"""What-if simulation API: SimulationRequest / SimulationReport (the port's
copy of the JAX package's api/simulation.py).

A SimulationRequest's scenarios are evaluated against the live fleet as one
batched [S,B,C] solve (simulation/engine.py) and answered with a
SimulationReport.

Scenario kinds:
  Drain          remove `cluster` from the candidate fleet (placements are
                 bit-identical to actually deleting the cluster and
                 cold-solving — the tie stream is index-remapped)
  Loss           mark `cluster` NotReady (stays in the fleet, infeasible)
  Taint          add a NoSchedule/NoExecute taint to `cluster`
  CapacityDelta  shift `cluster`'s allocatable by ±`resources`
  BindingSurge   inject `surge_count` synthetic dynamic-divided bindings
  Composite      apply `steps` together as ONE counterfactual (the quota
                 preflight caps several clusters at once this way)
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta
from .work import TargetCluster

KIND_SIMULATION_REQUEST = "SimulationRequest"
KIND_SIMULATION_REPORT = "SimulationReport"

SCENARIO_BASELINE = "Baseline"
SCENARIO_DRAIN = "Drain"
SCENARIO_LOSS = "Loss"
SCENARIO_TAINT = "Taint"
SCENARIO_CAPACITY = "CapacityDelta"
SCENARIO_SURGE = "BindingSurge"
SCENARIO_COMPOSITE = "Composite"
# preemption preview (sched/preemption.py): what would placing `binding`
# evict? Answered by the SAME planner the live scheduler runs, against the
# same snapshot — the previewed victim set is identical to what a real
# admission would cut, and nothing mutates
SCENARIO_PREEMPT = "Preemption"

SCENARIO_KINDS = (
    SCENARIO_BASELINE, SCENARIO_DRAIN, SCENARIO_LOSS, SCENARIO_TAINT,
    SCENARIO_CAPACITY, SCENARIO_SURGE, SCENARIO_COMPOSITE, SCENARIO_PREEMPT,
)


@dataclass
class Scenario:
    """One counterfactual. Flat on purpose (codec-friendly): each kind reads
    only its own fields; Composite nests sub-steps under `steps`."""

    kind: str = SCENARIO_BASELINE
    name: str = ""  # display label; label() derives one when empty
    cluster: str = ""  # Drain / Loss / Taint / CapacityDelta target
    # Taint
    taint_key: str = ""
    taint_value: str = ""
    taint_effect: str = "NoSchedule"
    # CapacityDelta: ± per resource, allocatable units (cpu cores, bytes)
    resources: dict[str, float] = field(default_factory=dict)
    # BindingSurge: synthetic dynamic-divided bindings over the whole fleet
    surge_count: int = 0
    surge_replicas: int = 1
    surge_request: dict[str, float] = field(default_factory=dict)
    # Preemption: namespace/name of the (typically pending) preemptor
    # binding whose victim set the preview computes
    binding: str = ""
    # Composite
    steps: list["Scenario"] = field(default_factory=list)

    def label(self) -> str:
        if self.name:
            return self.name
        if self.kind == SCENARIO_PREEMPT:
            return f"preempt({self.binding})"
        if self.kind == SCENARIO_COMPOSITE:
            inner = ",".join(s.label() for s in self.steps[:3])
            more = "" if len(self.steps) <= 3 else f"+{len(self.steps) - 3}"
            return f"composite({inner}{more})"
        if self.kind == SCENARIO_SURGE:
            return f"surge({self.surge_count}x{self.surge_replicas})"
        if self.kind == SCENARIO_CAPACITY:
            delta = ",".join(
                f"{r}{v:+g}" for r, v in sorted(self.resources.items())
            )
            return f"capacity({self.cluster}:{delta})"
        if self.kind == SCENARIO_TAINT:
            return f"taint({self.cluster}:{self.taint_key})"
        return f"{self.kind.lower()}({self.cluster})" if self.cluster else self.kind.lower()


@dataclass
class SimulationRequestSpec:
    scenarios: list[Scenario] = field(default_factory=list)
    namespace: str = ""  # restrict to one namespace's bindings ("" = all)
    diff_limit: int = 8  # max per-scenario BindingDiff entries in the report


@dataclass
class SimulationRequest:
    kind: str = KIND_SIMULATION_REQUEST
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: SimulationRequestSpec = field(default_factory=SimulationRequestSpec)


@dataclass
class BindingDiff:
    """One displaced binding: placements before (baseline solve) and after
    (the scenario's counterfactual solve); error set when the row went
    unplaceable under the scenario."""

    binding: str = ""  # namespace/name key
    before: list[TargetCluster] = field(default_factory=list)
    after: list[TargetCluster] = field(default_factory=list)
    error: str = ""


@dataclass
class PreemptionVictim:
    """One previewed victim replica reduction (Preemption scenarios)."""

    binding: str = ""  # namespace/name
    cluster: str = ""
    replicas: int = 0
    priority: int = 0


@dataclass
class ScenarioReport:
    scenario: Scenario = field(default_factory=Scenario)
    displaced: int = 0  # bindings whose placement changed vs baseline
    unplaceable: int = 0  # bindings with no feasible/schedulable placement
    injected: int = 0  # surge rows evaluated under this scenario
    overcommitted: list[str] = field(default_factory=list)  # cluster names
    diffs: list[BindingDiff] = field(default_factory=list)  # first diff_limit
    # Preemption scenarios: who pays for placing the previewed binding —
    # identical to the live planner's victim set (shared plan code)
    victims: list[PreemptionVictim] = field(default_factory=list)


@dataclass
class SimulationReport:
    kind: str = KIND_SIMULATION_REPORT
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    scenarios: list[ScenarioReport] = field(default_factory=list)
    bindings: int = 0
    clusters: int = 0
    baseline_unplaceable: int = 0
    batched_solves: int = 0  # vmapped [S,B,C] launches this report cost
    fallback_solves: int = 0  # per-scenario exact re-solves (spread rows etc.)
