"""Descheduler: shrink assignments stuck unschedulable so the scheduler can
re-place the freed replicas elsewhere.

Parity with pkg/descheduler (EST5, descheduler.go:141-240): every
--descheduling-interval (default 2m) sweep all ResourceBindings with
Divided+Dynamic placements (core/filter.go:35), find clusters where
ready < assigned (GetUndesiredClusters, core/helper.go:99-109), ask the
unschedulable estimators how many replicas cannot ever start (min-merge,
helper.go:62-96), reduce spec.clusters[i].replicas by that count — never below
ready (updateScheduleResult:207) — and update the binding. The scheduler then
sees replicas-changed (scheduler.go:408) and scale-up re-places the freed
replicas on clusters with headroom.

The port's copy of the reference's descheduler/descheduler.py. It differs
in one place: `device=` (None means the CUDA card, resolved at construction,
so a descheduler built without one raises RuntimeError at once; "cpu" runs
the plain path). Only the dry run touches the device: its re-placement
runs through the port's Simulator there (the scenario filter, the dense
tail and the load kernels on the card). The live sweep is host work.
"""
from __future__ import annotations

from typing import Optional

from .. import resolve_device
from ..api.policy import (
    DIVISION_PREFERENCE_AGGREGATED,
    DIVISION_PREFERENCE_WEIGHTED,
    REPLICA_SCHEDULING_DIVIDED,
)
from ..api.work import ResourceBinding, TargetCluster
from ..runtime.controller import Clock
from ..store.store import Store

DEFAULT_DESCHEDULING_INTERVAL = 120.0  # seconds (cmd/descheduler/app/options)
DEFAULT_UNSCHEDULABLE_THRESHOLD = 300.0  # 5m (descheduler options)


def eligible(rb: ResourceBinding) -> bool:
    """FilterBindings (descheduler/core/filter.go:35): Divided + dynamic
    division only (Aggregated or Weighted with dynamicWeight)."""
    p = rb.spec.placement
    if p is None or p.replica_scheduling is None:
        return False
    rs = p.replica_scheduling
    if rs.replica_scheduling_type != REPLICA_SCHEDULING_DIVIDED:
        return False
    if rs.replica_division_preference == DIVISION_PREFERENCE_AGGREGATED:
        return True
    return (
        rs.replica_division_preference == DIVISION_PREFERENCE_WEIGHTED
        and rs.weight_preference is not None
        and bool(rs.weight_preference.dynamic_weight)
    )


def ready_replicas_by_cluster(rb: ResourceBinding) -> dict[str, int]:
    """Parsed from aggregatedStatus (core/helper.go:120-142)."""
    out: dict[str, int] = {}
    for item in rb.status.aggregated_status:
        status = item.status or {}
        out[item.cluster_name] = int(status.get("readyReplicas", 0) or 0)
    return out


class Descheduler:
    def __init__(
        self,
        store: Store,
        estimator_registry,
        clock: Optional[Clock] = None,
        unschedulable_threshold: float = DEFAULT_UNSCHEDULABLE_THRESHOLD,
        interval: float = DEFAULT_DESCHEDULING_INTERVAL,
        device=None,  # the dry run's device: None = the CUDA card (raises
        #   RuntimeError without one), "cpu" = the plain path
    ) -> None:
        self.device = resolve_device(device)
        self.store = store
        self.registry = estimator_registry
        self.clock = clock or Clock()
        self.threshold = unschedulable_threshold
        self.interval = interval
        self._last_run: Optional[float] = None

    def tick(self) -> int:
        """Run one sweep if the interval elapsed; returns bindings updated."""
        now = self.clock.now()
        if self._last_run is not None and now - self._last_run < self.interval:
            return 0
        self._last_run = now
        return self.deschedule_once()

    def deschedule_once(self) -> int:
        updated = 0
        for rb in self.store.list("ResourceBinding"):
            if not eligible(rb):
                continue
            if self._deschedule_binding(rb):
                updated += 1
        return updated

    def _proposed_targets(self, rb: ResourceBinding):
        """The eviction set for one binding: the shrunk spec.clusters this
        sweep would write, or None when nothing shrinks. Pure — shared by
        the live sweep and the dry-run preflight so the two can never use
        different shrink logic."""
        ready = ready_replicas_by_cluster(rb)
        undesired = [
            tc.name for tc in rb.spec.clusters if ready.get(tc.name, 0) < tc.replicas
        ]
        if not undesired:
            return None
        unschedulable = dict(
            zip(
                undesired,
                self.registry.min_unschedulable(undesired, rb.spec.resource, self.threshold),
            )
        )
        new_clusters = []
        changed = False
        for tc in rb.spec.clusters:
            n = unschedulable.get(tc.name, 0)
            if n > 0:
                # shrink by the unschedulable count, floored at ready
                target = max(tc.replicas - n, ready.get(tc.name, 0))
                if target != tc.replicas:
                    changed = True
                new_clusters.append(TargetCluster(name=tc.name, replicas=target))
            else:
                new_clusters.append(tc)
        return new_clusters if changed else None

    def _deschedule_binding(self, rb: ResourceBinding) -> bool:
        new_clusters = self._proposed_targets(rb)
        if new_clusters is None:
            return False
        fresh = self.store.try_get("ResourceBinding", rb.name, rb.namespace)
        if fresh is None:
            return False
        fresh.spec.clusters = new_clusters
        self.store.update(fresh)
        return True

    def deschedule_dryrun(self, diff_limit: int = 16):
        """--dry-run mode: compute the eviction set, then — instead of
        patching bindings — run the shrunk copies through the simulation
        engine (the scheduler's own solve, simulation/engine.py) and report
        what the re-placement WOULD do, diffed against the bindings'
        current assignments. Touches neither the store nor the estimators'
        state; returns a SimulationReport that is NOT persisted.

        The simulated before-image is the live spec.clusters; the after
        image is the baseline solve of the shrunk copies (the scheduler
        sees replicas-changed and scale-up re-places the freed replicas —
        exactly what deschedule_once would trigger)."""
        import copy as copy_mod

        from ..api.simulation import (
            SCENARIO_COMPOSITE,
            Scenario,
            ScenarioReport,
            SimulationReport,
        )
        from ..simulation import Simulator, diff_placements

        proposals = []
        for rb in self.store.list("ResourceBinding"):
            if not eligible(rb):
                continue
            new_clusters = self._proposed_targets(rb)
            if new_clusters is not None:
                proposals.append((rb, new_clusters))
        report = SimulationReport()
        report.metadata.name = "descheduler-dry-run"
        if not proposals:
            return report
        clusters = sorted(
            self.store.list("Cluster"), key=lambda c: c.metadata.name
        )
        shrunk = []
        current_placements: dict[str, list] = {}
        for rb, new_clusters in proposals:
            m = copy_mod.deepcopy(rb)
            m.spec.clusters = new_clusters
            shrunk.append(m)
            current_placements[rb.metadata.key()] = list(rb.spec.clusters)
        sim = Simulator(clusters, device=self.device)
        # the live re-solve min-merges registered-estimator answers
        # (sched/scheduler.py batch_estimates) — the preflight must see the
        # same tightened availability, or it reports freed replicas landing
        # on clusters the real solve will reject (None when this registry
        # carries only unschedulable estimators, e.g. the daemon path)
        extra = None
        batch_estimates = getattr(self.registry, "batch_estimates", None)
        if batch_estimates is not None:
            extra = batch_estimates(shrunk, [c.metadata.name for c in clusters])
        baseline, _ = sim.simulate(shrunk, [], extra_avail=extra)
        baseline.scenario = Scenario(
            kind=SCENARIO_COMPOSITE, name="descheduler-evictions",
        )
        row = diff_placements(current_placements, {}, baseline,
                              limit=diff_limit)
        row = ScenarioReport(
            scenario=row.scenario, displaced=row.displaced,
            unplaceable=row.unplaceable, injected=len(shrunk),
            overcommitted=row.overcommitted, diffs=row.diffs,
        )
        report.scenarios = [row]
        report.bindings = len(shrunk)
        report.clusters = len(clusters)
        report.batched_solves = sim.last_stats.get("batched_solves", 0)
        report.fallback_solves = sim.last_stats.get("fallback_solves", 0)
        return report
