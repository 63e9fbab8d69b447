"""Scenario-batched counterfactual solves: S what-ifs as ONE [S,B,C] solve
(the port of the JAX package's simulation/engine.py).

Every scenario is a perturbation of the fleet encoding (models/fleet.py
FleetArrays: drain, readiness loss, taint, capacity delta) or of the binding
set (surge). The perturbed fleets are stacked on a leading scenario axis and
solved against the SAME factored binding batch by three kernel launches
(`_sim_solve`): `sim_filter` evaluates every (scenario, row, column) against
its scenario's fleet slice; `dense_tail`, the live dense round's division
tail, runs unchanged over the S x B scenario rows; `sim_load` sums each
scenario's placed replicas and resources per cluster. Each scenario's tie
stream comes from its remapped column index (1-based present rank), so a
Drain scenario reproduces bit-identically what a cold solve WITHOUT that
cluster would place.

Memory envelope: one solve keeps about six [S,B,C] buffers of 1-4 bytes
alive, so S·B·C is capped by the same `max_bc_elems` budget the live
scheduler uses, and the scenario axis is cut into sequential chunks of
`budget // (B·C)` scenarios. The reference shards an oversized scenario
axis over several devices instead; the port raises NotImplementedError
there until the multi-GPU slice (ROADMAP queue A item 11).

Rows the dense solve does not cover end to end (spread constraints,
ordered multi-term affinities — both host-driven search loops) take a
per-scenario exact fallback through ArrayScheduler on the same device;
everything else (Duplicated / static / dynamic strategies) rides the
batched path. `last_stats` and the karmada_simulation_solves_total metric
expose the split.
"""
from __future__ import annotations

import copy
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels, resolve_device
from ..api.cluster import CLUSTER_CONDITION_READY, Taint
from ..api.meta import Condition, ObjectMeta, set_condition
from ..api.policy import (
    DIVISION_PREFERENCE_AGGREGATED,
    REPLICA_SCHEDULING_DIVIDED,
    ClusterAffinity,
    Placement,
    ReplicaSchedulingStrategy,
)
from ..api.simulation import (
    SCENARIO_BASELINE,
    SCENARIO_CAPACITY,
    SCENARIO_COMPOSITE,
    SCENARIO_DRAIN,
    SCENARIO_KINDS,
    SCENARIO_LOSS,
    SCENARIO_PREEMPT,
    SCENARIO_SURGE,
    SCENARIO_TAINT,
    Scenario,
)
from ..api.work import (
    BindingSpec,
    ObjectReference,
    ReplicaRequirements,
    ResourceBinding,
    TargetCluster,
)
from ..convert import batch_from_numpy
from ..metrics import simulation_duration, simulation_scenarios, simulation_solves
from ..models.batch import AGGREGATED, DUPLICATED, NON_WORKLOAD, BatchEncoder, pow2_bucket
from ..models.fleet import FleetEncoder, to_int_units
from ..sched.core import (
    _BATCH_FIELDS,
    I32,
    TOPK_TARGETS,
    ArrayScheduler,
    _sorted_pairs,
    fetch_rows,
    pad_batch,
    resolve_autoshard,
    resolve_max_bc_elems,
    to_device,
)
from ..sched.plugins import ALL_PLUGIN_BITS

SURGE_NAMESPACE = "karmada-simulation"


class SimulationError(ValueError):
    """A scenario references state the fleet does not have (unknown cluster,
    unknown scenario kind) — surfaced as a client error, not a solve bug."""


# --------------------------------------------------------------------------
# scenario application (object level — the single source of perturbation
# semantics, shared by the batched encode, the exact fallback, and tests)
# --------------------------------------------------------------------------


def scenario_steps(scenario: Scenario) -> list[Scenario]:
    if scenario.kind == SCENARIO_COMPOSITE:
        return list(scenario.steps)
    return [scenario]


def _validate_steps(steps: Sequence[Scenario], cluster_names: set) -> None:
    for st in steps:
        if st.kind not in SCENARIO_KINDS:
            raise SimulationError(f"unknown scenario kind {st.kind!r}")
        if st.kind == SCENARIO_COMPOSITE:
            raise SimulationError("Composite scenarios cannot nest")
        if st.kind == SCENARIO_PREEMPT:
            # answered by the preemption planner — the batched
            # counterfactual engine has no victim-selection semantics and
            # must not silently baseline it
            raise SimulationError(
                "Preemption scenarios are answered by the preemption "
                "planner, not the batched engine"
            )
        if st.kind in (SCENARIO_DRAIN, SCENARIO_LOSS, SCENARIO_TAINT,
                       SCENARIO_CAPACITY):
            if not st.cluster:
                raise SimulationError(f"{st.kind} scenario needs a cluster")
            if st.cluster not in cluster_names:
                raise SimulationError(
                    f"{st.kind} scenario targets unknown cluster {st.cluster!r}"
                )
        if st.kind == SCENARIO_TAINT and not st.taint_key:
            raise SimulationError("Taint scenario needs taint_key")
        if st.kind == SCENARIO_SURGE and st.surge_count <= 0:
            raise SimulationError("BindingSurge scenario needs surge_count > 0")


def _set_ready(cluster, ready: bool) -> None:
    set_condition(
        cluster.status.conditions,
        Condition(
            type=CLUSTER_CONDITION_READY,
            status="True" if ready else "False",
            reason="Simulated",
        ),
    )


def _apply_step(cluster, step: Scenario):
    """One perturbed deepcopy of `cluster` under `step` (never Drain)."""
    cc = copy.deepcopy(cluster)
    if step.kind == SCENARIO_LOSS:
        _set_ready(cc, False)
    elif step.kind == SCENARIO_TAINT:
        cc.spec.taints.append(
            Taint(key=step.taint_key, value=step.taint_value,
                  effect=step.taint_effect or "NoSchedule")
        )
    elif step.kind == SCENARIO_CAPACITY:
        rs = cc.status.resource_summary
        if rs is not None:
            for rname, delta in step.resources.items():
                rs.allocatable[rname] = max(
                    0.0, rs.allocatable.get(rname, 0.0) + delta
                )
    return cc


def apply_scenario_objects(clusters: Sequence, scenario: Scenario) -> list:
    """REFERENCE semantics: the cluster list a real cold re-solve under this
    scenario would see — drained clusters REMOVED, others perturbed. The
    engine's batched path must be bit-identical to
    `ArrayScheduler(apply_scenario_objects(...)).schedule(...)` per
    scenario."""
    steps = scenario_steps(scenario)
    drained = {s.cluster for s in steps if s.kind == SCENARIO_DRAIN}
    mods: dict[str, list[Scenario]] = {}
    for s in steps:
        if s.kind in (SCENARIO_LOSS, SCENARIO_TAINT, SCENARIO_CAPACITY):
            mods.setdefault(s.cluster, []).append(s)
    out = []
    for c in clusters:
        if c.name in drained:
            continue
        for s in mods.get(c.name, ()):
            c = _apply_step(c, s)
        out.append(c)
    return out


def _perturb_columns(clusters: Sequence, scenario: Scenario):
    """ENGINE column view: same-length cluster list (the stacked [S,C,...]
    encode needs rectangular fleets) + the present mask. A drained cluster
    stays as a column but becomes a NotReady husk with no capacity — never
    feasible, so only its tie index matters, and tie indices come from the
    present mask (cumulative rank = the cluster's position in the REMOVED
    list), which is what makes drain bit-identical to removal."""
    steps = scenario_steps(scenario)
    drained = {s.cluster for s in steps if s.kind == SCENARIO_DRAIN}
    mods: dict[str, list[Scenario]] = {}
    for s in steps:
        if s.kind in (SCENARIO_LOSS, SCENARIO_TAINT, SCENARIO_CAPACITY):
            mods.setdefault(s.cluster, []).append(s)
    out, present = [], np.ones(len(clusters), bool)
    for i, c in enumerate(clusters):
        if c.name in drained:
            husk = copy.deepcopy(c)
            _set_ready(husk, False)
            husk.status.resource_summary = None
            husk.spec.taints = []
            out.append(husk)
            present[i] = False
            continue
        for s in mods.get(c.name, ()):
            c = _apply_step(c, s)
        out.append(c)
    return out, present


def surge_bindings(step: Scenario, scenario_index: int) -> list[ResourceBinding]:
    """Deterministic synthetic bindings for a BindingSurge step: dynamic
    Divided/Aggregated over the whole fleet (the capacity-pressure shape).
    Names/uids are derived from the scenario index so the batched solve and
    any per-scenario reference solve see identical rows (the tie stream is
    uid-seeded)."""
    req = dict(step.surge_request) or {"cpu": 0.1}
    out = []
    for i in range(step.surge_count):
        name = f"surge-{scenario_index}-{i}"
        out.append(ResourceBinding(
            metadata=ObjectMeta(
                namespace=SURGE_NAMESPACE, name=name,
                uid=f"sim-surge-{scenario_index}-{i}",
            ),
            spec=BindingSpec(
                resource=ObjectReference(
                    api_version="apps/v1", kind="Deployment",
                    namespace=SURGE_NAMESPACE, name=name,
                ),
                replicas=max(1, step.surge_replicas),
                replica_requirements=ReplicaRequirements(resource_request=req),
                placement=Placement(
                    cluster_affinity=ClusterAffinity(cluster_names=[]),
                    replica_scheduling=ReplicaSchedulingStrategy(
                        replica_scheduling_type=REPLICA_SCHEDULING_DIVIDED,
                        replica_division_preference=DIVISION_PREFERENCE_AGGREGATED,
                    ),
                ),
            ),
        ))
    return out


# --------------------------------------------------------------------------
# the scenario-stacked solve
# --------------------------------------------------------------------------


def _sim_solve(
    # scenario-stacked fleet [S,...]
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    tie_idx,  # i64[S,C] 1-based present rank per column (u64 bits)
    active,  # bool[S,B] rows that exist in each scenario (surge ownership)
    # batch (scenario-invariant — encoded once, shared by every scenario)
    replicas, unknown_request, gvk, strategy, fresh,
    tol_tables, tol_idx, aff_masks, aff_idx, weight_tables, weight_idx,
    prev_idx, prev_rep, evict_idx, seeds, req_unique, req_idx,
    extra_avail,  # i32[B,C] (-1 = no answer) or None, scenario-independent
    request_dense,  # i64[B,R] for the overcommit usage accumulation
    *,
    topk: int = TOPK_TARGETS,
    has_agg: bool = True,
):
    """The torch counterpart of the reference's `_sim_kernel`, in its
    argument order: sim_filter over the S scenario fleets, dense_tail over
    the S·B scenario rows (the batch's row fields repeated per scenario),
    sim_load over each scenario's active rows. Returns (unschedulable
    bool[S,B], avail_sum i32[S,B], feas_count i32[S,B], nnz i32[S,B],
    top_idx i32[S,B,topk], top_val i32[S,B,topk], assigned i64[S,C], usage
    i64[S,C,R], result i32[S,B,C]), on the inputs' device; the dense result
    stays there for overflow-row fetches."""
    S, C = alive.shape
    B = replicas.shape[0]
    n = S * B
    feasible, avail, prev, tie, feas_count = kernels.sim_filter(
        alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, tie_idx,
        replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx,
        prev_idx, prev_rep, evict_idx, seeds, req_unique, req_idx, extra_avail,
        plugin_bits=ALL_PLUGIN_BITS,
    )
    rows = torch.arange(n, dtype=I32, device=alive.device)
    result, unsched, avail_sum, nnz, top_idx, top_val = kernels.dense_tail(
        feasible.view(n, C), avail.view(n, C), prev.view(n, C), tie.view(n, C), rows,
        weight_tables, weight_idx.repeat(S), strategy.repeat(S), replicas.repeat(S),
        fresh.repeat(S), topk=topk, has_agg=has_agg,
    )
    del feasible, avail, prev, tie
    result = result.view(S, B, C)
    assigned, usage = kernels.sim_load(result, active, request_dense)
    return (
        unsched.view(S, B), avail_sum.view(S, B), feas_count, nnz.view(S, B),
        top_idx.view(S, B, -1), top_val.view(S, B, -1), assigned, usage, result,
    )


# --------------------------------------------------------------------------
# host wrapper
# --------------------------------------------------------------------------


class ScenarioOutcome:
    """One scenario's counterfactual solve, decoded."""

    __slots__ = (
        "scenario", "placements", "errors", "assigned", "usage",
        "overcommitted", "present", "injected",
    )

    def __init__(self, scenario: Scenario, n_clusters: int, n_resources: int,
                 present: np.ndarray):
        self.scenario = scenario
        self.placements: dict[str, list[TargetCluster]] = {}
        self.errors: dict[str, str] = {}
        self.assigned = np.zeros(n_clusters, np.int64)
        self.usage = np.zeros((n_clusters, n_resources), np.int64)
        self.overcommitted: list[str] = []
        self.present = present
        self.injected = 0

    @property
    def unplaceable(self) -> int:
        return len(self.errors)


class Simulator:
    """Evaluates S counterfactual scenarios against one fleet + binding set.

    Reuses the live plane's encoders unchanged: one FleetEncoder (interned
    ids stay stable across the scenario encodes) and one BatchEncoder (the
    batch is scenario-invariant). The solve is `_sim_solve` above; see the
    module docstring for routing. `device`: None means the CUDA card
    (RuntimeError without one); "cpu" runs the plain PyTorch versions."""

    def __init__(self, clusters: Sequence, encoder: Optional[FleetEncoder] = None,
                 max_bc_elems: Optional[int] = None,
                 autoshard: Optional[bool] = None, device=None):
        self.device = resolve_device(device)
        self.clusters = list(clusters)
        self.encoder = encoder or FleetEncoder()
        self.fleet = self.encoder.encode(self.clusters)
        self.batch_encoder = BatchEncoder(self.encoder, self.fleet, self.clusters)
        self.max_bc_elems = resolve_max_bc_elems(max_bc_elems)
        self.autoshard = resolve_autoshard(autoshard)
        self.last_stats: dict = {}

    # -- scenario fleet stacking ------------------------------------------

    def _encode_scenario_fleets(self, all_scen: list[Scenario]):
        """Per-scenario FleetArrays via the SHARED encoder (ids stable),
        stacked [S,...] with the taint/api axes padded to a common width.
        Late-minted GVK columns (registered by the batch encode after a
        fleet encode) are enabled by no cluster, so False-padding api_ok is
        exact, and zero-padding taints means 'no taint in slot'. tie_idx is
        the u64 present rank held as int64 bits."""
        fleets, present = [], []
        for sc in all_scen:
            cols, pres = _perturb_columns(self.clusters, sc)
            fleets.append(self.encoder.encode(cols))
            present.append(pres)
        T = max(f.taint_key.shape[1] for f in fleets)
        G = max((f.api_ok.shape[1] for f in fleets), default=0)

        def padt(a):
            return np.pad(a, [(0, 0), (0, T - a.shape[1])])

        def padg(a):
            return np.pad(a, [(0, 0), (0, G - a.shape[1])])

        stacks = (
            np.stack([f.alive for f in fleets]),
            np.stack([f.capacity for f in fleets]),
            np.stack([f.has_summary for f in fleets]),
            np.stack([padt(f.taint_key) for f in fleets]),
            np.stack([padt(f.taint_value) for f in fleets]),
            np.stack([padt(f.taint_effect) for f in fleets]),
            np.stack([padg(f.api_ok) for f in fleets]),
        )
        present = np.stack(present)
        tie_idx = np.cumsum(present, axis=1).astype(np.int64)
        return stacks, present, tie_idx

    # -- the batched launch (scenario chunking) ---------------------------

    def _launch_chunks(self, stacks, tie_idx, active, batch, extra_np,
                       request_dense, topk, has_agg):
        """Yield (scenario_slice, host_outputs, result_dev) per solve,
        honoring the S·B·C memory budget: `budget // (B·C)` scenarios a
        solve. The batch uploads once and serves every chunk."""
        S = tie_idx.shape[0]
        Bp = len(batch.replicas)
        C = tie_idx.shape[1]
        budget = self.max_bc_elems
        n_dev = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if self.autoshard and n_dev > 1 and S * Bp * C > budget:
            raise NotImplementedError(
                f"simulation: {S}x{Bp}x{C} scenario elements exceed the budget of {budget} "
                f"with {n_dev} cards visible; the scenario-sharded multi-device route comes "
                "with the multi-GPU slice (ROADMAP queue A item 11): pass autoshard=False or "
                "set KARMADA_TPU_AUTOSHARD=0 to chunk on one card"
            )
        per = max(1, budget // max(Bp * C, 1))
        self.last_stats["mesh"] = False

        dev = self.device
        t = batch_from_numpy({name: getattr(batch, name) for name in _BATCH_FIELDS}, dev)
        extra = None if extra_np is None else to_device(extra_np, dev)
        request = to_device(request_dense, dev)
        for s0 in range(0, S, per):
            s1 = min(s0 + per, S)
            fleet = [to_device(a[s0:s1], dev) for a in stacks]
            out = _sim_solve(
                *fleet, to_device(tie_idx[s0:s1], dev), to_device(active[s0:s1], dev),
                t["replicas"], t["unknown_request"], t["gvk"], t["strategy"], t["fresh"],
                t["tol_tables"], t["tol_idx"], t["aff_masks"], t["aff_idx"],
                t["weight_tables"], t["weight_idx"], t["prev_idx"], t["prev_rep"],
                t["evict_idx"], t["seeds"], t["req_unique"], t["req_idx"], extra, request,
                topk=topk, has_agg=has_agg,
            )
            simulation_solves.inc(mode="batched")
            self.last_stats["batched_solves"] += 1
            host = tuple(o.cpu().numpy() for o in out[:8])
            yield slice(s0, s1), host, out[8]

    # -- public API -------------------------------------------------------

    def simulate(self, bindings: Sequence, scenarios: Sequence[Scenario],
                 extra_avail=None):
        """Evaluate `scenarios` (plus an implicit baseline) against
        `bindings` on this fleet. Returns (baseline_outcome, outcomes) where
        outcomes[i] corresponds to scenarios[i]. Mutates nothing — neither
        the fleet, nor the bindings, nor any store."""
        t0 = time.perf_counter()
        names = self.fleet.names
        C = len(names)
        R = len(self.encoder.resources)
        cluster_names = set(names)
        all_scen = [Scenario(kind=SCENARIO_BASELINE, name="baseline")]
        all_scen += list(scenarios)
        for sc in all_scen[1:]:
            _validate_steps(scenario_steps(sc), cluster_names)
        simulation_scenarios.inc(len(all_scen) - 1)
        S = len(all_scen)

        # union batch: base rows live in every scenario; surge rows only in
        # their own (rows are independent, so solving a surge row under a
        # foreign scenario is wasted-but-harmless work that the active mask
        # excludes from decode and load accounting)
        union = list(bindings)
        owner = [-1] * len(bindings)
        for si, sc in enumerate(all_scen):
            for st in scenario_steps(sc):
                if st.kind == SCENARIO_SURGE:
                    rows = surge_bindings(st, si)
                    union += rows
                    owner += [si] * len(rows)

        if extra_avail is not None:
            extra_u = np.full((len(union), C), -1, np.int32)
            extra_u[: len(bindings)] = np.asarray(extra_avail, np.int32)
        else:
            extra_u = None

        # partition: spread constraints and ordered affinity terms are
        # host-driven searches — per-scenario exact fallback
        bat_rows, fb_rows = [], []
        for i, rb in enumerate(union):
            p = rb.spec.placement
            if p is not None and (p.spread_constraints or p.cluster_affinities):
                fb_rows.append(i)
            else:
                bat_rows.append(i)

        self.last_stats = {
            "scenarios": S - 1,
            "bindings": len(bindings),
            "batched_rows": len(bat_rows),
            "fallback_rows": len(fb_rows),
            "batched_solves": 0,
            "fallback_solves": 0,
            "mesh": False,
        }

        stacks, present, tie_idx = self._encode_scenario_fleets(all_scen)
        present_counts = present.sum(axis=1)
        outcomes = [
            ScenarioOutcome(sc, C, R, present[si])
            for si, sc in enumerate(all_scen)
        ]
        for ui, si in enumerate(owner):
            if si >= 0:
                outcomes[si].injected += 1

        if bat_rows:
            self._solve_batched(
                union, owner, bat_rows, all_scen, stacks, present_counts,
                tie_idx, extra_u, outcomes,
            )
        if fb_rows:
            self._solve_fallback(
                union, owner, fb_rows, all_scen, present, extra_u, outcomes,
            )

        # overcommit: scheduled load vs available capacity per cluster
        cap = stacks[1]  # [S,C,R]
        hs = stacks[2]  # [S,C]
        for si, o in enumerate(outcomes):
            over = (
                (o.usage > cap[si]).any(-1) & hs[si] & present[si]
            )
            o.overcommitted = [names[c] for c in np.nonzero(over)[0]]

        simulation_duration.observe(time.perf_counter() - t0)
        return outcomes[0], outcomes[1:]

    # -- batched path -----------------------------------------------------

    def _solve_batched(self, union, owner, bat_rows, all_scen, stacks,
                       present_counts, tie_idx, extra_u, outcomes):
        names = self.fleet.names
        C = len(names)
        S = len(all_scen)
        max_rows = max(8, self.max_bc_elems // max(C, 1))
        for g0 in range(0, len(bat_rows), max_rows):
            group = bat_rows[g0:g0 + max_rows]
            raw = self.batch_encoder.encode([union[i] for i in group])
            batch = pad_batch(raw, ArrayScheduler._bucket)
            Bp = len(batch.replicas)
            n = len(group)

            # static specializations (the reference's derivation of the
            # output window and has_agg from the raw batch)
            max_repl = int(raw.replicas.max(initial=0))
            cand = max_repl
            dup = raw.strategy == DUPLICATED
            if dup.any():
                pc = raw.aff_masks.sum(axis=1)
                cand = max(cand, int(pc[raw.aff_idx[dup]].max(initial=0)))
            topk = min(pow2_bucket(max(min(cand, TOPK_TARGETS), 1), lo=8),
                       min(C, TOPK_TARGETS)) if C else 8
            topk = max(topk, 1)
            has_agg = bool((raw.strategy == AGGREGATED).any())

            active = np.zeros((S, Bp), bool)
            for j, ui in enumerate(group):
                si = owner[ui]
                if si < 0:
                    active[:, j] = True
                else:
                    active[si, j] = True

            if extra_u is not None:
                extra_np = np.full((Bp, C), -1, np.int32)
                extra_np[:n] = extra_u[group]
            else:
                extra_np = None
            request_dense = np.asarray(batch.request, np.int64)

            for s_slice, host, result_dev in self._launch_chunks(
                stacks, tie_idx, active, batch, extra_np, request_dense,
                topk, has_agg,
            ):
                (unsched, avail_sum, feas_count, nnz, top_idx, top_val,
                 assigned, usage) = host
                for local, si in enumerate(range(s_slice.start, s_slice.stop)):
                    o = outcomes[si]
                    o.assigned += np.asarray(assigned[local], np.int64)
                    o.usage += np.asarray(usage[local], np.int64)
                    tis, tvs = _sorted_pairs(top_idx[local], top_val[local])
                    window = top_idx.shape[2]
                    overflow: list[tuple[int, str]] = []
                    for j, ui in enumerate(group):
                        if not active[si, j]:
                            continue
                        key = raw.keys[j]
                        strat = int(raw.strategy[j])
                        if feas_count[local, j] == 0:
                            o.errors[key] = (
                                f"0/{int(present_counts[si])} clusters are "
                                "available"
                            )
                        elif unsched[local, j]:
                            o.errors[key] = (
                                "Clusters available replicas "
                                f"{int(avail_sum[local, j])} are not enough "
                                "to schedule."
                            )
                        elif strat == NON_WORKLOAD:
                            o.placements[key] = []
                        elif int(nnz[local, j]) > window:
                            overflow.append((j, key))
                        else:
                            k = int(nnz[local, j])
                            o.placements[key] = [
                                TargetCluster(
                                    name=names[int(tis[j, t])],
                                    replicas=int(tvs[j, t]),
                                )
                                for t in range(k)
                            ]
                    if overflow:
                        dense = fetch_rows(
                            result_dev[local], [j for j, _ in overflow],
                            ArrayScheduler._bucket,
                        )
                        for m, (_, key) in enumerate(overflow):
                            pos = np.nonzero(dense[m] > 0)[0]
                            o.placements[key] = [
                                TargetCluster(
                                    name=names[int(i)],
                                    replicas=int(dense[m, i]),
                                )
                                for i in pos
                            ]

    # -- exact fallback (spread / multi-term affinity rows) ---------------

    def _solve_fallback(self, union, owner, fb_rows, all_scen, present,
                        extra_u, outcomes):
        req_cols = self.encoder.resources
        name_to_col = {n: c for c, n in enumerate(self.fleet.names)}
        for si, sc in enumerate(all_scen):
            rows = [i for i in fb_rows if owner[i] in (-1, si)]
            if not rows:
                continue
            ref_clusters = apply_scenario_objects(self.clusters, sc)
            sub = [union[i] for i in rows]
            sub_extra = None
            if extra_u is not None:
                sub_extra = extra_u[rows][:, present[si]]
            sched = ArrayScheduler(ref_clusters, device=self.device)
            decisions = sched.schedule(sub, extra_avail=sub_extra)
            simulation_solves.inc(mode="fallback")
            self.last_stats["fallback_solves"] += 1
            o = outcomes[si]
            for rb, dec in zip(sub, decisions):
                key = rb.metadata.key()
                if not dec.ok:
                    o.errors[key] = dec.error
                    continue
                targets = list(dec.targets or [])
                o.placements[key] = targets
                # fold fallback load into the per-cluster accounting
                req = np.zeros(len(req_cols), np.int64)
                rr = rb.spec.replica_requirements
                if rr is not None:
                    for rname, val in rr.resource_request.items():
                        if rname in req_cols:
                            req[req_cols.index(rname)] = to_int_units(rname, val)
                for tc in targets:
                    c = name_to_col.get(tc.name)
                    if c is not None:
                        o.assigned[c] += tc.replicas
                        o.usage[c] += tc.replicas * req
