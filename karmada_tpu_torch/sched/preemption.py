"""Workload-class scheduling: priority tiers and preemption as batched
solves (PyTorch port of sched/preemption.py).

- **Priority tiers as a segmented solve.** A micro-batch whose rows carry
  more than one `schedule_priority` solves in one launch sequence with
  tier-ordered capacity consumption: the filter (or the candidate select)
  runs once, then for each tier, highest priority first, the estimate over
  the current capacity (`kernels.tier_estimate`), the division tail over
  the tier's rows, and the subtraction of the tier's placed replicas times
  their requests from the capacity (`kernels.tier_consume`) before the
  next tier. All launches go on one stream; the round syncs once, in the
  materialize half. `solve_tiers_sequential` is the executable contract:
  separate per-tier rounds against capacity-decremented fleets.
- **Preemption as a second solve pass.** A PreemptLowerPriority row's
  victim-augmented decision (capacity plus every strictly-lower-priority
  placed replica) rides the same launch sequence as a speculative pass
  (`decision.speculative`), or the planner (`plan_preemption`) runs one
  augmented launch per distinct preemptor priority. Victim selection on
  the host takes the fewest, lowest-priority, youngest victims.

Registered-estimator answers (`extra_avail`) are snapshot-constant across
tiers: every tier's main pass min-merges them, and the speculative pass,
which models victim-freed capacity the estimators cannot see, reads none.

Rows carrying spread constraints or ordered multi-term affinities take the
standard round inside a tiered batch. Each tier's estimate and tail run
over that tier's rows only: rows are independent in both, so every row
gets exactly the reference's per-tier answer. The one output that differs
from the reference's program is the result row (and its nnz and window) of
an unschedulable row in the first tier, which the reference zeroes and the
port keeps; it decodes to the same error either way.

The gang queue and the daemon's commit are later slices.
"""
from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..api.policy import PREEMPT_LOWER_PRIORITY
from ..api.work import TargetCluster
from ..models.batch import AGGREGATED, NON_WORKLOAD, pow2_bucket
from ..models.fleet import to_int_units
from .core import (
    _BATCH_FIELDS,
    TOPK_TARGETS,
    ArrayScheduler,
    ScheduleDecision,
    _sorted_pairs,
    pad_batch,
    to_device,
)


class _LaunchCounter:
    """Process-global tiered / preemption launch counter: a tiered
    micro-batch is ONE launch sequence whatever its tier count; a
    preemption pass is one per distinct preemptor priority. Bumped under a
    lock: a pipelined round's writer thread launches too."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.tiered = 0
        self.preempt = 0

    def bump(self, kind: str) -> None:
        """One launch of `kind` ("tiered" or "preempt")."""
        with self._lock:
            setattr(self, kind, getattr(self, kind) + 1)


LAUNCHES = _LaunchCounter()


def priority_of(rb) -> int:
    return rb.spec.schedule_priority or 0


def gang_of(rb) -> str:
    """The binding's gang identity, or "" when it schedules solo (a gang
    of one is just a binding)."""
    if rb.spec.gang_name and (rb.spec.gang_size or 0) > 1:
        return rb.spec.gang_name
    return ""


def wants_tiers(array: ArrayScheduler, bindings: Sequence) -> bool:
    """Route a batch through the segmented tiered solve? Only when rows
    span more than one priority — a uniform batch is exactly the standard
    solve — and never under out-of-tree plugins."""
    if len(bindings) < 2 or array._oot_plugins:
        return False
    it = iter(bindings)
    first = priority_of(next(it))
    return any(priority_of(rb) != first for rb in it)


def _batch_static_flags(raw, n_cols: int) -> tuple[int, bool]:
    """(topk, has_agg) for a raw (unpadded) batch: the output window is
    pinned to the fleet-width bucket (not to the batch's content, so mixed
    victim / preemptor batches keep one window); rows wider than the
    window fetch their result row."""
    topk = min(pow2_bucket(max(n_cols, 1), lo=8), TOPK_TARGETS)
    return max(topk, 1), bool((raw.strategy == AGGREGATED).any())


def _tier_assignment(bindings: Sequence) -> tuple[np.ndarray, int]:
    """tier_of[i] per row (0 = highest priority) and the tier count padded
    to a pow2 bucket, as the reference reports it (pad tiers hold no
    rows)."""
    prios = np.asarray([priority_of(rb) for rb in bindings], np.int64)
    uniq = np.unique(prios)[::-1]  # descending: tier 0 = highest
    tier_of = np.searchsorted(-uniq, -prios).astype(np.int32)
    return tier_of, int(pow2_bucket(len(uniq), lo=1))


def _eligible_rows(bindings: Sequence) -> tuple[list[int], list[int]]:
    """Split a batch into tiered-launch rows and standard-round rows (spread
    constraints and ordered multi-term affinities are host-driven searches
    the tiered launch does not cover)."""
    kernel_rows, std_rows = [], []
    for i, rb in enumerate(bindings):
        p = rb.spec.placement
        if p is not None and (p.spread_constraints or p.cluster_affinities):
            std_rows.append(i)
        else:
            kernel_rows.append(i)
    return kernel_rows, std_rows


def _upload(d: dict, device) -> dict:
    """Host arrays onto the device through pinned memory, non-blocking
    (`core.to_device`; uint64 travels as its int64 bits)."""
    return {k: to_device(v.view(np.int64) if v.dtype == np.uint64 else v, device)
            for k, v in d.items()}


def _merge_into(bufs: Optional[list], rows64, outs, n_rows: int) -> list:
    """Scatter one tier's tail outputs (rows `rows64`) into [n_rows, ...]
    buffers, allocated on first use; every row belongs to one tier, so
    every buffer row is written."""
    if bufs is None:
        bufs = [torch.empty((n_rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
                for x in outs]
    for buf, x in zip(bufs, outs):
        buf.index_copy_(0, rows64, x)
    return bufs


def run_tiers(tier_rows, n_rows: int, cap, reclaim, spec_tiers, has_extra: bool,
              estimate, tail, consume, estimate_pair=None):
    """The tier loop shared by the dense and compact launches. For each
    tier (rows i32 and i64 on the device): `estimate(cap, rows, rows64,
    first, use_extra)` the availability of its rows (with the estimator
    answers when `use_extra`), `tail(avail, rows, rows64)` the six
    division-tail outputs (result, unschedulable, avail_sum, nnz, top_idx,
    top_val), the speculative pass over `cap + reclaim[t]` without answers,
    then `consume(cap, outs, rows)` the capacity left for the next tier.
    `estimate_pair(cap, reclaim_t, rows)`, when given, estimates a tier's
    main and speculative passes in one call (tiers after the first, whose
    main pass is the filter's). Returns the merged outputs of both passes
    (the second None without `reclaim`)."""
    main = aug = None
    for t, (rows, rows64) in enumerate(tier_rows):
        # reclaim[t] is zero and there are no estimator answers to leave
        # out: the speculative pass would repeat the main one
        spec = reclaim is not None and bool(spec_tiers[t] or has_extra)
        if spec and t > 0 and estimate_pair is not None:
            av, a_av = estimate_pair(cap, reclaim[t], rows)
            outs = tail(av, rows, rows64)
            a_outs = tail(a_av, rows, rows64)
        else:
            outs = tail(estimate(cap, rows, rows64, t == 0, True), rows, rows64)
            a_outs = outs
            if spec:
                a_outs = tail(estimate(cap + reclaim[t], rows, rows64, False, False),
                              rows, rows64)
        main = _merge_into(main, rows64, outs, n_rows)
        if reclaim is not None:
            aug = _merge_into(aug, rows64, a_outs, n_rows)
        if t + 1 < len(tier_rows):
            cap = consume(cap, outs, rows)
    return main, aug


def _launch_dense_tiers(array, t, tier_rows, capacity, tiers, reclaim, spec_tiers,
                        topk: int, has_agg: bool):
    """The dense tiered launch (the reference's `_tiered_kernel`, B11):
    dense_filter once (its avail is tier 0's estimate), then per tier
    tier_estimate into the avail buffer at the tier's rows, dense_tail
    through the same row ids, tier_consume, the tier launches through the
    round's launcher `tiers` (`kernels.tier_launcher`) in rows mode. The
    estimator answers `t["extra_avail"]` (or None) min-merge into every
    main pass and never into the speculative one. Returns (feas_count,
    main outputs, speculative outputs)."""
    feas, _score, avail, prev, tie, feas_count = array._dense_filter(t, capacity=capacity)
    tiers.rows_mode(avail)

    def estimate(cap, rows, _rows64, first, use_extra):
        if first and use_extra:
            return avail
        return tiers.estimate(cap, rows, use_extra=use_extra)

    def tail(av, rows, _rows64):
        return kernels.dense_tail(feas, av, prev, tie, rows, t["weight_tables"], t["weight_idx"],
                                  t["strategy"], t["replicas"], t["fresh"],
                                  topk=topk, has_agg=has_agg)

    def consume(cap, outs, rows):
        return tiers.consume(cap, outs[0], outs[1], rows)

    main, aug = run_tiers(tier_rows, len(t["replicas"]), capacity, reclaim, spec_tiers,
                          t["extra_avail"] is not None, estimate, tail, consume)
    return feas_count, main, aug


def _launch_kernel_rows(array: ArrayScheduler, bindings: list, extra_avail=None,
                        capacity_override=None, reclaim_tiers=None,
                        count: str = "tiered") -> dict:
    """Encode, upload and launch the tiered solve of kernel-eligible rows;
    the returned state feeds `_materialize_kernel_rows`. No device sync.
    `extra_avail` (i32[rows, c], or None) are the rows' estimator answers.
    `capacity_override` (i64[C,R]) replaces the fleet's capacity (the
    planner's victim-augmented fleet); with `reclaim_tiers`
    (i64[n_tiers,C,R]) the launch also solves the speculative pass."""
    from . import candidates as cand_mod

    with array._encode_lock:
        raw = array.batch_encoder.encode(bindings)
    batch = pad_batch(raw, array._bucket)
    C = len(array.fleet.names)
    B = len(batch.replicas)
    tier_of, n_tiers = _tier_assignment(bindings)
    tier_pad = np.zeros(B, np.int32)  # the batch's pad rows ride tier 0
    tier_pad[: len(bindings)] = tier_of
    topk, has_agg = _batch_static_flags(raw, C)
    topk = min(topk, max(C, 1))
    dev = array.device
    up = {name: getattr(batch, name) for name in _BATCH_FIELDS}
    up["request"] = np.asarray(batch.request, np.int64)
    # the tier row ids, known on the host: uploaded once, sliced per tier
    order = np.argsort(tier_pad, kind="stable").astype(np.int32)
    bounds = np.searchsorted(tier_pad[order], np.arange(int(tier_of.max(initial=0)) + 2))
    up["tier_rows"] = order
    up["tier_rows64"] = order.astype(np.int64)
    if capacity_override is not None:
        up["capacity"] = np.asarray(capacity_override, np.int64)
    speculate = reclaim_tiers is not None
    spec_tiers = None
    if speculate:
        reclaim_np = np.asarray(reclaim_tiers, np.int64)
        up["reclaim"] = reclaim_np
        spec_tiers = reclaim_np.reshape(len(reclaim_np), -1).any(1)
    t = _upload(up, dev)
    t["extra_avail"] = array._upload_extra(extra_avail, B)
    capacity = t.get("capacity", array._fleet_dev["capacity"])
    tier_rows = [(t["tier_rows"][lo:hi], t["tier_rows64"][lo:hi])
                 for lo, hi in zip(bounds[:-1], bounds[1:])]
    reclaim = t.get("reclaim")
    # the round's tier launches: its constant tensors checked and bound once
    tiers = kernels.tier_launcher(array._fleet_dev["has_summary"], t["req_unique"],
                                  t["req_idx"], t["replicas"], t["unknown_request"],
                                  request=t["request"], extra_avail=t["extra_avail"])

    cand_k = cand_mod.tiered_k(array, raw, C)
    cand_dev = None
    if cand_k:
        feas_count, main, aug, cand_dev = cand_mod.launch_tiered_compact(
            array, t, tier_rows, capacity, tiers, reclaim, spec_tiers,
            k=cand_k, topk=topk, has_agg=has_agg)
    else:
        if cand_mod.compact_width_ok(array):
            cand_mod.note_fallback("duplicated")
        elif array.candidate_k:
            cand_mod.note_fallback("small_fleet")
        feas_count, main, aug = _launch_dense_tiers(
            array, t, tier_rows, capacity, tiers, reclaim, spec_tiers,
            topk=topk, has_agg=has_agg)
    result, unsched, asum, nnz, top_idx, top_val = main
    out = (unsched, asum, feas_count, nnz, top_idx, top_val, result)
    if speculate:
        a_result, a_unsched, a_asum, a_nnz, a_idx, a_val = aug
        out += (a_unsched, a_asum, a_nnz, a_idx, a_val, a_result)
    LAUNCHES.bump(count)
    return {"raw": raw, "out": out, "n": len(bindings), "names": array.fleet.names,
            "n_tiers": n_tiers, "speculate": speculate, "cand_dev": cand_dev}


def _decode_rows(raw, names, real, rows_j, unsched, asum, feas_count, nnz,
                 tis, tvs, window, result_dev, cand_dev=None) -> dict:
    """Decode a set of tiered rows into ScheduleDecisions: the compact
    (cluster, replicas) pairs, the unschedulable / empty-feasible errors in
    the live solver's words, and a result-row fetch for rows whose target
    set outruns the window. With `cand_dev` (the compact launch) result
    columns are window-local and map to cluster ids through it."""
    decisions: dict[int, ScheduleDecision] = {}
    overflow: list[tuple[int, ScheduleDecision]] = []
    for j in rows_j:
        key = raw.keys[j]
        strat = int(raw.strategy[j])
        if feas_count[j] == 0:
            decisions[j] = ScheduleDecision(key, error=f"0/{real} clusters are available")
        elif unsched[j]:
            decisions[j] = ScheduleDecision(
                key,
                error=(f"Clusters available replicas {int(asum[j])} are "
                       "not enough to schedule."),
            )
        elif strat == NON_WORKLOAD:
            decisions[j] = ScheduleDecision(key, targets=[])
        elif int(nnz[j]) > window:
            dec = ScheduleDecision(key)
            decisions[j] = dec
            overflow.append((j, dec))
        else:
            k = int(nnz[j])
            decisions[j] = ScheduleDecision(key, targets=[
                TargetCluster(name=names[int(tis[j, i])], replicas=int(tvs[j, i]))
                for i in range(k)
            ])
    if overflow:
        sel = torch.tensor([j for j, _ in overflow], dtype=torch.int64, device=result_dev.device)
        dense = result_dev.index_select(0, sel).cpu().numpy()
        cand = None if cand_dev is None else cand_dev.index_select(0, sel).cpu().numpy()
        for m, (_, dec) in enumerate(overflow):
            pos = np.nonzero(dense[m] > 0)[0]
            ids = pos if cand is None else cand[m, pos]
            dec.targets = [
                TargetCluster(name=names[int(i)], replicas=int(dense[m, p]))
                for i, p in zip(ids, pos)
            ]
    return decisions


def _materialize_kernel_rows(state: dict, armed: Sequence[int] = ()) -> list[ScheduleDecision]:
    """Sync and decode the tiered outputs. With a speculative launch, the
    `armed` rows also decode their victim-augmented decision onto
    `decision.speculative`."""
    raw, n, names = state["raw"], state["n"], state["names"]
    speculate = state["speculate"]
    out = state["out"]
    host = [x.cpu().numpy() for x in out[:6] + (out[7:12] if speculate else ())]
    unsched, asum, feas_count, nnz, top_idx, top_val = host[:6]
    tis, tvs = _sorted_pairs(top_idx[:n], top_val[:n])
    window = top_idx.shape[1]
    real = sum(1 for nm in names if not nm.startswith("__shape-pad-"))
    cand_dev = state["cand_dev"]
    decoded = _decode_rows(raw, names, real, range(n), unsched, asum, feas_count, nnz,
                           tis, tvs, window, out[6], cand_dev=cand_dev)
    decisions = [decoded[j] for j in range(n)]
    if speculate and armed:
        a_unsched, a_asum, a_nnz, a_idx, a_val = host[6:11]
        a_tis, a_tvs = _sorted_pairs(a_idx[:n], a_val[:n])
        aug = _decode_rows(raw, names, real, list(armed), a_unsched, a_asum, feas_count,
                           a_nnz, a_tis, a_tvs, a_idx.shape[1], out[12], cand_dev=cand_dev)
        for j, dec in aug.items():
            decisions[j].speculative = dec
    return decisions


def armed_for_preemption(rb) -> bool:
    """Does this row want the speculative victim-augmented pass?
    PreemptLowerPriority and not a gang member (a gang commits whole or
    not at all)."""
    return rb.spec.preemption_policy == PREEMPT_LOWER_PRIORITY and not gang_of(rb)


# armed-row speculation cap: past this row count a uniform-priority chunk
# takes the standard solve and a short preemptor falls back to the
# planner's own launch. Mixed-priority chunks always tier.
SPECULATE_MAX_ROWS = 512


def wants_workload_solve(array: ArrayScheduler, bindings: Sequence,
                         preemption: bool = True) -> bool:
    """Route a batch through the workload-class launch? Mixed priorities
    (the segmented tiered solve) or any preemption-armed row (the
    speculative pass rides the same launch, up to SPECULATE_MAX_ROWS rows).
    Never under out-of-tree plugins."""
    if not bindings or array._oot_plugins:
        return False
    if (preemption and len(bindings) <= SPECULATE_MAX_ROWS
            and any(armed_for_preemption(rb) for rb in bindings)):
        return True
    return wants_tiers(array, bindings)


def _tier_reclaim(array: ArrayScheduler, bindings: list, placed) -> tuple:
    """(reclaim i64[n_tiers,C,R], armed row indices) for a speculative
    launch: per tier holding an armed row, every strictly-lower-priority
    placed replica's request folds into that tier's reclaimable matrix.
    Tiers without armed rows stay zero."""
    armed = [i for i, rb in enumerate(bindings) if armed_for_preemption(rb)]
    if not armed or placed is None:
        return None, armed
    resources = array.encoder.resources
    names = array.fleet.names
    col_of = {nm: c for c, nm in enumerate(names)}
    tier_of, n_tiers = _tier_assignment(bindings)
    C, R = len(names), len(resources)
    reclaim = np.zeros((n_tiers, C, R), np.int64)
    for t in sorted({int(tier_of[i]) for i in armed}):
        row = next(i for i in armed if tier_of[i] == t)
        for rb in victim_candidates(placed, bindings[row]):
            units = _request_units(rb, resources)
            for tc in rb.spec.clusters:
                c = col_of.get(tc.name)
                if c is not None and tc.replicas > 0:
                    reclaim[t, c] += units * tc.replicas
    return reclaim, armed


def launch_tiered(array: ArrayScheduler, bindings: Sequence, extra_avail=None,
                  placed=None) -> dict:
    """Launch one workload-class batch; `array.materialize_chunk` finishes
    it (the pending carries the "tiered" marker). Mixed priorities solve as
    the segmented tiered pass; preemption-armed rows also solve their
    victim-augmented variant in the same launch (`placed` is the
    victim-candidate snapshot). Spread and multi-term rows take the
    standard round inside the same pending. `extra_avail`: None, or the
    estimator answers i32[len(bindings), c] (EstimatorRegistry.
    batch_estimates), split over the two row sets."""
    bindings = list(bindings)
    if extra_avail is not None:
        extra_avail = np.asarray(extra_avail, np.int32)
    kernel_rows, std_rows = _eligible_rows(bindings)
    state = std_state = None
    armed: list[int] = []
    if kernel_rows:
        krows = [bindings[i] for i in kernel_rows]
        sub_extra = None if extra_avail is None else extra_avail[kernel_rows]
        reclaim, armed = _tier_reclaim(array, krows, placed)
        state = _launch_kernel_rows(array, krows, sub_extra, reclaim_tiers=reclaim)
    if std_rows:
        sub_extra = None if extra_avail is None else extra_avail[std_rows]
        std_state = array._launch_solve([bindings[i] for i in std_rows], sub_extra)
    return {
        "tiered": True, "bindings": bindings,
        "kernel_rows": kernel_rows, "std_rows": std_rows,
        "state": state, "std_state": std_state, "armed": armed,
        "n_tiers": state["n_tiers"] if state else 1,
        # the chunk API's replay split: tiered rows never replay (their
        # decisions depend on the batch's composition)
        "replayed": 0, "solved": len(bindings),
    }


def materialize_tiered(array: ArrayScheduler, pending: dict) -> list[ScheduleDecision]:
    out: list[Optional[ScheduleDecision]] = [None] * len(pending["bindings"])
    if pending["state"] is not None:
        decoded = _materialize_kernel_rows(pending["state"], armed=pending["armed"])
        for i, dec in zip(pending["kernel_rows"], decoded):
            out[i] = dec
    if pending["std_state"] is not None:
        for i, dec in zip(pending["std_rows"], array._materialize_solve(pending["std_state"])):
            out[i] = dec
    return out


# --------------------------------------------------------------------------
# the sequential reference (the executable parity contract)
# --------------------------------------------------------------------------


def solve_tiers_sequential(clusters: Sequence, bindings: Sequence,
                           device=None) -> list[ScheduleDecision]:
    """The contract the tiered launch is held to: each priority tier
    (descending) solves as its own ArrayScheduler round on a fleet whose
    allocated capacity has grown by every higher tier's placed
    consumption. O(tiers) rounds and a fleet re-encode per tier; for tests
    and documentation, never a hot path."""
    bindings = list(bindings)
    decisions: list[Optional[ScheduleDecision]] = [None] * len(bindings)
    cur = [copy.deepcopy(c) for c in clusters]
    prios = sorted({priority_of(rb) for rb in bindings}, reverse=True)
    for prio in prios:
        rows = [i for i, rb in enumerate(bindings) if priority_of(rb) == prio]
        sched = ArrayScheduler(cur, device=device)
        for i, dec in zip(rows, sched.schedule([bindings[i] for i in rows])):
            decisions[i] = dec
        # this tier's placements enter `allocated`, so the next tier's
        # capacity = allocatable - allocated shrinks as the launch's
        # consumption does
        by_name = {c.name: c for c in cur}
        for i in rows:
            dec = decisions[i]
            rb = bindings[i]
            if not dec.ok or not dec.targets:
                continue
            rr = rb.spec.replica_requirements
            req = rr.resource_request if rr is not None else {}
            for tc in dec.targets:
                c = by_name.get(tc.name)
                if c is None or c.status.resource_summary is None:
                    continue
                rs = c.status.resource_summary
                for rname, val in req.items():
                    rs.allocated[rname] = rs.allocated.get(rname, 0.0) + val * tc.replicas
    return decisions


# --------------------------------------------------------------------------
# preemption: plan / preview
# --------------------------------------------------------------------------


@dataclass
class VictimCut:
    """One victim replica reduction: `replicas` reclaimed from `cluster`."""

    key: str  # victim binding namespace/name
    cluster: str
    replicas: int
    priority: int = 0


@dataclass
class PreemptionPlan:
    key: str  # preemptor binding namespace/name
    priority: int = 0
    feasible: bool = False
    error: str = ""
    targets: list[TargetCluster] = field(default_factory=list)
    victims: list[VictimCut] = field(default_factory=list)

    def victim_keys(self) -> list[str]:
        seen: list[str] = []
        for v in self.victims:
            if v.key not in seen:
                seen.append(v.key)
        return seen


def victim_candidates(bindings: Sequence, preemptor) -> list:
    """Placed bindings the preemptor may evict from: strictly lower
    priority, same scheduler, not suspended or deleting, not gang members."""
    prio = priority_of(preemptor)
    sched_name = preemptor.spec.scheduler_name or ""
    out = []
    for rb in bindings:
        if rb.metadata.key() == preemptor.metadata.key():
            continue
        if priority_of(rb) >= prio:
            continue
        if not rb.spec.clusters:
            continue
        if (rb.spec.scheduler_name or "") != sched_name:
            continue
        if rb.metadata.deletion_timestamp is not None:
            continue
        if rb.spec.scheduling_suspended() or gang_of(rb):
            continue
        out.append(rb)
    return out


# request-unit vectors memoized per (uid, generation, resource count);
# cleared wholesale when it outgrows the working set
_UNITS_MEMO: dict = {}


def _request_units(rb, resources: Sequence[str]) -> np.ndarray:
    """Per-replica request in the fleet's integer units (cpu milli), zero
    for resources outside the vocabulary."""
    key = (rb.metadata.uid, rb.metadata.generation, len(resources))
    hit = _UNITS_MEMO.get(key) if rb.metadata.uid else None
    if hit is not None:
        return hit
    req = np.zeros(len(resources), np.int64)
    rr = rb.spec.replica_requirements
    if rr is not None:
        for rname, val in rr.resource_request.items():
            try:
                r = resources.index(rname)
            except ValueError:
                continue
            req[r] = to_int_units(rname, val)
    if rb.metadata.uid:
        if len(_UNITS_MEMO) > 16384:
            _UNITS_MEMO.clear()
        _UNITS_MEMO[key] = req
    return req


class PlanLedger:
    """Accounting across the priority groups of one preemption pass: each
    group's victim selection sees the free capacity and the victim replicas
    earlier groups already claimed, so two preemptors never count the same
    units twice."""

    def __init__(self, free: np.ndarray):
        self.free_left = np.maximum(np.asarray(free, np.int64), 0).copy()
        self.victim_cut: dict[tuple[str, int], int] = {}

    def cut_so_far(self, key: str, c: int) -> int:
        return self.victim_cut.get((key, int(c)), 0)

    def note_cut(self, key: str, c: int, replicas: int) -> None:
        k = (key, int(c))
        self.victim_cut[k] = self.victim_cut.get(k, 0) + replicas


def plan_preemption(array: ArrayScheduler, placed: Sequence, preemptors: Sequence,
                    ledger: Optional[PlanLedger] = None) -> list[PreemptionPlan]:
    """Second solve pass for short-placed preemptors: ONE victim-augmented
    launch per distinct preemptor priority, then the host victim selection.
    Reads the fleet encoding and the binding snapshots, mutates nothing."""
    resources = array.encoder.resources
    names = array.fleet.names
    col_of = {nm: c for c, nm in enumerate(names)}
    if ledger is None:
        ledger = PlanLedger(np.asarray(array.fleet.capacity, np.int64))
    plans: list[PreemptionPlan] = []
    by_prio: dict[int, list] = {}
    for rb in preemptors:
        by_prio.setdefault(priority_of(rb), []).append(rb)
    for prio in sorted(by_prio, reverse=True):
        group = by_prio[prio]
        cands = victim_candidates(placed, group[0])
        plans.extend(_plan_priority_group(array, group, cands, prio, resources, names,
                                          col_of, ledger))
    return plans


def _plan_priority_group(array, group, cands, prio, resources, names, col_of,
                         ledger=None) -> list[PreemptionPlan]:
    C = len(names)
    R = len(resources)
    if not cands:
        return [PreemptionPlan(key=rb.metadata.key(), priority=prio,
                               error="no lower-priority replicas to reclaim")
                for rb in group]
    # reclaimable capacity: every strictly-lower-priority placed replica's
    # request, folded per cluster
    reclaim = np.zeros((C, R), np.int64)
    for rb in cands:
        units = _request_units(rb, resources)
        for tc in rb.spec.clusters:
            c = col_of.get(tc.name)
            if c is not None and tc.replicas > 0:
                reclaim[c] += units * tc.replicas
    capacity = np.asarray(array.fleet.capacity, np.int64) + reclaim
    state = _launch_kernel_rows(array, list(group), capacity_override=capacity,
                                count="preempt")
    decisions = _materialize_kernel_rows(state)
    return _plans_from_decisions(array, group, decisions, cands, prio, resources, names,
                                 col_of, ledger=ledger)


def _plans_from_decisions(array, group, decisions, cands, prio, resources, names, col_of,
                          ledger: Optional[PlanLedger] = None) -> list[PreemptionPlan]:
    """The host half of a preemption plan: victim selection for a group of
    solved augmented decisions, shared by the standalone planner and the
    speculative path so the two cannot select different victims for the
    same solve. Deficits add up per cluster, so preemptors landing on one
    cluster select a joint victim set."""
    C = len(names)
    R = len(resources)
    cand_units = {rb.metadata.key(): _request_units(rb, resources) for rb in cands}
    if ledger is None:
        ledger = PlanLedger(np.asarray(array.fleet.capacity, np.int64))
    deficit = np.zeros((C, R), np.int64)
    plans = []
    for rb, dec in zip(group, decisions):
        plan = PreemptionPlan(key=rb.metadata.key(), priority=prio)
        if dec is None or not dec.ok:
            plan.error = (dec.error if dec is not None else "") or "preemption solve placed short"
            plans.append(plan)
            continue
        plan.feasible = True
        plan.targets = list(dec.targets or [])
        units = _request_units(rb, resources)
        for tc in plan.targets:
            c = col_of.get(tc.name)
            if c is not None:
                deficit[c] += units * tc.replicas
        plans.append(plan)
    need = np.maximum(deficit - ledger.free_left, 0)
    # this group's placements consume the free units first; later groups
    # see only the remainder
    ledger.free_left = np.maximum(ledger.free_left - deficit, 0)
    victims = _select_victims(need, cands, cand_units, col_of, names, ledger=ledger)
    feasible_plans = [p for p in plans if p.feasible]
    if victims is None:
        # the greedy could not cover the deficit: not safely committable
        for p in feasible_plans:
            p.feasible = False
            p.error = "victim selection could not cover the deficit"
        return plans
    for p in feasible_plans:
        p.victims = victims
    return plans


def plan_from_speculative(array, placed, pairs,
                          ledger: Optional[PlanLedger] = None) -> list[PreemptionPlan]:
    """Preemption plans for rows whose victim-augmented decision already
    rode the admission launch (decision.speculative): no extra launch, only
    the host victim selection. `pairs` is [(binding, speculative
    decision), ...]."""
    resources = array.encoder.resources
    names = array.fleet.names
    col_of = {nm: c for c, nm in enumerate(names)}
    if ledger is None:
        ledger = PlanLedger(np.asarray(array.fleet.capacity, np.int64))
    by_prio: dict[int, list] = {}
    for rb, dec in pairs:
        by_prio.setdefault(priority_of(rb), []).append((rb, dec))
    plans: list[PreemptionPlan] = []
    for prio in sorted(by_prio, reverse=True):
        group = by_prio[prio]
        cands = victim_candidates(placed, group[0][0])
        if not cands:
            plans.extend(PreemptionPlan(key=rb.metadata.key(), priority=prio,
                                        error="no lower-priority replicas to reclaim")
                         for rb, _d in group)
            continue
        plans.extend(_plans_from_decisions(
            array, [rb for rb, _d in group], [d for _rb, d in group],
            cands, prio, resources, names, col_of, ledger=ledger,
        ))
    return plans


def _select_victims(need: np.ndarray, cands, cand_units, col_of, names,
                    ledger: Optional[PlanLedger] = None) -> Optional[list[VictimCut]]:
    """Minimal-disruption greedy per cluster: candidate priorities
    ascending; within a priority the candidate covering the most deficit
    first, youngest placement next, binding key last; cut only as many
    replicas as the deficit needs. None when the deficit cannot be
    covered."""
    cuts: list[VictimCut] = []
    deficit_cols = np.nonzero(need.any(axis=1))[0]
    if not len(deficit_cols):
        return cuts
    n = len(cands)
    prio = np.fromiter((priority_of(rb) for rb in cands), np.int64, n)
    age = np.fromiter(((rb.status.last_scheduled_time or 0.0) for rb in cands), np.float64, n)
    units_mat = (np.stack([cand_units[rb.metadata.key()] for rb in cands]) if n
                 else np.zeros((0, need.shape[1]), np.int64))
    keys = [rb.metadata.key() for rb in cands]
    key_rank = np.argsort(np.argsort(keys))
    on_cluster = np.zeros((n, len(deficit_cols)), np.int64)
    col_pos = {int(c): i for i, c in enumerate(deficit_cols)}
    for i, rb in enumerate(cands):
        for tc in rb.spec.clusters:
            p = col_pos.get(col_of.get(tc.name, -1))
            if p is not None:
                on_cluster[i, p] = tc.replicas
    for p, c in enumerate(deficit_cols):
        rem = need[c].copy()
        on_c = on_cluster[:, p]
        helps = (on_c > 0) & ((units_mat > 0) & (rem[None, :] > 0)).any(1)
        idx = np.nonzero(helps)[0]
        if len(idx):
            cover = np.minimum(units_mat[idx] * on_c[idx, None], rem[None, :]).sum(1)
            # order: priority asc, coverage desc, youngest first, key asc
            order = np.lexsort((key_rank[idx], -age[idx], -cover, prio[idx]))
            for i in idx[order]:
                if not (rem > 0).any():
                    break
                units = units_mat[i]
                sel = (units > 0) & (rem > 0)
                if not sel.any():
                    continue
                # the minimal cut covering what this victim can address,
                # capped by its replicas on the cluster less what an
                # earlier group of this pass already claimed
                avail = int(on_c[i])
                if ledger is not None:
                    avail -= ledger.cut_so_far(keys[i], int(c))
                cut = int(min(avail, int(-(-rem[sel] // units[sel]).max())))
                if cut <= 0:
                    continue
                rem = np.maximum(rem - units * cut, 0)
                if ledger is not None:
                    ledger.note_cut(keys[i], int(c), cut)
                cuts.append(VictimCut(key=keys[i], cluster=names[int(c)], replicas=cut,
                                      priority=int(prio[i])))
        if (rem > 0).any():
            return None
    return cuts


def preview_preemption(clusters: Sequence, bindings: Sequence, preemptor,
                       device=None) -> PreemptionPlan:
    """The preemption preview: the planner on a fresh fleet encoding of the
    same snapshot the live planner would see, so its victim set is the
    live one; mutates nothing. The preemptor's current placement, if any,
    is ignored."""
    pre = copy.deepcopy(preemptor)
    pre.spec.clusters = []
    array = ArrayScheduler(sorted(clusters, key=lambda c: c.name), device=device)
    placed = [rb for rb in bindings if rb.metadata.key() != pre.metadata.key()]
    return plan_preemption(array, placed, [pre])[0]
