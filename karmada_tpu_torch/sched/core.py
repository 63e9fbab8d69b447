"""The batched scheduling core (PyTorch port, compact candidate round).

Port of sched/core.py's ArrayScheduler for the round every fleet wider than
the candidate window takes (sched/candidates.py): the per-binding
sequential loop of pkg/scheduler/core/generic_scheduler.go:70-115 becomes
one candidate-select launch over [B, C] and one division-tail launch per
row class over [rows, K] windows.

The dense round, spread constraints, tiers, the mesh and the incremental
replay are later slices; the paths that would reach them raise
NotImplementedError instead of running anything else.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..api.work import TargetCluster
from ..models.batch import (
    AGGREGATED,
    DUPLICATED,
    DYNAMIC_WEIGHT,
    STATIC_WEIGHT,
    BatchEncoder,
    BindingBatch,
    shape_bucket,
    shape_floor,
)
from ..models.fleet import FleetArrays, FleetEncoder
from ..ops import assign as assign_ops
from ..ops import filters as filter_ops
from . import plugins as plugin_mod

I64 = torch.int64
I32 = torch.int32

# compact-output width: covers every row whose target count is <= this
# (divided rows are bounded by spec.replicas; wider rows fetch their full
# window row as a fallback)
TOPK_TARGETS = 128


def unpack_row(packed_row: np.ndarray, n_cols: int) -> np.ndarray:
    """Host-side inverse of `pack_bits` for one row."""
    bits = np.unpackbits(packed_row, bitorder="little")[:n_cols]
    return np.nonzero(bits)[0]


class ScheduleDecision:
    """Outcome for one binding.

    Target/feasible lists materialize LAZILY from array-backed sources: a
    duplicated row can span hundreds of clusters, and building those
    TargetCluster objects eagerly for 10k rows costs seconds of host time
    before anything consumes them. Consumers see plain lists via the
    `targets`/`feasible` properties; assigning a list works too."""

    __slots__ = ("key", "error", "affinity_name",
                 "_targets", "_targets_src", "_feasible", "_feasible_src")

    def __init__(self, key: str, targets=None, error: str = "",
                 feasible=None, affinity_name: str = ""):
        self.key = key
        self.error = error  # non-empty ⇒ unschedulable / fit error
        self.affinity_name = affinity_name  # applied ordered-affinity term
        self._targets = targets
        self._targets_src = None
        self._feasible = feasible
        self._feasible_src = None

    @property
    def ok(self) -> bool:
        return not self.error

    @property
    def targets(self) -> Optional[list[TargetCluster]]:
        if self._targets is None and self._targets_src is not None:
            src = self._targets_src
            if src[0] == "pairs":  # pre-sorted (cluster idx, replicas) arrays
                _, names, idxs, reps = src
                self._targets = [
                    TargetCluster(name=names[int(i)], replicas=int(r))
                    for i, r in zip(idxs, reps)
                ]
            else:  # ("mask", names, packed_bits, n_cols, replicas_per_cluster)
                _, names, packed, n_cols, reps = src
                self._targets = [
                    TargetCluster(name=names[int(i)], replicas=int(reps))
                    for i in unpack_row(packed, n_cols)
                ]
        return self._targets

    @targets.setter
    def targets(self, v) -> None:
        self._targets = v
        self._targets_src = None

    @property
    def feasible(self) -> list[str]:
        if self._feasible is None and self._feasible_src is not None:
            _, names, packed, n_cols = self._feasible_src  # ("mask", ...)
            self._feasible = [names[int(i)] for i in unpack_row(packed, n_cols)]
        return self._feasible if self._feasible is not None else []

    @feasible.setter
    def feasible(self, v) -> None:
        self._feasible = v
        self._feasible_src = None


# --------------------------------------------------------------------------
# plain tensor functions (the CPU path, and the plain versions the kernels
# are held against)
# --------------------------------------------------------------------------


def filter_phase(
    alive, taint_key, taint_value, taint_effect, api_ok, gvk,
    tol_tables, tol_idx, affinity_ok, eviction_ok, prev_member,
    plugin_bits: int = plugin_mod.ALL_PLUGIN_BITS,
):
    """Filter masks + static score WITHOUT the estimator, over [B, C].
    Tolerations ride the factored [T,4,K] table: the taint mask is computed
    once per DISTINCT toleration row and gathered by `tol_idx` — each row's
    tolerations are exactly its table row, so this is the dense mask."""
    B, C = affinity_ok.shape
    ones = torch.ones((B, C), dtype=torch.bool, device=affinity_ok.device)
    if plugin_bits & plugin_mod.BIT_TAINT:
        per_tol = filter_ops.taint_toleration_mask(
            taint_key, taint_value, taint_effect,
            tol_tables[:, 0], tol_tables[:, 1], tol_tables[:, 2], tol_tables[:, 3],
        )
        taint_mask = per_tol[tol_idx.long()]
    else:
        taint_mask = ones
    api_mask = (
        filter_ops.api_enablement_mask(api_ok, gvk)
        if plugin_bits & plugin_mod.BIT_API
        else ones
    )
    feasible = filter_ops.feasible_mask(
        alive, api_mask, taint_mask,
        affinity_ok if plugin_bits & plugin_mod.BIT_AFFINITY else ones,
        eviction_ok if plugin_bits & plugin_mod.BIT_EVICTION else ones,
    )
    score = (
        filter_ops.locality_score(prev_member)
        if plugin_bits & plugin_mod.BIT_LOCALITY
        else torch.zeros((B, C), dtype=I32, device=feasible.device)
    )
    return feasible, score


def sparse_rows(prev_idx, prev_rep, evict_idx, n_cols: int):
    """Dense (prev_member, prev_replicas, eviction_ok) [B, C] from the
    sparse per-row entries. Indices outside [0, C) — the encoder's C
    sentinel included — are dropped. A column listed twice takes its LAST
    entry (columns scatter one at a time)."""
    B = prev_idx.shape[0]
    dev = prev_idx.device
    p = torch.where((prev_idx >= 0) & (prev_idx < n_cols), prev_idx, n_cols).long()
    prev_member = torch.zeros((B, n_cols + 1), dtype=torch.bool, device=dev)
    prev_replicas = torch.zeros((B, n_cols + 1), dtype=I32, device=dev)
    for j in range(p.shape[1]):
        prev_member.scatter_(1, p[:, j:j + 1], True)
        prev_replicas.scatter_(1, p[:, j:j + 1], prev_rep[:, j:j + 1].to(I32))
    e = torch.where((evict_idx >= 0) & (evict_idx < n_cols), evict_idx, n_cols).long()
    eviction_ok = torch.ones((B, n_cols + 1), dtype=torch.bool, device=dev)
    eviction_ok.scatter_(1, e, False)
    return prev_member[:, :n_cols], prev_replicas[:, :n_cols], eviction_ok[:, :n_cols]


_MIX1 = 0xBF58476D1CE4E5B9 - 2**64  # splitmix64 multipliers as int64 bits
_MIX2 = 0x94D049BB133111EB - 2**64


def _lshr(x, s: int):
    """Logical right shift of int64 bits (torch's >> is arithmetic and has
    no uint64 form on the CPU)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def tie_at(seeds, cols):
    """splitmix64 tie values AT global cluster columns — the per-(binding,
    cluster) stream of models/batch.py tie_matrix. `seeds` are the u64 UID
    seeds held as int64 bits ([B]); `cols` are 0-based global indices
    ([B, K]). Multiplies wrap in int64 exactly as in uint64."""
    x = seeds[:, None] ^ (cols.to(I64) + 1)
    x = (x ^ _lshr(x, 30)) * _MIX1
    x = (x ^ _lshr(x, 27)) * _MIX2
    x = x ^ _lshr(x, 31)
    return _lshr(x, 33).to(I32)


def pack_bits(sel):
    """bool[B, C] → u8[B, ceil(C/8)], bit order little (bit j of byte i is
    column 8i+j)."""
    B, C = sel.shape
    pad = (-C) % 8
    if pad:
        sel = torch.nn.functional.pad(sel, (0, pad))
    bits = sel.reshape(B, -1, 8).to(I32)
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=I32, device=sel.device)
    return (bits * w).sum(-1).to(torch.uint8)


def top_k_ordered(values, k: int):
    """Indices of the top k entries per row in (value desc, column asc)
    order — jax.lax.top_k's order. torch.topk orders equal values
    arbitrarily, so the column is folded into a unique int64 key; values
    must fit 64 - bit_length(C - 1) signed bits (the callers' keys use
    at most 35)."""
    C = values.shape[-1]
    cb = max((C - 1).bit_length(), 1)
    iota = torch.arange(C, device=values.device)
    comp = (values.to(I64) << cb) | ((1 << cb) - 1 - iota)
    return torch.topk(comp, k, dim=-1, sorted=True).indices


def assignment_tail(
    feasible, strategy, static_weight, avail, prev_replicas, tie, replicas,
    fresh, has_agg: bool = True,
):
    """Strategy dispatch + division over the row's columns (binding.go:112-144):
    static + dynamic rows share one dispenser pass."""
    dup = assign_ops.duplicated_assign(feasible, replicas)
    is_static = strategy == STATIC_WEIGHT
    is_dyn = (strategy == DYNAMIC_WEIGHT) | (strategy == AGGREGATED)
    sd = assign_ops.combined_assign(
        feasible, is_static, is_dyn, strategy == AGGREGATED,
        static_weight, avail, prev_replicas, tie, replicas, fresh,
        has_agg=has_agg,
    )
    result = torch.zeros_like(dup)
    result = torch.where((strategy == DUPLICATED)[:, None], dup, result)
    result = torch.where((is_static | is_dyn)[:, None], sd.result, result)
    unschedulable = is_dyn & sd.unschedulable
    return result, unschedulable, sd.available_sum


def compact_outputs(feasible, result, topk: int):
    """Top-K sparsification of the decision tensor: (feas_count, nnz,
    top_idx, top_val), the window in (value desc, column asc) order."""
    top_idx = top_k_ordered(result, topk)
    top_val = result.gather(-1, top_idx)
    nnz = (result > 0).sum(-1).to(I32)
    feas_count = feasible.sum(-1).to(I32)
    return feas_count, nnz, top_idx.to(I32), top_val


def _sorted_pairs(top_idx, top_val):
    """Order each row's compact (cluster idx, replicas) window by cluster
    index, parking the zero-replica padding at the end — shared by every
    decode site so the sentinel logic can never drift."""
    order = np.argsort(
        np.where(top_val > 0, top_idx, np.int32(1 << 30)), axis=1, kind="stable"
    )
    return (
        np.take_along_axis(top_idx, order, 1),
        np.take_along_axis(top_val, order, 1),
    )


def _pad_rows_idx(rows: Sequence[int], bucket_fn) -> tuple[np.ndarray, int]:
    """Pad a row-index list to a bucket (pads repeat the first row; callers
    slice the result back to len(rows))."""
    n = len(rows)
    b = bucket_fn(n)
    idx = np.empty(b, np.int32)
    idx[:n] = rows
    idx[n:] = rows[0] if n else 0
    return idx, n


def pad_batch(batch: BindingBatch, bucket_fn) -> BindingBatch:
    """Pad a batch's row axis to bucket_fn(B) — padded rows are strategy 0 /
    replicas 0 and are never decoded."""
    B = batch.size
    Bp = bucket_fn(B)
    if Bp == B:
        return batch
    pad = Bp - B

    def pz(a, fill=0):
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    return BindingBatch(
        keys=batch.keys,
        uids=batch.uids,
        replicas=pz(batch.replicas),
        unknown_request=pz(batch.unknown_request),
        gvk=pz(batch.gvk),
        strategy=pz(batch.strategy),
        fresh=pz(batch.fresh),
        tol_tables=batch.tol_tables,
        tol_idx=pz(batch.tol_idx),
        aff_masks=batch.aff_masks,
        aff_idx=pz(batch.aff_idx),
        weight_tables=batch.weight_tables,
        weight_idx=pz(batch.weight_idx),
        prev_idx=pz(batch.prev_idx, fill=batch.n_clusters),
        prev_rep=pz(batch.prev_rep),
        evict_idx=pz(batch.evict_idx, fill=batch.n_clusters),
        seeds=pz(batch.seeds),
        n_clusters=batch.n_clusters,
        req_unique=batch.req_unique,
        req_idx=None if batch.req_idx is None else pz(batch.req_idx),
    )


def resolve_max_bc_elems() -> int:
    """THE [B,C]-elements-per-launch budget: KARMADA_TPU_MAX_BC_ELEMS, else
    2<<27. A malformed value fails loudly."""
    env = os.environ.get("KARMADA_TPU_MAX_BC_ELEMS", "")
    if not env:
        return 2 << 27
    try:
        val = int(env)
    except ValueError:
        raise ValueError(f"KARMADA_TPU_MAX_BC_ELEMS={env!r}: must be an integer") from None
    if val <= 0:
        raise ValueError(f"KARMADA_TPU_MAX_BC_ELEMS={env!r}: must be positive")
    return val


def should_ignore_spread_constraint(placement) -> bool:
    """Static-weighted division ignores spread constraints
    (select_clusters.go:63-77)."""
    from ..api.policy import DIVISION_PREFERENCE_WEIGHTED, REPLICA_SCHEDULING_DIVIDED

    rs = placement.replica_scheduling
    return bool(
        rs is not None
        and rs.replica_scheduling_type == REPLICA_SCHEDULING_DIVIDED
        and rs.replica_division_preference == DIVISION_PREFERENCE_WEIGHTED
        and (
            rs.weight_preference is None
            or (rs.weight_preference.static_weight_list
                and not rs.weight_preference.dynamic_weight)
        )
    )


class ArrayScheduler:
    """Host wrapper: encodes fleet + batches, runs the kernels, decodes
    TargetClusters. Batch rows pad to the shape_bucket lattice and the
    fleet axis pads with dead clusters, exactly as the reference does, so
    pad columns, tie values and the names order match it."""

    def __init__(
        self,
        clusters: Sequence,
        plugins: Optional[Sequence[str]] = None,
        candidate_k: Optional[int] = None,
        device=None,
    ):
        """`device`: None means the CUDA card (RuntimeError without one);
        "cpu" runs the plain PyTorch path. `plugins`: the `--plugins`
        enable/disable list (default ["*"]). `candidate_k`: the candidate
        window (None reads KARMADA_TPU_CANDIDATE_K, default 128)."""
        from .candidates import resolve_candidate_k

        self.device = resolve_device(device)
        self.encoder = FleetEncoder()
        self.plugin_registry = plugin_mod.PluginRegistry()
        self.enabled_plugins = self.plugin_registry.filter(plugins)
        self._plugin_bits = plugin_mod.plugin_bits(self.enabled_plugins)
        self.max_bc_elems = resolve_max_bc_elems()
        self.candidate_k = resolve_candidate_k(candidate_k)
        self.last_candidate_stats: dict = {}
        self.set_clusters(clusters)

    def set_clusters(self, clusters: Sequence) -> None:
        """Re-encode the fleet and upload it to the device."""
        clusters = list(clusters)
        self.n_real_clusters = len(clusters)
        pad = (shape_bucket(len(clusters)) if clusters else 0) - len(clusters)
        if pad > 0:
            # the fleet axis pads to the shape_bucket lattice with dead
            # clusters (never Ready ⇒ never feasible ⇒ never decoded), as
            # the reference does, so every derived table sizes to the
            # bucketed width and tie values and names line up with it
            from ..api.cluster import Cluster, ClusterSpec
            from ..api.meta import ObjectMeta

            clusters += [
                Cluster(metadata=ObjectMeta(name=f"__shape-pad-{i}"),
                        spec=ClusterSpec())
                for i in range(pad)
            ]
        self.clusters = clusters
        self.fleet: FleetArrays = self.encoder.encode(self.clusters)
        self.batch_encoder = BatchEncoder(self.encoder, self.fleet, self.clusters)
        from ..convert import batch_from_numpy

        f = self.fleet
        self._fleet_dev = batch_from_numpy({
            "alive": f.alive, "capacity": f.capacity, "has_summary": f.has_summary,
            "taint_key": f.taint_key, "taint_value": f.taint_value,
            "taint_effect": f.taint_effect, "api_ok": f.api_ok,
        }, self.device)

    def _max_rows_per_round(self, n_cols: int) -> int:
        """Row cap per launched round under the [B,C] budget, floored to a
        shape_bucket lattice point."""
        return shape_floor(max(8, self.max_bc_elems // max(n_cols, 1)))

    _bucket = staticmethod(shape_bucket)

    def _pad(self, batch: BindingBatch) -> BindingBatch:
        return pad_batch(batch, self._bucket)

    def schedule(self, bindings: Sequence, extra_avail=None) -> list[ScheduleDecision]:
        """Schedule with the ordered-affinity-terms retry loop
        (scheduleResourceBindingWithClusterAffinities, scheduler.go:562-625).
        Rounds over the per-launch row cap run as serial row chunks (rows
        are independent and the tie-break is UID-seeded, so decisions do
        not depend on the chunking)."""
        if extra_avail is not None:
            raise NotImplementedError(
                "extra_avail from registered estimators is not ported yet "
                "(the estimator slice of the PyTorch port)"
            )
        if not bindings:
            return []
        bindings = list(bindings)
        max_rows = self._max_rows_per_round(len(self.fleet.names))
        out: list[ScheduleDecision] = []
        for s in range(0, len(bindings), max_rows):
            out += self._materialize_solve(self._launch_solve(bindings[s:s + max_rows]))
        return out

    @staticmethod
    def _affinity_terms_of(rb):
        p = rb.spec.placement
        return p.cluster_affinities if p is not None else []

    def _initial_term(self, rb) -> int:
        terms = self._affinity_terms_of(rb)
        if not terms:
            return 0
        observed = rb.status.scheduler_observed_affinity_name
        for i, t in enumerate(terms):
            if t.affinity_name == observed:
                return i
        return 0

    def _launch_solve(self, bindings: list):
        term_idx = [self._initial_term(rb) for rb in bindings]
        pending = self._launch_once(bindings, term_idx)
        return (bindings, term_idx, pending)

    def _materialize_solve(self, state) -> list[ScheduleDecision]:
        """Sync + decode, then the ordered-affinity retry loop (retried
        sub-batches solve serially) and the applied term names."""
        bindings, term_idx, pending = state
        decisions = self._materialize_once(pending)
        while True:
            retry = [
                b
                for b, d in enumerate(decisions)
                if not d.ok
                and term_idx[b] + 1 < len(self._affinity_terms_of(bindings[b]))
            ]
            if not retry:
                break
            for b in retry:
                term_idx[b] += 1
            sub_dec = self._schedule_once(
                [bindings[b] for b in retry], [term_idx[b] for b in retry]
            )
            for j, b in enumerate(retry):
                decisions[b] = sub_dec[j]
        for b, d in enumerate(decisions):
            terms = self._affinity_terms_of(bindings[b])
            if terms and d.ok:
                d.affinity_name = terms[term_idx[b]].affinity_name
        return decisions

    def _schedule_once(self, bindings: Sequence, term_indices=None) -> list[ScheduleDecision]:
        return self._materialize_once(self._launch_once(bindings, term_indices))

    def _launch_once(self, bindings: Sequence, term_indices=None) -> dict:
        from . import candidates as cand_mod

        self.last_candidate_stats = {}
        reason = cand_mod.dense_reason(self, bindings)
        if reason is not None:
            raise NotImplementedError(
                f"this round needs the dense solve (reason {reason!r}); the "
                "dense round is a later slice of the PyTorch port"
            )
        return cand_mod.launch_candidates(self, bindings, term_indices)

    def _materialize_once(self, pending: dict) -> list[ScheduleDecision]:
        from . import candidates as cand_mod

        return cand_mod.materialize_candidates(self, pending)

    def _classify_spread(self, bindings) -> list[int]:
        """Rows whose spread constraints take part in selection. The spread
        paths are a later slice: the candidate round raises on them."""
        return [
            b for b, rb in enumerate(bindings)
            if rb.spec.placement is not None
            and rb.spec.placement.spread_constraints
            and not should_ignore_spread_constraint(rb.spec.placement)
        ]

    def _row_class(self, rb, spread_row: bool) -> int:
        """0 = no division tail (dup / non-workload / spread rows),
        1 = static-weight or dynamic-weight tail, 2 = aggregated tail."""
        from ..models.batch import strategy_code

        if spread_row:
            return 0
        strat = strategy_code(rb.spec.placement, rb.spec.replicas)
        if strat == AGGREGATED:
            return 2
        if strat in (STATIC_WEIGHT, DYNAMIC_WEIGHT):
            return 1
        return 0
