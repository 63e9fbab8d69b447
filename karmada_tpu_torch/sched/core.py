"""The batched scheduling core (PyTorch port).

Port of sched/core.py's ArrayScheduler: the per-binding sequential loop of
pkg/scheduler/core/generic_scheduler.go:70-115 becomes a few kernel
launches over the whole round. Two rounds, as in the reference:

- the compact candidate round (sched/candidates.py) for fleets wider than
  the candidate window: one candidate-select launch over [B, C], then one
  division-tail launch per row class over [rows, K] windows;
- the dense round for small fleets, `candidate_k=0` and the `dense-solve`
  annotation (`dense_reason` not None): one dense-filter launch over
  [B, C], one wide-row division-tail launch per row class over full rows,
  and the feasible-index or packed-row launch for Duplicated and
  non-workload rows.

Spread-constrained rows ride both rounds. The compact round solves a row
whose feasible set fits its window on the host (sched/spread.py) and
re-solves wider rows through the dense round. The dense round scores every
(row, region) group in one launch, searches region combinations on the
host (sched/spread_batch.py), then launches the packed selection masks and
the division re-run over the selection; rows the batched path cannot take
(cluster-only constraints, cluster caps, zone/provider fields, ties and
wide divided rows) select per row and re-solve restricted to their
selection.

Priority tiers and preemption (sched/preemption.py) ride the same seam:
`launch_tiered` then `materialize_chunk`. Registered-estimator answers
(`extra_avail`, estimator/client.py) ride every round: permuted with the
rows, padded with the -1 no-answer sentinel, uploaded through one reusable
pinned buffer and min-merged into the estimate by the filter kernels.

Rounds over the per-launch row cap run as equal row chunks, serially by
default, or with `pipeline=True` through the chunk pipeline
(sched/pipeline.py): chunk k+1 encodes and launches on the caller's thread
while chunk k materializes on a writer thread, both on the caller's CUDA
stream (the pipelined executor measured slower than the serial one,
PERF.md §6). The replay cache
(sched/incremental.py) serves bindings whose inputs did not change since
the round that solved them
(`schedule_incremental`, `launch_chunk` / `materialize_chunk`), and a
status-only fleet change re-encodes only the dirty clusters and writes
their rows into the resident fleet tensors (`set_clusters(...,
dirty_names)`, the scatter_rows kernel).

Over a device mesh (`mesh=`, parallel/mesh.py) the monolithic mesh round
runs (`mesh_partitioned = False`, as the reference's explicit shard_map
mode): the mesh kernel solves every row (the tile filter on each
(row group, column shard) tile, the gather along the cluster axis, the
dense tail over the full rows) and the round decodes its compact outputs,
the spread overlay reading the gathered rows. The reference's default,
the partitioned mesh rounds, raise NotImplementedError.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..api.work import TargetCluster
from ..models.batch import (
    AGGREGATED,
    DUPLICATED,
    DYNAMIC_WEIGHT,
    NON_WORKLOAD,
    STATIC_WEIGHT,
    BatchEncoder,
    BindingBatch,
    pow2_bucket,
    shape_bucket,
    shape_floor,
)
from ..models.fleet import FleetArrays, FleetEncoder
from ..ops import assign as assign_ops
from ..ops import filters as filter_ops
from . import plugins as plugin_mod
from .pipeline import (
    ChunkPipeline,
    StageTimer,
    chunk_spans,
    plan_chunk_rows,
    resolve_pipeline,
    stage_span,
)

I64 = torch.int64
I32 = torch.int32

# the batch fields a round uploads to the device
_BATCH_FIELDS = (
    "replicas", "unknown_request", "gvk", "strategy", "fresh", "tol_tables", "tol_idx",
    "aff_masks", "aff_idx", "weight_tables", "weight_idx", "prev_idx", "prev_rep",
    "evict_idx", "seeds", "req_unique", "req_idx",
)

# the resident fleet tensors (`_fleet_dev`)
_FLEET_FIELDS = ("alive", "capacity", "has_summary", "taint_key", "taint_value",
                 "taint_effect", "api_ok")

# compact-output width: covers every row whose target count is <= this
# (divided rows are bounded by spec.replicas; wider rows fetch their full
# window row as a fallback)
TOPK_TARGETS = 128

# pipelined-round chunking policy (sched/pipeline.py): a daemon round is cut
# into ~PIPELINE_CHUNKS chunks so the estimate/encode/solve/materialize/patch
# stages overlap across them, but never below PIPELINE_MIN_ROWS rows per
# chunk — tiny launches pay more in dispatch than overlap buys back
PIPELINE_MIN_ROWS = 256
PIPELINE_CHUNKS = 8


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

    __slots__ = ("key", "error", "affinity_name", "speculative",
                 "_targets", "_targets_src", "_feasible", "_feasible_src")

    def __init__(self, key: str, targets=None, error: str = "",
                 feasible=None, affinity_name: str = ""):
        self.key = key
        self.error = error  # non-empty ⇒ unschedulable / fit error
        self.affinity_name = affinity_name  # applied ordered-affinity term
        # the victim-augmented decision of a tiered launch's speculative
        # pass (sched/preemption.py): a short placement's preemption plan
        # reads it instead of paying a second launch
        self.speculative: Optional[ScheduleDecision] = None
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
            src = self._feasible_src
            if src[0] == "mask":
                _, names, packed, n_cols = src
                self._feasible = [names[int(i)] for i in unpack_row(packed, n_cols)]
            else:  # ("idx", names, idx_array)
                _, names, idxs = src
                self._feasible = [names[int(i)] for i in idxs]
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


def filter_estimate_phase(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    affinity_ok, eviction_ok, prev_member, req_unique, req_idx,
    plugin_bits: int = plugin_mod.ALL_PLUGIN_BITS,
):
    """Filters + score + the GeneralEstimator over [B, C]: `filter_phase`,
    the unique-request estimate gathered to rows with its clamps, and 0
    available where a request names a resource outside the encoded
    vocabulary (general.go:166-169)."""
    feasible, score = filter_phase(
        alive, taint_key, taint_value, taint_effect, api_ok, gvk,
        tol_tables, tol_idx, affinity_ok, eviction_ok, prev_member,
        plugin_bits=plugin_bits,
    )
    est_u, any_u = assign_ops.general_estimate_unique(capacity, has_summary, req_unique)
    avail = assign_ops.general_estimate_apply(est_u, any_u, req_idx, has_summary, replicas)
    avail = torch.where(unknown_request[:, None], 0, avail)
    return feasible, score, avail


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


def tie_from_index(seeds, idx):
    """splitmix64 tie values from explicit 1-based GLOBAL cluster indices
    (the reference's `tie_from_index`): `seeds` are the u64 UID seeds held
    as int64 bits ([B]); `idx` (int64 bits of the u64 index) broadcasts
    against [B, 1]: [C] for one column space, [B, K] per row, [S, 1, C]
    per scenario (the simulation plane's remapped column spaces, where a
    drained cluster vanishes from the index range). Multiplies wrap in
    int64 exactly as in uint64."""
    x = seeds[:, None] ^ idx.to(I64)
    x = (x ^ _lshr(x, 30)) * _MIX1
    x = (x ^ _lshr(x, 27)) * _MIX2
    x = x ^ _lshr(x, 31)
    return _lshr(x, 33).to(I32)


def tie_at(seeds, cols):
    """splitmix64 tie values AT global cluster columns — the per-(binding,
    cluster) stream of models/batch.py tie_matrix. `cols` are 0-based
    global indices ([B, K] or [C])."""
    return tie_from_index(seeds, cols.to(I64) + 1)


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


def _schedule_body(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, request, unknown_request, gvk, strategy, fresh,
    tol_key, tol_value, tol_effect, tol_op,
    affinity_ok, eviction_ok, static_weight, prev_member, prev_replicas, tie,
    extra_avail,
):
    """The dense-input program in plain tensor ops (the reference's
    `_schedule_body` with every in-tree plugin on): the filter and estimate
    over the dense row inputs, the min-merge of the answers (-1 = none,
    core/util.go:72-92), then the division tail over every row. Returns
    (feasible bool[B,C], score i32, result i32, unschedulable bool[B],
    avail_sum i32[B], avail i32[B,C])."""
    from ..kernels import dense_input_filter_plain

    feasible, score, avail = dense_input_filter_plain(
        alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
        replicas, request, unknown_request, gvk, tol_key, tol_value, tol_effect, tol_op,
        affinity_ok, eviction_ok, prev_member, extra_avail,
    )
    result, unschedulable, avail_sum = assignment_tail(
        feasible, strategy, static_weight, avail, prev_replicas, tie, replicas, fresh,
    )
    return feasible, score, result, unschedulable, avail_sum, avail


def _schedule_kernel(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, request, unknown_request, gvk, strategy, fresh,
    tol_key, tol_value, tol_effect, tol_op,
    affinity_ok, eviction_ok, static_weight, prev_member, prev_replicas, tie,
    extra_avail,
):
    """The dense-input schedule program (the reference's `_schedule_kernel`,
    the graft entry's flagship program): the 24 dense tensors in the
    reference's order, all on one device (fleet: alive bool[C], capacity
    i64[C,R], has_summary bool[C], taints i32[C,T], api_ok bool[C,G];
    rows: replicas i32[B], request i64[B,R], unknown_request bool[B], gvk
    / strategy i32[B], fresh bool[B], tolerations i32[B,K] x4,
    affinity_ok / eviction_ok / prev_member bool[B,C], static_weight
    i64[B,C], prev_replicas / tie i32[B,C], extra_avail i32[B,C], -1 = no
    answer). `prev_member` feeds the locality score and `prev_replicas`
    the tail; they need not agree. On the CPU it runs `_schedule_body`; on
    the card the dense-input filter kernel, then the dense tail over every
    row (static weights as a [B, C] table read at row b, with no output
    window: the program returns none). Returns `_schedule_body`'s six
    outputs."""
    dev = alive.device
    if dev.type == "cpu":
        return _schedule_body(
            alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
            replicas, request, unknown_request, gvk, strategy, fresh,
            tol_key, tol_value, tol_effect, tol_op,
            affinity_ok, eviction_ok, static_weight, prev_member, prev_replicas, tie,
            extra_avail,
        )
    from .. import kernels

    feasible, score, avail = kernels.dense_input_filter(
        alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
        replicas, request, unknown_request, gvk, tol_key, tol_value, tol_effect, tol_op,
        affinity_ok, eviction_ok, prev_member, extra_avail,
    )
    B = feasible.shape[0]
    rows = torch.arange(B, dtype=I32, device=dev)
    result, unschedulable, avail_sum, *_ = kernels.dense_tail(
        feasible, avail, prev_replicas, tie, rows, static_weight, rows, strategy, replicas,
        fresh, topk=0, has_agg=True,
    )
    return feasible, score, result, unschedulable, avail_sum, avail


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


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` without a stream sync: a plain copy from
    pageable memory waits for every launch queued before it, so on a card
    the array travels through pinned memory, non-blocking."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def to_device_packed(arrays: Sequence[np.ndarray], device) -> list[torch.Tensor]:
    """Host arrays on `device` in one copy: on a card their bytes go into
    one pinned buffer (each at a 16-byte boundary), which travels without a
    stream sync and is cut into views of the arrays' dtypes and shapes; on
    the CPU each array comes back as a tensor over its own memory."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if torch.device(device).type != "cuda":
        return [torch.from_numpy(a) for a in arrays]
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += -(-a.nbytes // 16) * 16
    host = torch.empty(max(n, 16), dtype=torch.uint8, pin_memory=True)
    view = host.numpy()
    for a, o in zip(arrays, offs):
        view[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0].reshape(-1)).dtype).view(a.shape)
            for a, o in zip(arrays, offs)]


def fetch_views(*views: torch.Tensor) -> list[torch.Tensor]:
    """Views of one device block (a kernel's outputs cut from one
    allocation) on the host with one copy: the block's bytes fetched with
    one `.cpu()`, each view rebuilt over them with its dtype, offset and
    strides. Tensors that share no block come back one `.cpu()` each."""
    storage = views[0].untyped_storage()
    if any(v.untyped_storage().data_ptr() != storage.data_ptr() for v in views[1:]):
        return [v.cpu() for v in views]
    raw = torch.empty(0, dtype=torch.uint8, device=views[0].device).set_(storage).cpu()
    return [torch.empty(0, dtype=v.dtype).set_(raw.untyped_storage(), v.storage_offset(),
                                               v.shape, v.stride()) for v in views]


def fetch_rows(dev_tensor, rows: Sequence[int], bucket_fn) -> np.ndarray:
    """A row subset of a device tensor on the host: a gather on the device
    (rows padded to the bucket lattice) and one copy, never the full
    [B, C] fetch."""
    idx, n = _pad_rows_idx(rows, bucket_fn)
    sel = torch.from_numpy(idx.astype(np.int64)).to(dev_tensor.device)
    return dev_tensor.index_select(0, sel).cpu().numpy()[:n]


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


class PinnedStaging:
    """The padded answer-matrix upload: caller-provided estimator answers
    padded to the kernel shape with the -1 no-answer sentinel, columns to
    the (bucket-padded) fleet width and rows to the padded batch. For a
    card the matrix is written into one reusable pinned host buffer (10 000
    x 5 120 int32 is 200 MB at the flagship) and copied without blocking;
    the buffer grows to the largest matrix seen, and before it is written
    again the host waits for the copy out of it to finish. A pipelined
    round uploads from two threads (the caller's, and the writer's
    affinity-retry sub-rounds), so the wait, the fill, the copy and its
    event are one step under a lock. On the CPU the padded matrix is a new
    tensor."""

    def __init__(self) -> None:
        self._buf: Optional[torch.Tensor] = None
        self._copied = None
        self._lock = threading.Lock()

    @staticmethod
    def _fill(host: torch.Tensor, extra: np.ndarray) -> torch.Tensor:
        view = host.numpy()
        n, c = extra.shape
        view[:n, :c] = extra
        view[:n, c:] = -1
        view[n:] = -1
        return host

    @staticmethod
    def _pinned(nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8).pin_memory()

    @staticmethod
    def _copy(host: torch.Tensor, device):
        """`host` on `device` without blocking, and the event that marks
        the copy done on the current stream."""
        out = host.to(device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(device))
        return out, copied

    def upload(self, extra: np.ndarray, n_rows: int, n_cols: int, device) -> torch.Tensor:
        """`extra` (i32[n, c], n <= n_rows, c <= n_cols) padded with -1 to
        [n_rows, n_cols], on `device`."""
        if device.type != "cuda":
            return self._fill(torch.empty((n_rows, n_cols), dtype=torch.int32), extra)
        nbytes = 4 * n_rows * n_cols
        with self._lock:
            if self._buf is None or self._buf.numel() < nbytes:
                self._buf = self._pinned(nbytes)
            elif self._copied is not None:
                self._copied.synchronize()
            host = self._fill(self._buf[:nbytes].view(torch.int32).view(n_rows, n_cols), extra)
            out, self._copied = self._copy(host, device)
            return out


def caller_stream(device) -> Optional[torch.cuda.Stream]:
    """The calling thread's current CUDA stream on `device` (None on the
    CPU, where `torch.cuda.stream(None)` enters nothing)."""
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def resolve_max_bc_elems(override: Optional[int] = None) -> int:
    """THE [B,C]-elements-per-launch budget: an explicit override, else
    KARMADA_TPU_MAX_BC_ELEMS, else 2<<27. Shared by ArrayScheduler and the
    simulation plane, so a malformed value fails loudly and identically
    everywhere."""
    if override is not None:
        val, src = int(override), "max_bc_elems override"
    else:
        env = os.environ.get("KARMADA_TPU_MAX_BC_ELEMS", "")
        if not env:
            return 2 << 27
        try:
            val = int(env)
        except ValueError:
            raise ValueError(f"KARMADA_TPU_MAX_BC_ELEMS={env!r}: must be an integer") from None
        src = f"KARMADA_TPU_MAX_BC_ELEMS={env!r}"
    if val <= 0:
        raise ValueError(f"{src}: must be positive")
    return val


def resolve_autoshard(override: Optional[bool] = None) -> bool:
    """Whether an oversized solve may spread over several devices: an
    explicit override, else KARMADA_TPU_AUTOSHARD (0/off/false disables
    it), else on."""
    if override is not None:
        return bool(override)
    return os.environ.get("KARMADA_TPU_AUTOSHARD", "") not in ("0", "off", "false")


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (a CUDA device without an index is the
    current one)."""
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return norm(a) == norm(b)


def _batch_topk(batch: BindingBatch) -> int:
    """The output window of `run_kernel` (the reference's `_batch_flags`
    topk): the batch's provable per-row target bound, bucketed. A divided
    row places at most spec.replicas targets, a Duplicated row at most its
    affinity mask's popcount."""
    cand = int(batch.replicas.max(initial=0))
    dup = batch.strategy == DUPLICATED
    if dup.any():
        pc = batch.aff_masks.sum(axis=1)
        cand = max(cand, int(pc[batch.aff_idx[dup]].max(initial=0)))
    return min(pow2_bucket(min(cand, TOPK_TARGETS), lo=8), TOPK_TARGETS)


def _restrict_rows(batch: BindingBatch, rows: list[int], aff_rows: np.ndarray) -> BindingBatch:
    """Row subset of a batch with each row's spread selection folded into
    its affinity mask (`aff_rows`, bool[len(rows), C]: the rows' own
    affinity masks AND their selections). The masks are per row, so the
    sub-batch carries them as its own (un-deduped) table."""
    idx = np.asarray(rows)

    def take(a):
        return a[idx]

    return BindingBatch(
        keys=[batch.keys[b] for b in rows],
        uids=[batch.uids[b] for b in rows],
        replicas=take(batch.replicas),
        unknown_request=take(batch.unknown_request),
        gvk=take(batch.gvk),
        strategy=take(batch.strategy),
        fresh=take(batch.fresh),
        tol_tables=batch.tol_tables,
        tol_idx=take(batch.tol_idx),
        aff_masks=aff_rows,
        aff_idx=np.arange(len(rows), dtype=np.int32),
        weight_tables=batch.weight_tables,
        weight_idx=take(batch.weight_idx),
        prev_idx=take(batch.prev_idx),
        prev_rep=take(batch.prev_rep),
        evict_idx=take(batch.evict_idx),
        seeds=take(batch.seeds),
        n_clusters=batch.n_clusters,
        req_unique=batch.req_unique,
        req_idx=None if batch.req_idx is None else take(batch.req_idx),
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
        pipeline: Optional[bool] = None,
        mesh=None,
        *,
        encoder: Optional[FleetEncoder] = None,
        bucket_cols: bool = True,
        plugin_registry=None,
    ):
        """`device`: None means the CUDA card (RuntimeError without one);
        "cpu" runs the plain PyTorch path. `mesh`: a parallel.mesh.Mesh;
        the round then runs on `mesh.devices[0, 0]` (a `device` that
        differs raises) and the solve over the mesh, in the monolithic
        mode (set `mesh_partitioned = False`; the partitioned mode, the
        reference's default, is not ported and raises). `plugins`: the `--plugins`
        enable/disable list (default ["*"]). `candidate_k`: the candidate
        window (None reads KARMADA_TPU_CANDIDATE_K, default 128).
        `pipeline`: chunked rounds run as the software pipeline
        (sched/pipeline.py — encode/solve/materialize overlapped across
        chunks, bit-identical decisions); None reads KARMADA_TPU_PIPELINE
        (1/on/true enables it; by default the serial row-chunk executor
        runs them, which measured faster on the card). `encoder`: the
        fleet encoder (its resource vocabulary; default `FleetEncoder()`).
        `bucket_cols`: pad the fleet axis to the shape_bucket lattice with
        dead clusters (the default); False solves at the exact fleet width.
        `plugin_registry`: the plugin registry whose names `plugins`
        filters (None: the default one; the port registers no out-of-tree
        plugin, so any registry holds the in-tree set only). All three
        are keyword-only: the reference takes `encoder` as its second
        positional argument, where this constructor has `plugins`.
        Oversized rounds do not re-place the fleet over several cards
        yet: `_maybe_autoshard` raises where the reference would
        (KARMADA_TPU_AUTOSHARD=0 turns the check off)."""
        from .candidates import resolve_candidate_k

        self.mesh = mesh
        self._mesh_kernel = None
        self._fleet_scatter = None  # the placed fleet's refresh launcher
        # as the reference: mesh rounds default to the partitioned mode
        # (not ported: the round raises); False selects the monolithic one
        self.mesh_partitioned = True
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.devices[0, 0]
            if device is not None and not _same_device(resolve_device(device), self.device):
                raise ValueError(
                    f"ArrayScheduler: device {device!r} differs from the mesh's first device "
                    f"{self.device}, on which the round runs"
                )
        self.encoder = encoder or FleetEncoder()
        self.bucket_cols = bucket_cols
        self.plugin_registry = plugin_registry or plugin_mod.PluginRegistry()
        self.enabled_plugins = self.plugin_registry.filter(plugins)
        self._plugin_bits = plugin_mod.plugin_bits(self.enabled_plugins)
        self.max_bc_elems = resolve_max_bc_elems()
        self.autoshard = resolve_autoshard()
        self.candidate_k = resolve_candidate_k(candidate_k)
        self.last_candidate_stats: dict = {}
        self._staging = PinnedStaging()
        # out-of-tree plugins: the port has none (registering one raises),
        # and the tier routing, the replay cache and the pipeline read this
        # as the reference does
        self._oot_plugins: list = []
        # the chunk pipeline: the driving pipeline installs its stage timer
        # for one round (pipeline_context); last_pipeline_stats carries the
        # stage/overlap numbers of the last chunked round (None when the
        # round ran un-chunked)
        self.pipeline_enabled = resolve_pipeline(pipeline, default=False)
        self.stage_timer: Optional[StageTimer] = None
        self.last_pipeline_stats: Optional[dict] = None
        # the writer thread's affinity-retry sub-rounds encode while the
        # caller's thread encodes the next chunk: the batch encoder's
        # interned tables and row cache are shared, so encodes take a lock
        self._encode_lock = threading.Lock()
        # cross-round replay: any fleet change bumps the epoch (cached
        # decisions replay only at the epoch they were solved in); the
        # cache maps binding uid -> DecisionEntry
        self.fleet_epoch = 0
        self._decision_cache: dict[str, object] = {}
        self.last_round_stats = {"replayed": 0, "solved": 0}
        self.set_clusters(clusters)

    @contextmanager
    def pipeline_context(self, timer: StageTimer, overlap: bool = False):
        """Install the driving pipeline's stage timer for the duration of
        one round; restores the previous one on exit. `overlap` is the
        reference's flag, accepted for its callers: there it steers only
        the CPU-backend host tails, which the port leaves out, so here it
        steers nothing."""
        prev = self.stage_timer
        self.stage_timer = timer
        try:
            yield
        finally:
            self.stage_timer = prev

    def set_clusters(self, clusters: Sequence, dirty_names: Optional[set] = None) -> None:
        """Re-encode the fleet. With `dirty_names` (the clusters the caller
        knows changed since the last call), the dirty-column path re-encodes
        ONLY those clusters and writes their rows into the resident device
        tensors in place (one pinned upload and one scatter_rows launch
        through the placement's `kernels.FleetScatter`, no stream sync, on
        the current stream) — keeping the batch
        encoder's affinity masks and per-binding row cache alive — whenever
        the change is expressible that way; otherwise this falls back to
        the full rebuild. Either way the fleet epoch advances, so
        incremental rounds re-solve every binding against the new
        snapshot."""
        clusters = list(clusters)
        self.fleet_epoch += 1
        if dirty_names and self._update_dirty_columns(clusters, dirty_names):
            return
        self.n_real_clusters = len(clusters)
        pad = self._fleet_width(len(clusters)) - len(clusters)
        if pad > 0:
            # the fleet axis pads to the shape_bucket lattice (under a
            # mesh, rounded up to a multiple of the clusters axis) with
            # dead clusters (never Ready ⇒ never feasible ⇒ never
            # decoded), as the reference does, so every derived table
            # sizes to the padded width and tie values and names line up
            # with it
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
        # spread encodings (sched/spread.py array API): cluster-name
        # ascending ranks (the sortClusters tie-break) and region ids
        C = len(self.clusters)
        self._name_rank = np.empty(C, np.int32)
        self._name_rank[np.argsort(np.array(self.fleet.names))] = np.arange(C)
        region_ids: dict[str, int] = {}
        self._region_id = np.full(C, -1, np.int32)
        for i, c in enumerate(self.clusters):
            region = c.spec.region
            if region:
                self._region_id[i] = region_ids.setdefault(region, len(region_ids))
        self._region_names = list(region_ids)
        from . import spread_batch

        self._spread_layout = spread_batch.RegionLayout(
            self._region_id, self._region_names, self._name_rank
        )
        self._layout_dev = self._spread_layout.tensors(self.device)
        self._place_fleet()

    def _fleet_width(self, n_real: int) -> int:
        """Padded fleet width for n_real clusters: the shape_bucket
        lattice point (n_real itself without `bucket_cols`), rounded up to
        a multiple of the clusters axis under a mesh. An empty fleet stays
        empty."""
        if n_real == 0:
            return 0
        width = shape_bucket(n_real) if self.bucket_cols else n_real
        if self.mesh is not None:
            from ..parallel.mesh import AXIS_CLUSTERS

            width += (-width) % self.mesh.shape[AXIS_CLUSTERS]
        return width

    def _place_fleet(self) -> None:
        """Upload the fleet tensors whole to the round's device (they live
        there across rounds) and bind the dirty-column refresh's launcher
        to them (the previous one retired: its tensors are gone), and
        refresh the mesh kernel's column shards when it exists."""
        from .. import kernels
        from ..convert import batch_from_numpy

        self._fleet_dev = batch_from_numpy(
            {n: getattr(self.fleet, n) for n in _FLEET_FIELDS}, self.device)
        if self._fleet_scatter is not None:
            self._fleet_scatter.close()
        self._fleet_scatter = kernels.fleet_scatter(
            {n: self._fleet_dev[n] for n in _FLEET_FIELDS})
        if self._mesh_kernel is not None:
            self._mesh_kernel.set_fleet(self.fleet)

    def _mesh_solver(self):
        """The mesh kernel, built at first use with the fleet placed."""
        if self._mesh_kernel is None:
            from ..parallel.mesh import MeshScheduleKernel

            self._mesh_kernel = MeshScheduleKernel(self.mesh, self.fleet)
        return self._mesh_kernel

    def _update_dirty_columns(self, clusters: list, dirty_names) -> bool:
        """Dirty-column fleet refresh. Applies only when the membership is
        unchanged and no dirty cluster changed a mask-relevant field
        (labels / provider / region / zone): affinity masks, the spread
        layout and the weight tables are then still valid, so the batch
        encoder — and its per-binding row cache — survives the fleet
        update. Status-driven changes (capacity, readiness, taints, api
        enablements over known GVKs) take this path. Returns False when the
        delta cannot be expressed in the resident layout."""
        # self.clusters carries dead shape-pad clusters at the tail; the
        # caller's list never does, so compare against the real prefix
        old = self.clusters[: self.n_real_clusters]
        if len(clusters) != len(old):
            return False
        idx: list[int] = []
        for i, (cn, co) in enumerate(zip(clusters, old)):
            if cn.name != co.name:
                return False  # membership / order changed
            if cn.name in dirty_names:
                if (
                    cn.metadata.labels != co.metadata.labels
                    or cn.spec.provider != co.spec.provider
                    or cn.spec.region != co.spec.region
                    or cn.spec.zone != co.spec.zone
                ):
                    return False  # affinity/spread inputs changed
                idx.append(i)
        if not idx:
            return True  # spurious dirt: nothing to re-encode
        # keep the shape-pad clusters (never dirty: they are synthetic)
        clusters = clusters + self.clusters[len(clusters):]
        fleet = self.encoder.encode_cols(self.fleet, clusters, idx)
        if fleet is None:
            return False  # taint axis would widen / unknown GVK appeared
        self.clusters = clusters
        self.fleet = fleet
        self.batch_encoder.fleet = fleet
        self.batch_encoder.clusters = clusters
        self.batch_encoder.affinity_cache.clusters = clusters
        if self.mesh is not None:
            # under a mesh the refreshed tensors are placed whole again (as
            # the reference re-places its sharded fleet); the host side —
            # encode_cols, the kept batch encoder — is the same
            self._place_fleet()
            return True
        # the dirty rows into the resident tensors, in place: one pinned
        # upload and one launch through the placement's launcher
        self._fleet_scatter.refresh(np.asarray(idx, np.int64), fleet)
        return True

    def _maybe_autoshard(self, n_rows: int) -> bool:
        """The reference's oversized-round selector, up to the point where
        it re-places the fleet: False when autoshard is off, when a mesh
        was given, when the round fits `max_bc_elems`, or when fewer than
        two devices of the round's kind are visible (the CPU counts as
        one). Past those returns the reference builds a mesh over every
        visible device, which the port does not yet do: it raises
        NotImplementedError (queue A item 11, multi-GPU)."""
        if not self.autoshard or self.mesh is not None:
            return False
        if n_rows * len(self.fleet.names) <= self.max_bc_elems:
            return False
        visible = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if visible < 2:
            return False
        raise NotImplementedError(
            f"an oversized round ({n_rows} x {len(self.fleet.names)} over "
            f"max_bc_elems {self.max_bc_elems}) with {visible} cards visible "
            "would re-place the fleet over a mesh of them: not ported yet "
            "(queue A item 11, multi-GPU); set KARMADA_TPU_AUTOSHARD=0 to "
            "run it chunked on one card"
        )

    def _max_rows_per_round(self, n_cols: int) -> int:
        """Row cap per launched round under the [B,C] budget, floored to a
        shape_bucket lattice point. Under a mesh the budget scales by the
        bindings axis only: the tail's rows are gathered whole, so a
        clusters-axis split does not shrink their footprint."""
        scale = 1
        if self.mesh is not None:
            from ..parallel.mesh import AXIS_BINDINGS

            scale = self.mesh.shape[AXIS_BINDINGS]
        return self._floor_rows(max(8, self.max_bc_elems * scale // max(n_cols, 1)))

    @staticmethod
    def _floor_rows(cap: int) -> int:
        """Floor a row cap to a shape_bucket lattice point, so every full
        chunk has one shape."""
        return shape_floor(max(cap, 8))

    def pipeline_chunk_rows(self, n_cols: int) -> int:
        """Per-chunk row cap when the pipeline drives a chunked round: HALF
        the serial per-launch cap, so two chunks in flight keep the device
        working set inside the serial executor's envelope."""
        return self._floor_rows(max(8, self._max_rows_per_round(n_cols) // 2))

    def round_chunk_rows(self, n_rows: int) -> int:
        """Chunking policy for a daemon-driven pipelined round (the whole
        dirty set, replay included): aim for ~PIPELINE_CHUNKS chunks so the
        stages have work to overlap, floor at PIPELINE_MIN_ROWS, and never
        exceed the double-buffered chunk cap. Returns one chunk (the
        pipeline then runs serially) for rounds too small to fill the pipe
        and for out-of-tree-plugin rounds (stateful host hooks must not run
        on two threads). Always bounded by the serial per-launch row cap."""
        max_rows = self._max_rows_per_round(len(self.fleet.names))
        if not self.pipeline_enabled or self._oot_plugins:
            return min(max(1, n_rows), max_rows)
        if n_rows <= 2 * PIPELINE_MIN_ROWS and n_rows <= max_rows:
            return max(1, n_rows)
        cap = self.pipeline_chunk_rows(len(self.fleet.names))
        target = self._floor_rows(max(PIPELINE_MIN_ROWS, n_rows // PIPELINE_CHUNKS))
        return max(8, min(cap, target))

    _bucket = staticmethod(shape_bucket)

    def _pad(self, batch: BindingBatch) -> BindingBatch:
        return pad_batch(batch, self._bucket)

    # -- incremental rounds -----------------------------------------------

    def _split_replay(self, bindings: Sequence, extra_avail):
        """Replay-cache consult for one binding list: returns
        (out, dirty_pos, digest_of) where out[i] is the replayed decision or
        None, dirty_pos lists the rows that must solve, and digest_of
        memoizes the per-row estimator-answer digests for the cache writes.
        Digests are computed lazily — only after the cheap epoch check says
        a cached entry could match — so an epoch-invalidated round never
        hashes its answer rows just to find every entry stale. Out-of-tree
        plugins disable replay."""
        from .incremental import extra_digest

        n = len(bindings)
        out: list[Optional[ScheduleDecision]] = [None] * n
        digests: list[Optional[bytes]] = [None] * n
        digest_done = [extra_avail is None] * n

        def digest_of(i: int) -> Optional[bytes]:
            if not digest_done[i]:
                digests[i] = extra_digest(extra_avail[i])
                digest_done[i] = True
            return digests[i]

        if self._oot_plugins:
            return out, list(range(n)), digest_of
        cache = self._decision_cache
        epoch = self.fleet_epoch
        dirty_pos: list[int] = []
        for i, rb in enumerate(bindings):
            uid = rb.metadata.uid
            ent = cache.get(uid) if uid else None
            if ent is not None and ent.epoch == epoch and ent.matches(rb, epoch, digest_of(i)):
                out[i] = ent.decision
            else:
                dirty_pos.append(i)
        return out, dirty_pos, digest_of

    def _cache_decisions(self, bindings: Sequence, out, dirty_pos, digest_of, solve_epoch: int,
                         round_rows: Optional[int] = None) -> None:
        """Write the round's dirty decisions back to the replay cache and
        enforce the size bound (entries of deleted bindings must not
        accumulate). `round_rows`: the WHOLE round's binding count when the
        caller is one chunk of a larger round, so the bound scales with the
        round."""
        if self._oot_plugins:
            return  # replay disabled: never cache under opaque plugin terms
        from .incremental import DecisionEntry

        cache = self._decision_cache
        for i in dirty_pos:
            rb = bindings[i]
            if rb.metadata.uid:
                cache[rb.metadata.uid] = DecisionEntry(rb, solve_epoch, digest_of(i), out[i])
        if len(cache) > max(4 * (round_rows or len(bindings)), 16384):
            cache.clear()
            for i, rb in enumerate(bindings):
                if rb.metadata.uid and out[i] is not None:
                    cache[rb.metadata.uid] = DecisionEntry(rb, solve_epoch, digest_of(i), out[i])

    def schedule_incremental(self, bindings: Sequence, extra_avail=None) -> list[ScheduleDecision]:
        """Incremental schedule round: bindings whose solve inputs are
        unchanged since the round that last solved them — same fleet epoch,
        same spec/status inputs, same estimator answers (sched/incremental.py
        DecisionEntry) — replay their cached decision without touching the
        device; only the dirty rows enter `schedule()`. Decisions equal a
        cold full solve's (the tie-break is UID-seeded)."""
        if not bindings:
            self.last_round_stats = {"replayed": 0, "solved": 0}
            return []
        bindings = list(bindings)
        out, dirty_pos, digest_of = self._split_replay(bindings, extra_avail)
        if dirty_pos:
            dirty = [bindings[i] for i in dirty_pos]
            sub_extra = None if extra_avail is None else extra_avail[dirty_pos]
            decisions = self.schedule(dirty, extra_avail=sub_extra)
            for i, dec in zip(dirty_pos, decisions):
                out[i] = dec
            self._cache_decisions(bindings, out, dirty_pos, digest_of, self.fleet_epoch)
        self.last_round_stats = {
            "replayed": len(bindings) - len(dirty_pos), "solved": len(dirty_pos),
        }
        if dirty_pos and self.last_pipeline_stats:
            # the dirty-row solve ran chunked: its stage/overlap numbers
            self.last_round_stats.update(self.last_pipeline_stats)
        return out

    # -- the chunk API (sched/pipeline.py drives these) --------------------

    def launch_chunk(self, bindings: Sequence, extra_avail=None,
                     round_rows: Optional[int] = None) -> dict:
        """Launch one pipeline chunk, replay-aware: cached decisions resolve
        at once; dirty rows encode on the host and launch on the device —
        no device sync here. Keep chunks within `round_chunk_rows`.
        `round_rows`: the whole round's binding count (scales the replay
        cache's bound)."""
        bindings = list(bindings)
        out, dirty_pos, digest_of = self._split_replay(bindings, extra_avail)
        state = None
        if dirty_pos:
            dirty = [bindings[i] for i in dirty_pos]
            sub_extra = None if extra_avail is None else extra_avail[dirty_pos]
            state = self._launch_solve(dirty, sub_extra)
        return {
            "bindings": bindings, "out": out, "dirty_pos": dirty_pos, "digest_of": digest_of,
            "state": state, "epoch": self.fleet_epoch, "round_rows": round_rows,
            "replayed": len(bindings) - len(dirty_pos), "solved": len(dirty_pos),
        }

    def schedule(self, bindings: Sequence, extra_avail=None) -> list[ScheduleDecision]:
        """Schedule with the ordered-affinity-terms retry loop
        (scheduleResourceBindingWithClusterAffinities, scheduler.go:562-625).
        Rounds over the per-launch row cap run as equal row chunks through
        the chunk pipeline, or serially when it is off (rows are
        independent and the tie-break is UID-seeded, so decisions do not
        depend on the chunking). `extra_avail`: None, or the registered
        estimators' answers int32 [len(bindings), c] over the first c <=
        C fleet columns, -1 = no answer (EstimatorRegistry.batch_estimates)."""
        if not bindings:
            return []
        bindings = list(bindings)
        self.last_pipeline_stats = None
        if extra_avail is not None:
            extra_avail = np.asarray(extra_avail)
            C = len(self.fleet.names)
            if (extra_avail.ndim != 2 or len(extra_avail) != len(bindings)
                    or extra_avail.shape[1] > C):
                raise ValueError(
                    f"extra_avail: shape {extra_avail.shape}, expected "
                    f"({len(bindings)}, <= {C})"
                )
            extra_avail = extra_avail.astype(np.int32, copy=False)
        max_rows = self._max_rows_per_round(len(self.fleet.names))
        if len(bindings) > max_rows:
            return self._schedule_chunked(bindings, extra_avail, max_rows)
        return self._materialize_solve(self._launch_solve(bindings, extra_avail))

    def _schedule_chunked(self, bindings: list, extra_avail, max_rows: int
                          ) -> list[ScheduleDecision]:
        """The oversized-round executor: equal lattice row chunks under the
        [B,C] budget, run as the software pipeline when enabled (chunk k+1
        encodes and launches while chunk k materializes on the writer;
        two chunks in flight, so chunks are HALF the serial row cap), or
        strictly serially when not. Decisions are identical either way.
        Out-of-tree plugins run the chunks serially (their host hooks may
        be stateful), as they disable replay. A CUDA stream is current per
        thread, so the writer enters the caller's: its copies back wait
        for the chunk's kernels, and its retry sub-rounds launch there."""
        pipelined = self.pipeline_enabled and not self._oot_plugins
        cap = (min(max_rows, self.pipeline_chunk_rows(len(self.fleet.names)))
               if pipelined else max_rows)
        rows = plan_chunk_rows(len(bindings), cap)
        spans = chunk_spans(len(bindings), rows)
        chunks = [(bindings[s:e], None if extra_avail is None else extra_avail[s:e])
                  for s, e in spans]
        stream = caller_stream(self.device)

        def materialize(state):
            with torch.cuda.stream(stream):
                return self._materialize_solve(state)

        timer = StageTimer()
        with self.pipeline_context(timer):
            pipe = ChunkPipeline(
                launch=lambda i, c, est: self._launch_solve(c[0], c[1]),
                materialize=materialize,
                pipelined=pipelined,
                timer=timer,
                # the materialize halves time their own spans (the retry
                # loop's sub-rounds record their stages, not a second
                # blanket materialize span)
                time_materialize=False,
            )
            results = pipe.run(chunks)
        stats = pipe.stats()
        stats["chunks"] = len(spans)
        stats["chunk_rows"] = rows
        self.last_pipeline_stats = stats
        return [d for chunk_dec in results for d in chunk_dec]

    def materialize_chunk(self, pending: dict) -> list[ScheduleDecision]:
        """Second half of `launch_chunk`: sync + decode the chunk's dirty
        rows, run the ordered-affinity retry loop, write the replay cache,
        and merge with the replayed decisions, in the chunk's binding
        order. Tiered chunks (sched/preemption.py launch_tiered, the
        "tiered" marker) materialize here too and never enter the replay
        cache: their decisions depend on the batch's composition."""
        if pending.get("tiered"):
            from .preemption import materialize_tiered

            with stage_span("materialize", self.stage_timer):
                return materialize_tiered(self, pending)
        out = pending["out"]
        if pending["state"] is not None:
            decisions = self._materialize_solve(pending["state"])
            for i, dec in zip(pending["dirty_pos"], decisions):
                out[i] = dec
            self._cache_decisions(
                pending["bindings"], out, pending["dirty_pos"], pending["digest_of"],
                pending["epoch"], round_rows=pending["round_rows"],
            )
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

    def _launch_solve(self, bindings: list, extra_avail=None):
        term_idx = [self._initial_term(rb) for rb in bindings]
        pending = self._launch_once(bindings, extra_avail, term_idx)
        return (bindings, extra_avail, term_idx, pending)

    def _materialize_solve(self, state) -> list[ScheduleDecision]:
        """Sync + decode, then the ordered-affinity retry loop (retried
        sub-batches solve serially) and the applied term names."""
        bindings, extra_avail, term_idx, pending = state
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
            sub_extra = None if extra_avail is None else extra_avail[retry]
            sub_dec = self._schedule_once(
                [bindings[b] for b in retry], sub_extra, [term_idx[b] for b in retry]
            )
            for j, b in enumerate(retry):
                decisions[b] = sub_dec[j]
        for b, d in enumerate(decisions):
            terms = self._affinity_terms_of(bindings[b])
            if terms and d.ok:
                d.affinity_name = terms[term_idx[b]].affinity_name
        return decisions

    def _schedule_once(self, bindings: Sequence, extra_avail=None,
                       term_indices=None) -> list[ScheduleDecision]:
        return self._materialize_once(self._launch_once(bindings, extra_avail, term_indices))

    def _launch_once(self, bindings: Sequence, extra_avail=None, term_indices=None) -> dict:
        """Encode + kernel dispatch for one round (no device sync): the
        compact candidate round, or the dense round when `dense_reason`
        names one. The monolithic mesh round computes eagerly: its pending
        carries the finished decisions."""
        from . import candidates as cand_mod

        if self.mesh is not None:
            if self.mesh_partitioned:
                raise NotImplementedError(
                    "ArrayScheduler: the partitioned mesh rounds (the reference's default "
                    "mesh mode) are not ported yet (ROADMAP queue A item 11, the mesh's "
                    "remaining part); set mesh_partitioned = False for the monolithic mesh "
                    "round"
                )
            return {"decisions": self._schedule_once_monolithic(
                bindings, extra_avail, term_indices)}
        self.last_candidate_stats = {}
        reason = cand_mod.dense_reason(self, bindings)
        if reason is None:
            return cand_mod.launch_candidates(self, bindings, extra_avail, term_indices)
        cand_mod.note_fallback(reason)
        return self._launch_once_partitioned(bindings, extra_avail, term_indices)

    def _materialize_once(self, pending: dict) -> list[ScheduleDecision]:
        if "decisions" in pending:
            return pending["decisions"]
        if pending.get("candidates"):
            from . import candidates as cand_mod

            return cand_mod.materialize_candidates(self, pending)
        return self._materialize_once_partitioned(pending)

    def _encode_round(self, bindings: Sequence, extra_avail=None, term_indices=None):
        """The shared prefix of the compact and dense rounds: classify the
        rows (spread rows are class 0), permute them class-contiguous,
        encode, pad and upload the batch and the answer matrix. Returns
        (bindings, cls, order, raw, t, spread, extra) in the permuted row
        order, `t` the batch tensors by field (with "extra_avail", the
        padded answers on the device, or None), `spread` the (batched,
        cfg_of, fallback) spread rows and `extra` the permuted answers on
        the host (unpadded, or None)."""
        batched, cfg_of, fallback = self._classify_spread(bindings)
        spread_set = set(batched) | set(fallback)
        cls = np.asarray(
            [self._row_class(rb, b in spread_set) for b, rb in enumerate(bindings)], np.int8
        )
        order = np.argsort(cls, kind="stable")
        bindings = [bindings[i] for i in order]
        cls = cls[order]
        if term_indices is not None:
            term_indices = [term_indices[i] for i in order]
        if extra_avail is not None:
            extra_avail = extra_avail[order]
        # the spread rows in permuted space, ascending
        new_pos = np.empty(len(order), np.int64)
        new_pos[order] = np.arange(len(order))
        batched_p = sorted(int(new_pos[b]) for b in batched)
        cfg_p = {int(new_pos[b]): cfg for b, cfg in cfg_of.items()}
        fallback_p = sorted(int(new_pos[b]) for b in fallback)

        from ..convert import batch_from_numpy

        with self._encode_lock:
            raw = self.batch_encoder.encode(bindings, term_indices=term_indices)
        batch = self._pad(raw)
        t = batch_from_numpy({name: getattr(batch, name) for name in _BATCH_FIELDS}, self.device)
        t["extra_avail"] = self._upload_extra(extra_avail, len(batch.replicas))
        return bindings, cls, order, raw, t, (batched_p, cfg_p, fallback_p), extra_avail

    def _upload_extra(self, extra_avail, n_rows: int) -> Optional[torch.Tensor]:
        """Answers i32[n, c] on the device, padded with -1 to [n_rows, C]
        (through the pinned staging buffer on a card), or None."""
        if extra_avail is None:
            return None
        return self._staging.upload(extra_avail, n_rows, len(self.fleet.names), self.device)

    def _schedule_once_partitioned(self, bindings: Sequence, extra_avail=None,
                                   term_indices=None):
        return self._materialize_once_partitioned(
            self._launch_once_partitioned(bindings, extra_avail, term_indices)
        )

    def _launch_once_partitioned(self, bindings: Sequence, extra_avail=None,
                                 term_indices=None) -> dict:
        """LAUNCH half of the dense round, partitioned by row class (rows
        are permuted class-contiguous before encoding and unpermuted by the
        materialize half):

          phase 1  dense filter + estimate over ALL rows (one launch)
          phase 2  the wide-row division tail over ONLY the divided rows:
                   static/dynamic-weight rows and Aggregated rows as two
                   launches, so the truncation runs only where needed
          masks    duplicated / non-workload target sets: the first k
                   feasible indices when the affinity popcount bounds them,
                   else complete packed feasible rows
          spread   group scoring of the batched spread rows' scoring
                   representatives

        Every phase-2 launch reads only phase-1 device outputs, so the
        round pays one device->host sync, in the materialize half (the
        batched spread rows add one more, after their host search)."""
        if not bindings:
            return {"n_real": 0}
        with stage_span("encode", self.stage_timer):
            bindings, cls, order, raw, t, spread, extra = self._encode_round(
                bindings, extra_avail, term_indices)
        with stage_span("solve", self.stage_timer):
            return self._solve_partitioned(bindings, cls, order, raw, t, spread, extra)

    def _solve_partitioned(self, bindings, cls, order, raw, t, spread, extra) -> dict:
        """The dense round's kernel dispatch (the `solve` stage)."""
        from .. import kernels

        n_real = len(bindings)
        C = len(self.fleet.names)
        dev = self.device
        batched_rows, batched_cfg, fallback_rows = spread
        f = self._fleet_dev

        # the round's row ids (the tails' padded lists, the mask rows) go up
        # in one pinned copy before the filter, so the host never waits on it
        tail_rows = []
        for want_cls, has_agg in ((1, False), (2, True)):
            rows = [b for b in range(n_real) if cls[b] == want_cls]
            if rows:
                tail_rows.append((rows, has_agg))
        spread_set = set(batched_rows) | set(fallback_rows)
        mask_rows = [b for b in range(n_real) if cls[b] == 0 and b not in spread_set]
        row_ids = [_pad_rows_idx(rows, self._bucket)[0] for rows, _ in tail_rows]
        if mask_rows:
            row_ids.append(np.asarray(mask_rows, np.int32))
        row_ids = to_device_packed(row_ids, dev) if row_ids else []

        dev_feasible, dev_score, dev_avail, dev_prev, dev_tie, dev_fc = kernels.dense_filter(
            f["alive"], f["capacity"], f["has_summary"], f["taint_key"],
            f["taint_value"], f["taint_effect"], f["api_ok"],
            t["replicas"], t["unknown_request"], t["gvk"],
            t["tol_tables"], t["tol_idx"], t["aff_masks"], t["aff_idx"],
            t["prev_idx"], t["prev_rep"], t["evict_idx"], t["seeds"],
            t["req_unique"], t["req_idx"], t["extra_avail"],
            plugin_bits=self._plugin_bits,
        )

        # ---- phase 2: division tails per sub-class, read through row ids ----
        tails = []
        for (rows, has_agg), idx_dev in zip(tail_rows, row_ids):
            max_repl = int(raw.replicas[rows].max(initial=0))
            topk = min(pow2_bucket(min(max_repl, TOPK_TARGETS), lo=8), TOPK_TARGETS)
            t_out = kernels.dense_tail(
                dev_feasible, dev_avail, dev_prev, dev_tie, idx_dev,
                t["weight_tables"], t["weight_idx"], t["strategy"], t["replicas"],
                t["fresh"], topk=topk, has_agg=has_agg,
            )
            tails.append({"rows": rows, "t_out": t_out})

        # ---- phase 2: duplicated / non-workload target sets, read from the
        # filter outputs through the real mask rows' ids ----
        packed_dev = midx_dev = None
        if mask_rows:
            pc = raw.aff_masks.sum(axis=1)
            mk = int(pc[raw.aff_idx[np.asarray(mask_rows)]].max(initial=0))
            # the popcount bounds the feasible set only while feasible is
            # inside the affinity mask; with ClusterAffinity disabled the
            # filter substitutes all-ones, so those rows ship packed masks
            if self._plugin_bits & plugin_mod.BIT_AFFINITY and 0 < mk <= TOPK_TARGETS:
                midx_dev = kernels.feas_idx(dev_feasible, row_ids[-1],
                                            min(pow2_bucket(mk, lo=8), C))
            else:
                packed_dev = kernels.pack_rows(dev_feasible, row_ids[-1])

        # ---- phase 2: spread group scoring ----
        spread_pre = self._spread_prelaunch(
            bindings, raw, extra, batched_rows, batched_cfg, dev_feasible, dev_score, dev_avail,
            dev_prev,
        )

        return {
            "bindings": bindings, "raw": raw, "t": t, "extra": extra, "order": order,
            "n_real": n_real, "dev": (dev_feasible, dev_score, dev_avail, dev_prev, dev_tie),
            "dev_fc": dev_fc, "tails": tails, "packed_dev": packed_dev, "midx_dev": midx_dev,
            "mask_rows": mask_rows, "batched_rows": batched_rows, "batched_cfg": batched_cfg,
            "fallback_rows": fallback_rows, "spread_pre": spread_pre,
        }

    def _materialize_once_partitioned(self, p: dict) -> list[ScheduleDecision]:
        """MATERIALIZE half of the dense round: ONE device->host sync for
        everything the launch half dispatched, the decode (with row fetches
        for tail rows whose nonzero count outruns the output window and for
        mask rows whose feasible count outruns the index window), the spread
        rows, then the decisions, unpermuted."""
        if p["n_real"] == 0:
            return []
        with stage_span("materialize", self.stage_timer):
            return self._materialize_partitioned_inner(p)

    def _materialize_partitioned_inner(self, p: dict) -> list[ScheduleDecision]:
        n_real = p["n_real"]
        bindings, raw, order = p["bindings"], p["raw"], p["order"]
        tails, mask_rows = p["tails"], p["mask_rows"]
        spread_pre = p["spread_pre"]
        names = self.fleet.names

        unsched = np.zeros(n_real, bool)
        avail_sum = np.zeros(n_real, np.int64)
        row_err: dict[int, str] = {}
        row_target_src: dict[int, tuple] = {}
        row_feas_src: dict[int, tuple] = {}

        # ---- THE sync ----
        host = [p["dev_fc"]] + [x for tl in tails for x in tl["t_out"][1:]]
        host += [x for x in (p["packed_dev"], p["midx_dev"]) if x is not None]
        if spread_pre is not None:
            host += list(spread_pre["wvf"])
        host = [x.cpu().numpy() for x in host]
        if spread_pre is not None:
            spread_pre["wvf_host"] = host[-3:]
            host = host[:-3]
        feas_count = host[0][:n_real].astype(np.int64)

        # ---- decode: division tails ----
        for i, tl in enumerate(tails):
            t_unsched, t_asum, t_nnz, t_ti, t_tv = host[1 + 5 * i: 6 + 5 * i]
            tis, tvs = _sorted_pairs(t_ti, t_tv)
            overflow = []
            for k, b in enumerate(tl["rows"]):
                unsched[b] = bool(t_unsched[k])
                avail_sum[b] = int(t_asum[k])
                n = int(t_nnz[k])
                if n > t_ti.shape[1]:
                    overflow.append((k, b))
                    continue
                row_target_src[b] = ("pairs", names, tis[k, :n], tvs[k, :n])
            if overflow:
                o_res = fetch_rows(tl["t_out"][0], [k for k, _ in overflow], self._bucket)
                for j, (_, b) in enumerate(overflow):
                    pos = np.nonzero(o_res[j] > 0)[0]
                    row_target_src[b] = ("pairs", names, pos, o_res[j, pos].astype(np.int64))

        # ---- decode: duplicated / non-workload target sets ----
        if mask_rows:
            packed_h = host[-1] if p["packed_dev"] is not None else None
            midx_h = host[-1] if p["midx_dev"] is not None else None
            mask_overflow: list[int] = []
            for k, b in enumerate(mask_rows):
                n = int(feas_count[b])
                if n <= 0:
                    continue  # FitError branch
                reps = self._mask_replicas(raw, bindings, b)
                if midx_h is not None:
                    if n > midx_h.shape[1]:
                        # the feasible set outran the popcount-derived
                        # window: fetch the dense row, never truncate
                        mask_overflow.append(b)
                        continue
                    fidx = np.asarray(midx_h[k][:n], np.int64)
                    row_feas_src[b] = ("idx", names, fidx)
                    row_target_src[b] = ("pairs", names, fidx, np.full(n, reps, np.int64))
                else:
                    row_feas_src[b] = ("mask", names, packed_h[k], len(names))
                    row_target_src[b] = ("mask", names, packed_h[k], len(names), reps)
            if mask_overflow:
                o_feas = fetch_rows(p["dev"][0], mask_overflow, self._bucket)
                for j, b in enumerate(mask_overflow):
                    fidx = np.nonzero(o_feas[j])[0]
                    reps = self._mask_replicas(raw, bindings, b)
                    row_feas_src[b] = ("idx", names, fidx)
                    row_target_src[b] = (
                        "pairs", names, fidx, np.full(len(fidx), reps, np.int64),
                    )

        self._spread_overlay(
            p, feas_count, unsched, avail_sum, row_err, row_target_src, row_feas_src,
        )

        # ---- build decisions, then unpermute ----
        out: list[Optional[ScheduleDecision]] = [None] * n_real
        for b, dec in enumerate(self._decisions(raw, feas_count, unsched, avail_sum, row_err,
                                                row_target_src, row_feas_src)):
            out[int(order[b])] = dec
        return out

    def _decisions(self, raw: BindingBatch, feas_count, unsched, avail_sum, row_err,
                   row_target_src, row_feas_src) -> list[ScheduleDecision]:
        """A round's decisions in its batch's row order, from the decode
        overlays: an error (the row's own, the FitError diagnosis, or too
        few available replicas) before any targets."""
        out = []
        for b, key in enumerate(raw.keys):
            dec = ScheduleDecision(key=key)
            if b in row_feas_src:
                dec._feasible_src = row_feas_src[b]
            if b in row_err:
                dec.error = row_err[b]
            elif feas_count[b] == 0:
                # FitError diagnosis (generic_scheduler.go:83-88)
                dec.error = f"0/{self.n_real_clusters} clusters are available"
            elif unsched[b]:
                dec.error = (
                    f"Clusters available replicas {int(avail_sum[b])} are not "
                    "enough to schedule."
                )
            elif b in row_target_src:
                dec._targets_src = row_target_src[b]
            else:
                # every live row must get a decode source from exactly one
                # phase-2 path; a misrouted row decoding to empty targets
                # would look like a successful no-op placement
                raise AssertionError(
                    "schedule round produced no decode source for live row "
                    f"{key!r} (strategy {int(raw.strategy[b])})"
                )
            out.append(dec)
        return out

    @staticmethod
    def _mask_replicas(raw: BindingBatch, bindings, b: int) -> int:
        """Replicas per target of a duplicated / non-workload row."""
        return 0 if int(raw.strategy[b]) == NON_WORKLOAD else int(bindings[b].spec.replicas)

    def _spread_prelaunch(self, bindings, raw, extra, batched_rows, batched_cfg,
                          dev_feasible, dev_score, dev_avail, dev_prev):
        """LAUNCH the batched spread rows' group scoring (no sync): rows whose
        scoring inputs are identical share one representative — policy-heavy
        batches collapse many-fold, so only the representatives are scored,
        each read from the filter outputs through its row id. The overlay
        expands (weight, value, feas_count) back through `score_inv`."""
        if not batched_rows:
            return None
        from .. import kernels

        S = len(batched_rows)
        need = np.ones(S, np.int64)
        target = np.ones(S, np.int64)
        reps = np.zeros(S, np.int64)
        dupf = np.zeros(S, bool)
        for j, b in enumerate(batched_rows):
            cfg = batched_cfg[b]
            need[j] = cfg.need
            target[j] = -(-bindings[b].spec.replicas // max(cfg.rmin, 1))
            reps[j] = bindings[b].spec.replicas
            dupf[j] = cfg.duplicated

        # the reference's key: rows whose estimator answers differ never
        # share a representative (its out-of-tree plugin masks and scores
        # are absent in the port)
        rep_of: dict[tuple, int] = {}
        rep_js: list[int] = []
        inv = np.empty(S, np.int64)
        for j, b in enumerate(batched_rows):
            key = (
                int(raw.aff_idx[b]), int(raw.tol_idx[b]),
                int(raw.gvk[b]), int(raw.req_idx[b]),
                bool(raw.unknown_request[b]), int(raw.replicas[b]),
                raw.evict_idx[b].tobytes(),
                raw.prev_idx[b].tobytes(), raw.prev_rep[b].tobytes(),
                int(need[j]), int(target[j]), bool(dupf[j]),
                None if extra is None else extra[b].tobytes(), None, None,
            )
            r = rep_of.get(key)
            if r is None:
                r = len(rep_js)
                rep_of[key] = r
                rep_js.append(j)
            inv[j] = r
        js = np.asarray(rep_js, np.int64)
        dev = self.device
        lay = self._layout_dev
        W, V, _A, fc = kernels.group_score(
            dev_feasible, dev_score, dev_avail, dev_prev,
            to_device(np.asarray(batched_rows, np.int32)[js], dev),
            *(to_device(x[js], dev) for x in (reps, need, target, dupf)),
            lay["perm"], lay["seg_start"], lay["seg_end"], lay["rank_p"],
        )
        return {"score_inv": inv, "wvf": (W, V, fc)}

    def _spread_overlay(self, p, feas_count, unsched, avail_sum,
                        row_err, row_target_src, row_feas_src) -> None:
        """Spread-constrained rows of a dense round: the batched region path
        (host combination search over the fetched group scores, then the
        packed selection masks and the division re-run over the selection,
        one more sync) and the per-row exact fallback (the selection of
        sched/spread.py, then a restricted re-solve). Mutates the decode
        overlays in place."""
        from .. import kernels
        from . import spread as spread_mod
        from . import spread_batch

        bindings, raw, t = p["bindings"], p["raw"], p["t"]
        batched_rows, batched_cfg = p["batched_rows"], p["batched_cfg"]
        fallback_rows = list(p["fallback_rows"])
        dev_feasible, dev_score, dev_avail, dev_prev, dev_tie = p["dev"]
        names = self.fleet.names
        C = len(names)
        dev = self.device

        # ---- batched spread path ----
        if batched_rows:
            layout = self._spread_layout
            pre = p["spread_pre"]
            inv = pre["score_inv"]
            W, V, fc = (x[inv] for x in pre["wvf_host"])
            for j, b in enumerate(batched_rows):
                feas_count[b] = fc[j]

            j_by_cfg: dict = {}
            for j, b in enumerate(batched_rows):
                if fc[j] > 0:  # 0-feasible rows take the FitError branch
                    j_by_cfg.setdefault(batched_cfg[b], []).append(j)
            chosen = np.zeros((len(batched_rows), layout.n_regions), bool)
            for cfg, js in j_by_cfg.items():
                res = spread_batch.select_regions_batch(W[js], V[js], cfg, layout, on=dev)
                chosen[js] = res.chosen
                for local, msg in res.errors.items():
                    row_err[batched_rows[js[local]]] = msg
                for local in res.fallback:
                    fallback_rows.append(batched_rows[js[local]])
            fallback_set = set(fallback_rows)

            ok_js = [
                j for j, b in enumerate(batched_rows)
                if fc[j] > 0 and b not in row_err and b not in fallback_set
            ]
            if ok_js:
                # rows sharing (filters, eviction set, chosen regions) have
                # IDENTICAL masks: only representative rows are packed
                rep_of: dict[tuple, int] = {}
                rep_js: list[int] = []
                rep_idx_of_j: dict[int, int] = {}
                div_js = []
                for j in ok_js:
                    b = batched_rows[j]
                    k = (
                        int(raw.aff_idx[b]), int(raw.tol_idx[b]),
                        int(raw.gvk[b]), raw.evict_idx[b].tobytes(),
                        chosen[j].tobytes(),
                    )
                    r = rep_of.get(k)
                    if r is None:
                        r = len(rep_js)
                        rep_of[k] = r
                        rep_js.append(j)
                    rep_idx_of_j[j] = r
                    if int(raw.strategy[b]) not in (NON_WORKLOAD, DUPLICATED):
                        div_js.append(j)
                rid = self._layout_dev["rid"]
                rows_of = np.asarray(batched_rows, np.int32)
                packed_dev = kernels.packed_selection(
                    dev_feasible, *to_device_packed([rows_of[rep_js], chosen[rep_js]], dev), rid)
                tail_dev = None
                if div_js:
                    d_rows = [batched_rows[j] for j in div_js]
                    max_repl = int(raw.replicas[d_rows].max(initial=0))
                    topk_d = min(pow2_bucket(min(max_repl, TOPK_TARGETS), lo=8), TOPK_TARGETS)
                    has_agg_d = bool((raw.strategy[d_rows] == AGGREGATED).any())
                    tail_dev = kernels.spread_tail(
                        dev_feasible, dev_avail, dev_prev, dev_tie,
                        to_device(rows_of[div_js], dev), to_device(chosen[div_js], dev), rid,
                        t["strategy"], t["replicas"], t["fresh"],
                        topk=topk_d, has_agg=has_agg_d,
                    )

                # one sync for the packed representatives AND the tail (its
                # dense result stays on the device; only overflow rows fetch)
                host = [packed_dev] + ([] if tail_dev is None else list(tail_dev[1:]))
                host = [x.cpu().numpy() for x in host]
                packed_reps = host[0]
                for j in ok_js:
                    b = batched_rows[j]
                    prow = packed_reps[rep_idx_of_j[j]]
                    row_feas_src[b] = ("mask", names, prow, C)
                    strat = int(raw.strategy[b])
                    if strat == NON_WORKLOAD:
                        row_target_src[b] = ("mask", names, prow, C, 0)
                    elif strat == DUPLICATED:
                        row_target_src[b] = (
                            "mask", names, prow, C, int(bindings[b].spec.replicas),
                        )
                if div_js:
                    un2, as2, fc2, nnz2, ti2, tv2 = host[1:]
                    ti2s, tv2s = _sorted_pairs(ti2, tv2)
                    overflow2 = []
                    for k, b in enumerate(d_rows):
                        unsched[b] = bool(un2[k])
                        avail_sum[b] = int(as2[k])
                        feas_count[b] = int(fc2[k])
                        n = int(nnz2[k])
                        if n > ti2.shape[1]:
                            overflow2.append((k, b))
                            continue
                        row_target_src[b] = ("pairs", names, ti2s[k, :n], tv2s[k, :n])
                    if overflow2:
                        o_res = fetch_rows(tail_dev[0], [k for k, _ in overflow2], self._bucket)
                        for m, (_, b) in enumerate(overflow2):
                            pos = np.nonzero(o_res[m] > 0)[0]
                            row_target_src[b] = (
                                "pairs", names, pos, o_res[m, pos].astype(np.int64),
                            )

        # ---- fallback spread path: the per-row exact selection + restricted
        # re-solve (sched/spread.py stays the semantic spec) ----
        if not fallback_rows:
            return
        fallback_rows = sorted(set(fallback_rows))
        f_feas = fetch_rows(dev_feasible, fallback_rows, self._bucket)
        f_score = fetch_rows(dev_score, fallback_rows, self._bucket)
        f_avail = fetch_rows(dev_avail, fallback_rows, self._bucket)
        live_rows, sel_masks = [], []
        for k, b in enumerate(fallback_rows):
            if not f_feas[k].any():
                continue  # FitError branch
            rb = bindings[b]
            prev_row = np.zeros(C + 1, np.int32)
            prev_row[raw.prev_idx[b]] = raw.prev_rep[b]
            feas = np.nonzero(f_feas[k])[0]
            try:
                selected_idx = spread_mod.select_by_spread_arrays(
                    feas,
                    f_score[k, feas],
                    f_avail[k, feas].astype(np.int64) + prev_row[feas],
                    self._name_rank[feas],
                    self._region_id[feas],
                    self._region_names,
                    rb.spec.placement,
                    rb.spec.replicas,
                )
            except spread_mod.SpreadError as e:
                row_err[b] = str(e)
                continue
            mask = np.zeros(C, bool)
            mask[selected_idx] = True
            live_rows.append(b)
            sel_masks.append(mask)
        if not live_rows:
            return
        aff_rows = raw.aff_masks[raw.aff_idx[np.asarray(live_rows)]]
        sel = np.stack(sel_masks)
        extra_mask = None
        if self._plugin_bits & plugin_mod.BIT_AFFINITY:
            aff_rows = aff_rows & sel
        else:
            # the filter ignores the affinity table without ClusterAffinity,
            # so the selection (a SelectClusters restriction, not an
            # affinity term) rides the extra_mask channel, as in the
            # reference
            extra_mask = sel
        sub_extra = None if p["extra"] is None else p["extra"][live_rows]
        s_out = self.run_kernel(self._pad(_restrict_rows(raw, live_rows, aff_rows)),
                                extra_avail=sub_extra, extra_mask=extra_mask)
        s_feas, s_result, s_unsched, s_avail_sum = (
            s_out[k].cpu().numpy()[: len(live_rows)] for k in (0, 2, 3, 4))
        for j, b in enumerate(live_rows):
            fidx = np.nonzero(s_feas[j])[0]
            row_feas_src[b] = ("idx", names, fidx)
            feas_count[b] = len(fidx)
            if raw.strategy[b] == NON_WORKLOAD:
                # targets = the selected set, no replica counts
                row_target_src[b] = ("pairs", names, fidx, np.zeros(len(fidx), np.int64))
            else:
                pos = np.nonzero(s_result[j] > 0)[0]
                row_target_src[b] = ("pairs", names, pos, s_result[j, pos].astype(np.int64))
            unsched[b] = bool(s_unsched[j])
            avail_sum[b] = int(s_avail_sum[j])

    def run_kernel(self, batch: BindingBatch, extra_avail: Optional[np.ndarray] = None,
                   extra_mask: Optional[np.ndarray] = None,
                   extra_score: Optional[np.ndarray] = None):
        """The full solve of a (sub-)batch, the reference's `run_kernel`
        (`_schedule_kernel_compact`): the dense filter over its rows, then
        the dense tail over all of them (it places Duplicated rows too)
        with the output window of `_batch_topk`. `extra_avail` (i32[rows,
        c], or None) are the rows' estimator answers; `extra_mask`
        (bool[rows, C], or None) is ANDed into each row's feasibility, rows
        past it keeping theirs. `extra_score` comes only from out-of-tree
        plugins, which the port does not run yet. The batch comes padded
        (`_pad`), as the reference's callers pass it. Returns the
        reference's ten device outputs (feasible, score, result,
        unschedulable, avail_sum, avail, feas_count, nnz, top_idx, top_val)
        over the batch's rows (under a monolithic mesh, the mesh kernel's,
        rows and columns padded to the mesh)."""
        from .. import kernels
        from ..convert import batch_from_numpy

        if extra_score is not None:
            raise NotImplementedError(
                "run_kernel: extra_score (out-of-tree plugin scores) is ROADMAP queue A item 8")
        if self.mesh is not None and not self.mesh_partitioned:
            return self._mesh_solver()(batch, extra_avail, extra_mask=extra_mask,
                                       plugin_bits=self._plugin_bits)
        t = batch_from_numpy({name: getattr(batch, name) for name in _BATCH_FIELDS}, self.device)
        mask_dev = None
        if extra_mask is not None:
            full = np.ones((len(batch.replicas), extra_mask.shape[1]), bool)
            full[: len(extra_mask)] = extra_mask
            mask_dev = to_device(full, self.device)
        f = self._fleet_dev
        feas, score, avail, prev, tie, feas_count = kernels.dense_filter(
            f["alive"], f["capacity"], f["has_summary"], f["taint_key"],
            f["taint_value"], f["taint_effect"], f["api_ok"],
            t["replicas"], t["unknown_request"], t["gvk"],
            t["tol_tables"], t["tol_idx"], t["aff_masks"], t["aff_idx"],
            t["prev_idx"], t["prev_rep"], t["evict_idx"], t["seeds"],
            t["req_unique"], t["req_idx"], self._upload_extra(extra_avail, len(batch.replicas)),
            plugin_bits=self._plugin_bits, extra_mask=mask_dev,
        )
        rows = torch.arange(len(batch.replicas), dtype=I32, device=self.device)
        C = feas.shape[1]
        result, unsched, avail_sum, nnz, top_idx, top_val = kernels.dense_tail(
            feas, avail, prev, tie, rows, t["weight_tables"], t["weight_idx"],
            t["strategy"], t["replicas"], t["fresh"],
            topk=min(C, _batch_topk(batch)),
            has_agg=bool((batch.strategy == AGGREGATED).any()),
        )
        return (feas, score, result, unsched, avail_sum, avail, feas_count, nnz, top_idx,
                top_val)

    def _schedule_once_monolithic(self, bindings: Sequence, extra_avail=None,
                                  term_indices=None) -> list[ScheduleDecision]:
        """One round through the mesh kernel (the reference's
        `_schedule_once_monolithic`): encode and pad the batch, solve every
        row over the mesh, fetch the compact outputs in one sync, run the
        spread overlay on the gathered rows, fetch the rows whose targets
        outran the window and the feasible lists of non-workload rows, and
        decode in the bindings' order."""
        from ..convert import batch_from_numpy

        n_real = len(bindings)
        if n_real == 0:
            return []
        names = self.fleet.names
        batched_rows, batched_cfg, fallback_rows = self._classify_spread(bindings)
        with stage_span("encode", self.stage_timer):
            with self._encode_lock:
                raw = self.batch_encoder.encode(bindings, term_indices=term_indices)
            batch = self._pad(raw)
        n_rows = len(batch.replicas)
        with stage_span("solve", self.stage_timer):
            outs, dev_prev, dev_tie = self._mesh_solver().run(
                batch, extra_avail, plugin_bits=self._plugin_bits)
            # the batch's rows of the mesh outputs (the fleet is already
            # mesh-wide: _fleet_width), contiguous row slices
            dev_feasible, dev_score, dev_result, dev_avail, dev_prev, dev_tie = (
                x[:n_rows] for x in (outs[0], outs[1], outs[2], outs[5], dev_prev, dev_tie))
            t = batch_from_numpy({n: getattr(batch, n) for n in ("strategy", "replicas", "fresh")},
                                 self.device)
            spread_pre = self._spread_prelaunch(
                bindings, raw, extra_avail, batched_rows, batched_cfg,
                dev_feasible, dev_score, dev_avail, dev_prev)
        with stage_span("materialize", self.stage_timer):
            host = [x.cpu().numpy() for x in outs[3:5] + outs[6:]]
            if spread_pre is not None:
                spread_pre["wvf_host"] = [x.cpu().numpy() for x in spread_pre["wvf"]]
            unsched, avail_sum, feas_count, nnz, top_idx, top_val = host
            unsched = unsched[:n_real].copy()
            avail_sum = avail_sum[:n_real].astype(np.int64)
            feas_count = feas_count[:n_real].astype(np.int64)
            row_err: dict[int, str] = {}
            row_target_src: dict[int, tuple] = {}
            row_feas_src: dict[int, tuple] = {}
            self._spread_overlay(
                {"bindings": bindings, "raw": raw, "t": t, "extra": extra_avail,
                 "batched_rows": batched_rows, "batched_cfg": batched_cfg,
                 "fallback_rows": fallback_rows, "spread_pre": spread_pre,
                 "dev": (dev_feasible, dev_score, dev_avail, dev_prev, dev_tie)},
                feas_count, unsched, avail_sum, row_err, row_target_src, row_feas_src,
            )
            Kw = top_idx.shape[1]
            ti_sorted, tv_sorted = _sorted_pairs(top_idx, top_val)
            overflow = [b for b in range(n_real)
                        if b not in row_target_src and nnz[b] > Kw
                        and raw.strategy[b] != NON_WORKLOAD]
            if overflow:
                o_res = fetch_rows(dev_result, overflow, self._bucket)
                for k, b in enumerate(overflow):
                    pos = np.nonzero(o_res[k] > 0)[0]
                    row_target_src[b] = ("pairs", names, pos, o_res[k, pos].astype(np.int64))
            nonwork = [b for b in range(n_real)
                       if raw.strategy[b] == NON_WORKLOAD and b not in row_feas_src
                       and feas_count[b] > 0]
            if nonwork:
                nw_feas = fetch_rows(dev_feasible, nonwork, self._bucket)
                for k, b in enumerate(nonwork):
                    fidx = np.nonzero(nw_feas[k])[0]
                    row_feas_src[b] = ("idx", names, fidx)
                    row_target_src[b] = ("pairs", names, fidx, np.zeros(len(fidx), np.int64))
            # every other row's targets are its compact window
            for b in range(n_real):
                if b not in row_target_src:
                    n = int(nnz[b])
                    row_target_src[b] = ("pairs", names, ti_sorted[b, :n], tv_sorted[b, :n])
            return self._decisions(raw, feas_count, unsched, avail_sum, row_err, row_target_src,
                                   row_feas_src)

    def _classify_spread(self, bindings) -> tuple[list[int], dict, list[int]]:
        """Split spread-constrained rows into the batched path and the
        per-row exact fallback (cluster-only constraints, cluster MaxGroups
        caps, zone/provider fields, huge region counts, or divided rows
        wider than the compact window). Placement-only — runs before any
        kernel."""
        from . import spread as spread_mod
        from . import spread_batch

        batched, cfg_of, fallback = [], {}, []
        layout = self._spread_layout
        # placements are shared across many rows: classify each DISTINCT
        # placement once (ids are stable for the duration of the call —
        # bindings hold the references)
        pl_seen: dict[int, object] = {}
        _MISS = object()
        for b, rb in enumerate(bindings):
            placement = rb.spec.placement
            if placement is None or not placement.spread_constraints:
                continue
            cfg = pl_seen.get(id(placement), _MISS)
            if cfg is _MISS:
                if spread_mod.should_ignore_spread_constraint(placement):
                    cfg = "ignore"
                else:
                    cfg = spread_batch.config_of(placement)
                pl_seen[id(placement)] = cfg
            if cfg == "ignore":
                continue
            if (
                cfg is not None
                and 0 < layout.n_regions <= spread_batch.MAX_REGIONS
                and (cfg.duplicated or rb.spec.replicas <= TOPK_TARGETS)
            ):
                batched.append(b)
                cfg_of[b] = cfg
            else:
                fallback.append(b)
        return batched, cfg_of, fallback

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
