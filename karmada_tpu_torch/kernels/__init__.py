"""Kernel wrappers of the schedule rounds, each beside its plain PyTorch
version.

Compact candidate round:
- `candidate_select` (csrc/candidate_select.cu): filters + locality score
  over [B, C], the top-K window, and everything gathered to [B, K]; or,
  with `col0`, over one mesh tile's columns (global ids and ties, the
  affinity table, answers and terms read as column views); the plain
  version is `select_plain`.
- `candidate_merge` (csrc/candidate_merge.cu): the partitioned mesh's
  merge of a row group's shard windows into the row's top K, in column
  order, the feasible counts summed; the plain version is
  `candidate_merge_plain`.
- `candidate_tail` (csrc/candidate_tail.cu): the replica-division tail over
  [rows, K] windows plus the compact output window, one warp a row whose
  three orders are register sorts over the warp; the plain version is
  `tail_plain`.

Dense round:
- `dense_filter` (csrc/dense_filter.cu): filters, score, the [B, C]
  estimator answer, previous replicas, tie values and the feasible count;
  the estimate per distinct request, the taints per toleration table and
  api_ok are built once as tables (their plain mirror
  `dense_filter_tables_plain`, read back by `dense_filter_apply_plain`),
  then a tiled pass writes the rows from them; the plain version is
  `dense_filter_plain`.
- `dense_tail` (csrc/dense_tail.cu): the replica-division tail over full
  rows of width C, read from the filter outputs through row ids, plus the
  compact output window (none with topk = 0); rows up to
  MAX_TAIL_SMEM_COLS wide are read once and staged in shared memory,
  wider ones take the re-reading route; the plain version is
  `dense_tail_plain`.
- `pack_rows` and `feas_idx` (csrc/dense_mask.cu): bit-packed feasible rows
  and the first k feasible column ids per row, each one launch that reads
  the filter outputs in place through int32 row ids (pack_rows on
  packed_selection's body without the region test, feas_idx one warp a
  row); the plain versions are `pack_rows_plain` and `feas_idx_plain`.

Spread constraints (the dense round's batched region path):
- `group_score` (csrc/group_score.cu): every (row, region) group's weight,
  member count and availability sum, read from the filter outputs through
  row ids over the region layout's permuted slices; the plain version is
  `group_score_plain`.
- `packed_selection` (csrc/dense_mask.cu): bit-packed selection masks,
  each row's filter outputs restricted to its chosen regions, 16 columns
  a thread, one launch over the caller's bool [n, R] choice; the plain
  version is `packed_selection_plain`.
- `spread_tail` (csrc/dense_tail.cu, the dense tail restricted to each
  row's chosen regions, zero static weights): the division re-run over the
  selection plus its feasible count; the plain version is
  `spread_tail_plain`.
- `combo_select` (csrc/combo_select.cu): the winning region combination
  per row over the enumerated combination table, any number of regions,
  one warp a row and one pass (a row's regions in shared memory up to
  MAX_COMBO_SMEM_REGIONS, read in place past it), the outputs views of
  one block; the plain version is `combo_select_plain`.

Priority tiers (the tiered rounds of sched/preemption.py, composed with
the kernels above):
- `tier_estimate` (csrc/tiers.cu): the estimator answer over a tier's rows
  at a capacity matrix passed in, min-merged with the registered-estimator
  answers when they are given, into the [B, C] avail buffer (rows mode:
  from a table per distinct request at that capacity, or per element,
  `estimate_route`) or at the rows' candidate windows (window mode, a
  tier's main and speculative passes in one launch when paired); the
  plain version is `tier_estimate_plain`.
- `tier_consume` (csrc/tiers.cu): the capacity left after a tier's
  committed placements, `max(cap - placed.T @ request, 0)` in exact
  int64, dense or scattered through the candidate windows (the window
  mode counts as its own kernel, `tier_consume_window`), one launch a
  call per block of up to 16 resources; the plain version is
  `tier_consume_plain`.

The estimator sweep and the degraded mode (estimator/client.py,
faults/staleness.py):
- `fleet_estimate` (csrc/fleet_estimate.cu): every member cluster's
  accurate-estimator answer for every row, over the fleet's concatenated
  node arrays with the claim-free node mask; each distinct request (a
  table and the rows' index, as the estimator passes them) is evaluated
  once over nodes staged in shared memory, then gathered to the rows; the
  caller's node ranges replace the sort of the cluster ids; the plain
  version is `fleet_estimate_plain` (ops/estimate.py `fleet_estimate`).
- `staleness_penalty` (csrc/staleness.cu): the decay of stale answers,
  `values >> shift` where non-negative; the plain version is
  `staleness_penalty_plain`.

The fleet refresh (sched/core.py `set_clusters(..., dirty_names)`):
- `scatter_rows` (csrc/scatter_rows.cu): the re-encoded clusters' rows
  written in place into the resident fleet tensors, every tensor in one
  launch, a block a dirty row; the plain version is `scatter_rows_plain`.
  The refresh goes through a `FleetScatter` (`fleet_scatter(dsts)`)
  bound once per placed fleet: per call one pinned host block (the ids,
  then the rows) gathered on the host, one non-blocking upload and one
  C call, no stream sync. `scatter_rows(dsts, idx, srcs)` takes
  separate device sources (the same kernel).

The simulation plane's solve (simulation/engine.py `_sim_solve`: the
filter below, `dense_tail` over the S x B scenario rows, then the load):
- `sim_filter` (csrc/dense_filter.cu, its second entry): the dense filter
  and estimate over a scenario-stacked fleet, each scenario's tie from its
  remapped column index, as [S, B, C] plus the [S, B] feasible count; the
  estimate per distinct request and the taints per toleration table are
  built once per scenario as tables (their plain mirrors
  `sim_estimate_table_plain` / `sim_estimate_apply_plain`), then a tiled
  pass writes the rows from them; the plain version is `sim_filter_plain`.
- `sim_load` (csrc/sim_load.cu): the per-scenario load of the division
  result, replicas and resources per cluster over the scenario's active
  rows, exact int64, any number of resources (one launch per block of
  eight); the plain version is `sim_load_plain`.

The dense-input schedule program (sched/core.py `_schedule_kernel`: the
filter below, then `dense_tail` over every row):
- `dense_input_filter` (csrc/dense_filter.cu, its third entry): the dense
  filter and estimate over fully dense row inputs (tolerations [B, K],
  affinity / eviction / previous-membership masks [B, C], request
  [B, R]) with the answer matrix min-merged, every in-tree plugin on;
  the kernel factors each group of DENSE_INPUT_GROUP rows itself (the
  estimate per distinct request, the column-ok per distinct toleration
  row and gvk, in shared memory, kept over the groups a block walks;
  their plain mirror per group `dense_input_filter_groups_plain`); the
  plain version is `dense_input_filter_plain`.

The mesh solve (parallel/mesh.py `MeshScheduleKernel`: the tile filter
below on every (row group, column shard) tile, the tiles gathered along
the cluster axis, then `dense_tail` over each row group's full rows):
- `mesh_tile_filter` (csrc/dense_filter.cu, its fourth entry): the dense
  filter and estimate over one [B_l, C_l] tile whose first global column
  is col0 (prev / evict ids global, the tie at the global column), with
  the answers, mask and score read in place through their row strides;
  dense_filter's tables over the tile's fleet slice, then its tiled pass
  (`dense_filter_apply_plain` with `col0` and `extra_score`); the plain
  version is `mesh_tile_filter_plain`.

The wide routes, kernels of their own with their own launch counts:
`candidate_select` past MAX_SELECT_SMEM (`candidate_select_wide`, the same
selection with the row's keys in a device-memory scratch, csrc/
candidate_select.cu) and `candidate_tail` past MAX_TAIL_K
(`candidate_tail_wide`, csrc/dense_tail.cu in its window mode).

A tiered round drives both tier kernels through one `TierLauncher`
(`tier_launcher`): the round's constant tensors checked and their
pointers bound once, then one C call a tier per estimate and per
consumption.

A wrapper runs the plain version only for tensors that lie on the CPU. For
CUDA tensors it checks device, dtype, shape and contiguity, launches the
kernel on PyTorch's current stream, raises when the launch reports an
error, and adds one to its kernel's launch count (`launch_counts()`,
`reset_launches()`; the process's /metrics shows the same launches as
`karmada_kernel_launches_total`). There is no fallback. Every launch binds its C
prototype once, at its first call (`_bind`).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..faults.staleness import MAX_STALENESS_AGE
from ..metrics import kernel_launches
from ..sched import core
from ..ops import filters as filter_ops
from ..sched.plugins import (
    ALL_PLUGIN_BITS,
    BIT_AFFINITY,
    BIT_API,
    BIT_EVICTION,
    BIT_LOCALITY,
    BIT_TAINT,
)
from ..sched.spread import WEIGHT_UNIT

I64, I32, BOOL, U8 = torch.int64, torch.int32, torch.bool, torch.uint8

# every kernel's launch count, by name (the wide routes of candidate_select
# and candidate_tail are kernels of their own); bumped under a lock, since
# the pipelined round's writer thread launches too
KERNEL_NAMES = (
    "candidate_select", "candidate_select_wide", "candidate_tail", "candidate_tail_wide",
    "dense_filter", "dense_tail", "pack_rows", "feas_idx", "group_score", "packed_selection",
    "spread_tail", "combo_select", "tier_estimate", "tier_consume", "tier_consume_window",
    "fleet_estimate",
    "staleness_penalty", "scatter_rows", "sim_filter", "sim_load", "dense_input_filter",
    "mesh_tile_filter", "candidate_merge",
)
_launch_lock = threading.Lock()
_launches = dict.fromkeys(KERNEL_NAMES, 0)


def _launched(name: str, n: int = 1) -> None:
    with _launch_lock:
        _launches[name] += n
    kernel_launches.inc(n, kernel=name)


def _resource_blocks(R: int, block: int) -> int:
    """Launches a request of R resources takes in blocks of `block` (one
    at R = 0)."""
    return max(1, -(-R // block))


# the window tail's 128-thread block (one thread per window column) serves
# windows up to MAX_TAIL_K; wider ones take dense_tail.cu's window mode.
# The select kernel keeps a row's keys (4 bytes and a bit a column) in
# dynamic shared memory while they fit MAX_SELECT_SMEM, the 227 KB a block
# may use on sm_90 less the kernel's static shared memory (about 4.4 KB);
# wider fleets (about 54 500 columns on) keep them in a device scratch.
MAX_TAIL_K = 128
MAX_SELECT_SMEM = 225_280
# the dense tail sorts its output window in shared memory
MAX_DENSE_TOPK = 128
# candidate_merge takes up to this many shard windows a launch
# (candidate_merge.cu kMaxShards) and stages a row's W = sum K_s keys in
# shared memory, 8 bytes each, up to MAX_MERGE_WIDTH of them
MAX_MERGE_SHARDS = 16
MAX_MERGE_WIDTH = 16384
FEAS_IDX_PAD = 1 << 30  # feas_idx's value past a row's feasible count
# combo_select's sentinels (the reference's `NEG` and its masked discovery key)
COMBO_NEG = -(1 << 62)
COMBO_DISC_MASKED = 1 << 62
# combo_select keeps a row's regions in shared memory up to this many
# (combo_select.cu kSmemRegions) and reads them in place past it
MAX_COMBO_SMEM_REGIONS = 2048
# group_score stages a region of up to this many columns in shared memory
# (group_score.cu kStageMax); wider regions take the re-reading route
MAX_GROUP_STAGE = 1024
# tier_consume keeps one int64 sum per resource in registers for up to 16
# resources; a wider request runs in blocks of 16, one launch each
TIER_RESOURCE_BLOCK = 16
# a tiered round's launcher cuts its consumed capacities from blocks of
# this many (a round consumes once a tier after the first)
TIER_CAP_BLOCK = 8
# sim_load sums up to 8 resources a launch (sim_load.cu kBlockR)
SIM_LOAD_RESOURCE_BLOCK = 8
# the dense tail stages a row in shared memory up to this width (dense_tail.cu
# kSmemMaxCols); wider rows take the re-reading route
MAX_TAIL_SMEM_COLS = 12288
# the tails' and group_score's routes: "reread" forces the re-reading route
TAIL_ROUTES = {"auto": 0, "reread": 1}
# sim_filter's estimate table marks "the row's replicas" with this value
# (dense_filter.cu kEstReplicas); its other entries are answers >= 0
SIM_EST_REPLICAS = -1
# rows the dense-input filter kernel factors together (dense_filter.cu
# kInputRows: the bits of one 32-bit mask)
DENSE_INPUT_GROUP = 32


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def select_plain(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, *, k: int, plugin_bits: int,
    extra_mask=None, extra_score=None, col0: int = 0,
):
    """Plain version of the candidate-select kernel (the reference's
    `_candidate_select_kernel`). Returns (cand_idx i32[B,K], c_feas bool,
    c_score i32, c_avail i32, c_prev i32, c_tie i32, feas_count i32[B],
    packed u8[B,ceil(C/8)]). `extra_avail` is None or i32[B,C] (-1 = no
    answer). `extra_mask` (bool[B,C]) and `extra_score` (i32[B,C]), each
    None when absent, are the out-of-tree plugins' terms: the mask ANDed
    into feasibility, the score added with the int32 wrap, before the
    selection (the reference's filter_phase). A mesh tile passes its first
    global column `col0`: the fleet tensors and the [P, C] / [B, C] inputs
    are then the tile's columns (views allowed), `prev_idx` / `evict_idx`
    hold global ids (those outside [col0, col0 + C) drop), and the tie and
    `cand_idx` are at the global columns."""
    from ..sched.candidates import compact_estimate

    C = alive.shape[0]
    prev_member, prev_replicas, eviction_ok = core.sparse_rows(
        prev_idx.long() - col0, prev_rep, evict_idx.long() - col0, C)
    feasible, score = core.filter_phase(
        alive, taint_key, taint_value, taint_effect, api_ok, gvk,
        tol_tables, tol_idx, aff_masks[aff_idx.long()], eviction_ok, prev_member,
        plugin_bits=plugin_bits,
    )
    feasible, score = _plugin_terms_plain(feasible, score, extra_mask, extra_score)
    key = (feasible.to(I64) << 33) + score.to(I64)
    cand = torch.sort(core.top_k_ordered(key, k), dim=-1).values
    c_extra = None if extra_avail is None else extra_avail.gather(-1, cand)
    c_avail = compact_estimate(
        capacity, has_summary, req_unique, req_idx, replicas, unknown_request,
        cand, c_extra,
    )
    return (
        (cand + col0).to(I32), feasible.gather(-1, cand), score.gather(-1, cand), c_avail,
        prev_replicas.gather(-1, cand), core.tie_at(seeds, cand + col0),
        feasible.sum(-1).to(I32), core.pack_bits(feasible),
    )


def candidate_merge_plain(windows, k: int):
    """Plain version of the window-merge kernel (csrc/candidate_merge.cu):
    `windows` lists a row group's c shard windows in column order, each
    (cand_idx i32[B,K_s] global ids in column order, c_feas bool, c_score
    i32, c_avail i32, c_prev i32, c_tie i32, feas_count i32[B]). Returns
    the row's top k entries over all of them by (feasible desc, score desc,
    column asc), in column order, the six fields carried along, and the
    feasible counts summed: candidate_select's first seven outputs."""
    cat = [torch.cat([w[i] for w in windows], dim=1) for i in range(6)]
    W = cat[0].shape[1]
    if not 0 < k <= W:
        raise ValueError(f"candidate_merge: k={k} must be in (0, {W}]")
    # the concatenation is in column order, so positions order the ties
    key = (cat[1].to(I64) << 33) + cat[2].to(I64)
    pos = torch.sort(core.top_k_ordered(key, k), dim=-1).values
    feas_count = windows[0][6].to(I64)
    for w in windows[1:]:
        feas_count = feas_count + w[6]
    return tuple(x.gather(-1, pos) for x in cat) + (feas_count.to(I32),)


def _plugin_terms_plain(feasible, score, extra_mask, extra_score):
    """The out-of-tree plugin terms on the in-tree filter's output: the
    mask ANDed into feasibility, the score added (torch's int32 add wraps,
    as the reference's does)."""
    if extra_mask is not None:
        feasible = feasible & extra_mask
    if extra_score is not None:
        score = score + extra_score
    return feasible, score


def select_window_plain(feasible, score, k: int):
    """Plain version of candidate_select's selection alone over given rows
    (csrc/candidate_select.cu `select_window_launch`): the top k columns of
    each row by (feasible desc, score desc, column asc), in column order
    (i32[B,k]), and the feasible count (i32[B]); `score` is any i32[B,C]."""
    key = (feasible.to(I64) << 33) + score.to(I64)
    cand = torch.sort(core.top_k_ordered(key, k), dim=-1).values
    return cand.to(I32), feasible.sum(-1).to(I32)


def tail_plain(
    c_feas, c_avail, c_prev, c_tie, cand_idx,
    weight_tables, weight_idx, strategy, replicas, fresh, *, topk: int, has_agg: bool,
):
    """Plain version of the candidate-tail kernel (the reference's
    `_candidate_tail_kernel`): the division tail over [rows, K] windows,
    then the top-`min(K, topk)` output window mapped to GLOBAL cluster ids
    through cand_idx. Returns (result i32[rows,K], unschedulable bool[rows],
    avail_sum i32[rows], nnz i32[rows], top_idx i32, top_val i32)."""
    static_weight = weight_tables[weight_idx.long()[:, None], cand_idx.long()]
    result, unschedulable, avail_sum = core.assignment_tail(
        c_feas, strategy, static_weight, c_avail, c_prev, c_tie,
        replicas, fresh, has_agg=has_agg,
    )
    K = c_feas.shape[1]
    _, nnz, l_idx, top_val = core.compact_outputs(c_feas, result, min(K, topk))
    top_idx = cand_idx.gather(-1, l_idx.long())
    return result, unschedulable, avail_sum, nnz, top_idx, top_val


def dense_filter_plain(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, *, plugin_bits: int, extra_mask=None,
    extra_score=None,
):
    """Plain version of the dense-filter kernel (the reference's
    `_filter_kernel_compact`): over the full [B, C] grid. Returns (feasible
    bool[B,C], score i32, avail i32, prev_replicas i32, tie i32,
    feas_count i32[B]). `extra_avail` is None or i32[B,C] (-1 = no
    answer), min-merged into avail. `extra_mask` is None or bool[B,C],
    ANDed into feasible after the plugin filters, and `extra_score` None
    or i32[B,C], added to the score with the int32 wrap (the reference's
    filter_phase `extra_mask` / `extra_score`)."""
    C = alive.shape[0]
    prev_member, prev_replicas, eviction_ok = core.sparse_rows(prev_idx, prev_rep, evict_idx, C)
    feasible, score, avail = core.filter_estimate_phase(
        alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
        replicas, unknown_request, gvk, tol_tables, tol_idx,
        aff_masks[aff_idx.long()], eviction_ok, prev_member, req_unique, req_idx,
        plugin_bits=plugin_bits,
    )
    feasible, score = _plugin_terms_plain(feasible, score, extra_mask, extra_score)
    if extra_avail is not None:
        avail = torch.where(extra_avail >= 0, torch.minimum(avail, extra_avail), avail)
    tie = core.tie_at(seeds, torch.arange(C, device=alive.device)[None, :])
    return feasible, score, avail, prev_replicas, tie, feasible.sum(-1).to(I32)


def dense_filter_tables_plain(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    tol_tables, req_unique, *, plugin_bits: int,
):
    """Plain mirror of the dense-filter kernel's table pass: est_u i32[U,C]
    (sim_estimate_table_plain's entries for one fleet: 0 without a summary,
    SIM_EST_REPLICAS where the request names no resource or the minimum
    reaches INT32_MAX), col_ok bool[Tt,C] (alive, and with the taint plugin
    on every NoSchedule / NoExecute taint tolerated by table t) and api_t
    bool[G,C] (api_ok transposed)."""
    est_u = sim_estimate_table_plain(capacity[None], has_summary[None], req_unique)[0]
    col_ok = alive[None, :].expand(tol_tables.shape[0], -1)
    if plugin_bits & BIT_TAINT:
        col_ok = col_ok & filter_ops.taint_toleration_mask(
            taint_key, taint_value, taint_effect, *tol_tables.unbind(1))
    return est_u, col_ok, api_ok.T


def dense_filter_apply_plain(
    est_u, col_ok, api_t, replicas, unknown_request, gvk, tol_idx, aff_masks, aff_idx,
    prev_idx, prev_rep, evict_idx, seeds, req_idx, extra_avail, *, plugin_bits: int,
    extra_mask=None, col0: int = 0, extra_score=None,
):
    """Plain mirror of the dense-filter kernel's main pass over the tables
    of `dense_filter_tables_plain`: each row's col_ok row, AND its api_t row
    (none past G), affinity row, eviction list and `extra_mask` as the
    plugins say; the score 100 on a prev column with the locality plugin
    on, plus `extra_score` (wrapping int32); the estimate row with the
    row's clamps (sim_estimate_apply_plain); the tie at the column id; the
    feasible count. Returns dense_filter's six outputs. A mesh tile (the
    tile filter's mode) passes its first global column `col0`: the prev /
    evict ids are global (those outside [col0, col0 + C) drop) and the tie
    is at col0 + c; the terms may be column views."""
    G, C = api_t.shape
    prev_member, prev_replicas, eviction_ok = core.sparse_rows(
        prev_idx.long() - col0, prev_rep, evict_idx.long() - col0, C)
    feasible = col_ok[tol_idx.long()]
    if plugin_bits & BIT_API:
        api = (api_t[gvk.clamp(0, G - 1).long()] & (gvk < G)[:, None] if G
               else torch.zeros_like(feasible))
        feasible = feasible & api
    if plugin_bits & BIT_AFFINITY:
        feasible = feasible & aff_masks[aff_idx.long()]
    if plugin_bits & BIT_EVICTION:
        feasible = feasible & eviction_ok
    if extra_mask is not None:
        feasible = feasible & extra_mask
    score = torch.where(prev_member & bool(plugin_bits & BIT_LOCALITY), 100, 0).to(I32)
    if extra_score is not None:
        score = score + extra_score
    avail = sim_estimate_apply_plain(est_u[None], req_idx, replicas, unknown_request,
                                     extra_avail)[0]
    tie = core.tie_at(seeds, col0 + torch.arange(C, device=est_u.device)[None, :])
    return feasible, score, avail, prev_replicas, tie, feasible.sum(-1).to(I32)


def dense_tail_plain(
    feasible, avail, prev, tie, rows,
    weight_tables, weight_idx, strategy, replicas, fresh, *, topk: int, has_agg: bool,
):
    """Plain version of the dense-tail kernel (the reference's `_tail_kernel`
    on the filter outputs' rows `rows`): `feasible`/`avail`/`prev`/`tie` are
    the [B, C] filter outputs and `weight_idx`/`strategy`/`replicas`/`fresh`
    the batch's [B] columns, all read at `rows` (i32[n]). Returns (result
    i32[n,C], unschedulable bool[n], avail_sum i32[n], nnz i32[n], top_idx
    i32[n,w], top_val i32[n,w]) with w = min(C, topk), the window in
    (value desc, column asc) order; topk = 0 writes no window (w = 0)."""
    r = rows.long()
    f = feasible.index_select(0, r)
    static_weight = weight_tables[weight_idx.index_select(0, r).long()]
    result, unschedulable, avail_sum = core.assignment_tail(
        f, strategy.index_select(0, r), static_weight, avail.index_select(0, r),
        prev.index_select(0, r), tie.index_select(0, r), replicas.index_select(0, r),
        fresh.index_select(0, r), has_agg=has_agg,
    )
    if topk == 0:
        empty = torch.empty((r.numel(), 0), dtype=I32, device=result.device)
        return result, unschedulable, avail_sum, (result > 0).sum(-1).to(I32), empty, empty
    _, nnz, top_idx, top_val = core.compact_outputs(f, result, min(f.shape[1], topk))
    return result, unschedulable, avail_sum, nnz, top_idx, top_val


def pack_rows_plain(feasible, rows):
    """Plain version of the pack-rows kernel (the reference's
    `_pack_rows_kernel` on the filter outputs' rows `rows`, any order,
    repeats allowed): u8[n, ceil(C/8)], bit j of byte i = column 8i+j."""
    return core.pack_bits(feasible.index_select(0, rows.long()))


def feas_idx_plain(feasible, rows, k: int):
    """Plain version of the feasible-index kernel (the reference's
    `_feas_idx_kernel` on the filter outputs' rows `rows`, any order,
    repeats allowed): the ascending ids of the first k feasible columns of
    each row, padded with 2**30 past the row's feasible count (i32[n,k])."""
    feasible = feasible.index_select(0, rows.long())
    B, C = feasible.shape
    out = torch.full((B, k + 1), FEAS_IDX_PAD, dtype=I32, device=feasible.device)
    pos = feasible.to(I64).cumsum(-1) - 1
    pos = torch.where(feasible & (pos < k), pos, k)  # the rest lands in column k
    iota = torch.arange(C, dtype=I32, device=feasible.device).expand(B, C)
    out.scatter_(1, pos, iota)
    return out[:, :k].contiguous()


def _stable_by(key, *xs):
    """The [S, w] tensors xs reordered, row by row, by a stable ascending
    sort of key."""
    o = torch.argsort(key, dim=1, stable=True)
    return [x.gather(1, o) for x in xs]


def group_score_plain(
    feasible, score, avail, prev, rows, replicas, need, target, duplicated,
    perm, seg_start, seg_end, rank_p,
):
    """Plain version of the group-scoring kernel (the reference's
    `group_score_kernel`, and its skew-proof twin
    `group_score_kernel_segmented`, which gives the same outputs) on the
    [B, C] filter outputs' rows `rows` (i32[S]). Each region's members (the
    permuted columns perm[seg_start[g]:seg_end[g]]) sort by (infeasible,
    score desc, avail + prev desc, name rank asc), the sortClusters order
    (util.go:43-57); then calcGroupScore (group_clusters.go:143-330): the
    Duplicated score over the members whose availability covers replicas,
    and the Divided score at the FIRST sorted position k with
    k + 1 >= need and a prefix availability >= target. Divisions floor
    (scores are non-negative in-tree; a negative one floors toward -inf,
    as jnp's // does). Returns (weight i64[S,R], value i32[S,R], avail_sum
    i64[S,R], feas_count i32[S] over the whole row)."""
    r = rows.long()
    S, R = r.numel(), seg_start.numel()
    dev = feasible.device
    f_all = feasible.index_select(0, r)
    p = perm.long()
    f = f_all[:, p]
    av = torch.where(f, avail.index_select(0, r)[:, p].to(I64)
                     + prev.index_select(0, r)[:, p].to(I64), 0)
    sc = torch.where(f, score.index_select(0, r)[:, p].to(I64), 0)
    weight = torch.zeros((S, R), dtype=I64, device=dev)
    value = torch.zeros((S, R), dtype=I32, device=dev)
    av_sum = torch.zeros((S, R), dtype=I64, device=dev)
    rep, need, tgt = replicas.to(I64)[:, None], need.to(I64)[:, None], target.to(I64)[:, None]
    for g, (lo, hi) in enumerate(zip(seg_start.tolist(), seg_end.tolist())):
        if hi <= lo:
            continue
        # least significant key first, each sort stable: a lexicographic sort
        o = torch.argsort(rank_p[lo:hi].long(), stable=True)
        fg, ag, sg = f[:, lo:hi][:, o], av[:, lo:hi][:, o], sc[:, lo:hi][:, o]
        fg, ag, sg = _stable_by(-ag, fg, ag, sg)
        fg, ag, sg = _stable_by(-sg, fg, ag, sg)
        fg, ag, sg = _stable_by((~fg).to(I64), fg, ag, sg)
        w = hi - lo
        cum_av, cum_sc = ag.cumsum(1), sg.cumsum(1)
        val = fg.sum(1, keepdim=True).to(I64)
        a_sum, s_sum = cum_av[:, -1:], cum_sc[:, -1:]
        idx = torch.arange(w, device=dev)[None, :]
        cond = (idx + 1 >= need) & (cum_av >= tgt) & (idx < val)
        big = 1 << 40
        k = torch.where(cond, idx, big).min(1, keepdim=True).values
        met = k < big
        k_eff = torch.where(met, k, val - 1).clamp(0, w - 1)
        sc_at_k = cum_sc.gather(1, k_eff)
        denom = torch.where(met, k_eff + 1, val).clamp(min=1)
        w_div = torch.where(
            a_sum < tgt,
            a_sum * WEIGHT_UNIT + torch.div(s_sum, val.clamp(min=1), rounding_mode="floor"),
            tgt * WEIGHT_UNIT + torch.div(sc_at_k, denom, rounding_mode="floor"),
        )
        dup_ok = fg & (ag >= rep)
        cnt = dup_ok.sum(1, keepdim=True).to(I64)
        sc_dup = torch.where(dup_ok, sg, 0).sum(1, keepdim=True)
        w_dup = torch.where(
            cnt > 0,
            cnt * WEIGHT_UNIT + torch.div(sc_dup, cnt.clamp(min=1), rounding_mode="floor"), 0)
        wg = torch.where(duplicated[:, None], w_dup, w_div)
        weight[:, g] = torch.where(val > 0, wg, 0)[:, 0]
        value[:, g] = val[:, 0].to(I32)
        av_sum[:, g] = a_sum[:, 0]
    return weight, value, av_sum, f_all.sum(-1).to(I32)


def _selection(feasible, rows, chosen, rid):
    """feasible[rows[j], c] & chosen[j, region(c)] (bool[n, C]); `chosen`
    is bool[n, R], `rid` the layout's i32[C] region id + 1 (0 =
    regionless, never selected)."""
    n = rows.numel()
    chosen_pad = torch.cat(
        [torch.zeros((n, 1), dtype=BOOL, device=chosen.device), chosen], dim=1)
    return feasible.index_select(0, rows.long()) & chosen_pad[:, rid.long()]


def packed_selection_plain(feasible, rows, chosen, rid):
    """Plain version of the packed-selection kernel (the reference's
    `packed_selection_kernel` on the filter outputs' rows `rows`): the
    selection masks bit-packed, u8[n, ceil(C/8)]."""
    return core.pack_bits(_selection(feasible, rows, chosen, rid))


def spread_tail_plain(
    feasible, avail, prev, tie, rows, chosen, rid, strategy, replicas, fresh, *,
    topk: int, has_agg: bool,
):
    """Plain version of the spread-tail kernel (the reference's
    `spread_tail_kernel` on the filter outputs' rows `rows`): the division
    tail over the selection (feasible and in a chosen region) with zero
    static weights, then the compact window. `strategy`/`replicas`/`fresh`
    are the batch's [B] columns read at `rows`. Returns (result i32[n,C],
    unschedulable bool[n], avail_sum i32[n], feas_count i32[n] of the
    selection, nnz i32[n], top_idx i32[n,w], top_val i32[n,w]),
    w = min(C, topk)."""
    r = rows.long()
    sel = _selection(feasible, rows, chosen, rid)
    result, unschedulable, avail_sum = core.assignment_tail(
        sel, strategy.index_select(0, r), torch.zeros(sel.shape, dtype=I64, device=sel.device),
        avail.index_select(0, r), prev.index_select(0, r), tie.index_select(0, r),
        replicas.index_select(0, r), fresh.index_select(0, r), has_agg=has_agg,
    )
    feas_count, nnz, top_idx, top_val = core.compact_outputs(
        sel, result, min(sel.shape[1], topk))
    return result, unschedulable, avail_sum, feas_count, nnz, top_idx, top_val


def _first_index(mask):
    """Index of the first True per row, the row width where there is none."""
    K = mask.shape[1]
    iota = torch.arange(K, device=mask.device)
    return torch.where(mask, iota, K).min(1).values


def combo_select_plain(weight, value, kmax_row, rname, members_pad, sizes, *,
                       cmin: int, kmin: int):
    """Plain version of the combination-select kernel (the reference's
    `_combo_select_kernel`): per (row, combination of members_pad [K, L],
    -1 = pad) the weight and value sums, the presence of every member, the
    DFS recorded-path pruning through each row's group order (value asc,
    weight desc, name rank asc), the (Σweight, Σvalue) lexicographic winner
    and the discovery-order tie key. Returns (first_idx i32[S], n_ties
    i32[S], none_feasible bool[S]); equal keys take the lowest index."""
    S, R = weight.shape
    v64 = value.to(I64)
    mp = members_pad.long()
    valid = (mp >= 0)[None]
    mpc = torch.where(mp >= 0, mp, 0)
    sum_w = torch.where(valid, weight[:, mpc], 0).sum(-1)  # [S, K]
    sum_v = torch.where(valid, v64[:, mpc], 0).sum(-1)
    present = torch.where(valid, value[:, mpc] > 0, True).all(-1)
    sz = sizes.to(I64)[None, :]
    feasible = present & (sum_v >= cmin) & (sz <= kmax_row.to(I64)[:, None])
    # each region's position in the group order (value asc, weight desc, name asc)
    v_a, v_b = v64[:, :, None], v64[:, None, :]
    w_a, w_b = weight[:, :, None], weight[:, None, :]
    n_a, n_b = rname.long()[None, :, None], rname.long()[None, None, :]
    before = (v_a < v_b) | ((v_a == v_b) & ((w_a > w_b) | ((w_a == w_b) & (n_a < n_b))))
    pos = before.sum(1)  # [S, R]: the regions ordered before each one
    pos_g = torch.where(valid, pos[:, mpc], -1)  # [S, K, L]
    last = mpc[None].expand_as(pos_g).gather(2, pos_g.argmax(2, keepdim=True))[..., 0]
    v_last = v64.gather(1, last)
    recorded = (sz - 1 < kmin) | (sum_v - v_last < cmin)
    feasible &= recorded
    w_m = torch.where(feasible, sum_w, COMBO_NEG)
    best_w = w_m.max(1, keepdim=True).values
    none_feasible = best_w[:, 0] == COMBO_NEG
    cand = feasible & (w_m == best_w)
    v_m = torch.where(cand, sum_v, COMBO_NEG)
    cand2 = cand & (sum_v == v_m.max(1, keepdim=True).values)
    L = mp.shape[1]
    if 7 * L <= 62:
        seq = torch.sort(torch.where(pos_g < 0, 127, pos_g), dim=2).values
        shifts = 7 * torch.arange(L - 1, -1, -1, dtype=I64, device=weight.device)
        disc = torch.where(cand2, (seq << shifts).sum(2), COMBO_DISC_MASKED)
        first_idx = _first_index(disc == disc.min(1, keepdim=True).values)
        n_ties = cand2.sum(1).clamp(max=1)
    else:
        first_idx = _first_index(cand2)
        first_idx = torch.where(first_idx == mp.shape[0], 0, first_idx)
        n_ties = cand2.sum(1)
    return first_idx.to(I32), n_ties.to(I32), none_feasible


def tier_estimate_plain(capacity, has_summary, req_unique, req_idx, replicas,
                        unknown_request, rows, *, out=None, cand_idx=None, extra_avail=None):
    """Plain version of the tier-estimate kernel: the GeneralEstimator
    answer at `capacity` (i64[C,R], the residual of a tier or the
    residual plus the reclaimable capacity) for the batch rows `rows`
    (i32[n]), min-merged with the registered-estimator answers
    `extra_avail` (None or i32[B,C], -1 = no answer). Rows mode (`out`,
    the i32[B,C] avail buffer): the estimate half of
    filter_estimate_phase, written into `out` at those rows (in place;
    returns `out`). Window mode (`cand_idx`, i32[B,K]): `compact_estimate`
    at the rows' candidate columns, a new i32[n,K]."""
    from ..ops import assign as assign_ops
    from ..sched.candidates import compact_estimate

    r = rows.long()
    ridx, reps, unknown = (x.index_select(0, r) for x in (req_idx, replicas, unknown_request))
    extra = None if extra_avail is None else extra_avail.index_select(0, r)
    if cand_idx is not None:
        cand = cand_idx.index_select(0, r)
        return compact_estimate(capacity, has_summary, req_unique, ridx, reps, unknown,
                                cand, None if extra is None else extra.gather(-1, cand.long()))
    est_u, any_u = assign_ops.general_estimate_unique(capacity, has_summary, req_unique)
    avail = assign_ops.general_estimate_apply(est_u, any_u, ridx, has_summary, reps)
    avail = torch.where(unknown[:, None], 0, avail)
    if extra is not None:
        avail = torch.where(extra >= 0, torch.minimum(avail, extra), avail)
    return out.index_copy_(0, r, avail)


def tier_consume_plain(cap, placed, unsched, request, rows, *, cand_idx=None):
    """Plain version of the tier-consume kernel: max(cap - cons, 0) with
    cons[c, r] the sum over the committed rows j (unsched[j] False) of
    placed[j, c] * request[rows[j], r], in int64 (the reference's
    `placed.T @ request_dense`, preemption.py:221-222). Dense mode: placed
    is i32[n,C]. Window mode (`cand_idx`, i32[B,K]): placed is i32[n,K]
    and each entry lands on column cand_idx[rows[j], k] through
    `index_add_` (candidates.py:863-869). Written as a sum over rows per
    resource, not a matrix product: the card has no int64 matmul."""
    r = rows.long()
    p = torch.where(unsched[:, None], 0, placed).to(I64)
    req = request.index_select(0, r)
    if cand_idx is None:
        cons = torch.stack([(p * req[:, i:i + 1]).sum(0) for i in range(req.shape[1])], dim=1)
    else:
        cols = cand_idx.index_select(0, r).long().reshape(-1)
        vals = (p[:, :, None] * req[:, None, :]).reshape(-1, req.shape[1])
        cons = torch.zeros_like(cap).index_add_(0, cols, vals)
    return torch.clamp(cap - cons, min=0)


def fleet_estimate_plain(alloc, requested, pod_count, allowed_pods, cluster_id, n_clusters,
                         claimless_ok, request, *, req_idx=None):
    """Plain version of the fleet-estimate kernel (the reference's
    `_fleet_rows_kernel`): ops/estimate.py `fleet_estimate` over every
    node of the fleet (alloc/requested i64[N,R], pod_count/allowed_pods
    i64[N], cluster_id i32[N] in [0, n_clusters), in any order) with each
    node's claim-free feasibility `claimless_ok` (bool[N]) for every row
    of `request` (i64[B,R]), or, with `req_idx` (i32[B]), for every row of
    `request[req_idx]` (`request` then a table of distinct requests).
    Returns i32[B,n_clusters]."""
    from ..ops.estimate import fleet_estimate as fleet_estimate_ops

    if req_idx is not None:
        request = request.index_select(0, req_idx.long())
    node_ok = claimless_ok[None, :].expand(request.shape[0], alloc.shape[0])
    return fleet_estimate_ops(alloc, requested, pod_count, allowed_pods, cluster_id, request,
                              node_ok, n_clusters)


def staleness_penalty_plain(values, shift: int):
    """Plain version of the staleness kernel (the reference's
    `_apply_jnp`): `values >> shift` where non-negative, other values (the
    -1 discard sentinel) unchanged."""
    return torch.where(values >= 0, values >> shift, values)


def sim_filter_plain(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, tie_idx,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, *, plugin_bits: int,
):
    """Plain version of the scenario-stacked filter kernel (the filter half
    of the reference's `_sim_kernel`): the fleet tensors carry a leading
    scenario axis (alive bool[S,C], capacity i64[S,C,R], has_summary
    bool[S,C], taints i32[S,C,T], api_ok bool[S,C,G]) and `tie_idx`
    (i64[S,C], the u64 1-based present rank as int64 bits) gives each
    scenario's tie stream; the batch and `extra_avail` (None or i32[B,C],
    -1 = no answer) are shared. The dense filter per scenario, with the
    scenario's tie in place of the column's. Returns (feasible
    bool[S,B,C], avail i32, prev_replicas i32, tie i32, feas_count
    i32[S,B])."""
    per = [
        dense_filter_plain(
            alive[s], capacity[s], has_summary[s], taint_key[s], taint_value[s],
            taint_effect[s], api_ok[s], replicas, unknown_request, gvk, tol_tables, tol_idx,
            aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds, req_unique, req_idx,
            extra_avail, plugin_bits=plugin_bits,
        )
        for s in range(alive.shape[0])
    ]
    feasible, _score, avail, prev, _tie, feas_count = (torch.stack(x) for x in zip(*per))
    tie = torch.stack([core.tie_from_index(seeds, idx) for idx in tie_idx])
    return feasible, avail, prev, tie, feas_count


def sim_estimate_table_plain(capacity, has_summary, req_unique):
    """Plain mirror of the sim_filter kernel's estimate table: for every
    scenario s, distinct request u and column c, general_estimate_unique's
    minimum with the clamps of general_estimate_apply that do not depend on
    the row — 0 where the column has no summary, SIM_EST_REPLICAS (-1, "the
    row's replicas") where u requests no resource or the minimum reaches
    INT32_MAX — as i32[S,U,C]; `capacity` i64[S,C,R], `has_summary`
    bool[S,C], `req_unique` i64[U,R]."""
    from ..ops import assign as assign_ops

    out = []
    for cap, summ in zip(capacity, has_summary):
        est, any_req = assign_ops.general_estimate_unique(cap, summ, req_unique)
        est = torch.where(any_req[:, None] & (est < assign_ops.I32_MAX), est, SIM_EST_REPLICAS)
        out.append(torch.where(summ[None, :], est, 0).to(I32))
    return torch.stack(out)


def sim_estimate_apply_plain(est_u, req_idx, replicas, unknown_request, extra_avail):
    """Plain mirror of the sim_filter kernel's per-row estimate: the table
    row of each row's request (i32[S,B,C]), the sentinel replaced by the
    row's replicas, 0 for an unknown request, then the min-merge with a
    non-negative answer of `extra_avail` (None or i32[B,C])."""
    est = est_u.index_select(1, req_idx.long())
    avail = torch.where(est == SIM_EST_REPLICAS, replicas[None, :, None], est)
    avail = torch.where(unknown_request[None, :, None], 0, avail)
    if extra_avail is not None:
        avail = torch.where(extra_avail >= 0, torch.minimum(avail, extra_avail), avail)
    return avail.to(I32)


def dense_input_filter_plain(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, request, unknown_request, gvk, tol_key, tol_value, tol_effect, tol_op,
    affinity_ok, eviction_ok, prev_member, extra_avail,
):
    """Plain version of the dense-input filter kernel (the reference's
    filter_estimate_phase over dense inputs, then the extra_avail
    min-merge, core.py:190-226 and :311): the [B, K] tolerations as a
    [B, 4, K] table with `tol_idx = arange(B)`, the request [B, R] as the
    unique-request table with `req_idx = arange(B)`, every in-tree plugin
    on; `extra_avail` is i32[B, C] (-1 = no answer). Returns (feasible
    bool[B,C], score i32, avail i32)."""
    idx = torch.arange(replicas.shape[0], dtype=I32, device=alive.device)
    tol_tables = torch.stack([tol_key, tol_value, tol_effect, tol_op], dim=1)
    feasible, score, avail = core.filter_estimate_phase(
        alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
        replicas, unknown_request, gvk, tol_tables, idx,
        affinity_ok, eviction_ok, prev_member, request, idx,
    )
    avail = torch.where(extra_avail >= 0, torch.minimum(avail, extra_avail), avail)
    return feasible, score, avail


def _first_rows(rows):
    """(each distinct row's first index, each row's index among the
    distinct rows), the distinct rows in order of first appearance: the
    representatives and table slots of a dense-input group."""
    first, slot, seen = [], [], {}
    for i, row in enumerate(map(tuple, rows.tolist())):
        if row not in seen:
            seen[row] = len(first)
            first.append(i)
        slot.append(seen[row])
    dev = rows.device
    return (torch.tensor(first, dtype=torch.long, device=dev),
            torch.tensor(slot, dtype=I32, device=dev))


def dense_input_filter_groups_plain(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, request, unknown_request, gvk, tol_key, tol_value, tol_effect, tol_op,
    affinity_ok, eviction_ok, prev_member, extra_avail,
):
    """Plain mirror of what the dense-input filter kernel builds and reads
    (every in-tree plugin on): per group of DENSE_INPUT_GROUP rows, the
    representatives (each row's first equal
    request row, and its first equal toleration row with the same gvk),
    the estimate table of the distinct requests (est_u with the
    SIM_EST_REPLICAS sentinel, `dense_filter_tables_plain`'s) and the
    column-ok table of the distinct (toleration row, gvk) pairs (alive,
    api_ok at the gvk, every NoSchedule / NoExecute taint tolerated), then
    per row its two table rows, its affinity and eviction masks, the score
    100 on a previous member, and the row's clamps with the answers'
    min-merge (sim_estimate_apply_plain). Returns dense_input_filter's
    three outputs."""
    B, K = tol_key.shape
    G = api_ok.shape[1]
    tol = torch.stack([tol_key, tol_value, tol_effect, tol_op], dim=1)  # [B, 4, K]
    tol_rows = torch.cat([tol.reshape(B, 4 * K), gvk[:, None]], dim=1)  # the gvk last
    outs = []
    for r0 in range(0, B, DENSE_INPUT_GROUP):
        rows = slice(r0, min(r0 + DENSE_INPUT_GROUP, B))
        req_first, req_slot = _first_rows(request[rows])
        tol_first, tol_slot = _first_rows(tol_rows[rows])
        est_u, col_ok, api_t = dense_filter_tables_plain(
            alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
            tol[rows][tol_first], request[rows][req_first], plugin_bits=ALL_PLUGIN_BITS)
        g = gvk[rows][tol_first]
        api = (api_t[g.clamp(0, G - 1).long()] & (g < G)[:, None] if G
               else torch.zeros_like(col_ok))
        feasible = (col_ok & api)[tol_slot.long()] & affinity_ok[rows] & eviction_ok[rows]
        score = torch.where(prev_member[rows], 100, 0).to(I32)
        avail = sim_estimate_apply_plain(est_u[None], req_slot, replicas[rows],
                                         unknown_request[rows], extra_avail[rows])[0]
        outs.append((feasible, score, avail))
    return tuple(torch.cat(x) for x in zip(*outs))


def mesh_tile_filter_plain(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, extra_mask, extra_score, *, col0: int, plugin_bits: int,
):
    """Plain version of the mesh tile-filter kernel (the per-device half of
    the reference's `_sharded_body`: `decompress_batch(col_offset=col0)`
    and filter_estimate_phase on the tile, then the terms it applies after
    its gather). The fleet tensors and `aff_masks` ([P, C_l]) are the
    tile's column slices; `prev_idx` / `evict_idx` hold GLOBAL column ids
    (an id outside [col0, col0 + C_l) drops, the Cp sentinel included);
    `extra_avail` (i32, -1 = no answer), `extra_mask` (bool) and
    `extra_score` (i32) are None or [B, C_l], views allowed. Returns
    (feasible bool[B,C_l], score i32, avail i32, prev_replicas i32, tie
    i32 at the global columns, feas_count i32[B])."""
    C = alive.shape[0]
    prev_member, prev_replicas, eviction_ok = core.sparse_rows(
        prev_idx.long() - col0, prev_rep, evict_idx.long() - col0, C)
    feasible, score, avail = core.filter_estimate_phase(
        alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
        replicas, unknown_request, gvk, tol_tables, tol_idx,
        aff_masks[aff_idx.long()], eviction_ok, prev_member, req_unique, req_idx,
        plugin_bits=plugin_bits,
    )
    if extra_mask is not None:
        feasible = feasible & extra_mask
    if extra_score is not None:
        score = score + extra_score
    if extra_avail is not None:
        avail = torch.where(extra_avail >= 0, torch.minimum(avail, extra_avail), avail)
    tie = core.tie_at(seeds, col0 + torch.arange(C, device=alive.device)[None, :])
    return feasible, score, avail, prev_replicas, tie, feasible.sum(-1).to(I32)


def sim_load_plain(result, active, request):
    """Plain version of the per-scenario load kernel (the load half of the
    reference's `_sim_kernel`): over each scenario's active rows,
    `assigned[s, c] = sum_b result[s, b, c]` (i64[S,C]) and `usage[s, c, r]
    = sum_b result[s, b, c] * request[b, r]` (i64[S,C,R]), exact int64, a
    scenario and a resource at a time. `result` is i32[S,B,C], `active`
    bool[S,B], `request` i64[B,R]."""
    S, _, C = result.shape
    R = request.shape[1]
    assigned = torch.zeros((S, C), dtype=I64, device=result.device)
    usage = torch.zeros((S, C, R), dtype=I64, device=result.device)
    for s in range(S):
        r64 = torch.where(active[s][:, None], result[s], 0).to(I64)
        assigned[s] = r64.sum(0)
        for r in range(R):
            usage[s, :, r] = (r64 * request[:, r:r + 1]).sum(0)
    return assigned, usage


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def _check(name: str, t, dtype, shape, device):
    if (isinstance(t, torch.Tensor) and t.dtype == dtype and t.shape == shape
            and t.device == device and t.is_contiguous()):
        return  # the common case in one test; a failure below names its cause
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t):
    """A tensor's device address (None, a null pointer, for an absent one)."""
    return None if t is None else t.data_ptr()


def _ptrs(*ts):
    return [_ptr(t) for t in ts]


def _stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device` (its raw handle: no Stream
    object is built per launch)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")


def _check_filter_args(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, extra_mask=None, extra_score=None, *, views=False,
):
    """Check the fleet and factored-batch inputs shared by candidate_select
    and dense_filter, and the optional [B, C] terms (answers, plugin mask
    and score); returns (C, R, T, G, B, Kt, Kp, Ke). With `views` the
    affinity table is left to the caller (it may be a column view)."""
    dev = alive.device
    C, R = capacity.shape
    T = taint_key.shape[1]
    G = api_ok.shape[1]
    B = replicas.shape[0]
    Tt, _, Kt = tol_tables.shape
    P = aff_masks.shape[0]
    Kp = prev_idx.shape[1]
    Ke = evict_idx.shape[1]
    U = req_unique.shape[0]
    for name, t, dt, shape in (
        ("alive", alive, BOOL, (C,)), ("capacity", capacity, I64, (C, R)),
        ("has_summary", has_summary, BOOL, (C,)),
        ("taint_key", taint_key, I32, (C, T)), ("taint_value", taint_value, I32, (C, T)),
        ("taint_effect", taint_effect, I32, (C, T)), ("api_ok", api_ok, BOOL, (C, G)),
        ("replicas", replicas, I32, (B,)), ("unknown_request", unknown_request, BOOL, (B,)),
        ("gvk", gvk, I32, (B,)), ("tol_tables", tol_tables, I32, (Tt, 4, Kt)),
        ("tol_idx", tol_idx, I32, (B,)),
        ("aff_masks", aff_masks, BOOL, (P, C)),
        ("aff_idx", aff_idx, I32, (B,)), ("prev_idx", prev_idx, I32, (B, Kp)),
        ("prev_rep", prev_rep, I32, (B, Kp)), ("evict_idx", evict_idx, I32, (B, Ke)),
        ("seeds", seeds, I64, (B,)), ("req_unique", req_unique, I64, (U, R)),
        ("req_idx", req_idx, I32, (B,)),
    ):
        if not (views and name == "aff_masks"):
            _check(name, t, dt, shape, dev)
    for name, t, dt in (("extra_avail", extra_avail, I32), ("extra_mask", extra_mask, BOOL),
                        ("extra_score", extra_score, I32)):
        if t is not None:
            _check(name, t, dt, (B, C), dev)
    return C, R, T, G, B, Kt, Kp, Ke


def select_smem_bytes(C: int, Kt: int, Kp: int, Ke: int) -> int:
    """Dynamic shared memory of one in-block candidate-select block: the
    toleration row and the prev/evict lists, the row's ballot words and
    its uint32 keys."""
    return 4 * (4 * Kt + 2 * Kp + Ke) + 4 * (-(-C // 32)) + 4 * C


def select_route(C: int, Kt: int, Kp: int, Ke: int) -> str:
    """The candidate-select kernel a launch takes: the in-block route while
    the row's keys fit MAX_SELECT_SMEM, else the same selection over a
    device-memory key scratch."""
    if select_smem_bytes(C, Kt, Kp, Ke) <= MAX_SELECT_SMEM:
        return "candidate_select"
    return "candidate_select_wide"


def candidate_select(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, *, k: int, plugin_bits: int,
    extra_mask=None, extra_score=None, col0: int = 0,
):
    """Candidate select over the fleet and a padded batch, or over one
    mesh tile's columns from global column `col0` (see select_plain for
    the contract)."""
    args = (alive, capacity, has_summary, taint_key, taint_value, taint_effect,
            api_ok, replicas, unknown_request, gvk, tol_tables, tol_idx,
            aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
            req_unique, req_idx, extra_avail)
    kw = dict(k=k, plugin_bits=plugin_bits, extra_mask=extra_mask, extra_score=extra_score,
              col0=col0)
    dev = alive.device
    if dev.type == "cpu":
        return select_plain(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"candidate_select: unsupported device {dev}")
    out = _select_launch(*args, **kw)
    _launched(select_route(alive.shape[0], tol_tables.shape[2], prev_idx.shape[1],
                           evict_idx.shape[1]))
    return out


def _select_launch(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, *, k: int, plugin_bits: int,
    extra_mask=None, extra_score=None, col0: int = 0, route: str = "auto",
):
    """Check, allocate and launch candidate_select_kernel on its route:
    select_route's with route "auto", the device-memory one at any width
    with "wide" (both exact). The wide route's keys go to a uint32 [B, C]
    scratch (allocated as int32). The plugin terms go as null pointers
    when absent. The affinity table, the answers and the terms may be
    column views (a mesh tile's, from global column `col0`): they are read
    in place through their row strides."""
    dev = alive.device
    C, R, T, G, B, Kt, Kp, Ke = _check_filter_args(
        alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
        replicas, unknown_request, gvk, tol_tables, tol_idx,
        aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
        req_unique, req_idx, None, views=True,
    )
    ld_aff, ld_extra, ld_mask, ld_score = (
        C if t is None else max(_check_rows_view(name, t, dt, (n, C), dev), C)
        for name, t, dt, n in (("aff_masks", aff_masks, BOOL, aff_masks.shape[0]),
                               ("extra_avail", extra_avail, I32, B),
                               ("extra_mask", extra_mask, BOOL, B),
                               ("extra_score", extra_score, I32, B)))
    if not 0 < k <= C:
        raise ValueError(f"candidate_select: k={k} must be in (0, C={C}]")
    if col0 < 0:
        raise ValueError(f"candidate_select: col0 {col0} < 0")
    if route not in ("auto", "wide"):
        raise ValueError(f"candidate_select: unknown route {route!r}")
    wide = route == "wide" or select_route(C, Kt, Kp, Ke) == "candidate_select_wide"
    nbytes = (C + 7) // 8
    cand = torch.empty((B, k), dtype=I32, device=dev)
    c_feas = torch.empty((B, k), dtype=BOOL, device=dev)
    c_score = torch.empty((B, k), dtype=I32, device=dev)
    c_avail = torch.empty((B, k), dtype=I32, device=dev)
    c_prev = torch.empty((B, k), dtype=I32, device=dev)
    c_tie = torch.empty((B, k), dtype=I32, device=dev)
    feas_count = torch.empty((B,), dtype=I32, device=dev)
    packed = torch.empty((B, nbytes), dtype=U8, device=dev)
    if B == 0:
        return cand, c_feas, c_score, c_avail, c_prev, c_tie, feas_count, packed
    keys = torch.empty((B, C), dtype=I32, device=dev) if wide else None
    rc = _bind("candidate_select", "candidate_select_launch", _SELECT_ARGTYPES)(
        *_ptrs(alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok),
        C, R, T, G,
        *_ptrs(replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx,
               prev_idx, prev_rep, evict_idx, seeds, req_unique, req_idx),
        B, Kt, Kp, Ke, k, plugin_bits, extra_avail is not None,
        *_ptrs(extra_avail, extra_mask, extra_score, cand, c_feas, c_score, c_avail, c_prev,
               c_tie, feas_count, packed),
        col0, ld_aff, ld_extra, ld_mask, ld_score, _ptr(keys), _stream(dev),
    )
    _raise_on(rc, "candidate_select")
    return cand, c_feas, c_score, c_avail, c_prev, c_tie, feas_count, packed


def _select_window_launch(feasible, score, k: int, *, route: str = "auto"):
    """Check, allocate and launch candidate_select.cu's selection alone
    (see select_window_plain), `route` as for `_select_launch`. No schedule
    round calls it: it holds the selection against its plain version over
    any int32 scores."""
    dev = feasible.device
    B, C = feasible.shape
    _check("feasible", feasible, BOOL, (B, C), dev)
    _check("score", score, I32, (B, C), dev)
    if not 0 < k <= C:
        raise ValueError(f"select_window: k={k} must be in (0, C={C}]")
    if route not in ("auto", "wide"):
        raise ValueError(f"select_window: unknown route {route!r}")
    wide = route == "wide" or select_route(C, 0, 0, 0) == "candidate_select_wide"
    cand = torch.empty((B, k), dtype=I32, device=dev)
    feas_count = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return cand, feas_count
    keys = torch.empty((B, C), dtype=I32, device=dev) if wide else None
    rc = _bind("candidate_select", "select_window_launch", _SELECT_WINDOW_ARGTYPES)(
        feasible.data_ptr(), score.data_ptr(), B, C, k, cand.data_ptr(), feas_count.data_ptr(),
        _ptr(keys), _stream(dev))
    _raise_on(rc, "select_window")
    return cand, feas_count


def candidate_merge(windows, k: int):
    """The top-k merge of a row group's shard windows (see
    candidate_merge_plain for the contract)."""
    dev = windows[0][0].device
    if dev.type == "cpu":
        return candidate_merge_plain(windows, k)
    if dev.type != "cuda":
        raise ValueError(f"candidate_merge: unsupported device {dev}")
    out = _candidate_merge_launch(windows, k)
    _launched("candidate_merge")
    return out


def _candidate_merge_launch(windows, k: int):
    """Check the windows (c of them, up to MAX_MERGE_SHARDS, on one device,
    each i32 / bool [B, K_s] and a [B] count, contiguous), allocate the
    outputs and launch candidate_merge once for the row group."""
    c = len(windows)
    if not 0 < c <= MAX_MERGE_SHARDS:
        raise ValueError(f"candidate_merge: {c} windows, expected 1..{MAX_MERGE_SHARDS}")
    dev = windows[0][0].device
    B = windows[0][0].shape[0]
    table = (_MergeShard * c)()
    W = 0
    for j, w in enumerate(windows):
        Ks = w[0].shape[1]
        for name, t, dt in zip(("cand_idx", "c_feas", "c_score", "c_avail", "c_prev", "c_tie"),
                               w[:6], (I32, BOOL, I32, I32, I32, I32)):
            _check(f"{name}[{j}]", t, dt, (B, Ks), dev)
        _check(f"feas_count[{j}]", w[6], I32, (B,), dev)
        table[j] = _MergeShard(*_ptrs(*w[:7]), Ks)
        W += Ks
    if not 0 < k <= W:
        raise ValueError(f"candidate_merge: k={k} must be in (0, {W}]")
    if W > MAX_MERGE_WIDTH:
        raise ValueError(f"candidate_merge: {W} window entries a row, past {MAX_MERGE_WIDTH}")
    out = tuple(torch.empty((B, k), dtype=dt, device=dev)
                for dt in (I32, BOOL, I32, I32, I32, I32))
    feas_count = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return out + (feas_count,)
    rc = _bind("candidate_merge", "candidate_merge_launch", _MERGE_ARGTYPES)(
        ctypes.addressof(table), c, B, k, *_ptrs(*out, feas_count), _stream(dev))
    _raise_on(rc, "candidate_merge")
    return out + (feas_count,)


def candidate_tail(
    c_feas, c_avail, c_prev, c_tie, cand_idx,
    weight_tables, weight_idx, strategy, replicas, fresh, *, topk: int, has_agg: bool,
):
    """Division tail over [rows, K] candidate windows (see tail_plain for
    the contract)."""
    args = (c_feas, c_avail, c_prev, c_tie, cand_idx, weight_tables,
            weight_idx, strategy, replicas, fresh)
    dev = c_feas.device
    if dev.type == "cpu":
        return tail_plain(*args, topk=topk, has_agg=has_agg)
    if dev.type != "cuda":
        raise ValueError(f"candidate_tail: unsupported device {dev}")
    out = _tail_launch(*args, topk=topk, has_agg=has_agg)
    _launched("candidate_tail" if c_feas.shape[1] <= MAX_TAIL_K else "candidate_tail_wide")
    return out


def _tail_launch(
    c_feas, c_avail, c_prev, c_tie, cand_idx,
    weight_tables, weight_idx, strategy, replicas, fresh, *, topk: int, has_agg: bool,
    route: str = "auto",
):
    """Check, allocate and launch candidate_tail_kernel, or for windows
    wider than MAX_TAIL_K dense_tail.cu's window mode (whose route `route`
    picks, as for `_dense_tail_launch`; candidate_tail has one route)."""
    dev = c_feas.device
    rows, K = c_feas.shape
    if route != "auto" and K <= MAX_TAIL_K:
        raise ValueError(f"candidate_tail: route {route!r} at K={K}: only windows wider "
                         f"than {MAX_TAIL_K} take dense_tail's routes")
    W, Cw = weight_tables.shape
    for name, t, dt, shape in (
        ("c_feas", c_feas, BOOL, (rows, K)), ("c_avail", c_avail, I32, (rows, K)),
        ("c_prev", c_prev, I32, (rows, K)), ("c_tie", c_tie, I32, (rows, K)),
        ("cand_idx", cand_idx, I32, (rows, K)),
        ("weight_tables", weight_tables, I64, (W, Cw)),
        ("weight_idx", weight_idx, I32, (rows,)), ("strategy", strategy, I32, (rows,)),
        ("replicas", replicas, I32, (rows,)), ("fresh", fresh, BOOL, (rows,)),
    ):
        _check(name, t, dt, shape, dev)
    if K <= 0:
        raise ValueError(f"candidate_tail: empty window K={K}")
    tw = min(K, topk)
    if tw > MAX_DENSE_TOPK:
        raise ValueError(f"candidate_tail: output window {tw} over {MAX_DENSE_TOPK}")
    # the int32 outputs in one allocation (the host's time per call is the
    # compact round's tail time: the kernel takes less)
    result, top_idx, top_val, avail_sum, nnz = torch.empty(
        rows * (K + 2 * tw + 2), dtype=I32, device=dev).split(
        [rows * K, rows * tw, rows * tw, rows, rows])
    result, top_idx, top_val = result.view(rows, K), top_idx.view(rows, tw), top_val.view(rows, tw)
    unsched = torch.empty((rows,), dtype=BOOL, device=dev)
    if rows == 0:
        return result, unsched, avail_sum, nnz, top_idx, top_val
    if K > MAX_TAIL_K:
        rc = _bind("dense_tail", "window_tail_launch", _WINDOW_TAIL_ARGTYPES)(
            c_feas.data_ptr(), c_avail.data_ptr(), c_prev.data_ptr(), c_tie.data_ptr(),
            cand_idx.data_ptr(), rows, K, weight_tables.data_ptr(), Cw, weight_idx.data_ptr(),
            strategy.data_ptr(), replicas.data_ptr(), fresh.data_ptr(), tw, has_agg,
            TAIL_ROUTES[route], result.data_ptr(), unsched.data_ptr(), avail_sum.data_ptr(),
            nnz.data_ptr(), top_idx.data_ptr(), top_val.data_ptr(), _stream(dev),
        )
    else:
        rc = _bind("candidate_tail", "candidate_tail_launch", _TAIL_ARGTYPES)(
            *_ptrs(c_feas, c_avail, c_prev, c_tie, cand_idx, weight_tables), Cw,
            *_ptrs(weight_idx, strategy, replicas, fresh), rows, K, tw, has_agg,
            *_ptrs(result, unsched, avail_sum, nnz, top_idx, top_val), _stream(dev),
        )
    _raise_on(rc, "candidate_tail")
    return result, unsched, avail_sum, nnz, top_idx, top_val


def dense_filter(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, *, plugin_bits: int, extra_mask=None,
    extra_score=None,
):
    """Dense filter + estimate over the fleet and a padded batch (see
    dense_filter_plain for the contract)."""
    args = (alive, capacity, has_summary, taint_key, taint_value, taint_effect,
            api_ok, replicas, unknown_request, gvk, tol_tables, tol_idx,
            aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
            req_unique, req_idx, extra_avail)
    kw = dict(plugin_bits=plugin_bits, extra_mask=extra_mask, extra_score=extra_score)
    dev = alive.device
    if dev.type == "cpu":
        return dense_filter_plain(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"dense_filter: unsupported device {dev}")
    out = _dense_filter_launch(*args, **kw)
    _launched("dense_filter")
    return out


def _dense_filter_launch(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, *, plugin_bits: int, extra_mask=None,
    extra_score=None,
):
    """Check, allocate (the outputs, score / avail / prev / tie as the four
    planes of one i32[4,B,C] allocation, and in one allocation the factored
    tables' scratch: the estimate per distinct request i32[U,C], the
    column-ok table per toleration table u8[Tt,C], api_ok transposed
    u8[G,C]) and launch dense_filter (dense_filter.cu: the tables, then the
    main pass). Each plane starts 16-byte aligned whenever C % 4 == 0, as
    the kernel's 16-byte stores need."""
    dev = alive.device
    C, R, T, G, B, Kt, Kp, Ke = _check_filter_args(
        alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
        replicas, unknown_request, gvk, tol_tables, tol_idx,
        aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
        req_unique, req_idx, extra_avail, extra_mask, extra_score,
    )
    U, Tt = req_unique.shape[0], tol_tables.shape[0]
    feasible = torch.empty((B, C), dtype=BOOL, device=dev)
    score, avail, prev, tie = torch.empty((4, B, C), dtype=I32, device=dev).unbind(0)
    feas_count = torch.empty((B,), dtype=I32, device=dev)
    if B == 0 or C == 0:
        return feasible, score, avail, prev, tie, feas_count.zero_()
    scratch = torch.empty((4 * U + Tt + G) * C, dtype=U8, device=dev)
    est_u = scratch.data_ptr()
    col_ok = est_u + 4 * U * C
    rc = _bind("dense_filter", "dense_filter_launch", _DENSE_FILTER_ARGTYPES)(
        *_ptrs(alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok),
        C, R, T, G,
        *_ptrs(replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx,
               prev_idx, prev_rep, evict_idx, seeds, req_unique, req_idx),
        B, Kt, Kp, Ke, U, Tt, plugin_bits, extra_avail is not None,
        *_ptrs(extra_avail, extra_mask, extra_score), est_u, col_ok, col_ok + Tt * C,
        *_ptrs(feasible, score, avail, prev, tie, feas_count),
        _stream(dev),
    )
    _raise_on(rc, "dense_filter")
    return feasible, score, avail, prev, tie, feas_count


def dense_tail(
    feasible, avail, prev, tie, rows,
    weight_tables, weight_idx, strategy, replicas, fresh, *, topk: int, has_agg: bool,
):
    """Division tail over the full filter rows `rows` (see dense_tail_plain
    for the contract)."""
    args = (feasible, avail, prev, tie, rows, weight_tables, weight_idx,
            strategy, replicas, fresh)
    dev = feasible.device
    if dev.type == "cpu":
        return dense_tail_plain(*args, topk=topk, has_agg=has_agg)
    if dev.type != "cuda":
        raise ValueError(f"dense_tail: unsupported device {dev}")
    out = _dense_tail_launch(*args, topk=topk, has_agg=has_agg)
    _launched("dense_tail")
    return out


def _dense_tail_launch(
    feasible, avail, prev, tie, rows,
    weight_tables, weight_idx, strategy, replicas, fresh, *, topk: int, has_agg: bool,
    route: str = "auto",
):
    """Check, allocate and launch the dense tail. Row ids must lie in
    [0, B): the kernel reads them as they are. `route`: "auto" stages rows
    of up to MAX_TAIL_SMEM_COLS columns in shared memory and re-reads wider
    ones; "reread" re-reads at any width (both exact). topk = 0 writes no
    output window."""
    dev = feasible.device
    B, C = feasible.shape
    n = rows.shape[0]
    W = weight_tables.shape[0]
    for name, t, dt, shape in (
        ("feasible", feasible, BOOL, (B, C)), ("avail", avail, I32, (B, C)),
        ("prev", prev, I32, (B, C)), ("tie", tie, I32, (B, C)),
        ("rows", rows, I32, (n,)), ("weight_tables", weight_tables, I64, (W, C)),
        ("weight_idx", weight_idx, I32, (B,)), ("strategy", strategy, I32, (B,)),
        ("replicas", replicas, I32, (B,)), ("fresh", fresh, BOOL, (B,)),
    ):
        _check(name, t, dt, shape, dev)
    w = min(C, topk)
    if not 0 <= w <= MAX_DENSE_TOPK or (w == 0 and topk != 0):
        raise NotImplementedError(
            f"dense_tail: output window {w} outside [0, {MAX_DENSE_TOPK}] (the "
            "window is sorted in shared memory)"
        )
    result = torch.empty((n, C), dtype=I32, device=dev)
    unsched = torch.empty((n,), dtype=BOOL, device=dev)
    avail_sum = torch.empty((n,), dtype=I32, device=dev)
    nnz = torch.empty((n,), dtype=I32, device=dev)
    top_idx = torch.empty((n, w), dtype=I32, device=dev)
    top_val = torch.empty((n, w), dtype=I32, device=dev)
    if n == 0:
        return result, unsched, avail_sum, nnz, top_idx, top_val
    rc = _bind("dense_tail", "dense_tail_launch", _DENSE_TAIL_ARGTYPES)(
        feasible.data_ptr(), avail.data_ptr(), prev.data_ptr(), tie.data_ptr(), C,
        rows.data_ptr(), n, weight_tables.data_ptr(), weight_idx.data_ptr(),
        strategy.data_ptr(), replicas.data_ptr(), fresh.data_ptr(), w, has_agg,
        TAIL_ROUTES[route], result.data_ptr(), unsched.data_ptr(), avail_sum.data_ptr(),
        nnz.data_ptr(), top_idx.data_ptr(), top_val.data_ptr(), _stream(dev),
    )
    _raise_on(rc, "dense_tail")
    return result, unsched, avail_sum, nnz, top_idx, top_val


def pack_rows(feasible, rows):
    """The filter outputs' rows `rows` bit-packed (see pack_rows_plain)."""
    dev = feasible.device
    if dev.type == "cpu":
        return pack_rows_plain(feasible, rows)
    if dev.type != "cuda":
        raise ValueError(f"pack_rows: unsupported device {dev}")
    out = _pack_rows_launch(feasible, rows)
    _launched("pack_rows")
    return out


def _check_mask_rows(feasible, rows):
    """Check the mask kernels' inputs: the filter outputs bool[B, C] and
    int32 row ids [n] on their device; returns (B, C, n)."""
    dev = feasible.device
    B, C = feasible.shape
    n = rows.numel()
    _check("feasible", feasible, BOOL, (B, C), dev)
    _check("rows", rows, I32, (n,), dev)
    return B, C, n


def _pack_rows_launch(feasible, rows):
    """Check, allocate and launch pack_kernel without the region test: one
    launch over the filter outputs, read in place. Row ids must lie in
    [0, B): the kernel reads them as they are."""
    dev = feasible.device
    _B, C, n = _check_mask_rows(feasible, rows)
    out = torch.empty((n, (C + 7) // 8), dtype=U8, device=dev)
    if n == 0 or C == 0:
        return out
    rc = _bind("dense_mask", "pack_rows_launch", _PACK_ROWS_ARGTYPES)(
        feasible.data_ptr(), C, rows.data_ptr(), n, out.data_ptr(), _stream(dev))
    _raise_on(rc, "pack_rows")
    return out


def feas_idx(feasible, rows, k: int):
    """The first k feasible column ids of the filter outputs' rows `rows`
    (see feas_idx_plain)."""
    dev = feasible.device
    if dev.type == "cpu":
        return feas_idx_plain(feasible, rows, k)
    if dev.type != "cuda":
        raise ValueError(f"feas_idx: unsupported device {dev}")
    out = _feas_idx_launch(feasible, rows, k)
    _launched("feas_idx")
    return out


def _feas_idx_launch(feasible, rows, k: int):
    """Check, allocate and launch feas_idx_kernel: one launch over the
    filter outputs, read in place. Row ids must lie in [0, B)."""
    dev = feasible.device
    _B, C, n = _check_mask_rows(feasible, rows)
    if not 0 < k <= C:
        raise ValueError(f"feas_idx: k={k} must be in (0, C={C}]")
    out = torch.empty((n, k), dtype=I32, device=dev)
    if n == 0:
        return out
    rc = _bind("dense_mask", "feas_idx_launch", _FEAS_IDX_ARGTYPES)(
        feasible.data_ptr(), C, rows.data_ptr(), n, k, out.data_ptr(), _stream(dev))
    _raise_on(rc, "feas_idx")
    return out


def group_score(
    feasible, score, avail, prev, rows, replicas, need, target, duplicated,
    perm, seg_start, seg_end, rank_p,
):
    """Every (row, region) group score over the filter outputs' rows `rows`
    (see group_score_plain for the contract)."""
    args = (feasible, score, avail, prev, rows, replicas, need, target, duplicated,
            perm, seg_start, seg_end, rank_p)
    dev = feasible.device
    if dev.type == "cpu":
        return group_score_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"group_score: unsupported device {dev}")
    out = _group_score_launch(*args)
    _launched("group_score")
    return out


def _group_score_launch(
    feasible, score, avail, prev, rows, replicas, need, target, duplicated,
    perm, seg_start, seg_end, rank_p, *, route: str = "auto",
):
    """Check, allocate and launch group_score_kernel. Row ids must lie in
    [0, B) and the layout's columns in [0, C). `route`: "auto" stages
    regions of up to MAX_GROUP_STAGE columns in shared memory and re-reads
    wider ones; "reread" re-reads every region (both exact)."""
    dev = feasible.device
    B, C = feasible.shape
    S, R, Cp = rows.shape[0], seg_start.shape[0], perm.shape[0]
    for name, t, dt, shape in (
        ("feasible", feasible, BOOL, (B, C)), ("score", score, I32, (B, C)),
        ("avail", avail, I32, (B, C)), ("prev", prev, I32, (B, C)),
        ("rows", rows, I32, (S,)), ("replicas", replicas, I64, (S,)),
        ("need", need, I64, (S,)), ("target", target, I64, (S,)),
        ("duplicated", duplicated, BOOL, (S,)), ("perm", perm, I32, (Cp,)),
        ("seg_start", seg_start, I32, (R,)), ("seg_end", seg_end, I32, (R,)),
        ("rank_p", rank_p, I32, (Cp,)),
    ):
        _check(name, t, dt, shape, dev)
    if S == 0 or C == 0:
        return (torch.zeros((S, R), dtype=I64, device=dev),
                torch.zeros((S, R), dtype=I32, device=dev),
                torch.zeros((S, R), dtype=I64, device=dev), torch.zeros((S,), dtype=I32, device=dev))
    # every output element is written by the kernel
    weight = torch.empty((S, R), dtype=I64, device=dev)
    value = torch.empty((S, R), dtype=I32, device=dev)
    avail_sum = torch.empty((S, R), dtype=I64, device=dev)
    feas_count = torch.empty((S,), dtype=I32, device=dev)
    rc = _bind("group_score", "group_score_launch", _GROUP_SCORE_ARGTYPES)(
        *_ptrs(feasible, score, avail, prev), C, rows.data_ptr(), S,
        *_ptrs(replicas, need, target, duplicated, perm, seg_start, seg_end, rank_p), R, Cp,
        TAIL_ROUTES[route], *_ptrs(weight, value, avail_sum, feas_count), _stream(dev),
    )
    _raise_on(rc, "group_score")
    return weight, value, avail_sum, feas_count


def _chosen_table(chosen):
    """bool[n, R] -> the spread tail's u8[n, R + 1] table, column 0
    (regionless) False."""
    n = chosen.shape[0]
    return torch.cat([torch.zeros((n, 1), dtype=U8, device=chosen.device),
                      chosen.to(U8)], dim=1).contiguous()


def _check_selection(feasible, rows, chosen, rid):
    dev = feasible.device
    B, C = feasible.shape
    n, R = rows.shape[0], chosen.shape[1]
    for name, t, dt, shape in (
        ("feasible", feasible, BOOL, (B, C)), ("rows", rows, I32, (n,)),
        ("chosen", chosen, BOOL, (n, R)), ("rid", rid, I32, (C,)),
    ):
        _check(name, t, dt, shape, dev)
    return B, C, n, R


def packed_selection(feasible, rows, chosen, rid):
    """Bit-packed selection masks of the filter outputs' rows `rows` (see
    packed_selection_plain)."""
    dev = feasible.device
    if dev.type == "cpu":
        return packed_selection_plain(feasible, rows, chosen, rid)
    if dev.type != "cuda":
        raise ValueError(f"packed_selection: unsupported device {dev}")
    out = _packed_selection_launch(feasible, rows, chosen, rid)
    _launched("packed_selection")
    return out


def _packed_selection_launch(feasible, rows, chosen, rid):
    """Check, allocate and launch packed_selection_kernel: one launch, the
    caller's bool `chosen` read as it is."""
    dev = feasible.device
    _B, C, n, R = _check_selection(feasible, rows, chosen, rid)
    out = torch.empty((n, (C + 7) // 8), dtype=U8, device=dev)
    if n == 0 or C == 0:
        return out
    rc = _bind("dense_mask", "packed_selection_launch", _PACKED_SELECTION_ARGTYPES)(
        feasible.data_ptr(), C, rows.data_ptr(), n, chosen.data_ptr(), R, rid.data_ptr(),
        out.data_ptr(), _stream(dev))
    _raise_on(rc, "packed_selection")
    return out


def spread_tail(
    feasible, avail, prev, tie, rows, chosen, rid, strategy, replicas, fresh, *,
    topk: int, has_agg: bool,
):
    """Division tail over each row's selection (see spread_tail_plain)."""
    args = (feasible, avail, prev, tie, rows, chosen, rid, strategy, replicas, fresh)
    dev = feasible.device
    if dev.type == "cpu":
        return spread_tail_plain(*args, topk=topk, has_agg=has_agg)
    if dev.type != "cuda":
        raise ValueError(f"spread_tail: unsupported device {dev}")
    out = _spread_tail_launch(*args, topk=topk, has_agg=has_agg)
    _launched("spread_tail")
    return out


def _spread_tail_launch(
    feasible, avail, prev, tie, rows, chosen, rid, strategy, replicas, fresh, *,
    topk: int, has_agg: bool, route: str = "auto",
):
    """Check, allocate and launch the restricted dense tail (`route` as for
    `_dense_tail_launch`)."""
    dev = feasible.device
    B, C, n, R = _check_selection(feasible, rows, chosen, rid)
    for name, t, dt, shape in (
        ("avail", avail, I32, (B, C)), ("prev", prev, I32, (B, C)),
        ("tie", tie, I32, (B, C)), ("strategy", strategy, I32, (B,)),
        ("replicas", replicas, I32, (B,)), ("fresh", fresh, BOOL, (B,)),
    ):
        _check(name, t, dt, shape, dev)
    w = min(C, topk)
    if not 0 < w <= MAX_DENSE_TOPK:
        raise NotImplementedError(
            f"spread_tail: output window {w} outside (0, {MAX_DENSE_TOPK}] (the "
            "window is sorted in shared memory)"
        )
    result = torch.empty((n, C), dtype=I32, device=dev)
    unsched = torch.empty((n,), dtype=BOOL, device=dev)
    avail_sum = torch.empty((n,), dtype=I32, device=dev)
    feas_count = torch.empty((n,), dtype=I32, device=dev)
    nnz = torch.empty((n,), dtype=I32, device=dev)
    top_idx = torch.empty((n, w), dtype=I32, device=dev)
    top_val = torch.empty((n, w), dtype=I32, device=dev)
    if n == 0:
        return result, unsched, avail_sum, feas_count, nnz, top_idx, top_val
    table = _chosen_table(chosen)
    rc = _bind("dense_tail", "spread_tail_launch", _SPREAD_TAIL_ARGTYPES)(
        feasible.data_ptr(), avail.data_ptr(), prev.data_ptr(), tie.data_ptr(), C,
        rows.data_ptr(), n, table.data_ptr(), R + 1, rid.data_ptr(), strategy.data_ptr(),
        replicas.data_ptr(), fresh.data_ptr(), w, has_agg, TAIL_ROUTES[route],
        result.data_ptr(), unsched.data_ptr(), avail_sum.data_ptr(), feas_count.data_ptr(),
        nnz.data_ptr(), top_idx.data_ptr(), top_val.data_ptr(), _stream(dev),
    )
    _raise_on(rc, "spread_tail")
    return result, unsched, avail_sum, feas_count, nnz, top_idx, top_val


def combo_select(weight, value, kmax_row, rname, members_pad, sizes, *, cmin: int, kmin: int):
    """The winning region combination per row (see combo_select_plain)."""
    args = (weight, value, kmax_row, rname, members_pad, sizes)
    dev = weight.device
    if dev.type == "cpu":
        return combo_select_plain(*args, cmin=cmin, kmin=kmin)
    if dev.type != "cuda":
        raise ValueError(f"combo_select: unsupported device {dev}")
    out = _combo_select_launch(*args, cmin=cmin, kmin=kmin)
    _launched("combo_select")
    return out


def _combo_outputs(block):
    """(first_idx i32[S], n_ties i32[S], none_feasible bool[S]): views of
    one int32 [3, S] block; none_feasible reads the low byte of each 0 / 1
    in the block's last row."""
    return block[0], block[1], block[2].view(BOOL)[::4]


def _combo_select_launch(weight, value, kmax_row, rname, members_pad, sizes, *,
                         cmin: int, kmin: int):
    """Check, allocate and launch combo_select_kernel: one launch writes the
    three outputs, views of one fresh int32 [3, S] block (`fetch_views`
    brings them to the host in one copy). Members must lie in [-1, R).
    Past MAX_COMBO_SMEM_REGIONS regions the kernel reads them in place and
    writes their group-order positions to an int32 [S, R] scratch."""
    dev = weight.device
    S, R = weight.shape
    K, L = members_pad.shape
    for name, t, dt, shape in (
        ("weight", weight, I64, (S, R)), ("value", value, I32, (S, R)),
        ("kmax_row", kmax_row, I32, (S,)), ("rname", rname, I32, (R,)),
        ("members_pad", members_pad, I32, (K, L)), ("sizes", sizes, I32, (K,)),
    ):
        _check(name, t, dt, shape, dev)
    if R == 0:
        raise ValueError("combo_select: no region")
    if S == 0 or K == 0:
        return _combo_outputs(torch.zeros((3, S), dtype=I32, device=dev))
    block = torch.empty((3, S), dtype=I32, device=dev)
    pos = (torch.empty((S, R), dtype=I32, device=dev) if R > MAX_COMBO_SMEM_REGIONS
           else None)
    rc = _bind("combo_select", "combo_select_launch", _COMBO_SELECT_ARGTYPES)(
        *_ptrs(weight, value, kmax_row, rname), S, R, members_pad.data_ptr(), sizes.data_ptr(),
        K, L, cmin, kmin, *_ptrs(block, pos), _stream(dev),
    )
    _raise_on(rc, "combo_select")
    return _combo_outputs(block)


def tier_estimate(capacity, has_summary, req_unique, req_idx, replicas, unknown_request, rows,
                  *, out=None, cand_idx=None, extra_avail=None):
    """The estimate over a tier's rows at `capacity` (see
    tier_estimate_plain): rows mode writes `out` in place, window mode
    returns a new [n, K]."""
    if (out is None) == (cand_idx is None):
        raise ValueError("tier_estimate: pass exactly one of out (rows mode) and cand_idx")
    args = (capacity, has_summary, req_unique, req_idx, replicas, unknown_request, rows)
    kw = {"out": out, "cand_idx": cand_idx, "extra_avail": extra_avail}
    dev = capacity.device
    if dev.type == "cpu":
        return tier_estimate_plain(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"tier_estimate: unsupported device {dev}")
    res = _tier_estimate_launch(*args, **kw)
    _launched("tier_estimate")
    return res


def _tier_estimate_launch(capacity, has_summary, req_unique, req_idx, replicas,
                          unknown_request, rows, *, out=None, cand_idx=None, extra_avail=None,
                          route: str = "auto"):
    """Check, allocate and launch the tier-estimate kernel of its mode
    through a one-call TierLauncher. Row ids must lie in [0, B) and
    candidate columns in [0, C). `route` (rows mode): "table" builds the
    estimate per distinct request first, "element" evaluates every
    element, "auto" picks (`estimate_route`)."""
    launcher = TierLauncher(has_summary, req_unique, req_idx, replicas, unknown_request,
                            extra_avail=extra_avail)
    dev, n = launcher.device, rows.shape[0]
    _check("capacity", capacity, I64, (launcher.C, launcher.R), dev)
    _check("rows", rows, I32, (n,), dev)
    if cand_idx is None:
        launcher.rows_mode(out)
    else:
        launcher.window_mode(cand_idx)
        out = torch.empty((n, launcher.K), dtype=I32, device=dev)
    return launcher.launch_estimate(capacity, rows, out=out, route=route)


def estimate_route(U: int, n: int, route: str = "auto") -> str:
    """The rows-mode estimate's route for n tier rows over U distinct
    requests: the table of U x C entries while it is at most half the
    tier's n x C elements, else every element ("table" / "element" force
    one)."""
    if route not in ("auto", "table", "element"):
        raise ValueError(f"tier_estimate: unknown route {route!r}")
    if route == "auto":
        return "table" if 2 * U <= n else "element"
    return route


def tier_consume(cap, placed, unsched, request, rows, *, cand_idx=None):
    """The capacity a tier leaves to the next (see tier_consume_plain)."""
    args = (cap, placed, unsched, request, rows)
    dev = cap.device
    if dev.type == "cpu":
        return tier_consume_plain(*args, cand_idx=cand_idx)
    if dev.type != "cuda":
        raise ValueError(f"tier_consume: unsupported device {dev}")
    out = _tier_consume_launch(*args, cand_idx=cand_idx)
    _launched("tier_consume" if cand_idx is None else "tier_consume_window",
              _resource_blocks(request.shape[1], TIER_RESOURCE_BLOCK))
    return out


_bound = {}
_bind_lock = threading.Lock()


def _bind(lib: str, entry: str, argtypes):
    """The C entry point `entry` of kernel library `lib`, its ctypes
    prototype set once, at its first call (under a lock: the sharded
    plane's leaders launch from several threads)."""
    fn = _bound.get(entry)
    if fn is None:
        from .build import library

        handle = library(lib)
        with _bind_lock:
            fn = _bound.get(entry)
            if fn is None:
                fn = getattr(handle, entry)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
                _bound[entry] = fn
    return fn


# the C prototypes, one list per entry point (pointers, int and 64-bit
# arguments in the entry's order)
_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FILTER_HEAD = [_VP] * 7 + [_CI] * 4 + [_VP] * 13
_SELECT_ARGTYPES = _FILTER_HEAD + [_CI] * 7 + [_VP] * 11 + [_CI] + [_CL] * 4 + [_VP] * 2
_MERGE_ARGTYPES = [_VP, _CI, _CI, _CI] + [_VP] * 8
_SELECT_WINDOW_ARGTYPES = [_VP, _VP, _CI, _CI, _CI, _VP, _VP, _VP, _VP]
_TAIL_ARGTYPES = [_VP] * 6 + [_CI] + [_VP] * 4 + [_CI] * 4 + [_VP] * 7
_DENSE_FILTER_ARGTYPES = _FILTER_HEAD + [_CI] * 8 + [_VP] * 13
_PACK_ROWS_ARGTYPES = [_VP, _CI, _VP, _CI, _VP, _VP]
_FEAS_IDX_ARGTYPES = [_VP, _CI, _VP, _CI, _CI, _VP, _VP]
_GROUP_SCORE_ARGTYPES = [_VP] * 4 + [_CI, _VP, _CI] + [_VP] * 8 + [_CI] * 3 + [_VP] * 5
_PACKED_SELECTION_ARGTYPES = [_VP, _CI, _VP, _CI, _VP, _CI, _VP, _VP, _VP]
_COMBO_SELECT_ARGTYPES = [_VP] * 4 + [_CI] * 2 + [_VP] * 2 + [_CI] * 4 + [_VP] * 3
_TIER_ROUND_ARGTYPES = [_VP] * 4 + [_CI] * 3 + [_VP] * 2
_CONSUME_ROUND_ARGTYPES = [_VP] * 5 + [_CI, _VP]
_STALENESS_ARGTYPES = [_VP, ctypes.c_int64, _CI, _VP, _VP]
_SCATTER_ROWS_ARGTYPES = [_VP, _VP, _CI, _VP]
_SIM_FILTER_ARGTYPES = [_VP] * 7 + [_CI] * 5 + [_VP] * 14 + [_CI] * 8 + [_VP] * 10
_DENSE_INPUT_FILTER_ARGTYPES = ([_VP] * 7 + [_CI] * 4 + [_VP] * 8 + [_CI] + [_VP] * 4
                                + [_CI] * 2 + [_VP] * 4)
_MESH_TILE_FILTER_ARGTYPES = _FILTER_HEAD + [_CI] * 8 + [_VP, _CL] * 3 + [_VP] * 10
_DENSE_TAIL_ARGTYPES = [_VP] * 4 + [_CI, _VP, _CI] + [_VP] * 5 + [_CI] * 3 + [_VP] * 7
_SPREAD_TAIL_ARGTYPES = ([_VP] * 4 + [_CI, _VP, _CI, _VP, _CI] + [_VP] * 4 + [_CI] * 3
                         + [_VP] * 8)
_WINDOW_TAIL_ARGTYPES = ([_VP] * 5 + [_CI] * 2 + [_VP, _CI] + [_VP] * 4 + [_CI] * 3
                         + [_VP] * 7)
_FLEET_ESTIMATE_ARGTYPES = [_VP] * 7 + [_CI, _CI, _VP, _CI, _VP, _CI] + [_VP] * 3
_SIM_LOAD_ARGTYPES = [_VP] * 3 + [_CI] * 4 + [_VP] * 3


def _tier_consume_launch(cap, placed, unsched, request, rows, *, cand_idx=None):
    """Check the call's tensors and launch the tier-consume kernel of its
    mode through a one-call _TierConsume (the path a round's launcher
    takes). Row ids must lie in [0, B) and candidate columns in [0, C)."""
    dev = cap.device
    C, R = cap.shape
    n = placed.shape[0]
    B = request.shape[0]
    _check("cap", cap, I64, (C, R), dev)
    _check("unsched", unsched, BOOL, (n,), dev)
    _check("request", request, I64, (B, R), dev)
    _check("rows", rows, I32, (n,), dev)
    if cand_idx is not None:
        _check("cand_idx", cand_idx, I32, (B, cand_idx.shape[1]), dev)
        _check("placed", placed, I32, (n, cand_idx.shape[1]), dev)
    else:
        _check("placed", placed, I32, (n, C), dev)
    return _TierConsume(request, C, cand_idx)(cap, placed, unsched, rows)


class _MergeShard(ctypes.Structure):
    """candidate_merge.cu's MergeShard: one shard window's seven device
    pointers and its width."""
    _fields_ = [(name, _VP) for name in (
        "cand_idx", "c_feas", "c_score", "c_avail", "c_prev", "c_tie", "feas_count")] + [
        ("K", _CI)]


class _TierRound(ctypes.Structure):
    """tiers.cu's TierRound: one round's constant pointers and sizes."""
    _fields_ = [(name, _VP) for name in (
        "has_summary", "req_unique", "req_idx", "replicas", "unknown_request", "extra_avail",
        "cand_idx", "est_u", "request", "scratch")] + [
        ("scratch_bytes", _CL), ("stream", _VP)] + [(name, _CI) for name in "BCRUK"]


class _BumpOutputs:
    """Outputs of one shape cut in turn from a block of `depth` of them,
    none handed out twice: a used-up block is followed by a new one (the
    tensors cut from the old one keep it alive). One block serves a
    round's tiers, whose rows partition the batch, for one allocation."""

    def __init__(self, depth: int, shape: tuple, dtype, device):
        self._depth, self._shape, self._dtype, self._device = depth, shape, dtype, device
        self._block, self._off = None, depth

    def take(self, n: int | None = None):
        """The next n outputs as one [n, *shape] tensor, or with None the
        next output alone."""
        k = 1 if n is None else n
        if self._off + k > self._depth:
            self._block = torch.empty((max(self._depth, k),) + self._shape, dtype=self._dtype,
                                      device=self._device)
            self._off = 0
        i = self._off
        self._off += k
        return self._block[i] if n is None else self._block[i:i + k]


class _TierConsume:
    """tier_consume on the card over one request table (i64 [B, R]): the
    request in blocks of TIER_RESOURCE_BLOCK resources (each resource's
    sum and clamp is independent of the others, so a request past the
    kernel's register budget runs as contiguous slices of it), one
    TierRound a block, one scratch for all; `window(cand_idx)` scatters
    through the rows' candidate windows (i32 [B, K], checked by the
    caller) or, with None, reads dense placements. A call takes the tier's
    capacity, placements, flags and rows and writes a [C, R] capacity,
    `out` or a new one: one C call (tier_consume_round) a block."""

    def __init__(self, request, C: int, cand_idx=None):
        dev = request.device
        B, R = request.shape
        _check("request", request, I64, (B, R), dev)
        if R == 0:
            raise ValueError("tier_consume: a request with no resource")
        self.device, self.C, self.R = dev, C, R
        self._fn = _bind("tiers", "tier_consume_round", _CONSUME_ROUND_ARGTYPES)
        self._scratch = torch.empty((C, min(R, TIER_RESOURCE_BLOCK) + 1), dtype=I64, device=dev)
        stream = _stream(dev)
        self._blocks = []
        for r0 in range(0, R, TIER_RESOURCE_BLOCK):
            r1 = min(R, r0 + TIER_RESOURCE_BLOCK)
            req_b = request if r1 - r0 == R else request[:, r0:r1].contiguous()
            rnd = _TierRound(request=req_b.data_ptr(), scratch=self._scratch.data_ptr(),
                             scratch_bytes=self._scratch.numel() * 8, stream=stream, B=B, C=C,
                             R=r1 - r0)
            self._blocks.append((r0, r1, req_b, rnd, ctypes.byref(rnd)))
        self.window(cand_idx)

    def window(self, cand_idx) -> None:
        ptr, K = (None, 0) if cand_idx is None else (cand_idx.data_ptr(), cand_idx.shape[1])
        for *_, rnd, _ref in self._blocks:
            rnd.cand_idx, rnd.K = ptr, K

    def __call__(self, cap, placed, unsched, rows, out=None):
        n = placed.shape[0]
        if out is None:
            out = torch.empty((self.C, self.R), dtype=I64, device=self.device)
        if self.C == 0:
            return out
        for r0, r1, _req, _rnd, ref in self._blocks:
            whole = r1 - r0 == self.R
            cap_b = cap if whole else cap[:, r0:r1].contiguous()
            out_b = out if whole else torch.empty((self.C, r1 - r0), dtype=I64, device=self.device)
            rc = self._fn(ref, cap_b.data_ptr(), placed.data_ptr(), unsched.data_ptr(),
                          rows.data_ptr(), n, out_b.data_ptr())
            _raise_on(rc, "tier_consume")
            if not whole:
                out[:, r0:r1] = out_b
        return out


class TierLauncher:
    """One tiered round's `tier_estimate` and `tier_consume` launches on the
    card, with the host work done once a round. The constructor checks the
    round's constant tensors (the batch's request table and row columns,
    its answers, the requests the consumption reads) and keeps them, their
    device pointers in a `TierRound` the C entries read, the bound entries
    and the stream; `rows_mode(avail)` or `window_mode(cand_idx)` sets the
    mode and its tensor, checked once. Per tier a call passes only the
    capacity, the tier's rows and, in rows mode, the output: `estimate`
    (one C call: tier_estimate_round), in window mode `estimate_pair` (a
    tier's main and speculative passes in one C call) and `consume` (one
    C call a block of TIER_RESOURCE_BLOCK resources: _TierConsume), each
    adding to its kernel's launch count; the `launch_*` methods launch
    without counting (comparisons with the plain versions). Window
    estimates and consumed capacities are cut in turn from blocks the
    launcher allocates (`_BumpOutputs`), each handed out once, so a
    round allocates them once and no output is ever overwritten. The
    per-call tensors are the caller's: i64 [C, R] capacities, i32 row ids
    in [0, B), and the tail's placements and flags, on the round's
    device, contiguous (the public wrappers check each call; this path
    does not). For CPU tensors use `tier_launcher`, which runs the plain
    versions."""

    def __init__(self, has_summary, req_unique, req_idx, replicas, unknown_request, *,
                 request=None, extra_avail=None):
        dev = has_summary.device
        C = has_summary.shape[0]
        U, R = req_unique.shape
        B = req_idx.shape[0]
        for name, t, dt, shape in (
            ("has_summary", has_summary, BOOL, (C,)), ("req_unique", req_unique, I64, (U, R)),
            ("req_idx", req_idx, I32, (B,)), ("replicas", replicas, I32, (B,)),
            ("unknown_request", unknown_request, BOOL, (B,)),
        ):
            _check(name, t, dt, shape, dev)
        if extra_avail is not None:
            _check("extra_avail", extra_avail, I32, (B, C), dev)
        if request is not None:
            _check("request", request, I64, (B, R), dev)
        self.device, self.B, self.C, self.R, self.U, self.K = dev, B, C, R, U, 0
        self.has_summary, self.req_unique, self.req_idx = has_summary, req_unique, req_idx
        self.replicas, self.unknown_request = replicas, unknown_request
        self.extra_avail, self.request = extra_avail, request
        self.avail = self.cand_idx = self._est_u = None
        self._round = _TierRound(*_ptrs(has_summary, req_unique, req_idx, replicas,
                                        unknown_request, extra_avail), None, None, None, None,
                                 0, _stream(dev), B, C, R, U, 0)
        self._ref = ctypes.byref(self._round)
        self._estimate = _bind("tiers", "tier_estimate_round", _TIER_ROUND_ARGTYPES)
        self._consume = self._caps = self._windows = None
        if request is not None:
            self._consume = _TierConsume(request, C)
            self._caps = _BumpOutputs(TIER_CAP_BLOCK, (C, R), I64, dev)

    def rows_mode(self, avail) -> "TierLauncher":
        """Estimates into the i32 [B, C] avail buffer, in place; dense
        consumption."""
        _check("avail", avail, I32, (self.B, self.C), self.device)
        self.avail = avail
        self._window(None)
        return self

    def window_mode(self, cand_idx) -> "TierLauncher":
        """Estimates at the rows' candidate windows (i32 [B, K]);
        consumption scattered through them."""
        _check("cand_idx", cand_idx, I32, (self.B, cand_idx.shape[1]), self.device)
        self.avail = None
        self._window(cand_idx)
        return self

    def _window(self, cand_idx) -> None:
        self.cand_idx, self.K = cand_idx, 0 if cand_idx is None else cand_idx.shape[1]
        self._round.cand_idx = None if cand_idx is None else cand_idx.data_ptr()
        self._round.K = self.K
        # a round's main and speculative windows: at most 2B rows
        self._windows = None if cand_idx is None else _BumpOutputs(2 * self.B, (self.K,), I32,
                                                                  self.device)
        if self._consume is not None:
            self._consume.window(cand_idx)

    def launch_estimate(self, cap, rows, *, use_extra: bool = True, out=None,
                        route: str = "auto"):
        """The estimate at `cap` over the tier's `rows`, the answers
        min-merged when `use_extra`: rows mode writes `out` (the avail
        buffer by default) in place and returns it; window mode writes
        `out` or else the next [n, K] of the launcher's block. Not
        counted."""
        n = rows.shape[0]
        table = 0
        if self.cand_idx is None:
            res = self.avail if out is None else out
            if estimate_route(self.U, n, route) == "table":
                table = 1
                if self._est_u is None:  # scratch the call's two kernels share
                    self._est_u = torch.empty((self.U, self.C), dtype=I32, device=self.device)
                    self._round.est_u = self._est_u.data_ptr()
        else:
            res = self._windows.take(n) if out is None else out
        if n == 0 or self.C == 0 or (self.cand_idx is not None and self.K == 0):
            return res
        rc = self._estimate(self._ref, cap.data_ptr(), None, rows.data_ptr(), n, use_extra,
                            table, res.data_ptr(), None)
        _raise_on(rc, "tier_estimate")
        return res

    def launch_estimate_pair(self, cap, reclaim, rows, *, use_extra: bool = True, out=None):
        """Window mode: a tier's main pass at `cap` (the answers
        min-merged when `use_extra`) and its speculative pass at `cap +
        reclaim` (i64 [C, R], no answers) in one launch; returns both, the
        pair `out` or the next two [n, K] of the launcher's block. Not
        counted."""
        n = rows.shape[0]
        main, spec = (self._windows.take(n), self._windows.take(n)) if out is None else out
        if n == 0 or self.C == 0 or self.K == 0:
            return main, spec
        rc = self._estimate(self._ref, cap.data_ptr(), reclaim.data_ptr(), rows.data_ptr(), n,
                            use_extra, 0, main.data_ptr(), spec.data_ptr())
        _raise_on(rc, "tier_estimate")
        return main, spec

    def estimate(self, cap, rows, *, use_extra: bool = True, out=None):
        res = self.launch_estimate(cap, rows, use_extra=use_extra, out=out)
        _launched("tier_estimate")
        return res

    def estimate_pair(self, cap, reclaim, rows, *, use_extra: bool = True):
        res = self.launch_estimate_pair(cap, reclaim, rows, use_extra=use_extra)
        _launched("tier_estimate")
        return res

    def launch_consume(self, cap, placed, unsched, rows, *, out=None):
        """The capacity the tier leaves: max(cap - placed.T @ request, 0)
        over its committed rows, an i64 [C, R], `out` or the next of the
        launcher's block. Not counted."""
        if self._consume is None:
            raise ValueError("tier_consume: the launcher was built without a request")
        return self._consume(cap, placed, unsched, rows,
                             out=self._caps.take() if out is None else out)

    def consume(self, cap, placed, unsched, rows):
        out = self.launch_consume(cap, placed, unsched, rows)
        _launched("tier_consume" if self.cand_idx is None else "tier_consume_window",
                  _resource_blocks(self.R, TIER_RESOURCE_BLOCK))
        return out


class _PlainTiers:
    """The CPU round's launcher: TierLauncher's per-round methods over the
    public wrappers `tier_estimate` / `tier_consume`, which run the plain
    versions for CPU tensors."""

    def __init__(self, has_summary, req_unique, req_idx, replicas, unknown_request, *,
                 request=None, extra_avail=None):
        self.has_summary, self.req_unique, self.req_idx = has_summary, req_unique, req_idx
        self.replicas, self.unknown_request = replicas, unknown_request
        self.extra_avail, self.request = extra_avail, request
        self.avail = self.cand_idx = None

    def rows_mode(self, avail) -> "_PlainTiers":
        self.avail, self.cand_idx = avail, None
        return self

    def window_mode(self, cand_idx) -> "_PlainTiers":
        self.avail, self.cand_idx = None, cand_idx
        return self

    def estimate(self, cap, rows, *, use_extra: bool = True, out=None):
        return tier_estimate(
            cap, self.has_summary, self.req_unique, self.req_idx, self.replicas,
            self.unknown_request, rows, cand_idx=self.cand_idx,
            out=None if self.cand_idx is not None else (self.avail if out is None else out),
            extra_avail=self.extra_avail if use_extra else None)

    def estimate_pair(self, cap, reclaim, rows, *, use_extra: bool = True):
        return (self.estimate(cap, rows, use_extra=use_extra),
                self.estimate(cap + reclaim, rows, use_extra=False))

    def consume(self, cap, placed, unsched, rows):
        return tier_consume(cap, placed, unsched, self.request, rows, cand_idx=self.cand_idx)


def tier_launcher(has_summary, req_unique, req_idx, replicas, unknown_request, *, request=None,
                  extra_avail=None):
    """A tiered round's launcher (see TierLauncher): the card's for CUDA
    tensors, the plain versions' (same methods) for CPU tensors."""
    args = (has_summary, req_unique, req_idx, replicas, unknown_request)
    kw = {"request": request, "extra_avail": extra_avail}
    dev = has_summary.device
    if dev.type == "cpu":
        return _PlainTiers(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"tier_launcher: unsupported device {dev}")
    return TierLauncher(*args, **kw)


def fleet_estimate(alloc, requested, pod_count, allowed_pods, cluster_id, n_clusters,
                   claimless_ok, request, *, req_idx=None, node_off=None):
    """The fleet-wide estimator sweep (see fleet_estimate_plain). `req_idx`
    (i32[B]) makes `request` a table of distinct requests, each evaluated
    once on the card. `node_off` (i32[n_clusters + 1]), each cluster's node
    range, may be given when the nodes lie in cluster order (cluster_id
    non-decreasing); the card then reads them in place instead of sorting
    cluster_id. The CPU path ignores it."""
    args = (alloc, requested, pod_count, allowed_pods, cluster_id, n_clusters, claimless_ok,
            request)
    dev = alloc.device
    if dev.type == "cpu":
        return fleet_estimate_plain(*args, req_idx=req_idx)
    if dev.type != "cuda":
        raise ValueError(f"fleet_estimate: unsupported device {dev}")
    out = _fleet_estimate_launch(*args, req_idx=req_idx, node_off=node_off)
    _launched("fleet_estimate")
    return out


def _fleet_estimate_launch(alloc, requested, pod_count, allowed_pods, cluster_id, n_clusters,
                           claimless_ok, request, *, req_idx=None, node_off=None):
    """Check, allocate and launch the fleet sweep (csrc/fleet_estimate.cu:
    the sweep over distinct requests, then, with `req_idx`, the gather of
    the rows). Without `node_off` the kernel walks each cluster's nodes
    through a stable sort of `cluster_id` and the ranges found in it, built
    here, so the nodes may lie in any order, as they may for the plain
    version; with it they are read in place."""
    dev = alloc.device
    N, R = alloc.shape
    C = int(n_clusters)
    U = request.shape[0]
    B = U if req_idx is None else req_idx.shape[0]
    for name, t, dt, shape in (
        ("alloc", alloc, I64, (N, R)), ("requested", requested, I64, (N, R)),
        ("pod_count", pod_count, I64, (N,)), ("allowed_pods", allowed_pods, I64, (N,)),
        ("cluster_id", cluster_id, I32, (N,)),
        ("claimless_ok", claimless_ok, BOOL, (N,)), ("request", request, I64, (U, R)),
    ):
        _check(name, t, dt, shape, dev)
    if req_idx is not None:
        _check("req_idx", req_idx, I32, (B,), dev)
    if R == 0:
        raise ValueError("fleet_estimate: a request with no resource")
    out = torch.empty((B, C), dtype=I32, device=dev)
    if B == 0 or C == 0:
        return out
    order = None
    if node_off is None:
        ids, order = torch.sort(cluster_id, stable=True)
        order = order.to(I32)
        node_off = torch.searchsorted(ids, torch.arange(C + 1, dtype=I32, device=dev),
                                      out_int32=True)
    else:
        _check("node_off", node_off, I32, (C + 1,), dev)
    ans = None if req_idx is None else torch.empty((U, C), dtype=I32, device=dev)
    rc = _bind("fleet_estimate", "fleet_estimate_launch", _FLEET_ESTIMATE_ARGTYPES)(
        *_ptrs(alloc, requested, pod_count, allowed_pods, claimless_ok, order, node_off), C, R,
        request.data_ptr(), U, _ptr(req_idx), B, _ptr(ans), out.data_ptr(), _stream(dev),
    )
    _raise_on(rc, "fleet_estimate")
    return out


def staleness_penalty(values, shift: int):
    """The staleness decay of an int32 answer tensor, a new tensor (see
    staleness_penalty_plain); `shift` in [1, MAX_STALENESS_AGE], the
    penalty's age cap."""
    if not 1 <= shift <= MAX_STALENESS_AGE:
        raise ValueError(f"staleness_penalty: shift={shift} outside [1, {MAX_STALENESS_AGE}]")
    dev = values.device
    if dev.type == "cpu":
        return staleness_penalty_plain(values, shift)
    if dev.type != "cuda":
        raise ValueError(f"staleness_penalty: unsupported device {dev}")
    out = _staleness_launch(values, shift)
    _launched("staleness_penalty")
    return out


def _staleness_launch(values, shift: int):
    """Check, allocate and launch staleness_kernel."""
    _check("values", values, I32, tuple(values.shape), values.device)
    out = torch.empty_like(values)
    n = values.numel()
    if n == 0:
        return out
    rc = _bind("staleness", "staleness_launch", _STALENESS_ARGTYPES)(
        values.data_ptr(), n, shift, out.data_ptr(), _stream(values.device))
    _raise_on(rc, "staleness_penalty")
    return out


def scatter_rows_plain(dsts, idx, srcs):
    """Plain version of the row-scatter kernel (the reference's
    `_scatter_rows_kernel`, `dst.at[idx].set(src)`): `dst[idx] = src` in
    place for each pair; returns `dsts`."""
    for dst, src in zip(dsts, srcs):
        dst[idx] = src
    return dsts


MAX_SCATTER_TENSORS = 8  # scatter_rows.cu's table
_SCATTER_ELEM_BYTES = (1, 4, 8)  # the element sizes its stores take


class _ScatterTable(ctypes.Structure):
    """scatter_rows.cu's ScatterTable: up to MAX_SCATTER_TENSORS
    destinations (pointer, rows, elements a row, element size) and a
    source for each (pointer, row stride in bytes; the staged entry fills
    those itself)."""
    _fields_ = [("dst", _VP * MAX_SCATTER_TENSORS), ("src", _VP * MAX_SCATTER_TENSORS),
                ("src_stride", _CL * MAX_SCATTER_TENSORS), ("rows", _CL * MAX_SCATTER_TENSORS),
                ("row_elems", _CL * MAX_SCATTER_TENSORS),
                ("elem_bytes", _CI * MAX_SCATTER_TENSORS), ("n_dst", _CI)]


def _scatter_table(dsts) -> _ScatterTable:
    """The table over destinations that each have bytes (checked by the
    caller: contiguous, on one device)."""
    table = _ScatterTable(n_dst=len(dsts))
    for e, d in enumerate(dsts):
        if d.element_size() not in _SCATTER_ELEM_BYTES:
            raise TypeError(f"scatter_rows: dtype {d.dtype} (elements of "
                            f"{_SCATTER_ELEM_BYTES} bytes)")
        table.dst[e], table.rows[e] = d.data_ptr(), d.shape[0]
        table.row_elems[e], table.elem_bytes[e] = d.numel() // d.shape[0], d.element_size()
    return table


def _staged_layout(n: int, row_bytes) -> tuple[list[int], int]:
    """The staged route's block (scatter_rows.cu `scatter_rows_staged`):
    the ids, int64 [n], at offset 0, then each destination's n rows of
    `row_bytes`, every segment at a 16-byte boundary; returns the
    segments' offsets and the block's bytes."""
    off, offs = -(-n * 8 // 16) * 16, []
    for w in row_bytes:
        offs.append(off)
        off += -(-n * w // 16) * 16
    return offs, off


def scatter_rows(dsts, idx, srcs):
    """Write rows `src[i]` of each source into rows `idx[i]` of its
    destination, in place (dsts, srcs: sequences of tensors of equal dtype,
    src [n, ...] beside dst [rows, ...]; idx int64 [n]). A duplicate index
    must carry identical rows. Returns `dsts`."""
    dev = idx.device
    if dev.type == "cpu":
        return scatter_rows_plain(dsts, idx, srcs)
    if dev.type != "cuda":
        raise ValueError(f"scatter_rows: unsupported device {dev}")
    _scatter_rows_launch(dsts, idx, srcs)
    _launched("scatter_rows")
    return dsts


def _scatter_rows_launch(dsts, idx, srcs):
    """Check and launch scatter_rows_kernel over separate sources: one
    launch for every tensor."""
    dev = idx.device
    n = idx.shape[0]
    _check("idx", idx, I64, (n,), dev)
    if not 0 < len(dsts) == len(srcs) <= MAX_SCATTER_TENSORS:
        raise ValueError(f"scatter_rows: {len(dsts)} destinations, {len(srcs)} sources "
                         f"(1 to {MAX_SCATTER_TENSORS} pairs)")
    for e, (dst, src) in enumerate(zip(dsts, srcs)):
        _check(f"dst[{e}]", dst, dst.dtype, dst.shape, dev)
        _check(f"src[{e}]", src, dst.dtype, (n,) + tuple(dst.shape[1:]), dev)
    # rows of no bytes (a fleet without taints) have nothing to write
    pairs = [(d, x) for d, x in zip(dsts, srcs) if d.numel()]
    if n == 0 or not pairs:
        return
    table = _scatter_table([d for d, _ in pairs])
    for e, (_, x) in enumerate(pairs):
        table.src[e] = x.data_ptr()
        table.src_stride[e] = table.row_elems[e] * table.elem_bytes[e]
    rc = _bind("scatter_rows", "scatter_rows_launch", _SCATTER_ROWS_ARGTYPES)(
        ctypes.byref(table), idx.data_ptr(), n, _stream(dev))
    _raise_on(rc, "scatter_rows")


class FleetScatter:
    """The dirty-column refresh of one placed fleet on the card, its host
    work done once a placement. Built over the resident tensors (a mapping
    of field name to tensor, each [rows, ...], contiguous, on one device),
    which it checks once, with the ctypes table of those that have bytes
    and the staged C entry bound once. `refresh(rows, fleet)` writes rows
    `rows` (int64 ids, host) of the host arrays `getattr(fleet, name)`
    into the tensors of the same names, in place, on the current stream:
    the ids and the rows gathered straight into one freshly allocated host
    block (pinned on a card; `_staged_layout`), one non-blocking copy to
    the device, one C call (`scatter_rows_staged`), one scatter_rows
    launch counted. No stream sync; a block is never reused by hand (the
    caching host allocator keeps it until its copy is done). Readers that
    hold the tensors see the new rows. `close()` retires the launcher when
    its tensors are replaced: a closed launcher raises instead of writing.
    For CPU tensors use `fleet_scatter`, which writes the same block
    through the plain version."""

    def __init__(self, dsts):
        dsts = dict(dsts)
        if not 0 < len(dsts) <= MAX_SCATTER_TENSORS:
            raise ValueError(f"scatter_rows: {len(dsts)} destinations "
                             f"(1 to {MAX_SCATTER_TENSORS})")
        dev = next(iter(dsts.values())).device
        for name, t in dsts.items():
            _check(name, t, t.dtype, t.shape, dev)
        self.device, self.closed = dev, False
        # the fields with bytes (rows of no bytes, T = 0, have nothing to
        # write): name, tensor, numpy dtype, a row's shape and bytes
        self._fields = [
            (name, t, torch.empty(0, dtype=t.dtype).numpy().dtype, tuple(t.shape[1:]),
             t.numel() // t.shape[0] * t.element_size())
            for name, t in dsts.items() if t.numel()]
        self._row_bytes = [f[4] for f in self._fields]
        self._table = _scatter_table([f[1] for f in self._fields]) if self._fields else None
        self._ref = None if self._table is None else ctypes.byref(self._table)
        self._pin = dev.type == "cuda"
        self._bind()

    def _bind(self) -> None:
        self._fn = _bind("scatter_rows", "scatter_rows_staged", _SCATTER_ROWS_ARGTYPES)

    def close(self) -> None:
        self.closed = True

    def stage(self, rows, fleet):
        """The host block of one refresh (see `_staged_layout`) and its row
        count; checks the arrays' dtypes and row shapes."""
        rows = np.asarray(rows, np.int64)
        n = rows.shape[0]
        offs, nbytes = _staged_layout(n, self._row_bytes)
        host = torch.empty(max(nbytes, 16), dtype=U8, pin_memory=self._pin)
        view = host.numpy()
        view[:n * 8].view(np.int64)[:] = rows
        for (name, _, dt, tail, w), o in zip(self._fields, offs):
            a = getattr(fleet, name)
            if a.dtype != dt or a.shape[1:] != tail:
                raise TypeError(f"scatter_rows: {name} is {a.dtype} {a.shape}, expected "
                                f"{dt} [*, {', '.join(map(str, tail))}]")
            np.take(a, rows, axis=0, out=view[o:o + n * w].view(dt).reshape((n,) + tail))
        return host, n

    def refresh(self, rows, fleet) -> None:
        if self.closed:
            raise RuntimeError("scatter_rows: the launcher's fleet tensors were replaced")
        if len(rows) == 0 or not self._fields:
            return
        self._apply(*self.stage(rows, fleet))

    def _apply(self, host, n: int) -> None:
        staged = host.to(self.device, non_blocking=True)
        rc = self._fn(self._ref, staged.data_ptr(), n, _stream(self.device))
        _raise_on(rc, "scatter_rows")
        _launched("scatter_rows")


class _PlainFleetScatter(FleetScatter):
    """The CPU refresh: FleetScatter's block, cut into views of the ids and
    the rows, written by scatter_rows_plain."""

    def _bind(self) -> None:
        self._fn = None

    def _apply(self, host, n: int) -> None:
        offs, _ = _staged_layout(n, self._row_bytes)
        srcs = [host[o:o + n * w].view(t.dtype).view((n,) + tail)
                for (_, t, _, tail, w), o in zip(self._fields, offs)]
        scatter_rows_plain([f[1] for f in self._fields], host[:n * 8].view(I64), srcs)


def fleet_scatter(dsts) -> FleetScatter:
    """A placed fleet's refresh launcher (see FleetScatter): the card's for
    CUDA tensors, the plain version's (same methods, same block) for CPU
    tensors."""
    dev = next(iter(dict(dsts).values())).device
    if dev.type == "cpu":
        return _PlainFleetScatter(dsts)
    if dev.type != "cuda":
        raise ValueError(f"fleet_scatter: unsupported device {dev}")
    return FleetScatter(dsts)


def sim_filter(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, tie_idx,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, *, plugin_bits: int,
):
    """Filter + estimate over a scenario-stacked fleet (see sim_filter_plain
    for the contract)."""
    args = (alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
            tie_idx, replicas, unknown_request, gvk, tol_tables, tol_idx,
            aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
            req_unique, req_idx, extra_avail)
    dev = alive.device
    if dev.type == "cpu":
        return sim_filter_plain(*args, plugin_bits=plugin_bits)
    if dev.type != "cuda":
        raise ValueError(f"sim_filter: unsupported device {dev}")
    out = _sim_filter_launch(*args, plugin_bits=plugin_bits)
    _launched("sim_filter")
    return out


def _sim_filter_launch(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, tie_idx,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, *, plugin_bits: int,
):
    """Check, allocate (outputs, and the scratch of the factored tables:
    the estimate per distinct request i32[S,U,C], the column-ok table per
    toleration table u8[S,Tt,C], api_ok transposed u8[S,G,C]) and launch
    sim_filter (dense_filter.cu: the tables, then the main pass)."""
    dev = alive.device
    S, C = alive.shape
    R = capacity.shape[2]
    T = taint_key.shape[2]
    G = api_ok.shape[2]
    for name, t, dt, shape in (
        ("capacity", capacity, I64, (S, C, R)), ("has_summary", has_summary, BOOL, (S, C)),
        ("taint_key", taint_key, I32, (S, C, T)), ("taint_value", taint_value, I32, (S, C, T)),
        ("taint_effect", taint_effect, I32, (S, C, T)), ("api_ok", api_ok, BOOL, (S, C, G)),
        ("tie_idx", tie_idx, I64, (S, C)),
    ):
        _check(name, t, dt, shape, dev)
    # the batch against one scenario's fleet slice
    _, _, _, _, B, Kt, Kp, Ke = _check_filter_args(
        alive[0], capacity[0], has_summary[0], taint_key[0], taint_value[0], taint_effect[0],
        api_ok[0], replicas, unknown_request, gvk, tol_tables, tol_idx,
        aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
        req_unique, req_idx, extra_avail,
    )
    U, Tt = req_unique.shape[0], tol_tables.shape[0]
    feasible = torch.empty((S, B, C), dtype=BOOL, device=dev)
    avail = torch.empty((S, B, C), dtype=I32, device=dev)
    prev = torch.empty((S, B, C), dtype=I32, device=dev)
    tie = torch.empty((S, B, C), dtype=I32, device=dev)
    feas_count = torch.empty((S, B), dtype=I32, device=dev)
    if B == 0 or C == 0:
        return feasible, avail, prev, tie, feas_count.zero_()
    est_u = torch.empty((S, U, C), dtype=I32, device=dev)
    col_ok = torch.empty((S, Tt, C), dtype=U8, device=dev)
    api_t = torch.empty((S, G, C), dtype=U8, device=dev)
    rc = _bind("dense_filter", "sim_filter_launch", _SIM_FILTER_ARGTYPES)(
        *_ptrs(alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok),
        S, C, R, T, G,
        *_ptrs(tie_idx, replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks,
               aff_idx, prev_idx, prev_rep, evict_idx, seeds, req_unique, req_idx),
        B, Kt, Kp, Ke, U, Tt, plugin_bits, extra_avail is not None,
        *_ptrs(extra_avail, est_u, col_ok, api_t, feasible, avail, prev, tie, feas_count),
        _stream(dev),
    )
    _raise_on(rc, "sim_filter")
    return feasible, avail, prev, tie, feas_count


def sim_load(result, active, request):
    """Per-scenario replicas and resource load per cluster over the active
    rows (see sim_load_plain)."""
    dev = result.device
    if dev.type == "cpu":
        return sim_load_plain(result, active, request)
    if dev.type != "cuda":
        raise ValueError(f"sim_load: unsupported device {dev}")
    out = _sim_load_launch(result, active, request)
    _launched("sim_load", _resource_blocks(request.shape[1], SIM_LOAD_RESOURCE_BLOCK))
    return out


def _sim_load_launch(result, active, request):
    """Check, allocate and launch sim_load (the C entry zeroes the outputs
    on the stream, then launches once per block of up to eight resources:
    any R)."""
    dev = result.device
    S, B, C = result.shape
    R = request.shape[1]
    for name, t, dt, shape in (
        ("result", result, I32, (S, B, C)), ("active", active, BOOL, (S, B)),
        ("request", request, I64, (B, R)),
    ):
        _check(name, t, dt, shape, dev)
    if S == 0 or B == 0 or C == 0:
        return (torch.zeros((S, C), dtype=I64, device=dev),
                torch.zeros((S, C, R), dtype=I64, device=dev))
    assigned = torch.empty((S, C), dtype=I64, device=dev)
    usage = torch.empty((S, C, R), dtype=I64, device=dev)
    rc = _bind("sim_load", "sim_load_launch", _SIM_LOAD_ARGTYPES)(
        result.data_ptr(), active.data_ptr(), request.data_ptr(), S, B, C, R,
        assigned.data_ptr(), usage.data_ptr(), _stream(dev))
    _raise_on(rc, "sim_load")
    return assigned, usage


def dense_input_filter(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, request, unknown_request, gvk, tol_key, tol_value, tol_effect, tol_op,
    affinity_ok, eviction_ok, prev_member, extra_avail,
):
    """Dense filter + estimate + answer merge over fully dense row inputs
    (see dense_input_filter_plain for the contract)."""
    args = (alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
            replicas, request, unknown_request, gvk, tol_key, tol_value, tol_effect, tol_op,
            affinity_ok, eviction_ok, prev_member, extra_avail)
    dev = alive.device
    if dev.type == "cpu":
        return dense_input_filter_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"dense_input_filter: unsupported device {dev}")
    out = _dense_input_filter_launch(*args)
    _launched("dense_input_filter")
    return out


def _dense_input_filter_launch(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, request, unknown_request, gvk, tol_key, tol_value, tol_effect, tol_op,
    affinity_ok, eviction_ok, prev_member, extra_avail,
):
    """Check, allocate and launch dense_input_filter (dense_filter.cu:
    one launch that factors each group of rows in shared memory). Every
    input is read where it lies: nothing is copied or restacked."""
    dev = alive.device
    C, R = capacity.shape
    T = taint_key.shape[1]
    G = api_ok.shape[1]
    B, Kt = tol_key.shape
    for name, t, dt, shape in (
        ("alive", alive, BOOL, (C,)), ("capacity", capacity, I64, (C, R)),
        ("has_summary", has_summary, BOOL, (C,)),
        ("taint_key", taint_key, I32, (C, T)), ("taint_value", taint_value, I32, (C, T)),
        ("taint_effect", taint_effect, I32, (C, T)), ("api_ok", api_ok, BOOL, (C, G)),
        ("replicas", replicas, I32, (B,)), ("request", request, I64, (B, R)),
        ("unknown_request", unknown_request, BOOL, (B,)), ("gvk", gvk, I32, (B,)),
        ("tol_key", tol_key, I32, (B, Kt)), ("tol_value", tol_value, I32, (B, Kt)),
        ("tol_effect", tol_effect, I32, (B, Kt)), ("tol_op", tol_op, I32, (B, Kt)),
        ("affinity_ok", affinity_ok, BOOL, (B, C)), ("eviction_ok", eviction_ok, BOOL, (B, C)),
        ("prev_member", prev_member, BOOL, (B, C)), ("extra_avail", extra_avail, I32, (B, C)),
    ):
        _check(name, t, dt, shape, dev)
    feasible = torch.empty((B, C), dtype=BOOL, device=dev)
    score = torch.empty((B, C), dtype=I32, device=dev)
    avail = torch.empty((B, C), dtype=I32, device=dev)
    if B == 0 or C == 0:
        return feasible, score, avail
    rc = _bind("dense_filter", "dense_input_filter_launch", _DENSE_INPUT_FILTER_ARGTYPES)(
        *_ptrs(alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok),
        C, R, T, G,
        *_ptrs(replicas, request, unknown_request, gvk, tol_key, tol_value, tol_effect,
               tol_op), Kt,
        *_ptrs(affinity_ok, eviction_ok, prev_member, extra_avail), B, ALL_PLUGIN_BITS,
        *_ptrs(feasible, score, avail), _stream(dev),
    )
    _raise_on(rc, "dense_input_filter")
    return feasible, score, avail


def _check_rows_view(name: str, t, dtype, shape, device) -> int:
    """Check a [B, C] operand that may be a column slice of a wider
    row-major tensor; returns its row stride in elements."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: columns must be contiguous (stride {t.stride()})")
    if shape[0] > 1 and t.stride(0) < shape[1]:
        raise ValueError(f"{name}: row stride {t.stride(0)} below the width {shape[1]}")
    return t.stride(0)


def mesh_tile_filter(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, extra_mask, extra_score, *, col0: int, plugin_bits: int,
):
    """Filter + estimate + terms over one mesh tile (see
    mesh_tile_filter_plain for the contract)."""
    args = (alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
            replicas, unknown_request, gvk, tol_tables, tol_idx,
            aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
            req_unique, req_idx, extra_avail, extra_mask, extra_score)
    dev = alive.device
    if dev.type == "cpu":
        return mesh_tile_filter_plain(*args, col0=col0, plugin_bits=plugin_bits)
    if dev.type != "cuda":
        raise ValueError(f"mesh_tile_filter: unsupported device {dev}")
    out = _mesh_tile_filter_launch(*args, col0=col0, plugin_bits=plugin_bits)
    _launched("mesh_tile_filter")
    return out


def _mesh_tile_filter_launch(
    alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
    replicas, unknown_request, gvk, tol_tables, tol_idx,
    aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
    req_unique, req_idx, extra_avail, extra_mask, extra_score, *, col0: int, plugin_bits: int,
):
    """Check, allocate (the outputs, score / avail / prev / tie as the
    four planes of one i32[4,B,C] allocation, and the factored tables'
    scratch in one allocation, as `_dense_filter_launch` does) and launch
    mesh_tile_filter on the tile's device (dense_filter.cu: the tables over
    the tile's fleet slice, then the main pass). The terms are read where
    they lie, through their row strides."""
    dev = alive.device
    C, R, T, G, B, Kt, Kp, Ke = _check_filter_args(
        alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok,
        replicas, unknown_request, gvk, tol_tables, tol_idx,
        aff_masks, aff_idx, prev_idx, prev_rep, evict_idx, seeds,
        req_unique, req_idx, None,
    )
    if col0 < 0:
        raise ValueError(f"mesh_tile_filter: col0 {col0} < 0")
    lds = [
        0 if t is None else _check_rows_view(name, t, dt, (B, C), dev)
        for name, t, dt in (("extra_avail", extra_avail, I32), ("extra_mask", extra_mask, BOOL),
                            ("extra_score", extra_score, I32))
    ]
    U, Tt = req_unique.shape[0], tol_tables.shape[0]
    feasible = torch.empty((B, C), dtype=BOOL, device=dev)
    score, avail, prev, tie = torch.empty((4, B, C), dtype=I32, device=dev).unbind(0)
    feas_count = torch.empty((B,), dtype=I32, device=dev)
    if B == 0 or C == 0:
        return feasible, score, avail, prev, tie, feas_count.zero_()
    scratch = torch.empty((4 * U + Tt + G) * C, dtype=U8, device=dev)
    est_u = scratch.data_ptr()
    col_ok = est_u + 4 * U * C
    fn = _bind("dense_filter", "mesh_tile_filter_launch", _MESH_TILE_FILTER_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            *_ptrs(alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok),
            C, R, T, G,
            *_ptrs(replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx,
                   prev_idx, prev_rep, evict_idx, seeds, req_unique, req_idx),
            B, Kt, Kp, Ke, U, Tt, plugin_bits, col0,
            _ptr(extra_avail), lds[0], _ptr(extra_mask), lds[1], _ptr(extra_score), lds[2],
            est_u, col_ok, col_ok + Tt * C,
            *_ptrs(feasible, score, avail, prev, tie, feas_count), _stream(dev),
        )
    _raise_on(rc, "mesh_tile_filter")
    return feasible, score, avail, prev, tie, feas_count


def reset_launches() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


def launch_counts() -> dict[str, int]:
    with _launch_lock:
        return dict(_launches)
