"""Batched SpreadConstraint selection (PyTorch port of sched/spread_batch.py,
host half).

The reference resolves spread constraints one binding at a time: build
ClusterDetail objects, group by region, score each group with a sorted
prefix walk, then DFS over group combinations
(pkg/scheduler/core/spreadconstraint/{group_clusters,select_groups}.go).
The batched path splits that work:

- REGION IS A FLEET PROPERTY: the cluster→region map does not vary per
  binding, so a static column permutation (`RegionLayout`) groups each
  region into a contiguous slice of permuted columns, and one
  group-scoring launch (`kernels.group_score`) scores every (row, region)
  pair at once (group_clusters.go:143-330 semantics).
- The group-combination search runs here, on the host: enumerate candidate
  combinations ONCE per constraint config, sum every row × combination
  weight/value, and select the winner per row lexicographically
  (select_groups.go:100-230) — in numpy, or through `kernels.combo_select`
  once the (deduped) batch is large and lives on the card. Rows whose
  winner ties on (weight, value) take the discovery-order tie-break, and
  rows the table cannot prove optimal fall back to the exact per-row path.
- Selected-cluster masks are bit-packed on the device
  (`kernels.packed_selection`) and divided rows re-run the division tail
  over the selection (`kernels.spread_tail`).

Only region-spread rows without a cluster MaxGroups cap ride this path;
cluster-only constraints and capped rows use the per-row exact path
(sched/spread.py), which stays the semantic spec either way.

The reference's native C++ class-collapsed DFS is not ported: this module
behaves as the reference does when that library is absent (the
combination table, with the Python class DFS for rows the table cannot
take).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from itertools import combinations
from typing import Optional, Sequence

import numpy as np
import torch

from ..api.policy import (
    Placement,
    SPREAD_BY_FIELD_CLUSTER,
    SPREAD_BY_FIELD_REGION,
)
from .spread import _constraint_map, should_ignore_available_resource

# combination-enumeration guards: beyond these the exact per-row DFS is no
# better, but the batched pass would burn memory — fall back per row.
MAX_REGIONS = 64
MAX_PATH_LEN = 6
MAX_COMBOS = 40000
# device winner-selection guard: the [S, K, L] work must fit comfortably
SPREAD_COMBO_DEVICE_BYTES = 1 << 30
# the (deduped) row count from which the winner selection runs on the card
SPREAD_COMBO_DEVICE_ROWS = 4096


def on_card(on) -> bool:
    """Whether a round on device `on` runs on the card."""
    return on is not None and torch.device(on).type == "cuda"


@dataclass(frozen=True)
class SpreadConfig:
    """The per-placement knobs that shape group scoring + selection."""

    rmin: int  # region MinGroups
    rmax: int  # region MaxGroups (0 = unbounded)
    cmin: int  # cluster MinGroups (the DFS coverage target)
    cmax: int  # cluster MaxGroups (0 = unbounded; >0 forces fallback)
    duplicated: bool  # availability ignored per-cluster (select_clusters.go:79-88)

    @property
    def need(self) -> int:
        return max(self.cmin, max(self.rmin, 1))


def config_of(placement: Placement) -> Optional[SpreadConfig]:
    """Classify a placement for the batched path; None = not eligible
    (no region constraint, zone/provider fields, or a cluster cap)."""
    cmap = _constraint_map(placement.spread_constraints)
    if SPREAD_BY_FIELD_REGION not in cmap:
        return None
    if any(f not in (SPREAD_BY_FIELD_REGION, SPREAD_BY_FIELD_CLUSTER) for f in cmap):
        return None
    rc = cmap[SPREAD_BY_FIELD_REGION]
    cc = cmap.get(SPREAD_BY_FIELD_CLUSTER)
    cmin = cc.min_groups if cc else 0
    cmax = cc.max_groups if cc else 0
    if cmax > 0:
        return None  # phase-C truncation: exact path
    return SpreadConfig(
        rmin=rc.min_groups,
        rmax=rc.max_groups,
        cmin=cmin,
        cmax=cmax,
        duplicated=should_ignore_available_resource(placement),
    )


class RegionLayout:
    """Static fleet-side spread encoding: the region-grouping column
    permutation and its contiguous slices. Built once per cluster set.

    The permuted columns whose region is real come first, contiguous per
    region (`seg_start`/`seg_end`), so group reductions are sums over
    static slices — memory O(C) whatever the region sizes (the reference's
    padded [R, W] grid is not kept: the group-scoring kernel works on the
    slices for both of the reference's forms)."""

    def __init__(self, region_id: np.ndarray, region_names: Sequence[str],
                 name_rank: np.ndarray):
        self.n_regions = len(region_names)
        self.region_names = list(region_names)
        C = len(region_id)
        # clusters without a region sort to the tail and never join a group
        order = np.lexsort((np.arange(C), np.where(region_id < 0, self.n_regions, region_id)))
        self.perm = order.astype(np.int32)  # permuted -> original column
        rid_p = region_id[order]
        slices: list[tuple[int, int]] = []
        for r in range(self.n_regions):
            pos = np.nonzero(rid_p == r)[0]
            slices.append((int(pos[0]), int(pos[-1]) + 1) if len(pos) else (0, 0))
        self.name_rank_p = name_rank[order].astype(np.int32)
        self.seg_cp = int((region_id >= 0).sum())
        self.seg_start = np.array([s for s, _ in slices], np.int32)
        self.seg_end = np.array([e for _, e in slices], np.int32)
        # original-column-order region ids, shifted by one (0 = regionless —
        # such clusters never join a region selection)
        self.rid_orig = np.where(region_id < 0, 0, region_id + 1).astype(np.int32)
        # region-name ascending ranks (group order + path-sort tie-breaks)
        names_idx = sorted(range(self.n_regions), key=lambda r: self.region_names[r])
        self.rname_rank = np.empty(self.n_regions, np.int64)
        self.rname_rank[names_idx] = np.arange(self.n_regions)
        self._rname_dev: dict = {}

    def rname_tensor(self, device) -> torch.Tensor:
        """`rname_rank` as i32[R] on `device`, uploaded once."""
        key = str(device)
        t = self._rname_dev.get(key)
        if t is None:
            t = self._rname_dev[key] = torch.from_numpy(self.rname_rank.astype(np.int32)).to(device)
        return t

    def tensors(self, device) -> dict:
        """The layout as the spread kernels take it, on `device`: `perm`
        (i32[Cp], the region-member columns), `seg_start`/`seg_end`
        (i32[R]), `rank_p` (i32[Cp], name ranks of the permuted columns)
        and `rid` (i32[C], region id + 1 per column, 0 = regionless)."""
        cp = self.seg_cp
        arrays = {
            "perm": self.perm[:cp], "seg_start": self.seg_start,
            "seg_end": self.seg_end, "rank_p": self.name_rank_p[:cp],
            "rid": self.rid_orig,
        }
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)
                for k, v in arrays.items()}


# -- host combination search -------------------------------------------------


class _ComboTable:
    """All candidate region subsets for one (R, kmin..kmax) shape, with the
    one-hot matrix for the batched weight/value sums."""

    def __init__(self, n_regions: int, kmin: int, kmax: int):
        self.members: list[tuple[int, ...]] = []
        for k in range(kmin, kmax + 1):
            self.members.extend(combinations(range(n_regions), k))
        self.onehot = np.zeros((len(self.members), n_regions), np.int64)
        for i, m in enumerate(self.members):
            self.onehot[i, list(m)] = 1
        self.sizes = self.onehot.sum(1)
        self.max_len = max((len(m) for m in self.members), default=1)
        self.onehot_f_t = self.onehot.astype(np.float64).T  # cached for BLAS
        self.members_pad = np.full((max(len(self.members), 1), self.max_len),
                                   -1, np.int64)
        for i, m in enumerate(self.members):
            self.members_pad[i, : len(m)] = m
        self._dev: dict = {}

    def tensors(self, device) -> tuple:
        """(members_pad i32[K, L], sizes i32[K]) on `device`, uploaded once."""
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = (
                torch.from_numpy(self.members_pad.astype(np.int32)).to(device),
                torch.from_numpy(self.sizes.astype(np.int32)).to(device),
            )
        return t


_combo_cache: dict[tuple[int, int, int], _ComboTable] = {}


def _combos(n_regions: int, kmin: int, kmax: int) -> Optional[_ComboTable]:
    total = 0
    for k in range(kmin, kmax + 1):
        total += math.comb(n_regions, k)
        if total > MAX_COMBOS:
            return None
    key = (n_regions, kmin, kmax)
    t = _combo_cache.get(key)
    if t is None:
        t = _combo_cache[key] = _ComboTable(n_regions, kmin, kmax)
    return t


@dataclass
class ComboResult:
    chosen: np.ndarray  # bool[S,R] selected regions (False rows: see below)
    errors: dict[int, str]  # row -> SpreadError message
    fallback: list[int]  # rows needing the exact per-row path (ties etc.)


_CLASS_DFS_BUDGET = 200_000  # recursion-step bound per row


def _select_row_class_dfs(weight: np.ndarray, value: np.ndarray,
                          cfg: SpreadConfig, layout: RegionLayout,
                          kmax: int):
    """Exact region selection for ONE row by collapsing identical regions.

    When the combination table would be too large to enumerate
    (C(R, kmin..kmax) > MAX_COMBOS), the skewed-fleet structure that causes
    it — many interchangeable tiny regions — also defeats it: regions with
    identical (weight, value) are indistinguishable to the DFS except for
    name order, so recorded paths collapse to CLASS MULTISETS. Subsets
    realizing one multiset share (Σw, Σv) and recorded-ness, and the
    discovery-order representative is the canonical first-members-per-class
    subset (lex-min position sequence); the reference's winner rule
    (weight desc, value desc, id asc; select_groups.go:200-213) therefore
    reduces to a DFS over class counts — tiny wherever the subset
    enumeration explodes.

    Returns (region_index_array) on success, an error string for the
    too-few-groups cases, or None when the class DFS itself exceeds its
    budget (caller falls back to the per-row subset path)."""
    kmin = max(cfg.rmin, 1)
    cmin = cfg.cmin
    present = np.nonzero(value > 0)[0]
    if len(present) < kmin:
        return (
            "the number of feasible region is less than "
            "spreadConstraint.MinGroups"
        )
    # group order (value asc, weight desc, name asc)
    rr = layout.rname_rank
    order = sorted(
        present, key=lambda r: (value[r], -weight[r], rr[r])
    )
    # contiguous classes over (value, weight)
    cls_v: list[int] = []
    cls_w: list[int] = []
    cls_members: list[list[int]] = []
    cls_start: list[int] = []
    for pos, r in enumerate(order):
        if cls_v and value[r] == cls_v[-1] and weight[r] == cls_w[-1]:
            cls_members[-1].append(r)
        else:
            cls_v.append(int(value[r]))
            cls_w.append(int(weight[r]))
            cls_members.append([r])
            cls_start.append(pos)
    K = len(cls_v)
    n_present = len(present)
    kmax = min(kmax, n_present)
    if kmax < kmin:
        return (
            "the number of clusters is less than the cluster "
            "spreadConstraint.MinGroups"
        )

    # `if len(groups) == minConstraint: break` (select_groups.go:181-183):
    # the DFS takes exactly the full set
    if n_present == kmin:
        sv = int(value[present].sum())
        if sv < cmin:
            return (
                "the number of clusters is less than the cluster "
                "spreadConstraint.MinGroups"
            )
        counts = [len(m) for m in cls_members]
        return _class_counts_to_regions(
            counts, cls_members, cls_v, cls_w, cls_start, rr, kmin, cmin
        )

    recorded: list[tuple[int, int, tuple[int, ...]]] = []  # (Σw, Σv, counts)
    counts = [0] * K
    budget = [_CLASS_DFS_BUDGET]

    def rec(k: int, size: int, sv: int, sw: int) -> None:
        budget[0] -= 1
        if budget[0] <= 0:
            raise _Budget()
        if k == K:
            return
        # j = 0 (skip this class)
        rec(k + 1, size, sv, sw)
        m = len(cls_members[k])
        vk, wk = cls_v[k], cls_w[k]
        for j in range(1, min(m, kmax - size) + 1):
            size_j = size + j
            sv_j = sv + j * vk
            sw_j = sw + j * wk
            if sv_j >= cmin and size_j >= kmin:
                # the subset DFS records here and RETURNS — deeper members
                # of this class or later classes would have a satisfied
                # prefix and never be enumerated
                counts[k] = j
                recorded.append((sw_j, sv_j, tuple(counts)))
                counts[k] = 0
                break
            counts[k] = j
            rec(k + 1, size_j, sv_j, sw_j)
            counts[k] = 0

    class _Budget(Exception):
        pass

    try:
        rec(0, 0, 0, 0)
    except _Budget:
        return None
    if not recorded:
        return (
            "the number of clusters is less than the cluster "
            "spreadConstraint.MinGroups"
        )

    def canonical_key(cv: tuple[int, ...]) -> tuple[int, ...]:
        key: list[int] = []
        for k, j in enumerate(cv):
            key.extend(range(cls_start[k], cls_start[k] + j))
        return tuple(key)

    # two-stage winner: (Σw, Σv) max with cheap tuple compares first; the
    # discovery-order canonical key is built ONLY for the tied maxima
    best_w, best_v = max((t[0], t[1]) for t in recorded)
    tied = [t for t in recorded if t[0] == best_w and t[1] == best_v]
    best = (
        tied[0]
        if len(tied) == 1
        else min(tied, key=lambda t: canonical_key(t[2]))
    )
    return _class_counts_to_regions(
        list(best[2]), cls_members, cls_v, cls_w, cls_start, rr, kmin, cmin
    )


def _class_counts_to_regions(counts, cls_members, cls_v, cls_w, cls_start,
                             rr, kmin: int, cmin: int) -> np.ndarray:
    """Counts → concrete regions (first members per class, name-ascending —
    the canonical representative) + the subpath preference."""
    members: list[int] = []  # winner's concrete regions
    mem_v: list[int] = []
    mem_w: list[int] = []
    mem_pos: list[int] = []
    for k, j in enumerate(counts):
        ordered = sorted(cls_members[k], key=lambda r: rr[r])
        for i in range(j):
            members.append(ordered[i])
            mem_v.append(cls_v[k])
            mem_w.append(cls_w[k])
            mem_pos.append(cls_start[k] + i)
    return _finish_row_members(members, mem_v, mem_w, mem_pos, rr, kmin, cmin)


def _finish_row_members(members, mem_v, mem_w, mem_pos, rr,
                        kmin: int, cmin: int) -> np.ndarray:
    """The subpath preference (select_groups.go:210-230): the SHORTEST
    (weight desc, name asc)-ordered prefix of the winner that is itself a
    recorded feasible path."""
    worder = sorted(range(len(members)),
                    key=lambda i: (-mem_w[i], rr[members[i]]))
    n = len(members)
    cut = n
    for L in range(max(kmin, 1), n):
        prefix = worder[:L]
        sv = sum(mem_v[i] for i in prefix)
        if sv < cmin:
            continue
        if L > kmin:
            # recorded-ness: drop the prefix's group-order-last member
            last = max(prefix, key=lambda i: mem_pos[i])
            if sv - mem_v[last] >= cmin:
                continue
        cut = L
        break
    return np.asarray(sorted(members[i] for i in worder[:cut]), np.int64)


def select_regions_batch(
    weight: np.ndarray,  # i64[S,R]
    value: np.ndarray,  # i32[S,R]
    cfg: SpreadConfig,
    layout: RegionLayout,
    device: "bool | None" = None,  # None = auto (the round's device + size gate)
    on: Optional[torch.device] = None,  # the device the round runs on
) -> ComboResult:
    """Vectorized selectGroups (select_groups.go:100-230) for rows sharing
    one constraint config. Winner per row = feasible combination maximizing
    (Σweight, Σvalue); the reference's discovery-order tie-break only
    matters on exact (Σw, Σv) ties, which resolve in-batch or go to the
    per-row DFS. Subpath preference (prefer the shortest weight-ordered
    prefix of the winner that still covers the target) is applied exactly.

    `device=True` runs the winner selection through `kernels.combo_select`
    on `on` (the plain version when `on` is the CPU or None); None opens
    that path only when `on` is a CUDA device and the deduped batch is
    large enough to pay for the round trip."""
    S, R = weight.shape

    # Dedup identical (weight, value) rows first: bindings sharing a
    # placement + request produce identical group matrices, and the winner
    # depends only on the row content. The search then runs once per
    # DISTINCT row and results scatter back.
    key = np.concatenate([weight, value.astype(np.int64)], axis=1)
    uniq_first, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )[1:]
    inverse = inverse.reshape(-1)
    if len(uniq_first) < S:
        res_u = select_regions_batch(
            weight[uniq_first], value[uniq_first], cfg, layout, device, on
        )
        err_u = res_u.errors
        fb_u = set(res_u.fallback)
        errors: dict[int, str] = {}
        fallback: list[int] = []
        for s in range(S):
            u = int(inverse[s])
            if u in err_u:
                errors[s] = err_u[u]
            elif u in fb_u:
                fallback.append(s)
        return ComboResult(res_u.chosen[inverse], errors, fallback)

    present = value > 0
    n_present = present.sum(1)
    errors: dict[int, str] = {}
    fallback: list[int] = []
    chosen = np.zeros((S, R), bool)

    kmin = max(cfg.rmin, 1)
    too_few = n_present < cfg.rmin
    for s in np.nonzero(too_few)[0]:
        errors[int(s)] = (
            "the number of feasible region is less than spreadConstraint.MinGroups"
        )

    # per-row max path length: MaxGroups, else the row's present-region
    # count; never below kmin (the DFS clamps max_constraint =
    # max(max_constraint, min_constraint), select_groups.go:102-107)
    kmax_row = np.maximum(
        np.where(cfg.rmax > 0, cfg.rmax, n_present), kmin
    ).astype(np.int64)
    kmax_enum = int(min(R, kmax_row.max(initial=0), MAX_PATH_LEN if cfg.rmax <= 0 else cfg.rmax))
    if kmax_enum < kmin:
        kmax_enum = kmin
    if int(np.abs(weight).max(initial=0)) >= (1 << 48):
        # pathological magnitudes would lose exactness in the f64 host rank
        # compares — route such fleets to the per-row exact DFS everywhere
        live = np.nonzero(~too_few)[0]
        fallback.extend(int(s) for s in live)
        return ComboResult(chosen, errors, fallback)

    def run_class_dfs() -> ComboResult:
        # the class-collapsed exact DFS (skewed fleets: many
        # interchangeable regions ⇒ few classes), one row at a time
        for s in (int(s) for s in np.nonzero(~too_few)[0]):
            out = _select_row_class_dfs(
                weight[s], value[s], cfg, layout, int(kmax_row[s])
            )
            if out is None:
                fallback.append(s)
            elif isinstance(out, str):
                errors[s] = out
            else:
                chosen[s, out] = True
        return ComboResult(chosen, errors, fallback)

    table = _combos(R, kmin, min(kmax_enum, R))
    if R > MAX_REGIONS:
        live = np.nonzero(~too_few)[0]
        fallback.extend(int(s) for s in live)
        return ComboResult(chosen, errors, fallback)
    if table is None:
        return run_class_dfs()  # enumeration too large even to build
    if not table.members:  # kmin > R: no combination can exist
        for s in np.nonzero(~too_few)[0]:
            errors[int(s)] = (
                "the number of clusters is less than the cluster "
                "spreadConstraint.MinGroups"
            )
        return ComboResult(chosen, errors, fallback)
    # rows whose own kmax exceeds what we enumerated (unbounded MaxGroups
    # with many regions) cannot be proven optimal here
    overflow = (~too_few) & (kmax_row > kmax_enum) & (n_present > kmax_enum)

    v64 = value.astype(np.int64)

    if device is None:
        # the card's win only materializes once the (deduped) row count is
        # large — below that the upload + sync round trip dwarfs the host
        # BLAS pass
        device = (
            on_card(on)
            and S >= SPREAD_COMBO_DEVICE_ROWS
            and S * len(table.members) * table.max_len * 8
            <= SPREAD_COMBO_DEVICE_BYTES
        )
    if device:
        from .. import kernels
        from .core import fetch_views, to_device_packed

        dev = torch.device("cpu" if on is None else on)
        members_pad, sizes = table.tensors(dev)
        # the row inputs in one upload, the layout's and table's constants
        # cached on the device, the three outputs fetched in one copy
        row_inputs = to_device_packed([np.asarray(weight, np.int64), np.asarray(value, np.int32),
                                       kmax_row.astype(np.int32)], dev)
        outs = kernels.combo_select(*row_inputs, layout.rname_tensor(dev), members_pad, sizes,
                                    cmin=int(cfg.cmin), kmin=int(kmin))
        fi, nt, nf = (x.numpy() for x in fetch_views(*outs))
        return _finish_selection(
            weight, v64, cfg, layout, table, kmin, chosen, errors,
            fallback, overflow, fi, nt, nf,
        )

    # host path (also the spec the device kernel is tested against)
    # int64 matmul has no BLAS path in numpy; float64 is exact while
    # |weight| * path-length < 2^53, which the 2^48 guard above ensures.
    onehot_f = table.onehot_f_t
    sum_w = weight.astype(np.float64) @ onehot_f  # exact below 2^48
    # values are i32 per region; a path of several huge regions can pass
    # 2^31, so the summed form stays i64 (f64 is exact: counts << 2^53)
    sum_v = (v64.astype(np.float64) @ onehot_f).astype(np.int64)
    members_present = (
        (present.astype(np.float64) @ onehot_f).astype(np.int32)
        == table.sizes[None, :]
    )
    feasible_combo = (
        members_present
        & (sum_v >= cfg.cmin)
        & (table.sizes[None, :] <= kmax_row[:, None])
    )

    # RECORDED-path pruning: the reference DFS returns at the FIRST
    # satisfied prefix (select_groups.go dfs), so a subset is enumerated
    # iff removing its LAST member in the group order (value asc, weight
    # desc, name asc) leaves an UNsatisfied prefix. Each row ranks its
    # regions in that order ONCE (pos, int8 — R <= 64), then every combo's
    # last member falls out of one [S, K, Lmax] positional gather.
    rr = layout.rname_rank
    order_g = np.lexsort(
        (np.broadcast_to(rr, (S, R)), -weight, v64), axis=-1
    )  # ascending group order; last position = the DFS path's last member
    pos = np.empty((S, R), np.int8)
    np.put_along_axis(pos, order_g, np.arange(R, dtype=np.int8)[None, :], -1)
    mp = table.members_pad  # [K, Lmax], -1 = pad
    mpc = np.where(mp >= 0, mp, 0)
    pos_g = pos[:, mpc]  # [S, K, Lmax] int8
    pos_g = np.where(mp[None, :, :] >= 0, pos_g, np.int8(-1))
    am = pos_g.argmax(axis=2)  # [S, K]
    last_region = mpc[np.arange(mpc.shape[0])[None, :], am]  # [S, K]
    v_last = np.take_along_axis(value, last_region, axis=1)  # i32
    recorded = (table.sizes[None, :] - 1 < kmin) | (sum_v - v_last < cfg.cmin)
    feasible_combo &= recorded

    w_masked = np.where(feasible_combo, sum_w, -np.inf)
    best_w = w_masked.max(1)
    none_feasible = np.isneginf(best_w)
    cand = w_masked == best_w[:, None]
    v_masked = np.where(cand, sum_v, np.int64(-(1 << 62)))
    best_v = v_masked.max(1)
    cand2 = cand & (sum_v == best_v[:, None]) & feasible_combo
    n_ties = cand2.sum(1)

    first_idx = np.argmax(cand2, axis=1)
    if n_ties.max(initial=0) > 1 and 7 * table.max_len <= 62:
        # (Σw, Σv) ties resolve by DFS DISCOVERY ORDER (prioritizePaths
        # sorts (weight desc, value desc, id asc), select_groups.go:207-213;
        # id = append order of the DFS, which emits recorded paths in
        # lexicographic order of their group-order position sequences, and
        # no recorded path is a prefix of another). Pack each combo's sorted
        # positions into one integer (7 bits/slot — positions reach 63 at
        # R == MAX_REGIONS, so the pad sentinel is a distinct 127) and take
        # the min.
        tied = np.nonzero(n_ties > 1)[0]
        seq = np.where(pos_g[tied] < 0, 127, pos_g[tied]).astype(np.int64)
        seq.sort(axis=2)
        shifts = 7 * np.arange(table.max_len - 1, -1, -1, dtype=np.int64)
        disc = (seq << shifts).sum(axis=2)
        disc = np.where(cand2[tied], disc, np.int64(1) << 62)
        first_idx[tied] = disc.argmin(axis=1)
        n_ties[tied] = 1
    return _finish_selection(
        weight, v64, cfg, layout, table, kmin, chosen, errors,
        fallback, overflow, first_idx, n_ties, none_feasible,
    )


def _finish_selection(
    weight, v64, cfg, layout, table, kmin, chosen, errors, fallback,
    overflow, first_idx, n_ties, none_feasible,
) -> ComboResult:
    """Shared tail of select_regions_batch: error/fallback routing + the
    vectorized subpath preference, fed by either the host or the device
    winner selection."""
    S = weight.shape[0]
    rr = layout.rname_rank

    # rows that need a decision here (everything else errors or falls back)
    live = np.ones(S, bool)
    for s in np.nonzero(none_feasible)[0]:
        if int(s) not in errors:
            errors[int(s)] = (
                "the number of clusters is less than the cluster "
                "spreadConstraint.MinGroups"
            )
    live &= ~none_feasible
    for s in errors:
        live[s] = False
    fb_mask = live & (overflow | (n_ties > 1))
    fallback.extend(int(s) for s in np.nonzero(fb_mask)[0])
    live &= ~fb_mask
    rows = np.nonzero(live)[0]
    if not len(rows):
        return ComboResult(chosen, errors, fallback)

    # ---- vectorized subpath preference (select_groups.go:210-230): order
    # each winner's members by (weight desc, name asc), then take the
    # SHORTEST prefix that is itself a RECORDED feasible path ----
    Lmax = table.max_len
    mem = table.members_pad[first_idx[rows]]  # [N, Lmax] region ids, -1 = pad
    valid_m = mem >= 0
    midx = np.where(valid_m, mem, 0)
    mw = np.where(valid_m, weight[rows[:, None], midx], np.int64(-1) << 62)
    mv = np.where(valid_m, v64[rows[:, None], midx], 0)
    mn = np.where(valid_m, rr[midx], np.int64(1) << 40)
    # row-wise sort by (weight desc, name asc): stable argsort name, then -w
    o1 = np.argsort(mn, axis=1, kind="stable")
    mw1 = np.take_along_axis(mw, o1, 1)
    o2 = np.argsort(-mw1, axis=1, kind="stable")
    order = np.take_along_axis(o1, o2, 1)
    ms = np.take_along_axis(mem, order, 1)  # sorted member ids
    vs = np.take_along_axis(mv, order, 1)
    ws = np.take_along_axis(mw, order, 1)
    ns = np.take_along_axis(mn, order, 1)
    sizes_r = valid_m.sum(1)
    cum_v = np.cumsum(vs, axis=1)

    cut = sizes_r.copy()
    decided = np.zeros(len(rows), bool)
    for L in range(max(kmin, 1), Lmax):
        cand_rows = (~decided) & (sizes_r > L)
        if not cand_rows.any():
            break
        ok = cum_v[:, L - 1] >= cfg.cmin
        if L - 1 >= kmin:
            # recorded-ness: drop the prefix's value-order last member
            # ((value asc, weight desc, name asc) max) — tournament over L
            bv = vs[:, 0].copy()
            bw = ws[:, 0].copy()
            bn = ns[:, 0].copy()
            for j in range(1, L):
                after = (vs[:, j] > bv) | (
                    (vs[:, j] == bv)
                    & ((ws[:, j] < bw) | ((ws[:, j] == bw) & (ns[:, j] > bn)))
                )
                bv = np.where(after, vs[:, j], bv)
                bw = np.where(after, ws[:, j], bw)
                bn = np.where(after, ns[:, j], bn)
            ok = ok & (cum_v[:, L - 1] - bv < cfg.cmin)
        hit = cand_rows & ok
        cut[hit] = L
        decided |= hit

    # scatter the chosen prefixes: position < cut (over the sorted order)
    keep = np.arange(Lmax)[None, :] < cut[:, None]
    sel_rows = np.repeat(rows, Lmax)[keep.ravel()]
    sel_regions = ms.ravel()[keep.ravel()]
    chosen[sel_rows, sel_regions] = True
    return ComboResult(chosen, errors, fallback)
