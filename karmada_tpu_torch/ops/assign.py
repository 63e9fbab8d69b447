"""Replica-division algorithms as batched tensor programs (plain PyTorch).

Port of ops/assign.py: all B bindings are divided over C (or K window)
clusters in one pass of [B,C] integer tensors. Everything is int64, like
the reference with x64 on; casts to int32 wrap the same way.

Semantics parity notes (bit-exact targets):
- TakeByWeight: per-cluster quota = floor(weight * target / sum_weights)
  (int64 math), then +1 to the first `remain` clusters in the order
  (weight desc, lastReplicas desc, tie asc, column asc) — binding.go:118-144,
  with the crypto-rand tie-break replaced by the UID-seeded `tie` array.
- Dynamic strategies (division_algorithm.go:75-152): Steady scale-up
  dispenses only the delta with previous clusters as init; scale-down
  re-dispenses target with weights = previous result; Fresh recomputes with
  weights = available + own previous replicas. Aggregated first truncates the
  (prior-first, availability-descending) cluster order at the cumulative-
  capacity prefix covering the target.
- Unschedulable when sum(available) < target (division_algorithm.go:76-78).

The multi-key orders are total orders with the column as the last key.
torch.sort with stable=True applied least-significant key first gives
exactly that lexicographic order (the column is the initial order).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

I32_MAX = 2**31 - 1

I64 = torch.int64
I32 = torch.int32


def _lex_order(key1, key2):
    """Column permutation sorting each row ascending by (key1, key2, col):
    stable sorts, least significant key first."""
    o = torch.sort(key2, dim=-1, stable=True).indices
    o2 = torch.sort(key1.gather(-1, o), dim=-1, stable=True).indices
    return o.gather(-1, o2)


def _pack_last_tie(last, tie):
    """(last desc, tie asc) as ONE ascending i64 key — both inputs are i32."""
    return ((I32_MAX - last.to(I64)) << 32) | tie.to(I64)


def _cutoff_le(key1, key2, iota, k1s, k2s, ios, k):
    """mask of columns whose (key1, key2, iota) triple sorts at or before the
    sorted cutoff element at position k-1 — i.e. the first k positions of the
    total order, selected by ONE elementwise compare instead of a rank."""
    C = key1.shape[-1]
    idx = (k - 1).clamp(0, C - 1).to(I64)[:, None]
    c1 = k1s.gather(-1, idx)
    c2 = k2s.gather(-1, idx)
    co = ios.gather(-1, idx)
    le = (key1 < c1) | ((key1 == c1) & ((key2 < c2) | ((key2 == c2) & (iota <= co))))
    return le & (k > 0)[:, None]


def _first_k_mask(key1, key2, k):
    """mask[b,c] = True iff c is among the first k[b] columns of row b in
    ascending (key1, key2, col-index) order."""
    B, C = key1.shape
    iota = torch.arange(C, device=key1.device).expand(B, C)
    o = _lex_order(key1, key2)
    return _cutoff_le(key1, key2, iota, key1.gather(-1, o), key2.gather(-1, o), o, k)


def take_by_weight(
    weight,  # i64[B,C] (0 = not in the weight list)
    last,  # i32[B,C] previous replicas (tie-break inertia, binding.go:70-73)
    tie,  # i32[B,C] deterministic pseudo-random tie-break
    target,  # i32[B]
    init,  # i32[B,C] dispenser init result (prev clusters on scale-up)
):
    """Vectorized Dispenser.TakeByWeight. Returns (result i32[B,C],
    remain i32[B]); remain == target where sum(weight) == 0."""
    weight = weight.to(I64)
    target64 = target.to(I64)
    sum_w = weight.sum(-1)
    safe_sum = sum_w.clamp(min=1)
    quota = torch.div(weight * target64[:, None], safe_sum[:, None], rounding_mode="floor")
    rem = target64 - quota.sum(-1)
    bonus = _first_k_mask(-weight, _pack_last_tie(last, tie), rem) & (weight > 0)
    result = (quota + bonus.to(I64)).to(I32)
    ok = sum_w > 0
    result = torch.where(ok[:, None], result, 0).to(I32)
    remain = torch.where(ok, 0, target).to(I32)
    return (init + result).to(I32), remain


def _aggregated_keep(prior, weight, tgt):
    """Aggregated truncation mask: keep the shortest (prior desc, weight
    desc, col-index asc) prefix whose cumulative capacity covers tgt."""
    B, C = weight.shape
    iota = torch.arange(C, device=weight.device).expand(B, C)
    key1 = -prior.to(I64)
    key2 = -weight.to(I64)
    o = _lex_order(key1, key2)
    ws = weight.to(I64).gather(-1, o)
    cum = ws.cumsum(-1)
    keep_sorted = (cum - ws) < tgt[:, None]  # strictly before coverage
    k = keep_sorted.sum(-1)
    return _cutoff_le(key1, key2, iota, key1.gather(-1, o), key2.gather(-1, o), o, k)


def duplicated_assign(feasible, replicas):
    """assignByDuplicatedStrategy (assignment.go:176-182): every candidate
    gets the full spec.replicas."""
    return torch.where(feasible, replicas[:, None], 0).to(I32)


class DynamicResult(NamedTuple):
    result: torch.Tensor  # i32[B,C]
    unschedulable: torch.Tensor  # bool[B]
    available_sum: torch.Tensor  # i32[B] (for the Unschedulable message)


def combined_assign(
    feasible,  # bool[B,C]
    is_static,  # bool[B] strategy == STATIC_WEIGHT
    is_dyn,  # bool[B] DYNAMIC_WEIGHT | AGGREGATED
    aggregated,  # bool[B]
    raw_weight,  # i64[B,C] static weight tables
    avail,  # i32[B,C]
    prev,  # i32[B,C]
    tie,  # i32[B,C]
    replicas,  # i32[B]
    fresh,  # bool[B]
    has_agg: bool = True,  # batch contains Aggregated rows
) -> DynamicResult:
    """Static-weight AND dynamic rows through ONE dispenser pass (the two
    strategies are row-disjoint, so their (weight, last, init, target)
    inputs row-select into a single take_by_weight). The reference's
    `narrow` flag (i32 sort keys for TPU sort width) is dropped: the keys
    stay int64, which gives the same order and so the same decisions."""
    # --- static inputs (assignment.go:194-206) ---
    w_static = torch.where(feasible, raw_weight.to(I64), 0)
    all_zero = w_static.sum(-1) == 0
    w_static = torch.where(all_zero[:, None] & feasible, 1, w_static)
    last_static = torch.where(feasible, prev, 0).to(I32)

    # --- dynamic inputs (assignment.go:208-239) ---
    avail_m = torch.where(feasible, avail.to(I64), 0)
    prev_m = torch.where(feasible, prev.to(I64), 0)
    assigned = prev_m.sum(-1)
    target_spec = replicas.to(I64)
    down = ~fresh & (assigned > target_spec)
    up = ~fresh & (assigned < target_spec)
    eq = ~fresh & (assigned == target_spec)
    w_dyn = torch.where(
        fresh[:, None], avail_m + prev_m, torch.where(down[:, None], prev_m, avail_m)
    )
    init_dyn = torch.where(up[:, None], prev_m, 0).to(I32)
    tgt_dyn = torch.where(up, target_spec - assigned, target_spec)
    avail_sum = w_dyn.sum(-1)
    unsched = is_dyn & ~eq & (avail_sum < tgt_dyn)

    if has_agg:
        prior = up[:, None] & (prev_m > 0)
        keep = _aggregated_keep(prior, w_dyn, tgt_dyn)
        do_trunc = (aggregated & ~eq)[:, None]
        w_dyn = torch.where(do_trunc & ~keep, 0, w_dyn)
    last_dyn = torch.where(up[:, None], prev_m, 0).to(I32)

    # --- row-select into ONE dispense ---
    sm = is_static[:, None]
    weight = torch.where(sm, w_static, w_dyn)
    last = torch.where(sm, last_static, last_dyn)
    init = torch.where(sm, 0, init_dyn).to(I32)
    tgt = torch.where(is_static, target_spec, tgt_dyn).to(I32)
    dispensed, _ = take_by_weight(weight, last, tie, tgt, init)

    result = torch.where((is_dyn & eq)[:, None], prev_m.to(I32), dispensed)
    result = torch.where(unsched[:, None], 0, result).to(I32)
    return DynamicResult(result, unsched, avail_sum.to(I32))


def general_estimate_unique(capacity, has_summary, request_u):
    """The [U,C] core of the GeneralEstimator over UNIQUE request vectors
    (general.go:96-114): min over requested resources of cap // req, 0 where
    a requested resource has cap <= 0. Returns (est i64[U,C], any_req
    bool[U])."""
    has_req = request_u > 0  # [U,R]
    cap = capacity[None, :, :].to(I64)
    req = request_u.clamp(min=1)[:, None, :].to(I64)
    big = 2**62
    per_res = torch.where(
        has_req[:, None, :], torch.div(cap, req, rounding_mode="floor"), big
    )
    per_res = torch.where(has_req[:, None, :] & (cap <= 0), 0, per_res)
    if per_res.shape[-1] == 0:
        est_u = torch.full(per_res.shape[:2], big, dtype=I64, device=cap.device)
    else:
        est_u = per_res.min(-1).values
    return est_u, has_req.any(-1)


def general_estimate_apply(est_u, any_req_u, req_idx, has_summary, replicas):
    """Row gather of `general_estimate_unique` to [B,C] plus the per-row
    clamps, in the reference's order: no requested resource -> replicas, no
    summary -> 0, >= INT32_MAX -> replicas, then the i32 cast."""
    ridx = req_idx.long()
    est = est_u[ridx]  # i64[B,C]
    replicas64 = replicas.to(I64)[:, None]
    est = torch.where(any_req_u[ridx][:, None], est, replicas64)
    est = torch.where(has_summary[None, :], est, 0)
    est = torch.where(est >= I32_MAX, replicas64, est)
    return est.to(I32)
