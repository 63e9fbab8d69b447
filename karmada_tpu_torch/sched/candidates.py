"""Top-K candidate sparsification: the compact [B, K] round (PyTorch port
of sched/candidates.py).

One candidate-select launch makes the single [B, C] pass (filters + static
score), keeps each row's top-K candidate clusters by the key
`(feasible << 33) + score` in (key desc, column asc) order — every feasible
cluster outranks every infeasible one — and gathers everything the
division tail consumes to [B, K]: feasibility, score, previous replicas,
estimator answers and splitmix64 tie values, plus the exact feasible count
and the complete packed feasible mask. Candidate windows are sorted
ascending by global cluster index, so every local-order tie-break sees the
same relative order as the dense solve.

Then one division-tail launch per row class (static/dynamic-weight rows,
Aggregated rows) divides replicas over [rows, K] windows; duplicated and
non-workload rows decode from the packed masks. One device→host sync and
the host decode finish the round.

Spread-constrained rows gather their [rows, K] windows too: a row whose
feasible set fits its window selects on the host over the window
(sched/spread.py) and, when it divides replicas, re-runs the division tail
over the selection; a wider row needs the whole fleet and re-solves through
the dense round. Rounds with a `dense_reason` run the dense round of
sched/core.py instead.

The compact tiered launch of sched/preemption.py (`tiered_k`,
`launch_tiered_compact`) selects candidates once and runs each priority
tier's estimate, tail and capacity consumption over the same windows.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..models.batch import AGGREGATED, DUPLICATED, NON_WORKLOAD, pow2_bucket, shape_bucket
from . import plugins as plugin_mod
from .pipeline import stage_span
from .core import (
    I32,
    I64,
    TOPK_TARGETS,
    ScheduleDecision,
    _pad_rows_idx,
    _sorted_pairs,
    to_device,
    to_device_packed,
)

# default candidate window: covers every row whose feasible set fits 128
# clusters exactly; wider feasible sets solve over their 128 best-scored
# feasible candidates
CANDIDATE_K_DEFAULT = 128

# per-policy opt-out: bindings carrying this annotation (value 1/true/yes/on)
# pin their whole round to the exact dense solve
DENSE_SOLVE_ANNOTATION = "karmada-tpu.io/dense-solve"

_TRUTHY = ("1", "true", "yes", "on")


def resolve_candidate_k(override: Optional[int] = None) -> int:
    """THE candidate-window size: explicit override, else
    KARMADA_TPU_CANDIDATE_K, else CANDIDATE_K_DEFAULT; 0 disables the
    compact path entirely. Malformed env fails loudly."""
    if override is not None:
        val, src = int(override), "candidate_k override"
    else:
        env = os.environ.get("KARMADA_TPU_CANDIDATE_K", "")
        if not env:
            return CANDIDATE_K_DEFAULT
        try:
            val = int(env)
        except ValueError:
            raise ValueError(
                f"KARMADA_TPU_CANDIDATE_K={env!r}: must be an integer"
            ) from None
        src = f"KARMADA_TPU_CANDIDATE_K={env!r}"
    if val < 0:
        raise ValueError(f"{src}: must be >= 0 (0 disables)")
    return val


def compact_width_ok(array) -> bool:
    """The compact path only pays off when the bucketed window is strictly
    narrower than the fleet."""
    k = getattr(array, "candidate_k", 0)
    return k > 0 and len(array.fleet.names) > shape_bucket(max(k, 8))


def dense_reason(array, bindings) -> Optional[str]:
    """Why this round must solve dense — None when the compact path
    engages."""
    if getattr(array, "candidate_k", 0) <= 0:
        return "disabled"
    if not compact_width_ok(array):
        return "small_fleet"
    for rb in bindings:
        md = getattr(rb, "metadata", None)
        ann = getattr(md, "annotations", None)
        if ann and ann.get(DENSE_SOLVE_ANNOTATION, "").lower() in _TRUTHY:
            return "policy"
    return None


def note_fallback(reason: str, n: int = 1) -> None:
    """Count a dense fallback (karmada_candidate_fallback_total{reason});
    "disabled" is configuration, not a fallback."""
    if reason == "disabled":
        return
    from ..metrics import candidate_fallback

    candidate_fallback.inc(n, reason=reason)


def effective_k(array, raw, n_cols: int) -> int:
    """Per-round effective window, on the shape_bucket lattice. With the
    ClusterAffinity plugin enabled, feasible ⊆ affinity mask, so the
    batch's max affinity popcount is a lossless shrink."""
    k = array.candidate_k
    if (array._plugin_bits & plugin_mod.BIT_AFFINITY) and raw.aff_masks.size:
        pc = raw.aff_masks.sum(axis=1)
        bound = int(pc[raw.aff_idx].max(initial=0))
        if 0 < bound < k:
            k = bound
    return min(shape_bucket(max(k, 8)), n_cols)


def compact_estimate(
    capacity, has_summary, req_unique, req_idx, replicas, unknown_request,
    cand_idx, c_extra,
):
    """GeneralEstimator answers AT the candidate positions: the [U, C]
    unique-request solve, double-gathered to [B, K], then the per-row
    clamps in the reference's order (`_compact_estimate`). c_extra is the
    registered-estimator answer gathered to [B, K], or None."""
    from ..ops import assign as assign_ops

    est_u, any_u = assign_ops.general_estimate_unique(capacity, has_summary, req_unique)
    ridx = req_idx.long()
    cand = cand_idx.long()
    est = est_u[ridx[:, None], cand]  # i64[B,K]
    any_req = any_u[ridx]
    replicas64 = replicas.to(I64)[:, None]
    est = torch.where(any_req[:, None], est, replicas64)
    est = torch.where(has_summary[cand], est, 0)
    est = torch.where(est >= assign_ops.I32_MAX, replicas64, est)
    c_avail = est.to(I32)
    c_avail = torch.where(unknown_request[:, None], 0, c_avail)
    if c_extra is not None:
        c_avail = torch.where(c_extra >= 0, torch.minimum(c_avail, c_extra), c_avail)
    return c_avail.to(I32)


def launch_candidates(array, bindings: Sequence, extra_avail=None, term_indices=None) -> dict:
    """LAUNCH half of the compact round: classify + permute rows by class,
    encode, run the candidate-select kernel (ONE [B, C] launch, the
    estimator answers `extra_avail` min-merged at the window, the
    out-of-tree plugins' mask and score applied to every column), then the
    division-tail kernel per row class over [rows, K] windows. No device
    sync here."""
    if not bindings:
        return {"candidates": True, "n_real": 0}
    with stage_span("encode", array.stage_timer):
        bindings, cls, order, raw, t, (s_batched, _cfg, s_fallback), extra, _terms = (
            array._encode_round(bindings, extra_avail, term_indices))
        spread_rows = sorted(set(s_batched) | set(s_fallback))
        k = effective_k(array, raw, len(array.fleet.names))
    with stage_span("solve", array.stage_timer):
        return _solve_candidates(array, bindings, cls, order, raw, t, spread_rows, extra, k,
                                 term_indices)


def _solve_candidates(array, bindings, cls, order, raw, t, spread_rows, extra, k,
                      term_indices) -> dict:
    """The compact round's kernel dispatch (the `solve` stage)."""
    from ..metrics import candidate_k as candidate_k_gauge

    n_real = len(bindings)
    dev = array.device

    # the round's row ids (the tails' padded lists, the mask and spread
    # rows) go up in one pinned copy before the select, so the host never
    # waits on it
    tail_rows = []
    for want_cls, has_agg in ((1, False), (2, True)):
        rows = [b for b in range(n_real) if cls[b] == want_cls]
        if rows:
            tail_rows.append((rows, has_agg))
    spread_set = set(spread_rows)
    mask_rows = [b for b in range(n_real) if cls[b] == 0 and b not in spread_set]
    ids = [_pad_rows_idx(rows, array._bucket)[0] for rows, _ in tail_rows]
    ids += [rows for rows in (mask_rows, spread_rows) if rows]
    ids = to_device_packed([np.asarray(r, np.int64) for r in ids], dev) if ids else []
    tail_ids, rest = ids[:len(tail_rows)], ids[len(tail_rows):]
    mask_ids = rest.pop(0) if mask_rows else None
    spread_ids = rest.pop(0) if spread_rows else None

    (cand_idx, c_feas, c_score, c_avail, c_prev, c_tie, dev_fc,
     dev_packed) = array._candidate_select(t, k, packed=bool(mask_rows))
    candidate_k_gauge.set(float(k), bucket=str(k))

    # ---- division tails per sub-class over [rows, K] ----
    tails = []
    for (rows, has_agg), rsel in zip(tail_rows, tail_ids):
        max_repl = int(raw.replicas[rows].max(initial=0))
        topk = min(pow2_bucket(min(max_repl, TOPK_TARGETS), lo=8), TOPK_TARGETS)
        t_cand = cand_idx.index_select(0, rsel)
        t_out = kernels.candidate_tail(
            c_feas.index_select(0, rsel), c_avail.index_select(0, rsel),
            c_prev.index_select(0, rsel), c_tie.index_select(0, rsel), t_cand,
            t["weight_tables"], t["weight_idx"].index_select(0, rsel),
            t["strategy"].index_select(0, rsel), t["replicas"].index_select(0, rsel),
            t["fresh"].index_select(0, rsel),
            topk=topk, has_agg=has_agg,
        )
        tails.append({"rows": rows, "t_out": t_out, "t_cand": t_cand})

    # ---- duplicated / non-workload rows: complete packed feasible masks ----
    mask_pack = None if mask_ids is None else dev_packed.index_select(0, mask_ids)

    # ---- spread rows: their candidate windows (the selection runs on the
    # host at materialize over these compact gathers) ----
    spread_fetch = []
    if spread_ids is not None:
        spread_fetch = [a.index_select(0, spread_ids)
                        for a in (cand_idx, c_feas, c_score, c_avail, c_prev, c_tie)]

    return {
        "candidates": True, "bindings": bindings, "raw": raw, "t": t, "extra": extra,
        "cls": cls,
        "order": order, "n_real": n_real, "k": k,
        "term_indices": None if term_indices is None else [term_indices[i] for i in order],
        "dev_fc": dev_fc, "tails": tails, "mask_rows": mask_rows, "mask_pack": mask_pack,
        "spread_rows": spread_rows, "spread_fetch": spread_fetch,
    }


def materialize_candidates(array, p: dict) -> list[ScheduleDecision]:
    """MATERIALIZE half: ONE device→host copy, decode, unpermute."""
    if p["n_real"] == 0:
        return []
    with stage_span("materialize", array.stage_timer):
        return _materialize_inner(array, p)


def _materialize_inner(array, p: dict) -> list[ScheduleDecision]:
    n_real = p["n_real"]
    bindings, raw, cls, order, k = p["bindings"], p["raw"], p["cls"], p["order"], p["k"]
    names = array.fleet.names
    C = len(names)

    # ---- THE sync ----
    host = [p["dev_fc"]] + [x for tl in p["tails"] for x in tl["t_out"][1:]]
    if p["mask_pack"] is not None:
        host.append(p["mask_pack"])
    n_spread = len(p["spread_fetch"])
    host = [x.cpu().numpy() for x in host + p["spread_fetch"]]
    host, spread_host = host[:len(host) - n_spread], host[len(host) - n_spread:]
    feas_count = host[0][:n_real].astype(np.int64)

    # truncation accounting: only rows solved THROUGH the window can drop
    # feasible candidates (divided rows; spread rows wider than the window
    # re-solve dense and count as fallbacks)
    div_rows = cls > 0
    trunc = int(np.maximum(feas_count[div_rows] - k, 0).sum()) if div_rows.any() else 0
    if trunc:
        from ..metrics import candidate_truncations

        candidate_truncations.inc(trunc)
    array.last_candidate_stats = {"candidate_k": k, "candidate_truncations": trunc}

    unsched = np.zeros(n_real, bool)
    avail_sum = np.zeros(n_real, np.int64)
    feas_count_ovr: dict[int, int] = {}
    row_err: dict[int, str] = {}
    row_target_src: dict[int, tuple] = {}
    row_feas_src: dict[int, tuple] = {}
    wide_dec: dict[int, ScheduleDecision] = {}

    # ---- division tails ----
    for i, tl in enumerate(p["tails"]):
        t_unsched, t_asum, t_nnz, t_ti, t_tv = host[1 + 5 * i: 6 + 5 * i]
        tis, tvs = _sorted_pairs(t_ti, t_tv)  # t_ti is GLOBAL
        overflow = []
        for j, b in enumerate(tl["rows"]):
            unsched[b] = bool(t_unsched[j])
            avail_sum[b] = int(t_asum[j])
            n = int(t_nnz[j])
            if n > t_ti.shape[1]:
                overflow.append((j, b))
                continue
            row_target_src[b] = ("pairs", names, tis[j, :n], tvs[j, :n])
        if overflow:
            ks = torch.tensor([j for j, _ in overflow], device=array.device)
            o_res = tl["t_out"][0].index_select(0, ks).cpu().numpy()
            o_cand = tl["t_cand"].index_select(0, ks).cpu().numpy()
            for m, (_, b) in enumerate(overflow):
                pos = np.nonzero(o_res[m] > 0)[0]
                row_target_src[b] = (
                    "pairs", names, o_cand[m, pos].astype(np.int64),
                    o_res[m, pos].astype(np.int64),
                )

    # ---- duplicated / non-workload rows: complete packed masks ----
    if p["mask_rows"]:
        packed_h = host[-1]
        for j, b in enumerate(p["mask_rows"]):
            if feas_count[b] <= 0:
                continue  # FitError branch
            reps = array._mask_replicas(raw, bindings, b)
            row_feas_src[b] = ("mask", names, packed_h[j], C)
            row_target_src[b] = ("mask", names, packed_h[j], C, reps)

    # ---- spread rows: exact per-row selection over the candidate set ----
    if p["spread_rows"]:
        wide_dec = _spread_over_candidates(
            array, p, spread_host, feas_count, unsched, avail_sum, feas_count_ovr,
            row_err, row_target_src, row_feas_src,
        )

    # ---- build decisions, then unpermute ----
    out: list[Optional[ScheduleDecision]] = [None] * n_real
    for b, key in enumerate(raw.keys):
        if b in wide_dec:
            out[int(order[b])] = wide_dec[b]
            continue
        dec = ScheduleDecision(key=key)
        if b in row_feas_src:
            dec._feasible_src = row_feas_src[b]
        if b in row_err:
            dec.error = row_err[b]
        elif feas_count_ovr.get(b, feas_count[b]) == 0:
            dec.error = f"0/{array.n_real_clusters} clusters are available"
        elif unsched[b]:
            dec.error = (
                f"Clusters available replicas {int(avail_sum[b])} are not "
                "enough to schedule."
            )
        elif b in row_target_src:
            dec._targets_src = row_target_src[b]
        else:
            raise AssertionError(
                "compact schedule round produced no decode source for live "
                f"row {key!r} (class {int(cls[b])}, strategy "
                f"{int(raw.strategy[b])})"
            )
        out[int(order[b])] = dec
    return out


def _spread_over_candidates(
    array, p, fetch, feas_count, unsched, avail_sum, feas_count_ovr, row_err,
    row_target_src, row_feas_src,
) -> dict[int, ScheduleDecision]:
    """Spread constraints evaluated over CANDIDATE sets: whenever a row's
    feasible set fits the window, the window holds every feasible cluster
    and the per-row exact selection (sched/spread.py, the semantic spec)
    runs on the compact arrays — the inputs the dense fallback would pass,
    gathered instead of fetched dense. Rows whose feasible set outruns the
    window need full-fleet visibility: they re-solve through the dense
    round and their finished decisions merge in by position."""
    from . import spread as spread_mod

    bindings, raw, t = p["bindings"], p["raw"], p["t"]
    names = array.fleet.names
    k = p["k"]
    s_cand, s_feas, s_score, s_avail, s_prev, s_tie = fetch
    wide: list[int] = []
    live_div: list[tuple[int, int, np.ndarray]] = []  # (fetch row, round row, sel)
    for j, b in enumerate(p["spread_rows"]):
        if feas_count[b] == 0:
            continue  # FitError branch
        if feas_count[b] > k:
            wide.append(b)
            continue
        f = np.flatnonzero(s_feas[j])
        gidx = s_cand[j, f].astype(np.int64)
        rb = bindings[b]
        try:
            selected_idx = spread_mod.select_by_spread_arrays(
                gidx,
                s_score[j, f],
                s_avail[j, f].astype(np.int64) + s_prev[j, f],
                array._name_rank[gidx],
                array._region_id[gidx],
                array._region_names,
                rb.spec.placement,
                rb.spec.replicas,
            )
        except spread_mod.SpreadError as e:
            row_err[b] = str(e)
            continue
        sel_sorted = np.sort(np.asarray(selected_idx, np.int64))
        # the dense fallback re-runs the solve with the selection folded
        # into the feasibility mask, so its feasible set IS the selection —
        # mirror that exactly
        row_feas_src[b] = ("idx", names, sel_sorted)
        feas_count_ovr[b] = len(sel_sorted)
        strat = int(raw.strategy[b])
        if strat == NON_WORKLOAD:
            row_target_src[b] = (
                "pairs", names, sel_sorted, np.zeros(len(sel_sorted), np.int64),
            )
        elif strat == DUPLICATED:
            row_target_src[b] = (
                "pairs", names, sel_sorted,
                np.full(len(sel_sorted), int(rb.spec.replicas), np.int64),
            )
        else:
            live_div.append((j, b, np.isin(s_cand[j], sel_sorted)))

    if live_div:
        # the division tail re-runs over the windows restricted to the selection
        dev = array.device
        jks = np.asarray([j for j, _, _ in live_div])
        d_rows = [b for _, b, _ in live_div]
        d_feas = s_feas[jks] & np.stack([sel for _, _, sel in live_div])
        rsel = to_device(np.asarray(d_rows, np.int64), dev)
        max_repl = int(raw.replicas[d_rows].max(initial=0))
        topk = min(pow2_bucket(min(max_repl, TOPK_TARGETS), lo=8), TOPK_TARGETS)

        t_out = kernels.candidate_tail(
            *(to_device(a, dev) for a in (d_feas, s_avail[jks], s_prev[jks], s_tie[jks],
                                          s_cand[jks])),
            t["weight_tables"], t["weight_idx"].index_select(0, rsel),
            t["strategy"].index_select(0, rsel), t["replicas"].index_select(0, rsel),
            t["fresh"].index_select(0, rsel),
            topk=topk, has_agg=bool((raw.strategy[d_rows] == AGGREGATED).any()),
        )
        d_res, d_unsched, d_asum, d_nnz, d_ti, d_tv = (x.cpu().numpy() for x in t_out)
        tis, tvs = _sorted_pairs(d_ti, d_tv)
        d_cand = s_cand[jks]
        for m, b in enumerate(d_rows):
            unsched[b] = bool(d_unsched[m])
            avail_sum[b] = int(d_asum[m])
            feas_count_ovr[b] = int(d_feas[m].sum())
            n = int(d_nnz[m])
            if n > d_ti.shape[1]:
                pos = np.nonzero(d_res[m] > 0)[0]
                row_target_src[b] = (
                    "pairs", names, d_cand[m, pos].astype(np.int64),
                    d_res[m, pos].astype(np.int64),
                )
            else:
                row_target_src[b] = ("pairs", names, tis[m, :n], tvs[m, :n])

    out: dict[int, ScheduleDecision] = {}
    if wide:
        note_fallback("spread_constraint", len(wide))
        terms, extra = p["term_indices"], p["extra"]
        sub_dec = array._schedule_once_partitioned(
            [bindings[b] for b in wide],
            None if extra is None else extra[wide],
            None if terms is None else [terms[b] for b in wide],
        )
        out.update(zip(wide, sub_dec))
    return out


# --------------------------------------------------------------------------
# the compact tiered launch (sched/preemption.py routes here)
# --------------------------------------------------------------------------


def tiered_k(array, raw, n_cols: int) -> int:
    """Effective window for a tiered or speculative batch, or 0 for dense:
    the width gate plus a Duplicated-row exclusion (a Duplicated row's
    target set IS its feasible set, which a window would truncate; the
    tiered launch has no packed-mask side channel)."""
    if not compact_width_ok(array):
        return 0
    if bool((np.asarray(raw.strategy) == DUPLICATED).any()):
        return 0
    return effective_k(array, raw, n_cols)


def launch_tiered_compact(array, t, tier_rows, capacity, tiers, reclaim, spec_tiers, *,
                          k: int, topk: int, has_agg: bool):
    """The compact tiered launch (the reference's `_tiered_candidate_kernel`,
    B12): candidate_select once (feasibility and score do not depend on
    capacity; its c_avail is tier 0's estimate), then per tier
    tier_estimate over the tier's rows' windows (a later tier's main and
    speculative passes in one launch), candidate_tail over those rows,
    and tier_consume scattering the placements through cand_idx, the tier
    launches through the round's launcher `tiers`
    (`kernels.tier_launcher`) in window mode. The estimator answers
    `t["extra_avail"]` (or None) min-merge into every main pass and never
    into the speculative one. Output windows are min(k, topk) wide.
    Returns (feas_count, main outputs, speculative outputs, cand_idx)."""
    from .preemption import run_tiers

    (cand_idx, c_feas, _c_score, c_avail, c_prev, c_tie, feas_count,
     _packed) = array._candidate_select(t, k, capacity=capacity, packed=False)
    tiers.window_mode(cand_idx)

    def estimate(cap, rows, rows64, first, use_extra):
        if first and use_extra:
            return c_avail.index_select(0, rows64)
        return tiers.estimate(cap, rows, use_extra=use_extra)

    def tail(av, _rows, rows64):
        def g(x):
            return x.index_select(0, rows64)

        return kernels.candidate_tail(
            g(c_feas), av, g(c_prev), g(c_tie), g(cand_idx), t["weight_tables"],
            g(t["weight_idx"]), g(t["strategy"]), g(t["replicas"]), g(t["fresh"]),
            topk=topk, has_agg=has_agg,
        )

    def consume(cap, outs, rows):
        return tiers.consume(cap, outs[0], outs[1], rows)

    main, aug = run_tiers(tier_rows, len(t["replicas"]), capacity, reclaim, spec_tiers,
                          t["extra_avail"] is not None, estimate, tail, consume,
                          estimate_pair=tiers.estimate_pair)
    return feas_count, main, aug, cand_idx
