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

Spread-constrained rows, a path of the reference outside this slice,
raise NotImplementedError. Rounds with a `dense_reason` run the dense round
of sched/core.py instead.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..models.batch import pow2_bucket, shape_bucket
from . import plugins as plugin_mod
from .core import (
    I32,
    I64,
    TOPK_TARGETS,
    ScheduleDecision,
    _pad_rows_idx,
    _sorted_pairs,
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


def _rows_tensor(rows: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rows, np.int64)).to(device)


def launch_candidates(array, bindings: Sequence, term_indices=None) -> dict:
    """LAUNCH half of the compact round: classify + permute rows by class,
    encode, run the candidate-select kernel (ONE [B, C] launch), then the
    division-tail kernel per row class over [rows, K] windows. No device
    sync here."""
    n_real = len(bindings)
    if n_real == 0:
        return {"candidates": True, "n_real": 0}
    C = len(array.fleet.names)
    dev = array.device

    bindings, cls, order, raw, t = array._encode_round(bindings, term_indices)
    k = effective_k(array, raw, C)
    f = array._fleet_dev

    (cand_idx, c_feas, _c_score, c_avail, c_prev, c_tie, dev_fc,
     dev_packed) = kernels.candidate_select(
        f["alive"], f["capacity"], f["has_summary"], f["taint_key"],
        f["taint_value"], f["taint_effect"], f["api_ok"],
        t["replicas"], t["unknown_request"], t["gvk"],
        t["tol_tables"], t["tol_idx"], t["aff_masks"], t["aff_idx"],
        t["prev_idx"], t["prev_rep"], t["evict_idx"], t["seeds"],
        t["req_unique"], t["req_idx"], None,
        k=k, plugin_bits=array._plugin_bits,
    )

    # ---- division tails per sub-class over [rows, K] ----
    tails = []
    for want_cls, has_agg in ((1, False), (2, True)):
        rows = [b for b in range(n_real) if cls[b] == want_cls]
        if not rows:
            continue
        idx_pad, _nr = _pad_rows_idx(rows, array._bucket)
        rsel = _rows_tensor(idx_pad, dev)
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
    mask_rows = [b for b in range(n_real) if cls[b] == 0]
    mask_pack = None
    if mask_rows:
        mask_pack = dev_packed.index_select(0, _rows_tensor(np.asarray(mask_rows), dev))

    return {
        "candidates": True, "bindings": bindings, "raw": raw, "cls": cls,
        "order": order, "n_real": n_real, "k": k, "dev_fc": dev_fc, "tails": tails,
        "mask_rows": mask_rows, "mask_pack": mask_pack,
    }


def materialize_candidates(array, p: dict) -> list[ScheduleDecision]:
    """MATERIALIZE half: ONE device→host copy, decode, unpermute."""
    n_real = p["n_real"]
    if n_real == 0:
        return []
    bindings, raw, cls, order, k = p["bindings"], p["raw"], p["cls"], p["order"], p["k"]
    names = array.fleet.names
    C = len(names)

    # ---- THE sync ----
    host = [p["dev_fc"]] + [x for tl in p["tails"] for x in tl["t_out"][1:]]
    if p["mask_pack"] is not None:
        host.append(p["mask_pack"])
    host = [x.cpu().numpy() for x in host]
    feas_count = host[0][:n_real].astype(np.int64)

    div_rows = cls > 0
    trunc = int(np.maximum(feas_count[div_rows] - k, 0).sum()) if div_rows.any() else 0
    array.last_candidate_stats = {"candidate_k": k, "candidate_truncations": trunc}

    unsched = np.zeros(n_real, bool)
    avail_sum = np.zeros(n_real, np.int64)
    row_target_src: dict[int, tuple] = {}
    row_feas_src: dict[int, tuple] = {}

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

    # ---- build decisions, then unpermute ----
    out: list[Optional[ScheduleDecision]] = [None] * n_real
    for b, key in enumerate(raw.keys):
        dec = ScheduleDecision(key=key)
        if b in row_feas_src:
            dec._feasible_src = row_feas_src[b]
        if feas_count[b] == 0:
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
