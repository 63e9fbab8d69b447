"""Scheduler filter plugins as batched boolean masks (plain PyTorch).

The six in-tree plugins (plugins/registry.go:30-39) become one fused [B,C]
mask computation. These are the plain versions of the filter terms the
candidate-select kernel (kernels/csrc/candidate_select.cu) evaluates per
column; the scheduler's CPU path and the parity tests run them.

Plugin → mask:
- APIEnablement  (api_enablement.go:52)       → api_mask
- TaintToleration (taint_toleration.go:52)    → taint_mask (NoSchedule +
  NoExecute taints must be tolerated; PreferNoSchedule is score-only and
  ignored by the filter)
- ClusterAffinity (cluster_affinity.go:51-80) → host-evaluated affinity mask
- ClusterEviction (cluster_eviction.go:50)    → eviction mask
- aliveness (scheduler watches only joined+ready clusters)
"""
from __future__ import annotations

import torch

# toleration operator codes
TOL_OP_NONE = 0
TOL_OP_EQUAL = 1
TOL_OP_EXISTS = 2

# effect codes (models/fleet.py EFFECT_CODES)
EFF_NO_SCHEDULE = 1
EFF_PREFER_NO_SCHEDULE = 2
EFF_NO_EXECUTE = 3


def taint_toleration_mask(
    taint_key,  # i32[C,T] (0 = no taint in slot)
    taint_value,  # i32[C,T]
    taint_effect,  # i32[C,T]
    tol_key,  # i32[B,K] (0 = empty key)
    tol_value,  # i32[B,K]
    tol_effect,  # i32[B,K] (0 = matches all effects)
    tol_op,  # i32[B,K]
):
    """ok[b,c] ⇔ every NoSchedule/NoExecute taint of c is tolerated by some
    toleration of b (corev1 toleration semantics via
    plugins/tainttoleration/taint_toleration.go:52)."""
    B = tol_key.shape[0]
    C, T = taint_key.shape
    active = (taint_effect == EFF_NO_SCHEDULE) | (taint_effect == EFF_NO_EXECUTE)
    has_tol = tol_op != TOL_OP_NONE  # [B,K]
    tk_, tv_, te_, to_ = (x[:, None, :] for x in (tol_key, tol_value, tol_effect, tol_op))
    ok = torch.ones((B, C), dtype=torch.bool, device=tol_key.device)
    for t in range(T):
        tk = taint_key[:, t][None, :, None]
        tv = taint_value[:, t][None, :, None]
        te = taint_effect[:, t][None, :, None]
        key_match = (tk_ == tk) | ((tk_ == 0) & (to_ == TOL_OP_EXISTS))
        effect_match = (te_ == 0) | (te_ == te)
        value_match = (to_ == TOL_OP_EXISTS) | (tv_ == tv)
        tolerated = (has_tol[:, None, :] & key_match & effect_match & value_match).any(-1)
        ok &= ~active[None, :, t] | tolerated
    return ok


def api_enablement_mask(api_ok, gvk):
    """ok[b,c] ⇔ cluster c advertises binding b's GVK (api_enablement.go:52).
    api_ok: bool[C,G]; gvk: i32[B]. A GVK id minted after the fleet encoding
    (gvk >= G) is advertised by no cluster."""
    C, G = api_ok.shape
    if G == 0:
        return torch.zeros((gvk.shape[0], C), dtype=torch.bool, device=api_ok.device)
    ok = api_ok.T[gvk.clamp(0, G - 1).long()]  # [B,C]
    return ok & (gvk < G)[:, None]


def feasible_mask(alive, api_mask, taint_mask, affinity_ok, eviction_ok):
    """The fused findClustersThatFit (generic_scheduler.go:118-141)."""
    return alive[None, :] & api_mask & taint_mask & affinity_ok & eviction_ok


def locality_score(prev_member):
    """ClusterLocality score plugin (cluster_locality.go:50): 100 for
    clusters already in spec.clusters, else 0. Other in-tree score plugins
    return constant 0, so total score = locality."""
    return torch.where(prev_member, 100, 0).to(torch.int32)
