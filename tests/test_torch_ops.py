"""The PyTorch port's plain tensor functions held against the JAX
package's, on the same seeded numpy inputs. All integer math: the
tolerance is exact equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from karmada_tpu.models.batch import tie_matrix, uid_seed  # noqa: E402
from karmada_tpu.ops import assign as jassign  # noqa: E402
from karmada_tpu.ops import filters as jfilters  # noqa: E402
from karmada_tpu.sched import candidates as jcand  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.sched import spread_batch as jspread  # noqa: E402

from karmada_tpu_torch.ops import assign as tassign  # noqa: E402
from karmada_tpu_torch.ops import filters as tfilters  # noqa: E402
from karmada_tpu_torch.sched import candidates as tcand  # noqa: E402
from karmada_tpu_torch.sched import core as tcore  # noqa: E402


def T(a):
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def N(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def eq(got, want):
    np.testing.assert_array_equal(N(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_filters_match(seed):
    rng = np.random.default_rng(seed)
    B, C, T_, K, G = 12, 40, 3, 4, 5
    tk = rng.integers(0, 4, (C, T_)).astype(np.int32)
    tv = rng.integers(0, 3, (C, T_)).astype(np.int32)
    te = rng.integers(0, 4, (C, T_)).astype(np.int32)
    ok_ = rng.integers(0, 4, (B, K)).astype(np.int32)
    ov = rng.integers(0, 3, (B, K)).astype(np.int32)
    oe = rng.integers(0, 4, (B, K)).astype(np.int32)
    oo = rng.integers(0, 3, (B, K)).astype(np.int32)
    eq(tfilters.taint_toleration_mask(*map(T, (tk, tv, te, ok_, ov, oe, oo))),
       jfilters.taint_toleration_mask(tk, tv, te, ok_, ov, oe, oo))
    api_ok = rng.random((C, G)) < 0.6
    gvk = rng.integers(0, G + 2, B).astype(np.int32)  # ids past G: advertised nowhere
    eq(tfilters.api_enablement_mask(T(api_ok), T(gvk)),
       jfilters.api_enablement_mask(api_ok, gvk))
    masks = [rng.random((B, C)) < 0.8 for _ in range(4)]
    alive = rng.random(C) < 0.9
    eq(tfilters.feasible_mask(T(alive), *map(T, masks)),
       jfilters.feasible_mask(alive, masks[0], masks[1], np.ones((B, C), bool), masks[2], masks[3]))
    eq(tfilters.locality_score(T(masks[0])), jfilters.locality_score(masks[0]))


def test_filter_phase_over_factored_tolerations():
    """The port's filter_phase computes the taint mask per toleration-table
    row and gathers by tol_idx; the reference takes the dense [B,K] rows."""
    rng = np.random.default_rng(3)
    B, C, T_, K, Tt, G = 16, 48, 2, 3, 4, 3
    tk = rng.integers(0, 3, (C, T_)).astype(np.int32)
    tv = rng.integers(0, 2, (C, T_)).astype(np.int32)
    te = rng.integers(0, 4, (C, T_)).astype(np.int32)
    tol_tables = rng.integers(0, 3, (Tt, 4, K)).astype(np.int32)
    tol_idx = rng.integers(0, Tt, B).astype(np.int32)
    alive = rng.random(C) < 0.9
    api_ok = rng.random((C, G)) < 0.8
    gvk = rng.integers(0, G, B).astype(np.int32)
    aff = rng.random((B, C)) < 0.7
    evict = rng.random((B, C)) < 0.9
    prev = rng.random((B, C)) < 0.1
    tol = tol_tables[tol_idx]
    for bits in (31, 0, 1 | 4, 2 | 8 | 16):
        jf, js = jcore.filter_phase(alive, tk, tv, te, api_ok, gvk, tol[:, 0], tol[:, 1],
                                    tol[:, 2], tol[:, 3], aff, evict, prev, plugin_bits=bits)
        tf, ts = tcore.filter_phase(*map(T, (alive, tk, tv, te, api_ok, gvk, tol_tables, tol_idx,
                                             aff, evict, prev)), plugin_bits=bits)
        eq(tf, jf)
        eq(ts, js)


def _seeds(rng, n):
    s = rng.integers(0, 2**63, n, dtype=np.uint64) | np.uint64(1 << 63)  # top bit set
    s[::3] = rng.integers(0, 2**63, len(s[::3]), dtype=np.uint64)
    return s


def test_tie_at_matches_tie_matrix_and_tie_at():
    rng = np.random.default_rng(7)
    uids = [f"rb-{i}" for i in range(9)]
    seeds = np.array([uid_seed(u) for u in uids], np.uint64)
    C = 300
    cols = np.broadcast_to(np.arange(C), (len(uids), C))
    eq(tcore.tie_at(T(seeds), T(cols)), tie_matrix(uids, C))
    seeds = _seeds(rng, 32)
    cand = np.sort(rng.choice(5000, (32, 64)), axis=1).astype(np.int32)
    eq(tcore.tie_at(T(seeds), T(cand)), jcand._tie_at(jnp.asarray(seeds), jnp.asarray(cand)))


def test_top_k_window_tie_order():
    """jax.lax.top_k keeps the LOWEST index first among equal keys; the
    candidate window must pick the same clusters when feas_count > K."""
    rng = np.random.default_rng(11)
    feas = rng.random((24, 200)) < 0.7
    score = np.where(rng.random((24, 200)) < 0.1, 100, 0).astype(np.int32)
    key = (feas.astype(np.int64) << 33) + score
    for k in (8, 16, 96):
        _, ti = jax.lax.top_k(jnp.asarray(key), k)
        eq(tcore.top_k_ordered(T(key), k), ti)
    eq(tcore.top_k_ordered(T(np.array([[3, 3, 3, 1, 3]])), 3), [[0, 1, 2]])


def _division_case(rng, B, C):
    feas = rng.random((B, C)) < 0.75
    w = rng.choice([0, 1, 2, 2, 2, 5], (B, C)).astype(np.int64)  # many equal weights
    avail = rng.choice([0, 1, 3, 3, 7, 40], (B, C)).astype(np.int32)
    prev = np.where(rng.random((B, C)) < 0.25, rng.integers(1, 5, (B, C)), 0).astype(np.int32)
    tie = rng.integers(0, 4, (B, C)).astype(np.int32)  # forces (last, tie) ties to the column
    replicas = rng.integers(0, 40, B).astype(np.int32)
    assigned = np.where(feas, prev, 0).sum(-1)
    mode = np.arange(B) % 4  # up / down / eq / fresh
    replicas = np.where(mode == 2, assigned, replicas).astype(np.int32)
    replicas = np.where((mode == 1) & (assigned > 1), assigned - 1, replicas).astype(np.int32)
    fresh = mode == 3
    strategy = rng.choice([1, 2, 3, 4], B).astype(np.int32)
    return feas, w, avail, prev, tie, replicas, fresh, strategy


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_take_by_weight_matches(seed):
    rng = np.random.default_rng(seed)
    B, C = 32, 24
    w = rng.choice([0, 1, 1, 3, 3, 9], (B, C)).astype(np.int64)
    last = rng.integers(0, 3, (B, C)).astype(np.int32)
    tie = rng.integers(0, 3, (B, C)).astype(np.int32)
    target = rng.integers(0, 60, B).astype(np.int32)
    init = rng.integers(0, 3, (B, C)).astype(np.int32)
    jr, jrem = jassign.take_by_weight(w, last, tie, target, init)
    tr, trem = tassign.take_by_weight(*map(T, (w, last, tie, target, init)))
    eq(tr, jr)
    eq(trem, jrem)


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregated_keep_matches(seed):
    rng = np.random.default_rng(seed)
    B, C = 32, 20
    prior = rng.random((B, C)) < 0.3
    w = rng.choice([0, 2, 2, 4, 4, 9], (B, C)).astype(np.int64)
    tgt = rng.integers(0, 40, B).astype(np.int64)
    eq(tassign._aggregated_keep(T(prior), T(w), T(tgt)), jassign._aggregated_keep(prior, w, tgt))


@pytest.mark.parametrize("has_agg", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combined_assign_every_mode(seed, has_agg):
    rng = np.random.default_rng(seed)
    feas, w, avail, prev, tie, replicas, fresh, strategy = _division_case(rng, 48, 24)
    if not has_agg:
        strategy = np.where(strategy == 4, 3, strategy).astype(np.int32)
    is_static = strategy == 2
    is_dyn = (strategy == 3) | (strategy == 4)
    agg = strategy == 4
    j = jassign.combined_assign(feas, is_static, is_dyn, agg, w, avail, prev, tie, replicas,
                                fresh, has_agg=has_agg)
    t = tassign.combined_assign(*map(T, (feas, is_static, is_dyn, agg, w, avail, prev, tie,
                                         replicas, fresh)), has_agg=has_agg)
    for a, b in zip(t, j):
        eq(a, b)
    # and through the strategy dispatch
    jres = jcore.assignment_tail(feas, strategy, w, avail, prev, tie, replicas, fresh,
                                 has_agg=has_agg)
    tres = tcore.assignment_tail(*map(T, (feas, strategy, w, avail, prev, tie, replicas, fresh)),
                                 has_agg=has_agg)
    for a, b in zip(tres, jres):
        eq(a, b)


def test_general_estimate_and_compact_estimate():
    rng = np.random.default_rng(5)
    C, R, U, B, K = 30, 4, 5, 10, 8
    cap = rng.integers(-5, 5000, (C, R)).astype(np.int64)
    cap[::4, 1] = 0  # cap <= 0 on a requested resource
    has_summary = rng.random(C) < 0.85
    req_u = rng.integers(0, 300, (U, R)).astype(np.int64)
    req_u[0] = 0  # no request: clamps to replicas
    req_u[1, 1:] = 0
    jest, jany = jassign.general_estimate_unique(cap, has_summary, req_u)
    test, tany = tassign.general_estimate_unique(*map(T, (cap, has_summary, req_u)))
    eq(test, jest)
    eq(tany, jany)
    req_idx = rng.integers(0, U, B).astype(np.int32)
    replicas = rng.integers(1, 50, B).astype(np.int32)
    unknown = rng.random(B) < 0.3  # unknown request names: 0 everywhere
    cand = np.sort(rng.choice(C, (B, K)), axis=1).astype(np.int32)
    extra = rng.integers(-1, 20, (B, K)).astype(np.int32)
    for c_extra in (None, extra):
        want = jcand._compact_estimate(cap, has_summary, req_u, req_idx, replicas, unknown,
                                       cand, c_extra)
        got = tcand.compact_estimate(*map(T, (cap, has_summary, req_u, req_idx, replicas,
                                              unknown, cand)),
                                     None if c_extra is None else T(c_extra))
        eq(got, want)


def test_compact_outputs_and_pack_bits():
    rng = np.random.default_rng(9)
    feas = rng.random((20, 37)) < 0.5
    result = rng.choice([0, 0, 0, 1, 2, 2, 5], (20, 37)).astype(np.int32)
    for topk in (8, 16, 37):
        for a, b in zip(tcore.compact_outputs(T(feas), T(result), topk),
                        jcore.compact_outputs(feas, result, topk)):
            eq(a, b)
    eq(tcore.pack_bits(T(feas)), jspread._pack_bits(feas))
    row = N(tcore.pack_bits(T(feas)))[3]
    eq(tcore.unpack_row(row, 37), np.flatnonzero(feas[3]))


def test_sparse_rows_drop_and_repeat():
    """prev/evict entries out of [0, C) and the C sentinel are dropped; a
    repeated prev column takes the reference scatter's value."""
    C = 10
    prev_idx = np.array([[1, 1, 3, C], [-1, 12, 4, 4], [C, C, C, C]], np.int32)
    prev_rep = np.array([[5, 7, 2, 9], [3, 3, 6, 8], [1, 1, 1, 1]], np.int32)
    evict = np.array([[3, C], [-2, 0], [9, 9]], np.int32)
    rows = np.arange(3)[:, None]
    p = np.where((prev_idx >= 0) & (prev_idx < C), prev_idx, C)
    want_rep = jnp.zeros((3, C), jnp.int32).at[rows, p].set(prev_rep, mode="drop")
    want_mem = jnp.zeros((3, C), bool).at[rows, p].set(True, mode="drop")
    e = np.where((evict >= 0) & (evict < C), evict, C)
    want_ev = jnp.ones((3, C), bool).at[rows, e].set(False, mode="drop")
    mem, rep, ev = tcore.sparse_rows(T(prev_idx), T(prev_rep), T(evict), C)
    eq(mem, want_mem)
    eq(rep, want_rep)
    eq(ev, want_ev)
