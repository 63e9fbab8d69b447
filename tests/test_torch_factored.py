"""The factored forms of the port's dense_filter, sim_filter and
fleet_estimate held against the JAX package.

- dense_filter's tables (the estimate per distinct request with the "row's
  replicas" sentinel, alive and the taints per toleration table, api_ok
  transposed) and the per-row apply that reads them (the score, the
  extra_mask AND, the tie at the column id, the count), the plain mirrors
  of what csrc/dense_filter.cu builds and reads
  (`kernels.dense_filter_tables_plain` / `dense_filter_apply_plain`),
  against the reference's `_filter_kernel_compact` and against
  dense_filter_plain on seeded inputs: no requested resource, no summary,
  unknown requests, estimates at and above INT32_MAX, answers present and
  absent, a prev column listed twice, 3, 5 and 128 columns, every plugin
  and none; and the launch's marshalling of the tables' scratch on a
  faked card.

- sim_filter's estimate table (one row per scenario and distinct request,
  with the "row's replicas" sentinel) and its per-row apply, the plain
  mirrors of what csrc/dense_filter.cu builds and reads
  (`kernels.sim_estimate_table_plain` / `sim_estimate_apply_plain`),
  against the reference's general_estimate_unique + general_estimate_apply
  with the unknown-request clamp and the answers' min-merge: no requested
  resource, no summary, unknown requests, answers at and above INT32_MAX,
  answers present and absent; and against sim_filter_plain's avail.
- csrc/capped_div.cuh's divisions (a float64 estimate corrected by one
  exact step; a divisor's reciprocal, the high word of the product and
  one correction), modelled in Python, against exact integer floors over
  the int64 edges.
- dense_input_filter's group-factored form (per group of 32 rows the
  representatives, the estimate table with its sentinel and the
  column-ok table, then each row's masks and clamps;
  `kernels.dense_input_filter_groups_plain`) against the reference's
  filter_estimate_phase over dense inputs with the answers' min-merge and
  dense_input_filter_plain: rows all equal and all distinct, equal
  requests apart, toleration rows one field apart, rows past the last
  group, zero and absent requests, no summary, unknown requests,
  estimates at and above INT32_MAX with no answers, 3, 5 and 128
  columns; a model of the kernel's kept entries across groups; and the
  launch's marshalling on a faked card.
- The estimator's distinct-request table (`client.distinct_requests`), the
  sweep in that form against the reference's MemberEstimators, the fleet
  sweep at int64 edge values against the reference's fleet kernel, the
  snapshot's node ranges, and the launch's marshalling of the distinct
  form on a faked card.
Every comparison is exact (integers; tolerance 0)."""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.api.meta import CPU, MEMORY  # noqa: E402
from karmada_tpu.api.work import ReplicaRequirements  # noqa: E402
from karmada_tpu.estimator import client as jclient  # noqa: E402
from karmada_tpu.ops import assign as jassign  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402

import chip_smoke  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402
from karmada_tpu_torch.estimator import client as tclient  # noqa: E402
from karmada_tpu_torch.models.nodes import NodeEncoder  # noqa: E402
from karmada_tpu_torch.sched.plugins import ALL_PLUGIN_BITS  # noqa: E402

from test_torch_candidates import fake_card  # noqa: E402,F401 (fixture)
from test_torch_estimator import GiB, _members, _node_fleet  # noqa: E402

I32_MAX = 2**31 - 1
CPU_DEV = torch.device("cpu")
T = torch.from_numpy


# --------------------------------------------------------------------------
# dense_filter's tables and their apply
# --------------------------------------------------------------------------


def _dense_case(seed, C, variant):
    """chip_smoke.random_select_inputs at B = 40 and C columns (no requested
    resource in request 0, columns without a summary, unknown requests, a
    prev column listed twice, evictions, tolerations against tainted
    columns), with a random extra_mask; "int32 edges" makes every estimate
    reach or pass INT32_MAX or sit just below it (caps near 3 x INT32_MAX
    over requests of 1 and 3) and drops the answers; "answers" keeps them."""
    rng = np.random.default_rng(seed)
    B = 40
    args = chip_smoke.random_select_inputs(rng, CPU_DEV, B, C)
    args[8][0] = True  # an unknown request
    args[2][0] = False  # a column without a summary
    if variant == "int32 edges":
        args[1][:] = T(rng.choice(np.array([3 * I32_MAX - 3, 3 * I32_MAX, 3 * I32_MAX + 3,
                                            I32_MAX, 2**62], np.int64), (C, 4)))
        args[18][1:] = T(rng.choice(np.array([0, 1, 3], np.int64), (7, 4)))
        args[18][2] = T(np.array([3, 0, 0, 0], np.int64))
        args[1][-1, 0] = 3 * I32_MAX - 3  # request 2's answer: INT32_MAX - 1
        args[2][-1] = True
        args[-1] = None
    mask = T(rng.random((B, C)) < 0.7)
    return args, mask


def _ref_dense_filter(args, mask, bits):
    """The reference's _filter_kernel_compact on the same inputs (seeds as
    uint64, the [1, 1] sentinels for absent terms)."""
    a = [x.numpy() for x in args[:-1]]
    a[17] = a[17].view(np.uint64)
    extra = np.full((1, 1), -1, np.int32) if args[-1] is None else args[-1].numpy()
    return jcore._filter_kernel_compact(*a, extra, mask.numpy(), np.zeros((1, 1), np.int32),
                                        plugin_bits=bits)


@pytest.mark.parametrize("variant", ["answers", "int32 edges"])
@pytest.mark.parametrize("bits", [ALL_PLUGIN_BITS, 0])
@pytest.mark.parametrize("C", [3, 5, 128])
def test_dense_filter_tables_match_reference(C, bits, variant):
    """The tables, then their apply, equal the reference's
    _filter_kernel_compact and dense_filter_plain, all six outputs."""
    args, mask = _dense_case(C * 10 + bits % 7, C, variant)
    tables = kernels.dense_filter_tables_plain(*args[:7], args[10], args[18], plugin_bits=bits)
    est_u, col_ok, api_t = tables
    assert est_u.shape == (8, C) and col_ok.shape == (8, C) and api_t.shape == (6, C)
    got = kernels.dense_filter_apply_plain(
        *tables, args[7], args[8], args[9], args[11], args[12], args[13], args[14], args[15],
        args[16], args[17], args[19], args[20], plugin_bits=bits, extra_mask=mask)
    plain = kernels.dense_filter_plain(*args, plugin_bits=bits, extra_mask=mask)
    want = _ref_dense_filter(args, mask, bits)
    for name, g, p, w in zip(chip_smoke.FILTER_OUT, got, plain, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert torch.equal(g, p), name
    t = est_u.numpy()
    assert (t[0][args[2].numpy()] == kernels.SIM_EST_REPLICAS).all()  # no requested resource
    assert (t[:, 0] == 0).all()  # no summary
    assert (got[2][0] == 0).all()  # an unknown request
    if variant == "int32 edges":  # the sentinel past INT32_MAX, answers just below it
        assert (t[1:] == kernels.SIM_EST_REPLICAS).sum() > 0 and (t == I32_MAX - 1).any()
    prev_idx = args[14].numpy()
    twice = (prev_idx[:, 0] >= 0) & (prev_idx[:, 0] < C) & (args[15][:, 0] != args[15][:, 1]).numpy()
    assert twice.any()  # a prev column listed twice: its last entry
    prev_rep = args[15].numpy()
    for r in np.flatnonzero(twice):
        assert got[3][r, prev_idx[r, 0]] == prev_rep[r][prev_idx[r] == prev_idx[r, 0]][-1]


def test_dense_filter_launch_marshals_the_tables(fake_card):
    """The launch passes U and Tt, one scratch for the three tables (est_u
    [U, C] i32, then col_ok [Tt, C] and api_t [G, C] bytes, back to back),
    the answers, the mask and the plugin score, then the six outputs: one
    C entry of 45 arguments, an absent term as a null pointer."""
    C, B = 64, 5
    args = chip_smoke.random_select_inputs(np.random.default_rng(3), CPU_DEV, B, C)
    mask = torch.ones((B, C), dtype=torch.bool)
    score = torch.zeros((B, C), dtype=torch.int32)
    out = kernels._dense_filter_launch(*args, plugin_bits=ALL_PLUGIN_BITS, extra_mask=mask,
                                       extra_score=score)
    (name, cargs), = fake_card
    assert name == "dense_filter_launch" and len(cargs) == 45
    U, Tt, G = args[18].shape[0], args[10].shape[0], args[6].shape[1]
    assert cargs[7:11] == (C, 4, 4, G) and cargs[24:32] == (B, 6, 8, 2, U, Tt, ALL_PLUGIN_BITS,
                                                             True)
    assert cargs[32] == args[-1].data_ptr() and cargs[33] == mask.data_ptr()
    assert cargs[34] == score.data_ptr()
    est_u, col_ok, api_t = cargs[35:38]
    assert col_ok - est_u == 4 * U * C and api_t - col_ok == Tt * C
    assert cargs[38:44] == tuple(t.data_ptr() for t in out)
    kernels._dense_filter_launch(*args[:-1], None, plugin_bits=0)
    _, cargs = fake_card[-1]
    assert cargs[31] is False and cargs[32:35] == (None, None, None)


# --------------------------------------------------------------------------
# sim_filter's estimate table
# --------------------------------------------------------------------------


def _estimate_case(seed, variant):
    """(capacity i64[S,C,R], has_summary bool[S,C], req_unique i64[U,R],
    req_idx i32[B], replicas i32[B], unknown bool[B], extra i32[B,C] or
    None) with the sentinel cases of `variant` in them."""
    rng = np.random.default_rng(seed)
    S, C, R, U, B = 3, 29, 4, 7, 23
    cap = rng.integers(-10, 5000, (S, C, R)).astype(np.int64)
    req = rng.integers(0, 300, (U, R)).astype(np.int64)
    req[0] = 0  # no requested resource: the row's replicas
    req[1, 1:] = 0
    if variant == "int32 edges":
        # cap // req at INT32_MAX - 1, INT32_MAX and above, and 2^63 - 1 caps
        cap = rng.choice(np.array([0, 1, 3 * I32_MAX - 1, 3 * I32_MAX, 3 * I32_MAX + 3,
                                   2**62, 2**63 - 1], np.int64), (S, C, R))
        req = rng.choice(np.array([0, 1, 3, 2**31, 2**63 - 1], np.int64), (U, R))
        req[0] = 0
        req[1] = [3, 0, 0, 0]
    summary = rng.random((S, C)) < 0.85
    summary[:, 0] = False
    req_idx = rng.integers(0, U, B).astype(np.int32)
    req_idx[:U] = np.arange(U)
    replicas = rng.integers(0, 40, B).astype(np.int32)
    replicas[::5] = I32_MAX
    unknown = rng.random(B) < 0.2
    extra = None
    if variant != "no answers":
        extra = rng.integers(-1, 60, (B, C)).astype(np.int32)
    return cap, summary, req, req_idx, replicas, unknown, extra


@pytest.mark.parametrize("variant", ["answers", "no answers", "int32 edges"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sim_estimate_tables_match_reference(seed, variant):
    """The table (0 without a summary, the sentinel where no resource is
    requested or the minimum reaches INT32_MAX) and its apply equal the
    reference's general_estimate_unique + general_estimate_apply, then
    its unknown-request clamp and the answers' min-merge, per scenario."""
    cap, summary, req, req_idx, replicas, unknown, extra = _estimate_case(seed, variant)
    table = kernels.sim_estimate_table_plain(T(cap), T(summary), T(req))
    got = kernels.sim_estimate_apply_plain(table, T(req_idx), T(replicas), T(unknown),
                                           None if extra is None else T(extra))
    assert table.dtype == torch.int32 and table.shape == (cap.shape[0], len(req), cap.shape[1])
    for s in range(cap.shape[0]):
        est_u, any_u = jassign.general_estimate_unique(cap[s], summary[s], req)
        want = np.asarray(jassign.general_estimate_apply(est_u, any_u, req_idx, summary[s],
                                                         replicas))
        want = np.where(unknown[:, None], 0, want)
        if extra is not None:
            want = np.where(extra >= 0, np.minimum(want, extra), want)
        np.testing.assert_array_equal(got[s].numpy(), want)
    t = table.numpy()
    assert (t[:, :, 0] == 0).all()  # no summary
    assert (t[:, 0, 1:][summary[:, 1:]] == kernels.SIM_EST_REPLICAS).all()  # no request
    if variant == "int32 edges":
        assert (t == kernels.SIM_EST_REPLICAS).sum() > (t[:, 0] == -1).sum()  # >= INT32_MAX
        assert (t == I32_MAX - 1).any()


@pytest.mark.parametrize("with_extra", [True, False])
def test_sim_filter_plain_avail_is_the_factored_form(with_extra):
    """sim_filter_plain's avail (the dense filter per scenario) equals the
    table's apply on seeded stacked inputs with drained columns."""
    args = chip_smoke.random_sim_inputs(np.random.default_rng(9), CPU_DEV, 3, 40, 70,
                                        with_extra)
    _, avail, *_ = kernels.sim_filter_plain(*args, plugin_bits=ALL_PLUGIN_BITS)
    table = kernels.sim_estimate_table_plain(args[1], args[2], args[19])
    got = kernels.sim_estimate_apply_plain(table, args[20], args[8], args[9], args[21])
    assert torch.equal(got, avail)


# --------------------------------------------------------------------------
# capped_div.cuh's division
# --------------------------------------------------------------------------


def _capped_div_model(x: int, d: int, lim: int) -> int:
    """csrc/capped_div.cuh step by step: min(lim, x // d) through a float64
    estimate and one exact correction (uint64 products checked at 128
    bits, as __umul64hi does)."""
    if lim <= 0 or d > x:
        return 0
    if lim * d <= x:
        return lim
    t = int(np.float64(x) / np.float64(d))
    if t * d > x:
        t -= 1
    elif x - t * d >= d:
        t += 1
    return t


EDGE_X = [0, 1, 2, 7, 2**31 - 1, 2**31, 2**52 + 1, 2**53 + 1, 2**62 - 1, 2**62, 2**62 + 3,
          2**63 - 2, 2**63 - 1]
EDGE_D = [1, 2, 3, 7, 2**31 - 1, 2**31, 2**32 + 1, 2**53 + 1, 2**62, 2**63 - 2, 2**63 - 1]


@pytest.mark.parametrize("lim", [0, 1, 110, 2**31 - 2, 2**31 - 1])
def test_capped_div_is_exact_at_int64_edges(lim):
    """Numerators near 2^62 and 2^63 - 1, q = 1, q past the numerator, q
    near 2^63 - 1, quotients on both sides of the cap, and seeded values
    around them: the model equals min(lim, x // d)."""
    rng = np.random.default_rng(lim % 1000)
    xs = EDGE_X + [int(v) for v in rng.integers(0, 2**63 - 1, 300, dtype=np.int64)]
    ds = EDGE_D + [int(v) for v in rng.integers(1, 2**40, 60, dtype=np.int64)]
    for x in xs:
        for d in ds:
            assert _capped_div_model(x, d, lim) == min(lim, x // d), (x, d, lim)
    # quotients just below an integer, where the float64 estimate rounds up
    for q in (1, 3, 2**20 + 1, 2**31 - 2):
        for d in (3, 2**31 + 11, 2**40 + 7):
            for x in (q * d - 1, q * d, q * d + d - 1):
                if x < 2**63:
                    assert _capped_div_model(x, d, lim) == min(lim, x // d), (x, d, lim)


def _floor_div_rcp_model(x: int, d: int) -> int:
    """csrc/capped_div.cuh floor_div_rcp with its reciprocal: m =
    ceil(2^64 / d) (0 for d = 1), the high word of x m, one correction."""
    m = 0 if d <= 1 else (2**64 - 1) // d + 1
    if m == 0:
        return x
    t = (x * m) >> 64
    assert t * d < 2**64  # the correction's product fits 64 bits
    return t - 1 if t * d > x else t


def test_floor_div_rcp_is_exact_at_int64_edges():
    """The reciprocal division of the dense-input tables equals x // d over
    the int64 edges, seeded values, and quotients just below, at and just
    above an integer."""
    rng = np.random.default_rng(5)
    xs = EDGE_X + [int(v) for v in rng.integers(0, 2**63 - 1, 300, dtype=np.int64)]
    ds = EDGE_D + [int(v) for v in rng.integers(1, 2**40, 60, dtype=np.int64)]
    for x in xs:
        for d in ds:
            assert _floor_div_rcp_model(x, d) == x // d, (x, d)
    for q in (1, 3, 2**20 + 1, 2**31 - 2, 2**40 + 3):
        for d in (2, 3, 2**31 + 11, 2**40 + 7, 2**62 - 1):
            for x in (q * d - 1, q * d, q * d + d - 1):
                if x < 2**63:
                    assert _floor_div_rcp_model(x, d) == x // d, (x, d)


# --------------------------------------------------------------------------
# dense_input_filter's group-factored form
# --------------------------------------------------------------------------

INPUT_CASES = ("all rows equal", "all rows distinct", "equal requests apart",
               "tolerations one field apart", "rows past the last group",
               "no requests, no summary, unknown", "int32 edges, no answers", "C = 3", "C = 5",
               "C = 128")


def _input_case(case):
    """The dense-input filter's 19 inputs (FILTER_ARGS) as numpy, seeded,
    with the case's structure: rows equal or distinct, equal requests never
    adjacent, toleration rows equal but for one of their four fields, B
    not a multiple of the 32-row group, zero and absent requests with
    summary-less columns and unknown-request rows, estimates at and above
    INT32_MAX with every answer absent, and narrow and 128-column fleets."""
    rng = np.random.default_rng(INPUT_CASES.index(case) + 31)
    C = {"C = 3": 3, "C = 5": 5, "C = 128": 128}.get(case, 40)
    B = 77 if case == "rows past the last group" else 64
    R, T_, K, G = 4, 4, 5, 6
    i32 = np.int32
    capacity = rng.integers(-10, 200_000, (C, R)).astype(np.int64)
    request = rng.integers(0, 2000, (B, R)).astype(np.int64)
    tol = [rng.integers(0, 4, (B, K)), rng.integers(0, 3, (B, K)), rng.integers(0, 4, (B, K)),
           rng.integers(0, 3, (B, K))]
    gvk = rng.integers(-1, G + 1, B)
    if case == "all rows equal":
        request[:] = request[0]
        for t in tol:
            t[:] = t[0]
        gvk[:] = gvk[0]
    elif case == "equal requests apart":  # rows 0, 2, 4, ... share two requests
        request[0::2] = request[0]
        request[1::4] = request[1]
    elif case == "tolerations one field apart":
        for t in tol:
            t[:] = t[0]
        gvk[:] = gvk[0]
        field = rng.integers(0, 4, B)
        for b in range(1, B, 2):  # every other row differs in one field of one slot
            tol[field[b]][b, b % K] = (tol[field[b]][b, b % K] + 1) % 3
    elif case == "no requests, no summary, unknown":
        request[rng.random((B, R)) < 0.5] = 0
        request[::7] = 0
    elif case == "int32 edges, no answers":
        capacity = rng.choice(np.array([3 * I32_MAX - 3, 3 * I32_MAX, 3 * I32_MAX + 3, I32_MAX,
                                        2**62, 0, -1], np.int64), (C, R))
        request = rng.choice(np.array([0, 1, 3, 2**31, 2**62], np.int64), (B, R))
    has_summary = rng.random(C) < 0.85
    has_summary[0] = False
    unknown = rng.random(B) < 0.1
    extra = np.where(rng.random((B, C)) < 0.5, rng.integers(0, 50, (B, C)), -1).astype(i32)
    if case == "int32 edges, no answers":
        extra[:] = -1
    return (rng.random(C) < 0.9, capacity, has_summary,
            rng.integers(0, 4, (C, T_)).astype(i32), rng.integers(0, 3, (C, T_)).astype(i32),
            rng.integers(0, 4, (C, T_)).astype(i32), rng.random((C, G)) < 0.9,
            rng.integers(0, 40, B).astype(i32), request, unknown, gvk.astype(i32),
            *(t.astype(i32) for t in tol), rng.random((B, C)) < 0.8, rng.random((B, C)) < 0.9,
            rng.random((B, C)) < 0.2, extra)


@pytest.mark.parametrize("case", INPUT_CASES)
def test_dense_input_groups_match_reference(case):
    """The group-factored form (what csrc/dense_filter.cu's dense-input
    kernel builds and reads per group of 32 rows: the representatives, the
    estimate table with its sentinel, the column-ok table, then each row's
    masks and clamps) equals the reference's filter_estimate_phase over the
    dense inputs with the answers' min-merge (core.py:190-226, :311) and
    dense_input_filter_plain, all three outputs exactly."""
    a = _input_case(case)
    got = kernels.dense_input_filter_groups_plain(*(T(np.ascontiguousarray(x)) for x in a))
    plain = kernels.dense_input_filter_plain(*(T(np.ascontiguousarray(x)) for x in a))
    jf, js, ja = jcore.filter_estimate_phase(*a[:-1])
    ja = np.where(a[-1] >= 0, np.minimum(np.asarray(ja), a[-1]), np.asarray(ja))
    for name, g, pl, w in zip(chip_smoke.DENSE_INPUT_OUT, got, plain, (jf, js, ja)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert torch.equal(g, pl), name
    request = T(a[8])
    reqs = [len(kernels._first_rows(request[r:r + 32])[0]) for r in range(0, len(a[7]), 32)]
    if case == "all rows equal":
        assert reqs == [1, 1]
    if case == "all rows distinct":
        assert reqs == [32, 32]
    if case == "equal requests apart":
        first, slot = kernels._first_rows(request[:32])
        assert slot[0] == slot[2] == slot[30] and slot[1] == slot[5] and first[slot[30]] == 0
    if case == "tolerations one field apart":
        tol = torch.cat([T(x) for x in a[11:15]] + [T(a[10])[:, None]], 1)
        assert len(kernels._first_rows(tol[:32])[0]) > 2
    if case == "int32 edges, no answers":
        assert (got[2].numpy() == a[7][:, None]).any()  # the sentinel's replicas


def _kept_entries_model(groups, cap=32):
    """csrc/dense_filter.cu's kept entries, group by group: a row takes the
    kept entry equal to it, else a new entry shared with its first equal
    row; when the new entries do not fit, every entry is dropped and the
    group's distinct rows take entries from 0. Returns each group's slots
    and whether it refilled."""
    kept, out = [], []
    for rows in groups:
        hit = [kept.index(r) if r in kept else -1 for r in rows]
        first = [rows.index(r) for r in rows]
        reps = [i for i, f in enumerate(first) if f == i]
        fresh = [i for i in reps if hit[i] < 0]
        refill = len(kept) + len(fresh) > cap
        if refill:
            slots = [reps.index(f) for f in first]
            kept = [rows[i] for i in reps]
        else:
            slots = [h if h >= 0 else len(kept) + fresh.index(f) for h, f in zip(hit, first)]
            kept = kept + [rows[i] for i in fresh]
        assert len(kept) <= cap and all(kept[s] == r for s, r in zip(slots, rows))
        out.append((slots, refill))
    return out


@pytest.mark.parametrize("pattern", ["four requests", "every row distinct", "40 across groups",
                                     "one row"])
def test_kept_entries_model(pattern):
    """The bookkeeping of the dense-input kernel's kept entries (steps 2-4
    of dense_input_group_kernel): every row's entry holds that row, at most
    32 are kept, the flagship's four requests are built once, and a block
    refills only when a group brings more new rows than fit."""
    rng = np.random.default_rng(len(pattern))
    if pattern == "four requests":
        rows = list(rng.integers(0, 4, 320))
    elif pattern == "every row distinct":
        rows = list(range(320))
    elif pattern == "40 across groups":
        rows = list(rng.integers(0, 40, 320))
    else:
        rows = [7]
    groups = [rows[g:g + 32] for g in range(0, len(rows), 32)]
    out = _kept_entries_model(groups)
    refills = [r for _, r in out]
    if pattern == "four requests":
        assert not any(refills) and max(max(s) for s, _ in out) == 3
    if pattern == "every row distinct":
        assert refills == [False] + [True] * 9
    if pattern == "40 across groups":
        assert any(refills) and not refills[0]


def test_dense_input_filter_launch_marshals_the_rows(fake_card):
    """The launch passes the fleet, the widths, the row inputs where they
    lie (the request, the four toleration tables, the three masks and the
    answers, nothing copied), Kt, B and every plugin bit, and the three
    outputs: one C entry of 30 arguments and no scratch."""
    a = [T(np.ascontiguousarray(x)) for x in _input_case("rows past the last group")]
    out = kernels._dense_input_filter_launch(*a)
    (name, cargs), = fake_card
    assert name == "dense_input_filter_launch" and len(cargs) == 30
    B, C = a[15].shape
    assert cargs[:7] == tuple(t.data_ptr() for t in a[:7])
    assert cargs[7:11] == (C, 4, 4, 6) and cargs[19] == 5 and cargs[24:26] == (B, ALL_PLUGIN_BITS)
    assert cargs[11:19] == tuple(t.data_ptr() for t in a[7:15])
    assert cargs[20:24] == tuple(t.data_ptr() for t in a[15:19])
    assert cargs[26:29] == tuple(t.data_ptr() for t in out)


# --------------------------------------------------------------------------
# the estimator's distinct requests and the fleet sweep
# --------------------------------------------------------------------------


def _reqs(kind):
    """Requirement lists: repeated requests, all distinct, zero requests."""
    if kind == "repeated":
        base = [ReplicaRequirements(resource_request={CPU: c, MEMORY: m * GiB})
                for c in (0.1, 0.5, 1.0) for m in (0.5, 2.0)]
        return base * 5 + [None, ReplicaRequirements()] * 3
    if kind == "distinct":
        return [ReplicaRequirements(resource_request={CPU: 0.1 + 0.01 * i}) for i in range(37)]
    return [None, ReplicaRequirements(), ReplicaRequirements(resource_request={CPU: 0.0})] * 4


@pytest.mark.parametrize("kind", ["repeated", "distinct", "zero"])
def test_distinct_requests_table(kind):
    """The client's table: request_u[req_idx] is every row's request
    vector, the table holds each vector once, in order of first
    appearance."""
    reqs = conv(_reqs(kind))
    enc = NodeEncoder()
    request_u, req_idx = tclient.distinct_requests(enc, reqs)
    rows = np.stack([enc.request_vector(r.resource_request if r else {}) for r in reqs])
    np.testing.assert_array_equal(request_u[req_idx], rows)
    assert len(np.unique(request_u, axis=0)) == len(request_u)
    assert req_idx.dtype == np.int32 and list(np.unique(req_idx, return_index=True)[1]) == \
        sorted(np.unique(req_idx, return_index=True)[1])
    want_u = {"repeated": 7, "distinct": 37, "zero": 1}[kind]
    assert len(request_u) == want_u
    empty_u, empty_idx = tclient.distinct_requests(enc, [])
    assert empty_u.shape == (0, len(enc.resources)) and empty_idx.shape == (0,)


@pytest.mark.parametrize("kind", ["repeated", "distinct", "zero"])
def test_distinct_sweep_matches_reference(kind):
    """max_available_replicas_rows through the fleet route in its distinct
    form (the plain version on request_u[req_idx]) against the reference's
    MemberEstimators, on shard_nodes fleets with overcommitted nodes
    (pods placed), tainted and node-less members."""
    jm, tm, names = _members()
    reqs = _reqs(kind)
    j = jclient.MemberEstimators(jm)
    t = tclient.MemberEstimators(tm, device="cpu")
    try:
        want = np.asarray(j.max_available_replicas_rows(names, reqs))
        got = t.max_available_replicas_rows(names, conv(reqs))
    finally:
        t.close()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()


def test_snapshot_node_ranges():
    """The snapshot keeps each cluster's node range, from the node counts:
    the ranges searchsorted would find in its cluster ids."""
    _, tm, names = _members()
    t = tclient.MemberEstimators(tm, device="cpu")
    snap = t._fleet_snapshot(names)
    cid = snap[4].numpy()
    assert (np.diff(cid) >= 0).all()  # nodes in cluster order
    np.testing.assert_array_equal(t._fleet_off.numpy(),
                                  np.searchsorted(cid, np.arange(len(names) + 1)))
    t.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_sweep_edge_values_match_jax(seed):
    """The fleet sweep (its plain version, as a [B, R] request and as a
    distinct table with an index) at int64 edges against the reference's
    fleet kernel: free capacities near +-2^62, requests of 1, past the
    free capacity and near 2^63 - 1, pod slots past INT32_MAX."""
    rng = np.random.default_rng(seed)
    C, B = 17, 40
    _, _, _, _, cid, _, ok, _ = _node_fleet(rng, C, B)
    N = len(cid)
    alloc = rng.choice(np.array(chip_smoke.EDGE_ALLOC, np.int64), (N, 4))
    requested = rng.choice(np.array(chip_smoke.EDGE_REQUESTED, np.int64), (N, 4))
    allowed = rng.choice(np.array(chip_smoke.EDGE_PODS, np.int64), N)
    pods = np.minimum(rng.choice(np.array(chip_smoke.EDGE_PODS, np.int64), N), allowed)
    request = rng.choice(np.array(chip_smoke.EDGE_REQUEST, np.int64), (B, 4))
    request[B // 2:] = request[:B // 2]  # repeated rows
    want = np.asarray(jclient._fleet_rows_kernel(alloc, requested, pods, allowed, cid, ok,
                                                 request, num_clusters=C))
    fleet = (T(alloc), T(requested), T(pods), T(allowed), T(cid), C, T(ok))
    got = kernels.fleet_estimate(*fleet, T(request))
    np.testing.assert_array_equal(got.numpy(), want)
    u, inv = np.unique(request, axis=0, return_inverse=True)
    got = kernels.fleet_estimate(*fleet, T(u), req_idx=T(inv.reshape(-1).astype(np.int32)),
                                 node_off=T(np.searchsorted(cid, np.arange(C + 1)).astype(
                                     np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == I32_MAX).any() and (want == 0).any() and ((want > 0) & (want < I32_MAX)).any()


def test_fleet_launch_marshals_the_distinct_form(fake_card):
    """With an index and node ranges the launch passes the table's U rows,
    the index, the B rows, a [U, C] table scratch and the ranges in place
    of the sort (a null order); without ranges it sorts."""
    rng = np.random.default_rng(11)
    alloc, requested, pod_count, allowed, cid, off, ok, request = _node_fleet(rng, 13, 9)
    fleet = (T(alloc), T(requested), T(pod_count), T(allowed), T(cid), 13, T(ok))
    idx = T(np.array([0, 1, 1, 2, 0, 2, 2, 1, 0], np.int32))
    node_off = T(off)
    out = kernels._fleet_estimate_launch(*fleet, T(request[:3]), req_idx=idx,
                                         node_off=node_off)
    (name, cargs), = fake_card
    assert name == "fleet_estimate_launch" and len(cargs) == 16
    assert cargs[5] is None and cargs[6] == node_off.data_ptr()  # no order: the ranges
    assert cargs[7:9] == (13, 4) and cargs[10] == 3 and cargs[11] == idx.data_ptr()
    assert cargs[12] == 9 and cargs[13] is not None and isinstance(cargs[15], ctypes.c_void_p)
    assert out.shape == (9, 13)
    kernels._fleet_estimate_launch(*fleet, T(request[:3]), req_idx=idx)
    _, cargs = fake_card[-1]
    assert cargs[5] is not None  # the sort's order
    with pytest.raises(ValueError, match="node_off: shape"):
        kernels._fleet_estimate_launch(*fleet, T(request[:3]), req_idx=idx,
                                       node_off=node_off[:-1])
