"""The PyTorch port's priority tiers and preemption held against the JAX
package.

The plain versions of the two tier kernels (`tier_estimate_plain`,
`tier_consume_plain`) against the JAX expressions they replace, on seeded
arrays; the port's dense and compact tiered launches against the JAX
`_tiered_kernel` / `_tiered_candidate_kernel` on the same encoded batch,
output for output; then decisions (with their speculative decisions) of
`launch_tiered` + `materialize_chunk`, the preemption plans of
`plan_preemption`, `plan_from_speculative` and `preview_preemption`, and
the routing and launch counts, against the JAX package on the fixtures of
tests/test_preemption.py. All comparisons are exact (integer outputs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import karmada_tpu.sched.preemption as jpre  # noqa: E402
from karmada_tpu.api import policy as jpol  # noqa: E402
from karmada_tpu.api.policy import PREEMPT_LOWER_PRIORITY  # noqa: E402
from karmada_tpu.sched import candidates as jcand  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.testing.fixtures import (  # noqa: E402
    new_cluster_with_resource,
    static_weight_placement,
    synthetic_fleet,
)
from tests.test_parallel import dyn_placement, make_binding  # noqa: E402
import tests.test_preemption as jtests  # noqa: E402
from tests.test_preemption import mark_placed, mixed_priority_bindings, tight_fleet  # noqa: E402

import karmada_tpu_torch.sched.preemption as tpre  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402

OUT = ("unsched", "asum", "feas_count", "nnz", "top_idx", "top_val", "result")
AUG = ("aug_unsched", "aug_asum", "aug_nnz", "aug_idx", "aug_val", "aug_result")


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _estimate_inputs(rng, B, C, R=4, U=6):
    """Seeded estimate inputs: capacities around zero and past INT32_MAX
    quotients, absent summaries, zero and absent requests, unknown
    requests, replicas from 0."""
    cap = rng.integers(-5, 3000, (C, R)).astype(np.int64)
    cap[::7, 1] = 0
    cap[3] = 1 << 45  # a quotient past INT32_MAX
    req_u = rng.integers(0, 40, (U, R)).astype(np.int64)
    req_u[0] = 0  # a request naming no resource
    req_u[1] = [1, 0, 0, 0]
    return dict(
        capacity=cap, has_summary=rng.random(C) < 0.9, req_unique=req_u,
        req_idx=rng.integers(0, U, B).astype(np.int32),
        replicas=rng.integers(0, 50, B).astype(np.int32),
        unknown_request=rng.random(B) < 0.1,
    )


# --------------------------------------------------------------------------
# (a), (b): the plain versions of the tier kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["rows", "window"])
def test_tier_estimate_plain_matches_jax(mode):
    """Rows mode against the estimate half of the JAX filter_estimate_phase
    (general_estimate_unique + general_estimate_apply + the unknown-request
    zero); window mode against candidates._compact_estimate with no
    registered-estimator answers."""
    from karmada_tpu.ops import assign as jassign

    rng = np.random.default_rng(7)
    B, C, K = 40, 64, 16
    d = _estimate_inputs(rng, B, C)
    rows = rng.permutation(B)[:25].astype(np.int32)
    t = {k: _t(v) for k, v in d.items()}
    args = (t["capacity"], t["has_summary"], t["req_unique"], t["req_idx"], t["replicas"],
            t["unknown_request"], _t(rows))
    if mode == "rows":
        est_u, any_u = jassign.general_estimate_unique(
            jnp.asarray(d["capacity"]), jnp.asarray(d["has_summary"]), jnp.asarray(d["req_unique"]))
        want = np.asarray(jassign.general_estimate_apply(
            est_u, any_u, jnp.asarray(d["req_idx"]), jnp.asarray(d["has_summary"]),
            jnp.asarray(d["replicas"])))
        want = np.where(d["unknown_request"][:, None], 0, want)
        buf = torch.full((B, C), -7, dtype=torch.int32)
        got = _n(kernels.tier_estimate_plain(*args, out=buf))
        np.testing.assert_array_equal(got[rows], want[rows])
        untouched = np.setdiff1d(np.arange(B), rows)
        assert (got[untouched] == -7).all()  # only the tier's rows are written
    else:
        cand = np.sort(rng.choice(C, (B, K)), axis=1).astype(np.int32)
        want = np.asarray(jcand._compact_estimate(
            jnp.asarray(d["capacity"]), jnp.asarray(d["has_summary"]),
            jnp.asarray(d["req_unique"]), jnp.asarray(d["req_idx"][rows]),
            jnp.asarray(d["replicas"][rows]), jnp.asarray(d["unknown_request"][rows]),
            jnp.asarray(cand[rows]), None))
        got = _n(kernels.tier_estimate_plain(*args, cand_idx=_t(cand)))
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 5


# (mode, case) of the consumption checks: each mode's first draw (ids
# "dense" and "window"), then the edge shapes of each mode
_CONSUME_CASES = [pytest.param("dense", "base", id="dense"),
                  pytest.param("window", "base", id="window")] + [
    pytest.param(mode, case, id=f"{mode}-{case}")
    for case in ("c_odd", "r1", "r16", "one_row", "all_unsched", "hot_column")
    for mode in ("dense", "window")
]


@pytest.mark.parametrize("mode,case", _CONSUME_CASES)
def test_tier_consume_plain_matches_jax(mode, case):
    """Against the reference's consumption expressions
    (preemption.py:221-222, `placed.T @ request_dense` then the clamp;
    candidates.py:863-869, the scatter-add through cand_idx), with memory
    requests in bytes whose products pass 2**53; then at the edge shapes
    the kernel's launch geometry turns on: a width no multiple of 4 (41
    columns), one and sixteen resources, a single row, every row
    unschedulable, and every row placing on one column."""
    rng = np.random.default_rng(8)
    C = 41 if case == "c_odd" else 40
    R = {"r1": 1, "r16": 16}.get(case, 4)
    B, K = 48, 8
    n = 1 if case == "one_row" else 30
    mem = 1 if R > 1 else 0  # the memory column: requests in bytes
    rows = rng.permutation(B)[:n].astype(np.int32)
    unsched = rng.random(n) < 0.2
    request = rng.integers(0, 500, (B, R)).astype(np.int64)
    request[:, mem] = rng.integers(1 << 48, 1 << 49, B)  # bytes: sums pass 2**53
    cap = rng.integers(0, 1 << 50, (C, R)).astype(np.int64)
    cap[:, mem] = rng.integers(1 << 55, 1 << 56, C)
    cap[::3, 0] = rng.integers(0, 50, len(cap[::3]))  # rows the clamp zeroes
    width = C if mode == "dense" else K
    placed = np.where(rng.random((n, width)) < 0.4, rng.integers(0, 9, (n, width)), 0)
    placed = placed.astype(np.int32)
    cand = np.sort(rng.choice(C, (B, K)), axis=1).astype(np.int32) if mode == "window" else None
    if case == "all_unsched":
        unsched[:] = True
    if case == "hot_column":  # the last column, also the last slot of every window
        placed[:] = 0
        placed[:, -1] = rng.integers(1, 9, n)
        if cand is not None:
            cand[:, -1] = C - 1
    p = jnp.where(jnp.asarray(unsched)[:, None], 0, jnp.asarray(placed)).astype(jnp.int64)
    req = jnp.asarray(request[rows])
    if mode == "dense":
        cons = p.T @ req
    else:
        cons = jnp.zeros((C, R), jnp.int64).at[jnp.asarray(cand[rows])].add(
            p[:, :, None] * req[:, None, :])
    want = np.asarray(jnp.maximum(jnp.asarray(cap) - cons, 0))
    got = _n(kernels.tier_consume_plain(
        _t(cap), _t(placed), _t(unsched), _t(request), _t(rows),
        cand_idx=None if cand is None else _t(cand)))
    np.testing.assert_array_equal(got, want)
    cons = np.asarray(cons)
    if case == "base":
        assert (want == 0).any() and (want > 0).any()
        assert (cons > (1 << 53)).any()  # not exact in float64
    elif case == "all_unsched":
        np.testing.assert_array_equal(want, np.maximum(cap, 0))
    elif case == "hot_column":
        assert cons[C - 1].any() and not cons[:C - 1].any()
        assert (cons > (1 << 53)).any()
    else:
        assert cons.any()


@pytest.mark.parametrize("answers", [False, True])
def test_tier_estimate_factored_form_matches_jax(answers):
    """A tier's estimates as the CPU round's launcher (kernels.tier_launcher)
    makes them, and tier_estimate_plain, at the tier's rows equal the JAX
    estimate with the answers min-merged: rows mode into the avail buffer
    (general_estimate_unique + general_estimate_apply + the
    unknown-request zero), and window mode's pair of a main pass at the
    capacity with the answers and a speculative pass at capacity + reclaim
    without them (candidates._compact_estimate). The route rule takes the
    rows mode's table only while U is at most half the tier's rows."""
    from karmada_tpu.ops import assign as jassign

    rng = np.random.default_rng(8)
    B, C, K = 40, 64, 16
    d = _estimate_inputs(rng, B, C)
    rows = rng.permutation(B)[:25].astype(np.int32)
    cand = np.sort(rng.choice(C, (B, K)), axis=1).astype(np.int32)
    reclaim = rng.integers(0, 400, d["capacity"].shape).astype(np.int64)
    extra = rng.choice([-1, 0, 3, 1 << 20], (B, C)).astype(np.int32) if answers else None
    J = {k: jnp.asarray(v) for k, v in d.items()}

    def jax_rows(cap):
        est_u, any_u = jassign.general_estimate_unique(jnp.asarray(cap), J["has_summary"],
                                                       J["req_unique"])
        want = np.asarray(jassign.general_estimate_apply(est_u, any_u, J["req_idx"],
                                                         J["has_summary"], J["replicas"]))
        want = np.where(d["unknown_request"][:, None], 0, want)
        if answers:
            want = np.where(extra >= 0, np.minimum(want, extra), want)
        return want[rows]

    def jax_window(cap, use_extra):
        c_extra = jnp.asarray(extra[rows[:, None], cand[rows]]) if use_extra else None
        return np.asarray(jcand._compact_estimate(
            jnp.asarray(cap), J["has_summary"], J["req_unique"], J["req_idx"][rows],
            J["replicas"][rows], J["unknown_request"][rows], jnp.asarray(cand[rows]), c_extra))

    t = {k: _t(v) for k, v in d.items()}
    ans = None if extra is None else _t(extra)
    est = (t["has_summary"], t["req_unique"], t["req_idx"], t["replicas"], t["unknown_request"])
    launcher = kernels.tier_launcher(*est, extra_avail=ans)
    assert not isinstance(launcher, kernels.TierLauncher)  # CPU tensors: the plain versions
    buf = torch.full((B, C), -7, dtype=torch.int32)
    got = launcher.rows_mode(buf).estimate(t["capacity"], _t(rows))
    assert got is buf
    want = jax_rows(d["capacity"])
    np.testing.assert_array_equal(_n(got)[rows], want)
    plain = kernels.tier_estimate_plain(t["capacity"], *est, _t(rows),
                                        out=torch.full((B, C), -7, dtype=torch.int32),
                                        extra_avail=ans)
    np.testing.assert_array_equal(_n(plain)[rows], want)
    main, spec = launcher.window_mode(_t(cand)).estimate_pair(t["capacity"], _t(reclaim),
                                                              _t(rows))
    np.testing.assert_array_equal(_n(main), jax_window(d["capacity"], answers))
    np.testing.assert_array_equal(_n(spec), jax_window(d["capacity"] + reclaim, False))
    assert (_n(spec) != _n(main)).any()
    assert kernels.estimate_route(6, 12) == "table" and kernels.estimate_route(7, 12) == "element"
    assert kernels.estimate_route(6, 12, "element") == "element"
    with pytest.raises(ValueError, match="route"):
        kernels.estimate_route(6, 12, "dense")


@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_tiered_round_builds_one_launcher(mode, monkeypatch):
    """A tiered round builds one tier launcher (kernels.tier_launcher) with
    the round's constant tensors, puts it in rows mode (the dense launch,
    over dense_filter's avail buffer) or window mode (the compact launch,
    over candidate_select's windows), and runs every tier's estimate and
    consumption through it."""
    clusters, bindings = _tiered_fixture(mode, 3)
    tarr = TorchScheduler(conv(clusters), device="cpu")
    built, used = [], []
    make = kernels.tier_launcher

    def counting(*a, **kw):
        launcher = make(*a, **kw)
        built.append(launcher)
        for name in ("estimate", "consume"):
            fn = getattr(launcher, name)
            setattr(launcher, name, lambda *x, _f=fn, _n=name, **y: (used.append(_n),
                                                                     _f(*x, **y))[1])
        return launcher

    monkeypatch.setattr(kernels, "tier_launcher", counting)
    tpre._launch_kernel_rows(tarr, conv(bindings))
    (launcher,), = [built]
    assert (launcher.avail is not None) == (mode == "dense")
    assert (launcher.cand_idx is not None) == (mode == "compact")
    assert used.count("estimate") == used.count("consume") == 2  # tiers after the first


@pytest.mark.parametrize("mode", ["dense", "window"])
def test_tier_consume_launch_marshals_one_call(monkeypatch, mode):
    """On a faked card each tier_consume call is one call of the C entry
    tier_consume_round (which zeroes its scratch and launches once): the
    call's capacity, placements, flags, rows and [C, R] output, and a
    TierRound with the request, the window's cand_idx and K (none in dense
    mode), a C x (R + 1) int64 scratch for the sums and counters and the
    stream; the entry's prototype is bound at the first call only; every
    check still raises; a 17-resource request takes two calls, over
    resource blocks of 16 and 1 sharing one scratch."""
    from karmada_tpu_torch.kernels import build

    calls, loads = [], []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0

            return entry

    monkeypatch.setattr(build, "library", lambda name: (loads.append(name), Lib())[1])
    monkeypatch.setattr(kernels, "_stream", lambda dev: 7)
    monkeypatch.setattr(kernels, "_bound", {})
    rng = np.random.default_rng(2)
    C, R, n, B, K = 300, 4, 12, 20, 16
    cap = _t(rng.integers(0, 100, (C, R)).astype(np.int64))
    request = _t(rng.integers(0, 9, (B, R)).astype(np.int64))
    rows, unsched = _t(np.arange(n, dtype=np.int32)), torch.zeros(n, dtype=torch.bool)
    placed = torch.zeros((n, C), dtype=torch.int32)
    cand = _t(np.sort(rng.choice(C, (B, K)), axis=1).astype(np.int32))
    window = mode == "window"
    p = placed[:, :K].contiguous() if window else placed
    kw = {"cand_idx": cand} if window else {}
    outs = [kernels._tier_consume_launch(cap, p, unsched, request, rows, **kw) for _ in range(2)]
    assert loads == ["tiers"]
    assert [name for name, _ in calls] == ["tier_consume_round"] * 2
    for out, (_, args) in zip(outs, calls):
        rnd = args[0]._obj
        assert args[1:] == (cap.data_ptr(), p.data_ptr(), unsched.data_ptr(), rows.data_ptr(), n,
                            out.data_ptr())
        assert (rnd.request, rnd.B, rnd.C, rnd.R) == (request.data_ptr(), B, C, R)
        assert (rnd.cand_idx, rnd.K) == ((cand.data_ptr(), K) if window else (None, 0))
        assert (rnd.scratch_bytes, rnd.stream) == (C * (R + 1) * 8, 7)
        assert rnd.scratch not in (None, out.data_ptr())  # the scratch, apart from the output
        assert out.shape == (C, R) and out.dtype == torch.int64 and out.is_contiguous()
        assert out.untyped_storage().nbytes() == C * R * 8
    with pytest.raises(TypeError, match="dtype"):
        kernels._tier_consume_launch(cap, placed.long(), unsched, request, rows)
    with pytest.raises(ValueError, match="contiguous"):
        kernels._tier_consume_launch(cap, torch.zeros((C, n), dtype=torch.int32).t(), unsched,
                                     request, rows)
    with pytest.raises(ValueError, match="shape"):  # a dense placed matrix with a window
        kernels._tier_consume_launch(cap, placed, unsched, request, rows, cand_idx=cand)
    # past 16 resources: one launch per block of 16, over contiguous
    # resource slices, the outputs side by side
    wide = _t(rng.integers(0, 100, (C, 17)).astype(np.int64))
    wide_req = _t(rng.integers(0, 9, (B, 17)).astype(np.int64))
    out = kernels._tier_consume_launch(wide, p, unsched, wide_req, rows, **kw)
    assert [name for name, _ in calls] == ["tier_consume_round"] * 4
    blocks = [args[0]._obj for _, args in calls[2:]]
    assert [rnd.R for rnd in blocks] == [16, 1]
    assert blocks[0].scratch == blocks[1].scratch  # one scratch, 16 + 1 wide
    assert all(rnd.scratch_bytes == C * 17 * 8 for rnd in blocks)
    assert out.shape == (C, 17) and out.is_contiguous()


# --------------------------------------------------------------------------
# (c): the tiered launches against the JAX programs
# --------------------------------------------------------------------------


def _tiered_fixture(mode, n_tiers, seed=0):
    """(JAX clusters, JAX bindings): `dense` a contended 3-cluster fleet
    (the dense launch), `compact` a tightened 300-cluster synthetic fleet
    without Duplicated rows (the compact launch). Priorities cycle over
    n_tiers values; rows of every division strategy."""
    rng = np.random.default_rng(seed)
    if mode == "dense":
        clusters = tight_fleet(free=(5.0, 4.0, 3.0))
        names = [c.name for c in clusters]
        n, cpu = 12, (1.0, 0.5)
    else:
        clusters = _tight_synthetic(300)
        names = [c.name for c in clusters]
        n, cpu = 48, (0.5, 1.0, 2.0)
    placements = [dyn_placement(), dyn_placement(aggregated=True),
                  static_weight_placement({names[j]: j + 1 for j in range(3)})]
    out = []
    for i in range(n):
        rb = make_binding(f"t-{i}", int(rng.integers(1, 9 if mode == "dense" else 40)),
                          placements[i % 3], cpu=float(rng.choice(cpu)))
        rb.spec.schedule_priority = (i % n_tiers) * 7
        out.append(rb)
    return clusters, out


def _tight_synthetic(n):
    """A synthetic fleet with allocated cpu raised so the batches below
    contend: every cluster keeps 0-3 whole cpu free."""
    rng = np.random.default_rng(n)
    clusters = synthetic_fleet(n, seed=1)
    for c in clusters:
        rs = c.status.resource_summary
        rs.allocated["cpu"] = rs.allocatable["cpu"] - float(rng.integers(0, 4))
    return clusters


@pytest.mark.parametrize("speculate", [False, True])
@pytest.mark.parametrize("n_tiers", [1, 3, 4])
@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_tiered_launch_matches_jax_kernel(mode, n_tiers, speculate, monkeypatch):
    """Every output of the port's tiered launch equals the JAX program's on
    the same encoded batch, padded rows included. The one named exception
    (module docstring): for rows that are unschedulable in the FIRST tier,
    the result row, nnz and output window of the main pass, which the
    reference zeroes and the port keeps (their decisions are errors either
    way)."""
    clusters, bindings = _tiered_fixture(mode, n_tiers)
    jarr = jcore.ArrayScheduler(clusters)
    tarr = TorchScheduler(conv(clusters), device="cpu")
    reclaim = None
    if speculate:
        rng = np.random.default_rng(3)
        _, nt = jpre._tier_assignment(bindings)
        reclaim = rng.integers(0, 4000, (nt, len(jarr.fleet.names), len(jarr.encoder.resources)))
        reclaim[min(1, nt - 1)] = 0  # a tier with nothing to reclaim
        reclaim = reclaim.astype(np.int64)
    calls = []
    for name in ("dense_filter", "candidate_select", "tier_estimate", "tier_consume"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append(_n), _fn(*a, **kw))[1])
    got = tpre._launch_kernel_rows(tarr, conv(bindings), reclaim_tiers=reclaim)
    want = jpre._launch_kernel_rows(jarr, bindings, None, reclaim_tiers=reclaim)
    assert (got["cand_dev"] is None) == (mode == "dense") == (want["cand_dev"] is None)
    assert got["n_tiers"] == want["n_tiers"]
    first = calls[0]
    assert first == ("dense_filter" if mode == "dense" else "candidate_select")
    assert calls.count(first) == 1 and calls.count("tier_consume") == n_tiers - 1
    names = OUT + (AUG if speculate else ())
    # the reference's compact program also returns cand_idx last (its cand_dev)
    assert len(got["out"]) == len(names) == len(want["out"]) - (mode == "compact")
    g = dict(zip(names, (_n(x).astype(np.int64) for x in got["out"])))
    w = dict(zip(names, (np.asarray(x).astype(np.int64) for x in want["out"][:len(names)])))
    tier_of, _ = jpre._tier_assignment(bindings)
    tier_pad = np.zeros(len(g["unsched"]), np.int64)
    tier_pad[: len(bindings)] = tier_of
    skip = (tier_pad == 0) & (w["unsched"] > 0)
    for name in names:
        a, b = g[name], w[name]
        if name in ("result", "nnz", "top_idx", "top_val"):
            a, b = a[~skip], b[~skip]
        np.testing.assert_array_equal(a, b, err_msg=name)
    if mode == "compact":
        np.testing.assert_array_equal(_n(got["cand_dev"]), np.asarray(want["cand_dev"]))
    assert (w["nnz"] > 0).any()
    assert w["unsched"].any() or n_tiers == 1  # lower tiers meet a residual


# --------------------------------------------------------------------------
# (d): decisions of launch_tiered + materialize_chunk
# --------------------------------------------------------------------------


def _view(d):
    spec = d.speculative
    return (d.key, d.error, None if d.targets is None else
            sorted((t.name, t.replicas) for t in d.targets),
            None if spec is None else _view(spec))


def _unschedulable_middle():
    hi = make_binding("hi", 4, dyn_placement(), cpu=1.0)
    hi.spec.schedule_priority = 20
    mid = make_binding("mid", 40, dyn_placement(), cpu=1.0)
    mid.spec.schedule_priority = 10
    lo = make_binding("lo", 2, dyn_placement(), cpu=1.0)
    lo.spec.schedule_priority = 0
    return tight_fleet(free=(3.0, 3.0)), [hi, mid, lo]


def _with_spread_row():
    clusters = tight_fleet(free=(5.0, 4.0, 3.0, 6.0))
    bindings = mixed_priority_bindings(n=6)
    p = dyn_placement()
    p.spread_constraints = [jpol.SpreadConstraint(
        spread_by_field=jpol.SPREAD_BY_FIELD_CLUSTER, min_groups=2, max_groups=3)]
    rb = make_binding("spread", 3, p, cpu=1.0)
    rb.spec.schedule_priority = 5
    return clusters, bindings[:3] + [rb] + bindings[3:]


def _preempt_mix():
    """TestPreemption's fleet and victim with an armed preemptor inside a
    mixed-priority batch (the speculative pass)."""
    tp = jtests.TestPreemption()
    clusters, victim = tp._fleet(), tp._victim()
    urgent = tp._preemptor()
    other = make_binding("filler", 2, dyn_placement(), cpu=1.0)
    other.spec.schedule_priority = 1
    return clusters, [urgent, other], [victim]


def _fixture(name):
    """(clusters, bindings, placed snapshot or None, dense or compact)."""
    if name == "contended":
        return tight_fleet(free=(5.0, 4.0, 3.0)), mixed_priority_bindings(n=9), None, "dense"
    if name == "unschedulable_middle":
        return (*_unschedulable_middle(), None, "dense")
    if name == "compact":
        clusters, bindings = _tiered_fixture("compact", 3, seed=4)
        return clusters, bindings, None, "compact"
    if name == "spread_row":
        return (*_with_spread_row(), None, "dense")
    if name == "speculative":
        return (*_preempt_mix(), "dense")
    if name == "overflow":  # target sets wider than the 128-column window
        clusters = synthetic_fleet(200, seed=2)
        bindings = []
        for i in range(6):
            p = jpol.Placement() if i % 2 else dyn_placement()
            rb = make_binding(f"wide-{i}", 3000 if i % 2 == 0 else 2, p, cpu=0.1)
            rb.spec.schedule_priority = 10 * (i % 3)
            bindings.append(rb)
        return clusters, bindings, None, "dense"
    raise KeyError(name)


@pytest.mark.parametrize("name", ["contended", "unschedulable_middle", "compact", "spread_row",
                                  "speculative", "overflow"])
def test_launch_tiered_decisions_match_jax(name):
    """launch_tiered + materialize_chunk decide as the JAX package, row for
    row (targets, replica counts, errors, speculative decisions); in one
    launch, with the residual biting; and, without a spread row or a
    speculative pass, as the port's own solve_tiers_sequential."""
    clusters, bindings, placed, mode = _fixture(name)
    jarr = jcore.ArrayScheduler(clusters)
    tarr = TorchScheduler(conv(clusters), device="cpu")
    n0 = tpre.LAUNCHES.tiered
    pend = tpre.launch_tiered(tarr, conv(bindings), placed=conv(placed))
    got = tarr.materialize_chunk(pend)
    want = jarr.materialize_chunk(jpre.launch_tiered(jarr, bindings, placed=placed))
    assert [_view(d) for d in got] == [_view(d) for d in want]
    assert tpre.LAUNCHES.tiered - n0 == 1
    state = pend["state"]
    assert (state["cand_dev"] is None) == (mode == "dense")
    if name == "speculative":
        spec = got[0].speculative
        assert not got[0].ok and spec is not None and spec.ok  # short, then placed
        assert got[1].speculative is None  # not armed
        return
    if name == "spread_row":
        assert pend["std_rows"] == [3] and got[3].ok
        return
    if name == "overflow":  # decoded through the result-row fetch
        assert all(d.ok for d in got) and max(len(d.targets) for d in got) > 128
        return
    seq = tpre.solve_tiers_sequential(conv(clusters), conv(bindings), device="cpu")
    assert [_view(d)[:3] for d in seq] == [_view(d)[:3] for d in got]
    blind = tarr.schedule(conv(bindings))
    assert any(_view(a)[:3] != _view(b)[:3] for a, b in zip(got, blind))
    if name == "unschedulable_middle":
        assert not got[1].ok and got[2].ok


# --------------------------------------------------------------------------
# (e): preemption plans
# --------------------------------------------------------------------------


def _plan_view(p):
    return (p.key, p.priority, p.feasible, p.error,
            [(t.name, t.replicas) for t in p.targets],
            [(v.key, v.cluster, v.replicas, v.priority) for v in p.victims])


def _ledger_case():
    """TestPreemption's two-preemptors-share-a-ledger fleet: one cluster
    held whole by a priority-0 victim, two preemptors at 20 and 10."""
    clusters = [new_cluster_with_resource(
        "solo", allocatable={"cpu": 8.0, "memory": 64.0, "pods": 200.0},
        allocated={"cpu": 8.0})]
    victim = make_binding("victim", 8, dyn_placement(), cpu=1.0)
    victim.spec.schedule_priority = 0
    mark_placed(victim, [("solo", 8)])
    pre = []
    for i, prio in enumerate((20, 10)):
        rb = make_binding(f"urgent-{i}", 4, dyn_placement(), cpu=1.0)
        rb.spec.schedule_priority = prio
        rb.spec.preemption_policy = PREEMPT_LOWER_PRIORITY
        pre.append(rb)
    return clusters, [victim], pre


@pytest.mark.parametrize("case", ["single", "shared_ledger", "no_victims"])
def test_plan_preemption_matches_jax(case):
    """plan_preemption: one augmented launch per distinct priority, then
    the host victim selection — plans (feasibility, targets, victims,
    errors) identical to the JAX planner's."""
    if case == "shared_ledger":
        clusters, placed, pre = _ledger_case()
    else:
        tp = jtests.TestPreemption()
        clusters, placed, pre = tp._fleet(), [tp._victim()], [tp._preemptor()]
        if case == "no_victims":
            placed[0].spec.schedule_priority = 50
    jarr = jcore.ArrayScheduler(clusters)
    tarr = TorchScheduler(conv(clusters), device="cpu")
    n0 = tpre.LAUNCHES.preempt
    got = tpre.plan_preemption(tarr, conv(placed), conv(pre))
    want = jpre.plan_preemption(jarr, placed, pre)
    assert [_plan_view(p) for p in got] == [_plan_view(p) for p in want]
    launched = 0 if case == "no_victims" else len({rb.spec.schedule_priority for rb in pre})
    assert tpre.LAUNCHES.preempt - n0 == launched
    if case == "shared_ledger":
        cut = sum(v.replicas for p in got for v in p.victims)  # one plan per group
        assert all(p.feasible for p in got) and cut == 8
    elif case == "single":
        assert got[0].feasible and got[0].victims
    else:
        assert got[0].error == "no lower-priority replicas to reclaim"


def test_plan_from_speculative_and_preview_match_jax():
    """The speculative path (the plan read from decision.speculative, no
    extra launch) and the preview (the planner on a fresh encoding) give
    the JAX package's plans, and the preview equals the planner's plan."""
    clusters, bindings, placed = _preempt_mix()
    jarr = jcore.ArrayScheduler(clusters)
    tarr = TorchScheduler(conv(clusters), device="cpu")
    t_b, t_placed = conv(bindings), conv(placed)
    got_dec = tarr.materialize_chunk(tpre.launch_tiered(tarr, t_b, placed=t_placed))
    want_dec = jarr.materialize_chunk(jpre.launch_tiered(jarr, bindings, placed=placed))
    n0 = (tpre.LAUNCHES.tiered, tpre.LAUNCHES.preempt)
    got = tpre.plan_from_speculative(tarr, t_placed, [(t_b[0], got_dec[0].speculative)])
    assert (tpre.LAUNCHES.tiered, tpre.LAUNCHES.preempt) == n0  # no extra launch
    want = jpre.plan_from_speculative(jarr, placed, [(bindings[0], want_dec[0].speculative)])
    assert [_plan_view(p) for p in got] == [_plan_view(p) for p in want]
    assert got[0].feasible and got[0].victims
    preview = tpre.preview_preemption(conv(clusters), t_placed + [t_b[0]], t_b[0], device="cpu")
    j_preview = jpre.preview_preemption(clusters, placed + [bindings[0]], bindings[0])
    assert _plan_view(preview) == _plan_view(j_preview)
    planned = tpre.plan_preemption(tarr, t_placed, [t_b[0]])[0]
    assert _plan_view(preview) == _plan_view(planned)
    assert t_placed[0].spec.clusters[0].replicas == 4  # nothing mutated


# --------------------------------------------------------------------------
# (f), (g): routing, counts, what raises
# --------------------------------------------------------------------------


def test_routing_matches_jax():
    """wants_tiers / wants_workload_solve route as the reference: mixed
    priorities tier, a uniform batch does not, an armed row asks for the
    workload solve up to SPECULATE_MAX_ROWS rows, gang members are never
    armed."""
    clusters = tight_fleet()
    jarr = jcore.ArrayScheduler(clusters)
    tarr = TorchScheduler(conv(clusters), device="cpu")
    uniform = [make_binding(f"u-{i}", 2, dyn_placement(), cpu=0.5) for i in range(4)]
    armed = [make_binding(f"a-{i}", 2, dyn_placement(), cpu=0.5) for i in range(3)]
    armed[1].spec.preemption_policy = PREEMPT_LOWER_PRIORITY
    gang = make_binding("g", 2, dyn_placement(), cpu=0.5)
    gang.spec.preemption_policy = PREEMPT_LOWER_PRIORITY
    gang.spec.gang_name, gang.spec.gang_size = "team", 3
    big = [make_binding(f"x-{i}", 1, dyn_placement(), cpu=0.1)
           for i in range(jpre.SPECULATE_MAX_ROWS)] + armed
    batches = [uniform, mixed_priority_bindings(n=6), armed, [gang], big, [], uniform[:1]]
    for b in batches:
        tb = conv(b)
        assert tpre.wants_tiers(tarr, tb) == jpre.wants_tiers(jarr, b)
        for pre in (True, False):
            assert (tpre.wants_workload_solve(tarr, tb, preemption=pre)
                    == jpre.wants_workload_solve(jarr, b, preemption=pre))
        assert ([tpre.armed_for_preemption(rb) for rb in tb]
                == [jpre.armed_for_preemption(rb) for rb in b])
    assert tpre.wants_workload_solve(tarr, conv(armed))
    assert not tpre.wants_workload_solve(tarr, conv(big))
    assert tpre.SPECULATE_MAX_ROWS == jpre.SPECULATE_MAX_ROWS
    # the tier count is padded to a pow2 bucket, as the reference reports it
    b5 = mixed_priority_bindings(n=5)
    for i, rb in enumerate(b5):
        rb.spec.schedule_priority = i
    pend = tpre.launch_tiered(tarr, conv(b5))
    assert pend["n_tiers"] == jpre.launch_tiered(jarr, b5)["n_tiers"] == 8


def test_unported_paths_raise(monkeypatch):
    """A default device without a card raises, naming what is missing;
    registered-estimator answers (which raised until the estimator slice)
    and a non-tiered chunk through launch_chunk / materialize_chunk (which
    raised until the chunk-surface slice) decide as the JAX package."""
    clusters = tight_fleet()
    tarr = TorchScheduler(conv(clusters), device="cpu")
    ref = mixed_priority_bindings(n=4)
    bindings = conv(ref)
    extra = np.asarray([[-1, 0, 2], [1, -1, -1], [0, 3, 1], [-1, -1, -1]], np.int32)
    want = jcore.ArrayScheduler(clusters).materialize_chunk(
        jpre.launch_tiered(jcore.ArrayScheduler(clusters), ref, extra_avail=extra))
    got = tarr.materialize_chunk(tpre.launch_tiered(tarr, bindings, extra_avail=extra))
    assert [_view(d) for d in got] == [_view(d) for d in want]
    want = jcore.ArrayScheduler(clusters).materialize_chunk(
        jcore.ArrayScheduler(clusters).launch_chunk(ref, extra_avail=extra))
    got = tarr.materialize_chunk(tarr.launch_chunk(bindings, extra_avail=extra))
    assert [_view(d) for d in got] == [_view(d) for d in want]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.preview_preemption(conv(clusters), bindings, bindings[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.solve_tiers_sequential(conv(clusters), bindings)
