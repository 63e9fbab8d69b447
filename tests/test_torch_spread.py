"""The PyTorch port's spread-constrained placement held against the JAX
package.

Each plain version of the spread kernels (`group_score_plain`,
`packed_selection_plain`, `spread_tail_plain`, `combo_select_plain`)
against the JAX program it replaces, run by JAX on the CPU, on seeded
tie-heavy arrays; the port's host combination search against the JAX
one; then whole rounds of the port's ArrayScheduler(device="cpu") against
the JAX ArrayScheduler, decision for decision, in both rounds. All
comparisons are exact (integer outputs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.api import policy as jpol  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.sched import spread_batch as jsb  # noqa: E402
from karmada_tpu.testing.fixtures import synthetic_fleet  # noqa: E402

from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import batch_from_numpy, from_reference_objects  # noqa: E402
from karmada_tpu_torch.sched import spread_batch as tsb  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402

from test_torch_scheduler import _binding, _decision_view, _dyn  # noqa: E402


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _layouts(rng, C, R, skewed):
    """The same region layout in both packages: region ids with regionless
    columns, and a mega region holding most of the fleet when skewed."""
    rid = rng.integers(-1, R, C).astype(np.int32)
    if skewed:
        rid = np.where(rng.random(C) < 0.6, 0, rid)
    names = [f"region-{i:02d}" for i in rng.permutation(R)]
    rank = rng.permutation(C).astype(np.int32)
    return jsb.RegionLayout(rid, names, rank), tsb.RegionLayout(rid, names, rank)


# --------------------------------------------------------------------------
# plain kernels against the JAX programs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["balanced", "skewed", "negative", "one_column",
                                  "whole_fleet"])
def test_group_score_plain_matches_jax(case):
    """Tie-heavy scores and availability (few distinct values, so the name
    rank decides many orders), need and target spanning 0 to past the
    region sizes. "negative" holds negative scores and availability, where
    the prefix is not monotone: the first satisfying position is the grid
    program's, which the segmented twin does not claim. "one_column" adds
    a region of a single column, "whole_fleet" puts every column in one
    region."""
    seed = {"balanced": 0, "skewed": 1, "negative": 2, "one_column": 3, "whole_fleet": 4}[case]
    rng = np.random.default_rng(seed)
    C, R, B, S = 150, 7, 24, 18
    jl, tl = _layouts(rng, C, R, skewed=case == "skewed")
    if case in ("one_column", "whole_fleet"):
        rid = np.zeros(C, np.int32)
        if case == "one_column":
            rid = rng.integers(-1, R - 1, C).astype(np.int32)
            rid[rid == R - 1] = 0
            rid[rng.integers(C)] = R - 1  # region R - 1: one column
        names = [f"region-{i:02d}" for i in rng.permutation(R if case == "one_column" else 1)]
        rank = rng.permutation(C).astype(np.int32)
        jl, tl = jsb.RegionLayout(rid, names, rank), tsb.RegionLayout(rid, names, rank)
    feas = rng.random((B, C)) < 0.85
    score = rng.integers(0, 3, (B, C)).astype(np.int32)
    avail = rng.choice([0, 1, 1, 3, 9], (B, C)).astype(np.int32)
    prev = np.where(rng.random((B, C)) < 0.1, 2, 0).astype(np.int32)
    if case == "negative":
        score[::3] -= 3
        avail[::2] = np.where(rng.random(C) < 0.2, -4, avail[::2])
    rows = rng.integers(0, B, S).astype(np.int32)
    reps = rng.integers(1, 40, S).astype(np.int64)
    need = rng.integers(1, 6, S).astype(np.int64)
    target = rng.integers(0, 60, S).astype(np.int64)
    dup = rng.random(S) < 0.3
    lay = tl.tensors("cpu")
    t = batch_from_numpy(dict(f=feas, s=score, a=avail, p=prev, r=rows, reps=reps, need=need,
                              tgt=target, dup=dup), "cpu")
    got = kernels.group_score_plain(
        t["f"], t["s"], t["a"], t["p"], t["r"], t["reps"], t["need"], t["tgt"], t["dup"],
        lay["perm"], lay["seg_start"], lay["seg_end"], lay["rank_p"],
    )
    args = (feas[rows], score[rows], avail[rows], prev[rows], reps, need, target, dup)
    programs = [jsb.group_score_kernel]
    if case != "negative":
        programs.append(jsb.group_score_kernel_segmented)
    for program in programs:
        want = program(*args, layout=jl)
        for name, a, b in zip(("weight", "value", "avail_sum", "feas_count"), got, want):
            np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=f"{program.__name__} {name}")
    weight = _n(got[0])
    if case == "whole_fleet":  # one region: one weight a row
        assert (weight > 0).sum() > S // 2 and len(np.unique(weight)) > 5
    else:
        assert (weight > 0).sum() > S and len(np.unique(weight)) > 10


def _selection_inputs(rng, B, C, R, n):
    jl, tl = _layouts(rng, C, R, skewed=False)
    rows = rng.integers(0, B, n).astype(np.int32)
    chosen = rng.random((n, R)) < 0.5
    return jl, tl, rows, chosen


def test_packed_selection_plain_matches_jax():
    rng = np.random.default_rng(3)
    for C in (5, 96, 301):
        feas = rng.random((13, C)) < 0.6
        jl, tl, rows, chosen = _selection_inputs(rng, 13, C, 4, 9)
        want = jsb.packed_selection_kernel(feas[rows], chosen, layout=jl)
        got = kernels.packed_selection_plain(
            torch.from_numpy(feas), torch.from_numpy(rows), torch.from_numpy(chosen),
            tl.tensors("cpu")["rid"],
        )
        np.testing.assert_array_equal(_n(got), np.asarray(want))


@pytest.mark.parametrize("case", ["one_column", "odd_width", "nothing_chosen"])
def test_packed_selection_plain_edges_match_jax(case):
    """Rows of one column (in a region), a width that is no multiple of 8
    (the last byte's high bits stay 0) and rows that chose no region at
    all (every byte 0)."""
    rng = np.random.default_rng({"one_column": 30, "odd_width": 31, "nothing_chosen": 32}[case])
    C, R, B, n = {"one_column": 1, "odd_width": 77, "nothing_chosen": 96}[case], 4, 13, 9
    rid = rng.integers(0 if case == "one_column" else -1, R, C).astype(np.int32)
    names = [f"region-{i:02d}" for i in rng.permutation(R)]
    rank = rng.permutation(C).astype(np.int32)
    jl, tl = jsb.RegionLayout(rid, names, rank), tsb.RegionLayout(rid, names, rank)
    feas = rng.random((B, C)) < (1.0 if case == "one_column" else 0.7)
    rows = rng.integers(0, B, n).astype(np.int32)
    chosen = (rng.random((n, R)) < 0.5) & (case != "nothing_chosen")
    want = np.asarray(jsb.packed_selection_kernel(feas[rows], chosen, layout=jl))
    got = _n(kernels.packed_selection_plain(
        torch.from_numpy(feas), torch.from_numpy(rows), torch.from_numpy(chosen),
        tl.tensors("cpu")["rid"]))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n, (C + 7) // 8)
    if case == "nothing_chosen":
        assert not got.any()
    else:
        assert got.any() and not (got[:, -1] >> ((C - 1) % 8 + 1)).any()


@pytest.mark.parametrize("has_agg", [False, True])
def test_spread_tail_plain_matches_jax(has_agg):
    """Dynamic-weight, Aggregated (with has_agg) and static rows with the
    zero weights, Steady up/down/eq and Fresh rows, tie-heavy values."""
    rng = np.random.default_rng(5 + has_agg)
    B, C, R, n = 20, 160, 5, 16
    feas = rng.random((B, C)) < 0.8
    prev = np.where(rng.random((B, C)) < 0.05, rng.integers(1, 4, (B, C)), 0).astype(np.int32)
    avail = rng.choice([0, 2, 2, 7, 40], (B, C)).astype(np.int32)
    tie = rng.integers(0, 3, (B, C)).astype(np.int32)
    strategy = rng.choice([2, 3, 4] if has_agg else [2, 3], B).astype(np.int32)
    replicas = rng.integers(1, 200, B).astype(np.int32)
    fresh = rng.random(B) < 0.25
    jl, tl, rows, chosen = _selection_inputs(rng, B, C, R, n)
    replicas[rows[::4]] = np.where(feas[rows[::4]], prev[rows[::4]], 0).sum(-1)  # Steady eq
    want = jsb.spread_tail_kernel(
        feas[rows], avail[rows], prev[rows], tie[rows], chosen, strategy[rows],
        replicas[rows], fresh[rows], layout=jl, topk=32, narrow=False, has_agg=has_agg,
    )
    d = batch_from_numpy(dict(feas=feas, avail=avail, prev=prev, tie=tie, rows=rows,
                              chosen=chosen, strategy=strategy, replicas=replicas,
                              fresh=fresh), "cpu")
    got = kernels.spread_tail_plain(
        d["feas"], d["avail"], d["prev"], d["tie"], d["rows"], d["chosen"],
        tl.tensors("cpu")["rid"], d["strategy"], d["replicas"], d["fresh"],
        topk=32, has_agg=has_agg,
    )
    names = ("result", "unschedulable", "avail_sum", "feas_count", "nnz", "top_idx", "top_val")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    assert (_n(got[0]) > 0).sum(-1).max() > 3


@pytest.mark.parametrize("R,kmin,kmax", [(12, 2, 5), (10, 1, 10), (65, 1, 1), (65, 2, 2),
                                         (100, 1, 1), (100, 2, 2), (200, 1, 2)])
def test_combo_select_plain_matches_jax(R, kmin, kmax):
    """7 * L <= 62 (the packed discovery key) and L = 10 (the first
    candidate and the real tie count); heavy (Σw, Σv) ties; fleets of 65,
    100 and 200 regions (past the kernel's former 64-region cap; past 128
    a group-order position outgrows its 7-bit slot of the discovery key,
    whose slots are then added, as the reference adds them)."""
    rng = np.random.default_rng(R)
    S = 40
    W = rng.integers(0, 5, (S, R)).astype(np.int64) * 1000
    V = rng.integers(0, 4, (S, R)).astype(np.int32)
    kmax_row = rng.integers(kmin, kmax + 1, S).astype(np.int32)
    rname = rng.permutation(R).astype(np.int32)
    members_pad, sizes = tsb._combos(R, kmin, kmax).tensors("cpu")
    for cmin in (0, 4, 40):
        want = jsb._combo_select_kernel(W, V, kmax_row, rname,
                                        table=jsb._combos(R, kmin, kmax), cmin=cmin, kmin=kmin)
        got = kernels.combo_select_plain(
            torch.from_numpy(W), torch.from_numpy(V), torch.from_numpy(kmax_row),
            torch.from_numpy(rname), members_pad, sizes, cmin=cmin, kmin=kmin,
        )
        for name, a, b in zip(("first_idx", "n_ties", "none_feasible"), got, want):
            np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=f"cmin={cmin} {name}")


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("case", ["balanced", "skewed"])
def test_select_regions_batch_matches_jax(case, device):
    """The host combination search (device=False) and its combo_select
    route (device=True, the plain version here) against the JAX
    select_regions_batch; "skewed" has many interchangeable tiny regions
    (exact ties resolved by discovery order) and a constraint whose
    enumeration overflows the table (the class DFS)."""
    rng = np.random.default_rng(11 if case == "skewed" else 12)
    R = 21 if case == "skewed" else 12
    jl, tl = _layouts(rng, 200, R, skewed=case == "skewed")
    S = 48
    if case == "skewed":
        W = np.where(rng.random((S, R)) < 0.8, 5000, rng.integers(1, 4, (S, R)) * 1000)
        V = np.where(rng.random((S, R)) < 0.8, 1, rng.integers(0, 3, (S, R))).astype(np.int32)
        cfgs = [(2, 3, 3), (4, 6, 5), (1, 0, 2)]
    else:
        W = rng.integers(0, 6, (S, R)).astype(np.int64) * 1000 + rng.integers(0, 3, (S, R))
        V = rng.integers(0, 5, (S, R)).astype(np.int32)
        cfgs = [(2, 3, 3), (3, 0, 6), (2, 2, 0)]
    W[::5] = W[0]  # duplicate rows (the dedup)
    V[::5] = V[0]
    for rmin, rmax, cmin in cfgs:  # (the search reads no other config field)
        jc = jsb.SpreadConfig(rmin=rmin, rmax=rmax, cmin=cmin, cmax=0, duplicated=False)
        tc = tsb.SpreadConfig(rmin=rmin, rmax=rmax, cmin=cmin, cmax=0, duplicated=False)
        want = jsb.select_regions_batch(W.astype(np.int64), V, jc, jl, device=device)
        got = tsb.select_regions_batch(W.astype(np.int64), V, tc, tl, device=device)
        np.testing.assert_array_equal(got.chosen, want.chosen)
        assert got.errors == want.errors
        assert sorted(got.fallback) == sorted(want.fallback)


# --------------------------------------------------------------------------
# whole rounds against the JAX ArrayScheduler
# --------------------------------------------------------------------------


def _region_spread(rmin, rmax, cmin, divided):
    """bench.py _spread_placements' shape: region MinGroups/MaxGroups plus
    a cluster MinGroups, Duplicated or Aggregated."""
    cons = [
        jpol.SpreadConstraint(spread_by_field=jpol.SPREAD_BY_FIELD_REGION,
                              min_groups=rmin, max_groups=rmax),
        jpol.SpreadConstraint(spread_by_field=jpol.SPREAD_BY_FIELD_CLUSTER, min_groups=cmin),
    ]
    p = _dyn(True) if divided else jpol.Placement(
        cluster_affinity=jpol.ClusterAffinity(cluster_names=[]))
    p.spread_constraints = cons
    return p


def _spread_mix(rng, clusters, n_bindings, n_placements=24, window_names=None):
    """Config 4's mix at a small size: region spread over the whole fleet,
    ~70 % Duplicated, 30 % Aggregated; one in four with a previous
    placement. `window_names` adds rows whose affinity names those clusters
    (their feasible sets fit the candidate window)."""
    names = [c.name for c in clusters]
    placements = []
    for k in range(n_placements):
        rmin = int(rng.integers(2, 5))
        placements.append(_region_spread(rmin, rmin + int(rng.integers(0, 3)),
                                         int(rng.integers(rmin, rmin + 3)), k % 10 >= 7))
    if window_names:
        for p in placements[::3]:
            p = _region_spread(2, 3, 2, divided=p.replica_scheduling is not None)
            p.cluster_affinity = jpol.ClusterAffinity(cluster_names=list(window_names))
            placements.append(p)
    bindings = []
    for i in range(n_bindings):
        prev = None
        if i % 4 == 0:
            prev = {names[int(rng.integers(len(names)))]: int(rng.integers(1, 4))}
        bindings.append(_binding(i, int(rng.integers(1, 32)), placements[i % len(placements)],
                                 float(rng.choice([0.1, 0.25, 0.5])), prev=prev))
    return bindings


def _skewed_fleet(n, seed):
    clusters = synthetic_fleet(n, seed=seed, ready_fraction=0.95)
    rng = np.random.default_rng(seed)
    for i, c in enumerate(clusters):
        c.spec.region = "mega-region" if i < int(n * 0.6) else f"small-{int(rng.integers(0, 21))}"
    return clusters


def _fallback_mix(rng, clusters):
    """Rows the batched path cannot take, and the error paths: cluster-only
    constraints (Duplicated, divided, non-workload), a cluster MaxGroups
    cap, zone and provider constraints, an unsatisfiable region MinGroups,
    a divided row over 128 replicas, and plain region rows beside them."""
    S = jpol.SpreadConstraint
    cluster_only = [S(spread_by_field=jpol.SPREAD_BY_FIELD_CLUSTER, min_groups=2, max_groups=4)]
    capped = [S(spread_by_field=jpol.SPREAD_BY_FIELD_REGION, min_groups=2),
              S(spread_by_field=jpol.SPREAD_BY_FIELD_CLUSTER, min_groups=2, max_groups=3)]
    zone = [S(spread_by_field=jpol.SPREAD_BY_FIELD_ZONE, min_groups=2)]
    provider = [S(spread_by_field=jpol.SPREAD_BY_FIELD_PROVIDER, min_groups=2),
                S(spread_by_field=jpol.SPREAD_BY_FIELD_REGION, min_groups=2)]
    too_many = [S(spread_by_field=jpol.SPREAD_BY_FIELD_REGION, min_groups=40)]
    shapes = []
    for cons in (cluster_only, capped, zone, provider, too_many):
        for divided in (False, True):
            p = _dyn(False) if divided else jpol.Placement(
                cluster_affinity=jpol.ClusterAffinity(cluster_names=[]))
            p.spread_constraints = cons
            shapes.append(p)
    p = _dyn(True)
    p.spread_constraints = capped[:1]
    bindings = [_binding(i, int(rng.integers(1, 40)), shapes[i % len(shapes)], 0.25)
                for i in range(2 * len(shapes))]
    bindings.append(_binding(900, 300, p, 0.1))  # divided over 128: the fallback
    bindings.append(_binding(901, 0, shapes[0], 0.1))  # non-workload, cluster-only
    bindings += _spread_mix(rng, clusters, 12)
    return bindings


def _case(name):
    """(clusters, bindings, candidate_k) of one named spread round."""
    rng = np.random.default_rng(CASES.index(name))
    if name in ("balanced_dense", "balanced_window"):
        clusters = synthetic_fleet(300, seed=0, ready_fraction=0.95)
        window = [c.name for c in clusters[::7]] if name == "balanced_window" else None
        return clusters, _spread_mix(rng, clusters, 400, window_names=window), (
            0 if name == "balanced_dense" else None)
    if name == "skewed":
        clusters = _skewed_fleet(120, seed=3)
        bindings = _spread_mix(rng, clusters, 60)
        p = _region_spread(4, 5, 6, divided=False)  # C(22, 4..5) > 40 000: class DFS
        bindings += [_binding(500 + i, 3, p, 0.1) for i in range(4)]
        return clusters, bindings, 0
    if name in ("fallback_dense", "fallback_window"):
        clusters = synthetic_fleet(80, seed=4, ready_fraction=0.9)
        return clusters, _fallback_mix(rng, clusters), 0 if name == "fallback_dense" else 16
    raise KeyError(name)


CASES = ("balanced_dense", "balanced_window", "skewed", "fallback_dense", "fallback_window")


@pytest.mark.parametrize("case", CASES)
def test_spread_round_matches_jax(case, monkeypatch):
    """Whole spread rounds: the port's ArrayScheduler(device="cpu") and the
    JAX ArrayScheduler decide identically, row for row, and the round went
    through the spread kernels it should."""
    clusters, bindings, k = _case(case)
    calls = []
    for name in ("group_score", "packed_selection", "spread_tail", "candidate_tail",
                 "dense_tail"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append(_n), _fn(*a, **kw))[1])
    want = jcore.ArrayScheduler(clusters, candidate_k=k).schedule(bindings)
    got = TorchScheduler(from_reference_objects(clusters), candidate_k=k,
                         device="cpu").schedule(from_reference_objects(bindings))
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
    assert sum(d.ok for d in got) > len(got) // 2
    if case.startswith("balanced") or case == "skewed":
        assert {"group_score", "packed_selection", "spread_tail"} <= set(calls)
    if case == "balanced_window":
        assert "candidate_tail" in calls  # window rows re-ran the B2 tail
    if case.startswith("fallback"):
        errors = {d.error for d in got if d.error}
        assert "just support cluster and region spread constraint" in errors
        assert any("MinGroups" in e for e in errors)
        wide = next(d for d in got if d.key.endswith("/app-900"))
        assert wide.ok and sum(t.replicas for t in wide.targets) == 300
    if case == "fallback_dense":
        assert "dense_tail" in calls  # the restricted re-solve


def test_fallback_without_cluster_affinity_raises():
    """A per-row re-solve with the ClusterAffinity plugin disabled carries
    its selection on the extra_mask channel, since the filter ignores the
    affinity table (the port raised here until that channel was ported):
    the decision is the JAX package's."""
    clusters = synthetic_fleet(40, seed=6)
    p = jpol.Placement(cluster_affinity=jpol.ClusterAffinity(cluster_names=[]))
    p.spread_constraints = [jpol.SpreadConstraint(
        spread_by_field=jpol.SPREAD_BY_FIELD_CLUSTER, min_groups=2, max_groups=3)]
    plugins = ["*", "-ClusterAffinity"]
    rb = _binding(0, 4, p, 0.1)
    want = jcore.ArrayScheduler(clusters, candidate_k=0, plugins=plugins).schedule([rb])
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=0,
                          plugins=plugins, device="cpu")
    got = port.schedule(from_reference_objects([rb]))
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
    assert got[0].ok and 2 <= len(got[0].targets) <= 3


@pytest.mark.parametrize("candidate_k", [0, 16])
def test_per_row_resolve_without_cluster_affinity_matches_jax(candidate_k, monkeypatch):
    """The extra_mask repair over a mixed batch: cluster-only spread rows
    (Duplicated, divided, Aggregated, capped and uncapped), whose per-row
    re-solve runs with the ClusterAffinity plugin disabled, among plain
    rows, in the dense round and through the compact round's dense
    re-solve of wide rows — decision for decision against the JAX
    ArrayScheduler, and the re-solve's dense_filter took the mask."""
    clusters = synthetic_fleet(80, seed=7, ready_fraction=0.9)
    rng = np.random.default_rng(7)
    bindings = []
    for i in range(24):
        p = _dyn(aggregated=i % 3 == 1) if i % 3 else jpol.Placement(
            cluster_affinity=jpol.ClusterAffinity(cluster_names=[]))
        if i % 2 == 0:
            p.spread_constraints = [jpol.SpreadConstraint(
                spread_by_field=jpol.SPREAD_BY_FIELD_CLUSTER, min_groups=int(rng.integers(1, 4)),
                max_groups=int(rng.integers(4, 9)) if i % 4 == 0 else 0)]
        bindings.append(_binding(i, int(rng.integers(1, 30)), p, float(rng.choice([0.1, 0.5]))))
    plugins = ["*", "-ClusterAffinity"]
    masks = []
    filt = kernels.dense_filter

    def spy(*a, **kw):
        masks.append(kw.get("extra_mask") is not None)
        return filt(*a, **kw)

    want = jcore.ArrayScheduler(clusters, candidate_k=candidate_k, plugins=plugins).schedule(
        bindings)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=candidate_k,
                          plugins=plugins, device="cpu")
    monkeypatch.setattr(kernels, "dense_filter", spy)
    got = port.schedule(from_reference_objects(bindings))
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
    assert any(masks) and sum(d.ok for d in got) > 12
