"""The PyTorch port's dense round held against the JAX package.

Each plain version of the dense round's kernels (`dense_filter_plain`,
`dense_tail_plain`, `pack_rows_plain`, `feas_idx_plain`) against the JAX
program it replaces, run by JAX on the CPU, on batches encoded by both
packages from the same converted objects or on seeded tie-heavy arrays;
then whole dense rounds of the port's ArrayScheduler(device="cpu") against
the JAX ArrayScheduler, decision for decision. All comparisons are exact
(integer outputs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.api import policy as jpol  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402

from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import batch_from_numpy, from_reference_objects  # noqa: E402
from karmada_tpu_torch.sched import core as tcore  # noqa: E402
from karmada_tpu_torch.sched.candidates import DENSE_SOLVE_ANNOTATION, dense_reason  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402

from test_torch_candidates import BATCH_FIELDS, FLEET_FIELDS  # noqa: E402
from test_torch_scheduler import _binding, _decision_view, _dyn, flagship_mix  # noqa: E402

FILTER_OUT = ("feasible", "score", "avail", "prev_replicas", "tie", "feas_count")
TAIL_OUT = ("result", "unschedulable", "avail_sum", "nnz")


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _encode_both(n_clusters=96, n_bindings=128):
    clusters, bindings = flagship_mix(n_clusters=n_clusters, n_bindings=n_bindings)
    ref = jcore.ArrayScheduler(clusters, candidate_k=0)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=0, device="cpu")
    jb = ref._pad(ref.batch_encoder.encode(bindings))
    tb = port._pad(port.batch_encoder.encode(from_reference_objects(bindings)))
    for name in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
    return ref, port, jb, tb


def _port_filter(port, tb, extra=None, mask=None):
    f = port._fleet_dev
    t = batch_from_numpy({n: getattr(tb, n) for n in BATCH_FIELDS}, "cpu")
    return kernels.dense_filter_plain(
        *(f[n] for n in FLEET_FIELDS),
        t["replicas"], t["unknown_request"], t["gvk"], t["tol_tables"], t["tol_idx"],
        t["aff_masks"], t["aff_idx"], t["prev_idx"], t["prev_rep"], t["evict_idx"],
        t["seeds"], t["req_unique"], t["req_idx"],
        None if extra is None else torch.from_numpy(extra),
        plugin_bits=port._plugin_bits,
        extra_mask=None if mask is None else torch.from_numpy(mask),
    ), t


@pytest.mark.parametrize("with_extra", [False, True])
def test_dense_filter_plain_matches_filter_kernel_compact(with_extra):
    ref, port, jb, tb = _encode_both()
    B, C = len(jb.replicas), len(ref.fleet.names)
    extra = None
    if with_extra:
        extra = np.random.default_rng(0).integers(-1, 6, (B, C)).astype(np.int32)
    want = jcore._filter_kernel_compact(
        *ref.filter_kernel_args(jb, extra), plugin_bits=ref._plugin_bits,
    )
    got, _ = _port_filter(port, tb, extra)
    for name, a, b in zip(FILTER_OUT, got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    assert (_n(got[1]) > 0).any() and (_n(got[3]) > 0).any()  # locality, prev rows
    if with_extra:  # the min-merge changed some answers
        assert (_n(got[2]) != np.asarray(jcore._filter_kernel_compact(
            *ref.filter_kernel_args(jb), plugin_bits=ref._plugin_bits)[2])).any()


@pytest.mark.parametrize("plugins", [None, ["*", "-ClusterAffinity"]])
def test_dense_filter_plain_extra_mask_matches_filter_kernel_compact(plugins):
    """The per-row extra_mask channel (the spread selection of a per-row
    re-solve) ANDed into feasible after the plugin filters and before the
    count, as the reference's filter_phase does, with and without the
    ClusterAffinity plugin."""
    ref, port, jb, tb = _encode_both()
    if plugins:
        ref = jcore.ArrayScheduler(ref.clusters, candidate_k=0, plugins=plugins)
        port = TorchScheduler(port.clusters, candidate_k=0, plugins=plugins, device="cpu")
    B, C = len(jb.replicas), len(ref.fleet.names)
    mask = np.random.default_rng(1).random((B, C)) < 0.5
    want = jcore._filter_kernel_compact(
        *ref.filter_kernel_args(jb, None, mask), plugin_bits=ref._plugin_bits,
    )
    got, _ = _port_filter(port, tb, None, mask)
    for name, a, b in zip(FILTER_OUT, got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    assert (_n(got[5]) < _n(_port_filter(port, tb)[0][5])).any()  # the mask bit


def _tie_heavy_tail_inputs(rng, B, C):
    """Filter-output-shaped [B, C] arrays with few distinct values: many
    columns share each weight, so the dispenser's cutoff falls inside a tie
    group and the (last, tie) keys — themselves few-valued — and finally the
    column decide. Every strategy, Steady up/down/eq and Fresh rows."""
    feas = rng.random((B, C)) < 0.8
    prev = np.where(rng.random((B, C)) < 0.03, rng.integers(1, 4, (B, C)), 0).astype(np.int32)
    assigned = np.where(feas, prev, 0).sum(-1)
    replicas = rng.integers(0, 700, B)
    mode = np.arange(B) % 4
    replicas = np.where(mode == 2, assigned, replicas)
    replicas = np.where((mode == 1) & (assigned > 1), assigned - 1, replicas)
    return {
        "feasible": feas,
        "avail": rng.choice([0, 2, 2, 2, 7, 40], (B, C)).astype(np.int32),
        "prev": prev,
        "tie": rng.integers(0, 3, (B, C)).astype(np.int32),
        "weight_tables": rng.choice([0, 3, 3, 3, 5], (4, C)).astype(np.int64),
        "weight_idx": rng.integers(0, 4, B).astype(np.int32),
        "strategy": rng.choice([1, 2, 3, 4], B).astype(np.int32),
        "replicas": replicas.astype(np.int32),
        "fresh": mode == 3,
    }


def _tail_both(d, rows, topk, has_agg):
    """JAX `_tail_kernel` over the gathered rows vs `dense_tail_plain`
    reading the [B, C] arrays through the row ids."""
    want = jcore._tail_kernel(
        d["feasible"][rows], d["avail"][rows], d["prev"][rows], d["tie"][rows],
        d["weight_tables"], d["weight_idx"][rows], d["strategy"][rows],
        d["replicas"][rows], d["fresh"][rows],
        topk=topk, narrow=False, has_agg=has_agg,
    )
    t = batch_from_numpy(d, "cpu")
    got = kernels.dense_tail_plain(
        t["feasible"], t["avail"], t["prev"], t["tie"],
        torch.from_numpy(rows.astype(np.int32)), t["weight_tables"], t["weight_idx"],
        t["strategy"], t["replicas"], t["fresh"], topk=topk, has_agg=has_agg,
    )
    for name, a, b in zip(TAIL_OUT, got[:4], want[:4]):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    # the window exactly (jax.lax.top_k's order), and as the decode reads it
    np.testing.assert_array_equal(_n(got[4]), np.asarray(want[4]))
    np.testing.assert_array_equal(_n(got[5]), np.asarray(want[5]))
    gi, gv = tcore._sorted_pairs(_n(got[4]), _n(got[5]))
    wi, wv = tcore._sorted_pairs(np.asarray(want[4]), np.asarray(want[5]))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)
    return got


@pytest.mark.parametrize("has_agg,topk", [(False, 128), (True, 64)])
def test_dense_tail_plain_matches_tail_kernel_tie_heavy(has_agg, topk):
    """C = 320 columns, few distinct weights: `rem` splits the cutoff tie
    group on most divided rows."""
    rng = np.random.default_rng(7 + has_agg)
    B, C = 48, 320
    d = _tie_heavy_tail_inputs(rng, B, C)
    rows = rng.permutation(B)[:40]
    rows[-3:] = rows[0]  # repeated ids, as the padded row lists carry
    got = _tail_both(d, rows, topk, has_agg)
    # the case is tie-heavy: the nonzero result counts show split groups
    res = _n(got[0])
    divided = np.isin(d["strategy"][rows], (2, 3, 4))
    assert ((res > 0).sum(-1)[divided] > 1).sum() > 10


@pytest.mark.parametrize("has_agg", [False, True])
def test_dense_tail_plain_matches_tail_kernel_encoded(has_agg):
    """On the dense round's own inputs: the filter outputs of an encoded
    flagship-mix batch and its class-1 / class-2 rows."""
    ref, port, jb, tb = _encode_both()
    (feas, _score, avail, prev, tie, _fc), t = _port_filter(port, tb)
    d = {"feasible": _n(feas), "avail": _n(avail), "prev": _n(prev), "tie": _n(tie),
         **{n: getattr(jb, n) for n in ("weight_tables", "weight_idx", "strategy",
                                        "replicas", "fresh")}}
    rows = np.flatnonzero(np.isin(jb.strategy, (4,) if has_agg else (2, 3)))
    assert len(rows) > 4
    _tail_both(d, rows, 64, has_agg)


def test_pack_rows_plain_matches_pack_rows_kernel():
    rng = np.random.default_rng(3)
    for C in (5, 96, 301):
        m = rng.random((13, C)) < 0.4
        rows = rng.permutation(13).astype(np.int32)
        np.testing.assert_array_equal(
            _n(kernels.pack_rows_plain(torch.from_numpy(m), torch.from_numpy(rows))),
            np.asarray(jcore._pack_rows_kernel(m[rows])),
        )


@pytest.mark.parametrize("k", [1, 8, 32, 96])
def test_feas_idx_plain_matches_feas_idx_kernel(k):
    rng = np.random.default_rng(k)
    m = rng.random((17, 96)) < rng.random((17, 1))  # from empty to full rows
    m[0] = False
    m[1] = True
    rows = rng.permutation(17).astype(np.int32)
    np.testing.assert_array_equal(
        _n(kernels.feas_idx_plain(torch.from_numpy(m), torch.from_numpy(rows), k)),
        np.asarray(jcore._feas_idx_kernel(m[rows], k)),
    )


# the mask kernels' widths: config 1's bucket, a bucket_cols=False fleet
# (no multiple of 16), one vector step, an unpadded 5 000
MASK_WIDTHS = (8, 77, 128, 5000)
MASK_ROWS = np.array([5, 1, 0, 11, 3, 5, 1, 9, 2, 2, 7, 0], np.int32)  # out of order, repeated


def _mask_inputs(C):
    """bool [12, C] filter rows from empty to full (row 0 all false, row 1
    all true: more feasible columns than any k < C) and MASK_ROWS."""
    rng = np.random.default_rng(C)
    m = rng.random((12, C)) < rng.random((12, 1))
    m[0] = False
    m[1] = True
    m[2] = rng.random(C) < 4 / C  # a sparse row
    return m, MASK_ROWS


@pytest.mark.parametrize("C", MASK_WIDTHS)
def test_pack_rows_reads_filter_rows_through_ids(C):
    """pack_rows(feasible, rows), plain and the CPU wrapper, is the
    reference's `_pack_rows_kernel(feasible[rows])`."""
    m, rows = _mask_inputs(C)
    want = np.asarray(jcore._pack_rows_kernel(m[rows]))
    args = (torch.from_numpy(m), torch.from_numpy(rows))
    np.testing.assert_array_equal(_n(kernels.pack_rows_plain(*args)), want)
    np.testing.assert_array_equal(_n(kernels.pack_rows(*args)), want)


@pytest.mark.parametrize("k_of", ["1", "8", "C"])
@pytest.mark.parametrize("C", MASK_WIDTHS)
def test_feas_idx_reads_filter_rows_through_ids(C, k_of):
    """feas_idx(feasible, rows, k), plain and the CPU wrapper, is the
    reference's `_feas_idx_kernel(feasible[rows], k)`, k = C included, on
    rows with more feasible columns than k and an all-false row."""
    m, rows = _mask_inputs(C)
    k = C if k_of == "C" else min(int(k_of), C)
    want = np.asarray(jcore._feas_idx_kernel(m[rows], k))
    args = (torch.from_numpy(m), torch.from_numpy(rows), k)
    np.testing.assert_array_equal(_n(kernels.feas_idx_plain(*args)), want)
    np.testing.assert_array_equal(_n(kernels.feas_idx(*args)), want)
    assert (want == kernels.FEAS_IDX_PAD).all(-1).any()  # the all-false row
    if k < C:
        assert (m[rows].sum(-1) > k).any()


# --------------------------------------------------------------------------
# whole dense rounds against the JAX ArrayScheduler
# --------------------------------------------------------------------------


def _whole_fleet_dup(rb):
    p = rb.spec.placement
    return p.cluster_affinity is None and not p.cluster_affinities and p.replica_scheduling is None


def _case(name):
    """(clusters, bindings, candidate_k, plugins, expected dense reason,
    expected mask path) of one named dense-round case."""
    if name == "disabled":
        c, b = flagship_mix()
        return c, b, 0, None, "disabled", "feas_idx"
    if name == "small_fleet":
        c, b = flagship_mix()
        return c, b, 128, None, "small_fleet", "feas_idx"
    if name == "policy":  # whole-fleet Duplicated rows over 200 clusters
        c, b = flagship_mix(seed=2, n_clusters=200, n_bindings=160)
        b[5].metadata.annotations = {DENSE_SOLVE_ANNOTATION: "true"}
        return c, b, 16, None, "policy", "pack_rows"
    if name == "feas_idx":
        c, b = flagship_mix(seed=3, n_clusters=200, n_bindings=200)
        b = [rb for rb in b if not _whole_fleet_dup(rb)]
        return c, b, 0, None, "disabled", "feas_idx"
    if name == "no_affinity_plugin":
        c, b = flagship_mix(seed=4)
        return c, b, 0, ["*", "-ClusterAffinity"], "disabled", "pack_rows"
    if name == "overflow":
        c, b = flagship_mix(seed=5, n_clusters=200, n_bindings=40)
        b.append(_binding(999, 3000, _dyn(False), 0.1))
        return c, b, 0, None, "disabled", "pack_rows"
    raise KeyError(name)


CASES = ("disabled", "small_fleet", "policy", "feas_idx", "no_affinity_plugin", "overflow")


@pytest.mark.parametrize("host_tail", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_dense_round_matches_jax(case, host_tail, monkeypatch):
    """The dense round end to end. host_tail=False runs the JAX round's
    division tails on its XLA program (KARMADA_TPU_HOST_SORTS=0),
    host_tail=True on its numpy twin (HOST_TAIL_MIN_ELEMS=0)."""
    clusters, bindings, k, plugins, reason, mask_path = _case(case)
    if host_tail:
        monkeypatch.setattr(jcore, "HOST_TAIL_MIN_ELEMS", 0)
    else:
        monkeypatch.setenv("KARMADA_TPU_HOST_SORTS", "0")
    ref = jcore.ArrayScheduler(clusters, candidate_k=k, plugins=plugins)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=k, plugins=plugins,
                          device="cpu")
    port_bindings = from_reference_objects(bindings)
    assert dense_reason(port, port_bindings) == reason

    calls = []
    for name in ("dense_filter", "dense_tail", "pack_rows", "feas_idx"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append(_n), _fn(*a, **kw))[1])
    fetched = []
    fetch = tcore.fetch_rows
    monkeypatch.setattr(tcore, "fetch_rows", lambda *a: (fetched.append(len(a[1])), fetch(*a))[1])

    want = ref.schedule(bindings)
    got = port.schedule(port_bindings)
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
    assert port.last_candidate_stats == {}
    assert calls.count("dense_filter") >= 1 and calls.count("dense_tail") >= 1
    assert mask_path in calls
    errors = {d.error.split(" ")[0] for d in got if d.error}
    assert "Clusters" in errors or case in ("feas_idx", "overflow")
    if case == "overflow":
        assert fetched  # a tail row with nnz over its window fetched its row
        row = got[-1]
        assert row.ok and len(row.targets) > 128
    if case in ("disabled", "small_fleet"):
        assert any(d.affinity_name == "backup" for d in got)  # ordered-affinity retry


@pytest.mark.parametrize("case", ["feas_idx", "policy"])
def test_dense_round_masks_read_the_filter_rows_in_place(case, monkeypatch):
    """Each dense round (the first, then its ordered-affinity retries)
    hands feas_idx / pack_rows its dense filter's own feasible output
    ([B, C], no gather of the mask rows) and the int32 ids of the real
    mask rows only (no pad rows), uploaded in the round's one row-id copy
    with the tails' padded ids, before the filter."""
    clusters, bindings, k, plugins, _reason, mask_path = _case(case)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=k, plugins=plugins,
                          device="cpu")
    port_bindings = from_reference_objects(bindings)
    events = []

    def record(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            events.append((name, a, out))
            return out
        return run

    for name in ("dense_filter", "pack_rows", "feas_idx"):
        monkeypatch.setattr(kernels, name, record(name, getattr(kernels, name)))
    monkeypatch.setattr(tcore, "to_device_packed",
                        record("upload", tcore.to_device_packed))
    port.schedule(port_bindings)

    names = [e[0] for e in events]
    assert mask_path in names
    rounds = [i for i, n in enumerate(names) if n == "upload"]
    assert rounds[0] == 0 and names.count("dense_filter") == len(rounds)
    for r, i in enumerate(rounds):
        (_, (arrays, _dev), _), (name, _, filt) = events[i], events[i + 1]
        assert name == "dense_filter"
        masks = [e for e in events[i + 2:(rounds + [len(events)])[r + 1]]
                 if e[0] in ("pack_rows", "feas_idx")]
        assert len(masks) <= 1
        assert all(a.dtype == np.int32 for a in arrays)
        for _, (feasible, rows, *_), _ in masks:
            assert feasible is filt[0]  # the filter output itself
            assert rows.dtype == torch.int32 and rows.dim() == 1
            np.testing.assert_array_equal(rows.numpy(), arrays[-1])
            ids = rows.tolist()
            assert ids == sorted(set(ids)) and ids[-1] < feasible.shape[0]
            if r == 0:  # every Duplicated / non-workload row, no pad row
                assert len(ids) == sum(port._row_class(rb, False) == 0 for rb in port_bindings)


def test_dense_round_chunks_match_one_round(monkeypatch):
    """Serial row chunks of a dense round decide as one round."""
    clusters, bindings = flagship_mix(seed=6, n_bindings=96)
    pc, pb = from_reference_objects(clusters), from_reference_objects(bindings)
    whole = TorchScheduler(pc, candidate_k=0, device="cpu").schedule(pb)
    monkeypatch.setenv("KARMADA_TPU_MAX_BC_ELEMS", str(24 * 96))
    got = TorchScheduler(pc, candidate_k=0, device="cpu").schedule(pb)
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in whole]


def test_dense_round_raises_on_unported_paths():
    """Paths that raised in earlier slices of the port now decide as the
    JAX package on a dense round: a spread row that needs the per-row
    re-solve without the ClusterAffinity plugin (until the extra_mask
    channel was ported), registered-estimator answers (until the
    estimator slice) and out-of-tree plugins (until the plugin slice)."""
    clusters, bindings = flagship_mix(n_bindings=8)
    plugins = ["*", "-ClusterAffinity"]
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=0, device="cpu",
                          plugins=plugins)
    ref_rb = bindings[2]
    ref_rb.spec.placement.spread_constraints = [
        jpol.SpreadConstraint(spread_by_field="cluster", min_groups=2)
    ]
    rb = from_reference_objects(ref_rb)
    assert dense_reason(port, [rb]) == "disabled"
    want = jcore.ArrayScheduler(clusters, candidate_k=0, plugins=plugins).schedule([ref_rb])
    assert [_decision_view(d) for d in port.schedule([rb])] == [
        _decision_view(d) for d in want]
    rng = np.random.default_rng(8)
    extra = np.where(rng.random((8, 96)) < 0.3, -1, rng.integers(0, 40, (8, 96))).astype(np.int32)
    want = jcore.ArrayScheduler(clusters, candidate_k=0, plugins=plugins).schedule(
        bindings, extra_avail=extra)
    got = port.schedule(from_reference_objects(bindings), extra_avail=extra)
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
    from karmada_tpu.sched import plugins as jplugins
    from karmada_tpu_torch.sched import plugins as tplugins
    from karmada_tpu_torch.testing.plugins import hash_registry

    port = TorchScheduler(from_reference_objects(clusters), candidate_k=0, device="cpu",
                          plugins=plugins, plugin_registry=hash_registry(tplugins.PluginRegistry))
    want = jcore.ArrayScheduler(clusters, candidate_k=0, plugins=plugins,
                                plugin_registry=hash_registry(jplugins.PluginRegistry)).schedule(
        bindings, extra_avail=extra)
    got = port.schedule(from_reference_objects(bindings), extra_avail=extra)
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
