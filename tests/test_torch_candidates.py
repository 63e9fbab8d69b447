"""The plain versions of the two CUDA kernels (`select_plain`,
`tail_plain`) held against the JAX programs they replace
(`_candidate_select_kernel`, `_candidate_tail_kernel`, run on the CPU), on
batches encoded by both packages from the same converted objects and on
seeded windows with one edge of the division in every row (K = 8, 100 and
128). Exact equality; the output window is compared after `_sorted_pairs`
normalisation, and in its (value desc, column asc) order. Then a model of
candidate_tail.cu's warp sort (its stages, partner lanes and registers)
and of its packed keys, which must give a stable sort's order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.sched import candidates as jcand  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402

from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import batch_from_numpy, from_reference_objects  # noqa: E402
from karmada_tpu_torch.sched import core as tcore  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402

import chip_smoke  # noqa: E402
from test_torch_scheduler import flagship_mix  # noqa: E402

BATCH_FIELDS = (
    "replicas", "unknown_request", "gvk", "strategy", "fresh", "tol_tables",
    "tol_idx", "aff_masks", "aff_idx", "weight_tables", "weight_idx",
    "prev_idx", "prev_rep", "evict_idx", "seeds", "req_unique", "req_idx",
)
FLEET_FIELDS = ("alive", "capacity", "has_summary", "taint_key", "taint_value",
                "taint_effect", "api_ok")


def _encode_both(n_bindings=128):
    clusters, bindings = flagship_mix(n_bindings=n_bindings)
    ref = jcore.ArrayScheduler(clusters, candidate_k=16)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=16, device="cpu")
    jb = ref._pad(ref.batch_encoder.encode(bindings))
    tb = port._pad(port.batch_encoder.encode(from_reference_objects(bindings)))
    for name in BATCH_FIELDS:  # the port's encoder is a faithful copy
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
    return ref, port, jb, tb


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("k,with_extra", [(16, False), (24, True)])
def test_select_plain_matches_candidate_select_kernel(k, with_extra):
    ref, port, jb, tb = _encode_both()
    B, C = len(jb.replicas), len(ref.fleet.names)
    extra = None
    if with_extra:
        extra = np.random.default_rng(0).integers(-1, 6, (B, C)).astype(np.int32)
    want = jcand._candidate_select_kernel(
        *ref.filter_kernel_args(jb, extra), k=k, plugin_bits=ref._plugin_bits,
    )
    f, t = port._fleet_dev, batch_from_numpy({n: getattr(tb, n) for n in BATCH_FIELDS}, "cpu")
    got = kernels.select_plain(
        *(f[n] for n in FLEET_FIELDS),
        t["replicas"], t["unknown_request"], t["gvk"], t["tol_tables"], t["tol_idx"],
        t["aff_masks"], t["aff_idx"], t["prev_idx"], t["prev_rep"], t["evict_idx"],
        t["seeds"], t["req_unique"], t["req_idx"],
        None if extra is None else torch.from_numpy(extra),
        k=k, plugin_bits=port._plugin_bits,
    )
    names = ("cand_idx", "c_feas", "c_score", "c_avail", "c_prev", "c_tie", "feas_count", "packed")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    assert (_n(got[6]) > k).any()  # rows whose feasible set outruns the window


@pytest.mark.parametrize("case", ["ties_at_kth", "k_equals_c", "fewer_feasible"])
def test_select_plain_matches_candidate_select_kernel_edges(case):
    """The window's edge cases against the reference: K-th values tied with
    columns left out of the window (the window takes the lowest columns of
    the tie), K = C, and rows with fewer feasible columns than K (every
    feasible column wins, then the infeasible ones by score and column)."""
    ref, port, jb, tb = _encode_both()
    B, C = len(jb.replicas), len(ref.fleet.names)
    k = {"ties_at_kth": C // 2, "k_equals_c": C, "fewer_feasible": 24}[case]
    want = jcand._candidate_select_kernel(*ref.filter_kernel_args(jb), k=k,
                                          plugin_bits=ref._plugin_bits)
    f, t = port._fleet_dev, batch_from_numpy({n: getattr(tb, n) for n in BATCH_FIELDS}, "cpu")
    args = [f[n] for n in FLEET_FIELDS] + [t[n] for n in (
        "replicas", "unknown_request", "gvk", "tol_tables", "tol_idx", "aff_masks", "aff_idx",
        "prev_idx", "prev_rep", "evict_idx", "seeds", "req_unique", "req_idx")] + [None]
    got = kernels.select_plain(*args, k=k, plugin_bits=port._plugin_bits)
    names = ("cand_idx", "c_feas", "c_score", "c_avail", "c_prev", "c_tie", "feas_count", "packed")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    feasible, score = (_n(x) for x in kernels.dense_filter_plain(
        *args, plugin_bits=port._plugin_bits)[:2])
    key = (feasible.astype(np.int64) << 33) + score
    kth = np.take_along_axis(key, _n(got[0]).astype(np.int64), 1).min(1)
    left_out = ((key == kth[:, None]).sum(1)
                - (np.take_along_axis(key, _n(got[0]).astype(np.int64), 1) == kth[:, None]).sum(1))
    if case == "ties_at_kth":
        assert (left_out > 0).sum() > B // 4
    elif case == "fewer_feasible":
        assert (_n(got[6]) < k).any() and (_n(got[6]) > k).any()
    else:
        assert (_n(got[0]) == np.arange(C)).all()


@pytest.mark.parametrize("has_agg,topk", [(False, 16), (True, 8)])
def test_tail_plain_matches_candidate_tail_kernel(has_agg, topk):
    ref, port, jb, tb = _encode_both()
    k = 16
    sel = jcand._candidate_select_kernel(*ref.filter_kernel_args(jb), k=k,
                                         plugin_bits=ref._plugin_bits)
    cand_idx, c_feas, _, c_avail, c_prev, c_tie = (np.asarray(x) for x in sel[:6])
    strat = np.asarray(jb.strategy)
    rows = np.flatnonzero(np.isin(strat, (4,) if has_agg else (2, 3)))
    assert len(rows) > 4
    want = jcand._candidate_tail_kernel(
        c_feas[rows], c_avail[rows], c_prev[rows], c_tie[rows], cand_idx[rows],
        jb.weight_tables, jb.weight_idx[rows], jb.strategy[rows], jb.replicas[rows],
        jb.fresh[rows], topk=topk, narrow=False, has_agg=has_agg,
    )
    T = torch.from_numpy
    got = kernels.tail_plain(
        T(c_feas[rows]), T(c_avail[rows]), T(c_prev[rows]), T(c_tie[rows]), T(cand_idx[rows]),
        T(tb.weight_tables), T(tb.weight_idx[rows]), T(tb.strategy[rows]),
        T(tb.replicas[rows]), T(tb.fresh[rows]), topk=topk, has_agg=has_agg,
    )
    for name, a, b in zip(("result", "unschedulable", "avail_sum", "nnz"), got[:4], want[:4]):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    gi, gv = tcore._sorted_pairs(_n(got[4]), _n(got[5]))
    wi, wv = tcore._sorted_pairs(np.asarray(want[4]), np.asarray(want[5]))
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(np.where(gv > 0, gi, -1), np.where(wv > 0, wi, -1))
    # the window itself follows jax.lax.top_k's (value desc, column asc) order
    np.testing.assert_array_equal(_n(got[4]), np.asarray(want[4]))


TAIL_OUT = ("result", "unschedulable", "avail_sum", "nnz", "top_idx", "top_val")


@pytest.mark.parametrize("case", chip_smoke.TAIL_CASES)
@pytest.mark.parametrize("K", [8, 100, 128])
def test_tail_plain_matches_candidate_tail_kernel_cases(K, case):
    """tail_plain against the reference's _candidate_tail_kernel on seeded
    windows whose every row holds one edge (chip_smoke.tail_case_inputs,
    the windows phase 3 holds the kernel to on the card), with Aggregated
    rows in the dynamic cases; the output window of min(K, topk) columns
    in the reference's order, topk = K in the "topk = K" case."""
    rng = np.random.default_rng(K * 31 + chip_smoke.TAIL_CASES.index(case))
    args = chip_smoke.tail_case_inputs(rng, "cpu", 48, K, 300, case)
    topk = K if case == "topk = K" else 8
    want = jcand._candidate_tail_kernel(*(a.numpy() for a in args), topk=topk, narrow=False,
                                        has_agg=True)
    got = kernels.tail_plain(*args, topk=topk, has_agg=True)
    for name, a, b in zip(TAIL_OUT, got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    result, unsched = _n(got[0]), _n(got[1])
    feas, prev, replicas = _n(args[0]), _n(args[2]), _n(args[8])
    if case == "zero static weights":  # the feasible set takes the replicas at weight 1
        np.testing.assert_array_equal(result.sum(-1)[feas.any(-1)], replicas[feas.any(-1)])
    elif case == "rem = 0":
        np.testing.assert_array_equal(result, np.broadcast_to((replicas // K)[:, None],
                                                              result.shape))
    elif case == "steady eq":
        np.testing.assert_array_equal(result, np.where(feas, prev, 0))
    elif case == "unschedulable":
        assert unsched.all() and (result == 0).all()
    elif case == "window ties":  # equal results, taken by column
        top_val = _n(got[5])
        assert (top_val[:, 1:] == top_val[:, :-1]).any()
    assert got[4].shape == (48, min(K, topk))


# --------------------------------------------------------------------------
# a model of candidate_tail.cu's warp sort and packed keys
# --------------------------------------------------------------------------

LANES, COLS = 32, 4  # candidate_tail.cu: a warp, 4 window columns a lane
INT64_MAX = 2**63 - 1
I32_MAX = 2**31 - 1


def _warp_sort_model(keys):
    """candidate_tail.cu's warp_sort step by step: keys[4 * lane + j] in
    lane `lane`'s register j; each stage of the bitonic network exchanges
    with lane ^ (d / 4) through a shuffle when the partner distance d is 4
    or more (the lower position of an ascending pair keeps the smaller
    key), else swaps registers j and j + d of one lane. Returns the keys by
    position."""
    regs = [[keys[COLS * lane + j] for j in range(COLS)] for lane in range(LANES)]
    k = 2
    while k <= LANES * COLS:
        d = k // 2
        while d > 0:
            if d >= COLS:
                new = [row[:] for row in regs]
                for lane in range(LANES):
                    for j in range(COLS):
                        i = COLS * lane + j
                        o = regs[lane ^ (d // COLS)][j]
                        take_min = ((i & d) == 0) == ((i & k) == 0)
                        if take_min == (o < regs[lane][j]):
                            new[lane][j] = o
                regs = new
            else:
                for lane in range(LANES):
                    for j in range(COLS):
                        if j & d:
                            continue
                        a, b = regs[lane][j], regs[lane][j + d]
                        up = ((COLS * lane + j) & k) == 0
                        if (b < a) if up else (a < b):
                            regs[lane][j], regs[lane][j + d] = b, a
            d //= 2
        k *= 2
    return [regs[lane][j] for lane in range(LANES) for j in range(COLS)]


@pytest.mark.parametrize("K", [1, 8, 100, 127, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_warp_sort_model_gives_stable_ranks(K, seed):
    """The bonus order's keys (a, b, column), padding (INT64_MAX,
    INT64_MAX, column) past K, with many duplicates: the network's output
    is every real column in a stable sort's order (ties by column), the
    padding last; and the cutoff compare (own key <= the key at position
    k - 1) marks exactly the columns ranked below k."""
    rng = np.random.default_rng(seed * 1000 + K)
    a = rng.choice([-3, 0, 0, 5, INT64_MAX], K)
    b = rng.choice([-(2**40), -1, 0, 0, 7, INT64_MAX], K)
    keys = [(int(a[c]), int(b[c]), c) for c in range(K)]
    keys += [(INT64_MAX, INT64_MAX, c) for c in range(K, LANES * COLS)]
    got = _warp_sort_model(keys)
    order = np.lexsort((b, a))  # stable: ties keep column order
    assert [c for _, _, c in got[:K]] == order.tolist()
    assert [c for _, _, c in got[K:]] == list(range(K, LANES * COLS))
    rank = np.empty(K, int)
    rank[order] = np.arange(K)
    for k in (1, 2, K // 2, K):
        if k < 1:
            continue
        cut = got[min(k, K) - 1]
        np.testing.assert_array_equal([keys[c] <= cut for c in range(K)], rank < k)


def _agg_key(prior, w, col):
    """candidate_tail.cu agg_key: prior desc, weight desc, column asc."""
    return ((0 if prior else 1) << 41) | (((1 << 32) - w) << 7) | col


def _window_key(result, col):
    """candidate_tail.cu's output-window key: result desc, column asc."""
    return ((I32_MAX - result) << 7) | col


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_sort_model_packed_keys(seed):
    """The one-word keys of the truncation and the output window over their
    whole ranges (a weight is a sum of two int32 values, a result an
    int32), padded with the all-ones word: the network sorts them into
    the triple order, and each decodes back (agg_key_weight, the window's
    value and column)."""
    rng = np.random.default_rng(seed)
    K = 100
    w = rng.choice([-(2**32), -(2**31), -1, 0, 0, 3, 3, 2**31 - 1, 2**32 - 2], K)
    prior = rng.random(K) < 0.3
    pad = 2**64 - 1
    keys = [_agg_key(bool(prior[c]), int(w[c]), c) for c in range(K)] + [pad] * (128 - K)
    assert max(keys[:K]) < 2**42
    got = _warp_sort_model(keys)
    order = np.lexsort((-w, ~prior))
    assert [k & 127 for k in got[:K]] == order.tolist() and got[K:] == [pad] * (128 - K)
    weight = [(1 << 32) - ((k >> 7) & ((1 << 34) - 1)) for k in got[:K]]
    assert weight == w[order].tolist()
    res = rng.choice([-(2**31), -5, 0, 0, 1, 1, 9, I32_MAX], K)
    keys = [_window_key(int(res[c]), c) for c in range(K)] + [pad] * (128 - K)
    got = _warp_sort_model(keys)
    order = np.lexsort((-res.astype(np.int64),))
    assert [k & 127 for k in got[:K]] == order.tolist()
    assert [I32_MAX - (k >> 7) for k in got[:K]] == res[order].tolist()


# --------------------------------------------------------------------------
# the wide routes: windows past 128 columns, fleets past 16 384 columns
# --------------------------------------------------------------------------


def _views(decisions):
    from test_torch_scheduler import _decision_view

    return [_decision_view(d) for d in decisions]


def test_candidate_k_256_compact_round_matches_jax(monkeypatch):
    """candidate_k=256 on a fleet wider than the window (C = 384): the
    compact round over 256-column windows decides as the JAX round, with
    the same effective K and truncations."""
    clusters, bindings = flagship_mix(seed=3, n_clusters=300, n_bindings=96)
    ref = jcore.ArrayScheduler(clusters, candidate_k=256)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=256, device="cpu")
    windows = []
    tail = kernels.candidate_tail
    monkeypatch.setattr(kernels, "candidate_tail",
                        lambda *a, **kw: (windows.append(a[0].shape[1]), tail(*a, **kw))[1])
    want = ref.schedule(bindings)
    got = port.schedule(from_reference_objects(bindings))
    # the last round is the ordered-affinity retry's (a 30-cluster term)
    assert port.last_candidate_stats == ref.last_candidate_stats
    assert windows[:2] == [256, 256]
    assert _views(got) == _views(want)


def test_compact_round_uploads_its_row_ids_once_before_the_select(monkeypatch):
    """Each compact round's solve stage uploads the row ids it gathers by
    (the tails' padded lists, then the mask rows) in one to_device_packed
    copy, before candidate_select is launched (on a card: one pinned,
    non-blocking copy, so the host never waits on B1 there); the rounds
    decide as the JAX package."""
    from karmada_tpu_torch.sched import candidates as tcand

    clusters, bindings = flagship_mix(seed=3, n_clusters=300, n_bindings=96)
    ref = jcore.ArrayScheduler(clusters)
    port = TorchScheduler(from_reference_objects(clusters), device="cpu")
    events = []
    packed, select = tcand.to_device_packed, kernels.candidate_select
    monkeypatch.setattr(tcand, "to_device_packed", lambda arrays, dev: (
        events.append(("upload", [np.array(a) for a in arrays])), packed(arrays, dev))[1])
    monkeypatch.setattr(kernels, "candidate_select", lambda *a, **kw: (
        events.append(("select", None)), select(*a, **kw))[1])
    got = port.schedule(from_reference_objects(bindings))
    assert _views(got) == _views(ref.schedule(bindings))
    assert [e for e, _ in events] == ["upload", "select"] * (len(events) // 2)
    first = events[0][1]
    # the two tails' padded lists and the mask rows, none empty
    assert len(first) == 3 and all(a.dtype == np.int64 and len(a) for a in first)


def test_candidate_k_256_tiered_compact_round_matches_jax():
    """The compact tiered launch (B12) over 256-column windows: its tails
    take the K > 128 route on a card; on the CPU it decides as the JAX
    package."""
    import test_torch_preemption as tp
    from karmada_tpu.sched import preemption as jpre
    from karmada_tpu_torch.sched import preemption as tpre

    clusters, bindings = tp._tiered_fixture("compact", 3, seed=4)
    jarr = jcore.ArrayScheduler(clusters, candidate_k=256)
    tarr = TorchScheduler(from_reference_objects(clusters), candidate_k=256, device="cpu")
    pend = tpre.launch_tiered(tarr, from_reference_objects(bindings))
    assert pend["state"]["cand_dev"].shape[1] == 256
    got = tarr.materialize_chunk(pend)
    want = jarr.materialize_chunk(jpre.launch_tiered(jarr, bindings))
    assert [tp._view(d) for d in got] == [tp._view(d) for d in want]


def test_wide_fleet_round_matches_jax():
    """A 20 000-cluster fleet (padded to 20 480: the in-block select's keys
    in 84 KB of shared memory on the card) with a few dozen bindings
    decides as the JAX round."""
    from karmada_tpu.testing.fixtures import synthetic_fleet

    import test_torch_scheduler as ts

    clusters = synthetic_fleet(20_000, seed=1)
    names = [c.name for c in clusters]
    bindings = [
        ts._binding(i, 3 + i % 40, (ts._dyn(i % 2 == 0) if i % 3 else ts.duplicated_placement(
            names[i * 7: i * 7 + 12])), 0.5, prev={names[(i * 977) % 20_000]: 2})
        for i in range(36)
    ]
    ref = jcore.ArrayScheduler(clusters)
    port = TorchScheduler(from_reference_objects(clusters), device="cpu")
    assert len(port.fleet.names) == 20_480
    C = len(port.fleet.names)
    assert kernels.select_route(C, 1, 1, 1) == "candidate_select"
    want = ref.schedule(bindings)
    got = port.schedule(from_reference_objects(bindings))
    assert port.last_candidate_stats == ref.last_candidate_stats
    assert _views(got) == _views(want)


class _FakeLib:
    """A kernel library whose entry points record their call and return
    cudaSuccess: the wrappers' checks and argument marshalling run on CPU
    tensors up to the launch."""

    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, name):
        def entry(*args):
            self._calls.append((name, args))
            return 0

        return entry


@pytest.fixture()
def fake_card(monkeypatch):
    import ctypes

    from karmada_tpu_torch.kernels import build

    calls = []
    monkeypatch.setattr(build, "library", lambda name: _FakeLib(calls))
    monkeypatch.setattr(kernels, "_stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(kernels, "_bound", {})  # entries bound once, to this fake
    return calls


@pytest.mark.parametrize("K,entry", [(128, "candidate_tail_launch"),
                                     (256, "window_tail_launch"), (512, "window_tail_launch")])
def test_tail_launch_takes_any_window(K, entry, fake_card):
    """candidate_tail's launch no longer refuses windows past 128 columns:
    K <= 128 calls the 128-thread kernel, wider windows dense_tail.cu's
    window mode."""
    rng = np.random.default_rng(K)
    rows, C = 6, 1024
    T = torch.from_numpy
    args = (T(rng.random((rows, K)) < 0.8), T(rng.integers(0, 9, (rows, K)).astype(np.int32)),
            T(np.zeros((rows, K), np.int32)), T(rng.integers(0, 3, (rows, K)).astype(np.int32)),
            T(np.sort([rng.choice(C, K, replace=False) for _ in range(rows)], 1).astype(np.int32)),
            T(np.ones((2, C), np.int64)), T(np.zeros(rows, np.int32)),
            T(np.full(rows, 3, np.int32)), T(np.full(rows, 9, np.int32)),
            T(np.zeros(rows, bool)))
    out = kernels._tail_launch(*args, topk=128, has_agg=True)
    assert [name for name, _ in fake_card] == [entry]
    assert out[4].shape == (rows, min(K, 128))


@pytest.mark.parametrize("C,wide", [(5120, False), (20_480, False), (60_000, True)])
def test_select_launch_takes_any_width(C, wide, fake_card):
    """candidate_select's launch refuses no width: one C entry of 49
    arguments (the plugin mask and score after the answers, null when
    absent; the column offset and the four row strides after the outputs,
    0 and C for the whole fleet), its key scratch null on the in-block
    route and an int32 [B, C] tensor past MAX_SELECT_SMEM (wide_40k's
    20 480 columns stay in the block)."""
    import chip_smoke

    args = chip_smoke.random_select_inputs(np.random.default_rng(C), "cpu", 4, C)
    kernels._select_launch(*args, k=128, plugin_bits=31)
    (name, cargs), = fake_card
    assert name == "candidate_select_launch"
    assert len(cargs) == 49
    assert cargs[31] == args[-1].data_ptr() and cargs[32:34] == (None, None)
    assert cargs[42:47] == (0, C, C, C, C)
    assert (cargs[-2] is not None) == wide


def test_scatter_rows_launch_marshals_every_tensor(fake_card):
    """B17's launch over separate sources passes one ScatterTable (each
    tensor with bytes: pointer, rows, elements a row, element size, its
    source and row stride), the ids and n; skips rows of no bytes, and
    checks its inputs."""
    C, n = 64, 5
    dsts = [torch.zeros(C, dtype=torch.bool), torch.zeros((C, 4), dtype=torch.int64),
            torch.zeros((C, 3), dtype=torch.int32), torch.zeros((C, 0), dtype=torch.int32)]
    srcs = [torch.ones((n,) + tuple(d.shape[1:]), dtype=d.dtype) for d in dsts]
    idx = torch.tensor([1, 5, 5, 9, 63])
    kernels._scatter_rows_launch(dsts, idx, srcs)
    (name, cargs), = fake_card
    assert name == "scatter_rows_launch"
    table = cargs[0]._obj
    k = table.n_dst
    assert k == 3 and cargs[1:3] == (idx.data_ptr(), n)
    assert list(table.dst[:k]) == [d.data_ptr() for d in dsts[:3]]
    assert list(table.src[:k]) == [x.data_ptr() for x in srcs[:3]]
    assert list(table.rows[:k]) == [C] * 3
    assert list(table.row_elems[:k]) == [1, 4, 3]
    assert list(table.elem_bytes[:k]) == [1, 8, 4]
    assert list(table.src_stride[:k]) == [1, 32, 12]
    with pytest.raises(TypeError, match="dtype"):
        kernels._scatter_rows_launch(dsts[:1], idx, [srcs[1]])
    with pytest.raises(TypeError, match="dtype"):  # no 2-byte stores
        kernels._scatter_rows_launch([torch.zeros(C, dtype=torch.int16)], idx,
                                     [torch.ones(n, dtype=torch.int16)])


class _StagedLib:
    """A kernel library whose `scatter_rows_staged` records its call and
    does on the host what the C entry does: reads the table, finds the ids
    and each destination's rows in the staged block (the ids at 0, each
    segment at a 16-byte boundary, in table order) and writes the rows
    whose id is in range."""

    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, name):
        import ctypes

        def staged(ref, staging, n, stream):
            self._calls.append((name, (ref, staging, n, stream)))
            t = ref._obj

            def at(addr, nbytes):
                return np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(addr))

            ids = at(staging, 8 * n).view(np.int64)
            off = -(-8 * n // 16) * 16
            for e in range(t.n_dst):
                w = t.row_elems[e] * t.elem_bytes[e]
                seg = at(staging + off, n * w).reshape(n, w)
                dst = at(t.dst[e], t.rows[e] * w).reshape(t.rows[e], w)
                for i, r in enumerate(ids):
                    if 0 <= r < t.rows[e]:
                        dst[r] = seg[i]
                off += -(-n * w // 16) * 16
            return 0

        assert name == "scatter_rows_staged"
        return staged


@pytest.fixture()
def staged_card(fake_card, monkeypatch):
    """fake_card with the staged entry done on the host; every placement
    builds the card's launcher (`kernels.FleetScatter`) over the CPU
    tensors, and each build is recorded."""
    from karmada_tpu_torch.kernels import build

    monkeypatch.setattr(build, "library", lambda name: _StagedLib(fake_card))
    built = []

    def card_launcher(dsts):
        built.append(kernels.FleetScatter(dsts))
        return built[-1]

    monkeypatch.setattr(kernels, "fleet_scatter", card_launcher)
    return fake_card, built


def test_fleet_scatter_one_call_per_refresh(staged_card):
    """The card's refresh launcher: one refresh is one C call
    (`scatter_rows_staged`: the bound table, the staged block, n, the
    stream) and one scatter_rows launch counted; its table holds the
    resident tensors with bytes (T = 0 left out); the block it stages
    lands where the C entry reads it; refreshes of nothing call nothing; a
    closed launcher raises."""
    from types import SimpleNamespace

    from test_torch_incremental import random_fleet_arrays

    calls, _ = staged_card
    rng = np.random.default_rng(3)
    C = 29
    base, new = random_fleet_arrays(rng, C, 5, 0, 3), random_fleet_arrays(rng, C, 5, 0, 3)
    dsts = {n: torch.from_numpy(a.copy()) for n, a in base.items()}
    launcher = kernels.FleetScatter(dsts)
    assert launcher._table.n_dst == 4  # the three taint fields have no bytes
    assert list(launcher._table.dst[:4]) == [dsts[n].data_ptr() for n in (
        "alive", "capacity", "has_summary", "api_ok")]
    kernels.reset_launches()
    rows = np.array([C - 1, 4, 0, 4], np.int64)
    launcher.refresh(rows, SimpleNamespace(**new))
    (name, (ref, staging, n, _)), = calls
    assert name == "scatter_rows_staged" and ref._obj is launcher._table and n == 4
    assert kernels.launch_counts()["scatter_rows"] == 1
    for f, a in base.items():
        want = a.copy()
        want[rows] = new[f][rows]
        np.testing.assert_array_equal(dsts[f].numpy(), want, f)
    launcher.refresh(np.zeros(0, np.int64), SimpleNamespace(**new))
    assert len(calls) == 1 and kernels.launch_counts()["scatter_rows"] == 1
    launcher.close()
    with pytest.raises(RuntimeError, match="replaced"):
        launcher.refresh(rows, SimpleNamespace(**new))
    assert len(calls) == 1


def test_fleet_scatter_bound_once_per_placement(staged_card):
    """On a scheduler, the refresh launcher is built (its tensors checked,
    its table made) once per placement: dirty refreshes reuse it, one C
    call each, writing the resident tensors to a full re-encode; a full
    rebuild places new tensors and binds a new launcher to them, and the
    old one, retired, raises instead of writing."""
    import copy

    from karmada_tpu.testing.fixtures import synthetic_fleet

    calls, built = staged_card
    clusters = synthetic_fleet(12, seed=4)
    port = TorchScheduler(from_reference_objects(clusters), device="cpu")
    assert built == [port._fleet_scatter]
    first = built[0]
    live = clusters
    for step in range(3):
        live = list(live)
        c = copy.deepcopy(live[step + 2])
        c.status.resource_summary.allocated["cpu"] = 1.5 + step
        live[step + 2] = c
        port.set_clusters(from_reference_objects(live), dirty_names={c.name})
        assert len(built) == 1 and len(calls) == step + 1
        full = port.encoder.encode(port.clusters)
        for n in tcore._FLEET_FIELDS:
            np.testing.assert_array_equal(port._fleet_dev[n].numpy(), getattr(full, n), n)
    fleet_before = port.fleet
    port.set_clusters(from_reference_objects(live))  # full rebuild: no dirty names
    assert len(built) == 2 and port._fleet_scatter is built[1] and first.closed
    assert list(built[1]._table.dst[:built[1]._table.n_dst]) == [
        port._fleet_dev[n].data_ptr() for n in tcore._FLEET_FIELDS if port._fleet_dev[n].numel()]
    with pytest.raises(RuntimeError, match="replaced"):
        first.refresh(np.array([0], np.int64), fleet_before)
    assert len(calls) == 3


# --------------------------------------------------------------------------
# the candidate-window counters, at the reference's call sites
# --------------------------------------------------------------------------

_REASONS = ("disabled", "small_fleet", "policy", "spread_constraint", "duplicated")


def _fallback_case(name):
    """(JAX clusters, a round runner taking (module pair, scheduler,
    converted-or-not bindings), bindings, candidate_k) of one fallback
    reason."""
    import test_torch_preemption as tp
    from karmada_tpu.api import policy as jpol

    if name in ("disabled", "small_fleet", "policy", "spread_constraint"):
        clusters, bindings = flagship_mix(n_bindings=24)
        k = {"disabled": 0, "small_fleet": 128}.get(name, 16)
        if name == "policy":
            bindings[3].metadata.annotations = {"karmada-tpu.io/dense-solve": "true"}
        if name == "spread_constraint":
            bindings[2].spec.placement.spread_constraints = [
                jpol.SpreadConstraint(spread_by_field="cluster", min_groups=2)]
        return clusters, bindings, k, False
    if name == "tiered_duplicated":
        clusters, bindings = tp._tiered_fixture("compact", 2, seed=1)
        dup = tp.make_binding("dup", 2, jpol.Placement(), cpu=0.5)
        dup.spec.schedule_priority = 7
        return clusters, bindings + [dup], 128, True
    clusters, bindings = tp._tiered_fixture("dense", 2)  # tiered_small_fleet
    return clusters, bindings, 128, True


@pytest.mark.parametrize("name", ["disabled", "small_fleet", "policy", "spread_constraint",
                                  "tiered_duplicated", "tiered_small_fleet"])
def test_fallback_counter_matches_reference(name):
    """karmada_candidate_fallback_total{reason} moves as the reference's at
    each call site: the dense reasons of `_launch_once` (a disabled window
    counts nothing), the wide spread rows of the compact round, and the
    tiered launch's dense fallbacks."""
    from karmada_tpu import metrics as jmetrics
    from karmada_tpu.sched import preemption as jpre
    from karmada_tpu_torch import metrics as tmetrics
    from karmada_tpu_torch.sched import preemption as tpre

    clusters, bindings, k, tiered = _fallback_case(name)

    def counts(m):
        return {r: m.candidate_fallback.value(reason=r) for r in _REASONS}

    j0, t0 = counts(jmetrics), counts(tmetrics)
    jarr = jcore.ArrayScheduler(clusters, candidate_k=k)
    tarr = TorchScheduler(from_reference_objects(clusters), candidate_k=k, device="cpu")
    if tiered:
        jarr.materialize_chunk(jpre.launch_tiered(jarr, bindings))
        tarr.materialize_chunk(tpre.launch_tiered(tarr, from_reference_objects(bindings)))
    else:
        jarr.schedule(bindings)
        tarr.schedule(from_reference_objects(bindings))
    jd = {r: counts(jmetrics)[r] - j0[r] for r in _REASONS}
    td = {r: counts(tmetrics)[r] - t0[r] for r in _REASONS}
    assert td == jd
    if name == "disabled":  # configuration, not a fallback: nothing counted
        assert not any(td.values())
    else:
        assert td[name.replace("tiered_", "")] > 0


def test_truncations_and_window_gauge_match_reference():
    """karmada_candidate_truncations_total grows by the round's truncations
    as the reference's does, and karmada_candidate_k carries the window."""
    from karmada_tpu import metrics as jmetrics
    from karmada_tpu_torch import metrics as tmetrics

    clusters, bindings = flagship_mix(n_bindings=64)
    j0, t0 = jmetrics.candidate_truncations.total(), tmetrics.candidate_truncations.total()
    jarr = jcore.ArrayScheduler(clusters, candidate_k=16)
    tarr = TorchScheduler(from_reference_objects(clusters), candidate_k=16, device="cpu")
    jarr.schedule(bindings)
    tarr.schedule(from_reference_objects(bindings))
    t_delta = tmetrics.candidate_truncations.total() - t0
    assert t_delta == jmetrics.candidate_truncations.total() - j0 > 0
    assert tmetrics.candidate_k.value(bucket="16") == 16.0 == jmetrics.candidate_k.value(bucket="16")
