"""Every launch wrapper of `karmada_tpu_torch.kernels` on a faked card: the
wrapper binds its C entry point once (`kernels._bind`: the library is
loaded and the prototype set at the first call only) and passes exactly
as many arguments as the entry's C prototype in `csrc/` declares, the
prototype's ctypes list being that long too. The library is a fake whose
entries record their calls and return cudaSuccess; the inputs are CPU
tensors, so the wrappers' checks and marshalling run up to the launch."""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.kernels import build  # noqa: E402
from karmada_tpu_torch.sched import spread_batch  # noqa: E402

CPU = torch.device("cpu")


def c_prototypes() -> dict:
    """{entry: number of parameters} of every `extern "C"` entry in csrc."""
    out = {}
    for src in Path(build.CSRC).glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            out[name] = len([p for p in params.split(",") if p.strip()])
    return out


def _select_args(C=300):
    return chip_smoke.random_select_inputs(np.random.default_rng(1), CPU, 6, C)


def _group_args():
    rng = np.random.default_rng(2)
    C = 96
    region = rng.integers(-1, 5, C).astype(np.int32)
    lay = spread_batch.RegionLayout(region, [f"r{i}" for i in range(5)],
                                    rng.permutation(C).astype(np.int32)).tensors(CPU)
    args = chip_smoke.random_group_inputs(rng, CPU, 8, C, 5)
    return args + [lay[k] for k in chip_smoke.LAYOUT], lay


def _combo_args(R):
    rng = np.random.default_rng(R)
    members, sizes = spread_batch._combos(R, 1, 2).tensors(CPU)
    d = chip_smoke.random_combo_inputs(rng, CPU, 5, R)
    return (d["weight"], d["value"], torch.full((5,), 2, dtype=torch.int32),
            torch.from_numpy(rng.permutation(R).astype(np.int32)), members, sizes)


def _tier():
    return chip_smoke.random_tier_inputs(np.random.default_rng(3), CPU, 20, 64, 4, 8, 16)


def _sel():
    d = chip_smoke.random_selection_inputs(np.random.default_rng(4), CPU, 8, 96, 5, 4)
    _, lay = _group_args()
    return d, lay


def launch_select(C=300):
    kernels._select_launch(*_select_args(C), k=16, plugin_bits=31)


def launch_select_window():
    rng = np.random.default_rng(9)
    kernels._select_window_launch(torch.from_numpy(rng.random((4, 300)) < 0.5),
                                  torch.from_numpy(rng.integers(-9, 9, (4, 300), dtype=np.int32)),
                                  16)


def launch_tail():
    a = chip_smoke.random_tail_inputs(np.random.default_rng(5), CPU, 6, 32, 300)
    kernels._tail_launch(*a, topk=16, has_agg=True)


def launch_dense_filter():
    kernels._dense_filter_launch(*_select_args(), plugin_bits=31)


def _mask_rows():
    return torch.tensor([3, 0, 4, 3], dtype=torch.int32)


def launch_pack_rows():
    kernels._pack_rows_launch(torch.rand((5, 77)) < 0.5, _mask_rows())


def launch_feas_idx():
    kernels._feas_idx_launch(torch.rand((5, 77)) < 0.5, _mask_rows(), 8)


def launch_group_score():
    args, _ = _group_args()
    kernels._group_score_launch(*args)


def launch_packed_selection():
    d, lay = _sel()
    kernels._packed_selection_launch(d["feasible"], d["rows"], d["chosen"], lay["rid"])


def launch_combo_select():
    kernels._combo_select_launch(*_combo_args(6), cmin=2, kmin=1)


def launch_tier_estimate():
    d = _tier()
    args = [d[n] for n in chip_smoke.ESTIMATE_ARGS] + [d["rows"]]
    kernels._tier_estimate_launch(*args, cand_idx=d["cand_idx"])


def launch_staleness():
    kernels._staleness_launch(torch.arange(-3, 40, dtype=torch.int32).reshape(1, -1), 2)


def launch_scatter_rows():
    dst = [torch.zeros((10, 3), dtype=torch.int64)]
    kernels._scatter_rows_launch(dst, torch.tensor([1, 4]), [torch.ones((2, 3), dtype=torch.int64)])


def launch_fleet_scatter():
    from types import SimpleNamespace

    dsts = {"alive": torch.zeros(10, dtype=torch.bool),
            "capacity": torch.zeros((10, 3), dtype=torch.int64)}
    fleet = SimpleNamespace(alive=np.ones(10, bool), capacity=np.ones((10, 3), np.int64))
    kernels.FleetScatter(dsts).refresh(np.array([1, 4]), fleet)


def launch_sim_filter():
    a = chip_smoke.random_sim_inputs(np.random.default_rng(6), CPU, 2, 6, 100, True)
    kernels._sim_filter_launch(*a, plugin_bits=31)


def launch_dense_input_filter():
    kernels._dense_input_filter_launch(*chip_smoke.random_dense_input_args(7, CPU, 6, 100))


def launch_mesh_tile_filter():
    (args, kw), *_ = chip_smoke.random_tile_inputs(8, CPU, 8, 100, (2, 2))
    kernels._mesh_tile_filter_launch(*args, **kw)


# wrapper -> (library, entry)
WRAPPERS = {
    launch_select: ("candidate_select", "candidate_select_launch"),
    launch_select_window: ("candidate_select", "select_window_launch"),
    launch_tail: ("candidate_tail", "candidate_tail_launch"),
    launch_dense_filter: ("dense_filter", "dense_filter_launch"),
    launch_pack_rows: ("dense_mask", "pack_rows_launch"),
    launch_feas_idx: ("dense_mask", "feas_idx_launch"),
    launch_group_score: ("group_score", "group_score_launch"),
    launch_packed_selection: ("dense_mask", "packed_selection_launch"),
    launch_combo_select: ("combo_select", "combo_select_launch"),
    launch_tier_estimate: ("tiers", "tier_estimate_round"),
    launch_staleness: ("staleness", "staleness_launch"),
    launch_scatter_rows: ("scatter_rows", "scatter_rows_launch"),
    launch_fleet_scatter: ("scatter_rows", "scatter_rows_staged"),
    launch_sim_filter: ("dense_filter", "sim_filter_launch"),
    launch_dense_input_filter: ("dense_filter", "dense_input_filter_launch"),
    launch_mesh_tile_filter: ("dense_filter", "mesh_tile_filter_launch"),
}


@pytest.fixture()
def fake_lib(monkeypatch):
    """(calls, loads): each entry call as (name, args), each library load."""
    calls, loads = [], []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0

            return entry

    monkeypatch.setattr(build, "library", lambda name: (loads.append(name), Lib())[1])
    monkeypatch.setattr(kernels, "_stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(kernels, "_bound", {})
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    return calls, loads


@pytest.mark.parametrize("launch", list(WRAPPERS), ids=lambda f: f.__name__[7:])
def test_wrapper_binds_once_with_its_prototype(launch, fake_lib):
    calls, loads = fake_lib
    lib, entry = WRAPPERS[launch]
    launch()
    launch()
    assert loads == [lib]
    assert [name for name, _ in calls] == [entry, entry]
    n = c_prototypes()[entry]
    assert all(len(args) == n for _, args in calls)
    assert len(kernels._bound[entry].argtypes) == n


def test_every_c_entry_has_a_bound_prototype():
    """Each C entry's ctypes list in kernels has the prototype's length
    (dense_tail.cu's phase profile is bound by scripts/torch_tail_phases.py)."""
    protos = c_prototypes()
    protos.pop("dense_tail_phase_cycles")
    lists = {
        "candidate_select_launch": kernels._SELECT_ARGTYPES,
        "select_window_launch": kernels._SELECT_WINDOW_ARGTYPES,
        "candidate_tail_launch": kernels._TAIL_ARGTYPES,
        "dense_filter_launch": kernels._DENSE_FILTER_ARGTYPES,
        "pack_rows_launch": kernels._PACK_ROWS_ARGTYPES,
        "feas_idx_launch": kernels._FEAS_IDX_ARGTYPES,
        "group_score_launch": kernels._GROUP_SCORE_ARGTYPES,
        "packed_selection_launch": kernels._PACKED_SELECTION_ARGTYPES,
        "combo_select_launch": kernels._COMBO_SELECT_ARGTYPES,
        "tier_estimate_round": kernels._TIER_ROUND_ARGTYPES,
        "tier_consume_round": kernels._CONSUME_ROUND_ARGTYPES,
        "staleness_launch": kernels._STALENESS_ARGTYPES,
        "scatter_rows_launch": kernels._SCATTER_ROWS_ARGTYPES,
        "scatter_rows_staged": kernels._SCATTER_ROWS_ARGTYPES,
        "sim_filter_launch": kernels._SIM_FILTER_ARGTYPES,
        "dense_input_filter_launch": kernels._DENSE_INPUT_FILTER_ARGTYPES,
        "mesh_tile_filter_launch": kernels._MESH_TILE_FILTER_ARGTYPES,
        "dense_tail_launch": kernels._DENSE_TAIL_ARGTYPES,
        "spread_tail_launch": kernels._SPREAD_TAIL_ARGTYPES,
        "window_tail_launch": kernels._WINDOW_TAIL_ARGTYPES,
        "fleet_estimate_launch": kernels._FLEET_ESTIMATE_ARGTYPES,
        "sim_load_launch": kernels._SIM_LOAD_ARGTYPES,
    }
    assert set(lists) == set(protos)
    assert {e: len(t) for e, t in lists.items()} == protos


@pytest.mark.parametrize("C,wide", [(5120, False), (54_400, False), (54_700, True)])
def test_select_launch_routes_by_width(C, wide, fake_lib):
    """Both select routes go through the one entry: the in-block route
    passes a null key scratch, the device-memory route an int32 [B, C]
    one; MAX_SELECT_SMEM puts the threshold near 54 500 columns."""
    calls, _ = fake_lib
    args = chip_smoke.random_select_inputs(np.random.default_rng(C), CPU, 2, C)
    route = kernels.select_route(C, args[10].shape[2], args[14].shape[1], args[16].shape[1])
    assert route == ("candidate_select_wide" if wide else "candidate_select")
    kernels._select_launch(*args, k=128, plugin_bits=31)
    (_, cargs), = calls
    assert (cargs[-2] is not None) == wide


@pytest.mark.parametrize("R,scratch", [(6, False), (2048, False), (2049, True)])
def test_combo_select_launch_scratch_past_the_staged_regions(R, scratch, fake_lib):
    """combo_select takes any region count: past MAX_COMBO_SMEM_REGIONS
    the launch passes an int32 [S, R] position scratch; R = 0 raises."""
    calls, _ = fake_lib
    rng = np.random.default_rng(R)
    members = torch.from_numpy(np.array([[0, 1], [R - 1, -1]], np.int32))
    sizes = torch.tensor([2, 1], dtype=torch.int32)
    args = (torch.from_numpy(rng.integers(0, 9, (3, R)).astype(np.int64)),
            torch.from_numpy(rng.integers(0, 3, (3, R)).astype(np.int32)),
            torch.full((3,), 2, dtype=torch.int32),
            torch.from_numpy(rng.permutation(R).astype(np.int32)), members, sizes)
    kernels._combo_select_launch(*args, cmin=1, kmin=1)
    (_, cargs), = calls
    assert (cargs[-2] is not None) == scratch
    with pytest.raises(ValueError, match="no region"):
        kernels._combo_select_launch(args[0][:, :0], args[1][:, :0], args[2],
                                     args[3][:0], members[:0], sizes[:0], cmin=1, kmin=1)


def test_packed_selection_launch_takes_the_bool_choice(fake_lib, monkeypatch):
    """B9a's launch is one C call over the caller's bool [n, R] `chosen`,
    passed as it is with R itself: no u8 [n, R + 1] table is built on the
    host."""
    calls, _ = fake_lib
    d, lay = _sel()
    feasible, rows, chosen = d["feasible"], d["rows"], d["chosen"]
    monkeypatch.setattr(kernels, "_chosen_table", lambda *_: pytest.fail("a table was built"))
    monkeypatch.setattr(torch, "cat", lambda *a, **kw: pytest.fail("a table was built"))
    out = kernels._packed_selection_launch(feasible, rows, chosen, lay["rid"])
    (name, args), = calls
    n, R = chosen.shape
    assert name == "packed_selection_launch" and chosen.dtype == torch.bool
    assert args[:7] == (feasible.data_ptr(), 96, rows.data_ptr(), n, chosen.data_ptr(), R,
                        lay["rid"].data_ptr())
    assert args[7] == out.data_ptr() and out.shape == (n, 12)


@pytest.mark.parametrize("name", ["pack_rows", "feas_idx"])
def test_mask_launches_read_the_filter_rows_in_place(name, fake_lib):
    """pack_rows and feas_idx are one C call each over the filter outputs'
    own pointer and the int32 row ids, one output row per id; row ids of
    another dtype, rank or layout raise before any call."""
    calls, _ = fake_lib
    feasible = torch.rand((5, 77)) < 0.5
    rows = _mask_rows()
    k = (8,) if name == "feas_idx" else ()
    launch = getattr(kernels, f"_{name}_launch")
    out = launch(feasible, rows, *k)
    (cname, args), = calls
    assert cname == f"{name}_launch"
    assert args[:4] == (feasible.data_ptr(), 77, rows.data_ptr(), 4) and args[4:-2] == k
    assert args[-2] == out.data_ptr() and out.shape == ((4, 8) if k else (4, 10))
    for bad in (rows.long(), rows.reshape(2, 2), rows[::2]):
        with pytest.raises((TypeError, ValueError)):
            launch(feasible, bad, *k)
    assert len(calls) == 1


def test_combo_select_outputs_are_fresh_views_of_one_block(fake_lib):
    """combo_select's three outputs are views of one int32 [3, S] block,
    the one the single C call writes (first_idx, n_ties, then
    none_feasible as bool); two successive calls get two blocks, so no
    output of the first is overwritten by the second."""
    calls, _ = fake_lib
    a = _combo_args(6)
    first = kernels._combo_select_launch(*a, cmin=2, kmin=1)
    second = kernels._combo_select_launch(*a, cmin=2, kmin=1)
    for outs, (_, cargs) in zip((first, second), calls):
        base = outs[0].untyped_storage().data_ptr()
        assert cargs[-3] == base
        assert all(o.untyped_storage().data_ptr() == base for o in outs)
        assert [o.data_ptr() - base for o in outs] == [0, 4 * 5, 8 * 5]
        assert [o.dtype for o in outs] == [torch.int32, torch.int32, torch.bool]
        assert all(o.shape == (5,) for o in outs)
    assert first[0].untyped_storage().data_ptr() != second[0].untyped_storage().data_ptr()


def _device_route(monkeypatch):
    """select_regions_batch's device route on the CPU with combo_select's
    outputs as the launch returns them (views of one block), recording
    each call's arguments; the spread inputs and the host path's answer."""
    rng = np.random.default_rng(21)
    R, S, C = 12, 40, 200
    layout = spread_batch.RegionLayout(rng.integers(-1, R, C).astype(np.int32),
                                       [f"r{i:02d}" for i in range(R)],
                                       rng.permutation(C).astype(np.int32))
    W = rng.integers(0, 6, (S, R)).astype(np.int64) * 1000 + rng.integers(0, 3, (S, R))
    V = rng.integers(0, 5, (S, R)).astype(np.int32)
    cfg = spread_batch.SpreadConfig(rmin=2, rmax=3, cmin=3, cmax=0, duplicated=False)
    want = spread_batch.select_regions_batch(W, V, cfg, layout, device=False)
    seen = []

    def block_outputs(*args, **kw):
        seen.append(args)
        outs = kernels.combo_select_plain(*args, **kw)
        return kernels._combo_outputs(torch.stack([o.to(torch.int32) for o in outs]))

    monkeypatch.setattr(kernels, "combo_select", block_outputs)
    return (W, V, cfg, layout), want, seen


def test_select_regions_batch_fetches_combo_outputs_with_one_copy(monkeypatch):
    """The device route fetches combo_select's three outputs with one
    `.cpu()` of their block per call (counted on the tensor method), and
    decides as the host path."""
    args, want, _ = _device_route(monkeypatch)
    fetched = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **kw: (fetched.append(tuple(self.shape)),
                                                cpu(self, *a, **kw))[1])
    for _ in range(2):
        got = spread_batch.select_regions_batch(*args, device=True)
        np.testing.assert_array_equal(got.chosen, want.chosen)
        assert got.errors == want.errors and sorted(got.fallback) == sorted(want.fallback)
    assert fetched == [(3 * 40 * 4,)] * 2  # the block's bytes, once a call


def test_region_name_ranks_go_to_the_device_once_per_layout(monkeypatch):
    """Two device-route calls over one layout pass combo_select the same
    `rname` tensor, the layout's cached i32[R] copy of its name ranks."""
    args, _, seen = _device_route(monkeypatch)
    for _ in range(2):
        spread_batch.select_regions_batch(*args, device=True)
    layout = args[3]
    assert len(seen) == 2 and seen[0][3] is seen[1][3] is layout.rname_tensor(CPU)
    assert seen[0][3].dtype == torch.int32
    np.testing.assert_array_equal(seen[0][3].numpy(), layout.rname_rank)


@pytest.mark.parametrize("route,code", [("auto", 0), ("reread", 1)])
def test_group_score_launch_passes_its_route(route, code, fake_lib):
    calls, _ = fake_lib
    args, _ = _group_args()
    kernels._group_score_launch(*args, route=route)
    (_, cargs), = calls
    assert cargs[16:18] == (args[9].numel(), code)  # Cp, then the route


def _launcher(R=4, extra=False):
    rng = np.random.default_rng(R)
    d = chip_smoke.random_tier_inputs(rng, CPU, 20, 64, R, 8, 16)
    ans = torch.from_numpy(rng.integers(-1, 9, (20, 64)).astype(np.int32)) if extra else None
    L = kernels.TierLauncher(d["has_summary"], d["req_unique"], d["req_idx"], d["replicas"],
                             d["unknown_request"], request=d["request"], extra_avail=ans)
    return d, L


@pytest.mark.parametrize("R,blocks", [(4, 1), (17, 2)])
@pytest.mark.parametrize("mode", ["rows", "window"])
def test_tier_launcher_binds_once_and_calls_once_per_tier(mode, R, blocks, fake_lib):
    """The per-round tier launcher binds its two C entries at build time,
    once each, and a tier then costs one C call per estimate and one per
    consumption (per block of 16 resources), with the prototype's argument
    count: the round's TierRound by reference, the call's capacity, rows
    and output."""
    calls, loads = fake_lib
    d, L = _launcher(R, extra=True)
    assert loads == ["tiers", "tiers"] and set(kernels._bound) == {
        "tier_estimate_round", "tier_consume_round"}
    avail = torch.zeros((20, 64), dtype=torch.int32)
    L.rows_mode(avail) if mode == "rows" else L.window_mode(d["cand_idx"])
    placed = d["placed"] if mode == "rows" else d["placed_k"]
    cap, rows = d["capacity"], d["rows"]
    outs = []
    for tier in range(3):
        outs.append(L.estimate(cap, rows, use_extra=tier != 1))
        cap = L.consume(cap, placed, d["unsched"], rows)
    protos = c_prototypes()
    assert [name for name, _ in calls] == (["tier_estimate_round"] + ["tier_consume_round"]
                                           * blocks) * 3
    assert all(len(args) == protos[name] for name, args in calls)
    assert loads == ["tiers", "tiers"]
    est = [args for name, args in calls if name == "tier_estimate_round"]
    for tier, (args, out) in enumerate(zip(est, outs)):
        assert args[0]._obj is L._round and args[2] is None and args[8] is None
        assert args[3:6] == (rows.data_ptr(), 8, tier != 1) and args[7] == out.data_ptr()
        table = mode == "rows" and kernels.estimate_route(L.U, 8) == "table"
        assert (out is avail) == (mode == "rows") and args[6] == table
    rnd = L._round
    assert (rnd.req_idx, rnd.extra_avail, rnd.B, rnd.C, rnd.R) == (
        d["req_idx"].data_ptr(), L.extra_avail.data_ptr(), 20, 64, R)
    assert (rnd.cand_idx is not None, rnd.K) == ((True, 16) if mode == "window" else (False, 0))
    con = [args for name, args in calls if name == "tier_consume_round"]
    assert all(args[0]._obj.scratch == L._consume._scratch.data_ptr() for args in con)
    assert [args[0]._obj.R for args in con[:blocks]] == ([4] if R == 4 else [16, 1])


def test_tier_launcher_pairs_a_tiers_passes_in_one_call(fake_lib):
    """Window mode estimates a tier's main and speculative passes in one C
    call: the capacity and the reclaim, the main pass with the answers,
    into two new [n, K] outputs each call; setting rows mode afterwards
    clears the window from the estimate's round and the consumption's."""
    calls, _ = fake_lib
    d, L = _launcher(extra=True)
    L.window_mode(d["cand_idx"])
    reclaim = torch.ones_like(d["capacity"])
    main, spec = L.estimate_pair(d["capacity"], reclaim, d["rows"])
    again, _ = L.estimate_pair(d["capacity"], reclaim, d["rows"])
    (name, args), (_, args2) = calls
    assert name == "tier_estimate_round" and len(args) == c_prototypes()[name]
    assert args[1:6] == (d["capacity"].data_ptr(), reclaim.data_ptr(), d["rows"].data_ptr(), 8,
                         True)
    assert args[6:] == (0, main.data_ptr(), spec.data_ptr()) and main.data_ptr() != spec.data_ptr()
    assert main.shape == spec.shape == (8, 16)
    assert again.data_ptr() not in (main.data_ptr(), spec.data_ptr())
    assert kernels.launch_counts()["tier_estimate"] >= 2
    L.rows_mode(torch.zeros((20, 64), dtype=torch.int32))
    assert L.cand_idx is None and (L._round.cand_idx, L._round.K) == (None, 0)
    assert all((rnd.cand_idx, rnd.K) == (None, 0) for *_, rnd, _ref in L._consume._blocks)


def test_tier_launcher_refuses_a_wrong_tensor_at_build(fake_lib):
    """A round-constant tensor of the wrong dtype is refused when the
    launcher is built (and the avail buffer or window when its mode is
    set), before any C call."""
    calls, _ = fake_lib
    d, _L = _launcher()
    args = [d[n] for n in chip_smoke.ESTIMATE_ARGS[1:]]
    for k, bad in ((1, d["req_unique"].int()), (2, d["req_idx"].long()),
                   (4, d["unknown_request"].int())):
        with pytest.raises(TypeError, match="dtype"):
            kernels.TierLauncher(*args[:k], bad, *args[k + 1:], request=d["request"])
    with pytest.raises(TypeError, match="dtype"):
        kernels.TierLauncher(*args, request=d["request"].int())
    _d, L = _launcher()
    with pytest.raises(TypeError, match="dtype"):
        L.rows_mode(torch.zeros((20, 64), dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        L.window_mode(d["cand_idx"][:5])
    assert calls == []


def test_tier_estimate_launch_passes_the_table_route(fake_lib):
    """The public wrapper is one launcher call: in rows mode the table
    route sets a [U, C] table scratch in the round and the call's table
    flag, the element route neither; window mode a fresh [n, K] output."""
    calls, _ = fake_lib
    d = _tier()
    args = [d[n] for n in chip_smoke.ESTIMATE_ARGS] + [d["rows"]]
    out = torch.zeros((20, 64), dtype=torch.int32)
    for route in ("table", "element"):
        kernels._tier_estimate_launch(*args, out=out, route=route)
    win = kernels._tier_estimate_launch(*args, cand_idx=d["cand_idx"], route="table")
    (_, a), (_, b), (_, c) = calls
    assert a[6] == 1 and a[0]._obj.est_u is not None and a[7] == out.data_ptr()
    assert b[6] == 0 and b[0]._obj.est_u is None
    assert c[6] == 0 and c[7] == win.data_ptr() and win.shape == (8, 16)
    assert a[0]._obj.U == d["req_unique"].shape[0]


def test_tier_launcher_cuts_each_output_once(fake_lib):
    """Window estimates and consumed capacities are cut in turn from one
    block the launcher allocates (2B window rows: a round's main and
    speculative passes), none handed out twice; a used-up block is
    followed by a new one; an explicit `out` is written instead."""
    d, L = _launcher()
    L.window_mode(d["cand_idx"])
    B, n, K = 20, 8, 16
    outs = [L.launch_estimate(d["capacity"], d["rows"]) for _ in range(2 * B // n)]
    base = outs[0].untyped_storage().data_ptr()
    assert all(o.untyped_storage().data_ptr() == base and o.shape == (n, K) for o in outs)
    assert [o.data_ptr() - base for o in outs] == [i * n * K * 4 for i in range(len(outs))]
    assert L.launch_estimate(d["capacity"], d["rows"]).untyped_storage().data_ptr() != base
    mine = torch.empty((n, K), dtype=torch.int32)
    assert L.launch_estimate(d["capacity"], d["rows"], out=mine) is mine
    caps = [L.launch_consume(d["capacity"], d["placed_k"], d["unsched"], d["rows"])
            for _ in range(kernels.TIER_CAP_BLOCK + 1)]
    assert len({c.data_ptr() for c in caps}) == len(caps)
    assert len({c.untyped_storage().data_ptr() for c in caps}) == 2
    assert all(c.shape == (64, 4) and c.is_contiguous() for c in caps)
