"""The port's partitioned mesh rounds held against the JAX package.

The reference's mesh runs partitioned by default: its single-device round
with the fleet column-sharded, GSPMD partitioning every program over the 8
virtual CPU devices that conftest.py gives JAX. The port runs the same grid
shape as a virtual mesh of 8 CPU devices (`virtual_mesh(8, "cpu")`, 4 x 2):
the compact round's candidate select on every (row group, column shard)
tile from its column offset, one window merge a row group; the dense
round's tile filter and gather; the tiered rounds on those. Held here,
exactly: the tiles' selections merged against the single-device selection,
the packed-mask stitch, decisions and error strings of the compact, dense,
spread and tiered rounds (with and without answers and plugin terms),
`run_kernel`'s ten outputs, a fleet whose shards are narrower than the
window, `autoshard=`, the scenario-sharded simulation, `dryrun_multichip`,
and replay, the pipeline and the dirty-column refresh under the mesh."""
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.sched import preemption as jpre  # noqa: E402
from karmada_tpu.simulation import Simulator as JSimulator  # noqa: E402
from karmada_tpu.testing.fixtures import synthetic_fleet  # noqa: E402

import chip_smoke  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402
from karmada_tpu_torch.graft_entry import dryrun_multichip  # noqa: E402
from karmada_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from karmada_tpu_torch.sched import preemption as tpre  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402
from karmada_tpu_torch.sched.core import pack_bits  # noqa: E402
from karmada_tpu_torch.simulation import Simulator  # noqa: E402
from karmada_tpu_torch.testing.cpumesh import virtual_devices, virtual_mesh  # noqa: E402

import test_torch_mesh as tm  # noqa: E402
from test_simulation import mixed_bindings, scenario_set  # noqa: E402
from test_torch_plugins import _registries  # noqa: E402
from test_torch_preemption import _fixture as tier_fixture  # noqa: E402
from test_torch_preemption import _view as tier_view  # noqa: E402
from test_torch_scheduler import _decision_view, flagship_mix  # noqa: E402
from test_torch_candidates import fake_card  # noqa: E402,F401 (fixture)
from test_torch_simulation import assert_outcomes_equal  # noqa: E402
from test_torch_spread import _case  # noqa: E402
from karmada_tpu_torch.testing.plugins import HashBan, HashScore  # noqa: E402

SELECT_OUT = ("cand_idx", "c_feas", "c_score", "c_avail", "c_prev", "c_tie", "feas_count")


def _views(decisions):
    return [_decision_view(d) for d in decisions]


def _ref(clusters, **kw):
    """The reference's scheduler over its 8 CPU devices, partitioned mode."""
    return jcore.ArrayScheduler(clusters, mesh=ref_make_mesh(jax.devices()), **kw)


def _port(clusters, **kw):
    return TorchScheduler(conv(clusters), mesh=virtual_mesh(8, "cpu"), device="cpu", **kw)


def _both(clusters, bindings, *, extra=None, registries=None, **kw):
    """Both packages' partitioned mesh rounds over the same objects; the
    port's decisions, after asserting they equal the reference's."""
    rkw, pkw = dict(kw), dict(kw)
    if registries is not None:
        rkw["plugin_registry"], pkw["plugin_registry"] = registries
    want = _ref(clusters, **rkw).schedule(bindings, extra_avail=extra)
    port = _port(clusters, **pkw)
    got = port.schedule(conv(bindings), extra_avail=extra)
    assert port.mesh_partitioned and port.mesh.shape == {"bindings": 4, "clusters": 2}
    assert _views(got) == _views(want)
    return got, port


@pytest.fixture()
def counted(monkeypatch):
    """Every call of the partitioned rounds' kernels, as (name, col0)."""
    calls = []
    for name in ("candidate_select", "candidate_merge", "mesh_tile_filter", "dense_filter",
                 "candidate_tail", "dense_tail"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append((_n, kw.get("col0"))), _fn(*a, **kw))[1])
    return calls


# ------------------------------------------------- the tiles and the merge


def _tile_args(args, c0, c1):
    """candidate_select's arguments cut to the columns [c0, c1): the fleet
    slice, the affinity table and the [B, C] terms as column views."""
    cut = [x[c0:c1] for x in args[:7]] + list(args[7:12]) + [args[12][:, c0:c1]]
    cut += list(args[13:20]) + [None if args[20] is None else args[20][:, c0:c1]]
    return cut


@pytest.mark.parametrize("C,n_shards,k,terms", [
    (5120 // 16, 2, 128, False), (300, 2, 128, True), (200, 2, 128, False),
    (301, 3, 64, True), (40, 4, 8, False), (512, 4, 256, True)])
def test_tile_selections_merge_to_the_single_device_selection(C, n_shards, k, terms):
    """select_plain(col0=) on each column tile of a seeded tie-heavy batch
    (the affinity table, answers, mask and score read as column views),
    then candidate_merge_plain, equals select_plain over the whole fleet:
    window ids, the five fields and the feasible count; shards narrower
    than k (200 on two shards, k 128) included."""
    rng = np.random.default_rng(C + n_shards)
    args = list(chip_smoke.random_select_inputs(rng, "cpu", 9, C))
    kw = {}
    if terms:
        kw = {"extra_mask": torch.from_numpy(rng.random((9, C)) < 0.9),
              "extra_score": torch.from_numpy(rng.integers(-3, 3, (9, C)).astype(np.int32))}
    want = kernels.select_plain(*args, k=k, plugin_bits=31, **kw)
    width = -(-C // n_shards)
    windows, packed, widths = [], [], []
    for j in range(n_shards):
        c0, c1 = j * width, min(C, (j + 1) * width)
        widths.append(c1 - c0)
        tkw = {n: v[:, c0:c1] for n, v in kw.items()}
        w = kernels.select_plain(*_tile_args(args, c0, c1), k=min(k, c1 - c0), plugin_bits=31,
                                 col0=c0, **tkw)
        assert ((w[0] >= c0) & (w[0] < c1)).all()  # global ids of the tile's columns
        windows.append(w[:7])
        packed.append(w[7])
    got = kernels.candidate_merge(windows, k)
    for name, g, x in zip(SELECT_OUT, got, want[:7]):
        assert torch.equal(g, x), name
    assert torch.equal(tmesh.stitch_packed(packed, widths, "cpu"), want[7])


@pytest.mark.parametrize("widths", [(16, 24, 8), (7, 7), (13, 5, 9, 1), (2560, 2560)])
def test_stitch_packed_shifts_unaligned_shards(widths):
    """Packed masks of consecutive column ranges stitch into the packed
    mask of the whole: byte-aligned ranges land as their bytes, others
    shifted by their bit offset."""
    rng = np.random.default_rng(sum(widths))
    full = torch.from_numpy(rng.random((5, sum(widths))) < 0.5)
    bounds = np.cumsum((0,) + widths)
    parts = [pack_bits(full[:, a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    assert torch.equal(tmesh.stitch_packed(parts, widths, "cpu"), pack_bits(full))


def test_merge_rejects_windows_it_cannot_take():
    """candidate_merge_plain and the launch's checks: k within the windows'
    total width, at most MAX_MERGE_SHARDS windows."""
    w = tuple(torch.zeros((2, 3), dtype=dt) for dt in (torch.int32, torch.bool) + (
        torch.int32,) * 4) + (torch.zeros(2, dtype=torch.int32),)
    with pytest.raises(ValueError, match="must be in"):
        kernels.candidate_merge_plain([w, w], 7)
    with pytest.raises(ValueError, match="windows"):
        kernels._candidate_merge_launch([w] * (kernels.MAX_MERGE_SHARDS + 1), 3)


def test_merge_launch_marshals_the_shard_table(fake_card):
    """candidate_merge's launch: one C call with the table of the c shard
    windows (their pointers and widths), c, the rows and K, then the seven
    outputs ([B, K] and the [B] counts) and the stream."""
    import test_torch_launch_binding as lb

    windows = [lb._merge_window(5, w, c0) for w, c0 in ((40, 0), (7, 40), (60, 100))]
    out = kernels._candidate_merge_launch(windows, 64)
    (name, cargs), = fake_card
    assert name == "candidate_merge_launch" and len(cargs) == 12
    assert cargs[1:4] == (3, 5, 64)
    assert cargs[4:11] == tuple(o.data_ptr() for o in out)
    assert out[0].shape == (5, 64) and out[6].shape == (5,)


def test_tier_consume_per_row_group_equals_one_clamp():
    """max(cap - placed.T @ request, 0) clamped after each row group equals
    one clamp of the whole tier's sum (placements and requests are
    non-negative), in the dense and the window mode: consumption may be
    summed over the bindings axis in any grouping."""
    rng = np.random.default_rng(11)
    B, C, R, K = 24, 40, 3, 8
    cap = torch.from_numpy(rng.integers(0, 60, (C, R)).astype(np.int64))
    request = torch.from_numpy(rng.integers(0, 9, (B, R)).astype(np.int64))
    rows = torch.arange(B, dtype=torch.int32)
    unsched = torch.from_numpy(rng.random(B) < 0.2)
    dense = torch.from_numpy(rng.integers(0, 5, (B, C)).astype(np.int32))
    cand = torch.from_numpy(np.sort(np.stack([rng.choice(C, K, replace=False)
                                              for _ in range(B)]), 1).astype(np.int32))
    window = torch.from_numpy(rng.integers(0, 5, (B, K)).astype(np.int32))
    for placed, kw in ((dense, {}), (window, {"cand_idx": cand})):
        whole = kernels.tier_consume_plain(cap, placed, unsched, request, rows, **kw)
        step = cap
        for lo, hi in tmesh.row_bounds(B, 4):
            step = kernels.tier_consume_plain(step, placed[lo:hi], unsched[lo:hi], request,
                                              rows[lo:hi], **kw)
        assert torch.equal(step, whole)
        assert (whole == 0).any()  # the clamp bites


# --------------------------------------------------------- the rounds


@pytest.mark.parametrize("terms", [None, "answers", "plugins"])
def test_compact_round_matches_reference(terms, counted):
    """The flagship mix over a 4 x 2 mesh, the compact round: decisions and
    error strings equal the reference's partitioned round, with no terms,
    with answers and with a ban and a score plugin; every tile launched
    the select from its column offset and every row group one merge."""
    clusters, bindings = flagship_mix(n_clusters=320, n_bindings=160)
    kw = {}
    if terms == "answers":
        kw["extra"] = np.random.default_rng(3).integers(-1, 9, (160, 320)).astype(np.int32)
    if terms == "plugins":
        kw["registries"] = _registries(HashBan(share=4), HashScore())
    got, port = _both(clusters, bindings, **kw)
    assert port.last_candidate_stats and sum(d.ok for d in got) > 100
    width = len(port.fleet.names) // 2
    selects = [c for n, c in counted if n == "candidate_select"]
    assert selects[:8] == [0, width] * 4
    assert [n for n, _ in counted].count("candidate_merge") >= 4
    assert "dense_filter" not in [n for n, _ in counted]


def test_compact_round_shards_narrower_than_the_window(counted):
    """200 clusters at their exact width on two column shards, with
    ClusterAffinity off so that no affinity bound shrinks the window: each
    shard's window holds min(K, 100) = 100 entries and the merge takes
    windows narrower than K = 128; the round decides as the reference's
    and as the port's single-device round."""
    clusters, bindings = flagship_mix(seed=1, n_clusters=200, n_bindings=96)
    kw = {"bucket_cols": False, "plugins": ["*", "-ClusterAffinity"]}
    got, port = _both(clusters, bindings, **kw)
    assert len(port.fleet.names) == 200 and port.last_candidate_stats["candidate_k"] == 128
    one = TorchScheduler(conv(clusters), device="cpu", **kw)
    assert _views(one.schedule(conv(bindings))) == _views(got)
    assert ("candidate_merge", None) in counted


@pytest.mark.parametrize("with_extra", [False, True])
def test_dense_round_matches_reference(with_extra, counted):
    """tests/test_parallel.py's ragged fixture (13 clusters x 11 bindings,
    every strategy): the dense round's filter runs on the 8 tiles and the
    round decides as the reference's partitioned round."""
    clusters, bindings = tm._ragged()
    extra = None
    if with_extra:
        extra = np.random.default_rng(5).integers(-1, 7, (11, 13)).astype(np.int32)
    got, port = _both(clusters, bindings, extra=extra)
    assert sum(d.ok for d in got) >= 8
    assert sorted(c for n, c in counted if n == "mesh_tile_filter")[:8] == [0] * 4 + [8] * 4
    assert "dense_filter" not in [n for n, _ in counted]


@pytest.mark.parametrize("terms", [None, "answers", "all"])
def test_run_kernel_ten_outputs_match_reference(terms):
    """`run_kernel` under the partitioned mesh returns the single-device
    ten outputs, as the reference's does: all of them equal the
    reference's partitioned run_kernel on the ragged batch."""
    clusters, bindings = tm._ragged()
    ref, port = _ref(clusters), _port(clusters)
    jb = ref._pad(ref.batch_encoder.encode(bindings))
    tb = port._pad(port.batch_encoder.encode(conv(bindings)))
    B, C = len(jb.replicas), len(ref.fleet.names)
    rng = np.random.default_rng(7)
    kw = {}
    if terms:
        kw["extra_avail"] = rng.integers(-1, 7, (B, C)).astype(np.int32)
    if terms == "all":
        kw["extra_mask"] = rng.random((B, C)) < 0.85
        kw["extra_score"] = rng.integers(0, 40, (B, C)).astype(np.int32)
    want = [np.asarray(x) for x in ref.run_kernel(jb, **kw)]
    got = [x.numpy() for x in port.run_kernel(tb, **kw)]
    for name, g, w in zip(tm.MESH_OUT, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_unschedulable_rows_match_reference():
    """tests/test_parallel.py's too-big and nowhere rows: the error strings
    of both branches."""
    clusters, _ = tm._ragged()
    bindings = [
        tm.ref_tests.make_binding("fit", 4, tm.ref_tests.dyn_placement(), cpu=0.5),
        tm.ref_tests.make_binding("too-big", 10_000_000, tm.ref_tests.dyn_placement(), cpu=16.0),
        tm.ref_tests.make_binding("nowhere", 2, tm.duplicated_placement(["no-such-cluster"])),
    ]
    got, _ = _both(clusters, bindings)
    assert got[0].ok and got[1].error.startswith("Clusters available replicas")
    assert got[2].error == f"0/{len(clusters)} clusters are available"


@pytest.mark.parametrize("case", ["skewed", "fallback_dense", "fallback_window"])
def test_spread_rows_match_reference(case):
    """Spread rows over the partitioned mesh: the dense round's batched
    region path and per-row re-solve on the gathered rows, and the compact
    round's host selection over the merged windows (fallback_window, K 16)
    with its dense re-solve of rows wider than the window."""
    clusters, bindings, k = _case(case)
    got, _ = _both(clusters, bindings, candidate_k=k)
    assert sum(d.ok for d in got) > len(got) // 2


@pytest.mark.parametrize("name", ["contended", "unschedulable_middle", "compact", "speculative"])
def test_tiered_round_matches_reference(name):
    """launch_tiered over the partitioned mesh (the dense and the compact
    tiered launch, the speculative preemption pass) decides as the
    reference's launch over its mesh (tests/test_preemption.py
    test_parity_mesh's contract) and as the port's single-device launch."""
    clusters, bindings, placed, mode = tier_fixture(name)
    jarr = _ref(clusters)
    want = jarr.materialize_chunk(jpre.launch_tiered(jarr, bindings, placed=placed))
    port = _port(clusters)
    pend = tpre.launch_tiered(port, conv(bindings), placed=conv(placed))
    got = port.materialize_chunk(pend)
    assert [tier_view(d) for d in got] == [tier_view(d) for d in want]
    assert (pend["state"]["cand_dev"] is None) == (mode == "dense")
    one = TorchScheduler(conv(clusters), device="cpu")
    alone = one.materialize_chunk(tpre.launch_tiered(one, conv(bindings), placed=conv(placed)))
    assert [tier_view(d) for d in got] == [tier_view(d) for d in alone]


# ---------------------------------------- autoshard, simulation, dry run


@pytest.mark.parametrize("autoshard", [True, False])
def test_autoshard_keyword_routes_oversized_rounds(autoshard):
    """ArrayScheduler(autoshard=) with the [B, C] budget shrunk below the
    round: on, both packages re-place the fleet over a mesh of their 8
    devices (the port's through `virtual_devices`) and run partitioned;
    off, neither does. Decisions equal the reference's either way."""
    clusters, bindings = flagship_mix(seed=4, n_clusters=96, n_bindings=64)
    ref = jcore.ArrayScheduler(clusters, autoshard=autoshard)
    port = TorchScheduler(conv(clusters), autoshard=autoshard, device="cpu")
    for s in (ref, port):
        s.max_bc_elems = 1024
    want = ref.schedule(bindings)
    with virtual_devices(8, "cpu"):
        got = port.schedule(conv(bindings))
    assert (ref.mesh is not None) == (port.mesh is not None) == autoshard
    if autoshard:
        assert port.mesh.shape == dict(ref.mesh.shape) and port.mesh_partitioned
        assert port._max_rows_per_round(len(port.fleet.names)) == ref._max_rows_per_round(
            len(ref.fleet.names))
    assert _views(got) == _views(want)


def test_scenario_sharded_simulation_matches_reference():
    """An oversized what-if with eight devices visible: the scenario axis
    shards over them in both packages (`last_stats["mesh"]`), one solve a
    chunk, and the outcomes equal the reference's."""
    clusters = synthetic_fleet(12, seed=7)
    names = [c.name for c in clusters]
    bindings, scenarios = mixed_bindings(names), scenario_set(names)
    jsim = JSimulator(clusters, max_bc_elems=256)
    jbase, jouts = jsim.simulate(bindings, scenarios)
    sim = Simulator(conv(clusters), max_bc_elems=256, device="cpu")
    with virtual_devices(8, "cpu"):
        base, outs = sim.simulate(conv(bindings), conv(scenarios))
    assert sim.last_stats == jsim.last_stats and sim.last_stats["mesh"] is True
    assert_outcomes_equal([base] + outs, [jbase] + jouts)


def test_dryrun_multichip_on_cpu():
    """graft_entry.dryrun_multichip(8, device="cpu") runs the reference's
    dry run on a virtual mesh of the CPU, asserting inside; without a card
    the default device raises."""
    dryrun_multichip(8, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dryrun_multichip(2)


def test_replay_pipeline_and_refresh_under_the_mesh():
    """What the reference keeps working under its mesh: the replay cache
    (a second incremental round replays every row), the chunk pipeline (a
    shrunk budget cut into pipelined chunks, the row cap scaled by the
    bindings axis) and the dirty-column refresh (the shards re-placed),
    each deciding as the reference."""
    import copy

    clusters, bindings = flagship_mix(seed=5, n_clusters=160, n_bindings=120)
    ref, port = _ref(clusters), _port(clusters, pipeline=True)
    pb = conv(bindings)
    assert _views(port.schedule_incremental(pb)) == _views(ref.schedule_incremental(bindings))
    port.schedule_incremental(pb)
    assert port.last_round_stats == {"replayed": 120, "solved": 0}
    for s in (ref, port):
        s.max_bc_elems = 8 * len(s.fleet.names)
    assert port._max_rows_per_round(len(port.fleet.names)) == 32
    assert _views(port.schedule(pb)) == _views(ref.schedule(bindings))
    assert port.last_pipeline_stats["chunks"] > 1
    shard = port._fleet_shards
    assert shard is not None
    changed = copy.deepcopy(clusters)
    dirty = set()
    for c in changed[2::11]:
        c.status.resource_summary.allocated = dict(c.status.resource_summary.allocatable)
        dirty.add(c.name)
    encoder = port.batch_encoder
    ref.set_clusters(changed, dirty_names=dirty)
    port.set_clusters(conv(changed), dirty_names=dirty)
    assert port.batch_encoder is encoder and port._fleet_shards is not shard
    assert _views(port.schedule(pb)) == _views(ref.schedule(bindings))


# ------------------------------- the tiered rounds and the fleet placement


@pytest.mark.parametrize("name", ["contended", "compact"])
def test_tiered_round_tiles_only_its_select_or_filter(name, monkeypatch):
    """The partitioned tiered rounds cut only their [B, C] kernel into
    tiles (the dense launch's tile filter, the compact launch's select
    from each column offset); the tier kernels then run over the whole
    fleet on the round's device, from the gathered rows or the merged
    windows, through one launcher a round."""
    calls = []
    for n in ("tier_launcher", "candidate_select", "mesh_tile_filter", "dense_filter"):
        fn = getattr(kernels, n)
        monkeypatch.setattr(kernels, n, lambda *a, _fn=fn, _n=n, **kw: (
            calls.append((_n, a, kw)), _fn(*a, **kw))[1])
    clusters, bindings, placed, mode = tier_fixture(name)
    port = _port(clusters)
    port.materialize_chunk(tpre.launch_tiered(port, conv(bindings), placed=conv(placed)))
    names = [n for n, _, _ in calls]
    launchers = [a for n, a, _ in calls if n == "tier_launcher"]
    assert len(launchers) == 1 and "dense_filter" not in names
    assert launchers[0][0] is port._fleet_dev["has_summary"]
    width = len(port.fleet.names) // 2
    tile = "mesh_tile_filter" if mode == "dense" else "candidate_select"
    assert [kw["col0"] for n, _, kw in calls if n == tile][:8] == [0, width] * 4


@pytest.mark.parametrize("grid", [(4, 2), (1, 3), (2, 4)])
@pytest.mark.parametrize("kind", ["select", "filter"])
def test_tiles_at_a_tier_capacity_equal_the_single_device_kernel(grid, kind):
    """A tiered round hands its tier's residual capacity to the round's
    [B, C] kernel: under the partitioned mesh each tile reads its shard's
    rows of it (`ShardedFleet.tile(capacity=)`), and the merged select's
    or the gathered filter's outputs equal the single-device kernel's at
    the same capacity, bit for bit, on 2, 3 and 4 column shards."""
    clusters, bindings = flagship_mix(seed=6, n_clusters=150, n_bindings=40)
    port = TorchScheduler(conv(clusters), mesh=tmesh.Mesh([["cpu"] * grid[1]] * grid[0]),
                          device="cpu")
    t = port._encode_round(conv(bindings))[4]
    full = port._fleet_dev["capacity"]
    cap = full // torch.from_numpy(np.random.default_rng(grid[1]).integers(
        1, 4, (full.shape[0], 1)))

    def run():
        if kind == "select":
            return port._candidate_select(t, 128, capacity=cap)
        return port._dense_filter(t, capacity=cap)

    got = run()
    port.mesh_partitioned = False  # the same call over the whole resident fleet
    want = run()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
    assert bool(got[1].any())


def test_sharded_fleet_is_placed_at_the_first_partitioned_round():
    """Under a mesh the column-sharded fleet is placed by the first
    partitioned round, kept across rounds and dropped when the fleet is
    placed again; the monolithic mode never places one."""
    clusters, bindings = tm._ragged()
    mono = _port(clusters)
    mono.mesh_partitioned = False
    mono.schedule(conv(bindings))
    assert mono._fleet_shards is None and mono._mesh_kernel is not None
    part = _port(clusters)
    assert part._fleet_shards is None
    part.schedule(conv(bindings))
    shards = part._fleet_shards
    assert shards is not None and shards.col0 == [0, len(part.fleet.names) // 2]
    part.schedule(conv(bindings))
    assert part._fleet_shards is shards
    part.set_clusters(conv(clusters))
    assert part._fleet_shards is None


def test_virtual_devices_is_scoped_to_its_thread():
    """`virtual_devices` shows its n devices to the calling thread only,
    nests, and restores the real view after the block: another thread's
    oversized rounds keep seeing the one CPU device."""
    seen = {}
    with virtual_devices(8, "cpu"):
        other = threading.Thread(target=lambda: seen.update(other=tmesh.visible_devices("cpu")))
        other.start()
        other.join()
        assert len(tmesh.visible_devices("cpu")) == 8
        with virtual_devices(2, "cpu"):
            assert tmesh.visible_devices("cpu") == [torch.device("cpu")] * 2
        assert len(tmesh.visible_devices("cpu")) == 8
    assert seen["other"] == [torch.device("cpu")]
    assert tmesh.visible_devices("cpu") == [torch.device("cpu")]
