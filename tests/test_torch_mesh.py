"""The PyTorch port's mesh-sharded solve held against the JAX package.

The reference runs its mesh on the 8 virtual CPU devices that conftest.py
gives JAX; the port runs the same grid shape as a virtual mesh of 8 CPU
devices (`testing.cpumesh.virtual_mesh(8, "cpu")`, 4 x 2). Held here:
factor_mesh; `mesh_tile_filter_plain` on tiles of a batch against the
reference's `decompress_batch(col_offset=)` + `filter_estimate_phase` and
the terms it applies after its gather; the port's MeshScheduleKernel
against the reference's on the ragged 13-cluster x 11-binding fixture of
tests/test_parallel.py, all ten outputs; and the monolithic mesh round of
ArrayScheduler (`mesh_partitioned = False`) against the reference's,
decision for decision. Every comparison is exact (integer and bool
outputs). Only the compact window's order is compared as a set against the
reference's mesh outputs, whose backend orders equal values its own way
(as tests/test_parallel.py compares them); against the reference's
single-device outputs the window is compared exactly, in (value desc,
column asc) order."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.api import policy as jpol  # noqa: E402
from karmada_tpu.parallel import MeshScheduleKernel as RefMeshKernel  # noqa: E402
from karmada_tpu.parallel import factor_mesh as ref_factor_mesh  # noqa: E402
from karmada_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from karmada_tpu.parallel.mesh import make_hierarchical_mesh as ref_hierarchical  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.testing.fixtures import (  # noqa: E402
    duplicated_placement,
    static_weight_placement,
    synthetic_fleet,
)

from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import batch_from_numpy, from_reference_objects, mesh_like  # noqa: E402
from karmada_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from karmada_tpu_torch.sched import preemption  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402
from karmada_tpu_torch.testing.cpumesh import virtual_mesh  # noqa: E402

import test_parallel as ref_tests  # noqa: E402
from test_torch_candidates import BATCH_FIELDS, FLEET_FIELDS  # noqa: E402
from test_torch_candidates import fake_card  # noqa: E402,F401 (fixture)
from test_torch_scheduler import _binding, _decision_view, _dyn, flagship_mix  # noqa: E402
from test_torch_spread import _case  # noqa: E402

MESH_OUT = ("feasible", "score", "result", "unschedulable", "avail_sum", "avail",
            "feas_count", "nnz", "top_idx", "top_val")
TILE_OUT = ("feasible", "score", "avail", "prev_replicas", "tie", "feas_count")


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _ragged():
    """tests/test_parallel.py's fixture: 13 clusters (not divisible by 2) x
    11 bindings (not divisible by 4), every strategy, a third with a
    previous placement."""
    clusters = synthetic_fleet(13, seed=3)
    names = [c.name for c in clusters]
    bindings = []
    for i in range(11):
        kind = i % 4
        if kind == 0:
            p = duplicated_placement(names[: 3 + i % 5])
        elif kind == 1:
            p = static_weight_placement({names[j]: j + 1 for j in range(1 + i % 6)})
        else:
            p = ref_tests.dyn_placement(aggregated=kind == 3)
        prev = {names[i % len(names)]: 2} if i % 3 == 0 else None
        bindings.append(ref_tests.make_binding(f"app-{i}", 5 + i, p, cpu=0.5 + 0.25 * (i % 3),
                                               prev=prev))
    return clusters, bindings


def _ref_mesh_sched(clusters, **kw):
    ref = jcore.ArrayScheduler(clusters, mesh=ref_make_mesh(jax.devices()), **kw)
    ref.mesh_partitioned = False
    return ref


def _port_mesh_sched(clusters, mesh=None, **kw):
    port = TorchScheduler(from_reference_objects(clusters),
                          mesh=mesh or virtual_mesh(8, "cpu"), device="cpu", **kw)
    port.mesh_partitioned = False
    return port


def _views(decisions):
    return [_decision_view(d) for d in decisions]


# ---------------------------------------------------------------- the mesh


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_mesh_matches_reference(n):
    assert tmesh.factor_mesh(n) == ref_factor_mesh(n)


def test_virtual_mesh_and_mesh_like():
    ref = ref_make_mesh(jax.devices())
    port = virtual_mesh(8, "cpu")
    assert port.shape == dict(ref.shape) == {"bindings": 4, "clusters": 2}
    assert port.axis_names == tuple(ref.axis_names)
    assert port.devices.shape == ref.devices.shape
    assert {str(d) for d in port.devices.flat} == {"cpu"}
    like = mesh_like(ref, "cpu")
    assert like.shape == port.shape and like.axis_names == port.axis_names
    with pytest.raises(ValueError):
        mesh_like(ref, ["cpu"] * 3)


def test_make_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError):
        tmesh.make_hierarchical_mesh()
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(["cuda:0"])


def test_initialize_multihost():
    assert tmesh.initialize_multihost() is None  # no coordinator: a no-op
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tmesh.initialize_multihost("localhost:1234", num_processes=2, process_id=0)


def test_hierarchical_mesh_degenerates_on_one_host():
    """As tests/test_parallel.py's: on one process the hierarchical mesh is
    make_mesh's factorization, and the scheduler over it decides as the
    reference's over its own hierarchical mesh."""
    ref_mesh = ref_hierarchical(jax.devices())
    port_mesh = tmesh.make_hierarchical_mesh(["cpu"] * 8)
    assert port_mesh.shape == dict(ref_mesh.shape)
    assert port_mesh.axis_names == tuple(ref_mesh.axis_names)
    clusters = synthetic_fleet(24, seed=11)
    bindings = [ref_tests.make_binding(f"b{i}", 6 + i, ref_tests.dyn_placement(), cpu=0.5)
                for i in range(10)]
    ref = jcore.ArrayScheduler(clusters, mesh=ref_mesh)
    ref.mesh_partitioned = False
    want = ref.schedule(bindings)
    got = _port_mesh_sched(clusters, mesh=port_mesh).schedule(from_reference_objects(bindings))
    assert _views(got) == _views(want)
    assert all(d.ok for d in got)


# ---------------------------------------------------------- the tile filter


def _encoded_mix(seed=0):
    """The converted flagship mix encoded by both packages (96 clusters,
    128 bindings), plus seeded prev / evict ids over the whole padded fleet
    (the sentinel included) so that a tile sees ids of other tiles."""
    clusters, bindings = flagship_mix(seed=seed, n_clusters=96, n_bindings=128)
    ref = jcore.ArrayScheduler(clusters, candidate_k=0)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=0, device="cpu")
    jb = ref._pad(ref.batch_encoder.encode(bindings))
    tb = port._pad(port.batch_encoder.encode(from_reference_objects(bindings)))
    for name in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
    return ref, port, tb


@pytest.mark.parametrize("grid,tile,terms,plugins", [
    ((4, 2), (1, 1), False, None),
    ((4, 2), (2, 0), True, None),
    ((2, 3), (0, 2), True, None),
    ((2, 3), (1, 1), True, ["*", "-TaintToleration", "-ClusterLocality"]),
])
def test_mesh_tile_filter_plain_matches_reference(grid, tile, terms, plugins):
    """One tile of a (b, c) mesh: the plain tile filter on the tile's
    slices against the reference's decompress_batch(col_offset=) +
    filter_estimate_phase on the same slices, then the mask, score and
    answers as its mesh body applies them after the gather. C = 96 cut in
    3 gives a tile width that is no multiple of 32."""
    ref, port, tb = _encoded_mix()
    rng = np.random.default_rng(sum(grid) + sum(tile))
    B, C = len(tb.replicas), len(port.fleet.names)
    mb, mc = grid
    r, j = tile
    Bl, Cl = -(-B // mb), C // mc
    rows, cols = slice(r * Bl, (r + 1) * Bl), slice(j * Cl, (j + 1) * Cl)
    c0 = j * Cl
    prev_idx = tb.prev_idx.copy()
    evict_idx = tb.evict_idx.copy()
    hit = rng.random(prev_idx.shape) < 0.5
    prev_idx[hit] = rng.integers(0, C + 1, hit.sum())  # any tile, or the sentinel C
    hit = rng.random(evict_idx.shape) < 0.5
    evict_idx[hit] = rng.integers(0, C + 1, hit.sum())
    prev_rep = rng.integers(1, 5, prev_idx.shape).astype(np.int32)
    nb = len(tb.replicas[rows])
    extra = mask = score = None
    if terms:
        extra = rng.integers(-1, 7, (nb, C)).astype(np.int32)
        mask = rng.random((nb, C)) < 0.8
        score = rng.integers(-5, 60, (nb, C)).astype(np.int32)
    bits = port._plugin_bits if plugins is None else TorchScheduler(
        port.clusters, plugins=plugins, device="cpu")._plugin_bits

    f = ref.fleet
    aff_ok, _sw, prev_member, prev_reps, evict_ok, tie = jcore.decompress_batch(
        tb.aff_masks[:, cols], tb.aff_idx[rows], tb.weight_tables[:, cols],
        tb.weight_idx[rows], prev_idx[rows], prev_rep[rows], evict_idx[rows], tb.seeds[rows],
        Cl, col_offset=c0)
    tol = tb.tol_tables[tb.tol_idx[rows]]
    feasible, sc, avail = jcore.filter_estimate_phase(
        *(getattr(f, n)[cols] for n in FLEET_FIELDS),
        tb.replicas[rows], None, tb.unknown_request[rows], tb.gvk[rows],
        tol[:, 0], tol[:, 1], tol[:, 2], tol[:, 3], aff_ok, evict_ok, prev_member,
        req_unique=tb.req_unique, req_idx=tb.req_idx[rows], plugin_bits=bits)
    feasible, sc, avail = np.asarray(feasible), np.asarray(sc), np.asarray(avail)
    if terms:
        feasible = feasible & mask[:, cols]
        sc = sc + score[:, cols]
        e = extra[:, cols]
        avail = np.where(e >= 0, np.minimum(avail, e), avail)
    want = (feasible, sc, avail, np.asarray(prev_reps), np.asarray(tie),
            feasible.sum(-1).astype(np.int32))

    fl = port._fleet_dev
    t = batch_from_numpy({n: getattr(tb, n)[rows] for n in (
        "replicas", "unknown_request", "gvk", "tol_idx", "aff_idx", "seeds", "req_idx")}, "cpu")
    # the terms as column views of the row group's [B_l, C] blocks, as the
    # mesh kernel passes them
    views = [None if a is None else torch.from_numpy(a)[:, cols] for a in (extra, mask, score)]
    got = kernels.mesh_tile_filter(
        *(fl[n][cols] for n in FLEET_FIELDS),
        t["replicas"], t["unknown_request"], t["gvk"], torch.from_numpy(tb.tol_tables),
        t["tol_idx"], torch.from_numpy(np.ascontiguousarray(tb.aff_masks[:, cols])), t["aff_idx"],
        torch.from_numpy(prev_idx[rows]), torch.from_numpy(prev_rep[rows]),
        torch.from_numpy(evict_idx[rows]), t["seeds"], torch.from_numpy(tb.req_unique),
        t["req_idx"], *views, col0=c0, plugin_bits=bits)
    for name, a, w in zip(TILE_OUT, got, want):
        np.testing.assert_array_equal(_n(a), w, err_msg=name)
    assert _n(got[0]).any() and (_n(got[3]) > 0).any()  # feasible columns, prev in the tile


def test_mesh_tile_filter_launch_checks_strides():
    """The card route refuses a term whose columns are not contiguous (it
    reads through a row stride only), before it loads any library."""
    _, port, tb = _encoded_mix()
    fl = port._fleet_dev
    t = batch_from_numpy({n: getattr(tb, n) for n in BATCH_FIELDS}, "cpu")
    B, C = len(tb.replicas), len(port.fleet.names)
    bad = torch.zeros((C, B), dtype=torch.int32).t()  # [B, C], column stride B
    args = [fl[n] for n in FLEET_FIELDS] + [
        t["replicas"], t["unknown_request"], t["gvk"], t["tol_tables"], t["tol_idx"],
        t["aff_masks"], t["aff_idx"], t["prev_idx"], t["prev_rep"], t["evict_idx"], t["seeds"],
        t["req_unique"], t["req_idx"]]
    with pytest.raises(ValueError, match="columns must be contiguous"):
        kernels._mesh_tile_filter_launch(*args, bad, None, None, col0=0,
                                         plugin_bits=port._plugin_bits)
    with pytest.raises(ValueError, match="col0"):
        kernels._mesh_tile_filter_launch(*args, None, None, None, col0=-1,
                                         plugin_bits=port._plugin_bits)


def test_mesh_tile_filter_plain_tiles_the_dense_filter():
    """The tiles of a 2 x 3 cut, each with its column offset, put back
    together, equal the dense filter's [B, C] outputs."""
    _, port, tb = _encoded_mix(seed=1)
    fl = port._fleet_dev
    t = batch_from_numpy({n: getattr(tb, n) for n in BATCH_FIELDS}, "cpu")
    C = len(port.fleet.names)
    Cl = C // 3
    whole = kernels.dense_filter_plain(
        *(fl[n] for n in FLEET_FIELDS), t["replicas"], t["unknown_request"], t["gvk"],
        t["tol_tables"], t["tol_idx"], t["aff_masks"], t["aff_idx"], t["prev_idx"],
        t["prev_rep"], t["evict_idx"], t["seeds"], t["req_unique"], t["req_idx"], None,
        plugin_bits=port._plugin_bits)
    parts = [kernels.mesh_tile_filter_plain(
        *(fl[n][j * Cl:(j + 1) * Cl] for n in FLEET_FIELDS), t["replicas"],
        t["unknown_request"], t["gvk"], t["tol_tables"], t["tol_idx"],
        t["aff_masks"][:, j * Cl:(j + 1) * Cl].contiguous(), t["aff_idx"], t["prev_idx"],
        t["prev_rep"], t["evict_idx"], t["seeds"], t["req_unique"], t["req_idx"], None, None,
        None, col0=j * Cl, plugin_bits=port._plugin_bits) for j in range(3)]
    for k, name in enumerate(TILE_OUT[:5]):
        np.testing.assert_array_equal(_n(torch.cat([p[k] for p in parts], 1)), _n(whole[k]),
                                      err_msg=name)
    np.testing.assert_array_equal(_n(sum(p[5] for p in parts)), _n(whole[5]))


# the tile filter's factored form: dense_filter's tables over the tile's
# fleet slice, then its main pass with col0, global ids and strided terms
TILE_TABLE_CASES = ("sentinel", "prev listed twice", "neighbouring tiles", "score wraps",
                    "offsets and strides")


def _ref_tile(ref, tb, rows, cols, c0, prev_idx, prev_rep, evict_idx, bits, terms):
    """The reference's tile: decompress_batch(col_offset=c0) and
    filter_estimate_phase on the tile's slices, then the mask, the score
    (int32, wrapping) and the answers as its mesh body applies them after
    the gather. `terms` are numpy (extra, mask, score) over the tile or
    None."""
    f = ref.fleet
    Cl = cols.stop - cols.start
    aff_ok, _sw, prev_member, prev_reps, evict_ok, tie = jcore.decompress_batch(
        tb.aff_masks[:, cols], tb.aff_idx[rows], tb.weight_tables[:, cols],
        tb.weight_idx[rows], prev_idx, prev_rep, evict_idx, tb.seeds[rows], Cl, col_offset=c0)
    tol = tb.tol_tables[tb.tol_idx[rows]]
    feasible, sc, avail = jcore.filter_estimate_phase(
        *(getattr(f, n)[cols] for n in FLEET_FIELDS),
        tb.replicas[rows], None, tb.unknown_request[rows], tb.gvk[rows],
        tol[:, 0], tol[:, 1], tol[:, 2], tol[:, 3], aff_ok, evict_ok, prev_member,
        req_unique=tb.req_unique, req_idx=tb.req_idx[rows], plugin_bits=bits)
    feasible, sc, avail = np.asarray(feasible), np.asarray(sc), np.asarray(avail)
    if terms is not None:
        extra, mask, score = terms
        feasible = feasible & mask
        sc = (sc.astype(np.int64) + score).astype(np.int64)
        sc = ((sc + 2**31) % 2**32 - 2**31).astype(np.int32)  # the int32 add's wrap
        avail = np.where(extra >= 0, np.minimum(avail, extra), avail)
    return (feasible, sc, avail, np.asarray(prev_reps), np.asarray(tie),
            feasible.sum(-1).astype(np.int32))


@pytest.mark.parametrize("case", TILE_TABLE_CASES)
def test_mesh_tile_tables_match_reference(case):
    """The tile filter's factored form (what csrc/dense_filter.cu's tile
    mode builds and reads): dense_filter_tables_plain over the tile's fleet
    slice, then dense_filter_apply_plain with the tile's first column, the
    global prev / evict ids and the three terms as strided column views,
    against mesh_tile_filter_plain and the reference's tile, all six
    outputs exactly: padded rows' Cp sentinel, a prev column listed twice
    (its last entry), ids just across the tile's edges, a score term that
    wraps past INT32_MAX, and a first column and term row strides that are
    no multiples of 4."""
    ref, port, tb = _encoded_mix(seed=2)
    rng = np.random.default_rng(TILE_TABLE_CASES.index(case) + 11)
    B, C = len(tb.replicas), len(port.fleet.names)
    c0, Cl, Cw = (34, 30, 98) if case == "offsets and strides" else (32, 32, C)
    rows, cols = slice(16, 80), slice(c0, c0 + Cl)
    nb = rows.stop - rows.start
    prev_idx = tb.prev_idx[rows].copy()
    evict_idx = tb.evict_idx[rows].copy()
    prev_rep = rng.integers(1, 5, prev_idx.shape).astype(np.int32)
    if case == "sentinel":  # padded rows: every id the global width
        prev_idx[-5:] = C
        evict_idx[-5:] = C
    elif case == "prev listed twice":
        prev_idx[:, 1] = prev_idx[:, 0] = rng.integers(c0, c0 + Cl, nb)
        prev_rep[:, 1] = prev_rep[:, 0] + 1
    elif case == "neighbouring tiles":  # the columns just outside and just inside
        edge = np.array([c0 - 1, c0, c0 + Cl - 1, c0 + Cl], np.int32)
        prev_idx[:] = rng.choice(edge, prev_idx.shape)
        evict_idx[:] = rng.choice(edge, evict_idx.shape)
    else:
        hit = rng.random(prev_idx.shape) < 0.5
        prev_idx[hit] = rng.integers(0, C + 1, hit.sum())
    blocks = (rng.integers(-1, 7, (nb, Cw)).astype(np.int32), rng.random((nb, Cw)) < 0.8,
              rng.integers(-5, 60, (nb, Cw)).astype(np.int32))
    if case == "score wraps":
        blocks[2][:] = np.int32(2**31 - 1) - rng.integers(0, 150, (nb, Cw)).astype(np.int32)
    terms = [a[:, c0:c0 + Cl] for a in blocks]
    bits = port._plugin_bits
    want = _ref_tile(ref, tb, rows, cols, c0, prev_idx, prev_rep, evict_idx, bits, terms)

    fl = port._fleet_dev
    t = batch_from_numpy({n: getattr(tb, n)[rows] for n in (
        "replicas", "unknown_request", "gvk", "tol_idx", "aff_idx", "seeds", "req_idx")}, "cpu")
    views = [torch.from_numpy(a)[:, c0:c0 + Cl] for a in blocks]
    assert views[0].stride(0) == Cw and c0 % 4 == (2 if case == "offsets and strides" else 0)
    fleet = [fl[n][cols] for n in FLEET_FIELDS]
    aff = torch.from_numpy(np.ascontiguousarray(tb.aff_masks[:, cols]))
    tables = kernels.dense_filter_tables_plain(
        *fleet, torch.from_numpy(tb.tol_tables), torch.from_numpy(tb.req_unique),
        plugin_bits=bits)
    got = kernels.dense_filter_apply_plain(
        *tables, t["replicas"], t["unknown_request"], t["gvk"], t["tol_idx"], aff, t["aff_idx"],
        torch.from_numpy(prev_idx), torch.from_numpy(prev_rep), torch.from_numpy(evict_idx),
        t["seeds"], t["req_idx"], views[0], plugin_bits=bits, extra_mask=views[1], col0=c0,
        extra_score=views[2])
    plain = kernels.mesh_tile_filter_plain(
        *fleet, t["replicas"], t["unknown_request"], t["gvk"], torch.from_numpy(tb.tol_tables),
        t["tol_idx"], aff, t["aff_idx"], torch.from_numpy(prev_idx), torch.from_numpy(prev_rep),
        torch.from_numpy(evict_idx), t["seeds"], torch.from_numpy(tb.req_unique), t["req_idx"],
        *views, col0=c0, plugin_bits=bits)
    for name, g, pl, w in zip(TILE_OUT, got, plain, want):
        np.testing.assert_array_equal(_n(g), w, err_msg=name)
        assert torch.equal(g, pl), name
    if case == "prev listed twice":  # the last entry's replicas
        last = [prev_rep[r][prev_idx[r] == prev_idx[r, 0]][-1] for r in range(nb)]
        np.testing.assert_array_equal(_n(got[3])[np.arange(nb), prev_idx[:, 0] - c0], last)
    if case == "score wraps":
        assert (_n(got[1]) < 0).any()
    if case == "neighbouring tiles":
        assert (_n(got[3]) > 0).any() and not _n(got[3])[:, 1:-1].any()


def test_mesh_tile_filter_launch_marshals_the_tables(fake_card, monkeypatch):
    """The launch passes U and Tt beside the tile's col0, the terms' row
    strides, one scratch for the three tables (est_u [U, C] i32, then
    col_ok [Tt, C] and api_t [G, C] bytes, back to back) and the six
    outputs (score, avail, prev and tie the planes of one allocation): one
    C entry of 48 arguments."""
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    _, port, tb = _encoded_mix()
    fl = port._fleet_dev
    t = batch_from_numpy({n: getattr(tb, n) for n in BATCH_FIELDS}, "cpu")
    B, C = len(tb.replicas), len(port.fleet.names)
    c0, Cl = 34, 30
    blocks = [torch.zeros((B, 98), dtype=dt) for dt in (torch.int32, torch.bool, torch.int32)]
    views = [a[:, c0:c0 + Cl] for a in blocks]
    args = [fl[n][c0:c0 + Cl] for n in FLEET_FIELDS] + [
        t["replicas"], t["unknown_request"], t["gvk"], t["tol_tables"], t["tol_idx"],
        t["aff_masks"][:, c0:c0 + Cl].contiguous(), t["aff_idx"], t["prev_idx"], t["prev_rep"],
        t["evict_idx"], t["seeds"], t["req_unique"], t["req_idx"]]
    out = kernels._mesh_tile_filter_launch(*args, *views, col0=c0, plugin_bits=port._plugin_bits)
    (name, cargs), = fake_card
    assert name == "mesh_tile_filter_launch" and len(cargs) == 48
    U, Tt, G = tb.req_unique.shape[0], tb.tol_tables.shape[0], tb.aff_masks.shape[0] and \
        fl["api_ok"].shape[1]
    Kt, Kp, Ke = tb.tol_tables.shape[2], tb.prev_idx.shape[1], tb.evict_idx.shape[1]
    assert cargs[7] == Cl and cargs[10] == G
    assert cargs[24:32] == (B, Kt, Kp, Ke, U, Tt, port._plugin_bits, c0)
    assert cargs[32:38] == (views[0].data_ptr(), 98, views[1].data_ptr(), 98,
                            views[2].data_ptr(), 98)
    est_u, col_ok, api_t = cargs[38:41]
    assert col_ok - est_u == 4 * U * Cl and api_t - col_ok == Tt * Cl
    assert cargs[41:47] == tuple(o.data_ptr() for o in out)
    assert out[2].data_ptr() - out[1].data_ptr() == 4 * B * Cl  # the planes of one tensor
    kernels._mesh_tile_filter_launch(*args, None, None, None, col0=0, plugin_bits=0)
    _, cargs = fake_card[-1]
    assert cargs[31] == 0 and cargs[32:38] == (None, 0, None, 0, None, 0)


# ---------------------------------------------------------- the mesh kernel


@pytest.fixture(scope="module")
def ragged_encoded():
    clusters, bindings = _ragged()
    ref = jcore.ArrayScheduler(clusters)
    port = TorchScheduler(from_reference_objects(clusters), device="cpu")
    jb = ref._pad(ref.batch_encoder.encode(bindings))
    tb = port._pad(port.batch_encoder.encode(from_reference_objects(bindings)))
    for name in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
    return ref, port, jb, tb


@pytest.mark.parametrize("terms", [None, "answers", "all"])
def test_mesh_kernel_matches_reference(ragged_encoded, terms):
    """The port's MeshScheduleKernel on a 4 x 2 virtual CPU mesh against the
    reference's on its 8 virtual devices, all ten outputs over the padded
    [Bp, Cp], and against the reference's single-device kernel on the
    batch's [B, C]; with no terms, with a dense extra_avail, and with the
    answers, a mask and a score."""
    ref, port, jb, tb = ragged_encoded
    B, C = len(jb.replicas), len(ref.fleet.names)
    rng = np.random.default_rng(5)
    kw = {}
    if terms:
        kw["extra_avail"] = rng.integers(-1, 7, (B, C)).astype(np.int32)
    if terms == "all":
        kw["extra_mask"] = rng.random((B, C)) < 0.85
        kw["extra_score"] = rng.integers(0, 40, (B, C)).astype(np.int32)
    jmesh = ref_make_mesh(jax.devices())
    want_mesh = [np.asarray(x) for x in RefMeshKernel(jmesh, ref.fleet)(jb, **kw)]
    want_one = [np.asarray(x) for x in ref.run_kernel(jb, **kw)]
    mk = tmesh.MeshScheduleKernel(virtual_mesh(8, "cpu"), port.fleet)
    got = [_n(x) for x in mk(tb, **kw)]
    assert mk.padded_clusters == C + C % 2 and got[0].shape == want_mesh[0].shape
    for k, name in enumerate(MESH_OUT):
        if name in ("top_idx", "top_val"):
            continue
        np.testing.assert_array_equal(got[k], want_mesh[k], err_msg=f"{name} vs reference mesh")
        w = want_one[k]
        g = got[k][:B, :C] if w.ndim == 2 else got[k][:B]
        np.testing.assert_array_equal(g, w, err_msg=f"{name} vs reference single device")
    for b in range(B):
        n = int(want_one[7][b])
        # the reference mesh's window as a set (its backend orders ties its own way)
        assert ({(int(i), int(v)) for i, v in zip(got[8][b, :n], got[9][b, :n])}
                == {(int(i), int(v)) for i, v in zip(want_mesh[8][b, :n], want_mesh[9][b, :n])})
        # the single-device window exactly, in (value desc, column asc) order
        np.testing.assert_array_equal(got[8][b, :n], want_one[8][b, :n])
        np.testing.assert_array_equal(got[9][b, :n], want_one[9][b, :n])
    assert (got[7][:11] > 0).all()  # every binding of the fixture placed something


def test_mesh_kernel_counts_tiles_and_tails(ragged_encoded, monkeypatch):
    """One call launches the tile filter on every tile, with its column
    offset, and the tail once per row group."""
    _, port, _, tb = ragged_encoded
    calls = []
    for name in ("mesh_tile_filter", "dense_tail"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append((_n, kw.get("col0"))), _fn(*a, **kw))[1])
    mk = tmesh.MeshScheduleKernel(tmesh.make_mesh(["cpu"] * 6), port.fleet)  # 3 x 2
    mk(tb)
    Cl = mk.padded_clusters // 2
    assert sorted(c for n, c in calls if n == "mesh_tile_filter") == [0, 0, 0, Cl, Cl, Cl]
    assert sum(n == "dense_tail" for n, _ in calls) == 3


# ------------------------------------------------------- the mesh round


@pytest.mark.parametrize("with_extra", [False, True])
def test_monolithic_round_matches_reference(with_extra):
    """Every strategy on the ragged fixture: targets, errors and feasible
    lists of the port's monolithic mesh round equal the reference's, and
    its targets and errors the reference's single-device round's (the
    reference's monolithic round lists feasible clusters only for
    non-workload and spread rows, its single-device round for Duplicated
    rows too)."""
    clusters, bindings = _ragged()
    extra = None
    if with_extra:
        extra = np.random.default_rng(5).integers(-1, 7, (len(bindings), len(clusters))).astype(
            np.int32)
    want = _ref_mesh_sched(clusters).schedule(bindings, extra_avail=extra)
    one = jcore.ArrayScheduler(clusters).schedule(bindings, extra_avail=extra)
    got = _port_mesh_sched(clusters).schedule(from_reference_objects(bindings), extra_avail=extra)
    assert _views(got) == _views(want)
    assert [v[:4] for v in _views(got)] == [v[:4] for v in _views(one)]
    assert sum(d.ok for d in got) >= 8


def test_monolithic_round_unschedulable_rows():
    """tests/test_parallel.py's too-big and nowhere rows: the error strings
    of both branches."""
    clusters, _ = _ragged()
    bindings = [
        ref_tests.make_binding("fit", 4, ref_tests.dyn_placement(), cpu=0.5),
        ref_tests.make_binding("too-big", 10_000_000, ref_tests.dyn_placement(), cpu=16.0),
        ref_tests.make_binding("nowhere", 2, duplicated_placement(["no-such-cluster"])),
    ]
    want = _ref_mesh_sched(clusters).schedule(bindings)
    got = _port_mesh_sched(clusters).schedule(from_reference_objects(bindings))
    assert _views(got) == _views(want)
    assert got[0].ok
    assert got[1].error.startswith("Clusters available replicas")
    assert got[2].error == f"0/{len(clusters)} clusters are available"


def test_monolithic_round_plugins_and_mix():
    """The flagship mix (taints and tolerations, evictions, an ordered
    affinity retry, Steady and Fresh rows) with TaintToleration disabled."""
    clusters, bindings = flagship_mix(n_clusters=96, n_bindings=128)
    plugins = ["*", "-TaintToleration"]
    want = _ref_mesh_sched(clusters, plugins=plugins).schedule(bindings)
    got = _port_mesh_sched(clusters, plugins=plugins).schedule(from_reference_objects(bindings))
    assert _views(got) == _views(want)
    assert any(d.affinity_name == "backup" for d in got)


@pytest.mark.parametrize("case", ["skewed", "fallback_dense"])
def test_monolithic_round_spread(case):
    """Region-spread rows over the mesh round: the batched path (group
    scoring, the host search, the packed selection and the spread tail on
    the gathered rows) and the per-row fallback (the restricted re-solve
    through the mesh kernel)."""
    clusters, bindings, _ = _case(case)
    calls = []
    fns = {n: getattr(kernels, n) for n in ("group_score", "spread_tail", "mesh_tile_filter")}
    want = _ref_mesh_sched(clusters).schedule(bindings)
    try:
        for name, fn in fns.items():
            setattr(kernels, name, lambda *a, _fn=fn, _n=name, **kw: (
                calls.append(_n), _fn(*a, **kw))[1])
        got = _port_mesh_sched(clusters).schedule(from_reference_objects(bindings))
    finally:
        for name, fn in fns.items():
            setattr(kernels, name, fn)
    assert _views(got) == _views(want)
    assert sum(d.ok for d in got) > len(got) // 2
    if case == "skewed":
        assert {"group_score", "spread_tail"} <= set(calls)
    else:
        # the round's 8 tiles, then 8 more for the restricted re-solve
        assert calls.count("mesh_tile_filter") >= 16


def test_monolithic_round_extra_mask_without_cluster_affinity():
    """Cluster-only spread rows whose re-solve runs with ClusterAffinity
    disabled: the selection rides the mesh kernel's extra_mask."""
    clusters = synthetic_fleet(40, seed=7, ready_fraction=0.9)
    rng = np.random.default_rng(7)
    bindings = []
    for i in range(16):
        p = _dyn(aggregated=i % 3 == 1) if i % 3 else jpol.Placement(
            cluster_affinity=jpol.ClusterAffinity(cluster_names=[]))
        if i % 2 == 0:
            p.spread_constraints = [jpol.SpreadConstraint(
                spread_by_field=jpol.SPREAD_BY_FIELD_CLUSTER, min_groups=int(rng.integers(1, 4)),
                max_groups=int(rng.integers(4, 9)) if i % 4 == 0 else 0)]
        bindings.append(_binding(i, int(rng.integers(1, 30)), p, float(rng.choice([0.1, 0.5]))))
    plugins = ["*", "-ClusterAffinity"]
    want = _ref_mesh_sched(clusters, plugins=plugins).schedule(bindings)
    got = _port_mesh_sched(clusters, plugins=plugins).schedule(from_reference_objects(bindings))
    assert _views(got) == _views(want)
    assert sum(d.ok for d in got) > 8


def test_monolithic_round_chunks_by_the_bindings_axis():
    """With the [B, C] budget shrunk, the row cap scales by the bindings
    axis (4 here), as the reference's does, and the chunked round decides
    as the reference's."""
    clusters, bindings = flagship_mix(seed=2, n_clusters=64, n_bindings=160)
    ref = _ref_mesh_sched(clusters)
    port = _port_mesh_sched(clusters)
    single = TorchScheduler(from_reference_objects(clusters), device="cpu")
    for s in (ref, port, single):
        s.max_bc_elems = 8 * 64
    C = len(port.fleet.names)
    assert port._max_rows_per_round(C) == ref._max_rows_per_round(C) == 32
    assert single._max_rows_per_round(C) == 8
    want = ref.schedule(bindings)
    got = port.schedule(from_reference_objects(bindings))
    assert port.last_pipeline_stats["chunks"] == 5
    assert _views(got) == _views(want)


def test_monolithic_round_dirty_columns():
    """A status-only change of a few clusters under the mesh: the port keeps
    its batch encoder (the dirty-column path), re-places the mesh kernel's
    shards whole, and decides as the reference after the same update."""
    import copy

    clusters, bindings = flagship_mix(seed=3, n_clusters=64, n_bindings=96)
    ref = _ref_mesh_sched(clusters)
    port = _port_mesh_sched(clusters)
    ref.schedule(bindings)
    port_bindings = from_reference_objects(bindings)
    port.schedule(port_bindings)
    encoder = port.batch_encoder
    shards = port._mesh_kernel._fleet_dev[0, 1]
    changed = copy.deepcopy(clusters)
    dirty = set()
    for c in changed[3::9]:
        c.status.resource_summary.allocated = dict(c.status.resource_summary.allocatable)
        dirty.add(c.name)
    ref.set_clusters(changed, dirty_names=dirty)
    port.set_clusters(from_reference_objects(changed), dirty_names=dirty)
    assert port.batch_encoder is encoder  # the dirty-column path
    assert port._mesh_kernel._fleet_dev[0, 1] is not shards  # the shards re-placed
    cap = port._fleet_dev["capacity"]
    Cl = port._mesh_kernel.padded_clusters // 2
    np.testing.assert_array_equal(_n(port._mesh_kernel._fleet_dev[0, 1]["capacity"]),
                                  _n(cap[Cl:2 * Cl]))
    want = ref.schedule(bindings)
    got = port.schedule(port_bindings)
    assert _views(got) == _views(want)


def test_mesh_round_modes_and_device():
    """Both modes run: the partitioned mode (the default) and the
    monolithic one decide as the reference's partitioned mesh round, and
    the tiered launch runs over the mesh in either; a device other than
    the mesh's first raises; the round's device is the mesh's first."""
    clusters, bindings = _ragged()
    port = TorchScheduler(from_reference_objects(clusters), mesh=virtual_mesh(8, "cpu"))
    assert port.device == torch.device("cpu") and port.mesh_partitioned
    assert len(port.fleet.names) % 2 == 0
    pb = from_reference_objects(bindings)
    want = _views(jcore.ArrayScheduler(clusters, mesh=ref_make_mesh(jax.devices()))
                  .schedule(bindings))
    assert _views(port.schedule(pb)) == want
    tiered = port.materialize_chunk(preemption.launch_tiered(port, pb))
    with pytest.raises(ValueError, match="first device"):
        TorchScheduler(from_reference_objects(clusters), mesh=virtual_mesh(8, "cpu"),
                       device="meta")
    port.mesh_partitioned = False
    got = port.schedule(pb)
    assert all(d.ok for d in got)
    assert [v[:4] for v in _views(got)] == [v[:4] for v in want]
    assert _views(port.materialize_chunk(preemption.launch_tiered(port, pb))) == _views(tiered)
