"""Resource vocabularies past the kernels' old caps, and the
`ArrayScheduler` constructor keywords `encoder=` / `bucket_cols=`, held
against the JAX package.

The port's Simulator with 9- and 17-resource fleet encoders against the
JAX Simulator (outcomes and last_stats); a tiered round with a
17-resource request and the estimator's fleet sweep over 17-resource node
arrays against the JAX programs; `ArrayScheduler(encoder=...,
bucket_cols=False)` decisions against the reference's; the dense tail's
no-window mode against the windowed outputs it keeps; and, on a faked
card, the launches of sim_load, tier_consume and fleet_estimate taking
R = 17 to their C entries. Every comparison is exact (integers and
strings; tolerance 0)."""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import karmada_tpu.sched.preemption as jpre  # noqa: E402
from karmada_tpu.estimator import client as jclient  # noqa: E402
from karmada_tpu.models.fleet import DEFAULT_RESOURCES  # noqa: E402
from karmada_tpu.models.fleet import FleetEncoder as JFleetEncoder  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.simulation import Simulator as JSimulator  # noqa: E402
from karmada_tpu.testing.fixtures import synthetic_fleet  # noqa: E402

import karmada_tpu_torch.sched.preemption as tpre  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402
from karmada_tpu_torch.models.fleet import FleetEncoder  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler  # noqa: E402
from karmada_tpu_torch.simulation import Simulator  # noqa: E402

from test_simulation import mixed_bindings, scenario_set  # noqa: E402
from test_torch_candidates import fake_card  # noqa: E402,F401 (fixture)
from test_torch_estimator import _node_fleet  # noqa: E402
from test_torch_simulation import assert_outcomes_equal, stats_but_mesh  # noqa: E402

EXTRA = tuple(f"example.com/device-{i}" for i in range(13))
TAIL_OUT = ("result", "unschedulable", "avail_sum", "nnz", "top_idx", "top_val")


def _resources(n):
    """The default vocabulary plus n - 4 extended resources."""
    return DEFAULT_RESOURCES + EXTRA[:n - len(DEFAULT_RESOURCES)]


def _wide_fleet(n, n_clusters=12, seed=7):
    """synthetic_fleet with each extended resource of the n-resource
    vocabulary on most clusters (some hold none: those are infeasible for
    a row that asks for it), part of it allocated."""
    clusters = synthetic_fleet(n_clusters, seed=seed)
    rng = np.random.default_rng(seed)
    for i, c in enumerate(clusters):
        rs = c.status.resource_summary
        for k, name in enumerate(_resources(n)[len(DEFAULT_RESOURCES):]):
            if (i + k) % 5 == 4:
                continue
            alloc = int(rng.integers(8, 400))
            rs.allocatable[name] = float(alloc)
            rs.allocated[name] = float(rng.integers(0, alloc // 2))
    return clusters


def _wide_bindings(names, n, n_bindings=16):
    """mixed_bindings with the extended resources requested on most rows,
    a few of them more than some clusters hold."""
    bindings = mixed_bindings(names, n=n_bindings)
    for i, b in enumerate(bindings):
        rr = b.spec.replica_requirements
        if rr is None:
            continue
        for k, name in enumerate(_resources(n)[len(DEFAULT_RESOURCES):]):
            if (i + k) % 3:
                rr.resource_request[name] = float(1 + (i * 7 + k * 5) % 30)
    return bindings


def _view(d):
    spec = getattr(d, "speculative", None)
    return (d.key, d.error, d.affinity_name,
            None if d.targets is None else sorted((t.name, t.replicas) for t in d.targets),
            None if spec is None else _view(spec))


# --------------------------------------------------------------------------
# the simulation plane past eight resources
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [9, 17])
def test_simulator_with_wide_encoder_matches_jax(n):
    """The port's Simulator with an n-resource FleetEncoder against the JAX
    Simulator with its own: every outcome (placements, errors, per-cluster
    assigned replicas and usage of all n resources, overcommit) and
    last_stats."""
    clusters = _wide_fleet(n)
    names = [c.name for c in clusters]
    bindings = _wide_bindings(names, n)
    scenarios = scenario_set(names)
    jsim = JSimulator(clusters, encoder=JFleetEncoder(resources=_resources(n)))
    jbase, jouts = jsim.simulate(bindings, scenarios)
    tsim = Simulator(conv(clusters), encoder=FleetEncoder(resources=_resources(n)),
                     device="cpu")
    tbase, touts = tsim.simulate(conv(bindings), conv(scenarios))
    assert_outcomes_equal([tbase] + touts, [jbase] + jouts)
    assert stats_but_mesh(tsim.last_stats) == stats_but_mesh(jsim.last_stats)
    assert len(tsim.encoder.resources) == n
    # the extended resources take part: placed rows load the first and the
    # last of them
    usage = np.stack([o.usage for o in [tbase] + touts])
    assert usage.shape[-1] == n and (usage[..., 4] > 0).any() and (usage[..., n - 1] > 0).any()


# --------------------------------------------------------------------------
# a tiered round and the estimator sweep with 17 resources
# --------------------------------------------------------------------------


def test_tiered_round_with_17_resources_matches_jax():
    """launch_tiered over a 17-resource encoder (tier_consume's request is
    [B, 17]) decides as the JAX package, row for row: priorities, a tight
    extended resource, and the residual passed from tier to tier."""
    n = 17
    clusters = _wide_fleet(n, n_clusters=10, seed=3)
    for c in clusters:  # a scarce extended resource, so tiers contend on it
        rs = c.status.resource_summary
        if EXTRA[5] in rs.allocatable:
            rs.allocatable[EXTRA[5]] = 12.0
            rs.allocated[EXTRA[5]] = 0.0
    names = [c.name for c in clusters]
    bindings = _wide_bindings(names, n, n_bindings=12)
    for i, b in enumerate(bindings):
        b.spec.schedule_priority = (0, 10, 100)[i % 3]
        if b.spec.replica_requirements is not None:
            b.spec.replica_requirements.resource_request[EXTRA[5]] = 2.0
    jarr = jcore.ArrayScheduler(clusters, encoder=JFleetEncoder(resources=_resources(n)))
    tarr = ArrayScheduler(conv(clusters), device="cpu",
                          encoder=FleetEncoder(resources=_resources(n)))
    got = tarr.materialize_chunk(tpre.launch_tiered(tarr, conv(bindings)))
    want = jarr.materialize_chunk(jpre.launch_tiered(jarr, bindings))
    assert [_view(d) for d in got] == [_view(d) for d in want]
    assert sum(d.ok for d in got) >= 2 and not all(d.ok for d in got)


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_sweep_with_17_resources_matches_jax(seed):
    """The estimator's fleet sweep (kernels.fleet_estimate; its plain
    version on the CPU) over 17-resource node arrays and requests against
    the reference's fleet kernel: the minimum over every resource is taken
    per node before the sum over a cluster's nodes."""
    rng = np.random.default_rng(seed)
    C, B = 19, 13
    alloc, requested, pod_count, allowed, cid, _, ok, request = _node_fleet(rng, C, B, R=17)
    request[2, 16] = 7000  # one resource past 16 decides a row
    T = torch.from_numpy
    got = kernels.fleet_estimate(T(alloc), T(requested), T(pod_count), T(allowed), T(cid), C,
                                 T(ok), T(request))
    want = jclient._fleet_rows_kernel(alloc, requested, pod_count, allowed, cid, ok, request,
                                      num_clusters=C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() > 0).any()


# --------------------------------------------------------------------------
# ArrayScheduler(encoder=..., bucket_cols=False)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,bucket_cols", [(4, False), (9, False), (9, True)])
def test_scheduler_encoder_and_bucket_cols_match_reference(n, bucket_cols):
    """The constructor keywords the reference takes: the fleet encoder
    (its resource vocabulary) and the exact fleet width. Decisions equal
    the reference's, and the fleet tensors are C wide, unpadded, without
    bucket_cols."""
    clusters = _wide_fleet(n, n_clusters=13, seed=5)
    names = [c.name for c in clusters]
    bindings = _wide_bindings(names, n, n_bindings=20)
    jarr = jcore.ArrayScheduler(clusters, JFleetEncoder(resources=_resources(n)),
                                bucket_cols=bucket_cols)
    tarr = ArrayScheduler(conv(clusters), device="cpu",
                          encoder=FleetEncoder(resources=_resources(n)),
                          bucket_cols=bucket_cols)
    got = tarr.schedule(conv(bindings))
    want = jarr.schedule(bindings)
    assert [_view(d) for d in got] == [_view(d) for d in want]
    assert tarr.bucket_cols is bucket_cols and tarr.encoder.resources == list(_resources(n))
    assert len(tarr.fleet.names) == len(jarr.fleet.names)
    assert (len(tarr.fleet.names) == len(clusters)) is (not bucket_cols)
    assert tarr._fleet_dev["capacity"].shape == (len(tarr.fleet.names), n)


def test_scheduler_keywords_keep_positional_callers():
    """`encoder` and `bucket_cols` are keyword-only, after the port's own
    parameters: the port's positional order (clusters, plugins,
    candidate_k, device) is unchanged, and the defaults are the
    reference's."""
    clusters = conv(synthetic_fleet(5, seed=1))
    arr = ArrayScheduler(clusters, None, 0, "cpu")
    assert arr.candidate_k == 0 and arr.bucket_cols is True
    assert isinstance(arr.encoder, FleetEncoder) and len(arr.encoder.resources) == 4
    enc = FleetEncoder(resources=_resources(9))
    assert ArrayScheduler(clusters, device="cpu", encoder=enc).encoder is enc
    with pytest.raises(TypeError):
        ArrayScheduler(clusters, None, 0, "cpu", None, None, enc)


# --------------------------------------------------------------------------
# the dense tail without its output window
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_tail_plain_no_window_keeps_windowed_outputs(seed):
    """topk = 0: result, unschedulable, avail_sum and nnz equal the
    windowed call's, and the window is empty ([n, 0])."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    args = chip_smoke.random_dense_tail_inputs(rng, "cpu", 24, 300, 20)
    windowed = kernels.dense_tail_plain(*args, topk=16, has_agg=True)
    bare = kernels.dense_tail_plain(*args, topk=0, has_agg=True)
    for name, a, b in zip(TAIL_OUT[:4], bare[:4], windowed[:4]):
        assert torch.equal(a, b), name
    assert bare[4].shape == (20, 0) and bare[5].shape == (20, 0)
    assert bare[4].dtype == torch.int32


def test_dense_tail_launch_no_window_and_routes(fake_card):
    """On a faked card: topk = 0 reaches the C entry as 0 with an empty
    window, the route names map to the entry's codes at any width, and an
    unknown route raises before any launch."""
    import chip_smoke

    args = chip_smoke.random_dense_tail_inputs(np.random.default_rng(3), "cpu", 8, 40, 6)
    out = kernels._dense_tail_launch(*args, topk=0, has_agg=False)
    (name, cargs), = fake_card
    assert name == "dense_tail_launch" and cargs[12:15] == (0, False, 0)
    assert out[4].shape == (6, 0)
    wide = chip_smoke.random_dense_tail_inputs(
        np.random.default_rng(4), "cpu", 2, kernels.MAX_TAIL_SMEM_COLS + 1, 2)
    for a in (args, wide):
        for route, code in (("auto", 0), ("reread", 1)):
            kernels._dense_tail_launch(*a, topk=8, has_agg=True, route=route)
            assert fake_card[-1][1][12:15] == (8, True, code)
    with pytest.raises(KeyError):
        kernels._dense_tail_launch(*args, topk=8, has_agg=True, route="shared")
    assert len(fake_card) == 5


@pytest.mark.parametrize("K", [128, 256])
def test_tail_launch_route_only_past_128(K, fake_card):
    """A forced route reaches dense_tail.cu's window mode (K > 128) as its
    code; candidate_tail (K <= 128) has one route and refuses any other
    before a launch."""
    rng = np.random.default_rng(K)
    rows, C = 4, 512
    T = torch.from_numpy
    args = (T(rng.random((rows, K)) < 0.8), T(rng.integers(0, 9, (rows, K)).astype(np.int32)),
            T(np.zeros((rows, K), np.int32)), T(rng.integers(0, 3, (rows, K)).astype(np.int32)),
            T(np.sort([rng.choice(C, K, replace=False) for _ in range(rows)], 1).astype(np.int32)),
            T(np.ones((2, C), np.int64)), T(np.zeros(rows, np.int32)),
            T(np.full(rows, 3, np.int32)), T(np.full(rows, 9, np.int32)),
            T(np.zeros(rows, bool)))
    if K <= kernels.MAX_TAIL_K:
        with pytest.raises(ValueError, match="route"):
            kernels._tail_launch(*args, topk=128, has_agg=True, route="reread")
        assert fake_card == []
    else:
        kernels._tail_launch(*args, topk=128, has_agg=True, route="reread")
        (name, cargs), = fake_card
        assert name == "window_tail_launch" and cargs[15] == kernels.TAIL_ROUTES["reread"]


@pytest.mark.parametrize("R,block,launches", [(0, 8, 1), (4, 8, 1), (8, 8, 1), (9, 8, 2),
                                               (17, 8, 3), (16, 16, 1), (17, 16, 2)])
def test_resource_blocks_count_each_launch(R, block, launches):
    """sim_load (blocks of 8) and tier_consume (blocks of 16) add one to
    their launch counts per resource block they launch."""
    assert kernels._resource_blocks(R, block) == launches


# --------------------------------------------------------------------------
# R = 17 through the faked card
# --------------------------------------------------------------------------


def test_sim_load_launch_takes_17_resources(fake_card):
    """sim_load passes R = 17 to its C entry (which runs blocks of eight)."""
    S, B, C, R = 3, 40, 24, 17
    result = torch.zeros((S, B, C), dtype=torch.int32)
    active = torch.ones((S, B), dtype=torch.bool)
    assigned, usage = kernels._sim_load_launch(result, active,
                                               torch.zeros((B, R), dtype=torch.int64))
    (name, cargs), = fake_card
    assert name == "sim_load_launch" and cargs[3:7] == (S, B, C, R)
    assert cargs[7:9] == (assigned.data_ptr(), usage.data_ptr())
    assert usage.shape == (S, C, R) and assigned.shape == (S, C)


def test_tier_consume_launch_takes_17_resources(fake_card):
    """tier_consume runs R = 17 as resource blocks of 16 and 1 over
    contiguous slices of cap and request, and returns the blocks side by
    side; the slices are the columns of the inputs."""
    rng = np.random.default_rng(6)
    C, R, n, B = 50, 17, 7, 9
    T = torch.from_numpy
    cap = T(rng.integers(0, 100, (C, R)).astype(np.int64))
    request = T(rng.integers(0, 9, (B, R)).astype(np.int64))
    rows = T(np.arange(n, dtype=np.int32))
    out = kernels._tier_consume_launch(cap, torch.zeros((n, C), dtype=torch.int32),
                                       torch.zeros(n, dtype=torch.bool), request, rows)
    assert [name for name, _ in fake_card] == ["tier_consume_round"] * 2
    assert [(cargs[0]._obj.C, cargs[0]._obj.R) for _, cargs in fake_card] == [(C, 16), (C, 1)]
    assert out.shape == (C, R) and out.dtype == torch.int64


def test_fleet_estimate_launch_takes_17_resources(fake_card):
    """fleet_estimate passes R = 17 to its one C call (the sweep reads a
    wide request in place, so the minimum over resources stays per node);
    rows given as a plain [B, R] request are the table itself (U = B, no
    index, no table scratch)."""
    rng = np.random.default_rng(7)
    alloc, requested, pod_count, allowed, cid, _, ok, request = _node_fleet(rng, 11, 5, R=17)
    T = torch.from_numpy
    out = kernels._fleet_estimate_launch(T(alloc), T(requested), T(pod_count), T(allowed),
                                         T(cid), 11, T(ok), T(request))
    (name, cargs), = fake_card
    assert name == "fleet_estimate_launch" and cargs[7:9] == (11, 17) and cargs[10] == 5
    assert cargs[11] is None and cargs[12] == 5 and cargs[13] is None
    assert out.shape == (5, 11)
    assert isinstance(cargs[15], ctypes.c_void_p)  # the stream