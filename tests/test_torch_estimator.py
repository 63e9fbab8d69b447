"""The PyTorch port's scheduler-estimator path held against the JAX package.

The node-level estimate (ops/estimate.py's plain versions and the fleet
sweep's wrapper on the CPU) against the JAX programs on seeded node fleets
with overcommitted nodes, zero requests, exhausted pod slots, tainted nodes
and clusters without nodes; the port's AccurateEstimator, MemberEstimators
(the fleet route and the per-cluster route under a fault plan and an open
breaker), EstimatorRegistry (breakers opening and closing, the staleness
overlay, a chunked sweep round) and the staleness penalty against the
reference's; then whole rounds of `ArrayScheduler.schedule(bindings,
extra_avail=...)` and `launch_tiered(..., extra_avail=...)` against the JAX
package. Every comparison is exact (integer outputs, tolerance 0)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
import karmada_tpu.faults as jfaults  # noqa: E402
import karmada_tpu.sched.preemption as jpre  # noqa: E402
from karmada_tpu.api import policy as jpol  # noqa: E402
from karmada_tpu.api.cluster import Taint  # noqa: E402
from karmada_tpu.api.meta import CPU, MEMORY  # noqa: E402
from karmada_tpu.api.work import NodeClaim, ReplicaRequirements  # noqa: E402
from karmada_tpu.estimator import client as jclient  # noqa: E402
from karmada_tpu.estimator.accurate import AccurateEstimator as JAccurate  # noqa: E402
from karmada_tpu.native import first_fit_place as jfirst_fit  # noqa: E402
from karmada_tpu.ops import estimate as jest  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.testing.fixtures import synthetic_fleet  # noqa: E402
from scripts.bench_estimator import build as jbuild_estimator  # noqa: E402
from tests.test_estimator import nodes_small  # noqa: E402
from tests.test_parallel import dyn_placement, make_binding  # noqa: E402
from tests.test_preemption import mark_placed  # noqa: E402

import karmada_tpu_torch.faults as tfaults  # noqa: E402
import karmada_tpu_torch.sched.preemption as tpre  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402
from karmada_tpu_torch.estimator import client as tclient  # noqa: E402
from karmada_tpu_torch.estimator.accurate import AccurateEstimator as TAccurate  # noqa: E402
from karmada_tpu_torch.estimator.accurate import first_fit_place as tfirst_fit  # noqa: E402
from karmada_tpu_torch.ops import estimate as test  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402
from karmada_tpu_torch.testing.fixtures import build_estimator, shard_nodes  # noqa: E402

from test_torch_scheduler import _binding, _decision_view, _dyn, flagship_mix  # noqa: E402

GiB = 1024.0**3


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _view(d):
    spec = d.speculative
    return (d.key, d.error, d.affinity_name,
            None if d.targets is None else sorted((t.name, t.replicas) for t in d.targets),
            None if spec is None else _view(spec))


# --------------------------------------------------------------------------
# the node-level estimate
# --------------------------------------------------------------------------


def _node_fleet(rng, C, B, R=4):
    """Seeded node arrays in cluster order: 0-5 nodes a cluster (some
    clusters without any), overcommitted nodes (requested > alloc),
    exhausted pod slots, tainted nodes (claimless_ok False), and requests
    with zero rows and zero columns."""
    counts = rng.integers(0, 6, C)
    counts[::5] = 0
    N = int(counts.sum())
    cluster_id = np.repeat(np.arange(C), counts).astype(np.int32)
    alloc = rng.integers(0, 64_000, (N, R)).astype(np.int64)
    requested = (alloc * rng.uniform(0, 1.3, (N, R))).astype(np.int64)  # > alloc: overcommitted
    allowed = rng.integers(0, 120, N).astype(np.int64)
    pod_count = (allowed + rng.integers(-50, 5, N)).clip(0).astype(np.int64)  # some exhausted
    ok = rng.random(N) < 0.8
    request = rng.choice([0, 1, 250, 1000, 7000], (B, R)).astype(np.int64)
    request[::4] = 0  # requests naming no resource
    request[1::3, 2:] = 0
    offsets = np.searchsorted(cluster_id, np.arange(C + 1)).astype(np.int32)
    return alloc, requested, pod_count, allowed, cluster_id, offsets, ok, request


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_plain_versions_match_jax(seed):
    """node_available_replicas, cluster_estimate and fleet_estimate, and
    the fleet sweep's wrapper (its plain version on the CPU), against the
    JAX programs, including the reference's own fleet kernel."""
    rng = np.random.default_rng(seed)
    C, B = 23, 17
    alloc, requested, pod_count, allowed, cid, offsets, ok, request = _node_fleet(rng, C, B)
    N = len(cid)
    node_ok = rng.random((B, N)) < 0.85
    got = test.node_available_replicas(_t(alloc), _t(requested), _t(pod_count), _t(allowed),
                                       _t(request), _t(node_ok))
    want = jest.node_available_replicas(alloc, requested, pod_count, allowed, request, node_ok)
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    assert (_n(got) == 0).any() and (_n(got) > 0).any()
    assert ((alloc - requested) < 0).any()  # overcommitted nodes are in the fleet
    m = cid == cid[0]
    got = test.cluster_estimate(_t(alloc[m]), _t(requested[m]), _t(pod_count[m]),
                                _t(allowed[m]), _t(request), _t(node_ok[:, m]))
    want = jest.cluster_estimate(alloc[m], requested[m], pod_count[m], allowed[m], request,
                                 node_ok[:, m])
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    got = test.fleet_estimate(_t(alloc), _t(requested), _t(pod_count), _t(allowed), _t(cid),
                              _t(request), _t(node_ok), C)
    want = jest.fleet_estimate(alloc, requested, pod_count, allowed, cid, request, node_ok, C)
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    assert (_n(got)[:, offsets[:-1] == offsets[1:]] == 0).all()  # node-less clusters
    # the sweep's wrapper on CPU tensors (its plain version) and the
    # reference's jitted fleet kernel over the claim-free mask
    got = kernels.fleet_estimate(_t(alloc), _t(requested), _t(pod_count), _t(allowed), _t(cid),
                                 C, _t(ok), _t(request))
    want = jclient._fleet_rows_kernel(alloc, requested, pod_count, allowed, cid, ok, request,
                                      num_clusters=C)
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    # nodes out of cluster order answer the same
    p = rng.permutation(N)
    got = kernels.fleet_estimate(_t(alloc[p]), _t(requested[p]), _t(pod_count[p]),
                                 _t(allowed[p]), _t(cid[p]), C, _t(ok[p]), _t(request))
    np.testing.assert_array_equal(_n(got), np.asarray(want))


def test_staleness_penalty_tensor_matches_numpy():
    """apply_staleness_penalty on an int32 tensor (the kernel's plain
    version on the CPU) equals its numpy branch and the reference's, the
    sentinel untouched, ages past the cap stable."""
    rng = np.random.default_rng(5)
    v = rng.integers(-1, 5000, (40, 30)).astype(np.int32)
    v[::3] = -1
    for age in range(11):
        want = jfaults.apply_staleness_penalty(v, age)
        np.testing.assert_array_equal(tfaults.apply_staleness_penalty(v, age), want)
        np.testing.assert_array_equal(_n(tfaults.apply_staleness_penalty(_t(v), age)), want)
    assert (_n(tfaults.apply_staleness_penalty(_t(v), 3))[v < 0] == -1).all()
    with pytest.raises(ValueError, match="shift"):
        kernels.staleness_penalty(_t(v), 0)
    with pytest.raises(ValueError, match="shift"):  # past the age cap
        kernels.staleness_penalty(_t(v), tfaults.MAX_STALENESS_AGE + 1)


# --------------------------------------------------------------------------
# the member estimators
# --------------------------------------------------------------------------


def _requirements():
    return [
        ReplicaRequirements(resource_request={CPU: 1.0}),
        ReplicaRequirements(resource_request={CPU: 0.1}),
        ReplicaRequirements(),
        None,
        ReplicaRequirements(resource_request={CPU: 0.5, MEMORY: 3 * GiB}),
        ReplicaRequirements(
            node_claim=NodeClaim(tolerations=[{"key": "gpu", "operator": "Exists"}],
                                 node_selector={"zone": "z1"}),
            resource_request={CPU: 2.0}),
        ReplicaRequirements(node_claim=NodeClaim(node_selector={"zone": "nowhere"}),
                            resource_request={CPU: 1.0}),
    ]


def test_accurate_estimator_matches_reference():
    """Estimates (claims, taints, pod caps, empty requests), placement and
    its pending / unschedulable counts, unplace and the version bumps, on
    tests/test_estimator.py's node set."""
    j, t = JAccurate(nodes_small()), TAccurate(conv(nodes_small()))
    reqs = _requirements()
    assert t.max_available_replicas_batch(conv(reqs)) == j.max_available_replicas_batch(reqs)
    for key, n, cpu in (("default/web", 10, 1.0), ("default/big", 7, 1.0),
                        ("default/small", 30, 0.1)):
        assert t.place(key, n, {CPU: cpu}, now=100.0) == j.place(key, n, {CPU: cpu}, now=100.0)
        assert (t.max_available_replicas_batch(conv(reqs))
                == j.max_available_replicas_batch(reqs))
    for key in ("default/web", "default/big", "default/small", "default/none"):
        for now in (150.0, 500.0):
            assert (t.get_unschedulable_replicas(key, 300, now=now)
                    == j.get_unschedulable_replicas(key, 300, now=now))
    assert t.get_unschedulable_replicas("default/big", 300, now=500.0) > 0
    v = t.version
    t.unplace("default/big")
    j.unplace("default/big")
    assert t.version == v + 1
    assert t.max_available_replicas_batch(conv(reqs)) == j.max_available_replicas_batch(reqs)
    np.testing.assert_array_equal(t.arrays.requested, j.arrays.requested)
    np.testing.assert_array_equal(t.arrays.pod_count, j.arrays.pod_count)


def test_first_fit_and_fixtures_match_reference():
    """The port's first-fit placement against the reference's (its C++
    library where it builds, else the same loop), the reference estimator
    fixture against bench_estimator.build, and shard_nodes against the
    bench's _shard_nodes."""
    rng = np.random.default_rng(7)
    N, R = 60, 4
    alloc = rng.integers(0, 20_000, (N, R)).astype(np.int64)
    for trial in range(4):
        requested = (alloc * rng.uniform(0, 1.1, (N, R))).astype(np.int64)
        pods = rng.integers(0, 12, N).astype(np.int64)
        allowed = rng.integers(0, 12, N).astype(np.int64)
        ok = rng.random(N) < 0.8
        req = rng.choice([0, 100, 900], R).astype(np.int64)
        reps = int(rng.integers(1, 300))
        a = (requested.copy(), pods.copy())
        b = (requested.copy(), pods.copy())
        got = tfirst_fit(alloc, a[0], a[1], allowed, ok, req, reps)
        want = jfirst_fit(alloc, b[0], b[1], allowed, ok, req, reps)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    t, j = build_estimator(300, 6000, seed=3), jbuild_estimator(300, 6000, seed=3)
    np.testing.assert_array_equal(t.arrays.requested, j.arrays.requested)
    np.testing.assert_array_equal(t.arrays.pod_count, j.arrays.pod_count)
    reqs = _requirements()[:5]
    assert t.max_available_replicas_batch(conv(reqs)) == j.max_available_replicas_batch(reqs)
    for name in ("member-0", "member-17", "x"):
        assert conv(bench._shard_nodes(4, name)) == shard_nodes(4, name)


class _Member:
    def __init__(self, est):
        self.node_estimator = est


def _members(n=24, seed=0):
    """(reference members, port members, cluster names): shard_nodes pools
    on most clusters, one cluster without a member, one whose member has no
    estimator, one with no nodes, one whose nodes are all tainted, and
    pods placed on a few."""
    names = [f"member-{i}" for i in range(n)]
    jm, tm = {}, {}
    for i, name in enumerate(names):
        if i == 3:
            continue  # no member
        if i == 5:
            jm[name], tm[name] = _Member(None), _Member(None)
            continue
        nodes = [] if i == 7 else bench._shard_nodes(seed, name)
        if i == 9:
            for nd in nodes:
                nd.taints = [Taint(key="gpu", effect="NoSchedule")]
        je, te = JAccurate(nodes), TAccurate(conv(nodes))
        if i % 4 == 1:
            for est in (je, te):
                est.place("ns/w", 40, {CPU: 1.0}, now=1.0)
        jm[name], tm[name] = _Member(je), _Member(te)
    return jm, tm, names


@pytest.mark.parametrize("route", ["fleet", "fault_plan", "open_breaker", "claims"])
def test_member_estimators_rows_match_reference(route, monkeypatch):
    """max_available_replicas_rows on both routes: the fleet kernel (its
    plain version here) when every row is claim-free and no guard is
    engaged, else the per-cluster host path — under an installed grpc
    FaultPlan, an open breaker, or node claims — answer for answer as the
    reference's MemberEstimators."""
    jm, tm, names = _members()
    jb = tb = None
    if route == "open_breaker":
        jb, tb = jfaults.BreakerRegistry(failure_threshold=1), tfaults.BreakerRegistry(
            failure_threshold=1)
        for br in (jb.for_member(names[2]), tb.for_member(names[2])):
            br.record_failure()
    j = jclient.MemberEstimators(jm, breakers=jb)
    t = tclient.MemberEstimators(tm, breakers=tb, device="cpu")
    reqs = [r for r in _requirements() if r is None or r.node_claim is None]
    if route == "claims":
        reqs = _requirements()
    calls = []
    fn = kernels.fleet_estimate
    monkeypatch.setattr(kernels, "fleet_estimate",
                        lambda *a, **kw: (calls.append(kw), fn(*a, **kw))[1])
    plan = jfaults.FaultPlan(seed=1, rules=[jfaults.FaultRule(
        boundary=jfaults.BOUNDARY_GRPC, target=names[4], kind="partition")])
    try:
        if route == "fault_plan":
            jfaults.install(plan)
            tfaults.install(tfaults.FaultPlan(seed=1, rules=[tfaults.FaultRule(
                boundary=tfaults.BOUNDARY_GRPC, target=names[4], kind="partition")]))
        for sweep in range(2):
            want = np.asarray(j.max_available_replicas_rows(names, reqs))
            got = t.max_available_replicas_rows(names, conv(reqs))
            np.testing.assert_array_equal(got, want, err_msg=f"sweep {sweep}")
            assert got.shape == (len(reqs), len(names))
    finally:
        jfaults.reset()
        tfaults.reset()
        t.close()
    assert bool(calls) == (route == "fleet")
    # the sweep reads the snapshot's node ranges (no per-sweep sort)
    assert all(kw["node_off"] is not None for kw in calls)
    assert (got == tclient.UNAUTHENTIC_REPLICA).any() and (got > 0).any()
    if route in ("fault_plan", "open_breaker"):
        dark = names[4] if route == "fault_plan" else names[2]
        assert (got[:, names.index(dark)] == tclient.UNAUTHENTIC_REPLICA).all()


@pytest.mark.parametrize("kind", ["error", "partition", "flap", "latency"])
def test_fault_plan_decisions_match_reference(kind):
    """The port's FaultPlan schedules the same faults as the reference's:
    decision for decision over two targets, a healing window and a rule
    on another target."""
    rules = [dict(boundary="grpc", target="m-1", kind=kind, rate=0.4, latency=0.5,
                  period=3, after=2, heal_after=40),
             dict(boundary="grpc", target="*", kind="error", rate=0.1,
                  code="DEADLINE_EXCEEDED")]
    jplan = jfaults.FaultPlan(seed=7, rules=[jfaults.FaultRule(**r) for r in rules])
    tplan = tfaults.FaultPlan(seed=7, rules=[tfaults.FaultRule(**r) for r in rules])
    for target in ("m-1", "m-2"):
        for n in range(64):
            ja, ta = jplan.decide("grpc", target, n), tplan.decide("grpc", target, n)
            assert (ta.error, ta.latency) == (ja.error, ja.latency), (target, n)
    with pytest.raises(ValueError, match="boundary"):
        tfaults.FaultPlan(rules=[tfaults.FaultRule(boundary="gprc")]).validate()
    # the HTTP and apply boundaries are the reference's too
    for boundary in ("http", "apply"):
        tfaults.FaultPlan(rules=[tfaults.FaultRule(boundary=boundary)]).validate()
        jfaults.FaultPlan(rules=[jfaults.FaultRule(boundary=boundary)]).validate()


def test_member_estimators_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tclient.MemberEstimators({})


class _RowsEstimator:
    """Seeded per-(row, cluster) answers with discards (bench.py
    build_degraded's stand-in for the member daemons), one matrix per
    shape."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)
        self._cache = {}

    def max_available_replicas_rows(self, clusters, reqs):
        key = (len(clusters), len(reqs))
        if key not in self._cache:
            a = self._rng.integers(-1, 60, size=(len(reqs), len(clusters)))
            self._cache[key] = a.astype(np.int32)
        return self._cache[key]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _registries():
    """The same registry in both packages: member estimators and a rows
    estimator registered together, breakers on a fake clock."""
    jm, tm, names = _members(seed=2)
    out = []
    for pkg, members, client, faults in (("jax", jm, jclient, jfaults),
                                         ("port", tm, tclient, tfaults)):
        clock = _FakeClock()
        breakers = faults.BreakerRegistry(failure_threshold=1, open_seconds=30.0, clock=clock)
        reg = client.EstimatorRegistry(breakers=breakers)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        reg.register_replica_estimator("members", client.MemberEstimators(
            members, breakers=breakers, **kw))
        reg.register_replica_estimator("rows", _RowsEstimator(11))
        out.append((reg, breakers, clock))
    return out, names


def test_registry_batch_estimates_match_reference():
    """batch_estimates over two registered estimators across four sweeps —
    healthy, a member's breaker open (its column served from the staleness
    cache, min-merged with the live estimator), still open (one more
    decay), closed again — and a chunked sweep_round, against the
    reference registry; plus the None cases and min_unschedulable."""
    (jside, tside), names = _registries()
    (jreg, jbr, jclock), (treg, tbr, tclock) = jside, tside
    rng = np.random.default_rng(3)
    placements = [dyn_placement(), dyn_placement(aggregated=True),
                  jpol.Placement(cluster_affinity=jpol.ClusterAffinity(cluster_names=[]))]
    bindings = [make_binding(f"r-{i}", int(rng.integers(1, 20)), placements[i % 3],
                             cpu=float(rng.choice([0.25, 0.5, 1.0]))) for i in range(12)]
    tb = conv(bindings)
    dark = names[6]
    seen_stale = False
    for sweep in range(4):
        for br in (jbr.for_member(dark), tbr.for_member(dark)):
            if sweep in (1, 2):
                br.record_failure()
            else:
                br.record_success()
        want = jreg.batch_estimates(bindings, names)
        got = treg.batch_estimates(tb, names)
        np.testing.assert_array_equal(got, want, err_msg=f"sweep {sweep}")
        assert treg.last_sweep_open == jreg.last_sweep_open
        assert treg.last_sweep_stale == jreg.last_sweep_stale
        seen_stale |= bool(treg.last_sweep_stale)
        assert (got[2::3] == -1).all()  # Duplicated rows are not estimated
    assert seen_stale
    assert treg.staleness.age(dark) == jreg.staleness.age(dark)
    # a chunked round: two chunk sweeps as one logical sweep, dark member
    for br in (jbr.for_member(dark), tbr.for_member(dark)):
        br.record_failure()
    with jreg.sweep_round(), treg.sweep_round():
        for lo, hi in ((0, 5), (5, 12)):
            want = jreg.batch_estimates(bindings[lo:hi], names)
            got = treg.batch_estimates(tb[lo:hi], names)
            np.testing.assert_array_equal(got, want)
    assert treg.staleness.age(dark) == jreg.staleness.age(dark)
    # no dynamic row, no registered estimator: no answer matrix
    assert treg.batch_estimates(tb[2::3], names) is None
    assert tclient.EstimatorRegistry().batch_estimates(tb, names) is None
    # the descheduler's merge over unschedulable estimators
    for reg in (jreg, treg):
        reg.register_unschedulable_estimator("a", _Unsched([3, -1, 5]))
        reg.register_unschedulable_estimator("b", _Unsched([1, -1, 7]))
    assert (treg.min_unschedulable(names[:3], None, 60.0)
            == jreg.min_unschedulable(names[:3], None, 60.0) == [1, 0, 5])


class _Unsched:
    def __init__(self, answers):
        self.answers = answers

    def get_unschedulable_replicas(self, clusters, resource, threshold_seconds):
        return list(self.answers)


# --------------------------------------------------------------------------
# schedule rounds and tiered launches with answers
# --------------------------------------------------------------------------


def _answers(rng, B, C, values=(0, 1, 3, 40, 1 << 20)):
    """A seeded answer matrix: -1 (no answer), 0, and values below and far
    above the general estimate."""
    a = rng.choice(values, (B, C))
    return np.where(rng.random((B, C)) < 0.3, -1, a).astype(np.int32)


def _spread_twins(clusters):
    """Region-spread rows identical in every scoring input, so only their
    answer rows tell them apart (the scoring dedup must not merge them)."""
    from test_torch_spread import _region_spread

    p = _region_spread(2, 3, 3, divided=True)
    return [_binding(700 + i, 12, p, 0.25) for i in range(6)]


def _round_case(name):
    """(clusters, bindings, candidate_k, extra_avail)."""
    rng = np.random.default_rng(ROUNDS.index(name))
    if name in ("compact", "dense", "chunked"):
        clusters, bindings = flagship_mix(seed=ROUNDS.index(name), n_bindings=120)
        k = 0 if name == "dense" else 16
    elif name == "spread":
        clusters = synthetic_fleet(80, seed=5, ready_fraction=0.95)
        from test_torch_spread import _spread_mix

        bindings = _spread_mix(rng, clusters, 40) + _spread_twins(clusters)
        k = 0
    else:  # "spread_window": wide spread rows re-solve dense with their answers
        clusters = synthetic_fleet(80, seed=6, ready_fraction=0.95)
        bindings = _spread_twins(clusters) + [
            _binding(800 + i, int(rng.integers(1, 40)), _dyn(i % 2 == 0), 0.5)
            for i in range(20)]
        k = 16
    extra = _answers(rng, len(bindings), len(clusters))
    if name.startswith("spread"):
        first = len(bindings) - 6 if name == "spread" else 0
        for i in range(6):  # each twin's answers starve a different set of clusters
            row = extra[first + i]
            row[:] = -1
            row[rng.choice(len(clusters), 20 + 8 * i, replace=False)] = 0
    return clusters, bindings, k, extra


ROUNDS = ("compact", "dense", "chunked", "spread", "spread_window")


@pytest.mark.parametrize("name", ROUNDS)
def test_schedule_with_answers_matches_jax(name, monkeypatch):
    """ArrayScheduler.schedule(bindings, extra_avail=...) decides as the
    JAX ArrayScheduler: a compact round (with its ordered-affinity retry),
    a dense round, a round chunked by a small row budget, spread rows whose
    answer rows alone differ (dense round) and wide spread rows re-solved
    dense out of the compact round; and the answers change decisions."""
    clusters, bindings, k, extra = _round_case(name)
    want = jcore.ArrayScheduler(clusters, candidate_k=k).schedule(bindings, extra_avail=extra)
    if name == "chunked":
        monkeypatch.setenv("KARMADA_TPU_MAX_BC_ELEMS", str(24 * 96))
    port = TorchScheduler(conv(clusters), candidate_k=k, device="cpu")
    if name == "chunked":
        assert port._max_rows_per_round(96) == 24
    tb = conv(bindings)
    got = port.schedule(tb, extra_avail=extra)
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
    plain = port.schedule(tb)
    changed = sum(_decision_view(a) != _decision_view(b) for a, b in zip(got, plain))
    assert changed > 0
    if name in ("compact", "chunked"):
        assert any(d.affinity_name == "backup" for d in got)
    if name.startswith("spread"):
        twins = [d for d in got if d.key.split("-")[-1].startswith("70")]
        assert len({str(_decision_view(d)[3]) for d in twins}) > 1


def _tier_answer_case(mode):
    """(clusters, bindings, placed, extra): a mixed-priority batch at
    priorities 0, 7 and 14 with armed preemptors in every tier and one
    placed victim at priority 7, so the armed tiers at 7 and 0 have nothing
    to reclaim, over the contended dense fleet or a 300-cluster synthetic
    fleet (the compact launch)."""
    from test_torch_preemption import _tiered_fixture

    clusters, bindings = _tiered_fixture(mode, 3, seed=2)
    rng = np.random.default_rng(4)
    for rb in bindings[::5]:
        rb.spec.preemption_policy = jpol.PREEMPT_LOWER_PRIORITY
    victim = make_binding("victim", 2, dyn_placement(), cpu=1.0)
    victim.spec.schedule_priority = 7
    mark_placed(victim, [(clusters[0].name, 2)])
    extra = _answers(rng, len(bindings), len(clusters), values=(0, 0, 1, 1 << 20))
    extra[::5] = 0  # the armed rows' answers forbid every cluster
    return clusters, bindings, [victim], extra


@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_launch_tiered_with_answers_matches_jax(mode):
    """launch_tiered(..., extra_avail=...) + materialize_chunk decides as
    the JAX package, speculative decisions included: every tier's main
    pass min-merges the answers, the speculative pass reads none, even in
    a tier with zero reclaim (where it then differs from the main pass)."""
    clusters, bindings, placed, extra = _tier_answer_case(mode)
    jarr = jcore.ArrayScheduler(clusters)
    tarr = TorchScheduler(conv(clusters), device="cpu")
    want = jarr.materialize_chunk(jpre.launch_tiered(jarr, bindings, extra_avail=extra,
                                                     placed=placed))
    pend = tpre.launch_tiered(tarr, conv(bindings), extra_avail=extra, placed=conv(placed))
    assert (pend["state"]["cand_dev"] is None) == (mode == "dense")
    got = tarr.materialize_chunk(pend)
    assert [_view(d) for d in got] == [_view(d) for d in want]
    plain = tarr.materialize_chunk(tpre.launch_tiered(tarr, conv(bindings),
                                                      placed=conv(placed)))
    assert any(_view(a) != _view(b) for a, b in zip(got, plain))
    specs = [d for d in got if d.speculative is not None]
    assert specs
    # a speculative pass over the same capacity without the answers
    reclaim, armed = tpre._tier_reclaim(tarr, conv(bindings), conv(placed))
    tier_of, _ = tpre._tier_assignment(conv(bindings))
    zero_tiers = {int(tier_of[i]) for i in armed} - (
        set() if reclaim is None else {t for t in range(len(reclaim)) if reclaim[t].any()})
    assert zero_tiers
    assert any(_view(d)[:4] != _view(d.speculative)[:4] for d in specs)
