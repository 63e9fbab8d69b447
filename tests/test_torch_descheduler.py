"""The port's descheduler (`karmada_tpu_torch.descheduler`) held against the
JAX package's on the CPU.

- `eligible` and `ready_replicas_by_cluster` over every placement kind;
- the store-level dry run and live sweep of tests/test_simulation.py's
  `TestDryRunStoreLevel` (a stub unschedulable registry): the report, the
  untouched store image before the sweep and the store image after it;
- a seeded sweep over 40 bindings of four placement kinds with ready
  counts below their assignments on a third of the clusters: the dry
  run's report (displaced, unplaceable, overcommitted, every diff) and the
  live sweep's count and every shrunk `spec.clusters`;
- tests/test_estimator.py's `TestDescheduler` flow without a
  `ControlPlane`: member estimators over one node each, the member's
  node shrinks under its assignment, the pods pend past the threshold on a
  stepped clock, the sweep shrinks the binding and the daemon re-places
  the freed replicas, each step equal to the reference's;
- `tick`'s interval, and `device=None` raising without a card.
"""
from __future__ import annotations

import copy
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.testing.fixtures import (  # noqa: E402
    duplicated_placement,
    static_weight_placement,
    synthetic_fleet,
)
from tests.test_parallel import dyn_placement, make_binding  # noqa: E402

from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402

PKGS = ("karmada_tpu", "karmada_tpu_torch")
GiB = 1024.0**3
T0 = 1000.0


def _mods(pkg: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg, store=imp("store.store"), controller=imp("runtime.controller"),
        desched=imp("descheduler.descheduler"), work=imp("api.work"), codec=imp("server.codec"),
        client=imp("estimator.client"), accurate=imp("estimator.accurate"),
        scheduler=imp("sched.scheduler"), nodes=imp("models.nodes"),
    )


REF, PORT = (_mods(p) for p in PKGS)


def _own(m, obj):
    obj = copy.deepcopy(obj)
    return conv(obj) if m is PORT else obj


def _kw(m) -> dict:
    return {"device": "cpu"} if m is PORT else {}


def _encoded(m, obj) -> str:
    """The object's wire encoding without the store's wall-clock creation
    stamp."""
    enc = m.codec.encode(obj)
    enc["metadata"].pop("creation_timestamp", None)
    return json.dumps(enc, sort_keys=True, default=str)


def store_image(m, store) -> str:
    """Every object of every kind, wire-encoded (resourceVersions
    included, so any write shows)."""
    return json.dumps({kind: sorted(_encoded(m, o) for o in store.list(kind))
                       for kind in sorted(store.kinds())}, sort_keys=True)


def report_view(m, report) -> str:
    enc = m.codec.encode(report)
    enc["metadata"].pop("uid", None)
    enc["metadata"].pop("creation_timestamp", None)
    return json.dumps(enc, sort_keys=True)


def targets(rb) -> tuple:
    return tuple(sorted((t.name, t.replicas) for t in rb.spec.clusters))


class StubRegistry:
    """The reference test's min_unschedulable stub: every undesired
    cluster has `n` replicas that can never start (or a per-cluster
    count)."""

    def __init__(self, n=2):
        self.n = n

    def min_unschedulable(self, clusters, resource, threshold):
        if isinstance(self.n, dict):
            return [self.n.get(c, 0) for c in clusters]
        return [self.n] * len(clusters)


# ---------------------------------------------------------------------------
# the filters
# ---------------------------------------------------------------------------


def _placement_kinds(names):
    aggregated = dyn_placement(aggregated=True)
    weighted = dyn_placement()
    static = static_weight_placement({names[0]: 1, names[1]: 2})
    dup = duplicated_placement(names[:3])
    bare = dyn_placement()
    bare.replica_scheduling = None
    return {"aggregated": aggregated, "dynamic weighted": weighted, "static weighted": static,
            "duplicated": dup, "no strategy": bare, "no placement": None}


@pytest.mark.parametrize("kind", list(_placement_kinds(["a", "b", "c"])))
def test_eligible_and_ready_counts_match_reference(kind):
    from karmada_tpu.api.work import AggregatedStatusItem

    placement = _placement_kinds(["a", "b", "c"])[kind]
    rb = make_binding("e", 6, placement, cpu=0.5, prev={"a": 4, "b": 2})
    rb.status.aggregated_status = [
        AggregatedStatusItem(cluster_name="a", status={"readyReplicas": 3}),
        AggregatedStatusItem(cluster_name="b", status={}),
        AggregatedStatusItem(cluster_name="c", status=None),
    ]
    port = conv(rb)
    assert PORT.desched.eligible(port) == REF.desched.eligible(rb)
    assert PORT.desched.ready_replicas_by_cluster(port) == \
        REF.desched.ready_replicas_by_cluster(rb)
    assert PORT.desched.DEFAULT_DESCHEDULING_INTERVAL == REF.desched.DEFAULT_DESCHEDULING_INTERVAL
    assert PORT.desched.DEFAULT_UNSCHEDULABLE_THRESHOLD == \
        REF.desched.DEFAULT_UNSCHEDULABLE_THRESHOLD


# ---------------------------------------------------------------------------
# store-level sweeps against a stub registry
# ---------------------------------------------------------------------------


def _stuck_objects():
    """tests/test_simulation.py TestDryRunStoreLevel._store's objects: the
    first cluster has no headroom left, and one aggregated binding has
    ready counts below its assignment on both of its clusters."""
    from karmada_tpu.api.work import AggregatedStatusItem

    clusters = synthetic_fleet(12, seed=7)
    names = [c.name for c in clusters]
    rs = clusters[0].status.resource_summary
    rs.allocated = dict(rs.allocatable)
    rb = make_binding("stuck", 10, dyn_placement(aggregated=True), cpu=0.5,
                      prev={names[0]: 6, names[1]: 4})
    rb.status.aggregated_status = [
        AggregatedStatusItem(cluster_name=names[0], status={"readyReplicas": 2}),
        AggregatedStatusItem(cluster_name=names[1], status={"readyReplicas": 4}),
    ]
    return clusters + [rb]


def _store_of(m, objs):
    """A store of `objs` carried into package `m`, each with an explicit
    uid (a store mints missing ones from its own package's counter)."""
    store = m.store.Store()
    for o in objs:
        o = _own(m, o)
        o.metadata.uid = o.metadata.uid or f"uid-{o.kind}-{o.metadata.name}"
        store.create(o)
    return store


def test_store_level_dry_run_and_sweep_match_reference():
    views, images = [], []
    objs = _stuck_objects()
    for m in (REF, PORT):
        store = _store_of(m, objs)
        d = m.desched.Descheduler(store, StubRegistry(n=3), **_kw(m))
        before = store_image(m, store)
        report = d.deschedule_dryrun()
        assert store_image(m, store) == before, "dry-run wrote to the store"
        assert report.bindings == 1
        (row,) = report.scenarios
        assert row.scenario.name == "descheduler-evictions" and row.injected == 1
        assert row.diffs and row.diffs[0].binding == "default/stuck"
        rb = store.list("ResourceBinding")[0]
        proposed = d._proposed_targets(rb)
        assert d.deschedule_once() == 1
        after = store.list("ResourceBinding")[0]
        assert targets(after) == tuple(sorted((t.name, t.replicas) for t in proposed))
        views.append(report_view(m, report))
        images.append((before, store_image(m, store)))
    assert views[1] == views[0]
    assert images[1] == images[0]


def _seeded_sweep_objects(seed=5):
    """40 bindings of four placement kinds over a 12-cluster fleet, each
    with a previous assignment, ready counts below the assignment on a
    seeded third of the clusters, and each cluster's unschedulable
    count."""
    from karmada_tpu.api.work import AggregatedStatusItem

    rng = np.random.default_rng(seed)
    clusters = synthetic_fleet(12, seed=7)
    names = [c.name for c in clusters]
    short = set(rng.choice(names, 4, replace=False).tolist())
    objs = list(clusters)
    for i in range(40):
        kind = i % 4
        placement = (dyn_placement(aggregated=True) if kind == 0 else dyn_placement()
                     if kind == 1 else static_weight_placement({names[2]: 1, names[5]: 1})
                     if kind == 2 else duplicated_placement(names[:2]))
        picks = rng.choice(names, 3, replace=False).tolist()
        prev = {n: int(rng.integers(1, 6)) for n in picks}
        rb = make_binding(f"sw-{i:02d}", sum(prev.values()), placement,
                          cpu=0.25 * (1 + i % 3), prev=prev)
        rb.status.aggregated_status = [
            AggregatedStatusItem(cluster_name=n, status={
                "readyReplicas": int(rng.integers(0, r)) if n in short else r})
            for n, r in prev.items()]
        objs.append(rb)
    return objs, {n: int(rng.integers(1, 4)) for n in names}


def test_seeded_dry_run_report_and_sweep_match_reference():
    got = []
    objs, unsched = _seeded_sweep_objects()
    for m in (REF, PORT):
        store = _store_of(m, objs)
        d = m.desched.Descheduler(store, StubRegistry(unsched), **_kw(m))
        report = d.deschedule_dryrun(diff_limit=1 << 20)
        n = d.deschedule_once()
        shrunk = {rb.metadata.name: targets(rb) for rb in store.list("ResourceBinding")}
        got.append((report_view(m, report), n, shrunk, store_image(m, store)))
    assert got[1] == got[0]
    report = json.loads(got[0][0])
    (row,) = report["scenarios"]
    assert got[0][1] > 5 and row["injected"] == got[0][1]
    assert row["diffs"] and row["displaced"] > 0


def test_tick_runs_once_per_interval_like_the_reference():
    counts = []
    objs, unsched = _seeded_sweep_objects()
    for m in (REF, PORT):
        store = _store_of(m, objs)
        clock = m.controller.Clock(fixed=T0)
        d = m.desched.Descheduler(store, StubRegistry(unsched), clock=clock, interval=120.0,
                                  **_kw(m))
        seen = [d.tick()]
        clock.advance(60.0)
        seen.append(d.tick())
        clock.advance(61.0)
        seen.append(d.tick())
        counts.append(seen)
    assert counts[1] == counts[0] and counts[0][0] > 0 and counts[0][1] == 0


def test_default_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT.desched.Descheduler(PORT.store.Store(), StubRegistry())


# ---------------------------------------------------------------------------
# the estimator flow without a ControlPlane
# ---------------------------------------------------------------------------


class _Member:
    def __init__(self, est):
        self.node_estimator = est


class Flow:
    """One package's store of two clusters `a` and `b` (10 cpu each),
    member estimators over one node each on a stepped clock, a registry
    carrying them as replica and unschedulable estimators, and a daemon."""

    def __init__(self, m):
        from karmada_tpu.api.meta import CPU, MEMORY, PODS
        from karmada_tpu.models.nodes import NodeSpec
        from karmada_tpu.testing.fixtures import new_cluster_with_resource

        self.m = m
        self.clock = m.controller.Clock(fixed=T0)
        self.store = m.store.Store()
        alloc = {CPU: 10.0, MEMORY: 40 * GiB, PODS: 110.0}
        for name in ("a", "b"):
            self.store.create(_own(m, new_cluster_with_resource(name, alloc)))
        self.members = {
            name: _Member(m.accurate.AccurateEstimator(
                _own(m, [NodeSpec(name="n1", allocatable={CPU: 10.0, MEMORY: 40 * GiB})]),
                clock=self.clock))
            for name in ("a", "b")}
        est = m.client.MemberEstimators(self.members, **_kw(m))
        self.registry = m.client.EstimatorRegistry()
        self.registry.register_replica_estimator("members", est)
        self.registry.register_unschedulable_estimator("members", est)
        self.runtime = m.controller.Runtime(clock=self.clock)
        self.daemon = m.scheduler.SchedulerDaemon(
            self.store, self.runtime, estimator_registry=self.registry, aot_prewarm=False,
            **_kw(m))

    def binding(self):
        return self.store.get("ResourceBinding", "web", "default")

    def run_members(self):
        """The member side: each cluster runs its share of the pods on
        its node (first fit; the rest pend from now), and the binding's
        aggregated status reports the ready counts."""
        from karmada_tpu.api.meta import CPU

        rb = self.binding()
        key = f"{rb.spec.resource.kind}/{rb.spec.resource.namespace}/{rb.spec.resource.name}"
        ready = {}
        for t in rb.spec.clusters:
            ready[t.name] = self.members[t.name].node_estimator.place(
                key, t.replicas, {CPU: 1.0}, now=self.clock.now())
        rb.status.aggregated_status = [
            self.m.work.AggregatedStatusItem(cluster_name=n, status={"readyReplicas": r})
            for n, r in sorted(ready.items())]
        self.store.update(rb)
        return ready


def test_estimator_flow_shrinks_and_replaces_like_the_reference():
    """tests/test_estimator.py TestDescheduler without the ControlPlane:
    10 replicas over a and b, a's node shrinks to 2 cpu, its pods pend,
    past the threshold the sweep shrinks a's share to what runs there and
    the daemon re-places the freed replicas on b."""
    steps = []
    rb = make_binding("web", 10, dyn_placement(), cpu=1.0)
    for m in (REF, PORT):
        f = Flow(m)
        f.store.create(_own(m, rb))
        f.runtime.settle()
        before = targets(f.binding())
        assert sum(r for _, r in before) == 10
        f.run_members()
        est_a = f.members["a"].node_estimator
        est_a.arrays.alloc[0, 0] = 2000  # 2 cpu in millicores
        est_a.version += 1
        f.clock.advance(1.0)
        ready = f.run_members()
        f.clock.advance(600.0)
        d = m.desched.Descheduler(f.store, f.registry, clock=f.clock, **_kw(m))
        report = d.deschedule_dryrun()
        moved = d.deschedule_once()
        shrunk = targets(f.binding())
        f.runtime.settle()
        after = targets(f.binding())
        steps.append((before, ready, report_view(m, report), moved, shrunk, after))
    assert steps[1] == steps[0]
    before, ready, _report, moved, shrunk, after = steps[0]
    assert moved == 1 and ready["a"] <= 2
    got = dict(after)
    assert sum(got.values()) == 10 and got.get("a", 0) <= 2 and got["b"] >= 8
