"""The port's `SchedulerDaemon` held against the JAX package's on the CPU.

Each test builds one daemon per package over the same objects (explicit
uids, a stepped `Clock` shared by the daemon and its event recorder), drives
both through the same store writes and `Runtime.settle()`, and compares
every binding the stores hold — targets and replicas, the applied-placement
annotation, conditions without their transition times, observed
generations, scheduled times, graceful-eviction tasks, resourceVersions —
and the recorded events. Covered: the reference's `topology()` recipe
(tests/test_streaming.py), `_needs_schedule`'s four triggers, suspension,
re-targeting and deletion, a cluster MODIFIED (the dirty-column refresh,
with the `dirty_names` handed to `set_clusters`) and a membership change (a
full rebuild), gang all-or-nothing and a gang timeout, tiered routing under
the PriorityBasedScheduling gate with one preemption commit, the estimator
registry's protocol check, `MemberEstimators(max_workers=)`,
`plugin_registry=`, `device=`, the prewarm and
`ArrayScheduler._maybe_autoshard`'s early returns.
"""
from __future__ import annotations

import copy
import importlib
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import tests.test_preemption as jpre  # noqa: E402
import tests.test_streaming as jstream  # noqa: E402
from karmada_tpu.testing.fixtures import synthetic_fleet  # noqa: E402
from tests.test_parallel import dyn_placement, make_binding  # noqa: E402

from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402

PKGS = ("karmada_tpu", "karmada_tpu_torch")
T0 = 1000.0


def _mods(pkg: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg, store=imp("store.store"), controller=imp("runtime.controller"),
        scheduler=imp("sched.scheduler"), features=imp("features"), events=imp("events"),
        metrics=imp("metrics"), policy=imp("api.policy"), work=imp("api.work"),
        plugins=imp("sched.plugins"), preemption=imp("sched.preemption"),
    )


class Side:
    """One package's store, stepped clock, runtime, event recorder and
    daemon."""

    def __init__(self, pkg: str, clusters, *, gates: bool = False, **kw):
        self.m = m = _mods(pkg)
        self.clock = m.controller.Clock(fixed=T0)
        self.store = m.store.Store()
        self.runtime = m.controller.Runtime(clock=self.clock)
        self.recorder = m.events.EventRecorder(self.store, clock=self.clock)
        for c in clusters:
            self.store.create(self._own(c))
        if gates:
            kw["gates"] = m.features.FeatureGates({m.features.PRIORITY_BASED_SCHEDULING: True})
        if pkg == "karmada_tpu_torch":
            kw.setdefault("device", "cpu")
        self.daemon = m.scheduler.SchedulerDaemon(
            self.store, self.runtime, event_recorder=self.recorder, aot_prewarm=False, **kw)

    def _own(self, obj):
        obj = copy.deepcopy(obj)
        return conv(obj) if self.m.pkg == "karmada_tpu_torch" else obj

    def create(self, obj):
        return self.store.create(self._own(obj))

    def binding(self, name: str):
        return self.store.get("ResourceBinding", name, "default")

    def edit(self, name: str, fn) -> None:
        rb = self.binding(name)
        fn(self.m, rb)
        self.store.update(rb)

    def view(self) -> dict:
        out = {}
        for rb in self.store.list("ResourceBinding"):
            out[rb.metadata.name] = (
                rb.metadata.resource_version, rb.metadata.generation,
                tuple(sorted((t.name, t.replicas) for t in (rb.spec.clusters or []))),
                rb.metadata.annotations.get(self.m.work.POLICY_PLACEMENT_ANNOTATION),
                tuple((c.type, c.status, c.reason, c.message) for c in rb.status.conditions),
                rb.status.scheduler_observed_generation, rb.status.last_scheduled_time,
                rb.status.scheduler_observed_affinity_name,
                tuple((t.from_cluster, t.replicas, t.reason, t.producer, t.message,
                       t.creation_timestamp) for t in rb.spec.graceful_eviction_tasks),
            )
        return out

    def events(self) -> list:
        return sorted(
            (e.metadata.resource_version, e.involved_name, e.type, e.reason, e.message,
             e.count, e.timestamp)
            for e in self.store.list("Event")
        )


class Pair:
    def __init__(self, clusters, **kw):
        self.ref, self.port = (Side(p, clusters, **kw) for p in PKGS)
        self.sides = (self.ref, self.port)

    def create(self, objs) -> None:
        for s in self.sides:
            for o in objs:
                s.create(o)

    def edit(self, name: str, fn) -> None:
        for s in self.sides:
            s.edit(name, fn)

    def settle(self) -> None:
        for s in self.sides:
            s.runtime.settle()

    def advance(self, dt: float) -> None:
        for s in self.sides:
            s.clock.advance(dt)

    def check(self) -> dict:
        want = self.ref.view()
        assert self.port.view() == want
        assert self.port.events() == self.ref.events()
        return want


def _fleet():
    return synthetic_fleet(jstream.N_CLUSTERS, seed=9)


def _names():
    return [c.name for c in _fleet()]


def test_topology_settle_matches_reference():
    pair = Pair(_fleet())
    pair.create(jstream.mixed_bindings(_names()))
    pair.settle()
    got = pair.check()
    assert len(got) == 24 and all(v[2] for v in got.values()), "every binding placed"
    assert len(pair.port.events()) == 24
    # a second settle finds every binding clean: nothing moves
    pair.settle()
    assert pair.check() == got


def _placement_edit(m, rb):
    rb.spec.placement.cluster_affinity = m.policy.ClusterAffinity(cluster_names=_names()[:3])


def _replicas_edit(m, rb):
    rb.spec.replicas += 2


def _reschedule_edit(m, rb):
    rb.spec.reschedule_triggered_at = T0 + 5.0


TRIGGERS = {
    # (binding, edit, needs_schedule after the edit)
    "placement": ("app-0", _placement_edit, True),
    "replicas": ("app-2", _replicas_edit, True),
    "reschedule": ("app-4", _reschedule_edit, True),
    "duplicated": ("app-1", None, True),
    "clean": ("app-6", None, False),
}


@pytest.mark.parametrize("trigger", list(TRIGGERS))
def test_needs_schedule_triggers_match_reference(trigger):
    name, edit, want = TRIGGERS[trigger]
    pair = Pair(_fleet())
    pair.create(jstream.mixed_bindings(_names()))
    pair.settle()
    pair.advance(10.0)
    if edit is not None:
        pair.edit(name, edit)
    for s in pair.sides:
        assert s.daemon._needs_schedule(s.binding(name)) is want
    pair.settle()
    after = pair.check()
    if trigger == "replicas":
        assert sum(r for _, r in after[name][2]) == 5 + 2
    if trigger == "placement":
        assert {n for n, _ in after[name][2]} <= set(_names()[:3])
    if trigger == "reschedule":
        assert after[name][6] == T0 + 10.0  # re-scheduled at the stepped clock


def _suspend(m, rb):
    rb.spec.suspension = m.policy.Suspension(scheduling=True)
    rb.spec.replicas += 3


def _retarget(m, rb):
    rb.spec.scheduler_name = "other-scheduler"
    rb.spec.replicas += 3


@pytest.mark.parametrize("event", ["suspend", "retarget", "delete"])
def test_stopping_events_match_reference(event):
    pair = Pair(_fleet())
    pair.create(jstream.mixed_bindings(_names()))
    pair.settle()
    before = pair.check()
    if event == "delete":
        for s in pair.sides:
            s.store.delete("ResourceBinding", "app-2", "default")
    else:
        pair.edit("app-2", _suspend if event == "suspend" else _retarget)
    pair.settle()
    after = pair.check()
    if event == "delete":
        assert "app-2" not in after
    else:
        # the spec moved (replicas + 3) but the placement did not follow
        assert after["app-2"][2] == before["app-2"][2]
        assert after["app-2"][1] == before["app-2"][1] + 1


def _record_set_clusters(side) -> list:
    array = side.daemon._ensure_fleet()
    calls: list = []
    orig = array.set_clusters

    def set_clusters(clusters, dirty_names=None):
        calls.append(None if dirty_names is None else set(dirty_names))
        return orig(clusters, dirty_names=dirty_names)

    array.set_clusters = set_clusters
    return calls


def test_cluster_modified_takes_dirty_columns():
    pair = Pair(_fleet())
    pair.create(jstream.mixed_bindings(_names()))
    pair.settle()
    calls = [_record_set_clusters(s) for s in pair.sides]
    target = _names()[2]
    for s in pair.sides:
        c = s.store.get("Cluster", target)
        cpu = next(iter(c.status.resource_summary.allocated)) if c.status.resource_summary else None
        assert cpu is not None
        c.status.resource_summary.allocated[cpu] = c.status.resource_summary.allocatable[cpu]
        s.store.update(c)
    pair.settle()
    pair.check()
    assert calls[0] == calls[1] == [{target}]
    # the port kept its batch encoder and refreshed the placed fleet in place
    arr = pair.port.daemon._array
    assert arr.fleet.names[: len(_names())] == sorted(_names())


def test_membership_change_rebuilds_fleet():
    pair = Pair(_fleet())
    pair.create(jstream.mixed_bindings(_names()))
    pair.settle()
    calls = [_record_set_clusters(s) for s in pair.sides]
    extra = synthetic_fleet(jstream.N_CLUSTERS + 1, seed=9)[-1]
    extra.metadata.name = "zz-new"
    extra.metadata.uid = "uid-zz-new"
    for s in pair.sides:
        s.create(extra)
    pair.settle()
    pair.check()
    assert calls[0] == calls[1] == [None]
    assert "zz-new" in pair.port.daemon._array.fleet.names


def test_gang_all_or_nothing_matches_reference():
    pair = Pair(jpre.tight_fleet(free=(8.0, 8.0)))
    ok = jpre.gang_bindings(n=3, name="team")
    bad = jpre.gang_bindings(n=3, name="crew")
    bad[2].spec.replicas = 50  # cannot fit anywhere
    n0 = {p: _mods(p).metrics.gang_admissions.value(outcome="placed") for p in PKGS}
    r0 = {p: _mods(p).metrics.gang_admissions.value(outcome="rejected") for p in PKGS}
    pair.create(ok + bad)
    pair.settle()
    got = pair.check()
    assert all(sum(r for _, r in got[f"team-{i}"][2]) == 2 for i in range(3))
    assert all(got[f"crew-{i}"][2] == () for i in range(3)), "a partial gang leaked"
    assert all(got[f"crew-{i}"][4][0][2] == "GangUnschedulable" for i in range(3))
    for p in PKGS:
        mm = _mods(p).metrics
        assert mm.gang_admissions.value(outcome="placed") - n0[p] == 1
        assert mm.gang_admissions.value(outcome="rejected") - r0[p] >= 1


def test_gang_timeout_matches_reference():
    pair = Pair(jpre.tight_fleet(free=(8.0, 8.0)), gang_wait_seconds=30.0)
    gang = jpre.gang_bindings(n=3)
    pair.create(gang[:2])  # the third member never arrives in time
    pair.settle()
    assert pair.check()["team-0"][2] == ()
    for s in pair.sides:
        assert s.daemon.gangs.held_count() == 2
    pair.advance(31.0)
    for s in pair.sides:
        assert s.daemon.gang_tick() == 1
        assert s.daemon.gangs.held_count() == 0
    got = pair.check()
    assert all(got[f"team-{i}"][4][0][2] == "GangTimeout" for i in range(2))
    # the late member completes a fresh cohort
    pair.create(gang[2:])
    for s in pair.sides:
        for i in range(2):
            s.store.update(s.binding(f"team-{i}"))
    pair.settle()
    got = pair.check()
    assert all(sum(r for _, r in got[f"team-{i}"][2]) == 2 for i in range(3))


def test_tiered_routing_under_gate_matches_reference():
    pair = Pair(jpre.tight_fleet(), gates=True)
    for s in pair.sides:
        assert type(s.daemon.controller.queue).__name__ == "PrioritySchedulingQueue"
    tiered0 = pair.port.m.preemption.LAUNCHES.tiered
    pair.create(jpre.mixed_priority_bindings())
    pair.settle()
    pair.check()
    assert pair.port.m.preemption.LAUNCHES.tiered > tiered0


def test_preemption_commit_matches_reference():
    t = jpre.TestPreemption()
    pair = Pair(t._fleet(), gates=True)
    c0 = {p: _mods(p).metrics.preemptions_total.value(outcome="committed") for p in PKGS}
    pair.create([t._victim()])
    pair.settle()
    assert pair.check()["victim"][2] == (("m0", 4),)
    pair.create([t._preemptor()])
    pair.settle()
    got = pair.check()
    assert sum(r for _, r in got["urgent"][2]) == 6
    assert got["victim"][8], "no graceful-eviction task on the victim"
    for p in PKGS:
        assert _mods(p).metrics.preemptions_total.value(outcome="committed") - c0[p] == 1


class _NoProtocol:
    def batch_estimates(self, bindings, clusters):
        return None


def test_registry_without_protocol_raises():
    msgs = []
    for p in PKGS:
        m = _mods(p)
        kw = {"device": "cpu"} if p == "karmada_tpu_torch" else {}
        with pytest.raises(TypeError) as e:
            m.scheduler.SchedulerDaemon(m.store.Store(), m.controller.Runtime(),
                                        estimator_registry=_NoProtocol(), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "last_sweep_open" in msgs[1] and "sweep_round" in msgs[1]


def test_plugin_registry_reaches_array_scheduler():
    side = Side("karmada_tpu_torch", _fleet(),
                plugin_registry=(reg := _mods("karmada_tpu_torch").plugins.PluginRegistry()),
                plugins=["*", "-ClusterLocality"])
    array = side.daemon._ensure_fleet()
    assert array.plugin_registry is reg
    assert "ClusterLocality" not in array.enabled_plugins


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is present")
def test_default_device_without_card_raises():
    m = _mods("karmada_tpu_torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        m.scheduler.SchedulerDaemon(m.store.Store(), m.controller.Runtime())


def test_prewarm_runs_dry_round_and_records_counts():
    side = Side("karmada_tpu_torch", _fleet())
    side.daemon.aot_prewarm = True
    side.daemon.prewarm(wait_aot=True)
    array = side.daemon._array
    assert side.daemon.last_prewarm_stats == {
        "epoch": array.fleet_epoch, "jit_compiles": 0, "jit_compile_seconds": 0.0,
        "jit_persistent_cache_hits": 0,
    }
    assert side.store.list("ResourceBinding") == []  # the dry round wrote nothing
    side.daemon.abandon_prewarm()
    assert side.daemon._aot_epoch == -1


def test_maybe_autoshard_early_returns_match_reference(monkeypatch):
    """`_maybe_autoshard` keeps the reference's early returns (the round
    within max_bc_elems, autoshard off: False in both packages; one device
    visible: False in the port, whose CPU is one device) and raises where
    the reference re-places the fleet over several devices (the tests'
    JAX backend shows eight)."""
    from karmada_tpu.sched.core import ArrayScheduler as JaxScheduler

    from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler

    ref, port = JaxScheduler(_fleet()), TorchScheduler(conv(_fleet()), device="cpu")
    width = len(port.fleet.names)
    for arr in (ref, port):
        assert arr._maybe_autoshard(4) is False  # fits the budget
        arr.max_bc_elems = width  # one row fits, two do not
        arr.autoshard = False
        assert arr._maybe_autoshard(2) is False  # autoshard off
        arr.autoshard = True
    assert port._maybe_autoshard(2) is False  # one device visible
    assert ref._maybe_autoshard(2) is True and ref.mesh is not None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    port.device = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        port._maybe_autoshard(2)
    assert port.mesh is None


def test_estimator_registry_protocol_and_pool_width_match_reference():
    """The port's EstimatorRegistry satisfies SchedulerEstimatorRegistry's
    attributes, so a daemon takes it; MemberEstimators(max_workers=) pins
    the fan-out pool as the reference's does and rejects a width of 0."""
    widths = []
    for p in PKGS:
        client = importlib.import_module(f"{p}.estimator.client")
        kw = {"device": "cpu"} if p == "karmada_tpu_torch" else {}
        proto = client.SchedulerEstimatorRegistry
        reg = client.EstimatorRegistry()
        assert all(hasattr(reg, a) for a in ("batch_estimates", "last_sweep_open", "sweep_round"))
        assert {"batch_estimates", "sweep_round"} <= set(vars(proto))
        side = Side(p, _fleet(), estimator_registry=reg)
        assert side.daemon.estimator_registry is reg
        pinned = client.MemberEstimators({}, max_workers=3, **kw)
        default = client.MemberEstimators({}, **kw)
        widths.append((pinned._pool_for(100)._max_workers, default._pool_for(100)._max_workers,
                       default._pool_for(5)._max_workers))
        pinned._pool.shutdown(wait=True)
        default._pool.shutdown(wait=True)
        with pytest.raises(ValueError, match="max_workers=0"):
            client.MemberEstimators({}, max_workers=0, **kw)
    assert widths[0] == widths[1] == (3, 64, 64)
