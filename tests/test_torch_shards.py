"""The port's sharded scheduler plane (`karmada_tpu_torch.sched.shards`)
held against the JAX package's on the CPU.

The rendezvous map agrees key for key (`shard_of`, `shard_of_binding`,
`shard_of_gang` over 10 000 keys at totals 1-8), and the sharding kinds
encode to the same wire bytes in both directions. Then the reference's
tests/test_shards.py scenarios (all but its two `karmadactl` ones) run once
per package over the same objects (explicit uids, a stepped `Clock`):
ownership and the owned index, a resize mid-stream, the orphan-slot guard,
the cross-shard gang's commit, stale-rv abort and timeout, and the status
surface; each compares every stored binding, proposal and shard object,
the owned slices and the metric deltas. The leader kill, the fairness
budget and the in-process `ShardPlane` (threads on the wall clock) run on
the port alone with the reference's assertions, the plane's placements
held against the reference's direct round.
"""
from __future__ import annotations

import copy
import importlib
import json
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.testing.fixtures import synthetic_fleet  # noqa: E402
from tests.test_parallel import dyn_placement, make_binding  # noqa: E402

from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402

PKGS = ("karmada_tpu", "karmada_tpu_torch")
T0 = 1000.0
N_CLUSTERS = 5


def _mods(pkg: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg, store=imp("store.store"), controller=imp("runtime.controller"),
        shards=imp("sched.shards"), fairness=imp("sched.shards.fairness"),
        sharding=imp("api.sharding"), work=imp("api.work"), metrics=imp("metrics"),
        codec=imp("server.codec"),
    )


REF, PORT = (_mods(p) for p in PKGS)


def gang_binding(name, gname, size, replicas=2, ns="default"):
    rb = make_binding(name, replicas, dyn_placement(), cpu=0.1, ns=ns)
    rb.spec.gang_name = gname
    rb.spec.gang_size = size
    return rb


def spanning_gang(total, size=3, ns="default"):
    """A gang whose members hash to more than one shard."""
    shard_of_binding = REF.shards.shard_of_binding
    for salt in range(200):
        gname = f"xg{salt}"
        rbs = [gang_binding(f"{gname}-m{i}", gname, size, ns=ns) for i in range(size)]
        if len({shard_of_binding(rb, total) for rb in rbs}) > 1:
            return gname, rbs
    raise AssertionError("no spanning gang found")


class _PlacementLog:
    """Watch-side exactly-once ledger (the reference test's): one entry per
    empty->placed transition of each binding."""

    def __init__(self, store):
        self.commits: dict[str, int] = {}
        self._placed: dict[str, bool] = {}
        self._lock = threading.Lock()
        store.watch("ResourceBinding", self._on_event, replay=True)

    def _on_event(self, event, rb):
        key = rb.metadata.key()
        placed = bool(rb.spec.clusters)
        with self._lock:
            if placed and not self._placed.get(key, False):
                self.commits[key] = self.commits.get(key, 0) + 1
            self._placed[key] = placed

    def doubles(self):
        return {k: n for k, n in self.commits.items() if n > 1}


class Side:
    """One package's store over the same fleet, a stepped clock, its shard
    stacks ((daemon, streaming service) per slot) and a placement log."""

    def __init__(self, m, clusters, total, **daemon_kw):
        self.m = m
        self.clock = m.controller.Clock(fixed=T0)
        self.store = m.store.Store()
        for c in clusters:
            self.store.create(self.own(c))
        self.log = _PlacementLog(self.store)
        self.daemon_kw = daemon_kw
        self.stacks = [self.stack(i, total) for i in range(total)]

    @property
    def port(self) -> bool:
        return self.m.pkg == "karmada_tpu_torch"

    def own(self, obj):
        obj = copy.deepcopy(obj)
        return conv(obj) if self.port else obj

    def stack(self, index, total):
        kw = dict(self.daemon_kw)
        if self.port:
            kw["device"] = "cpu"
        d = self.m.shards.ShardedDaemon(self.store, self.m.controller.Runtime(clock=self.clock),
                                        index, total, aot_prewarm=False, **kw)
        return d, d.streaming(batch_delay=0.0)

    def create(self, objs):
        for o in objs:
            self.store.create(self.own(o))

    def binding(self, name, ns="default"):
        return self.store.try_get("ResourceBinding", name, ns)

    def drain(self, rounds=16):
        """The reference test's deterministic drive: quiescent-serve every
        shard, then every cross-shard coordinator tick, until a round makes
        no progress."""
        for _ in range(rounds):
            progress = 0
            for _d, service in self.stacks:
                progress += service.serve(quiescent=True)
            for d, _s in self.stacks:
                progress += d.xshards.tick()
            if not progress:
                return
        raise AssertionError("sharded drain did not reach a fixpoint")

    def view(self) -> dict:
        sharding = self.m.sharding
        out = {}
        for rb in self.store.list("ResourceBinding"):
            out[rb.metadata.key()] = (
                rb.metadata.generation,
                tuple((t.name, t.replicas) for t in (rb.spec.clusters or [])),
                tuple((c.type, c.status, c.reason, c.message) for c in rb.status.conditions),
                rb.status.scheduler_observed_generation, rb.status.last_scheduled_time,
            )
        for kind in (sharding.KIND_SHARD_GANG_PROPOSAL, sharding.KIND_SCHEDULER_SHARD):
            for obj in self.store.list(kind, sharding.SHARD_NAMESPACE):
                enc = self.m.codec.encode(obj)
                for volatile in ("uid", "creation_timestamp", "resource_version"):
                    enc["metadata"].pop(volatile, None)
                out[f"{kind}/{obj.metadata.name}"] = json.dumps(enc)
        return out

    def owned(self):
        return [sorted(d._owned) for d, _s in self.stacks]

    def metric(self, name, **labels):
        return getattr(self.m.metrics, name).value(**labels)

    def teardown(self):
        for d, _s in self.stacks:
            d.detach()


class Pair:
    def __init__(self, total=2, n_clusters=N_CLUSTERS, **daemon_kw):
        clusters = synthetic_fleet(n_clusters, seed=9)
        self.ref, self.port = (Side(m, clusters, total, **daemon_kw) for m in (REF, PORT))
        self.sides = (self.ref, self.port)

    def create(self, objs):
        for s in self.sides:
            s.create(objs)

    def drain(self):
        for s in self.sides:
            s.drain()

    def check(self) -> dict:
        want = self.ref.view()
        assert self.port.view() == want
        assert self.port.owned() == self.ref.owned()
        return want

    def metric_deltas(self, fn):
        """[fn(reference side), fn(port side)]: a metric's value on each
        side, read before and after a step."""
        return [fn(s) for s in self.sides]

    def teardown(self):
        for s in self.sides:
            s.teardown()


# ---------------------------------------------------------------------------
# the map and the wire
# ---------------------------------------------------------------------------

MAP_KEYS = [f"ns-{i % 7}/uid-{i}" for i in range(10_000)]


@pytest.mark.parametrize("total", range(1, 9))
def test_shard_of_matches_reference_key_for_key(total):
    assert [PORT.shards.shard_of(k, total) for k in MAP_KEYS] == \
        [REF.shards.shard_of(k, total) for k in MAP_KEYS]
    gangs = [(f"ns-{i % 5}", f"gang-{i}") for i in range(10_000)]
    assert [PORT.shards.shard_of_gang(ns, g, total) for ns, g in gangs] == \
        [REF.shards.shard_of_gang(ns, g, total) for ns, g in gangs]


@pytest.mark.parametrize("total", range(1, 9))
def test_shard_of_binding_matches_reference(total):
    rbs = [make_binding(f"rb-{i}", 1, dyn_placement(), ns=f"ns-{i % 3}") for i in range(10_000)]
    for rb in rbs[::50]:
        rb.metadata.uid = ""  # the name fallback
    ports = conv(rbs)
    want = [REF.shards.shard_of_binding(rb, total) for rb in rbs]
    assert [PORT.shards.shard_of_binding(rb, total) for rb in ports] == want
    m = PORT.shards.ShardMap(0, total)
    assert [m.owner(rb) for rb in ports] == want
    assert [m.mine(rb) for rb in ports] == [w == 0 for w in want]


def test_shard_map_balance_movement_and_validation():
    counts = [0] * 4
    for i in range(8000):
        counts[PORT.shards.shard_of(f"ns/uid-{i}", 4)] += 1
    assert 1600 < min(counts) and max(counts) < 2400, counts
    keys = [f"ns/uid-{i}" for i in range(6000)]
    for total in (2, 4):
        moved = sum(1 for k in keys if PORT.shards.shard_of(k, total)
                    != PORT.shards.shard_of(k, total + 1))
        assert moved < len(keys) / (total + 1) * 1.3, (total, moved)
    for args in ((2, 2), (0, 0)):
        with pytest.raises(ValueError) as port_err:
            PORT.shards.ShardMap(*args)
        with pytest.raises(ValueError) as ref_err:
            REF.shards.ShardMap(*args)
        assert str(port_err.value) == str(ref_err.value)
    assert PORT.shards.ShardMap(0, 4).coordinator("default", "g1") == \
        REF.shards.shard_of_gang("default", "g1", 4)


def test_sharding_names_match_reference():
    for m in (PORT, REF):
        assert m.sharding.SHARD_NAMESPACE == "karmada-system"
    for i in range(5):
        assert PORT.sharding.shard_lease_name(i) == REF.sharding.shard_lease_name(i)
        assert PORT.sharding.shard_object_name(i) == REF.sharding.shard_object_name(i)
        for ns in ("", "default", "team-a"):
            assert PORT.sharding.gang_proposal_name(ns, "g", i) == \
                REF.sharding.gang_proposal_name(ns, "g", i)


def _sharding_objects(s):
    from karmada_tpu.api.meta import ObjectMeta

    shard = s.SchedulerShard(
        metadata=ObjectMeta(name=s.shard_object_name(1), namespace=s.SHARD_NAMESPACE,
                            uid="uid-shard-1"),
        status=s.ShardStatus(leader="sched-1", fencing_token=4, epoch=17, queue_depth=3,
                             bindings=2_500, last_solve_time=1234.5, handoff="absorbing",
                             shards_total=4))
    prop = s.ShardGangProposal(
        metadata=ObjectMeta(name=s.gang_proposal_name("default", "g7", 2),
                            namespace=s.SHARD_NAMESPACE, uid="uid-prop-7"),
        spec=s.GangProposalSpec(
            gang_name="g7", gang_ns="default", gang_size=3, shard=2, coordinator=0,
            entries=[s.GangMemberEntry(key="default/g7-m0", uid="uid-m0", solved_rv=41,
                                       targets=[["member-1", 2], ["member-3", 1]],
                                       affinity_name="", error="", feasible=True),
                     s.GangMemberEntry(key="default/g7-m2", uid="uid-m2", solved_rv=44,
                                       targets=[], error="0/5 clusters are available",
                                       feasible=False)],
            created_at=1000.25),
        status=s.GangProposalStatus(outcome="aborted", message="stale rv"))
    return [shard, prop, s.SchedulerShard(), s.ShardGangProposal()]


@pytest.mark.parametrize("which", ["shard", "proposal", "default shard", "default proposal"])
def test_sharding_objects_wire_bytes_match_reference(which):
    i = ["shard", "proposal", "default shard", "default proposal"].index(which)
    ref = _sharding_objects(REF.sharding)[i]
    port = conv(ref)
    assert type(port).__module__ == "karmada_tpu_torch.api.sharding"
    want = json.dumps(REF.codec.encode(ref))
    assert json.dumps(PORT.codec.encode(port)) == want
    back = PORT.codec.decode(json.loads(want))
    assert type(back) is type(port) and json.dumps(PORT.codec.encode(back)) == want
    again = REF.codec.decode(json.loads(json.dumps(PORT.codec.encode(port))))
    assert json.dumps(REF.codec.encode(again)) == want


# ---------------------------------------------------------------------------
# the reference's scenarios, both packages
# ---------------------------------------------------------------------------


def test_slices_partition_and_place_match_reference():
    pair = Pair(2)
    bindings = [make_binding(f"own-{i}", 2 + i % 3, dyn_placement(), cpu=0.2)
                for i in range(18)]
    pair.create(bindings)
    pair.drain()
    got = pair.check()
    assert sum(1 for k, v in got.items() if k.startswith("default/") and v[1]) == 18
    for s in pair.sides:
        assert not s.log.doubles()
        d0, d1 = s.stacks[0][0], s.stacks[1][0]
        assert d0.owned_count() + d1.owned_count() == 18
        assert d0.owned_count() > 0 and d1.owned_count() > 0
        for rb in s.store.list("ResourceBinding"):
            owner = s.m.shards.shard_of_binding(rb, 2)
            assert rb.metadata.key() in s.stacks[owner][0]._owned
    pair.teardown()


def test_owned_index_drops_deleted_matches_reference():
    pair = Pair(2)
    rb = make_binding("gone", 2, dyn_placement(), cpu=0.1)
    pair.create([rb])
    pair.drain()
    pair.check()
    owner = REF.shards.shard_of_binding(rb, 2)
    for s in pair.sides:
        assert rb.metadata.key() in s.stacks[owner][0]._owned
        s.store.delete("ResourceBinding", "gone", "default")
        assert rb.metadata.key() not in s.stacks[owner][0]._owned
    pair.check()
    pair.teardown()


def test_resize_mid_stream_exactly_once_matches_reference():
    pair = Pair(2)
    pair.create([make_binding(f"pre-{i}", 2, dyn_placement(), cpu=0.2) for i in range(16)])
    pair.drain()
    pair.check()
    before = pair.metric_deltas(lambda s: s.metric("shard_handoffs", reason="resize"))
    pair.create([make_binding(f"mid-{i}", 2, dyn_placement(), cpu=0.2) for i in range(16)])
    moved = []
    for s in pair.sides:
        grown = s.stack(2, 3)
        n = sum(d.set_total(3) for d, _s in s.stacks)
        grown[0].relist()
        s.stacks.append(grown)
        moved.append(n)
    assert moved[0] == moved[1] > 0
    pair.drain()
    got = pair.check()
    after = pair.metric_deltas(lambda s: s.metric("shard_handoffs", reason="resize"))
    assert [a - b for a, b in zip(after, before)] == [float(moved[0])] * 2
    assert sum(1 for k, v in got.items() if k.startswith("default/") and v[1]) == 32
    for s in pair.sides:
        assert not s.log.doubles()
        for rb in s.store.list("ResourceBinding"):
            owner = s.m.shards.shard_of_binding(rb, 3)
            for i, (d, _s) in enumerate(s.stacks):
                assert (rb.metadata.key() in d._owned) == (i == owner)
    pair.teardown()


def test_set_total_refuses_orphan_slot_matches_reference():
    msgs = []
    for m in (REF, PORT):
        store = m.store.Store()
        kw = {"device": "cpu"} if m is PORT else {}
        d = m.shards.ShardedDaemon(store, m.controller.Runtime(), 1, 2, aot_prewarm=False, **kw)
        with pytest.raises(ValueError) as err:
            d.set_total(1)
        msgs.append(str(err.value))
        assert d.set_total(2) == 0
        d.detach()
    assert msgs[0] == msgs[1]


def test_cross_shard_gang_commits_atomically_matches_reference():
    pair = Pair(2)
    before = pair.metric_deltas(lambda s: s.metric("xshard_gang_commits", outcome="committed"))
    gname, rbs = spanning_gang(2)
    pair.create(rbs)
    pair.drain()
    pair.check()
    after = pair.metric_deltas(lambda s: s.metric("xshard_gang_commits", outcome="committed"))
    assert [a - b for a, b in zip(after, before)] == [1.0, 1.0]
    for s in pair.sides:
        fresh = [s.binding(rb.metadata.name) for rb in rbs]
        assert all(rb.spec.clusters for rb in fresh)
        rvs = sorted(rb.metadata.resource_version for rb in fresh)
        assert rvs[-1] - rvs[0] == len(rvs) - 1, rvs
        assert not s.store.list(s.m.sharding.KIND_SHARD_GANG_PROPOSAL,
                                s.m.sharding.SHARD_NAMESPACE)
    pair.teardown()


def test_cross_shard_gang_stale_rv_race_matches_reference():
    pair = Pair(2)
    gname, rbs = spanning_gang(2)
    pair.create(rbs)
    coord = REF.shards.shard_of_gang("default", gname, 2)
    for s in pair.sides:
        for _d, svc in s.stacks:
            svc.serve(quiescent=True)
        assert s.store.list(s.m.sharding.KIND_SHARD_GANG_PROPOSAL, s.m.sharding.SHARD_NAMESPACE)
    pair.check()  # the published proposals, entry for entry
    before = pair.metric_deltas(lambda s: s.metric("xshard_gang_commits", outcome="aborted"))
    for s in pair.sides:
        victim = s.binding(rbs[0].metadata.name)
        victim.metadata.labels = dict(victim.metadata.labels or {}, raced="yes")
        s.store.update(victim)
        assert s.stacks[coord][0].xshards.tick() == 1
        for rb in rbs:
            assert not s.binding(rb.metadata.name).spec.clusters, "partial gang reached the store"
    after = pair.metric_deltas(lambda s: s.metric("xshard_gang_commits", outcome="aborted"))
    assert [a - b for a, b in zip(after, before)] == [1.0, 1.0]
    pair.check()
    pair.drain()
    pair.check()
    for s in pair.sides:
        fresh = [s.binding(rb.metadata.name) for rb in rbs]
        assert all(rb.spec.clusters for rb in fresh)
        rvs = sorted(rb.metadata.resource_version for rb in fresh)
        assert rvs[-1] - rvs[0] == len(rvs) - 1
    pair.teardown()


def test_cross_shard_gang_timeout_matches_reference():
    pair = Pair(2, gang_wait_seconds=5.0)
    gname, rbs = spanning_gang(2, size=3)
    pair.create(rbs[:2])  # only 2 of 3 members ever arrive
    pair.drain()
    pair.check()
    before = pair.metric_deltas(lambda s: s.metric("xshard_gang_commits", outcome="timeout"))
    for s in pair.sides:
        s.clock.advance(6.0)
    pair.drain()
    pair.check()
    after = pair.metric_deltas(lambda s: s.metric("xshard_gang_commits", outcome="timeout"))
    assert [a - b for a, b in zip(after, before)] == [1.0, 1.0]
    for s in pair.sides:
        for rb in rbs[:2]:
            cur = s.binding(rb.metadata.name)
            assert not cur.spec.clusters
            cond = {c.type: c for c in cur.status.conditions}[s.m.work.CONDITION_SCHEDULED]
            assert cond.status == "False" and cond.reason == s.m.work.REASON_GANG_TIMEOUT
    pair.teardown()


def test_cross_shard_gang_rejected_matches_reference():
    """A member that cannot place fully makes the cohort jointly
    infeasible: outcome `rejected`, Scheduled=False on every member."""
    pair = Pair(2)
    before = pair.metric_deltas(lambda s: s.metric("xshard_gang_commits", outcome="rejected"))
    gname, rbs = spanning_gang(2, size=3)
    rbs[1].spec.replica_requirements.resource_request = {"cpu": 10_000.0}
    pair.create(rbs)
    pair.drain()
    pair.check()
    after = pair.metric_deltas(lambda s: s.metric("xshard_gang_commits", outcome="rejected"))
    # the Scheduled=False writes re-admit the members once more, as in the
    # reference: the cohort is rejected again and the conditions stand
    deltas = [a - b for a, b in zip(after, before)]
    assert deltas[0] == deltas[1] >= 1.0, deltas
    for s in pair.sides:
        for rb in rbs:
            cur = s.binding(rb.metadata.name)
            assert not cur.spec.clusters
            cond = {c.type: c for c in cur.status.conditions}[s.m.work.CONDITION_SCHEDULED]
            assert cond.status == "False"
    pair.teardown()


def test_status_surface_matches_reference():
    pair = Pair(2)
    pair.create([make_binding(f"st-{i}", 2, dyn_placement(), cpu=0.1) for i in range(6)])
    pair.drain()
    for s in pair.sides:
        for i, (d, _s) in enumerate(s.stacks):
            d.publish_status(leader=f"me-{i}", token=7 + i, force=True)
    pair.check()  # the SchedulerShard objects, field for field
    for s in pair.sides:
        objs = s.store.list("SchedulerShard", s.m.sharding.SHARD_NAMESPACE)
        assert len(objs) == 2
        assert sum(o.status.bindings for o in objs) == 6
        d = s.stacks[0][0]
        assert s.metric("shard_bindings", shard="0") == float(d.owned_count())
        d.retire_status()
        key = s.m.metrics._label_key({"shard": "0"})
        assert key not in s.m.metrics.shard_bindings._values
        assert key not in s.m.metrics.shard_queue_depth._values
        assert len(s.store.list("SchedulerShard", s.m.sharding.SHARD_NAMESPACE)) == 1
    pair.check()
    pair.teardown()


# ---------------------------------------------------------------------------
# the port alone: threads on the wall clock
# ---------------------------------------------------------------------------


def _port_store(n=N_CLUSTERS):
    store = PORT.store.Store()
    for c in conv(synthetic_fleet(n, seed=9)):
        store.create(c)
    return store


def test_leader_kill_successor_places_in_flight_exactly_once():
    """The reference's TestLeaderKill on the port: kill the shard leader
    mid-stream without releasing its lease; the successor takes the
    expired lease and places the rest, each binding exactly once."""
    from karmada_tpu_torch.api.sharding import shard_lease_name
    from karmada_tpu_torch.coordination.elector import Elector, LocalLeaseClient
    from karmada_tpu_torch.coordination.lease import LeaseCoordinator

    store = _port_store()
    log = _PlacementLog(store)

    def contender(identity, leading):
        daemon = PORT.shards.ShardedDaemon(store, PORT.controller.Runtime(), 0, 1,
                                           aot_prewarm=False, device="cpu")
        service = daemon.streaming(batch_delay=0.0)
        elector = Elector(
            LocalLeaseClient(LeaseCoordinator(store)), shard_lease_name(0), identity,
            lease_duration=0.6,
            on_started_leading=lambda t: (daemon.xshards.start(), daemon.relist(),
                                          leading.set()),
            on_stopped_leading=lambda r: (leading.clear(), daemon.xshards.stop()),
        )
        return daemon, service, elector

    a_lead, b_lead = threading.Event(), threading.Event()
    a_d, a_svc, a_el = contender("leader-a", a_lead)
    b_d, b_svc, b_el = contender("leader-b", b_lead)
    done = threading.Event()
    threads = []

    def serve(svc, lead):
        def run():
            while not done.is_set():
                if lead.is_set():
                    try:
                        svc.serve(should_stop=lambda: not lead.is_set() or done.is_set())
                    except Exception:  # noqa: BLE001 - asserted on state below
                        pass
                else:
                    time.sleep(0.01)
        t = threading.Thread(target=run, daemon=True)
        threads.append(t)
        t.start()

    before = PORT.metrics.shard_handoffs.value(reason="takeover")
    a_el.step()
    a_el.run()
    assert a_lead.wait(5.0), "first contender must lead"
    b_el.step()
    b_el.run()
    assert not b_lead.is_set()
    serve(a_svc, a_lead)
    serve(b_svc, b_lead)
    n = 30
    for i in range(n):
        store.create(conv(make_binding(f"kill-{i}", 2, dyn_placement(), cpu=0.2)))
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline and sum(log.commits.values()) < 1:
        time.sleep(0.005)
    a_el.stop(release=False)
    a_lead.clear()
    a_svc.stop()
    assert b_lead.wait(10.0), "successor must take the expired lease"
    deadline = time.monotonic() + 25.0
    while time.monotonic() < deadline:
        if sum(1 for rb in store.list("ResourceBinding") if rb.spec.clusters) == n:
            break
        time.sleep(0.02)
    done.set()
    b_svc.stop()
    b_el.stop(release=True)
    for t in threads:
        t.join(timeout=10.0)
    placed = [rb for rb in store.list("ResourceBinding") if rb.spec.clusters]
    assert len(placed) == n, f"only {len(placed)}/{n} placed"
    assert not log.doubles(), log.doubles()
    assert PORT.metrics.shard_handoffs.value(reason="takeover") >= before + float(n)
    a_d.detach()
    b_d.detach()


def test_fairness_budget_caps_concurrent_legs_per_cluster():
    budget = PORT.fairness.ClusterFairnessBudget(limit=2)
    assert budget.limit == REF.fairness.ClusterFairnessBudget(limit=2).limit
    assert PORT.fairness.DEFAULT_PER_CLUSTER == REF.fairness.DEFAULT_PER_CLUSTER
    acquired, errs = [], []
    start = threading.Barrier(4)

    def leg():
        try:
            start.wait(timeout=5.0)
            with budget.leg("m1"):
                acquired.append(time.monotonic())
                time.sleep(0.15)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=leg) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10.0)
    assert not errs and len(acquired) == 4
    acquired.sort()
    assert acquired[2] - acquired[0] > 0.1
    assert budget.waits >= 1
    with budget.leg("m2"):
        pass
    budget.forget("m1")
    assert "m1" not in budget._sems


class _CountingBudget:
    """A fairness budget that records every leg it grants."""

    def __init__(self):
        self.legs = []
        self._lock = threading.Lock()

    def leg(self, cluster):
        import contextlib

        with self._lock:
            self.legs.append(cluster)
        return contextlib.nullcontext()


def test_member_estimators_fairness_holds_legs_on_the_host_route_only():
    """`MemberEstimators.fairness`: the guarded per-cluster host route
    holds one leg per cluster it asks, as the reference's does; the fleet
    route is one launch and takes none. The answers and the legs are the
    reference's."""
    import numpy as np

    from karmada_tpu import faults as jfaults
    from karmada_tpu.estimator import client as jclient
    from tests.test_torch_estimator import _members, _requirements

    from karmada_tpu_torch import faults as tfaults
    from karmada_tpu_torch.estimator import client as tclient

    jm, tm, names = _members()
    reqs = [r for r in _requirements() if r is None or r.node_claim is None]
    j = jclient.MemberEstimators(jm)
    t = tclient.MemberEstimators(tm, device="cpu")
    assert t.fairness is None and j.fairness is None
    j.fairness, t.fairness = _CountingBudget(), _CountingBudget()
    try:
        np.testing.assert_array_equal(t.max_available_replicas_rows(names, conv(reqs)),
                                      np.asarray(j.max_available_replicas_rows(names, reqs)))
        assert t.fairness.legs == [] and j.fairness.legs == []
        j.breakers, t.breakers = (jfaults.BreakerRegistry(failure_threshold=1),
                                  tfaults.BreakerRegistry(failure_threshold=1))
        for br in (j.breakers.for_member(names[2]), t.breakers.for_member(names[2])):
            br.record_failure()  # a breaker not at rest: the host route
        np.testing.assert_array_equal(t.max_available_replicas_rows(names, conv(reqs)),
                                      np.asarray(j.max_available_replicas_rows(names, reqs)))
        assert t.fairness.legs and sorted(t.fairness.legs) == sorted(j.fairness.legs)
        assert names[2] not in t.fairness.legs
    finally:
        t.close()


def _plane_inputs(n_clusters=12, n_bindings=48):
    clusters = synthetic_fleet(n_clusters, seed=4)
    bindings = [make_binding(f"pl-{i}", 1 + i % 4, dyn_placement(aggregated=i % 3 == 0),
                             cpu=0.1 + 0.05 * (i % 5)) for i in range(n_bindings)]
    return clusters, bindings


def _direct_targets(clusters, bindings):
    """The reference's direct round over the same fleet: each binding's
    targets (the stores hold no cluster status writes, so each row's
    decision is independent of the rest of its batch)."""
    from karmada_tpu.sched.core import ArrayScheduler

    ref = ArrayScheduler(sorted(clusters, key=lambda c: c.name))
    return {rb.metadata.key(): tuple(sorted((t.name, t.replicas) for t in d.targets))
            for rb, d in zip(bindings, ref.schedule(bindings))}


class _EpochPatches:
    """Scheduled patches by (binding key, admission epoch): a store watch
    counting each write that lands a placement, keyed by the spec
    generation the scheduler observed."""

    def __init__(self, store):
        self.by_key: dict = {}
        self._last: dict = {}
        self._lock = threading.Lock()
        store.watch("ResourceBinding", self._on_event, replay=True)

    def _on_event(self, event, rb):
        placed = tuple(sorted((t.name, t.replicas) for t in rb.spec.clusters))
        key = rb.metadata.key()
        with self._lock:
            if placed and self._last.get(key) != placed:
                k = (key, rb.status.scheduler_observed_generation)
                self.by_key[k] = self.by_key.get(k, 0) + 1
            self._last[key] = placed


def test_shard_plane_places_resizes_and_publishes_on_the_cpu():
    """`ShardPlane(store, 3, elect=True, device="cpu")`: leaders on
    in-process leases, every binding placed as the reference's direct
    round places it, once; a resize to 2 with a second wave in flight,
    `quiesce`, the status objects' owned counts summing to the bindings;
    `close` retires every row."""
    clusters, bindings = _plane_inputs()
    store = PORT.store.Store()
    for c in conv(clusters):
        store.create(c)
    patches = _EpochPatches(store)
    plane = PORT.shards.ShardPlane(store, 3, elect=True, lease_duration=5.0, device="cpu",
                                   batch_delay=0.0)
    assert all(s.stream is None for s in plane.stacks)
    plane.start()
    try:
        assert plane.wait_leading(10.0)
        for rb in conv(bindings[:24]):
            store.create(rb)
        assert plane.quiesce(30.0)
        for rb in conv(bindings[24:]):
            store.create(rb)
        moved = plane.resize(2)
        assert moved > 0 and len(plane.stacks) == 2
        assert plane.quiesce(30.0)
        deadline = time.monotonic() + 10.0
        want = _direct_targets(clusters, bindings)
        while time.monotonic() < deadline:
            got = {rb.metadata.key(): tuple(sorted((t.name, t.replicas)
                                                   for t in rb.spec.clusters))
                   for rb in store.list("ResourceBinding")}
            if got == want:
                break
            time.sleep(0.05)
        assert got == want
        assert all(n == 1 for n in patches.by_key.values()), patches.by_key
        for s in plane.stacks:
            s.daemon.publish_status(leader=s.elector.identity, token=s.token, force=True)
        objs = store.list("SchedulerShard", PORT.sharding.SHARD_NAMESPACE)
        assert sorted(o.metadata.name for o in objs) == ["scheduler-shard-0",
                                                         "scheduler-shard-1"]
        assert sum(o.status.bindings for o in objs) == len(bindings)
        assert all(o.status.shards_total == 2 and o.status.leader for o in objs)
        stats = plane.stats()
        assert sorted(stats) == [0, 1]
    finally:
        plane.close()
    assert not store.list("SchedulerShard", PORT.sharding.SHARD_NAMESPACE)


def test_shard_plane_default_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT.shards.ShardPlane(_port_store(), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT.shards.ShardedDaemon(_port_store(), PORT.controller.Runtime(), 0, 2)
