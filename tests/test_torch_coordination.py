"""The port's coordination plane held against the JAX package's on the CPU:
lease CAS and fencing tokens (`LeaseCoordinator`), the elector's state
machine (`Elector`), fenced writes over the serving wire, and the
in-process twin of the reference's scheduler failover harness.

Every scenario runs in both packages over a stepped `Clock` (the port's
`MiniPlane` holding each package's store and coordinator on a fixed
clock, as the reference's `MiniPlane` does) and
driven by the elector's `step()`, never by wall-clock sleeps; the
observations (lease encodings, tokens, leadership callbacks, error types)
must be equal, and each also carries the reference test's own asserts.
The failover harness runs the port's `SchedulerDaemon` with
`device="cpu"` over `RemoteStore` against a `ControlPlaneServer`: its
placements after a mid-run kill equal a single daemon's, and equal the
reference harness's on the same fixtures (explicit uids, so ties match).
"""
from __future__ import annotations

import importlib
import json
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from karmada_tpu_torch.testing.daemon import MiniPlane  # noqa: E402

PKGS = ("karmada_tpu", "karmada_tpu_torch")
NAME = "karmada-scheduler"


def _mods(pkg: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg, coordination=imp("coordination"), api=imp("api.coordination"),
        meta=imp("api.meta"), work=imp("api.work"), store=imp("store.store"),
        controller=imp("runtime.controller"), apiserver=imp("server.apiserver"),
        remote=imp("server.remote"), codec=imp("server.codec"),
        fixtures=imp("testing.fixtures"), metrics=imp("metrics"),
    )


M = {pkg: _mods(pkg) for pkg in PKGS}


def wait_until(pred, timeout=60.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def mini_plane(pkg: str = "karmada_tpu_torch") -> MiniPlane:
    """The port's MiniPlane (testing/daemon.py) holding either package's
    store and lease coordinator on a fixed clock: what the
    serving/coordination seam needs, without a ControlPlane
    (tests/test_coordination.py's `MiniPlane`)."""
    m = M[pkg]
    return MiniPlane(m.controller.Clock(fixed=10_000.0), store=m.store.Store(),
                     coordinator=m.coordination.LeaseCoordinator)


def enc(m, obj) -> str:
    """A lease's encoding without its wall-clock creation stamp."""
    e = m.codec.encode(obj)
    e["metadata"].pop("creation_timestamp", None)
    e["metadata"].pop("uid", None)
    return json.dumps(e)


def run_both(scenario):
    """Run scenario(m) in each package; both observation lists must be
    equal. Returns the port's."""
    ref, port = (scenario(M[pkg]) for pkg in PKGS)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# LeaseCoordinator CAS semantics (twins of TestLeaseCoordinator)
# ---------------------------------------------------------------------------


def coordinator(m):
    clock = m.controller.Clock(fixed=1000.0)
    store = m.store.Store()
    return clock, store, m.coordination.LeaseCoordinator(store, clock)


def err_name(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the observation
        return type(e).__name__
    return None


class TestLeaseCoordinator:
    def test_first_acquire_mints_token_one(self):
        def s(m):
            _, _, c = coordinator(m)
            lease, ok = c.acquire(NAME, "a", 10.0)
            return [ok, enc(m, lease)]

        ok, lease = run_both(s)
        spec = json.loads(lease)["spec"]
        assert ok and spec["fencing_token"] == 1 and spec["holder_identity"] == "a"
        assert json.loads(lease)["metadata"]["namespace"] == "karmada-system"

    def test_live_lease_is_not_stolen_and_holder_renews(self):
        def s(m):
            clock, _, c = coordinator(m)
            l1, _ = c.acquire(NAME, "a", 10.0)
            stolen = c.acquire(NAME, "b", 10.0)
            clock.advance(5.0)
            l2, ok = c.acquire(NAME, "a", 10.0)
            return [stolen[1], stolen[0].spec.holder_identity, ok,
                    l2.spec.fencing_token, l2.spec.renew_time > l1.spec.renew_time]

        assert run_both(s) == [False, "a", True, 1, True]

    def test_expired_takeover_bumps_token_and_transitions(self):
        def s(m):
            clock, _, c = coordinator(m)
            c.acquire(NAME, "a", 10.0)
            clock.advance(10.1)
            lease, ok = c.acquire(NAME, "b", 10.0)
            clock.advance(10.1)
            again, ok2 = c.acquire(NAME, "b", 10.0)  # own expired lease
            return [ok, enc(m, lease), ok2, enc(m, again)]

        ok, lease, ok2, again = run_both(s)
        assert ok and ok2
        assert json.loads(lease)["spec"]["fencing_token"] == 2
        assert json.loads(lease)["spec"]["lease_transitions"] == 1
        assert json.loads(again)["spec"]["fencing_token"] == 3
        assert json.loads(again)["spec"]["lease_transitions"] == 1

    def test_renew_and_release_rules(self):
        def s(m):
            clock, store, c = coordinator(m)
            c.acquire(NAME, "a", 10.0)
            clock.advance(10.1)
            out = [err_name(lambda: c.renew(NAME, "a", 1))]  # past TTL
            c.acquire(NAME, "b", 10.0)
            out.append(err_name(lambda: c.renew(NAME, "a", 1)))  # deposed
            c.release(NAME, "a", 1)  # stale: no-op
            out.append(store.get("LeaderLease", NAME, "karmada-system")
                       .spec.holder_identity)
            c.release(NAME, "b", 2)
            out.append(store.get("LeaderLease", NAME, "karmada-system")
                       .spec.holder_identity)
            lease, ok = c.acquire(NAME, "c", 10.0)
            out += [ok, lease.spec.fencing_token]
            out.append(err_name(lambda: c.renew(NAME, "ghost", 3)))
            out.append(err_name(lambda: c.renew("no-such-lease", "c", 3)))
            return out

        assert run_both(s) == ["StaleLeaseError", "StaleLeaseError", "b", "", True, 3,
                               "StaleLeaseError", "StaleLeaseError"]

    def test_check_fence(self):
        def s(m):
            clock, _, c = coordinator(m)
            c.acquire(NAME, "a", 10.0)
            out = [err_name(lambda: c.check_fence(NAME, 1)),
                   err_name(lambda: c.check_fence(NAME, 0)),
                   err_name(lambda: c.check_fence("unknown-lease", 1))]
            clock.advance(10.1)
            c.acquire(NAME, "b", 10.0)
            out += [err_name(lambda: c.check_fence(NAME, 1)),
                    err_name(lambda: c.check_fence(NAME, 2))]
            try:
                c.check_fence(NAME, 1)
            except Exception as e:  # noqa: BLE001
                out.append(str(e))
            return out

        out = run_both(s)
        assert out[:5] == [None, "FencingError", "FencingError", "FencingError", None]
        assert "stale token 1" in out[5]

    def test_racing_acquires_single_winner(self):
        m = M["karmada_tpu_torch"]
        _, store, c = coordinator(m)
        results: list[tuple[str, bool]] = []
        lock = threading.Lock()
        barrier = threading.Barrier(8)

        def contend(identity: str) -> None:
            barrier.wait()
            _, ok = c.acquire(NAME, identity, 30.0)
            with lock:
                results.append((identity, ok))

        threads = [threading.Thread(target=contend, args=(f"cand-{i}",))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        winners = [i for i, ok in results if ok]
        assert len(results) == 8 and len(winners) == 1
        lease = store.get("LeaderLease", NAME, "karmada-system")
        assert lease.spec.holder_identity == winners[0]
        assert lease.spec.fencing_token == 1

    def test_fence_header_round_trip_matches_reference(self):
        for pkg in PKGS:
            lease = M[pkg].coordination
            assert lease.format_fence_header(NAME, 7) == "karmada-system/karmada-scheduler:7"
            assert lease.parse_fence_header("karmada-system/x:3") == \
                ("karmada-system", "x", 3)
            assert lease.parse_fence_header("x:3") == ("karmada-system", "x", 3)
            assert lease.parse_fence_header("  ") is None
            with pytest.raises(ValueError):
                lease.parse_fence_header("not-a-fence")


# ---------------------------------------------------------------------------
# Elector state machine (twins of TestElector; injected clocks)
# ---------------------------------------------------------------------------


class Electors:
    def __init__(self, m):
        self.m = m
        self.clock = m.controller.Clock(fixed=1000.0)
        self.store = m.store.Store()
        self.client = m.coordination.LocalLeaseClient(
            m.coordination.LeaseCoordinator(self.store, self.clock))
        self.events: list[tuple] = []

    def elector(self, identity: str, **kw):
        return self.m.coordination.Elector(
            self.client, NAME, identity, lease_duration=10.0,
            on_started_leading=lambda t: self.events.append(("start", identity, t)),
            on_stopped_leading=lambda r: self.events.append(("stop", identity)),
            **kw)


class TestElector:
    def test_one_leader_standby_promoted_within_ttl(self):
        def s(m):
            e = Electors(m)
            a, b = e.elector("a"), e.elector("b")
            out = [a.step(), b.step(), a.token, b.token]
            e.clock.advance(10.1)
            out += [b.step(), b.token, a.step()]
            return out + [e.events]

        out = run_both(s)
        assert out[:7] == [True, False, 1, 0, True, 2, False]
        assert out[7] == [("start", "a", 1), ("start", "b", 2), ("stop", "a")]

    def test_leader_renews_and_keeps_token(self):
        def s(m):
            e = Electors(m)
            a = e.elector("a")
            a.step()
            out = []
            for _ in range(5):
                e.clock.advance(3.0)
                out.append(a.step())
            return out + [a.token]

        assert run_both(s) == [True] * 5 + [1]

    def test_voluntary_stop_releases_for_instant_takeover(self):
        def s(m):
            e = Electors(m)
            a, b = e.elector("a"), e.elector("b")
            a.step()
            a.stop(release=True)
            return [b.step(), b.token, e.events]

        assert run_both(s) == [True, 2, [("start", "a", 1), ("stop", "a"),
                                         ("start", "b", 2)]]

    def test_transport_failure_demotes_only_after_ttl(self):
        def s(m):
            e = Electors(m)

            class FlakyClient:
                def __init__(self, inner):
                    self.inner = inner
                    self.down = False

                def acquire_lease(self, *a, **k):
                    if self.down:
                        raise OSError("plane unreachable")
                    return self.inner.acquire_lease(*a, **k)

                def renew_lease(self, *a, **k):
                    if self.down:
                        raise OSError("plane unreachable")
                    return self.inner.renew_lease(*a, **k)

                def release_lease(self, *a, **k):
                    self.inner.release_lease(*a, **k)

            flaky = FlakyClient(e.client)
            mono = [0.0]
            a = m.coordination.Elector(
                flaky, NAME, "a", lease_duration=10.0,
                on_stopped_leading=lambda r: e.events.append(("stop", "a")),
                monotonic=lambda: mono[0])
            out = [a.step()]
            flaky.down = True
            mono[0] = 5.0
            out.append(a.step())
            mono[0] = 10.5
            out.append(a.step())
            return out + [e.events]

        assert run_both(s) == [True, True, False, [("stop", "a")]]

    def test_leader_gauge_flips_on_transition(self):
        m = M["karmada_tpu_torch"]
        e = Electors(m)
        a = m.coordination.Elector(e.client, "gauge-lease", "a", lease_duration=10.0)
        b = m.coordination.Elector(e.client, "gauge-lease", "b", lease_duration=10.0)
        a.step()
        g = m.metrics.leader_election_is_leader
        assert g.value(lease="gauge-lease", identity="a") == 1.0
        e.clock.advance(10.5)
        b.step()
        a.step()
        assert g.value(lease="gauge-lease", identity="a") == 0.0
        assert g.value(lease="gauge-lease", identity="b") == 1.0
        assert "karmada_leader_election_transitions_total" in m.metrics.registry.render()


# ---------------------------------------------------------------------------
# fencing end to end over the wire (twins of TestFencedWrites)
# ---------------------------------------------------------------------------


def make_rb(m, name: str, replicas: int = 1, placement=None):
    w = m.work
    return w.ResourceBinding(
        metadata=m.meta.ObjectMeta(namespace="default", name=name, uid=f"rb-{name}"),
        spec=w.BindingSpec(
            resource=w.ObjectReference(api_version="apps/v1", kind="Deployment",
                                       namespace="default", name=name),
            replicas=replicas,
            replica_requirements=w.ReplicaRequirements(
                resource_request={m.meta.CPU: 0.1}),
            placement=placement,
        ),
    )


PAIRINGS = (
    ("karmada_tpu_torch", "karmada_tpu_torch"),
    ("karmada_tpu", "karmada_tpu_torch"),
    ("karmada_tpu_torch", "karmada_tpu"),
)


@pytest.fixture(params=PAIRINGS, ids=lambda p: f"{p[0]}-client/{p[1]}-server")
def wire(request):
    client_pkg, server_pkg = request.param
    cp = mini_plane(server_pkg)
    srv = M[server_pkg].apiserver.ControlPlaneServer(cp, token="tok")
    srv.start()
    stores = []

    def client():
        s = M[client_pkg].remote.RemoteStore(srv.url, token="tok")
        stores.append(s)
        return s

    yield SimpleNamespace(cp=cp, srv=srv, client=client, m=M[client_pkg])
    for s in stores:
        s.close()
    srv.stop()


class TestFencedWrites:
    def test_paused_leader_resumes_renew_409_and_write_409(self, wire):
        m = wire.m
        old = wire.client()
        lease, ok = old.acquire_lease(NAME, "old", 10.0)
        assert ok
        old.set_fence(NAME, lease.spec.fencing_token)
        old.create(make_rb(m, "web"))
        wire.cp.clock.advance(10.5)
        new = wire.client()
        l2, ok2 = new.acquire_lease(NAME, "new", 10.0)
        assert ok2 and l2.spec.fencing_token == 2
        rb = old.try_get("ResourceBinding", "web", "default")
        rb.spec.replicas = 99
        with pytest.raises(m.store.ConflictError, match="stale token"):
            old.update(rb)
        with pytest.raises(m.store.ConflictError):
            old.renew_lease(NAME, "old", 1)
        assert new.get("ResourceBinding", "web", "default").spec.replicas == 1
        # a cleared fence writes unfenced again
        old.clear_fence()
        rb.spec.replicas = 5
        assert old.update(rb).spec.replicas == 5

    def test_deposed_client_reenters_election_despite_stale_fence(self, wire):
        old = wire.client()
        lease, _ = old.acquire_lease(NAME, "old", 10.0)
        old.set_fence(NAME, lease.spec.fencing_token)
        wire.cp.clock.advance(10.5)
        new = wire.client()
        new.acquire_lease(NAME, "new", 10.0)
        _, ok3 = old.acquire_lease(NAME, "old", 10.0)
        assert not ok3
        new.release_lease(NAME, "new", 2)
        l4, ok4 = old.acquire_lease(NAME, "old", 10.0)
        assert ok4 and l4.spec.fencing_token == 3
        assert {x.metadata.name for x in old.elections()} == {NAME}

    def test_malformed_fence_header_is_400(self, wire):
        from urllib.error import HTTPError
        from urllib.request import Request, urlopen

        req = Request(wire.srv.url + "/objects",
                      data=json.dumps({"obj": None}).encode(), method="POST",
                      headers={"Authorization": "Bearer tok",
                               "Content-Type": "application/json",
                               "X-Karmada-Fencing": "not-a-fence"})
        with pytest.raises(HTTPError) as ei:
            urlopen(req, timeout=10)
        assert ei.value.code == 400

    def test_remote_elector_over_the_wire(self, wire):
        """The Elector's lease-client protocol through RemoteStore, stepped
        against the plane's fixed clock."""
        m = wire.m
        events = []
        a_store, b_store = wire.client(), wire.client()

        def elector(store, ident):
            return m.coordination.Elector(
                store, NAME, ident, lease_duration=10.0,
                on_started_leading=lambda t: (store.set_fence(NAME, t),
                                              events.append(("start", ident, t))),
                on_stopped_leading=lambda r: (store.clear_fence(),
                                              events.append(("stop", ident))))

        a, b = elector(a_store, "a"), elector(b_store, "b")
        assert a.step() and not b.step()
        wire.cp.clock.advance(10.5)
        assert b.step() and b.token == 2
        assert not a.step()
        assert events == [("start", "a", 1), ("start", "b", 2), ("stop", "a")]
        b.stop(release=True)
        assert a.step() and a.token == 3


# ---------------------------------------------------------------------------
# two scheduler daemons, one plane (the twin of SchedHarness /
# TestSchedulerFailoverParity)
# ---------------------------------------------------------------------------


class SchedHarness:
    """Everything `python -m karmada_tpu_torch.sched` wires (RemoteStore
    watches, SchedulerDaemon, the elector with the fencing callbacks), in
    process so the clock is injectable and a kill is 'stop stepping'."""

    def __init__(self, pkg: str, url: str, identity: str):
        m = M[pkg]
        self.identity = identity
        self.store = m.remote.RemoteStore(url, token="tok")
        self.runtime = m.controller.Runtime()
        sched = importlib.import_module(f"{pkg}.sched.scheduler")
        kw = {"device": "cpu"} if pkg == "karmada_tpu_torch" else {}
        self.daemon = sched.SchedulerDaemon(self.store, self.runtime, **kw)
        self.elector = m.coordination.Elector(
            self.store, NAME, identity, lease_duration=10.0,
            on_started_leading=lambda t: self.store.set_fence(NAME, t),
            on_stopped_leading=lambda r: self.store.clear_fence())

    def drive(self) -> bool:
        if self.elector.step():
            self.runtime.settle()
            return True
        self.daemon.prewarm()
        return False

    def close(self) -> None:
        self.store.close()


def _mk_cluster(m, name: str):
    GiB = 1024.0**3
    return m.fixtures.new_cluster_with_resource(
        name, {m.meta.CPU: 100.0, m.meta.MEMORY: 400 * GiB, "pods": 1000.0})


def _placements(store) -> dict:
    return {rb.metadata.name: tuple(sorted((t.name, t.replicas) for t in rb.spec.clusters))
            for rb in store.list("ResourceBinding", "default")}


def _churn(m, user, round_no: int) -> None:
    """One deterministic churn round: Duplicated bindings and a static
    split over the three clusters (explicit uids: the tie seeds match)."""
    f = m.fixtures
    for i in range(3):
        user.create(make_rb(m, f"app-r{round_no}-{i}", replicas=1 + i,
                            placement=f.duplicated_placement([])))
    user.create(make_rb(m, f"split-r{round_no}", replicas=5 + round_no,
                        placement=f.static_weight_placement({"m1": 1, "m2": 2, "m3": 1})))


def _run_epoch(m, harnesses, user, rounds):
    for r in rounds:
        _churn(m, user, r)

        def all_placed() -> bool:
            for h in harnesses:
                h.drive()
            return all(rb.spec.clusters for rb in user.list("ResourceBinding", "default"))

        assert wait_until(all_placed, timeout=60.0), f"round {r} never fully placed"


def solo_run(pkg: str, server_pkg: str) -> dict:
    m = M[pkg]
    cp = mini_plane(server_pkg)
    srv = M[server_pkg].apiserver.ControlPlaneServer(cp, token="tok")
    srv.start()
    user = m.remote.RemoteStore(srv.url, token="tok")
    solo = SchedHarness(pkg, srv.url, "solo_1")
    try:
        for name in ("m1", "m2", "m3"):
            user.create(_mk_cluster(m, name))
        _run_epoch(m, [solo], user, rounds=(1, 2, 3))
        return _placements(user)
    finally:
        solo.close()
        user.close()
        srv.stop()


class TestSchedulerFailoverParity:
    def test_two_daemons_equal_one_with_midrun_kill_and_reference(self):
        m = M["karmada_tpu_torch"]
        baseline = solo_run("karmada_tpu_torch", "karmada_tpu_torch")
        assert baseline and all(baseline.values())
        assert baseline == solo_run("karmada_tpu", "karmada_tpu")

        cp = mini_plane()
        srv = m.apiserver.ControlPlaneServer(cp, token="tok")
        srv.start()
        user = m.remote.RemoteStore(srv.url, token="tok")
        a = SchedHarness("karmada_tpu_torch", srv.url, "a_1")
        b = SchedHarness("karmada_tpu_torch", srv.url, "b_2")
        try:
            for name in ("m1", "m2", "m3"):
                user.create(_mk_cluster(m, name))
            _run_epoch(m, [a, b], user, rounds=(1,))
            leaders = [h for h in (a, b) if h.elector.is_leader]
            assert len(leaders) == 1
            leader = leaders[0]
            standby = b if leader is a else a
            old_token = leader.elector.token
            cp.clock.advance(10.5)  # the leader stops stepping: its TTL runs out
            assert standby.elector.step() is True
            assert standby.elector.token == old_token + 1
            _run_epoch(m, [standby], user, rounds=(2, 3))
            rb = leader.store.try_get("ResourceBinding", "app-r1-0", "default")
            rb.spec.replicas = 77
            with pytest.raises(m.store.ConflictError):
                leader.store.update(rb)
            assert _placements(user) == baseline
        finally:
            a.close()
            b.close()
            user.close()
            srv.stop()

    def test_port_daemon_against_a_reference_server(self):
        """The port's daemon over the port's RemoteStore, attached to a
        JAX-package ControlPlaneServer, places as the reference's own
        harness does."""
        assert solo_run("karmada_tpu_torch", "karmada_tpu") == \
            solo_run("karmada_tpu", "karmada_tpu")

    def test_standby_is_warm_before_promotion(self):
        m = M["karmada_tpu_torch"]
        cp = mini_plane()
        srv = m.apiserver.ControlPlaneServer(cp, token="tok")
        srv.start()
        user = m.remote.RemoteStore(srv.url, token="tok")
        a = SchedHarness("karmada_tpu_torch", srv.url, "a_1")
        b = SchedHarness("karmada_tpu_torch", srv.url, "b_2")
        try:
            for name in ("m1", "m2", "m3"):
                user.create(_mk_cluster(m, name))
            assert a.drive() is True

            def standby_warm() -> bool:
                b.drive()
                arr = b.daemon._array
                return arr is not None and arr.n_real_clusters == 3

            assert wait_until(standby_warm, timeout=30.0)
            assert b.elector.is_leader is False
        finally:
            a.close()
            b.close()
            user.close()
            srv.stop()


class TestMetricsSurfaces:
    def test_apiserver_metrics_route_same_auth_as_wire(self):
        from urllib.error import HTTPError
        from urllib.request import Request, urlopen

        m = M["karmada_tpu_torch"]
        srv = m.apiserver.ControlPlaneServer(mini_plane(), token="tok")
        srv.start()
        try:
            with pytest.raises(HTTPError) as ei:
                urlopen(Request(srv.url + "/metrics"), timeout=10)
            assert ei.value.code == 401
            resp = urlopen(Request(srv.url + "/metrics",
                                   headers={"Authorization": "Bearer tok"}), timeout=10)
            body = resp.read().decode()
            assert resp.headers["Content-Type"].startswith("text/plain")
            assert "karmada_leader_election_is_leader" in body
        finally:
            srv.stop()

    def test_daemon_metrics_server(self, tmp_path):
        from urllib.error import HTTPError
        from urllib.request import Request, urlopen

        from karmada_tpu_torch.server.metricsserver import (
            MetricsServer,
            start_metrics_server,
        )

        srv = MetricsServer(token="tok")
        port = srv.start()
        base = f"http://127.0.0.1:{port}"
        try:
            assert json.loads(urlopen(base + "/healthz", timeout=10).read()) == {"ok": True}
            with pytest.raises(HTTPError) as ei:
                urlopen(base + "/metrics", timeout=10)
            assert ei.value.code == 401
            body = urlopen(Request(base + "/metrics",
                                   headers={"Authorization": "Bearer tok"}),
                           timeout=10).read().decode()
            assert "karmada_leader_election_transitions_total" in body
            with pytest.raises(HTTPError) as ei:
                urlopen(Request(base + "/nope", headers={"Authorization": "Bearer tok"}),
                        timeout=10)
            assert ei.value.code == 404
        finally:
            srv.stop()
        # the scrape-token file is minted on first start and read after
        assert start_metrics_server(-1) is None
        f = tmp_path / "scrape"
        srv = start_metrics_server(0, token="tok", scrape_token_file=str(f))
        try:
            scrape = f.read_text().strip()
            assert scrape and srv._scrape_token == scrape
            body = urlopen(Request(srv.url, headers={"Authorization": f"Bearer {scrape}"}),
                           timeout=10).read().decode()
            assert "karmada_" in body
        finally:
            srv.stop()
