"""The port's serving seam held against the JAX package's on the CPU: the
object codec, the binary frame/delta codec, the watch cache, the event
loop, and `ControlPlaneServer` / `RemoteStore` across the wire both ways.

Every codec comparison is on bytes: the same seeded fixtures (built by the
JAX package's fixtures, carried over with `convert.from_reference_objects`)
encode to the same JSON in both packages, frames and delta frames are
byte-equal, and each package decodes the other's encoding. The cross-wire
cases run a JAX-package `RemoteStore` against a port `ControlPlaneServer`
and a port `RemoteStore` against a JAX-package server, besides port
against port, and hold the objects each side sees to equal encodings.
The negotiation and event-loop cases are twins of tests/test_wire.py's.
"""
from __future__ import annotations

import importlib
import json
import socket
import struct
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.server import codec as jcodec  # noqa: E402
from karmada_tpu.server import wirecodec as jwire  # noqa: E402

from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402
from karmada_tpu_torch.server import codec, wirecodec  # noqa: E402
from karmada_tpu_torch.server.apiserver import ControlPlaneServer  # noqa: E402
from karmada_tpu_torch.server.eventloop import WatchLoop  # noqa: E402
from karmada_tpu_torch.server.remote import RemoteStore  # noqa: E402
from karmada_tpu_torch.store.store import Store  # noqa: E402
from karmada_tpu_torch.store.watchcache import ContinueExpired, WatchCache  # noqa: E402
from karmada_tpu_torch.testing.daemon import MiniPlane  # noqa: E402

KIND = "v1/ConfigMap"
PKGS = ("karmada_tpu", "karmada_tpu_torch")
# (client package, server package): port against port, then each way across
PAIRINGS = (
    ("karmada_tpu_torch", "karmada_tpu_torch"),
    ("karmada_tpu", "karmada_tpu_torch"),
    ("karmada_tpu_torch", "karmada_tpu"),
)


def _mods(pkg: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg, codec=imp("server.codec"), wire=imp("server.wirecodec"),
        apiserver=imp("server.apiserver"), remote=imp("server.remote"),
        store=imp("store.store"), unstructured=imp("api.unstructured"),
    )


def dumps(enc) -> str:
    return json.dumps(enc, sort_keys=False)


def cm(name, ns="default", pkg="karmada_tpu_torch", **data):
    U = _mods(pkg).unstructured.Unstructured
    return U({
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": name, "namespace": ns},
        "data": {k: str(v) for k, v in data.items()} or {"v": "1"},
    })


def wait_until(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def stub_plane(pkg="karmada_tpu_torch") -> MiniPlane:
    """Minimal cp surface for ControlPlaneServer: the port's MiniPlane
    (testing/daemon.py) holding either package's Store and no lease
    coordinator (tests/test_wire.py's `_StubCP`)."""
    return MiniPlane(store=_mods(pkg).store.Store(), coordinator=None)


# ---------------------------------------------------------------------------
# seeded fixtures, built by the JAX package and carried across
# ---------------------------------------------------------------------------


def reference_fixtures() -> dict:
    """name -> a JAX-package object (or list): a synthetic fleet, bindings
    with each placement kind, a lease, an event, a manifest."""
    from karmada_tpu.api.coordination import LeaderLease, LeaderLeaseSpec
    from karmada_tpu.api.meta import CPU, ObjectMeta
    from karmada_tpu.events import Event
    from karmada_tpu.testing.fixtures import (
        duplicated_placement,
        static_weight_placement,
        synthetic_fleet,
    )
    from tests.test_parallel import dyn_placement, make_binding

    clusters = synthetic_fleet(6, seed=3)
    names = [c.name for c in clusters]
    bindings = [
        make_binding("rb-0", 3, duplicated_placement(names[:2]), cpu=0.5),
        make_binding("rb-1", 7, static_weight_placement({names[0]: 1, names[2]: 2}),
                     cpu=0.25),
        make_binding("rb-2", 9, dyn_placement(aggregated=False), cpu=1.0),
        make_binding("rb-3", 4, dyn_placement(aggregated=True), cpu=0.1),
    ]
    lease = LeaderLease(
        metadata=ObjectMeta(name="karmada-scheduler", namespace="karmada-system"),
        spec=LeaderLeaseSpec(holder_identity="a_1", lease_duration_seconds=3.0,
                             acquire_time=10.0, renew_time=11.5,
                             lease_transitions=2, fencing_token=7),
    )
    event = Event(metadata=ObjectMeta(name="ev-1", namespace="default"),
                  reason="Scheduled", message="ok " + CPU)
    manifest = cm("m0", pkg="karmada_tpu", v=3)
    return {"clusters": clusters, "bindings": bindings, "lease": lease,
            "event": event, "manifest": manifest}


REF_FIXTURES = ("clusters", "bindings", "lease", "event", "manifest")


# ---------------------------------------------------------------------------
# the object codec
# ---------------------------------------------------------------------------

SHARED_TAGS = sorted(set(codec._registry) & set(jcodec._registry))
REF_ONLY_TAGS = sorted(set(jcodec._registry) - set(codec._registry))


class TestCodecParity:
    def test_port_registers_no_tag_the_reference_lacks(self):
        assert set(codec._registry) <= set(jcodec._registry)
        for tag in ("work.ResourceBinding", "cluster.Cluster",
                    "coordination.LeaderLease", "events.Event",
                    "nodes.NodeSpec", "policy.PropagationPolicy"):
            assert tag in codec._registry

    @pytest.mark.parametrize("tag", SHARED_TAGS)
    def test_default_instances_encode_the_same(self, tag):
        """Every kind both packages have: a default-constructed reference
        instance, carried across, encodes to the same bytes; each package
        decodes the other's bytes back to them."""
        cls = jcodec._registry[tag]
        ref = cls(name="n0") if tag == "nodes.NodeSpec" else cls()
        port = conv(ref)
        assert type(port) is codec._registry[tag]
        want = dumps(jcodec.encode(ref))
        assert dumps(codec.encode(port)) == want
        assert dumps(codec.encode(codec.decode(json.loads(want)))) == want
        assert dumps(jcodec.encode(jcodec.decode(json.loads(want)))) == want

    @pytest.mark.parametrize("name", REF_FIXTURES)
    def test_fixture_objects_encode_the_same(self, name):
        ref = reference_fixtures()[name]
        port = conv(ref)
        want = dumps(jcodec.encode(ref))
        assert dumps(codec.encode(port)) == want
        back = codec.decode(json.loads(want))
        assert dumps(codec.encode(back)) == want
        assert dumps(jcodec.encode(jcodec.decode(
            json.loads(dumps(codec.encode(port)))))) == want

    @pytest.mark.parametrize("tag", REF_ONLY_TAGS)
    def test_unported_tags_raise_naming_their_item(self, tag):
        """A reference kind the port lacks never decodes to something else
        (an Unstructured, a dict): the decode raises naming its queue
        item."""
        with pytest.raises(TypeError, match=r"ROADMAP queue A item 1[02]"):
            codec.decode({"__t": tag, "metadata": {}})

    def test_agent_lease_and_member_config_name_item_12(self):
        for tag in ("agent.Lease", "member.MemberConfig"):
            with pytest.raises(TypeError, match="queue A item 12"):
                codec.decode({"__t": tag})
        with pytest.raises(TypeError, match="unknown wire type"):
            codec.decode({"__t": "nowhere.Nothing"})


# ---------------------------------------------------------------------------
# frames, messages, diffs (twins of TestFrameCodec / TestDiffPatch)
# ---------------------------------------------------------------------------

FRAMES = [
    (wirecodec.FRAME_HEARTBEAT, b""),
    (wirecodec.FRAME_EVENT, b'{"rv": 1}'),
    (wirecodec.FRAME_DELTA, b'{"rv": 2, "patch": [0, null]}'),
    (wirecodec.FRAME_MESSAGE, b"\x78\x9c"),
]

DIFF_CASES = [
    ({"a": 1, "b": {"x": "1", "y": "2"}}, {"a": 1, "b": {"x": "9", "y": "2"}}),
    ({"a": 1, "b": 2}, {"a": 1}),
    ({"a": 1}, {"a": 1, "c": {"deep": [1, 2]}}),
    ({"l": [1, 2, 3]}, {"l": [1, 2, 3, 4]}),
    ({"s": "x"}, {"s": {"now": "a dict"}}),
    ({"same": {"deeply": {"nested": 1}}}, {"same": {"deeply": {"nested": 1}}}),
    ({}, {"fresh": True}),
]


class TestFrameCodec:
    def test_literals_match_reference(self):
        for name in ("CONTENT_TYPE_BIN", "CONTENT_TYPE_JSON_LINES", "WIRE_MAGIC",
                     "WIRE_VERSION", "HEADER_WIRE", "FRAME_HEARTBEAT", "FRAME_EVENT",
                     "FRAME_DELTA", "FRAME_MESSAGE", "HEADER_LEN", "MAX_FRAME_BYTES",
                     "OP_REPLACE", "OP_MERGE", "HEARTBEAT_FRAME"):
            assert getattr(wirecodec, name) == getattr(jwire, name), name

    def test_roundtrip_incremental_feed(self):
        stream = b"".join(wirecodec.pack_frame(t, p) for t, p in FRAMES)
        assert stream == b"".join(jwire.pack_frame(t, p) for t, p in FRAMES)
        reader = wirecodec.FrameReader()
        assert list(reader.feed(stream)) == FRAMES
        reader = wirecodec.FrameReader()
        got = []
        for i in range(len(stream)):
            got.extend(reader.feed(stream[i:i + 1]))
        assert got == FRAMES

    def test_bad_magic_rejected(self):
        with pytest.raises(wirecodec.WireProtocolError):
            list(wirecodec.FrameReader().feed(b"XX\x01\x00\x00\x00\x00\x00"))

    def test_oversize_frame_rejected(self):
        hdr = struct.pack("!2sBBI", wirecodec.WIRE_MAGIC, wirecodec.WIRE_VERSION,
                          wirecodec.FRAME_EVENT, wirecodec.MAX_FRAME_BYTES + 1)
        with pytest.raises(wirecodec.WireProtocolError):
            list(wirecodec.FrameReader().feed(hdr))

    def test_message_roundtrip_and_garbage_rejected(self):
        body = {"op": "append", "entries": [{"rv": 7, "x": "y" * 500}]}
        packed = wirecodec.pack_message(body)
        assert packed == jwire.pack_message(body)
        assert wirecodec.unpack_message(packed) == body
        assert jwire.unpack_message(packed) == body
        assert len(packed) < len(json.dumps(body))
        with pytest.raises(wirecodec.WireProtocolError):
            wirecodec.unpack_message(b"not a frame at all")

    def test_negotiation_helpers_match_reference(self):
        for accept in (None, "", "application/json", wirecodec.CONTENT_TYPE_BIN,
                       "text/plain, " + wirecodec.CONTENT_TYPE_BIN + ";q=0.9"):
            assert wirecodec.accepts_binary(accept) == jwire.accepts_binary(accept)
        for code in (400, 404, 409, 415, 422, 500):
            for msg in ("wire codec: bad magic", "kind required", ""):
                assert (wirecodec.body_rejected(code, msg)
                        == jwire.body_rejected(code, msg))


class TestDiffPatch:
    @pytest.mark.parametrize("i", range(len(DIFF_CASES)))
    def test_diff_and_apply_match_reference(self, i):
        base, new = DIFF_CASES[i]
        patch = wirecodec.diff(base, new)
        assert patch == jwire.diff(base, new)
        applied = wirecodec.apply_patch(base, patch)
        assert wirecodec.canonical(applied) == wirecodec.canonical(new)
        assert wirecodec.canonical(new) == jwire.canonical(new)

    def test_small_change_patches_smaller_than_full(self):
        base = {"metadata": {"name": "n", "labels": {"k": "v"}},
                "data": {"pad": "x" * 400, "t": "0"}}
        new = json.loads(json.dumps(base))
        new["data"]["t"] = "1"
        patch = wirecodec.diff(base, new)
        assert len(json.dumps(patch)) < len(json.dumps(new)) / 4

    def test_event_and_delta_frames_match_reference(self):
        ref = reference_fixtures()["bindings"][1]
        enc = jcodec.encode(ref)
        assert enc == codec.encode(conv(ref))
        new = json.loads(json.dumps(enc))
        new["spec"]["replicas"] = 11
        patch = wirecodec.diff(enc, new)
        assert (wirecodec.event_frame("work.ResourceBinding", "MODIFIED", 9, new)
                == jwire.event_frame("work.ResourceBinding", "MODIFIED", 9, new))
        got = wirecodec.delta_frame("ResourceBinding", "MODIFIED", 9, "default",
                                    ref.metadata.name, 8, patch)
        assert got == jwire.delta_frame("ResourceBinding", "MODIFIED", 9, "default",
                                        ref.metadata.name, 8, patch)
        (ftype, payload), = wirecodec.FrameReader().feed(got)
        msg = json.loads(payload)
        assert ftype == wirecodec.FRAME_DELTA and msg["base"] == 8
        assert wirecodec.canonical(wirecodec.apply_patch(enc, msg["patch"])) == \
            wirecodec.canonical(new)


# ---------------------------------------------------------------------------
# the watch cache
# ---------------------------------------------------------------------------


class TestWatchCache:
    def test_resume_from_since_delivers_only_the_delta(self):
        store = Store()
        cache = WatchCache(store, capacity=64)
        cache.attach()
        for i in range(3):
            store.create(cm(f"a{i}"))
        mark = cache.current_rv
        store.update(cm("a1", v=2))
        store.create(cm("b0"))
        events, cursor, ok = cache.events_since(mark, KIND)
        assert ok and [(e.event, e.name) for e in events] == [
            ("MODIFIED", "a1"), ("ADDED", "b0")]
        assert cursor == cache.current_rv
        # the same writes through the reference cache over the reference
        # store give the same (event, name, rv) sequence and wire lines
        from karmada_tpu.store.store import Store as JStore
        from karmada_tpu.store.watchcache import WatchCache as JCache

        jstore = JStore()
        jcache = JCache(jstore, capacity=64)
        jcache.attach()
        for i in range(3):
            jstore.create(cm(f"a{i}", pkg="karmada_tpu"))
        jstore.update(cm("a1", pkg="karmada_tpu", v=2))
        jstore.create(cm("b0", pkg="karmada_tpu"))
        jev, _, _ = jcache.events_since(mark, KIND)

        def unstamped(payload: bytes) -> dict:
            # the stores stamp creation time from the wall clock and uids
            # from a process-wide counter: drop both before comparing
            msg = json.loads(payload)
            msg["obj"]["manifest"]["metadata"].pop("creationTimestamp")
            msg["obj"]["manifest"]["metadata"].pop("uid")
            return msg

        def frame_of(b: bytes):
            (ftype, payload), = wirecodec.FrameReader().feed(b)
            return ftype, unstamped(payload)

        for mine, theirs in zip(events, jev):
            assert unstamped(mine.line()) == unstamped(theirs.line())
            assert frame_of(mine.frame()) == frame_of(theirs.frame())
        assert len(events) == len(jev) == 2

    def test_compaction_refuses_resume(self):
        store = Store()
        cache = WatchCache(store, capacity=4)
        cache.attach()
        mark = cache.current_rv
        for i in range(10):
            store.create(cm(f"c{i}"))
        _, _, ok = cache.events_since(mark, KIND)
        assert not ok
        assert cache.compacted_rv > mark
        rv, items = cache.snapshot(KIND)
        assert rv == cache.current_rv and len(items) == 10

    def test_paginated_list_is_a_frozen_snapshot_and_expires(self):
        store = Store()
        cache = WatchCache(store, capacity=64, page_ttl=60.0)
        cache.attach()
        for i in range(5):
            store.create(cm(f"p{i}"))
        rv, items, token = cache.list_page(KIND, "", 2)
        assert len(items) == 2 and token
        store.create(cm("p9"))  # lands mid-crawl: not in this list
        seen = [it["manifest"]["metadata"]["name"] for it in items]
        while token:
            rv2, items, token = cache.list_page(KIND, "", 2, token)
            assert rv2 == rv
            seen += [it["manifest"]["metadata"]["name"] for it in items]
        assert seen == [f"p{i}" for i in range(5)]
        with pytest.raises(ContinueExpired):
            cache.list_page(KIND, "", 2, "999:2")
        with pytest.raises(ContinueExpired):
            cache.list_page(KIND, "", 2, "1:-2")

    def test_served_since_resume_over_the_wire(self):
        """GET /watch?since=<rv> on a port server resumes from the ring:
        only the events past rv arrive, no replay snapshot."""
        srv = ControlPlaneServer(stub_plane())
        srv.start()
        try:
            st = srv.cp.store
            for i in range(4):
                st.create(cm(f"s{i}"))
            mark = srv._watch_cache.current_rv
            st.update(cm("s2", v=9))
            s, tail, ctype = raw_attach(srv._port, accept=None, since=mark)
            try:
                lines = read_lines(s, tail, want=1)
            finally:
                s.close()
            assert [(m["event"], m["obj"]["manifest"]["metadata"]["name"])
                    for m in lines] == [("MODIFIED", "s2")]
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# ControlPlaneServer / RemoteStore across the wire, both ways
# ---------------------------------------------------------------------------


def raw_attach(port, kind=KIND, accept=None, replay=False, namespace=None,
               since=None, timeout_s=10.0):
    """Raw-socket watch attach: (socket, body bytes past the headers,
    response Content-Type)."""
    from urllib.parse import quote

    s = socket.create_connection(("127.0.0.1", port), timeout=timeout_s)
    req = (f"GET /watch?kind={quote(kind, safe='')}"
           f"&replay={'1' if replay else '0'}")
    if namespace:
        req += f"&namespace={quote(namespace, safe='')}"
    if since is not None:
        req += f"&since={since}"
    req += " HTTP/1.1\r\nHost: t\r\n"
    if accept:
        req += f"Accept: {accept}\r\n"
    req += "Connection: close\r\n\r\n"
    s.sendall(req.encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = s.recv(65536)
        if not chunk:
            raise RuntimeError("attach: closed during headers")
        buf += chunk
    head, _, body = buf.partition(b"\r\n\r\n")
    ctype = ""
    for line in head.decode("latin-1").split("\r\n")[1:]:
        if line.lower().startswith("content-type:"):
            ctype = line.split(":", 1)[1].strip()
    return s, body, ctype


def read_lines(sock, tail=b"", want=1, timeout_s=10.0):
    buf = tail
    out = []
    sock.settimeout(0.3)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and len(out) < want:
        while b"\n" in buf:
            line, _, buf = buf.partition(b"\n")
            if line.strip():
                out.append(json.loads(line))
        if len(out) >= want:
            break
        try:
            chunk = sock.recv(65536)
        except socket.timeout:
            continue
        if not chunk:
            break
        buf += chunk
    return out


def drain_frames(sock, tail=b"", quiet_s=0.3, timeout_s=10.0):
    """Read until the stream goes quiet; returns the parsed frame list."""
    reader = wirecodec.FrameReader()
    frames = list(reader.feed(tail)) if tail else []
    sock.settimeout(quiet_s)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            chunk = sock.recv(65536)
        except socket.timeout:
            break
        if not chunk:
            break
        frames.extend(reader.feed(chunk))
    return frames


class Wire:
    """A server of one package over a stub plane and clients of another."""

    def __init__(self, client_pkg: str, server_pkg: str, **client_kw):
        self.c = _mods(client_pkg)
        self.s = _mods(server_pkg)
        self.cp = stub_plane(server_pkg)
        self.srv = self.s.apiserver.ControlPlaneServer(self.cp)
        self.srv.start()
        self.clients = []
        self.client_kw = client_kw

    def client(self, **kw):
        rs = self.c.remote.RemoteStore(self.srv.url, **{**self.client_kw, **kw})
        self.clients.append(rs)
        return rs

    def objects(self, fixture: str):
        """The fixture in the client's package."""
        ref = reference_fixtures()[fixture]
        return ref if self.c.pkg == "karmada_tpu" else conv(ref)

    def same(self, client_obj, server_obj):
        """The client's decoded object and the server store's encode to the
        same bytes, each by its own package's codec."""
        assert dumps(self.c.codec.encode(client_obj)) == \
            dumps(self.s.codec.encode(server_obj))

    def close(self):
        for rs in self.clients:
            rs.close()
        self.srv.stop()


@pytest.fixture(params=PAIRINGS, ids=lambda p: f"{p[0]}-client/{p[1]}-server")
def wire(request):
    w = Wire(*request.param)
    yield w
    w.close()


class TestCrossWire:
    def test_crud_round_trips_equal_bytes(self, wire):
        rs = wire.client()
        clusters = wire.objects("clusters")
        bindings = wire.objects("bindings")
        for c in clusters:
            out = rs.create(c)
            wire.same(out, wire.cp.store.get("Cluster", c.name))
        for rb in bindings:
            out = rs.create(rb)
            wire.same(out, wire.cp.store.get("ResourceBinding", rb.metadata.name,
                                             rb.metadata.namespace))
        got = rs.get("ResourceBinding", bindings[2].metadata.name,
                     bindings[2].metadata.namespace)
        wire.same(got, wire.cp.store.get("ResourceBinding", bindings[2].metadata.name,
                                         bindings[2].metadata.namespace))
        got.spec.replicas = 99
        out = rs.update(got, check_rv=True)
        assert out.spec.replicas == 99
        with pytest.raises(wire.c.store.ConflictError):
            rs.update(got, check_rv=True)  # stale rv
        wire.same(rs.apply(wire.objects("lease")),
                  wire.cp.store.get("LeaderLease", "karmada-scheduler",
                                    "karmada-system"))
        rs.delete("Cluster", clusters[0].name)
        assert rs.try_get("Cluster", clusters[0].name) is None
        with pytest.raises(wire.c.store.NotFoundError):
            rs.get("Cluster", clusters[0].name)
        assert sorted(rs.kinds()) == sorted(wire.cp.store.kinds())

    def test_paginated_list_equals_server_store(self, wire):
        rs = wire.client(page_size=2)
        for c in wire.objects("clusters"):
            rs.create(c)
        listed = rs.list("Cluster")
        stored = wire.cp.store.list("Cluster")
        assert len(listed) == len(stored) == 6
        for a, b in zip(sorted(listed, key=lambda o: o.name),
                        sorted(stored, key=lambda o: o.name)):
            wire.same(a, b)

    def test_batch_ops_equal_bytes(self, wire):
        rs = wire.client()
        bindings = wire.objects("bindings")
        outs = rs.create_batch(bindings, chunk=3)
        assert [o.metadata.name for o in outs] == [b.metadata.name for b in bindings]
        keys = [(b.metadata.name, b.metadata.namespace) for b in bindings]
        got = rs.get_batch("ResourceBinding", keys + [("missing", "default")])
        assert got[-1] is None
        for a, (n, ns) in zip(got, keys):
            wire.same(a, wire.cp.store.get("ResourceBinding", n, ns))
        for o in got[:-1]:
            o.spec.replicas += 1
        ups = rs.update_batch(got[:-1], check_rv=True)
        assert [o.spec.replicas for o in ups] == [b.spec.replicas + 1 for b in bindings]
        # a stale slot skips under skip_stale instead of failing the batch
        skipped = rs.update_batch(got[:2], check_rv=True, skip_stale=True)
        assert skipped == [None, None]
        with pytest.raises(wire.c.store.BatchError):
            rs.create_batch(bindings[:1])  # already exists: typed results
        applied = rs.apply_batch(wire.objects("clusters"))
        assert len(applied) == 6

    @pytest.mark.parametrize("codec_pin", ["auto", "json"])
    def test_watch_delivers_every_event_in_rv_order(self, wire, codec_pin):
        writer = wire.client()
        watcher = wire.client(wire=codec_pin)
        seen = []
        lock = threading.Lock()

        def handler(ev, obj):
            with lock:
                seen.append((ev, obj.metadata.name,
                             int(obj.metadata.resource_version),
                             dumps(wire.c.codec.encode(obj))))

        bindings = wire.objects("bindings")
        writer.create(bindings[0])
        watcher.watch("ResourceBinding", handler, replay=True)
        assert wait_until(lambda: len(seen) >= 1)
        for rb in bindings[1:]:
            writer.create(rb)
        cur = writer.get("ResourceBinding", bindings[0].metadata.name,
                         bindings[0].metadata.namespace)
        for r in range(3):
            cur.spec.replicas = 20 + r
            cur = writer.update(cur)
        writer.delete("ResourceBinding", bindings[3].metadata.name,
                      bindings[3].metadata.namespace)
        assert wait_until(lambda: len(seen) >= 8)
        time.sleep(0.2)
        with lock:
            evs = [(e, n) for e, n, _, _ in seen]
            rvs = [rv for _, _, rv, _ in seen]
        names = [b.metadata.name for b in bindings]
        assert evs == ([("ADDED", names[0])] + [("ADDED", n) for n in names[1:]]
                       + [("MODIFIED", names[0])] * 3 + [("DELETED", names[3])])
        assert rvs == sorted(rvs)
        # the last state the watcher holds for each live key is the store's
        last = {}
        for e, n, _, enc in seen:
            if e != "DELETED":
                last[n] = enc
        for rb in wire.cp.store.list("ResourceBinding"):
            assert last[rb.metadata.name] == dumps(wire.s.codec.encode(rb))


class TestServingPaths:
    @pytest.mark.parametrize("watch_cache,watch_loop", [
        (True, True), (True, False), (False, False)])
    def test_serving_paths_deliver_the_reference_sequence(self, watch_cache, watch_loop):
        """The same store churn served by the cache's event loop, by the
        cache on handler threads and by the per-subscription baseline
        arrives as the same (event, name, data) sequence a reference
        server over a reference store delivers (twin of
        TestBaselineParity)."""
        seqs = {}
        for pkg, kw in (("karmada_tpu", {}),
                        ("karmada_tpu_torch", {"watch_cache": watch_cache,
                                               "watch_loop": watch_loop})):
            m = _mods(pkg)
            cp = stub_plane(pkg)
            srv = m.apiserver.ControlPlaneServer(cp, **kw)
            srv.start()
            rs = m.remote.RemoteStore(srv.url)
            got = seqs[pkg] = []
            try:
                rs.watch(KIND, lambda ev, o, got=got: got.append(
                    (ev, o.metadata.name, o.get("data", "v"))), replay=False)
                time.sleep(0.3)
                for i in range(30):
                    cp.store.apply(cm(f"x-{i % 7}", pkg=pkg, val=str(i)))
                cp.store.delete(KIND, "x-0", "default")
                assert wait_until(lambda: len(got) == 31), len(got)
            finally:
                rs.close()
                srv.stop()
        assert seqs["karmada_tpu_torch"] == seqs["karmada_tpu"]


# ---------------------------------------------------------------------------
# negotiation (twins of TestNegotiation, on the port's server and client)
# ---------------------------------------------------------------------------


class TestNegotiation:
    def test_binary_client_binary_server_upgrades_posts_and_watch(self):
        srv = ControlPlaneServer(stub_plane())
        srv.start()
        rs = RemoteStore(srv.url)
        try:
            rs.create(cm("a", v=1))
            assert rs._wire_seen and not rs._wire_down
            rs.create(cm("b", v=1))
            rs.create_batch([cm("c", v=1), cm("d", v=1)])
            assert {o.metadata.name for o in rs.list(KIND)} == {"a", "b", "c", "d"}
            s, tail, ctype = raw_attach(srv._port, accept=wirecodec.CONTENT_TYPE_BIN,
                                        replay=True)
            try:
                assert wirecodec.CONTENT_TYPE_BIN in ctype
                frames = drain_frames(s, tail)
                evs = [f for f in frames if f[0] != wirecodec.FRAME_HEARTBEAT]
                assert len(evs) == 4
            finally:
                s.close()
        finally:
            rs.close()
            srv.stop()

    def test_json_pinned_client_never_upgrades(self):
        srv = ControlPlaneServer(stub_plane())
        srv.start()
        rs = RemoteStore(srv.url, wire="json")
        got = []
        try:
            rs.create(cm("a", v=1))
            rs.watch(KIND, lambda ev, obj: got.append((ev, obj.name)), replay=True)
            assert wait_until(lambda: len(got) == 1)
            rs.create(cm("b", v=1))
            assert wait_until(lambda: len(got) == 2)
            assert not rs._wire_upgrade_ok()
        finally:
            rs.close()
            srv.stop()

    def test_pre_binary_server_watch_falls_back_to_json_lines(self, monkeypatch):
        from karmada_tpu_torch.server import apiserver as apiserver_mod

        monkeypatch.setattr(apiserver_mod.wirecodec, "accepts_binary", lambda h: False)
        srv = ControlPlaneServer(stub_plane())
        srv.start()
        rs = RemoteStore(srv.url)
        got = []
        try:
            rs.create(cm("a", v=1))
            s, _, ctype = raw_attach(srv._port, accept=wirecodec.CONTENT_TYPE_BIN,
                                     replay=True)
            s.close()
            assert wirecodec.CONTENT_TYPE_BIN not in ctype
            rs.watch(KIND, lambda ev, obj: got.append((ev, obj.name)), replay=True)
            assert wait_until(lambda: ("ADDED", "a") in got)
            rs.update(cm("a", v=2))
            assert wait_until(lambda: ("MODIFIED", "a") in got)
        finally:
            rs.close()
            srv.stop()

    def test_no_advertise_header_means_no_body_upgrade(self, monkeypatch):
        from karmada_tpu_torch.server import apiserver as apiserver_mod
        from karmada_tpu_torch.server.httpbase import send_json

        monkeypatch.setattr(
            apiserver_mod.ControlPlaneServer, "_send",
            staticmethod(lambda h, status, body: send_json(h, status, body)))
        srv = ControlPlaneServer(stub_plane())
        srv.start()
        rs = RemoteStore(srv.url)
        try:
            rs.create(cm("a", v=1))
            rs.create(cm("b", v=1))
            assert not rs._wire_seen
            assert not rs._wire_upgrade_ok()
            assert len(rs.list(KIND)) == 2
        finally:
            rs.close()
            srv.stop()

    def test_binary_body_400_downgrades_stickily_and_retries(self, monkeypatch):
        monkeypatch.setattr(
            ControlPlaneServer, "_body",
            staticmethod(lambda h: json.loads(
                h.rfile.read(int(h.headers.get("Content-Length") or 0)).decode())))
        srv = ControlPlaneServer(stub_plane())
        srv.start()
        rs = RemoteStore(srv.url)
        try:
            rs.create(cm("a", v=1))
            assert rs._wire_seen
            rs.create(cm("b", v=1))
            assert rs._wire_down
            rs.create_batch([cm("c", v=1)])
            assert {o.metadata.name for o in rs.list(KIND)} == {"a", "b", "c"}
        finally:
            rs.close()
            srv.stop()


# ---------------------------------------------------------------------------
# the event loop (twins of TestEventLoop's heartbeat and eviction cases)
# ---------------------------------------------------------------------------


def loop_fixture(capacity=4096, queue_max=256 * 1024, heartbeat_s=0.15):
    store = Store()
    cache = WatchCache(store, capacity=capacity)
    cache.attach()
    loop = WatchLoop(cache, heartbeat_s=heartbeat_s, queue_max_bytes=queue_max)
    loop.start()
    return store, cache, loop


class TestEventLoop:
    def test_idle_stream_heartbeats_from_loop_timer(self):
        store, cache, loop = loop_fixture()
        a, a_client = socket.socketpair()
        b, b_client = socket.socketpair()
        try:
            rv = cache.current_rv
            loop.add(a, kind="*", namespace="", wire="json", cursor=rv, delta_floor=rv)
            loop.add(b, kind="*", namespace="", wire="bin", cursor=rv, delta_floor=rv)
            a_client.settimeout(5.0)
            b_client.settimeout(5.0)
            assert a_client.recv(64) == b"\n"
            frames = list(wirecodec.FrameReader().feed(b_client.recv(64)))
            assert frames and all(t == wirecodec.FRAME_HEARTBEAT for t, _ in frames)
            assert loop.stats()["heartbeats"] >= 2
        finally:
            loop.stop()
            for s in (a_client, b_client):
                s.close()

    def test_heartbeat_never_corrupts_framing_mid_delta(self):
        store, cache, loop = loop_fixture(heartbeat_s=0.05)
        srv_sock, client = socket.socketpair()
        srv_sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8192)
        try:
            store.create(cm("big", pad="x"))
            rv = cache.current_rv
            loop.add(srv_sock, kind="*", namespace="", wire="bin", cursor=rv,
                     delta_floor=rv)
            store.update(cm("big", pad="y" * 200_000))
            time.sleep(0.3)
            frames = drain_frames(client, timeout_s=10.0)
            evs = [(t, json.loads(p)) for t, p in frames
                   if t != wirecodec.FRAME_HEARTBEAT]
            assert len(evs) == 1
            ftype, msg = evs[0]
            assert msg["patch"] if ftype == wirecodec.FRAME_DELTA else msg["obj"]
        finally:
            loop.stop()
            client.close()

    def test_slow_client_eviction_resyncs_in_stream_to_exact_state(self):
        store, cache, loop = loop_fixture(capacity=24, queue_max=4096, heartbeat_s=5.0)
        srv_sock, client = socket.socketpair()
        srv_sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        try:
            rv = cache.current_rv
            loop.add(srv_sock, kind="*", namespace="", wire="json", cursor=rv,
                     delta_floor=rv)
            for i in range(120):
                store.create(cm(f"k{i:03d}", pad="p" * 300))
            assert wait_until(lambda: loop.stats()["evictions"] >= 1)
            assert loop.stats()["resyncs"] >= 1
            assert loop.stats()["queue_bytes_max"] <= 4096
            state = {}
            buf = b""
            client.settimeout(0.5)
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                try:
                    chunk = client.recv(65536)
                except socket.timeout:
                    if len(state) == 120:
                        break
                    continue
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    if not line.strip():
                        continue
                    enc = json.loads(line)["obj"]
                    m = enc.get("manifest", enc).get("metadata", {})
                    state[(m.get("namespace", ""), m.get("name", ""))] = \
                        wirecodec.canonical(enc)
            assert len(state) == 120
            for o in store.list(KIND):
                key = (o.metadata.namespace, o.metadata.name)
                assert state[key] == wirecodec.canonical(codec.encode(o))
        finally:
            loop.stop()
            client.close()

    def test_stuck_socket_reaped(self, monkeypatch):
        from karmada_tpu_torch.server import eventloop as eventloop_mod

        monkeypatch.setattr(eventloop_mod, "STUCK_SOCKET_TIMEOUT_S", 0.3)
        store, cache, loop = loop_fixture(queue_max=2048, heartbeat_s=0.1)
        srv_sock, client = socket.socketpair()
        srv_sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 2048)
        try:
            rv = cache.current_rv
            loop.add(srv_sock, kind="*", namespace="", wire="json", cursor=rv,
                     delta_floor=rv)
            for i in range(40):
                store.create(cm(f"s{i}", pad="p" * 400))
            assert wait_until(lambda: loop.stats()["stuck_closed"] >= 1, timeout=5.0)
            assert loop.stats()["connections"] == 0
        finally:
            loop.stop()
            client.close()


# ---------------------------------------------------------------------------
# routes the stub plane cannot answer, and the server's own surface
# ---------------------------------------------------------------------------


class TestServerSurface:
    def _call(self, srv, method, path, body=None):
        from urllib.error import HTTPError
        from urllib.request import Request, urlopen

        req = Request(srv.url + path, method=method,
                      data=None if body is None else json.dumps(body).encode(),
                      headers={"Content-Type": "application/json"})
        try:
            with urlopen(req, timeout=10) as resp:
                return resp.status, json.loads(resp.read().decode() or "{}")
        except HTTPError as e:
            return e.code, json.loads(e.read().decode() or "{}")

    @pytest.mark.parametrize("method,path,body", [
        ("GET", "/healthz", None),
        ("GET", "/members", None),
        ("GET", "/member/objects?cluster=m1", None),
        ("GET", "/search?kind=x", None),
        ("GET", "/elastic/status", None),
        ("GET", "/replication/status", None),
        ("GET", "/objects", None),
        ("GET", "/nowhere", None),
        ("POST", "/tick", {"seconds": 0}),
        ("POST", "/settle", None),
    ])
    def test_status_codes_match_reference(self, method, path, body):
        """Over the same stub plane, the port's server answers every route
        with the reference server's status code."""
        codes = []
        for pkg in PKGS:
            srv = _mods(pkg).apiserver.ControlPlaneServer(stub_plane(pkg))
            srv.start()
            try:
                code, out = self._call(srv, method, path, body)
                codes.append(code)
                if code == 200 and path == "/replication/status":
                    assert out["role"] == "single"
            finally:
                srv.stop()
        assert codes[0] == codes[1], codes

    def test_unported_routes_name_their_item(self):
        srv = ControlPlaneServer(stub_plane())
        srv.start()
        try:
            for path, body, item in (
                    ("/join", {"config": {}}, "item 12"),
                    ("/replication/append", {"token": 1, "entries": []}, "item 13"),
                    ("/replication/snapshot", {"token": 1, "objs": []}, "item 13")):
                code, out = self._call(srv, "POST", path, body)
                assert code == 500 and item in out["error"], (path, out)
        finally:
            srv.stop()
        for kw in ({"follower": True}, {"replication": object()}):
            with pytest.raises(NotImplementedError, match="item 13"):
                ControlPlaneServer(stub_plane(), **kw)
        from karmada_tpu_torch.server.remote import RemoteControlPlane

        with pytest.raises(NotImplementedError, match="item 12"):
            RemoteControlPlane("http://127.0.0.1:1").search({"kind": "x"})

    def test_metrics_route_serves_the_wire_series(self):
        srv = ControlPlaneServer(stub_plane(), token="tok", scrape_token="scrape")
        srv.start()
        rs = RemoteStore(srv.url, token="tok")
        try:
            rs.create(cm("m", v=1))
            rs.list(KIND, page_size=1)
            from urllib.request import Request, urlopen

            for tok in ("tok", "scrape"):
                req = Request(srv.url + "/metrics",
                              headers={"Authorization": f"Bearer {tok}"})
                with urlopen(req, timeout=10) as resp:
                    text = resp.read().decode()
                    assert resp.headers["Content-Type"].startswith("text/plain")
                assert "karmada_reads_served_total" in text
            code, _ = self._call(srv, "GET", "/metrics")
            assert code == 401
        finally:
            rs.close()
            srv.stop()
