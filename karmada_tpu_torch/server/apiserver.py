"""HTTP REST + watch serving over a ControlPlane (the L1 network boundary;
the port's copy of server/apiserver.py).

The port has no `ControlPlane` yet (ROADMAP queue A item 12): the server
duck-types `cp`, and a stub plane serves every route it can answer —
`cp.store` (the port's `Store`), and optionally `cp.coordinator` (a
`LeaseCoordinator`, for /leases/* and fencing), `cp.settle()`,
`cp.tick(seconds)` and `cp.members`. Routes that need modules the port
lacks answer as the reference's server does over such a stub, or raise
NotImplementedError naming their queue item (a 500 on the wire):
/search and /join (item 12), /replication/append and /replication/snapshot
(`store/replication.py`, item 13).

Routes (all JSON; objects wire-encoded by server/codec.py):

| method+path          | store call                | notes                      |
|----------------------|---------------------------|----------------------------|
| GET  /healthz        | —                         | liveness                   |
| GET  /kinds          | store.kinds()             |                            |
| GET  /objects        | get / list                | ?kind=&namespace=[&name=]  |
|                      |                           | [&limit=&continue=] pages  |
|                      |                           | pinned to a snapshot rv    |
| POST /objects        | create                    | body {"obj": enc}          |
| PUT  /objects        | update                    | body {"obj": enc, "check_rv"} |
| POST /apply          | apply                     | body {"obj": enc}          |
| POST /objects/batch  | *_batch / get_batch       | transactional multi-op:    |
|                      |                           | {"op", "objs"} all-or-     |
|                      |                           | nothing, one lock hold +   |
|                      |                           | one fsync; 409/422 carry   |
|                      |                           | per-object typed results   |
| DELETE /objects      | delete                    | ?kind=&name=[&namespace=]  |
| GET  /watch          | watch cache fan-out       | ?kind= (or *) [&replay=]   |
|                      |   (store subscription     | [&since=<rv>] resumes from |
|                      |    when cache disabled)   | the ring; streams JSON     |
|                      |                           | lines tagged with "rv"     |
| POST /settle         | cp.settle()               | drain controllers, blocking|
| POST /tick           | cp.tick(seconds)          | fire timer loops           |
| GET  /members        | cp.members keys           |                            |
| GET  /member/objects | member.objects()          | ?cluster= — the aggregated |
|                      |                           | cluster-proxy view (U9)    |
| POST /join           | cp.join_member            | body {"config": enc}       |
| POST /unjoin         | cp.unjoin_member          | body {"name": ...}         |
| POST /agent/cert     | cp.sign_agent_cert        | register CSR flow          |
| POST /leases/acquire | coordinator.acquire       | leader election CAS        |
| POST /leases/renew   | coordinator.renew         | 409 when deposed/expired   |
| POST /leases/release | coordinator.release       | voluntary step-down        |
| GET  /elections      | coordinator.elections()   | LeaderLease status view    |
| GET  /metrics        | metrics.registry.render() | Prometheus text (wire      |
|                      |                           | token OR read-only         |
|                      |                           | scrape_token)              |
| POST /simulate       | cp.simulate               | what-if plane: body        |
|                      |                           | {"request": enc(SimulationRequest)} |
|                      |                           | → {"report": enc(SimulationReport)} |
| POST /replication/append   | store.apply_replicated | leader log shipping:  |
|                      |                           | rv-contiguous entries,     |
|                      |                           | token-fenced; 409 carries  |
|                      |                           | expected_rv / stale_token  |
| POST /replication/snapshot | store.load_snapshot  | catch-up state swap at a   |
|                      |                           | pinned rv                  |
| GET  /replication/status   | role + lag view      | leader: per-peer lag;      |
|                      |                           | follower: applied rv/leader|

Write fencing: a mutating request may carry `X-Karmada-Fencing:
<namespace>/<lease>:<token>`; the token is checked against the named
LeaderLease BEFORE the store operation runs, and a stale token (the caller
was deposed) gets 409 — a paused ex-leader resuming past its TTL cannot
land in-flight patches (coordination/lease.py).

Error mapping: NotFound→404, Conflict→409, admission denial→422, missing or
wrong bearer token→401, anything else→500; bodies are {"error": "..."}.

Transport security mirrors the reference's kube-apiserver boundary (TLS +
authn): pass `ssl_context` (server cert signed by the cluster CA,
`auth/pki.py`) to serve HTTPS, and `token` to require
`Authorization: Bearer <token>` on every route except GET /healthz
(liveness probes are conventionally unauthenticated). The daemon
(`python -m karmada_tpu.server --tls-dir --token-file`) materializes both;
loopback plaintext remains the zero-config default for tests and demos.

Concurrency model: store CRUD is thread-safe (store.py's RLock), so request
handlers hit it directly. Controller queues drain on a single reconcile
thread (`_reconcile_loop`) woken by a store-wide watch — `Runtime.settle`
is never run from two threads.

Read scaling (docs/PERF.md "Control-plane read path"): by default the
server attaches ONE revisioned WatchCache to the store and every watch
stream is a cursor into its shared ring — the per-client store
subscription (N watchers serializing every write inside the notify path)
only remains as the `watch_cache=False` baseline. A slow client's cursor
falls behind instead of overflowing a queue: it misses nothing until the
ring compacts past it, and even then the SAME stream falls back to a
snapshot replay instead of being closed for a full reconnect resync.
"""
from __future__ import annotations

import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from ..store.store import ConflictError, NotFoundError
from ..store.watchcache import ContinueExpired
from ..webhook.admission import AdmissionDenied
from . import codec, wirecodec
from .httpbase import (
    bearer_auth_ok,
    drain_body,
    make_http_server,
    read_json,
    send_json,
)

_WATCH_END = object()


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue A item {item})")


class ControlPlaneServer:
    def __init__(self, cp, host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None, token: Optional[str] = None,
                 enable_test_clock: bool = True,
                 scrape_token: Optional[str] = None,
                 socket_timeout: Optional[float] = None,
                 watch_cache: bool = True,
                 watch_cache_capacity: int = 0,
                 watch_loop: bool = True,
                 replication=None,
                 follower: bool = False):
        """`enable_test_clock=False` disables POST /tick with 403: advancing
        a nonzero `seconds` freezes the plane's Clock at the advanced
        instant, which is a test affordance — a production daemon
        must not expose it to anyone holding the normal bearer token. The
        in-process default stays True (tests and demos); the daemon
        (`python -m karmada_tpu.server`) requires --enable-test-clock.

        `scrape_token`: a dedicated READ-ONLY credential accepted on GET
        /metrics ONLY — a Prometheus scraper no longer needs the full wire
        token (docs/HA.md). Every other route still requires `token`.

        `socket_timeout`: per-connection idle bound in seconds (slow-loris
        reaping, httpbase.make_http_server); None = the shared default,
        0 disables (tests only). Daemon flag: --socket-timeout.

        `watch_cache`: serve GET /watch and paginated GET /objects from a
        shared revisioned ring (store/watchcache.py) instead of a store
        subscription per stream. False restores the per-subscription
        baseline (the fanout bench's comparison leg; daemon flag
        --no-watch-cache). `watch_cache_capacity`: ring size in events
        (0 = the module default).

        `watch_loop`: serve plain-TCP watch streams from the single-thread
        event loop (server/eventloop.py) instead of parking a handler
        thread per stream, and negotiate the binary delta codec
        (`Accept: application/x-karmada-bin`) on those streams. False
        restores the thread-per-stream JSON baseline (the fanout bench's
        wire comparison leg; daemon flag --no-watch-loop). TLS streams
        always stay on the threaded path (an SSLSocket cannot be dup()'d
        into byte-level non-blocking serving). Requires `watch_cache`.

        `replication` / `follower`: the replicated store's leader and
        follower roles (`store/replication.py`), not ported yet: either
        raises NotImplementedError naming its queue item."""
        from .httpbase import DEFAULT_SOCKET_TIMEOUT

        if replication is not None or follower:
            raise _unported(
                "ControlPlaneServer(replication=, follower=): the replicated "
                "store (store/replication.py)", 13)
        self.cp = cp
        self._host = host
        self._port = port
        self._socket_timeout = (
            DEFAULT_SOCKET_TIMEOUT if socket_timeout is None
            else socket_timeout
        )
        self._ssl_context = ssl_context
        self._token = token
        self._scrape_token = scrape_token
        self._enable_test_clock = enable_test_clock
        self._use_watch_cache = watch_cache
        self._watch_cache_capacity = watch_cache_capacity
        self._watch_cache = None
        self._use_watch_loop = watch_loop
        self._watch_loop = None
        self._watch_ids = itertools.count(1)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads: list[threading.Thread] = []
        self._dirty = threading.Event()
        self._quiesced = threading.Condition()
        self._settle_lock = threading.Lock()  # one settle/tick at a time
        self._stopping = False

    # -- lifecycle --------------------------------------------------------

    def start(self) -> int:
        """Bind, start the serving + reconcile threads, return the port."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def do_GET(self):
                server._route(self, "GET")

            def do_POST(self):
                server._route(self, "POST")

            def do_PUT(self):
                server._route(self, "PUT")

            def do_DELETE(self):
                server._route(self, "DELETE")

        self._httpd = make_http_server(
            self._host, self._port, Handler, self._ssl_context,
            socket_timeout=self._socket_timeout,
        )
        self._port = self._httpd.server_address[1]
        if self._use_watch_cache and self._watch_cache is None:
            from ..store.watchcache import WatchCache

            kwargs = {}
            if self._watch_cache_capacity:
                kwargs["capacity"] = self._watch_cache_capacity
            self._watch_cache = WatchCache(self.cp.store, **kwargs)
            self._watch_cache.attach()
        if (self._use_watch_loop and self._watch_cache is not None
                and self._watch_loop is None):
            from .eventloop import WatchLoop

            self._watch_loop = WatchLoop(self._watch_cache)
            self._watch_loop.start()
        self.cp.store.watch_all(self._mark_dirty, replay=False)
        for target, name in ((self._httpd.serve_forever, "serve"),
                             (self._reconcile_loop, "reconcile")):
            t = threading.Thread(
                target=target, name=f"cp-server-{name}", daemon=True
            )
            t.start()
            self._threads.append(t)
        return self._port

    def stop(self) -> None:
        self._stopping = True
        self.cp.store.unwatch_all(self._mark_dirty)
        if self._watch_loop is not None:
            self._watch_loop.stop()
        if self._watch_cache is not None:
            self._watch_cache.detach()
        self._dirty.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    @property
    def url(self) -> str:
        scheme = "https" if self._ssl_context is not None else "http"
        return f"{scheme}://{self._host}:{self._port}"

    def watch_loop_stats(self) -> dict:
        """Event-loop serving counters (connections, queue high-water,
        evictions, stuck closes) — the soak's WireHealth invariant and the
        wire tests read these. Empty dict when the loop is disabled."""
        return {} if self._watch_loop is None else self._watch_loop.stats()

    # -- reconcile thread -------------------------------------------------

    def _mark_dirty(self, kind: str, event: str, obj: Any) -> None:
        self._dirty.set()

    def _reconcile_loop(self) -> None:
        while not self._stopping:
            if not self._dirty.wait(timeout=0.2):
                continue  # idle: no settle churn, no lock contention
            if self._stopping:
                return
            self._dirty.clear()
            try:
                with self._settle_lock:
                    self.cp.settle()
            except Exception:  # noqa: BLE001 - keep the loop alive
                import logging

                logging.getLogger(__name__).exception("reconcile loop")
            with self._quiesced:
                self._quiesced.notify_all()

    def _settle_blocking(self, timeout: float = 30.0) -> None:
        """Wake the reconcile thread and wait until a settle pass ran with
        no further dirtying (the CLI's post-mutation convergence point)."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._dirty.set()
            with self._quiesced:
                self._quiesced.wait(timeout=0.5)
            if not self._dirty.is_set():
                return

    # -- routing ----------------------------------------------------------

    def _route(self, h: BaseHTTPRequestHandler, method: str) -> None:
        parsed = urlparse(h.path)
        q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        if method == "GET" and parsed.path == "/metrics":
            # /metrics accepts the read-only scrape token too; the scrape
            # token is valid NOWHERE else (it must never mutate the plane)
            from .metricsserver import scrape_auth_ok

            if not scrape_auth_ok(h, self._token, self._scrape_token):
                drain_body(h)
                self._send(h, 401, {"error": "unauthorized"})
                return
        elif (not (method == "GET" and parsed.path == "/healthz")
                and not bearer_auth_ok(h, self._token)):
            drain_body(h)
            self._send(h, 401, {"error": "unauthorized"})
            return
        # lease-management routes are exempt from fencing: acquire IS how a
        # deposed leader (whose client still carries its old token) re-enters
        # the election, and renew/release validate their own token server-side.
        # Replication routes carry their own (monotonic) token fence in the
        # body — a follower plane has no coordinator to resolve the header
        # against, and the append fence must hold there regardless.
        if (method != "GET"
                and not parsed.path.startswith(("/leases", "/replication"))
                and not self._fence_ok(h)):
            return
        # distributed tracing: a mutating request may carry X-Karmada-Trace
        # (trace id + LOGICAL span id); the server records its side of the
        # write as a commit span under that context. The span id dedups, so
        # a replay-idempotent retry or a 409->leader-redirect re-send of
        # the same logical write yields exactly ONE commit span.
        trace_ctx = None
        if method != "GET":
            from ..tracing import parse_trace_header

            trace_ctx = parse_trace_header(
                h.headers.get("X-Karmada-Trace", ""))
            if trace_ctx is not None and not trace_ctx[2]:
                trace_ctx = None  # s=0: head-dropped upstream
        # the span is recorded by _send BEFORE the response bytes reach the
        # socket: a client that writes and immediately reads its trace back
        # must observe the commit span (happens-before the response)
        h._trace_ctx = trace_ctx
        h._trace_t0 = time.time() if trace_ctx is not None else 0.0
        h._trace_route = parsed.path
        try:
            fn = getattr(self, f"_h_{method}_{parsed.path.strip('/').replace('/', '_')}", None)
            if fn is None:
                drain_body(h)
                self._send(h, 404, {"error": f"no route {method} {parsed.path}"})
                return
            fn(h, q)
        except NotFoundError as e:
            self._send(h, 404, {"error": str(e)})
        except ConflictError as e:
            self._send(h, 409, {"error": str(e)})
        except ContinueExpired as e:
            # the reference's "410 Gone / expired resourceVersion": the
            # client restarts its paginated list from the beginning
            self._send(h, 410, {"error": str(e)})
        except AdmissionDenied as e:
            self._send(h, 422, {"error": str(e)})
        except BrokenPipeError:
            pass
        except wirecodec.WireProtocolError as e:
            # an undecodable negotiated-binary body is the client's error,
            # not a server fault — and it must read as a hard 4xx so the
            # client's sticky downgrade (not its 5xx retry loop) engages
            self._send(h, 400, {"error": f"wire codec: {e}"})
        except Exception as e:  # noqa: BLE001 - wire boundary
            self._send(h, 500, {"error": f"{type(e).__name__}: {e}"})

    def _fence_ok(self, h: BaseHTTPRequestHandler) -> bool:
        """Enforce X-Karmada-Fencing on mutating requests. True = proceed
        (no header, or the token is current); False = a reply was sent."""
        raw = h.headers.get("X-Karmada-Fencing", "")
        if not raw:
            return True
        coordinator = getattr(self.cp, "coordinator", None)
        if coordinator is None:  # plane without a coordination layer
            return True
        from ..coordination.lease import parse_fence_header

        try:
            parsed = parse_fence_header(raw)
        except ValueError as e:
            drain_body(h)
            self._send(h, 400, {"error": str(e)})
            return False
        if parsed is None:
            return True
        ns, name, token = parsed
        try:
            coordinator.check_fence(name, token, namespace=ns)
        except ConflictError as e:
            drain_body(h)
            self._send(h, 409, {"error": str(e)})
            return False
        return True

    @staticmethod
    def _replication_role() -> str:
        """The read-serving role a reads_served label names: a plane
        without the replicated store is "single"."""
        return "single"

    @staticmethod
    def _send(h, status: int, body: dict) -> None:
        h._trace_status = status
        # commit span, recorded ONLY on success and BEFORE the response is
        # written: a handler that raised OR answers a 4xx/5xx here (POST
        # /objects/batch reports BatchError as a 409 body and returns
        # normally) committed nothing — its span would show a commit that
        # never happened, and recording it would also burn the logical span
        # id so the client's real replayed commit deduped away. A replay
        # whose first attempt succeeded server-side still dedups by span
        # id. Ordering before send_json means a client that writes and
        # immediately reads its trace always sees the span.
        ctx = getattr(h, "_trace_ctx", None)
        if ctx is not None and status < 400:
            from ..tracing import tracer

            h._trace_ctx = None
            tracer.record_trace(
                ctx[0], "commit", getattr(h, "_trace_t0", 0.0), time.time(),
                span_id=ctx[1], route=getattr(h, "_trace_route", ""),
            )
        # advertise binary-body support on every response: clients upgrade
        # their subsequent POST bodies only after seeing this (a pre-binary
        # server would reject a frame it cannot parse) — wirecodec.py
        send_json(h, status, body,
                  extra_headers={wirecodec.HEADER_WIRE:
                                 str(wirecodec.WIRE_VERSION)})

    @staticmethod
    def _body(h) -> dict:
        return read_json(h)

    # -- handlers ---------------------------------------------------------

    def _h_GET_healthz(self, h, q):
        self._send(h, 200, {"ok": True})

    def _h_GET_elastic_status(self, h, q):
        """Elasticity-daemon observability (docs/ELASTICITY.md): leadership,
        hysteresis/preflight config, and the cumulative tick counters
        (solves advance 1 per tick regardless of workload count)."""
        el = getattr(self.cp, "elasticity", None)
        if el is None:
            self._send(h, 404, {"error": "elasticity plane not enabled "
                                         "(start with --elastic)"})
            return
        self._send(h, 200, el.status())

    def _h_GET_kinds(self, h, q):
        self._send(h, 200, {"kinds": self.cp.store.kinds()})

    # how long a min_rv= read barrier waits for replication to catch up
    # before answering 504 (read-your-writes callers retry or re-route)
    MIN_RV_WAIT_S = 5.0

    def _min_rv_ok(self, h, q) -> bool:
        """The min_rv= read barrier: block until this plane's store has
        applied at least that resourceVersion (a follower waiting out
        replication lag), else 504. True = proceed."""
        try:
            min_rv = int(q.get("min_rv") or 0)
        except ValueError:
            min_rv = 0
        if min_rv <= 0:
            return True
        deadline = time.monotonic() + self.MIN_RV_WAIT_S
        cache = self._watch_cache
        while not self._stopping:
            have = (cache.current_rv if cache is not None
                    else self.cp.store.current_rv)
            if have >= min_rv:
                return True
            if time.monotonic() >= deadline:
                drain_body(h)
                self._send(h, 504, {
                    "error": f"min_rv {min_rv} not reached "
                             f"(applied rv {have}) within "
                             f"{self.MIN_RV_WAIT_S}s",
                })
                return False
            if cache is not None:
                cache.wait(have, timeout=0.25)
            else:
                time.sleep(0.02)
        return False

    def _h_GET_objects(self, h, q):
        from ..metrics import reads_served

        kind = q.get("kind", "")
        if not kind:
            self._send(h, 400, {"error": "kind required"})
            return
        if not self._min_rv_ok(h, q):
            return
        reads_served.inc(role=self._replication_role())
        if "name" in q:
            obj = self.cp.store.get(kind, q["name"], q.get("namespace", ""))
            self._send(h, 200, {"obj": codec.encode(obj)})
            return
        try:
            limit = int(q.get("limit") or 0)
        except ValueError:
            limit = 0
        if limit > 0 and self._watch_cache is not None:
            # revision-consistent pagination: every page of one crawl is
            # served from the snapshot pinned by the first page, so writes
            # landing mid-crawl cannot duplicate or skip items
            from ..metrics import list_pages

            rv, items, token = self._watch_cache.list_page(
                kind, q.get("namespace", ""), limit, q.get("continue") or None
            )
            list_pages.inc()
            body: dict = {"items": items, "resourceVersion": rv}
            if token:
                body["continue"] = token
            self._send(h, 200, body)
        else:
            objs = self.cp.store.list(kind, q.get("namespace", ""))
            self._send(h, 200, {"items": [codec.encode(o) for o in objs]})

    def _h_GET_search(self, h, q):
        """Fleet-wide columnar search over the plane's member-object index:
        404 on a plane without one; the search plane itself is not ported."""
        search = getattr(self.cp, "search", None)
        if search is None:
            self._send(h, 404, {"error": "search plane not enabled"})
            return
        raise _unported("GET /search: the columnar search plane "
                        "(search/columnar.py, search/query.py)", 12)

    def _h_POST_objects(self, h, q):
        obj = codec.decode(self._body(h)["obj"])
        out = self.cp.store.create(obj)
        self._send(h, 200, {"obj": codec.encode(out)})

    def _h_POST_objects_batch(self, h, q):
        """Transactional batch writes (docs/PERF.md "Write path at fleet
        scale"): body {"op": "create"|"update"|"apply", "objs": [enc...]}
        (+ "check_rv"/"skip_missing" for update) commits every object under
        ONE store lock hold with contiguous resourceVersions and one WAL
        fsync — or commits NOTHING, answering 409/422 with per-object typed
        results so the client's retry policy can tell re-send-the-rest from
        drop-this-one. op "get" batches point reads: {"op": "get", "kind":
        ..., "keys": [[name, namespace], ...]} -> objs (null = missing)."""
        from ..store.store import BatchError

        body = self._body(h)
        op = body.get("op", "apply")
        store = self.cp.store
        if op == "get":
            keys = [(k[0], k[1] if len(k) > 1 else "")
                    for k in body.get("keys", [])]
            objs = store.get_batch(body.get("kind", ""), keys)
            self._send(h, 200, {"objs": [
                None if o is None else codec.encode(o) for o in objs
            ]})
            return
        objs = [codec.decode(o) for o in body.get("objs", [])]
        try:
            if op == "create":
                outs = store.create_batch(objs)
            elif op == "update":
                outs = store.update_batch(
                    objs, check_rv=bool(body.get("check_rv")),
                    skip_missing=bool(body.get("skip_missing")),
                    skip_stale=bool(body.get("skip_stale")),
                )
            elif op == "apply":
                outs = store.apply_batch(objs)
            else:
                self._send(h, 400, {"error": f"unknown batch op {op!r}"})
                return
        except BatchError as e:
            reasons = {r.reason for r in e.results}
            # conflict dominates (retryable, like the single-object 409);
            # a pure admission failure maps to the single-object 422
            status = (409 if "conflict" in reasons
                      else 422 if "admission" in reasons else 400)
            self._send(h, status, {"error": str(e), "results": [
                {"ok": r.ok, "reason": r.reason, "error": r.error}
                for r in e.results
            ]})
            return
        self._send(h, 200, {"objs": [
            None if o is None else codec.encode(o) for o in outs
        ]})

    def _h_PUT_objects(self, h, q):
        body = self._body(h)
        obj = codec.decode(body["obj"])
        out = self.cp.store.update(obj, check_rv=bool(body.get("check_rv")))
        self._send(h, 200, {"obj": codec.encode(out)})

    def _h_POST_apply(self, h, q):
        obj = codec.decode(self._body(h)["obj"])
        out = self.cp.store.apply(obj)
        self._send(h, 200, {"obj": codec.encode(out)})

    def _h_DELETE_objects(self, h, q):
        self.cp.store.delete(q["kind"], q["name"], q.get("namespace", ""))
        self._send(h, 200, {"ok": True})

    def _h_POST_settle(self, h, q):
        self._settle_blocking()
        self._send(h, 200, {"ok": True})

    def _h_POST_tick(self, h, q):
        if not self._enable_test_clock:
            drain_body(h)
            self._send(h, 403, {
                "error": "test clock disabled: start the daemon with "
                         "--enable-test-clock to allow POST /tick",
            })
            return
        body = self._body(h)
        # timer loops share the reconcile thread's exclusivity requirement
        # (tick itself settles at the end). NOTE: advancing a nonzero
        # `seconds` freezes the daemon's Clock at the advanced instant —
        # meant for tests, not live deployments.
        with self._settle_lock:
            steps = self.cp.tick(float(body.get("seconds") or 0.0))
        self._send(h, 200, {"steps": steps})

    def _h_GET_members(self, h, q):
        self._send(h, 200, {"members": sorted(self.cp.members.keys())})

    def _h_GET_member_objects(self, h, q):
        member = self.cp.members.get(q.get("cluster", ""))
        if member is None:
            self._send(h, 404, {"error": f"cluster {q.get('cluster')!r} not found"})
            return
        self._send(h, 200, {
            "items": [o.to_dict() for o in member.objects()],
        })

    def _h_POST_join(self, h, q):
        self._body(h)
        raise _unported("POST /join: members.member.MemberConfig and the "
                        "member plane", 12)

    def _h_POST_unjoin(self, h, q):
        name = self._body(h)["name"]
        with self._settle_lock:
            self.cp.unjoin_member(name)
        self._settle_blocking()
        self._send(h, 200, {"ok": True})

    # -- leader election (coordination/lease.py) --------------------------

    def _h_POST_leases_acquire(self, h, q):
        from ..api.coordination import DEFAULT_LEASE_DURATION, LEADER_LEASE_NAMESPACE

        body = self._body(h)
        lease, acquired = self.cp.coordinator.acquire(
            body["name"], body["identity"],
            float(body.get("duration") or DEFAULT_LEASE_DURATION),
            namespace=body.get("namespace") or LEADER_LEASE_NAMESPACE,
        )
        self._send(h, 200, {"acquired": acquired,
                            "lease": codec.encode(lease)})

    def _h_POST_leases_renew(self, h, q):
        from ..api.coordination import LEADER_LEASE_NAMESPACE

        body = self._body(h)
        lease = self.cp.coordinator.renew(
            body["name"], body["identity"], int(body["token"]),
            namespace=body.get("namespace") or LEADER_LEASE_NAMESPACE,
        )
        self._send(h, 200, {"lease": codec.encode(lease)})

    def _h_POST_leases_release(self, h, q):
        from ..api.coordination import LEADER_LEASE_NAMESPACE

        body = self._body(h)
        self.cp.coordinator.release(
            body["name"], body["identity"], int(body["token"]),
            namespace=body.get("namespace") or LEADER_LEASE_NAMESPACE,
        )
        self._send(h, 200, {"ok": True})

    def _h_GET_elections(self, h, q):
        self._send(h, 200, {
            "items": [codec.encode(l) for l in self.cp.coordinator.elections()],
        })

    def _h_POST_simulate(self, h, q):
        """What-if plane: evaluate a SimulationRequest's scenarios against
        the live fleet as one batched vmapped solve (simulation/engine.py)
        and answer with the SimulationReport; the plane persists the last N
        reports for `karmadactl get simulationreports`. Read-only with
        respect to the fleet and bindings."""
        from ..api.simulation import SimulationRequest
        from ..simulation.engine import SimulationError

        body = self._body(h)
        req = codec.decode(body.get("request"))
        if not isinstance(req, SimulationRequest):
            self._send(h, 400, {"error": "request must be a SimulationRequest"})
            return
        try:
            report = self.cp.simulate(req)
        except SimulationError as e:
            self._send(h, 400, {"error": str(e)})
            return
        self._send(h, 200, {"report": codec.encode(report)})

    # -- replicated store (store/replication.py; docs/HA.md) --------------

    def _h_POST_replication_append(self, h, q):
        """Follower apply path of the replicated store: rv-contiguous log
        entries from the leader's commit stream, fenced by the monotonic
        lease token."""
        self._body(h)
        raise _unported("POST /replication/append: the replicated store "
                        "(store/replication.py)", 13)

    def _h_POST_replication_snapshot(self, h, q):
        """Catch-up fallback of the replicated store: replace the whole
        store state with the leader's rv-pinned snapshot."""
        self._body(h)
        raise _unported("POST /replication/snapshot: the replicated store "
                        "(store/replication.py)", 13)

    def _h_GET_replication_status(self, h, q):
        """One status view for both roles — what `karmadactl replication
        status` and the role column of `get leaderleases` read; a plane
        without the replicated store is "single"."""
        self._send(h, 200, {
            "role": "single",
            "applied_rv": self.cp.store.current_rv,
        })

    def _h_GET_traces(self, h, q):
        """Placement-trace store (docs/OBSERVABILITY.md): summaries of the
        retained ring, one full trace by ?trace_id= or ?binding=<ns>/<name>,
        or the per-stage SLO attribution table with ?report=1 (the soak's
        report artifact). Served from the process-global tracer — the plane
        that runs the streaming scheduler in-process holds the full causal
        chain; split topologies contribute their commit/apply spans via the
        X-Karmada-Trace header and the agent-status path."""
        from ..tracing import slo_report, tracer

        if q.get("report"):
            self._send(h, 200, {"report": slo_report()})
            return
        tid, binding = q.get("trace_id"), q.get("binding")
        if tid or binding:
            trace = tracer.get(trace_id=tid, key=binding)
            if trace is None:
                self._send(h, 404, {"error": "no trace retained for "
                                             f"{tid or binding!r}"})
                return
            self._send(h, 200, {"trace": trace})
            return
        self._send(h, 200, {"traces": tracer.traces(),
                            "config": tracer.config()})

    def _h_GET_metrics(self, h, q):
        """Prometheus text exposition. Behind the
        same bearer auth as every other route — _route already checked.
        Exemplars (trace ids on the SLO histogram buckets) render only for
        scrapers that negotiated openmetrics-text via Accept."""
        from ..metrics import registry
        from .httpbase import send_prometheus, wants_openmetrics

        om = wants_openmetrics(h)
        send_prometheus(h, registry.render(exemplars=om), openmetrics=om)

    def _h_POST_agent_cert(self, h, q):
        cert = self.cp.sign_agent_cert(self._body(h)["cluster"])
        self._send(h, 200, {
            "cert_pem": cert.cert_pem.decode(),
            "key_pem": cert.key_pem.decode(),
            "ca_pem": self.cp.pki.ca_pem.decode(),
        })

    # -- watch streaming --------------------------------------------------

    # events written per batch on the cached path: bounds one client's
    # single write() while amortizing the per-batch ring scan + flush
    WATCH_BATCH = 256

    def _h_GET_watch(self, h, q):
        from ..metrics import reads_served

        reads_served.inc(role=self._replication_role())
        kind = q.get("kind", "")
        replay = q.get("replay", "1") not in ("0", "false")
        # server-side namespace scoping: a pull agent watching its own
        # execution namespace must not receive (or pay for) the rest of the
        # federation's events
        namespace = q.get("namespace", "")
        if not kind:
            self._send(h, 400, {"error": "kind required"})
            return
        if self._watch_cache is not None:
            self._serve_watch_cached(h, q, kind, replay, namespace)
            return
        self._serve_watch_subscribed(h, kind, replay, namespace)

    def _serve_watch_cached(self, h, q, kind: str, replay: bool,
                            namespace: str) -> None:
        """Fan-out serving: this stream is a cursor into the shared
        revisioned ring — no store subscription, no per-client queue. The
        filter and the JSON bytes are evaluated/read here, in this
        connection's own thread, never inside the store's notify path.

        `since=<rv>`: resume — deliver only events past rv when the ring
        still holds them, else fall back to snapshot+replay (the client
        sent since because it HAS state; the replay reconverges it). A
        cursor that lags past ring compaction mid-stream resyncs the same
        way instead of being closed.

        Serving path + codec negotiation (docs/PERF.md "Async wire
        plane"): after the headers (and any replay snapshot) are written
        here, a plain-TCP stream is handed off to the event loop — this
        thread returns to the pool while the loop serves the live tail.
        `Accept: application/x-karmada-bin` negotiates binary delta
        frames on the loop path (the Content-Type answers the decision,
        so a pre-binary client/server pair degrades observably to JSON
        lines); TLS streams and watch_loop=False stay on this thread."""
        from ..metrics import (
            watch_client_lag,
            watch_clients,
            watch_events_sent,
            watch_resyncs,
            wire_connections,
        )

        cache = self._watch_cache
        loop = self._watch_loop
        use_loop = loop is not None and self._ssl_context is None
        wire = ("bin" if use_loop
                and wirecodec.accepts_binary(h.headers.get("Accept"))
                else "json")
        client = f"c{next(self._watch_ids)}"
        watch_clients.inc(1)
        threaded = False
        try:
            h.send_response(200)
            h.send_header("Content-Type",
                          wirecodec.CONTENT_TYPE_BIN if wire == "bin"
                          else wirecodec.CONTENT_TYPE_JSON_LINES)
            h.send_header(wirecodec.HEADER_WIRE, str(wirecodec.WIRE_VERSION))
            # no Content-Length: the stream ends when either side closes
            h.send_header("Connection", "close")
            h.end_headers()
            w = h.wfile
            cursor = None
            replayed = False
            since = q.get("since")
            if since is not None:
                try:
                    since_rv = int(since)
                except ValueError:
                    since_rv = -1
                if since_rv >= 0:
                    _, _, ok = cache.events_since(since_rv, kind, namespace,
                                                  limit=1)
                    # a token from a different store incarnation (rv ahead
                    # of everything we have) is as unusable as a compacted
                    # one — fall through to snapshot replay
                    if ok and since_rv <= cache.current_rv:
                        cursor = since_rv
                    else:
                        watch_resyncs.inc(reason="compacted")
            if cursor is None:
                if replay or since is not None:
                    cursor = self._replay_snapshot(w, kind, namespace, wire)
                    replayed = True
                else:
                    cursor = cache.current_rv
            if use_loop:
                # hand-off: flush what this thread wrote, dup the
                # connection for the loop, and keep socketserver's
                # teardown from FIN-ing the shared socket (httpbase
                # detach seam). Deltas are only sound against state this
                # stream delivered: after a replay every base is held
                # (floor 0); a bare since-resume holds nothing delivered
                # by THIS attachment yet, so its floor is the cursor.
                w.flush()
                h.server.detach_request(h.connection)
                loop.add(h.connection.dup(), kind=kind, namespace=namespace,
                         wire=wire, cursor=cursor,
                         delta_floor=0 if replayed else cursor)
                return
            threaded = True
            wire_connections.inc(1, codec=wire, loop="thread")
            last_write = time.monotonic()
            while not self._stopping:
                events, cursor, ok = cache.events_since(
                    cursor, kind, namespace, limit=self.WATCH_BATCH
                )
                if not ok:
                    # lagged past ring compaction: resync IN-STREAM (the
                    # per-subscription path closed for a full reconnect)
                    watch_resyncs.inc(reason="lagged")
                    cursor = self._replay_snapshot(w, kind, namespace)
                    last_write = time.monotonic()
                    continue
                if not events:
                    cache.wait(cursor, timeout=0.5)
                    # heartbeat on WALL time since this stream's last
                    # bytes — not on wait()'s wakeup: unrelated-kind churn
                    # wakes the wait constantly while matching nothing, and
                    # a byte-silent stream trips the client's read timeout
                    if time.monotonic() - last_write >= 0.5:
                        w.write(b"\n")
                        w.flush()
                        last_write = time.monotonic()
                    continue
                w.write(b"".join(ev.line() for ev in events))
                w.flush()
                last_write = time.monotonic()
                watch_events_sent.inc(len(events), path="cache")
                watch_client_lag.set(cache.lag(cursor), client=client)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            watch_client_lag.remove(client=client)
            watch_clients.inc(-1)
            if threaded:
                wire_connections.inc(-1, codec=wire, loop="thread")

    def _replay_snapshot(self, w, kind: str, namespace: str,
                         wire: str = "json") -> int:
        """Write the cache's revision-consistent current state as ADDED
        lines (informer initial-list semantics) — or ADDED frames on a
        binary-negotiated stream; returns the snapshot rv — the cursor
        from which live streaming continues gap-free."""
        from ..metrics import watch_events_sent

        rv, items = self._watch_cache.snapshot(kind, namespace)
        if wire == "bin":
            buf = b"".join(it.added_frame() for it in items)
        else:
            buf = b"".join(it.added_line() for it in items)
        if buf:
            w.write(buf)
            w.flush()
            watch_events_sent.inc(len(items), path="cache")
        return rv

    def _serve_watch_subscribed(self, h, kind: str, replay: bool,
                                namespace: str) -> None:
        """Per-subscription baseline (watch_cache=False): every stream owns
        a Store.watch subscription and a bounded queue filled inside the
        store's notify path; overflow closes the stream for a full-resync
        reconnect. Kept as the fanout bench's comparison leg."""
        from ..metrics import watch_clients, watch_events_sent

        watch_clients.inc(1)
        events: queue.Queue = queue.Queue(maxsize=10_000)
        # a client too slow for the event rate gets its stream CLOSED (not
        # silently thinned): RemoteStore reconnects with replay=1, which is
        # the informer relist/resync — level-triggered consumers converge
        overflowed = threading.Event()

        if kind == "*":
            def handler(k: str, event: str, obj: Any) -> None:
                if namespace and obj.metadata.namespace != namespace:
                    return
                try:
                    events.put_nowait((k, event, obj))
                except queue.Full:
                    overflowed.set()
            self.cp.store.watch_all(handler, replay=replay)
            unsub = lambda: self.cp.store.unwatch_all(handler)  # noqa: E731
        else:
            def handler(event: str, obj: Any) -> None:  # type: ignore[misc]
                try:
                    events.put_nowait((kind, event, obj))
                except queue.Full:
                    overflowed.set()
            self.cp.store.watch(
                kind, handler, replay=replay, namespace=namespace
            )
            unsub = lambda: self.cp.store.unwatch(kind, handler)  # noqa: E731

        try:
            h.send_response(200)
            h.send_header("Content-Type", wirecodec.CONTENT_TYPE_JSON_LINES)
            # no Content-Length: the stream ends when either side closes
            h.send_header("Connection", "close")
            h.end_headers()
            while not self._stopping:
                if overflowed.is_set() and events.empty():
                    import logging

                    logging.getLogger(__name__).warning(
                        "watch stream for %s overflowed; closing for resync",
                        kind,
                    )
                    break
                try:
                    k, event, obj = events.get(timeout=0.5)
                except queue.Empty:
                    # heartbeat line keeps half-open connections detectable
                    h.wfile.write(b"\n")
                    h.wfile.flush()
                    continue
                line = json.dumps(
                    {"kind": k, "event": event, "obj": codec.encode(obj)}
                )
                h.wfile.write(line.encode() + b"\n")
                h.wfile.flush()
                watch_events_sent.inc(path="subscription")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            unsub()
            watch_clients.inc(-1)
