"""Client transports for the control-plane serving seam (the port's copy of
server/remote.py; the same routes, bodies and error mapping, so a port
client talks to a JAX-package server and the reverse).

`RemoteStore` implements the Store surface (create/get/try_get/list/update/
apply/delete/watch/watch_all/kinds) over the HTTP API, so anything built
against the in-process store — the pull agent, controllers, the CLI — runs
out-of-process unchanged. `RemoteControlPlane` is the karmadactl-facing
facade: store + settle + the member-object view the promote verb reads
(the reference CLI's cluster-proxy path, pkg/karmadactl/promote).

Watch streams run on daemon threads reading JSON lines; each handler is
delivered events in arrival order. `close()` tears the streams down.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Callable, Iterable, Optional
from urllib.error import HTTPError
from urllib.parse import quote, urlparse
from urllib.request import Request, urlopen

from ..api.unstructured import Unstructured
from ..faults.policy import RetryPolicy
from ..store.store import BatchError, BatchOpResult, ConflictError, NotFoundError, gvk_of
from . import codec, wirecodec

# Write-retry backoff after a possible failover window: full-jitter with a
# cap, so N clients retrying into a promotion don't form a synchronized
# thundering herd (docs/ROBUSTNESS.md backoff audit). Attempts/deadline are
# enforced by the call sites' own loops, not by `run()`.
WRITE_RETRY = RetryPolicy(base_delay=0.2, max_delay=2.0, multiplier=2.0)
BATCH_RETRY = RetryPolicy(base_delay=0.1, max_delay=1.0, multiplier=2.0)


class RemoteError(RuntimeError):
    """Non-CRUD failure on the serving seam (transport or server error)."""


class AdmissionDeniedRemote(RemoteError):
    """Server-side admission chain rejected the operation (HTTP 422)."""


class ContinueExpiredRemote(RemoteError):
    """The server expired this list's continue token (HTTP 410); the
    paginated crawl restarts from the beginning."""


class LeaderRedirect(ConflictError):
    """A write hit a replication FOLLOWER (or a just-deposed leader): the
    409 body named the current leader. The client re-points its write
    base and retries — docs/HA.md replicated topology."""

    def __init__(self, message: str, leader_url: str):
        super().__init__(message)
        self.leader_url = leader_url


# default list page size: large enough that small fleets still list in one
# round-trip, small enough that a 40k-binding store never materializes as
# one response body on either side of the wire
DEFAULT_PAGE_SIZE = 500

# batch-write chunk: one POST /objects/batch per this many objects (one
# store lock hold + one WAL fsync server-side); sized so a chunk's request
# body stays well under a megabyte for typical bindings/works
DEFAULT_BATCH_CHUNK = 256


class _NoBatchRoute(Exception):
    """The server predates POST /objects/batch (404): fall back to the
    per-object calls so new clients keep working against old daemons."""


class RemoteStore:
    # how long an unreachable replica sits out of the read rotation
    REPLICA_COOLDOWN_S = 15.0

    def __init__(self, base_url: str, timeout: float = 30.0,
                 token: Optional[str] = None, cafile: Optional[str] = None,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 replicas: Optional[Iterable[str]] = None,
                 read_preference: str = "leader",
                 wire: str = "auto"):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token
        self.cafile = cafile
        # negotiated wire codec (server/wirecodec.py). "auto": watch
        # streams send Accept for the binary framing and follow whatever
        # Content-Type the server answers with (a pre-binary server
        # answers json-lines — observable, never assumed), and POST
        # bodies upgrade to the framed binary codec only AFTER a response
        # carried the X-Karmada-Wire advertise header. "json" pins the
        # plain-JSON parity baseline everywhere. A 400/415 answer to a
        # binary body downgrades stickily (a middlebox or downgraded
        # server mid-rollout must not fail every later write).
        self._wire = wire
        self._wire_seen = False
        self._wire_down = False
        # list() auto-paginates in chunks of this many objects (0 = one
        # unpaginated request — also what pre-pagination servers serve)
        self.page_size = page_size
        # replicated topology (docs/HA.md): follower endpoints for read
        # routing. read_preference "leader" (default) keeps every call on
        # base_url; "follower" round-robins GET /objects, list crawls,
        # and watch streams across the replicas (identical rvs — the
        # follower consistency contract), falling back to the leader when
        # a replica is unreachable. Writes ALWAYS go to the leader, and a
        # 409 naming a new leader re-points them automatically.
        self._replicas = [u.rstrip("/") for u in (replicas or [])]
        self.read_preference = read_preference
        self._rr = itertools.count()
        # replica -> monotonic deadline while it sits out of the read
        # rotation (an unreachable replica must not cost every Nth read
        # a connect timeout forever)
        self._replica_cooldown: dict[str, float] = {}
        self._ssl_ctx = None
        if self.base_url.startswith("https"):
            import ssl

            # verify against the cluster CA the daemon's --tls-dir emitted
            # (the kubeconfig certificate-authority role); without a cafile
            # the default trust store applies and a self-signed CA fails —
            # honest, not bypassed
            self._ssl_ctx = ssl.create_default_context(cafile=cafile)
        # fault-plan site name for this client's HTTP boundary
        self._fault_target = urlparse(self.base_url).netloc or "control-plane"
        self._watch_threads: list[threading.Thread] = []
        self._streams: list[tuple[str, Any, threading.Event]] = []
        self._closed = False
        # per-thread X-Karmada-Trace value for the LOGICAL write in flight
        # (set by the _write_call/_write_chunk retry loops so every retry
        # and redirect re-send carries the same span id; thread-local
        # because one RemoteStore serves many threads)
        self._trace_tl = threading.local()
        # leader-election fence: while set, every request carries
        # X-Karmada-Fencing so a deposed holder's writes bounce with 409
        self._fence: Optional[str] = None

    # -- transport --------------------------------------------------------

    def set_fence(self, lease_name: str, token: int,
                  namespace: str = "") -> None:
        """Stamp subsequent requests with this lease's fencing token (the
        elector's on_started_leading hook). token 0 clears (legacy planes
        without a lease API mint no tokens)."""
        from ..coordination.lease import format_fence_header

        if not token:
            self._fence = None
            return
        from ..api.coordination import LEADER_LEASE_NAMESPACE

        self._fence = format_fence_header(
            lease_name, token, namespace or LEADER_LEASE_NAMESPACE
        )

    def clear_fence(self) -> None:
        self._fence = None

    def _headers(self, with_content: bool,
                 trace_header: Optional[str] = None) -> dict:
        headers = {"Content-Type": "application/json"} if with_content else {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        if self._fence:
            headers["X-Karmada-Fencing"] = self._fence
        if trace_header:
            headers["X-Karmada-Trace"] = trace_header
        return headers

    # -- negotiated body codec (server/wirecodec.py) ----------------------

    def _wire_upgrade_ok(self) -> bool:
        """True when POST/PUT bodies should ship as binary frames: the
        server advertised support and nothing has forced a downgrade."""
        return (self._wire == "auto" and self._wire_seen
                and not self._wire_down)

    def _note_wire(self, value: Optional[str]) -> None:
        """Learn binary-codec support from any response's advertise
        header — one successful call (even a GET) upgrades every later
        write body on this client."""
        if value and not self._wire_seen:
            self._wire_seen = True

    def _encode_body(self, body: dict) -> tuple[bytes, Optional[str], bool]:
        """(request bytes, content-type override, sent-binary flag)."""
        if self._wire_upgrade_ok():
            return (wirecodec.pack_message(body),
                    wirecodec.CONTENT_TYPE_BIN, True)
        return json.dumps(body).encode(), None, False

    @staticmethod
    def _trace_header() -> Optional[str]:
        """X-Karmada-Trace value for ONE logical write, minted from the
        thread's active trace context (tracing.trace_context). Computed
        ONCE before any retry loop: replays and redirect re-sends then
        carry the same span id, and the serving plane dedups them to
        exactly one commit span."""
        from ..tracing import (
            current_context,
            format_trace_header,
            new_span_id,
        )

        ctx = current_context()
        if ctx is None:
            return None
        trace_id, _parent, sampled = ctx
        return format_trace_header(trace_id, new_span_id(), sampled)

    def _call(self, method: str, path: str, body: Optional[dict] = None,
              *, base: Optional[str] = None,
              trace_header: Optional[str] = None) -> dict:
        # chaos hook: the HTTP process boundary (faults/plan.py). A decision
        # surfaces as the same RemoteError a real transport failure raises,
        # so every consumer's error handling is exercised, not special-cased.
        from .. import faults

        target = (urlparse(base).netloc if base else self._fault_target)
        try:
            faults.check(faults.BOUNDARY_HTTP, target or "control-plane")
        except faults.InjectedFault as e:
            raise RemoteError(f"control plane unreachable: {e}") from None
        data, ctype, sent_bin = (None, None, False)
        if body is not None:
            data, ctype, sent_bin = self._encode_body(body)
        th = trace_header or getattr(self._trace_tl, "header", None)
        headers = self._headers(data is not None, th)
        if ctype:
            headers["Content-Type"] = ctype
        req = Request(
            (base or self.base_url) + path, data=data, method=method,
            headers=headers,
        )
        try:
            with urlopen(req, timeout=self.timeout,
                         context=self._ssl_ctx) as resp:
                self._note_wire(resp.headers.get(wirecodec.HEADER_WIRE))
                return json.loads(resp.read().decode() or "{}")
        except HTTPError as e:
            try:
                payload = json.loads(e.read().decode())
            except Exception:  # noqa: BLE001
                payload = {}
            if not isinstance(payload, dict):
                payload = {}
            msg = payload.get("error", str(e))
            if sent_bin and wirecodec.body_rejected(e.code, msg):
                # the binary body bounced (pre-binary middlebox, or the
                # server rolled back mid-session): downgrade stickily and
                # replay this one request as plain JSON — a genuine bad
                # request then fails the same way it always did
                self._wire_down = True
                return self._call(method, path, body, base=base,
                                  trace_header=trace_header)
            if e.code == 404:
                raise NotFoundError(msg) from None
            if e.code == 409:
                if payload.get("leader_url"):
                    raise LeaderRedirect(msg, payload["leader_url"]) from None
                raise ConflictError(msg) from None
            if e.code == 410:
                raise ContinueExpiredRemote(msg) from None
            if e.code == 422:
                raise AdmissionDeniedRemote(msg) from None
            err = RemoteError(f"HTTP {e.code}: {msg}")
            err.code = e.code
            raise err from None
        except OSError as e:
            raise RemoteError(f"control plane unreachable: {e}") from None

    # -- replicated-topology routing (docs/HA.md) --------------------------

    def _read_base(self) -> str:
        """Base URL for the next read: round-robin across replicas when
        follower reads are preferred (skipping any sitting out a failure
        cooldown), else the leader."""
        if not self._replicas or self.read_preference == "leader":
            return self.base_url
        now = time.monotonic()
        for _ in range(len(self._replicas)):
            base = self._replicas[next(self._rr) % len(self._replicas)]
            if self._replica_cooldown.get(base, 0.0) <= now:
                return base
        return self.base_url  # every replica is cooling down

    def _read_call(self, path: str) -> dict:
        base = self._read_base()
        if base != self.base_url:
            try:
                return self._call("GET", path, base=base)
            except RemoteError:
                # replica unreachable: bench it briefly and fall back to
                # the leader (without the cooldown a hung replica costs
                # every rotation hit a full connect timeout, forever)
                self._replica_cooldown[base] = (
                    time.monotonic() + self.REPLICA_COOLDOWN_S)
        return self._call("GET", path)

    def _set_base(self, url: str) -> None:
        self.base_url = url.rstrip("/")
        self._fault_target = urlparse(self.base_url).netloc or "control-plane"

    def _repoint(self, leader_url: str) -> None:
        url = leader_url.rstrip("/")
        if url and url != self.base_url:
            old = self.base_url
            self._set_base(url)
            if self.read_preference != "leader" and old not in self._replicas:
                # the deposed leader usually re-joins as a follower: keep
                # it in the read rotation rather than forgetting it
                self._replicas.append(old)

    def _write_call(self, method: str, path: str,
                    body: Optional[dict] = None) -> dict:
        """A write against the leader, following leader redirects (we
        dialed a follower, or leadership moved since our last write).

        A redirect can be STALE during a failover window: the follower
        still advertises the dead leader until the promoted one's first
        append reaches it. An unreachable redirect target therefore falls
        back to the origin and re-asks after a short wait — the follower
        learns the new leader from the promotion's append stream and the
        next redirect lands.

        Honesty on replays: once a post-redirect attempt failed with a
        transport error, the request MAY have landed. A later attempt
        answering 409 could then be our own replay's conflict — that
        surfaces as a RemoteError (outcome unknown, the pre-redirect
        contract), never as a definite-looking ConflictError."""
        origin = self.base_url
        ambiguous: Optional[RemoteError] = None
        # one span id across every retry/redirect of this logical write —
        # carried thread-locally so monkeypatched/stubbed transports keep
        # working (the receiver dedups replays to one commit span)
        self._trace_tl.header = self._trace_header()
        try:
            for attempt in range(5):
                try:
                    return self._call(method, path, body)
                except LeaderRedirect as e:
                    self._repoint(e.leader_url)
                except ConflictError:
                    if ambiguous is not None:
                        raise RemoteError(
                            f"write outcome unknown: a retry after "
                            f"'{ambiguous}' answered 409, which may be our "
                            f"own landed request's replay") from ambiguous
                    raise
                except RemoteError as e:
                    if self.base_url == origin:
                        raise  # not a redirect problem: surface as before
                    ambiguous = e
                    self._set_base(origin)
                    time.sleep(WRITE_RETRY.delay(attempt))
            raise ambiguous or RemoteError(
                "write: leader redirects exhausted")
        finally:
            self._trace_tl.header = None

    def replication_status(self) -> dict:
        """GET /replication/status on the write base — role, applied rv,
        and (on a leader) per-follower lag."""
        return self._call("GET", "/replication/status")

    @staticmethod
    def _okey(kind: str, name: str = "", namespace: str = "") -> str:
        parts = [f"kind={quote(kind, safe='')}"]
        if name:
            parts.append(f"name={quote(name, safe='')}")
        if namespace:
            parts.append(f"namespace={quote(namespace, safe='')}")
        return "/objects?" + "&".join(parts)

    # -- Store surface ----------------------------------------------------

    def create(self, obj: Any) -> Any:
        return codec.decode(self._write_call("POST", "/objects", {"obj": codec.encode(obj)})["obj"])

    def update(self, obj: Any, *, check_rv: bool = False) -> Any:
        return codec.decode(self._write_call(
            "PUT", "/objects", {"obj": codec.encode(obj), "check_rv": check_rv}
        )["obj"])

    def apply(self, obj: Any) -> Any:
        return codec.decode(self._write_call("POST", "/apply", {"obj": codec.encode(obj)})["obj"])

    # -- transactional batch writes (POST /objects/batch) ------------------

    def _call_batch(self, body: dict,
                    trace_header: Optional[str] = None) -> dict:
        """One batch round-trip. 4xx answers carrying per-object results
        raise the store's own BatchError so remote and in-process callers
        share one failure vocabulary; 404 (a pre-batch server) raises
        _NoBatchRoute for the per-object fallback."""
        from .. import faults

        try:
            faults.check(faults.BOUNDARY_HTTP, self._fault_target)
        except faults.InjectedFault as e:
            raise RemoteError(f"control plane unreachable: {e}") from None
        data, ctype, sent_bin = self._encode_body(body)
        th = trace_header or getattr(self._trace_tl, "header", None)
        headers = self._headers(True, th)
        if ctype:
            headers["Content-Type"] = ctype
        req = Request(
            self.base_url + "/objects/batch", data=data, method="POST",
            headers=headers,
        )
        try:
            with urlopen(req, timeout=self.timeout,
                         context=self._ssl_ctx) as resp:
                self._note_wire(resp.headers.get(wirecodec.HEADER_WIRE))
                return json.loads(resp.read().decode() or "{}")
        except HTTPError as e:
            try:
                payload = json.loads(e.read().decode())
            except Exception:  # noqa: BLE001
                payload = {}
            if not isinstance(payload, dict):
                payload = {}
            msg = payload.get("error", str(e))
            if (sent_bin and "results" not in payload
                    and wirecodec.body_rejected(e.code, msg)):
                # codec-level rejection (no per-object results): sticky
                # downgrade and replay as JSON — see _call
                self._wire_down = True
                return self._call_batch(body, trace_header=trace_header)
            if e.code == 404:
                raise _NoBatchRoute(msg) from None
            results = payload.get("results")
            if e.code in (400, 409, 422) and results is not None:
                raise BatchError(msg, [
                    BatchOpResult(ok=bool(r.get("ok")),
                                  reason=r.get("reason", ""),
                                  error=r.get("error", ""))
                    for r in results
                ]) from None
            if e.code == 409:
                if payload.get("leader_url"):
                    raise LeaderRedirect(msg, payload["leader_url"]) from None
                raise ConflictError(msg) from None
            if e.code == 422:
                raise AdmissionDeniedRemote(msg) from None
            err = RemoteError(f"HTTP {e.code}: {msg}")
            err.code = e.code
            raise err from None
        except OSError as e:
            raise RemoteError(f"control plane unreachable: {e}") from None

    def create_batch(self, objs: Iterable[Any], *,
                     chunk: int = DEFAULT_BATCH_CHUNK) -> list[Any]:
        """Batched create with auto-chunking: one POST per `chunk` objects
        (one lock hold + one fsync server-side each). A chunk replayed
        after a transport timeout is IDEMPOTENT: objects the lost-response
        attempt already committed come back as 409 conflicts with typed
        results — those are treated as satisfied-by-replay (the server's
        copy is fetched), and only the remainder is re-sent, so a retry can
        never double-create. First-attempt conflicts still raise."""
        return self._write_batch("create", list(objs), chunk=chunk)

    def apply_batch(self, objs: Iterable[Any], *,
                    chunk: int = DEFAULT_BATCH_CHUNK) -> list[Any]:
        """Batched create-or-update with auto-chunking; replay-safe by
        construction (apply is idempotent), so transport failures retry the
        whole chunk."""
        return self._write_batch("apply", list(objs), chunk=chunk)

    def update_batch(self, objs: Iterable[Any], *, check_rv: bool = False,
                     skip_missing: bool = False, skip_stale: bool = False,
                     chunk: int = DEFAULT_BATCH_CHUNK) -> list[Optional[Any]]:
        """Batched update. With `skip_stale`, rv-mismatched slots skip
        (None) instead of failing the batch — which also makes a
        transport-retry replay benign: the first attempt's own commits
        surface as skipped slots, not a 409. Plain `check_rv` retry
        caveat: a replayed chunk whose lost-response attempt committed
        answers conflict for its own writes."""
        return self._write_batch("update", list(objs), chunk=chunk,
                                 check_rv=check_rv, skip_missing=skip_missing,
                                 skip_stale=skip_stale)

    def get_batch(self, kind: str, keys: Iterable[tuple[str, str]], *,
                  chunk: int = DEFAULT_BATCH_CHUNK) -> list[Optional[Any]]:
        """Batched point reads: [(name, namespace), ...] -> [obj | None] in
        one round-trip per chunk (the coalesced patch path's read half)."""
        keys = list(keys)
        out: list[Optional[Any]] = []
        step = max(1, chunk)
        for s in range(0, len(keys), step):
            ch = keys[s:s + step]
            try:
                resp = self._call_batch({
                    "op": "get", "kind": kind,
                    "keys": [[n, ns] for n, ns in ch],
                })
                out.extend(None if o is None else codec.decode(o)
                           for o in resp["objs"])
            except _NoBatchRoute:
                out.extend(self.try_get(kind, n, ns) for n, ns in ch)
        return out

    def _write_batch(self, op: str, objs: list, *, chunk: int,
                     check_rv: bool = False, skip_missing: bool = False,
                     skip_stale: bool = False) -> list:
        out: list = []
        step = max(1, chunk)
        for s in range(0, len(objs), step):
            out.extend(self._write_chunk(op, objs[s:s + step],
                                         check_rv, skip_missing, skip_stale))
        return out

    def _write_chunk(self, op: str, objs: list, check_rv: bool,
                     skip_missing: bool, skip_stale: bool = False) -> list:
        payload: dict = {"op": op, "objs": [codec.encode(o) for o in objs]}
        if op == "update":
            payload["check_rv"] = check_rv
            payload["skip_missing"] = skip_missing
            payload["skip_stale"] = skip_stale
        attempted = False
        origin = self.base_url
        # one span id for this chunk's every retry (thread-local so stubbed
        # transports inherit it): replays dedup server-side
        prev_th = getattr(self._trace_tl, "header", None)
        self._trace_tl.header = self._trace_header()
        try:
            return self._send_chunk(op, objs, payload, origin, attempted,
                                    check_rv, skip_missing, skip_stale)
        finally:
            self._trace_tl.header = prev_th

    def _send_chunk(self, op, objs, payload, origin, attempted,
                    check_rv, skip_missing, skip_stale) -> list:
        for attempt in range(4):
            try:
                resp = self._call_batch(payload)
                return [None if o is None else codec.decode(o)
                        for o in resp["objs"]]
            except LeaderRedirect as e:
                # we dialed a follower (or the leader moved): re-point and
                # burn this attempt on the redirect, not on a backoff
                self._repoint(e.leader_url)
                continue
            except _NoBatchRoute:
                return self._batch_fallback(op, objs, check_rv, skip_missing)
            except BatchError as e:
                if (op == "create" and attempted
                        and len(e.results) == len(objs)
                        and any(r.reason == "conflict" for r in e.results)
                        and all(r.reason in ("conflict", "aborted", "skipped")
                                for r in e.results if not r.ok)):
                    # replayed chunk after a lost response: the conflicts
                    # are (with create's all-or-nothing, nothing ELSE can
                    # have committed them mid-retry except our own first
                    # attempt or a racing creator — either way the object
                    # exists) satisfied-by-replay. Fetch their server copy,
                    # re-send only the rest.
                    conflicted = [r.reason == "conflict" for r in e.results]
                    rest = [o for o, c in zip(objs, conflicted) if not c]
                    rest_out = (self._write_chunk("create", rest, check_rv,
                                                  skip_missing, skip_stale)
                                if rest else [])
                    it = iter(rest_out)
                    return [
                        self.try_get(gvk_of(o), o.metadata.name,
                                     o.metadata.namespace)
                        if c else next(it)
                        for o, c in zip(objs, conflicted)
                    ]
                raise
            except RemoteError:
                # transport failure: the request may or may not have landed.
                # apply/update replays are idempotent; create replays are
                # made idempotent by the conflict handling above. If a
                # REDIRECT pointed us at a dead ex-leader (failover
                # window), return to the origin — it learns the new
                # leader from the promotion's append stream.
                attempted = True
                if self.base_url != origin:
                    self._set_base(origin)
                if attempt == 3:
                    raise
                time.sleep(BATCH_RETRY.delay(attempt))
        raise RemoteError("batch write: retries exhausted")  # unreachable

    def _batch_fallback(self, op: str, objs: list, check_rv: bool,
                        skip_missing: bool) -> list:
        """Pre-batch server: per-object round-trips with the same per-op
        semantics (the old write path, one request per object)."""
        out: list = []
        for o in objs:
            if op == "create":
                out.append(self.create(o))
            elif op == "apply":
                out.append(self.apply(o))
            else:
                try:
                    out.append(self.update(o, check_rv=check_rv))
                except NotFoundError:
                    if not skip_missing:
                        raise
                    out.append(None)
        return out

    def get(self, kind: str, name: str, namespace: str = "", *,
            min_rv: int = 0) -> Any:
        """Point read, routed by read preference. `min_rv` is the
        read-your-writes barrier: the serving plane (typically a
        follower) blocks until it has applied at least that
        resourceVersion before answering — pass the rv a prior write
        returned to read your own write through a lagging replica."""
        path = self._okey(kind, name, namespace)
        if min_rv > 0:
            path += f"&min_rv={min_rv}"
        return codec.decode(self._read_call(path)["obj"])

    def try_get(self, kind: str, name: str, namespace: str = "", *,
                min_rv: int = 0) -> Optional[Any]:
        try:
            return self.get(kind, name, namespace, min_rv=min_rv)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: str = "", *,
             page_size: Optional[int] = None, min_rv: int = 0) -> list[Any]:
        """Auto-paginating list: pages of `page_size` ride limit=/continue=
        tokens pinned server-side to ONE snapshot revision, so the result
        is revision-consistent however many round-trips it took. A server
        without pagination support ignores the limit and answers in full
        (no continue token ends the loop); an expired token (410) restarts
        the crawl from scratch.

        Routed by read preference (each crawl is sticky to one plane —
        continue tokens pin a snapshot there); `min_rv` waits out
        replication lag before the first page."""
        size = self.page_size if page_size is None else page_size
        base = self._okey(kind, namespace=namespace)
        if min_rv > 0:
            base += f"&min_rv={min_rv}"
        if size <= 0:
            out = self._read_call(base)
            return [codec.decode(o) for o in out["items"]]
        for _ in range(3):  # expired-token restarts
            items: list[Any] = []
            token = ""
            crawl_base = self._read_base()
            try:
                while True:
                    path = base + f"&limit={size}"
                    if token:
                        path += f"&continue={quote(token, safe='')}"
                    try:
                        out = self._call("GET", path, base=crawl_base)
                    except RemoteError:
                        if crawl_base == self.base_url:
                            raise
                        # replica died mid-crawl: restart on the leader
                        crawl_base = self.base_url
                        items, token = [], ""
                        continue
                    items.extend(codec.decode(o) for o in out["items"])
                    token = out.get("continue") or ""
                    if not token:
                        return items
            except ContinueExpiredRemote:
                continue
        raise RemoteError(
            f"list {kind}: continue token kept expiring mid-crawl "
            f"(snapshot TTL shorter than the crawl?)"
        )

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        self._write_call("DELETE", self._okey(kind, name, namespace))

    def kinds(self) -> list[str]:
        return self._call("GET", "/kinds")["kinds"]

    # -- leader election (the Elector's lease-client protocol) ------------

    def acquire_lease(self, name: str, identity: str,
                      duration: float = 0.0, namespace: str = ""):
        body = {"name": name, "identity": identity}
        if duration:
            body["duration"] = duration
        if namespace:
            body["namespace"] = namespace
        # lease CAS is a store write: a replication follower 409-redirects
        # it to the leader (an election must never mint follower-local
        # rvs), and _write_call follows — electors work against any plane
        out = self._write_call("POST", "/leases/acquire", body)
        return codec.decode(out["lease"]), bool(out["acquired"])

    def renew_lease(self, name: str, identity: str, token: int,
                    namespace: str = ""):
        body = {"name": name, "identity": identity, "token": token}
        if namespace:
            body["namespace"] = namespace
        return codec.decode(
            self._write_call("POST", "/leases/renew", body)["lease"])

    def release_lease(self, name: str, identity: str, token: int,
                      namespace: str = "") -> None:
        body = {"name": name, "identity": identity, "token": token}
        if namespace:
            body["namespace"] = namespace
        self._write_call("POST", "/leases/release", body)

    def elections(self) -> list[Any]:
        return [codec.decode(x)
                for x in self._call("GET", "/elections")["items"]]

    # -- watch ------------------------------------------------------------

    def watch(self, kind: str, handler: Callable[[str, Any], None], *,
              replay: bool = True, namespace: str = "") -> None:
        self._start_stream(
            kind, replay, lambda k, ev, obj: handler(ev, obj),
            namespace=namespace, handler_key=handler,
        )

    def watch_all(self, handler: Callable[[str, str, Any], None], *,
                  replay: bool = True, namespace: str = "") -> None:
        self._start_stream("*", replay, handler, namespace=namespace,
                           handler_key=handler)

    def unwatch(self, kind: str, handler: Callable) -> None:
        """Stop the stream(s) registered for (kind, handler) — the Store
        surface's unwatch, so bounded consumers (get -w) don't leak
        reconnect threads against the daemon."""
        for k, h, stop in self._streams:
            if k == kind and h == handler:
                stop.set()

    def _start_stream(self, kind: str, replay: bool,
                      deliver: Callable[[str, str, Any], None],
                      namespace: str = "", handler_key: Any = None) -> None:
        import http.client

        stop = threading.Event()
        self._streams.append((kind, handler_key, stop))

        def done() -> bool:
            return self._closed or stop.is_set()

        # highest resourceVersion this stream has fully DELIVERED: on
        # re-attach it rides the wire as `since=<rv>` so the server's watch
        # cache resumes with only the missed delta instead of a full replay
        # (an event whose handler failed does not advance it — the
        # re-attach re-delivers exactly that event). Pre-cache servers
        # ignore `since`; `replay=1` keeps them converging the old way.
        last_rv = [0]

        def attach(with_replay: bool, since: int) -> Optional[int]:
            """One stream attachment; returns the HTTP status (None when the
            request itself failed before a response arrived)."""
            from .. import faults

            # replicated topology: each attach re-picks a read base, so a
            # stream re-attaching after a replica died rotates to the next
            # one (rvs are identical across replicas — the since= cursor
            # stays valid wherever the stream lands)
            url = urlparse(self._read_base())
            try:
                # watch re-attach rides the same HTTP fault site as _call;
                # an injected fault presents as the transport failure the
                # retry loop already classifies
                faults.check(faults.BOUNDARY_HTTP,
                             url.netloc or self._fault_target)
            except faults.InjectedFault as e:
                raise OSError(str(e)) from None
            path = (f"/watch?kind={quote(kind, safe='')}"
                    f"&replay={'1' if with_replay else '0'}")
            if since > 0:
                path += f"&since={since}"
            if namespace:
                path += f"&namespace={quote(namespace, safe='')}"
            # the server heartbeats every 0.5s; a read stalling 10x that is
            # a half-open connection (host died without RST) — time out and
            # let the outer loop re-attach with replay
            if self._ssl_ctx is not None:
                conn = http.client.HTTPSConnection(
                    url.hostname, url.port, timeout=5.0,
                    context=self._ssl_ctx,
                )
            else:
                conn = http.client.HTTPConnection(
                    url.hostname, url.port, timeout=5.0
                )
            try:
                headers = self._headers(False)
                if self._wire != "json":
                    # ask for the binary framing; the server's answering
                    # Content-Type decides (pre-binary servers answer
                    # json-lines and the JSON loop below runs unchanged)
                    headers["Accept"] = wirecodec.CONTENT_TYPE_BIN
                conn.request("GET", path, headers=headers)
                resp = conn.getresponse()
                if resp.status != 200:
                    return resp.status
                self._note_wire(resp.getheader(wirecodec.HEADER_WIRE))
                if wirecodec.is_binary_content_type(
                        resp.getheader("Content-Type")):
                    return self._attach_binary(resp, kind, deliver, done,
                                               last_rv)
                buf = b""
                while not done():
                    chunk = resp.read1(65536)
                    if not chunk:
                        return 200  # server closed (shutdown or overflow)
                    buf += chunk
                    while b"\n" in buf:
                        line, _, buf = buf.partition(b"\n")
                        if not line.strip():
                            continue  # heartbeat
                        msg = json.loads(line.decode())
                        try:
                            # decode stays INSIDE the try: an undecodable
                            # event (codec skew) must end the attachment
                            # for a resync, not kill this thread
                            obj = codec.decode(msg["obj"])
                            deliver(msg["kind"], msg["event"], obj)
                        except Exception:  # noqa: BLE001 - handler fault
                            # a handler doing its own I/O can fail
                            # transiently (chaos plans inject exactly
                            # this). Dropping the event would silently
                            # lose it forever if nothing changes
                            # server-side again, and letting it propagate
                            # used to KILL the thread — instead, end this
                            # attachment cleanly: the outer loop
                            # re-attaches WITH replay, re-delivering the
                            # full state so the level-triggered handler
                            # gets another shot at the missed key.
                            import logging

                            logging.getLogger(__name__).exception(
                                "watch %s: handler failed for one event; "
                                "re-attaching to resume it", kind,
                            )
                            return 200
                        rv = msg.get("rv") or obj.metadata.resource_version
                        if rv and rv > last_rv[0]:
                            last_rv[0] = rv
                return 200
            finally:
                conn.close()

        def run() -> None:
            # informer semantics: a dropped stream re-attaches with
            # `since=<last delivered rv>` — the server's ring resumes with
            # only the missed delta; when it can't (compaction, old server)
            # the replay=1 fallback is the full relist/resync that makes
            # level-triggered consumers converge despite missed deltas.
            # Non-200 responses are LOGGED (at least once per distinct
            # status) and retried with exponential backoff instead of a
            # silent fixed 0.5 s spin; 401/403 are authorization failures
            # that no amount of retrying fixes, so the stream surfaces them
            # as a hard error and terminates.
            import logging

            from ..faults.policy import Backoff

            log = logging.getLogger(__name__)
            first = True
            # the unified backoff policy (faults/policy.py) replaces the
            # hand-rolled doubling counter: full jitter de-synchronizes a
            # fleet of daemons re-attaching to one restarted server. Two
            # envelopes, as before — transport failures cap low so a
            # restarting server is re-joined within a couple of seconds;
            # HTTP-level errors (5xx) back off for real.
            transport_bo = Backoff(base=0.5, cap=2.0)
            http_bo = Backoff(base=0.5, cap=30.0)
            logged: set[object] = set()
            while not done():
                status: Optional[int] = None
                err: Optional[Exception] = None
                try:
                    status = attach(replay if first else True,
                                    0 if first else last_rv[0])
                except (OSError, json.JSONDecodeError) as e:
                    err = e
                first = False
                if status in (401, 403):
                    log.error(
                        "watch %s: HTTP %d from %s — authorization failure, "
                        "stream terminated (check the bearer token)",
                        kind, status, self.base_url,
                    )
                    stop.set()
                    return
                if status == 200:
                    transport_bo.reset()
                    http_bo.reset()
                    wait = 0.5  # healthy stream ended: quick resync
                elif status is None:
                    # transport failure (connection refused, half-open
                    # timeout): log the first occurrence per stream
                    if "transport" not in logged:
                        logged.add("transport")
                        log.warning(
                            "watch %s: %s unreachable (%s); retrying",
                            kind, self.base_url, err,
                        )
                    wait = transport_bo.next()
                else:
                    if status not in logged:
                        logged.add(status)
                        log.warning(
                            "watch %s: HTTP %d from %s; retrying with backoff",
                            kind, status, self.base_url,
                        )
                    wait = http_bo.next()
                if not done():
                    stop.wait(wait)

        t = threading.Thread(target=run, name=f"watch-{kind}", daemon=True)
        t.start()
        self._watch_threads.append(t)

    def _attach_binary(self, resp, kind: str, deliver, done,
                       last_rv: list) -> int:
        """One binary-framed watch attachment (negotiated by response
        Content-Type). Tracks (rv, encoding) per key so FRAME_DELTA
        patches apply against the exact base the server diffed from —
        sound because the stream delivers each key's events in rv order,
        so the state after a contiguous stream through `base` IS the
        object at `base`. A base mismatch (compaction skew, codec bug)
        ends the attachment: the outer loop re-attaches with replay and
        the full snapshot heals the state. Returns the status-like code
        the JSON loop returns (always 200 here: stream ended)."""
        import logging

        reader = wirecodec.FrameReader()
        # (kind, namespace, name) -> (rv, wire encoding) for delta bases;
        # DELETED drops the key so the dict tracks live objects only
        state: dict[tuple, tuple[int, Any]] = {}
        while not done():
            chunk = resp.read1(65536)
            if not chunk:
                return 200  # server closed (shutdown or overflow)
            try:
                frames = list(reader.feed(chunk))
            except wirecodec.WireProtocolError:
                logging.getLogger(__name__).warning(
                    "watch %s: broken binary framing; re-attaching", kind)
                return 200
            for ftype, payload in frames:
                if ftype == wirecodec.FRAME_HEARTBEAT:
                    continue
                msg = json.loads(payload.decode())
                if ftype == wirecodec.FRAME_DELTA:
                    key = (msg["kind"], msg["ns"], msg["name"])
                    held = state.get(key)
                    if held is None or held[0] != msg["base"]:
                        logging.getLogger(__name__).warning(
                            "watch %s: delta base rv %s != held %s for "
                            "%s/%s; re-attaching for a replay resync",
                            kind, msg["base"],
                            held[0] if held else None,
                            msg["ns"], msg["name"])
                        return 200
                    enc = wirecodec.apply_patch(held[1], msg["patch"])
                elif ftype == wirecodec.FRAME_EVENT:
                    enc = msg["obj"]
                else:
                    continue  # unknown frame type: skip, stay attached
                try:
                    # decode inside the try — see the JSON loop
                    obj = codec.decode(enc)
                    key = (msg["kind"], obj.metadata.namespace or "",
                           obj.metadata.name)
                    deliver(msg["kind"], msg["event"], obj)
                except Exception:  # noqa: BLE001 - handler fault
                    logging.getLogger(__name__).exception(
                        "watch %s: handler failed for one event; "
                        "re-attaching to resume it", kind)
                    return 200
                if msg["event"] == "DELETED":
                    state.pop(key, None)
                else:
                    state[key] = (msg["rv"], enc)
                rv = msg.get("rv") or obj.metadata.resource_version
                if rv and rv > last_rv[0]:
                    last_rv[0] = rv
        return 200

    def close(self) -> None:
        self._closed = True


class _RemoteMember:
    """Read-only member view for verbs that inspect member objects
    (promote): backed by GET /member/objects — the cluster-proxy
    subresource of the aggregated apiserver (SURVEY U9)."""

    def __init__(self, store: RemoteStore, name: str):
        self._store = store
        self.name = name

    def objects(self) -> list[Unstructured]:
        out = self._store._call(
            "GET", f"/member/objects?cluster={quote(self.name, safe='')}"
        )
        return [Unstructured(d) for d in out["items"]]

    def get(self, api_version: str, kind: str, name: str,
            namespace: str = "") -> Optional[Unstructured]:
        for o in self.objects():
            if (o.api_version == api_version and o.kind == kind
                    and o.name == name
                    and (not namespace or o.namespace == namespace)):
                return o
        return None


class _RemoteMembers(dict):
    """Live mapping facade over GET /members."""

    def __init__(self, store: RemoteStore):
        super().__init__()
        self._store = store

    def _refresh(self) -> None:
        names = self._store._call("GET", "/members")["members"]
        super().clear()
        for n in names:
            super().__setitem__(n, _RemoteMember(self._store, n))

    # iteration always refreshes; keyed access only refreshes on a miss —
    # `for name in cp.members: cp.members[name]` costs ONE round-trip, not
    # N+1, while a just-joined member is still found

    def get(self, key, default=None):
        if not super().__contains__(key):
            self._refresh()
        return super().get(key, default)

    def __getitem__(self, key):
        if not super().__contains__(key):
            self._refresh()
        return super().__getitem__(key)

    def __contains__(self, key) -> bool:
        # membership checks always re-ask (an unjoined member must read as
        # gone); only get/getitem use the stale-snapshot fast path
        self._refresh()
        return super().__contains__(key)

    def keys(self):
        self._refresh()
        return super().keys()

    def values(self):
        self._refresh()
        return super().values()

    def items(self):
        self._refresh()
        return super().items()

    def __iter__(self):
        self._refresh()
        return iter(list(super().keys()))


class RemoteControlPlane:
    """What `karmadactl --server URL` hands to the command functions: the
    same attribute surface the in-process ControlPlane exposes for the
    verbs that are meaningful over the wire (store CRUD, settle, member
    views, join/unjoin). Anything deeper (in-process scheduler state,
    interpreter internals) raises AttributeError — those verbs require the
    daemon side, as in the reference where karmadactl is a pure API client."""

    def __init__(self, url: str, timeout: float = 30.0,
                 token: Optional[str] = None, cafile: Optional[str] = None,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 replicas: Optional[Iterable[str]] = None,
                 read_preference: str = "leader",
                 wire: str = "auto"):
        self.url = url.rstrip("/")
        self.store = RemoteStore(self.url, timeout=timeout, token=token,
                                 cafile=cafile, page_size=page_size,
                                 replicas=replicas,
                                 read_preference=read_preference,
                                 wire=wire)
        self.members = _RemoteMembers(self.store)

    def replication_status(self) -> dict:
        """GET /replication/status — the `karmadactl replication status`
        backing call (role, applied rv, per-follower lag on a leader)."""
        return self.store.replication_status()

    def settle(self, max_steps: int = 0) -> int:
        self.store._call("POST", "/settle")
        return 0

    def tick(self, seconds: float = 0.0) -> int:
        return int(self.store._call("POST", "/tick", {"seconds": seconds}).get("steps", 0))

    def join_member(self, config) -> None:
        self.store._call("POST", "/join", {"config": codec.encode(config)})

    def unjoin_member(self, name: str) -> None:
        self.store._call("POST", "/unjoin", {"name": name})

    def sign_agent_cert(self, cluster: str) -> dict:
        return self.store._call("POST", "/agent/cert", {"cluster": cluster})

    def simulate(self, request):
        """POST /simulate: the what-if plane over the wire — same signature
        as ControlPlane.simulate, so karmadactl simulate works identically
        in-process and against a daemon."""
        out = self.store._call(
            "POST", "/simulate", {"request": codec.encode(request)}
        )
        return codec.decode(out.get("report"))

    def search(self, params: dict, *, at_rv=None, trace_id: str = ""):
        """GET /search over the wire (ControlPlane.search's signature)."""
        raise NotImplementedError(
            "RemoteControlPlane.search: the columnar search plane "
            "(search/query.py) is not ported yet (ROADMAP queue A item 12)")

    def trace_of(self, namespace: str, name: str):
        """GET /traces?binding= — the `karmadactl trace binding` backing
        call over the wire; None when no trace is retained."""
        binding = f"{namespace}/{name}" if namespace else name
        try:
            out = self.store._call(
                "GET", f"/traces?binding={quote(binding, safe='')}"
            )
        except NotFoundError:
            return None
        return out.get("trace")

    def traces(self) -> list:
        return self.store._call("GET", "/traces").get("traces", [])

    def healthz(self) -> bool:
        try:
            return bool(self.store._call("GET", "/healthz").get("ok"))
        except RemoteError:
            return False

    def close(self) -> None:
        self.store.close()
