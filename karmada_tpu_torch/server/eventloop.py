"""Single-threaded event-loop watch serving (the async wire plane; the
port's copy of server/eventloop.py).

The threaded serving path parks one handler thread per watch stream in
`cache.wait()` — at fleet scale the thread stacks, the per-thread
condition-variable wakeups, and the GIL handoffs between thousands of
mostly-idle serving threads become the wall.
This module serves every handed-off stream from ONE thread:

- a `selectors.DefaultSelector` multiplexes all client sockets plus a
  self-pipe; the watch cache's `add_notify` hook (called on every ring
  append, non-blocking) writes one byte to the pipe to wake the loop;
- each connection is a cursor into the SAME revisioned ring the threaded
  path reads (`store/watchcache.py`) — pre-encoded event lines/frames are
  scattered to sockets via buffered non-blocking writes, so fan-out cost
  per client stays a filter check plus a send();
- a slow client gets a bounded per-socket byte queue
  (`SOCK_QUEUE_MAX_BYTES`): when it fills, the cursor simply stops
  advancing (the ring holds its backlog); if the ring then compacts past
  the cursor, the backlog is EVICTED in favor of the existing in-stream
  resync (snapshot replayed as ADDED events, delivered incrementally so
  the resync itself cannot blow the queue bound) — counted by
  `karmada_wire_queue_evictions_total`;
- heartbeats ride the loop timer: any stream byte-idle for
  `heartbeat_s` gets one heartbeat (b"\\n" for JSON, an empty
  FRAME_HEARTBEAT for binary) appended AT A FRAME BOUNDARY — the queue
  holds only complete frames/lines, so a heartbeat can never interleave
  into a partially-written delta frame (pinned by tests/test_wire.py);
- a socket that accepts no bytes for `STUCK_SOCKET_TIMEOUT_S` while
  bytes are pending is closed (the watch-path slow-loris bound; the
  soak's WireHealth invariant asserts none linger at verdict time).

Hand-off: the HTTP handler thread negotiates the codec, writes the
response headers (+ any replay snapshot) with ordinary blocking I/O, then
dup()s the connection into `WatchLoop.add` and returns — httpbase's
detach seam keeps socketserver's teardown from FIN-ing the shared
connection. TLS streams stay on the threaded path (an SSLSocket cannot be
dup()'d into byte-level non-blocking serving).
"""
from __future__ import annotations

import logging
import os
import selectors
import socket
import threading
import time
from typing import Optional

from ..analysis.lockorder import make_lock
from . import wirecodec

log = logging.getLogger(__name__)

# per-socket byte-queue bound: a slow client may hold at most this many
# undelivered bytes in process memory; past it the cursor stalls against
# the ring (and eventually resyncs) instead of growing the queue — the
# thread-hygiene analyzer asserts this constant gates every queue append
SOCK_QUEUE_MAX_BYTES = 256 * 1024

# no-progress bound for a socket with pending bytes (slow-loris reaping on
# the streaming path, mirroring httpbase.DEFAULT_SOCKET_TIMEOUT's role on
# the request path)
STUCK_SOCKET_TIMEOUT_S = 30.0

# ring events encoded per connection per pump round: bounds one client's
# share of a single loop iteration
LOOP_BATCH = 256


class _WireConn:
    """One handed-off watch stream: socket + ring cursor + bounded queue."""

    __slots__ = ("sock", "fd", "kind", "namespace", "wire", "cursor",
                 "chunks", "qbytes", "delta_floor", "resync",
                 "last_send", "last_progress", "wants_write", "fast")

    def __init__(self, sock: socket.socket, kind: str, namespace: str,
                 wire: str, cursor: int, delta_floor: int):
        self.sock = sock
        self.fd = sock.fileno()
        self.kind = kind
        self.namespace = namespace
        self.wire = wire                # "json" | "bin"
        self.cursor = cursor
        self.chunks: list[bytes] = []   # complete frames/lines only
        self.qbytes = 0
        # deltas are sound only against state THIS stream delivered (or a
        # snapshot it replayed): events with base_rv <= delta_floor go as
        # full frames. 0 after a snapshot replay (every base is held).
        self.delta_floor = delta_floor
        self.resync: Optional[object] = None  # in-stream resync iterator
        now = time.monotonic()
        self.last_send = now
        self.last_progress = now
        self.wants_write = False
        # fast = caught up to the loop's dispatch cursor and registered in
        # the route index: events are scattered to it as the ring is read
        # (once), and `cursor` is implicit until it lags again
        self.fast = False


class WatchLoop:
    def __init__(self, cache, heartbeat_s: float = 0.5,
                 queue_max_bytes: int = SOCK_QUEUE_MAX_BYTES):
        self._cache = cache
        self._heartbeat_s = heartbeat_s
        self._queue_max = queue_max_bytes
        self._sel: Optional[selectors.BaseSelector] = None
        self._rpipe = self._wpipe = -1
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._conns: dict[int, _WireConn] = {}
        # single-read dispatch state: `_tip` is the rv through which the
        # loop has read the ring ONCE and scattered events to caught-up
        # conns via the (kind, namespace) route index — a stream whose
        # filter doesn't match a write costs nothing for it, making a
        # fleet of namespace-scoped watchers O(events), not O(W x events)
        self._tip = 0
        self._routes: dict[tuple[str, str], set[_WireConn]] = {}
        # hand-off seam: handler threads append, the loop thread admits
        self._pending: list[_WireConn] = []
        self._pending_lock = make_lock("eventloop._pending")
        # counters surfaced by stats() (soak WireHealth + tests + bench)
        self._resyncs = 0
        self._evictions = 0
        self._stuck_closed = 0
        self._closed_total = 0
        self._closed_reasons: dict[str, int] = {}
        self._heartbeats = 0
        self._cpu_s = 0.0
        self._started = False

    # -- lifecycle (handler-thread side) ----------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._sel = selectors.DefaultSelector()
        self._rpipe, self._wpipe = os.pipe()
        os.set_blocking(self._rpipe, False)
        os.set_blocking(self._wpipe, False)
        self._sel.register(self._rpipe, selectors.EVENT_READ, None)
        self._tip = self._cache.current_rv
        self._cache.add_notify(self._wake)
        self._thread = threading.Thread(
            target=self._run, name="cp-watch-loop", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        self._cache.remove_notify(self._wake)
        self._stop = True
        self._wake()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def add(self, sock: socket.socket, *, kind: str, namespace: str,
            wire: str, cursor: int, delta_floor: int) -> None:
        """Hand a negotiated, headers-sent stream socket to the loop
        (any thread). The loop owns the socket from here."""
        sock.setblocking(False)
        conn = _WireConn(sock, kind, namespace, wire, cursor, delta_floor)
        with self._pending_lock:
            self._pending.append(conn)
        self._wake()

    def _wake(self) -> None:
        try:
            os.write(self._wpipe, b"x")
        except (BlockingIOError, OSError):
            pass  # pipe full = a wakeup is already pending / loop stopped

    def stats(self) -> dict:
        return {
            "connections": len(self._conns),
            "queue_bytes_max": max(
                (c.qbytes for c in self._conns.values()), default=0),
            "queue_bound": self._queue_max,
            "resyncs": self._resyncs,
            "evictions": self._evictions,
            "stuck_closed": self._stuck_closed,
            "closed_total": self._closed_total,
            "closed_reasons": dict(self._closed_reasons),
            "heartbeats": self._heartbeats,
            "cpu_s": round(self._cpu_s, 4),
        }

    # -- loop thread ------------------------------------------------------

    def _run(self) -> None:
        from ..metrics import wire_connections

        cpu0 = time.thread_time()
        last_sweep = time.monotonic()
        try:
            while not self._stop:
                timeout = self._heartbeat_s / 2
                for key, mask in self._sel.select(timeout):
                    if key.data is None:
                        try:
                            while os.read(self._rpipe, 4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                        continue
                    conn = key.data
                    if mask & selectors.EVENT_READ:
                        if not self._drain_read(conn):
                            continue  # closed
                    if mask & selectors.EVENT_WRITE:
                        self._flush(conn)
                self._admit(wire_connections)
                self._pump()
                now = time.monotonic()
                if now - last_sweep >= self._heartbeat_s / 2:
                    self._sweep(now)
                    last_sweep = now
                    self._cpu_s = time.thread_time() - cpu0
        except Exception:  # noqa: BLE001 - the loop must not die silently
            log.exception("watch loop crashed; closing %d streams",
                          len(self._conns))
        finally:
            for conn in list(self._conns.values()):
                self._close(conn, "shutdown")
            try:
                self._sel.close()
            except OSError:
                pass
            for fd in (self._rpipe, self._wpipe):
                try:
                    os.close(fd)
                except OSError:
                    pass

    def _admit(self, wire_connections) -> None:
        from ..metrics import watch_clients

        with self._pending_lock:
            fresh, self._pending = self._pending, []
        for conn in fresh:
            try:
                self._sel.register(conn.sock, selectors.EVENT_READ, conn)
            except (ValueError, OSError):
                conn.sock.close()
                continue
            self._conns[conn.fd] = conn
            if conn.cursor == self._tip:
                self._promote(conn)
            watch_clients.inc(1)
            wire_connections.inc(1, codec=conn.wire, loop="loop")

    def _promote(self, conn: _WireConn) -> None:
        conn.fast = True
        self._routes.setdefault(
            (conn.kind, conn.namespace), set()).add(conn)

    def _demote(self, conn: _WireConn, cursor: int) -> None:
        """Drop a stream out of the dispatch index, materializing its
        cursor at `cursor` (delivered through it) for the per-conn path."""
        if not conn.fast:
            return
        conn.fast = False
        conn.cursor = cursor
        key = (conn.kind, conn.namespace)
        bucket = self._routes.get(key)
        if bucket is not None:
            bucket.discard(conn)
            if not bucket:
                del self._routes[key]

    def _matches(self, kind: str, namespace: str) -> list[_WireConn]:
        """Fast-path streams whose (kind, namespace) filter admits an
        event with this shape — exact and wildcard buckets."""
        routes = self._routes
        out: list[_WireConn] = []
        for key in ((kind, namespace), (kind, ""),
                    ("*", namespace), ("*", "")):
            bucket = routes.get(key)
            if bucket:
                out.extend(bucket)
        return out

    def _drain_read(self, conn: _WireConn) -> bool:
        """A watch client never sends after its request; readable means
        close (EOF/RST) or ignorable stray bytes. False = conn closed."""
        try:
            data = conn.sock.recv(4096)
        except (BlockingIOError, InterruptedError):
            return True
        except OSError:
            self._close(conn, "read-error")
            return False
        if not data:
            self._close(conn, "client-eof")
            return False
        return True

    # -- queue fill (ring -> per-socket queue) ----------------------------

    def _pump(self) -> None:
        cache = self._cache
        compacted = cache.compacted_rv
        tip = cache.current_rv
        # fast dispatch: read each new ring event ONCE and scatter it to
        # every caught-up stream via the route index — a write a stream's
        # filter doesn't admit costs that stream nothing
        touched: set[_WireConn] = set()
        while self._tip < tip:
            events, cursor, ok = cache.events_since(
                self._tip, "*", "", limit=LOOP_BATCH)
            if not ok:
                # the dispatch cursor itself fell behind compaction (a
                # long pause): every fast stream is lagged — demote them
                # onto the per-conn path, which begins their resyncs
                for conn in [c for b in self._routes.values() for c in b]:
                    self._demote(conn, self._tip)
                self._tip = tip
                break
            prev = self._tip
            for ev in events:
                for conn in self._matches(ev.kind, ev.namespace):
                    data, is_delta = self._encode(conn, ev)
                    if conn.qbytes and \
                            conn.qbytes + len(data) > self._queue_max:
                        # queue full mid-dispatch: delivered through prev,
                        # the per-conn path takes over from there (an
                        # oversized single frame into an EMPTY queue still
                        # passes — the bound is on backlog, and stalling
                        # it would wedge the stream forever)
                        self._demote(conn, prev)
                        continue
                    self._enqueue(conn, data, is_delta)
                    touched.add(conn)
                prev = ev.rv
            self._tip = cursor
            if not events:
                break
        for conn in touched:
            if conn.fd in self._conns:
                self._flush(conn)
        # per-conn path: lagging, resyncing, or freshly admitted streams
        for conn in list(self._conns.values()):
            if conn.fast:
                continue
            if conn.resync is not None:
                self._pump_resync(conn)
                continue
            if conn.cursor < compacted and conn.cursor < tip:
                # the ring compacted past a stalled cursor: evict the
                # unreachable backlog in favor of an in-stream resync
                self._begin_resync(conn)
                self._pump_resync(conn)
                continue
            filled = False
            full = False
            while not full and conn.cursor < tip:
                events, cursor, ok = cache.events_since(
                    conn.cursor, conn.kind, conn.namespace,
                    limit=LOOP_BATCH)
                if not ok:
                    self._begin_resync(conn)
                    self._pump_resync(conn)
                    break
                for ev in events:
                    data, is_delta = self._encode(conn, ev)
                    if conn.qbytes and \
                            conn.qbytes + len(data) > self._queue_max:
                        # hard byte bound, checked per event: the ring
                        # keeps the backlog, the cursor records exactly
                        # how far we delivered (an oversized single frame
                        # into an EMPTY queue still passes — the bound is
                        # on backlog, not on one message)
                        full = True
                        break
                    self._enqueue(conn, data, is_delta)
                    conn.cursor = ev.rv
                    filled = True
                else:
                    # whole batch enqueued: jump past any trailing events
                    # the filter skipped
                    conn.cursor = cursor
                if not events:
                    break
            if filled:
                self._flush(conn)
            if (conn.resync is None and conn.fd in self._conns
                    and conn.qbytes < self._queue_max
                    and conn.cursor == self._tip):
                # fully caught up to the dispatch cursor: rejoin the
                # scatter index (strict equality — past it would double-
                # deliver, short of it would skip)
                self._promote(conn)

    def _begin_resync(self, conn: _WireConn) -> None:
        from ..metrics import watch_resyncs, wire_queue_evictions

        self._evictions += 1
        self._resyncs += 1
        wire_queue_evictions.inc(codec=conn.wire)
        watch_resyncs.inc(reason="lagged")
        rv, items = self._cache.snapshot(conn.kind, conn.namespace)
        conn.cursor = rv
        conn.resync = [0, list(items)]

    def _pump_resync(self, conn: _WireConn) -> None:
        """Feed the resync snapshot only as the queue drains — a resync of
        a huge kind must respect the same per-socket byte bound, checked
        per item (resync state is [next_index, items] so an item that
        doesn't fit simply waits for the next drain)."""
        idx, items = conn.resync
        while idx < len(items):
            item = items[idx]
            data = (item.added_frame() if conn.wire == "bin"
                    else item.added_line())
            if conn.qbytes and conn.qbytes + len(data) > self._queue_max:
                break
            self._enqueue(conn, data, False)
            idx += 1
        if idx < len(items):
            conn.resync[0] = idx
        else:
            conn.resync = None
            # every key the client now holds came from this snapshot
            # (or later): all future delta bases are provably held
            conn.delta_floor = 0
        self._flush(conn)

    @staticmethod
    def _encode(conn: _WireConn, ev) -> tuple[bytes, bool]:
        """(bytes, is_delta) for one live ring event on this stream."""
        if conn.wire == "bin":
            if ev._base_rv > conn.delta_floor:
                df = ev.delta_frame()
                if df is not None:
                    return df, True
            return ev.frame(), False
        return ev.line(), False

    def _enqueue(self, conn: _WireConn, data: bytes, is_delta: bool) -> None:
        from ..metrics import wire_bytes_sent

        conn.chunks.append(data)
        conn.qbytes += len(data)
        wire_bytes_sent.inc(len(data), codec=conn.wire,
                            delta="1" if is_delta else "0")

    # -- socket writes ----------------------------------------------------

    def _flush(self, conn: _WireConn) -> None:
        while conn.chunks:
            chunk = conn.chunks[0]
            try:
                n = conn.sock.send(chunk)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                log.warning("wire send failed (%s): closing stream", e)
                self._close(conn, "send-error")
                return
            if n <= 0:
                break
            conn.qbytes -= n
            now = time.monotonic()
            conn.last_send = now
            conn.last_progress = now
            if n < len(chunk):
                conn.chunks[0] = chunk[n:]
                break
            conn.chunks.pop(0)
        # keep write-interest while a backlog exists BEYOND the queue
        # (resync remainder, or a cursor short of the ring tip): the
        # chunks can drain straight into the OS socket buffer, and
        # without this the refill would only ride the sweep timer
        self._want_write(conn, bool(conn.chunks) or self._backlogged(conn))

    def _backlogged(self, conn: _WireConn) -> bool:
        """More to send than the byte-bounded queue could hold. Fast
        streams never backlog by construction (a full queue demotes)."""
        if conn.resync is not None:
            return True
        return not conn.fast and conn.cursor < self._cache.current_rv

    def _want_write(self, conn: _WireConn, want: bool) -> None:
        if want == conn.wants_write or conn.fd not in self._conns:
            return
        conn.wants_write = want
        mask = selectors.EVENT_READ
        if want:
            mask |= selectors.EVENT_WRITE
        try:
            self._sel.modify(conn.sock, mask, conn)
        except (KeyError, ValueError, OSError) as e:
            log.warning("wire selector modify failed (%r): closing stream", e)
            self._close(conn, "selector-modify")

    def _sweep(self, now: float) -> None:
        """Loop-timer duties: heartbeat byte-idle streams, reap stuck
        sockets. Heartbeats are whole frames appended at queue (= frame)
        boundaries — never inside a partially-sent frame."""
        for conn in list(self._conns.values()):
            if conn.chunks:
                if now - conn.last_progress > STUCK_SOCKET_TIMEOUT_S:
                    self._stuck_closed += 1
                    self._close(conn, "stuck")
                continue
            if now - conn.last_send >= self._heartbeat_s:
                self._heartbeats += 1
                hb = (wirecodec.HEARTBEAT_FRAME if conn.wire == "bin"
                      else b"\n")
                self._enqueue(conn, hb, False)
                self._flush(conn)

    def _close(self, conn: _WireConn, reason: str = "client") -> None:
        from ..metrics import watch_clients, wire_connections

        if self._conns.pop(conn.fd, None) is None:
            return
        self._demote(conn, self._tip)
        self._closed_total += 1
        self._closed_reasons[reason] = \
            self._closed_reasons.get(reason, 0) + 1
        watch_clients.inc(-1)
        wire_connections.inc(-1, codec=conn.wire, loop="loop")
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
