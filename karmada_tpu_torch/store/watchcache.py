"""Revisioned watch cache: the server-side read-scaling layer over the store
(the port's copy of store/watchcache.py, over the port's `Store`).

The reference control plane gets its read throughput from etcd revisions
plus the kube-apiserver watch cache (PAPER.md L1/L6): every mutation is
stamped with a monotonic revision, the apiserver keeps a bounded in-memory
log of recent events plus a revision-consistent object index, and serves

- resumable watches — a client reconnecting with `since=<rv>` receives
  only the delta, not a full relist, as long as the ring still holds it;
- consistent paginated lists — `limit=`/`continue=` pages pinned to one
  snapshot revision, so a list crawled across many requests never shows
  dupes or skips from writes that landed mid-crawl.

This module is that analogue for the store. `WatchCache`
attaches to a `Store` through the under-lock event-sink seam
(`Store.add_event_sink`), which delivers mutations in strict
resourceVersion order — unlike the watcher bus, whose callbacks run after
the lock drops and may interleave under concurrent writers. Each event is
wire-encoded ONCE (`server/codec.py`) — lazily, on the first serving read,
so the store's lock hold pays only the ring append while every watch
client still writes the same cached bytes: fan-out cost per client is a
filter check plus a socket write, not an encode.

Consistency model:
- the ring holds the last `capacity` events in rv order; `events_since(rv)`
  is exact while `rv >= compacted_rv`, else the caller must fall back to
  snapshot + replay (exactly the reference's "too old resource version");
- the object index is updated in the same critical section as the ring
  append, so `snapshot()` at rv R reflects precisely the first R events;
- a non-monotonic rv (a persistence `restore()` replaying files in
  file order) resets the ring and moves the compaction point forward —
  no since-resume across a restore, snapshots stay correct.

Thread-safety: one condition variable guards ring + index + pinned pages;
`wait()` lets serving threads block for the next event without polling.
"""
from __future__ import annotations

import bisect
import itertools
import json
import threading
import time
from typing import Any, Optional

from ..analysis.lockorder import make_lock
from ..server import codec, wirecodec
from .store import ADDED, DELETED, Store

DEFAULT_CAPACITY = 8192
# pinned list snapshots: a crawler must finish its pages inside the TTL
# (refreshed per page fetch); beyond MAX_PINNED the oldest pin is dropped
DEFAULT_PAGE_TTL = 60.0
MAX_PINNED_PAGES = 64


class ContinueExpired(Exception):
    """The continue token's pinned snapshot is gone (TTL or pressure);
    the client must restart the list from the beginning (HTTP 410)."""


class CacheEvent:
    """One revisioned event, wire-encoded once, shared by ring and index.

    The encode is LAZY: the event is appended under the store lock (the
    sink runs in the mutation's critical section so the ring sees strict
    rv order), but the codec work happens on the first serving thread that
    reads `enc`/`line()` — the store commits immutable objects, so
    retaining the reference and encoding it outside the lock is safe, and
    the write path's lock hold stays free of codec cost. Two racing
    encoders produce identical values — benign."""

    __slots__ = ("rv", "kind", "event", "namespace", "name", "obj", "_enc",
                 "_line", "_added_line", "_frame", "_added_frame",
                 "_base_rv", "_base_src", "_delta_frame")

    def __init__(self, rv: int, kind: str, event: str, namespace: str,
                 name: str, obj: Any = None, enc: Any = None):
        self.rv = rv
        self.kind = kind
        self.event = event
        self.namespace = namespace
        self.name = name
        self.obj = obj
        self._enc = enc
        self._line: Optional[bytes] = None
        self._added_line: Optional[bytes] = None
        # dual encoding (binary wire codec): the full binary frame, the
        # ADDED-frame variant, and the delta frame against the PREVIOUS
        # object for this key. `_base_src` holds a reference to the prior
        # object (or its encoding) — never the prior CacheEvent, so no
        # predecessor chain is retained: one extra object per ring slot
        # at most, freed with the slot on compaction or delta build.
        self._frame: Optional[bytes] = None
        self._added_frame: Optional[bytes] = None
        self._base_rv: int = 0
        self._base_src: Any = None
        self._delta_frame: Optional[bytes] = None

    @property
    def enc(self) -> Any:
        """Wire encoding, built once on first read (never under the store
        lock); the retained object reference drops once encoded. Two
        racing first-readers are safe under the GIL: the object reference
        is snapshotted BEFORE encoding, and a reader that finds it already
        dropped re-reads the published encoding (the writer publishes
        `_enc` before clearing `obj`, so a None obj implies `_enc` is
        set — encoding the dropped None would cache a corrupt obj:null
        wire line forever)."""
        e = self._enc
        if e is None:
            obj = self.obj
            if obj is None:
                return self._enc  # racer published between our two reads
            e = codec.encode(obj)
            self._enc = e
            self.obj = None  # footprint: keep bytes OR object, not both
        return e

    def matches(self, kind: str, namespace: str) -> bool:
        if kind != "*" and self.kind != kind:
            return False
        return not namespace or self.namespace == namespace

    def line(self) -> bytes:
        """The JSON wire line for this event (built once, served to every
        client). Two racing encoders produce identical bytes — benign."""
        line = self._line
        if line is None:
            line = (json.dumps({
                "kind": self.kind, "event": self.event, "rv": self.rv,
                "obj": self.enc,
            }) + "\n").encode()
            self._line = line
        return line

    def added_line(self) -> bytes:
        """The same object as an ADDED line — what a snapshot replay sends
        (informer initial-list semantics), whatever the live event was."""
        if self.event == ADDED:
            return self.line()
        line = self._added_line
        if line is None:
            line = (json.dumps({
                "kind": self.kind, "event": ADDED, "rv": self.rv,
                "obj": self.enc,
            }) + "\n").encode()
            self._added_line = line
        return line

    # -- binary wire frames (server/wirecodec.py), built once like line()

    def frame(self) -> bytes:
        """Full binary event frame — same JSON object as line(), framed."""
        f = self._frame
        if f is None:
            f = wirecodec.event_frame(self.kind, self.event, self.rv,
                                      self.enc)
            self._frame = f
        return f

    def added_frame(self) -> bytes:
        """frame() with the event rewritten to ADDED — snapshot replay."""
        if self.event == ADDED:
            return self.frame()
        f = self._added_frame
        if f is None:
            f = wirecodec.event_frame(self.kind, ADDED, self.rv, self.enc)
            self._added_frame = f
        return f

    def delta_frame(self) -> Optional[bytes]:
        """Delta frame against this key's previous object, or None when no
        base exists (ADDED/DELETED, or a delta would not be smaller than
        the full frame). Built once; the base reference drops after the
        build either way. Racing encoders produce identical bytes."""
        f = self._delta_frame
        if f is not None:
            return f if f else None  # b"" caches "not worth it"
        base_rv = self._base_rv
        if not base_rv or self.event in (ADDED, DELETED):
            return None
        src = self._base_src
        if src is None:
            return None
        base_enc = codec.encode(src)  # idempotent on already-encoded dicts
        patch = wirecodec.diff(base_enc, self.enc)
        f = wirecodec.delta_frame(self.kind, self.event, self.rv,
                                  self.namespace, self.name, base_rv, patch)
        if len(f) >= len(self.frame()):
            f = b""
        self._delta_frame = f
        self._base_src = None  # the base served its purpose
        return f if f else None


class WatchCache:
    def __init__(self, store: Store, capacity: int = DEFAULT_CAPACITY,
                 page_ttl: float = DEFAULT_PAGE_TTL):
        self._store = store
        self.capacity = max(int(capacity), 1)
        self.page_ttl = page_ttl
        # lock-order watchdog seam (KARMADA_TPU_LOCKCHECK=1): the cache
        # lock is acquired under the store hold via the event sink — the
        # watchdog proves that edge never reverses (docs/ANALYSIS.md)
        self._cond = threading.Condition(make_lock("watchcache._cond"))
        self._events: list[CacheEvent] = []
        # kind -> (namespace, name) -> latest CacheEvent (current state)
        self._index: dict[str, dict[tuple[str, str], CacheEvent]] = {}
        self._rv = 0
        self._compacted_rv = 0  # since-resume exact iff since >= this
        # pinned list snapshots: id -> [expires, rv, items]
        self._pages: dict[int, list] = {}
        self._page_ids = itertools.count(1)
        self._attached = False
        # wakeup fan-out beyond the condition variable: the event loop
        # (server/eventloop.py) blocks in selectors.select(), not in
        # wait() — each hook runs inside _on_event (store lock held) and
        # must be non-blocking (the loop's is one os.write to a self-pipe)
        self._notify_hooks: list = []

    # -- lifecycle --------------------------------------------------------

    def attach(self) -> None:
        """Prime the index from current store state and subscribe to the
        event-sink seam, atomically with respect to mutations.

        Safe to call again after detach() — the replication snapshot path
        swaps the store's whole state with the cache detached, then
        re-attaches: the stale ring and index are dropped FIRST (a
        since-resume across the swap must fall back to snapshot replay,
        and index entries for objects that vanished during the swap must
        not survive), and prime rebuilds a revision-consistent index
        under the same lock hold that gates new events."""
        if self._attached:
            return
        self._attached = True
        with self._cond:
            self._events.clear()
            self._index.clear()
        rv = self._store.add_event_sink(self._on_event, prime=self._prime)
        with self._cond:
            self._rv = max(self._rv, rv)
            self._compacted_rv = self._rv

    def detach(self) -> None:
        if not self._attached:
            return
        self._attached = False
        self._store.remove_event_sink(self._on_event)

    # -- feed (runs under the store lock) ---------------------------------

    def _prime(self, kind: str, obj: Any) -> None:
        ev = self._make_event(kind, ADDED, obj)
        with self._cond:
            self._apply_index(ev)
            self._rv = max(self._rv, ev.rv)

    @staticmethod
    def _make_event(kind: str, event: str, obj: Any) -> CacheEvent:
        # no encode here: _on_event runs under the store lock, and the
        # committed object is immutable — CacheEvent encodes lazily on the
        # first serving read instead (write-path lock-scope shrink)
        m = obj.metadata
        return CacheEvent(m.resource_version, kind, event, m.namespace,
                          m.name, obj=obj)

    def _on_event(self, kind: str, event: str, obj: Any) -> None:
        ev = self._make_event(kind, event, obj)
        with self._cond:
            if ev.rv <= self._rv:
                # non-monotonic: a restore() replaying persisted files in
                # file order. Keep the index correct, forbid since-resume
                # across the discontinuity — and mint a FRESH store
                # revision for it (we run under the store lock, so
                # _next_rv is safe): a pre-restore cursor numerically
                # equal to the post-restore tip must not alias a client
                # that already resynced and holds the restored state.
                self._apply_index(ev)
                self._events.clear()
                self._compacted_rv = self._rv = self._store._next_rv()
            else:
                self._rv = ev.rv
                self._apply_index(ev)
                self._events.append(ev)
                if len(self._events) > self.capacity:
                    drop = len(self._events) - self.capacity
                    self._compacted_rv = self._events[drop - 1].rv
                    del self._events[:drop]
            self._cond.notify_all()
        for hook in self._notify_hooks:
            hook()

    def add_notify(self, hook) -> None:
        """Register a non-blocking wakeup hook, called after every ring
        append (outside the cache lock, still under the store lock)."""
        self._notify_hooks.append(hook)

    def remove_notify(self, hook) -> None:
        try:
            self._notify_hooks.remove(hook)
        except ValueError:
            pass

    def _apply_index(self, ev: CacheEvent) -> None:
        by_key = self._index.setdefault(ev.kind, {})
        key = (ev.namespace, ev.name)
        if ev.event == DELETED:
            by_key.pop(key, None)
        else:
            prev = by_key.get(key)
            if prev is not None and ev.event != ADDED:
                # delta base: the key's previous OBJECT (or its encoding
                # if already built) — exactly the state an rv-contiguous
                # client holds for this key when ev arrives. Never the
                # CacheEvent itself: that would chain predecessors
                # indefinitely when no binary client forces delta builds.
                ev._base_rv = prev.rv
                ev._base_src = (prev._enc if prev._enc is not None
                                else prev.obj)
            by_key[key] = ev

    # -- read side --------------------------------------------------------

    @property
    def current_rv(self) -> int:
        with self._cond:
            return self._rv

    @property
    def compacted_rv(self) -> int:
        """Cursors at or past this rv resume exactly; older ones must
        snapshot+replay (the event loop checks before each pump)."""
        with self._cond:
            return self._compacted_rv

    def events_since(self, rv: int, kind: str = "*", namespace: str = "",
                     limit: int = 0) -> tuple[list[CacheEvent], int, bool]:
        """Events with resourceVersion > rv matching the filter, in order.

        Returns (events, cursor, ok): `cursor` is the rv the caller should
        resume from next (past filtered-out events too, so an idle filter
        never rescans the ring); ok=False means the ring has compacted past
        `rv` — the caller must snapshot+replay instead."""
        with self._cond:
            if rv < self._compacted_rv:
                return [], rv, False
            events = self._events
            lo = self._idx_after(rv)
            out: list[CacheEvent] = []
            cursor = rv
            for ev in events[lo:]:
                cursor = ev.rv
                if ev.matches(kind, namespace):
                    out.append(ev)
                    if limit and len(out) >= limit:
                        break
            return out, cursor, True

    def wait(self, rv: int, timeout: float) -> bool:
        """Block until an event past `rv` exists (True) or timeout."""
        with self._cond:
            if self._rv > rv:
                return True
            self._cond.wait(timeout)
            return self._rv > rv

    def lag(self, rv: int) -> int:
        """How many ring events a cursor at `rv` still has to consume —
        the per-client backlog the lag gauge exports."""
        with self._cond:
            return len(self._events) - self._idx_after(rv)

    def _idx_after(self, rv: int) -> int:
        """Index of the first ring event with .rv > rv (rv-sorted ring);
        caller must hold self._cond."""
        return bisect.bisect_right(self._events, rv, key=lambda e: e.rv)

    def snapshot(self, kind: str = "*", namespace: str = ""
                 ) -> tuple[int, list[CacheEvent]]:
        """Revision-consistent current state matching the filter, sorted by
        (kind, namespace, name) — the replay source for watch fallback."""
        with self._cond:
            rv = self._rv
            items = self._collect(kind, namespace)
        return rv, items

    def _collect(self, kind: str, namespace: str) -> list[CacheEvent]:
        """Caller must hold self._cond."""
        kinds = self._index.keys() if kind == "*" else (kind,)
        out: list[CacheEvent] = []
        for k in kinds:
            by_key = self._index.get(k)
            if not by_key:
                continue
            for ev in by_key.values():
                if not namespace or ev.namespace == namespace:
                    out.append(ev)
        out.sort(key=lambda e: (e.kind, e.namespace, e.name))
        return out

    # -- paginated, revision-consistent lists -----------------------------

    def list_page(self, kind: str, namespace: str, limit: int,
                  token: Optional[str] = None
                  ) -> tuple[int, list[Any], str]:
        """One page of encoded objects. First call (token=None) pins a
        snapshot at the current rv; the returned continue token fetches
        later pages FROM THAT SNAPSHOT, so concurrent writes can neither
        duplicate nor skip items across pages. Returns (rv, items, token);
        an empty token means the list is complete."""
        limit = max(int(limit), 1)
        now = time.monotonic()
        with self._cond:
            self._prune_pages(now)
            if token:
                try:
                    pid_s, off_s = token.split(":", 1)
                    pid, off = int(pid_s), int(off_s)
                except ValueError:
                    raise ContinueExpired(
                        f"malformed continue token {token!r}") from None
                if pid <= 0 or off < 0:
                    # a negative offset would slice from the END of the pin
                    # and silently duplicate items across pages
                    raise ContinueExpired(
                        f"malformed continue token {token!r}")
                page = self._pages.get(pid)
                if page is None:
                    raise ContinueExpired(
                        "continue token expired; restart the list")
                page[0] = now + self.page_ttl  # crawl in progress: refresh
                _, rv, items = page
            else:
                rv = self._rv
                items = self._collect(kind, namespace)
                off = 0
                pid = 0
                if len(items) > limit:
                    pid = next(self._page_ids)
                    self._pages[pid] = [now + self.page_ttl, rv, items]
            chunk = items[off:off + limit]
            end = off + limit
            next_token = f"{pid}:{end}" if end < len(items) else ""
            if not next_token and token:
                self._pages.pop(pid, None)  # crawl done: unpin eagerly
            return rv, [it.enc for it in chunk], next_token

    def _prune_pages(self, now: float) -> None:
        expired = [pid for pid, p in self._pages.items() if p[0] <= now]
        for pid in expired:
            del self._pages[pid]
        while len(self._pages) > MAX_PINNED_PAGES:
            oldest = min(self._pages, key=lambda pid: self._pages[pid][0])
            del self._pages[oldest]
