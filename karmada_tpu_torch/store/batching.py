"""Write coalescing over the Store surface (docs/PERF.md "Write path at
fleet scale").

The port's copy of the JAX package's `store/batching.py`, unchanged in behaviour.

Every control-plane writer that used to loop per object — the binding
controller materializing one Work per target cluster, agents reporting
status for each drained Work, the scheduler patching a micro-batch of
decisions — shares these two helpers instead of growing its own copy of
the batching logic:

- `apply_all(store, objs)`: one-shot coalescing. Rides the store's
  transactional `apply_batch` when present (one lock hold / one request
  per chunk, one WAL fsync), degrading to per-object `apply` on a
  `BatchError` so one bad object costs itself — exactly the pre-batch
  loop's failure semantics — and falling back entirely for stores without
  the batch surface.

- `WriteCoalescer`: a buffered create-or-update writer for trickle
  producers (agent status reports). `apply()` enqueues; a background
  flusher commits the buffer as ONE batch after `flush_delay` seconds (the
  knob: trade a small latency floor for N-fold fewer round-trips), or
  sooner when `max_batch` accumulates. Writes to the same object key
  coalesce last-write-wins while buffered — a work whose status flapped
  twice within the window costs one write. Intended for level-triggered,
  idempotent status writes: a flush that fails is logged and dropped,
  because the next reconcile re-writes the same state.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Optional

from ..analysis.lockorder import make_lock
from ..metrics import writes_coalesced
from .store import BatchError, gvk_of

log = logging.getLogger(__name__)

DEFAULT_CHUNK = 256


def _obj_key(obj: Any) -> tuple[str, str, str]:
    return (gvk_of(obj), obj.metadata.namespace, obj.metadata.name)


def apply_all(store, objs, *, path: str = "coalesced",
              chunk: int = DEFAULT_CHUNK) -> list:
    """Create-or-update every object, coalesced into batch calls when the
    store supports them. Returns the committed objects in input order.

    Failure semantics match the per-object loop: on a BatchError (one
    object failed validation — the batch committed nothing) the chunk
    degrades to per-object apply, so the healthy objects land and the bad
    one raises exactly where the old loop would have raised."""
    objs = list(objs)
    if not objs:
        return []
    batch = getattr(store, "apply_batch", None)
    if batch is None:
        return [store.apply(o) for o in objs]
    out: list = []
    step = max(1, chunk)
    for s in range(0, len(objs), step):
        ch = objs[s:s + step]
        if len(ch) == 1:
            out.append(store.apply(ch[0]))
            continue
        try:
            out.extend(batch(ch))
            writes_coalesced.inc(len(ch), path=path)
        except BatchError:
            out.extend(store.apply(o) for o in ch)
    return out


def update_all(store, objs, *, path: str = "coalesced",
               skip_missing: bool = False, skip_stale: bool = False,
               chunk: int = DEFAULT_CHUNK) -> list:
    """Update every object, coalesced into batch calls when the store
    supports them; the shared home for the update-batch-or-fallback shape
    (the scheduler's patch and observed-generation flushes both ride it).
    Returns the per-object committed objects — None marks a slot the batch
    SKIPPED (vanished object under skip_missing, or a newer concurrent
    write under skip_stale); callers must treat those as not-written.

    The per-object fallback (no batch surface) preserves the old write
    semantics exactly: blind update, NotFound raising unless
    skip_missing."""
    from .store import NotFoundError

    objs = list(objs)
    if not objs:
        return []
    batch = getattr(store, "update_batch", None)
    out: list = []
    if batch is None:
        for o in objs:
            try:
                out.append(store.update(o))
            except NotFoundError:
                if not skip_missing:
                    raise
                out.append(None)
        return out
    step = max(1, chunk)
    for s in range(0, len(objs), step):
        ch = objs[s:s + step]
        out.extend(batch(ch, skip_missing=skip_missing,
                         skip_stale=skip_stale))
        writes_coalesced.inc(len(ch), path=path)
    return out


class WriteCoalescer:
    """Buffered apply() writer with a flush-delay knob (see module doc).

    flush_delay <= 0 disables buffering entirely: apply() writes through
    synchronously — the zero-config default for in-process callers, so
    only deployments that opt in (remote agents) pay the latency floor."""

    def __init__(self, store, *, flush_delay: float = 0.005,
                 max_batch: int = DEFAULT_CHUNK,
                 path: str = "coalesced") -> None:
        self._store = store
        self.flush_delay = flush_delay
        self.max_batch = max(1, max_batch)
        self.path = path
        # lock-order watchdog seam (KARMADA_TPU_LOCKCHECK=1): flush()
        # commits to the store AFTER dropping this lock — the watchdog
        # proves the coalescer/store order never inverts
        self._cv = threading.Condition(make_lock("coalescer._cv"))
        self._buf: dict[tuple[str, str, str], Any] = {}
        self._closed = False
        self._closed_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producer side -----------------------------------------------------

    def apply(self, obj: Any) -> Optional[Any]:
        """Enqueue a create-or-update. Returns the committed object when
        writing through (flush_delay <= 0), else None — buffered writes
        commit on the flusher thread within flush_delay."""
        if self.flush_delay <= 0:
            return self._store.apply(obj)
        with self._cv:
            if self._closed:
                raise RuntimeError("WriteCoalescer is closed")
            self._buf[_obj_key(obj)] = obj
            full = len(self._buf) >= self.max_batch
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._flusher, name=f"coalescer-{self.path}",
                    daemon=True,
                )
                self._thread.start()
            self._cv.notify_all()
        if full:
            self.flush()
        return None

    def flush(self) -> int:
        """Commit the buffered writes NOW, on the caller's thread; returns
        how many objects were written. Unlike the background flusher, a
        flush() failure RAISES — explicit flush points (end of an agent
        step) want to see the error."""
        with self._cv:
            batch = list(self._buf.values())
            self._buf.clear()
        if batch:
            apply_all(self._store, batch, path=self.path)
        return len(batch)

    def pending(self) -> int:
        with self._cv:
            return len(self._buf)

    def close(self) -> None:
        """Flush the tail and stop the flusher."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._closed_evt.set()  # interrupt a mid-delay flusher sleep
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self.flush()

    # -- flusher thread ----------------------------------------------------

    def _flusher(self) -> None:
        while True:
            with self._cv:
                while not self._buf and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return  # close() flushes the tail itself
            # let the trickle coalesce: more writes land while we sleep
            # (the flush-delay knob); a full buffer flushed synchronously
            # by apply() just leaves nothing for us to do. close() cuts
            # the sleep short so shutdown never waits out the delay.
            self._closed_evt.wait(self.flush_delay)
            with self._cv:
                batch = list(self._buf.values())
                self._buf.clear()
            if not batch:
                continue
            try:
                apply_all(self._store, batch, path=self.path)
            except Exception:  # noqa: BLE001 - status writes are
                # level-triggered and idempotent: the next reconcile
                # re-writes the same state, so log loudly and keep serving
                log.exception(
                    "coalesced flush of %d writes failed (path=%s); "
                    "dropped — the next reconcile re-writes them",
                    len(batch), self.path,
                )
