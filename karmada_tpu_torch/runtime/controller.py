"""Level-triggered controller runtime.

The port's copy of the JAX package's `runtime/controller.py`, unchanged in behaviour.

Equivalent of the reference's controller-runtime + util.AsyncWorker stack
(pkg/util/worker.go, cmd/controller-manager/app/controllermanager.go:217-247):
each controller owns a dedup'ing work queue of keys and a reconcile(key)
function; watch handlers enqueue keys. The runtime drains all queues
round-robin until quiescent — deterministic for tests, and re-runnable at any
time (level-triggered: reconcile reads desired state from the store, never from
the event payload).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

# Reconcile outcomes
DONE = "done"
REQUEUE = "requeue"


class WorkQueue:
    """Dedup'ing FIFO with retry backoff bookkeeping (reference:
    workqueue.RateLimitingInterface; backoff envelope 1s→10s per
    scheduling_queue.go:43-51 — in the in-process runtime, backoff is a retry
    counter consulted by the drain loop rather than wall-clock sleeps).

    Thread-safe: watch handlers enqueue from whatever thread mutated the
    store while drain loops pop concurrently (the reference's workqueue is
    the same cross-goroutine seam)."""

    def __init__(self, max_retries: int = 16):
        self._items: OrderedDict[str, None] = OrderedDict()
        self._retries: dict[str, int] = {}
        self._lock = threading.Lock()
        self.max_retries = max_retries
        # enqueue wakeup hook (the streaming scheduler's condition-variable
        # seam, sched/streaming.py): called — OUTSIDE the queue lock — when
        # a key lands in an empty-or-not queue, so an event-driven drain
        # loop can sleep until work exists instead of polling on a tick
        self.on_add: Optional[Callable[[], None]] = None

    def add(self, key: str) -> None:
        with self._lock:
            fresh = key not in self._items
            if fresh:
                self._items[key] = None
        if fresh and self.on_add is not None:
            self.on_add()

    def pop(self) -> Optional[str]:
        with self._lock:
            if not self._items:
                return None
            key, _ = self._items.popitem(last=False)
            return key

    def readd(self, key: str) -> None:
        """Interface parity with PrioritySchedulingQueue.readd (store-free
        re-admit of a drained key); add() is already store-free here."""
        self.add(key)

    def drain(self, limit: Optional[int] = None) -> list[str]:
        """Pop up to `limit` keys (all, when None) in FIFO order — the
        micro-batch former's one-lock-hold alternative to a pop loop."""
        out: list[str] = []
        with self._lock:
            while self._items and (limit is None or len(out) < limit):
                key, _ = self._items.popitem(last=False)
                out.append(key)
        return out

    def retry(self, key: str) -> bool:
        with self._lock:
            n = self._retries.get(key, 0) + 1
            self._retries[key] = n
            if n > self.max_retries:
                return False
            readded = key not in self._items
            if readded:
                self._items[key] = None
        if readded and self.on_add is not None:
            self.on_add()
        return True

    def forget(self, key: str) -> None:
        with self._lock:
            self._retries.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


@dataclass
class Controller:
    name: str
    reconcile: Callable[[str], str]  # key -> DONE | REQUEUE
    queue: WorkQueue = field(default_factory=WorkQueue)
    errors: dict[str, Exception] = field(default_factory=dict)

    def enqueue(self, key: str) -> None:
        self.queue.add(key)

    def step(self) -> bool:
        """Process one item; returns True if work was done.

        Reconcile exceptions are retried (up to queue.max_retries) instead of
        propagating, matching controller-runtime: one bad object must not halt
        every other controller sharing the drain loop. The last error per key
        is kept for inspection/tests."""
        key = self.queue.pop()
        if key is None:
            return False
        try:
            outcome = self.reconcile(key)
        except Exception as e:  # noqa: BLE001 - reconcile errors are retried
            self.errors[key] = e
            self.queue.retry(key)
            return True
        self.errors.pop(key, None)
        if outcome == REQUEUE:
            self.queue.retry(key)
        else:
            self.queue.forget(key)
        return True


@dataclass
class BatchingController(Controller):
    """Controller that drains its whole queue into ONE reconcile call — the
    host-side hook that turns per-key events into the scheduler's batched
    [B,C] device solve. reconcile_batch(keys) returns keys to requeue."""

    reconcile_batch: Optional[Callable[[list[str]], list[str]]] = None

    def step(self) -> bool:
        keys = self.queue.drain()
        if not keys:
            return False
        try:
            requeue = self.reconcile_batch(keys) or []
        except Exception:
            # Per-key error isolation: one bad item must not burn the whole
            # batch's retry budget (the reference retries bindings
            # individually). Fall back to singleton batches; only the
            # offender is retried/dropped.
            for k in keys:
                try:
                    solo_requeue = self.reconcile_batch([k]) or []
                except Exception as e:  # noqa: BLE001
                    self.errors[k] = e
                    self.queue.retry(k)
                    continue
                if k in solo_requeue:
                    self.queue.retry(k)
                else:
                    self.queue.forget(k)
                    self.errors.pop(k, None)
            return True
        for k in keys:
            if k in requeue:
                self.queue.retry(k)
            else:
                self.queue.forget(k)
                self.errors.pop(k, None)
        return True


class Runtime:
    """Holds all controllers; `settle()` drains every queue until quiescent.

    Time-based behaviors (descheduler cadence, toleration windows, graceful
    eviction grace periods) take an explicit `now` from a Clock so tests can
    advance time deterministically (the reference relies on wall clocks +
    RequeueAfter; we make time injectable instead)."""

    def __init__(self, clock: Optional["Clock"] = None):
        self.controllers: list[Controller] = []
        self.clock = clock or Clock()

    def register(self, controller: Controller) -> Controller:
        self.controllers.append(controller)
        return controller

    def settle(self, max_steps: int = 100_000) -> int:
        steps = 0
        progressed = True
        while progressed:
            progressed = False
            for c in self.controllers:
                while c.step():
                    steps += 1
                    progressed = True
                    if steps >= max_steps:
                        raise RuntimeError(
                            f"runtime did not settle in {max_steps} steps; "
                            f"queues: {[(x.name, len(x.queue)) for x in self.controllers]}"
                        )
        return steps


class Clock:
    """Injectable clock; real by default, steppable in tests."""

    def __init__(self, fixed: Optional[float] = None):
        self._fixed = fixed

    def now(self) -> float:
        return self._fixed if self._fixed is not None else time.time()

    def advance(self, seconds: float) -> None:
        if self._fixed is None:
            self._fixed = time.time()
        self._fixed += seconds
