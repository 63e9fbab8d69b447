"""Priority scheduling queue (SCH3).

The port's copy of the JAX package's `sched/queue.py`, unchanged in behaviour.

Parity with pkg/scheduler/internal/queue/scheduling_queue.go:43-57 under the
PriorityBasedScheduling feature gate: an activeQ (max-heap by binding priority,
FIFO among equals), a backoffQ with exponential per-key backoff (1s initial →
10s max), and an unschedulable pool whose items re-enter activeQ after at most
5 minutes. The heap mirrors internal/heap/heap.go; priority comes from
`spec.SchedulePriorityValue()` (event_handler.go:122-137) — here the binding's
`schedule_priority` (None ⇒ 0).

Starvation control: the reference pops strictly by priority, so a sustained
flood of high-priority bindings can park priority-0 keys in activeQ forever —
under the streaming scheduler (sched/streaming.py), where admission never
pauses, that is a real livelock, not a transient. This queue AGES instead:
a key's effective priority grows by one for every `aging_step` seconds it
waits in activeQ, so any binding eventually out-ranks a flood of fresh
arrivals while short-term ordering stays exactly priority-then-FIFO. Aging
uses the injectable clock (deterministic in fake-clock tests); 0 disables it.

Implements the same queue interface the controller runtime drains
(add/pop/drain/retry/forget/len), so it can be dropped into a
BatchingController in place of the FIFO WorkQueue. Time is injectable (Clock)
so backoff and aging windows are deterministic in tests.
"""
from __future__ import annotations

import heapq
import itertools
import math
import threading
from typing import Callable, Optional

DEFAULT_BACKOFF_INITIAL = 1.0  # scheduling_queue.go:43-51
DEFAULT_BACKOFF_MAX = 10.0
DEFAULT_UNSCHEDULABLE_MAX_STAY = 300.0  # 5 min
DEFAULT_AGING_STEP = 60.0  # +1 effective priority per minute of queue age

DEFAULT_GANG_WAIT = 30.0  # partial gangs reject after this hold window


class GangCoordinator:
    """The queue-side half of gang scheduling (sched/preemption.py): holds
    partial gangs — bindings sharing `spec.gang_name`, expecting
    `spec.gang_size` members — until the cohort completes (all K offered)
    or a timeout rejects it. A drained gang member parks HERE instead of
    entering a micro-batch; the offer that completes the gang releases
    every held member into the CURRENT batch formation, so the cohort
    always solves (and commits) together.

    Held entries keep the binding snapshot + admission epoch captured at
    offer time: a member whose spec changes while held re-offers through
    its own watch event and REPLACES the stale entry (key-based), and the
    epoch fence discards any decision computed on a replaced snapshot.
    Thread-safe — the streaming admission loop and the batch daemon's
    drain both offer."""

    def __init__(self, clock, wait_seconds: float = DEFAULT_GANG_WAIT):
        self.clock = clock
        self.wait_seconds = wait_seconds
        self._lock = threading.Lock()
        # gang -> key -> (binding snapshot, epoch)
        self._held: dict[str, dict[str, tuple]] = {}
        self._deadline: dict[str, float] = {}
        self._size: dict[str, int] = {}

    def offer(self, key: str, rb, epoch: int = 0) -> list[tuple]:
        """Offer one gang member. Returns the full cohort [(key, binding,
        epoch), ...] when this offer completes the gang (the coordinator
        forgets it — the cohort is the caller's now), else [] (held)."""
        gname = rb.spec.gang_name
        with self._lock:
            g = self._held.setdefault(gname, {})
            if not g:
                self._deadline[gname] = self.clock.now() + self.wait_seconds
            g[key] = (rb, epoch)
            # misdeclared sizes: the largest declared K wins (a gang can
            # only complete when every declared expectation is met)
            self._size[gname] = max(
                self._size.get(gname, 0), int(rb.spec.gang_size or 0)
            )
            if len(g) >= max(self._size[gname], 1):
                self._forget_locked(gname)
                return [(k, r, e) for k, (r, e) in g.items()]
            return []

    def discard(self, key: str, gang_name: str) -> None:
        """Drop one held member (tombstone / re-target / suspension): the
        remainder keeps waiting and times out if never completed."""
        with self._lock:
            g = self._held.get(gang_name)
            if g is not None:
                g.pop(key, None)
                if not g:
                    self._forget_locked(gang_name)

    def expire(self, now: float) -> list[tuple[str, list[tuple]]]:
        """Pop every gang whose hold window elapsed incomplete:
        [(gang_name, [(key, binding, epoch), ...]), ...]."""
        out = []
        with self._lock:
            for gname in [g for g, d in self._deadline.items() if now >= d]:
                members = self._held.get(gname, {})
                out.append(
                    (gname, [(k, r, e) for k, (r, e) in members.items()])
                )
                self._forget_locked(gname)
        return out

    def held_count(self) -> int:
        with self._lock:
            return sum(len(g) for g in self._held.values())

    def _forget_locked(self, gname: str) -> None:
        self._held.pop(gname, None)
        self._deadline.pop(gname, None)
        self._size.pop(gname, None)


class PrioritySchedulingQueue:
    """activeQ + backoffQ + unschedulable pool.

    `priority_fn(key) -> int` resolves a binding key to its current priority at
    enqueue time (the reference reads spec.SchedulePriorityValue at event time).
    """

    def __init__(
        self,
        clock,
        priority_fn: Optional[Callable[[str], int]] = None,
        backoff_initial: float = DEFAULT_BACKOFF_INITIAL,
        backoff_max: float = DEFAULT_BACKOFF_MAX,
        unschedulable_max_stay: float = DEFAULT_UNSCHEDULABLE_MAX_STAY,
        max_retries: int = 16,
        aging_step: float = DEFAULT_AGING_STEP,
    ):
        self.clock = clock
        self.priority_fn = priority_fn or (lambda _key: 0)
        self.backoff_initial = backoff_initial
        self.backoff_max = backoff_max
        self.unschedulable_max_stay = unschedulable_max_stay
        self.max_retries = max_retries
        self.aging_step = aging_step
        # enqueue wakeup hook — same contract as WorkQueue.on_add (called
        # outside any internal state mutation): the streaming scheduler's
        # condition variable notifies on it
        self.on_add: Optional[Callable[[], None]] = None
        # under the streaming scheduler this queue is shared across threads
        # (watch handlers add, the admission loop drains, the writer
        # forgets/retries) — the same cross-goroutine seam WorkQueue locks
        self._lock = threading.RLock()

        self._seq = itertools.count()  # FIFO tie-break among equal priorities
        # base priority per known key, read at add() time OUTSIDE the lock
        # (see add()); lifecycle matches _attempts (cleared by forget)
        self._base_prio: dict[str, int] = {}
        self._active: list[tuple[int, int, str]] = []  # (-eff_prio, seq, key)
        # key -> (base priority, seq, activeQ-entry time): the live entry
        # set the aging re-heap rebuilds from (heap entries are immutable,
        # so aging periodically re-keys the whole heap from this map)
        self._active_meta: dict[str, tuple[int, int, float]] = {}
        self._aged_at: float = clock.now()
        self._backoff: list[tuple[float, int, str]] = []  # (due, seq, key)
        self._in_backoff: set[str] = set()
        self._unschedulable: dict[str, float] = {}  # key -> entered-at
        # earliest entered-at still (possibly) parked: _flush skips the
        # full-map expiry scan until this key's stay can have elapsed —
        # the streaming loop calls _flush several times per admission, and
        # an O(parked) comprehension per call is the kind of lock-held work
        # watch handlers contend on. Removals may leave this stale-early
        # (one wasted scan recomputes it); it is never stale-late.
        self._unsched_earliest: float = math.inf
        self._attempts: dict[str, int] = {}

    # -- queue interface (WorkQueue-compatible) ---------------------------

    def add(self, key: str) -> None:
        """Add/move to activeQ. An add always wins over backoff/unschedulable
        (a fresh event means new information — moveToActiveQ semantics).

        `priority_fn` runs BEFORE the lock, never under it: it typically
        reads the store (SchedulerDaemon._priority_of), and watch handlers
        calling add() can run WITH the store lock held (Store.apply) — a
        priority read under the queue lock would complete an ABBA cycle
        with that path. The base priority is cached per key (cleared by
        forget()) so backoff/unschedulable re-activation inside _flush —
        which does run under the lock — never needs the callback; a fresh
        add() re-reads it. Duplicate events for an already-active key
        return before the priority read at all — under sustained watch
        floods that store get would otherwise run per event."""
        with self._lock:
            if key in self._active_meta:
                # active keys are never simultaneously parked (backoff /
                # unschedulable pushes refuse active keys), so this is a
                # complete no-op re-event
                return
        prio = self.priority_fn(key)
        with self._lock:
            self._base_prio[key] = prio
            self._in_backoff.discard(key)
            self._unschedulable.pop(key, None)
            if key in self._active_meta:
                return
            self._push_active(key)
        if self.on_add is not None:
            self.on_add()

    def pop(self) -> Optional[str]:
        with self._lock:
            self._flush()
            while self._active:
                _, _, key = heapq.heappop(self._active)
                if key in self._active_meta:
                    del self._active_meta[key]
                    return key
            return None

    def drain(self, limit: Optional[int] = None) -> list[str]:
        """Pop up to `limit` due keys (all, when None) in priority order —
        the streaming micro-batch former's quota drain, under ONE lock
        hold and ONE backoff/unschedulable flush (a pop-per-item loop
        would rescan the unschedulable map per key). Aging keeps a bounded
        drain fair: a starved key's effective priority eventually rises
        into every quota."""
        out: list[str] = []
        with self._lock:
            self._flush()
            while self._active and (limit is None or len(out) < limit):
                _, _, key = heapq.heappop(self._active)
                if key in self._active_meta:
                    del self._active_meta[key]
                    out.append(key)
        return out

    def readd(self, key: str) -> None:
        """Return a previously drained key to activeQ WITHOUT consulting
        `priority_fn`: the cached base priority (which a drain leaves in
        place — only forget() clears it) is used as-is. The streaming
        scheduler's error-recovery paths re-admit drained keys with this:
        `priority_fn` typically reads the store, and those paths run
        exactly when the store is erroring — a raise mid-loop would lose
        every key after it."""
        with self._lock:
            self._in_backoff.discard(key)
            self._unschedulable.pop(key, None)
            if key in self._active_meta:
                return
            self._push_active(key)
        if self.on_add is not None:
            self.on_add()

    def retry(self, key: str) -> bool:
        """Failed attempt → backoffQ with exponential delay."""
        with self._lock:
            n = self._attempts.get(key, 0) + 1
            self._attempts[key] = n
            if n > self.max_retries:
                return False
            delay = min(
                self.backoff_initial * (2 ** (n - 1)), self.backoff_max
            )
            self._push_backoff(key, delay)
            return True

    def forget(self, key: str) -> None:
        with self._lock:
            self._attempts.pop(key, None)
            # keep the cached priority while the key is PARKED: the patch
            # path forgets right after _patch_result may have pushed the
            # key unschedulable, and its later _flush re-activation must
            # re-enqueue at the real priority, not 0
            if (key not in self._in_backoff
                    and key not in self._unschedulable
                    and key not in self._active_meta):
                self._base_prio.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            self._flush()
            return (len(self._active_meta) + len(self._in_backoff)
                    + len(self._unschedulable))

    # -- scheduler-facing extras ------------------------------------------

    def push_unschedulable(self, key: str) -> None:
        """Park a binding that found no feasible cluster; it re-enters activeQ
        after at most `unschedulable_max_stay` (or earlier via add())."""
        with self._lock:
            if key in self._active_meta or key in self._in_backoff:
                return
            self._unschedulable.setdefault(key, self.clock.now())
            self._unsched_earliest = min(
                self._unsched_earliest, self._unschedulable[key]
            )

    def active_len(self) -> int:
        with self._lock:
            self._flush()
            return len(self._active_meta)

    # -- internals --------------------------------------------------------

    def _effective(self, prio: int, entered: float, now: float) -> int:
        """Effective priority: base + one per aging_step seconds of activeQ
        age — the anti-starvation ramp (0 disables aging)."""
        if self.aging_step <= 0 or now <= entered:
            return prio
        return prio + int((now - entered) / self.aging_step)

    def _push_active(self, key: str, now: Optional[float] = None) -> None:
        if now is None:
            now = self.clock.now()
        prio = self._base_prio.get(key, 0)
        seq = next(self._seq)
        self._active_meta[key] = (prio, seq, now)
        heapq.heappush(self._active, (-prio, seq, key))

    def _push_backoff(self, key: str, delay: float) -> None:
        if key in self._active_meta or key in self._in_backoff:
            return
        heapq.heappush(self._backoff, (self.clock.now() + delay, next(self._seq), key))
        self._in_backoff.add(key)

    def _flush(self) -> None:
        """Move due backoff items and expired unschedulable items to activeQ
        (the reference's flushBackoffQCompleted / flushUnschedulableLeftover),
        then re-age the heap once per aging_step."""
        now = self.clock.now()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, key = heapq.heappop(self._backoff)
            if key in self._in_backoff:
                self._in_backoff.discard(key)
                if key not in self._active_meta:
                    self._push_active(key, now)
        if (self._unschedulable
                and now - self._unsched_earliest
                >= self.unschedulable_max_stay):
            expired = [
                k
                for k, entered in self._unschedulable.items()
                if now - entered >= self.unschedulable_max_stay
            ]
            for key in expired:
                self._unschedulable.pop(key, None)
                if key not in self._active_meta:
                    self._push_active(key, now)
            self._unsched_earliest = min(
                self._unschedulable.values(), default=math.inf
            )
        if self.aging_step > 0 and now - self._aged_at >= self.aging_step:
            # re-key the heap with aged effective priorities; rebuilding
            # from the meta map also sweeps lazily-deleted stale entries
            self._aged_at = now
            self._active = [
                (-self._effective(p, entered, now), seq, k)
                for k, (p, seq, entered) in self._active_meta.items()
            ]
            heapq.heapify(self._active)
