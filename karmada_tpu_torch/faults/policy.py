"""Unified retry + circuit-breaker policy for every member-facing I/O path
(the port's copy of faults/policy.py).

One place for the three fault-tolerance primitives the reference spreads over
client-go workqueue rate limiters, per-cluster gRPC connection management,
and taint-based failover:

  - `RetryPolicy`: exponential backoff with FULL jitter (delay is uniform in
    [0, min(cap, base·mult^attempt)] — the AWS-architecture-blog shape that
    de-synchronizes retry storms) under a total deadline budget.
  - `Backoff`: the stateful per-stream variant (replaces `RemoteStore`'s
    hand-rolled watch backoff).
  - `CircuitBreaker`: per-member closed → open → half-open probe machine.
    While open, callers fast-fail (the batched solve must never stall on a
    dark member); after `open_seconds` one probe is admitted, and its
    outcome closes or re-opens the breaker.

All time is injectable (`clock` returns monotonic seconds) and all jitter is
injectable (`rng` returns uniform [0,1)), so the state machines unit-test
with fake clocks and chaos runs stay deterministic.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

# breaker states (gauge values: the wire encoding of karmada_breaker_state)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


@dataclass(frozen=True)
class RetryPolicy:
    """Declarative retry envelope: attempts × backoff under a deadline."""

    base_delay: float = 0.1
    max_delay: float = 5.0
    multiplier: float = 2.0
    max_attempts: int = 5
    deadline: float = 30.0  # total budget across attempts + sleeps

    def delay(self, attempt: int, u: Optional[float] = None) -> float:
        """Full-jitter delay for `attempt` (0-based): uniform in
        [0, min(max_delay, base·mult^attempt)]."""
        cap = min(self.max_delay, self.base_delay * self.multiplier ** attempt)
        if u is None:
            u = random.random()
        return u * cap

    def run(self, fn: Callable, retryable: Callable[[Exception], bool],
            sleep: Callable[[float], None] = time.sleep,
            clock: Callable[[], float] = time.monotonic,
            rng: Callable[[], float] = random.random):
        """Call `fn` until it succeeds, a non-retryable error escapes, the
        attempt budget is spent, or the next sleep would overrun the
        deadline. The last error re-raises."""
        t0 = clock()
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - classified below
                if not retryable(e) or attempt + 1 >= self.max_attempts:
                    raise
                d = self.delay(attempt, rng())
                if clock() - t0 + d > self.deadline:
                    raise
                sleep(d)
                attempt += 1


class Backoff:
    """Stateful exponential backoff with full jitter — the per-stream shape
    (watch reconnects): `next()` returns the sleep for the current failure
    streak and advances it; `reset()` on success."""

    def __init__(self, base: float = 0.5, cap: float = 30.0,
                 multiplier: float = 2.0,
                 rng: Callable[[], float] = random.random):
        self.base = base
        self.cap = cap
        self.multiplier = multiplier
        self._rng = rng
        self._current = base

    def next(self) -> float:
        d = self._current * self._rng()
        self._current = min(self._current * self.multiplier, self.cap)
        return d

    def peek_cap(self) -> float:
        """Upper bound of the next sleep (what a jitterless loop would use)."""
        return self._current

    def reset(self) -> None:
        self._current = self.base


class CircuitBreaker:
    """closed → open → half-open probe, per member.

    closed:    every call admitted; `failure_threshold` CONSECUTIVE failures
               trip to open.
    open:      `allow()` is False (fast-fail, no I/O) until `open_seconds`
               elapse, then the breaker moves to half-open.
    half-open: exactly `half_open_probes` in-flight probes admitted; a probe
               success closes the breaker, a probe failure re-opens it (and
               restarts the open window).
    """

    def __init__(self, name: str = "", failure_threshold: int = 3,
                 open_seconds: float = 5.0, half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.open_seconds = open_seconds
        self.half_open_probes = max(1, half_open_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._publish(CLOSED)

    # -- state accessors ---------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    @property
    def is_open(self) -> bool:
        """True while calls should fast-fail (open and not yet probing)."""
        return self.state == OPEN

    # -- transitions -------------------------------------------------------

    def _publish(self, to: str) -> None:
        from ..metrics import breaker_state

        breaker_state.set(_STATE_GAUGE[to], member=self.name)

    def _transition(self, to: str) -> None:
        if self._state == to:
            return
        self._state = to
        from ..metrics import breaker_transitions

        breaker_transitions.inc(member=self.name, to=to)
        self._publish(to)

    def _maybe_half_open(self) -> None:
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.open_seconds):
            self._transition(HALF_OPEN)
            self._probes_in_flight = 0

    def allow(self) -> bool:
        """Admission check for one call. In half-open, admitting counts the
        call as a probe; its record_success/record_failure settles it."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return False
            if self._probes_in_flight < self.half_open_probes:
                self._probes_in_flight += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state in (HALF_OPEN, OPEN):
                self._transition(CLOSED)
            self._probes_in_flight = 0

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            if self._state == HALF_OPEN:
                self._opened_at = self._clock()
                self._transition(OPEN)
                self._probes_in_flight = 0
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition(OPEN)


class BreakerRegistry:
    """Per-member breakers with a shared configuration + clock. Created
    lazily on first use, so 'has a breaker' means 'this member has been
    called through a guarded path'."""

    def __init__(self, failure_threshold: int = 3, open_seconds: float = 5.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.open_seconds = open_seconds
        self.half_open_probes = half_open_probes
        self.clock = clock
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def for_member(self, name: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(name)
            if br is None:
                br = CircuitBreaker(
                    name=name,
                    failure_threshold=self.failure_threshold,
                    open_seconds=self.open_seconds,
                    half_open_probes=self.half_open_probes,
                    clock=self.clock,
                )
                self._breakers[name] = br
            return br

    def get(self, name: str) -> Optional[CircuitBreaker]:
        with self._lock:
            return self._breakers.get(name)

    def open_members(self) -> set[str]:
        """Members whose breaker currently fast-fails (OPEN — a half-open
        breaker is probing and no longer counts as dark)."""
        with self._lock:
            breakers = list(self._breakers.items())
        return {name for name, br in breakers if br.is_open}

    def any_open(self) -> bool:
        return bool(self.open_members())
