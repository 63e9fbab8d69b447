"""Per-member circuit breakers (the port's copy of the breaker half of
faults/policy.py; the retry and backoff policies serve I/O paths the port
does not have).

`CircuitBreaker`: per-member closed -> open -> half-open probe machine.
While open, callers fast-fail (the batched solve must never stall on a dark
member); after `open_seconds` one probe is admitted, and its outcome closes
or re-opens the breaker. Time is injectable (`clock` returns monotonic
seconds), so the state machine unit-tests with fake clocks.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# breaker states (gauge values: the wire encoding of karmada_breaker_state)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


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
