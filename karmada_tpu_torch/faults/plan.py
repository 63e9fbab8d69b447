"""Deterministic fault injection: seeded chaos schedules, replayable bit-for-bit
(the port's copy of faults/plan.py, at the one boundary the port has: the
estimator fan-out. The HTTP and apply boundaries, the env-gated install for
daemon processes and the replay serialization come with the daemon.)

A `FaultPlan` is a seed plus a list of `FaultRule`s. The estimator fan-out
asks the installed `FaultInjector` for a decision before each member leg.
Decisions are a PURE function of
(plan seed, rule index, boundary, target, per-site operation sequence number)
— never of wall clock or thread identity — so the same plan against the same
driver produces the same fault schedule. A plan is installed with
`install()` and removed with `reset()`.

Rule semantics (all windows are counted in per-site OPERATIONS, not seconds —
the unit that replays deterministically):

  kind=error      ops in [after, heal_after) fail with probability `rate`
                  (deterministic splitmix coin per op); heal_after=0 = forever
  kind=partition  ops in [after, heal_after) ALL fail (rate ignored)
  kind=flap       alternating windows of `period` ops: the first window is
                  healthy, the second faulted, and so on (shifted by `after`)
  kind=latency    ops in [after, heal_after) sleep `latency` seconds with
                  probability `rate` (injected before the real call)

`target` matches the site's target string exactly, or "*" for any target on
that boundary. A site is (boundary, target); each keeps its own op counter.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

BOUNDARY_GRPC = "grpc"      # estimator fan-out, per member cluster
BOUNDARIES = (BOUNDARY_GRPC,)

KINDS = ("error", "partition", "flap", "latency")


class InjectedFault(RuntimeError):
    """A fault-plan decision, raised at the boundary it targets. Carries the
    gRPC-style status code chaos rules use (`UNAVAILABLE` by default,
    `DEADLINE_EXCEEDED` for latency-style kills) so the breaker/metric layer
    classifies injected faults exactly like real ones."""

    def __init__(self, boundary: str, target: str, code: str = "UNAVAILABLE"):
        super().__init__(f"injected fault [{boundary}/{target}] {code}")
        self.boundary = boundary
        self.target = target
        self.code = code


@dataclass(frozen=True)
class FaultRule:
    boundary: str
    target: str = "*"
    kind: str = "error"
    rate: float = 1.0          # per-op fault probability (error / latency)
    latency: float = 0.0       # seconds (kind=latency)
    period: int = 4            # ops per half-cycle (kind=flap)
    after: int = 0             # first faultable op index at this site
    heal_after: int = 0        # first healed op index; 0 = never heals
    code: str = "UNAVAILABLE"  # status code injected errors carry

    def validate(self) -> None:
        if self.boundary not in BOUNDARIES:
            # a typo'd boundary would install cleanly and inject NOTHING —
            # the silent-clean chaos run this plane must never produce
            raise ValueError(
                f"unknown fault boundary {self.boundary!r} "
                f"(want one of {sorted(BOUNDARIES)})"
            )
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "flap" and self.period <= 0:
            raise ValueError("flap rule needs period > 0")
        if self.kind == "latency" and self.latency <= 0:
            raise ValueError("latency rule needs latency > 0")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate {self.rate} outside [0, 1]")


@dataclass
class FaultAction:
    """One site-op decision: at most one error and any accumulated latency."""

    error: Optional[str] = None  # status code when the op must fail
    latency: float = 0.0


def _splitmix_unit(seed: int, rule_idx: int, site: str, n: int) -> float:
    """Deterministic uniform [0,1) for one (rule, site, op) — splitmix64 over
    a stable mix of the identifying tuple (no Python hash randomization)."""
    h = 0xCBF29CE484222325
    for b in site.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    x = (seed * 0x9E3779B97F4A7C15 + rule_idx * 0xBF58476D1CE4E5B9
         + h + n) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return (x >> 11) / float(1 << 53)


@dataclass
class FaultPlan:
    seed: int = 0
    rules: list[FaultRule] = field(default_factory=list)

    def validate(self) -> None:
        for r in self.rules:
            r.validate()

    def decide(self, boundary: str, target: str, n: int) -> FaultAction:
        """Decision for op `n` at site (boundary, target) — pure, so the
        whole schedule can be previewed/replayed without an injector."""
        site = f"{boundary}/{target}"
        action = FaultAction()
        for i, r in enumerate(self.rules):
            if r.boundary != boundary:
                continue
            if r.target != "*" and r.target != target:
                continue
            if n < r.after or (r.heal_after and n >= r.heal_after):
                continue
            if r.kind == "partition":
                action.error = action.error or r.code
            elif r.kind == "flap":
                if ((n - r.after) // r.period) % 2 == 1:
                    action.error = action.error or r.code
            elif r.kind == "error":
                if _splitmix_unit(self.seed, i, site, n) < r.rate:
                    action.error = action.error or r.code
            elif r.kind == "latency":
                if _splitmix_unit(self.seed, i, site, n) < r.rate:
                    action.latency += r.latency
        return action

    def has_boundary(self, boundary: str) -> bool:
        """True when any rule can fire at `boundary` — call sites that
        reroute execution paths under chaos (e.g. the estimator sweep
        abandoning the fused fleet kernel for per-cluster legs) check this
        so an unrelated plan doesn't change their shape."""
        return any(r.boundary == boundary for r in self.rules)


class FaultInjector:
    """Installed plan + per-site op counters.

    `check()` is the call-site hook: it advances the site counter, applies
    latency (sleeps), and raises `InjectedFault` on an error decision.
    Thread-safe; counters only ever advance."""

    def __init__(self, plan: FaultPlan):
        plan.validate()
        self.plan = plan
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, str], int] = {}

    def decide(self, boundary: str, target: str) -> FaultAction:
        with self._lock:
            key = (boundary, target)
            n = self._counters.get(key, 0)
            self._counters[key] = n + 1
        action = self.plan.decide(boundary, target, n)
        if action.error or action.latency:
            from ..metrics import faults_injected

            faults_injected.inc(
                boundary=boundary,
                kind="error" if action.error else "latency",
            )
        return action

    def check(self, boundary: str, target: str) -> None:
        action = self.decide(boundary, target)
        if action.latency:
            import time

            time.sleep(action.latency)
        if action.error:
            raise InjectedFault(boundary, target, action.error)


# -- process-global installation -------------------------------------------

_active: Optional[FaultInjector] = None
_lock = threading.Lock()


def install(plan: FaultPlan) -> FaultInjector:
    global _active
    with _lock:
        _active = FaultInjector(plan)
        return _active


def reset() -> None:
    """Remove any installed injector."""
    global _active
    with _lock:
        _active = None


def active() -> Optional[FaultInjector]:
    """The installed injector, if any."""
    return _active


def check(boundary: str, target: str) -> None:
    """Hook for the boundary: no-op without an installed plan."""
    inj = active()
    if inj is not None:
        inj.check(boundary, target)
