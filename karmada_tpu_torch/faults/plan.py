"""Deterministic fault injection: seeded chaos schedules, replayable bit-for-bit
(the port's copy of faults/plan.py; the same seed and plan give the same
schedule bytes in either package).

A `FaultPlan` is a seed plus a list of `FaultRule`s. Every member-facing I/O
site (the three process boundaries: `RemoteStore` HTTP, the estimator gRPC
fan-out, and member apply) asks the installed `FaultInjector` for a decision
before doing real work. Decisions are a PURE function of
(plan seed, rule index, boundary, target, per-site operation sequence number)
— never of wall clock or thread identity — so the same plan against the same
sequence of operations produces byte-identical fault schedules, and a chaos
run can be replayed exactly.

Installation is env-gated for daemon processes: set
`KARMADA_TPU_FAULT_PLAN` to a JSON document (or a path to one) and every
process that consults `active()` injects the same schedule. In-process tests
install a plan explicitly with `install()` / the `installed()` context
manager.

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

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Optional

BOUNDARY_HTTP = "http"      # RemoteStore <-> control-plane apiserver
BOUNDARY_GRPC = "grpc"      # estimator fan-out, per member cluster
BOUNDARY_APPLY = "apply"    # execution controller / agent -> member apply
BOUNDARIES = (BOUNDARY_HTTP, BOUNDARY_GRPC, BOUNDARY_APPLY)

KINDS = ("error", "partition", "flap", "latency")

# Process-level fault vocabulary: whole-process events the soak harness fires
# BETWEEN traffic slices (boundary rules above fire per-op, these fire
# per-wave). The plan only *decides* (pure, seeded); the harness *executes*
# (kills the leader server, resizes the shard plane, valves a follower,
# blacks out an estimator) because only it holds the process handles.
PROCESS_KINDS = (
    "leader_kill",          # stop leader server group; seal-and-promote
    "shard_kill",           # kill one scheduler shard; map-resize handoff
    "partition",            # isolate a follower past the log ring (snapshot)
    "estimator_blackout",   # member estimators answer nothing for a window
)
ENV_FAULT_PLAN = "KARMADA_TPU_FAULT_PLAN"


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


@dataclass(frozen=True)
class ProcessFaultRule:
    """One whole-process fault candidate. `wave` pins the rule to exactly one
    fault wave (the unit that replays deterministically — the soak has no
    per-op counter for process lifecycles); wave=-1 makes the rule a
    candidate on EVERY wave, gated by the seeded `rate` coin."""

    kind: str
    target: str = "*"      # follower name / shard index / member — "*" lets
    #                        the harness pick (e.g. the max-applied follower)
    wave: int = -1         # fire on exactly this wave; -1 = every wave
    rate: float = 1.0      # per-wave firing probability (splitmix coin)

    def validate(self) -> None:
        if self.kind not in PROCESS_KINDS:
            raise ValueError(
                f"unknown process fault kind {self.kind!r} "
                f"(want one of {sorted(PROCESS_KINDS)})"
            )
        if self.wave < -1:
            raise ValueError(f"wave {self.wave} < -1")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate {self.rate} outside [0, 1]")


@dataclass(frozen=True)
class ProcessEvent:
    """One fired process fault: what the harness must do this wave."""

    kind: str
    target: str
    wave: int


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
    process_rules: list[ProcessFaultRule] = field(default_factory=list)

    def validate(self) -> None:
        for r in self.rules:
            r.validate()
        for p in self.process_rules:
            p.validate()

    # -- (de)serialization -------------------------------------------------

    @staticmethod
    def from_dict(d: dict) -> "FaultPlan":
        plan = FaultPlan(
            seed=int(d.get("seed", 0)),
            rules=[FaultRule(**r) for r in d.get("rules", [])],
            process_rules=[
                ProcessFaultRule(**r) for r in d.get("process_rules", [])
            ],
        )
        plan.validate()
        return plan

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        return FaultPlan.from_dict(json.loads(text))

    def to_json(self) -> str:
        from dataclasses import asdict

        doc = {"seed": self.seed, "rules": [asdict(r) for r in self.rules]}
        if self.process_rules:
            doc["process_rules"] = [asdict(r) for r in self.process_rules]
        return json.dumps(doc, sort_keys=True)

    # -- the pure decision function ---------------------------------------

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

    def process_events(self, wave: int) -> list[ProcessEvent]:
        """Process faults that fire on fault wave `wave` — pure, like
        `decide()`, so a soak's whole process-fault schedule can be previewed
        without a harness. The splitmix coin keys on a "process/" site string,
        which no boundary rule can produce, so process and boundary streams
        never correlate even under the same seed."""
        fired = []
        for i, r in enumerate(self.process_rules):
            if r.wave != -1 and r.wave != wave:
                continue
            site = f"process/{r.kind}/{r.target}"
            if r.rate >= 1.0 or _splitmix_unit(self.seed, i, site, wave) < r.rate:
                fired.append(ProcessEvent(kind=r.kind, target=r.target, wave=wave))
        return fired

    def process_schedule(self, n_waves: int) -> bytes:
        """All process-fault firings over the first `n_waves` waves,
        serialized — the byte-identical-replay witness for the process
        vocabulary (mirrors `schedule()` for boundary rules)."""
        out = []
        for w in range(n_waves):
            for e in self.process_events(w):
                out.append(f"{w}:{e.kind}:{e.target}")
        return "\n".join(out).encode()

    def has_boundary(self, boundary: str) -> bool:
        """True when any rule can fire at `boundary` — call sites that
        reroute execution paths under chaos (e.g. the estimator sweep
        abandoning the fused fleet kernel for per-cluster legs) check this
        so an unrelated plan doesn't change their shape."""
        return any(r.boundary == boundary for r in self.rules)

    def schedule(self, boundary: str, target: str, n_ops: int) -> bytes:
        """The first `n_ops` decisions at one site, serialized — the
        byte-identical-replay witness (same seed + same plan ⇒ same bytes)."""
        out = []
        for n in range(n_ops):
            a = self.decide(boundary, target, n)
            out.append(f"{n}:{a.error or '-'}:{a.latency:g}")
        return "\n".join(out).encode()


class FaultInjector:
    """Installed plan + per-site op counters + the decision trace.

    `check()` is the call-site hook: it advances the site counter, applies
    latency (sleeps), and raises `InjectedFault` on an error decision.
    Thread-safe; counters only ever advance."""

    def __init__(self, plan: FaultPlan):
        plan.validate()
        self.plan = plan
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, str], int] = {}
        self.trace: list[tuple[str, str, int, str, float]] = []

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
            with self._lock:
                self.trace.append(
                    (boundary, target, n, action.error or "", action.latency)
                )
        return action

    def check(self, boundary: str, target: str) -> None:
        action = self.decide(boundary, target)
        if action.latency:
            import time

            time.sleep(action.latency)
        if action.error:
            raise InjectedFault(boundary, target, action.error)

    def trace_bytes(self) -> bytes:
        """The recorded fault schedule, serialized for replay comparison."""
        with self._lock:
            rows = list(self.trace)
        return "\n".join(
            f"{b}/{t}:{n}:{e or '-'}:{lat:g}" for b, t, n, e, lat in rows
        ).encode()


# -- process-global installation (env-gated for daemons) -------------------

_active: Optional[FaultInjector] = None
_env_checked = False
_env_error: Optional[Exception] = None
# RLock: active()'s env-gated first call installs while already holding it
_lock = threading.RLock()


def install(plan: FaultPlan) -> FaultInjector:
    global _active, _env_checked
    with _lock:
        _active = FaultInjector(plan)
        _env_checked = True
        return _active


def reset() -> None:
    """Remove any installed injector AND forget the env check (tests)."""
    global _active, _env_checked, _env_error
    with _lock:
        _active = None
        _env_checked = False
        _env_error = None


def install_from_env() -> Optional[FaultInjector]:
    """Install from KARMADA_TPU_FAULT_PLAN (inline JSON, or a path to a JSON
    file). Returns None when the variable is unset. A malformed plan fails
    loudly — a chaos run silently running fault-free would be worse."""
    spec = os.environ.get(ENV_FAULT_PLAN, "")
    if not spec:
        return None
    text = spec
    if not spec.lstrip().startswith("{"):
        with open(spec, encoding="utf-8") as f:
            text = f.read()
    return install(FaultPlan.from_json(text))


def active() -> Optional[FaultInjector]:
    """The installed injector, if any. The first call per process also
    honors the env gate, so daemons need no explicit wiring beyond calling
    the boundary hooks. The check-and-install is atomic: exactly ONE
    injector is ever minted per process for an env plan — a second install
    would reset the per-site op counters and break bit-for-bit replay.

    A MALFORMED env plan fails persistently: the parse error re-raises on
    every call (not just the first, which a broad except at some boundary
    might swallow) — a broken chaos run must never quietly become a clean
    run that reports success."""
    global _env_checked, _env_error
    if _env_error is not None:
        raise _env_error
    if _active is None and not _env_checked:
        with _lock:
            if _env_error is not None:
                raise _env_error
            if _env_checked:
                return _active  # another thread won the race
            _env_checked = True
            if os.environ.get(ENV_FAULT_PLAN, ""):
                try:
                    return install_from_env()
                except Exception as e:
                    _env_error = e
                    raise
    return _active


def check(boundary: str, target: str) -> None:
    """Hook for the three boundaries: no-op without an installed plan."""
    inj = active()
    if inj is not None:
        inj.check(boundary, target)
