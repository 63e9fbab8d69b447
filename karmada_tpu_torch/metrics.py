"""Prometheus-style counters, gauges and histograms (the port's copy of the
registry classes of metrics.py, with only the series the ported paths
touch: the estimator fan-out errors, the circuit breakers, the degraded
rounds, the injected faults, the schedule round's stage seconds, the
candidate window's size, fallbacks and truncations, and the simulation
plane's solves, scenarios and durations).

Dependency-free: a process-local registry with a text exposition
(`render()`) in the Prometheus format.
"""
from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field

_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


# one lock for every metric mutation: observations are read-modify-write
# and arrive from many threads (the estimator fan-out pool, the pipelined
# round's writer thread)
_mutate_lock = threading.Lock()


@dataclass
class Counter:
    name: str
    help: str = ""
    _values: dict[tuple, float] = field(default_factory=dict)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        k = _label_key(labels)
        with _mutate_lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        return sum(self._values.values())


@dataclass
class Gauge:
    name: str
    help: str = ""
    _values: dict[tuple, float] = field(default_factory=dict)

    def set(self, v: float, **labels: str) -> None:
        with _mutate_lock:
            self._values[_label_key(labels)] = v

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)


@dataclass
class Histogram:
    name: str
    help: str = ""
    buckets: tuple = _DEFAULT_BUCKETS
    _counts: dict[tuple, list[int]] = field(default_factory=dict)
    _sums: dict[tuple, float] = field(default_factory=dict)
    _totals: dict[tuple, int] = field(default_factory=dict)

    def observe(self, v: float, **labels: str) -> None:
        k = _label_key(labels)
        with _mutate_lock:
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            i = bisect.bisect_left(self.buckets, v)
            if i < len(counts):
                counts[i] += 1
            self._sums[k] = self._sums.get(k, 0.0) + v
            self._totals[k] = self._totals.get(k, 0) + 1

    def count(self, **labels: str) -> int:
        return self._totals.get(_label_key(labels), 0)

    def sum(self, **labels: str) -> float:
        return self._sums.get(_label_key(labels), 0.0)

    def quantile(self, q: float, **labels: str) -> float:
        """Approximate quantile from bucket upper bounds (scrape-side math)."""
        k = _label_key(labels)
        counts = self._counts.get(k)
        total = self._totals.get(k, 0)
        if not counts or total == 0:
            return 0.0
        target = q * total
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                return self.buckets[i]
        return self.buckets[-1]


def _fmt_labels(k: tuple) -> str:
    if not k:
        return ""
    return "{" + ",".join(f'{name}="{val}"' for name, val in k) + "}"


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Counter(name=name, help=help)
                self._metrics[name] = m
            return m  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Gauge(name=name, help=help)
                self._metrics[name] = m
            return m  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "", buckets: tuple = _DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name=name, help=help, buckets=buckets)
                self._metrics[name] = m
            return m  # type: ignore[return-value]

    def render(self) -> str:
        """Prometheus text exposition; label sets are snapshotted under the
        mutation lock."""
        out: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            if isinstance(m, Histogram):
                out.append(f"# TYPE {m.name} histogram")
                with _mutate_lock:
                    counts = {k: list(v) for k, v in m._counts.items()}
                    sums = dict(m._sums)
                    totals = dict(m._totals)
                for k in sorted(totals):
                    acc = 0
                    for i, c in enumerate(counts[k]):
                        acc += c
                        le = ("le", repr(m.buckets[i]))
                        out.append(f"{m.name}_bucket{_fmt_labels(k + (le,))} {acc}")
                    inf = ("le", "+Inf")
                    out.append(f"{m.name}_bucket{_fmt_labels(k + (inf,))} {totals[k]}")
                    out.append(f"{m.name}_sum{_fmt_labels(k)} {sums[k]}")
                    out.append(f"{m.name}_count{_fmt_labels(k)} {totals[k]}")
                continue
            kind = "counter" if isinstance(m, Counter) else "gauge"
            out.append(f"# TYPE {m.name} {kind}")
            with _mutate_lock:
                items = sorted(m._values.items())
            for k, v in items:
                out.append(f"{m.name}{_fmt_labels(k)} {v}")
        return "\n".join(out) + "\n"


registry = MetricsRegistry()

# degraded rounds are schedule rounds that completed while at least one
# member's breaker was open (stale estimator rows stayed in the matrix with
# the staleness penalty applied)
degraded_rounds = registry.counter(
    "karmada_degraded_rounds_total",
    "Schedule rounds completed while at least one member breaker was open",
)
estimator_rpc_errors = registry.counter(
    "karmada_estimator_rpc_errors_total",
    "Estimator fan-out failures by cluster and status code",
)
breaker_transitions = registry.counter(
    "karmada_breaker_transitions_total",
    "Circuit-breaker state transitions by member and destination state",
)
breaker_state = registry.gauge(
    "karmada_breaker_state",
    "Per-member breaker state: 0 closed, 1 half-open, 2 open",
)
faults_injected = registry.counter(
    "karmada_faults_injected_total",
    "Fault-plan decisions that fired, by boundary and kind",
)
schedule_stage_seconds = registry.histogram(
    "karmada_schedule_stage_seconds",
    "Wall seconds per schedule-round pipeline stage",
)
candidate_k = registry.gauge(
    "karmada_candidate_k",
    "Effective top-K candidate window of the last compact round, by "
    "shape_bucket bucket",
)
candidate_fallback = registry.counter(
    "karmada_candidate_fallback_total",
    "Schedule rounds (or spread-row subsets) that fell back to the exact "
    "dense solve, by reason (small_fleet/spread_constraint/policy/"
    "duplicated)",
)
candidate_truncations = registry.counter(
    "karmada_candidate_truncations_total",
    "Feasible clusters dropped by the top-K candidate window on divided "
    "rows (nonzero means compact decisions may diverge from exact dense)",
)

# what-if simulation plane (simulation/engine.py): `mode=batched` counts
# the scenario-stacked [S,B,C] solves (one per scenario chunk: S scenarios
# cost ONE solve when they fit the memory budget); `mode=fallback` counts
# per-scenario exact re-solves for rows outside the batched path
simulation_solves = registry.counter(
    "karmada_simulation_solves_total",
    "What-if solve launches by mode (batched = one scenario-stacked solve)",
)
simulation_scenarios = registry.counter(
    "karmada_simulation_scenarios_total",
    "Scenarios evaluated by the simulation plane",
)
simulation_duration = registry.histogram(
    "karmada_simulation_duration_seconds",
    "End-to-end what-if simulation latency in seconds",
)
