"""Prometheus-style counters and gauges (the port's copy of the registry
classes of metrics.py, with only the series the estimator path touches:
the estimator fan-out errors, the circuit breakers, the degraded rounds
and the injected faults).

Dependency-free: a process-local registry with a text exposition
(`render()`) in the Prometheus format.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


# one lock for every metric mutation: observations are read-modify-write
# and arrive from many threads (the estimator fan-out pool)
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

    def render(self) -> str:
        """Prometheus text exposition; label sets are snapshotted under the
        mutation lock."""
        out: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
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
