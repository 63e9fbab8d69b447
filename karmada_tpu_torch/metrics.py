"""Prometheus-style counters, gauges and histograms (the port's copy of the
registry classes of metrics.py, with only the series the ported paths
touch: the scheduler daemon's attempts, latencies and incoming bindings,
the streaming service's placement latency, queue depth and micro-batch
sizes, preemptions and gang admissions, the store's write lock and
transactional batches, the estimator fan-out errors, the circuit
breakers, the degraded rounds, the injected faults, the schedule round's
stage seconds, the candidate window's size, fallbacks and truncations,
the kernel library builds, and the simulation plane's solves, scenarios
and durations). Names, help strings and buckets are the reference's, so
both renders of a series match.

Dependency-free: a process-local registry with a text exposition
(`render()`) in the Prometheus format.
"""
from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

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
    # per-bucket exemplars: label key -> {bucket index: (value, trace_id)}
    # keeping the WORST observation per bucket — the trace an operator
    # wants when a bucket's count looks bad
    _exemplars: dict[tuple, dict] = field(default_factory=dict)

    def observe(self, v: float, exemplar: Optional[str] = None,
                **labels: str) -> None:
        k = _label_key(labels)
        with _mutate_lock:
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            i = bisect.bisect_left(self.buckets, v)
            if i < len(counts):
                counts[i] += 1
            self._sums[k] = self._sums.get(k, 0.0) + v
            self._totals[k] = self._totals.get(k, 0) + 1
            if exemplar:
                ex = self._exemplars.setdefault(k, {})
                cur = ex.get(i)
                if cur is None or v > cur[0]:
                    ex[i] = (v, exemplar)

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

    def render(self, exemplars: bool = True) -> str:
        """Prometheus text exposition; label sets are snapshotted under the
        mutation lock. `exemplars=False` omits the OpenMetrics exemplar
        suffixes (the classic text/plain 0.0.4 format does not allow
        them); with exemplars the exposition ends with the OpenMetrics
        '# EOF' terminator."""
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
                    ex_snap = ({k: dict(v) for k, v in m._exemplars.items()}
                               if exemplars else {})
                for k in sorted(totals):
                    acc = 0
                    for i, c in enumerate(counts[k]):
                        acc += c
                        le = ("le", repr(m.buckets[i]))
                        line = f"{m.name}_bucket{_fmt_labels(k + (le,))} {acc}"
                        ex = ex_snap.get(k, {}).get(i)
                        if ex is not None:
                            # OpenMetrics exemplar: the worst trace in this bucket
                            line += f' # {{trace_id="{ex[1]}"}} {ex[0]}'
                        out.append(line)
                    inf = ("le", "+Inf")
                    line = f"{m.name}_bucket{_fmt_labels(k + (inf,))} {totals[k]}"
                    ex = ex_snap.get(k, {}).get(len(m.buckets))
                    if ex is not None:
                        line += f' # {{trace_id="{ex[1]}"}} {ex[0]}'
                    out.append(line)
                    out.append(f"{m.name}_sum{_fmt_labels(k)} {sums[k]}")
                    out.append(f"{m.name}_count{_fmt_labels(k)} {totals[k]}")
                continue
            kind = "counter" if isinstance(m, Counter) else "gauge"
            out.append(f"# TYPE {m.name} {kind}")
            with _mutate_lock:
                items = sorted(m._values.items())
            for k, v in items:
                out.append(f"{m.name}{_fmt_labels(k)} {v}")
        text = "\n".join(out) + "\n"
        if exemplars:
            # OpenMetrics requires the exposition to end with '# EOF'
            text += "# EOF\n"
        return text


registry = MetricsRegistry()

# -- the scheduler metric set (metrics.go:61-127) ---------------------------

schedule_attempts = registry.counter(
    "karmada_scheduler_schedule_attempts_total",
    "Number of attempts to schedule resourceBinding",
)
e2e_scheduling_duration = registry.histogram(
    "karmada_scheduler_e2e_scheduling_duration_seconds",
    "E2e scheduling latency in seconds",
)
scheduling_algorithm_duration = registry.histogram(
    "karmada_scheduler_scheduling_algorithm_duration_seconds",
    "Scheduling algorithm latency in seconds",
)
queue_incoming_bindings = registry.counter(
    "karmada_scheduler_queue_incoming_bindings_total",
    "Number of bindings added to scheduling queues by event type",
)

# streaming scheduler (sched/streaming.py): the per-BINDING latency SLO —
# watch-event admission to the store patch that placed it. Buckets extend
# past the request-latency defaults: an overloaded admission queue backs
# up into seconds, and that tail is what the histogram must resolve.
placement_latency = registry.histogram(
    "karmada_placement_latency_seconds",
    "Per-binding latency from watch-event admission to store patch",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
)
sched_queue_depth = registry.gauge(
    "karmada_sched_queue_depth",
    "Dirty-binding keys waiting in the scheduling queue",
)
microbatch_size = registry.histogram(
    "karmada_microbatch_size",
    "Bindings per admitted streaming micro-batch",
    buckets=(1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512,
             1024, 2048, 4096),
)

# workload-class scheduling (sched/preemption.py): preemption plans by
# outcome (committed / aborted / infeasible), gang admissions by outcome
# (placed / timeout / rejected), and the victim bindings each committed
# plan cut
preemptions_total = registry.counter(
    "karmada_preemptions_total",
    "Preemption plans by outcome (committed/aborted/infeasible)",
)
gang_admissions = registry.counter(
    "karmada_gang_admissions_total",
    "Gang admission outcomes (placed/timeout/rejected)",
)
preemption_victims = registry.histogram(
    "karmada_preemption_victims",
    "Victim bindings cut per committed preemption plan",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)

# kernel library builds (kernels/build.py, the counterpart of the
# reference's compile counters): a library nvcc built in this process is a
# compile, one found already built under kernels/_build/ a persistent-cache
# hit
jit_compile_seconds = registry.histogram(
    "karmada_jit_compile_seconds",
    "nvcc wall seconds per kernel library built in this process",
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 240.0),
)
jit_cache_misses = registry.counter(
    "karmada_jit_cache_misses_total",
    "Kernel libraries built by nvcc in this process",
)
jit_persistent_cache_hits = registry.counter(
    "karmada_jit_persistent_cache_hits_total",
    "Kernel libraries found already built on disk",
)

# control-plane write path (store/store.py transactional batch writes):
# how long writers queue on the store's one mutation lock, how long the
# critical section is, how many objects each transactional batch commits,
# and how many writes the coalescing call sites merged into batch calls
store_lock_wait = registry.histogram(
    "karmada_store_lock_wait_seconds",
    "Wall seconds a mutator waited to acquire the store write lock",
    buckets=(1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3,
             0.01, 0.05, 0.1, 0.5, 1.0),
)
store_lock_hold = registry.histogram(
    "karmada_store_lock_hold_seconds",
    "Wall seconds the store write lock was held per mutation/batch",
    buckets=(1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3,
             0.01, 0.05, 0.1, 0.5, 1.0),
)
txn_batch_size = registry.histogram(
    "karmada_txn_batch_size",
    "Objects committed per transactional store batch write",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
)
writes_coalesced = registry.counter(
    "karmada_writes_coalesced_total",
    "Writes that rode a coalesced batch call instead of their own "
    "round-trip, by call-site path",
)

# sharded scheduler plane: the per-shard queue depth a sharded daemon
# publishes after each micro-batch drain
shard_queue_depth = registry.gauge(
    "karmada_shard_queue_depth",
    "Per-shard scheduling queue depth after each micro-batch drain "
    "(labeled by shard; rows retire with the shard)",
)

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


class timed:
    """Context manager observing wall time into a histogram."""

    def __init__(self, hist: Histogram, **labels: str):
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self._t0, **self.labels)
        return False
