"""The port's scheduling queues, feature gates and metrics held against the
JAX package's: `PrioritySchedulingQueue` (pop order by priority then FIFO,
exponential backoff, the unschedulable pool and its maximum stay, priority
aging, `readd` / `forget` / `retry` bookkeeping) and `GangCoordinator`
(holds, releases, expiry, discards) driven by one stepped `Clock`;
`FeatureGates`; and the daemon's metric series, whose names, help strings,
buckets and renders (exemplars included) must be the reference's. Each
scenario runs once per package and records a trace; the traces must be
equal."""
from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

PKGS = ("karmada_tpu", "karmada_tpu_torch")

# the series the port's daemon, streaming service and store observe
DAEMON_SERIES = (
    "schedule_attempts", "scheduling_algorithm_duration", "e2e_scheduling_duration",
    "queue_incoming_bindings", "placement_latency", "sched_queue_depth", "microbatch_size",
    "preemptions_total", "gang_admissions", "preemption_victims", "store_lock_wait",
    "store_lock_hold", "txn_batch_size", "writes_coalesced", "degraded_rounds",
    "schedule_stage_seconds", "shard_queue_depth",
)


def _mods(pkg: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        queue=imp("sched.queue"), controller=imp("runtime.controller"),
        features=imp("features"), metrics=imp("metrics"),
    )


def _queue_trace(m) -> list:
    clock = m.controller.Clock(fixed=1000.0)
    prio = {"b/high": 10, "b/low": 1, "b/mid": 5}
    q = m.queue.PrioritySchedulingQueue(clock, priority_fn=lambda k: prio.get(k, 0),
                                        aging_step=60.0)
    woken: list = []
    q.on_add = lambda: woken.append(len(q))
    trace: list = []
    for k in ("b/first", "b/high", "b/low", "b/second", "b/high"):
        q.add(k)
    trace.append(("len", len(q), q.active_len()))
    trace.append(("pop", [q.pop() for _ in range(5)]))
    # backoff: 1 s, then 2 s, capped at 10 s; an add overrides it
    q.add("b/x")
    trace.append(("pop-x", q.pop()))
    trace.append(("retry", q.retry("b/x"), q.pop()))
    clock.advance(1.0)
    trace.append(("due", q.pop(), q.retry("b/x")))
    clock.advance(1.5)
    trace.append(("not-due", q.pop(), len(q)))
    clock.advance(0.5)
    trace.append(("due2", q.pop()))
    q.retry("b/x")
    q.add("b/x")
    trace.append(("add-overrides-backoff", q.pop()))
    # the unschedulable pool: re-activated by an add, or after the max stay
    q.push_unschedulable("b/u1")
    q.push_unschedulable("b/u2")
    trace.append(("parked", q.pop(), len(q), q.active_len()))
    q.add("b/u1")
    trace.append(("reactivated", q.pop()))
    clock.advance(301.0)
    trace.append(("max-stay", q.pop()))
    # aging: a long-waiting priority-0 key overtakes a fresh priority-1 flood
    q.add("b/old")
    clock.advance(180.0)
    for i in range(3):
        prio[f"b/flood-{i}"] = 1
        q.add(f"b/flood-{i}")
    trace.append(("aged", q.drain(2), q.drain()))
    # readd keeps the cached priority without reading priority_fn
    q.add("b/mid")
    q.pop()
    prio["b/mid"] = 0
    q.readd("b/mid")
    q.add("b/zero")
    trace.append(("readd", q.drain()))
    # retry budget and forget
    q2 = m.queue.PrioritySchedulingQueue(clock, max_retries=2)
    q2.add("b/r")
    q2.pop()
    trace.append(("budget", q2.retry("b/r"), q2.retry("b/r"), q2.retry("b/r")))
    q2.forget("b/r")
    trace.append(("after-forget", q2.retry("b/r")))
    trace.append(("woken", woken))
    return trace


def _rb(m, name, gang, size):
    return SimpleNamespace(
        metadata=SimpleNamespace(name=name),
        spec=SimpleNamespace(gang_name=gang, gang_size=size),
    )


def _gang_trace(m) -> list:
    clock = m.controller.Clock(fixed=50.0)
    g = m.queue.GangCoordinator(clock, wait_seconds=30.0)
    trace: list = []

    def names(cohort):
        return [(k, r.metadata.name, e) for k, r, e in cohort]

    trace.append(("held", names(g.offer("a/0", _rb(m, "0", "a", 3), 1)), g.held_count()))
    trace.append(("held", names(g.offer("a/1", _rb(m, "1", "a", 3), 2)), g.held_count()))
    # a re-offer replaces the held snapshot (key-based)
    trace.append(("re-offer", names(g.offer("a/1", _rb(m, "1b", "a", 3), 5))))
    trace.append(("release", names(g.offer("a/2", _rb(m, "2", "a", 3), 3)), g.held_count()))
    # a misdeclared size: the largest declared K wins
    g.offer("b/0", _rb(m, "0", "b", 2), 0)
    trace.append(("mis-size", names(g.offer("b/1", _rb(m, "1", "b", 3), 0))))
    g.offer("c/0", _rb(m, "0", "c", 2), 0)
    g.discard("c/0", "c")
    g.discard("zz", "nope")
    trace.append(("discard", g.held_count()))
    clock.advance(10.0)
    g.offer("d/0", _rb(m, "0", "d", 4), 7)
    clock.advance(21.0)
    trace.append(("expire-b", [(n, names(c)) for n, c in g.expire(clock.now())], g.held_count()))
    clock.advance(10.0)
    trace.append(("expire-d", [(n, names(c)) for n, c in g.expire(clock.now())], g.held_count()))
    trace.append(("default-wait", m.queue.DEFAULT_GANG_WAIT))
    return trace


@pytest.mark.parametrize("scenario", [_queue_trace, _gang_trace], ids=["priority_queue", "gangs"])
def test_queues_match_reference(scenario):
    ref, port = (scenario(_mods(p)) for p in PKGS)
    assert port == ref
    assert len(port) > 5


def test_feature_gates_match_reference():
    def trace(m):
        f = m.features
        gates = f.FeatureGates({f.PRIORITY_BASED_SCHEDULING: True})
        out = [sorted(f.DEFAULTS.items()), gates.enabled(f.PRIORITY_BASED_SCHEDULING),
               gates.enabled(f.FAILOVER), f.default_gates.enabled(f.PRIORITY_BASED_SCHEDULING)]
        gates.set(f.FAILOVER, True)
        out.append(gates.enabled(f.FAILOVER))
        for bad in (lambda: gates.enabled("Nope"), lambda: gates.set("Nope", True),
                    lambda: f.FeatureGates({"Nope": True})):
            with pytest.raises(KeyError) as e:
                bad()
            out.append(str(e.value))
        return out

    ref, port = (trace(_mods(p)) for p in PKGS)
    assert port == ref


@pytest.mark.parametrize("series", DAEMON_SERIES)
def test_daemon_series_match_reference(series):
    ref, port = (getattr(_mods(p).metrics, series) for p in PKGS)
    assert type(port).__name__ == type(ref).__name__
    assert (port.name, port.help) == (ref.name, ref.help)
    assert getattr(port, "buckets", None) == getattr(ref, "buckets", None)


@pytest.mark.parametrize("exemplars", [True, False])
def test_render_with_exemplars_matches_reference(exemplars):
    """A fresh registry in each package, the same observations (a placement
    latency with trace exemplars, the worst per bucket kept, counters and a
    gauge with labels), the same text."""
    def render(m):
        reg = m.metrics.MetricsRegistry()
        lat = reg.histogram("karmada_placement_latency_seconds",
                            "Per-binding latency from watch-event admission to store patch",
                            buckets=m.metrics.placement_latency.buckets)
        for v, tid in ((0.003, "t1"), (0.004, "t2"), (0.002, None), (0.3, "t3"),
                       (75.0, "t4"), (0.0031, "t5")):
            lat.observe(v, exemplar=tid)
        lat.observe(0.01, shard="s1", exemplar="t6")
        reg.counter("karmada_scheduler_schedule_attempts_total", "attempts").inc(
            result="scheduled")
        reg.counter("karmada_scheduler_schedule_attempts_total").inc(2, result="error")
        reg.gauge("karmada_sched_queue_depth", "depth").set(7.0)
        with m.metrics.timed(reg.histogram("karmada_timed_seconds", "timed")):
            pass
        text = reg.render(exemplars=exemplars)
        # the timed span's seconds differ between runs: keep its count
        return [ln for ln in text.splitlines()
                if not ln.startswith(("karmada_timed_seconds_sum",
                                      "karmada_timed_seconds_bucket"))]

    ref, port = (render(_mods(p)) for p in PKGS)
    assert port == ref
    assert (port[-1] == "# EOF") is exemplars
    assert any('# {trace_id="t2"} 0.004' in ln for ln in port) is exemplars


def test_gauge_inc_and_remove_match_reference():
    """Gauge.inc (a label series' value plus the amount, 1 by default) and
    Gauge.remove (the series dropped; an absent one ignored): the same
    values and the same render as the reference's, on a fresh registry and
    on the process-wide shard_queue_depth series the shard daemon removes."""
    def trace(m):
        reg = m.metrics.MetricsRegistry()
        g = reg.gauge("karmada_test_gauge", "a gauge")
        out = []
        g.inc(shard="a")
        g.inc(2.5, shard="a")
        g.inc(-1.0, shard="b")
        g.set(4.0, shard="c")
        g.inc(shard="c")
        out.append([g.value(shard=s) for s in "abcd"])
        g.remove(shard="b")
        g.remove(shard="never-set")
        out.append([g.value(shard=s) for s in "abcd"])
        out.append(reg.render())
        depth = m.metrics.shard_queue_depth
        depth.inc(3.0, shard="test-gauge-inc")
        depth.inc(shard="test-gauge-inc")
        out.append(depth.value(shard="test-gauge-inc"))
        depth.remove(shard="test-gauge-inc")
        out.append(depth.value(shard="test-gauge-inc"))
        return out

    ref, port = (trace(_mods(p)) for p in PKGS)
    assert port == ref
    assert ref[0] == [3.5, -1.0, 5.0, 0.0] and ref[1] == [3.5, 0.0, 5.0, 0.0]
    assert ref[3:] == [4.0, 0.0]
