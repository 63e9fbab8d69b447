"""Distributed placement tracing: causal spans from template write to
member apply (docs/OBSERVABILITY.md).

The port's copy of the JAX package's `tracing/spans.py`, unchanged in behaviour.

Every binding gets a trace keyed by (uid, admission epoch); components
along the placement pipeline append COMPLETED spans (start/end wall-clock
seconds — cross-process comparable) as the binding moves through them:

    template_write -> detector_match -> binding_create -> queue_wait
    (gang_hold / queue_aging as their own spans) -> solve (one shared
    launch fanned to its member rows) -> commit (the rv-checked batch
    cohort) -> work_fanout -> member_apply -> status_aggregation

Sampling is decided at PLACEMENT time, not admission time, so forced tail
sampling is possible: spans for every binding accumulate in a bounded
pending map (cheap tuple appends), and when the placement latency is known
the trace is RETAINED iff it head-samples (deterministic: crc32(trace_id)
modulo the sampling ratio — every process agrees without coordination) OR
the latency breached the placement-SLO slow threshold. Dropped traces cost
a dict pop. Retained traces land in a bounded ring served at GET /traces
and keep accepting the post-placement spans (Work fan-out, member apply,
status aggregation) that arrive after the placement patched.

Cross-process propagation rides the `X-Karmada-Trace` header on
RemoteStore HTTP writes (the receiving plane records the server-side
commit span under the caller's context; span ids are generated once per
LOGICAL write so replay-idempotent retries and 409-redirect re-sends
dedup to exactly one span) and the coalesced agent-status path for
pull-mode apply spans (the agent stamps its apply timing onto the Work as
the `trace.karmada.io/apply-span` annotation; the plane's TraceCollector
lifts it — same id under replay, so coalescer re-sends can't double-count).

Knobs (env, also constructor args): KARMADA_TPU_TRACE_SAMPLE (head
sampling ratio 1/N, default 64; 1 = sample everything, 0 disables
head sampling entirely so only SLO breaches retain),
KARMADA_TPU_TRACE_SLOW_MS (tail-sampling threshold, default 1000 — the
placement-SLO histogram's slow bucket), KARMADA_TPU_TRACING=0 (off).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Optional

TRACE_HEADER = "X-Karmada-Trace"

# Work annotation carrying the pull-mode apply span (agent -> plane over
# the existing coalesced agent-status write; see agent/agent.py)
APPLY_SPAN_ANNOTATION = "trace.karmada.io/apply-span"

DEFAULT_HEAD_SAMPLE = 64       # 1 in 64 traces head-sample
DEFAULT_SLOW_PLACEMENT_S = 1.0  # tail-sample anything slower than this
DEFAULT_RING_CAPACITY = 512    # retained traces
DEFAULT_PENDING_CAP = 16384    # in-flight (pre-placement) traces


@dataclass
class Span:
    name: str
    start: float                 # wall seconds (time.time)
    end: float
    span_id: str = ""
    parent_id: str = ""
    attrs: dict = field(default_factory=dict)

    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    def to_dict(self) -> dict:
        d = {"name": self.name, "start": self.start, "end": self.end,
             "duration_ms": round(self.duration() * 1e3, 3)}
        if self.span_id:
            d["span_id"] = self.span_id
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class TraceRecord:
    __slots__ = ("trace_id", "uid", "key", "epoch", "started", "admitted",
                 "spans", "retained", "placement_s")

    def __init__(self, trace_id: str, uid: str, key: str, epoch: int):
        self.trace_id = trace_id
        self.uid = uid
        self.key = key                 # binding "namespace/name" ("" = orphan)
        self.epoch = epoch
        self.started = time.time()
        self.admitted: Optional[float] = None
        self.spans: list[Span] = []
        self.retained = ""             # "" pending | "head" | "slo"
        self.placement_s: Optional[float] = None

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "uid": self.uid, "key": self.key,
            "epoch": self.epoch, "started": self.started,
            "retained": self.retained,
            "placement_s": self.placement_s,
            "spans": [s.to_dict() for s in sorted(
                self.spans, key=lambda s: (s.start, s.end))],
        }

    def summary(self) -> dict:
        return {
            "trace_id": self.trace_id, "key": self.key, "epoch": self.epoch,
            "retained": self.retained, "placement_s": self.placement_s,
            "spans": len(self.spans),
        }


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class PlacementTracer:
    """Process-global trace buffer + sampler. Every method is a cheap
    no-op when `enabled` is False; all state is bounded. The lock is a
    LEAF — no method calls out while holding it, so recording from
    under-lock store sinks, watch handlers, and the pipeline writer can
    never invert."""

    def __init__(self, head_sample: Optional[int] = None,
                 slow_threshold_s: Optional[float] = None,
                 capacity: int = DEFAULT_RING_CAPACITY,
                 pending_cap: int = DEFAULT_PENDING_CAP):
        self.enabled = os.environ.get("KARMADA_TPU_TRACING", "") not in (
            "0", "off", "false")
        self.head_sample = (
            _env_int("KARMADA_TPU_TRACE_SAMPLE", DEFAULT_HEAD_SAMPLE)
            if head_sample is None else head_sample
        )
        if slow_threshold_s is None:
            slow_threshold_s = _env_int(
                "KARMADA_TPU_TRACE_SLOW_MS",
                int(DEFAULT_SLOW_PLACEMENT_S * 1000)) / 1000.0
        self.slow_threshold_s = slow_threshold_s
        self.capacity = capacity
        self.pending_cap = pending_cap
        self._lock = threading.Lock()
        self._pending: OrderedDict[str, TraceRecord] = OrderedDict()
        self._ring: OrderedDict[str, TraceRecord] = OrderedDict()
        self._by_key: dict[str, str] = {}   # key -> retained trace_id
        self._tid_pending: dict[str, TraceRecord] = {}
        self._marks: dict[tuple[str, str], float] = {}
        self._seen: OrderedDict[tuple[str, str], None] = OrderedDict()
        self._sid = itertools.count(1)
        # drops/evictions are observable, not silent (docs/OBSERVABILITY.md)
        self.evicted = 0

    # -- sampling ----------------------------------------------------------

    def head_sampled(self, trace_id: str) -> bool:
        """Deterministic head decision: a pure function of the trace id, so
        every process (plane, scheduler, agent) agrees without any
        coordination. head_sample<=0 means NO head sampling (tail only);
        1 samples everything."""
        if self.head_sample <= 0:
            return False
        if self.head_sample == 1:
            return True
        return zlib.crc32(trace_id.encode()) % self.head_sample == 0

    # -- trace lifecycle ---------------------------------------------------

    def _insert_pending(self, key: str, rec: TraceRecord) -> None:
        """Insert a fresh pending record and enforce the bound (caller
        holds the lock)."""
        self._pending[key] = rec
        self._tid_pending[rec.trace_id] = rec
        while len(self._pending) > self.pending_cap:
            _, old = self._pending.popitem(last=False)
            self._tid_pending.pop(old.trace_id, None)
            self.evicted += 1

    def begin(self, key: str, uid: str, epoch: int = 0
              ) -> Optional[TraceRecord]:
        """Start (or return) the pending trace for a binding key. Called by
        the plane collector at binding create and by the scheduler at
        admission; setdefault semantics mirror AdmissionLog._admitted — a
        pending stretch has ONE trace however many events coalesce into it."""
        if not self.enabled:
            return None
        with self._lock:
            rec = self._pending.get(key)
            if rec is None:
                rec = TraceRecord(f"{uid}:{epoch}", uid, key, epoch)
                self._insert_pending(key, rec)
            return rec

    def admit(self, key: str, uid: str, epoch: int) -> None:
        """Queue admission (the streaming AdmissionLog's note): stamp the
        admitted-at wall time — the start of the queue_wait span — and
        re-key a collector-begun trace to its real (uid, epoch) identity.
        Only the FIRST admission of a pending stretch sticks (coalesced
        re-events keep the original clock, exactly like the SLO histogram)."""
        if not self.enabled:
            return
        with self._lock:
            rec = self._pending.get(key)
            if rec is None:
                rec = TraceRecord(f"{uid}:{epoch}", uid, key, epoch)
                self._insert_pending(key, rec)
            if rec.admitted is None:
                rec.admitted = time.time()
                if rec.epoch != epoch:
                    # the collector began this trace at binding create with
                    # a provisional epoch; adopt the admission epoch — the
                    # trace KEY of the data model (uid, admission epoch)
                    self._tid_pending.pop(rec.trace_id, None)
                    rec.epoch = epoch
                    rec.trace_id = f"{rec.uid}:{epoch}"
                    self._tid_pending[rec.trace_id] = rec

    def drained(self, key: str, aging_step: float = 0.0,
                **attrs: Any) -> None:
        """The binding left the queue into a micro-batch: close the
        queue_wait span (admission -> drain), with the aged portion as its
        own queue_aging span when the wait crossed the queue's aging step.
        `attrs` ride the queue_wait span (the sharded plane stamps which
        shard's queue held the key)."""
        if not self.enabled:
            return
        now = time.time()
        with self._lock:
            rec = self._pending.get(key)
            if rec is None or rec.admitted is None:
                return
            rec.spans.append(Span("queue_wait", rec.admitted, now,
                                  attrs=dict(attrs)))
            if aging_step > 0 and now - rec.admitted > aging_step:
                rec.spans.append(Span(
                    "queue_aging", rec.admitted + aging_step, now,
                    attrs={"aging_step_s": aging_step}))

    def record(self, key: str, name: str, start: float, end: float,
               span_id: str = "", parent_id: str = "", placed: bool = False,
               **attrs: Any) -> None:
        """Append a completed span to the binding's trace. `placed=False`
        (the pre-placement stages: detector, solve, commit) targets the
        PENDING stretch; `placed=True` (the stages that land AFTER the
        placement patched: work fan-out, member apply, status aggregation)
        targets the RETAINED trace only — the patch's own watch event
        opens a fresh pending stretch for the key, and appending there
        would attach this placement's tail to the next stretch's trace.
        No-op when the binding has no live trace (dropped by sampling)."""
        if not self.enabled:
            return
        with self._lock:
            if placed:
                tid = self._by_key.get(key)
                rec = self._ring.get(tid) if tid else None
                if rec is not None and end < rec.started:
                    # causal guard: a post-placement span that ENDED before
                    # this trace even began belongs to a PREVIOUS placement
                    # (e.g. the apply-span annotation preserved on a Work
                    # the controller rewrote for a re-placed binding) — it
                    # must not stretch the new waterfall backwards
                    return
            else:
                rec = self._pending.get(key)
            if rec is None:
                return
            if span_id:
                k = (rec.trace_id, span_id)
                if k in self._seen:
                    return
                self._remember(k)
            rec.spans.append(Span(name, start, end, span_id=span_id,
                                  parent_id=parent_id, attrs=dict(attrs)))

    def record_trace(self, trace_id: str, name: str, start: float,
                     end: float, span_id: str = "", **attrs: Any) -> None:
        """Append a span by TRACE id — the cross-process entry point (the
        apiserver's commit span under an X-Karmada-Trace header). With a
        span_id, replays dedup to exactly one span. An unknown trace id
        begins an orphan pending record so remote-context spans are not
        silently lost."""
        if not self.enabled:
            return
        with self._lock:
            if span_id:
                k = (trace_id, span_id)
                if k in self._seen:
                    return
                self._remember(k)
            rec = self._tid_pending.get(trace_id) or self._ring.get(trace_id)
            if rec is None:
                rec = TraceRecord(trace_id, trace_id.rsplit(":", 1)[0],
                                  "", 0)
                self._insert_pending(f"~{trace_id}", rec)
            rec.spans.append(Span(name, start, end, span_id=span_id,
                                  attrs=dict(attrs)))

    def mark(self, key: str, name: str) -> None:
        """Open a long-running mark (gang hold) closed by unmark()."""
        if not self.enabled:
            return
        with self._lock:
            self._marks.setdefault((key, name), time.time())
            # bound abandoned marks (a gang that timed out and never
            # re-offered): drop the oldest insertion past the cap
            while len(self._marks) > 4096:
                del self._marks[next(iter(self._marks))]

    def unmark(self, key: str, name: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            t0 = self._marks.pop((key, name), None)
            if t0 is None:
                return
            rec = self._pending.get(key)
            if rec is not None:
                rec.spans.append(Span(name, t0, time.time(),
                                      attrs=dict(attrs)))

    def finish_placement(self, key: str, latency_s: Optional[float]
                         ) -> Optional[str]:
        """The placement patched: decide retention. Retained = head-sampled
        (deterministic) OR the latency breached the SLO slow threshold
        (forced tail sampling — the slow trace survives even when head
        sampling would drop it). Returns the trace id when retained (the
        caller feeds it to the SLO histogram as the bucket exemplar)."""
        if not self.enabled:
            return None
        now = time.time()
        with self._lock:
            rec = self._pending.pop(key, None)
            if rec is None:
                return None
            self._tid_pending.pop(rec.trace_id, None)
            rec.placement_s = latency_s
            slow = (latency_s is not None
                    and latency_s >= self.slow_threshold_s)
            head = self.head_sampled(rec.trace_id)
            if not (head or slow):
                return None
            rec.retained = "head" if head else "slo"
            if rec.admitted is not None:
                rec.spans.append(Span("placement", rec.admitted, now,
                                      attrs={"latency_s": latency_s}))
            self._ring[rec.trace_id] = rec
            self._by_key[key] = rec.trace_id
            while len(self._ring) > self.capacity:
                tid, old = self._ring.popitem(last=False)
                if self._by_key.get(old.key) == tid:
                    del self._by_key[old.key]
            return rec.trace_id

    def settle(self, key: str) -> None:
        """The pending stretch resolved without a measured placement
        (clean drain, suspension, invalidation): drop the trace."""
        if not self.enabled:
            return
        with self._lock:
            rec = self._pending.pop(key, None)
            if rec is not None:
                self._tid_pending.pop(rec.trace_id, None)

    def forget(self, key: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            rec = self._pending.pop(key, None)
            if rec is not None:
                self._tid_pending.pop(rec.trace_id, None)
            for mk in [m for m in self._marks if m[0] == key]:
                del self._marks[mk]

    # -- serving -----------------------------------------------------------

    def traces(self) -> list[dict]:
        with self._lock:
            return [r.summary() for r in reversed(self._ring.values())]

    def get(self, trace_id: Optional[str] = None,
            key: Optional[str] = None) -> Optional[dict]:
        with self._lock:
            rec = None
            if trace_id:
                rec = self._ring.get(trace_id) or self._tid_pending.get(
                    trace_id)
            elif key:
                tid = self._by_key.get(key)
                rec = (self._ring.get(tid) if tid
                       else self._pending.get(key))
            return None if rec is None else rec.to_dict()

    def retained(self) -> list[TraceRecord]:
        with self._lock:
            return list(self._ring.values())

    def config(self) -> dict:
        return {
            "enabled": self.enabled,
            "head_sample": self.head_sample,
            "slow_threshold_s": self.slow_threshold_s,
            "capacity": self.capacity,
            "pending": len(self._pending),
            "retained": len(self._ring),
            "evicted": self.evicted,
        }

    def reset(self) -> None:
        with self._lock:
            self._pending.clear()
            self._ring.clear()
            self._by_key.clear()
            self._tid_pending.clear()
            self._marks.clear()
            self._seen.clear()
            self.evicted = 0

    def _remember(self, k: tuple[str, str]) -> None:
        """Bounded span-id dedup memory (caller holds the lock)."""
        self._seen[k] = None
        while len(self._seen) > 4096:
            self._seen.popitem(last=False)


# the process-global tracer every component records into
tracer = PlacementTracer()


def new_span_id() -> str:
    """Globally-unique span id for a LOGICAL operation. Generate once per
    logical write, BEFORE any retry loop — replays and redirect re-sends
    then carry the same id and the receiver dedups to one span."""
    return "w" + os.urandom(6).hex()


# -- cross-process context (X-Karmada-Trace) --------------------------------

_ctx = threading.local()


def current_context() -> Optional[tuple[str, str, bool]]:
    """(trace_id, span_id, sampled) of the innermost active context on
    this thread, or None."""
    stack = getattr(_ctx, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def trace_context(trace_id: str, span_id: str = "", sampled: bool = True):
    """Run a block under a propagated trace context: RemoteStore writes
    issued inside it carry the X-Karmada-Trace header."""
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    stack.append((trace_id, span_id or new_span_id(), sampled))
    try:
        yield
    finally:
        stack.pop()


def format_trace_header(trace_id: str, span_id: str,
                        sampled: bool = True) -> str:
    return f"{trace_id};{span_id};s={'1' if sampled else '0'}"


def parse_trace_header(raw: str) -> Optional[tuple[str, str, bool]]:
    """-> (trace_id, span_id, sampled) or None on a malformed header (a
    bad header must never fail the carrying request)."""
    if not raw:
        return None
    parts = raw.split(";")
    if len(parts) < 2 or not parts[0] or not parts[1]:
        return None
    sampled = True
    for p in parts[2:]:
        if p.strip() == "s=0":
            sampled = False
    return parts[0], parts[1], sampled


# -- SLO attribution (the soak's report artifact; ROADMAP item 5a) ----------

def _pctl(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    i = min(len(s) - 1, max(0, int(round(q * len(s))) - 1))
    return s[i]


def slo_report(from_tracer: Optional[PlacementTracer] = None) -> dict:
    """Roll the retained traces into the per-stage p50/p99 attribution
    table — WHERE placement time goes, not just that it was slow. This is
    the SLO report artifact the fleet soak (ROADMAP item 5a) emits next to
    its BENCH_*.json lines."""
    t = from_tracer or tracer
    stage_durs: dict[str, list[float]] = {}
    placements: list[float] = []
    recs = t.retained()
    for rec in recs:
        if rec.placement_s is not None:
            placements.append(rec.placement_s)
        for s in rec.spans:
            stage_durs.setdefault(s.name, []).append(s.duration())
    return {
        "n_traces": len(recs),
        "head_sample": t.head_sample,
        "slow_threshold_s": t.slow_threshold_s,
        "tail_sampled": sum(1 for r in recs if r.retained == "slo"),
        "stages": {
            name: {
                "n": len(durs),
                "p50_ms": round(_pctl(durs, 0.50) * 1e3, 3),
                "p99_ms": round(_pctl(durs, 0.99) * 1e3, 3),
            }
            for name, durs in sorted(stage_durs.items())
        },
        "placement": {
            "n": len(placements),
            "p50_ms": round(_pctl(placements, 0.50) * 1e3, 3),
            "p99_ms": round(_pctl(placements, 0.99) * 1e3, 3),
        },
    }
