"""Event recording (reference: pkg/events/events.go — the reasons registry —
plus the EventRecorder usage in scheduler.go:964-1010 which records events on
both the binding and the referenced template).

The port's copy of the JAX package's `events.py`, unchanged in behaviour.

Events are plain store objects (kind "Event") so the query plane and CLI can
list them like any other resource; a bounded ring per recorder prevents
unbounded growth in long-lived processes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .api.meta import ObjectMeta, new_uid

# Reasons registry (pkg/events/events.go). Grouped as in the reference.
REASON_SCHEDULE_BINDING_SUCCEED = "ScheduleBindingSucceed"
REASON_SCHEDULE_BINDING_FAILED = "ScheduleBindingFailed"
REASON_DESCHEDULE_BINDING_SUCCEED = "DescheduleBindingSucceed"
REASON_DESCHEDULE_BINDING_FAILED = "DescheduleBindingFailed"
REASON_EVICT_WORKLOAD_FROM_CLUSTER_SUCCEED = "EvictWorkloadFromClusterSucceed"
REASON_EVICT_WORKLOAD_FROM_CLUSTER_FAILED = "EvictWorkloadFromClusterFailed"
REASON_SYNC_WORK_SUCCEED = "SyncWorkSucceed"
REASON_SYNC_WORK_FAILED = "SyncWorkFailed"
REASON_APPLY_POLICY_SUCCEED = "ApplyPolicySucceed"
REASON_APPLY_POLICY_FAILED = "ApplyPolicyFailed"
REASON_PREEMPT_POLICY_SUCCEED = "PreemptPolicySucceed"
REASON_PREEMPT_POLICY_FAILED = "PreemptPolicyFailed"
REASON_CLUSTER_NOT_READY = "ClusterNotReady"
REASON_CLUSTER_READY = "ClusterReady"
REASON_TAINT_CLUSTER_SUCCEED = "TaintClusterSucceed"
REASON_WORK_DISPATCHING = "WorkDispatching"

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"


@dataclass
class Event:
    kind: str = "Event"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_kind: str = ""
    involved_name: str = ""
    involved_namespace: str = ""
    type: str = TYPE_NORMAL
    reason: str = ""
    message: str = ""
    count: int = 1
    timestamp: float = 0.0

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


class EventRecorder:
    """Records events into the store, deduplicating consecutive identical
    (object, reason, message) tuples by bumping `count` (client-go recorder
    aggregation behavior)."""

    def __init__(self, store, clock=None, max_events: int = 2048):
        self.store = store
        self.clock = clock
        self.max_events = max_events
        self._order: list[str] = []  # store keys, oldest first

    def event(
        self,
        obj,
        etype: str,
        reason: str,
        message: str,
    ) -> Event:
        involved_kind = getattr(obj, "kind", "")
        meta: Optional[ObjectMeta] = getattr(obj, "metadata", None)
        involved_name = meta.name if meta else ""
        involved_ns = meta.namespace if meta else ""
        ts = self.clock.now() if self.clock else 0.0

        # dedup against the most recent event for the same object+reason
        for key in reversed(self._order):
            ns, _, name = key.partition("/")
            prev = self.store.try_get("Event", name, ns)
            if prev is None:
                continue
            if (
                prev.involved_kind == involved_kind
                and prev.involved_name == involved_name
                and prev.involved_namespace == involved_ns
            ):
                if prev.reason == reason and prev.message == message:
                    prev.count += 1
                    prev.timestamp = ts
                    self.store.update(prev)
                    return prev
                break

        ev = Event(
            metadata=ObjectMeta(name=new_uid("event"), namespace=involved_ns),
            involved_kind=involved_kind,
            involved_name=involved_name,
            involved_namespace=involved_ns,
            type=etype,
            reason=reason,
            message=message,
            timestamp=ts,
        )
        self.store.create(ev)
        self._order.append(ev.metadata.key())
        while len(self._order) > self.max_events:
            key = self._order.pop(0)
            ns, _, name = key.partition("/")
            self.store.delete("Event", name, ns)
        return ev

    def events_for(self, obj) -> list[Event]:
        meta = getattr(obj, "metadata", None)
        if meta is None:
            return []
        return [
            e
            for e in self.store.list("Event")
            if e.involved_kind == getattr(obj, "kind", "")
            and e.involved_name == meta.name
            and e.involved_namespace == meta.namespace
        ]
