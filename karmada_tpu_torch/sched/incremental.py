"""Cross-round incremental scheduling state: per-binding decision replay
(the port's copy of sched/incremental.py).

The solve is row-independent — every binding's placement is a pure function
of (its own spec/status inputs, the fleet snapshot, its estimator answers).
So a binding whose inputs did not change since the round that last solved it
can skip the device solve entirely and replay the cached ScheduleDecision.
This is the per-row memo that turns a steady-state churn round (≤5% of
bindings dirty) into a solve over only the dirty rows.

`DecisionEntry` captures EVERYTHING `ArrayScheduler._schedule_once` reads
from a binding:

  - metadata.generation + placement / replica_requirements / resource
    compared by VALUE with an object-identity fast path (the in-process
    store contract — managed updates replace these objects and bump
    generation — makes `is` a sufficient check there, but the daemon path
    re-fetches bindings through the store's deepcopy / the wire codec, so
    out-of-process every fetch hands back NEW objects and an identity-only
    compare would defeat replay entirely; dataclass `==` restores it),
  - spec.replicas,
  - previous placements and graceful-eviction entries by VALUE (they are
    status-driven and mutate between rounds),
  - the Fresh-reschedule bit (rescheduleTriggeredAt vs lastScheduledTime),
  - status.scheduler_observed_affinity_name (the ordered-affinity retry
    loop's starting term),
  - a digest of the binding's registered-estimator answer row, and
  - the scheduler's fleet epoch (any cluster change bumps it, so a fleet
    delta re-solves every row — cheap insurance that replay can never serve
    a decision computed against a stale fleet).

The tie-break is seeded from the binding UID (models/batch.py tie_matrix),
so a replayed decision is bit-identical to what a cold re-solve would have
produced — the incremental-vs-cold parity suite pins this.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from ..models.batch import _reschedule_required


def extra_digest(row: Optional[np.ndarray]) -> Optional[bytes]:
    """Fixed-size digest of one binding's estimator-answer row (storing the
    raw row would pin O(B·C) host memory in the cache)."""
    if row is None:
        return None
    return hashlib.blake2b(np.ascontiguousarray(row).tobytes(),
                           digest_size=8).digest()


class DecisionEntry:
    __slots__ = (
        "epoch", "key", "generation", "replicas",
        "placement", "requirements", "resource",
        "prev", "evict", "fresh", "observed_affinity", "extra",
        "decision",
    )

    def __init__(self, rb, epoch: int, extra: Optional[bytes], decision):
        spec = rb.spec
        self.epoch = epoch
        self.key = rb.metadata.key()
        self.generation = rb.metadata.generation
        self.replicas = spec.replicas
        self.placement = spec.placement
        self.requirements = spec.replica_requirements
        self.resource = spec.resource
        self.prev = tuple(
            (tc.name, tc.replicas) for tc in (spec.clusters or ())
        )
        self.evict = tuple(
            t.from_cluster for t in (spec.graceful_eviction_tasks or ())
        )
        self.fresh = _reschedule_required(spec, rb.status)
        self.observed_affinity = rb.status.scheduler_observed_affinity_name
        self.extra = extra
        self.decision = decision

    @staticmethod
    def _same(a, b) -> bool:
        """Identity fast path (in-process callers hand back the very same
        policy objects), value compare otherwise (the daemon path re-fetches
        through the store's deepcopy / wire codec, where identity never
        holds but dataclass equality does)."""
        return a is b or a == b

    def matches(self, rb, epoch: int, extra: Optional[bytes]) -> bool:
        spec = rb.spec
        return (
            self.epoch == epoch
            and self.generation == rb.metadata.generation
            and self.replicas == spec.replicas
            and self.extra == extra
            and self.key == rb.metadata.key()
            and self.fresh == _reschedule_required(spec, rb.status)
            and self.observed_affinity
            == rb.status.scheduler_observed_affinity_name
            and self.prev
            == tuple((tc.name, tc.replicas) for tc in (spec.clusters or ()))
            and self.evict
            == tuple(t.from_cluster for t in (spec.graceful_eviction_tasks or ()))
            and self._same(self.placement, spec.placement)
            and self._same(self.requirements, spec.replica_requirements)
            and self._same(self.resource, spec.resource)
        )
