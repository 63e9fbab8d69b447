"""Cross-shard estimator fairness: a shared per-cluster concurrency budget
(the port's copy of the reference's sched/shards/fairness.py).

With N shard leaders fanning estimator calls out independently, one hot
shard's sweep can occupy every connection a member cluster's estimator
will serve and starve the other shards' sweeps — the per-shard pools
(`MemberEstimators._pool_for`) bound each SHARD's concurrency, not the
cluster's aggregate. `ClusterFairnessBudget` is the aggregate bound: one
process-wide BoundedSemaphore per member cluster, acquired around each
per-cluster estimator leg (`MemberEstimators._guarded` consults the hook
when installed). Shards contend on the semaphore FIFO-ish (threading
semaphores wake waiters roughly in arrival order), so a burst from one
shard queues behind, not instead of, its siblings' in-flight legs.

The budget is deliberately per-process: in the one-process-per-shard
deployment each process talks to the member's estimator over its own
connections and the member's own server enforces its aggregate; the
shared-process ShardPlane (bench, tests, single-box deployments) is where
unfair interleaving actually manifests and where this budget binds.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

DEFAULT_PER_CLUSTER = 4


class ClusterFairnessBudget:
    """`limit` concurrent estimator legs per member cluster, fleet-wide
    across every shard that shares the budget object."""

    def __init__(self, limit: int = DEFAULT_PER_CLUSTER) -> None:
        self.limit = max(1, int(limit))
        self._lock = threading.Lock()
        self._sems: dict[str, threading.BoundedSemaphore] = {}
        # contention visibility: legs that had to WAIT on the budget
        self.waits = 0

    def _sem(self, cluster: str) -> threading.BoundedSemaphore:
        with self._lock:
            sem = self._sems.get(cluster)
            if sem is None:
                sem = self._sems[cluster] = threading.BoundedSemaphore(
                    self.limit
                )
            return sem

    @contextmanager
    def leg(self, cluster: str):
        """Hold one of `cluster`'s estimator-call slots for the duration
        of a per-cluster estimator leg."""
        sem = self._sem(cluster)
        if not sem.acquire(blocking=False):
            with self._lock:
                self.waits += 1
            sem.acquire()
        try:
            yield
        finally:
            sem.release()

    def forget(self, cluster: str) -> None:
        """Drop a retired member's semaphore so the map stays bounded."""
        with self._lock:
            self._sems.pop(cluster, None)
