"""Degraded-mode estimator staleness: per-cluster epochs + pure-array penalty.

When a member's circuit breaker is open, its estimator answers no fresh rows
— but the batched [B,C] solve must not stall, and discarding the column (the
-1 sentinel) would let the GeneralEstimator bound alone steer replicas onto a
possibly-dark cluster. Instead the last FRESH answers are kept per (cluster,
binding uid), a per-cluster staleness epoch counts the degraded sweeps since
that answer, and the stale values re-enter the matrix decayed:

    penalized = answer >> min(age, MAX_STALENESS_AGE)

i.e. the scheduler's trust in a stale answer halves every degraded sweep.
The transform is pure integer array math over the extra_avail matrix, so
everything that consumes extra_avail inherits it unchanged. The age cap
bounds re-solve churn: after MAX_STALENESS_AGE degraded sweeps the
penalized row is stable (usually 0).

This is the port's copy of faults/staleness.py. The penalty keeps its numpy
branch; on a torch tensor it runs `kernels.staleness_penalty`, the CUDA
kernel on a card and its plain version on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

MAX_STALENESS_AGE = 8  # penalized values are stable past this many sweeps

UNAUTHENTIC = -1  # the estimator discard sentinel (client.UNAUTHENTIC_REPLICA)


def apply_staleness_penalty(values, age: int):
    """Decay estimator answers by staleness age: halve per epoch, sentinel
    (-1) rows pass through untouched. Works on numpy arrays and int32
    torch tensors alike, so callers may apply it host-side on the
    assembled matrix or to a matrix already on the device."""
    shift = min(int(age), MAX_STALENESS_AGE)
    if shift <= 0:
        return values
    if isinstance(values, np.ndarray):
        return np.where(values >= 0, values >> shift, values)
    from .. import kernels

    return kernels.staleness_penalty(values, shift)


class StalenessTracker:
    """Last-known estimator answers per (cluster, binding uid) + per-cluster
    staleness epochs. Not thread-safe by itself — the estimator sweep that
    feeds it is already serialized per scheduler round.

    Snapshots store (uids tuple, i32 column) — the healthy-sweep hot path
    is one array copy per cluster, never a per-binding Python dict build
    (O(B·C) dict inserts per round would dwarf the array-only sweep).
    The uid→index map is built lazily, only on DEGRADED sweeps."""

    def __init__(self):
        # cluster -> (uids, i32[B] column); uids tuples are shared across
        # clusters of one sweep (the caller passes the same object)
        self._rows: dict[str, tuple] = {}
        self._age: dict[str, int] = {}
        self._index_cache: Optional[tuple] = None  # (uids, {uid: i})
        # chunked-round scope (a pipelined scheduler's chunk sweeps): a
        # round of N chunk-shard sweeps must look like ONE sweep here —
        # fresh snapshots MERGE across the round's chunks (a replace would
        # keep only the last chunk's bindings) and each cluster's staleness
        # epoch advances once per ROUND, not once per chunk (else trust
        # decays chunk-count times faster and later chunks see a different
        # penalty than earlier ones, breaking serial/pipelined parity)
        self._round_active = False
        self._round_fresh: set = set()
        self._round_aged: set = set()

    def begin_round(self) -> None:
        self._round_active = True
        self._round_fresh.clear()
        self._round_aged.clear()

    def end_round(self) -> None:
        self._round_active = False
        self._round_fresh.clear()
        self._round_aged.clear()

    def age(self, cluster: str) -> int:
        return self._age.get(cluster, 0)

    def record_fresh(self, cluster: str, uids, column) -> None:
        """A successful sweep for `cluster`: snapshot its column (replacing
        the previous snapshot — deleted bindings fall out with their sweep)
        and reset the staleness epoch. Inside a chunked round, later chunks
        EXTEND the round's snapshot instead of replacing it."""
        if self._round_active and cluster in self._round_fresh:
            old_uids, old_col = self._rows[cluster]
            self._rows[cluster] = (
                tuple(old_uids) + tuple(uids),
                np.concatenate(
                    [old_col, np.array(column, np.int32, copy=True)]
                ),
            )
        else:
            self._rows[cluster] = (
                uids, np.array(column, np.int32, copy=True)
            )
            if self._round_active:
                self._round_fresh.add(cluster)
        self._age[cluster] = 0

    def _index_of(self, uids) -> dict:
        cached = self._index_cache
        if cached is not None and cached[0] is uids:
            return cached[1]
        index = {uid: i for i, uid in enumerate(uids) if uid}
        self._index_cache = (uids, index)
        return index

    def fill_stale(self, cluster: str, uids: Sequence[Optional[str]]):
        """One degraded sweep for `cluster`: bump its staleness epoch and
        return the penalized column for the CURRENT binding order (i32[B];
        bindings the cache never saw answer the -1 sentinel). Returns None
        when nothing was ever cached (the column stays all-sentinel).
        Inside a chunked round the epoch bumps once per ROUND — every chunk
        of the round sees the same decay."""
        if not (self._round_active and cluster in self._round_aged):
            self._age[cluster] = self._age.get(cluster, 0) + 1
            if self._round_active:
                self._round_aged.add(cluster)
        cached = self._rows.get(cluster)
        if cached is None:
            return None
        old_uids, old_col = cached
        age = self._age[cluster]
        if old_uids is uids or tuple(old_uids) == tuple(uids):
            col = old_col.copy()  # common case: binding set unchanged
        else:
            index = self._index_of(old_uids)
            col = np.fromiter(
                (old_col[index[uid]] if uid and uid in index
                 else UNAUTHENTIC for uid in uids),
                np.int32, count=len(uids),
            )
        return apply_staleness_penalty(col, age)

    def forget(self, cluster: str) -> None:
        self._rows.pop(cluster, None)
        self._age.pop(cluster, None)
