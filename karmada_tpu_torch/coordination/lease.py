"""Lease-based coordination: CAS acquire/renew and write fencing (the
port's copy of coordination/lease.py).

`LeaseCoordinator` is the control-plane half of leader election — the role
etcd's compare-and-swap plays for client-go's resourcelock. All mutations
go through the store's optimistic-concurrency path (`check_rv=True` +
retry), so two daemons racing an acquire resolve to exactly one holder no
matter how their requests interleave; the store's RLock makes each
individual CAS atomic.

Fencing (the Chubby/Kafka "sequencer" pattern): every acquisition mints a
strictly larger `fencing_token` for that lease name. A leader stamps its
mutating requests with its token (`X-Karmada-Fencing` on the wire); once a
standby has taken over, the token advanced, and `check_fence` rejects the
deposed leader's in-flight writes with a Conflict (HTTP 409) — a paused
process resuming after its TTL cannot double-patch placements.

Release clears the holder but keeps the token counter and the lease object
itself: deleting the lease would reset the counter and break monotonicity,
which is the entire safety argument.
"""
from __future__ import annotations

from typing import Optional

from ..api.coordination import (
    DEFAULT_LEASE_DURATION,
    KIND_LEADER_LEASE,
    LEADER_LEASE_NAMESPACE,
    LeaderLease,
    LeaderLeaseSpec,
)
from ..api.meta import ObjectMeta
from ..store.store import ConflictError

_CAS_ATTEMPTS = 16


class StaleLeaseError(ConflictError):
    """Renew/release by a caller that no longer holds the lease."""


class FencingError(ConflictError):
    """A mutating request carried a fencing token older than the lease's
    current one — the caller was deposed; the write must not land."""


class LeaseCoordinator:
    def __init__(self, store, clock=None):
        self.store = store
        self._clock = clock

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock.now()
        import time

        return time.time()

    # -- acquire / renew / release ----------------------------------------

    def acquire(
        self,
        name: str,
        identity: str,
        duration: float = DEFAULT_LEASE_DURATION,
        namespace: str = LEADER_LEASE_NAMESPACE,
    ) -> tuple[LeaderLease, bool]:
        """Try to take (or keep) leadership of `name` as `identity`.

        Returns (lease, acquired). Semantics per attempt:
        - no lease yet            -> create it held by identity (token 1)
        - held by identity, live  -> renew in place (token unchanged)
        - expired or released     -> take over; token += 1; transitions += 1
                                     when the holder actually changed. The
                                     SAME identity re-acquiring its own
                                     expired lease also mints a fresh token:
                                     its old token spent time beyond the TTL
                                     and must fence.
        - held by another, live   -> (current lease, False)
        """
        if not identity:
            raise ValueError("elector identity must be non-empty")
        for _ in range(_CAS_ATTEMPTS):
            lease = self.store.try_get(KIND_LEADER_LEASE, name, namespace)
            now = self._now()
            if lease is None:
                fresh = LeaderLease(
                    metadata=ObjectMeta(name=name, namespace=namespace),
                    spec=LeaderLeaseSpec(
                        holder_identity=identity,
                        lease_duration_seconds=duration,
                        acquire_time=now,
                        renew_time=now,
                        fencing_token=1,
                    ),
                )
                try:
                    return self.store.create(fresh), True
                except ConflictError:
                    continue  # lost the create race: re-read and re-judge
            spec = lease.spec
            expired = lease.expired(now)
            if spec.holder_identity == identity and not expired:
                spec.renew_time = now
                spec.lease_duration_seconds = duration
            elif expired:
                if spec.holder_identity and spec.holder_identity != identity:
                    spec.lease_transitions += 1
                spec.holder_identity = identity
                spec.lease_duration_seconds = duration
                spec.acquire_time = now
                spec.renew_time = now
                spec.fencing_token += 1
            else:
                return lease, False
            try:
                return self.store.update(lease, check_rv=True), True
            except ConflictError:
                continue  # concurrent CAS won: re-read and re-judge
        raise ConflictError(f"lease {namespace}/{name}: CAS contention")

    def renew(
        self,
        name: str,
        identity: str,
        token: int,
        namespace: str = LEADER_LEASE_NAMESPACE,
    ) -> LeaderLease:
        """Extend a held lease. Strict: the caller must still be the holder
        with the CURRENT token, and the lease must not have expired — a
        leader paused past its TTL is forced back through acquire() (which
        mints a fresh token) instead of silently resuming on its old one."""
        for _ in range(_CAS_ATTEMPTS):
            lease = self.store.try_get(KIND_LEADER_LEASE, name, namespace)
            if lease is None:
                raise StaleLeaseError(
                    f"lease {namespace}/{name}: gone (renew by {identity!r})"
                )
            spec = lease.spec
            if spec.holder_identity != identity or spec.fencing_token != token:
                raise StaleLeaseError(
                    f"lease {namespace}/{name}: held by "
                    f"{spec.holder_identity!r} (token {spec.fencing_token}), "
                    f"not {identity!r} (token {token})"
                )
            now = self._now()
            if lease.expired(now):
                raise StaleLeaseError(
                    f"lease {namespace}/{name}: expired "
                    f"{now - spec.renew_time:.1f}s ago; re-acquire required"
                )
            spec.renew_time = now
            try:
                return self.store.update(lease, check_rv=True)
            except ConflictError:
                continue
        raise ConflictError(f"lease {namespace}/{name}: CAS contention")

    def release(
        self,
        name: str,
        identity: str,
        token: int,
        namespace: str = LEADER_LEASE_NAMESPACE,
    ) -> None:
        """Voluntary step-down. Clears the holder (a standby acquires
        immediately instead of waiting out the TTL) but keeps the lease and
        its token counter. A deposed caller's release is a no-op — it must
        not clobber the new leader."""
        for _ in range(_CAS_ATTEMPTS):
            lease = self.store.try_get(KIND_LEADER_LEASE, name, namespace)
            if lease is None:
                return
            spec = lease.spec
            if spec.holder_identity != identity or spec.fencing_token != token:
                return
            spec.holder_identity = ""
            try:
                self.store.update(lease, check_rv=True)
                return
            except ConflictError:
                continue

    # -- fencing -----------------------------------------------------------

    def check_fence(
        self,
        name: str,
        token: int,
        namespace: str = LEADER_LEASE_NAMESPACE,
    ) -> None:
        """Raise FencingError unless `token` is the lease's current fencing
        token. Called by the apiserver on mutating requests that carry
        X-Karmada-Fencing, BEFORE the store operation runs."""
        lease = self.store.try_get(KIND_LEADER_LEASE, name, namespace)
        if lease is None:
            raise FencingError(
                f"fencing: lease {namespace}/{name} does not exist "
                f"(write carried token {token})"
            )
        current = lease.spec.fencing_token
        if token != current:
            raise FencingError(
                f"fencing: stale token {token} for lease {namespace}/{name} "
                f"(current {current}, holder {lease.spec.holder_identity!r})"
            )

    # -- status ------------------------------------------------------------

    def elections(self) -> list[LeaderLease]:
        """Every election lease, all namespaces (the `karmadactl elections`
        view)."""
        return self.store.list(KIND_LEADER_LEASE)


def parse_fence_header(value: str) -> Optional[tuple[str, str, int]]:
    """Parse "namespace/name:token" (namespace optional) into
    (namespace, name, token); None for an empty header, ValueError for a
    malformed one."""
    value = value.strip()
    if not value:
        return None
    ref, sep, tok = value.rpartition(":")
    if not sep or not ref:
        raise ValueError(f"malformed fencing header {value!r}")
    ns, _, name = ref.rpartition("/")
    return ns or LEADER_LEASE_NAMESPACE, name, int(tok)


def format_fence_header(name: str, token: int,
                        namespace: str = LEADER_LEASE_NAMESPACE) -> str:
    return f"{namespace}/{name}:{token}"
