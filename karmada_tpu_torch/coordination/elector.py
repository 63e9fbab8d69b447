"""Client-side leader election: acquire -> jittered renew loop -> callbacks
(the port's copy of coordination/elector.py).

The shape of client-go's leaderelection.LeaderElector (OnStartedLeading /
OnStoppedLeading, renew at ~duration/3, release-on-exit), over either
transport:

- `LocalLeaseClient(coordinator)` — in-process against a ControlPlane's
  LeaseCoordinator (the controller-manager self-election, tests);
- `RemoteStore` — over the serving API (/leases/acquire|renew|release);
  its lease methods match the same protocol.

Safety rules the loop enforces:
- a renew rejected with Conflict (deposed, expired, token mismatch) drops
  leadership IMMEDIATELY and falls back to candidate;
- a leader that cannot REACH the plane steps down once its last successful
  renew is older than the lease duration — it can no longer prove the
  lease is still its own (client-go's RenewDeadline);
- `stop()` releases the lease so a standby takes over without waiting out
  the TTL.

`step()` runs one acquire-or-renew attempt synchronously — daemons call it
once at startup so single-instance deployments lead immediately, and tests
drive elections deterministically with an injected clock.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional

from ..api.coordination import DEFAULT_LEASE_DURATION, LEADER_LEASE_NAMESPACE
from ..metrics import (
    leader_election_is_leader,
    leader_election_renew_duration,
    leader_election_transitions,
    timed,
)
from ..store.store import ConflictError, NotFoundError

log = logging.getLogger(__name__)


class LocalLeaseClient:
    """The elector-facing lease protocol over an in-process coordinator."""

    def __init__(self, coordinator):
        self._coordinator = coordinator

    def acquire_lease(self, name: str, identity: str,
                      duration: float = DEFAULT_LEASE_DURATION,
                      namespace: str = LEADER_LEASE_NAMESPACE):
        return self._coordinator.acquire(name, identity, duration,
                                         namespace=namespace)

    def renew_lease(self, name: str, identity: str, token: int,
                    namespace: str = LEADER_LEASE_NAMESPACE):
        return self._coordinator.renew(name, identity, token,
                                       namespace=namespace)

    def release_lease(self, name: str, identity: str, token: int,
                      namespace: str = LEADER_LEASE_NAMESPACE) -> None:
        self._coordinator.release(name, identity, token, namespace=namespace)


def default_identity() -> str:
    """hostname_pid — the reference uses hostname + uniquifier."""
    import os
    import socket

    return f"{socket.gethostname()}_{os.getpid()}"


class Elector:
    def __init__(
        self,
        client,
        name: str,
        identity: str,
        *,
        namespace: str = LEADER_LEASE_NAMESPACE,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        renew_interval: Optional[float] = None,
        retry_interval: Optional[float] = None,
        on_started_leading: Optional[Callable[[int], None]] = None,
        on_stopped_leading: Optional[Callable[[str], None]] = None,
        jitter: float = 0.2,
        monotonic: Callable[[], float] = time.monotonic,
    ):
        self.client = client
        self.name = name
        self.namespace = namespace
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_interval = renew_interval or lease_duration / 3.0
        self.retry_interval = retry_interval or self.renew_interval
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.jitter = jitter
        self._monotonic = monotonic
        self.is_leader = False
        self.token = 0  # 0 = no fence (not leading, or legacy plane)
        self._last_ok = 0.0  # monotonic stamp of the last proven-held lease
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._legacy_warned = False

    # -- one election round ------------------------------------------------

    def step(self) -> bool:
        """One synchronous acquire-or-renew attempt; returns is_leader."""
        try:
            if self.is_leader:
                with timed(leader_election_renew_duration, lease=self.name):
                    self.client.renew_lease(
                        self.name, self.identity, self.token,
                        namespace=self.namespace,
                    )
                self._last_ok = self._monotonic()
            else:
                lease, acquired = self.client.acquire_lease(
                    self.name, self.identity, self.lease_duration,
                    namespace=self.namespace,
                )
                if acquired:
                    self._last_ok = self._monotonic()
                    self._promote(lease.spec.fencing_token)
        except ConflictError as e:
            self._demote(f"lease lost: {e}")
        except NotFoundError:
            # a plane without /leases routes (pre-coordination daemon):
            # behave like the un-elected legacy topology — lead, unfenced
            if not self._legacy_warned:
                self._legacy_warned = True
                log.warning(
                    "elector %s: control plane has no lease API; assuming "
                    "single-instance leadership (no fencing)", self.name,
                )
            if not self.is_leader:
                self._promote(0)
            self._last_ok = self._monotonic()
        except Exception as e:  # noqa: BLE001 - transport errors
            # cannot prove the lease is still ours; step down once the TTL
            # has certainly elapsed since the last successful renew
            if self.is_leader and (
                self._monotonic() - self._last_ok > self.lease_duration
            ):
                self._demote(f"lease unverifiable past TTL: {e}")
            else:
                log.warning("elector %s: lease call failed: %s", self.name, e)
        return self.is_leader

    def _promote(self, token: int) -> None:
        self.is_leader = True
        self.token = token
        leader_election_is_leader.set(
            1.0, lease=self.name, identity=self.identity
        )
        leader_election_transitions.inc(lease=self.name)
        log.info("elector %s: %s acquired leadership (fencing token %d)",
                 self.name, self.identity, token)
        if self.on_started_leading is not None:
            self.on_started_leading(token)

    def _demote(self, reason: str) -> None:
        if not self.is_leader:
            return
        self.is_leader = False
        self.token = 0
        leader_election_is_leader.set(
            0.0, lease=self.name, identity=self.identity
        )
        log.warning("elector %s: %s stopped leading (%s)",
                    self.name, self.identity, reason)
        if self.on_stopped_leading is not None:
            self.on_stopped_leading(reason)

    # -- background loop ---------------------------------------------------

    def run(self) -> None:
        """Start the renew/acquire loop on a daemon thread."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=f"elector-{self.name}", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            interval = (
                self.renew_interval if self.step() else self.retry_interval
            )
            # jitter desynchronizes a fleet of candidates hammering acquire
            interval *= 1.0 + random.uniform(-self.jitter, self.jitter)
            self._stop.wait(max(interval, 0.05))

    def stop(self, release: bool = True) -> None:
        """Stop the loop; release the lease (if held) so a standby takes
        over immediately instead of waiting out the TTL."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        was_leader, token = self.is_leader, self.token
        self._demote("elector stopped")
        if was_leader and release and token:
            try:
                self.client.release_lease(
                    self.name, self.identity, token, namespace=self.namespace
                )
            except Exception as e:  # noqa: BLE001 - best-effort on exit
                log.warning("elector %s: release failed: %s", self.name, e)
