"""coordination.k8s.io-shaped leader-election Lease (the port's copy of
api/coordination.py; the same fields in the same order, so both packages
encode it to the same wire bytes).

The reference runs every binary behind client-go leader election over a
`coordination.k8s.io/Lease` (cmd/scheduler/app/scheduler.go:33-34,188,
cmd/controller-manager/app/controllermanager.go:154-155). `LeaderLease` is
that resource for the TPU build's daemon topology, distinct from the
cluster-heartbeat `Lease` of the pull agent: one per elected ROLE
(karmada-scheduler, karmada-descheduler, karmada-agent-<cluster>,
karmada-controller-manager), not per member cluster.

Beyond the k8s shape it carries a monotonic **fencing token**, minted on
every leadership acquisition (not on renewals): a write stamped with an
older token than the lease's current one comes from a deposed leader and
must be rejected (coordination/lease.py `check_fence`). Tokens only ever
increase for a given lease name — release clears the holder but keeps the
counter, so monotonicity survives clean handovers and restarts (the lease
rides the store's WAL like every other object).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta

KIND_LEADER_LEASE = "LeaderLease"

# the reference deploys its election leases in the karmada-system namespace
LEADER_LEASE_NAMESPACE = "karmada-system"

# client-go defaults are 15s/10s/2s (LeaseDuration/RenewDeadline/RetryPeriod);
# we keep the same envelope with renew at duration/3
DEFAULT_LEASE_DURATION = 15.0

# well-known lease names for the daemon roles
LEASE_SCHEDULER = "karmada-scheduler"
LEASE_DESCHEDULER = "karmada-descheduler"
LEASE_CONTROLLER_MANAGER = "karmada-controller-manager"


def agent_lease_name(cluster: str) -> str:
    """Election lease for the pull agent serving `cluster` — exactly one
    agent process may heartbeat/apply for a given member identity."""
    return f"karmada-agent-{cluster}"


@dataclass
class LeaderLeaseSpec:
    holder_identity: str = ""  # "" = released / never held
    lease_duration_seconds: float = DEFAULT_LEASE_DURATION
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_transitions: int = 0  # holder changes (k8s leaseTransitions)
    fencing_token: int = 0  # monotonic; bumped on every acquisition


@dataclass
class LeaderLease:
    kind: str = KIND_LEADER_LEASE
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaderLeaseSpec = field(default_factory=LeaderLeaseSpec)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def expired(self, now: float) -> bool:
        return (
            not self.spec.holder_identity
            or now - self.spec.renew_time > self.spec.lease_duration_seconds
        )
