"""Coordination plane (the port's copy of coordination/): leader election
and write fencing.

Every role that mutates shared state elects exactly one active instance
per identity over a `LeaderLease` (api/coordination.py) and stamps its
writes with the lease's fencing token. The data-dir lock (`flock.py`)
serves the control-plane daemon, which the port does not have yet.
"""
from ..api.coordination import (  # noqa: F401 - re-exports
    DEFAULT_LEASE_DURATION,
    KIND_LEADER_LEASE,
    LEADER_LEASE_NAMESPACE,
    LEASE_CONTROLLER_MANAGER,
    LEASE_DESCHEDULER,
    LEASE_SCHEDULER,
    LeaderLease,
    LeaderLeaseSpec,
    agent_lease_name,
)
from .elector import Elector, LocalLeaseClient, default_identity  # noqa: F401
from .lease import (  # noqa: F401
    FencingError,
    LeaseCoordinator,
    StaleLeaseError,
    format_fence_header,
    parse_fence_header,
)
