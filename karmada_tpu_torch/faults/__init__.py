"""Fault-tolerance pieces of the estimator path (the port's copy of
faults/): deterministic fault injection at the estimator boundary, the
per-member circuit breakers, and degraded-mode estimator staleness."""
from .plan import (
    BOUNDARY_GRPC,
    FaultAction,
    FaultInjector,
    FaultPlan,
    FaultRule,
    InjectedFault,
    active,
    check,
    install,
    reset,
)
from .policy import CLOSED, HALF_OPEN, OPEN, BreakerRegistry, CircuitBreaker
from .staleness import MAX_STALENESS_AGE, StalenessTracker, apply_staleness_penalty

__all__ = [
    "BOUNDARY_GRPC",
    "FaultAction", "FaultInjector", "FaultPlan", "FaultRule", "InjectedFault",
    "active", "check", "install", "reset",
    "CLOSED", "HALF_OPEN", "OPEN", "BreakerRegistry", "CircuitBreaker",
    "MAX_STALENESS_AGE", "StalenessTracker", "apply_staleness_penalty",
]
