"""Fault-tolerance plane (the port's copy of faults/): deterministic chaos
injection at the HTTP, estimator and apply boundaries (env-gated for
daemon processes), the unified retry/breaker policy, and degraded-mode
estimator staleness."""
from .plan import (
    BOUNDARY_APPLY,
    BOUNDARY_GRPC,
    BOUNDARY_HTTP,
    ENV_FAULT_PLAN,
    FaultAction,
    FaultInjector,
    FaultPlan,
    FaultRule,
    InjectedFault,
    PROCESS_KINDS,
    ProcessEvent,
    ProcessFaultRule,
    active,
    check,
    install,
    install_from_env,
    reset,
)
from .policy import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    Backoff,
    BreakerRegistry,
    CircuitBreaker,
    RetryPolicy,
)
from .staleness import (
    MAX_STALENESS_AGE,
    StalenessTracker,
    apply_staleness_penalty,
)

__all__ = [
    "BOUNDARY_APPLY", "BOUNDARY_GRPC", "BOUNDARY_HTTP", "ENV_FAULT_PLAN",
    "FaultAction", "FaultInjector", "FaultPlan", "FaultRule", "InjectedFault",
    "PROCESS_KINDS", "ProcessEvent", "ProcessFaultRule",
    "active", "check", "install", "install_from_env", "reset",
    "CLOSED", "HALF_OPEN", "OPEN",
    "Backoff", "BreakerRegistry", "CircuitBreaker", "RetryPolicy",
    "MAX_STALENESS_AGE", "StalenessTracker", "apply_staleness_penalty",
]
