"""Feature gates.

The port's copy of the JAX package's `features.py`, unchanged in behaviour.

Parity with pkg/features/features.go:33-101: same gate names, same defaults
(Failover β off, GracefulEviction β on, PropagateDeps β on,
CustomizedClusterResourceModeling β on, PropagationPolicyPreemption α off,
MultiClusterService α off, ResourceQuotaEstimate α off,
StatefulFailoverInjection α off, PriorityBasedScheduling α off).

A module-level default gate set mirrors the reference's global
features.FeatureGate; components take an optional FeatureGates so tests can
flip gates without global state.
"""
from __future__ import annotations

FAILOVER = "Failover"
GRACEFUL_EVICTION = "GracefulEviction"
PROPAGATE_DEPS = "PropagateDeps"
CUSTOMIZED_CLUSTER_RESOURCE_MODELING = "CustomizedClusterResourceModeling"
# the operator-facing gate string matches the reference exactly
# (features.go:50: "PropagationPolicyPreemption")
POLICY_PREEMPTION = "PropagationPolicyPreemption"
MULTI_CLUSTER_SERVICE = "MultiClusterService"
RESOURCE_QUOTA_ESTIMATE = "ResourceQuotaEstimate"
STATEFUL_FAILOVER_INJECTION = "StatefulFailoverInjection"
PRIORITY_BASED_SCHEDULING = "PriorityBasedScheduling"

DEFAULTS: dict[str, bool] = {
    FAILOVER: False,
    GRACEFUL_EVICTION: True,
    PROPAGATE_DEPS: True,
    CUSTOMIZED_CLUSTER_RESOURCE_MODELING: True,
    POLICY_PREEMPTION: False,
    MULTI_CLUSTER_SERVICE: False,
    RESOURCE_QUOTA_ESTIMATE: False,
    STATEFUL_FAILOVER_INJECTION: False,
    PRIORITY_BASED_SCHEDULING: False,
}


class FeatureGates:
    def __init__(self, overrides: dict[str, bool] | None = None):
        self._state = dict(DEFAULTS)
        if overrides:
            self.set_from_map(overrides)

    def enabled(self, name: str) -> bool:
        try:
            return self._state[name]
        except KeyError:
            raise KeyError(f"unknown feature gate {name!r}") from None

    def set(self, name: str, value: bool) -> None:
        if name not in self._state:
            raise KeyError(f"unknown feature gate {name!r}")
        self._state[name] = value

    def set_from_map(self, overrides: dict[str, bool]) -> None:
        for k, v in overrides.items():
            self.set(k, v)


# The process-default gate set (reference: features.FeatureGate global).
default_gates = FeatureGates()
