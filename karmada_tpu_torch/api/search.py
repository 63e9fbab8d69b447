"""Quota API: FederatedResourceQuota (the port's copy of the quota types
of the JAX package's api/search.py; reference:
pkg/apis/policy/v1alpha1/federatedresourcequota_types.go): federation-wide
hard limits with per-cluster static assignments, the object the quota
admission preflight (simulation/preflight.py) reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta

KIND_FEDERATED_RESOURCE_QUOTA = "FederatedResourceQuota"


@dataclass
class StaticClusterAssignment:
    cluster_name: str = ""
    hard: dict[str, float] = field(default_factory=dict)


@dataclass
class FederatedResourceQuotaSpec:
    overall: dict[str, float] = field(default_factory=dict)
    static_assignments: list[StaticClusterAssignment] = field(default_factory=list)


@dataclass
class ClusterQuotaStatus:
    cluster_name: str = ""
    hard: dict[str, float] = field(default_factory=dict)
    used: dict[str, float] = field(default_factory=dict)


@dataclass
class FederatedResourceQuotaStatus:
    overall: dict[str, float] = field(default_factory=dict)
    overall_used: dict[str, float] = field(default_factory=dict)
    aggregated_status: list[ClusterQuotaStatus] = field(default_factory=list)


@dataclass
class FederatedResourceQuota:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: FederatedResourceQuotaSpec = field(default_factory=FederatedResourceQuotaSpec)
    status: FederatedResourceQuotaStatus = field(default_factory=FederatedResourceQuotaStatus)
    kind: str = KIND_FEDERATED_RESOURCE_QUOTA

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace
