"""Cluster API: member-cluster registration, taints, capacity summaries.

Behavior parity with the reference cluster API
(pkg/apis/cluster/v1alpha1/types.go): SyncMode push/pull, taints with
NoSchedule/NoExecute/PreferNoSchedule effects, Status.ResourceSummary
(allocatable/allocating/allocated) that powers the GeneralEstimator
(pkg/estimator/client/general.go:96-114), APIEnablements consumed by the
APIEnablement filter (plugins/apienablement/api_enablement.go:52), and the
grade-based cluster resource models (types.go:207-252).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .meta import Condition, ObjectMeta, Resources

KIND_CLUSTER = "Cluster"

# Sync modes (types.go SyncMode)
SYNC_MODE_PUSH = "Push"
SYNC_MODE_PULL = "Pull"

# Taint effects
EFFECT_NO_SCHEDULE = "NoSchedule"
EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
EFFECT_NO_EXECUTE = "NoExecute"

# Condition types
CLUSTER_CONDITION_READY = "Ready"

# Well-known taint keys the cluster controller applies on condition changes
# (reference: pkg/controllers/cluster/cluster_controller.go taint constants).
TAINT_CLUSTER_NOT_READY = "cluster.karmada.io/not-ready"
TAINT_CLUSTER_UNREACHABLE = "cluster.karmada.io/unreachable"


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = EFFECT_NO_SCHEDULE
    time_added: Optional[float] = None


@dataclass
class ResourceModelRange:
    name: str = ""  # resource name, e.g. "cpu"
    min: float = 0.0
    max: float = float("inf")


@dataclass
class ResourceModel:
    """One grade of the node-histogram resource model (types.go:207-252)."""

    grade: int = 0
    ranges: list[ResourceModelRange] = field(default_factory=list)


@dataclass
class AllocatableModeling:
    grade: int = 0
    count: int = 0


@dataclass
class ResourceSummary:
    """allocatable − allocated − allocating is the GeneralEstimator's input
    (pkg/estimator/client/general.go:96-114)."""

    allocatable: Resources = field(default_factory=dict)
    allocating: Resources = field(default_factory=dict)
    allocated: Resources = field(default_factory=dict)
    allocatable_modelings: list[AllocatableModeling] = field(default_factory=list)

    def available(self) -> Resources:
        out: Resources = {}
        for k, v in self.allocatable.items():
            out[k] = v - self.allocated.get(k, 0.0) - self.allocating.get(k, 0.0)
        return out


@dataclass
class NodeSummary:
    total_num: int = 0
    ready_num: int = 0


@dataclass
class APIEnablement:
    group_version: str = ""
    resources: list[str] = field(default_factory=list)  # Kind names


# the API surface every simulated member advertises (status collector's
# APIEnablements probe; consumed by the APIEnablement filter plugin)
DEFAULT_API_ENABLEMENTS = [
    APIEnablement(group_version="apps/v1", resources=["Deployment", "StatefulSet"]),
    APIEnablement(group_version="v1", resources=["ConfigMap", "Secret", "Service"]),
    APIEnablement(group_version="batch/v1", resources=["Job"]),
]


@dataclass
class ClusterSpec:
    sync_mode: str = SYNC_MODE_PUSH
    api_endpoint: str = ""
    provider: str = ""
    region: str = ""
    zone: str = ""
    zones: list[str] = field(default_factory=list)
    taints: list[Taint] = field(default_factory=list)
    resource_models: list[ResourceModel] = field(default_factory=list)


@dataclass
class ClusterStatus:
    kubernetes_version: str = ""
    api_enablements: list[APIEnablement] = field(default_factory=list)
    conditions: list[Condition] = field(default_factory=list)
    node_summary: Optional[NodeSummary] = None
    resource_summary: Optional[ResourceSummary] = None
    remedy_actions: list[str] = field(default_factory=list)


@dataclass
class Cluster:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ClusterSpec = field(default_factory=ClusterSpec)
    status: ClusterStatus = field(default_factory=ClusterStatus)
    kind: str = KIND_CLUSTER

    @property
    def name(self) -> str:
        return self.metadata.name


def cluster_ready(cluster: Cluster) -> bool:
    for c in cluster.status.conditions:
        if c.type == CLUSTER_CONDITION_READY:
            return c.status == "True"
    return False


def cluster_api_enabled(cluster: Cluster, api_version: str, kind: str) -> bool:
    """APIEnablement filter predicate (api_enablement.go:52).

    Empty enablement list counts as 'unknown' and the reference treats missing
    enablement as filter failure only when the list is populated and lacks the
    GVK; an empty status means the collector has not run, which the reference
    also rejects (helper.IsAPIEnabled returns false)."""
    for en in cluster.status.api_enablements:
        if en.group_version == api_version and kind in en.resources:
            return True
    return False
