"""Work API: ResourceBinding / ClusterResourceBinding / Work.

Behavior parity with pkg/apis/work/v1alpha2/binding_types.go (ResourceBinding:
target clusters, replica requirements, graceful eviction tasks :241-311,
reschedule trigger, suspension) and pkg/apis/work/v1alpha1/work_types.go (Work:
manifests + per-manifest reflected status).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .meta import ObjectMeta, Resources
from .policy import Placement, PURGE_MODE_GRACIOUSLY

KIND_RESOURCE_BINDING = "ResourceBinding"
KIND_CLUSTER_RESOURCE_BINDING = "ClusterResourceBinding"
KIND_WORK = "Work"

# Well-known labels/annotations (mirror pkg/apis/work/v1alpha2/well_known_*.go)
RESOURCE_BINDING_PERMANENT_ID_LABEL = "resourcebinding.karmada.io/permanent-id"
# Work -> owning-ResourceBinding back-references (stamped by the
# binding controller, read by status aggregation and the trace
# collector — one definition so the wire-visible names cannot drift)
WORK_BINDING_NAMESPACE_LABEL = "resourcebinding.karmada.io/namespace"
WORK_BINDING_NAME_LABEL = "resourcebinding.karmada.io/name"
POLICY_PLACEMENT_ANNOTATION = "policy.karmada.io/applied-placement"
WORK_NAMESPACE_PREFIX = "karmada-es-"

# Binding condition types (binding_types.go)
CONDITION_SCHEDULED = "Scheduled"
CONDITION_FULLY_APPLIED = "FullyApplied"

# Scheduled condition reasons (scheduler.go:913-961)
REASON_BINDING_SCHEDULED = "BindingScheduled"
REASON_SCHEDULE_FAILED = "BindingFailedScheduling"
REASON_UNSCHEDULABLE = "Unschedulable"
# workload-class scheduling (sched/preemption.py)
REASON_GANG_TIMEOUT = "GangTimeout"
REASON_GANG_UNSCHEDULABLE = "GangUnschedulable"

# graceful-eviction task reason/producer stamped by the preemption plane
EVICTION_REASON_PREEMPTED = "Preempted"
EVICTION_PRODUCER_PREEMPTION = "karmada-scheduler-preemption"

# template labels the detector lifts into the binding's gang/priority
# fields (they override the claiming policy's spec so several templates
# under one policy can form one gang)
GANG_NAME_LABEL = "gang.karmada.io/name"
GANG_SIZE_LABEL = "gang.karmada.io/size"
SCHEDULE_PRIORITY_LABEL = "scheduling.karmada.io/priority"

# Work condition types
WORK_CONDITION_APPLIED = "Applied"
WORK_CONDITION_AVAILABLE = "Available"
WORK_CONDITION_DISPATCHING = "Dispatching"


def work_namespace_for_cluster(cluster: str) -> str:
    """Per-cluster execution namespace (reference: names.GenerateExecutionSpaceName)."""
    return WORK_NAMESPACE_PREFIX + cluster


def cluster_of_work_namespace(ns: str) -> str:
    if not ns.startswith(WORK_NAMESPACE_PREFIX):
        raise ValueError(f"{ns} is not an execution namespace")
    return ns[len(WORK_NAMESPACE_PREFIX) :]


@dataclass
class ObjectReference:
    api_version: str = ""
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""
    resource_version: int = 0

    def key(self) -> str:
        return f"{self.api_version}/{self.kind}/{self.namespace}/{self.name}"


@dataclass
class NodeClaim:
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[Any] = field(default_factory=list)
    hard_node_affinity: Optional[Any] = None


@dataclass
class ReplicaRequirements:
    """binding_types.go ReplicaRequirements; resourceRequest feeds the
    estimators (pb/generated.proto ReplicaRequirements :91-110)."""

    node_claim: Optional[NodeClaim] = None
    resource_request: Resources = field(default_factory=dict)
    namespace: str = ""
    priority_class_name: str = ""


@dataclass
class TargetCluster:
    name: str = ""
    replicas: int = 0


@dataclass
class BindingSnapshot:
    """Requirements snapshot used by attached (dependency) bindings."""

    resource: ObjectReference = field(default_factory=ObjectReference)
    clusters: list[TargetCluster] = field(default_factory=list)


@dataclass
class GracefulEvictionTask:
    """binding_types.go:241-311."""

    from_cluster: str = ""
    replicas: Optional[int] = None
    reason: str = ""
    message: str = ""
    producer: str = ""
    grace_period_seconds: Optional[int] = None
    suppress_deletion: Optional[bool] = None
    creation_timestamp: Optional[float] = None  # None = not yet stamped
    purge_mode: str = PURGE_MODE_GRACIOUSLY
    preserved_label_state: dict[str, str] = field(default_factory=dict)
    cluster_before_failover: list[str] = field(default_factory=list)


@dataclass
class BindingSuspension:
    dispatching: bool = False
    scheduling: bool = False
    dispatching_on_clusters: list[str] = field(default_factory=list)


@dataclass
class BindingSpec:
    resource: ObjectReference = field(default_factory=ObjectReference)
    propagate_deps: bool = False
    replicas: int = 0
    replica_requirements: Optional[ReplicaRequirements] = None
    clusters: list[TargetCluster] = field(default_factory=list)
    placement: Optional[Placement] = None
    scheduler_name: str = ""
    schedule_priority: Optional[int] = None
    # scheduling preemption + gang membership (workload-class scheduling,
    # sched/preemption.py): plumbed from the claiming policy / template
    # labels by the detector, validated by the admission webhook
    preemption_policy: str = ""  # "" | Never | PreemptLowerPriority
    gang_name: str = ""
    gang_size: int = 0
    reschedule_triggered_at: Optional[float] = None
    graceful_eviction_tasks: list[GracefulEvictionTask] = field(default_factory=list)
    required_by: list[BindingSnapshot] = field(default_factory=list)
    suspension: Optional[BindingSuspension] = None
    conflict_resolution: str = ""
    failover: Optional[Any] = None  # policy.FailoverBehavior snapshot

    def target_cluster_names(self) -> list[str]:
        return [tc.name for tc in self.clusters]

    def assigned_replicas(self) -> int:
        return sum(tc.replicas for tc in self.clusters)

    def scheduling_suspended(self) -> bool:
        return self.suspension is not None and self.suspension.scheduling


@dataclass
class AggregatedStatusItem:
    cluster_name: str = ""
    status: Optional[dict] = None
    applied: bool = False
    applied_message: str = ""
    health: str = "Unknown"  # Healthy | Unhealthy | Unknown


@dataclass
class BindingStatus:
    scheduler_observed_generation: int = 0
    scheduler_observed_affinity_name: str = ""
    last_scheduled_time: Optional[float] = None
    conditions: list = field(default_factory=list)
    aggregated_status: list[AggregatedStatusItem] = field(default_factory=list)


@dataclass
class ResourceBinding:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: BindingSpec = field(default_factory=BindingSpec)
    status: BindingStatus = field(default_factory=BindingStatus)
    kind: str = KIND_RESOURCE_BINDING

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class ClusterResourceBinding:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: BindingSpec = field(default_factory=BindingSpec)
    status: BindingStatus = field(default_factory=BindingStatus)
    kind: str = KIND_CLUSTER_RESOURCE_BINDING

    @property
    def name(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------------------
# Work
# ---------------------------------------------------------------------------


@dataclass
class ManifestStatus:
    identifier: ObjectReference = field(default_factory=ObjectReference)
    status: Optional[dict] = None
    health: str = "Unknown"


@dataclass
class WorkSpec:
    workload_manifests: list[dict] = field(default_factory=list)
    suspend_dispatching: bool = False
    preserve_resources_on_deletion: bool = False


@dataclass
class WorkStatus:
    conditions: list = field(default_factory=list)
    manifest_statuses: list[ManifestStatus] = field(default_factory=list)


@dataclass
class Work:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: WorkSpec = field(default_factory=WorkSpec)
    status: WorkStatus = field(default_factory=WorkStatus)
    kind: str = KIND_WORK

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace
