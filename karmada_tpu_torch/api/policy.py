"""Policy API: PropagationPolicy / ClusterPropagationPolicy, Placement,
OverridePolicy.

Behavior parity with pkg/apis/policy/v1alpha1/propagation_types.go and
override_types.go: resource selectors (priority name>label), placement with
cluster affinity (+ordered affinity terms), tolerations, spread constraints
(min/max groups over provider/region/zone/cluster, types.go:466-504), replica
scheduling (Duplicated | Divided × Weighted/Aggregated × static/dynamic
weights, :543-631), failover behavior (:304-408), and override rules.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .meta import LabelSelector, ObjectMeta

KIND_PROPAGATION_POLICY = "PropagationPolicy"
KIND_CLUSTER_PROPAGATION_POLICY = "ClusterPropagationPolicy"
KIND_OVERRIDE_POLICY = "OverridePolicy"
KIND_CLUSTER_OVERRIDE_POLICY = "ClusterOverridePolicy"

# ReplicaSchedulingType (propagation_types.go:543-550)
REPLICA_SCHEDULING_DUPLICATED = "Duplicated"
REPLICA_SCHEDULING_DIVIDED = "Divided"

# ReplicaDivisionPreference
DIVISION_PREFERENCE_AGGREGATED = "Aggregated"
DIVISION_PREFERENCE_WEIGHTED = "Weighted"

# DynamicWeightFactor (propagation_types.go:616-631)
DYNAMIC_WEIGHT_AVAILABLE_REPLICAS = "AvailableReplicas"

# SpreadFieldValue (propagation_types.go:466-504)
SPREAD_BY_FIELD_CLUSTER = "cluster"
SPREAD_BY_FIELD_REGION = "region"
SPREAD_BY_FIELD_ZONE = "zone"
SPREAD_BY_FIELD_PROVIDER = "provider"

# Failover PurgeMode
PURGE_MODE_IMMEDIATELY = "Immediately"
PURGE_MODE_GRACIOUSLY = "Graciously"
PURGE_MODE_NEVER = "Never"

# ConflictResolution
CONFLICT_OVERWRITE = "Overwrite"
CONFLICT_ABORT = "Abort"

DEFAULT_SCHEDULER_NAME = "default-scheduler"

# Scheduling preemption policy (kube PreemptionPolicy vocabulary, distinct
# from spec.preemption which governs POLICY-claim preemption in the
# detector): "" defaults to Never; PreemptLowerPriority lets an
# unschedulable binding evict placed replicas of strictly-lower-priority
# bindings (sched/preemption.py).
PREEMPT_NEVER = "Never"
PREEMPT_LOWER_PRIORITY = "PreemptLowerPriority"
VALID_SCHEDULER_PREEMPTION = ("", PREEMPT_NEVER, PREEMPT_LOWER_PRIORITY)

# schedule_priority bounds enforced at admission (webhook/handlers.py) —
# mirrors kube's PriorityClass value range so priorities stay well inside
# i32 for the tiered device solve
SCHEDULE_PRIORITY_BOUND = 1_000_000_000


@dataclass
class ResourceSelector:
    """propagation_types.go ResourceSelector: apiVersion+kind required,
    name > labelSelector precedence is enforced by the detector."""

    api_version: str = ""
    kind: str = ""
    namespace: str = ""
    name: str = ""
    label_selector: Optional[LabelSelector] = None


@dataclass
class ClusterAffinity:
    label_selector: Optional[LabelSelector] = None
    field_selector: Optional[FieldSelector] = None
    cluster_names: list[str] = field(default_factory=list)
    exclude: list[str] = field(default_factory=list)

    def is_empty(self) -> bool:
        return (
            self.label_selector is None
            and self.field_selector is None
            and not self.cluster_names
            and not self.exclude
        )


@dataclass
class ClusterAffinityTerm:
    """Ordered failover terms (propagation_types.go OrderedClusterAffinity);
    the scheduler retries terms in order
    (pkg/scheduler/scheduler.go:562-625)."""

    affinity_name: str = ""
    affinity: ClusterAffinity = field(default_factory=ClusterAffinity)


@dataclass
class FieldSelector:
    """Only provider/region/zone fields are addressable (cluster API)."""

    match_expressions: list[FieldSelectorRequirement] = field(default_factory=list)


@dataclass
class FieldSelectorRequirement:
    key: str = ""  # provider | region | zone
    operator: str = "In"  # In | NotIn
    values: list[str] = field(default_factory=list)


@dataclass
class Toleration:
    """Mirrors corev1.Toleration semantics as used by the TaintToleration
    filter (plugins/tainttoleration/taint_toleration.go:52)."""

    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            # empty key with Exists tolerates everything
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class SpreadConstraint:
    spread_by_field: str = ""  # cluster|region|zone|provider
    spread_by_label: str = ""
    min_groups: int = 1
    max_groups: int = 0  # 0 = unconstrained


@dataclass
class StaticClusterWeight:
    target_cluster: ClusterAffinity = field(default_factory=ClusterAffinity)
    weight: int = 1


@dataclass
class ClusterPreferences:
    static_weight_list: list[StaticClusterWeight] = field(default_factory=list)
    dynamic_weight: str = ""  # "" | AvailableReplicas


@dataclass
class ReplicaSchedulingStrategy:
    replica_scheduling_type: str = REPLICA_SCHEDULING_DUPLICATED
    replica_division_preference: str = ""  # Aggregated | Weighted
    weight_preference: Optional[ClusterPreferences] = None


@dataclass
class Placement:
    cluster_affinity: Optional[ClusterAffinity] = None
    cluster_affinities: list[ClusterAffinityTerm] = field(default_factory=list)
    cluster_tolerations: list[Toleration] = field(default_factory=list)
    spread_constraints: list[SpreadConstraint] = field(default_factory=list)
    replica_scheduling: Optional[ReplicaSchedulingStrategy] = None

    def replica_scheduling_type(self) -> str:
        if self.replica_scheduling is None:
            return REPLICA_SCHEDULING_DUPLICATED
        return self.replica_scheduling.replica_scheduling_type


@dataclass
class ApplicationFailoverBehavior:
    decision_conditions_toleration_seconds: int = 300
    purge_mode: str = PURGE_MODE_GRACIOUSLY
    grace_period_seconds: Optional[int] = None
    state_preservation: Optional[StatePreservation] = None


@dataclass
class StatePreservation:
    rules: list[StatePreservationRule] = field(default_factory=list)


@dataclass
class StatePreservationRule:
    alias_label_name: str = ""
    json_path: str = ""


@dataclass
class FailoverBehavior:
    application: Optional[ApplicationFailoverBehavior] = None


@dataclass
class Suspension:
    dispatching: bool = False
    scheduling: bool = False


@dataclass
class PropagationSpec:
    resource_selectors: list[ResourceSelector] = field(default_factory=list)
    placement: Placement = field(default_factory=Placement)
    propagate_deps: bool = False
    priority: int = 0
    scheduler_priority: Optional[int] = None
    preemption: str = "Never"  # Never | Always (policy-claim preemption)
    # scheduling preemption: may this policy's bindings evict placed
    # replicas of strictly-lower-priority bindings when they place short?
    scheduler_preemption: str = ""  # "" | Never | PreemptLowerPriority
    # gang scheduling: bindings sharing gang_name co-admit as an
    # all-or-nothing cohort of gang_size members (sched/preemption.py);
    # template labels gang.karmada.io/{name,size} override per workload
    gang_name: str = ""
    gang_size: int = 0
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    failover: Optional[FailoverBehavior] = None
    suspension: Optional[Suspension] = None
    conflict_resolution: str = CONFLICT_ABORT
    activation_preference: str = ""  # "" | Lazy


@dataclass
class PropagationPolicy:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PropagationSpec = field(default_factory=PropagationSpec)
    kind: str = KIND_PROPAGATION_POLICY

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class ClusterPropagationPolicy:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PropagationSpec = field(default_factory=PropagationSpec)
    kind: str = KIND_CLUSTER_PROPAGATION_POLICY

    @property
    def name(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------------------
# Override policy (pkg/apis/policy/v1alpha1/override_types.go)
# ---------------------------------------------------------------------------


@dataclass
class ImageOverrider:
    component: str = ""  # Registry | Repository | Tag
    operator: str = "replace"  # add | remove | replace
    value: str = ""
    predicate_path: Optional[str] = None


@dataclass
class CommandArgsOverrider:
    container_name: str = ""
    operator: str = "add"  # add | remove
    value: list[str] = field(default_factory=list)


@dataclass
class LabelAnnotationOverrider:
    operator: str = "add"  # add | remove | replace
    value: dict[str, str] = field(default_factory=dict)


@dataclass
class PlaintextOverrider:
    path: str = ""  # JSON pointer
    operator: str = "add"  # add | remove | replace
    value: Any = None


@dataclass
class FieldPatchOperation:
    """JSONPatchOperation / YAMLPatchOperation (override_types.go:288-325):
    one add/remove/replace at an RFC 6901 subPath inside the embedded
    document."""

    sub_path: str = ""
    operator: str = "add"  # add | remove | replace
    value: Any = None


@dataclass
class FieldOverrider:
    """Modify a STRING field holding an embedded JSON or YAML document
    (e.g. a ConfigMap data value) with patch operations
    (override_types.go:266-286). Either `json` or `yaml` per instance."""

    field_path: str = ""  # RFC 6901 pointer to the string field
    json: list[FieldPatchOperation] = field(default_factory=list)
    yaml: list[FieldPatchOperation] = field(default_factory=list)


@dataclass
class Overriders:
    plaintext: list[PlaintextOverrider] = field(default_factory=list)
    image_overrider: list[ImageOverrider] = field(default_factory=list)
    command_overrider: list[CommandArgsOverrider] = field(default_factory=list)
    args_overrider: list[CommandArgsOverrider] = field(default_factory=list)
    labels_overrider: list[LabelAnnotationOverrider] = field(default_factory=list)
    annotations_overrider: list[LabelAnnotationOverrider] = field(default_factory=list)
    field_overrider: list[FieldOverrider] = field(default_factory=list)


@dataclass
class RuleWithCluster:
    target_cluster: Optional[ClusterAffinity] = None
    overriders: Overriders = field(default_factory=Overriders)


@dataclass
class OverrideSpec:
    resource_selectors: list[ResourceSelector] = field(default_factory=list)
    override_rules: list[RuleWithCluster] = field(default_factory=list)


@dataclass
class OverridePolicy:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: OverrideSpec = field(default_factory=OverrideSpec)
    kind: str = KIND_OVERRIDE_POLICY

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class ClusterOverridePolicy:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: OverrideSpec = field(default_factory=OverrideSpec)
    kind: str = KIND_CLUSTER_OVERRIDE_POLICY

    @property
    def name(self) -> str:
        return self.metadata.name
