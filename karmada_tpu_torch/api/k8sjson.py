"""Parsers for the reference's own JSON wire shapes → our typed API.

A stock Go karmada component marshals its CRD structs with k8s JSON tags
(camelCase, quantity strings, RFC3339 times). The scheduler sidecar shim
accepts exactly those bytes, so the Go side needs no translation layer:
`json.Marshal(spec)` of a `workv1alpha2.ResourceBindingSpec` (
binding_types.go) or a `clusterv1alpha1.Cluster` (types.go) is a valid
request body. Unknown fields are ignored (k8s clients are forward-
compatible the same way).

A copy of karmada_tpu/api/k8sjson.py over the port's API dataclasses,
with its own copy of the quantity parser.
"""
from __future__ import annotations

from datetime import datetime
from typing import Any, Optional

from . import policy as pol
from .cluster import (
    APIEnablement,
    Cluster,
    ClusterSpec,
    ClusterStatus,
    NodeSummary,
    ResourceSummary,
    Taint,
)
from .meta import (
    Condition,
    LabelSelector,
    LabelSelectorRequirement,
    ObjectMeta,
)
from .work import (
    BindingSpec,
    NodeClaim,
    ObjectReference,
    ReplicaRequirements,
    TargetCluster,
)


def _parse_quantity(v: Any) -> float:
    """Kubernetes quantity strings → canonical floats (cpu cores / bytes)
    (a copy of the reference's interpreter/interpreter.py:61)."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    try:
        return float(s)
    except ValueError:
        pass
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    suffixes = {
        "Ki": 1024.0,
        "Mi": 1024.0**2,
        "Gi": 1024.0**3,
        "Ti": 1024.0**4,
        "Pi": 1024.0**5,
        "k": 1e3,
        "M": 1e6,
        "G": 1e9,
        "T": 1e12,
    }
    for suf, mult in suffixes.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    raise ValueError(f"unparseable quantity {v!r}")


def rfc3339_to_epoch(v: Any) -> Optional[float]:
    if v in (None, ""):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    # metav1.Time marshals as RFC3339 (Z or numeric offset, optional
    # fractional seconds) — exactly what fromisoformat accepts
    try:
        return datetime.fromisoformat(str(v).replace("Z", "+00:00")).timestamp()
    except ValueError:
        return None


def resources_from_json(d: Optional[dict]) -> dict[str, float]:
    return {k: _parse_quantity(v) for k, v in (d or {}).items()}


def _label_selector(d: Optional[dict]) -> Optional[LabelSelector]:
    if not d:
        return None
    return LabelSelector(
        match_labels=dict(d.get("matchLabels") or {}),
        match_expressions=[
            LabelSelectorRequirement(
                key=e.get("key", ""),
                operator=e.get("operator", "In"),
                values=list(e.get("values") or []),
            )
            for e in (d.get("matchExpressions") or [])
        ],
    )


def _field_selector(d: Optional[dict]) -> Optional[pol.FieldSelector]:
    if not d:
        return None
    return pol.FieldSelector(
        match_expressions=[
            pol.FieldSelectorRequirement(
                key=e.get("key", ""),
                operator=e.get("operator", "In"),
                values=list(e.get("values") or []),
            )
            for e in (d.get("matchExpressions") or [])
        ]
    )


def cluster_affinity_from_json(d: Optional[dict]) -> Optional[pol.ClusterAffinity]:
    if d is None:
        return None
    return pol.ClusterAffinity(
        label_selector=_label_selector(d.get("labelSelector")),
        field_selector=_field_selector(d.get("fieldSelector")),
        cluster_names=list(d.get("clusterNames") or []),
        exclude=list(d.get("exclude") or []),
    )


def _toleration(d: dict) -> pol.Toleration:
    return pol.Toleration(
        key=d.get("key", ""),
        operator=d.get("operator", "Equal"),
        value=d.get("value", ""),
        effect=d.get("effect", ""),
        toleration_seconds=d.get("tolerationSeconds"),
    )


def placement_from_json(d: Optional[dict]) -> Optional[pol.Placement]:
    """propagation_types.go Placement (JSON tags) → Placement."""
    if d is None:
        return None
    rs = d.get("replicaScheduling")
    strategy = None
    if rs is not None:
        wp = rs.get("weightPreference")
        prefs = None
        if wp is not None:
            prefs = pol.ClusterPreferences(
                static_weight_list=[
                    pol.StaticClusterWeight(
                        target_cluster=cluster_affinity_from_json(
                            w.get("targetCluster")
                        ) or pol.ClusterAffinity(),
                        weight=int(w.get("weight", 1)),
                    )
                    for w in (wp.get("staticWeightList") or [])
                ],
                dynamic_weight=wp.get("dynamicWeight", ""),
            )
        strategy = pol.ReplicaSchedulingStrategy(
            replica_scheduling_type=rs.get(
                "replicaSchedulingType", pol.REPLICA_SCHEDULING_DUPLICATED
            ),
            replica_division_preference=rs.get("replicaDivisionPreference", ""),
            weight_preference=prefs,
        )
    return pol.Placement(
        cluster_affinity=cluster_affinity_from_json(d.get("clusterAffinity")),
        cluster_affinities=[
            pol.ClusterAffinityTerm(
                affinity_name=t.get("affinityName", ""),
                affinity=cluster_affinity_from_json(t) or pol.ClusterAffinity(),
            )
            for t in (d.get("clusterAffinities") or [])
        ],
        cluster_tolerations=[
            _toleration(t) for t in (d.get("clusterTolerations") or [])
        ],
        spread_constraints=[
            pol.SpreadConstraint(
                spread_by_field=s.get("spreadByField", ""),
                spread_by_label=s.get("spreadByLabel", ""),
                min_groups=int(s.get("minGroups") or 1),
                max_groups=int(s.get("maxGroups") or 0),
            )
            for s in (d.get("spreadConstraints") or [])
        ],
        replica_scheduling=strategy,
    )


def replica_requirements_from_json(d: Optional[dict]) -> Optional[ReplicaRequirements]:
    if d is None:
        return None
    nc = d.get("nodeClaim")
    claim = None
    if nc is not None:
        claim = NodeClaim(
            node_selector=dict(nc.get("nodeSelector") or {}),
            tolerations=list(nc.get("tolerations") or []),
            hard_node_affinity=nc.get("hardNodeAffinity"),
        )
    return ReplicaRequirements(
        node_claim=claim,
        resource_request=resources_from_json(d.get("resourceRequest")),
        namespace=d.get("namespace", ""),
        priority_class_name=d.get("priorityClassName", ""),
    )


def binding_spec_from_json(d: dict) -> BindingSpec:
    """workv1alpha2.ResourceBindingSpec JSON → BindingSpec (the scheduler's
    slice of it: resource identity, replicas+requirements, placement,
    previous clusters, reschedule trigger)."""
    res = d.get("resource") or {}
    return BindingSpec(
        resource=ObjectReference(
            api_version=res.get("apiVersion", ""),
            kind=res.get("kind", ""),
            namespace=res.get("namespace", ""),
            name=res.get("name", ""),
            uid=res.get("uid", ""),
        ),
        replicas=int(d.get("replicas") or 0),
        replica_requirements=replica_requirements_from_json(
            d.get("replicaRequirements")
        ),
        placement=placement_from_json(d.get("placement")),
        clusters=[
            TargetCluster(name=c.get("name", ""), replicas=int(c.get("replicas") or 0))
            for c in (d.get("clusters") or [])
        ],
        scheduler_name=d.get("schedulerName", ""),
        reschedule_triggered_at=rfc3339_to_epoch(d.get("rescheduleTriggeredAt")),
    )


def cluster_from_json(d: dict) -> Cluster:
    """clusterv1alpha1.Cluster JSON → Cluster (the scheduler's slice:
    identity/topology, taints, Ready condition, resource summary, API
    enablements)."""
    meta = d.get("metadata") or {}
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    summary = status.get("resourceSummary") or {}
    nodes = status.get("nodeSummary") or {}
    return Cluster(
        metadata=ObjectMeta(
            name=meta.get("name", ""),
            labels=dict(meta.get("labels") or {}),
        ),
        spec=ClusterSpec(
            sync_mode=spec.get("syncMode", "Push"),
            provider=spec.get("provider", ""),
            region=spec.get("region", ""),
            zone=spec.get("zone", ""),
            taints=[
                Taint(
                    key=t.get("key", ""),
                    value=t.get("value", ""),
                    effect=t.get("effect", ""),
                    time_added=rfc3339_to_epoch(t.get("timeAdded")),
                )
                for t in (spec.get("taints") or [])
            ],
        ),
        status=ClusterStatus(
            kubernetes_version=status.get("kubernetesVersion", ""),
            api_enablements=[
                APIEnablement(
                    group_version=e.get("groupVersion", ""),
                    resources=[
                        r.get("kind", "") for r in (e.get("resources") or [])
                    ],
                )
                for e in (status.get("apiEnablements") or [])
            ],
            conditions=[
                Condition(
                    type=c.get("type", ""),
                    status=c.get("status", ""),
                    reason=c.get("reason", ""),
                    message=c.get("message", ""),
                )
                for c in (status.get("conditions") or [])
            ],
            node_summary=NodeSummary(
                total_num=int(nodes.get("totalNum") or 0),
                ready_num=int(nodes.get("readyNum") or 0),
            ),
            resource_summary=ResourceSummary(
                allocatable=resources_from_json(summary.get("allocatable")),
                allocating=resources_from_json(summary.get("allocating")),
                allocated=resources_from_json(summary.get("allocated")),
            ),
        ),
    )


def target_clusters_to_json(clusters: list[TargetCluster]) -> list[dict]:
    """→ workv1alpha2.TargetCluster JSON (the ScheduleResult payload)."""
    return [
        {"name": tc.name, **({"replicas": tc.replicas} if tc.replicas else {})}
        for tc in clusters
    ]


# -- typed → reference JSON (the marshal direction a Go component's own
# json.Marshal produces; mirrors of the parsers above, omitempty-style) ------


def epoch_to_rfc3339(v: Optional[float]) -> Optional[str]:
    if v is None:
        return None
    from datetime import timezone

    return (
        datetime.fromtimestamp(float(v), tz=timezone.utc)
        .isoformat()
        .replace("+00:00", "Z")
    )


def resources_to_json(d: Optional[dict]) -> dict:
    """→ corev1.ResourceList quantity strings ('2', '0.25')."""
    out = {}
    for k, v in (d or {}).items():
        out[k] = str(int(v)) if float(v) == int(v) else repr(float(v))
    return out


def _label_selector_to_json(s: Optional[LabelSelector]) -> Optional[dict]:
    if s is None:
        return None
    out: dict = {}
    if s.match_labels:
        out["matchLabels"] = dict(s.match_labels)
    if s.match_expressions:
        out["matchExpressions"] = [
            {"key": e.key, "operator": e.operator,
             **({"values": list(e.values)} if e.values else {})}
            for e in s.match_expressions
        ]
    # an empty selector parses back as None; omit it so marshal∘parse∘marshal
    # is a fixpoint (it selects everything either way)
    return out or None


def _field_selector_to_json(s) -> Optional[dict]:
    if s is None:
        return None
    return {
        "matchExpressions": [
            {"key": e.key, "operator": e.operator,
             **({"values": list(e.values)} if e.values else {})}
            for e in s.match_expressions
        ]
    }


def cluster_affinity_to_json(a: Optional[pol.ClusterAffinity]) -> Optional[dict]:
    if a is None:
        return None
    out: dict = {}
    sel = _label_selector_to_json(a.label_selector)
    if sel is not None:
        out["labelSelector"] = sel
    fsel = _field_selector_to_json(a.field_selector)
    if fsel is not None:
        out["fieldSelector"] = fsel
    if a.cluster_names:
        out["clusterNames"] = list(a.cluster_names)
    if a.exclude:
        out["exclude"] = list(a.exclude)
    return out


def _toleration_to_json(t: pol.Toleration) -> dict:
    out: dict = {}
    if t.key:
        out["key"] = t.key
    # the parser defaults a missing operator to Equal; normalize here so
    # the marshal is a fixpoint under parse∘marshal
    out["operator"] = t.operator or "Equal"
    if t.value:
        out["value"] = t.value
    if t.effect:
        out["effect"] = t.effect
    if t.toleration_seconds is not None:
        out["tolerationSeconds"] = t.toleration_seconds
    return out


def placement_to_json(p: Optional[pol.Placement]) -> Optional[dict]:
    if p is None:
        return None
    out: dict = {}
    aff = cluster_affinity_to_json(p.cluster_affinity)
    if aff is not None:
        out["clusterAffinity"] = aff
    if p.cluster_affinities:
        out["clusterAffinities"] = [
            {"affinityName": t.affinity_name,
             **(cluster_affinity_to_json(t.affinity) or {})}
            for t in p.cluster_affinities
        ]
    if p.cluster_tolerations:
        out["clusterTolerations"] = [
            _toleration_to_json(t) for t in p.cluster_tolerations
        ]
    if p.spread_constraints:
        out["spreadConstraints"] = [
            {
                **({"spreadByField": s.spread_by_field}
                   if s.spread_by_field else {}),
                **({"spreadByLabel": s.spread_by_label}
                   if s.spread_by_label else {}),
                "minGroups": s.min_groups or 1,
                **({"maxGroups": s.max_groups} if s.max_groups else {}),
            }
            for s in p.spread_constraints
        ]
    rs = p.replica_scheduling
    if rs is not None:
        rsj: dict = {"replicaSchedulingType": rs.replica_scheduling_type}
        if rs.replica_division_preference:
            rsj["replicaDivisionPreference"] = rs.replica_division_preference
        wp = rs.weight_preference
        if wp is not None:
            wpj: dict = {}
            if wp.static_weight_list:
                wpj["staticWeightList"] = [
                    {
                        "targetCluster": cluster_affinity_to_json(
                            w.target_cluster
                        ) or {},
                        "weight": w.weight,
                    }
                    for w in wp.static_weight_list
                ]
            if wp.dynamic_weight:
                wpj["dynamicWeight"] = wp.dynamic_weight
            rsj["weightPreference"] = wpj
        out["replicaScheduling"] = rsj
    return out


def replica_requirements_to_json(r: Optional[ReplicaRequirements]) -> Optional[dict]:
    if r is None:
        return None
    out: dict = {}
    if r.node_claim is not None:
        nc: dict = {}
        if r.node_claim.node_selector:
            nc["nodeSelector"] = dict(r.node_claim.node_selector)
        if r.node_claim.tolerations:
            nc["tolerations"] = list(r.node_claim.tolerations)
        if r.node_claim.hard_node_affinity is not None:
            nc["hardNodeAffinity"] = r.node_claim.hard_node_affinity
        out["nodeClaim"] = nc
    if r.resource_request:
        out["resourceRequest"] = resources_to_json(r.resource_request)
    if r.namespace:
        out["namespace"] = r.namespace
    if r.priority_class_name:
        out["priorityClassName"] = r.priority_class_name
    return out


def binding_spec_to_json(s: BindingSpec) -> dict:
    """BindingSpec → workv1alpha2.ResourceBindingSpec JSON (the scheduler's
    slice; inverse of binding_spec_from_json)."""
    out: dict = {
        "resource": {
            **({"apiVersion": s.resource.api_version}
               if s.resource.api_version else {}),
            **({"kind": s.resource.kind} if s.resource.kind else {}),
            **({"namespace": s.resource.namespace}
               if s.resource.namespace else {}),
            **({"name": s.resource.name} if s.resource.name else {}),
            **({"uid": s.resource.uid} if s.resource.uid else {}),
        },
    }
    if s.replicas:
        out["replicas"] = s.replicas
    rr = replica_requirements_to_json(s.replica_requirements)
    if rr is not None:
        out["replicaRequirements"] = rr
    pj = placement_to_json(s.placement)
    if pj is not None:
        out["placement"] = pj
    if s.clusters:
        out["clusters"] = target_clusters_to_json(s.clusters)
    if s.scheduler_name:
        out["schedulerName"] = s.scheduler_name
    if s.reschedule_triggered_at is not None:
        out["rescheduleTriggeredAt"] = epoch_to_rfc3339(s.reschedule_triggered_at)
    return out


def cluster_to_json(c: Cluster) -> dict:
    """Cluster → clusterv1alpha1.Cluster JSON (the scheduler's slice;
    inverse of cluster_from_json)."""
    out: dict = {
        "metadata": {
            "name": c.metadata.name,
            **({"labels": dict(c.metadata.labels)}
               if c.metadata.labels else {}),
        },
        "spec": {
            "syncMode": c.spec.sync_mode,
            **({"provider": c.spec.provider} if c.spec.provider else {}),
            **({"region": c.spec.region} if c.spec.region else {}),
            **({"zone": c.spec.zone} if c.spec.zone else {}),
        },
    }
    if c.spec.taints:
        out["spec"]["taints"] = [
            {
                **({"key": t.key} if t.key else {}),
                **({"value": t.value} if t.value else {}),
                **({"effect": t.effect} if t.effect else {}),
                **({"timeAdded": epoch_to_rfc3339(t.time_added)}
                   if t.time_added is not None else {}),
            }
            for t in c.spec.taints
        ]
    status: dict = {}
    if c.status.kubernetes_version:
        status["kubernetesVersion"] = c.status.kubernetes_version
    if c.status.api_enablements:
        status["apiEnablements"] = [
            {"groupVersion": e.group_version,
             "resources": [{"kind": k} for k in e.resources]}
            for e in c.status.api_enablements
        ]
    if c.status.conditions:
        status["conditions"] = [
            {
                "type": cond.type, "status": cond.status,
                **({"reason": cond.reason} if cond.reason else {}),
                **({"message": cond.message} if cond.message else {}),
            }
            for cond in c.status.conditions
        ]
    ns = c.status.node_summary
    if ns is not None and (ns.total_num or ns.ready_num):
        status["nodeSummary"] = {"totalNum": ns.total_num,
                                 "readyNum": ns.ready_num}
    rs = c.status.resource_summary
    if rs is not None and (rs.allocatable or rs.allocating or rs.allocated):
        status["resourceSummary"] = {
            **({"allocatable": resources_to_json(rs.allocatable)}
               if rs.allocatable else {}),
            **({"allocating": resources_to_json(rs.allocating)}
               if rs.allocating else {}),
            **({"allocated": resources_to_json(rs.allocated)}
               if rs.allocated else {}),
        }
    if status:
        out["status"] = status
    return out
