"""Object-model metadata shared by every API type.

Behavior modeled on how the reference uses Kubernetes object metadata
(labels/annotations as the idempotence keys, generation vs observedGeneration,
finalizers + deletionTimestamp for teardown) — e.g.
pkg/scheduler/scheduler.go:400-441 keys scheduling decisions off
annotations/generation. Not a port of apimachinery: just enough metadata for a
level-triggered, versioned object store.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Optional

# Resource quantities. Canonical units: "cpu" in cores (float), "memory" in
# bytes, everything else raw counts. The reference uses resource.Quantity;
# floats are sufficient for the scheduling math (the division algorithms all
# operate on integer replica counts, not quantities).
Resources = dict[str, float]

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    return f"{prefix}-{next(_uid_counter)}"


def now() -> float:
    return time.time()


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    finalizers: list[str] = field(default_factory=list)
    owner_references: list[OwnerReference] = field(default_factory=list)
    resource_version: int = 0
    generation: int = 0
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None

    def key(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class Condition:
    """Mirrors metav1.Condition semantics (status True/False/Unknown)."""

    type: str = ""
    status: str = "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


def set_condition(conditions: list[Condition], cond: Condition) -> bool:
    """Upsert by type; only bumps transition time when status flips.

    Returns True when anything changed (reference: meta.SetStatusCondition use
    throughout pkg/scheduler/scheduler.go:913-961).
    """
    for i, existing in enumerate(conditions):
        if existing.type == cond.type:
            if (
                existing.status == cond.status
                and existing.reason == cond.reason
                and existing.message == cond.message
            ):
                return False
            if existing.status == cond.status:
                cond.last_transition_time = existing.last_transition_time
            elif not cond.last_transition_time:
                cond.last_transition_time = now()
            conditions[i] = cond
            return True
    if not cond.last_transition_time:
        cond.last_transition_time = now()
    conditions.append(cond)
    return True


def get_condition(conditions: list[Condition], ctype: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == ctype:
            return c
    return None


def deepcopy_obj(obj: Any) -> Any:
    return copy.deepcopy(obj)


@dataclass
class LabelSelector:
    """matchLabels + matchExpressions (In/NotIn/Exists/DoesNotExist).

    Reference: metav1.LabelSelector as consumed by
    pkg/scheduler/framework/plugins/clusteraffinity/cluster_affinity.go:51-80.
    """

    match_labels: dict[str, str] = field(default_factory=dict)
    match_expressions: list[LabelSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            if not req.matches(labels):
                return False
        return True

    def is_empty(self) -> bool:
        return not self.match_labels and not self.match_expressions


@dataclass
class LabelSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist
    values: list[str] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        present = self.key in labels
        if self.operator == "Exists":
            return present
        if self.operator == "DoesNotExist":
            return not present
        if self.operator == "In":
            return present and labels[self.key] in self.values
        if self.operator == "NotIn":
            return not present or labels[self.key] not in self.values
        raise ValueError(f"unknown label selector operator {self.operator!r}")


def add_resources(a: Resources, b: Resources) -> Resources:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + v
    return out


def sub_resources(a: Resources, b: Resources) -> Resources:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) - v
    return out


def dataclass_replace(obj, **kw):
    return dataclasses.replace(obj, **kw)
