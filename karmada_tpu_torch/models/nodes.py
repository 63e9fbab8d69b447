"""Node fleet encoding for the accurate estimator (the port's copy of
models/nodes.py).

Counterpart of the estimator server's NodeInfo snapshot
(pkg/util/lifted/scheduler NodeInfo/snapshot, fed by node/pod informers in
server.go:92-193): nodes become dense arrays; pods fold into per-node
requested totals. Node affinity (strings) is evaluated host-side with
per-claim dedup, exactly like cluster affinity masks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..api.cluster import Taint
from ..api.meta import LabelSelector, LabelSelectorRequirement, Resources
from ..api.policy import Toleration
from ..api.work import NodeClaim
from .fleet import EFFECT_CODES, to_int_units
from ..utils.interner import Interner

NODE_RESOURCES = ("cpu", "memory", "ephemeral-storage", "nvidia.com/gpu")


@dataclass
class NodeSpec:
    name: str
    labels: dict[str, str] = field(default_factory=dict)
    taints: list[Taint] = field(default_factory=list)
    allocatable: Resources = field(default_factory=dict)
    allowed_pods: int = 110


@dataclass
class NodeArrays:
    names: list[str]
    alloc: np.ndarray  # i64[N,R]
    requested: np.ndarray  # i64[N,R] (mutable: pod placement updates it)
    pod_count: np.ndarray  # i64[N]
    allowed_pods: np.ndarray  # i64[N]
    taint_key: np.ndarray  # i32[N,T]
    taint_value: np.ndarray
    taint_effect: np.ndarray
    labels: list[dict[str, str]]

    @property
    def n_nodes(self) -> int:
        return len(self.names)


class NodeEncoder:
    def __init__(self, resources: Sequence[str] = NODE_RESOURCES, strings: Optional[Interner] = None):
        self.resources = list(resources)
        self.strings = strings or Interner()

    def encode(self, nodes: Sequence[NodeSpec], max_taints: int = 2) -> NodeArrays:
        N, R = len(nodes), len(self.resources)
        widest = max((len(n.taints) for n in nodes), default=0)
        T = max_taints
        while T < widest:
            T *= 2
        alloc = np.zeros((N, R), np.int64)
        taint_key = np.zeros((N, T), np.int32)
        taint_value = np.zeros((N, T), np.int32)
        taint_effect = np.zeros((N, T), np.int32)
        allowed = np.zeros(N, np.int64)
        for i, n in enumerate(nodes):
            for r, rname in enumerate(self.resources):
                alloc[i, r] = to_int_units(rname, n.allocatable.get(rname, 0.0))
            allowed[i] = n.allowed_pods
            for t, taint in enumerate(n.taints):
                taint_key[i, t] = self.strings.id(taint.key)
                taint_value[i, t] = self.strings.id(taint.value)
                taint_effect[i, t] = EFFECT_CODES.get(taint.effect, 1)
        return NodeArrays(
            names=[n.name for n in nodes],
            alloc=alloc,
            requested=np.zeros((N, R), np.int64),
            pod_count=np.zeros(N, np.int64),
            allowed_pods=allowed,
            taint_key=taint_key,
            taint_value=taint_value,
            taint_effect=taint_effect,
            labels=[dict(n.labels) for n in nodes],
        )

    def request_vector(self, request: Resources) -> np.ndarray:
        return np.array(
            [to_int_units(r, request.get(r, 0.0)) for r in self.resources], np.int64
        )


def node_claim_matches(claim: Optional[NodeClaim], labels: dict[str, str]) -> bool:
    """NodeSelector + required NodeAffinity label matching
    (nodeutil.IsNodeAffinityMatched in estimate.go:90-92)."""
    if claim is None:
        return True
    for k, v in claim.node_selector.items():
        if labels.get(k) != v:
            return False
    affinity = claim.hard_node_affinity
    if affinity:
        # affinity: list of terms (OR), each a list of match_expressions (AND)
        terms = affinity if isinstance(affinity, list) else [affinity]
        ok = False
        for term in terms:
            sel = LabelSelector(
                match_expressions=[
                    LabelSelectorRequirement(
                        key=e.get("key", ""),
                        operator=e.get("operator", "In"),
                        values=list(e.get("values", [])),
                    )
                    for e in term.get("matchExpressions", [])
                ]
            )
            if sel.matches(labels):
                ok = True
                break
        if not ok:
            return False
    return True


def tolerations_cover_node_taints(
    tolerations: Sequence, taints: Sequence[Taint]
) -> bool:
    """IsTolerationMatched (estimate.go:90-92): NoSchedule/NoExecute node
    taints must be tolerated."""
    tols = [
        t if isinstance(t, Toleration) else Toleration(
            key=t.get("key", ""),
            operator=t.get("operator", "Equal"),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
        )
        for t in tolerations
    ]
    for taint in taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(t.tolerates(taint) for t in tols):
            return False
    return True
