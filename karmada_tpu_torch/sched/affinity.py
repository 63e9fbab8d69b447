"""Host-side cluster affinity evaluation (string programs).

Equivalent of util.ClusterMatches as used by the ClusterAffinity plugin
(cluster_affinity.go:51-80) and static-weight rule matching
(division_algorithm.go getStaticWeightInfoList → util.ClusterMatches):
exclude list, clusterNames, labelSelector, fieldSelector (provider/region/zone
In/NotIn). Affinity masks are evaluated once per *unique* affinity per round
(policies are shared by many bindings) and handed to the device pipeline as
bool[B,C] — strings never reach the device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..api.cluster import Cluster
from ..api.policy import ClusterAffinity, FieldSelector


def field_selector_matches(fs: Optional[FieldSelector], cluster: Cluster) -> bool:
    if fs is None:
        return True
    fields = {
        "provider": cluster.spec.provider,
        "region": cluster.spec.region,
        "zone": cluster.spec.zone,
    }
    for req in fs.match_expressions:
        val = fields.get(req.key, "")
        if req.operator == "In":
            if val not in req.values:
                return False
        elif req.operator == "NotIn":
            if val in req.values:
                return False
        else:
            raise ValueError(f"unsupported field selector operator {req.operator!r}")
    return True


def cluster_matches(cluster: Cluster, affinity: Optional[ClusterAffinity]) -> bool:
    """util.ClusterMatches: exclude wins; then clusterNames (if set), label
    selector, field selector must all hold."""
    if affinity is None:
        return True
    if cluster.name in affinity.exclude:
        return False
    if affinity.cluster_names and cluster.name not in affinity.cluster_names:
        return False
    if affinity.label_selector is not None and not affinity.label_selector.matches(
        cluster.metadata.labels
    ):
        return False
    if not field_selector_matches(affinity.field_selector, cluster):
        return False
    return True


def affinity_key(affinity: Optional[ClusterAffinity]) -> str:
    """Canonical dedup key: bindings sharing a policy share the mask."""
    if affinity is None:
        return "<all>"
    parts = [
        ",".join(sorted(affinity.cluster_names)),
        ",".join(sorted(affinity.exclude)),
    ]
    if affinity.label_selector is not None:
        ls = affinity.label_selector
        parts.append(";".join(f"{k}={v}" for k, v in sorted(ls.match_labels.items())))
        parts.append(
            ";".join(
                f"{r.key} {r.operator} [{','.join(sorted(r.values))}]"
                for r in ls.match_expressions
            )
        )
    if affinity.field_selector is not None:
        parts.append(
            ";".join(
                f"{r.key} {r.operator} [{','.join(sorted(r.values))}]"
                for r in affinity.field_selector.match_expressions
            )
        )
    return "|".join(parts)


class AffinityMaskCache:
    """Evaluates affinity → bool[C] masks with dedup across bindings.
    Invalidate on any cluster change (encoder re-encode)."""

    def __init__(self, clusters: Sequence[Cluster]):
        self.clusters = list(clusters)
        self._cache: dict[str, np.ndarray] = {}

    def mask(self, affinity: Optional[ClusterAffinity]) -> np.ndarray:
        key = affinity_key(affinity)
        m = self._cache.get(key)
        if m is None:
            m = np.array([cluster_matches(c, affinity) for c in self.clusters], bool)
            self._cache[key] = m
        return m
