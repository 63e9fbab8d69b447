"""Scheduler plugin registry: the `--plugins` enable/disable surface.

The six in-tree plugins (plugins/registry.go:30-39) are FUSED mask/score
terms inside the candidate-select kernel, so "enabling" a plugin selects
which terms the kernel evaluates (the `plugin_bits` argument). Out-of-tree
plugins (host-computed [B,C] mask/score terms, scheduler.go:241-244) belong
to a later slice of the port: registering one raises NotImplementedError.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

# In-tree plugin names (plugins/registry.go:30-39).
API_ENABLEMENT = "APIEnablement"
TAINT_TOLERATION = "TaintToleration"
CLUSTER_AFFINITY = "ClusterAffinity"
SPREAD_CONSTRAINT = "SpreadConstraint"
CLUSTER_LOCALITY = "ClusterLocality"
CLUSTER_EVICTION = "ClusterEviction"
IN_TREE = (
    API_ENABLEMENT,
    TAINT_TOLERATION,
    CLUSTER_AFFINITY,
    SPREAD_CONSTRAINT,
    CLUSTER_LOCALITY,
    CLUSTER_EVICTION,
)

# kernel bits for the fused in-tree terms. SpreadConstraint has no bit ON
# PURPOSE: in the reference the plugin is only the field-presence FILTER
# (spread_constraint.go:49); the selection algorithm runs in SelectClusters
# regardless of the registry (core/common.go:32-39).
BIT_API = 1
BIT_TAINT = 2
BIT_AFFINITY = 4
BIT_EVICTION = 8
BIT_LOCALITY = 16
ALL_PLUGIN_BITS = BIT_API | BIT_TAINT | BIT_AFFINITY | BIT_EVICTION | BIT_LOCALITY
_BIT_OF = {
    API_ENABLEMENT: BIT_API,
    TAINT_TOLERATION: BIT_TAINT,
    CLUSTER_AFFINITY: BIT_AFFINITY,
    CLUSTER_EVICTION: BIT_EVICTION,
    CLUSTER_LOCALITY: BIT_LOCALITY,
}


def plugin_bits(enabled: Iterable[str]) -> int:
    bits = 0
    for name in enabled:
        bits |= _BIT_OF.get(name, 0)
    return bits


class PluginRegistry:
    """In-tree names with the reference's Filter semantics
    (runtime/registry.go:38-103)."""

    def register(self, plugin) -> None:
        raise NotImplementedError(
            "out-of-tree scheduler plugins are not ported yet (a later slice "
            "of the PyTorch port)"
        )

    def factory_names(self) -> list[str]:
        return sorted(IN_TREE)

    def filter(self, names: Optional[Sequence[str]]) -> set[str]:
        """registry.Filter(names): '*' enables everything, 'foo' enables
        foo, '-foo' disables foo (registry.go:73-103).

        Order quirks are REFERENCE-FAITHFUL, not accidents: a '-foo' that
        precedes every enable is skipped (registry.go:95 requires a
        non-empty result before deleting), and multiple leading dashes all
        strip (Go strings.TrimLeft(name, "-") == str.lstrip('-'))."""
        names = list(names) if names else ["*"]
        enabled: set[str] = set()
        all_names = set(self.factory_names())
        for name in names:
            if name == "*":
                enabled |= all_names
                break
        for name in names:
            if name in all_names:
                enabled.add(name)
                continue
            if name.startswith("-") and enabled:
                enabled.discard(name.lstrip("-"))
        return enabled
