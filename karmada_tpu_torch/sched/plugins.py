"""Scheduler plugin registry: the `--plugins` enable/disable surface and the
out-of-tree extension seam.

The six in-tree plugins (plugins/registry.go:30-39) are FUSED mask/score
terms inside the filter kernels, so "enabling" a plugin selects which terms
the kernels evaluate (the `plugin_bits` argument). Out-of-tree plugins
(FilterPlugin, ScorePlugin; registered with `PluginRegistry.register`)
return host-computed [B, C] mask and score terms that ride into every round
as extra kernel inputs: the mask ANDed into each row's feasibility, the
score added to the in-tree score (a wrapping int32 add) — the reference's
out-of-tree registry merge (scheduler.go:241-244).
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

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


class FilterPlugin:
    """Out-of-tree filter seam (framework/interface.go:62-69): return a
    bool[B, C] feasibility mask for the round's bindings x clusters."""

    name = "filter"

    def mask(self, bindings: Sequence, cluster_names: Sequence[str]) -> np.ndarray:
        raise NotImplementedError


class ScorePlugin:
    """Out-of-tree score seam (framework/interface.go:183-194): return an
    i32[B, C] score term, summed with the in-tree scores
    (generic_scheduler.go:166-172 sums plugins)."""

    name = "score"

    def score(self, bindings: Sequence, cluster_names: Sequence[str]) -> np.ndarray:
        raise NotImplementedError


class PluginRegistry:
    """In-tree names + registered out-of-tree plugins, with the reference's
    Register/Unregister/Filter semantics (runtime/registry.go:38-103)."""

    def __init__(self) -> None:
        self._out_of_tree: dict[str, object] = {}

    def register(self, plugin) -> None:
        name = plugin.name
        if name in IN_TREE or name in self._out_of_tree:
            raise ValueError(f"a plugin named {name} already exists")
        self._out_of_tree[name] = plugin

    def unregister(self, name: str) -> None:
        if name not in self._out_of_tree:
            raise ValueError(f"no plugin named {name} exists")
        del self._out_of_tree[name]

    def factory_names(self) -> list[str]:
        return sorted((*IN_TREE, *self._out_of_tree))

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

    def out_of_tree(self, enabled: set[str]) -> list:
        """The enabled out-of-tree plugins, in name order."""
        return [p for n, p in sorted(self._out_of_tree.items()) if n in enabled]
