"""Device-resident fleet state: the batched reframing of the scheduler's
cluster cache.

The reference deep-copies every Cluster on every schedule attempt
(pkg/scheduler/cache/cache.go:62-77 — O(N) per binding). Here the fleet is
encoded ONCE into dense arrays kept on device; schedule rounds reuse them, and
cluster changes re-encode incrementally. All strings (names, taint keys, label
keys/values, GVKs, topology values) are interned to int32 ids.

Array layout (C clusters, R resources, T max taints, L max labels):
  capacity[C,R]    available = allocatable − allocated − allocating
                   (GeneralEstimator input, estimator/client/general.go:96-114)
  allocatable[C,R]
  alive[C]         Ready condition (cluster_status_controller.go health probe)
  taint_key/value/effect[C,T]   effect codes: 0 none, 1 NoSchedule,
                   2 PreferNoSchedule, 3 NoExecute
  api_ok[C,G]      GVK enablement bitmap (api_enablement.go:52)
  topo[C,4]        provider/region/zone/name ids (spread constraint axes)
  name_id[C]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..api.cluster import (
    Cluster,
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    cluster_ready,
)
from ..utils.interner import Interner

EFFECT_CODES = {
    "": 0,
    EFFECT_NO_SCHEDULE: 1,
    EFFECT_PREFER_NO_SCHEDULE: 2,
    EFFECT_NO_EXECUTE: 3,
}

# Fixed resource vocabulary; index = column in capacity arrays. Extend via
# FleetEncoder(resources=...). Order matters for encoded batches.
DEFAULT_RESOURCES = ("cpu", "memory", "pods", "ephemeral-storage")

TOPO_PROVIDER, TOPO_REGION, TOPO_ZONE, TOPO_CLUSTER = 0, 1, 2, 3


def to_int_units(resource: str, value: float) -> int:
    """Canonical integer units, mirroring resource.Quantity math in the
    estimators (general.go:180-186): cpu in millicores (MilliValue), all other
    resources in raw integer value. Integer division over these units is what
    gives bit-exact replica estimates."""
    if resource == "cpu":
        return int(round(value * 1000))
    return int(value)


@dataclass
class FleetArrays:
    """Numpy-side encoding; the scheduler uploads it to torch tensors."""

    names: list[str]
    name_id: np.ndarray  # i32[C]
    alive: np.ndarray  # bool[C]
    capacity: np.ndarray  # i64[C,R] integer units (cpu milli)
    allocatable: np.ndarray  # i64[C,R]
    has_summary: np.ndarray  # bool[C]
    taint_key: np.ndarray  # i32[C,T]
    taint_value: np.ndarray  # i32[C,T]
    taint_effect: np.ndarray  # i32[C,T]
    api_ok: np.ndarray  # bool[C,G]
    topo: np.ndarray  # i32[C,4]

    @property
    def n_clusters(self) -> int:
        return len(self.names)

    def index_of(self, name: str) -> int:
        return self.names.index(name)


class FleetEncoder:
    """Encodes Cluster objects into FleetArrays with a shared interner.

    The interner and the GVK vocabulary grow monotonically; re-encoding with
    the same encoder keeps ids stable (device caches never need string
    rewrites)."""

    def __init__(
        self,
        resources: Sequence[str] = DEFAULT_RESOURCES,
        max_taints: int = 4,
    ) -> None:
        self.resources = list(resources)
        self.max_taints = max_taints
        self.strings = Interner()
        self.gvks = Interner()

    def gvk_id(self, api_version: str, kind: str) -> int:
        return self.gvks.id(f"{api_version}/{kind}")

    def encode(self, clusters: Sequence[Cluster]) -> FleetArrays:
        C, R = len(clusters), len(self.resources)
        # Size the taint axis to the actual fleet maximum (bucketed to bound
        # jit recompiles) — truncating would silently unfilter tainted clusters.
        widest = max((len(c.spec.taints) for c in clusters), default=0)
        T = self.max_taints
        while T < widest:
            T *= 2
        # Pre-register every GVK so api_ok has stable width this round.
        for c in clusters:
            for en in c.status.api_enablements:
                for kind in en.resources:
                    self.gvk_id(en.group_version, kind)
        G = len(self.gvks)

        names = [c.name for c in clusters]
        name_id = np.array([self.strings.id(n) for n in names], np.int32)
        alive = np.array([cluster_ready(c) for c in clusters], bool)
        capacity = np.zeros((C, R), np.int64)
        allocatable = np.zeros((C, R), np.int64)
        has_summary = np.zeros(C, bool)
        taint_key = np.zeros((C, T), np.int32)
        taint_value = np.zeros((C, T), np.int32)
        taint_effect = np.zeros((C, T), np.int32)
        api_ok = np.zeros((C, G), bool)
        topo = np.zeros((C, 4), np.int32)

        for i, c in enumerate(clusters):
            self._fill_cluster_row(
                i, c, capacity, allocatable, has_summary,
                taint_key, taint_value, taint_effect, api_ok, topo, name_id,
            )

        return FleetArrays(
            names=names,
            name_id=name_id,
            alive=alive,
            capacity=capacity,
            allocatable=allocatable,
            has_summary=has_summary,
            taint_key=taint_key,
            taint_value=taint_value,
            taint_effect=taint_effect,
            api_ok=api_ok,
            topo=topo,
        )

    def _fill_cluster_row(
        self, i: int, c: Cluster, capacity, allocatable, has_summary,
        taint_key, taint_value, taint_effect, api_ok, topo, name_id,
    ) -> None:
        """Write one cluster's encoding into row i of the fleet arrays —
        the single source of truth shared by the full encode() and the
        dirty-column encode_cols() refresh."""
        rs = c.status.resource_summary
        if rs is not None:
            has_summary[i] = True
            for r, rname in enumerate(self.resources):
                alloc = to_int_units(rname, rs.allocatable.get(rname, 0.0))
                used = to_int_units(rname, rs.allocated.get(rname, 0.0))
                pending = to_int_units(rname, rs.allocating.get(rname, 0.0))
                allocatable[i, r] = alloc
                capacity[i, r] = max(alloc - used - pending, 0)
        for t, taint in enumerate(c.spec.taints):
            taint_key[i, t] = self.strings.id(taint.key)
            taint_value[i, t] = self.strings.id(taint.value)
            taint_effect[i, t] = EFFECT_CODES.get(taint.effect, 1)
        for en in c.status.api_enablements:
            for kind in en.resources:
                api_ok[i, self.gvk_id(en.group_version, kind)] = True
        topo[i, TOPO_PROVIDER] = self.strings.id(c.spec.provider)
        topo[i, TOPO_REGION] = self.strings.id(c.spec.region)
        topo[i, TOPO_ZONE] = self.strings.id(c.spec.zone)
        topo[i, TOPO_CLUSTER] = name_id[i]

    def encode_cols(
        self, prev: FleetArrays, clusters: Sequence[Cluster], idx: Sequence[int]
    ) -> Optional[FleetArrays]:
        """Dirty-column re-encode: new FleetArrays sharing `prev`'s layout
        with only the rows in `idx` re-encoded from `clusters`. Returns None
        when the delta does not fit the previous layout — the membership
        changed, a dirty cluster's taints outgrow the taint axis, or it
        enables a GVK outside the encoded vocabulary (api_ok would need a
        new column) — and the caller must run the full encode()."""
        if len(clusters) != prev.n_clusters:
            return None
        T = prev.taint_key.shape[1]
        G = prev.api_ok.shape[1]
        for i in idx:
            c = clusters[i]
            if c.name != prev.names[i]:
                return None
            if len(c.spec.taints) > T:
                return None
            for en in c.status.api_enablements:
                for kind in en.resources:
                    gid = self.gvks.peek(f"{en.group_version}/{kind}")
                    if gid is None or gid >= G:
                        return None
        name_id = prev.name_id
        alive = prev.alive.copy()
        capacity = prev.capacity.copy()
        allocatable = prev.allocatable.copy()
        has_summary = prev.has_summary.copy()
        taint_key = prev.taint_key.copy()
        taint_value = prev.taint_value.copy()
        taint_effect = prev.taint_effect.copy()
        api_ok = prev.api_ok.copy()
        topo = prev.topo.copy()
        for i in idx:
            c = clusters[i]
            alive[i] = cluster_ready(c)
            has_summary[i] = False
            capacity[i] = 0
            allocatable[i] = 0
            taint_key[i] = 0
            taint_value[i] = 0
            taint_effect[i] = 0
            api_ok[i] = False
            self._fill_cluster_row(
                i, c, capacity, allocatable, has_summary,
                taint_key, taint_value, taint_effect, api_ok, topo, name_id,
            )
        return FleetArrays(
            names=prev.names,
            name_id=name_id,
            alive=alive,
            capacity=capacity,
            allocatable=allocatable,
            has_summary=has_summary,
            taint_key=taint_key,
            taint_value=taint_value,
            taint_effect=taint_effect,
            api_ok=api_ok,
            topo=topo,
        )
