"""Fixture helpers + synthetic fleet generator (the subset the scheduler
slice needs).

Mirrors the role of the reference's test/helper/resource.go (NewCluster
:679, NewClusterWithResource :686): clusters are just objects with a
ResourceSummary — multi-cluster is simulated without real clusters.
`synthetic_fleet` draws from `random.Random(seed)` in the same order as the
JAX package's generator, so one seed gives the same fleet in both.
"""
from __future__ import annotations

import random
from typing import Optional

from ..api.cluster import (
    APIEnablement,
    Cluster,
    ClusterSpec,
    NodeSummary,
    ResourceSummary,
    Taint,
    CLUSTER_CONDITION_READY,
)
from ..api.meta import CPU, MEMORY, PODS, Condition, ObjectMeta, Resources
from ..api.policy import (
    ClusterAffinity,
    ClusterPreferences,
    Placement,
    REPLICA_SCHEDULING_DIVIDED,
    REPLICA_SCHEDULING_DUPLICATED,
    ReplicaSchedulingStrategy,
    StaticClusterWeight,
)

GiB = 1024.0**3


def new_cluster(
    name: str,
    *,
    provider: str = "",
    region: str = "",
    zone: str = "",
    labels: Optional[dict[str, str]] = None,
    taints: Optional[list[Taint]] = None,
    ready: bool = True,
    api_enablements: Optional[list[APIEnablement]] = None,
) -> Cluster:
    c = Cluster(
        metadata=ObjectMeta(name=name, labels=dict(labels or {})),
        spec=ClusterSpec(provider=provider, region=region, zone=zone, taints=list(taints or [])),
    )
    c.status.conditions.append(
        Condition(type=CLUSTER_CONDITION_READY, status="True" if ready else "False")
    )
    if api_enablements is None:
        api_enablements = [
            APIEnablement(group_version="apps/v1", resources=["Deployment", "StatefulSet"]),
            APIEnablement(group_version="v1", resources=["ConfigMap", "Secret", "Service"]),
            APIEnablement(group_version="batch/v1", resources=["Job"]),
        ]
    c.status.api_enablements = api_enablements
    return c


def new_cluster_with_resource(
    name: str,
    allocatable: Resources,
    allocating: Optional[Resources] = None,
    allocated: Optional[Resources] = None,
    **kw,
) -> Cluster:
    """test/helper/resource.go:686 NewClusterWithResource."""
    c = new_cluster(name, **kw)
    c.status.resource_summary = ResourceSummary(
        allocatable=dict(allocatable),
        allocating=dict(allocating or {}),
        allocated=dict(allocated or {}),
    )
    c.status.node_summary = NodeSummary(total_num=10, ready_num=10)
    return c


def duplicated_placement(cluster_names: Optional[list[str]] = None) -> Placement:
    return Placement(
        cluster_affinity=ClusterAffinity(cluster_names=list(cluster_names or [])),
        replica_scheduling=ReplicaSchedulingStrategy(
            replica_scheduling_type=REPLICA_SCHEDULING_DUPLICATED
        ),
    )


def static_weight_placement(weights: dict[str, int]) -> Placement:
    return Placement(
        cluster_affinity=ClusterAffinity(cluster_names=list(weights)),
        replica_scheduling=ReplicaSchedulingStrategy(
            replica_scheduling_type=REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference="Weighted",
            weight_preference=ClusterPreferences(
                static_weight_list=[
                    StaticClusterWeight(
                        target_cluster=ClusterAffinity(cluster_names=[n]), weight=w
                    )
                    for n, w in weights.items()
                ]
            ),
        ),
    )


PROVIDERS = ["aws", "gcp", "azure", "onprem"]


def synthetic_fleet(
    n_clusters: int,
    *,
    seed: int = 0,
    regions_per_provider: int = 4,
    zones_per_region: int = 3,
    cpu_range: tuple[float, float] = (64.0, 1024.0),
    mem_per_cpu: float = 4 * GiB,
    ready_fraction: float = 1.0,
) -> list[Cluster]:
    rng = random.Random(seed)
    out = []
    for i in range(n_clusters):
        provider = PROVIDERS[i % len(PROVIDERS)]
        region = f"{provider}-region-{rng.randrange(regions_per_provider)}"
        zone = f"{region}-z{rng.randrange(zones_per_region)}"
        cpu = rng.uniform(*cpu_range)
        alloc = {CPU: cpu, MEMORY: cpu * mem_per_cpu, PODS: float(int(cpu) * 8)}
        used_frac = rng.uniform(0.0, 0.7)
        used = {k: v * used_frac for k, v in alloc.items()}
        c = new_cluster_with_resource(
            f"member-{i}",
            allocatable=alloc,
            allocated=used,
            provider=provider,
            region=region,
            zone=zone,
            labels={"fleet.karmada.io/tier": "gold" if i % 3 == 0 else "silver"},
            ready=rng.random() < ready_fraction,
        )
        out.append(c)
    return out


# -- estimator fixtures ------------------------------------------------------


def shard_nodes(seed: int, cluster_name: str):
    """Deterministic heterogeneous node pool of one member cluster (2-5
    nodes of 8/16/32 cpu and 32/64 GiB), the reference bench's
    `_shard_nodes`: the draws are seeded by (seed, crc32 of the name), so
    every process and both packages rebuild the same pools."""
    import zlib

    import numpy as np

    from ..models.nodes import NodeSpec

    rng = np.random.default_rng((seed, zlib.crc32(cluster_name.encode())))
    return [
        NodeSpec(
            name=f"{cluster_name}-n{k}",
            allocatable={
                CPU: float(rng.choice([8.0, 16.0, 32.0])),
                MEMORY: float(rng.choice([32.0, 64.0])) * GiB,
                PODS: 110.0,
            },
        )
        for k in range(int(rng.integers(2, 6)))
    ]


def build_estimator(n_nodes: int, n_pods: int, seed: int = 0):
    """The reference estimator-server benchmark fixture
    (server_test.go:265-312, the JAX package's scripts/bench_estimator.py
    `build`): one AccurateEstimator over `n_nodes` nodes of 16/32/64 cpu
    and 64/128 GiB, with `n_pods` pods placed first-fit in workload groups
    of 50-199."""
    import numpy as np

    from ..estimator.accurate import AccurateEstimator
    from ..models.nodes import NodeSpec

    rng = np.random.default_rng(seed)
    nodes = [
        NodeSpec(
            name=f"n{k}",
            allocatable={
                CPU: float(rng.choice([16.0, 32.0, 64.0])),
                MEMORY: float(rng.choice([64.0, 128.0])) * GiB,
                PODS: 110.0,
            },
        )
        for k in range(n_nodes)
    ]
    est = AccurateEstimator(nodes)
    placed = 0
    w = 0
    while placed < n_pods:
        count = min(int(rng.integers(50, 200)), n_pods - placed)
        est.place(
            f"w{w}", count,
            {CPU: float(rng.choice([0.1, 0.25, 0.5])), MEMORY: 0.5 * GiB},
        )
        placed += count
        w += 1
    return est
