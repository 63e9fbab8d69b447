"""Node-level replica estimation (PyTorch port of ops/estimate.py).

The karmada-scheduler-estimator's core math
(pkg/estimator/server/estimate.go:59-112): answer = sum over feasible nodes
of min(min over requested resources floor((allocatable - requested) /
request), allowed_pods - pod_count), clipped to [0, 2^31 - 1] per node and
per cluster. Node feasibility (NodeAffinity + toleration match) is a mask
computed on the host.

These are the plain versions: int64 throughout, floor division (a node can
be overcommitted, so `allocatable - requested` may be negative), and the
per-cluster sum as `index_add_` over the owning cluster ids, which does not
depend on the order of the nodes. The fleet-wide sweep's kernel
(`kernels.fleet_estimate`, csrc/fleet_estimate.cu) is held against
`fleet_estimate`.
"""
from __future__ import annotations

import torch

I32_MAX = 2**31 - 1
I64 = torch.int64


def node_available_replicas(alloc, requested, pod_count, allowed_pods, request, node_ok):
    """per_node[b, n] = nodeMaxAvailableReplica (estimate.go:104-112):
    alloc/requested i64[N,R], pod_count/allowed_pods i64[N], request
    i64[B,R], node_ok bool[B,N] -> i64[B,N]."""
    rest = alloc - requested
    has_req = request > 0
    req = request.clamp(min=1)[:, None, :]
    per_res = torch.where(
        has_req[:, None, :], torch.div(rest[None], req, rounding_mode="floor"), I32_MAX)
    per_node = per_res.min(-1).values
    pods_left = (allowed_pods.to(I64) - pod_count.to(I64)).clamp(min=0)
    per_node = torch.minimum(per_node, pods_left[None, :])
    per_node = per_node.clamp(0, I32_MAX)
    return torch.where(node_ok, per_node, 0)


def cluster_estimate(alloc, requested, pod_count, allowed_pods, request, node_ok):
    """MaxAvailableReplicas for ONE cluster: i32[B] (estimateReplicas sum)."""
    per_node = node_available_replicas(alloc, requested, pod_count, allowed_pods, request,
                                       node_ok)
    return per_node.sum(-1).clamp(0, I32_MAX).to(torch.int32)


def fleet_estimate(alloc, requested, pod_count, allowed_pods, cluster_id, request, node_ok,
                   num_clusters: int):
    """The whole fleet's node-level estimates in one pass, i32[B, C]: the
    nodes of every cluster concatenated (cluster_id i32[N] the owning
    cluster's index), summed per cluster; a cluster without nodes answers
    0."""
    per_node = node_available_replicas(alloc, requested, pod_count, allowed_pods, request,
                                       node_ok)
    sums = torch.zeros((request.shape[0], num_clusters), dtype=I64, device=per_node.device)
    sums.index_add_(1, cluster_id.long(), per_node)
    return sums.clamp(0, I32_MAX).to(torch.int32)
