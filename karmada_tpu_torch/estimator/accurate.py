"""Accurate estimator core: the karmada-scheduler-estimator daemon's brain
(the port's copy of estimator/accurate.py).

Parity with pkg/estimator/server (EST4): per member cluster, a node/pod
snapshot answers MaxAvailableReplicas = sum over affinity+toleration-feasible
nodes of min((allocatable - requested) / request, free pod slots)
(estimate.go:36-112), and GetUnschedulableReplicas counts replicas pending
longer than a threshold (server.go:228). Member-local calls run the node
math in numpy on the host, as the member's daemon would; the scheduler's
fleet-wide sweep over every member's nodes is one device kernel
(estimator/client.py `MemberEstimators`, `kernels.fleet_estimate`).
Node-affinity string matching is host-evaluated with per-claim dedup.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from ..api.meta import Resources
from ..api.work import ReplicaRequirements
from ..models.nodes import (
    NodeArrays,
    NodeEncoder,
    NodeSpec,
    node_claim_matches,
    tolerations_cover_node_taints,
)

_I32_MAX = np.int64(2**31 - 1)
_estimator_uid = iter(range(1, 2**62))


def first_fit_place(
    alloc: np.ndarray,      # i64[N,R]
    requested: np.ndarray,  # i64[N,R] — mutated
    pod_count: np.ndarray,  # i64[N]  — mutated
    allowed: np.ndarray,    # i64[N]
    node_ok: np.ndarray,    # bool[N]
    req: np.ndarray,        # i64[R]
    replicas: int,
) -> tuple[int, np.ndarray]:
    """Greedy first-fit in node order; returns (placed, fits[N]). Mutates
    requested/pod_count. The reference runs the same scan in a C++
    library with this loop as its fallback; both give the same fits."""
    N, R = alloc.shape
    fits = np.zeros(N, dtype=np.int64)
    remaining = int(replicas)
    for i in range(N):
        if remaining <= 0 or not node_ok[i]:
            continue
        fit = int(allowed[i] - pod_count[i])
        if fit <= 0:
            continue
        rest = alloc[i] - requested[i]
        with np.errstate(divide="ignore"):
            by_res = np.where(req > 0, rest // np.maximum(req, 1), np.iinfo(np.int64).max)
        fit = max(0, min(fit, int(by_res.min()), remaining))
        if fit > 0:
            requested[i] += req * fit
            pod_count[i] += fit
            fits[i] = fit
            remaining -= fit
    return replicas - remaining, fits


def _np_cluster_estimate(alloc, requested, pod_count, allowed_pods, request, node_ok):
    """numpy twin of ops/estimate.cluster_estimate: bit-identical integer
    math (estimate.go:59-112), kept host-side for member-local calls."""
    rest = alloc - requested  # i64[N,R]
    has_req = request > 0  # [B,R]
    req = np.maximum(request, 1)[:, None, :]  # [B,1,R]
    per_res = np.where(has_req[:, None, :], rest[None, :, :] // req, _I32_MAX)
    per_node = per_res.min(-1)  # [B,N]
    pods_left = np.maximum(allowed_pods - pod_count.astype(np.int64), 0)
    per_node = np.minimum(per_node, pods_left[None, :])
    per_node = np.clip(per_node, 0, _I32_MAX)
    per_node = np.where(node_ok, per_node, 0)
    return np.clip(per_node.sum(-1), 0, _I32_MAX).astype(np.int32)


class AccurateEstimator:
    """One member cluster's estimator. Also serves as the member's pod
    placement simulator (the test fixture role — SURVEY §4 synthetic fleet)."""

    def __init__(self, nodes: Sequence[NodeSpec], clock=None, framework=None):
        self.clock = clock  # injectable (tests advance time deterministically)
        # EstimateReplicas plugin framework (estimate.go:78-101): plugin
        # answers min-merge into the node-level sum; Unschedulable short-
        # circuits to 0. None = no plugins configured.
        self.framework = framework
        self.encoder = NodeEncoder()
        self.specs = list(nodes)
        self.arrays: NodeArrays = self.encoder.encode(self.specs)
        # pods placed per workload key: list of (node_idx, count, req_vec)
        self._pods: dict[str, list[tuple[int, int, np.ndarray]]] = {}
        self._node_ok_cache: dict[str, np.ndarray] = {}
        self._pending: dict[str, tuple[int, float]] = {}  # key -> (count, since)
        # bumped on every node-state mutation (pod placement); lets fleet-
        # level caches (client.MemberEstimators) know when to re-snapshot.
        # uid is a process-monotonic identity: id() recycles after GC, which
        # would let a rejoined cluster alias a stale fleet snapshot.
        self.version = 0
        self.uid = next(_estimator_uid)

    # -- estimation (the gRPC answer) -------------------------------------

    def _node_ok(self, requirements: Optional[ReplicaRequirements]) -> np.ndarray:
        """Claim → node feasibility mask, deduped per distinct claim (most
        rows in a batch share a claim — typically None); node labels/taints
        are fixed at construction so the cache never invalidates."""
        claim = requirements.node_claim if requirements else None
        key = repr(claim)
        cached = self._node_ok_cache.get(key)
        if cached is not None:
            return cached
        N = self.arrays.n_nodes
        ok = np.ones(N, bool)
        tolerations = claim.tolerations if claim else []
        for i, spec in enumerate(self.specs):
            if not node_claim_matches(claim, spec.labels):
                ok[i] = False
            elif not tolerations_cover_node_taints(tolerations, spec.taints):
                ok[i] = False
        self._node_ok_cache[key] = ok
        return ok

    def max_available_replicas(self, requirements: Optional[ReplicaRequirements]) -> int:
        return self.max_available_replicas_batch([requirements])[0]

    def max_available_replicas_batch(
        self, requirements_list: Sequence[Optional[ReplicaRequirements]]
    ) -> list[int]:
        """All B requests against this cluster's nodes in ONE kernel call —
        the batched form the scheduler's per-round estimate sweep uses."""
        if self.arrays.n_nodes == 0:
            return [0] * len(requirements_list)
        request = np.stack(
            [
                self.encoder.request_vector(r.resource_request if r else {})
                for r in requirements_list
            ]
        )
        node_ok = np.stack([self._node_ok(r) for r in requirements_list])
        # Member-side compute runs in plain numpy on purpose: the estimator
        # daemon lives on the member cluster's CPUs in the reference
        # deployment, and these [B, N, R] slabs are tiny. The device form
        # of this math is the scheduler-side fleet sweep
        # (kernels.fleet_estimate).
        out = _np_cluster_estimate(
            self.arrays.alloc,
            self.arrays.requested,
            self.arrays.pod_count,
            self.arrays.allowed_pods,
            request,
            node_ok,
        )
        res = [int(v) for v in out]
        if self.framework is not None:
            # RunEstimateReplicasPlugins min-merge (estimate.go:78-101):
            # Unschedulable => 0; Success bounds the node sum; NoOperation
            # leaves it untouched; plugin errors surface the node answer
            # (the reference returns an error — our gRPC layer maps that to
            # the -1 discard sentinel upstream, so keep the node sum here)
            for i, req in enumerate(requirements_list):
                replicas, ret = self.framework.run_estimate_replicas_plugins(req)
                if ret.is_unschedulable:
                    res[i] = 0
                elif ret.is_success and replicas < res[i]:
                    res[i] = replicas
        return res

    def get_unschedulable_replicas(
        self, workload_key: str, threshold_seconds: float, now: Optional[float] = None
    ) -> int:
        """Replicas of the workload pending longer than the threshold
        (server.go:228: owner-chained pods Pending > threshold)."""
        pending = self._pending.get(workload_key)
        if pending is None:
            return 0
        count, since = pending
        if now is None:
            now = self.clock.now() if self.clock else time.time()
        return count if now - since >= threshold_seconds else 0

    # -- pod placement simulation (member-side "kubelet/scheduler") -------

    def place(
        self,
        workload_key: str,
        replicas: int,
        request: Resources,
        now: Optional[float] = None,
        claim=None,
    ) -> int:
        """Greedy first-fit of `replicas` pods over claim-feasible nodes
        (taints/selector respected, like the real kube-scheduler would);
        returns how many fit. The remainder is recorded as pending (feeds
        GetUnschedulableReplicas); the pending-since timestamp survives
        re-placement so the unschedulable threshold can actually elapse."""
        prev_pending = self._pending.get(workload_key)
        self.unplace(workload_key)
        req = self.encoder.request_vector(request)
        a = self.arrays
        # claim feasibility reuses the deduped node_ok cache
        fake_req = ReplicaRequirements(node_claim=claim) if claim else None
        node_ok = self._node_ok(fake_req)
        n_placed, fits = first_fit_place(
            a.alloc, a.requested, a.pod_count, a.allowed_pods,
            node_ok, req.astype(np.int64), replicas,
        )
        self.version += 1
        placed = [
            (i, int(fits[i]), req) for i in np.nonzero(fits)[0]
        ]
        remaining = replicas - n_placed
        self._pods[workload_key] = placed
        if remaining > 0:
            if now is None:
                now = self.clock.now() if self.clock else time.time()
            since = prev_pending[1] if prev_pending else now
            self._pending[workload_key] = (remaining, since)
        else:
            self._pending.pop(workload_key, None)
        return replicas - remaining

    def unplace(self, workload_key: str) -> None:
        removed = self._pods.pop(workload_key, [])
        for i, count, req in removed:
            self.arrays.requested[i] -= req * count
            self.arrays.pod_count[i] -= count
        if removed:
            self.version += 1
        self._pending.pop(workload_key, None)
