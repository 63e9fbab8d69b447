"""Estimator client registry + min-merge (the port's copy of
estimator/client.py).

Parity with pkg/estimator/client (EST1/EST3): a pluggable registry of
ReplicaEstimator / UnschedulableReplicaEstimator implementations; the
scheduler takes the MIN across estimators per cluster, with
UnauthenticReplica = -1 meaning "discard my answer" (interface.go:27-55,
core/util.go:72-100). The in-process `MemberEstimators` adapter plays the
role of the per-cluster gRPC connection cache (accurate.go:34-68); its
per-round sweep over the whole fleet is one device kernel
(`kernels.fleet_estimate`), fed the round's distinct requests
(`distinct_requests`). The gRPC client and server are not ported.

The answer matrix makes the reference's round trip: the device sweep, the
host min-merge and degraded-mode overlay, then the upload inside
`ArrayScheduler.schedule(bindings, extra_avail=...)`.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Protocol, Sequence

import numpy as np

from .. import resolve_device
from ..api.work import ReplicaRequirements, ResourceBinding

UNAUTHENTIC_REPLICA = -1


class SchedulerEstimatorRegistry(Protocol):
    """What the scheduler daemon requires of an estimator registry — typed,
    so degraded-mode detection reads a declared attribute instead of
    duck-probing with getattr (the probe silently went dark whenever a
    registry forgot the attribute).

    `last_sweep_open` lists the member clusters whose circuit breaker was
    OPEN during the most recent `batch_estimates` sweep (empty while the
    fleet is healthy — the default for a registry that never degrades).
    Under the pipelined round executor each chunk-shard sweep resets it, so
    callers snapshot it immediately after the sweep that produced it."""

    last_sweep_open: list[str]

    def batch_estimates(
        self,
        bindings: Sequence["ResourceBinding"],
        clusters: Sequence[str],
    ) -> Optional[np.ndarray]:
        ...

    def sweep_round(self):
        """Context manager scoping N chunk-shard sweeps as ONE round (the
        pipelined executor's prefetch stage) — see EstimatorRegistry."""
        ...


class ReplicaEstimator(Protocol):
    def max_available_replicas(
        self,
        clusters: Sequence[str],
        requirements: Optional[ReplicaRequirements],
        replicas: int,
    ) -> list[int]:
        """Per-cluster estimate; UNAUTHENTIC_REPLICA to discard."""
        ...


class UnschedulableReplicaEstimator(Protocol):
    def get_unschedulable_replicas(
        self, clusters: Sequence[str], resource, threshold_seconds: float
    ) -> list[int]:
        """resource: api/work.ObjectReference (full GVK + name)."""
        ...


class EstimatorRegistry:
    """replicaEstimators / unschedulableReplicaEstimators registries
    (interface.go:38-55). The GeneralEstimator is fused into the schedule
    kernels; registered estimators contribute the extra min-merge term."""

    def __init__(self, breakers=None, staleness=None) -> None:
        """`breakers`: faults.BreakerRegistry shared with the estimator
        clients. When a member's breaker is open, its column of the [B,C]
        answer matrix is served from the staleness cache (last fresh
        answers decayed by faults/staleness.py) instead of the discard
        sentinel, so degraded rounds keep steering away from the dark
        member without stalling the batched solve."""
        self.replica_estimators: dict[str, ReplicaEstimator] = {}
        self.unschedulable_estimators: dict[str, UnschedulableReplicaEstimator] = {}
        self.breakers = breakers
        if staleness is None and breakers is not None:
            from ..faults.staleness import StalenessTracker

            staleness = StalenessTracker()
        self.staleness = staleness
        # per-sweep degraded bookkeeping (read by a round's degraded-rounds
        # accounting)
        self.last_sweep_open: list[str] = []
        self.last_sweep_stale: list[str] = []

    def sweep_round(self):
        """Scope a chunked round's N sweeps as ONE logical sweep for the
        staleness cache: fresh snapshots merge across the round's chunks and
        each open member's staleness epoch advances once per round, so a
        chunked degraded round serves exactly the penalized columns a
        whole-round sweep would."""
        from contextlib import contextmanager

        @contextmanager
        def scope():
            if self.staleness is None:
                yield
                return
            self.staleness.begin_round()
            try:
                yield
            finally:
                self.staleness.end_round()

        return scope()

    def register_replica_estimator(self, name: str, est: ReplicaEstimator) -> None:
        self.replica_estimators[name] = est

    def register_unschedulable_estimator(
        self, name: str, est: UnschedulableReplicaEstimator
    ) -> None:
        self.unschedulable_estimators[name] = est

    def batch_estimates(
        self,
        bindings: Sequence[ResourceBinding],
        clusters: Sequence[str],
    ) -> Optional[np.ndarray]:
        """extra_avail i32[B,C]: min across registered estimators, -1 where
        every estimator discarded (the schedule kernels min-merge this with
        the GeneralEstimator answer). None when no estimator is registered
        or no row is dynamic."""
        self.last_sweep_open = []
        self.last_sweep_stale = []
        if not self.replica_estimators:
            return None
        from ..models.batch import AGGREGATED, DYNAMIC_WEIGHT, strategy_code
        from ..sched.spread import should_ignore_spread_constraint

        B, C = len(bindings), len(clusters)
        # Only dynamic strategies consume availability; Duplicated/static
        # rows must not pay B x C estimator calls (core/util.go:63-70 skips
        # non-workloads; the reference only estimates inside dynamic assign).
        dyn_rows = [
            b
            for b, rb in enumerate(bindings)
            if strategy_code(rb.spec.placement, rb.spec.replicas)
            in (DYNAMIC_WEIGHT, AGGREGATED)
            # spread-constrained rows need availability for group scoring
            # regardless of strategy (group_clusters.go:143-330) — unless the
            # constraint is statically ignored (select_clusters.go:63-77)
            or (
                rb.spec.placement is not None
                and rb.spec.placement.spread_constraints
                and rb.spec.replicas > 0
                and not should_ignore_spread_constraint(rb.spec.placement)
            )
        ]
        if not dyn_rows:
            return None
        merged = np.full((B, C), np.iinfo(np.int32).max, np.int64)
        authentic = np.zeros((B, C), bool)

        def merge_row(b: int, res) -> None:
            row = np.asarray(res, np.int64)
            ok = row != UNAUTHENTIC_REPLICA
            merged[b] = np.where(ok, np.minimum(merged[b], row), merged[b])
            authentic[b] |= ok

        reqs = [bindings[b].spec.replica_requirements for b in dyn_rows]
        for est in self.replica_estimators.values():
            rows_fn = getattr(est, "max_available_replicas_rows", None)
            if rows_fn is not None:  # batched path: one sweep for all rows
                for b, res in zip(dyn_rows, rows_fn(clusters, reqs)):
                    merge_row(b, res)
            else:
                for b in dyn_rows:
                    merge_row(
                        b,
                        est.max_available_replicas(
                            clusters,
                            bindings[b].spec.replica_requirements,
                            bindings[b].spec.replicas,
                        ),
                    )
        out = np.where(authentic, merged, UNAUTHENTIC_REPLICA).astype(np.int32)
        if self.breakers is not None:
            self._overlay_stale_columns(bindings, clusters, out)
        return out

    def _overlay_stale_columns(self, bindings, clusters, out: np.ndarray) -> None:
        """Degraded-mode column repair: a member whose breaker is OPEN after
        this sweep answered the discard sentinel on its member legs — fold
        the staleness cache's decayed last-fresh answers into its column.
        Healthy columns refresh the cache and reset their staleness epoch.

        The fold is a MIN-merge, not an overwrite: other registered
        estimators may still be answering live for this cluster, and stale
        member data may only TIGHTEN or fill a live bound — a decayed
        snapshot must never loosen one."""
        # ONE shared tuple per sweep: the staleness snapshots alias it, so
        # the unchanged-binding-set fast path is an identity check
        uids = tuple(rb.metadata.uid for rb in bindings)
        for j, c in enumerate(clusters):
            br = self.breakers.get(c)
            if br is not None and br.is_open:
                self.last_sweep_open.append(c)
                col = self.staleness.fill_stale(c, uids)
                if col is not None:
                    cur = out[:, j]
                    out[:, j] = np.where(
                        cur >= 0,
                        np.where(col >= 0, np.minimum(cur, col), cur),
                        col,
                    )
                    self.last_sweep_stale.append(c)
            elif (out[:, j] != UNAUTHENTIC_REPLICA).any():
                # an all-sentinel column under a CLOSED breaker is a blip
                # (or a row set with nothing to estimate) — never wipe the
                # last-fresh cache for it
                self.staleness.record_fresh(c, uids, out[:, j])

    def min_unschedulable(
        self,
        clusters: Sequence[str],
        resource,
        threshold_seconds: float,
    ) -> list[int]:
        """Min across unschedulable estimators (descheduler/core/helper.go:62-96)."""
        C = len(clusters)
        merged = [np.iinfo(np.int32).max] * C
        authentic = [False] * C
        for est in self.unschedulable_estimators.values():
            res = est.get_unschedulable_replicas(clusters, resource, threshold_seconds)
            for i, v in enumerate(res):
                if v != UNAUTHENTIC_REPLICA:
                    merged[i] = min(merged[i], v)
                    authentic[i] = True
        return [m if a else 0 for m, a in zip(merged, authentic)]


def distinct_requests(enc, requirements_list):
    """The rows' request vectors as a table of distinct ones, in order of
    first appearance, and each row's index into it: (request_u i64[U, R],
    req_idx i32[B]), `request_u[req_idx]` the [B, R] request matrix. A
    round's rows carry few distinct requests (they come from policies)."""
    table: dict[bytes, int] = {}
    rows, idx = [], np.empty(len(requirements_list), np.int32)
    for i, r in enumerate(requirements_list):
        vec = np.asarray(enc.request_vector(r.resource_request if r else {}), np.int64)
        j = table.setdefault(vec.tobytes(), len(rows))
        if j == len(rows):
            rows.append(vec)
        idx[i] = j
    request_u = np.stack(rows) if rows else np.zeros((0, len(enc.resources)), np.int64)
    return request_u, idx


class MemberEstimators:
    """In-process adapter: routes estimator calls to each member's
    AccurateEstimator (`members` maps a cluster name to any object with a
    `node_estimator` attribute) with concurrent fan-out
    (accurate.go:139-162's goroutine-per-cluster becomes a thread pool;
    members without node state answer the -1 sentinel). Answers merge in
    cluster order, never in completion order.

    The per-round sweep (`max_available_replicas_rows`) runs as ONE device
    kernel over the whole fleet's concatenated node arrays
    (`kernels.fleet_estimate`) whenever no row carries a node claim and no
    fault guard is engaged. The node arrays are uploaded once per
    membership and estimator version, in cluster order with each cluster's
    node range beside them, so steady rounds ship only the table of the
    round's distinct requests [U, R] and each row's index into it, and the
    card evaluates each distinct request once.

    `max_workers` pins the per-cluster fan-out pool size; the default
    (None) scales with each sweep's fan-out width (floor
    DEFAULT_MIN_WORKERS, cap DEFAULT_MAX_WORKERS), growing as members join.
    `device`: None means the CUDA card (RuntimeError without one); "cpu"
    runs the fleet sweep's plain version."""

    DEFAULT_MIN_WORKERS = 16
    DEFAULT_MAX_WORKERS = 64

    def __init__(self, members: dict, breakers=None,
                 max_workers: Optional[int] = None, device=None):
        self.members = members
        self.breakers = breakers  # faults.BreakerRegistry, shared
        if max_workers is not None and max_workers <= 0:
            raise ValueError(f"max_workers={max_workers}: must be positive")
        self.max_workers = max_workers
        self.device = resolve_device(device)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_width = 0
        self._fleet_key = None
        # (alloc, requested, pod_count, allowed, cluster_id on the device,
        # the cluster count, claimless_ok on the device)
        self._fleet_dev = None
        self._fleet_off = None  # i32[C + 1] on the device: each cluster's node range
        self._no_node_cols = None  # bool[C] clusters without node state

    def _pool_for(self, width: int) -> ThreadPoolExecutor:
        """The fan-out pool, (re)sized for a sweep over `width` clusters:
        explicit max_workers pins it; the default grows with the widest
        sweep seen, replacing the executor only when it must widen."""
        want = self.max_workers or min(
            self.DEFAULT_MAX_WORKERS, max(self.DEFAULT_MIN_WORKERS, width)
        )
        if self._pool is None or want > self._pool_width:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool = ThreadPoolExecutor(max_workers=want)
            self._pool_width = want
        return self._pool

    def close(self) -> None:
        """Stop the fan-out pool's threads."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
            self._pool_width = 0

    def _estimator_for(self, cluster: str):
        member = self.members.get(cluster)
        return getattr(member, "node_estimator", None) if member else None

    def _guarded(self, cluster: str, fn, sentinel):
        """One member-estimator leg under the fault policy: the in-process
        stand-in for the gRPC boundary — breaker admission, chaos injection
        (BOUNDARY_GRPC), typed failure metric, breaker feedback. Failures
        answer `sentinel`, never raise (per-cluster error isolation, like
        the wire client)."""
        from .. import faults
        from ..metrics import estimator_rpc_errors

        br = self.breakers.for_member(cluster) if self.breakers is not None else None
        if br is not None and not br.allow():
            return sentinel
        try:
            faults.check(faults.BOUNDARY_GRPC, cluster)
            out = fn()
        except faults.InjectedFault as e:
            estimator_rpc_errors.inc(cluster=cluster, code=e.code)
            if br is not None:
                br.record_failure()
            return sentinel
        except Exception:  # noqa: BLE001 - degrade per cluster, don't fail sweep
            estimator_rpc_errors.inc(cluster=cluster, code="MEMBER_ERROR")
            if br is not None:
                br.record_failure()
            return sentinel
        if br is not None:
            br.record_success()
        return out

    def _guards_engaged(self, clusters) -> bool:
        """True when the per-cluster boundary must be exercised (a fault
        plan with grpc-boundary rules is installed, or any breaker is not
        at rest): the fleet kernel bypasses member boundaries, so those
        sweeps route per cluster instead. A plan that only targets other
        boundaries leaves the one-launch path alone."""
        from .. import faults
        from ..faults.policy import CLOSED

        inj = faults.active()
        if inj is not None and inj.plan.has_boundary(faults.BOUNDARY_GRPC):
            return True
        if self.breakers is None:
            return False
        return any(
            br is not None and br.state != CLOSED
            for br in (self.breakers.get(c) for c in clusters)
        )

    def max_available_replicas(self, clusters, requirements, replicas) -> list[int]:
        def one(cluster: str) -> int:
            est = self._estimator_for(cluster)
            if est is None:
                return UNAUTHENTIC_REPLICA
            return self._guarded(
                cluster,
                lambda: est.max_available_replicas(requirements),
                UNAUTHENTIC_REPLICA,
            )

        return list(self._pool_for(len(clusters)).map(one, clusters))

    def _fleet_snapshot(self, clusters):
        """Concatenated node arrays for the fleet kernel, in cluster order,
        rebuilt and uploaded (pinned) only when membership or any
        estimator's (uid, version) changes; None when a member's estimator
        runs plugins (their answers are not node math) or no member has
        nodes — those sweeps take the per-cluster path."""
        from ..sched.core import to_device

        ests = [self._estimator_for(c) for c in clusters]
        if any(e is not None and e.framework is not None for e in ests):
            return None
        key = tuple(
            (c, e.uid, e.version) if e is not None else (c, -1, -1)
            for c, e in zip(clusters, ests)
        )
        if key == self._fleet_key:
            return self._fleet_dev
        allocs, reqs, pods, allowed, cids, oks = [], [], [], [], [], []
        no_node = np.zeros(len(clusters), bool)
        counts = np.zeros(len(clusters), np.int64)
        for ci, e in enumerate(ests):
            if e is None:
                no_node[ci] = True
                continue
            a = e.arrays
            if a.n_nodes == 0:
                continue
            counts[ci] = a.n_nodes
            allocs.append(a.alloc)
            reqs.append(a.requested)
            pods.append(a.pod_count)
            allowed.append(a.allowed_pods)
            cids.append(np.full(a.n_nodes, ci, np.int32))
            # claim-free node feasibility (taints still filter nodes,
            # exactly like the per-cluster path's _node_ok(None))
            oks.append(e._node_ok(None))
        if not allocs:
            return None
        dev = [to_device(np.concatenate(x).astype(np.int64), self.device)
               for x in (allocs, reqs, pods, allowed)]
        dev += [to_device(np.concatenate(cids), self.device), len(clusters),
                to_device(np.concatenate(oks), self.device)]
        self._fleet_dev = tuple(dev)
        # the nodes are concatenated in cluster order: each cluster's range
        # comes from the counts, so the card needs no sort per sweep
        off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        self._fleet_off = to_device(off, self.device)
        self._no_node_cols = no_node
        self._fleet_key = key
        return self._fleet_dev

    def max_available_replicas_rows(self, clusters, requirements_list):
        """Batched per-round sweep: [B][C] answers. Clusters without node
        state are discarded via the sentinel."""
        claimless = all(r is None or r.node_claim is None for r in requirements_list)
        # the fleet kernel fuses every member into one launch, which skips
        # the per-member boundary — with a chaos plan installed or a breaker
        # not at rest, route per cluster so faults and breakers apply
        fleet = (
            self._fleet_snapshot(clusters)
            if claimless and not self._guards_engaged(clusters) else None
        )
        if fleet is not None:
            from .. import kernels
            from ..models.nodes import NodeEncoder
            from ..sched.core import to_device

            request_u, req_idx = distinct_requests(NodeEncoder(), requirements_list)
            # rows that are all distinct are the table itself (no index)
            idx = None if len(request_u) == len(req_idx) else to_device(req_idx, self.device)
            out = kernels.fleet_estimate(*fleet, to_device(request_u, self.device),
                                         req_idx=idx, node_off=self._fleet_off)
            rows = out.cpu().numpy()
            if self._no_node_cols.any():
                rows = np.where(self._no_node_cols[None, :], UNAUTHENTIC_REPLICA, rows)
            return rows

        def one(cluster: str) -> list[int]:
            sentinel = [UNAUTHENTIC_REPLICA] * len(requirements_list)
            est = self._estimator_for(cluster)
            if est is None:
                return sentinel
            return self._guarded(
                cluster,
                lambda: est.max_available_replicas_batch(requirements_list),
                sentinel,
            )

        columns = list(self._pool_for(len(clusters)).map(one, clusters))  # [C][B]
        return np.asarray(columns, np.int64).reshape(len(clusters), len(requirements_list)).T

    def get_unschedulable_replicas(self, clusters, resource, threshold_seconds) -> list[int]:
        key = f"{resource.kind}/{resource.namespace}/{resource.name}"

        def one(cluster: str) -> int:
            est = self._estimator_for(cluster)
            if est is None:
                return UNAUTHENTIC_REPLICA
            return self._guarded(
                cluster,
                lambda: est.get_unschedulable_replicas(key, threshold_seconds),
                UNAUTHENTIC_REPLICA,
            )

        return list(self._pool_for(len(clusters)).map(one, clusters))
