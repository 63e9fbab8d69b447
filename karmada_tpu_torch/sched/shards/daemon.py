"""ShardedDaemon + ShardPlane: N concurrent streaming leaders, one slice each
(the port's copy of the reference's sched/shards/daemon.py).

`ShardedDaemon` is a SchedulerDaemon whose ownership predicate is the
rendezvous shard map: it admits (and therefore solves and patches) only
the bindings whose ns/uid hashes to its slot. Everything else — the solve,
the prewarm lattice, the micro-batch pipeline, the patch path — is the
parent's machinery untouched; sharding changes WHICH keys admit, never how
they schedule. Gang cohorts route through the cross-shard commit protocol
(gangs.py) instead of the local coordinator whenever more than one shard
exists.

Handoff discipline (the exactly-once story, pinned by the shard tests):

- The shard map swap is atomic (plain attribute assignment); from that
  instant the admission gate — which `_patch_result` re-checks under the
  store's serialization — answers with the NEW map. A losing shard's
  in-flight decision that reaches the writer after the swap re-gates to
  "drop" and vetoes; one that committed before the swap is a normal
  placement the gaining shard observes as clean. There is no interleaving
  in which two shards both patch the same binding for one admission epoch.
- The losing side additionally FENCES the moving keyspace (admission
  epoch bump per moved key — any decision still mid-pipeline discards at
  the epoch check) and forgets the keys' queue bookkeeping; the gaining
  side re-admits level-triggered from a store re-list.
- Across processes the same argument holds with the lease fencing token
  in place of the in-process gate: a deposed shard leader's batch writes
  bounce on the store's fence, and its successor re-lists.

`ShardPlane` hosts one full leader stack per shard in a single process —
daemon + StreamingScheduler + per-shard elector on the
`karmada-sched-shard-<i>` lease — which is the bench/test topology and a
legitimate single-box deployment (the per-process topology runs one
`python -m karmada_tpu_torch.sched --scheduler-shards N --shard-index i`
per slot instead). The plane owns the shared cross-shard estimator fairness
budget and the shard status objects `karmadactl get shards` renders.

The port's differences, none of which changes a decision: `device=` (None
means the CUDA card, resolved once by the plane, so a plane built without
one raises RuntimeError at construction; "cpu" runs the plain path); on
the card each stack's serve thread runs in a CUDA stream of its own (the
rounds follow the caller's stream, so no shard's copies back wait for the
kernels its siblings queued), and `ShardPlane.start()` builds every
kernel library once before the stacks start, so N leaders do not enter
nvcc together inside their first rounds.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import torch

from ... import resolve_device
from ...api.meta import ObjectMeta
from ...api.sharding import (
    KIND_SCHEDULER_SHARD,
    SHARD_NAMESPACE,
    SchedulerShard,
    ShardStatus,
    shard_lease_name,
    shard_object_name,
)
from ...metrics import shard_bindings, shard_handoffs, shard_queue_depth
from ...store.store import DELETED, MODIFIED, ConflictError
from ..scheduler import SchedulerDaemon
from .fairness import ClusterFairnessBudget
from .gangs import CrossShardGangs
from .shardmap import ShardMap, shard_of_binding

log = logging.getLogger(__name__)

# shard-status publish throttle: transitions publish immediately; the
# steady-state refresh rides the serve loop's idle tick at most this often
_STATUS_INTERVAL = 0.5


class ShardedDaemon(SchedulerDaemon):
    """A SchedulerDaemon that owns one rendezvous shard of the binding
    keyspace. Construct with the slot coordinates; every other argument
    passes through to SchedulerDaemon."""

    def __init__(self, store, runtime, shard_index: int, shards_total: int,
                 **kwargs) -> None:
        # the map must exist BEFORE super().__init__: the parent's watch
        # subscription replays the store through _on_binding, which gates
        # on _owns immediately
        self.shards = ShardMap(shard_index, shards_total)
        # owned-keyspace index (key -> True), maintained by _on_binding:
        # the O(1) source for the shard_bindings gauge and the status view
        self._owned: dict[str, bool] = {}
        super().__init__(store, runtime, **kwargs)
        self.shard_id = str(shard_index)
        self.xshards = CrossShardGangs(self)
        self._status_stamp = 0.0
        self._handoff_state = ""
        self._last_solve_time = 0.0

    # -- ownership ---------------------------------------------------------

    def _owns(self, rb) -> bool:
        return self.shards.mine(rb)

    def _gang_holds(self, rb) -> str:
        # cross-shard cohorts cannot assemble in one queue: members admit
        # as solo rows; gangs.py supplies the all-or-nothing commit
        if self.shards.total > 1:
            return ""
        return self._gang_of(rb)

    def _patch_gang(self, gname: str, items):
        if self.shards.total <= 1:
            return super()._patch_gang(gname, items)
        # publish this shard's solved members; the coordinator commits.
        # False = "not patched here": streaming keeps the admission
        # stretch pending until the coordinator's outcome lands
        self.xshards.publish(gname, items)
        return [False] * len(items)

    def _patch_results(self, items, gang_sink=None):
        self._last_solve_time = self.clock.now()
        return super()._patch_results(items, gang_sink=gang_sink)

    def _on_binding(self, event: str, rb) -> None:
        key = rb.metadata.key()
        if event == DELETED or rb.metadata.deletion_timestamp is not None:
            self._owned.pop(key, None)
        elif self._owns(rb):
            self._owned[key] = True
        else:
            self._owned.pop(key, None)
        super()._on_binding(event, rb)

    def owned_count(self) -> int:
        return len(self._owned)

    # -- handoff -----------------------------------------------------------

    def _list_bindings_retried(self):
        """The resize/relist sweep over the wire: a map-resize or leader
        takeover that died on ONE transient store error would strand its
        slice of the keyspace un-readmitted (the soak's shard-kill wave
        hits exactly this against a faulted apiserver). Transport errors
        retry under full jitter; anything else is terminal and escapes
        immediately."""
        from ...faults.policy import RetryPolicy

        def transient(e: Exception) -> bool:
            from ...server.remote import RemoteError
            from ...store.store import ConflictError, NotFoundError

            return isinstance(e, RemoteError) and not isinstance(
                e, (ConflictError, NotFoundError))

        policy = RetryPolicy(base_delay=0.1, max_delay=2.0,
                             max_attempts=6, deadline=20.0)
        return policy.run(
            lambda: self.store.list("ResourceBinding"), transient)

    def set_total(self, new_total: int, reason: str = "resize") -> int:
        """Resize the shard map in place. The swap is atomic; the moved
        keyspace is fenced off the losing side (epoch bump + queue forget)
        and re-admitted level-triggered on the gaining side. Returns the
        number of bindings that moved relative to this slot."""
        old = self.shards
        if new_total == old.total:
            return 0
        if old.index >= new_total:
            raise ValueError(
                f"shard {old.index} does not exist at total={new_total}; "
                f"retire the stack instead of resizing it")
        new = ShardMap(old.index, new_total)
        self._handoff_state = "draining" if new_total < old.total \
            else "absorbing"
        self.shards = new  # the gate answers with the new map from here on
        moved = 0
        try:
            for rb in self._list_bindings_retried():
                was = shard_of_binding(rb, old.total) == old.index
                now = new.mine(rb)
                if was == now:
                    continue
                moved += 1
                key = rb.metadata.key()
                if was:
                    # losing: fence any in-flight decision (epoch bump) and
                    # drop the queue's per-key bookkeeping; the gaining
                    # shard owns the key's future
                    self._owned.pop(key, None)
                    if self.admission.enabled:
                        self.admission.invalidate(key)
                    self.controller.queue.forget(key)
                else:
                    # gaining: level-triggered re-admission through the
                    # ordinary event path (notes the epoch, enqueues)
                    self._on_binding(MODIFIED, rb)
        finally:
            # even a retry-exhausted sweep must not leave the daemon
            # claiming a handoff is still in flight
            self._handoff_state = ""
        if moved:
            shard_handoffs.inc(float(moved), reason=reason)
        return moved

    def relist(self) -> int:
        """Leader-takeover re-admission: enqueue every owned binding
        level-triggered, so work the deposed leader had in flight (whose
        patches the fence bounced) re-places under this leader. Counted
        as a takeover handoff."""
        n = 0
        for rb in self._list_bindings_retried():
            if rb.metadata.deletion_timestamp is None and self._owns(rb):
                self._on_binding(MODIFIED, rb)
                n += 1
        if n:
            shard_handoffs.inc(float(n), reason="takeover")
        return n

    # -- status surface ----------------------------------------------------

    def publish_status(self, leader: str = "", token: int = 0,
                       force: bool = False) -> None:
        """Write (or refresh) this shard's SchedulerShard object — the
        `karmadactl get shards` row — and its gauge series. Throttled;
        transitions pass force=True."""
        now = time.monotonic()
        if not force and now - self._status_stamp < _STATUS_INTERVAL:
            return
        self._status_stamp = now
        depth = len(self.controller.queue)
        owned = self.owned_count()
        shard_bindings.set(float(owned), shard=self.shard_id)
        shard_queue_depth.set(float(depth), shard=self.shard_id)
        status = ShardStatus(
            leader=leader,
            fencing_token=token,
            epoch=self.admission.last_epoch(),
            queue_depth=depth,
            bindings=owned,
            last_solve_time=getattr(self, "_last_solve_time", 0.0),
            handoff=self._handoff_state,
            shards_total=self.shards.total,
        )
        name = shard_object_name(self.shards.index)
        try:
            cur = self.store.try_get(KIND_SCHEDULER_SHARD, name,
                                     SHARD_NAMESPACE)
            if cur is None:
                self.store.create(SchedulerShard(
                    metadata=ObjectMeta(name=name, namespace=SHARD_NAMESPACE),
                    status=status,
                ))
            else:
                cur.status = status
                self.store.update(cur)
        except ConflictError:
            pass  # a sibling published concurrently; next tick wins
        except Exception:  # noqa: BLE001 - status is best-effort
            log.exception("shard %s status publish", self.shard_id)

    def retire_status(self) -> None:
        """Remove the shard's gauge rows and status object (a retired
        shard must not leave stale series behind)."""
        shard_bindings.remove(shard=self.shard_id)
        shard_queue_depth.remove(shard=self.shard_id)
        try:
            self.store.delete(KIND_SCHEDULER_SHARD,
                              shard_object_name(self.shards.index),
                              SHARD_NAMESPACE)
        except Exception:  # noqa: BLE001 - already gone is fine
            pass

    def detach(self) -> None:
        """Unsubscribe the daemon's watches and stop the cross-shard
        worker (plane shutdown / stack retirement)."""
        self.xshards.detach()
        try:
            self.store.unwatch("ResourceBinding", self._on_binding)
            self.store.unwatch("Cluster", self._on_cluster)
        except Exception:  # noqa: BLE001 - double-detach is fine
            pass


class _ShardStack:
    """One shard's full leader stack inside a ShardPlane: daemon +
    streaming service + elector + serve thread."""

    def __init__(self, plane: "ShardPlane", index: int) -> None:
        from ...coordination.elector import Elector
        from ...coordination.lease import LeaseCoordinator
        from ...runtime.controller import Runtime

        self.plane = plane
        self.index = index
        self.runtime = Runtime(plane.clock)
        self.daemon = ShardedDaemon(
            plane.store, self.runtime, index, plane.total,
            scheduler_name=plane.scheduler_name,
            estimator_registry=plane.registry_factory(index)
            if plane.registry_factory else None,
            gates=plane.gates,
            gang_wait_seconds=plane.gang_wait_seconds,
            aot_prewarm=plane.aot_prewarm,
            device=plane.device,
        )
        # the serve thread's own CUDA stream (None on the CPU)
        self.stream = (torch.cuda.Stream(plane.device)
                       if plane.device.type == "cuda" else None)
        reg = self.daemon.estimator_registry
        if reg is not None:
            # the shared budget: every shard's per-cluster estimator legs
            # draw from ONE pool per member cluster
            for est in getattr(reg, "replica_estimators", {}).values():
                if hasattr(est, "fairness"):
                    est.fairness = plane.fairness
        self.service = self.daemon.streaming(**plane.streaming_kwargs)
        self.leading = threading.Event()
        self.stop_evt = threading.Event()
        self.token = 0
        self.elector: Optional[object] = None
        if plane.elect:
            from ...coordination.elector import LocalLeaseClient

            if hasattr(plane.store, "acquire_lease"):
                # the store already speaks the lease-client protocol
                # (RemoteStore in the daemon deployment shape): elections go
                # through the apiserver's lease routes, same as sched
                # __main__ — NOT raw object CAS against a remote store
                lease_client = plane.store
            else:
                coordinator = LeaseCoordinator(plane.store, clock=plane.clock)
                lease_client = LocalLeaseClient(coordinator)
            self.elector = Elector(
                lease_client,
                shard_lease_name(index),
                f"{plane.identity}-s{index}",
                lease_duration=plane.lease_duration,
                on_started_leading=self._started,
                on_stopped_leading=self._stopped,
            )
        self.thread = threading.Thread(
            target=self._run, name=f"shard-serve-{index}", daemon=True
        )

    def _started(self, token: int) -> None:
        self.token = token
        self.daemon.abandon_prewarm()
        self.daemon.xshards.start()
        self.daemon.relist()
        self.leading.set()
        self.daemon.publish_status(
            leader=self.elector.identity if self.elector else "local",
            token=token, force=True,
        )

    def _stopped(self, reason: str) -> None:
        self.leading.clear()
        self.token = 0
        self.daemon.xshards.stop()
        self.daemon.publish_status(force=True)

    def start(self) -> None:
        if self.elector is not None:
            self.elector.step()
            self.elector.run()
        else:
            self._started(0)
        self.thread.start()

    def _run(self) -> None:
        with torch.cuda.stream(self.stream):
            self._serve_loop()

    def _serve_loop(self) -> None:
        while not self.stop_evt.is_set():
            if self.leading.is_set():
                try:
                    self.service.serve(
                        should_stop=lambda: (
                            not self.leading.is_set()
                            or self.stop_evt.is_set()
                        ),
                        idle=self._idle,
                    )
                except Exception:  # noqa: BLE001 - survive transients
                    log.exception("shard %d streaming service", self.index)
                    self.stop_evt.wait(0.2)
            else:
                self.stop_evt.wait(0.05)

    def _idle(self) -> None:
        self.daemon.publish_status(
            leader=self.elector.identity if self.elector else "local",
            token=self.token,
        )

    def stop(self, retire: bool = False) -> None:
        self.stop_evt.set()
        self.leading.clear()
        self.service.stop()
        if self.elector is not None:
            self.elector.stop(release=True)
        self.thread.join(timeout=10.0)
        self.daemon.xshards.stop()
        if retire:
            self.daemon.retire_status()
        self.daemon.detach()


class ShardPlane:
    """The in-process host: one _ShardStack per shard slot over a shared
    store. `resize()` re-maps the keyspace through the handoff fence;
    shrinking retires the dropped slots (status objects deleted, gauge
    rows removed)."""

    def __init__(
        self,
        store,
        total: int,
        *,
        clock=None,
        scheduler_name: str = "default-scheduler",
        registry_factory=None,  # index -> EstimatorRegistry (per shard)
        gates=None,
        gang_wait_seconds: Optional[float] = None,
        aot_prewarm: bool = False,
        elect: bool = True,
        lease_duration: float = 5.0,
        identity: str = "shardplane",
        fairness_limit: int = 4,
        device=None,  # None = the CUDA card (RuntimeError without one)
        **streaming_kwargs,
    ) -> None:
        if total < 1:
            raise ValueError("shard total must be >= 1")
        from ...runtime.controller import Clock

        self.device = resolve_device(device)
        self.store = store
        self.total = total
        self.clock = clock or Clock()
        self.scheduler_name = scheduler_name
        self.registry_factory = registry_factory
        self.gates = gates
        self.gang_wait_seconds = gang_wait_seconds
        self.aot_prewarm = aot_prewarm
        self.elect = elect
        self.lease_duration = lease_duration
        self.identity = identity
        self.fairness = ClusterFairnessBudget(fairness_limit)
        self.streaming_kwargs = streaming_kwargs
        self.stacks: list[_ShardStack] = [
            _ShardStack(self, i) for i in range(total)
        ]

    def start(self) -> None:
        if self.device.type == "cuda":
            from ...kernels.build import build_all

            build_all()  # once, before any leader's first round
        for s in self.stacks:
            s.start()

    def wait_leading(self, timeout: float = 10.0) -> bool:
        """Block until every shard has a leader (bench/test setup)."""
        deadline = time.monotonic() + timeout
        for s in self.stacks:
            if not s.leading.wait(max(0.0, deadline - time.monotonic())):
                return False
        return True

    def resize(self, new_total: int) -> int:
        """Change the shard count in place. Every surviving stack swaps
        its map (fencing + re-admitting its side of the moved keyspace);
        new slots spin up cold and retired slots drain out. Returns total
        keyspace movement observed across surviving shards."""
        if new_total < 1:
            raise ValueError("shard total must be >= 1")
        old_total = self.total
        if new_total == old_total:
            return 0
        moved = 0
        if new_total < old_total:
            # retiring slots first: their keys re-admit on the survivors
            # (whose maps still cover them) only after the swap below, so
            # stop the leaders before any survivor claims the keyspace
            for s in self.stacks[new_total:]:
                s.stop(retire=True)
            self.stacks = self.stacks[:new_total]
        self.total = new_total
        for s in self.stacks:
            moved += s.daemon.set_total(new_total)
        if new_total > old_total:
            for i in range(old_total, new_total):
                stack = _ShardStack(self, i)
                self.stacks.append(stack)
                stack.start()
        return moved

    def quiesce(self, timeout: float = 60.0) -> bool:
        """Wait until every shard's queue is empty and nothing is
        mid-pipeline (the bench's drain barrier). Also drives the
        cross-shard gang coordinators so cohorts resolve (their workers
        run while each shard leads)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            busy = False
            for s in self.stacks:
                q = s.daemon.controller.queue
                snap = s.service.stats_snapshot()
                if len(q) or snap["formed"] != snap["batches"]:
                    busy = True
            if not busy:
                return True
            time.sleep(0.01)
        return False

    def stats(self) -> dict:
        out = {}
        for s in self.stacks:
            out[s.index] = s.service.stats_snapshot()
        return out

    def close(self) -> None:
        for s in self.stacks:
            s.stop(retire=True)
