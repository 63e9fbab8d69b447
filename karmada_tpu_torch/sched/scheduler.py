"""Scheduler daemon: the host loop around the batched device solve.

Parity with pkg/scheduler/scheduler.go: watches ResourceBindings + Clusters
(event_handler.go:46,94-120 filters: schedulerName, scheduling suspension),
decides WHETHER each binding needs scheduling (doScheduleBinding:375-443 — the
four triggers: applied-placement changed :401, replicas changed :408,
reschedule triggered :415, Duplicated refresh :422), then — unlike the
reference's one-at-a-time loop — drains every dirty binding into ONE
ArrayScheduler batch (BatchingController), and patches results + conditions
(patchScheduleResultForResourceBinding:627-651, condition updates :913-961).

Cluster add/update/delete re-encodes the device fleet and re-enqueues all
bindings (reconcileCluster/enqueueAffectedBindings event_handler.go:313-368);
idempotent no-op writes make the fixpoint terminate.

The port's copy of the JAX package's `sched/scheduler.py`, over the port's
own store, runtime, queues, metrics and spans. It differs in three places:
`device=` (None means the CUDA card, resolved at construction, so a daemon
built without one raises RuntimeError at once; "cpu" runs the plain
path), the prewarm's background pass builds every kernel library
(`kernels.build.build_all()`) where the reference walks XLA's bucket
lattice, and the round's materialize halves run in the caller's CUDA
stream even when a writer thread runs them (a stream is current per
thread).
"""
from __future__ import annotations

import json
from dataclasses import asdict
from typing import Optional

import torch

from .. import resolve_device
from ..api.meta import Condition, set_condition
from ..api.policy import DEFAULT_SCHEDULER_NAME, REPLICA_SCHEDULING_DUPLICATED
from ..api.work import (
    CONDITION_SCHEDULED,
    EVICTION_PRODUCER_PREEMPTION,
    EVICTION_REASON_PREEMPTED,
    GracefulEvictionTask,
    POLICY_PLACEMENT_ANNOTATION,
    REASON_BINDING_SCHEDULED,
    REASON_GANG_TIMEOUT,
    REASON_GANG_UNSCHEDULABLE,
    REASON_SCHEDULE_FAILED,
    REASON_UNSCHEDULABLE,
    ResourceBinding,
)
from ..features import FeatureGates, PRIORITY_BASED_SCHEDULING
from ..metrics import (
    degraded_rounds,
    e2e_scheduling_duration,
    gang_admissions,
    preemption_victims,
    preemptions_total,
    queue_incoming_bindings,
    schedule_attempts,
    scheduling_algorithm_duration,
    timed,
)
from ..runtime.controller import BatchingController, Runtime
from ..store.store import DELETED, MODIFIED, Store
from ..tracing import tracer
from .core import ArrayScheduler, ScheduleDecision
from .queue import GangCoordinator, PrioritySchedulingQueue


def read_bindings(store, keys: list[str]) -> list[Optional[ResourceBinding]]:
    """The bindings of `keys` ("namespace/name"), None where gone: one
    `get_batch` (one lock hold in process; one request per 256 keys over
    the wire). The reference's drains read each key with `try_get`; the
    objects read are the same."""
    return store.get_batch("ResourceBinding",
                           [(k.partition("/")[2], k.partition("/")[0]) for k in keys])


def placement_json(placement) -> str:
    if placement is None:
        return ""
    return json.dumps(asdict(placement), sort_keys=True, default=str)


# sentinel: "no batch-read snapshot — do the per-binding try_get"
_UNREAD = object()


class AdmissionLog:
    """Per-binding admission bookkeeping for the streaming scheduler
    (sched/streaming.py). Two facts per key, both bumped by the watch
    handlers the moment an event enqueues the binding:

    - a monotonically increasing dirty EPOCH — the staleness fence: a
      micro-batch snapshots each binding's epoch BEFORE reading its spec,
      and the patch stage discards any in-flight decision whose binding
      moved past the snapshot (it dirtied mid-flight; the bumping event
      already re-enqueued the key, so the binding re-admits with the
      fresh spec);
    - the ADMITTED-AT timestamp the placement-latency histogram measures
      from: the FIRST event of the current pending stretch (coalesced
      re-events while the key waits do not reset the clock — the binding
      has been dirty since the first one).

    Disabled (`enabled=False`) outside streaming mode so the batch daemon
    pays no bookkeeping and the maps cannot grow in a mode that never
    clears them."""

    def __init__(self) -> None:
        import itertools
        import threading

        self.enabled = False
        self._lock = threading.Lock()
        # epochs come from ONE process-global counter, not per-key counts:
        # forget() may drop a key's entry while a snapshot of it is still
        # in flight (delete→recreate of the same ns/name), and a per-key
        # count restarting at 1 could collide with that old snapshot and
        # let a stale decision patch the recreated binding
        self._gen = itertools.count(1)
        self._epoch: dict[str, int] = {}
        self._admitted: dict[str, float] = {}

    def note(self, key: str, now: float, uid: str = "") -> None:
        with self._lock:
            epoch = next(self._gen)
            self._epoch[key] = epoch
            self._admitted.setdefault(key, now)
        # distributed tracing (tracing/spans.py): the admission IS the
        # trace's (uid, epoch) key — setdefault semantics inside admit()
        # mirror _admitted, so coalesced re-events share one trace
        tracer.admit(key, uid or key, epoch)

    def invalidate(self, key: str) -> None:
        """Fence off any in-flight decision for `key` WITHOUT starting a
        new pending stretch: events that stop scheduling rather than
        request it (suspension, scheduler_name re-target, deletion) must
        still move the epoch — the in-flight decision was computed on the
        pre-event spec — but there is nothing to measure a placement
        latency against."""
        with self._lock:
            self._epoch[key] = next(self._gen)
            self._admitted.pop(key, None)
        tracer.settle(key)

    def epoch(self, key: str) -> int:
        with self._lock:
            return self._epoch.get(key, 0)

    def last_epoch(self) -> int:
        """Highest admission epoch currently tracked — the shard status
        view's EPOCH column (observational; forgotten keys drop out)."""
        with self._lock:
            return max(self._epoch.values(), default=0)

    def observe_patch(self, key: str, now: float) -> Optional[float]:
        """Latency of the patch that just landed (admission → patch);
        clears the pending stretch. None when nothing was pending. The
        daemon's own patch re-notes the key (its store write is a watch
        event) BEFORE this pop runs on the same thread, and setdefault
        keeps the original timestamp — so the pop both measures from the
        true first admission and retires the self-inflicted note."""
        with self._lock:
            t0 = self._admitted.pop(key, None)
        return None if t0 is None else max(0.0, now - t0)

    def settle(self, key: str) -> None:
        """A drained key needed no scheduling: the pending stretch (if
        any — e.g. the daemon's own patch event) resolves un-measured."""
        with self._lock:
            self._admitted.pop(key, None)
        tracer.settle(key)

    def forget(self, key: str) -> None:
        with self._lock:
            self._epoch.pop(key, None)
            self._admitted.pop(key, None)
        tracer.forget(key)


class SchedulerDaemon:
    def __init__(
        self,
        store: Store,
        runtime: Runtime,
        scheduler_name: str = DEFAULT_SCHEDULER_NAME,
        # estimator.client.SchedulerEstimatorRegistry: the typed contract —
        # batch_estimates + the last_sweep_open degraded-sweep attribute
        estimator_registry=None,
        gates: Optional[FeatureGates] = None,
        event_recorder=None,
        plugins=None,  # the --plugins list: "*" / "foo" / "-foo"
        plugin_registry=None,  # out-of-tree plugins (WithOutOfTreeRegistry)
        pipeline=None,  # pipelined round executor (None = KARMADA_TPU_PIPELINE)
        aot_prewarm=None,  # kernel-build prewarm on the standby (builds
        #   every kernel library ahead of time); None =
        #   KARMADA_TPU_AOT_PREWARM env (default on)
        gang_wait_seconds: Optional[float] = None,  # partial-gang hold
        #   window before a timeout rejects the cohort (sched/queue.py)
        preemption: bool = True,  # the PreemptLowerPriority second solve
        #   pass (sched/preemption.py); bindings still opt in per policy
        device=None,  # the round's device: None = the CUDA card (raises
        #   RuntimeError without one), "cpu" = the plain path
    ) -> None:
        self.device = resolve_device(device)
        self.store = store
        self.clock = runtime.clock
        self.scheduler_name = scheduler_name
        if estimator_registry is not None:
            # contract check ONCE, loudly, at boot: the pipelined round
            # reads these every chunk, and a registry from the old
            # batch_estimates-only duck contract would otherwise fail every
            # round with a bare AttributeError deep in the pipeline
            missing = [
                a for a in ("batch_estimates", "last_sweep_open",
                            "sweep_round")
                if not hasattr(estimator_registry, a)
            ]
            if missing:
                raise TypeError(
                    "estimator_registry must satisfy "
                    "estimator.client.SchedulerEstimatorRegistry; missing: "
                    + ", ".join(missing)
                )
        self.estimator_registry = estimator_registry
        self.event_recorder = event_recorder
        self.plugins = plugins
        self.plugin_registry = plugin_registry
        self.pipeline = pipeline
        self._array: Optional[ArrayScheduler] = None
        self._fleet_dirty = True
        # Cluster events seen (port-only): the standby loop re-warms once
        # they stop arriving, not on every tick of a replay
        self.cluster_events = 0
        self._prewarmed_epoch = -1
        if aot_prewarm is None:
            import os

            aot_prewarm = os.environ.get("KARMADA_TPU_AOT_PREWARM", "") not in (
                "0", "off", "false",
            )
        self.aot_prewarm = bool(aot_prewarm)
        import threading as _threading

        self._aot_epoch = -1  # fleet epoch the last prewarm pass covered
        self._aot_thread = None
        self._aot_stop = None  # threading.Event: promotion abandons the pass
        # start/abandon run on different threads (standby idle loop vs the
        # elector callback); the lock makes stop-event assignment and the
        # suspension flag atomic with thread start, so a promotion landing
        # mid-_start_aot can never race a fresh pass into a leading daemon
        self._aot_lock = _threading.Lock()
        self._prewarm_suspended = False
        self.last_prewarm_stats: dict = {}
        # streaming admission state (sched/streaming.py): epoch + latency
        # bookkeeping (inert until a StreamingScheduler attaches) and the
        # reference's hint that micro-batch row buckets belong in the
        # prewarm walk (the port's prewarm builds whole libraries, so it
        # reads no shape)
        self.admission = AdmissionLog()
        self.stream_prewarm = False
        # sharded plane (sched/shards/): the shard this daemon serves, as a
        # span/metric label ("" = the unsharded singleton). Ownership and
        # gang-hold routing go through the _owns/_gang_holds seams below so
        # the sharded subclass changes WHICH keys admit, never HOW they
        # solve or patch.
        self.shard_id = ""
        # workload-class scheduling (sched/preemption.py, docs/SCHEDULING.md):
        # the gang coordinator holds partial all-or-nothing cohorts at the
        # queue seam, and `preemption_enabled` arms the second solve pass
        # for PreemptLowerPriority bindings that place short
        from .queue import DEFAULT_GANG_WAIT

        self.gangs = GangCoordinator(
            self.clock,
            DEFAULT_GANG_WAIT if gang_wait_seconds is None
            else gang_wait_seconds,
        )
        self.preemption_enabled = bool(preemption)
        # placed-bindings index for the preemption planner: maintained by
        # the binding watch (replay seeds it at subscription), so a plan
        # snapshot is a dict scan instead of a full store.list deep-copy
        # per preemption. Eventually consistent only — the atomic commit
        # re-reads every victim fresh and rv-checks, so a stale snapshot
        # can only abort a plan, never mis-commit one.
        self._placed: dict[str, ResourceBinding] = {}
        # names of clusters MODIFIED since the last fleet encode; None means
        # the membership changed (add/delete) and the next encode must be a
        # full rebuild instead of the dirty-column scatter
        self._dirty_clusters: Optional[set[str]] = None
        self.controller = runtime.register(
            BatchingController(
                name="scheduler", reconcile=None, reconcile_batch=self._schedule_batch
            )
        )
        if gates is not None and gates.enabled(PRIORITY_BASED_SCHEDULING):
            # swap the FIFO for the activeQ/backoffQ/unschedulable-pool queue
            # (scheduling_queue.go:43-57 under the PriorityBasedScheduling gate)
            self.controller.queue = PrioritySchedulingQueue(
                self.clock, priority_fn=self._priority_of
            )
        store.watch("ResourceBinding", self._on_binding)
        store.watch("Cluster", self._on_cluster)

    # -- event handlers (event_handler.go:94-120) -------------------------

    def _on_binding(self, event: str, rb: ResourceBinding) -> None:
        # placed index upkeep FIRST — before any gating below returns (the
        # handler's rb is this subscriber's own copy, safe to retain)
        if (event == DELETED or rb.metadata.deletion_timestamp is not None
                or not rb.spec.clusters):
            self._placed.pop(rb.metadata.key(), None)
        else:
            self._placed[rb.metadata.key()] = rb
        if event == DELETED:
            if self.admission.enabled:
                # fence + drain: the bump discards any in-flight decision,
                # and enqueueing lets _form_keys see the tombstone and
                # forget the key, keeping the admission maps bounded
                self.admission.invalidate(rb.metadata.key())
                self.controller.enqueue(rb.metadata.key())
            return
        if rb.spec.scheduler_name and rb.spec.scheduler_name != self.scheduler_name:
            # re-targeted to another scheduler: any in-flight decision of
            # ours was computed on the pre-retarget spec — fence it off
            # (no enqueue: the binding is not ours to schedule)
            if self.admission.enabled:
                self.admission.invalidate(rb.metadata.key())
            return
        if not self._owns(rb):
            # sharded plane: another shard's key. Fence any in-flight
            # decision of ours (a resize may have just moved the key off
            # this shard mid-solve) but do not enqueue — the owning
            # shard's own watch admits it.
            if self.admission.enabled:
                self.admission.invalidate(rb.metadata.key())
            return
        if rb.spec.scheduling_suspended():
            # suspension must also move the epoch: an in-flight decision
            # passing the writer's fence would place a binding the user
            # explicitly told the scheduler to leave alone. Enqueue so the
            # drain settles the pending stretch (un-measured).
            if self.admission.enabled:
                self.admission.invalidate(rb.metadata.key())
                self.controller.enqueue(rb.metadata.key())
            return
        queue_incoming_bindings.inc(event=event)
        key = rb.metadata.key()
        if self.admission.enabled:
            # note BEFORE enqueue: the enqueue hook wakes the streaming
            # admission loop, whose epoch snapshot must already see this
            # event's bump; the uid keys the binding's placement trace
            self.admission.note(key, self.clock.now(), uid=rb.metadata.uid)
        self.controller.enqueue(key)

    def _priority_of(self, key: str) -> int:
        ns, _, name = key.partition("/")
        rb = self.store.try_get("ResourceBinding", name, ns)
        if rb is None or rb.spec.schedule_priority is None:
            return 0
        return rb.spec.schedule_priority

    def _on_cluster(self, event: str, cluster) -> None:
        # record the delta FIRST, then mark dirty unconditionally — there is
        # no check-then-act window in which a concurrent _ensure_fleet swap
        # could absorb the flag without the event. Racing with the swap can
        # at worst add the name to the retired set (the fresh set is then
        # empty ⇒ the re-marked round does a full rebuild): a lost NAME
        # degrades to a full re-encode, a lost FLAG would mean scheduling
        # against a stale fleet.
        if event == MODIFIED:
            d = self._dirty_clusters
            if d is not None:
                d.add(cluster.name)
        else:
            self._dirty_clusters = None  # membership changed: full rebuild
        self._fleet_dirty = True
        self.cluster_events += 1
        for rb in self.store.list("ResourceBinding"):
            self._on_binding("MODIFIED", rb)

    # -- trigger decision (doScheduleBinding:375-443) ---------------------

    def _needs_schedule(self, rb: ResourceBinding) -> bool:
        applied = rb.metadata.annotations.get(POLICY_PLACEMENT_ANNOTATION, "")
        current = placement_json(rb.spec.placement)
        if applied != current:
            return True  # placement changed (:401) or never scheduled
        if rb.spec.reschedule_triggered_at is not None and (
            rb.status.last_scheduled_time is None
            or rb.spec.reschedule_triggered_at > rb.status.last_scheduled_time
        ):
            return True  # reschedule triggered (:415)
        if rb.spec.replicas > 0:
            placement = rb.spec.placement
            if placement is not None and placement.replica_scheduling_type() == REPLICA_SCHEDULING_DUPLICATED:
                # Duplicated: replicas synced whenever any target drifts (:422);
                # cluster-set changes also re-run (cluster events enqueue us).
                return True
            if rb.spec.assigned_replicas() != rb.spec.replicas:
                return True  # replicas changed → scale schedule (:408)
        return False

    def _admission_gate(self, rb: Optional[ResourceBinding],
                        any_shard: bool = False) -> str:
        """Per-key admission decision, shared by BOTH drain paths (the
        batch round's _schedule_batch and streaming's _form_keys) so the
        skip conditions cannot drift apart and silently break the
        streaming-vs-batch decision-parity contract. 'drop': tombstone or
        re-targeted to another scheduler (not ours — the key's bookkeeping
        should be forgotten); 'suspended': the user told us to leave it
        alone; 'schedule': solve it; 'clean': current, just record the
        observed generation."""
        if rb is None or rb.metadata.deletion_timestamp is not None:
            return "drop"
        if (rb.spec.scheduler_name
                and rb.spec.scheduler_name != self.scheduler_name):
            # re-targeted while queued: the event handler declines
            # re-target events, but this key was enqueued BEFORE
            return "drop"
        if not any_shard and not self._owns(rb):
            # sharded plane: the key moved (or never belonged) to another
            # shard. Dropping here — and in the _patch_result re-check,
            # which runs under the store's serialization — is the handoff
            # fence: a losing shard's in-flight decision can never patch a
            # binding the gaining shard now owns. `any_shard` is the one
            # sanctioned bypass: the cross-shard gang COORDINATOR commits
            # members it does not own (safety comes from the rv fence on
            # its batch commit, not from ownership).
            return "drop"
        if rb.spec.scheduling_suspended():
            return "suspended"
        return "schedule" if self._needs_schedule(rb) else "clean"

    def _owns(self, rb: ResourceBinding) -> bool:
        """Shard-ownership predicate (sched/shards/): the unsharded daemon
        owns everything; ShardedDaemon overrides with the rendezvous map."""
        return True

    def _record_observed(self, rb: ResourceBinding, sink=None) -> None:
        """No scheduling required: still record that the current spec was
        observed (scheduler.go:437-441) — graceful eviction assessment
        gates on this. With `sink`, the write is collected for one batch
        flush (_flush_observed) instead of its own round-trip — the drain
        loops call this once per clean key."""
        if rb.status.scheduler_observed_generation != rb.metadata.generation:
            rb.status.scheduler_observed_generation = rb.metadata.generation
            if sink is not None:
                sink.append(rb)
            else:
                self.store.update(rb)

    def _flush_observed(self, objs: list) -> None:
        """Commit a drain's observed-generation bookkeeping as ONE batch
        write — rv-checked with per-slot skip: these are full-object
        snapshots read at drain start, and a drain can run long, so a user
        write landing mid-drain must WIN (the skipped binding's own change
        event re-drains it; a binding deleted since its read just drops)."""
        if not objs:
            return
        from ..store.batching import update_all

        update_all(self.store, objs, path="sched_observed",
                   skip_missing=True, skip_stale=True)

    # -- the batch solve --------------------------------------------------

    def _ensure_fleet(self) -> ArrayScheduler:
        if self._array is None or self._fleet_dirty:
            # swap the dirty state out FIRST: a cluster event landing while
            # we encode re-marks the fleet dirty for the next round instead
            # of being silently absorbed into this one
            self._fleet_dirty = False
            dirty = self._dirty_clusters
            self._dirty_clusters = set()
            clusters = self.store.list("Cluster")
            clusters.sort(key=lambda c: c.name)
            if self._array is None:
                self._array = ArrayScheduler(
                    clusters,
                    plugins=self.plugins,
                    plugin_registry=self.plugin_registry,
                    pipeline=self.pipeline,
                    device=self.device,
                )
            else:
                # MODIFIED-only churn rides the dirty-column scatter (the
                # batch encoder and its row cache survive); membership
                # changes rebuild everything as before
                self._array.set_clusters(clusters, dirty_names=dirty)
        return self._array

    def prewarm(self, wait_aot: bool = False) -> None:
        """Hot-standby warmth (coordination plane): build the fleet encoders
        and place the fleet with a throwaway dry round, so a standby
        promoted on leader death takes over within the lease TTL instead of
        paying encoder + build cold-start. Idempotent per fleet epoch —
        cheap to call from the standby's idle loop; cluster churn (which
        bumps the epoch via the watch handlers) re-warms.

        Beyond the dry solve, a background thread builds every kernel
        library (`kernels.build.build_all()`: nvcc over each source whose
        library is not already under kernels/_build/), so the takeover
        round's first launches load built libraries instead of paying nvcc
        mid-round. One pass per fleet epoch; on the CPU there is nothing to
        build and the pass only records zero counts. `wait_aot` blocks
        until the pass finishes (tests and explicit boot warming); the idle
        loop never waits. `abandon_prewarm()` stops a pass on promotion;
        calling prewarm again (the standby loop after losing leadership)
        lifts the suspension. `last_prewarm_stats` carries the pass's
        epoch and its build counts (kernels/build.py `compile_delta`)."""
        with self._aot_lock:
            self._prewarm_suspended = False
        try:
            array = self._ensure_fleet()
            if not array.fleet.names:
                return  # nothing to encode against yet
            if self._prewarmed_epoch == array.fleet_epoch:
                # dry solve already warm for this epoch — but the AOT pass
                # has its own lifecycle (it may have been abandoned on
                # promotion, or still cover a stale epoch) and must get its
                # chance every standby tick
                self._start_aot(array, wait=wait_aot)
                return
            self._prewarmed_epoch = array.fleet_epoch
            from ..api.meta import ObjectMeta
            from ..api.policy import (
                ClusterAffinity,
                Placement,
                ReplicaSchedulingStrategy,
            )
            from ..api.work import BindingSpec, ResourceBinding

            dry = ResourceBinding(
                metadata=ObjectMeta(name="__prewarm__"),
                spec=BindingSpec(
                    replicas=0,
                    placement=Placement(
                        cluster_affinity=ClusterAffinity(cluster_names=[]),
                        replica_scheduling=ReplicaSchedulingStrategy(
                            replica_scheduling_type=REPLICA_SCHEDULING_DUPLICATED
                        ),
                    ),
                ),
            )
            # plain schedule(), NOT schedule_incremental: the dry decision
            # must never enter the replay cache
            array.schedule([dry])
            self._start_aot(array, wait=wait_aot)
        except Exception:  # noqa: BLE001 - warmth is best-effort
            import logging

            logging.getLogger(__name__).exception("standby prewarm")

    def _start_aot(self, array: ArrayScheduler, wait: bool = False) -> None:
        """Kick (or join) the kernel-build pass for the current fleet
        epoch. One pass per epoch; runs on a daemon thread so the standby's
        idle loop keeps renewing its election heartbeat while nvcc works."""
        if not self.aot_prewarm:
            return
        import threading

        with self._aot_lock:
            t = self._aot_thread
            if t is not None and t.is_alive():
                if (self._aot_epoch != array.fleet_epoch
                        and self._aot_stop is not None):
                    # the running pass covers a stale fleet epoch: wind it
                    # down; the NEXT prewarm tick starts the fresh-epoch pass
                    # (cheap — libraries already built are disk hits)
                    self._aot_stop.set()
            else:
                t = None
        if t is not None:
            if not wait:
                return
            t.join()
        with self._aot_lock:
            if self._prewarm_suspended:
                return  # promoted while we were snapshotting: do not start
            if self._aot_thread is not None and self._aot_thread.is_alive():
                return
            if self._aot_epoch == array.fleet_epoch:
                return
            self._aot_epoch = array.fleet_epoch
            epoch = array.fleet_epoch
            stop = threading.Event()
            self._aot_stop = stop

        device = array.device

        def run() -> None:
            import logging

            from ..kernels.build import build_all, compile_counts, compile_delta

            try:
                snap = compile_counts()
                # nvcc cannot be stopped mid-build: the stop is honoured
                # before the pass starts, and one pass builds every source
                if device.type == "cuda" and not stop.is_set():
                    build_all()
                stats = compile_delta(snap)
                self.last_prewarm_stats = {"epoch": epoch, **stats}
                # loud by design: whether takeover rides built libraries is
                # the first thing to check when it looks slow
                logging.getLogger(__name__).warning(
                    "kernel prewarm: epoch %d — %d nvcc builds (%.1fs), "
                    "%d libraries already built",
                    epoch, stats.get("jit_compiles", 0),
                    stats.get("jit_compile_seconds", 0.0),
                    stats.get("jit_persistent_cache_hits", 0),
                )
            except Exception:  # noqa: BLE001 - warmth is best-effort
                logging.getLogger(__name__).exception("kernel prewarm")

        t = threading.Thread(target=run, name="sched-aot-prewarm", daemon=True)
        self._aot_thread = t
        t.start()
        if wait:
            t.join()

    def abandon_prewarm(self) -> None:
        """Promotion hook: stop an in-flight prewarm pass — the new leader's
        first round must not share the host with a background build (the
        pass resumes, skipping what is built, next time the process stands
        by). A running nvcc cannot be aborted, so a pass already building
        drains after promotion (and its build-counter delta can then leak
        into the first leader round's process-global attribution — see
        _schedule_batch)."""
        with self._aot_lock:
            self._prewarm_suspended = True
            if self._aot_stop is not None:
                self._aot_stop.set()
            self._aot_epoch = -1  # re-arm for the next standby period

    def streaming(self, **kwargs):
        """Attach the streaming admission service (sched/streaming.py):
        kills the round boundary — watch events wake an always-on admission
        loop that accumulates micro-batches while the previous one solves
        on device. Enables admission/epoch bookkeeping and adds the
        micro-batch hint for the prewarm. kwargs pass
        through to StreamingScheduler (batch_delay, interval, max_batch,
        depth)."""
        from .streaming import StreamingScheduler

        return StreamingScheduler(self, **kwargs)

    def _gang_of(self, rb: ResourceBinding) -> str:
        from .preemption import gang_of

        return gang_of(rb)

    def _gang_holds(self, rb: ResourceBinding) -> str:
        """The gang identity for QUEUE-HOLD purposes: non-empty parks the
        member in the local GangCoordinator until its cohort assembles.
        The sharded daemon (N>1) returns "" — members hash to different
        shards, so no single queue can assemble the cohort; gang rows
        admit like solo rows and the cross-shard proposal protocol
        (sched/shards/gangs.py) supplies the all-or-nothing commit."""
        return self._gang_of(rb)

    def gang_tick(self) -> int:
        """Reject gangs whose hold window elapsed incomplete (ControlPlane
        .tick drives this for the batch daemon; the streaming loop checks
        on every admission). Returns the number of gangs rejected."""
        expired = self.gangs.expire(self.clock.now())
        for gname, members in expired:
            self._reject_gang(
                gname, members, REASON_GANG_TIMEOUT,
                "gang %s timed out waiting for members" % gname,
                outcome="timeout",
            )
        return len(expired)

    def _reject_gang(self, gname: str, members, reason: str, message: str,
                     outcome: str) -> None:
        """Terminal gang disposition (timeout / joint infeasibility):
        write the Scheduled=False condition on every member (idempotent —
        a repeat writes nothing, so the event fixpoint terminates), park
        priority-queue keys unschedulable, settle admission bookkeeping."""
        gang_admissions.inc(outcome=outcome)
        q = self.controller.queue
        for key, rb, _epoch in members:
            fresh = self.store.try_get("ResourceBinding", rb.name,
                                       rb.namespace)
            if self._admission_gate(fresh) in ("drop", "suspended"):
                continue
            if self.admission.enabled:
                self.admission.settle(key)
            if isinstance(q, PrioritySchedulingQueue):
                q.push_unschedulable(key)
            if set_condition(
                fresh.status.conditions,
                Condition(type=CONDITION_SCHEDULED, status="False",
                          reason=reason, message=message),
            ):
                self.store.update(fresh)

    def _admit_gangs(self, bindings: list) -> list:
        """Gang admission at the drain seam: gang members park in the
        coordinator until their cohort completes; the completing member
        releases the whole gang into THIS batch (so the cohort always
        solves together). Non-gang rows pass through untouched."""
        ready: list = []
        for rb in bindings:
            if self._gang_holds(rb):
                released = self.gangs.offer(rb.metadata.key(), rb, 0)
                ready.extend(rb2 for _k, rb2, _e in released)
            else:
                ready.append(rb)
        return ready

    def _launch_routed(self, array: ArrayScheduler, chunk: list,
                       extra, round_rows: int) -> dict:
        """Launch one chunk, routing workload-class batches — mixed
        priorities (segmented tiered solve) or preemption-armed rows
        (speculative victim-augmented pass) — through ONE
        sched/preemption.py launch, and plain batches through the ordinary
        replay-aware path."""
        from .preemption import (
            armed_for_preemption, launch_tiered, wants_workload_solve,
        )

        if wants_workload_solve(array, chunk,
                                preemption=self.preemption_enabled):
            # the O(placed) snapshot copy is only paid when a row will
            # actually read it (speculative second pass) — a plain
            # mixed-priority stream must not tax every micro-batch with it
            placed = None
            if self.preemption_enabled and any(
                armed_for_preemption(rb) for rb in chunk
            ):
                placed = list(self._placed.values())
            return launch_tiered(array, chunk, extra, placed=placed)
        return array.launch_chunk(chunk, extra, round_rows=round_rows)

    def _schedule_batch(self, keys: list[str]) -> list[str]:
        bindings = []
        observed: list = []
        for key, rb in zip(keys, read_bindings(self.store, keys)):
            gate = self._admission_gate(rb)
            if gate == "schedule":
                bindings.append(rb)
            elif gate == "clean":
                self._record_observed(rb, sink=observed)
            if rb is not None and gate in ("drop", "suspended"):
                g = self._gang_of(rb)
                if g:
                    self.gangs.discard(key, g)
        self._flush_observed(observed)
        bindings = self._admit_gangs(bindings)
        self.gang_tick()
        if not bindings:
            return []
        from ..kernels.build import compile_counts, compile_delta
        from ..tracing import Trace
        from .core import caller_stream
        from .pipeline import (
            ChunkPipeline, StageTimer, chunk_spans, plan_chunk_rows,
        )

        trace = Trace("Scheduling", {"bindings": len(bindings)})
        compile_snap = compile_counts()
        with timed(e2e_scheduling_duration):
            array = self._ensure_fleet()
            trace.step("Fleet snapshot ready")
            names = array.fleet.names
            reg = self.estimator_registry
            # Pipelined round (sched/pipeline.py): the round is cut into row
            # chunks and the five stages overlap across them — chunk k+1's
            # estimator sweep prefetches on a worker thread and its rows
            # encode/dispatch on this thread while chunk k solves on device
            # and chunk k−1 materializes + patches on the bounded writer.
            # Decisions are bit-identical to the serial executor (rows are
            # independent; tie-breaks UID-seeded) and the writer patches
            # chunks strictly in order, so per-binding store-write ordering
            # is exactly the serial sequence. Autoshard routes on the WHOLE
            # round first — chunked launches must see the same backend the
            # serial executor would.
            array._maybe_autoshard(len(bindings))
            # equalized chunk-size schedule: lattice-snapped equal chunks —
            # never more program shapes than the greedy split, usually one
            rows = plan_chunk_rows(
                len(bindings), array.round_chunk_rows(len(bindings))
            )
            chunks = [
                bindings[s:e] for s, e in chunk_spans(len(bindings), rows)
            ]
            # same guard as ArrayScheduler._schedule_chunked: out-of-tree
            # plugins' stateful host hooks must never run on two threads,
            # so their (HBM-chunked) rounds execute serially
            pipelined = (
                array.pipeline_enabled
                and not array._oot_plugins
                and len(chunks) > 1
            )
            timer = StageTimer()
            open_members: set[str] = set()
            totals = {"replayed": 0, "solved": 0}

            def estimate(chunk):
                # chunk-shard estimator fan-out: each sweep covers only this
                # chunk's bindings, so the next chunk's answers prefetch
                # while the current one solves. Snapshot the degraded set
                # per sweep — breaker-open members' stale columns merged
                # into THIS chunk's matrix exactly as a serial sweep would.
                extra = reg.batch_estimates(chunk, names)
                return extra, tuple(reg.last_sweep_open)

            def launch(i, chunk, est):
                extra = None
                if est is not None:
                    extra, swept_open = est
                    open_members.update(swept_open)
                pending = self._launch_routed(array, chunk, extra,
                                              round_rows=len(bindings))
                totals["replayed"] += pending["replayed"]
                totals["solved"] += pending["solved"]
                return pending

            # gang cohorts commit at ROUND scope, not chunk scope: the
            # equalized chunk split can land a gang's members in different
            # chunks, and the all-or-nothing commit must see the whole
            # cohort (the streaming path never splits — the coordinator
            # releases a gang into one micro-batch)
            gang_buffer: list = []

            def patch(i, chunk, decisions):
                for decision in decisions:
                    schedule_attempts.inc(
                        result="scheduled" if decision.ok else "error"
                    )
                # coalesced: one batch read + one transactional batch write
                # per chunk instead of 2 store round-trips per binding
                self._patch_results(list(zip(chunk, decisions)),
                                    gang_sink=gang_buffer)

            from contextlib import nullcontext

            # a CUDA stream is current per thread: the pipelined writer
            # enters the caller's, so its copies back wait for the chunk's
            # kernels and its retry sub-rounds launch there (plain and
            # tiered pendings alike)
            stream = caller_stream(array.device)

            def materialize(pending):
                with torch.cuda.stream(stream):
                    return array.materialize_chunk(pending)

            # the round's chunk-shard sweeps count as ONE sweep for the
            # staleness cache (snapshots merge, epochs advance once/round)
            sweep_scope = (
                reg.sweep_round() if reg is not None else nullcontext()
            )
            with array.pipeline_context(timer, overlap=pipelined), sweep_scope:
                pipe = ChunkPipeline(
                    launch=launch,
                    materialize=materialize,
                    estimate=estimate if reg is not None else None,
                    patch=patch,
                    pipelined=pipelined,
                    timer=timer,
                    # materialize_chunk times its own finer span
                    time_materialize=False,
                )
                pipe.run(chunks)
                if gang_buffer:
                    self._flush_gang_sink(gang_buffer)
            # the algorithm metric keeps its solve-only reference semantics
            # (estimate RPC time and store patching stay OUTSIDE it, as they
            # were before the pipeline): observe the round's algorithm-stage
            # busy time — stages overlap, so wall-clock would under-count
            scheduling_algorithm_duration.observe(sum(
                timer.totals.get(s, 0.0)
                for s in ("encode", "solve", "materialize")
            ))
            if open_members:
                # degraded mode: at least one member's breaker was open
                # during this round's sweeps — its stale (penalized) rows
                # stayed in the matrix and every chunk still completed as a
                # batched launch
                degraded_rounds.inc()
            stats = pipe.stats()
            stats["chunks"] = len(chunks)
            stats["chunk_rows"] = rows
            # build economics: a steady-state round shows jit_compiles == 0
            # (every library it launches is already built); anything else
            # is a build the prewarm should have done. Attribution is
            # PROCESS-global: a concurrent build — an abandoned prewarm
            # pass draining its nvcc right after takeover — can leak into
            # one round's delta
            stats.update(compile_delta(compile_snap))
            array.last_round_stats = {**totals, **stats}
            trace.step("Pipelined round done (estimate/encode/solve/"
                       "materialize/patch)")
        # slow-round span (the scheduler-side analogue of estimate.go:37-38)
        trace.log_if_long(1.0)
        return []

    def _patch_results(self, items, gang_sink: Optional[list] = None
                       ) -> list[bool]:
        """Coalesced decision patching with workload-class routing: gang
        cohorts split off to the all-or-nothing `_patch_gang` commit (or,
        with `gang_sink`, defer to the caller's round-end `_flush_gang_sink`
        — the batch round's chunk split can separate a gang's members, and
        the atomic commit must see the whole cohort), everything else rides
        the coalesced solo path, and failed PreemptLowerPriority rows take
        the preemption second pass afterwards."""
        if not items:
            return []
        gang_groups: dict[str, list[int]] = {}
        for j, (rb, _dec) in enumerate(items):
            g = self._gang_of(rb)
            if g:
                gang_groups.setdefault(g, []).append(j)
        if not gang_groups:
            return self._patch_solo(items)
        outcomes: list[bool] = [False] * len(items)
        in_gang = {j for js in gang_groups.values() for j in js}
        solo_js = [j for j in range(len(items)) if j not in in_gang]
        if solo_js:
            for j, ok in zip(solo_js,
                             self._patch_solo([items[j] for j in solo_js])):
                outcomes[j] = ok
        for gname, js in gang_groups.items():
            group = [items[j] for j in js]
            if gang_sink is not None:
                # deferred: the round-end flush owns the cohort
                gang_sink.append((gname, group))
                continue
            for j, ok in zip(js, self._patch_gang(gname, group)):
                outcomes[j] = ok
        return outcomes

    def _flush_gang_sink(self, gang_buffer: list) -> None:
        """Round-end gang commit for the batch daemon: chunks deferred
        their gang items here, so a gang split across chunk boundaries
        still commits as ONE cohort."""
        merged: dict[str, list] = {}
        for gname, group in gang_buffer:
            merged.setdefault(gname, []).extend(group)
        for gname, group in merged.items():
            self._patch_gang(gname, group)

    def _gang_full(self, rb: ResourceBinding, dec: ScheduleDecision) -> bool:
        """Joint-feasibility term for one gang member: the solve succeeded
        AND a divided workload placed its FULL replica count (a gang's
        all-or-nothing contract covers partial placements too)."""
        if not dec.ok:
            return False
        if rb.spec.replicas > 0 and rb.spec.placement is not None and (
            rb.spec.placement.replica_scheduling_type()
            != REPLICA_SCHEDULING_DUPLICATED
        ):
            return sum(t.replicas for t in (dec.targets or [])) \
                >= rb.spec.replicas
        return True

    def _patch_gang(self, gname: str, items) -> list[bool]:
        """All-or-nothing gang commit: the whole cohort passes the joint
        feasibility check, prepares against fresh snapshots, and commits in
        ONE rv-checked `update_batch` — a mid-cohort veto (stale rv,
        vanished member, last-moment gate flip) re-admits the WHOLE gang
        uncharged; nothing partial ever reaches the store (pinned by
        tests/test_preemption.py)."""
        from ..store.store import BatchError

        size = max(max((rb.spec.gang_size or 0) for rb, _ in items), 1)
        if len(items) < size or not all(
            self._gang_full(rb, dec) for rb, dec in items
        ):
            self._reject_gang(
                gname,
                [(rb.metadata.key(), rb, 0) for rb, _ in items],
                REASON_GANG_UNSCHEDULABLE,
                f"gang {gname}: cohort did not place all "
                f"{size} members fully",
                outcome="rejected",
            )
            return [False] * len(items)
        get_batch = getattr(self.store, "get_batch", None)
        if get_batch is not None:
            fresh_list = get_batch(
                "ResourceBinding",
                [(rb.name, rb.namespace) for rb, _ in items],
            )
        else:
            fresh_list = [
                self.store.try_get("ResourceBinding", rb.name, rb.namespace)
                for rb, _ in items
            ]
        sink: list = []
        for (rb, dec), fresh in zip(items, fresh_list):
            if fresh is None:
                return self._readmit_gang(items)
            if not self._patch_result(rb, dec, fresh=fresh, sink=sink):
                return self._readmit_gang(items)
        objs = [obj for obj, _ in sink]
        try:
            if objs:
                batch = getattr(self.store, "update_batch", None)
                if batch is not None:
                    batch(objs, check_rv=True)
                else:
                    for obj in objs:
                        self.store.update(obj)
        except BatchError:
            return self._readmit_gang(items)
        gang_admissions.inc(outcome="placed")
        for obj, dec in sink:
            if dec is not None:
                self._record_event(obj, dec)
        return [True] * len(items)

    def _readmit_gang(self, items) -> list[bool]:
        """Mid-cohort veto: something moved under one member and nothing
        committed — the whole gang re-admits uncharged (readd keeps cached
        priorities and burns no retry budget; the coordinator reassembles
        the cohort on the next drain)."""
        q = self.controller.queue
        readd = getattr(q, "readd", None) or q.add
        for rb, _dec in items:
            readd(rb.metadata.key())
        return [False] * len(items)

    def _patch_solo(self, items) -> list[bool]:
        """The coalesced non-gang patch path: per-binding prepare/veto
        against a batch-read fresh snapshot, then ONE transactional batch
        write for the whole cohort — a micro-batch of B decisions costs ≤1
        batch read + 1 batch write instead of 2·B store round-trips, with
        store bytes and event stream bit-identical to the per-object path
        (same objects, same order, contiguous rvs; under concurrent writers
        the cohort write is rv-checked, so a mid-window rewrite skips its
        slot instead of being clobbered). Event recording runs AFTER the
        commit and only for slots that landed. Returns the per-item outcome
        (False = vetoed/skipped, as _patch_result)."""
        if not items:
            return []
        fresh_list = None
        get_batch = getattr(self.store, "get_batch", None)
        if get_batch is not None and len(items) > 1:
            fresh_list = get_batch(
                "ResourceBinding",
                [(rb.name, rb.namespace) for rb, _ in items],
            )
        from ..api.policy import PREEMPT_LOWER_PRIORITY

        sink: list = []
        outcomes = []
        spans = []
        preempt_later: list[int] = []
        for j, (rb, decision) in enumerate(items):
            if (self.preemption_enabled and not decision.ok
                    and rb.spec.preemption_policy == PREEMPT_LOWER_PRIORITY
                    and not self._gang_of(rb)):
                # short-placed preemptor: defer — the preemption pass runs
                # after this cohort commits, and only an infeasible or
                # aborted plan writes the Unschedulable condition (a
                # committed plan would immediately overwrite it, costing a
                # wasted store round-trip per preemption on the hot path)
                preempt_later.append(j)
                outcomes.append(True)  # resolved by _preempt_pass below
                spans.append((len(sink), len(sink)))
                continue
            fresh = fresh_list[j] if fresh_list is not None else _UNREAD
            n0 = len(sink)
            outcomes.append(
                self._patch_result(rb, decision, fresh=fresh, sink=sink)
            )
            spans.append((n0, len(sink)))
        if sink:
            from ..store.batching import update_all

            # rv-checked with per-slot skip: batching widens the
            # read→commit window from per-binding to per-cohort, so a
            # binding rewritten (or deleted) in that window SKIPS — never
            # clobbered by the stale snapshot — and reports a veto below;
            # its own change event re-admits the key
            committed = update_all(self.store, [obj for obj, _ in sink],
                                   path="sched_patch",
                                   skip_missing=True, skip_stale=True)
            for j, (n0, n1) in enumerate(spans):
                if any(committed[k] is None for k in range(n0, n1)):
                    outcomes[j] = False
            # events record post-commit, and only for writes that LANDED —
            # a skipped slot must not log "scheduled successfully"
            for (obj, decision), done in zip(sink, committed):
                if decision is not None and done is not None:
                    self._record_event(obj, decision)
        if preempt_later:
            self._preempt_pass(items, preempt_later, outcomes)
        return outcomes

    # -- preemption second pass (sched/preemption.py) ----------------------

    def _preempt_pass(self, items, idxs, outcomes) -> None:
        """Short-placed PreemptLowerPriority bindings take the second solve
        pass: plan over a victim-augmented capacity matrix (one launch per
        distinct preemptor priority), then commit victim replica reductions
        + preemptor placements as ONE rv-checked batch cohort. A committed
        plan rewrites the in-flight decision to its placement so the
        streaming writer observes the preemptor's placement latency on the
        same SLO histogram as ordinary admissions; anything else falls back
        to the ordinary unschedulable patch."""
        cands = [(j, *items[j]) for j in idxs]
        plans_by_key: dict = {}
        if self._array is not None:
            import numpy as np

            from .preemption import (
                PlanLedger, plan_from_speculative, plan_preemption,
            )

            placed = [
                b for b in list(self._placed.values())
                if b.spec.clusters and b.metadata.deletion_timestamp is None
            ]
            # rows whose victim-augmented decision already rode the
            # admission launch (speculative second pass) plan with ZERO
            # extra solves; the rest (batch-round fallbacks, std-path
            # rows) pay the standalone planner's launch. ONE ledger spans
            # both paths: every plan in this pass sees the free capacity
            # and victim replicas earlier plans already claimed, so the
            # joint commit cannot double-count either.
            ledger = PlanLedger(
                np.asarray(self._array.fleet.capacity, np.int64)
            )
            spec_pairs = [(rb, dec.speculative) for _j, rb, dec in cands
                          if dec.speculative is not None]
            solve_rbs = [rb for _j, rb, dec in cands
                         if dec.speculative is None]
            plans = []
            if spec_pairs:
                plans += plan_from_speculative(self._array, placed,
                                               spec_pairs, ledger=ledger)
            if solve_rbs:
                plans += plan_preemption(self._array, placed, solve_rbs,
                                         ledger=ledger)
            plans_by_key = {p.key: p for p in plans}
        feasible = []
        feasible_js = []
        fallback = []
        for j, rb, dec in cands:
            plan = plans_by_key.get(rb.metadata.key())
            if plan is None or not plan.feasible:
                preemptions_total.inc(outcome="infeasible")
                fallback.append(j)
                continue
            feasible.append((rb, dec, plan))
            feasible_js.append(j)
        if feasible and not self._commit_preemption(feasible):
            fallback.extend(feasible_js)
        for j in fallback:
            rb, dec = items[j]
            outcomes[j] = self._patch_result(rb, dec)

    def _commit_preemption(self, feasible) -> bool:
        """The atomic half: victim cuts (merged per victim binding, flowing
        through graceful-eviction tasks) and every preemptor's placement in
        ONE `update_batch(check_rv=True)` — a concurrent write to any
        member aborts the whole plan (outcome=aborted; the preemptor stays
        unschedulable and retries on its next event)."""
        from ..store.store import BatchError

        # merge victim cuts per (binding, cluster): plans within one
        # priority group SHARE one victims list (id-identical — the joint
        # selection), counted once; DISTINCT groups' cuts SUM — the plan
        # ledger already guaranteed they claim disjoint replicas, so the
        # sum is exactly the combined eviction the pass decided on
        cuts: dict[tuple[str, str], int] = {}
        seen_lists: set[int] = set()
        for _rb, _dec, plan in feasible:
            if id(plan.victims) in seen_lists:
                continue
            seen_lists.add(id(plan.victims))
            for v in plan.victims:
                k = (v.key, v.cluster)
                cuts[k] = cuts.get(k, 0) + v.replicas
        victim_keys = sorted({k for k, _c in cuts})
        now = self.clock.now()
        objs: list = []
        # fresh reads coalesced: one batch read for the victims + one for
        # the preemptors instead of a try_get (lock hold + deep copy) each
        get_batch = getattr(self.store, "get_batch", None)
        if get_batch is not None:
            pre_keys = [rb.metadata.key() for rb, _d, _p in feasible]
            pairs = [(k.partition("/")[2], k.partition("/")[0])
                     for k in victim_keys + pre_keys]
            fresh_all = get_batch("ResourceBinding", pairs)
            victims_fresh = dict(zip(victim_keys, fresh_all))
            preemptors_fresh = dict(zip(pre_keys,
                                        fresh_all[len(victim_keys):]))
        else:
            victims_fresh = preemptors_fresh = None
        for vkey in victim_keys:
            ns, _, name = vkey.partition("/")
            if victims_fresh is not None:
                victim = victims_fresh[vkey]
            else:
                victim = self.store.try_get("ResourceBinding", name, ns)
            if victim is None or victim.metadata.deletion_timestamp is not None:
                self._abort_preemption(feasible, "victim vanished mid-plan")
                return False
            for (k2, cluster), cut in sorted(cuts.items()):
                if k2 != vkey:
                    continue
                entry = next(
                    (tc for tc in victim.spec.clusters
                     if tc.name == cluster), None,
                )
                if entry is None or entry.replicas < cut:
                    self._abort_preemption(
                        feasible, "victim placement changed mid-plan"
                    )
                    return False
                entry.replicas -= cut
                if entry.replicas == 0:
                    victim.spec.clusters = [
                        tc for tc in victim.spec.clusters
                        if tc.name != cluster
                    ]
                victim.spec.graceful_eviction_tasks.append(
                    GracefulEvictionTask(
                        from_cluster=cluster,
                        replicas=cut,
                        reason=EVICTION_REASON_PREEMPTED,
                        message=("preempted by higher-priority binding(s): "
                                 + ", ".join(p.key for _r, _d, p in feasible
                                             )[:200]),
                        producer=EVICTION_PRODUCER_PREEMPTION,
                        creation_timestamp=now,
                    )
                )
            objs.append(victim)
        # the preemptor's placement write goes through _patch_result — THE
        # one placement-write implementation (annotation, condition,
        # observed generation/affinity, reschedule handling) — so the
        # preemption path cannot drift from the ordinary patch path, and
        # committed placements record the same binding Event
        sink: list = []
        for rb, dec, plan in feasible:
            if preemptors_fresh is not None:
                fresh = preemptors_fresh[rb.metadata.key()]
            else:
                fresh = self.store.try_get("ResourceBinding", rb.name,
                                           rb.namespace)
            if fresh is None:
                self._abort_preemption(feasible, "preemptor vanished")
                return False
            placed_dec = ScheduleDecision(dec.key,
                                          targets=list(plan.targets))
            if not self._patch_result(rb, placed_dec, fresh=fresh,
                                      sink=sink):
                self._abort_preemption(feasible, "preemptor gate flipped")
                return False
        objs.extend(obj for obj, _dec in sink)
        try:
            batch = getattr(self.store, "update_batch", None)
            if batch is not None:
                batch(objs, check_rv=True)
            else:
                for obj in objs:
                    self.store.update(obj)
        except BatchError:
            self._abort_preemption(feasible, "atomic commit lost a race")
            return False
        for obj, dec in sink:
            if dec is not None:
                self._record_event(obj, dec)
        for rb, dec, plan in feasible:
            preemptions_total.inc(outcome="committed")
            preemption_victims.observe(float(len(plan.victim_keys())))
            # rewrite the in-flight decision: the preemptor IS placed now,
            # so the streaming writer's SLO accounting sees a placement
            dec.error = ""
            dec.targets = list(plan.targets)
        return True

    def _abort_preemption(self, feasible, why: str) -> None:
        import logging

        logging.getLogger(__name__).warning("preemption aborted: %s", why)
        for _rb, _dec, _plan in feasible:
            preemptions_total.inc(outcome="aborted")

    def _patch_result(self, rb: ResourceBinding, decision: ScheduleDecision,
                      *, fresh=None, sink=None,
                      any_shard: bool = False) -> bool:
        """Write a decision back to the store. Returns False when the write
        is VETOED by a last-moment spec change: the streaming writer's epoch
        fence is check-then-act, so a deletion/suspension/re-target event
        landing between the epoch comparison and this write must still stop
        the patch — re-checked here against the freshest spec, under the
        store's serialization (which orders this read after that event's
        write).

        Coalescing seams (used by _patch_results): `fresh` supplies a
        batch-read snapshot instead of the per-binding try_get; `sink`
        collects (obj, decision-to-record|None) instead of writing — the
        caller commits the whole cohort as one batch and records events
        post-commit."""
        if fresh is _UNREAD or (fresh is None and sink is None):
            fresh = self.store.try_get("ResourceBinding", rb.name, rb.namespace)
        if self._admission_gate(fresh, any_shard=any_shard) in (
                "drop", "suspended"):
            return False
        if decision.ok:
            placement = placement_json(fresh.spec.placement)
            trigger_active = fresh.spec.reschedule_triggered_at is not None and (
                fresh.status.last_scheduled_time is None
                or fresh.spec.reschedule_triggered_at > fresh.status.last_scheduled_time
            )
            changed = (
                _targets_fingerprint(fresh.spec.clusters)
                != _targets_fingerprint(decision.targets)
                or fresh.metadata.annotations.get(POLICY_PLACEMENT_ANNOTATION) != placement
                or trigger_active
            )
            fresh.spec.clusters = decision.targets
            fresh.metadata.annotations[POLICY_PLACEMENT_ANNOTATION] = placement
            cond_changed = set_condition(
                fresh.status.conditions,
                Condition(
                    type=CONDITION_SCHEDULED,
                    status="True",
                    reason=REASON_BINDING_SCHEDULED,
                    message="Binding has been scheduled successfully.",
                ),
            )
            if not changed and not cond_changed:
                if fresh.status.scheduler_observed_generation != fresh.metadata.generation:
                    fresh.status.scheduler_observed_generation = fresh.metadata.generation
                    self._commit_patch(fresh, None, sink)
                return True  # idempotent no-op: the event fixpoint terminates here
            fresh.status.scheduler_observed_generation = fresh.metadata.generation
            fresh.status.scheduler_observed_affinity_name = decision.affinity_name
            fresh.status.last_scheduled_time = self.clock.now()
        else:
            reason = (
                REASON_UNSCHEDULABLE
                if "not enough" in decision.error or "available" in decision.error
                else REASON_SCHEDULE_FAILED
            )
            if isinstance(self.controller.queue, PrioritySchedulingQueue):
                # park until new information arrives (≤5 min max stay)
                self.controller.queue.push_unschedulable(fresh.metadata.key())
            if not set_condition(
                fresh.status.conditions,
                Condition(
                    type=CONDITION_SCHEDULED,
                    status="False",
                    reason=reason,
                    message=decision.error,
                ),
            ):
                return True
        self._commit_patch(fresh, decision, sink)
        return True

    def _commit_patch(self, fresh: ResourceBinding,
                      decision: Optional[ScheduleDecision], sink) -> None:
        """The write point of a patch: straight to the store (per-object
        path), or into the caller's sink for one transactional batch write
        (decision=None marks a bookkeeping-only write with no event)."""
        if sink is not None:
            sink.append((fresh, decision))
            return
        self.store.update(fresh)
        if decision is not None:
            self._record_event(fresh, decision)

    def _record_event(self, fresh: ResourceBinding,
                      decision: ScheduleDecision) -> None:
        if self.event_recorder is None:
            return
        # recorded on the binding (scheduler.go:964-1010); the binding
        # status controller mirrors template-side visibility
        from ..events import (
            REASON_SCHEDULE_BINDING_FAILED,
            REASON_SCHEDULE_BINDING_SUCCEED,
            TYPE_NORMAL,
            TYPE_WARNING,
        )

        if decision.ok:
            self.event_recorder.event(
                fresh, TYPE_NORMAL, REASON_SCHEDULE_BINDING_SUCCEED,
                "Binding has been scheduled successfully.",
            )
        else:
            self.event_recorder.event(
                fresh, TYPE_WARNING, REASON_SCHEDULE_BINDING_FAILED, decision.error
            )


def _targets_fingerprint(targets) -> tuple:
    return tuple(sorted((t.name, t.replicas) for t in (targets or [])))
