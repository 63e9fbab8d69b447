"""Streaming scheduler: kill the round boundary.

The batch daemon wakes on a fixed tick, drains every dirty binding into one
round, and sleeps — a binding arriving right after a drain waits the whole
tick PLUS the whole next round before its placement patches, and the only
latency anyone can state is a round p99. This module replaces the tick with
an always-on admission service, the continuous-batching shape LLM inference
serving proved out (Orca/vLLM-style in-flight batching): admit new work into
the gaps of an already-running pipeline instead of waiting for the next
round.

Mechanics:

- **Event-driven wakeup.** Watch events enqueue keys and notify a condition
  variable (`WorkQueue.on_add` / `PrioritySchedulingQueue.on_add`); the
  admission loop sleeps until work exists, with the old `--interval` kept
  only as a max-sleep fallback so an idle leader still runs its idle hook
  (election renew piggyback, prewarm re-checks). The 0.2 s idle latency
  floor is gone.
- **Micro-batch admission.** When work arrives the loop optionally waits
  `batch_delay` (the `--batch-delay-ms` knob: trade a latency floor for
  batch efficiency — applied only to trickle arrivals; a backlog admits
  immediately), then drains a quota of keys and launches them as ONE
  micro-batch through the open-ended StreamPipeline. The launch returns as
  soon as the kernels dispatch; the loop goes straight back to
  accumulating, so the NEXT micro-batch forms while this one solves on
  device and the previous one patches on the writer. Micro-batch size is
  self-pacing: it grows toward arrival_rate × solve_time under load and
  shrinks to single bindings when traffic trickles.
- **Epoch-tagged staleness.** Every watch event bumps the binding's
  admission epoch (scheduler.AdmissionLog). A micro-batch snapshots each
  binding's epoch BEFORE reading its spec; if the epoch moved by the time
  the writer patches — the binding dirtied mid-flight — the in-flight
  decision is DISCARDED and the binding re-admits with its fresh spec (the
  bumping event already re-enqueued the key).
- **Parity.** Decisions for any stable snapshot are bit-identical to the
  equivalent one-shot batch round: micro-batches ride the same replay-aware
  `launch_chunk`/`materialize_chunk` rows-independent solve, and the
  tie-break is UID-seeded — batch composition cannot leak into placements
  (pinned by tests/test_streaming.py).
- **Zero steady-state compiles.** Micro-batch rows pad to the shape_bucket
  lattice like every other round, and the drain quota is FLOORED to a
  lattice point (a deep queue drains exactly a bucket's worth and leaves the
  remainder for the immediately-following batch, instead of padding up).
  On the card the kernels are built once a process, for every shape, so a
  micro-batch after the first builds nothing (`jit_compiles == 0`).

Streaming admission is leader-only (docs/HA.md): the daemon runs `serve()`
only while it holds the scheduler lease, and a standby's queue keeps
accumulating from its own watches — takeover resumes the queue, losing
nothing but the deposed leader's un-patched in-flight decisions (whose
patches would bounce on the fencing token anyway).

The port's copy of the JAX package's `sched/streaming.py`. The writer
thread materializes each micro-batch in the CUDA stream that was current
on the thread that opened the stream (a stream is current per thread), so
its copies back wait for the batch's kernels; the build counters come from
kernels/build.py.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..metrics import (
    degraded_rounds,
    e2e_scheduling_duration,
    microbatch_size,
    placement_latency,
    sched_queue_depth,
    schedule_attempts,
)
from ..models.batch import shape_floor
from ..tracing import tracer
from .pipeline import DEFAULT_DEPTH, StageTimer, StreamPipeline

log = logging.getLogger(__name__)

# trickle threshold: the batching delay only applies while fewer than one
# minimal row bucket is ready — under backlog, delaying admission buys no
# batching (the batch is already big) and only adds latency
MIN_ACCUMULATE = 8

# drain-quota ceiling when the caller sets none: one shape_bucket lattice
# run's worth of rows — micro-batches above this split across consecutive
# admissions (each still under the pipeline's per-chunk HBM cap)
DEFAULT_MAX_BATCH = 4096


@dataclass
class _MicroBatch:
    """One admitted micro-batch: the bindings with their pre-read epoch
    snapshots (the staleness fence) and the per-batch accounting the patch
    stage publishes."""

    bindings: list
    keys: list[str]
    epochs: list[int]
    compile_snap: dict
    t0: float  # perf_counter at formation (e2e histogram)
    swept_open: tuple = ()
    replayed: int = 0
    solved: int = 0
    stats: dict = field(default_factory=dict)
    # tracing: (launch id, wall start, wall dispatch-end) of the shared
    # device launch — ONE span fanned out to the batch's member traces
    launch_wall: tuple = ()


class StreamingScheduler:
    """The admission service around a SchedulerDaemon.

    `serve()` runs the admission loop on the calling thread (the daemon
    main thread while it leads); `stop()` — or `should_stop` returning
    True — makes it return after draining in-flight work. `batch_delay`,
    `interval`, `max_batch`, `depth` are the tuning surface; everything
    else (what needs scheduling, how it solves, how results patch) is the
    daemon's existing machinery."""

    def __init__(
        self,
        daemon,
        batch_delay: float = 0.005,
        interval: float = 0.2,
        max_batch: int = 0,
        depth: int = DEFAULT_DEPTH,
    ) -> None:
        self.daemon = daemon
        self.batch_delay = batch_delay
        self.interval = interval
        self.max_batch = max_batch
        self.depth = depth
        self._cond = threading.Condition()
        self._stop_evt = threading.Event()
        self._serving = False
        self._array = None
        self._timer: Optional[StageTimer] = None
        self._stop_check: Callable[[], bool] = lambda: False
        self._n_batches = 0
        self._stats_lock = threading.Lock()
        # keys from a failed multi-key micro-batch: the culprit is unknown,
        # so each suspect re-admits as a SINGLETON batch (the
        # BatchingController.step isolation discipline) — the next failure
        # charges exactly the poison binding's retry budget, and its
        # healthy cohort neighbors keep theirs. Plain-set membership ops
        # only (atomic under the GIL); touched by admission + writer.
        self._suspects: set[str] = set()
        from collections import deque

        # exact recent placement latencies (admission → patch), next to the
        # bucketed histogram: the stream bench reports honest percentiles
        self._latencies: deque = deque(maxlen=100_000)
        self.stats = {
            "batches": 0, "formed": 0, "admitted": 0, "placed": 0,
            "failed": 0, "stale_discarded": 0, "clean": 0, "jit_compiles": 0,
        }
        # attach: admission/epoch bookkeeping on, condvar wakeup on
        # enqueue, and the reference's micro-batch prewarm hint
        daemon.admission.enabled = True
        daemon.stream_prewarm = True
        daemon.controller.queue.on_add = self._wake

    # -- wakeup ------------------------------------------------------------

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def stop(self) -> None:
        """Make a serve() on another thread return (clean shutdown and the
        leadership-loss path both land here)."""
        self._stop_evt.set()
        self._wake()

    def _ready(self) -> int:
        q = self.daemon.controller.queue
        return q.active_len() if hasattr(q, "active_len") else len(q)

    def _wait_for_work(self) -> bool:
        """Sleep until a key is enqueued (condition-variable wakeup) or the
        `interval` max-sleep fallback elapses; True iff work is ready."""
        with self._cond:
            if self._ready():
                return True
            self._cond.wait(timeout=self.interval)
            return bool(self._ready())

    # -- the admission loop ------------------------------------------------

    def serve(
        self,
        should_stop: Optional[Callable[[], bool]] = None,
        idle: Optional[Callable[[], None]] = None,
        quiescent: bool = False,
        max_batches: int = 0,
    ) -> int:
        """Run the admission loop until `should_stop()`/`stop()` (the
        daemon deployment), the queue goes quiescent (`quiescent=True` —
        the test/bench drive: returns once no work is ready and every
        in-flight micro-batch has retired, including the fixpoint events
        the patches themselves generate), or `max_batches` micro-batches
        admitted. Returns the number of micro-batches admitted. `idle`
        runs on every max-sleep fallback wakeup that found no work."""
        if self._serving:
            raise RuntimeError("serve() is not reentrant")
        self._serving = True
        self._stop_evt.clear()
        daemon = self.daemon
        stop_fn = should_stop or (lambda: False)
        # visible to _submit's bounded-slot poll (leadership loss must
        # interrupt a slot wait, not just the condvar sleep)
        self._stop_check = stop_fn
        n0 = self._n_batches
        stream = None
        try:
            # inside the try: _ensure_fleet reads the store and can raise
            # transiently — the finally must still reset _serving, or every
            # retry serve() is rejected as reentrant and the leader never
            # schedules again
            array = self._array = daemon._ensure_fleet()
            timer = self._timer = StageTimer()
            with array.pipeline_context(timer, overlap=True):
                stream = self._open_stream(array, timer)
                while not (stop_fn() or self._stop_evt.is_set()):
                    if max_batches and self._n_batches - n0 >= max_batches:
                        break
                    if stream.aborted:
                        # eager writer-death detection: with an EMPTY queue
                        # the failed micro-batch's bindings would otherwise
                        # stay un-readmitted (and unplaced) until some
                        # unrelated watch event woke the loop — recycle
                        # now; _shutdown_stream re-admits the unretired
                        # work, which re-fills the queue
                        stream = self._recycle(stream, timer, array)
                        continue
                    if not self._ready():
                        if quiescent:
                            # in-flight patches can re-enqueue (fixpoint
                            # events); only an empty queue AFTER a full
                            # drain is genuinely quiescent
                            stream.drain()
                            if not self._ready():
                                break
                            continue
                        if not self._wait_for_work():
                            if idle is not None:
                                idle()
                            continue
                    if stop_fn() or self._stop_evt.is_set():
                        break
                    if self.batch_delay > 0 and self._ready() < MIN_ACCUMULATE:
                        # the batching-delay knob: let a trickle coalesce
                        # into one micro-batch; a backlog admits at once
                        self._stop_evt.wait(self.batch_delay)
                    try:
                        if daemon._fleet_dirty:
                            # a fleet re-encode must not race in-flight
                            # chunks (the writer's retry sub-rounds encode
                            # against the live fleet): drain, then swap.
                            # Bounded wait — a writer wedged in a hung
                            # patch must not pin serve() past a stop
                            # request (the same wedge _shutdown_stream
                            # bounds); on timeout loop back so stop is
                            # re-checked and the stale fleet keeps serving
                            if not stream.drain(timeout=min(self.interval, 1.0)):
                                continue
                            array = self._array = daemon._ensure_fleet()
                        mb = self._form_batch(array)
                    except Exception:
                        # transient-error survival, the streaming analogue
                        # of the batch loop's `except Exception: log;
                        # continue` around settle(): a store blip (remote
                        # error, fencing 409 on the clean-path write) must
                        # not kill the admission service — _form_batch
                        # re-admitted its drained keys before re-raising,
                        # so nothing is lost; back off one interval
                        log.exception("streaming admission iteration")
                        self._stop_evt.wait(min(self.interval, 1.0))
                        continue
                    if mb is None:
                        continue
                    try:
                        ok = self._submit(stream, array, mb)
                    except Exception:
                        # per-batch error isolation: the failed batch
                        # re-admits with poison isolation; the service
                        # keeps serving
                        log.exception("streaming micro-batch admission")
                        self._readmit_failed(mb)
                        continue
                    if not ok:
                        if stop_fn() or self._stop_evt.is_set():
                            # the writer died because we are being deposed
                            # (fencing 409 from the new leader's store is
                            # the usual shape) — not a scheduling failure:
                            # re-admit uncharged/unmarked and let the
                            # finally shut the stream down clean
                            self._readmit_clean(mb)
                            break
                        # the writer aborted (materialize/patch failure) or
                        # a wedged writer timed the slot wait out: recover
                        # its unretired work and re-open the stream. THIS
                        # batch never entered the pipeline (a failed launch
                        # raises instead of returning False) — it is
                        # innocent of whatever killed the writer, so it
                        # re-admits clean; the culprit batch is among the
                        # unretired chunks _recycle charges
                        stream = self._recycle(stream, timer, array)
                        self._readmit_clean(mb)
                        continue
                    self._n_batches += 1
        finally:
            if stream is not None:
                # leftovers at a REQUESTED stop (shutdown/leadership loss)
                # are undone work, not failures: re-admit them without
                # suspect-marking or retry charges so the next leadership
                # resumes full-width micro-batches at full retry budget
                self._shutdown_stream(
                    stream, clean=stop_fn() or self._stop_evt.is_set()
                )
            self._array = None
            self._timer = None
            self._stop_check = lambda: False
            self._serving = False
        return self._n_batches - n0

    # -- micro-batch formation ---------------------------------------------

    def _quota(self, array) -> int:
        """Drain quota for this admission: bounded by the pipeline's
        per-chunk HBM cap and `max_batch`, and FLOORED to the shape_bucket
        lattice when the queue runs deep — a full drain then dispatches
        exactly one bucket's rows (zero pad waste) and the remainder
        admits immediately after."""
        ready = self._ready()
        cap = self.max_batch or DEFAULT_MAX_BATCH
        if array.fleet.names:
            cap = min(cap, array.pipeline_chunk_rows(len(array.fleet.names)))
        quota = min(ready, cap)
        if quota > MIN_ACCUMULATE:
            quota = max(MIN_ACCUMULATE, min(shape_floor(quota), cap))
        return quota

    def _form_batch(self, array) -> Optional[_MicroBatch]:
        daemon = self.daemon
        q = daemon.controller.queue
        keys = q.drain(self._quota(array))
        sched_queue_depth.set(float(len(q)))
        if daemon.shard_id:
            from ..metrics import shard_queue_depth

            shard_queue_depth.set(float(len(q)), shard=daemon.shard_id)
        if not keys:
            return None
        if self._suspects:
            sus = [k for k in keys if k in self._suspects]
            if sus and len(keys) > 1:
                # poison isolation: a suspect admits ALONE so a repeat
                # failure implicates exactly it; the rest of the drain
                # re-queues (readd: store-free, cached priority) and
                # admits right after
                keep = sus[0]
                for k in keys:
                    if k != keep:
                        q.readd(k)
                keys = [keep]
        from ..kernels.build import compile_counts

        # gang hold windows expire on the admission clock: reject cohorts
        # that never completed before forming the next batch
        daemon.gang_tick()
        bindings, out_keys, epochs = [], [], []
        try:
            clean = self._form_keys(daemon, keys, bindings, out_keys, epochs)
        except Exception:
            # a store read/write failed mid-drain: give EVERY drained key
            # back to the queue (the already-collected ones simply re-read
            # next time) so a transient error loses no bindings, then let
            # serve()'s survival wrap log and back off. readd, NOT add:
            # add's priority_fn reads the store — during the very outage
            # this path recovers from, a raise mid-loop would lose every
            # key after it
            for key in keys:
                q.readd(key)
            raise
        if clean:
            with self._stats_lock:
                self.stats["clean"] += clean
        if not bindings:
            return None
        with self._stats_lock:
            # formed-vs-retired ("batches") is the in-flight gauge an
            # external quiesce check needs: equal counts + empty queue
            # means nothing is mid-pipeline
            self.stats["formed"] += 1
        microbatch_size.observe(float(len(bindings)))
        return _MicroBatch(
            bindings=bindings, keys=out_keys, epochs=epochs,
            compile_snap=compile_counts(), t0=time.perf_counter(),
        )

    def _form_keys(self, daemon, keys, bindings, out_keys, epochs) -> int:
        """The store-facing half of batch formation (split out so the
        caller can re-admit `keys` wholesale when a read/write here hits a
        transient error). Returns the count of clean (needed-no-schedule)
        keys."""
        clean = 0
        observed: list = []
        # per-shard span attribution: queue_wait records WHICH shard's
        # queue held the key (empty for the unsharded singleton)
        shard_attr = {"shard": daemon.shard_id} if daemon.shard_id else {}
        # every epoch BEFORE the spec reads: an event landing in between
        # discards a decision that was in fact computed on the fresh spec
        # (one cheap re-solve via the replay cache) — the safe direction;
        # the reverse order could patch a stale decision. The reads are
        # one batch (read_bindings) where the reference reads key by key
        from .scheduler import read_bindings

        epochs_of = [daemon.admission.epoch(key) for key in keys]
        fresh = read_bindings(daemon.store, keys)
        for key, epoch, rb in zip(keys, epochs_of, fresh):
            # the gate itself is SHARED with the batch round's
            # _schedule_batch (decision-parity contract); only the
            # admission/queue bookkeeping around it is streaming's
            gate = daemon._admission_gate(rb)
            if gate == "drop":
                # tombstone or re-targeted to another scheduler: this
                # drain is the last time we see the key — clear the
                # queue's per-key bookkeeping (cached priority, retry
                # budget) and any suspect mark too, or sustained
                # create/delete churn grows them without bound
                daemon.admission.forget(key)
                daemon.controller.queue.forget(key)
                self._suspects.discard(key)
                if rb is not None and daemon._gang_of(rb):
                    daemon.gangs.discard(key, rb.spec.gang_name)
            elif gate == "suspended":
                daemon.admission.settle(key)
                if daemon._gang_of(rb):
                    daemon.gangs.discard(key, rb.spec.gang_name)
            elif gate == "schedule":
                aging = getattr(daemon.controller.queue, "aging_step", 0.0)
                if daemon._gang_holds(rb):
                    # gang member: park in the coordinator until the whole
                    # cohort is here; the completing offer releases every
                    # held member into THIS micro-batch, so a gang always
                    # solves (and commits) as one cohort. (The sharded
                    # daemon holds nothing here — _gang_holds returns ""
                    # and members ride the cross-shard commit instead.)
                    cohort = daemon.gangs.offer(key, rb, epoch)
                    if not cohort:
                        # held: the gang_hold span stays open until the
                        # completing offer (or a timeout drops the trace)
                        tracer.mark(key, "gang_hold")
                    for k2, rb2, e2 in cohort:
                        tracer.unmark(k2, "gang_hold",
                                      gang=rb.spec.gang_name)
                        tracer.drained(k2, aging, **shard_attr)
                        bindings.append(rb2)
                        out_keys.append(k2)
                        epochs.append(e2)
                    continue
                tracer.drained(key, aging, **shard_attr)
                bindings.append(rb)
                out_keys.append(key)
                epochs.append(epoch)
            else:  # clean
                daemon._record_observed(rb, sink=observed)
                daemon.admission.settle(key)
                self._suspects.discard(key)
                clean += 1
        # one batch write for the drain's observed-generation bookkeeping
        # (a raise here rides the caller's re-admit-everything contract)
        daemon._flush_observed(observed)
        return clean

    # -- launch / patch (StreamPipeline callbacks) -------------------------

    def _open_stream(self, array, timer: StageTimer) -> StreamPipeline:
        from .core import caller_stream

        # out-of-tree plugins' stateful host hooks must never run on two
        # threads (the same guard the chunked executor applies): depth 1
        # serializes admission behind the writer
        depth = 1 if array._oot_plugins else self.depth
        # the writer enters the admission thread's CUDA stream (plain and
        # tiered pendings alike): its copies back then wait for the
        # micro-batch's kernels, and its retry sub-rounds launch there
        stream = caller_stream(array.device)

        def materialize(pending):
            with torch.cuda.stream(stream):
                return array.materialize_chunk(pending)

        return StreamPipeline(
            launch=self._launch,
            materialize=materialize,
            patch=self._patch,
            depth=depth, timer=timer,
            # materialize_chunk times its own finer spans
            time_materialize=False,
            # the stream lives for the whole leadership: per-chunk results
            # must not accumulate
            keep_results=False,
        )

    def _submit(self, stream: StreamPipeline, array, mb: _MicroBatch) -> bool:
        daemon = self.daemon
        reg = daemon.estimator_registry
        extra = None
        if reg is not None:
            # each micro-batch is one logical round for the staleness
            # cache: snapshots merge within it, decay advances once
            with self._timer.stage("estimate"), reg.sweep_round():
                extra = reg.batch_estimates(mb.bindings, array.fleet.names)
            mb.swept_open = tuple(reg.last_sweep_open)
            if mb.swept_open:
                degraded_rounds.inc()
        # autoshard contract parity with the batch round; micro-batches are
        # bounded under the HBM budget, so this is a no-op check in practice
        array._maybe_autoshard(len(mb.bindings))
        # bounded-slot submit: a writer wedged in a hung patch holds every
        # depth slot, and an unbounded acquire here would pin the admission
        # loop — and a deposed leader — forever (the one wedge the
        # drain/close timeouts didn't cover). Poll so stop() and leadership
        # loss are honored mid-wait; a full minute of full slots is the
        # wedge itself — return False and let serve() recycle the stream
        # (whose close(timeout=) abandons the stuck writer)
        deadline = time.monotonic() + 60.0
        while True:
            if stream.submit(mb, extra, timeout=0.5) is not None:
                return True
            if (stream.aborted or self._stop_evt.is_set()
                    or self._stop_check()):
                return False
            if time.monotonic() >= deadline:
                return False

    def _launch(self, i: int, mb: _MicroBatch, extra):
        # routed: a mixed-priority micro-batch solves as ONE segmented
        # tiered launch (sched/preemption.py); uniform batches ride the
        # ordinary replay-aware path — identical call shape either way
        t0 = time.time()
        pending = self.daemon._launch_routed(
            self._array, mb.bindings, extra, round_rows=len(mb.bindings)
        )
        if tracer.enabled:
            # one shared launch span per micro-batch, fanned out to the
            # member traces at the patch stage (dispatch end here; the
            # device+materialize tail closes when the writer picks it up)
            mb.launch_wall = (f"launch-{i}", t0, time.time())
        mb.replayed = pending["replayed"]
        mb.solved = pending["solved"]
        return pending

    def _patch(self, i: int, mb: _MicroBatch, decisions) -> None:
        """Writer-thread patch stage: epoch-check every decision, patch the
        still-current ones, publish per-batch stats."""
        from ..kernels.build import compile_delta

        daemon = self.daemon
        q = daemon.controller.queue
        admission = daemon.admission
        placed = failed = stale = 0
        cohort = []
        stale_keys = {
            key for key, epoch0 in zip(mb.keys, mb.epochs)
            if admission.epoch(key) != epoch0
        }
        # gang stale fencing: ONE stale member vetoes its WHOLE gang — the
        # cohort must commit all K against current specs or not at all, so
        # the healthy members re-admit uncharged and the coordinator
        # reassembles the gang once the stale member's event re-offers it
        vetoed_rows: set[int] = set()
        if stale_keys:
            gang_rows: dict[str, list[int]] = {}
            for idx, rb in enumerate(mb.bindings):
                g = daemon._gang_of(rb)
                if g:
                    gang_rows.setdefault(g, []).append(idx)
            for g, idxs in gang_rows.items():
                if any(mb.keys[i] in stale_keys for i in idxs):
                    vetoed_rows.update(idxs)
                    for i in idxs:
                        # readd is a no-op for the stale member (its event
                        # already re-enqueued it) and uncharged for the rest
                        q.readd(mb.keys[i])
        for idx, (key, epoch0, rb, dec) in enumerate(
            zip(mb.keys, mb.epochs, mb.bindings, decisions)
        ):
            if idx in vetoed_rows:
                if key in stale_keys:
                    stale += 1
                continue
            if key in stale_keys:
                # dirtied mid-flight: the decision is stale — discard it;
                # the bumping event already re-enqueued the key, so the
                # binding re-admits with its fresh spec
                stale += 1
                continue
            schedule_attempts.inc(result="scheduled" if dec.ok else "error")
            cohort.append((key, rb, dec))
        # tracing: the shared solve span (launch dispatch -> writer pickup,
        # covering device compute + materialize) fans out to every row of
        # the cohort, split into dispatch vs device time; the rv-checked
        # commit below becomes each row's commit span
        t_solved = time.time()
        # coalesced patch (docs/PERF.md "Write path at fleet scale"): one
        # batch read + ONE transactional batch write for the whole cohort —
        # the micro-batch's B decisions were 2·B store round-trips
        outcomes = daemon._patch_results([(rb, dec) for _, rb, dec in cohort])
        t_committed = time.time()
        if tracer.enabled and mb.launch_wall and cohort:
            lid, l0, l1 = mb.launch_wall
            shard_attr = (
                {"shard": daemon.shard_id} if daemon.shard_id else {}
            )
            for (key, _rb, _dec), ok in zip(cohort, outcomes):
                if not ok:
                    continue
                tracer.record(key, "solve", l0, t_solved, launch=lid,
                              rows=len(mb.bindings), replayed=mb.replayed,
                              solved=mb.solved,
                              dispatch_ms=round((l1 - l0) * 1e3, 3),
                              device_ms=round((t_solved - l1) * 1e3, 3),
                              **shard_attr)
                tracer.record(key, "commit", t_solved, t_committed,
                              cohort=len(cohort), **shard_attr)
        for (key, rb, dec), ok in zip(cohort, outcomes):
            if not ok:
                # last-moment veto under the store's serialization: a
                # deletion/suspension/re-target landed AFTER the epoch
                # check above — the epoch fence is check-then-act, and
                # this closes the window. Same disposition as stale: the
                # vetoing event's own handling (tombstone drain, settle,
                # or fade-out) owns the key from here
                stale += 1
                continue
            q.forget(key)
            self._suspects.discard(key)  # a clean patch clears suspicion
            if not dec.ok:
                # unschedulable/failed: _patch_result wrote the condition
                # (and parked the key on a priority queue). The SLO
                # histogram measures time-to-PLACEMENT only — the pending
                # stretch resolves unmeasured, like the clean-drain path
                admission.settle(key)
                failed += 1
                continue
            lat = admission.observe_patch(key, daemon.clock.now())
            if lat is not None:
                # retention decision: head-sampled or SLO-breaching traces
                # survive; the retained trace id rides the SLO histogram
                # as the bucket exemplar (worst trace per bucket)
                tid = tracer.finish_placement(key, lat)
                placement_latency.observe(lat, exemplar=tid)
                with self._stats_lock:
                    self._latencies.append(lat)
            else:
                tracer.finish_placement(key, None)
            placed += 1
        e2e_scheduling_duration.observe(time.perf_counter() - mb.t0)
        # per-batch stats (the streaming analogue of the round stats).
        # Compile attribution is process-global and micro-batches overlap
        # (this batch's delta can carry a neighbor's launch compiles), but
        # the steady-state invariant — EVERY batch at zero — is exact.
        mb.stats = {
            "streaming": True,
            "replayed": mb.replayed, "solved": mb.solved,
            "batch_rows": len(mb.bindings),
            "placed": placed, "failed": failed, "stale_discarded": stale,
            "queue_depth": int(self._ready()),
            **compile_delta(mb.compile_snap),
            # candidate sparsification (sched/candidates.py): the last
            # compact round's effective K and truncation count — empty on
            # dense-solved micro-batches
            **self._array.last_candidate_stats,
        }
        self._array.last_round_stats = mb.stats
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["admitted"] += len(mb.bindings)
            self.stats["placed"] += placed
            self.stats["failed"] += failed
            self.stats["stale_discarded"] += stale
            self.stats["jit_compiles"] += int(mb.stats.get("jit_compiles", 0))

    # -- failure recovery / shutdown ---------------------------------------

    def _readmit_failed(self, mb: _MicroBatch) -> None:
        """A formed micro-batch that will never reach the patch stage:
        retire it from the formed-vs-patched in-flight gauge and re-admit
        its keys with poison isolation. A multi-key batch re-adds its keys
        UNCHARGED but marked suspect — the culprit is unknown, and burning
        every neighbor's retry budget per failure would silently drop
        healthy bindings; each suspect then re-admits as a singleton, so a
        repeat failure charges exactly the poison binding. A singleton
        failure charges its own retry/backoff budget, and a binding that
        exhausts it is dropped LOUDLY (until its next watch event)."""
        with self._stats_lock:
            self.stats["formed"] -= 1
        q = self.daemon.controller.queue
        if len(mb.keys) > 1:
            self._suspects.update(mb.keys)
            for key in mb.keys:
                q.readd(key)
            return
        for key in mb.keys:
            if not q.retry(key):
                log.error(
                    "binding %s dropped after exhausting its scheduling "
                    "retry budget (repeated micro-batch failures); it "
                    "re-admits on its next watch event", key,
                )
                self._suspects.discard(key)
                self.daemon.admission.forget(key)

    def _readmit_clean(self, mb: _MicroBatch) -> None:
        """Undone in-flight work at a requested stop (shutdown or
        leadership loss): NOT a scheduling failure — the keys re-add
        uncharged and unmarked (no suspect isolation, no retry budget), so
        a lease flap costs nothing but the re-solve. readd is store-free:
        a deposed leader's priority_fn may be mid-outage too."""
        with self._stats_lock:
            self.stats["formed"] -= 1
        q = self.daemon.controller.queue
        for key in mb.keys:
            q.readd(key)

    def _recycle(self, stream: StreamPipeline, timer: StageTimer,
                 array) -> StreamPipeline:
        leftovers = self._shutdown_stream(stream)
        log.error("streaming writer failed; re-opened stream "
                  "(re-admitted %d micro-batches)", leftovers)
        return self._open_stream(array, timer)

    def _shutdown_stream(self, stream: StreamPipeline,
                         clean: bool = False) -> int:
        """Drain + close; re-admit any unretired work (abort leftovers) so
        a failure or shutdown loses no bindings. `clean` (a requested
        stop) re-admits without failure semantics. On a writer FAILURE the
        poison-isolation discipline (_readmit_failed) is charged to the
        FIRST unretired chunk only: the writer retires strictly in
        submission order, so that is the chunk it was processing when it
        died — the trailing chunks drained un-executed and are innocent
        (suspect-marking them would force hundreds of healthy bindings
        through singleton re-admission over one store blip)."""
        stream.drain(timeout=60.0)
        # bounded close: a writer wedged in a hung patch must not pin
        # serve() forever — a deposed leader has to get back to standby
        stream.close(raise_failure=False, timeout=10.0)
        if stream.failure is not None:
            log.error("streaming stream failure: %r", stream.failure)
        leftovers = stream.unretired_chunks()
        for j, mb in enumerate(leftovers):
            if clean or j > 0:
                self._readmit_clean(mb)
            else:
                self._readmit_failed(mb)
        return len(leftovers)

    # -- introspection -----------------------------------------------------

    def latencies(self) -> list[float]:
        """Recent exact placement latencies (admission → patch), oldest
        first — the stream bench's percentile source."""
        with self._stats_lock:
            return list(self._latencies)

    def stats_snapshot(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)
