"""Pipelined round executor: overlap estimator fan-out, host encode, device
solve, and store patching (the port's copy of sched/pipeline.py).

A schedule round decomposes into five explicit stages:

    estimate     per-member estimator fan-out (chunk-shard RPC sweep)
    encode       dirty-row host encode (classify / permute / factored batch)
    solve        device kernel dispatch (CUDA launches are async — launching
                 returns immediately with device tensors)
    materialize  device-to-host copy + decision decompress/decode
    patch        store writes per decision

and the executor here runs them as a chunked software pipeline with double
buffering (GPipe, Huang et al. 2019; asynchronous dispatch per Pathways,
Barham et al. 2022): while chunk k's kernels run on device, chunk k+1's
estimator answers are prefetched on a worker thread and its rows are encoded
and dispatched on the main thread, and chunk k−1's decisions are
materialized and patched on a bounded in-order writer. The host never idles
waiting for the device, and the device never idles waiting for host encode.

Guarantees (pinned by tests/test_torch_pipeline.py):

- **Bit-identical decisions.** Rows are independent and the tie-break is
  UID-seeded, so placements do not depend on chunk boundaries; the
  pipelined executor produces exactly the serial executor's decisions.
- **Write ordering.** The writer materializes and patches chunks strictly
  in submission order, and within a chunk in binding order — per binding
  UID the store sees exactly the serial executor's write sequence.
- **Bounded in-flight work.** At most `depth` launched-but-unmaterialized
  chunks exist at any moment (double buffering at the default depth=2);
  callers halve the per-chunk row budget so the device working set stays
  inside the serial executor's HBM envelope.

Every stage records a wall-time histogram
(`karmada_schedule_stage_seconds{stage}`), and `ChunkPipeline.stats()`
reports the per-round overlap ratio: total stage seconds divided by the
round's wall seconds. Serial execution sits at ~1.0; a pipelined round
above 1.0 is overlapping by construction — the win is observable, not
asserted.

The port's `ArrayScheduler` runs chunked rounds serially unless
`KARMADA_TPU_PIPELINE=1` (or `ArrayScheduler(pipeline=True)`) turns the
pipeline on: on the card the pipelined leg measured slower (PERF.md §6).
Serially the stages run inline in order with the same timing
instrumentation, which is the serial comparison leg.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

from ..metrics import schedule_stage_seconds

STAGES = ("estimate", "encode", "solve", "materialize", "patch")

# bounded in-flight chunks: the "double" in double buffering — one chunk
# materializing while the next solves (callers size chunks so depth x chunk
# stays inside the serial executor's per-launch HBM budget)
DEFAULT_DEPTH = 2


def resolve_pipeline(override: Optional[bool] = None, default: bool = True) -> bool:
    """Pipeline enablement: explicit override, else KARMADA_TPU_PIPELINE
    (0/off/false disables, 1/on/true enables), else `default` (on, as the
    reference; the port's ArrayScheduler passes off)."""
    if override is not None:
        return bool(override)
    env = os.environ.get("KARMADA_TPU_PIPELINE", "")
    if env in ("0", "off", "false"):
        return False
    return True if env in ("1", "on", "true") else default


class StageTimer:
    """Thread-safe per-stage wall-time accumulator.

    Every `stage()` span observes `karmada_schedule_stage_seconds{stage}`
    and adds to this round's per-stage totals; `trace` (optional) receives
    (stage, tag, event, t) at span begin/end — the fake-clock stage-trace
    tests reconstruct the interleaving from it. `clock` is injectable for
    those tests."""

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        trace: Optional[Callable[[str, object, str, float], None]] = None,
    ) -> None:
        self.clock = clock
        self.trace = trace
        self._lock = threading.Lock()
        self.totals: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str, tag=None):
        t0 = self.clock()
        if self.trace is not None:
            self.trace(name, tag, "begin", t0)
        try:
            yield
        finally:
            t1 = self.clock()
            if self.trace is not None:
                self.trace(name, tag, "end", t1)
            dt = t1 - t0
            schedule_stage_seconds.observe(dt, stage=name)
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt


@contextmanager
def stage_span(name: str, timer: Optional[StageTimer] = None, tag=None):
    """One stage span: into `timer` when a pipeline is driving the round,
    else straight to the histogram (serial single-round callers get stage
    observability too)."""
    if timer is not None:
        with timer.stage(name, tag=tag):
            yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        schedule_stage_seconds.observe(time.perf_counter() - t0, stage=name)


class _Done:
    pass


_DONE = _Done()


class StreamPipeline:
    """Open-ended chunk stream: the launch→materialize→patch tail of the
    pipeline without a fixed chunk list.

    `ChunkPipeline` runs a round whose chunks are all known up front; the
    streaming scheduler (sched/streaming.py) has no round — micro-batches
    form one at a time as watch events accumulate, and each is submitted
    the moment it exists. This class owns the shared machinery: `submit()`
    launches a chunk on the caller's thread (host encode + async device
    dispatch, no sync) and hands it to a writer thread that materializes
    and patches chunks strictly in submission order, while a semaphore
    bounds launched-but-unretired chunks at `depth` (the same double
    buffering bound — in-flight device work never exceeds depth × chunk).
    The caller's thread is free the moment `submit()` returns: the
    admission loop goes back to accumulating the NEXT micro-batch while
    this one solves on device, which is exactly how new work is admitted
    into the gaps of an already-running pipeline.

    Failure semantics match ChunkPipeline: the first exception from any
    stage aborts the stream — later submitted chunks drain un-executed,
    `submit()` returns None once aborted, and `close()` re-raises (or
    returns quietly with `.failure` set when `raise_failure=False`, for
    callers that must sequence their own cleanup first). `chunk_of()`
    exposes the un-retired chunks so an aborting caller can re-enqueue
    their work instead of losing it."""

    def __init__(
        self,
        launch: Callable,
        *,
        materialize: Optional[Callable] = None,
        patch: Optional[Callable] = None,
        depth: int = DEFAULT_DEPTH,
        timer: Optional[StageTimer] = None,
        time_materialize: bool = True,
        keep_results: bool = True,
        name: str = "sched-stream-writer",
    ) -> None:
        self.launch = launch
        self.materialize = materialize
        self.patch = patch
        self.depth = max(1, depth)
        self.timer = timer or StageTimer()
        self.time_materialize = time_materialize
        # a long-lived stream (the streaming daemon runs ONE for its whole
        # leadership) must not accumulate per-chunk state: with
        # keep_results=False the writer drops a chunk's result and its
        # chunk ref the moment it retires cleanly
        self.keep_results = keep_results
        self.failure: Optional[BaseException] = None
        self._abort = threading.Event()
        self._slots = threading.Semaphore(self.depth)
        # the launch-slot semaphore already bounds in-flight chunks to
        # `depth`; the queue bound (+1 for the close sentinel) makes the
        # invariant structural (thread-hygiene rule: every ring bounded)
        self._q: queue.Queue = queue.Queue(maxsize=self.depth + 1)
        self._lock = threading.Lock()
        self._retired_cv = threading.Condition(self._lock)
        self._results: dict[int, object] = {}
        self._pending_chunks: dict[int, object] = {}
        self._submitted = 0
        self._retired = 0
        self._closed = False
        self._writer = threading.Thread(
            target=self._writer_main, name=name, daemon=True
        )
        self._writer.start()

    # -- caller side -------------------------------------------------------

    def submit(self, chunk, est=None,
               timeout: Optional[float] = None) -> Optional[int]:
        """Launch `chunk` on this thread and queue it for the writer.
        Blocks while `depth` chunks are already in flight — bounded by
        `timeout` when given (a writer wedged in a hung patch holds every
        slot; an unbounded acquire would pin the caller forever). Returns
        the chunk's stream index, or None when the stream aborted or the
        slot wait timed out (distinguish via `.aborted`; on timeout no
        state was touched — the caller may retry). A `launch` exception
        propagates here, after its slot is returned."""
        if self._closed:
            raise RuntimeError("stream already closed")
        if timeout is None:
            self._slots.acquire()
        elif not self._slots.acquire(timeout=timeout):
            return None
        if self._abort.is_set():
            self._slots.release()
            return None
        i = self._submitted
        try:
            pending = self.launch(i, chunk, est)
        except BaseException:
            self._slots.release()
            raise
        self._submitted = i + 1
        with self._lock:
            self._pending_chunks[i] = chunk
        self._q.put((i, chunk, pending))
        return i

    def abort(self) -> None:
        """Stop executing: chunks not yet materialized drain un-patched
        (their work is recoverable via `unretired_chunks`)."""
        self._abort.set()

    @property
    def aborted(self) -> bool:
        return self._abort.is_set()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted chunk has retired (materialized and
        patched, or abort-drained). True unless the timeout hit."""
        with self._retired_cv:
            return self._retired_cv.wait_for(
                lambda: self._retired >= self._submitted, timeout
            )

    def unretired_chunks(self) -> list:
        """Chunks submitted but not fully patched (abort/failure leftovers;
        empty after a clean drain) — the caller re-admits their work."""
        with self._lock:
            return [
                self._pending_chunks[i] for i in sorted(self._pending_chunks)
            ]

    def close(self, raise_failure: bool = True,
              timeout: Optional[float] = None) -> dict[int, object]:
        """Shut the writer down once the queued chunks drain; returns the
        per-index results. Re-raises the first stage failure unless
        `raise_failure=False` (then read `.failure`). Idempotent.
        `timeout` bounds the writer join: a writer WEDGED in a stage (a
        hung store patch, a stuck device sync) would otherwise block the
        caller forever — on expiry the stream aborts, records a failure,
        and the (daemon) writer thread is abandoned; its chunks stay
        recoverable via `unretired_chunks()`."""
        if not self._closed:
            self._closed = True
            self._q.put(_DONE)
        self._writer.join(timeout)
        if self._writer.is_alive():
            self._abort.set()
            if self.failure is None:
                self.failure = RuntimeError(
                    f"stream writer did not retire within {timeout}s"
                )
        if raise_failure and self.failure is not None:
            raise self.failure
        with self._lock:
            return dict(self._results)

    # -- writer side -------------------------------------------------------

    def _materialize_one(self, i: int, pending):
        if self.materialize is None:
            return pending
        if self.time_materialize:
            with self.timer.stage("materialize", tag=i):
                return self.materialize(pending)
        return self.materialize(pending)

    def _writer_main(self) -> None:
        while True:
            item = self._q.get()
            if item is _DONE:
                return
            i, chunk, pending = item
            try:
                if self._abort.is_set():
                    continue  # drain without executing past a failure
                try:
                    result = self._materialize_one(i, pending)
                    if self.patch is not None:
                        with self.timer.stage("patch", tag=i):
                            self.patch(i, chunk, result)
                    with self._lock:
                        self._pending_chunks.pop(i, None)
                        if self.keep_results:
                            self._results[i] = result
                except BaseException as e:  # noqa: BLE001 - close() re-raises
                    if self.failure is None:
                        self.failure = e
                    self._abort.set()
            finally:
                self._slots.release()  # chunk fully retired: slot frees
                with self._retired_cv:
                    self._retired += 1
                    self._retired_cv.notify_all()


class ChunkPipeline:
    """The chunked software pipeline.

    Callbacks (any may be None except `launch`):

      estimate(chunk)            -> est        (prefetch thread, stage
                                                "estimate")
      launch(index, chunk, est)  -> pending    (main thread; times its own
                                                encode/solve stages via the
                                                shared timer)
      materialize(pending)       -> result     (writer thread, stage
                                                "materialize" unless the
                                                callee times finer spans)
      patch(index, chunk, result)              (writer thread, stage
                                                "patch")

    `run(chunks)` returns the per-chunk results in order. Chunks are
    materialized/patched strictly in submission order; at most `depth`
    launched chunks wait for the writer. With `pipelined=False` the same
    callbacks run inline in order — the serial executor with identical
    instrumentation.

    The first exception from any stage aborts the round: the remaining
    chunks are neither launched nor patched, and the exception re-raises on
    the caller's thread (the scheduler's per-key error isolation then takes
    over, exactly as for a serial round)."""

    def __init__(
        self,
        launch: Callable,
        *,
        estimate: Optional[Callable] = None,
        materialize: Optional[Callable] = None,
        patch: Optional[Callable] = None,
        depth: int = DEFAULT_DEPTH,
        pipelined: bool = True,
        timer: Optional[StageTimer] = None,
        time_materialize: bool = True,
    ) -> None:
        self.launch = launch
        self.estimate = estimate
        self.materialize = materialize
        self.patch = patch
        self.depth = max(1, depth)
        self.pipelined = pipelined
        self.timer = timer or StageTimer()
        # callees that time their own finer materialize spans set this False
        self.time_materialize = time_materialize
        self.wall_seconds = 0.0

    # -- serial leg --------------------------------------------------------

    def _run_serial(self, chunks: Sequence) -> list:
        out = []
        for i, chunk in enumerate(chunks):
            est = None
            if self.estimate is not None:
                with self.timer.stage("estimate", tag=i):
                    est = self.estimate(chunk)
            pending = self.launch(i, chunk, est)
            result = self._materialize_one(i, pending)
            if self.patch is not None:
                with self.timer.stage("patch", tag=i):
                    self.patch(i, chunk, result)
            out.append(result)
        return out

    def _materialize_one(self, i: int, pending):
        if self.materialize is None:
            return pending
        if self.time_materialize:
            with self.timer.stage("materialize", tag=i):
                return self.materialize(pending)
        return self.materialize(pending)

    # -- pipelined leg -----------------------------------------------------

    def _run_pipelined(self, chunks: Sequence) -> list:
        """A fixed chunk list is just a stream that closes after its last
        submit: the launch/materialize/patch tail (writer thread, in-order
        patching, depth-bounded double buffering) is StreamPipeline's; this
        leg only adds the estimate PREFETCH — chunk i+1's estimator fan-out
        runs on a worker thread while chunk i encodes and solves, which
        needs the full chunk list and so cannot live in the open-ended
        stream."""
        n = len(chunks)
        stream = StreamPipeline(
            launch=self.launch, materialize=self.materialize,
            patch=self.patch, depth=self.depth, timer=self.timer,
            time_materialize=self.time_materialize,
            name="sched-pipeline-writer",
        )

        est_box: dict[int, object] = {}
        est_lock = threading.Lock()
        est_ready: dict[int, threading.Event] = {}
        est_err: list[BaseException] = []

        def prefetch(i: int) -> None:
            try:
                with self.timer.stage("estimate", tag=i):
                    est = self.estimate(chunks[i])
                with est_lock:
                    est_box[i] = est
            except BaseException as e:  # noqa: BLE001
                est_err.append(e)
                stream.abort()
            finally:
                est_ready[i].set()

        prefetcher: Optional[threading.Thread] = None

        def start_prefetch(i: int) -> Optional[threading.Thread]:
            if self.estimate is None or i >= n:
                return None
            est_ready[i] = threading.Event()
            t = threading.Thread(
                target=prefetch, args=(i,),
                name="sched-pipeline-estimate", daemon=True,
            )
            t.start()
            return t

        try:
            prefetcher = start_prefetch(0)
            for i, chunk in enumerate(chunks):
                est = None
                if self.estimate is not None:
                    est_ready[i].wait()
                    if est_err:
                        break
                    with est_lock:
                        est = est_box.pop(i)
                    # chunk i+1's fan-out runs while chunk i encodes/solves
                    prefetcher = start_prefetch(i + 1)
                if stream.submit(chunk, est) is None:
                    break  # a stage failed: stop launching, drain below
        finally:
            # close() drains the queued chunks and joins the writer; a
            # launch exception propagates from the try body AFTER cleanup
            results = stream.close(raise_failure=False)
            if prefetcher is not None:
                prefetcher.join()
        if est_err:
            raise est_err[0]
        if stream.failure is not None:
            raise stream.failure
        return [results.get(i) for i in range(n)]

    def run(self, chunks: Sequence) -> list:
        t0 = time.perf_counter()
        try:
            if not self.pipelined or len(chunks) <= 1:
                return self._run_serial(chunks)
            return self._run_pipelined(chunks)
        finally:
            self.wall_seconds = time.perf_counter() - t0

    def stats(self) -> dict:
        """Per-round pipeline stats: stage seconds, wall seconds, and the
        overlap ratio (total stage seconds / wall seconds; ~1.0 serial,
        >1.0 when stages overlapped)."""
        totals = dict(self.timer.totals)
        busy = sum(totals.values())
        wall = self.wall_seconds
        return {
            "pipelined": self.pipelined,
            "stage_seconds": {k: round(v, 6) for k, v in totals.items()},
            "wall_seconds": round(wall, 6),
            "overlap_ratio": round(busy / wall, 4) if wall > 0 else 0.0,
        }


def chunk_spans(total: int, rows: int) -> list[tuple[int, int]]:
    """[start, end) spans chunking `total` rows at `rows` per chunk."""
    rows = max(1, rows)
    return [(s, min(s + rows, total)) for s in range(0, total, rows)]


def plan_chunk_rows(total: int, cap: int) -> int:
    """Equalized chunk-size schedule: the rows-per-chunk that splits `total`
    into the same number of chunks a greedy cap-sized split would, but with
    EQUAL chunks snapped to the shape_bucket lattice. The greedy schedule
    (cap, cap, ..., remainder) wastes twice — the ragged tail pads to its
    own (different) bucket, compiling a second program per kernel, and the
    full chunks may sit just above a lattice point, padding maximally. At
    the 40k×20k flagship the greedy split is 12288×3 + 3136 (two compiled
    shapes, 3.1k pad rows); the equalized split is 10240×4 — one shape,
    960 pad rows (the profiled chunk-size half of the HBM-chunking fix,
    docs/PERF.md compile economics).

    The guarantee is "never more program shapes than the greedy split,
    usually one" — NOT always one: when the tail chunk falls below the
    rows bucket's predecessor lattice point (e.g. total=2100, cap=2048 →
    1536 + 564, buckets {1536, 768}), the round still pads two shapes;
    both are on the lattice, so they amortize across rounds either way."""
    from ..models.batch import shape_bucket

    cap = max(1, cap)
    if total <= cap:
        return cap
    n_chunks = -(-total // cap)
    rows = shape_bucket(-(-total // n_chunks))
    return min(rows, cap)
