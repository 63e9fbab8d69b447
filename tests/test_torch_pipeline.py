"""The port's chunked round held against the JAX ArrayScheduler: rounds over
the per-launch row cap cut into equal lattice chunks and run through the
chunk pipeline (sched/pipeline.py) or serially, with identical decisions —
targets, replica counts, feasible lists, error strings and applied
affinity-term names — whichever package and executor runs them. Also the
pipeline's own helpers against the reference's, the stage-seconds
histogram, failure propagation and the launch counters under threads."""
import contextlib
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.sched import pipeline as jpipe  # noqa: E402

from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch import metrics as tmetrics  # noqa: E402
from karmada_tpu_torch.convert import from_reference_objects  # noqa: E402
from karmada_tpu_torch.sched import core  # noqa: E402
from karmada_tpu_torch.sched import pipeline as tpipe  # noqa: E402
from karmada_tpu_torch.sched import preemption as tpre  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402

from test_torch_scheduler import _decision_view, flagship_mix  # noqa: E402


@pytest.mark.parametrize("total,cap", [
    (10, 10), (10000, 1024), (10000, 512), (40000, 6144), (40000, 10240), (2100, 2048),
    (1, 8), (97, 24),
])
def test_chunk_plan_matches_reference(total, cap):
    rows = tpipe.plan_chunk_rows(total, cap)
    assert rows == jpipe.plan_chunk_rows(total, cap)
    assert tpipe.chunk_spans(total, rows) == jpipe.chunk_spans(total, rows)


@pytest.mark.parametrize("env,override", [
    ("", None), ("0", None), ("off", None), ("false", None), ("1", None), ("0", True),
    ("", False),
])
def test_resolve_pipeline_matches_reference(env, override, monkeypatch):
    """With the reference's default (on) the switch reads as the
    reference's; the port's scheduler defaults to off and turns the
    pipeline on only when asked."""
    monkeypatch.setenv("KARMADA_TPU_PIPELINE", env)
    assert tpipe.resolve_pipeline(override) == jpipe.resolve_pipeline(override)
    port_default = tpipe.resolve_pipeline(override, default=False)
    assert port_default == (override if override is not None else env == "1")


@pytest.mark.parametrize("budget,pipeline", [(96 * 24, True), (96 * 24, False), (2 << 27, True),
                                             (96 * 700, True)])
def test_round_chunk_rows_match_reference(budget, pipeline):
    """pipeline_chunk_rows, round_chunk_rows and the per-launch row cap of
    the two schedulers over one fleet, at several budgets and row counts."""
    clusters, _ = flagship_mix(n_bindings=1)
    ref = jcore.ArrayScheduler(clusters, candidate_k=16, pipeline=pipeline, autoshard=False)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=16, device="cpu",
                          pipeline=pipeline)
    ref.max_bc_elems = port.max_bc_elems = budget
    C = len(port.fleet.names)
    assert port._max_rows_per_round(C) == ref._max_rows_per_round(C)
    assert port.pipeline_chunk_rows(C) == ref.pipeline_chunk_rows(C)
    for n in (1, 100, 255, 256, 512, 513, 700, 3000, 20000):
        assert port.round_chunk_rows(n) == ref.round_chunk_rows(n), n


def _chunked_pair(clusters, pipeline, candidate_k, budget):
    ref = jcore.ArrayScheduler(clusters, candidate_k=candidate_k, pipeline=pipeline,
                               autoshard=False)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=candidate_k,
                          device="cpu", pipeline=pipeline)
    ref.max_bc_elems = port.max_bc_elems = budget
    return ref, port


@pytest.mark.parametrize("candidate_k,with_extra", [(16, False), (16, True), (0, False)])
def test_chunked_rounds_match_jax(candidate_k, with_extra):
    """A round cut into >= 3 chunks: port pipelined = port serial = JAX
    pipelined = JAX serial, compact (candidate_k=16) and dense
    (candidate_k=0), with and without estimator answers; the chunk plans
    agree."""
    clusters, bindings = flagship_mix(seed=2, n_bindings=120)
    port_bindings = from_reference_objects(bindings)
    extra = None
    if with_extra:
        rng = np.random.default_rng(3)
        extra = np.where(rng.random((len(bindings), 96)) < 0.3, -1,
                         rng.choice([0, 2, 9, 1 << 20], (len(bindings), 96))).astype(np.int32)
    views = {}
    stats = {}
    for pipeline in (True, False):
        ref, port = _chunked_pair(clusters, pipeline, candidate_k, 24 * 96)
        want = ref.schedule(bindings, extra_avail=extra)
        got = port.schedule(port_bindings, extra_avail=extra)
        views[("jax", pipeline)] = [_decision_view(d) for d in want]
        views[("port", pipeline)] = [_decision_view(d) for d in got]
        for name, s in (("jax", ref), ("port", port)):
            st = s.last_pipeline_stats
            stats[(name, pipeline)] = (st["chunks"], st["chunk_rows"], st["pipelined"])
            assert set(st["stage_seconds"]) <= {"encode", "solve", "materialize"}
            assert st["wall_seconds"] > 0 and st["overlap_ratio"] > 0
    first = views[("jax", False)]
    assert all(v == first for v in views.values())
    assert stats[("port", True)] == stats[("jax", True)]
    assert stats[("port", False)] == stats[("jax", False)]
    assert stats[("port", True)][0] >= 3 and stats[("port", False)][0] >= 3
    assert any(v[2] == "backup" for v in first)  # the ordered-affinity retry ran


def test_affinity_retry_runs_on_the_writer_thread(monkeypatch):
    """The pipelined round materializes on its writer thread, so the
    ordered-affinity retry's sub-rounds launch there (under the encode
    lock) while the caller's thread launches the next chunk; decisions
    equal the JAX round's."""
    clusters, bindings = flagship_mix(seed=4, n_bindings=120)
    ref, port = _chunked_pair(clusters, True, 16, 24 * 96)
    threads = []
    orig = port._schedule_once

    def spy(*a, **kw):
        threads.append(threading.current_thread().name)
        return orig(*a, **kw)

    monkeypatch.setattr(port, "_schedule_once", spy)
    got = port.schedule(from_reference_objects(bindings))
    want = ref.schedule(bindings)
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
    assert threads and set(threads) == {"sched-pipeline-writer"}


def test_scheduler_runs_chunks_serially_by_default(monkeypatch):
    """The port's scheduler runs chunked rounds serially unless the
    pipeline is asked for, by argument or by KARMADA_TPU_PIPELINE."""
    clusters, _ = flagship_mix(n_bindings=1)
    port_clusters = from_reference_objects(clusters)
    for env, arg, want in (("", None, False), ("1", None, True), ("0", True, True),
                           ("", True, True), ("1", False, False)):
        monkeypatch.setenv("KARMADA_TPU_PIPELINE", env)
        port = TorchScheduler(port_clusters, candidate_k=16, device="cpu", pipeline=arg)
        assert port.pipeline_enabled is want, (env, arg)


class _Copied:
    def synchronize(self) -> None:
        pass


class _FakeCardStaging(core.PinnedStaging):
    """PinnedStaging's card branch on the CPU: the pinned buffer is a plain
    tensor, and the host-to-device copy reads the buffer a moment after it
    is enqueued, as a non-blocking copy does when the stream gets to it.
    Records the threads that uploaded."""

    def __init__(self):
        super().__init__()
        self.threads = set()

    @staticmethod
    def _pinned(nbytes):
        return torch.empty(nbytes, dtype=torch.uint8)

    def _copy(self, host, device):
        self.threads.add(threading.current_thread().name)
        time.sleep(0.002)
        return host.clone(), _Copied()


def test_pinned_staging_uploads_one_at_a_time():
    """Two threads uploading through the one staging buffer each get their
    own answers back: no fill lands while another thread's copy out of the
    buffer is still queued."""
    staging = _FakeCardStaging()
    card = torch.device("cuda")
    bad = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(25):
            extra = rng.integers(-1, 50, (6, 5)).astype(np.int32)
            got = staging.upload(extra, 8, 7, card).numpy()
            want = np.full((8, 7), -1, np.int32)
            want[:6, :5] = extra
            if not np.array_equal(got, want):
                bad.append(seed)

    threads = [threading.Thread(target=worker, args=(seed,)) for seed in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert bad == [] and len(staging.threads) == 2


def test_pipelined_answers_with_retries_on_a_faked_card(monkeypatch):
    """A pipelined chunked round with estimator answers whose ordered
    affinity terms retry on the writer thread, the answers staged through
    the card's pinned-buffer path: both threads upload, and the decisions
    equal the serial leg's and the JAX round's."""
    clusters, bindings = flagship_mix(seed=4, n_bindings=120)
    rng = np.random.default_rng(5)
    extra = np.where(rng.random((len(bindings), 96)) < 0.3, -1,
                     rng.choice([0, 2, 9, 1 << 20], (len(bindings), 96))).astype(np.int32)
    port_bindings = from_reference_objects(bindings)
    views = {}
    staged = {}
    for pipeline in (True, False):
        ref, port = _chunked_pair(clusters, pipeline, 16, 24 * 96)
        staging = staged[pipeline] = _FakeCardStaging()
        monkeypatch.setattr(port, "_upload_extra", lambda e, n, port=port, staging=staging: (
            None if e is None
            else staging.upload(e, n, len(port.fleet.names), torch.device("cuda"))))
        views[("port", pipeline)] = [_decision_view(d)
                                     for d in port.schedule(port_bindings, extra_avail=extra)]
        views[("jax", pipeline)] = [_decision_view(d)
                                    for d in ref.schedule(bindings, extra_avail=extra)]
    first = views[("jax", False)]
    assert all(v == first for v in views.values())
    assert any(v[2] == "backup" for v in first)  # the ordered-affinity retry ran
    assert staged[True].threads == {"MainThread", "sched-pipeline-writer"}
    assert staged[False].threads == {"MainThread"}


def test_writer_enters_the_callers_stream(monkeypatch):
    """A stream is current per thread: the writer materializes each chunk,
    and launches its retry sub-rounds, inside the stream the caller had
    current when it called schedule()."""
    clusters, bindings = flagship_mix(seed=4, n_bindings=120)
    ref, port = _chunked_pair(clusters, True, 16, 24 * 96)
    caller = object()
    current = threading.local()
    entered = []

    @contextlib.contextmanager
    def fake_stream(stream):
        entered.append((threading.current_thread().name, stream))
        prev = getattr(current, "stream", None)
        current.stream = stream
        try:
            yield
        finally:
            current.stream = prev

    retry_streams = []
    orig = port._schedule_once

    def spy(*a, **kw):
        retry_streams.append(getattr(current, "stream", None))
        return orig(*a, **kw)

    monkeypatch.setattr(core, "caller_stream", lambda device: caller)
    monkeypatch.setattr(torch.cuda, "stream", fake_stream)
    monkeypatch.setattr(port, "_schedule_once", spy)
    got = port.schedule(from_reference_objects(bindings))
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in ref.schedule(bindings)]
    assert entered == [("sched-pipeline-writer", caller)] * port.last_pipeline_stats["chunks"]
    assert retry_streams and set(retry_streams) == {caller}


def test_materialize_failure_propagates(monkeypatch):
    """A failure in a chunk's materialize half aborts the round and
    re-raises on the caller's thread, pipelined or serial; the pipeline
    context is restored."""
    clusters, bindings = flagship_mix(n_bindings=96)
    port_bindings = from_reference_objects(bindings)
    for pipeline in (True, False):
        port = TorchScheduler(from_reference_objects(clusters), candidate_k=16, device="cpu",
                              pipeline=pipeline)
        port.max_bc_elems = 24 * 96
        calls = []
        orig = port._materialize_solve

        def failing(state, calls=calls, orig=orig):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("materialize failed")
            return orig(state)

        monkeypatch.setattr(port, "_materialize_solve", failing)
        with pytest.raises(RuntimeError, match="materialize failed"):
            port.schedule(port_bindings)
        assert port.stage_timer is None
    stream_fail = tpipe.ChunkPipeline(launch=lambda i, c, est: c,
                                      materialize=lambda p: 1 // (p - 2))
    with pytest.raises(ZeroDivisionError):
        stream_fail.run([0, 1, 2, 3])


def test_stage_seconds_histogram_and_round_stats():
    """Every stage span observes karmada_schedule_stage_seconds{stage}, a
    serial single-chunk round included, and the histogram renders."""
    clusters, bindings = flagship_mix(n_bindings=32)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=16, device="cpu")
    h = tmetrics.schedule_stage_seconds
    before = {s: h.count(stage=s) for s in ("encode", "solve", "materialize")}
    port.schedule(from_reference_objects(bindings))
    assert port.last_pipeline_stats is None  # one chunk: no pipeline ran
    for s, n in before.items():
        assert h.count(stage=s) > n, s
    text = tmetrics.registry.render()
    assert 'karmada_schedule_stage_seconds_bucket{stage="encode",le="+Inf"}' in text
    assert "# TYPE karmada_schedule_stage_seconds histogram" in text


def test_launch_counters_under_threads():
    """The kernel launch counts and the tiered/preempt counters are bumped
    under a lock: threads racing on them, with a tiny switch interval,
    lose no update."""
    kernels.reset_launches()
    n0 = (tpre.LAUNCHES.tiered, tpre.LAUNCHES.preempt)
    per_thread = 20000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(per_thread):
                kernels._launched("candidate_tail")
                tpre.LAUNCHES.bump("tiered")

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts()["candidate_tail"] == 8 * per_thread
    assert tpre.LAUNCHES.tiered - n0[0] == 8 * per_thread
    assert tpre.LAUNCHES.preempt == n0[1]
    kernels.reset_launches()
    assert set(kernels.launch_counts().values()) == {0}
