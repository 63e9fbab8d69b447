"""The port's `StreamingScheduler` held against the JAX package's, after the
reference's streaming tests (tests/test_streaming.py `TestStreamingParity`,
`TestEpochStaleness`, `TestPoisonIsolation`, `TestZeroCompileDrift`) on the
same fixtures with explicit uids: micro-batch decisions equal one batch
round of either package, a binding dirtied mid-flight is discarded and
re-admitted, a poison binding is isolated without costing its neighbours,
the per-batch build count stays 0, and a gang released into a micro-batch
commits whole. Every serve ends on `quiescent=True`; no test waits on the
wall clock."""
from __future__ import annotations

import copy
import importlib

import pytest

torch = pytest.importorskip("torch")

import tests.test_preemption as jpre  # noqa: E402
import tests.test_streaming as jstream  # noqa: E402
from tests.test_parallel import dyn_placement, make_binding  # noqa: E402

from test_torch_daemon import Pair, Side, _fleet, _names  # noqa: E402


def _placements(side) -> dict:
    return jstream.placements(side.store)


@pytest.mark.parametrize("max_batch", [0, 4], ids=["one_serve", "trickle_max4"])
def test_streaming_matches_one_shot_round(max_batch):
    """The port's streaming service (one serve, or a trickle of creates
    each quiesced in micro-batches of at most 4) places every binding as
    one batch round of the reference daemon and of the port's own, and as
    the reference's streaming service does."""
    bindings = jstream.mixed_bindings(_names(), n=18)
    batch = Pair(_fleet())
    batch.create(bindings)
    batch.settle()
    want = batch.check()

    streams = [Side(p, _fleet()) for p in ("karmada_tpu", "karmada_tpu_torch")]
    svcs = [s.daemon.streaming(batch_delay=0.0, max_batch=max_batch) for s in streams]
    for s, svc in zip(streams, svcs):
        if max_batch:
            for rb in bindings:
                s.create(rb)
                svc.serve(quiescent=True)
        else:
            for rb in bindings:
                s.create(rb)
            assert svc.serve(quiescent=True) >= 1
    ref_s, port_s = streams
    got = _placements(port_s)
    assert got == _placements(ref_s) == _placements(batch.ref)
    assert got == {k: v[2] for k, v in want.items()}
    assert all(got.values()), "every binding placed"
    # conditions and applied annotations as the reference's streaming run
    strip = (lambda v: {k: (x[2], x[3], x[4], x[5]) for k, x in v.items()})
    assert strip(port_s.view()) == strip(ref_s.view())
    stats = port_s.daemon._array.last_round_stats
    assert stats.get("streaming") is True
    assert "stale_discarded" in stats and "queue_depth" in stats
    # the patches' own watch events re-admit the bindings once more (the
    # fixpoint): every binding placed at least once, each measured
    snap = svcs[1].stats_snapshot()
    assert snap["placed"] >= len(bindings) and snap["failed"] == 0
    assert snap["jit_compiles"] == 0
    assert len(svcs[1].latencies()) >= len(bindings)


def _midflight(side):
    """The reference's TestEpochStaleness recipe on one package: returns
    (stale discarded by the hand-formed batch, placed replicas after)."""
    svc = side.daemon.streaming(batch_delay=0.0)
    side.create(make_binding("app-x", 3, dyn_placement(), cpu=0.25))
    svc.serve(quiescent=True)
    placed_3 = _placements(side)["app-x"]
    fresh = side.binding("app-x")
    fresh.spec.replicas = 5
    side.store.update(fresh)
    array = side.daemon._ensure_fleet()
    svc._array = array
    svc._timer = importlib.import_module(f"{side.m.pkg}.sched.pipeline").StageTimer()
    mb = svc._form_batch(array)
    assert mb is not None and mb.bindings[0].spec.replicas == 5
    fresh = side.binding("app-x")
    fresh.spec.replicas = 9
    side.store.update(fresh)  # dirties mid-flight
    with array.pipeline_context(svc._timer, overlap=True):
        stream = svc._open_stream(array, svc._timer)
        assert svc._submit(stream, array, mb)
        stream.drain()
        stream.close(raise_failure=True)
    svc._array = svc._timer = None
    stale = side.daemon._array.last_round_stats["stale_discarded"]
    assert _placements(side)["app-x"] == placed_3  # the replicas=5 decision was discarded
    assert svc._ready() > 0  # the dirtying event re-admitted the key
    svc.serve(quiescent=True)
    return stale, _placements(side)["app-x"], svc.stats_snapshot()["stale_discarded"]


def test_midflight_dirty_discards_and_readmits():
    want, got = (_midflight(Side(p, _fleet())) for p in ("karmada_tpu", "karmada_tpu_torch"))
    assert got == want
    assert got[0] == 1 and sum(r for _, r in got[1]) == 9 and got[2] >= 1


def _poison(side) -> dict:
    svc = side.daemon.streaming(batch_delay=0.0)
    for rb in jstream.mixed_bindings(_names(), n=6):
        side.create(rb)
    side.create(make_binding("poison", 3, dyn_placement(), cpu=0.25))
    array = side.daemon._ensure_fleet()
    orig = array.launch_chunk

    def launch(bindings, extra, round_rows=None):
        if any(rb.metadata.name == "poison" for rb in bindings):
            raise RuntimeError("poison row")
        return orig(bindings, extra, round_rows=round_rows)

    array.launch_chunk = launch
    svc.serve(quiescent=True)
    first = _placements(side)
    array.launch_chunk = orig
    fresh = side.binding("poison")
    fresh.spec.replicas = 4
    side.store.update(fresh)
    svc.serve(quiescent=True)
    return {"first": first, "healed": _placements(side)}


def test_poison_binding_is_isolated():
    want, got = (_poison(Side(p, _fleet())) for p in ("karmada_tpu", "karmada_tpu_torch"))
    assert got == want
    assert got["first"]["poison"] == ()
    assert all(v for k, v in got["first"].items() if k != "poison"), "a neighbour lost"
    assert sum(r for _, r in got["healed"]["poison"]) == 4


def test_in_bucket_drift_builds_nothing():
    """Micro-batches whose row counts drift inside one shape bucket: every
    batch reports jit_compiles == 0 (the port builds libraries once a
    process; on the CPU it builds none), and placements follow the
    reference's streaming service wave by wave."""
    sides = [Side(p, _fleet()) for p in ("karmada_tpu", "karmada_tpu_torch")]
    svcs = [s.daemon.streaming(batch_delay=0.0) for s in sides]
    for s, svc in zip(sides, svcs):
        for rb in jstream.mixed_bindings(_names(), n=8):
            s.create(rb)
        svc.serve(quiescent=True)

    def dirty(side, lo, hi):
        for i in range(lo, hi):
            rb = side.binding(f"app-{i}")
            rb.spec.replicas += 1
            side.store.update(rb)

    for lo in (0, 0, 1, 2):
        for s, svc in zip(sides, svcs):
            dirty(s, lo, 7)
            svc.serve(quiescent=True)
        port = sides[1]
        assert port.daemon._array.last_round_stats.get("jit_compiles", 0) == 0
        assert _placements(port) == _placements(sides[0])
    assert svcs[1].stats_snapshot()["jit_compiles"] == 0


def test_streamed_gang_commits_whole():
    """A gang released into one micro-batch commits as one cohort, on
    contiguous rvs, as in the reference."""
    sides = [Side(p, jpre.tight_fleet(free=(8.0, 8.0))) for p in ("karmada_tpu",
                                                                   "karmada_tpu_torch")]
    for s in sides:
        svc = s.daemon.streaming(batch_delay=0.0)
        for rb in jpre.gang_bindings(n=3):
            s.create(copy.deepcopy(rb))
        svc.serve(quiescent=True)
    assert sides[1].view() == sides[0].view()
    rvs = sorted(rb.metadata.resource_version for rb in sides[1].store.list("ResourceBinding"))
    assert rvs[2] - rvs[0] == 2
