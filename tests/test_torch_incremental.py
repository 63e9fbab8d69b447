"""The port's incremental rounds held against the JAX ArrayScheduler: the
replay cache (`schedule_incremental`, `launch_chunk` / `materialize_chunk`)
and the dirty-column fleet refresh (`set_clusters(clusters, dirty_names)`)
decide exactly as the reference — decisions, replayed/solved splits and
which refresh path a fleet change takes — across a churn sequence on the
same fixtures (tests/test_incremental.py, without its mesh and daemon
cases). Also the row-scatter kernel's plain version against the
reference's `_scatter_rows_kernel`."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.test_incremental as jinc  # noqa: E402
from karmada_tpu.api.cluster import Taint  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.testing.fixtures import duplicated_placement, synthetic_fleet  # noqa: E402
from tests.test_parallel import dyn_placement, make_binding  # noqa: E402

from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import from_reference_objects as conv  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402

from test_torch_scheduler import _decision_view  # noqa: E402


@pytest.fixture()
def fleet():
    clusters = synthetic_fleet(19, seed=5)
    return clusters, [c.name for c in clusters]


def _split(sched):
    return {k: sched.last_round_stats[k] for k in ("replayed", "solved")}


def _views(decisions):
    return [_decision_view(d) for d in decisions]


def _round(jref, port, bindings, port_bindings, extra=None):
    """One incremental round on both packages: identical decisions and
    splits; returns the split."""
    want = jref.schedule_incremental(bindings, extra_avail=extra)
    got = port.schedule_incremental(port_bindings, extra_avail=extra)
    assert _views(got) == _views(want)
    assert _split(port) == jinc.round_split(jref)
    return _split(port)


def test_replay_skips_unchanged_rows(fleet):
    clusters, names = fleet
    bindings = jinc.mixed_bindings(names)
    jref, port = jcore.ArrayScheduler(clusters), TorchScheduler(conv(clusters), device="cpu")
    pb = conv(bindings)
    assert _round(jref, port, bindings, pb) == {"replayed": 0, "solved": len(bindings)}
    assert _round(jref, port, bindings, pb) == {"replayed": len(bindings), "solved": 0}
    assert _views(port.schedule_incremental(pb)) == _views(
        TorchScheduler(conv(clusters), device="cpu").schedule(pb))


def test_incremental_parity_across_churn_sequence(fleet):
    """Interleaved churn (replica scale, strategy change, prev-placement
    drift, Fresh trigger, bindings added and removed): every round's
    incremental decisions equal the JAX incremental round's and a cold
    port schedule(), with the reference's replayed/solved splits. Mutated
    bindings reach the port as new objects (a store re-fetch); the rest
    keep their identity."""
    clusters, names = fleet
    bindings = jinc.mixed_bindings(names)
    jref, port = jcore.ArrayScheduler(clusters), TorchScheduler(conv(clusters), device="cpu")
    pb = conv(bindings)

    def check(expect_solved):
        split = _round(jref, port, bindings, pb)
        assert split["solved"] == expect_solved
        cold = TorchScheduler(conv(clusters), device="cpu").schedule(pb)
        assert _views(port.schedule_incremental(pb)) == _views(cold)

    check(len(bindings))
    bindings[2].spec.replicas += 3
    jinc.bump(bindings[2])
    bindings[3].spec.placement = duplicated_placement(names[:5])
    jinc.bump(bindings[3])
    bindings[6].spec.clusters = [
        type(bindings[6].spec.clusters[0])(name=names[1], replicas=4)
    ] if bindings[6].spec.clusters else []
    bindings[7].spec.reschedule_triggered_at = 5.0
    bindings[7].status.last_scheduled_time = 1.0
    for i in (2, 3, 6, 7):
        pb[i] = conv(bindings[i])
    check(4)
    bindings.append(make_binding("late-1", 6, dyn_placement(), cpu=0.25))
    bindings.append(make_binding("late-2", 2, duplicated_placement(names[:3])))
    del bindings[0]
    pb = pb[1:] + conv(bindings[-2:])
    check(2)
    check(0)


def test_estimator_answer_change_invalidates_replay(fleet):
    clusters, names = fleet
    bindings = [make_binding(f"d{i}", 6 + i, dyn_placement(), cpu=0.5) for i in range(4)]
    B, C = len(bindings), len(clusters)
    extra = np.full((B, C), 40, np.int32)
    jref, port = jcore.ArrayScheduler(clusters), TorchScheduler(conv(clusters), device="cpu")
    pb = conv(bindings)
    _round(jref, port, bindings, pb, extra)
    assert _round(jref, port, bindings, pb, extra) == {"replayed": B, "solved": 0}
    extra2 = extra.copy()
    extra2[1, :] = 2  # one binding's answers tightened
    assert _round(jref, port, bindings, pb, extra2) == {"replayed": B - 1, "solved": 1}


def test_replay_survives_object_identity_change(fleet):
    """Re-fetched bindings (deep copies: no object is the cached one)
    still replay on value equality; a genuine change in a copy
    re-solves."""
    clusters, names = fleet
    bindings = jinc.mixed_bindings(names)
    jref, port = jcore.ArrayScheduler(clusters), TorchScheduler(conv(clusters), device="cpu")
    _round(jref, port, bindings, conv(bindings))
    clones = [copy.deepcopy(rb) for rb in bindings]
    split = _round(jref, port, clones, conv(clones))
    assert split == {"replayed": len(bindings), "solved": 0}
    clones2 = [copy.deepcopy(rb) for rb in bindings]
    clones2[1].spec.replicas += 3
    jinc.bump(clones2[1])
    assert _round(jref, port, clones2, conv(clones2))["solved"] == 1


def test_launch_chunk_materialize_chunk_match_jax(fleet):
    """The chunk API: a chunk launched with launch_chunk and materialized
    with materialize_chunk decides and splits as the reference's, replay
    included, and writes the replay cache."""
    clusters, names = fleet
    bindings = jinc.mixed_bindings(names)
    jref, port = jcore.ArrayScheduler(clusters), TorchScheduler(conv(clusters), device="cpu")
    pb = conv(bindings)
    for _ in range(2):
        jp = jref.launch_chunk(bindings, round_rows=len(bindings))
        tp = port.launch_chunk(pb, round_rows=len(bindings))
        assert (tp["replayed"], tp["solved"]) == (jp["replayed"], jp["solved"])
        assert _views(port.materialize_chunk(tp)) == _views(jref.materialize_chunk(jp))
    assert (tp["replayed"], tp["solved"]) == (len(bindings), 0)


def _status_change(clusters, i, cpu=77.0, ready_flip=False, taint=False):
    c = copy.deepcopy(clusters[i])
    c.status.resource_summary.allocated["cpu"] = cpu
    if ready_flip:
        c.status.conditions[0].status = "False"
    if taint:
        c.spec.taints = [Taint(key="churn", value="x", effect="NoSchedule")]
    out = list(clusters)
    out[i] = c
    return out, c.name


def test_cluster_status_change_takes_dirty_column_path(fleet, monkeypatch):
    """Status-only deltas (allocated cpu, Ready flipping, a taint gained)
    take the dirty path: the batch encoder survives, the epoch advances,
    the rows go into the resident tensors through one refresh of the
    placement's launcher (one plain scatter of the staged block on the
    CPU), those tensors equal a full encode, and every row re-solves to
    the decisions of a fresh scheduler and of the JAX round."""
    clusters, names = fleet
    bindings = jinc.mixed_bindings(names)
    jref, port = jcore.ArrayScheduler(clusters), TorchScheduler(conv(clusters), device="cpu")
    pb = conv(bindings)
    _round(jref, port, bindings, pb)
    scatters = []
    scatter = kernels.scatter_rows_plain
    monkeypatch.setattr(kernels, "scatter_rows_plain",
                        lambda *a: (scatters.append(len(a[1])), scatter(*a))[1])
    live = clusters
    for step, kw in enumerate(({}, {"ready_flip": True}, {"taint": True, "cpu": 5.0})):
        encoder, epoch = port.batch_encoder, port.fleet_epoch
        j_encoder = jref.batch_encoder
        live, name = _status_change(live, 4 + step, **kw)
        jref.set_clusters(live, dirty_names={name})
        port.set_clusters(conv(live), dirty_names={name})
        assert port.batch_encoder is encoder and jref.batch_encoder is j_encoder
        assert port.fleet_epoch == epoch + 1
        assert scatters[-1] == 1 and len(scatters) == step + 1
        full = port.encoder.encode(port.clusters)
        for n in ("alive", "capacity", "has_summary", "taint_key", "taint_value",
                  "taint_effect", "api_ok"):
            np.testing.assert_array_equal(port._fleet_dev[n].numpy(), getattr(full, n), n)
        assert _round(jref, port, bindings, pb)["solved"] == len(bindings)
        fresh = TorchScheduler(conv(live), device="cpu").schedule(pb)
        assert _views(port.schedule_incremental(pb)) == _views(fresh)


def test_label_and_membership_changes_rebuild(fleet):
    """A label change and a membership change fall back to the full
    rebuild, as in the reference; decisions track the new fleet."""
    clusters, names = fleet
    label_placement = jinc.Placement(
        cluster_affinity=jinc.ClusterAffinity(
            label_selector=jinc.LabelSelector(match_labels={"tier": "gold"})))
    bindings = [make_binding("lbl", 4, label_placement, cpu=0.25)] + jinc.mixed_bindings(names)
    base = list(clusters)
    gold = copy.deepcopy(clusters[0])
    gold.metadata.labels["tier"] = "gold"
    base[0] = gold
    jref, port = jcore.ArrayScheduler(base), TorchScheduler(conv(base), device="cpu")
    pb = conv(bindings)
    _round(jref, port, bindings, pb)
    switched = list(base)
    plain = copy.deepcopy(gold)
    del plain.metadata.labels["tier"]
    other = copy.deepcopy(base[1])
    other.metadata.labels["tier"] = "gold"
    switched[0], switched[1] = plain, other
    encoder = port.batch_encoder
    jref.set_clusters(switched, dirty_names={plain.name, other.name})
    port.set_clusters(conv(switched), dirty_names={plain.name, other.name})
    assert port.batch_encoder is not encoder  # full rebuild
    _round(jref, port, bindings, pb)
    assert {t.name for t in port.schedule_incremental(pb)[0].targets} == {other.name}
    grown = list(switched) + synthetic_fleet(2, seed=99)
    encoder = port.batch_encoder
    jref.set_clusters(grown, dirty_names={grown[-1].name})
    port.set_clusters(conv(grown), dirty_names={grown[-1].name})
    assert port.batch_encoder is not encoder
    assert _round(jref, port, bindings, pb)["solved"] == len(bindings)


@pytest.mark.parametrize("dtype", [np.bool_, np.int32, np.int64])
def test_scatter_rows_plain_matches_reference(dtype):
    """B17's plain version against `_scatter_rows_kernel` on numpy inputs
    with duplicate indices (which carry identical rows), 1-D and 2-D."""
    rng = np.random.default_rng(5)
    for shape in ((40,), (40, 3)):
        dst = rng.integers(0, 5, shape).astype(dtype)
        new = rng.integers(0, 5, shape).astype(dtype)
        idx = np.array([3, 17, 3, 0, 39, 17, 17], np.int64)
        src = new[idx]
        want = np.asarray(jcore._scatter_rows_kernel(dst.copy(), idx, src))
        got = kernels.scatter_rows([torch.from_numpy(dst.copy())], torch.from_numpy(idx),
                                   [torch.from_numpy(src)])
        np.testing.assert_array_equal(got[0].numpy(), want)


_FIELDS = ("alive", "capacity", "has_summary", "taint_key", "taint_value", "taint_effect",
           "api_ok")


def random_fleet_arrays(rng, C, R, T, G):
    """Seeded host arrays of the seven resident fields (bool, int64, int32
    rows), as FleetArrays lays them out."""
    return {
        "alive": rng.random(C) < 0.8,
        "capacity": rng.integers(-(1 << 40), 1 << 40, (C, R)).astype(np.int64),
        "has_summary": rng.random(C) < 0.9,
        "taint_key": rng.integers(0, 9, (C, T)).astype(np.int32),
        "taint_value": rng.integers(0, 9, (C, T)).astype(np.int32),
        "taint_effect": rng.integers(0, 4, (C, T)).astype(np.int32),
        "api_ok": rng.random((C, G)) < 0.7,
    }


def _dirty_rows(kind, C, rng):
    return {
        "one": np.array([C // 2]),
        "last": np.array([C - 1, 0]),
        "some": np.sort(rng.choice(C, 9, replace=False)),
        "repeated": np.array([7, 3, 7, C - 1, 3, 7]),  # a repeat carries the same row
        "every": np.arange(C),
    }[kind].astype(np.int64)


@pytest.mark.parametrize("kind", ["one", "last", "some", "repeated", "every"])
@pytest.mark.parametrize("R,T,G", [(1, 0, 5), (5, 3, 7), (5, 0, 1), (1, 3, 3)])
def test_fleet_scatter_refresh_matches_reference(R, T, G, kind):
    """The refresh launcher's CPU route: the staged block round-trips (the
    ids, then each field's rows, every segment at a 16-byte boundary,
    fields of no bytes left out), and a refresh equals scatter_rows_plain
    and the reference's `_scatter_rows_kernel` on every field, for bool,
    int32 and int64 rows, R = 1 and 5, T = 0 and 3, odd G, one row, the
    last row, repeated ids and every row."""
    from types import SimpleNamespace

    rng = np.random.default_rng(R * 100 + T * 10 + G)
    C = 37
    base, new = random_fleet_arrays(rng, C, R, T, G), random_fleet_arrays(rng, C, R, T, G)
    rows = _dirty_rows(kind, C, rng)
    dsts = {n: torch.from_numpy(base[n].copy()) for n in _FIELDS}
    launcher = kernels.fleet_scatter(dsts)
    fleet = SimpleNamespace(**new)

    host, n = launcher.stage(rows, fleet)
    kept = [f for f in _FIELDS if new[f].size]
    widths = [new[f][0].nbytes for f in kept]
    offs, nbytes = kernels._staged_layout(n, widths)
    assert n == len(rows) and host.numel() >= nbytes
    assert all(o % 16 == 0 for o in offs) and offs[0] >= 8 * n
    raw = host.numpy()
    np.testing.assert_array_equal(raw[:8 * n].view(np.int64), rows)
    for f, o, w in zip(kept, offs, widths):
        seg = raw[o:o + n * w].view(new[f].dtype).reshape((n,) + new[f].shape[1:])
        np.testing.assert_array_equal(seg, new[f][rows], f)

    launcher.refresh(rows, fleet)
    plain = kernels.scatter_rows_plain([torch.from_numpy(base[f].copy()) for f in _FIELDS],
                                       torch.from_numpy(rows),
                                       [torch.from_numpy(new[f][rows]) for f in _FIELDS])
    for f, p in zip(_FIELDS, plain):
        want = np.asarray(jcore._scatter_rows_kernel(base[f].copy(), rows, new[f][rows]))
        np.testing.assert_array_equal(dsts[f].numpy(), want, f)
        np.testing.assert_array_equal(p.numpy(), want, f)
    with pytest.raises(TypeError, match="capacity"):
        launcher.refresh(rows, SimpleNamespace(**{**new, "capacity": new["capacity"][:, :0]
                                                  if R > 1 else new["capacity"] != 0}))
    launcher.close()
    with pytest.raises(RuntimeError, match="replaced"):
        launcher.refresh(rows, fleet)


def _status_edit(clusters, name, *, cpu=None, ready=None, taints=None, alloc=None):
    out = list(clusters)
    i = next(j for j, c in enumerate(out) if c.name == name)
    c = copy.deepcopy(out[i])
    if cpu is not None:
        c.status.resource_summary.allocated["cpu"] = cpu
    if alloc is not None:
        c.status.resource_summary.allocatable["cpu"] = alloc
    if ready is not None:
        c.status.conditions[0].status = ready
    if taints is not None:
        c.spec.taints = taints
    out[i] = c
    return out


def test_dirty_round_sequence_matches_reference(fleet, monkeypatch):
    """A sequence of heartbeat rounds through the dirty-column path on the
    port's CPU scheduler and the reference: Ready flips both ways, a taint
    gained then replaced, capacity drift (allocated and allocatable),
    spurious dirt (an unchanged cluster named dirty; a name outside the
    fleet), and a dirty set covering the whole fleet. Every round keeps
    the batch encoder, refreshes through one plain scatter of the staged
    block (none when nothing re-encodes), leaves the resident tensors
    equal to a full re-encode and decides as the reference and a fresh
    scheduler."""
    clusters, names = fleet
    bindings = jinc.mixed_bindings(names)
    jref, port = jcore.ArrayScheduler(clusters), TorchScheduler(conv(clusters), device="cpu")
    pb = conv(bindings)
    _round(jref, port, bindings, pb)
    encoder, launcher = port.batch_encoder, port._fleet_scatter
    scatters = []
    scatter = kernels.scatter_rows_plain
    monkeypatch.setattr(kernels, "scatter_rows_plain",
                        lambda *a: (scatters.append(len(a[1])), scatter(*a))[1])
    churn = Taint(key="churn", value="x", effect="NoSchedule")
    steps = [
        ({names[2]: {"ready": "False"}, names[5]: {"cpu": 3.0}}, 2),
        ({names[2]: {"ready": "True"}, names[9]: {"taints": [churn]}}, 2),
        ({names[9]: {"taints": [Taint(key="churn", value="y", effect="NoExecute")]},
          names[11]: {"alloc": 5.0, "cpu": 4.5}}, 2),
        ({names[0]: {}}, 1),  # named dirty, unchanged
        ({"no-such-cluster": {}}, 0),  # nothing re-encodes
        ({n: ({"cpu": float(i % 7)} if i % 3 == 0 else {}) for i, n in enumerate(names)},
         len(names)),
    ]
    live = clusters
    for edits, n_rows in steps:
        for name, kw in edits.items():
            if name in names and kw:
                live = _status_edit(live, name, **kw)
        epoch, calls = port.fleet_epoch, len(scatters)
        jref.set_clusters(live, dirty_names=set(edits))
        port.set_clusters(conv(live), dirty_names=set(edits))
        assert port.batch_encoder is encoder and port._fleet_scatter is launcher
        assert port.fleet_epoch == epoch + 1
        assert scatters[calls:] == ([n_rows] if n_rows else [])
        full = port.encoder.encode(port.clusters)
        for n in _FIELDS:
            np.testing.assert_array_equal(port._fleet_dev[n].numpy(), getattr(full, n), n)
        assert _round(jref, port, bindings, pb)["solved"] == len(bindings)
        fresh = TorchScheduler(conv(live), device="cpu").schedule(pb)
        assert _views(port.schedule_incremental(pb)) == _views(fresh)
