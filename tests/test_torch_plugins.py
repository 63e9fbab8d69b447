"""Out-of-tree scheduler plugins of the PyTorch port held against the JAX
package on the CPU.

The port's `PluginRegistry` (register, unregister, factory_names, filter
with out-of-tree names, out_of_tree) against the reference's, errors
included; the plugin terms of `ArrayScheduler._plugin_terms` (real cluster
names only, pad columns and padding rows all-feasible with score 0);
whole rounds with a FilterPlugin and a ScorePlugin registered on both
sides — the compact round (the plugin score moving the candidate window),
the dense round (candidate_k=0, small_fleet, the dense-solve annotation),
`-ClusterAffinity`, the spread rounds (the batched path's representative
keys and the per-row re-solve), a score that wraps int32, the monolithic
mesh round and a daemon round — decision for decision; the guards the
plugins switch on (no replay, no pipeline, no tiered launch, streaming
depth 1); and the kernels' plain versions with the terms against the JAX
programs they replace. Every comparison is exact. One plugin instance
serves both registries: a registry reads only `name` and the `mask` /
`score` methods."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.api import policy as jpol  # noqa: E402
from karmada_tpu.sched import candidates as jcand  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.sched import plugins as JP  # noqa: E402
from karmada_tpu.sched import preemption as jpre  # noqa: E402
from karmada_tpu.testing.fixtures import synthetic_fleet  # noqa: E402

from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import batch_from_numpy, from_reference_objects  # noqa: E402
from karmada_tpu_torch.sched import plugins as TP  # noqa: E402
from karmada_tpu_torch.sched import preemption as tpre  # noqa: E402
from karmada_tpu_torch.sched.candidates import DENSE_SOLVE_ANNOTATION, dense_reason  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402
from karmada_tpu_torch.sched.pipeline import StageTimer  # noqa: E402
from karmada_tpu_torch.testing.plugins import HashBan, HashScore, hash_registry  # noqa: E402

from test_scheduler_core import make_binding, targets_dict  # noqa: E402
from test_torch_candidates import BATCH_FIELDS, FLEET_FIELDS  # noqa: E402
from test_torch_scheduler import _decision_view, flagship_mix  # noqa: E402
from test_torch_spread import _case  # noqa: E402

SELECT_OUT = ("cand_idx", "c_feas", "c_score", "c_avail", "c_prev", "c_tie", "feas_count",
              "packed")
FILTER_OUT = ("feasible", "score", "avail", "prev_replicas", "tie", "feas_count")
I32_MAX = 2**31 - 1


def _views(decisions):
    return [_decision_view(d) for d in decisions]


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


class BanFirst(TP.FilterPlugin):
    name = "BanFirst"

    def mask(self, bindings, cluster_names):
        m = np.ones((len(bindings), len(cluster_names)), bool)
        m[:, 0] = False
        return m


class BanPerRow(TP.FilterPlugin):
    name = "BanPerRow"

    def mask(self, bindings, cluster_names):
        m = np.ones((len(bindings), len(cluster_names)), bool)
        for i, rb in enumerate(bindings):
            if rb.metadata.name == "row-b":
                m[i, 1] = False
        return m


class PrevMax(TP.ScorePlugin):
    """INT32_MAX on every column a row lists as a previous placement, where
    the in-tree locality score's 100 then wraps the sum negative; a hashed
    score elsewhere."""

    name = "PrevMax"

    def score(self, bindings, cluster_names):
        out = HashScore().score(bindings, cluster_names)
        col = {n: c for c, n in enumerate(cluster_names)}
        for i, rb in enumerate(bindings):
            for t in rb.spec.clusters or []:
                if t.name in col:
                    out[i, col[t.name]] = I32_MAX
        return out


class Recorder(TP.FilterPlugin, TP.ScorePlugin):
    """Both seams, recording the width of the cluster names each call
    sees."""

    name = "Recorder"

    def __init__(self):
        self.widths = []

    def mask(self, bindings, cluster_names):
        self.widths.append(len(cluster_names))
        return HashBan().mask(bindings, cluster_names)

    def score(self, bindings, cluster_names):
        self.widths.append(len(cluster_names))
        return HashScore().score(bindings, cluster_names)


def _registries(*plugins):
    """(reference registry, port registry) holding the same instances."""
    regs = JP.PluginRegistry(), TP.PluginRegistry()
    for reg in regs:
        for p in plugins:
            reg.register(p)
    return regs


def _pair(clusters, registries, **kw):
    """The reference's and the port's scheduler over the same clusters."""
    jreg, treg = registries
    ref = jcore.ArrayScheduler(clusters, plugin_registry=jreg, **kw)
    port = TorchScheduler(from_reference_objects(clusters), plugin_registry=treg,
                          device="cpu", **kw)
    return ref, port


def _both(clusters, bindings, registries, **kw):
    ref, port = _pair(clusters, registries, **kw)
    want = ref.schedule(bindings)
    got = port.schedule(from_reference_objects(bindings))
    assert _views(got) == _views(want)
    return got, port


def _differ(a, b) -> int:
    return sum(x != y for x, y in zip(_views(a), _views(b)))


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------


class _Named:
    def __init__(self, name):
        self.name = name


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the error's type and text are compared
        return type(e).__name__, str(e)


REGISTRY_SCRIPTS = {
    "register": lambda r: [_outcome(lambda: r.register(_Named("Foo"))), r.factory_names(),
                           sorted(r.filter(["*"])), sorted(r.filter(None))],
    "duplicate": lambda r: [_outcome(lambda: r.register(_Named("Foo"))),
                            _outcome(lambda: r.register(_Named("Foo"))), r.factory_names()],
    "in-tree name": lambda r: [_outcome(lambda: r.register(_Named("TaintToleration"))),
                               r.factory_names()],
    "unregister": lambda r: [_outcome(lambda: r.register(_Named("Foo"))),
                             _outcome(lambda: r.unregister("Foo")), r.factory_names(),
                             _outcome(lambda: r.unregister("Foo"))],
    "unknown name": lambda r: [_outcome(lambda: r.unregister("Nope")),
                               _outcome(lambda: r.unregister("ClusterAffinity"))],
    "filter": lambda r: [_outcome(lambda: r.register(_Named("Foo"))),
                         _outcome(lambda: r.register(_Named("Bar"))),
                         sorted(r.filter(["*", "-Foo"])), sorted(r.filter(["Foo"])),
                         sorted(r.filter(["-Foo", "*"])), sorted(r.filter(["Bar", "-Foo"])),
                         sorted(r.filter(["-Foo", "Bar"])), sorted(r.filter(["--Bar", "*"]))],
    "out_of_tree order": lambda r: [
        [_outcome(lambda n=n: r.register(_Named(n))) for n in ("Zed", "Alpha", "Mid")],
        [p.name for p in r.out_of_tree(r.filter(["*"]))],
        [p.name for p in r.out_of_tree(r.filter(["*", "-Mid"]))],
        [p.name for p in r.out_of_tree(r.filter(["Zed", "TaintToleration"]))],
        [p.name for p in r.out_of_tree(set())]],
}


@pytest.mark.parametrize("script", list(REGISTRY_SCRIPTS))
def test_registry_matches_reference(script):
    """Each script on a fresh registry of each package: the same results,
    the same error types and texts ("a plugin named X already exists", "no
    plugin named X exists")."""
    run = REGISTRY_SCRIPTS[script]
    want, got = run(JP.PluginRegistry()), run(TP.PluginRegistry())
    assert got == want
    if script == "duplicate":
        assert got[1] == ("ValueError", "a plugin named Foo already exists")
    if script == "unknown name":
        assert got[0] == ("ValueError", "no plugin named Nope exists")


def test_plugin_seams_raise_until_overridden():
    for P in (JP, TP):
        for cls, method in ((P.FilterPlugin, "mask"), (P.ScorePlugin, "score")):
            with pytest.raises(NotImplementedError):
                getattr(cls(), method)([], [])
    assert (TP.FilterPlugin.name, TP.ScorePlugin.name) == (JP.FilterPlugin.name,
                                                           JP.ScorePlugin.name)


# --------------------------------------------------------------------------
# the reference's own plugin tests, held on both packages
# --------------------------------------------------------------------------


def test_filter_and_score_plugins_apply():
    """TestOutOfTreeSeam.test_filter_and_score_plugins_apply, with a score
    plugin beside the filter."""
    clusters = synthetic_fleet(5, seed=4)
    names = [c.name for c in clusters]
    p = jpol.Placement(cluster_affinity=jpol.ClusterAffinity(cluster_names=[]))
    rb = make_binding("app", 2, p)
    got, port = _both(clusters, [rb], _registries(BanFirst(), HashScore()))
    assert names[0] not in targets_dict(got[0]) and names[0] not in got[0].feasible
    assert [p.name for p in port._oot_plugins] == ["BanFirst", "HashScore"]


def test_disabled_out_of_tree_plugin_is_inert(monkeypatch):
    """TestOutOfTreeSeam.test_disabled_out_of_tree_plugin_is_inert: a
    registered plugin disabled by `--plugins` is never asked, no term is
    built or uploaded, and the round decides as without it."""
    clusters = synthetic_fleet(5, seed=4)
    names = [c.name for c in clusters]
    p = jpol.Placement(cluster_affinity=jpol.ClusterAffinity(cluster_names=[]))
    rb = make_binding("app", 2, p)
    got, port = _both(clusters, [rb], _registries(BanFirst()), plugins=["*", "-BanFirst"])
    assert names[0] in targets_dict(got[0])
    assert port._oot_plugins == [] and port._plugin_terms([rb], 8) == (None, None)

    def refuse(*a, **kw):
        raise AssertionError("a plugin term was uploaded")

    monkeypatch.setattr(port._term_staging, "upload_terms", refuse)
    assert _views(port.schedule(from_reference_objects([rb]))) == _views(got)


def test_spread_dedup_respects_out_of_tree_masks():
    """TestSpreadInteraction.test_spread_dedup_respects_out_of_tree_masks:
    two batched spread rows that differ only in their out-of-tree mask
    never share a scoring or packed-mask representative."""
    clusters = synthetic_fleet(24, seed=11)
    names = [c.name for c in clusters]
    n_regions = len({c.spec.region for c in clusters})
    p = jpol.Placement(
        cluster_affinity=jpol.ClusterAffinity(),
        spread_constraints=[jpol.SpreadConstraint(
            spread_by_field=jpol.SPREAD_BY_FIELD_REGION, min_groups=n_regions, max_groups=0)],
    )
    rows = [make_binding("row-a", 2, p), make_binding("row-b", 2, p)]
    (d_a, d_b), port = _both(clusters, rows, _registries(BanPerRow()))
    t_a, t_b = targets_dict(d_a), targets_dict(d_b)
    assert names[1] in t_a and names[1] not in t_b
    assert set(t_a) - set(t_b) == {names[1]}
    assert port._classify_spread(from_reference_objects(rows))[0] == [0, 1]  # batched


@pytest.mark.parametrize("with_plugins", [False, True])
def test_spread_fallback_honors_selection_with_affinity_disabled(with_plugins):
    """TestSpreadInteraction.test_spread_fallback_honors_selection_with_
    affinity_disabled, also with plugins registered: the per-row spread
    selection rides extra_mask, ANDed into the plugin mask, and the
    re-solve takes the live rows' plugin score."""
    clusters = synthetic_fleet(20, seed=9)
    p = jpol.Placement(
        cluster_affinity=jpol.ClusterAffinity(),
        spread_constraints=[
            jpol.SpreadConstraint(spread_by_field=jpol.SPREAD_BY_FIELD_REGION, min_groups=2,
                                  max_groups=0),
            jpol.SpreadConstraint(spread_by_field=jpol.SPREAD_BY_FIELD_CLUSTER, min_groups=2,
                                  max_groups=3),
        ],
    )
    rows = [make_binding(f"capped-{i}", 4, p, cpu=0.5) for i in range(6)]
    regs = _registries(HashBan(share=4), HashScore()) if with_plugins else _registries()
    base, _ = _both(clusters, rows, regs)
    got, port = _both(clusters, rows, regs, plugins=["*", "-ClusterAffinity"])
    assert port._classify_spread(from_reference_objects(rows))[2] == list(range(6))
    assert _views(got) == _views(base)
    assert all(len(targets_dict(d)) <= 3 for d in got)


# --------------------------------------------------------------------------
# the rounds
# --------------------------------------------------------------------------


def _record_terms(monkeypatch, name):
    """Record, per call of kernels.<name>, whether each plugin term came."""
    calls = []
    fn = getattr(kernels, name)

    def rec(*a, **kw):
        calls.append((kw.get("extra_mask") is not None, kw.get("extra_score") is not None))
        return fn(*a, **kw)

    monkeypatch.setattr(kernels, name, rec)
    return calls


def test_compact_round_plugin_score_moves_the_window(monkeypatch):
    """A fleet wider than the window (200 clusters, candidate_k=16): the
    plugin score reorders each row's candidates, so the window — and the
    divided rows' targets — change; the round stays compact, with both
    terms in its one candidate_select launch."""
    clusters, bindings = flagship_mix(seed=4, n_clusters=200, n_bindings=96)
    calls = _record_terms(monkeypatch, "candidate_select")
    got, port = _both(clusters, bindings, _registries(HashScore()), candidate_k=16)
    assert dense_reason(port, from_reference_objects(bindings)) is None
    assert calls == [(True, True)] + [(True, True)] * (len(calls) - 1)
    plain, _ = _both(clusters, bindings, _registries(), candidate_k=16)
    divided = [i for i, rb in enumerate(bindings)
               if rb.spec.placement.replica_scheduling is not None and got[i].ok]
    moved = sum(_views([got[i]]) != _views([plain[i]]) for i in divided)
    assert moved >= len(divided) // 4  # 24 of 68 rows


def test_compact_round_ban_and_score_match_reference(monkeypatch):
    """The hashed ban and score together on the compact round, its retry
    sub-rounds and Duplicated rows (the packed masks hold the masked
    feasible set)."""
    clusters, bindings = flagship_mix(seed=5, n_clusters=160, n_bindings=96)
    got, _ = _both(clusters, bindings, _registries(HashBan(share=4), HashScore()))
    plain, _ = _both(clusters, bindings, _registries())
    assert _differ(got, plain) >= len(got) // 2
    assert any(d.affinity_name == "backup" for d in got)


def _dense_fixture(how):
    if how == "small_fleet":
        return flagship_mix(seed=6, n_clusters=96, n_bindings=64) + ({},)
    clusters, bindings = flagship_mix(seed=6, n_clusters=160, n_bindings=64)
    if how == "candidate_k=0":
        return clusters, bindings, {"candidate_k": 0}
    bindings[3].metadata.annotations = {DENSE_SOLVE_ANNOTATION: "true"}
    return clusters, bindings, {}


@pytest.mark.parametrize("how,reason", [("candidate_k=0", "disabled"),
                                        ("small_fleet", "small_fleet"),
                                        ("dense-solve", "policy")])
def test_dense_round_with_plugins_matches_reference(how, reason, monkeypatch):
    """The dense round by each of its reasons: both terms reach the one
    dense_filter launch; decisions equal the reference's and differ from
    the plugin-free round's."""
    clusters, bindings, kw = _dense_fixture(how)
    calls = _record_terms(monkeypatch, "dense_filter")
    got, port = _both(clusters, bindings, _registries(HashBan(share=4), HashScore()), **kw)
    assert dense_reason(port, from_reference_objects(bindings)) == reason
    assert calls and calls[0] == (True, True)
    plain, _ = _both(clusters, bindings, _registries(), **kw)
    assert _differ(got, plain) >= len(got) // 2


@pytest.mark.parametrize("candidate_k", [None, 0])
def test_cluster_affinity_disabled_with_plugins(candidate_k):
    """`-ClusterAffinity` beside the plugins: the affinity table is ignored,
    the plugin mask is not, on the compact and the dense round."""
    clusters, bindings = flagship_mix(seed=7, n_clusters=160, n_bindings=64)
    got, _ = _both(clusters, bindings, _registries(HashBan(share=3), HashScore()),
                   plugins=["*", "-ClusterAffinity"], candidate_k=candidate_k)
    assert sum(d.ok for d in got) > len(got) // 2


@pytest.mark.parametrize("bucket_cols", [True, False])
def test_plugin_terms_see_real_clusters_only(bucket_cols):
    """`_plugin_terms` over a 100-cluster fleet: plugins see the 100 real
    names (the bucketed fleet pads to 128 dead columns); pad columns and
    padding rows stay all-feasible with score 0, as the reference's; the
    round decides as the reference's."""
    clusters, bindings = flagship_mix(seed=8, n_clusters=100, n_bindings=40)
    rec_j, rec_t = Recorder(), Recorder()
    ref = jcore.ArrayScheduler(clusters, plugin_registry=_registries(rec_j)[0],
                               bucket_cols=bucket_cols)
    treg = TP.PluginRegistry()
    treg.register(rec_t)
    port = TorchScheduler(from_reference_objects(clusters), plugin_registry=treg,
                          bucket_cols=bucket_cols, device="cpu")
    C = len(port.fleet.names)
    assert C == (128 if bucket_cols else 100) == len(ref.fleet.names)
    pb = from_reference_objects(bindings)
    for n_rows in (40, 64):
        want = ref._plugin_terms(bindings, n_rows)
        got = port._plugin_terms(pb, n_rows)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (n_rows, C) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        mask, score = got
        assert mask[:, 100:].all() and not score[:, 100:].any()
        assert mask[40:].all() and not score[40:].any()
        assert not mask[:40, :100].all()
    assert set(rec_t.widths) == {100}
    assert _views(port.schedule(pb)) == _views(ref.schedule(bindings))


@pytest.mark.parametrize("candidate_k", [16, 0])
def test_score_that_wraps_int32(candidate_k):
    """INT32_MAX on each row's previous columns: with the locality score's
    100 the sum wraps to the most negative scores, the reference's int32
    add, so those columns rank last in the window and in the spread
    selection."""
    clusters, bindings = flagship_mix(seed=9, n_clusters=160, n_bindings=96)
    got, port = _both(clusters, bindings, _registries(PrevMax()), candidate_k=candidate_k)
    pb = from_reference_objects(bindings)
    _mask, score = port._plugin_terms(pb, len(pb))
    assert any(rb.spec.clusters for rb in pb) and (score == I32_MAX).any()
    assert sum(d.ok for d in got) > len(got) // 2


SPREAD_CASES = ("balanced_dense", "balanced_window", "fallback_dense", "fallback_window")


@pytest.mark.parametrize("case", SPREAD_CASES)
def test_spread_rounds_with_plugins_match_reference(case):
    """test_torch_spread's rounds with the hashed ban and score registered:
    the batched path (group scoring and packed-mask representatives keyed
    on each row's plugin terms), the window rows and the per-row
    re-solve."""
    clusters, bindings, k = _case(case)
    got, _ = _both(clusters, bindings, _registries(HashBan(share=8), HashScore()),
                   candidate_k=k)
    plain, _ = _both(clusters, bindings, _registries(), candidate_k=k)
    assert _differ(got, plain) >= len(got) // 4


def test_monolithic_mesh_round_with_plugins():
    """The monolithic mesh round (8 CPU devices, 4 x 2) with both terms:
    the mesh kernel takes them, padded to the mesh, and so does the
    per-row re-solve over the mesh."""
    import jax

    from karmada_tpu.parallel import make_mesh as ref_make_mesh
    from karmada_tpu_torch.testing.cpumesh import virtual_mesh

    clusters, bindings, _k = _case("fallback_dense")
    jreg, treg = _registries(HashBan(share=6), HashScore())
    ref = jcore.ArrayScheduler(clusters, mesh=ref_make_mesh(jax.devices()), plugin_registry=jreg)
    port = TorchScheduler(from_reference_objects(clusters), mesh=virtual_mesh(8, "cpu"),
                          device="cpu", plugin_registry=treg)
    ref.mesh_partitioned = port.mesh_partitioned = False
    want = ref.schedule(bindings)
    got = port.schedule(from_reference_objects(bindings))
    assert _views(got) == _views(want)
    assert sum(d.ok for d in got) > len(got) // 2


# --------------------------------------------------------------------------
# the guards the plugins switch on
# --------------------------------------------------------------------------


def test_replay_is_off_under_plugins():
    """schedule_incremental replays nothing with a plugin enabled (its host
    hooks may depend on more than the binding), as the reference."""
    clusters, bindings = flagship_mix(seed=10, n_clusters=160, n_bindings=48)
    for regs, replayed in ((_registries(HashScore()), 0), (_registries(), len(bindings))):
        ref, port = _pair(clusters, regs)
        pb = from_reference_objects(bindings)
        for _ in range(2):
            want = ref.schedule_incremental(bindings)
            got = port.schedule_incremental(pb)
            assert _views(got) == _views(want)
            assert port.last_round_stats == {k: ref.last_round_stats[k]
                                             for k in ("replayed", "solved")}
        assert port.last_round_stats["replayed"] == replayed


def test_pipeline_is_off_under_plugins(monkeypatch):
    """A chunked round with the pipeline asked for runs its chunks serially
    under plugins (round_chunk_rows gives one chunk), as the reference."""
    clusters, bindings = flagship_mix(seed=11, n_clusters=160, n_bindings=96)
    monkeypatch.setenv("KARMADA_TPU_MAX_BC_ELEMS", str(32 * 160))
    for regs, pipelined in ((_registries(HashBan()), False), (_registries(), True)):
        ref, port = _pair(clusters, regs, pipeline=True)
        assert port.round_chunk_rows(4096) == ref.round_chunk_rows(4096)
        want = ref.schedule(bindings)
        got = port.schedule(from_reference_objects(bindings))
        assert _views(got) == _views(want)
        assert port.last_pipeline_stats["chunks"] > 1
        assert port.last_pipeline_stats["pipelined"] is pipelined


def test_tiered_launch_is_off_under_plugins():
    """Mixed priorities and preemption-armed rows route to the workload
    launch without plugins and never with one, in both packages."""
    clusters, bindings = flagship_mix(seed=12, n_clusters=160, n_bindings=16)
    for i, rb in enumerate(bindings):
        rb.spec.schedule_priority = 1000 * (i % 2)
        rb.spec.preemption_policy = jpre.PREEMPT_LOWER_PRIORITY
    for regs, routed in ((_registries(HashScore()), False), (_registries(), True)):
        ref, port = _pair(clusters, regs)
        pb = from_reference_objects(bindings)
        assert jpre.wants_tiers(ref, bindings) is routed
        assert tpre.wants_tiers(port, pb) is routed
        assert jpre.wants_workload_solve(ref, bindings) is routed
        assert tpre.wants_workload_solve(port, pb) is routed


def _daemon_side(pkg, clusters, registry):
    from test_torch_daemon import Side

    return Side(pkg, clusters, plugin_registry=registry)


def test_daemon_round_with_plugins_matches_reference():
    """A SchedulerDaemon per package over the same store objects, each with
    a registry holding the same plugins: the settled bindings and events
    equal; the daemon's streaming service runs at depth 1."""
    import tests.test_streaming as jstream

    clusters = synthetic_fleet(jstream.N_CLUSTERS, seed=9)
    names = [c.name for c in clusters]
    jreg, treg = _registries(HashBan(share=4), HashScore())
    ref = _daemon_side("karmada_tpu", clusters, jreg)
    port = _daemon_side("karmada_tpu_torch", clusters, treg)
    for side in (ref, port):
        for o in jstream.mixed_bindings(names):
            side.create(o)
        side.runtime.settle()
    assert port.view() == ref.view()
    assert port.events() == ref.events()
    assert sum(1 for v in port.view().values() if v[2]) > 12
    array = port.daemon._ensure_fleet()
    assert [p.name for p in array._oot_plugins] == ["HashBan", "HashScore"]
    assert port.daemon.streaming(batch_delay=0.0)._open_stream(array, StageTimer()).depth == 1
    plain = _daemon_side("karmada_tpu_torch", clusters, TP.PluginRegistry())
    plain_array = plain.daemon._ensure_fleet()
    stream = plain.daemon.streaming(batch_delay=0.0)
    assert stream._open_stream(plain_array, StageTimer()).depth == stream.depth > 1


# --------------------------------------------------------------------------
# the kernels' plain versions with the terms
# --------------------------------------------------------------------------


def _encode_both(n_clusters, n_bindings, seed=13):
    clusters, bindings = flagship_mix(seed=seed, n_clusters=n_clusters, n_bindings=n_bindings)
    ref = jcore.ArrayScheduler(clusters)
    port = TorchScheduler(from_reference_objects(clusters), device="cpu")
    jb = ref._pad(ref.batch_encoder.encode(bindings))
    tb = port._pad(port.batch_encoder.encode(from_reference_objects(bindings)))
    return ref, port, jb, tb


def _terms(rng, B, C):
    """A mask with about 1/8 of the pairs off and scores over the whole
    int32 range, INT32_MAX in a few columns so the locality score wraps."""
    mask = rng.random((B, C)) >= 0.125
    score = rng.integers(-2**31, 2**31, (B, C), dtype=np.int64).astype(np.int32)
    score[:, ::7] = I32_MAX
    return mask, score


def _port_args(port, tb):
    f = port._fleet_dev
    t = batch_from_numpy({n: getattr(tb, n) for n in BATCH_FIELDS}, "cpu")
    return [f[n] for n in FLEET_FIELDS] + [t[n] for n in (
        "replicas", "unknown_request", "gvk", "tol_tables", "tol_idx", "aff_masks", "aff_idx",
        "prev_idx", "prev_rep", "evict_idx", "seeds", "req_unique", "req_idx")]


@pytest.mark.parametrize("terms", ["mask", "score", "both", "both and answers"])
def test_select_plain_with_terms_matches_candidate_select_kernel(terms):
    ref, port, jb, tb = _encode_both(200, 96)
    B, C = len(jb.replicas), len(ref.fleet.names)
    rng = np.random.default_rng(14)
    mask, score = _terms(rng, B, C)
    mask = mask if terms != "score" else None
    score = score if terms != "mask" else None
    extra = rng.integers(-1, 9, (B, C)).astype(np.int32) if "answers" in terms else None
    k = 24
    want = jcand._candidate_select_kernel(
        *ref.filter_kernel_args(jb, extra, mask, score), k=k, plugin_bits=ref._plugin_bits)
    T = (lambda x: None if x is None else torch.from_numpy(x))
    got = kernels.select_plain(*_port_args(port, tb), T(extra), k=k,
                               plugin_bits=port._plugin_bits, extra_mask=T(mask),
                               extra_score=T(score))
    for name, a, b in zip(SELECT_OUT, got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    if score is not None:  # the top scores lead the window; wrapped ones rank last
        assert (_n(got[2]) == I32_MAX).any()


@pytest.mark.parametrize("with_mask", [False, True])
def test_dense_filter_plain_with_score_matches_filter_kernel_compact(with_mask):
    ref, port, jb, tb = _encode_both(96, 64)
    B, C = len(jb.replicas), len(ref.fleet.names)
    mask, score = _terms(np.random.default_rng(15), B, C)
    mask = mask if with_mask else None
    want = jcore._filter_kernel_compact(
        *ref.filter_kernel_args(jb, None, mask, score), plugin_bits=ref._plugin_bits)
    got = kernels.dense_filter_plain(
        *_port_args(port, tb), None, plugin_bits=port._plugin_bits,
        extra_mask=None if mask is None else torch.from_numpy(mask),
        extra_score=torch.from_numpy(score))
    for name, a, b in zip(FILTER_OUT, got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    assert (_n(got[1]) < -2**31 + 100).any()


def test_wrappers_check_the_terms():
    """The wrappers refuse a term of the wrong dtype, shape or device."""
    _ref, port, jb, tb = _encode_both(96, 16)
    args = _port_args(port, tb) + [None]
    B, C = len(jb.replicas), len(port.fleet.names)
    bad = {"extra_mask": torch.ones((B, C), dtype=torch.int32),
           "extra_score": torch.zeros((B, C + 1), dtype=torch.int32)}
    for name, t in bad.items():
        with pytest.raises((TypeError, ValueError), match=name):
            kernels._select_launch(*args, k=16, plugin_bits=31, **{name: t})
        with pytest.raises((TypeError, ValueError), match=name):
            kernels._dense_filter_launch(*args, plugin_bits=31, **{name: t})


def test_hash_plugins_read_names_only():
    """The seeded plugins read names only: the port's and the reference's
    objects give the same terms, and hash_registry holds both, in name
    order."""
    clusters, bindings = flagship_mix(seed=16, n_clusters=48, n_bindings=8)
    names = [c.name for c in clusters]
    pb = from_reference_objects(bindings)
    for f in (HashBan().mask, HashScore().score):
        np.testing.assert_array_equal(f(bindings, names), f(pb, names))
    score = HashScore().score(bindings, names)
    assert score.dtype == np.int32 and score.min() < 0 < score.max()
    ban = HashBan(share=4).mask(bindings, names)
    assert 0.15 < 1 - ban.mean() < 0.35
    reg = hash_registry(TP.PluginRegistry)
    assert [p.name for p in reg.out_of_tree(reg.filter(None))] == ["HashBan", "HashScore"]
