"""The PyTorch port's compact candidate round held against the JAX
ArrayScheduler: same fixtures (converted objects, so the same UIDs and tie
seeds), identical decisions — targets, replica counts, feasible lists,
error strings and applied affinity-term names."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.api import policy as jpol  # noqa: E402
from karmada_tpu.api.cluster import Taint  # noqa: E402
from karmada_tpu.api.meta import CPU, ObjectMeta, new_uid  # noqa: E402
from karmada_tpu.api.work import (  # noqa: E402
    BindingSpec,
    GracefulEvictionTask,
    ObjectReference,
    ReplicaRequirements,
    ResourceBinding,
    TargetCluster,
)
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.testing.fixtures import (  # noqa: E402
    duplicated_placement,
    static_weight_placement,
    synthetic_fleet,
)

from karmada_tpu_torch.convert import from_reference_objects  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _dyn(aggregated):
    return jpol.Placement(
        cluster_affinity=jpol.ClusterAffinity(cluster_names=[]),
        replica_scheduling=jpol.ReplicaSchedulingStrategy(
            replica_scheduling_type=jpol.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=(
                jpol.DIVISION_PREFERENCE_AGGREGATED if aggregated
                else jpol.DIVISION_PREFERENCE_WEIGHTED
            ),
            weight_preference=None if aggregated else jpol.ClusterPreferences(
                dynamic_weight=jpol.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS
            ),
        ),
    )


def _binding(i, replicas, placement, cpu, prev=None):
    return ResourceBinding(
        metadata=ObjectMeta(namespace="parity", name=f"app-{i}", uid=new_uid("rb")),
        spec=BindingSpec(
            resource=ObjectReference(
                api_version="apps/v1", kind="Deployment", namespace="parity",
                name=f"app-{i}",
            ),
            replicas=replicas,
            replica_requirements=ReplicaRequirements(resource_request={CPU: cpu}),
            placement=placement,
            clusters=[TargetCluster(name=n, replicas=r) for n, r in (prev or {}).items()],
        ),
    )


def flagship_mix(seed=0, n_clusters=96, n_bindings=256):
    """A small flagship mix: the bench.py build_flagship placements plus
    Steady up/down/eq and Fresh rows, taints and tolerations, eviction
    tasks, a not-ready share of the fleet and an ordered-affinity retry."""
    rng = np.random.default_rng(seed)
    clusters = synthetic_fleet(n_clusters, seed=seed, ready_fraction=0.85)
    names = [c.name for c in clusters]
    for c in clusters[::7]:
        c.spec.taints = [Taint(key="dedicated", value="gpu", effect="NoSchedule")]
    tolerant = _dyn(False)
    tolerant.cluster_tolerations = [jpol.Toleration(key="dedicated", value="gpu")]
    retry = jpol.Placement(
        cluster_affinities=[
            jpol.ClusterAffinityTerm(
                affinity_name="primary",
                affinity=jpol.ClusterAffinity(cluster_names=["no-such-cluster"]),
            ),
            jpol.ClusterAffinityTerm(
                affinity_name="backup",
                affinity=jpol.ClusterAffinity(cluster_names=names[10:40]),
            ),
        ],
        replica_scheduling=_dyn(True).replica_scheduling,
    )
    placements = [
        duplicated_placement(names[:16]),
        static_weight_placement({names[j]: j + 1 for j in range(8)}),
        _dyn(False),
        _dyn(True),
        tolerant,
        retry,
        static_weight_placement({names[j]: 3 for j in range(20, 44)}),
        jpol.Placement(),  # Duplicated over the whole fleet
        duplicated_placement(["no-such-cluster"]),  # FitError
    ]
    bindings = []
    for i in range(n_bindings):
        mode = i % 5
        prev = None
        if mode in (1, 2, 3):
            prev = {names[int(j)]: int(rng.integers(1, 6))
                    for j in rng.choice(n_clusters, size=int(rng.integers(1, 4)), replace=False)}
        replicas = int(rng.integers(1, 64))
        if prev and mode == 2:  # Steady unchanged
            replicas = sum(prev.values())
        elif prev and mode == 3:  # Steady scale-down
            replicas = max(1, sum(prev.values()) - 2)
        cpu = float(rng.choice([0.1, 0.25, 0.5, 1.0, 64.0, 512.0]))
        rb = _binding(i, replicas, placements[i % len(placements)], cpu, prev=prev)
        if mode == 4:  # Fresh reschedule
            rb.spec.reschedule_triggered_at = 2.0
            rb.status.last_scheduled_time = 1.0
        if i % 11 == 0:
            rb.spec.graceful_eviction_tasks = [
                GracefulEvictionTask(from_cluster=names[int(rng.integers(n_clusters))])
            ]
        if i % 13 == 0:
            rb.spec.replicas = 0  # non-workload row
        bindings.append(rb)
    return clusters, bindings


def _decision_view(d):
    return (
        d.key, d.error, d.affinity_name,
        None if d.targets is None else [(t.name, t.replicas) for t in d.targets],
        list(d.feasible),
    )


@pytest.mark.parametrize("candidate_k,host_tail", [(8, False), (16, False), (16, True)])
def test_schedule_matches_jax(candidate_k, host_tail, monkeypatch):
    """The slice end to end: the port's ArrayScheduler(device="cpu") and
    the JAX ArrayScheduler decide identically. host_tail routes the JAX
    round's division tails through its numpy twin (`host_tail`) instead of
    the XLA kernel, so both reference tails are held."""
    clusters, bindings = flagship_mix()
    if host_tail:
        monkeypatch.setattr(jcore, "HOST_TAIL_MIN_ELEMS", 0)
    ref = jcore.ArrayScheduler(clusters, candidate_k=candidate_k)
    port = TorchScheduler(
        from_reference_objects(clusters), candidate_k=candidate_k, device="cpu",
    )
    want = ref.schedule(bindings)
    got = port.schedule(from_reference_objects(bindings))
    assert ref.last_candidate_stats == port.last_candidate_stats
    assert port.last_candidate_stats["candidate_truncations"] > 0  # feas > K rows
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
    errors = {d.error.split(" ")[0] for d in got if d.error}
    assert errors == {"0/96", "Clusters"}  # FitError and unschedulable rows
    assert any(d.affinity_name == "backup" for d in got)


def test_serial_row_chunks_match_one_round(monkeypatch):
    """Rounds over the per-launch row cap run as serial chunks with the
    same decisions."""
    clusters, bindings = flagship_mix(seed=1, n_bindings=96)
    port_clusters = from_reference_objects(clusters)
    port_bindings = from_reference_objects(bindings)
    whole = TorchScheduler(port_clusters, candidate_k=16, device="cpu").schedule(port_bindings)
    monkeypatch.setenv("KARMADA_TPU_MAX_BC_ELEMS", str(24 * 96))
    chunked = TorchScheduler(port_clusters, candidate_k=16, device="cpu")
    assert chunked._max_rows_per_round(96) == 24
    got = chunked.schedule(port_bindings)
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in whole]


def test_spread_row_raises():
    """A cluster-only spread row whose feasible set outruns the window
    re-solves dense, and with the ClusterAffinity plugin disabled its
    per-row re-solve carries the selection on the extra_mask channel: the
    port decides it as the JAX package does (it raised before that channel
    was ported)."""
    clusters, bindings = flagship_mix(n_bindings=8)
    rb = bindings[2]
    rb.spec.placement.spread_constraints = [
        jpol.SpreadConstraint(spread_by_field="cluster", min_groups=2)
    ]
    plugins = ["*", "-ClusterAffinity"]
    want = jcore.ArrayScheduler(clusters, candidate_k=16, plugins=plugins).schedule([rb])
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=16, device="cpu",
                          plugins=plugins)
    got = port.schedule(from_reference_objects([rb]))
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
    assert got[0].ok


def test_extra_avail_matches_reference():
    """Registered-estimator answers (-1, 0, and values below and above the
    general estimate) ride the compact round as in the JAX package; an
    answer matrix of the wrong shape is refused."""
    clusters, bindings = flagship_mix(n_bindings=8)
    rng = np.random.default_rng(9)
    extra = np.where(rng.random((8, 96)) < 0.3, -1,
                     rng.choice([0, 3, 17, 1 << 20], (8, 96))).astype(np.int32)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=16, device="cpu")
    want = jcore.ArrayScheduler(clusters, candidate_k=16).schedule(bindings, extra_avail=extra)
    got = port.schedule(from_reference_objects(bindings), extra_avail=extra)
    assert [_decision_view(d) for d in got] == [_decision_view(d) for d in want]
    with pytest.raises(ValueError, match="extra_avail"):
        port.schedule(from_reference_objects(bindings), extra_avail=extra[:4])


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clusters, _ = flagship_mix(n_bindings=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchScheduler(from_reference_objects(clusters))


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, leaves jax
    and the JAX package out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import karmada_tpu_torch\n"
        "for m in pkgutil.walk_packages(karmada_tpu_torch.__path__, 'karmada_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'karmada_tpu.'))"
        " or n == 'karmada_tpu')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_schedule_decision_score_matches_reference():
    """ScheduleDecision's `score` slot and keyword (default None), in the
    reference's position: after `feasible`, before `affinity_name`."""
    import inspect

    from karmada_tpu_torch.sched.core import ScheduleDecision as TDecision

    JDecision = jcore.ScheduleDecision
    assert list(inspect.signature(TDecision).parameters) == list(
        inspect.signature(JDecision).parameters)
    assert set(TDecision.__slots__) == set(JDecision.__slots__)
    for cls in (JDecision, TDecision):
        d = cls("ns/a", None, "", ["c0"], 7, "term")
        assert (d.score, d.affinity_name, d.feasible) == (7, "term", ["c0"])
        assert cls("ns/b").score is None
        d.score = 3
        assert d.score == 3


@pytest.mark.parametrize("keyword,env", [(None, ""), (None, "0"), (None, "off"), (True, "0"),
                                         (False, ""), (False, "1")])
def test_autoshard_keyword_matches_reference(keyword, env, monkeypatch):
    """ArrayScheduler(autoshard=) takes the reference's default and
    precedence: the keyword when given, else KARMADA_TPU_AUTOSHARD
    (0/off/false disable), else on."""
    monkeypatch.setenv("KARMADA_TPU_AUTOSHARD", env)
    clusters = synthetic_fleet(8, seed=1)
    ref = jcore.ArrayScheduler(clusters, autoshard=keyword)
    port = TorchScheduler(from_reference_objects(clusters), autoshard=keyword, device="cpu")
    assert port.autoshard is ref.autoshard
    assert port.autoshard is (keyword if keyword is not None else env not in ("0", "off"))
