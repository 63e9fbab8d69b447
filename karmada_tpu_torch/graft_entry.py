"""The graft entry's twin: the dense-input schedule program and a small
real workload for it.

    fn, args = entry(device="cpu")   # device=None: the CUDA card
    feasible, score, result, unschedulable, avail_sum, avail = fn(*args)

`entry()` returns `sched.core._schedule_kernel` and its 24 tensors, already
on the device, built from the dense views of a mixed-strategy batch
(models/batch.py) over a synthetic fleet, as the reference's
`__graft_entry__.entry()` builds them. `dryrun_multichip(n, device)` is
the reference's multi-chip dry run: the partitioned mesh round over a
virtual mesh of n copies of the device, checked inside against the
single-device round.

    dryrun_multichip(8, device="cpu")   # device=None: the CUDA card
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .api.meta import CPU, ObjectMeta, new_uid
from .api.policy import (
    DIVISION_PREFERENCE_AGGREGATED,
    DIVISION_PREFERENCE_WEIGHTED,
    DYNAMIC_WEIGHT_AVAILABLE_REPLICAS,
    REPLICA_SCHEDULING_DIVIDED,
    SPREAD_BY_FIELD_CLUSTER,
    SPREAD_BY_FIELD_REGION,
    ClusterAffinity,
    ClusterPreferences,
    Placement,
    ReplicaSchedulingStrategy,
    SpreadConstraint,
)
from .api.work import (
    BindingSpec,
    ObjectReference,
    ReplicaRequirements,
    ResourceBinding,
    TargetCluster,
)
from .convert import schedule_args_from_numpy
from .sched.core import ArrayScheduler, _schedule_kernel
from .testing.fixtures import duplicated_placement, static_weight_placement, synthetic_fleet


def example_objects(n_clusters: int, n_bindings: int):
    """(clusters, bindings): a synthetic fleet and a batch whose rows cycle
    Duplicated, static-weight, dynamic, Aggregated and region-spread, one
    in three with a previous placement (the reference's
    `_example_problem` objects)."""
    clusters = synthetic_fleet(n_clusters, seed=7)
    names = [c.name for c in clusters]

    def dyn(aggregated):
        return Placement(
            cluster_affinity=ClusterAffinity(cluster_names=[]),
            replica_scheduling=ReplicaSchedulingStrategy(
                replica_scheduling_type=REPLICA_SCHEDULING_DIVIDED,
                replica_division_preference=(
                    DIVISION_PREFERENCE_AGGREGATED
                    if aggregated
                    else DIVISION_PREFERENCE_WEIGHTED
                ),
                weight_preference=None
                if aggregated
                else ClusterPreferences(dynamic_weight=DYNAMIC_WEIGHT_AVAILABLE_REPLICAS),
            ),
        )

    spread_p = Placement(
        cluster_affinity=ClusterAffinity(cluster_names=[]),
        spread_constraints=[
            SpreadConstraint(spread_by_field=SPREAD_BY_FIELD_REGION,
                             min_groups=2, max_groups=3),
            SpreadConstraint(spread_by_field=SPREAD_BY_FIELD_CLUSTER,
                             min_groups=2),
        ],
    )
    bindings = []
    for i in range(n_bindings):
        kind = i % 5
        if kind == 0:
            p = duplicated_placement(names[: 2 + i % 3])
        elif kind == 1:
            p = static_weight_placement({names[j]: j + 1 for j in range(1 + i % 4)})
        elif kind == 4:
            p = spread_p  # region-HA rows
        else:
            p = dyn(aggregated=(kind == 3))
        prev = (
            [TargetCluster(name=names[i % len(names)], replicas=2)] if i % 3 == 0 else []
        )
        bindings.append(
            ResourceBinding(
                metadata=ObjectMeta(namespace="default", name=f"app-{i}", uid=new_uid("rb")),
                spec=BindingSpec(
                    resource=ObjectReference(
                        api_version="apps/v1", kind="Deployment",
                        namespace="default", name=f"app-{i}",
                    ),
                    replicas=4 + i % 5,
                    replica_requirements=ReplicaRequirements(
                        resource_request={CPU: 0.25 * (1 + i % 3)}
                    ),
                    placement=p,
                    clusters=prev,
                ),
            )
        )
    return clusters, bindings


def _example_problem(n_clusters: int, n_bindings: int, *, device=None, objects=None):
    """(sched, batch, bindings): the example's ArrayScheduler on `device`
    (None: the CUDA card, RuntimeError without one) and its padded batch. `objects` = (clusters, bindings) replaces the
    freshly built `example_objects` (the parity tests pass the reference's,
    carried across, so the uid-seeded ties agree)."""
    clusters, bindings = objects or example_objects(n_clusters, n_bindings)
    sched = ArrayScheduler(clusters, device=resolve_device(device))
    batch = sched._pad(sched.batch_encoder.encode(bindings))
    return sched, batch, bindings


def schedule_args(sched: ArrayScheduler, batch, device) -> tuple:
    """The dense-input program's 24 tensors on `device`: the scheduler's
    fleet tables and the batch's dense views, with `extra_avail` -1
    everywhere (no answers), as the reference's entry() passes it."""
    f = sched.fleet
    extra_avail = np.full((len(batch.replicas), len(f.names)), -1, np.int32)
    return schedule_args_from_numpy((
        f.alive, f.capacity, f.has_summary,
        f.taint_key, f.taint_value, f.taint_effect, f.api_ok,
        batch.replicas, batch.request, batch.unknown_request, batch.gvk,
        batch.strategy, batch.fresh,
        batch.tol_key, batch.tol_value, batch.tol_effect, batch.tol_op,
        batch.affinity_ok, batch.eviction_ok, batch.static_weight,
        batch.prev_member, batch.prev_replicas, batch.tie,
        extra_avail,
    ), device)


def entry(device=None, n_clusters: int = 16, n_bindings: int = 12):
    """(fn, args): `_schedule_kernel` and its 24 tensors on `device`
    (None: the CUDA card, RuntimeError without one)."""
    dev = resolve_device(device)
    sched, batch, _ = _example_problem(n_clusters, n_bindings, device=dev)
    return _schedule_kernel, schedule_args(sched, batch, dev)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The multi-chip dry run (the reference's `dryrun_multichip`) on a
    virtual mesh of `n_devices` copies of `device` (None: the CUDA card,
    RuntimeError without one) at a non-trivial shape: 512 clusters x 256
    mixed-strategy bindings (Duplicated, static-weight, dynamic,
    Aggregated and region-spread rows). It runs the full partitioned
    round sharded over the (bindings, clusters) mesh: `run_kernel` (the
    tile filter on every tile, the gather, the dense tail; some placement
    asserted), then `schedule` (the compact round: the select on every
    tile and the window merge), with sampled parity against the
    single-device round asserted inside; then the autoshard leg: a
    mesh-less scheduler whose [B, C] budget is shrunk below the round's
    footprint, with `n_devices` copies of the device visible, must route
    itself onto the mesh and decide as the single-device round."""
    from .parallel.mesh import make_mesh, virtual_devices

    dev = resolve_device(device)
    sched, _, bindings = _example_problem(512, 256, device=dev)
    clusters = sched.clusters[: sched.n_real_clusters]
    mesh_sched = ArrayScheduler(clusters, mesh=make_mesh([dev] * n_devices))
    batch = mesh_sched._pad(mesh_sched.batch_encoder.encode(bindings))
    out = mesh_sched.run_kernel(batch)
    assert bool(out[0].any()), "dryrun produced no feasible placements"
    assert int(out[2].to(torch.int64).sum()) > 0, "dryrun assigned no replicas"

    decisions = mesh_sched.schedule(bindings)
    assert any(d.ok and d.targets for d in decisions), "no decision decoded"

    # sampled parity with the single-device solve: same targets, same errors
    want = sched.schedule(bindings)
    sample = np.random.default_rng(0).choice(len(bindings), size=min(48, len(bindings)),
                                             replace=False)
    _hold_sample("sharded", decisions, want, sample)

    # the autoshard leg: an oversized round re-places itself onto the mesh
    auto = ArrayScheduler(clusters, device=dev)
    auto.max_bc_elems = 4096  # << 256 x 512: the oversized class
    with virtual_devices(n_devices, dev):
        auto_dec = auto.schedule(bindings)
    assert auto.mesh is not None, "autoshard did not engage the mesh path"
    _hold_sample("autoshard", auto_dec, want, sample)


def _hold_sample(label: str, got, want, sample) -> None:
    """Assert the sampled rows decide alike: ok, error and targets."""
    for b in sample:
        d, w = got[int(b)], want[int(b)]
        assert d.ok == w.ok, (
            f"{label} row {b}: mesh ok={d.ok} single ok={w.ok} ({d.error!r} vs {w.error!r})")
        if not d.ok:
            assert d.error == w.error, f"{label} row {b}"
            continue
        got_t = {t.name: t.replicas for t in d.targets}
        want_t = {t.name: t.replicas for t in w.targets}
        assert got_t == want_t, f"{label} row {b}: {got_t} != single-device {want_t}"
