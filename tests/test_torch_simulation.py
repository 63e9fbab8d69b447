"""The PyTorch port's what-if simulation plane held against the JAX package.

The port's scenario-stacked solve (`_sim_solve`: sim_filter, dense_tail over
the S x B scenario rows, sim_load) against the reference's vmapped
`_sim_kernel` on the same seeded numpy inputs, all nine outputs; then the
port's Simulator(device="cpu") against the JAX Simulator on
tests/test_simulation.py's 12-cluster fleet, mixed bindings and scenario
set carried across by `from_reference_objects`: every scenario kind,
extra_avail, the spread fallback, scenario chunking, the SimulationError
cases, surge overcommit, the reports, and the store-level quota preflight.
Every comparison is exact (integers and strings; tolerance 0)."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.api import policy as jpol  # noqa: E402
from karmada_tpu.api.meta import ObjectMeta as JObjectMeta  # noqa: E402
from karmada_tpu.api.simulation import (  # noqa: E402
    SCENARIO_BASELINE,
    SCENARIO_CAPACITY,
    SCENARIO_COMPOSITE,
    SCENARIO_DRAIN,
    SCENARIO_LOSS,
    SCENARIO_PREEMPT,
    SCENARIO_SURGE,
    SCENARIO_TAINT,
    Scenario,
    SimulationRequest,
    SimulationRequestSpec,
)
from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.simulation import Simulator as JSimulator  # noqa: E402
from karmada_tpu.simulation import build_report as jbuild_report  # noqa: E402
from karmada_tpu.simulation import engine as jengine  # noqa: E402
from karmada_tpu.simulation import report as jreport  # noqa: E402
from karmada_tpu.testing.fixtures import duplicated_placement, synthetic_fleet  # noqa: E402

from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import batch_from_numpy, from_reference_objects  # noqa: E402
from karmada_tpu_torch.metrics import simulation_solves  # noqa: E402
from karmada_tpu_torch.sched import core as tcore  # noqa: E402
from karmada_tpu_torch.simulation import Simulator, build_report, diff_placements  # noqa: E402
from karmada_tpu_torch.simulation import engine as tengine  # noqa: E402
from karmada_tpu_torch.simulation.engine import SimulationError  # noqa: E402

from test_parallel import dyn_placement, make_binding  # noqa: E402
from test_torch_candidates import fake_card  # noqa: E402,F401 (fixture)
from test_simulation import fp, mixed_bindings, scenario_set  # noqa: E402

BATCH_ARGS = tcore._BATCH_FIELDS  # the factored batch, in _sim_kernel's order
SIM_OUT = ("unschedulable", "avail_sum", "feas_count", "nnz", "top_idx", "top_val",
           "assigned", "usage", "result")


@pytest.fixture()
def fleet():
    clusters = synthetic_fleet(12, seed=7)
    return clusters, [c.name for c in clusters]


def conv(x):
    return from_reference_objects(x)


def mixed_scenarios(names):
    """scenario_set plus a Composite of every step kind (drain, loss, taint,
    capacity, surge) and a second surge that outruns the fleet."""
    return scenario_set(names) + [
        Scenario(kind=SCENARIO_COMPOSITE, name="composite", steps=[
            Scenario(kind=SCENARIO_DRAIN, cluster=names[6]),
            Scenario(kind=SCENARIO_LOSS, cluster=names[7]),
            Scenario(kind=SCENARIO_TAINT, cluster=names[8], taint_key="k",
                     taint_effect="NoExecute"),
            Scenario(kind=SCENARIO_CAPACITY, cluster=names[9],
                     resources={"cpu": -40.0, "memory": -1e11}),
            Scenario(kind=SCENARIO_SURGE, surge_count=2, surge_replicas=5,
                     surge_request={"cpu": 2.0}),
        ]),
        Scenario(kind=SCENARIO_SURGE, surge_count=3, surge_replicas=10 ** 5,
                 surge_request={"cpu": 4.0}),
    ]


def assert_outcomes_equal(got, want):
    """Placements, errors, assigned, usage, overcommitted and injected of
    the port's outcomes equal the reference's, scenario for scenario."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.scenario.label() == w.scenario.label()
        assert g.errors == w.errors, g.scenario.label()
        assert set(g.placements) == set(w.placements), g.scenario.label()
        for key in w.placements:
            assert fp(g.placements[key]) == fp(w.placements[key]), (g.scenario.label(), key)
        np.testing.assert_array_equal(g.assigned, w.assigned)
        np.testing.assert_array_equal(g.usage, w.usage)
        np.testing.assert_array_equal(g.present, w.present)
        assert g.overcommitted == w.overcommitted
        assert g.injected == w.injected


def simulate_both(clusters, bindings, scenarios, extra=None, **kw):
    jsim = JSimulator(clusters, **kw)
    jbase, jouts = jsim.simulate(bindings, scenarios, extra_avail=extra)
    tsim = Simulator(conv(clusters), device="cpu", **kw)
    tbase, touts = tsim.simulate(conv(bindings), conv(scenarios), extra_avail=extra)
    assert_outcomes_equal([tbase] + touts, [jbase] + jouts)
    return (jsim, jbase, jouts), (tsim, tbase, touts)


def stats_but_mesh(stats):
    return {k: v for k, v in stats.items() if k != "mesh"}


# --------------------------------------------------------------------------
# the solve itself: _sim_solve against _sim_kernel
# --------------------------------------------------------------------------


def _sim_inputs(clusters, bindings, scenarios, seed, with_extra):
    """The reference Simulator's own scenario stack and padded batch for
    `scenarios`, with a seeded active mask (every base row active, each
    surge row in its owner scenario, then random drops) and a seeded
    extra_avail."""
    sim = JSimulator(clusters)
    all_scen = [Scenario(kind=SCENARIO_BASELINE, name="baseline")] + list(scenarios)
    union, owner = list(bindings), [-1] * len(bindings)
    for si, sc in enumerate(all_scen):
        for st in jengine.scenario_steps(sc):
            if st.kind == SCENARIO_SURGE:
                rows = jengine.surge_bindings(st, si)
                union += rows
                owner += [si] * len(rows)
    stacks, present, tie_idx = sim._encode_scenario_fleets(all_scen)
    raw = sim.batch_encoder.encode(union)
    batch = jcore.pad_batch(raw, jcore.ArrayScheduler._bucket)
    S, C = tie_idx.shape
    Bp = len(batch.replicas)
    rng = np.random.default_rng(seed)
    active = np.zeros((S, Bp), bool)
    for j, si in enumerate(owner):
        if si < 0:
            active[:, j] = True
        else:
            active[si, j] = True
    active &= rng.random((S, Bp)) < 0.85
    extra = None
    if with_extra:
        extra = rng.integers(-1, 12, (Bp, C)).astype(np.int32)
    return stacks, present, tie_idx, active, batch, extra


@pytest.mark.parametrize("with_extra", [False, True])
def test_sim_solve_matches_sim_kernel(fleet, with_extra):
    """All nine outputs of the port's solve equal the reference's vmapped
    `_sim_kernel` on the same numpy inputs: drains (a present mask with
    holes, repeated tie ranks), a taint, a capacity cut, surge-owned rows
    and seeded row drops in the active mask, with and without a seeded
    answer matrix."""
    clusters, names = fleet
    bindings = mixed_bindings(names, n=20)
    scenarios = mixed_scenarios(names)
    stacks, present, tie_idx, active, batch, extra = _sim_inputs(
        clusters, bindings, scenarios, seed=11, with_extra=with_extra)
    assert (~present).any() and not active.all()
    Bp, C = len(batch.replicas), tie_idx.shape[1]
    request = np.asarray(batch.request, np.int64)
    topk, has_agg = 8, True
    want = jengine._sim_kernel(
        *stacks, tie_idx, active, *(getattr(batch, n) for n in BATCH_ARGS),
        extra if with_extra else np.full((1, 1), -1, np.int32), request,
        topk=topk, has_agg=has_agg,
    )
    T = torch.from_numpy
    t = batch_from_numpy({n: getattr(batch, n) for n in BATCH_ARGS}, "cpu")
    got = tengine._sim_solve(
        *(T(np.ascontiguousarray(a)) for a in stacks), T(tie_idx.view(np.int64)), T(active),
        *(t[n] for n in BATCH_ARGS), None if extra is None else T(extra), T(request),
        topk=topk, has_agg=has_agg,
    )
    assert len(got) == len(SIM_OUT)
    for name, g, w in zip(SIM_OUT, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    result = got[8].numpy()
    assert result.shape == (len(stacks[0]), Bp, C) and (result > 0).any()
    # ties: equal values inside the output window, ordered by column
    assert (np.diff(got[5].numpy(), axis=-1) == 0).any()


def test_sim_solve_overflow_rows_fetch_dense():
    """A Duplicated row over the whole fleet places on more clusters than
    the output window (C = 160 > 128): both packages decode it from the
    dense result, the port through fetch_rows."""
    clusters = synthetic_fleet(160, seed=5)
    names = [c.name for c in clusters]
    bindings = mixed_bindings(names, n=8) + [
        make_binding("wide", 3, duplicated_placement([]), cpu=0.1)]
    scenarios = [Scenario(kind=SCENARIO_DRAIN, cluster=names[10]),
                 Scenario(kind=SCENARIO_LOSS, cluster=names[11])]
    (_, jbase, _), (_, tbase, touts) = simulate_both(clusters, bindings, scenarios)
    key = bindings[-1].metadata.key()
    assert len(tbase.placements[key]) > 128
    assert len(touts[0].placements[key]) == len(tbase.placements[key]) - 1


def test_sim_load_plain_is_the_active_row_product():
    """sim_load_plain against numpy int64 on seeded results, active masks
    and byte-sized requests (sums past 2^53)."""
    rng = np.random.default_rng(3)
    S, B, C, R = 3, 40, 17, 4
    result = rng.integers(0, 9, (S, B, C)).astype(np.int32)
    active = rng.random((S, B)) < 0.7
    request = rng.integers(0, 1 << 47, (B, R)).astype(np.int64)
    assigned, usage = kernels.sim_load(torch.from_numpy(result), torch.from_numpy(active),
                                       torch.from_numpy(request))
    r64 = np.where(active[:, :, None], result, 0).astype(np.int64)
    np.testing.assert_array_equal(assigned.numpy(), r64.sum(1))
    want = np.einsum("sbc,br->scr", r64, request)
    np.testing.assert_array_equal(usage.numpy(), want)
    assert want.max() > 1 << 53


def test_sim_wrappers_raise_off_cpu_and_cuda():
    """A wrapper runs the plain version only for CPU tensors; any other
    device raises (a CUDA tensor launches the kernel)."""
    meta = torch.empty((1, 2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="sim_load: unsupported device"):
        kernels.sim_load(meta, torch.empty((1, 2), dtype=torch.bool, device="meta"),
                         torch.empty((2, 4), dtype=torch.int64, device="meta"))
    args = [torch.empty((1, 4), dtype=torch.bool, device="meta")] + [None] * 21
    with pytest.raises(ValueError, match="sim_filter: unsupported device"):
        kernels.sim_filter(*args, plugin_bits=31)


def test_sim_launches_marshal_and_check(fleet, fake_card):
    """The launches' argument marshalling and checks, run on CPU tensors up
    to the (faked) library call: one sim_filter_launch of 44 arguments
    with the stacked widths, the batch's distinct requests and toleration
    tables, and the factored tables' scratch, one sim_load_launch of 10
    for 4, 9 and 17 resources (no resource cap); a mis-shaped tensor
    raises."""
    clusters, names = fleet
    stacks, _, tie_idx, active, batch, extra = _sim_inputs(
        clusters, mixed_bindings(names, n=6), scenario_set(names), seed=2, with_extra=True)
    T = torch.from_numpy
    t = batch_from_numpy({n: getattr(batch, n) for n in BATCH_ARGS}, "cpu")
    fleet_t = [T(np.ascontiguousarray(a)) for a in stacks]
    filt = (*fleet_t, T(tie_idx.view(np.int64)), t["replicas"], t["unknown_request"], t["gvk"],
            t["tol_tables"], t["tol_idx"], t["aff_masks"], t["aff_idx"], t["prev_idx"],
            t["prev_rep"], t["evict_idx"], t["seeds"], t["req_unique"], t["req_idx"], T(extra))
    out = kernels._sim_filter_launch(*filt, plugin_bits=31)
    (name, cargs), = fake_card
    S, C = tie_idx.shape
    Bp = len(batch.replicas)
    assert name == "sim_filter_launch" and len(cargs) == 44
    assert cargs[7:12] == (S, C, stacks[1].shape[2], stacks[3].shape[2], stacks[6].shape[2])
    U, Tt = t["req_unique"].shape[0], t["tol_tables"].shape[0]
    assert cargs[26:32] == (Bp, t["tol_tables"].shape[2], t["prev_idx"].shape[1],
                            t["evict_idx"].shape[1], U, Tt)
    assert all(p is not None for p in cargs[35:38])  # est_u, col_ok, api_t scratch
    assert [tuple(o.shape) for o in out] == [(S, Bp, C)] * 4 + [(S, Bp)]
    result = torch.zeros((S, Bp, C), dtype=torch.int32)
    request = T(np.asarray(batch.request, np.int64))
    assigned, usage = kernels._sim_load_launch(result, T(active), request)
    name, cargs = fake_card[-1]
    assert name == "sim_load_launch" and len(cargs) == 10 and cargs[3:7] == (S, Bp, C, 4)
    assert tuple(usage.shape) == (S, C, 4) and tuple(assigned.shape) == (S, C)
    # any resource count launches (the C entry runs blocks of eight)
    for R in (9, 17):
        _, usage = kernels._sim_load_launch(result, T(active),
                                            torch.zeros((Bp, R), dtype=torch.int64))
        name, cargs = fake_card[-1]
        assert name == "sim_load_launch" and cargs[3:7] == (S, Bp, C, R)
        assert tuple(usage.shape) == (S, C, R)
    with pytest.raises(ValueError, match="tie_idx: shape"):
        kernels._sim_filter_launch(*filt[:7], T(tie_idx.view(np.int64))[:, :-1], *filt[8:],
                                   plugin_bits=31)


# --------------------------------------------------------------------------
# the Simulator against the JAX Simulator
# --------------------------------------------------------------------------


def test_every_scenario_kind_matches_jax(fleet):
    """Baseline and every scenario kind (drain, loss, taint, capacity,
    surge, and a Composite of all of them) in one batched solve: the
    outcomes and last_stats equal the JAX Simulator's."""
    clusters, names = fleet
    scenarios = mixed_scenarios(names)
    (jsim, _, jouts), (tsim, _, touts) = simulate_both(
        clusters, mixed_bindings(names, n=24), scenarios)
    assert stats_but_mesh(tsim.last_stats) == stats_but_mesh(jsim.last_stats)
    assert tsim.last_stats["batched_solves"] == 1 and tsim.last_stats["mesh"] is False
    assert [o.injected for o in touts] == [0, 0, 0, 0, 4, 2, 3]
    assert any(o.overcommitted for o in touts) and any(o.errors for o in touts)


def test_extra_avail_matches_jax(fleet):
    """Registered-estimator answers for the caller's rows ride every
    scenario (surge rows get none)."""
    clusters, names = fleet
    bindings = mixed_bindings(names, n=16)
    extra = np.random.default_rng(4).integers(-1, 6, (len(bindings), len(names)))
    simulate_both(clusters, bindings, scenario_set(names), extra=extra.astype(np.int32))


def test_drain_bit_identical_to_cluster_removal(fleet):
    """A Drain scenario places exactly as the port's cold ArrayScheduler
    round on the fleet without that cluster (and as the JAX Simulator)."""
    clusters, names = fleet
    bindings = mixed_bindings(names)
    drain = Scenario(kind=SCENARIO_DRAIN, cluster=names[4])
    _, (_, _, (out,)) = simulate_both(clusters, bindings, [drain])
    removed = [c for c in conv(clusters) if c.name != names[4]]
    want = tcore.ArrayScheduler(removed, device="cpu").schedule(conv(bindings))
    for rb, w in zip(bindings, want):
        key = rb.metadata.key()
        if w.ok:
            assert fp(out.placements[key]) == fp(w.targets), key
            assert all(t.name != names[4] for t in out.placements[key]), key
        else:
            assert out.errors[key] == w.error, key


def test_sixteen_scenarios_one_batched_solve(fleet):
    """S = 16 drains and losses cost ONE batched solve (the solve-count
    metric), outcomes equal to the JAX Simulator's."""
    clusters, names = fleet
    scenarios = [
        Scenario(kind=SCENARIO_DRAIN if k % 2 == 0 else SCENARIO_LOSS,
                 cluster=names[k % len(names)])
        for k in range(16)
    ]
    before = simulation_solves.value(mode="batched")
    (_, _, _), (tsim, _, touts) = simulate_both(clusters, mixed_bindings(names, n=24), scenarios)
    assert simulation_solves.value(mode="batched") == before + 1
    assert tsim.last_stats["batched_solves"] == 1 and len(touts) == 16


def test_spread_rows_take_exact_fallback(fleet):
    """Spread-constrained and ordered-affinity rows take the per-scenario
    ArrayScheduler fallback; outcomes and their load equal the JAX
    Simulator's."""
    clusters, names = fleet
    spread = jpol.Placement(
        cluster_affinity=jpol.ClusterAffinity(cluster_names=[]),
        spread_constraints=[jpol.SpreadConstraint(
            spread_by_field=jpol.SPREAD_BY_FIELD_REGION, min_groups=2,
        )],
    )
    ordered = dyn_placement()
    ordered.cluster_affinities = [
        jpol.ClusterAffinityTerm(affinity_name="first",
                                 affinity=jpol.ClusterAffinity(cluster_names=names[:2])),
        jpol.ClusterAffinityTerm(affinity_name="second",
                                 affinity=jpol.ClusterAffinity(cluster_names=names[2:8])),
    ]
    bindings = mixed_bindings(names, n=6) + [
        make_binding("ha-app", 4, spread, cpu=0.25),
        make_binding("ordered", 6, ordered, cpu=0.5),
    ]
    scenarios = [Scenario(kind=SCENARIO_DRAIN, cluster=names[3]),
                 Scenario(kind=SCENARIO_LOSS, cluster=names[0])]
    (jsim, _, _), (tsim, _, touts) = simulate_both(clusters, bindings, scenarios)
    assert tsim.last_stats["fallback_rows"] == 2
    assert stats_but_mesh(tsim.last_stats) == stats_but_mesh(jsim.last_stats)
    assert tsim.last_stats["fallback_solves"] == 3
    assert "default/ha-app" in touts[0].placements


@pytest.mark.parametrize("budget,solves", [(64, 10), (600, 2)])
def test_scenario_chunking_equals_one_solve(fleet, budget, solves):
    """Past the max_bc_elems budget the rows run in groups of budget // C
    (at least 8) and the scenario axis in chunks of budget // (B·C)
    scenarios (at least one): 64 gives two groups of 8 rows, five chunks
    each, 600 one group of 16 rows in chunks of 3. The outcomes equal the
    unchunked solve's and the JAX Simulator's (which shards the oversized
    scenario axis over its CPU devices instead)."""
    clusters, names = fleet
    bindings = mixed_bindings(names)
    scenarios = scenario_set(names)[:4]
    (jsim, _, _), (tsim, tbase, touts) = simulate_both(
        clusters, bindings, scenarios, max_bc_elems=budget)
    assert tsim.last_stats["batched_solves"] == solves
    assert tsim.last_stats["mesh"] is False
    big = Simulator(conv(clusters), device="cpu")
    base, outs = big.simulate(conv(bindings), conv(scenarios))
    assert big.last_stats["batched_solves"] == 1
    assert_outcomes_equal([tbase] + touts, [base] + outs)


def test_oversized_solve_on_several_cards_refuses(fleet, monkeypatch):
    """With more than one device visible (two copies of the CPU through
    `virtual_devices`), autoshard on and an oversized volume, the solve no
    longer refuses: the scenario axis shards over the devices, as the
    reference's does over its CPU devices (`last_stats["mesh"]` True, the
    budget doubled, two solves of two scenarios each), and the outcomes
    equal the reference's; with autoshard off it chunks on one device."""
    from karmada_tpu_torch.testing.cpumesh import virtual_devices

    clusters, names = fleet
    bindings, scenarios = mixed_bindings(names, n=4), scenario_set(names)[:2]
    jsim = JSimulator(clusters, max_bc_elems=64)
    jbase, jouts = jsim.simulate(bindings, scenarios)
    assert jsim.last_stats["mesh"] is True
    sim = Simulator(conv(clusters), max_bc_elems=64, device="cpu")
    with virtual_devices(2, "cpu"):
        base, outs = sim.simulate(conv(bindings), conv(scenarios))
    assert sim.last_stats["mesh"] is True and sim.last_stats["batched_solves"] == 2
    assert_outcomes_equal([base] + outs, [jbase] + jouts)
    off = Simulator(conv(clusters), max_bc_elems=64, autoshard=False, device="cpu")
    with virtual_devices(2, "cpu"):
        base, outs = off.simulate(conv(bindings), conv(scenarios))
    assert off.last_stats["mesh"] is False and off.last_stats["batched_solves"] == 3
    assert_outcomes_equal([base] + outs, [jbase] + jouts)


@pytest.mark.parametrize("scenario,match", [
    (Scenario(kind=SCENARIO_DRAIN, cluster="nope"), "unknown cluster"),
    (Scenario(kind="Meteor", cluster="x"), "unknown scenario kind"),
    (Scenario(kind=SCENARIO_LOSS), "needs a cluster"),
    (Scenario(kind=SCENARIO_TAINT, cluster="member-0"), "needs taint_key"),
    (Scenario(kind=SCENARIO_SURGE, surge_count=0), "surge_count > 0"),
    (Scenario(kind=SCENARIO_PREEMPT, binding="default/x"), "preemption planner"),
    (Scenario(kind=SCENARIO_COMPOSITE, steps=[Scenario(kind=SCENARIO_COMPOSITE)]),
     "cannot nest"),
])
def test_simulation_errors_match_jax(fleet, scenario, match):
    """Client errors raise SimulationError with the reference's message."""
    clusters, names = fleet
    bindings = mixed_bindings(names, n=2)
    with pytest.raises(jengine.SimulationError, match=match) as want:
        JSimulator(clusters).simulate(bindings, [scenario])
    with pytest.raises(SimulationError) as got:
        Simulator(conv(clusters), device="cpu").simulate(conv(bindings), [conv(scenario)])
    assert str(got.value) == str(want.value)


def test_surge_overcommit_reported(fleet):
    """A surge that outruns fleet capacity: unplaceable surge rows, the
    injected count, and errors equal to the JAX Simulator's."""
    clusters, names = fleet
    surge = Scenario(kind=SCENARIO_SURGE, surge_count=3, surge_replicas=10 ** 6,
                     surge_request={"cpu": 8.0})
    _, (_, _, (out,)) = simulate_both(clusters, mixed_bindings(names, n=4), [surge])
    assert out.injected == 3
    surge_keys = [k for k in list(out.errors) + list(out.placements)
                  if k.startswith("karmada-simulation/")]
    assert len(surge_keys) == 3 and any(k in out.errors for k in surge_keys)


def test_reports_match_jax(fleet):
    """build_report and diff_placements (the before-image given by the
    caller) equal the reference's on the same outcomes."""
    clusters, names = fleet
    bindings = mixed_bindings(names, n=12)
    scenarios = mixed_scenarios(names)
    (jsim, jbase, jouts), (tsim, tbase, touts) = simulate_both(clusters, bindings, scenarios)
    req = SimulationRequest(metadata=JObjectMeta(name="what-if"),
                            spec=SimulationRequestSpec(scenarios=scenarios, diff_limit=3))
    want = jbuild_report(req, jbase, jouts, stats=jsim.last_stats, clusters=12,
                         bindings=len(bindings))
    got = build_report(conv(req), tbase, touts, stats=tsim.last_stats, clusters=12,
                       bindings=len(bindings))
    assert got == conv(want)
    assert any(r.displaced for r in got.scenarios) and got.batched_solves == 1
    before = {b.metadata.key(): [] for b in bindings[:3]}
    assert diff_placements(before, {}, touts[0], limit=2) == conv(
        jreport.diff_placements(before, {}, jouts[0], limit=2))


# --------------------------------------------------------------------------
# the quota admission preflight, store level
# --------------------------------------------------------------------------


class ListStore:
    """The store surface the preflight reads: `list(kind, namespace)`,
    deep copies, as the reference Store returns them."""

    def __init__(self, objs):
        self.objs = list(objs)

    def list(self, kind, namespace=None):
        return [copy.deepcopy(o) for o in self.objs
                if o.kind == kind and (namespace is None or o.metadata.namespace == namespace)]


def _quota(caps):
    from karmada_tpu.api.search import (
        FederatedResourceQuota,
        FederatedResourceQuotaSpec,
        StaticClusterAssignment,
    )

    return FederatedResourceQuota(
        metadata=JObjectMeta(name="quota", namespace="default"),
        spec=FederatedResourceQuotaSpec(
            overall={"cpu": 1000.0},
            static_assignments=[StaticClusterAssignment(cluster_name=c, hard={"cpu": h})
                                for c, h in caps.items()],
        ),
    )


def _preflights(fleet):
    from karmada_tpu.simulation.preflight import QuotaPreflight as JPreflight
    from karmada_tpu.store.store import Store

    from karmada_tpu_torch.simulation.preflight import QuotaPreflight

    clusters, names = fleet
    rb = make_binding("app", 8, dyn_placement(), cpu=1.0)
    store = Store()
    for c in clusters:
        store.create(copy.deepcopy(c))
    store.create(copy.deepcopy(rb))
    # the port's store holds what the reference's returns (resourceVersions
    # and all)
    port_store = ListStore(conv(store.list("Cluster") + store.list("ResourceBinding")))
    return JPreflight(store), QuotaPreflight(port_store, device="cpu"), names


def test_preflight_denies_stranding_caps_as_jax(fleet):
    from karmada_tpu.webhook.admission import AdmissionDenied as JDenied
    from karmada_tpu.webhook.admission import AdmissionRequest as JRequest

    from karmada_tpu_torch.webhook.admission import AdmissionDenied

    jpf, tpf, names = _preflights(fleet)
    req = JRequest(operation="CREATE", kind="FederatedResourceQuota",
                   obj=_quota({n: 0.25 for n in names}))
    with pytest.raises(JDenied, match="strands replicas") as want:
        jpf.validate(req)
    before = simulation_solves.value(mode="batched")
    with pytest.raises(AdmissionDenied) as got:
        tpf.validate(conv(req))
    assert str(got.value) == str(want.value)
    assert (got.value.webhook, got.value.reason) == (want.value.webhook, want.value.reason)
    assert simulation_solves.value(mode="batched") == before + 1


def test_preflight_allows_generous_caps_and_skips_status_writes(fleet):
    from karmada_tpu.webhook.admission import AdmissionRequest as JRequest

    jpf, tpf, names = _preflights(fleet)
    from karmada_tpu_torch.webhook.admission import AdmissionRequest

    # caps above what every cluster has: no deltas, allowed without a solve;
    # every cluster cut to 20 cpu available: a solve, and the 8 one-cpu
    # replicas still fit
    for caps, solves in (({n: 10_000.0 for n in names}, 0), ({n: 20.0 for n in names}, 1)):
        req = JRequest(operation="CREATE", kind="FederatedResourceQuota", obj=_quota(caps))
        jpf.validate(req)
        before = simulation_solves.value(mode="batched")
        tpf.validate(conv(req))
        assert simulation_solves.value(mode="batched") == before + solves

    frq = conv(_quota({n: 0.25 for n in names}))
    old = copy.deepcopy(frq)
    before = simulation_solves.value(mode="batched")
    # a spec-unchanged update (the status aggregation) and a delete skip
    # the solve
    frq.status.overall_used = {"cpu": 1.0}
    tpf.validate(AdmissionRequest(operation="UPDATE", kind="FederatedResourceQuota", obj=frq,
                                  old_thunk=lambda: old))
    tpf.validate(AdmissionRequest(operation="DELETE", kind="FederatedResourceQuota", obj=frq))
    assert simulation_solves.value(mode="batched") == before


# --------------------------------------------------------------------------
# the budget and autoshard resolvers, and the device default
# --------------------------------------------------------------------------


@pytest.mark.parametrize("env,override", [
    ("", None), ("", 4096), ("12345", None), ("12345", 77), ("abc", None), ("abc", 5),
    ("0", None), ("-3", None), ("", 0), ("", -1),
])
def test_resolve_max_bc_elems_matches_reference(monkeypatch, env, override):
    monkeypatch.setenv("KARMADA_TPU_MAX_BC_ELEMS", env)
    try:
        want = jcore.resolve_max_bc_elems(override)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tcore.resolve_max_bc_elems(override)
        assert str(got.value) == str(e)
        return
    assert tcore.resolve_max_bc_elems(override) == want


@pytest.mark.parametrize("env", ["", "0", "off", "false", "1", "on"])
@pytest.mark.parametrize("override", [None, True, False])
def test_resolve_autoshard_matches_reference(monkeypatch, env, override):
    monkeypatch.setenv("KARMADA_TPU_AUTOSHARD", env)
    assert tcore.resolve_autoshard(override) == jcore.resolve_autoshard(override)


def test_simulator_takes_the_budget_override(fleet, monkeypatch):
    clusters, _ = fleet
    monkeypatch.setenv("KARMADA_TPU_MAX_BC_ELEMS", "bogus")
    assert Simulator(conv(clusters), max_bc_elems=99, device="cpu").max_bc_elems == 99
    with pytest.raises(ValueError, match="must be an integer"):
        Simulator(conv(clusters), device="cpu")


def test_tie_from_index_generalises_tie_at():
    """tie_at is tie_from_index at the 1-based column, per column, per row
    and per scenario, equal to the reference's stream."""
    rng = np.random.default_rng(9)
    seeds = rng.integers(0, 2**63, 6, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    idx = np.cumsum(rng.random((3, 10)) < 0.8, axis=1).astype(np.uint64)
    want = np.stack([np.asarray(jcore.tie_from_index(seeds, i)) for i in idx])
    s = torch.from_numpy(seeds.view(np.int64))
    got = tcore.tie_from_index(s, torch.from_numpy(idx.view(np.int64))[:, None, :])
    np.testing.assert_array_equal(got.numpy(), want)
    cols = torch.arange(10)
    np.testing.assert_array_equal(tcore.tie_at(s, cols).numpy(),
                                  tcore.tie_from_index(s, cols + 1).numpy())


def test_simulator_needs_a_card_by_default(fleet):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    clusters, _ = fleet
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulator(conv(clusters))
