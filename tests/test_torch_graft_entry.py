"""The PyTorch port's dense-input schedule program held against the JAX
package.

The reference's `_schedule_kernel` (jitted on the CPU) and the port's
`_schedule_kernel` on `device="cpu"` (its plain `_schedule_body`) take the
same 24 numpy arrays, carried across by `convert.schedule_args_from_numpy`:
the graft entry's example, two larger examples, and seeded random dense
inputs in which `prev_member` and `prev_replicas` disagree, with
evictions, tolerations, unknown requests and answers with -1s. The port's
`graft_entry._example_problem`, fed the reference's objects carried across
by `from_reference_objects`, must build the reference's 24 arrays. Every
comparison is exact (integer and bool outputs; tolerance 0)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402

from karmada_tpu_torch import graft_entry, kernels  # noqa: E402
from karmada_tpu_torch.convert import (  # noqa: E402
    FILTER_ARGS,
    SCHEDULE_ARGS,
    from_reference_objects,
    schedule_args_from_numpy,
)
from karmada_tpu_torch.sched import core as tcore  # noqa: E402

from test_torch_candidates import fake_card  # noqa: E402,F401 (fixture)

OUT = ("feasible", "score", "result", "unschedulable", "avail_sum", "avail")

_jit_kernel = jax.jit(jcore._schedule_kernel)


def reference_args(n_clusters, n_bindings):
    """The reference graft entry's 24 arrays at this size (its entry()
    recipe over `_example_problem`), with the reference's objects."""
    sched, batch, bindings = ge._example_problem(n_clusters, n_bindings)
    f = sched.fleet
    extra = np.full((len(batch.replicas), len(f.names)), -1, np.int32)
    args = (
        f.alive, f.capacity, f.has_summary,
        f.taint_key, f.taint_value, f.taint_effect, f.api_ok,
        batch.replicas, batch.request, batch.unknown_request, batch.gvk,
        batch.strategy, batch.fresh,
        batch.tol_key, batch.tol_value, batch.tol_effect, batch.tol_op,
        batch.affinity_ok, batch.eviction_ok, batch.static_weight,
        batch.prev_member, batch.prev_replicas, batch.tie,
        extra,
    )
    return args, sched.clusters[: sched.n_real_clusters], bindings


def random_dense_args(seed, B=24, C=40, R=3, T=3, K=4, G=5):
    """Seeded dense inputs: dead and summary-less columns, non-positive
    capacity, tolerations against tainted columns (every effect and
    operator), out-of-range gvks, unknown requests, random eviction and
    affinity masks, `prev_member` drawn independently of `prev_replicas`,
    every strategy, static weights with all-zero rows, tie-heavy ties and
    answers with -1s."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    static_weight = rng.integers(0, 6, (B, C)).astype(np.int64)
    static_weight[rng.random(B) < 0.25] = 0
    return (
        rng.random(C) < 0.9,
        rng.integers(-500, 20_000, (C, R)).astype(np.int64),
        rng.random(C) < 0.9,
        rng.integers(0, 4, (C, T)).astype(i32),
        rng.integers(0, 3, (C, T)).astype(i32),
        rng.integers(0, 4, (C, T)).astype(i32),
        rng.random((C, G)) < 0.9,
        rng.integers(0, 30, B).astype(i32),
        (rng.integers(0, 2_000, (B, R)) * (rng.random((B, R)) < 0.7)).astype(np.int64),
        rng.random(B) < 0.1,
        rng.integers(-1, G + 1, B).astype(i32),
        rng.integers(0, 5, B).astype(i32),
        rng.random(B) < 0.5,
        rng.integers(0, 4, (B, K)).astype(i32),
        rng.integers(0, 3, (B, K)).astype(i32),
        rng.integers(0, 4, (B, K)).astype(i32),
        rng.integers(0, 3, (B, K)).astype(i32),
        rng.random((B, C)) < 0.8,
        rng.random((B, C)) < 0.9,
        static_weight,
        rng.random((B, C)) < 0.2,
        np.where(rng.random((B, C)) < 0.2, rng.integers(1, 6, (B, C)), 0).astype(i32),
        rng.integers(0, 4, (B, C)).astype(i32),
        np.where(rng.random((B, C)) < 0.5, rng.integers(0, 40, (B, C)), -1).astype(i32),
    )


def assert_same(args):
    want = [np.asarray(w) for w in _jit_kernel(*args)]
    got = tcore._schedule_kernel(*schedule_args_from_numpy(args, "cpu"))
    assert len(got) == len(OUT)
    for name, w, g in zip(OUT, want, got):
        g = g.numpy()
        assert (g.dtype, g.shape) == (w.dtype, w.shape), name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return want


def test_graft_entry_matches_reference():
    """The reference graft entry's own (fn, args): the port's program on
    the same arrays gives all six outputs exactly."""
    fn, args = ge.entry()
    want = [np.asarray(w) for w in jax.jit(fn)(*args)]
    got = tcore._schedule_kernel(*schedule_args_from_numpy(args, "cpu"))
    for name, w, g in zip(OUT, want, got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert want[2].sum() > 0 and want[0].any()


@pytest.mark.parametrize("n_clusters,n_bindings", [(64, 40), (128, 96)])
def test_larger_examples_match_reference(n_clusters, n_bindings):
    args, _, _ = reference_args(n_clusters, n_bindings)
    want = assert_same(args)
    strategies = set(np.asarray(args[SCHEDULE_ARGS.index("strategy")]).tolist())
    assert {1, 2, 3, 4} <= strategies and want[2].sum() > 0


@pytest.mark.parametrize("seed,shape", [
    (0, {}), (1, {}), (2, {}), (3, {"B": 7, "C": 3, "R": 1, "T": 1, "K": 1, "G": 1}),
    (4, {"B": 16, "C": 130, "T": 4, "K": 6}), (5, {"K": 0}),
])
def test_random_dense_inputs_match_reference(seed, shape):
    args = random_dense_args(seed, **shape)
    pm = args[SCHEDULE_ARGS.index("prev_member")]
    pr = args[SCHEDULE_ARGS.index("prev_replicas")]
    assert (pm != (pr > 0)).any()  # the two inputs disagree
    want = assert_same(args)
    assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("n_clusters,n_bindings", [(16, 12), (64, 40)])
def test_example_problem_builds_reference_arrays(n_clusters, n_bindings):
    """The port's `_example_problem` over the reference's objects carried
    across, and `schedule_args` over its batch, give the reference's 24
    arrays (dtypes and values)."""
    want, clusters, bindings = reference_args(n_clusters, n_bindings)
    sched, batch, _ = graft_entry._example_problem(
        n_clusters, n_bindings, device="cpu",
        objects=from_reference_objects((clusters, bindings)))
    got = graft_entry.schedule_args(sched, batch, "cpu")
    for name, w, g in zip(SCHEDULE_ARGS, want, got):
        w = np.asarray(w)
        assert (g.numpy().dtype, g.shape) == (w.dtype, w.shape), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_example_objects_cover_every_strategy():
    """The port's own example (fresh objects, fresh uids) has the
    reference's row mix and decides on the CPU."""
    fn, args = graft_entry.entry(device="cpu", n_clusters=32, n_bindings=20)
    assert fn is tcore._schedule_kernel
    assert [a.device.type for a in args] == ["cpu"] * 24
    strategy = args[SCHEDULE_ARGS.index("strategy")]
    assert set(strategy.tolist()) >= {1, 2, 3, 4}
    out = fn(*args)
    assert out[2].sum() > 0 and out[0].any()


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()


def test_example_problem_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry._example_problem(16, 12)


@pytest.mark.parametrize("seed", [6, 7])
def test_dense_input_filter_plain_matches_reference_phase(seed):
    """The kernel's plain version against the reference's dense
    filter_estimate_phase and its answer merge."""
    args = random_dense_args(seed, B=20, C=70)
    named = dict(zip(SCHEDULE_ARGS, args))
    jf, js, ja = jcore.filter_estimate_phase(
        *(named[n] for n in FILTER_ARGS[:-1]))
    extra = named["extra_avail"]
    ja = np.where(extra >= 0, np.minimum(np.asarray(ja), extra), np.asarray(ja))
    t = schedule_args_from_numpy(args, "cpu")
    tn = dict(zip(SCHEDULE_ARGS, t))
    got = kernels.dense_input_filter(*(tn[n] for n in FILTER_ARGS))
    for name, w, g in zip(("feasible", "score", "avail"), (jf, js, ja), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_dense_input_filter_raises_off_cpu_and_cuda():
    args = [torch.empty((4,), dtype=torch.bool, device="meta")] + [None] * 18
    with pytest.raises(ValueError, match="dense_input_filter: unsupported device"):
        kernels.dense_input_filter(*args)


def test_program_launch_marshals_and_checks(fake_card):
    """The card route's marshalling on CPU tensors up to the (faked)
    library calls: one dense_input_filter_launch of 30 arguments (the
    widths, Kt, B and every plugin bit), then one dense_tail_launch over
    every row; a mis-typed input raises."""
    args = schedule_args_from_numpy(random_dense_args(8, B=12, C=40), "cpu")
    named = dict(zip(SCHEDULE_ARGS, args))
    out = kernels._dense_input_filter_launch(*(named[n] for n in FILTER_ARGS))
    (name, cargs), = fake_card
    assert name == "dense_input_filter_launch" and len(cargs) == 30
    assert cargs[7:11] == (40, 3, 3, 5) and cargs[19] == 4 and cargs[24:26] == (12, 31)
    assert [tuple(o.shape) for o in out] == [(12, 40)] * 3
    bad = dict(named, request=named["request"].to(torch.int32))
    with pytest.raises(TypeError, match="request: dtype"):
        kernels._dense_input_filter_launch(*(bad[n] for n in FILTER_ARGS))
    bad = dict(named, eviction_ok=named["eviction_ok"][:, :-1])
    with pytest.raises(ValueError, match="eviction_ok: shape"):
        kernels._dense_input_filter_launch(*(bad[n] for n in FILTER_ARGS))
