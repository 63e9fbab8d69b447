"""`ArrayScheduler.run_kernel` and `pipeline_context` of the port against
the reference's: the same signature, called by position, and the same ten
outputs on one seeded fixture."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.sched import core as jcore  # noqa: E402
from karmada_tpu.testing.fixtures import (  # noqa: E402
    duplicated_placement,
    static_weight_placement,
    synthetic_fleet,
)

from karmada_tpu_torch.convert import from_reference_objects  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402
from karmada_tpu_torch.sched.pipeline import StageTimer  # noqa: E402

from test_torch_scheduler import _binding, _dyn  # noqa: E402

OUTS = ("feasible", "score", "result", "unschedulable", "avail_sum", "avail", "feas_count",
        "nnz", "top_idx", "top_val")


def _fixture(seed=3, n_clusters=40, n_bindings=30):
    """Every strategy over a small fleet (a not-ready share, Duplicated
    rows on 16 clusters, replicas up to 90 so the window reaches 128 > C),
    some rows with a previous placement."""
    rng = np.random.default_rng(seed)
    clusters = synthetic_fleet(n_clusters, seed=seed, ready_fraction=0.85)
    names = [c.name for c in clusters]
    placements = [duplicated_placement(names[:16]), static_weight_placement(
        {names[j]: j + 1 for j in range(6)}), _dyn(False), _dyn(True)]
    bindings = []
    for i in range(n_bindings):
        prev = None
        if i % 3 == 1:
            prev = {names[int(j)]: int(rng.integers(1, 5))
                    for j in rng.choice(n_clusters, size=2, replace=False)}
        bindings.append(_binding(i, int(rng.integers(1, 90)), placements[i % len(placements)],
                                 float(rng.choice([0.25, 0.5, 2.0, 64.0])), prev=prev))
    return clusters, bindings


@pytest.fixture(scope="module")
def encoded():
    clusters, bindings = _fixture()
    ref = jcore.ArrayScheduler(clusters)
    port = TorchScheduler(from_reference_objects(clusters), device="cpu")
    jb = ref._pad(ref.batch_encoder.encode(bindings))
    tb = port._pad(port.batch_encoder.encode(from_reference_objects(bindings)))
    return ref, port, jb, tb


@pytest.mark.parametrize("terms", ["none", "answers", "answers and mask"])
def test_run_kernel_matches_reference_by_position(encoded, terms):
    """Both packages' run_kernel called as run_kernel(batch, extra_avail,
    extra_mask): the ten outputs, in the reference's order, equal."""
    ref, port, jb, tb = encoded
    B, C = len(jb.replicas), len(ref.fleet.names)
    rng = np.random.default_rng(11)
    args = []
    if terms != "none":
        args.append(rng.integers(-1, 9, (B, C)).astype(np.int32))
    if terms == "answers and mask":
        args.append(rng.random((B, C)) < 0.8)
    want = [np.asarray(x) for x in ref.run_kernel(jb, *args)]
    got = [x.numpy() for x in port.run_kernel(tb, *args)]
    assert len(got) == len(want) == len(OUTS)
    for name, g, w in zip(OUTS, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (want[7] > 0).any() and want[8].shape[1] == min(C, 128)


def test_run_kernel_extra_score_raises(encoded):
    _ref, port, jb, tb = encoded
    score = np.zeros((len(jb.replicas), len(port.fleet.names)), np.int32)
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        port.run_kernel(tb, None, None, score)


@pytest.mark.parametrize("overlap", [True, False])
def test_pipeline_context_takes_the_overlap_flag(encoded, overlap):
    """pipeline_context(timer, overlap) installs the timer for the block
    and restores the previous one, whatever the flag."""
    _ref, port, _jb, _tb = encoded
    before = port.stage_timer
    timer = StageTimer()
    with port.pipeline_context(timer, overlap):
        assert port.stage_timer is timer
    assert port.stage_timer is before
