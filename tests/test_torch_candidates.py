"""The plain versions of the two CUDA kernels (`select_plain`,
`tail_plain`) held against the JAX programs they replace
(`_candidate_select_kernel`, `_candidate_tail_kernel`, run on the CPU), on
batches encoded by both packages from the same converted objects. Exact
equality; the output window is compared after `_sorted_pairs`
normalisation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from karmada_tpu.sched import candidates as jcand  # noqa: E402
from karmada_tpu.sched import core as jcore  # noqa: E402

from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.convert import batch_from_numpy, from_reference_objects  # noqa: E402
from karmada_tpu_torch.sched import core as tcore  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler as TorchScheduler  # noqa: E402

from test_torch_scheduler import flagship_mix  # noqa: E402

BATCH_FIELDS = (
    "replicas", "unknown_request", "gvk", "strategy", "fresh", "tol_tables",
    "tol_idx", "aff_masks", "aff_idx", "weight_tables", "weight_idx",
    "prev_idx", "prev_rep", "evict_idx", "seeds", "req_unique", "req_idx",
)
FLEET_FIELDS = ("alive", "capacity", "has_summary", "taint_key", "taint_value",
                "taint_effect", "api_ok")


def _encode_both(n_bindings=128):
    clusters, bindings = flagship_mix(n_bindings=n_bindings)
    ref = jcore.ArrayScheduler(clusters, candidate_k=16)
    port = TorchScheduler(from_reference_objects(clusters), candidate_k=16, device="cpu")
    jb = ref._pad(ref.batch_encoder.encode(bindings))
    tb = port._pad(port.batch_encoder.encode(from_reference_objects(bindings)))
    for name in BATCH_FIELDS:  # the port's encoder is a faithful copy
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
    return ref, port, jb, tb


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("k,with_extra", [(16, False), (24, True)])
def test_select_plain_matches_candidate_select_kernel(k, with_extra):
    ref, port, jb, tb = _encode_both()
    B, C = len(jb.replicas), len(ref.fleet.names)
    extra = None
    if with_extra:
        extra = np.random.default_rng(0).integers(-1, 6, (B, C)).astype(np.int32)
    want = jcand._candidate_select_kernel(
        *ref.filter_kernel_args(jb, extra), k=k, plugin_bits=ref._plugin_bits,
    )
    f, t = port._fleet_dev, batch_from_numpy({n: getattr(tb, n) for n in BATCH_FIELDS}, "cpu")
    got = kernels.select_plain(
        *(f[n] for n in FLEET_FIELDS),
        t["replicas"], t["unknown_request"], t["gvk"], t["tol_tables"], t["tol_idx"],
        t["aff_masks"], t["aff_idx"], t["prev_idx"], t["prev_rep"], t["evict_idx"],
        t["seeds"], t["req_unique"], t["req_idx"],
        None if extra is None else torch.from_numpy(extra),
        k=k, plugin_bits=port._plugin_bits,
    )
    names = ("cand_idx", "c_feas", "c_score", "c_avail", "c_prev", "c_tie", "feas_count", "packed")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    assert (_n(got[6]) > k).any()  # rows whose feasible set outruns the window


@pytest.mark.parametrize("has_agg,topk", [(False, 16), (True, 8)])
def test_tail_plain_matches_candidate_tail_kernel(has_agg, topk):
    ref, port, jb, tb = _encode_both()
    k = 16
    sel = jcand._candidate_select_kernel(*ref.filter_kernel_args(jb), k=k,
                                         plugin_bits=ref._plugin_bits)
    cand_idx, c_feas, _, c_avail, c_prev, c_tie = (np.asarray(x) for x in sel[:6])
    strat = np.asarray(jb.strategy)
    rows = np.flatnonzero(np.isin(strat, (4,) if has_agg else (2, 3)))
    assert len(rows) > 4
    want = jcand._candidate_tail_kernel(
        c_feas[rows], c_avail[rows], c_prev[rows], c_tie[rows], cand_idx[rows],
        jb.weight_tables, jb.weight_idx[rows], jb.strategy[rows], jb.replicas[rows],
        jb.fresh[rows], topk=topk, narrow=False, has_agg=has_agg,
    )
    T = torch.from_numpy
    got = kernels.tail_plain(
        T(c_feas[rows]), T(c_avail[rows]), T(c_prev[rows]), T(c_tie[rows]), T(cand_idx[rows]),
        T(tb.weight_tables), T(tb.weight_idx[rows]), T(tb.strategy[rows]),
        T(tb.replicas[rows]), T(tb.fresh[rows]), topk=topk, has_agg=has_agg,
    )
    for name, a, b in zip(("result", "unschedulable", "avail_sum", "nnz"), got[:4], want[:4]):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=name)
    gi, gv = tcore._sorted_pairs(_n(got[4]), _n(got[5]))
    wi, wv = tcore._sorted_pairs(np.asarray(want[4]), np.asarray(want[5]))
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(np.where(gv > 0, gi, -1), np.where(wv > 0, wi, -1))
    # the window itself follows jax.lax.top_k's (value desc, column asc) order
    np.testing.assert_array_equal(_n(got[4]), np.asarray(want[4]))
