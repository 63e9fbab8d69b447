"""On-card smoke test of the PyTorch/CUDA port (karmada_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100 is the target) and nvcc; exits non-zero with no
result line otherwise. Phases, each of which raises on failure:

1. the device line: torch's device name, and nvidia-smi's name and power
   limit;
2. the build of every kernel of the compact candidate round from the
   sources in karmada_tpu_torch/kernels/csrc, with its seconds;
3. each kernel against its plain PyTorch version on the card, exactly
   (integer outputs): on seeded tie-heavy random inputs at the flagship
   shapes and on the flagship's own encoded batch; with each kernel's time,
   its plain version's time and its bound;
4. the main path: the flagship round (bench.py build_flagship's mix: 5 000
   clusters x 10 000 bindings, seed 0) through ArrayScheduler.schedule() on
   the card — one warm round, then timed rounds with p50/p99 — with every
   launch count set to 0 just before and read just after, and its
   decisions held against the same round run by the port on the CPU;
5. the `kernels` JSON line, then the card's name and power limit, then the
   last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from karmada_tpu_torch import kernels
from karmada_tpu_torch.api import policy as pol
from karmada_tpu_torch.api.meta import CPU, ObjectMeta, new_uid
from karmada_tpu_torch.api.work import (
    BindingSpec,
    ObjectReference,
    ReplicaRequirements,
    ResourceBinding,
    TargetCluster,
)
from karmada_tpu_torch.convert import batch_from_numpy
from karmada_tpu_torch.kernels import build
from karmada_tpu_torch.models.batch import pow2_bucket
from karmada_tpu_torch.sched.candidates import effective_k
from karmada_tpu_torch.sched.core import (
    TOPK_TARGETS,
    ArrayScheduler,
    _pad_rows_idx,
    _sorted_pairs,
)
from karmada_tpu_torch.testing.fixtures import (
    duplicated_placement,
    static_weight_placement,
    synthetic_fleet,
)

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# float32 rate outside the tensor cores, used here for the kernels' 32/64-bit
# integer ALU work
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

N_CLUSTERS = 5000
N_BINDINGS = 10000
TIMED_ROUNDS = 110  # p90 then has 11 samples beyond it

FLEET = ("alive", "capacity", "has_summary", "taint_key", "taint_value", "taint_effect", "api_ok")
SELECT_BATCH = ("replicas", "unknown_request", "gvk", "tol_tables", "tol_idx", "aff_masks",
                "aff_idx", "prev_idx", "prev_rep", "evict_idx", "seeds", "req_unique", "req_idx")
SELECT_OUT = ("cand_idx", "c_feas", "c_score", "c_avail", "c_prev", "c_tie", "feas_count",
              "packed")
TAIL_OUT = ("result", "unschedulable", "avail_sum", "nnz", "top_idx", "top_val")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# the flagship mix (bench.py build_flagship, rebuilt from the port's API)
# --------------------------------------------------------------------------


def _dyn_placement(aggregated: bool) -> pol.Placement:
    return pol.Placement(
        cluster_affinity=pol.ClusterAffinity(cluster_names=[]),
        replica_scheduling=pol.ReplicaSchedulingStrategy(
            replica_scheduling_type=pol.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=(
                pol.DIVISION_PREFERENCE_AGGREGATED if aggregated
                else pol.DIVISION_PREFERENCE_WEIGHTED
            ),
            weight_preference=None if aggregated else pol.ClusterPreferences(
                dynamic_weight=pol.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS
            ),
        ),
    )


def _binding(i, replicas, placement, cpu, prev=None, ns="bench"):
    return ResourceBinding(
        metadata=ObjectMeta(namespace=ns, name=f"app-{i}", uid=new_uid("rb")),
        spec=BindingSpec(
            resource=ObjectReference(api_version="apps/v1", kind="Deployment",
                                     namespace=ns, name=f"app-{i}"),
            replicas=replicas,
            replica_requirements=ReplicaRequirements(resource_request={CPU: cpu}),
            placement=placement,
            clusters=[TargetCluster(name=n, replicas=r) for n, r in (prev or {}).items()],
        ),
    )


def build_flagship(seed=0, n_clusters=N_CLUSTERS, n_bindings=N_BINDINGS):
    """The north-star mixed round: duplicated / static-weight /
    dynamic-weight / aggregated rows, one in three with a previous
    placement (bench.py:398-423, the same draws from the same seed)."""
    rng = np.random.default_rng(seed)
    clusters = synthetic_fleet(n_clusters, seed=seed)
    names = [c.name for c in clusters]
    placements = [
        duplicated_placement(names[:16]),
        static_weight_placement({names[j]: j + 1 for j in range(8)}),
        _dyn_placement(aggregated=False),
        _dyn_placement(aggregated=True),
    ]
    bindings = []
    for i in range(n_bindings):
        prev = {names[int(rng.integers(n_clusters))]: 2} if i % 3 == 0 else None
        bindings.append(_binding(i, int(rng.integers(1, 64)), placements[i % 4],
                                 float(rng.choice([0.1, 0.25, 0.5, 1.0])), prev=prev))
    return clusters, bindings


# --------------------------------------------------------------------------
# inputs at the flagship shapes
# --------------------------------------------------------------------------


def flagship_kernel_inputs(sched: ArrayScheduler, bindings):
    """The main path's own select and tail inputs for the flagship batch:
    rows permuted by class and encoded as launch_candidates does."""
    cls = np.asarray([sched._row_class(rb, False) for rb in bindings], np.int8)
    order = np.argsort(cls, kind="stable")
    bindings = [bindings[i] for i in order]
    cls = cls[order]
    raw = sched.batch_encoder.encode(bindings)
    batch = sched._pad(raw)
    k = effective_k(sched, raw, len(sched.fleet.names))
    t = batch_from_numpy({n: getattr(batch, n) for n in SELECT_BATCH + (
        "strategy", "fresh", "weight_tables", "weight_idx")}, sched.device)
    select_args = [sched._fleet_dev[n] for n in FLEET] + [t[n] for n in SELECT_BATCH] + [None]
    tails = []
    for want_cls, has_agg in ((1, False), (2, True)):
        idx_pad, nr = _pad_rows_idx(np.flatnonzero(cls == want_cls), sched._bucket)
        rows = idx_pad[:nr]
        idx = torch.from_numpy(idx_pad.astype(np.int64)).to(sched.device)
        topk = min(pow2_bucket(min(int(raw.replicas[rows].max()), TOPK_TARGETS), lo=8),
                   TOPK_TARGETS)
        tails.append((idx, topk, has_agg))
    return select_args, k, t, tails


def tail_args(sel, t, idx):
    cand_idx, c_feas, _, c_avail, c_prev, c_tie = sel[:6]
    pick = [x.index_select(0, idx) for x in (c_feas, c_avail, c_prev, c_tie, cand_idx)]
    return pick + [t["weight_tables"]] + [t[n].index_select(0, idx) for n in
                                         ("weight_idx", "strategy", "replicas", "fresh")]


def random_select_inputs(rng, dev, B, C, k):
    """Seeded tie-heavy select inputs at the flagship shapes: few distinct
    keys per row (so the window's tie order decides most winners), taints
    and tolerations, unknown GVKs, prev lists with sentinels, out-of-range
    and repeated columns, high-bit seeds, zero and absent requests, and a
    registered-estimator answer with -1 sentinels."""
    R, T, G, Kt, Tt, P, Kp, Ke, U = 4, 4, 6, 6, 8, 4, 8, 2, 8
    tol_tables = rng.integers(0, 4, (Tt, 4, Kt)).astype(np.int32)
    tol_tables[0] = 0
    prev_idx = rng.integers(-2, C + 3, (B, Kp)).astype(np.int32)
    prev_idx[:, 1] = prev_idx[:, 0]  # a column listed twice
    prev_idx[::2, 4:] = C  # the encoder's drop sentinel
    seeds = rng.integers(0, 2**63, B, dtype=np.uint64) | np.uint64(1 << 63)
    req_unique = rng.integers(0, 2000, (U, R)).astype(np.int64)
    req_unique[0] = 0
    capacity = rng.integers(-10, 2_000_000, (C, R)).astype(np.int64)
    capacity[::5, 0] = 0
    d = {
        "alive": rng.random(C) < 0.9,
        "capacity": capacity,
        "has_summary": rng.random(C) < 0.95,
        "taint_key": rng.integers(0, 4, (C, T)).astype(np.int32),
        "taint_value": rng.integers(0, 3, (C, T)).astype(np.int32),
        "taint_effect": rng.integers(0, 4, (C, T)).astype(np.int32),
        "api_ok": rng.random((C, G)) < 0.9,
        "replicas": rng.integers(0, 64, B).astype(np.int32),
        "unknown_request": rng.random(B) < 0.05,
        "gvk": rng.integers(0, G + 1, B).astype(np.int32),
        "tol_tables": tol_tables,
        "tol_idx": rng.integers(0, Tt, B).astype(np.int32),
        "aff_masks": rng.random((P, C)) < 0.6,
        "aff_idx": rng.integers(0, P, B).astype(np.int32),
        "prev_idx": prev_idx,
        "prev_rep": rng.integers(0, 9, (B, Kp)).astype(np.int32),
        "evict_idx": rng.integers(0, C + 1, (B, Ke)).astype(np.int32),
        "seeds": seeds,
        "req_unique": req_unique,
        "req_idx": rng.integers(0, U, B).astype(np.int32),
        "extra_avail": rng.integers(-1, 50, (B, C)).astype(np.int32),
    }
    t = batch_from_numpy(d, dev)
    return [t[n] for n in FLEET + SELECT_BATCH + ("extra_avail",)]


def random_tail_inputs(rng, dev, rows, K, C):
    """Seeded tie-heavy tail inputs: every strategy, Steady up/down/eq and
    Fresh rows, many equal weights and ties."""
    cand = np.sort(rng.choice(C, (rows, K)), axis=1).astype(np.int32)
    feas = rng.random((rows, K)) < 0.8
    prev = np.where(rng.random((rows, K)) < 0.05, rng.integers(1, 6, (rows, K)), 0)
    assigned = np.where(feas, prev, 0).sum(-1)
    replicas = rng.integers(0, 120, rows)
    mode = np.arange(rows) % 4
    replicas = np.where(mode == 2, assigned, replicas)
    replicas = np.where((mode == 1) & (assigned > 1), assigned - 1, replicas)
    d = {
        "c_feas": feas,
        "c_avail": rng.choice([0, 1, 2, 2, 9, 40], (rows, K)).astype(np.int32),
        "c_prev": prev.astype(np.int32),
        "c_tie": rng.integers(0, 4, (rows, K)).astype(np.int32),
        "cand_idx": cand,
        "weight_tables": rng.choice([0, 1, 3, 3], (4, C)).astype(np.int64),
        "weight_idx": rng.integers(0, 4, rows).astype(np.int32),
        "strategy": rng.choice([1, 2, 3, 4], rows).astype(np.int32),
        "replicas": replicas.astype(np.int32),
        "fresh": mode == 3,
    }
    return list(batch_from_numpy(d, dev).values())


# --------------------------------------------------------------------------
# comparison and timing
# --------------------------------------------------------------------------


def compare(name, got, want, fields) -> int:
    """Exact comparison of every output; returns the max abs error (0)."""
    worst = 0
    for f, a, b in zip(fields, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}.{f}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0
        worst = max(worst, err)
        if err:
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{name}.{f} differs from its plain version at {bad}")
    if "top_idx" in fields:  # the output window as the decode reads it
        gi, gv = _sorted_pairs(got[4].cpu().numpy(), got[5].cpu().numpy())
        wi, wv = _sorted_pairs(want[4].cpu().numpy(), want[5].cpu().numpy())
        if not (np.array_equal(gi, wi) and np.array_equal(gv, wv)):
            raise AssertionError(f"{name}: sorted output windows differ")
    return worst


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def select_bound(args, outs, k):
    """Bytes: every input read once, every output written once. Operations:
    per (row, column) the filter chain and key — one compare per taint
    slot, prev entry and evict entry plus 8 more — and the window's
    estimate per requested resource."""
    B, C = args[7].shape[0], args[0].shape[0]
    T, Kp, Ke, R = args[3].shape[1], args[14].shape[1], args[16].shape[1], args[1].shape[1]
    ops = B * C * (T + Kp + Ke + 8) + B * k * (4 * R + 12)
    return bound(nbytes(args) + nbytes(outs), ops)


def tail_bound(args_list, outs_list):
    """Per row of K window columns: three sorts of K keys (K log2 K
    compares each), one scan, and ~40 elementwise int64 operations per
    column."""
    ops, moved = 0, 0
    for args, outs in zip(args_list, outs_list):
        rows, K = args[0].shape
        ops += rows * (3 * K * max(K.bit_length() - 1, 1) + 2 * K + 40 * K)
        moved += nbytes(args) + nbytes(outs)
    return bound(moved, ops)


def decision_view(d):
    return (d.key, d.error, d.affinity_name,
            None if d.targets is None else [(t.name, t.replicas) for t in d.targets],
            list(d.feasible))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    log(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")

    # ---- the flagship and its scheduler (the batch feeds phase 3 too) ----
    t0 = time.perf_counter()
    clusters, bindings = build_flagship()
    sched = ArrayScheduler(clusters, device=dev)
    log(f"flagship: {len(clusters)} clusters x {len(bindings)} bindings built in "
        f"{time.perf_counter() - t0:.1f} s (fleet width {len(sched.fleet.names)})")

    # ---- phase 3: kernels against their plain versions on the card ----
    sel_args, k, t, tails = flagship_kernel_inputs(sched, bindings)
    B, C = sel_args[7].shape[0], sel_args[0].shape[0]
    n_tail = sum(int(idx.numel()) for idx, _, _ in tails)
    rng = np.random.default_rng(0)
    results = {}
    r_args = random_select_inputs(rng, dev, B, C, k)
    err = compare("candidate_select[random]",
                  kernels._select_launch(*r_args, k=k, plugin_bits=31),
                  kernels.select_plain(*r_args, k=k, plugin_bits=31), SELECT_OUT)
    r_tail = random_tail_inputs(rng, dev, n_tail, k, C)
    for has_agg, topk in ((True, 128), (False, 16), (True, 8)):
        err = max(err, compare(f"candidate_tail[random,{has_agg},{topk}]",
                               kernels._tail_launch(*r_tail, topk=topk, has_agg=has_agg),
                               kernels.tail_plain(*r_tail, topk=topk, has_agg=has_agg),
                               TAIL_OUT))
    log(f"random inputs (select {B}x{C} k={k}, tail {n_tail}x{k}): both kernels equal "
        "their plain versions (tolerance 0: integer outputs, compared exactly)")

    bits = sched._plugin_bits
    sel = kernels._select_launch(*sel_args, k=k, plugin_bits=bits)
    sel_err = compare("candidate_select[flagship]", sel,
                      kernels.select_plain(*sel_args, k=k, plugin_bits=bits), SELECT_OUT)
    t_args = [tail_args(sel, t, idx) for idx, _, _ in tails]
    t_outs = []
    tail_err = 0
    for a, (_, topk, has_agg) in zip(t_args, tails):
        out = kernels._tail_launch(*a, topk=topk, has_agg=has_agg)
        tail_err = max(tail_err, compare(f"candidate_tail[flagship,{has_agg}]", out,
                                         kernels.tail_plain(*a, topk=topk, has_agg=has_agg),
                                         TAIL_OUT))
        t_outs.append(out)
    log(f"flagship batch: select k={k}, tail rows "
        f"{[int(idx.numel()) for idx, _, _ in tails]}: both kernels equal their plain versions")

    sel_ms = cuda_ms(lambda: kernels._select_launch(*sel_args, k=k, plugin_bits=bits), 10)
    sel_plain_ms = cuda_ms(lambda: kernels.select_plain(*sel_args, k=k, plugin_bits=bits), 3)

    def both_tails(fn):
        return lambda: [fn(*a, topk=topk, has_agg=h) for a, (_, topk, h) in zip(t_args, tails)]

    tail_ms = cuda_ms(both_tails(kernels._tail_launch), 20)
    tail_plain_ms = cuda_ms(both_tails(kernels.tail_plain), 3)
    sb, sb_by = select_bound(sel_args, sel, k)
    tb, tb_by = tail_bound(t_args, t_outs)
    results["candidate_select"] = dict(
        source="karmada_tpu_torch/kernels/csrc/candidate_select.cu",
        replaces="karmada_tpu/sched/candidates.py:209",
        max_abs_err=max(err, sel_err), ms=sel_ms, plain_ms=sel_plain_ms,
        bound_ms=sb, bound_by=sb_by)
    results["candidate_tail"] = dict(
        source="karmada_tpu_torch/kernels/csrc/candidate_tail.cu",
        replaces="karmada_tpu/sched/candidates.py:279",
        max_abs_err=max(err, tail_err), ms=tail_ms, plain_ms=tail_plain_ms,
        bound_ms=tb, bound_by=tb_by)
    log(f"timing: select {sel_ms:.3f} ms (plain {sel_plain_ms:.3f}, bound {sb:.4f} {sb_by}); "
        f"tail, both launches of a round {tail_ms:.3f} ms (plain {tail_plain_ms:.3f}, "
        f"bound {tb:.4f} {tb_by})")

    # ---- phase 4: the main path ----
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decisions = sched.schedule(bindings)
    torch.cuda.synchronize()
    log(f"warm round: {time.perf_counter() - t0:.3f} s")
    times, gc_rounds = [], []
    for _ in range(TIMED_ROUNDS):
        full_gcs = gc.get_stats()[2]["collections"]
        t0 = time.perf_counter()
        decisions = sched.schedule(bindings)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        gc_rounds.append(gc.get_stats()[2]["collections"] > full_gcs)
    launches = kernels.launch_counts()
    p50, p90, p99 = (float(np.percentile(times, q)) for q in (50, 90, 99))
    log(f"flagship round on {name} ({smi}): p50 {p50:.4f} s p90 {p90:.4f} s "
        f"p99 {p99:.4f} s min {min(times):.4f} s max {max(times):.4f} s over "
        f"{TIMED_ROUNDS} rounds; launches {launches}; "
        f"candidate stats {sched.last_candidate_stats}")
    with_gc = [x for x, g in zip(times, gc_rounds) if g]
    without = [x for x, g in zip(times, gc_rounds) if not g]
    log(f"rounds with a full (generation 2) garbage collection: {len(with_gc)}, median "
        f"{np.median(with_gc) if with_gc else float('nan'):.4f} s; without: {len(without)}, "
        f"median {np.median(without) if without else float('nan'):.4f} s")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched by the flagship round")

    # where a round's time goes: one more round split at its seams (host
    # clock), and the batch encode alone (row cache warm, as in these rounds)
    t0 = time.perf_counter()
    state = sched._launch_solve(bindings)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sched._materialize_solve(state)
    t3 = time.perf_counter()
    sched.batch_encoder.encode(bindings)
    t4 = time.perf_counter()
    kernel_s = (sel_ms + tail_ms) / 1e3
    log(f"round breakdown: launch (classify + encode + upload + dispatch) {t1 - t0:.4f} s "
        f"[of which encode {t4 - t3:.4f} s], wait for the device {t2 - t1:.4f} s, "
        f"materialize (copy back + decode) {t3 - t2:.4f} s; kernel time per round "
        f"{kernel_s:.4f} s = {kernel_s / p50:.3f} of the p50 round (device busy share, "
        "from the phase-3 kernel timings)")

    t0 = time.perf_counter()
    cpu_sched = ArrayScheduler(clusters, device="cpu")
    cpu_dec = cpu_sched.schedule(bindings)
    log(f"cpu round (plain PyTorch path): {time.perf_counter() - t0:.1f} s")
    got = [decision_view(d) for d in decisions]
    want = [decision_view(d) for d in cpu_dec]
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"card and cpu decisions differ at row {bad}: {got[bad]} vs {want[bad]}")
    placed = sum(1 for d in decisions if d.ok)
    replicas = sum(t.replicas for d in decisions if d.ok for t in d.targets)
    log(f"decisions identical to the cpu round: {len(decisions)} rows, {placed} placed, "
        f"{replicas} replicas")

    line = {"kernels": [
        {"name": n, "route": "cuda", **{k_: v for k_, v in r.items() if k_ in ("source", "replaces")},
         "launches": launches[n], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": None, "matches_plain": True}
        for n, r in results.items()
    ]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
