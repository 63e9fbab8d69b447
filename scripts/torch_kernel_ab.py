"""The redesigned kernels' time on the main path's own arguments, for an
A/B of two trees on one card: candidate_select, group_score,
packed_selection, combo_select, the dense round's mask step (feas_idx,
pack_rows), sim_filter, fleet_estimate, dense_filter,
candidate_tail, dense_input_filter, mesh_tile_filter and the tier
launches (tier_estimate, tier_consume).

    python3 /path/to/scripts/torch_kernel_ab.py [--kernels NAME,...]

Imports chip_smoke and karmada_tpu_torch from the current directory, so
the same script times this tree and an earlier commit unpacked under a
gitignored directory (`git archive <commit> | tar -x -C build/parent`):
run it from each tree's root in turns (parent, this, this, parent) in one
call. It builds the tree's kernels, then times by CUDA events, two turns
each:
- `kernels._select_launch` on the compact flagship's batch (10 240 x
  5 120, K = 128) and on a wide_40k chunk (the flagship mix at 20 000
  clusters, 20 480 padded, the pipelined chunk's 6 144 rows);
- `kernels._group_score_launch`, `_packed_selection_launch` and
  `_combo_select_launch` on the calls one round of config 4, config 4b and
  the drain cell makes (combo_select: the drain's);
- the dense round's mask step (`mask_step`) as each tree's round makes
  it, captured at launch: feas_idx at the dense flagship (2 500 mask rows
  x 5 120, k = 16) and pack_rows at the whole-fleet Duplicated round
  (its 2 500 Duplicated rows). Where the tree's mask kernels read the
  filter output through row ids (passed second, at launch) that
  is the kernel alone, the ids uploaded earlier with the tails'; in an
  earlier tree it is the upload of the padded mask row ids from pageable
  memory (which waits for the stream), the gather of their filter rows
  and the kernel over them. The digest covers the real rows' outputs;
- `kernels._sim_filter_launch` on the first call one round of whatif_churn5k
  (a chunk of 5 scenarios x 10 240 rows x 5 000 columns) and of whatif (17 x
  1 024 x 500) makes, captured at launch;
- `kernels._fleet_estimate_launch` on the estimator sweep of the flagship
  (its 5 000 dynamic rows over 5 000 clusters' shard_nodes pools), of the
  same rows made all distinct (each row's memory one byte apart), and of
  config 3 (1 000 x 1 000), each in the form the tree's own
  max_available_replicas_rows passes it: a table of distinct requests, each
  row's index and the snapshot's node ranges where the tree has them
  (`estimator.client.distinct_requests`), else the [B, R] request;
- `kernels._dense_filter_launch` on the dense flagship's batch (10 240 x
  5 120; also with a random extra_mask, and with a random answer
  matrix), on config 2's (1 024 x 100) and config 1's (128 x 3) batches,
  and on the call one tiers_dense round makes (its tightened capacity),
  captured at launch;
- `kernels._tail_launch` on the compact flagship round's two calls (5 120
  and 3 072 rows, K = 128), on the calls one tiers_compact round makes,
  on seeded windows of 5 120 rows at K = 8, 32, 100 and 128, and on 6
  rows at K = 128;
- `kernels._dense_input_filter_launch` on the graft_flagship program's
  call (the dense flagship's batch as the program's dense arguments,
  10 240 x 5 120), on seeded inputs of that shape with every row distinct
  (chip_smoke's phase-3 draw) and on the same inputs with each row's
  request, tolerations and gvk drawn from four rows;
- `kernels._mesh_tile_filter_launch` on the four tiles one mesh_flagship
  round passes it (the dense flagship over a 2 x 2 virtual mesh of the
  card) and on the six of a 2 x 3 round (tiles 1 707 wide), captured at
  launch;
- the tier launches of one tiers_dense round (`tier_estimate` in rows
  mode, `tier_consume` dense) and one tiers_compact round (window mode),
  each as the tree's main path makes them (a round's `TierLauncher`
  where the tree has one, whose window mode estimates a later tier's two
  passes in one launch, else `kernels._tier_estimate_launch` /
  `_tier_consume_launch`), captured at launch; and
  `kernels._tier_estimate_launch` in rows mode on seeded inputs at the
  flagship's shape (10 240 x 5 120, R = 4, a tier of 2 560 rows) with every
  row's request distinct and with four requests;
- the dirty-column refresh's device step (`scatter_rows`) as the tree's
  `_update_dirty_columns` makes it after encode_cols, at the churn width
  (58 rows, 8 of them repeated, into seeded fleets at 5 120 columns): a
  launcher's `refresh` (the rows gathered into one pinned block, one
  upload, one launch) where the tree has `kernels.fleet_scatter`, else the
  rows gathered per field, seven pageable uploads, the ids' upload and
  `kernels.scatter_rows`.
Beside each label's CUDA-event times it prints the device time per call
under torch.profiler and the host's time to enqueue a call. chip_smoke's
builders, seed 0. `--kernels` picks among candidate_select, group_score,
packed_selection, combo_select, mask_step, sim_filter, fleet_estimate,
dense_filter, candidate_tail, dense_input_filter, mesh_tile_filter,
tier_estimate (with tier_consume) and scatter_rows (default: all).
Prints one JSON line: the tree, the card's nvidia-smi line, and per
label the times in ms, the device and enqueue ms and a digest of the
outputs (equal digests: equal outputs). Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from karmada_tpu_torch import graft_entry, kernels  # noqa: E402
from karmada_tpu_torch.api.meta import MEMORY  # noqa: E402
from karmada_tpu_torch.api.work import ReplicaRequirements  # noqa: E402
from karmada_tpu_torch.convert import FILTER_ARGS, SCHEDULE_ARGS  # noqa: E402
from karmada_tpu_torch.estimator import client  # noqa: E402
from karmada_tpu_torch.estimator.client import MemberEstimators  # noqa: E402
from karmada_tpu_torch.kernels import build  # noqa: E402
from karmada_tpu_torch.models.nodes import NodeEncoder  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler, _pad_rows_idx  # noqa: E402
from karmada_tpu_torch.testing.cpumesh import virtual_mesh  # noqa: E402

REPS = 10  # launches per CUDA-event window
TURNS = 2
WIDE_CHUNK_BINDINGS = 6144  # the pipelined wide_40k chunk's rows
KERNELS = ("candidate_select", "group_score", "packed_selection", "combo_select", "mask_step",
           "sim_filter", "fleet_estimate", "dense_filter", "candidate_tail", "dense_input_filter",
           "mesh_tile_filter", "tier_estimate", "scatter_rows")
TIER_DRAW = (10240, 5120, 4, 2560)  # B, C, R and the tier's rows of the seeded estimate draws
INPUT_REPEATS = 4  # distinct rows of the repeated-row dense-input draw
TAIL_KS = (8, 32, 100, 128)  # seeded windows' widths
TAIL_ROWS = 5120  # the compact flagship's first tail


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed(fn, outputs=None) -> dict:
    """fn's times; the digest of its outputs (of `outputs()` if given)."""
    outs = fn() if outputs is None else outputs()
    return {"ms": [chip_smoke.cuda_ms(fn, REPS) for _ in range(TURNS)],
            "device_ms": chip_smoke.profiled_calls_ms(fn, REPS)[0],
            "enqueue_ms": chip_smoke.host_enqueue_ms(fn, REPS), "digest": digest(outs)}


def time_select(dev, result):
    for label, n_clusters, n_bindings in (
            ("candidate_select, compact flagship", chip_smoke.N_CLUSTERS, chip_smoke.N_BINDINGS),
            ("candidate_select, wide_40k chunk", chip_smoke.WIDE_CLUSTERS, WIDE_CHUNK_BINDINGS)):
        clusters, bindings = chip_smoke.build_flagship(n_clusters=n_clusters,
                                                       n_bindings=n_bindings)
        sched = ArrayScheduler(clusters, device=dev)
        args, k, _, _ = chip_smoke.flagship_kernel_inputs(sched, bindings)
        bits = sched._plugin_bits
        result[label] = timed(lambda: kernels._select_launch(*args, k=k, plugin_bits=bits))
        chip_smoke.log(f"{label} ({args[7].shape[0]} x {args[0].shape[0]}, k={k}): "
                       f"{result[label]}")
        del sched, clusters, bindings, args


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def time_spread(dev, result, which):
    """The spread kernels among `which` (group_score, packed_selection,
    combo_select) on the calls one round of config 4, config 4b and the
    drain cell makes."""
    names = [n for n in ("group_score", "packed_selection", "combo_select") if n in which]
    for cell, build_cell, expect in chip_smoke.SPREAD_CELLS:
        if cell == "window":  # launches no spread kernel
            continue
        calls, _, _ = chip_smoke.main_path_spread_calls(cell, build_cell, expect, dev)
        for n in names:
            if not calls[n]:
                continue
            label = f"{n}, {cell} round"
            launch = getattr(kernels, f"_{n}_launch")
            result[label] = timed(lambda cs=calls[n], f=launch: [
                o for a, kw in cs for o in _outputs(f(*a, **kw))])
            rows = [int(a[chip_smoke.SPREAD_KERNELS[n][4]].shape[0]) for a, _ in calls[n]]
            chip_smoke.log(f"{label} (rows per call {rows}): {result[label]}")
        del calls


def time_mask_step(dev, result):
    """The dense round's mask step as this tree's round makes it (see the
    module docstring): feas_idx at the dense flagship, pack_rows at the
    whole-fleet Duplicated round, the filter and mask launches of one round
    captured, the filter output made again from its captured arguments."""
    for cell, whole_fleet_dup, name in (("dense flagship", False, "feas_idx"),
                                        ("whole-fleet Duplicated", True, "pack_rows")):
        clusters, bindings = chip_smoke.build_flagship(dense=True, whole_fleet_dup=whole_fleet_dup)
        sched = ArrayScheduler(clusters, device=dev)
        with chip_smoke.captured_launches(("dense_filter", name)) as cap:
            sched.schedule(bindings)
        (f_args, f_kw), = cap["dense_filter"]
        (m_args, _), = cap[name]
        feasible = kernels._dense_filter_launch(*f_args, **f_kw)[0]
        # the round's mask rows: its class-0 rows in class order (no spread rows here)
        cls = np.asarray([sched._row_class(rb, False) for rb in bindings])
        mask_rows = np.flatnonzero(np.sort(cls, kind="stable") == 0)
        launch = getattr(kernels, f"_{name}_launch")
        # a tree whose mask kernels take row ids passes them second
        in_place = len(m_args) > 1 and isinstance(m_args[1], torch.Tensor)
        if in_place:
            rows, rest = m_args[1], m_args[2:]
            if not np.array_equal(rows.cpu().numpy(), mask_rows):
                raise AssertionError(f"{cell}: the round's mask rows are not its class-0 rows")

            def step(rows=rows, rest=rest, launch=launch, feasible=feasible):
                return launch(feasible, rows, *rest)
        else:
            idx = _pad_rows_idx(mask_rows, sched._bucket)[0].astype(np.int64)
            rest = m_args[1:]
            if not torch.equal(feasible.index_select(0, torch.from_numpy(idx).to(dev)), m_args[0]):
                raise AssertionError(f"{cell}: the round's gathered mask rows differ")

            def step(idx=idx, rest=rest, launch=launch, feasible=feasible):
                return launch(feasible.index_select(0, torch.from_numpy(idx).to(dev)), *rest)
        n = len(mask_rows)
        label = f"mask step ({name}), {cell} round"
        result[label] = timed(step, lambda step=step, n=n: [step()[:n]])
        chip_smoke.log(f"{label} ({n} mask rows x {feasible.shape[1]}, "
                       f"{'read in place' if in_place else 'upload + gather + kernel'}): "
                       f"{result[label]}")
        del sched, clusters, bindings, cap, feasible


def time_sim_filter(dev, result):
    for label, build_cell in (
            ("sim_filter, whatif_churn5k chunk", functools.partial(
                chip_smoke.build_whatif, n_clusters=chip_smoke.CHURN5K_CLUSTERS,
                n_bindings=chip_smoke.CHURN5K_BINDINGS)),
            ("sim_filter, whatif solve", chip_smoke.build_whatif)):
        clusters, bindings, scenarios = build_cell()
        sim = chip_smoke.Simulator(clusters, device=dev)
        with chip_smoke.captured_launches(("sim_filter",)) as calls:
            sim.simulate(bindings, scenarios)
        args, kw = calls["sim_filter"][0]
        del calls, sim
        result[label] = timed(lambda: kernels._sim_filter_launch(*args, **kw))
        shape = (args[0].shape[0], args[8].shape[0], args[0].shape[1])
        chip_smoke.log(f"{label} ({' x '.join(map(str, shape))}): {result[label]}")
        del args, kw


def sweep_call(members, names, reqs, dev, all_distinct=False):
    """The fleet sweep's arguments as this tree's max_available_replicas_rows
    passes them; `all_distinct` moves each row's memory one byte apart."""
    if all_distinct:
        reqs = [ReplicaRequirements(resource_request={
            **(r.resource_request if r else {}),
            MEMORY: (r.resource_request.get(MEMORY, 0.0) if r else 0.0) + i}) for i, r in
            enumerate(reqs)]
    est = MemberEstimators(members, device=dev)
    snap = list(est._fleet_snapshot(names))
    enc = NodeEncoder()
    if not hasattr(client, "distinct_requests"):  # the [B, R] request, sorted per launch
        dense = np.stack([enc.request_vector(r.resource_request if r else {}) for r in reqs])
        return snap + [torch.from_numpy(dense.astype(np.int64)).to(dev)], {}
    request_u, idx = client.distinct_requests(enc, reqs)
    req_idx = None if len(request_u) == len(idx) else torch.from_numpy(idx).to(dev)
    return (snap + [torch.from_numpy(request_u).to(dev)],
            {"req_idx": req_idx, "node_off": est._fleet_off})


def time_fleet_estimate(dev, result):
    clusters, bindings = chip_smoke.build_flagship()
    names = [c.name for c in clusters]
    members = chip_smoke.estimator_members(names)
    flag_reqs = [bindings[b].spec.replica_requirements
                 for b in chip_smoke.dynamic_rows(bindings)]
    c3_clusters, c3_bindings = chip_smoke.build_dynamic()
    c3_names = [c.name for c in c3_clusters]
    c3_reqs = [rb.spec.replica_requirements for rb in c3_bindings]
    for label, args, kw in (
            ("fleet_estimate, flagship sweep", *sweep_call(members, names, flag_reqs, dev)),
            ("fleet_estimate, flagship sweep, every row distinct",
             *sweep_call(members, names, flag_reqs, dev, all_distinct=True)),
            ("fleet_estimate, config 3 sweep", *sweep_call(
                chip_smoke.estimator_members(c3_names), c3_names, c3_reqs, dev))):
        result[label] = timed(lambda: [kernels._fleet_estimate_launch(*args, **kw)])
        chip_smoke.log(f"{label} ({args[-1].shape[0]} requests x {args[5]} clusters, "
                       f"{args[0].shape[0]} nodes, keywords {sorted(kw)}): {result[label]}")


def filter_args(sched, bindings):
    """The dense filter's arguments over a scheduler's padded batch."""
    batch = sched._pad(sched.batch_encoder.encode(bindings))
    t = chip_smoke.batch_from_numpy({n: getattr(batch, n) for n in chip_smoke.SELECT_BATCH},
                                    sched.device)
    return ([sched._fleet_dev[n] for n in chip_smoke.FLEET]
            + [t[n] for n in chip_smoke.SELECT_BATCH] + [None])


def time_dense_filter(dev, result):
    clusters, bindings = chip_smoke.build_flagship(dense=True)
    sched = ArrayScheduler(clusters, device=dev)
    args = chip_smoke.dense_kernel_inputs(sched, bindings)[0]
    bits = sched._plugin_bits
    B, C = args[7].shape[0], args[0].shape[0]
    rng = np.random.default_rng(14)
    mask = torch.from_numpy(rng.random((B, C)) < 0.5).to(dev)
    answers = torch.from_numpy(rng.integers(-1, 50, (B, C)).astype(np.int32)).to(dev)
    calls = [("dense flagship", args, None), ("dense flagship, extra_mask", args, mask),
             ("dense flagship, extra_avail", args[:-1] + [answers], None)]
    for cell, (c_clusters, c_bindings) in (("config 2", chip_smoke.build_static()),
                                           ("config 1", chip_smoke.build_dup3())):
        calls.append((cell, filter_args(ArrayScheduler(c_clusters, device=dev), c_bindings),
                      None))
    t_clusters, t_bindings, placed = chip_smoke.build_tiers()
    t_sched = ArrayScheduler(t_clusters, device=dev)
    with chip_smoke.captured_launches(("dense_filter",)) as cap:
        chip_smoke.tier_round(t_sched, t_bindings, placed)
    (t_args, t_kw), = cap["dense_filter"]
    calls.append(("tiers_dense round", t_args, t_kw.get("extra_mask")))
    for cell, a, m in calls:
        label = f"dense_filter, {cell}"
        result[label] = timed(lambda a=a, m=m: kernels._dense_filter_launch(
            *a, plugin_bits=bits, extra_mask=m))
        chip_smoke.log(f"{label} ({a[7].shape[0]} x {a[0].shape[0]}): {result[label]}")
    del sched, t_sched, args, calls, mask, answers


def time_candidate_tail(dev, result):
    clusters, bindings = chip_smoke.build_flagship()
    sched = ArrayScheduler(clusters, device=dev)
    sel_args, k, t, tails = chip_smoke.flagship_kernel_inputs(sched, bindings)
    sel = kernels._select_launch(*sel_args, k=k, plugin_bits=sched._plugin_bits)
    flag = [(chip_smoke.tail_args(sel, t, idx), {"topk": w, "has_agg": h})
            for idx, w, h in tails]
    del sel, sched, sel_args
    t_clusters, t_bindings, placed = chip_smoke.build_tiers(duplicated=False)
    t_sched = ArrayScheduler(t_clusters, device=dev)
    with chip_smoke.captured_launches(("tail",)) as cap:
        chip_smoke.tier_round(t_sched, t_bindings, placed)
    rng = np.random.default_rng(15)
    groups = [("compact flagship round (both calls)", flag),
              ("tiers_compact round", cap["tail"])]
    for K in TAIL_KS:
        a = chip_smoke.random_tail_inputs(rng, dev, TAIL_ROWS, K, chip_smoke.N_CLUSTERS)
        groups.append((f"seeded, {TAIL_ROWS} rows at K = {K}", [(a, {"topk": min(K, 64),
                                                                      "has_agg": True})]))
    a = chip_smoke.random_tail_inputs(rng, dev, 6, 128, 1024)
    groups.append(("seeded, 6 rows at K = 128", [(a, {"topk": 128, "has_agg": True})]))
    for name, cs in groups:
        label = f"candidate_tail, {name}"
        result[label] = timed(lambda cs=cs: [o for a, kw in cs
                                             for o in kernels._tail_launch(*a, **kw)])
        chip_smoke.log(f"{label} (rows x K per call "
                       f"{[tuple(a[0].shape) for a, _ in cs]}): {result[label]}")
    del t_sched, groups, flag


def time_dense_input_filter(dev, result):
    clusters, bindings = chip_smoke.build_flagship(dense=True)
    sched = ArrayScheduler(clusters, device=dev)
    batch = chip_smoke.dense_kernel_inputs(sched, bindings)[-1]
    args = graft_entry.schedule_args(sched, batch, dev)
    flag = [args[SCHEDULE_ARGS.index(n)] for n in FILTER_ARGS]
    del args, sched, batch
    B, C = flag[FILTER_ARGS.index("affinity_ok")].shape
    distinct = chip_smoke.random_dense_input_args(40 + C, dev, B, C)
    repeats = chip_smoke.random_dense_input_args(44 + C, dev, B, C)
    pick = torch.from_numpy(np.random.default_rng(15).integers(0, INPUT_REPEATS, B)).to(dev)
    for n in ("request", "gvk", "tol_key", "tol_value", "tol_effect", "tol_op"):
        k = FILTER_ARGS.index(n)
        repeats[k] = repeats[k][pick].contiguous()
    for name, a in (("graft_flagship call", flag), ("random, every row distinct", distinct),
                    (f"random, {INPUT_REPEATS} distinct rows", repeats)):
        label = f"dense_input_filter, {name}"
        result[label] = timed(lambda a=a: kernels._dense_input_filter_launch(*a))
        chip_smoke.log(f"{label} ({B} x {C}): {result[label]}")
    del flag, distinct, repeats


def time_mesh_tile_filter(dev, result):
    clusters, bindings = chip_smoke.build_flagship(dense=True)
    for name, mesh in (("mesh_flagship round, 2 x 2 tiles", virtual_mesh(4, dev)),
                       ("2 x 3 round's tiles", chip_smoke.mesh_of(dev, (2, 3)))):
        sched = ArrayScheduler(clusters, mesh=mesh, candidate_k=0, device=dev)
        sched.mesh_partitioned = False
        sched.schedule(bindings)
        batch = sched._pad(sched.batch_encoder.encode(bindings))
        with chip_smoke.captured_launches(("mesh_tile_filter",)) as cap:
            sched._mesh_solver()(batch)
        calls = cap["mesh_tile_filter"]
        label = f"mesh_tile_filter, {name}"
        result[label] = timed(lambda cs=calls: [
            o for a, kw in cs for o in kernels._mesh_tile_filter_launch(*a, **kw)])
        chip_smoke.log(f"{label} ({len(calls)} tiles of {calls[0][0][7].shape[0]} x "
                       f"{calls[0][0][0].shape[0]}): {result[label]}")
        del sched, batch, cap, calls


def tier_round_calls(duplicated, dev):
    """One round of a tier cell's tier launches as this tree's main path
    makes them: the estimates, the consumptions and their outputs for the
    digest (each output cloned as its call returns: a rows-mode estimate
    writes the round's avail buffer in place), each a callable that
    launches them again, and the counts."""
    clusters, bindings, placed = chip_smoke.build_tiers(duplicated=duplicated)
    sched = ArrayScheduler(clusters, device=dev)
    if hasattr(chip_smoke, "captured_tier_calls"):  # the round's launcher
        with chip_smoke.captured_tier_calls() as calls:
            chip_smoke.tier_round(sched, bindings, placed)
        est, con = calls["tier_estimate"], calls["tier_consume"]
        return (lambda: [c.run(fresh_out=False) for c in est],
                lambda: [c.run() for c in con],
                lambda: [x.clone() for c in est for x in c.written(c.run(fresh_out=False))],
                lambda: [c.run().clone() for c in con], len(est), len(con))
    with chip_smoke.captured_launches(("tier_estimate", "tier_consume")) as calls:
        chip_smoke.tier_round(sched, bindings, placed)
    est, con = calls["tier_estimate"], calls["tier_consume"]

    def written():
        outs = [kernels._tier_estimate_launch(*a, **kw) for a, kw in est]
        return [o.index_select(0, a[6].long()) if kw.get("out") is not None else o
                for (a, kw), o in zip(est, outs)]

    def consumed():
        return [kernels._tier_consume_launch(*a, **kw) for a, kw in con]
    return (lambda: [kernels._tier_estimate_launch(*a, **kw) for a, kw in est], consumed,
            written, consumed, len(est), len(con))


def tier_draw(dev, distinct):
    """Seeded rows-mode estimate inputs at the flagship's shape (TIER_DRAW):
    capacities around zero and past INT32_MAX quotients, absent summaries
    and unknown requests; `distinct` requests (one a row when it is B)."""
    B, C, R, n = TIER_DRAW
    rng = np.random.default_rng(16 + distinct)
    cap = rng.integers(-10, 2_000_000, (C, R)).astype(np.int64)
    cap[::97] = 1 << 45
    req_u = rng.integers(0, 2000, (distinct, R)).astype(np.int64)
    req_idx = (rng.permutation(B) if distinct == B else rng.integers(0, distinct, B))
    t = chip_smoke.batch_from_numpy({
        "capacity": cap, "has_summary": rng.random(C) < 0.95, "req_unique": req_u,
        "req_idx": req_idx.astype(np.int32), "replicas": rng.integers(0, 64, B).astype(np.int32),
        "unknown_request": rng.random(B) < 0.05,
        "rows": rng.permutation(B)[:n].astype(np.int32)}, dev)
    return [t[k] for k in chip_smoke.ESTIMATE_ARGS] + [t["rows"]], torch.full(
        (B, C), -1, dtype=torch.int32, device=dev)


def time_tier_estimate(dev, result):
    for cell, duplicated in (("tiers_dense", True), ("tiers_compact", False)):
        est, con, est_outs, con_outs, n_est, n_con = tier_round_calls(duplicated, dev)
        for name, fn, outs, n in (("tier_estimate", est, est_outs, n_est),
                                  ("tier_consume", con, con_outs, n_con)):
            label = f"{name}, {cell} round"
            result[label] = timed(fn, outs)
            chip_smoke.log(f"{label} ({n} launches): {result[label]}")
        torch.cuda.empty_cache()
    B, C, R, n = TIER_DRAW
    for distinct in (B, 4):
        args, out = tier_draw(dev, distinct)
        label = f"tier_estimate, seeded rows mode, {distinct} distinct requests"
        result[label] = timed(
            lambda a=args, o=out: [kernels._tier_estimate_launch(*a, out=o)],
            lambda a=args, o=out: [kernels._tier_estimate_launch(*a, out=o).index_select(
                0, a[-1].long())])
        chip_smoke.log(f"{label} ({B} x {C}, R = {R}, {n} tier rows): {result[label]}")


def time_scatter_rows(dev, result):
    """The refresh's device step at the churn width (module docstring)."""
    from types import SimpleNamespace

    rng = np.random.default_rng(40)
    C = chip_smoke.shape_bucket(chip_smoke.N_CLUSTERS)
    dsts = chip_smoke.random_fleet(rng, dev, C)
    fleet = SimpleNamespace(**{n: t.cpu().numpy() for n, t in zip(
        chip_smoke.FLEET, chip_smoke.random_fleet(rng, dev, C))})
    rows = rng.choice(C, chip_smoke.DIRTY_CLUSTERS, replace=False)
    rows = np.concatenate([rows, rows[:8]]).astype(np.int64)
    if hasattr(kernels, "fleet_scatter"):
        launcher = kernels.fleet_scatter(dict(zip(chip_smoke.FLEET, dsts)))

        def step():
            launcher.refresh(rows, fleet)
        route = "one pinned block, one upload, one launch"
    else:
        from karmada_tpu_torch.convert import batch_from_numpy
        from karmada_tpu_torch.sched.core import to_device

        def step():
            src = batch_from_numpy({n: getattr(fleet, n)[rows] for n in chip_smoke.FLEET}, dev)
            kernels.scatter_rows(dsts, to_device(rows, dev), [src[n] for n in chip_smoke.FLEET])
        route = "seven pageable uploads, the ids' pinned upload, one launch"
    label = "scatter_rows, churn_dirty refresh"
    result[label] = timed(step, lambda: (step(), dsts)[1])
    chip_smoke.log(f"{label} ({len(rows)} rows x C = {C}; {route}): {result[label]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated, among {', '.join(KERNELS)}")
    which = ap.parse_args().kernels.split(",")
    unknown = set(which) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(chip_smoke.DEVICE)
    build.build_all()
    result = {}
    if {"group_score", "packed_selection", "combo_select"} & set(which):
        time_spread(dev, result, which)
    for name, fn in (("mask_step", time_mask_step), ("candidate_select", time_select),
                     ("sim_filter", time_sim_filter), ("fleet_estimate", time_fleet_estimate),
                     ("dense_filter", time_dense_filter),
                     ("candidate_tail", time_candidate_tail),
                     ("dense_input_filter", time_dense_input_filter),
                     ("mesh_tile_filter", time_mesh_tile_filter),
                     ("tier_estimate", time_tier_estimate),
                     ("scatter_rows", time_scatter_rows)):
        if name in which:
            fn(dev, result)
    print(json.dumps({"tree": os.getcwd(), "card": chip_smoke.nvidia_smi_line(),
                      "kernel_ab": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
