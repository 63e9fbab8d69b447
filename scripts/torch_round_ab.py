"""Round latency of the cells the redesigned kernels run in, for an A/B of
two trees on one card.

    python3 /path/to/scripts/torch_round_ab.py [--cells NAME,...]

Imports chip_smoke and karmada_tpu_torch from the current directory, so
the same script times this tree and an earlier commit unpacked under a
gitignored directory (`git archive <commit> | tar -x -C build/parent`):
run it from each tree's root in turns (parent, this, this, parent) in one
call. It builds the tree's kernels, then times the compact flagship round,
the dense flagship round, whatif and whatif_churn5k, estimator_flagship
(the compact flagship with member estimators on every cluster), config3,
tiers_dense, tiers_compact, mesh_flagship (the dense flagship through
ArrayScheduler(mesh=virtual_mesh(4, card), candidate_k=0), monolithic),
graft_flagship (the dense-input program, `_schedule_kernel`, on the
dense flagship's batch as its 24 dense arguments; each call timed by CUDA
events, in seconds like the rounds), config 4 (bench.py build_spread),
the drain cell (chip_smoke.build_drain: combo_select's cell), and
config 2 and config 1 (bench.py build_static and build_dup3: small
fleets, dense rounds of 100 x 1 000 and 3 x 100), and churn_dirty (the
churn fleet, 50 clusters changing status a round: set_clusters with
dirty_names, then schedule_incremental; the refresh split at its
encode_cols call into the dirty scan, encode_cols and the rest, the pack,
upload and launch; then the refresh alone on an idle stream and behind
QUEUED_WORK_MS of device work, torch.cuda._sleep, in turns)
(chip_smoke's build_* functions, seed 0; the
tier cells' round is launch_tiered + materialize_chunk), each round on
the host clock around a synchronised call, with its split (ArrayScheduler
and the tier cells: launch / wait / materialize; Simulator: fleet encodes
/ batch encode / solve / the rest; the estimator cells: sweep / merge /
the round given the answers; none for the mesh and the program; the
ArrayScheduler cells also their launch half's `solve` stage), and
dense_tail's, sim_load's, sim_filter's, fleet_estimate's, dense_filter's,
candidate_tail's, dense_input_filter's, mesh_tile_filter's, the spread
kernels' (group_score, packed_selection, spread_tail, combo_select) and
the mask kernels' (feas_idx, pack_rows) time in
those rounds by CUDA events around each wrapper call (its host enqueue
included). `--cells`
picks among the cells (default: all). Prints one JSON line: the tree, the
card's nvidia-smi line, and per cell the round times in seconds, their
p50, the splits' medians and each kernel's ms and calls a round. Needs
one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.estimator.client import EstimatorRegistry, MemberEstimators  # noqa: E402
from karmada_tpu_torch.kernels import build  # noqa: E402
from karmada_tpu_torch.sched import preemption  # noqa: E402
from karmada_tpu_torch import graft_entry  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler, _schedule_kernel  # noqa: E402
from karmada_tpu_torch.sched.pipeline import StageTimer  # noqa: E402
from karmada_tpu_torch.testing.cpumesh import virtual_mesh  # noqa: E402
from karmada_tpu_torch.simulation import engine  # noqa: E402
from karmada_tpu_torch.simulation.engine import Simulator  # noqa: E402

ROUNDS = {"compact flagship": 30, "dense flagship": 30, "whatif": 20, "whatif_churn5k": 4,
          "estimator_flagship": 20, "config3": 30, "tiers_dense": 15, "tiers_compact": 15,
          "mesh_flagship": 20, "graft_flagship": 30, "config 4": 20, "drain": 20,
          "config 2": 60, "config 1": 60, "churn_dirty": 10}
QUEUED_TURNS = 3  # churn_dirty: refreshes on an idle stream and behind queued work, each
QUEUED_WORK_MS = 20.0
# the kernels' wrappers, as the rounds call them
TIMED = ("dense_tail", "sim_load", "sim_filter", "fleet_estimate", "dense_filter",
         "candidate_tail", "dense_input_filter", "mesh_tile_filter", "group_score",
         "packed_selection", "spread_tail", "combo_select", "feas_idx", "pack_rows")


class KernelEvents:
    """While active, each call of kernels.<name> (name in TIMED) is
    bracketed by CUDA events on the current stream."""

    def __enter__(self):
        self.saved = {n: getattr(kernels, n) for n in TIMED}
        self.events = {n: [] for n in TIMED}
        for n, fn in self.saved.items():
            def wrap(*a, _fn=fn, _ev=self.events[n], **k):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = _fn(*a, **k)
                end.record()
                _ev.append((start, end))
                return out
            setattr(kernels, n, wrap)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(kernels, n, fn)

    def per_round(self, rounds):
        torch.cuda.synchronize()
        return {n: {"ms": sum(s.elapsed_time(e) for s, e in ev) / rounds,
                    "calls": len(ev) / rounds} for n, ev in self.events.items() if ev}


def sched_rounds(sched, bindings, rounds):
    """A warm round, then `rounds` rounds split launch / wait / materialize,
    and the launch half's `solve` stage (the kernel dispatch, host clock)
    read from a StageTimer."""
    sched.schedule(bindings)
    torch.cuda.synchronize()
    times, split = [], []
    sched.stage_timer = timer = StageTimer()
    with KernelEvents() as ev:
        for _ in range(rounds):
            solve0 = timer.totals.get("solve", 0.0)
            t0 = time.perf_counter()
            state = sched._launch_solve(bindings)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            sched._materialize_solve(state)
            t3 = time.perf_counter()
            times.append(t3 - t0)
            split.append((t1 - t0, t2 - t1, t3 - t2, timer.totals.get("solve", 0.0) - solve0))
    sched.stage_timer = None
    return (times, dict(zip(("launch", "wait", "materialize", "solve"),
                            np.median(split, 0).tolist())), ev.per_round(rounds))


def tier_rounds(sched, bindings, placed, rounds):
    """A warm round, then `rounds` tiered rounds (launch_tiered, then
    materialize_chunk) split launch / wait / materialize."""
    chip_smoke.tier_round(sched, bindings, placed)
    torch.cuda.synchronize()
    times, split = [], []
    with KernelEvents() as ev:
        for _ in range(rounds):
            t0 = time.perf_counter()
            state = preemption.launch_tiered(sched, bindings, placed=placed)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            sched.materialize_chunk(state)
            t3 = time.perf_counter()
            times.append(t3 - t0)
            split.append((t1 - t0, t2 - t1, t3 - t2))
    return (times, dict(zip(("launch", "wait", "materialize"), np.median(split, 0).tolist())),
            ev.per_round(rounds))


def sim_rounds(sim, bindings, scenarios, rounds):
    """A warm round, then `rounds` rounds split at the Simulator's seams."""
    secs = {}

    def timed(key, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if key == "solve":
                torch.cuda.synchronize()
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrap

    sim.simulate(bindings, scenarios)
    torch.cuda.synchronize()
    saved = engine._sim_solve
    sim._encode_scenario_fleets = timed("fleet encode", sim._encode_scenario_fleets)
    sim.batch_encoder.encode = timed("batch encode", sim.batch_encoder.encode)
    engine._sim_solve = timed("solve", saved)
    times, split = [], []
    try:
        with KernelEvents() as ev:
            for _ in range(rounds):
                secs.clear()
                t0 = time.perf_counter()
                sim.simulate(bindings, scenarios)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                parts = [secs.get(k, 0.0) for k in ("fleet encode", "batch encode", "solve")]
                split.append(parts + [times[-1] - sum(parts)])
    finally:
        del sim._encode_scenario_fleets, sim.batch_encoder.encode
        engine._sim_solve = saved
    keys = ("fleet encode", "batch encode", "solve", "rest")
    return times, dict(zip(keys, np.median(split, 0).tolist())), ev.per_round(rounds)


def estimator_rounds(sched, est, bindings, names, rounds):
    """A warm round, then `rounds` rounds of the registry's answers (the
    member sweep, then the host merge) and schedule(extra_avail=...)."""
    registry = EstimatorRegistry()
    registry.register_replica_estimator("members", est)
    sweep = {"s": 0.0}
    orig = est.max_available_replicas_rows

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        sweep["s"] += time.perf_counter() - t0
        return out

    sched.schedule(bindings, extra_avail=registry.batch_estimates(bindings, names))
    torch.cuda.synchronize()
    est.max_available_replicas_rows = timed
    times, split = [], []
    try:
        with KernelEvents() as ev:
            for _ in range(rounds):
                sweep["s"] = 0.0
                t0 = time.perf_counter()
                extra = registry.batch_estimates(bindings, names)
                t1 = time.perf_counter()
                sched.schedule(bindings, extra_avail=extra)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                times.append(t2 - t0)
                split.append((sweep["s"], t1 - t0 - sweep["s"], t2 - t1))
    finally:
        del est.max_available_replicas_rows
    return (times, dict(zip(("sweep", "merge", "round"), np.median(split, 0).tolist())),
            ev.per_round(rounds))


def mesh_rounds(sched, bindings, rounds):
    """A warm round, then `rounds` monolithic mesh rounds (no split)."""
    sched.schedule(bindings)
    torch.cuda.synchronize()
    times = []
    with KernelEvents() as ev:
        for _ in range(rounds):
            t0 = time.perf_counter()
            sched.schedule(bindings)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return times, {}, ev.per_round(rounds)


def program_calls(args, rounds):
    """A warm call, then `rounds` calls of the dense-input program, each
    timed by CUDA events (seconds)."""
    _schedule_kernel(*args)
    torch.cuda.synchronize()
    spans = []
    with KernelEvents() as ev:
        for _ in range(rounds):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            _schedule_kernel(*args)
            end.record()
            spans.append((start, end))
        torch.cuda.synchronize()
        per = ev.per_round(rounds)
    return [s.elapsed_time(e) / 1e3 for s, e in spans], {}, per


def split_refresh(sched, clusters, dirty):
    """sched.set_clusters(clusters, dirty_names=dirty) on the host clock,
    split at its encode_cols call: (dirty scan, encode_cols, the rest,
    whole) in seconds."""
    enc = sched.encoder
    inner, marks = enc.encode_cols, []

    def encode_cols(*a, **kw):
        marks.append(time.perf_counter())
        out = inner(*a, **kw)
        marks.append(time.perf_counter())
        return out

    enc.encode_cols = encode_cols
    try:
        t0 = time.perf_counter()
        sched.set_clusters(clusters, dirty_names=dirty)
        t3 = time.perf_counter()
    finally:
        del enc.encode_cols
    t1, t2 = marks
    return t1 - t0, t2 - t1, t3 - t2, t3 - t0


def dirty_rounds(clusters, bindings, rounds, dev):
    """churn_dirty: a warm round, then `rounds` rounds (refresh, then
    schedule_incremental) split dirty scan / encode_cols / the rest of the
    refresh / the incremental round; then the refresh alone, QUEUED_TURNS
    times in turns on an idle stream and behind QUEUED_WORK_MS of device
    work (its host ms and that work's ms by events under "queued")."""
    fleets = chip_smoke.status_churn(clusters, rounds + 1 + 2 * QUEUED_TURNS)
    sched = ArrayScheduler(clusters, device=dev)
    sched.schedule_incremental(bindings)
    torch.cuda.synchronize()
    times, split = [], []
    with KernelEvents() as ev:
        for live, dirty in fleets[:rounds + 1]:
            parts = split_refresh(sched, live, dirty)
            t0 = time.perf_counter()
            sched.schedule_incremental(bindings)
            torch.cuda.synchronize()
            times.append(parts[3] + time.perf_counter() - t0)
            split.append(parts[:3] + (time.perf_counter() - t0,))
        per = ev.per_round(rounds + 1)
    probe = 1_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(probe)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    torch.cuda.synchronize()
    cycles = int(probe * QUEUED_WORK_MS / start.elapsed_time(end))
    idle, queued, work = [], [], []
    rest = fleets[rounds + 1:]
    for k in range(0, len(rest), 2):
        torch.cuda.synchronize()
        idle.append(split_refresh(sched, *rest[k])[3] * 1e3)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(cycles)
        queued.append(split_refresh(sched, *rest[k + 1])[3] * 1e3)
        end.record()
        torch.cuda.synchronize()
        work.append(start.elapsed_time(end))
    keys = ("dirty scan", "encode_cols", "the rest (pack, upload, launch)", "round")
    out = dict(zip(keys, np.median(split[1:], 0).tolist()))
    out["refresh ms, idle"], out["refresh ms, queued"], out["queued work ms"] = idle, queued, work
    return times[1:], out, per


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(ROUNDS),
                    help=f"comma-separated, among {', '.join(ROUNDS)}")
    which = ap.parse_args().cells.split(",")
    unknown = set(which) - set(ROUNDS)
    if unknown:
        ap.error(f"unknown cells {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("torch_round_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    build.build_all()
    cells = {}

    def keep(name, times, split, kernel_ms):
        cells[name] = {"p50": float(np.percentile(times, 50)), "times": times, "split": split,
                       "kernels": kernel_ms}
        print(f"{name}: p50 {cells[name]['p50']:.4f} s, split {split}, kernels {kernel_ms}",
              file=sys.stderr, flush=True)

    for name, build_cell in (("compact flagship", chip_smoke.build_flagship),
                             ("dense flagship", lambda: chip_smoke.build_flagship(dense=True)),
                             ("config 4", chip_smoke.build_spread),
                             ("drain", chip_smoke.build_drain),
                             ("config 2", chip_smoke.build_static),
                             ("config 1", chip_smoke.build_dup3)):
        if name not in which:
            continue
        clusters, bindings = build_cell()
        keep(name, *sched_rounds(ArrayScheduler(clusters, device=dev), bindings, ROUNDS[name]))
        del clusters, bindings
    for name, kw in (("whatif", {}), ("whatif_churn5k", {
            "n_clusters": chip_smoke.CHURN5K_CLUSTERS,
            "n_bindings": chip_smoke.CHURN5K_BINDINGS})):
        if name not in which:
            continue
        clusters, bindings, scenarios = chip_smoke.build_whatif(**kw)
        keep(name, *sim_rounds(Simulator(clusters, device=dev), bindings, scenarios,
                               ROUNDS[name]))
        del clusters, bindings, scenarios
    for name, build_cell in (("estimator_flagship", chip_smoke.build_flagship),
                             ("config3", chip_smoke.build_dynamic)):
        if name not in which:
            continue
        clusters, bindings = build_cell()
        names = [c.name for c in clusters]
        est = MemberEstimators(chip_smoke.estimator_members(names), device=dev)
        keep(name, *estimator_rounds(ArrayScheduler(clusters, device=dev), est, bindings, names,
                                     ROUNDS[name]))
        est.close()
        del clusters, bindings, est
    for name, duplicated in (("tiers_dense", True), ("tiers_compact", False)):
        if name not in which:
            continue
        clusters, bindings, placed = chip_smoke.build_tiers(duplicated=duplicated)
        keep(name, *tier_rounds(ArrayScheduler(clusters, device=dev), bindings, placed,
                                ROUNDS[name]))
        del clusters, bindings, placed
    if "mesh_flagship" in which or "graft_flagship" in which:
        clusters, bindings = chip_smoke.build_flagship(dense=True)
        if "mesh_flagship" in which:
            sched = ArrayScheduler(clusters, mesh=virtual_mesh(4, dev), candidate_k=0,
                                   device=dev)
            sched.mesh_partitioned = False
            keep("mesh_flagship", *mesh_rounds(sched, bindings, ROUNDS["mesh_flagship"]))
            del sched
        if "graft_flagship" in which:
            sched = ArrayScheduler(clusters, device=dev)
            batch = chip_smoke.dense_kernel_inputs(sched, bindings)[-1]
            args = graft_entry.schedule_args(sched, batch, dev)
            keep("graft_flagship", *program_calls(args, ROUNDS["graft_flagship"]))
            del sched, batch, args
        del clusters, bindings
    if "churn_dirty" in which:
        clusters, bindings = chip_smoke.build_churn()
        keep("churn_dirty", *dirty_rounds(clusters, bindings, ROUNDS["churn_dirty"], dev))
        del clusters, bindings
    print(json.dumps({"tree": os.getcwd(), "smi": chip_smoke.nvidia_smi_line(),
                      "cells": cells}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
