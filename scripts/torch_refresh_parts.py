"""Host cost of the dirty-column refresh's device step on one card: each
part alone, and the step in the churn_dirty round cold and warm.

    python3 scripts/torch_refresh_parts.py

From the repository root (it imports chip_smoke and karmada_tpu_torch from
the current directory). It builds the kernels, then prints, host clock:
- each part of one refresh at the churn width (50 dirty rows into seeded
  fleets at 5 120 columns), averaged over PARTS_CALLS back-to-back calls:
  the pinned block's allocation, the launcher's `stage` (the block, the
  ids and the seven gathers), the seven gathers alone, the non-blocking
  upload, the C call, `_apply` (upload + C call) and the whole `refresh`;
- in the churn_dirty round (chip_smoke's churn fleet, 50 clusters changing
  status a round), ROUNDS times: the refresh inside `set_clusters` right
  after a round (cold: its pack and upload + launch, chip_smoke's
  `timed_refresh` split), then the same rows again at once, with Python's
  garbage collector on and off in alternating order (warm).
Prints the card's nvidia-smi line first. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import gc
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.kernels import build  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler  # noqa: E402

PARTS_CALLS = 2000
ROUNDS = 12


def per_call_us(fn, calls=PARTS_CALLS) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def parts(dev):
    rng = np.random.default_rng(40)
    C = cs.shape_bucket(cs.N_CLUSTERS)
    dsts = cs.random_fleet(rng, dev, C)
    fleet = SimpleNamespace(**cs.random_fleet_arrays(rng, C))
    rows = np.sort(rng.choice(C, cs.DIRTY_CLUSTERS, replace=False)).astype(np.int64)
    launcher = kernels.fleet_scatter(dict(zip(cs.FLEET, dsts)))
    offs, nbytes = kernels._staged_layout(len(rows), launcher._row_bytes)
    host, n = launcher.stage(rows, fleet)
    view = host.numpy()
    staged = host.to(dev, non_blocking=True)
    stream = kernels._stream(dev)

    def gathers():
        for (name, _, dt, tail, w), o in zip(launcher._fields, offs):
            np.take(getattr(fleet, name), rows, axis=0,
                    out=view[o:o + n * w].view(dt).reshape((n,) + tail))

    got = {
        "pinned block": per_call_us(
            lambda: torch.empty(nbytes, dtype=torch.uint8, pin_memory=launcher._pin)),
        "stage": per_call_us(lambda: launcher.stage(rows, fleet)),
        "seven gathers": per_call_us(gathers),
        "upload": per_call_us(lambda: host.to(dev, non_blocking=True)),
        "C call": per_call_us(lambda: launcher._fn(launcher._ref, staged.data_ptr(), n, stream)),
        "_apply": per_call_us(lambda: launcher._apply(host, n)),
        "refresh": per_call_us(lambda: launcher.refresh(rows, fleet)),
    }
    cs.log(f"refresh parts, us a call over {PARTS_CALLS} back-to-back calls ({n} rows, C = "
           f"{C}): " + ", ".join(f"{k} {v:.2f}" for k, v in got.items()))


def in_round(dev):
    clusters, bindings = cs.build_churn()
    fleets = cs.status_churn(clusters, ROUNDS)
    sched = ArrayScheduler(clusters, device=dev)
    sched.schedule_incremental(bindings)
    torch.cuda.synchronize()
    cold, warm = [], {True: [], False: []}
    for k, (live, dirty) in enumerate(fleets):
        spans = []
        cs.timed_refresh(sched, live, dirty, spans)
        cold.append(spans[0][4:6])
        launcher = sched._fleet_scatter
        rows = np.flatnonzero([c.name in dirty for c in sched.clusters]).astype(np.int64)
        for gc_on in ((True, False) if k % 2 == 0 else (False, True)):
            if not gc_on:
                gc.disable()
            try:
                t0 = time.perf_counter()
                host, n = launcher.stage(rows, sched.fleet)
                t1 = time.perf_counter()
                launcher._apply(host, n)
                t2 = time.perf_counter()
            finally:
                gc.enable()
            warm[gc_on].append((t1 - t0, t2 - t1))
        sched.schedule_incremental(bindings)
        torch.cuda.synchronize()

    def fmt(v):
        return ", ".join(f"{a * 1e3:.4f} + {b * 1e3:.4f}" for a, b in v)

    cs.log(f"refresh in the churn_dirty round, ms pack + upload and launch: cold (in "
           f"set_clusters after a round) {fmt(cold)}; warm, the same rows again at once, "
           f"collector on {fmt(warm[True])}; collector off {fmt(warm[False])}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_refresh_parts: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    print(cs.nvidia_smi_line(), flush=True)
    build.build_all()
    parts(dev)
    in_round(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
