"""candidate_select's, group_score's and combo_select's time on the main
path's own arguments, for an A/B of two trees on one card.

    python3 /path/to/scripts/torch_kernel_ab.py

Imports chip_smoke and karmada_tpu_torch from the current directory, so
the same script times this tree and an earlier commit unpacked under a
gitignored directory (`git archive <commit> | tar -x -C build/parent`):
run it from each tree's root in turns (parent, this, this, parent) in one
call. It builds the tree's kernels, then times by CUDA events, two turns
each, the tree's `kernels._select_launch` on the compact flagship's batch
(10 240 x 5 120, K = 128) and on a wide_40k chunk (the flagship mix at
20 000 clusters, 20 480 padded, the pipelined chunk's 6 144 rows), and
its `kernels._group_score_launch` (and the drain's `_combo_select_launch`)
on the calls one round of config 4, config 4b and the drain cell makes
(chip_smoke's builders, seed 0). Prints one JSON line: the tree, the
card's nvidia-smi line, and per label the times in ms and a digest of the
outputs (equal digests: equal outputs). Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.kernels import build  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler  # noqa: E402

REPS = 10  # launches per CUDA-event window
TURNS = 2
WIDE_CHUNK_BINDINGS = 6144  # the pipelined wide_40k chunk's rows


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed(fn) -> dict:
    outs = fn()
    return {"ms": [chip_smoke.cuda_ms(fn, REPS) for _ in range(TURNS)],
            "digest": digest(outs)}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(chip_smoke.DEVICE)
    build.build_all()
    result = {}
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
    for cell, build_cell, expect in chip_smoke.SPREAD_CELLS:
        if cell == "window":  # launches no group_score
            continue
        calls, _, _ = chip_smoke.main_path_spread_calls(cell, build_cell, expect, dev)
        for n, launch in (("group_score", kernels._group_score_launch),
                          ("combo_select", kernels._combo_select_launch)):
            if not calls[n]:
                continue
            label = f"{n}, {cell} round"
            result[label] = timed(
                lambda cs=calls[n], f=launch: [o for a, kw in cs for o in f(*a, **kw)])
            chip_smoke.log(f"{label}: {result[label]}")
    print(json.dumps({"tree": os.getcwd(), "card": chip_smoke.nvidia_smi_line(),
                      "kernel_ab": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
