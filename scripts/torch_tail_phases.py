"""Where the dense tail's shared-memory route spends its time, by phase, on
the card.

    python3 scripts/torch_tail_phases.py

Builds karmada_tpu_torch/kernels/csrc/dense_tail.cu a second time with
-DDENSE_TAIL_PHASES (thread 0 of each block adds the clock64() cycles of
each phase into a device array) beside the port's own build, then runs
both tails of one dense flagship round (chip_smoke.build_flagship with
dense-solve, 5 000 clusters x 10 000 bindings) through it, with their
output windows and without, and prints each phase's share of the
blocks' cycles and each call's time by CUDA events next to the
uninstrumented kernel's. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.kernels import build  # noqa: E402
from karmada_tpu_torch.sched.core import ArrayScheduler  # noqa: E402

PHASES = ("staging and row sums", "weights", "Aggregated cutoff", "quota sums",
          "bonus cutoff", "result row", "window cutoff", "window gather and sort")
REPS = 10


def build_instrumented() -> ctypes.CDLL:
    src = build.CSRC / "dense_tail.cu"
    flags = ["-DDENSE_TAIL_PHASES"]
    blob = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(build.CSRC.glob("*.cuh")))
    digest = hashlib.sha256(blob).hexdigest()[:12]
    out = build.BUILD_DIR / f"dense_tail_phases-{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(out), str(src)],
                       check=True)
    lib = ctypes.CDLL(str(out))
    lib.dense_tail_launch.restype = ctypes.c_int
    lib.dense_tail_launch.argtypes = kernels._DENSE_TAIL_ARGTYPES
    lib.dense_tail_phase_cycles.restype = ctypes.c_int
    lib.dense_tail_phase_cycles.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tail_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    print(chip_smoke.nvidia_smi_line(), flush=True)
    build.build_all()
    lib = build_instrumented()
    clusters, bindings = chip_smoke.build_flagship(dense=True)
    sched = ArrayScheduler(clusters, device=dev)
    filt_args, t, tails, *_ = chip_smoke.dense_kernel_inputs(sched, bindings)
    filt = kernels._dense_filter_launch(*filt_args, plugin_bits=sched._plugin_bits)
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    for rows, topk, has_agg in tails:
        args = chip_smoke.dense_tail_args(filt, t, rows)
        for w in (topk, 0):
            want = kernels._dense_tail_launch(*args, topk=w, has_agg=has_agg)

            def instrumented():
                outs = [torch.empty_like(o) for o in want]
                rc = lib.dense_tail_launch(
                    *[a.data_ptr() for a in args[:4]], args[0].shape[1], args[4].data_ptr(),
                    args[4].numel(), *[a.data_ptr() for a in args[5:]], min(w, args[0].shape[1]),
                    has_agg, 0, *[o.data_ptr() for o in outs], kernels._stream(dev))
                kernels._raise_on(rc, "instrumented dense_tail")
                return outs

            chip_smoke.compare("instrumented dense_tail", instrumented(), want,
                               chip_smoke.TAIL_OUT)
            torch.cuda.synchronize()
            kernels._raise_on(lib.dense_tail_phase_cycles(cycles), "phase read")  # zero them
            ms_i = chip_smoke.cuda_ms(instrumented, REPS)
            ms = chip_smoke.cuda_ms(
                lambda: kernels._dense_tail_launch(*args, topk=w, has_agg=has_agg), REPS)
            kernels._raise_on(lib.dense_tail_phase_cycles(cycles), "phase read")
            total = sum(cycles) or 1
            shares = "; ".join(f"{name} {100 * c / total:.1f} %"
                               for name, c in zip(PHASES, cycles))
            print(f"tail of {rows.numel()} rows x "
                  f"{args[0].shape[1]} (topk {w}, has_agg "
                  f"{has_agg}): {ms:.4f} ms ({ms_i:.4f} instrumented); cycles per row "
                  f"{total / (REPS + 1) / rows.numel():.0f}: {shares}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
