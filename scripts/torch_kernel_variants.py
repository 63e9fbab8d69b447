"""Designs of packed_selection and combo_select side by side on one card:
each variant source built and timed in turns against the tree's own
kernels on the calls one round of config 4 and the drain cell makes.

    python3 scripts/torch_kernel_variants.py SOURCE.cu [SOURCE.cu ...]

A SOURCE is an edited copy of karmada_tpu_torch/kernels/csrc/dense_mask.cu
(its file name starts with dense_mask) or csrc/combo_select.cu (starts
with combo_select), with the same C entry points. Each is built with
kernels/build.py's nvcc flags and -Xptxas -v (registers and spills are
printed) into build/variants_so/, and its entry is bound in place of the
tree's (`kernels._bound`), so the tree's launch wrappers drive it. Every
variant's outputs are held against the plain versions on every call,
then each (the tree's kernels as "built") is timed by CUDA events and
under torch.profiler in three turns, the order reversed every other
turn. Beside them, what the drain call's bytes cost alone: torch's
index_select of its filter rows, a clone of the gathered rows and
pack_rows over the same filter rows (read in place through the row
ids: packed_selection's body without the region test). chip_smoke's
builders, seed 0. Prints one JSON
line: the card's nvidia-smi line, each variant's ptxas lines and, per
label, the ms by events and the device ms of each turn. Needs one CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from karmada_tpu_torch import kernels  # noqa: E402
from karmada_tpu_torch.kernels import build  # noqa: E402

OUT = Path("build/variants_so")
TURNS = 3
REPS = 20
# source-name prefix -> (C entry, its ctypes prototype, kernel)
ENTRIES = {
    "dense_mask": ("packed_selection_launch", kernels._PACKED_SELECTION_ARGTYPES,
                   "packed_selection"),
    "combo_select": ("combo_select_launch", kernels._COMBO_SELECT_ARGTYPES, "combo_select"),
}


def build_variants(sources):
    """{name: (entry, bound C function, kernel)} and {name: ptxas lines}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        name = src.stem
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC), "-o",
               str(OUT / f"{name}.so"), str(src)]
        procs[name] = (src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns, ptx = {}, {}
    for name, (src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{src}: nvcc failed\n{log}")
        ptx[name] = [ln.strip() for ln in log.splitlines() if "Used" in ln or "stack frame" in ln]
        kind = next(k for k in ENTRIES if name.startswith(k))
        entry, argtypes, kernel = ENTRIES[kind]
        fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")), entry)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[name] = (entry, fn, kernel)
        chip_smoke.log(f"{name}: {ptx[name]}")
    return fns, ptx


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    sources = ap.parse_args().sources
    bad = [s for s in sources if not any(s.name.startswith(k) for k in ENTRIES)]
    if bad:
        ap.error(f"not a dense_mask or combo_select variant: {bad}")
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(chip_smoke.DEVICE)
    build.build_all()
    fns, ptx = build_variants(sources)
    for lib, (entry, argtypes, kernel) in ENTRIES.items():  # the tree's own kernels
        fns[f"built {kernel}"] = (entry, kernels._bind(lib, entry, argtypes), kernel)
    calls = {}
    for cell, build_cell, expect in chip_smoke.SPREAD_CELLS:
        if cell in ("config 4", "drain"):
            calls[cell] = chip_smoke.main_path_spread_calls(cell, build_cell, expect, dev)[0]
    names = sorted(fns)
    res = {}
    for turn in range(TURNS):
        for name in names if turn % 2 == 0 else names[::-1]:
            entry, fn, kernel = fns[name]
            kernels._bound[entry] = fn
            for cell, cl in ((c, calls[c][kernel]) for c in calls):
                if not cl:
                    continue

                def run(kernel=kernel, cl=cl):
                    return chip_smoke.run_calls(kernel, cl)

                if turn == 0:
                    fields = ("packed",) if kernel == "packed_selection" else chip_smoke.COMBO_OUT
                    for got, want in zip(run(), chip_smoke.run_calls(kernel, cl, plain=True)):
                        chip_smoke.compare(f"{name}, {cell}", got, want, fields)
                r = res.setdefault(f"{name}, {cell}", {"ms": [], "device_ms": []})
                r["ms"].append(chip_smoke.cuda_ms(run, REPS))
                r["device_ms"].append(chip_smoke.profiled_calls_ms(run, REPS)[0])
        kernels._bound.clear()
    (args, _), = calls["drain"]["packed_selection"]
    feas, rows = args[0], args[1]
    gathered = feas.index_select(0, rows.long())
    for label, fn in (("index_select of the drain call's filter rows",
                       lambda: feas.index_select(0, rows.long())),
                      ("clone of the gathered rows", gathered.clone),
                      ("pack_rows over the same filter rows",
                       lambda: kernels._pack_rows_launch(feas, rows))):
        res[f"bytes alone: {label}"] = {
            "ms": [chip_smoke.cuda_ms(fn, REPS) for _ in range(TURNS)],
            "device_ms": [chip_smoke.profiled_calls_ms(fn, REPS)[0] for _ in range(TURNS)],
            "shape": list(gathered.shape)}
    for label, r in res.items():
        chip_smoke.log(f"{label}: ms {['%.4f' % x for x in r['ms']]}, device "
                       f"{['%.4f' % x for x in r['device_ms']]}")
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(), "ptxas": ptx, "variants": res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
