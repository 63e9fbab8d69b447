"""Build the CUDA kernels into shared libraries and load them with ctypes.

Each source under `csrc/` compiles on its own with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into `_build/<name>-<hash>.so` beside this file, the hash covering the
source, the shared headers (`csrc/*.cuh`) and the flags; all nvcc
processes start together. A library whose hash is already built is
reused. The sources have a plain C interface (no PyTorch headers), so a
build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("candidate_select", "candidate_tail", "dense_filter", "dense_tail", "dense_mask",
           "group_score", "combo_select", "tiers", "fleet_estimate", "staleness", "scatter_rows",
           "sim_load")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel; returns
    {name: library path}. Raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        if verbose:
            print(f"built {out.name}\n{log}", flush=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib

