"""Build the CUDA kernels into shared libraries and load them with ctypes.

Each source under `csrc/` compiles on its own with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into `_build/<name>-<hash>.so` beside this file, the hash covering the
source, the shared headers (`csrc/*.cuh`) and the flags; all nvcc
processes start together. A library whose hash is already built is
reused. The sources have a plain C interface (no PyTorch headers), so a
build takes seconds.

`compile_counts()` / `compile_delta()` are the counterpart of the
reference's XLA compile counters (sched/compilecache.py), with the same
three keys: `jit_compiles` counts the libraries nvcc built in this
process, `jit_compile_seconds` their build time, and
`jit_persistent_cache_hits` the libraries found already built under
`_build/`. Each library counts once a process, at its first sight, so a
steady-state round reports `jit_compiles == 0`; where nothing is built
(the CPU) all three stay 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from ..metrics import jit_cache_misses, jit_compile_seconds, jit_persistent_cache_hits

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("candidate_select", "candidate_merge", "candidate_tail", "dense_filter", "dense_tail",
           "dense_mask", "group_score", "combo_select", "tiers", "fleet_estimate", "staleness",
           "scatter_rows", "sim_load")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# one build at a time: a prewarm thread and a round's first launch may
# both ask, and their nvcc outputs would share a temporary path
_build_lock = threading.Lock()
# library paths this process has accounted for in the compile counters
_seen: set[Path] = set()
_seen_lock = threading.Lock()


def _account(out: Path, built_seconds: Optional[float]) -> None:
    """Count one library once a process: built here (a compile, with its
    seconds) or found on disk (a persistent-cache hit)."""
    with _seen_lock:
        if out in _seen:
            return
        _seen.add(out)
    if built_seconds is None:
        jit_persistent_cache_hits.inc()
    else:
        jit_cache_misses.inc()
        jit_compile_seconds.observe(built_seconds)


def compile_counts() -> dict:
    """Snapshot of the build counters — callers diff two snapshots to
    attribute builds, seconds and disk hits to one round or prewarm pass."""
    return {
        "jit_compiles": int(jit_cache_misses.total()),
        "jit_compile_seconds": round(jit_compile_seconds.sum(), 6),
        "jit_persistent_cache_hits": int(jit_persistent_cache_hits.total()),
    }


def compile_delta(before: dict, after: Optional[dict] = None) -> dict:
    if after is None:
        after = compile_counts()
    return {
        k: round(after[k] - before[k], 6) if isinstance(after[k], float)
        else after[k] - before[k]
        for k in before
    }


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
    with _build_lock:
        return _build_all(verbose)


def _build_all(verbose: bool) -> dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    procs = {}
    t0 = time.perf_counter()
    for name, out in targets.items():
        if out.exists():
            _account(out, None)
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
        # the builds run together: a library's seconds run from the common
        # start to when its nvcc was seen to finish
        _account(out, time.perf_counter() - t0)
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

