"""PyTorch/CUDA port of karmada-tpu's batched scheduling core.

The package mirrors the JAX package's module names (api/, models/, ops/,
sched/, testing/) so each function's counterpart is easy to find. Device
work runs on an NVIDIA GPU through hand-written CUDA kernels
(`kernels/`); every kernel has a plain PyTorch version beside it, which
the wrappers use only for tensors that lie on the CPU.

Entry points take `device=None`, which means the CUDA card. The CPU is used
only when the caller asks for it (`device="cpu"`), as the parity tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises RuntimeError when the default is asked for and no CUDA
    device is present — the port never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "karmada_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "path explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev
