"""A virtual mesh: n copies of one device.

The reference tests its mesh on n virtual CPU devices; the port's mesh is a
grid of torch devices in one process, and a device may appear more than
once, so the same grid shape runs on the CPU (the tests) or on one card
(`chip_smoke.py`). The tiles of a virtual mesh run in turn on that
device."""
from __future__ import annotations

from ..parallel.mesh import Mesh, make_mesh


def virtual_mesh(n_devices: int, device="cpu") -> Mesh:
    """A (bindings, clusters) mesh of `n_devices` copies of `device`,
    factored as make_mesh factors n devices (8 -> 4 x 2)."""
    if n_devices < 1:
        raise ValueError(f"virtual_mesh: {n_devices} devices")
    return make_mesh([device] * n_devices)
