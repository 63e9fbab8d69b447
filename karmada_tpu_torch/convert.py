"""Carrying state across from the JAX package, and numpy tables onto a
device.

`from_reference_objects` copies an API object of the JAX package (a
Cluster, ResourceBinding, Placement, NodeSpec, Scenario,
FederatedResourceQuota, AdmissionRequest, ...) into the port's
dataclass of the same name, field by field, keeping the uid. Tie-breaks are seeded by the
binding UID (models/batch.py uid_seed), so converted objects make both
packages solve the same problem. It matches classes by NAME and never
imports the JAX package.

`mesh_like` builds the port's Mesh with a reference mesh's shape and axis
names over torch devices.

`batch_from_numpy` turns a BindingBatch's or FleetArrays' numpy tables into
torch tensors on one device; `schedule_args_from_numpy` does the same for
the dense-input program's 24 positional arrays (the reference graft
entry's `args`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api import cluster, meta, policy, search, simulation, work
from .models import nodes
from .webhook import admission

_PORT_CLASSES = {
    name: obj
    for mod in (meta, cluster, policy, work, nodes, simulation, search, admission)
    for name, obj in vars(mod).items()
    if isinstance(obj, type) and dataclasses.is_dataclass(obj)
}


def from_reference_objects(obj):
    """Deep copy of `obj` in which every dataclass instance is rebuilt as
    the port's class of the same name (lists, tuples and dicts are walked;
    other values are copied as they are)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        cls = _PORT_CLASSES.get(name)
        if cls is None:
            raise TypeError(f"the port has no API class named {name!r}")
        return cls(**{
            f.name: from_reference_objects(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        })
    if isinstance(obj, list):
        return [from_reference_objects(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(from_reference_objects(x) for x in obj)
    if isinstance(obj, dict):
        return {k: from_reference_objects(v) for k, v in obj.items()}
    return obj


def mesh_like(ref_mesh, devices):
    """The port's `parallel.mesh.Mesh` with `ref_mesh`'s grid shape and
    axis names (any object with `.devices` and `.axis_names`, such as a
    `jax.sharding.Mesh`), laid over `devices`: one torch device for every
    position, or a single device for all of them (a virtual mesh)."""
    from .parallel.mesh import Mesh

    shape = np.shape(ref_mesh.devices)
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * int(np.prod(shape))
    devices = list(devices)
    if len(devices) != int(np.prod(shape)):
        raise ValueError(f"mesh_like: {len(devices)} devices for a {shape} mesh")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), tuple(ref_mesh.axis_names))


def batch_from_numpy(d, device) -> dict:
    """{name: contiguous tensor on device} for a dict of numpy arrays (a
    BindingBatch or FleetArrays given by field). uint64 (the tie seeds)
    travels as its int64 bit pattern: torch has no uint64 shifts."""
    out = {}
    for k, v in d.items():
        a = np.ascontiguousarray(v)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        out[k] = torch.from_numpy(a).to(device)
    return out


# the dense-input program's positional arguments, in the reference's order
# (karmada_tpu/sched/core.py:320-326 `_schedule_kernel`)
SCHEDULE_ARGS = (
    "alive", "capacity", "has_summary", "taint_key", "taint_value", "taint_effect", "api_ok",
    "replicas", "request", "unknown_request", "gvk", "strategy", "fresh",
    "tol_key", "tol_value", "tol_effect", "tol_op",
    "affinity_ok", "eviction_ok", "static_weight", "prev_member", "prev_replicas", "tie",
    "extra_avail",
)
# the dense-input filter's arguments (kernels.dense_input_filter), a subset
# of SCHEDULE_ARGS in the same order: the tail's inputs left out
FILTER_ARGS = tuple(n for n in SCHEDULE_ARGS
                    if n not in ("strategy", "fresh", "static_weight", "prev_replicas", "tie"))


def schedule_args_from_numpy(args, device) -> tuple:
    """The 24 arrays of the dense-input program (any array-likes, in the
    order of SCHEDULE_ARGS) as contiguous tensors on `device`, dtypes
    kept."""
    if len(args) != len(SCHEDULE_ARGS):
        raise ValueError(f"expected {len(SCHEDULE_ARGS)} arrays, got {len(args)}")
    t = batch_from_numpy(dict(zip(SCHEDULE_ARGS, (np.asarray(a) for a in args))), device)
    return tuple(t[n] for n in SCHEDULE_ARGS)
