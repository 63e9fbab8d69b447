"""The mesh-sharded solve (PyTorch port of parallel/mesh.py).

The scheduling problem is cut over a 2D grid of devices, in one process,
as the reference's single-controller `jax.sharding.Mesh` cuts it:

  axis "bindings" — data-parallel over the batch rows (rows are
    independent end to end, so no copy crosses this axis);
  axis "clusters" — over the fleet columns: the filters, the locality
    score and the GeneralEstimator are elementwise over (B, C) and run on
    each device's column shard; the replica division needs full rows, so
    the tiles of a row group are gathered along this axis first.

`Mesh` holds a [b, c] object array of `torch.device`s. A device may appear
more than once, which gives a virtual mesh (`testing/cpumesh.py
virtual_mesh`): the tiles then run in turn on that one device, as the
reference's virtual CPU devices do. The gather is a copy of each tile
onto the device of its row group — a peer copy between cards, a
concatenation on one device.

`MeshScheduleKernel` is the monolithic mesh round's solve: the hand-written
`mesh_tile_filter` kernel on every (row group, column shard) tile with the
shard's global column offset, the gather, then the `dense_tail` kernel over
each row group's full rows. It returns the reference's ten outputs, in its
order, with the row groups concatenated on `mesh.devices[0, 0]`.

The multi-host half (`initialize_multihost` over `torch.distributed`) and
the partitioned mesh rounds are later slices.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models.batch import AGGREGATED, BindingBatch
from ..models.fleet import FleetArrays
from ..sched.core import TOPK_TARGETS, to_device

AXIS_BINDINGS = "bindings"
AXIS_CLUSTERS = "clusters"

# the seven fleet tensors, in the reference's order
_FLEET_FIELDS = ("alive", "capacity", "has_summary", "taint_key", "taint_value",
                 "taint_effect", "api_ok")
# the batch's per-row fields, padded with zeros (prev / evict ids pad with
# the global drop sentinel instead)
_ROW_FIELDS = ("replicas", "unknown_request", "gvk", "strategy", "fresh", "tol_idx",
               "aff_idx", "weight_idx", "prev_rep", "seeds", "req_idx")


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """Split n devices into (bindings, clusters) axis sizes, as square as
    possible with bindings >= clusters (binding rows are the cheaper axis to
    widen: no copy crosses it)."""
    best = (n_devices, 1)
    f = 1
    while f * f <= n_devices:
        if n_devices % f == 0:
            best = (n_devices // f, f)
        f += 1
    return best


class Mesh:
    """A grid of torch devices with named axes: `devices` is a [b, c]
    object array, `shape` maps each axis name to its size (as
    `jax.sharding.Mesh.shape` does)."""

    def __init__(self, devices, axis_names: Sequence[str] = (AXIS_BINDINGS, AXIS_CLUSTERS)):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"mesh: a {grid.ndim}-d device grid for axes {tuple(axis_names)}")
        self.devices = np.empty(grid.shape, dtype=object)
        for pos, d in np.ndenumerate(grid):
            self.devices[pos] = _mesh_device(d)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))


def _mesh_device(d) -> torch.device:
    """A device of a mesh: a CUDA device carries its index (the mesh places
    tensors on it by index), and must exist."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A (bindings, clusters) mesh over `devices`, factored by factor_mesh.
    None means every visible CUDA card (RuntimeError when there is none);
    an explicit list may name `cpu` or repeat one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass the devices explicitly "
                "(testing.cpumesh.virtual_mesh builds a mesh of CPU devices)"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    b, c = factor_mesh(len(devices))
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(b, c))


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join a multi-host cluster. It no-ops when no coordinator is given,
    as the reference does on a single host; a coordinator needs the
    multi-host slice (`torch.distributed`), which is not ported yet."""
    if coordinator is None:
        return
    raise NotImplementedError(
        "initialize_multihost: the multi-host mesh over torch.distributed comes with the "
        "multi-GPU slice's remaining part (ROADMAP queue A item 11); in one process, "
        "build the mesh with make_mesh"
    )


def make_hierarchical_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with the bindings axis across hosts and the clusters axis within
    a host's devices (the clusters axis carries the gather, the bindings
    axis nothing). Devices are grouped by their `process_index` (0 for a
    `torch.device`: in one process every device is on host 0), so on one
    host this degenerates to make_mesh's factorization."""
    if devices is None:
        devices = list(make_mesh().devices.flat)
    by_process: dict[int, list] = {}
    for d in devices:
        by_process.setdefault(getattr(d, "process_index", 0), []).append(d)
    n_hosts = len(by_process)
    per_host = min(len(v) for v in by_process.values())
    dropped = sum(len(v) - per_host for v in by_process.values())
    if dropped:
        import warnings

        warnings.warn(
            f"make_hierarchical_mesh: hosts have unequal device counts; "
            f"dropping {dropped} device(s) to keep the mesh rectangular",
            stacklevel=2,
        )
    grid = np.empty((n_hosts, per_host), dtype=object)
    for h, (_, v) in enumerate(sorted(by_process.items())):
        grid[h, :] = v[:per_host]
    lb, lc = factor_mesh(per_host)
    return Mesh(grid.reshape(n_hosts * lb, lc))


def _pad_axis(a: np.ndarray, axis: int, to: int, fill=0) -> np.ndarray:
    cur = a.shape[axis]
    if cur >= to:
        return a
    width = [(0, 0)] * a.ndim
    width[axis] = (0, to - cur)
    return np.pad(a, width, constant_values=fill)


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` (uint64 tie seeds as their int64 bits)."""
    a = np.ascontiguousarray(a)
    return to_device(a.view(np.int64) if a.dtype == np.uint64 else a, device)


def _on_device(device):
    """Make `device` the current CUDA device (kernels launch on the current
    device's stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class MeshScheduleKernel:
    """The monolithic mesh round's solve over a `Mesh`.

    Holds the fleet column-sharded and device-resident across rounds; each
    call ships the factored batch (rows to their row group's devices, the
    affinity table's column shards to their column's devices, the dense
    terms as row-group blocks) and returns the reference's ten outputs:
    (feasible, score, result, unschedulable, avail_sum, avail, feas_count,
    nnz, top_idx, top_val) over [Bp, Cp], rows and clusters padded to the
    mesh. Padded clusters are dead (never feasible); padded rows are
    NON_WORKLOAD rows with replicas 0 that the decode never reads."""

    def __init__(self, mesh: Mesh, fleet: Optional[FleetArrays] = None):
        self.mesh = mesh
        self.mesh_b = mesh.shape[AXIS_BINDINGS]
        self.mesh_c = mesh.shape[AXIS_CLUSTERS]
        self._topk = TOPK_TARGETS
        self._fleet_dev: Optional[dict] = None
        self.n_clusters = 0
        if fleet is not None:
            self.set_fleet(fleet)

    def set_fleet(self, fleet: FleetArrays) -> None:
        """Pad the cluster axis to a multiple of the clusters axis with dead
        clusters and place column shard j of the fleet tensors on every
        device of mesh column j (a device listed twice holds one copy)."""
        C = fleet.alive.shape[0]
        self.n_clusters = C
        self.padded_clusters = _round_up(max(C, self.mesh_c), self.mesh_c)
        Cl = self.padded_clusters // self.mesh_c
        padded = {n: _pad_axis(getattr(fleet, n), 0, self.padded_clusters)
                  for n in _FLEET_FIELDS}
        placed: dict = {}
        self._fleet_dev = {}
        for (r, j), dev in np.ndenumerate(self.mesh.devices):
            key = (dev, j)
            if key not in placed:
                placed[key] = {n: _upload(a[j * Cl:(j + 1) * Cl], dev)
                               for n, a in padded.items()}
            self._fleet_dev[r, j] = placed[key]

    def __call__(self, batch: BindingBatch, extra_avail=None, extra_mask=None,
                 extra_score=None, plugin_bits: Optional[int] = None):
        return self.run(batch, extra_avail, extra_mask, extra_score, plugin_bits)[0]

    def run(self, batch: BindingBatch, extra_avail=None, extra_mask=None, extra_score=None,
            plugin_bits: Optional[int] = None):
        """The ten outputs, then the gathered previous replicas and ties
        ([Bp, Cp] on `mesh.devices[0, 0]`, which the spread overlay reads).
        `extra_avail` (i32, -1 = no answer), `extra_mask` (bool) and
        `extra_score` (i32) are None or [rows, c] over the first c
        columns, padded here with -1 / True / 0."""
        from .. import kernels
        from ..sched import plugins as plugin_mod

        if plugin_bits is None:
            plugin_bits = plugin_mod.ALL_PLUGIN_BITS
        if self._fleet_dev is None:
            raise RuntimeError("set_fleet() before scheduling")
        if batch.req_unique is None or batch.req_idx is None:
            raise ValueError(
                "BindingBatch lacks req_unique/req_idx — encode batches via "
                "BatchEncoder.encode()"
            )
        B = len(batch.replicas)
        Bp = _round_up(max(B, self.mesh_b), self.mesh_b)
        Cp = self.padded_clusters
        Bl, Cl = Bp // self.mesh_b, Cp // self.mesh_c
        rows = {n: _pad_axis(getattr(batch, n), 0, Bp) for n in _ROW_FIELDS}
        # padded rows carry the global drop sentinel, not column 0
        rows["prev_idx"] = _pad_axis(batch.prev_idx, 0, Bp, fill=Cp)
        rows["evict_idx"] = _pad_axis(batch.evict_idx, 0, Bp, fill=Cp)
        aff = _pad_axis(batch.aff_masks, 1, Cp)
        weights = _pad_axis(batch.weight_tables, 1, Cp)
        terms = {}
        for name, t, fill, dtype in (("extra_avail", extra_avail, -1, np.int32),
                                     ("extra_mask", extra_mask, True, bool),
                                     ("extra_score", extra_score, 0, np.int32)):
            if t is not None:
                t = np.asarray(t, dtype)
                terms[name] = _pad_axis(_pad_axis(t, 0, Bp, fill=fill), 1, Cp, fill=fill)

        uploads: dict = {}

        def put(key, dev, make):
            k = (dev,) + key
            if k not in uploads:
                uploads[k] = make()
            return uploads[k]

        def row_block(r, dev):
            return put(("rows", r), dev, lambda: {
                n: _upload(a[r * Bl:(r + 1) * Bl], dev) for n, a in rows.items()})

        # ---- every tile: the filter on its own device ----
        tiles = {}
        for (r, j), dev in np.ndenumerate(self.mesh.devices):
            f = self._fleet_dev[r, j]
            t = row_block(r, dev)
            tables = put(("tables",), dev, lambda: {
                "tol_tables": _upload(batch.tol_tables, dev),
                "req_unique": _upload(batch.req_unique, dev)})
            aff_j = put(("aff", j), dev, lambda: _upload(aff[:, j * Cl:(j + 1) * Cl], dev))
            term_r = put(("terms", r), dev, lambda: {
                n: _upload(a[r * Bl:(r + 1) * Bl], dev) for n, a in terms.items()})
            views = {n: a[:, j * Cl:(j + 1) * Cl] for n, a in term_r.items()}
            with _on_device(dev):
                tiles[r, j] = kernels.mesh_tile_filter(
                    *(f[n] for n in _FLEET_FIELDS),
                    t["replicas"], t["unknown_request"], t["gvk"],
                    tables["tol_tables"], t["tol_idx"], aff_j, t["aff_idx"],
                    t["prev_idx"], t["prev_rep"], t["evict_idx"], t["seeds"],
                    tables["req_unique"], t["req_idx"],
                    views.get("extra_avail"), views.get("extra_mask"), views.get("extra_score"),
                    col0=j * Cl, plugin_bits=plugin_bits,
                )

        # ---- per row group: gather along the cluster axis, then the tail ----
        has_agg = bool((rows["strategy"] == AGGREGATED).any())
        window = min(Cp, self._topk)
        groups = []
        for r in range(self.mesh_b):
            home = self.mesh.devices[r, 0]
            t = row_block(r, home)
            w_dev = put(("weights",), home, lambda: _upload(weights, home))
            with _on_device(home):
                parts = [tiles[r, j] for j in range(self.mesh_c)]
                feasible, score, avail, prev, tie = (
                    torch.cat([p[k].to(home) for p in parts], dim=1) for k in range(5))
                feas_count = parts[0][5].to(home)
                for p in parts[1:]:
                    feas_count = feas_count + p[5].to(home)
                result, unsched, avail_sum, nnz, top_idx, top_val = kernels.dense_tail(
                    feasible, avail, prev, tie,
                    torch.arange(Bl, dtype=torch.int32, device=home),
                    w_dev, t["weight_idx"], t["strategy"], t["replicas"], t["fresh"],
                    topk=window, has_agg=has_agg,
                )
            groups.append((feasible, score, result, unsched, avail_sum, avail, feas_count,
                           nnz, top_idx, top_val, prev, tie))

        # ---- the row groups on the first device ----
        first = self.mesh.devices[0, 0]
        if len(groups) == 1:
            out = groups[0]
        else:
            with _on_device(first):
                out = tuple(torch.cat([g[k].to(first) for g in groups])
                            for k in range(len(groups[0])))
        return out[:10], out[10], out[11]
