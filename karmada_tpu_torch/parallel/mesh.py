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

The partitioned mesh rounds (the reference's default mode, where GSPMD
partitions the single-device programs over a column-sharded fleet) run the
single-device rounds with their one [B, C] kernel cut into tiles:

- `ShardedFleet` holds the seven fleet tensors cut by column shard, shard
  j's slice on every device of mesh column j, and each shard's first
  global column `col0` (the fleet is padded to a multiple of the clusters
  axis: `ArrayScheduler._fleet_width`);
- `partitioned_select` (the compact round): candidate_select in its col0
  mode on every tile, then per row group one `candidate_merge` of the c
  shard windows into the row's top K, in column order, the feasible
  counts summed and the packed feasible masks stitched; the row groups
  concatenated on `mesh.devices[0, 0]` give candidate_select's eight
  outputs, bit for bit;
- `partitioned_filter` (the dense round, the dense tiered round and
  `run_kernel`): `mesh_tile_filter` on every tile, the tiles of a row
  group gathered along the clusters axis, the row groups concatenated on
  `mesh.devices[0, 0]`: dense_filter's six outputs, bit for bit.

The rest of each round (the division tails, the masks, the spread kernels,
the tier kernels, the decode) runs as on one device over these outputs, on
`mesh.devices[0, 0]`: the tier kernels' inputs are the merged [B, K]
windows or the gathered rows, which sit there.

`MeshScheduleKernel` is the monolithic mesh round's solve (the reference's
explicit shard_map mode, `mesh_partitioned = False`): the tile filter, the
gather, then the `dense_tail` kernel over each row group's full rows. It
returns the reference's ten outputs, in its order, rows and clusters
padded to the mesh, with the row groups concatenated on
`mesh.devices[0, 0]`.

`visible_devices` is what an oversized round spreads over (autoshard, the
scenario-sharded simulation): every CUDA card, or one CPU device; the
`virtual_devices` context shows its thread n copies of one device
instead. The multi-host half (`initialize_multihost` over
`torch.distributed`) is a later slice.
"""
from __future__ import annotations

import contextlib
import threading
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


# n copies of one device that `visible_devices` shows to the current
# thread instead of the real ones (`virtual_devices` sets it)
_view = threading.local()


@contextlib.contextmanager
def virtual_devices(n_devices: int, device="cpu"):
    """Show `n_devices` copies of `device` (None: the CUDA card) as the
    visible devices to this thread while the block runs, the previous view
    coming back after it: the counterpart of the reference's
    `force_cpu_mesh`, so that autoshard and the scenario-sharded
    simulation engage on one device. Other threads keep their own view."""
    if n_devices < 1:
        raise ValueError(f"virtual_devices: {n_devices} devices")
    dev = _mesh_device(device)
    prev = getattr(_view, "devices", None)
    _view.devices = (n_devices, dev)
    try:
        yield
    finally:
        _view.devices = prev


def visible_devices(device) -> list[torch.device]:
    """The devices an oversized round on `device` may spread over (the
    reference's `jax.devices()`): every CUDA card for a card, the one CPU
    device for the CPU; inside this thread's `virtual_devices(n, d)`, n
    copies of d."""
    view = getattr(_view, "devices", None)
    if view is not None:
        n, d = view
        return [d] * n
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def row_bounds(n_rows: int, n_groups: int) -> list[tuple[int, int]]:
    """The bindings axis's row groups over n_rows rows: equal blocks of
    ceil(n_rows / n_groups) rows, the last ones shorter or empty (GSPMD's
    uneven split)."""
    per = -(-n_rows // n_groups) if n_rows else 0
    return [(min(r * per, n_rows), min((r + 1) * per, n_rows)) for r in range(n_groups)]


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


def on_device(device):
    """Make `device` the current CUDA device (kernels launch on the current
    device's stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class ShardedFleet:
    """The fleet placed column-sharded over a mesh (the reference's
    `_place_fleet_sharded`): C, already a multiple of the clusters axis,
    cut into c shards of `width` columns, shard j (first global column
    `col0[j]`) on every device of mesh column j, one copy a device. The
    batch is not placed here: the rounds cut the uploaded batch per tile
    (`_TileInputs`)."""

    def __init__(self, mesh: Mesh, fleet: FleetArrays):
        c = mesh.shape[AXIS_CLUSTERS]
        C = fleet.alive.shape[0]
        if C % c:
            raise ValueError(f"ShardedFleet: {C} clusters over {c} column shards")
        self.mesh = mesh
        self.width = C // c
        self.col0 = [j * self.width for j in range(c)]
        arrays = {n: getattr(fleet, n) for n in _FLEET_FIELDS}
        placed: dict = {}
        self._tiles: dict = {}
        for (r, j), dev in np.ndenumerate(mesh.devices):
            key = (dev, j)
            if key not in placed:
                lo, hi = self.col0[j], self.col0[j] + self.width
                placed[key] = {n: _upload(a[lo:hi], dev) for n, a in arrays.items()}
            self._tiles[r, j] = placed[key]

    def tile(self, r: int, j: int, capacity=None) -> list:
        """The seven fleet tensors of tile (r, j), in the reference's order;
        `capacity` (i64 [C, R] on any device, or None) replaces the
        fleet's (a tiered round's capacity override), cut to the shard."""
        f = self._tiles[r, j]
        out = [f[n] for n in _FLEET_FIELDS]
        if capacity is not None:
            lo = self.col0[j]
            dev = self.mesh.devices[r, j]
            out[1] = capacity[lo:lo + self.width].to(dev)
        return out


class _TileInputs:
    """A round's uploaded batch tensors (the dict `t` of ArrayScheduler.
    _encode_round, on the round's device) cut for the tiles of a mesh: a
    row group's rows of every per-row field and the shared tables on the
    tile's device (views on the round's device, one copy a device
    elsewhere), and the [P, C] / [B, C] inputs as column views of them."""

    def __init__(self, mesh: Mesh, t: dict, bounds):
        self.mesh, self.t, self.bounds = mesh, t, bounds
        self.home = t["replicas"].device
        self._moved: dict = {}

    def _on(self, key, dev, x):
        """`x` (a view on the round's device) on `dev`, copied once."""
        if _same(dev, self.home):
            return x
        k = (str(dev),) + key
        if k not in self._moved:
            self._moved[k] = x.to(dev)
        return self._moved[k]

    def table(self, name: str, dev) -> torch.Tensor:
        return self._on((name,), dev, self.t[name])

    def rows(self, name: str, r: int, dev) -> Optional[torch.Tensor]:
        """Row group r of field `name` (None stays None) on `dev`."""
        if self.t.get(name) is None:
            return None
        lo, hi = self.bounds[r]
        return self._on((name, r), dev, self.t[name][lo:hi])

    def term(self, name: str, r: int, j: int, col0: int, width: int, dev):
        """Tile (r, j)'s column view of a [B, C] term, or None."""
        x = self.rows(name, r, dev)
        return None if x is None else x[:, col0:col0 + width]


def _same(a: torch.device, b: torch.device) -> bool:
    return a == b or (a.type == b.type == "cuda" and (a.index or 0) == (b.index or 0))


def _tile_batch(inp: _TileInputs, r: int, dev) -> list:
    """The batch arguments of a tile's filter or select, in the kernels'
    order, from `replicas` to `req_idx`, the affinity table excepted (it
    is cut per column shard)."""
    rows = {n: inp.rows(n, r, dev) for n in ("replicas", "unknown_request", "gvk", "tol_idx",
                                                "aff_idx", "prev_idx", "prev_rep", "evict_idx",
                                                "seeds", "req_idx")}
    return [rows["replicas"], rows["unknown_request"], rows["gvk"],
            inp.table("tol_tables", dev), rows["tol_idx"], None, rows["aff_idx"],
            rows["prev_idx"], rows["prev_rep"], rows["evict_idx"], rows["seeds"],
            inp.table("req_unique", dev), rows["req_idx"]]


def stitch_packed(parts: Sequence[torch.Tensor], widths: Sequence[int], device) -> torch.Tensor:
    """Row-wise bit-packed masks of consecutive column ranges (u8 [B,
    ceil(w/8)] each, bit j of byte i = column 8i + j, padding bits zero)
    as one packed mask over all of them, on `device`. A range that starts
    on a byte boundary lands as its bytes; otherwise its bytes are shifted
    by the start's bit offset and ORed into the two bytes each one
    straddles (no unpacked [B, C] mask is made)."""
    B = parts[0].shape[0]
    C = sum(widths)
    out = torch.zeros((B, (C + 7) // 8), dtype=torch.uint8, device=device)
    c0 = 0
    for p, w in zip(parts, widths):
        p = p.to(device)
        q, o = divmod(c0, 8)
        n = p.shape[1]
        if o == 0:
            out[:, q:q + n] |= p
        else:
            wide = p.to(torch.int16) << o
            out[:, q:q + n] |= (wide & 0xFF).to(torch.uint8)
            m = min(n, out.shape[1] - q - 1)
            out[:, q + 1:q + 1 + m] |= (wide[:, :m] >> 8).to(torch.uint8)
        c0 += w
    return out


def _gather_row_group(tiles: list, home) -> tuple:
    """One row group's tile-filter outputs (in column order) gathered along
    the clusters axis on `home`: feasible, score, avail, prev and tie as
    [B_l, C], the feasible counts summed."""
    cat = tuple(torch.cat([p[k].to(home) for p in tiles], dim=1) for k in range(5))
    feas_count = tiles[0][5].to(home)
    for p in tiles[1:]:
        feas_count = feas_count + p[5].to(home)
    return cat + (feas_count,)


def _concat_rows(groups: list, first) -> tuple:
    """Row groups' outputs concatenated on the mesh's first device."""
    if len(groups) == 1:
        return tuple(x.to(first) for x in groups[0])
    with on_device(first):
        return tuple(torch.cat([g[k].to(first) for g in groups]) for k in range(len(groups[0])))


def partitioned_filter(mesh: Mesh, shards: ShardedFleet, t: dict, *, plugin_bits: int,
                       capacity=None):
    """dense_filter's six outputs over the round's padded batch `t` (see
    `_TileInputs`), computed by `mesh_tile_filter` on every (row group,
    column shard) tile and gathered: each tile's affinity table is its
    column shard (one copy a shard and device: the kernel reads a
    contiguous table), the answers, mask and score column views; the
    tiles of a row group are concatenated along the clusters axis on the
    row group's first device, the row groups on `mesh.devices[0, 0]`.
    `capacity` (i64 [C, R], or None) replaces the fleet's."""
    from .. import kernels

    B = t["replicas"].shape[0]
    bounds = row_bounds(B, mesh.shape[AXIS_BINDINGS])
    inp = _TileInputs(mesh, t, bounds)
    W = shards.width
    aff: dict = {}
    tiles: dict = {}
    for (r, j), dev in np.ndenumerate(mesh.devices):
        c0 = shards.col0[j]
        key = (str(dev), j)
        if key not in aff:
            aff[key] = inp.table("aff_masks", dev)[:, c0:c0 + W].contiguous()
        args = _tile_batch(inp, r, dev)
        args[5] = aff[key]
        terms = [inp.term(n, r, j, c0, W, dev) for n in ("extra_avail", "extra_mask",
                                                          "extra_score")]
        with on_device(dev):
            tiles[r, j] = kernels.mesh_tile_filter(
                *shards.tile(r, j, capacity), *args, *terms, col0=c0, plugin_bits=plugin_bits)
    groups = []
    for r in range(mesh.shape[AXIS_BINDINGS]):
        home = mesh.devices[r, 0]
        with on_device(home):
            groups.append(_gather_row_group(
                [tiles[r, j] for j in range(mesh.shape[AXIS_CLUSTERS])], home))
    return _concat_rows(groups, mesh.devices[0, 0])


def partitioned_select(mesh: Mesh, shards: ShardedFleet, t: dict, *, k: int, plugin_bits: int,
                       capacity=None, packed: bool = True):
    """candidate_select's eight outputs over the round's padded batch `t`
    (see `_TileInputs`): candidate_select in its col0 mode on every
    (row group, column shard) tile, over the tile's columns, each window
    min(k, width) wide, the affinity table, answers, mask and score read
    as column views; then per row group one `candidate_merge` of its c
    windows on the row group's first device (with one column shard the
    tile's window is the row group's), the packed feasible masks stitched
    (`stitch_packed`; with `packed` False they are not, and the eighth
    output is None); the row groups concatenated on `mesh.devices[0, 0]`.
    No [B, C] buffer is made. `capacity` (i64 [C, R], or None) replaces
    the fleet's."""
    from .. import kernels

    B = t["replicas"].shape[0]
    bounds = row_bounds(B, mesh.shape[AXIS_BINDINGS])
    inp = _TileInputs(mesh, t, bounds)
    W = shards.width
    n_c = mesh.shape[AXIS_CLUSTERS]
    tiles: dict = {}
    for (r, j), dev in np.ndenumerate(mesh.devices):
        c0 = shards.col0[j]
        args = _tile_batch(inp, r, dev)
        args[5] = inp.table("aff_masks", dev)[:, c0:c0 + W]
        extra, mask, score = (inp.term(n, r, j, c0, W, dev)
                              for n in ("extra_avail", "extra_mask", "extra_score"))
        with on_device(dev):
            tiles[r, j] = kernels.candidate_select(
                *shards.tile(r, j, capacity), *args, extra, k=min(k, W),
                plugin_bits=plugin_bits, extra_mask=mask, extra_score=score, col0=c0)
    groups = []
    for r in range(mesh.shape[AXIS_BINDINGS]):
        home = mesh.devices[r, 0]
        parts = [tiles[r, j] for j in range(n_c)]
        with on_device(home):
            if n_c == 1:
                merged = parts[0][:7]
            else:
                merged = kernels.candidate_merge([tuple(x.to(home) for x in p[:7])
                                                  for p in parts], k)
            pk = (stitch_packed([p[7] for p in parts], [W] * n_c, home) if packed
                  else None)
        groups.append(tuple(merged) + (pk,))
    first = mesh.devices[0, 0]
    out = _concat_rows([g[:7] for g in groups], first)
    pk = None
    if packed:
        pk = _concat_rows([g[7:] for g in groups], first)[0]
    return out + (pk,)


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
            with on_device(dev):
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
            with on_device(home):
                feasible, score, avail, prev, tie, feas_count = _gather_row_group(
                    [tiles[r, j] for j in range(self.mesh_c)], home)
                result, unsched, avail_sum, nnz, top_idx, top_val = kernels.dense_tail(
                    feasible, avail, prev, tie,
                    torch.arange(Bl, dtype=torch.int32, device=home),
                    w_dev, t["weight_idx"], t["strategy"], t["replicas"], t["fresh"],
                    topk=window, has_agg=has_agg,
                )
            groups.append((feasible, score, result, unsched, avail_sum, avail, feas_count,
                           nnz, top_idx, top_val, prev, tie))

        # ---- the row groups on the first device ----
        out = _concat_rows(groups, self.mesh.devices[0, 0])
        return out[:10], out[10], out[11]
