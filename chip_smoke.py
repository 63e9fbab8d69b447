"""On-card smoke test of the PyTorch/CUDA port (karmada_tpu_torch).

    python3 chip_smoke.py [--only kernels|sim|graft|mesh|tiers|refresh]

Needs one CUDA card (an H100 is the target) and nvcc; exits non-zero with no
result line otherwise. Phases, each of which raises on failure:

1. the device line: torch's device name, and nvidia-smi's name and power
   limit;
2. the build of every kernel from the sources in
   karmada_tpu_torch/kernels/csrc, with its seconds;
3. each kernel against its plain PyTorch version on the card, exactly
   (integer outputs): on seeded tie-heavy random inputs at the flagship
   shapes (the dense tail also at 16 384 columns) and on the flagship's own
   encoded batches, compact and dense; the spread kernels on the
   arguments the main path itself passes them in one round each of
   config 4, config 4b and the drain cell (captured at launch), then on
   seeded tie-heavy inputs over the config-4 and config-4b region layouts
   (group_score also with negative availability and on a single-region
   fleet of 16 384 columns; packed_selection also at widths that are no
   multiple of 32 or 16, off a 16-byte boundary, with nothing chosen and
   over 60 000 regions; combo_select at 4 096 rows over a config-4
   combination table, on groups of equal weight and value there and at
   L = 10, then select_regions_batch through it against its host path);
   pack_rows and feas_idx on seeded filter rows read through row ids
   out of order and repeated (at 5 120, 5 000 and 77 columns, and off a
   16-byte boundary; k = the flagship's and 128) and on the dense
   flagship's own mask rows; pack_rows also on the call one whole-fleet
   Duplicated round makes (its timing);
   dense_filter also with a random extra_mask, on config 1's
   and config 2's batches (alone, with a mask, with answers), at 4 999
   and 13 columns, with answers and mask off alignment, at a tightened
   capacity and on the call one tiers_dense round makes; candidate_tail
   also on seeded windows with one edge of the division in every row
   (zero static weights, rem = 0, Steady eq, unschedulable rows, ties on
   the window, topk = K; K = 8, 100 and 128) and on the calls one
   tiers_compact round makes, both with their device time under
   torch.profiler; the tier
   kernels (tier_estimate, tier_consume) on seeded inputs at the flagship
   shapes in both modes, tier_consume also at its edge shapes (5 121
   columns, one and sixteen resources, one row, every row unschedulable,
   a hot column, K = 256, a placed matrix off a 16-byte boundary), and on
   the arguments one round of each tier cell passes them; with each
   kernel's time, its plain version's time, its bound and, for feas_idx
   and tier_consume, the time of the one torch call that computes the
   same function — the spread kernels' per round of config 4 (of the
   drain cell for combo_select; packed_selection also per drain round,
   as its `drain_*` keys; both with device time under torch.profiler and
   the host's enqueue), the tier kernels' per round of
   tiers_dense, tier_consume's window mode (a kernel of its own in the
   result line) per round of tiers_compact, each tier_consume mode also
   with its device time under torch.profiler; candidate_select, dense_filter and
   tier_estimate also with a random registered-estimator answer matrix
   (extra_avail) on the flagship batches; fleet_estimate on seeded node
   fleets (overcommitted nodes, zero requests, exhausted pod slots,
   tainted nodes, node-less clusters; in cluster order and shuffled; rows
   as a [B, R] request and as a table of distinct requests, one or many,
   with and without the caller's node ranges; 4 999 and 13 clusters;
   R = 17; int64 edge values), on config 3's and the flagship's
   node fleets (shard_nodes pools) with their rows, also in the form the
   estimator's sweep passes them (distinct requests, node ranges), and on
   the reference estimator fixture (5 000 nodes, 100 000 pods) as one
   cluster, timed at the flagship sweep (with the node ranges, with the
   sort, every row distinct) and at config 3's; staleness_penalty on a random i32 [10 000, 5 000]
   matrix at ages 0-10, with torch.where as its library call;
   scatter_rows (the dirty-column refresh) on seeded fleets at 5 120
   columns, every dtype, both routes (separate sources; a launcher's
   staged block: one pinned upload, one launch) on repeated ids, one row,
   the last row, every row, T = 0 and odd G, with index_copy_ as its
   library call; candidate_tail's K > 128 route on seeded tie-heavy
   windows at K = 192, 256 and 512 and on the flagship's K = 256 windows;
   candidate_select's wide route on seeded rows at C = 20 480 and 32 768
   (with and without answers; on one chunk of the wide_40k round in phase
   4, where that fixture is built); sim_filter (the simulation plane's
   scenario-stacked filter, csrc/dense_filter.cu) and sim_load (its
   per-scenario load, csrc/sim_load.cu) on seeded inputs at the whatif
   solve's shape (with and without answers) and at one whatif_churn5k
   chunk, drained columns and padded taint slots in each, sim_filter also
   on its edge cases (one distinct request and every row its own, 4 999
   and 13 columns, one scenario, a scenario drained whole, R = 17, the
   estimate's int64 edges), and on the
   arguments one round each of whatif and whatif_churn5k passes them,
   with torch.bmm in float64 as sim_load's library call; dense_input_filter
   (the dense-input program's filter, csrc/dense_filter.cu) on seeded
   inputs at the dense flagship's 10 240 x 5 120 (every row distinct, and
   rows drawn from four requests and toleration rows, not adjacent), at
   300 x 100 and at 333 x 257 (no multiple of the 32-row group, an odd
   width), and with its answers and affinity mask off alignment, with
   prev_member drawn apart from any prev count, random evictions,
   tolerations against tainted columns, unknown-request rows and answers
   with -1s, and on the same inputs with the tail's drawn beside them
   (every strategy code, all-zero static weight rows, prev_replicas apart
   from prev_member, tie-heavy ties) the whole program, _schedule_kernel,
   against _schedule_body on the card; mesh_tile_filter (the mesh
   solve's tile filter, csrc/dense_filter.cu) on seeded inputs at the
   dense flagship's 10 240 x 5 120 cut into 2 x 2 and 2 x 3 tiles (the
   latter padded with a dead column to 5 121, tiles 1 707 wide) and into
   2 x 2 tiles shifted by two columns (first columns and term views off
   a multiple of 4), prev and evict ids in other tiles and at the
   sentinel, answers with -1s, a random mask and score, with the terms
   and without; dense_tail on
   both of its routes (the shared-memory one up to 12 288 columns, the
   re-reading one at any width) and without its output window, sim_load
   at R = 4, 9 and 17, and tier_consume and fleet_estimate at R = 17;
   and the A/B timings: the redesigned dense_tail (every mode) and
   sim_load in turns with the re-reading route and torch.bmm, printed as
   `A/B ...` lines and one {"ab": ...} line (`--only kernels` stops here);
4. the main paths through ArrayScheduler.schedule() on the card, each with
   every launch count set to 0 just before it and read just after, timed
   rounds with p50/p90/p99, and decisions held against the port's CPU
   round: the compact flagship round (bench.py build_flagship's mix: 5 000
   clusters x 10 000 bindings, seed 0); the same flagship as a dense round
   (every binding annotated dense-solve), and right after it the graft
   and shim cells: graft_example (graft_entry.entry() at 16 x 12, the six
   outputs against _schedule_body on the card and the cpu run),
   graft_flagship (the dense flagship's batch as the program's 24 dense
   arguments: 20 timed calls split filter / tail, against _schedule_body
   on the card, B3's filter outputs and B4's tail rows, and the kernel on
   the arguments the program passed it), shim_flagship (the compact
   flagship's 5 000 clusters and 10 000 specs over HTTP to
   SchedulerShimServer, 5 timed rounds split wire + parse / round /
   encode + send, every result against the in-process card round and a
   2 048-row sample against the cpu round; any non-200 fails) and
   shim_contract (the shim contract's cases on the card); then the mesh
   cells: mesh_flagship (the dense flagship's bindings through
   ArrayScheduler(mesh=virtual_mesh(4, card), candidate_k=0) in the
   monolithic mode, a 2 x 2 virtual mesh: 10 timed rounds with four tile
   filters and two tails each, split by CUDA events into tile filters /
   gathers / tails and by a stage timer into the host's encode /
   dispatch / materialize; targets and errors against the single-device
   card round on every row, everything against the cpu mesh round on a
   2 000-row sample, the mesh kernel's ten outputs against the
   single-device B3 + B4 on the whole batch, and the tile filter on the
   arguments one round passed it, with its time and bound), one 2 x 3
   round at the same width (C padded to 5 121) held the same way, and the
   cell over every card when there are several; that dense
   flagship with the
   Duplicated quarter placed over the whole fleet (packed mask rows); the
   compact flagship, the dense flagship and that variant each run one
   more round with their solve stages under
   torch.cuda.set_sync_debug_mode("error") (no stream sync there), its
   decisions the cell's (one row in 64 compared whole); the
   static-weight split of bench.py build_static (100 x 1 000, reason
   small_fleet); the 3-cluster Duplicated slice of bench.py build_dup3;
   BASELINE config 4 (bench.py build_spread: region spread over 5 000
   clusters x 5 000 bindings) and config 4b (build_spread_skewed); config
   4's mix with affinities of 64 clusters (the window cell: solved in the
   candidate window; 8 timed rounds, the others 20); and the drain cell (a synthetic cell built to cross
   combo_select's 4 096-distinct-row gate: config 4's fleet, 5 000
   bindings under one region-spread policy, each evicting a cluster in
   each of its own random half of the regions); every spread cell with
   its exact launches per round; then the tier cells, 20 rounds each:
   tiers_dense (the flagship batch at four priorities, one row in 16
   PreemptLowerPriority, over the flagship fleet tightened so the divided
   rows ask 1.5x its free cpu: preemption.launch_tiered +
   materialize_chunk, the dense tiered launch with its speculative pass),
   tiers_compact (the same without the Duplicated quarter: the compact
   tiered launch), each with its exact launches, decisions and
   speculative decisions held against the CPU round and shown to differ
   from a tier-blind schedule(); and preempt_plan (256 preemptors at two
   priorities over that fleet tightened to 0.25 cpu free per cluster:
   plan_preemption, two launches a round, plans and one
   preview_preemption held against the CPU); then the estimator cells,
   the timed round being the registry's sweep plus the round given its
   answers: config3 (BASELINE config 3, bench.py build_dynamic: 1 000
   clusters x 1 000 dynamic bindings, in-process member estimators over
   shard_nodes pools, 60 rounds), estimator_flagship (the compact
   flagship with member estimators on all 5 000 clusters), degraded
   (bench.py build_degraded: a breaker open every other round, the
   staleness overlay feeding the round, launch parity between the legs)
   and tiers_estimator (the tiers_compact batch with answers through
   launch_tiered, a speculative pass in every tier; one round's
   tier_estimate and tier_consume launches held against their plain
   versions, tier_consume's timed as in phase 3), 20 rounds each, the
   profiled round's device time also by event; answer matrices held
   against the per-cluster host path, decisions against the CPU round
   given the same answers; then the chunk surface:
   churn (BASELINE config 5, bench.py build_churn: 5 000 x 10 000, every
   binding with previous placements, schedule()), churn_incremental
   (config 5b: 5 % of the bindings dirtied per round,
   schedule_incremental replaying the rest), churn_dirty (50 clusters
   change status per round: set_clusters with dirty_names through the
   placement's scatter_rows launcher, then every row re-solved; the
   refresh split dirty scan / encode_cols / pack + upload + launch, one
   refresh under set_sync_debug_mode("error"), and its host time with
   20 ms of device work queued ahead beside an idle stream's), pipeline (the churn round at
   a B*C/8 budget: the serial leg, the scheduler's default, and the
   pipelined leg, 3 interleaved runs each, stage seconds and overlap
   ratio; then one pipelined round under a side stream with estimator
   answers and ordered affinity terms, whose retries upload on the writer
   thread), wide_40k (the
   flagship mix at 20 000 clusters x 40 000 bindings: pipelined chunks
   through the wide select route, the serial leg, a 2 048-row sample
   over every chunk and row class held against the CPU round) and
   flagship_k256 (the compact flagship at candidate_k=256 through the
   K > 128 tail, and one tiered compact round at K = 256); then the
   simulation plane through Simulator.simulate(): whatif (bench.py:521
   build_whatif: 500 clusters x 1 000 churn bindings, 16 drain, loss and
   capacity scenarios, one solve a round, every outcome held against the
   CPU Simulator, and bench.py's 16 sequential cold rounds for the
   amortization), whatif_mixed (its fleet with a taint, a surge and a
   composite scenario added and 32 region-spread rows on the
   per-scenario ArrayScheduler fallback), whatif_churn5k (the same recipe
   at 5 000 x 10 000: four scenario chunks a round, the baseline and the
   first drain, loss and capacity scenario held against a cold dense
   ArrayScheduler round on the card, a 256-row sample of every outcome
   against the CPU Simulator, the round's breakdown) and preflight
   (QuotaPreflight's deny and allow on the card, as on the CPU);
5. every kernel's launches over every main path's rounds, the `kernels`
   JSON line, then the card's name and power limit, then the last line
   {"ok": true, "device": {...}}.

`--only GROUP` builds every kernel, runs one group of phases and prints no
result line: `kernels` phase 3, `sim` the simulation plane's checks of
phases 3 and 4, `graft` those of the dense-input program and the scheduler
shim, `mesh` those of the mesh solve (with the single-device dense
flagship round they are held against), `tiers` the tier kernels' checks of
phase 3, `refresh` scatter_rows' check of phase 3 and the churn_dirty cell
with the refresh's checks.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import json
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import torch

from karmada_tpu_torch import faults, graft_entry, kernels
from karmada_tpu_torch.api import k8sjson
from karmada_tpu_torch.api import policy as pol
from karmada_tpu_torch.api.cluster import (
    CLUSTER_CONDITION_READY,
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    Taint,
)
from karmada_tpu_torch.api.meta import CPU, MEMORY, ObjectMeta, new_uid
from karmada_tpu_torch.api.search import (
    FederatedResourceQuota,
    FederatedResourceQuotaSpec,
    StaticClusterAssignment,
)
from karmada_tpu_torch.api.simulation import (
    SCENARIO_BASELINE,
    SCENARIO_CAPACITY,
    SCENARIO_COMPOSITE,
    SCENARIO_DRAIN,
    SCENARIO_LOSS,
    SCENARIO_SURGE,
    SCENARIO_TAINT,
    Scenario,
)
from karmada_tpu_torch.api.work import (
    BindingSpec,
    GracefulEvictionTask,
    ObjectReference,
    ReplicaRequirements,
    ResourceBinding,
    TargetCluster,
)
from karmada_tpu_torch.convert import FILTER_ARGS, SCHEDULE_ARGS, batch_from_numpy
from karmada_tpu_torch.estimator.accurate import AccurateEstimator
from karmada_tpu_torch.estimator.client import (
    EstimatorRegistry,
    MemberEstimators,
    distinct_requests,
)
from karmada_tpu_torch.faults import BreakerRegistry
from karmada_tpu_torch.kernels import build
from karmada_tpu_torch.models.batch import (
    AGGREGATED,
    DUPLICATED,
    DYNAMIC_WEIGHT,
    STATIC_WEIGHT,
    pow2_bucket,
    shape_bucket,
    strategy_code,
)
from karmada_tpu_torch.models.nodes import NodeEncoder
from karmada_tpu_torch.sched.candidates import DENSE_SOLVE_ANNOTATION, effective_k
from karmada_tpu_torch.sched.plugins import ALL_PLUGIN_BITS
from karmada_tpu_torch.sched import candidates as cand_mod
from karmada_tpu_torch.sched import preemption, spread_batch
from karmada_tpu_torch.sched.pipeline import chunk_spans, plan_chunk_rows
from karmada_tpu_torch.sched.core import (
    TOPK_TARGETS,
    ArrayScheduler,
    _pad_rows_idx,
    _schedule_body,
    _schedule_kernel,
    _sorted_pairs,
)
from karmada_tpu_torch.server.scheduler_shim import SchedulerShimServer, decision_json
from karmada_tpu_torch.simulation import Simulator, apply_scenario_objects
from karmada_tpu_torch.simulation.preflight import QuotaPreflight
from karmada_tpu_torch.parallel.mesh import Mesh, MeshScheduleKernel, make_mesh
from karmada_tpu_torch.sched.pipeline import StageTimer
from karmada_tpu_torch.testing.cpumesh import virtual_mesh
from karmada_tpu_torch.testing.shim_contract import CONTRACT_CASES
from karmada_tpu_torch.testing.fixtures import (
    build_estimator,
    duplicated_placement,
    shard_nodes,
    static_weight_placement,
    synthetic_fleet,
)
from karmada_tpu_torch.webhook.admission import AdmissionDenied, AdmissionRequest

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# float32 rate outside the tensor cores, used here for the kernels' 32/64-bit
# integer ALU work
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

N_CLUSTERS = 5000
N_BINDINGS = 10000
TIMED_ROUNDS = 60  # p90 then has 6 samples beyond it (110 until the simulation cells)
VARIANT_ROUNDS = 20  # timed rounds of the whole-fleet Duplicated variant
SPREAD_ROUNDS = 20  # timed rounds of each spread cell but the window cell
WINDOW_ROUNDS = 8  # the window cell's (about 4.7 s a round, host-bound: the run's time limit)
SPREAD_BINDINGS = 5000  # BASELINE config 4: 5k clusters x 5k bindings
WINDOW_BINDINGS = 1000
WINDOW_NAMES = 64  # clusters named by each window-cell affinity
SPREAD_REPS = 512  # representative rows of the random group_score check
COMBO_ROWS = 4096  # rows of the combo_select check (its device gate)
COMBO_SCRATCH_ROWS = 512  # rows of the combo_select check past its shared-memory regions
SELECTION_EDGE_WIDTHS = (4999, 5008, 13, 1)  # packed_selection: no multiple of 32 (5 008 of 16)
SELECTION_WIDE_REGIONS = 60_000  # its choice read in place (past 48 KB a row)
WIDE_C = 16384  # the dense tail's and group_score's width check
TIER_ROUNDS = 20  # timed rounds of each tier cell
CONFIG3_CLUSTERS = 1000  # BASELINE config 3: 1k clusters x 1k bindings
CONFIG3_BINDINGS = 1000
CONFIG3_ROUNDS = 60
ESTIMATOR_ROUNDS = 20  # timed rounds of estimator_flagship, degraded and tiers_estimator
DEGRADED_CLUSTERS = 500
DEGRADED_BINDINGS = 1000
ESTIMATOR_FIXTURE = (5000, 100_000)  # server_test.go's 5 000 nodes / 100 000 pods
STALENESS_SHAPE = (10_000, 5_000)
PLAIN_ESTIMATE_ROWS = 256  # row chunk of the plain fleet estimate on the card
TIER_PRIORITIES = (0, 1000, 100000, 1000000)
PREEMPTORS = 256
PREEMPT_FREE_CPU = 0.25  # bench.py run_preempt's preempt leg: 0.25 cpu free per cluster
CHURN_ROUNDS = 20  # timed rounds of the churn cell
CHUNK_ROUNDS = 10  # timed rounds of churn_incremental, churn_dirty and flagship_k256
INCREMENTAL_DIRTY = 0.05  # config 5b: 5 % of the bindings dirtied per round
DIRTY_CLUSTERS = 50  # churn_dirty: 1 % of the fleet changes status per round
QUEUED_REFRESH_TURNS = 3  # churn_dirty: refreshes on an idle stream and behind queued work
QUEUED_WORK_MS = 20.0  # the device work queued ahead of those refreshes
PIPELINE_RUNS = 3  # runs of each pipeline leg, interleaved
RETRY_EVERY = 8  # one churn binding in 8 under ordered affinity terms (pipeline cell)
PIPELINE_ROUNDS = 5  # timed rounds per run
WIDE_CLUSTERS = 20_000  # the reference's 40k x 20k scale point
WIDE_BINDINGS = 40_000
WIDE_ROUNDS = 3
WIDE_SAMPLE = 2048  # wide_40k rows held against the cpu round
WIDE_TAIL_KS = (192, 256, 512)  # the K > 128 tail's random checks
WIDE_TAIL_ROWS = 2048
WIDE_SELECT_ROWS = 1024  # rows of the random checks on both sides of the select routes' threshold
SELECT_EDGE_ROWS = 2048  # rows of the select's seeded edge cases
TAIL_CASE_ROWS = 2048  # rows of each of the tail's seeded edge cases
TAIL_CASE_KS = (8, 100, 128)  # their window widths
DENSE_FILTER_SCALAR_SHAPES = ((2048, 4999), (2048, 13))  # dense_filter's scalar route
MASK_SCALAR_WIDTHS = (5000, 77)  # the mask kernels' scalar routes (bucket_cols=False fleets)
SYNC_CHECK_SAMPLE = 64  # the sync check compares one row in 64 whole
WHATIF_CLUSTERS = 500  # bench.py:521 build_whatif's defaults
WHATIF_BINDINGS = 1000
WHATIF_SCENARIOS = 16
WHATIF_ROUNDS = 20
SIM_SPREAD_ROWS = 32  # whatif_mixed's region-spread rows (the fallback)
CHURN5K_CLUSTERS = N_CLUSTERS  # build_whatif at BASELINE config 5's size
CHURN5K_BINDINGS = N_BINDINGS
CHURN5K_ROUNDS = 3
CHURN5K_SAMPLE = 256  # whatif_churn5k rows held against the cpu Simulator
# sim_filter / sim_load's seeded checks (S, B, C, with answers): the whatif
# solve's shape and one whatif_churn5k chunk's
SIM_CHECK_SHAPES = ((17, 1024, 512, False), (17, 1024, 512, True), (5, 10240, 5120, True))
SIM_LOAD_RESOURCES = (4, 9, 17)  # sim_load's resource counts in phase 3
K256 = 256  # flagship_k256's candidate window
GRAFT_ROUNDS = 20  # timed calls of the dense-input program at the flagship
SHIM_ROUNDS = 5  # timed /v1/scheduleBatch rounds of shim_flagship
SHIM_SAMPLE = 2048  # shim_flagship rows held against the cpu round
NARROW_INPUT_SHAPE = (300, 100)  # the dense-input filter's narrow check (C < 128)
ODD_INPUT_SHAPE = (333, 257)  # rows no multiple of its 32-row group, an odd width
INPUT_REPEATS = 4  # distinct rows of its repeated-row check (the flagship's requests)
MESH_GRIDS = ((2, 2), (2, 3))  # the tile filter's random cuts; 2 x 3 pads C to a multiple of 3
MESH_SHIFT = 2  # columns the shifted 2 x 2 cut moves its tiles (first columns off a multiple of 4)
MESH_ROUNDS = 10  # timed rounds of mesh_flagship
MESH_SAMPLE = 2000  # mesh_flagship rows held against the cpu mesh round
DEVICE = "cuda"

FLEET = ("alive", "capacity", "has_summary", "taint_key", "taint_value", "taint_effect", "api_ok")
SELECT_BATCH = ("replicas", "unknown_request", "gvk", "tol_tables", "tol_idx", "aff_masks",
                "aff_idx", "prev_idx", "prev_rep", "evict_idx", "seeds", "req_unique", "req_idx")
SELECT_OUT = ("cand_idx", "c_feas", "c_score", "c_avail", "c_prev", "c_tie", "feas_count",
              "packed")
TAIL_OUT = ("result", "unschedulable", "avail_sum", "nnz", "top_idx", "top_val")
ESTIMATE_ARGS = ("capacity", "has_summary", "req_unique", "req_idx", "replicas",
                 "unknown_request")
FILTER_OUT = ("feasible", "score", "avail", "prev", "tie", "feas_count")
GRAFT_OUT = ("feasible", "score", "result", "unschedulable", "avail_sum", "avail")
DENSE_INPUT_OUT = ("feasible", "score", "avail")
MESH_OUT = ("feasible", "score", "result", "unschedulable", "avail_sum", "avail", "feas_count",
            "nnz", "top_idx", "top_val")
GROUP_OUT = ("weight", "value", "avail_sum", "feas_count")
SPREAD_TAIL_OUT = ("result", "unschedulable", "avail_sum", "feas_count", "nnz", "top_idx",
                   "top_val")
COMBO_OUT = ("first_idx", "n_ties", "none_feasible")
LAYOUT = ("perm", "seg_start", "seg_end", "rank_p")


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# the flagship mix (bench.py build_flagship, rebuilt from the port's API)
# --------------------------------------------------------------------------


def _dyn_placement(aggregated: bool) -> pol.Placement:
    return pol.Placement(
        cluster_affinity=pol.ClusterAffinity(cluster_names=[]),
        replica_scheduling=pol.ReplicaSchedulingStrategy(
            replica_scheduling_type=pol.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=(
                pol.DIVISION_PREFERENCE_AGGREGATED if aggregated
                else pol.DIVISION_PREFERENCE_WEIGHTED
            ),
            weight_preference=None if aggregated else pol.ClusterPreferences(
                dynamic_weight=pol.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS
            ),
        ),
    )


def _binding(i, replicas, placement, cpu, prev=None, ns="bench"):
    return ResourceBinding(
        metadata=ObjectMeta(namespace=ns, name=f"app-{i}", uid=new_uid("rb")),
        spec=BindingSpec(
            resource=ObjectReference(api_version="apps/v1", kind="Deployment",
                                     namespace=ns, name=f"app-{i}"),
            replicas=replicas,
            replica_requirements=ReplicaRequirements(resource_request={CPU: cpu}),
            placement=placement,
            clusters=[TargetCluster(name=n, replicas=r) for n, r in (prev or {}).items()],
        ),
    )


def build_flagship(seed=0, n_clusters=N_CLUSTERS, n_bindings=N_BINDINGS, dense=False,
                   whole_fleet_dup=False):
    """The north-star mixed round: duplicated / static-weight /
    dynamic-weight / aggregated rows, one in three with a previous
    placement (bench.py:398-423, the same draws from the same seed).
    `dense` annotates every binding dense-solve (the dense round, reason
    policy); `whole_fleet_dup` places the Duplicated quarter over the whole
    fleet instead of 16 clusters."""
    rng = np.random.default_rng(seed)
    clusters = synthetic_fleet(n_clusters, seed=seed)
    names = [c.name for c in clusters]
    placements = [
        pol.Placement() if whole_fleet_dup else duplicated_placement(names[:16]),
        static_weight_placement({names[j]: j + 1 for j in range(8)}),
        _dyn_placement(aggregated=False),
        _dyn_placement(aggregated=True),
    ]
    bindings = []
    for i in range(n_bindings):
        prev = {names[int(rng.integers(n_clusters))]: 2} if i % 3 == 0 else None
        bindings.append(_binding(i, int(rng.integers(1, 64)), placements[i % 4],
                                 float(rng.choice([0.1, 0.25, 0.5, 1.0])), prev=prev))
    if dense:
        for rb in bindings:
            rb.metadata.annotations = {DENSE_SOLVE_ANNOTATION: "true"}
    return clusters, bindings


def build_static(seed=0, n_clusters=100, n_bindings=1000):
    """BASELINE config 2 (bench.py:151 build_static, the same draws): a
    static-weight Divided split, 100 clusters x 1 000 bindings over 16
    weight lists of 8 clusters each."""
    rng = np.random.default_rng(seed)
    clusters = synthetic_fleet(n_clusters, seed=seed)
    names = [c.name for c in clusters]
    placements = [
        static_weight_placement(
            {names[j]: int(rng.integers(1, 10))
             for j in rng.choice(n_clusters, size=min(8, n_clusters), replace=False)}
        )
        for _ in range(16)
    ]
    bindings = [
        _binding(i, int(rng.integers(1, 64)), placements[i % 16],
                 float(rng.choice([0.1, 0.25, 0.5])))
        for i in range(n_bindings)
    ]
    return clusters, bindings


def build_dup3(seed=0, n_bindings=100):
    """BASELINE config 1 (bench.py:139 build_dup3): the local-up slice, 3
    member clusters and Duplicated nginx-alikes."""
    clusters = synthetic_fleet(3, seed=seed)
    p = duplicated_placement([c.name for c in clusters])
    return clusters, [_binding(i, 2, p, 0.1) for i in range(n_bindings)]


def _spread_placements(rng, n_placements: int):
    """bench.py:273 _spread_placements, the same draws: n_placements
    distinct (region MinGroups, MaxGroups, cluster MinGroups) tuples, 30 %
    Aggregated, the rest Duplicated, over the whole fleet."""
    out = []
    for k in range(n_placements):
        rmin = int(rng.integers(2, 5))
        rmax = rmin + int(rng.integers(0, 3))
        cmin = int(rng.integers(rmin, rmin + 3))
        cons = [
            pol.SpreadConstraint(spread_by_field=pol.SPREAD_BY_FIELD_REGION,
                                 min_groups=rmin, max_groups=rmax),
            pol.SpreadConstraint(spread_by_field=pol.SPREAD_BY_FIELD_CLUSTER, min_groups=cmin),
        ]
        if k % 10 >= 7:
            p = _dyn_placement(aggregated=True)
            p.spread_constraints = cons
        else:
            p = pol.Placement(cluster_affinity=pol.ClusterAffinity(cluster_names=[]),
                              spread_constraints=cons)
        out.append(p)
    return out


def build_spread(seed=0, n_clusters=N_CLUSTERS, n_bindings=SPREAD_BINDINGS, skewed=False):
    """BASELINE config 4 (bench.py:305 build_spread, the same draws): 200
    distinct region-spread placements over 5 000 clusters x 5 000 bindings.
    `skewed` is config 4b (bench.py:323 build_spread_skewed): one mega
    region holding 60 % of the fleet among 30 small ones."""
    rng = np.random.default_rng(seed)
    clusters = synthetic_fleet(n_clusters, seed=seed)
    if skewed:
        n_mega = int(n_clusters * 0.6)
        for i, c in enumerate(clusters):
            if i < n_mega:
                c.spec.region, c.spec.provider = "mega-region", "mega"
            else:
                r = int(rng.integers(0, 30))
                c.spec.region, c.spec.provider = f"small-{r}", f"p{r % 4}"
    placements = _spread_placements(rng, 200)
    bindings = [
        _binding(i, int(rng.integers(1, 32)), placements[i % len(placements)],
                 float(rng.choice([0.1, 0.25, 0.5])))
        for i in range(n_bindings)
    ]
    return clusters, bindings


def build_spread_window(seed=0, n_clusters=N_CLUSTERS, n_bindings=WINDOW_BINDINGS):
    """Config 4's mix over the same fleet, each placement's affinity naming
    64 clusters: every feasible set fits the candidate window, so the
    compact round selects in the window (and re-runs the window tail for
    the Aggregated rows)."""
    rng = np.random.default_rng(seed + 1)
    clusters = synthetic_fleet(n_clusters, seed=seed)
    names = [c.name for c in clusters]
    placements = _spread_placements(rng, 200)
    for p in placements:
        pick = rng.choice(n_clusters, WINDOW_NAMES, replace=False)
        p.cluster_affinity = pol.ClusterAffinity(cluster_names=[names[int(j)] for j in pick])
    bindings = [
        _binding(i, int(rng.integers(1, 32)), placements[i % len(placements)],
                 float(rng.choice([0.1, 0.25, 0.5])))
        for i in range(n_bindings)
    ]
    return clusters, bindings


def build_drain(seed=0, n_clusters=N_CLUSTERS, n_bindings=SPREAD_BINDINGS):
    """A synthetic cell that exists to cross the 4 096-distinct-row gate
    that puts the winner selection (combo_select) on the card; no
    deployment or bench configuration has its shape. Config 4's fleet under
    one policy (region MinGroups 2, MaxGroups 3, cluster MinGroups 3,
    Duplicated); each binding carries graceful-eviction tasks from one
    cluster in each region of its own random half of the 16 regions, so
    almost every row has its own group values."""
    rng = np.random.default_rng(seed + 2)
    clusters = synthetic_fleet(n_clusters, seed=seed)
    by_region: dict[str, list[str]] = {}
    for c in clusters:
        by_region.setdefault(c.spec.region, []).append(c.name)
    regions = sorted(by_region)
    p = pol.Placement(
        cluster_affinity=pol.ClusterAffinity(cluster_names=[]),
        spread_constraints=[
            pol.SpreadConstraint(spread_by_field=pol.SPREAD_BY_FIELD_REGION,
                                 min_groups=2, max_groups=3),
            pol.SpreadConstraint(spread_by_field=pol.SPREAD_BY_FIELD_CLUSTER, min_groups=3),
        ],
    )
    bindings = []
    for i in range(n_bindings):
        rb = _binding(i, int(rng.integers(1, 32)), p, float(rng.choice([0.1, 0.25, 0.5])))
        drained = [r for r in regions if rng.random() < 0.5]
        rb.spec.graceful_eviction_tasks = [
            GracefulEvictionTask(from_cluster=by_region[r][int(rng.integers(len(by_region[r])))])
            for r in drained
        ]
        bindings.append(rb)
    return clusters, bindings


# the spread cells of phase 4: (name, builder, launches per round; every
# other kernel must launch 0 times)
_SPREAD_DENSE = {"candidate_select": 1, "dense_filter": 1, "group_score": 1,
                 "packed_selection": 1}
SPREAD_CELLS = (
    ("config 4", build_spread, {**_SPREAD_DENSE, "spread_tail": 1}),
    ("config 4b", functools.partial(build_spread, skewed=True), {**_SPREAD_DENSE, "spread_tail": 1}),
    ("window", build_spread_window, {"candidate_select": 1, "candidate_tail": 1}),
    ("drain", build_drain, {**_SPREAD_DENSE, "combo_select": 1}),
)


def _set_free_cpu(clusters, free_of) -> None:
    """Raise each cluster's allocated cpu so its free cpu is
    free_of(cluster, free now)."""
    for c in clusters:
        rs = c.status.resource_summary
        free = rs.allocatable[CPU] - rs.allocated.get(CPU, 0.0)
        rs.allocated[CPU] = rs.allocatable[CPU] - free_of(c, free)


def build_tiers(seed=0, duplicated=True, n_clusters=N_CLUSTERS, n_bindings=N_BINDINGS):
    """The tier cells: the flagship batch (build_flagship, seed 0) with
    schedule_priority drawn from the seed over TIER_PRIORITIES and one row
    in 16 PreemptLowerPriority, over the flagship fleet with every
    cluster's free cpu scaled by one factor so the divided rows ask for
    1.5x the fleet's free cpu (lower tiers meet a residual). The
    victim-candidate snapshot is the batch's rows that carry a previous
    placement. `duplicated=False` drops the Duplicated quarter (7 500
    rows: the compact tiered launch). Returns (clusters, bindings,
    placed)."""
    clusters, bindings = build_flagship(seed, n_clusters=n_clusters, n_bindings=n_bindings)
    rng = np.random.default_rng(seed + 3)
    for i, rb in enumerate(bindings):
        rb.spec.schedule_priority = int(rng.choice(TIER_PRIORITIES))
        if i % 16 == 2:  # dynamic-weight rows (placements[i % 4]), in both cells
            rb.spec.preemption_policy = pol.PREEMPT_LOWER_PRIORITY
    divided = (STATIC_WEIGHT, DYNAMIC_WEIGHT, AGGREGATED)
    demand = sum(rb.spec.replicas * rb.spec.replica_requirements.resource_request[CPU]
                 for rb in bindings
                 if strategy_code(rb.spec.placement, rb.spec.replicas) in divided)
    free_now = sum(c.status.resource_summary.allocatable[CPU]
                   - c.status.resource_summary.allocated.get(CPU, 0.0) for c in clusters)
    scale = demand / 1.5 / free_now
    _set_free_cpu(clusters, lambda c, free: free * scale)
    if not duplicated:
        bindings = [rb for i, rb in enumerate(bindings) if i % 4]  # placements[0] is Duplicated
    return clusters, bindings, [rb for rb in bindings if rb.spec.clusters]


def build_preempt(seed=0, n_clusters=N_CLUSTERS, n_bindings=N_BINDINGS,
                  n_preemptors=PREEMPTORS):
    """The preemption-plan cell: the tier cells' fleet tightened to
    PREEMPT_FREE_CPU free cpu per cluster (bench.py run_preempt's preempt
    leg: every preemptor must reclaim), sorted by name as the preview
    encodes it; the placed snapshot is the tier batch's rows with a
    previous placement at priority 0; PREEMPTORS arrivals of 6 replicas x
    1 cpu, dynamic-weight, PreemptLowerPriority, half at priority 20 and
    half at 10 (run_preempt's arrival shape at two priorities). Returns
    (clusters, placed, preemptors)."""
    clusters, _, placed = build_tiers(seed, n_clusters=n_clusters, n_bindings=n_bindings)
    _set_free_cpu(clusters, lambda c, free: min(free, PREEMPT_FREE_CPU))
    for rb in placed:
        rb.spec.schedule_priority = 0
    preemptors = []
    for i in range(n_preemptors):
        rb = _binding(i, 6, _dyn_placement(aggregated=False), 1.0, ns="preempt")
        rb.spec.schedule_priority = 20 if i % 2 else 10
        rb.spec.preemption_policy = pol.PREEMPT_LOWER_PRIORITY
        preemptors.append(rb)
    return sorted(clusters, key=lambda c: c.name), placed, preemptors


def tier_round(sched, bindings, placed, extra=None):
    """One tiered round as the daemon runs a serial chunk: launch_tiered
    (with the estimator answers `extra`, or none), then
    materialize_chunk."""
    return sched.materialize_chunk(
        preemption.launch_tiered(sched, bindings, extra_avail=extra, placed=placed))


def tier_expect(sched, bindings, placed, compact: bool, has_extra: bool = False) -> dict:
    """Exact launches of one tiered round: the filter (dense) or select
    (compact) once; a tail per tier and per speculative pass (the tiers
    whose reclaim is non-zero, or every tier when estimator answers are
    present: the pass leaves them out); an estimate per tier after the
    first and per speculative pass (the compact round's later tiers
    estimate both passes in one launch); a consumption between tiers (the
    window mode's count in the compact round)."""
    reclaim, _armed = preemption._tier_reclaim(sched, bindings, placed)
    tier_of, _ = preemption._tier_assignment(bindings)
    n_tiers = int(tier_of.max()) + 1
    armed = np.zeros(n_tiers, bool) if reclaim is None else (
        np.ones(n_tiers, bool) if has_extra else reclaim[:n_tiers].reshape(n_tiers, -1).any(1))
    spec = int(armed.sum())
    first, tail = ("candidate_select", "candidate_tail") if compact else (
        "dense_filter", "dense_tail")
    # the compact launch estimates a later tier's two passes in one launch
    estimates = n_tiers - 1 + (int(armed[0]) if compact else spec)
    return {first: 1, tail: n_tiers + spec, "tier_estimate": estimates,
            "tier_consume_window" if compact else "tier_consume": n_tiers - 1}


# the tier cells of phase 4: (name, build_tiers' duplicated flag, compact)
TIER_CELLS = (("tiers_dense", True, False), ("tiers_compact", False, True))


# --------------------------------------------------------------------------
# the estimator path (BASELINE config 3 and the degraded mode)
# --------------------------------------------------------------------------


class Member:
    """A member cluster as MemberEstimators reads it: its node estimator."""

    def __init__(self, node_estimator):
        self.node_estimator = node_estimator


def estimator_members(names, seed=0):
    """In-process member estimators over shard_nodes pools (bench.py
    _shard_nodes' crc32-seeded draws), one per cluster name."""
    return {n: Member(AccurateEstimator(shard_nodes(seed, n))) for n in names}


def build_dynamic(seed=0, n_clusters=CONFIG3_CLUSTERS, n_bindings=CONFIG3_BINDINGS):
    """BASELINE config 3 (bench.py:216 build_dynamic, the same draws):
    Divided dynamic split, half Aggregated and half dynamic-weight, 1-63
    replicas of 0.25/0.5/1 cpu, over 1 000 synthetic_fleet clusters whose
    answers come from member estimators over shard_nodes pools (the
    reference's MemberEstimators route in place of its gRPC daemon).
    Returns (clusters, bindings)."""
    rng = np.random.default_rng(seed)
    clusters = synthetic_fleet(n_clusters, seed=seed)
    cpus = [0.25, 0.5, 1.0]
    bindings = [
        _binding(i, int(rng.integers(1, 64)), _dyn_placement(aggregated=(i % 2 == 0)),
                 float(rng.choice(cpus)))
        for i in range(n_bindings)
    ]
    return clusters, bindings


class RowsEstimator:
    """bench.py build_degraded's stand-in for the member daemons: seeded
    per-(row, cluster) answers in [1, 1000), one matrix per shape."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)
        self._cache = {}

    def max_available_replicas_rows(self, clusters, reqs):
        key = (len(clusters), len(reqs))
        if key not in self._cache:
            self._cache[key] = self._rng.integers(
                1, 1000, size=(len(reqs), len(clusters))).astype(np.int32)
        return self._cache[key]


def build_degraded(seed=0, n_clusters=DEGRADED_CLUSTERS, n_bindings=DEGRADED_BINDINGS):
    """bench.py:634 build_degraded (the same draws): 500 clusters x 1 000
    dynamic-weight bindings of 1-31 replicas, answers from RowsEstimator,
    a breaker registry (threshold 1, open for an hour) shared with the
    estimator registry. Returns (clusters, bindings, registry, breakers)."""
    rng = np.random.default_rng(seed)
    clusters = synthetic_fleet(n_clusters, seed=seed)
    bindings = [
        _binding(i, int(rng.integers(1, 32)), _dyn_placement(aggregated=False),
                 float(rng.choice([0.1, 0.25, 0.5])))
        for i in range(n_bindings)
    ]
    breakers = BreakerRegistry(failure_threshold=1, open_seconds=3600.0)
    registry = EstimatorRegistry(breakers=breakers)
    registry.register_replica_estimator("bench-estimator", RowsEstimator(seed + 1))
    return clusters, bindings, registry, breakers


def host_rows(members, names, reqs) -> np.ndarray:
    """The per-cluster host path's answers [len(reqs), len(names)]: each
    member's AccurateEstimator in numpy (its max_available_replicas_batch),
    the discard sentinel where a cluster has no estimator; computed once
    per distinct requirement, since an answer depends on nothing else."""
    keys = [repr(r) for r in reqs]
    uniq = list(dict.fromkeys(keys))
    first = {k: reqs[keys.index(k)] for k in uniq}
    cols = []
    for n in names:
        m = members.get(n)
        est = m.node_estimator if m is not None else None
        cols.append([-1] * len(uniq) if est is None else
                    est.max_available_replicas_batch([first[k] for k in uniq]))
    table = np.asarray(cols, np.int64).T  # [U, C]
    return table[[uniq.index(k) for k in keys]]


# --------------------------------------------------------------------------
# inputs at the flagship shapes
# --------------------------------------------------------------------------


def flagship_kernel_inputs(sched: ArrayScheduler, bindings):
    """The main path's own select and tail inputs for the flagship batch:
    rows permuted by class and encoded as launch_candidates does."""
    cls = np.asarray([sched._row_class(rb, False) for rb in bindings], np.int8)
    order = np.argsort(cls, kind="stable")
    bindings = [bindings[i] for i in order]
    cls = cls[order]
    raw = sched.batch_encoder.encode(bindings)
    batch = sched._pad(raw)
    k = effective_k(sched, raw, len(sched.fleet.names))
    t = batch_from_numpy({n: getattr(batch, n) for n in SELECT_BATCH + (
        "strategy", "fresh", "weight_tables", "weight_idx")}, sched.device)
    select_args = [sched._fleet_dev[n] for n in FLEET] + [t[n] for n in SELECT_BATCH] + [None]
    tails = []
    for want_cls, has_agg in ((1, False), (2, True)):
        idx_pad, nr = _pad_rows_idx(np.flatnonzero(cls == want_cls), sched._bucket)
        rows = idx_pad[:nr]
        idx = torch.from_numpy(idx_pad.astype(np.int64)).to(sched.device)
        topk = min(pow2_bucket(min(int(raw.replicas[rows].max()), TOPK_TARGETS), lo=8),
                   TOPK_TARGETS)
        tails.append((idx, topk, has_agg))
    return select_args, k, t, tails


def tail_args(sel, t, idx):
    cand_idx, c_feas, _, c_avail, c_prev, c_tie = sel[:6]
    pick = [x.index_select(0, idx) for x in (c_feas, c_avail, c_prev, c_tie, cand_idx)]
    return pick + [t["weight_tables"]] + [t[n].index_select(0, idx) for n in
                                         ("weight_idx", "strategy", "replicas", "fresh")]


def random_select_inputs(rng, dev, B, C):
    """Seeded tie-heavy select inputs at the flagship shapes: few distinct
    keys per row (so the window's tie order decides most winners), taints
    and tolerations, unknown GVKs, prev lists with sentinels, out-of-range
    and repeated columns, high-bit seeds, zero and absent requests, and a
    registered-estimator answer with -1 sentinels."""
    R, T, G, Kt, Tt, P, Kp, Ke, U = 4, 4, 6, 6, 8, 4, 8, 2, 8
    tol_tables = rng.integers(0, 4, (Tt, 4, Kt)).astype(np.int32)
    tol_tables[0] = 0
    prev_idx = rng.integers(-2, C + 3, (B, Kp)).astype(np.int32)
    prev_idx[:, 1] = prev_idx[:, 0]  # a column listed twice
    prev_idx[::2, 4:] = C  # the encoder's drop sentinel
    seeds = rng.integers(0, 2**63, B, dtype=np.uint64) | np.uint64(1 << 63)
    req_unique = rng.integers(0, 2000, (U, R)).astype(np.int64)
    req_unique[0] = 0
    capacity = rng.integers(-10, 2_000_000, (C, R)).astype(np.int64)
    capacity[::5, 0] = 0
    d = {
        "alive": rng.random(C) < 0.9,
        "capacity": capacity,
        "has_summary": rng.random(C) < 0.95,
        "taint_key": rng.integers(0, 4, (C, T)).astype(np.int32),
        "taint_value": rng.integers(0, 3, (C, T)).astype(np.int32),
        "taint_effect": rng.integers(0, 4, (C, T)).astype(np.int32),
        "api_ok": rng.random((C, G)) < 0.9,
        "replicas": rng.integers(0, 64, B).astype(np.int32),
        "unknown_request": rng.random(B) < 0.05,
        "gvk": rng.integers(0, G + 1, B).astype(np.int32),
        "tol_tables": tol_tables,
        "tol_idx": rng.integers(0, Tt, B).astype(np.int32),
        "aff_masks": rng.random((P, C)) < 0.6,
        "aff_idx": rng.integers(0, P, B).astype(np.int32),
        "prev_idx": prev_idx,
        "prev_rep": rng.integers(0, 9, (B, Kp)).astype(np.int32),
        "evict_idx": rng.integers(0, C + 1, (B, Ke)).astype(np.int32),
        "seeds": seeds,
        "req_unique": req_unique,
        "req_idx": rng.integers(0, U, B).astype(np.int32),
        "extra_avail": rng.integers(-1, 50, (B, C)).astype(np.int32),
    }
    t = batch_from_numpy(d, dev)
    return [t[n] for n in FLEET + SELECT_BATCH + ("extra_avail",)]


def random_tail_inputs(rng, dev, rows, K, C):
    """Seeded tie-heavy tail inputs: every strategy, Steady up/down/eq and
    Fresh rows, many equal weights and ties."""
    cand = np.sort(rng.choice(C, (rows, K)), axis=1).astype(np.int32)
    feas = rng.random((rows, K)) < 0.8
    prev = np.where(rng.random((rows, K)) < 0.05, rng.integers(1, 6, (rows, K)), 0)
    assigned = np.where(feas, prev, 0).sum(-1)
    replicas = rng.integers(0, 120, rows)
    mode = np.arange(rows) % 4
    replicas = np.where(mode == 2, assigned, replicas)
    replicas = np.where((mode == 1) & (assigned > 1), assigned - 1, replicas)
    d = {
        "c_feas": feas,
        "c_avail": rng.choice([0, 1, 2, 2, 9, 40], (rows, K)).astype(np.int32),
        "c_prev": prev.astype(np.int32),
        "c_tie": rng.integers(0, 4, (rows, K)).astype(np.int32),
        "cand_idx": cand,
        "weight_tables": rng.choice([0, 1, 3, 3], (4, C)).astype(np.int64),
        "weight_idx": rng.integers(0, 4, rows).astype(np.int32),
        "strategy": rng.choice([1, 2, 3, 4], rows).astype(np.int32),
        "replicas": replicas.astype(np.int32),
        "fresh": mode == 3,
    }
    return list(batch_from_numpy(d, dev).values())


TAIL_CASES = ("zero static weights", "rem = 0", "steady eq", "unschedulable", "window ties",
              "topk = K")


def tail_case_inputs(rng, dev, rows, K, C, case):
    """Seeded tail inputs [rows, K] with one edge of the division in every
    row: "zero static weights" (static rows on the all-zero weight table,
    so the feasible set weighs 1 each), "rem = 0" (static rows, every
    column feasible at weight 2, replicas a multiple of K: no remainder to
    give), "steady eq" (non-fresh dynamic and Aggregated rows whose
    feasible previous replicas sum to their replicas), "unschedulable"
    (dynamic and Aggregated rows asking more than their windows hold),
    "window ties" (Duplicated rows and static rows of equal weights: the
    output window breaks ties on the result by column); "topk = K" is
    random_tail_inputs' mix (the caller passes topk = K)."""
    if case == "topk = K":
        return random_tail_inputs(rng, dev, rows, K, C)
    cand = np.sort(np.stack([rng.choice(C, K, replace=False) for _ in range(rows)]),
                   axis=1).astype(np.int32)
    feas = rng.random((rows, K)) < 0.75
    prev = np.where(rng.random((rows, K)) < 0.1, rng.integers(1, 6, (rows, K)), 0)
    avail = rng.choice([0, 1, 2, 2, 9, 40], (rows, K))
    weight_tables = rng.choice([1, 3, 3, 5], (4, C)).astype(np.int64)
    weight_tables[0] = 0  # the encoder's all-zero row
    weight_tables[1] = 2
    weight_idx = rng.integers(1, 4, rows)
    fresh = np.zeros(rows, bool)
    replicas = rng.integers(1, 200, rows)
    if case == "zero static weights":
        strategy = np.full(rows, 2)
        weight_idx[:] = 0
    elif case == "rem = 0":
        strategy = np.full(rows, 2)
        weight_idx[:] = 1
        feas[:] = True
        replicas = K * rng.integers(0, 4, rows)
    elif case == "steady eq":
        strategy = rng.choice([3, 4], rows)
        replicas = np.where(feas, prev, 0).sum(-1)
    elif case == "unschedulable":
        strategy = rng.choice([3, 4], rows)
        fresh = rng.random(rows) < 0.5
        replicas = np.where(feas, avail + prev, 0).sum(-1) + rng.integers(1, 50, rows)
    elif case == "window ties":
        strategy = rng.choice([1, 2], rows)
        weight_idx[:] = 1
        replicas = rng.integers(1, 8, rows)
    else:
        raise ValueError(f"unknown tail case {case!r}")
    d = {
        "c_feas": feas,
        "c_avail": avail.astype(np.int32),
        "c_prev": prev.astype(np.int32),
        "c_tie": rng.integers(0, 4, (rows, K)).astype(np.int32),
        "cand_idx": cand,
        "weight_tables": weight_tables,
        "weight_idx": weight_idx.astype(np.int32),
        "strategy": strategy.astype(np.int32),
        "replicas": replicas.astype(np.int32),
        "fresh": fresh,
    }
    return list(batch_from_numpy(d, dev).values())


def random_dense_tail_inputs(rng, dev, B, C, n):
    """Seeded tie-heavy dense-tail inputs: [B, C] filter outputs with few
    distinct weights, last values and ties (so `rem` splits the cutoff tie
    group), every strategy, Steady up/down/eq and Fresh rows, n row ids
    with repeats, and one row in eight with negative previous replicas or
    availability (the exact quadratic Aggregated prefix)."""
    feas = rng.random((B, C)) < 0.8
    prev = np.where(rng.random((B, C)) < 0.03, rng.integers(1, 4, (B, C)), 0)
    avail = rng.choice([0, 2, 2, 2, 7, 40], (B, C))
    odd = rng.random(B) < 0.125
    prev = np.where(odd[:, None] & (rng.random((B, C)) < 0.05), -rng.integers(1, 3, (B, C)), prev)
    avail = np.where(odd[:, None] & (rng.random((B, C)) < 0.05), -1, avail)
    assigned = np.where(feas, prev, 0).sum(-1)
    replicas = rng.integers(0, 4 * C, B)
    mode = np.arange(B) % 4
    replicas = np.where(mode == 2, assigned, replicas)
    replicas = np.where((mode == 1) & (assigned > 1), assigned - 1, replicas)
    d = {
        "feasible": feas,
        "avail": avail.astype(np.int32),
        "prev": prev.astype(np.int32),
        "tie": rng.integers(0, 3, (B, C)).astype(np.int32),
        "rows": rng.integers(0, B, n).astype(np.int32),
        "weight_tables": rng.choice([0, 3, 3, 3, 5], (4, C)).astype(np.int64),
        "weight_idx": rng.integers(0, 4, B).astype(np.int32),
        "strategy": rng.choice([0, 1, 2, 3, 4, 4], B).astype(np.int32),
        "replicas": np.maximum(replicas, 0).astype(np.int32),
        "fresh": mode == 3,
    }
    d["weight_tables"][0] = 0  # the encoder's all-zero row
    return list(batch_from_numpy(d, dev).values())


# --------------------------------------------------------------------------
# comparison and timing
# --------------------------------------------------------------------------


def compare(name, got, want, fields) -> int:
    """Exact comparison of every output; returns the max abs error (0)."""
    worst = 0
    for f, a, b in zip(fields, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}.{f}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0
        worst = max(worst, err)
        if err:
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{name}.{f} differs from its plain version at {bad}")
    if "top_idx" in fields:  # the output window as the decode reads it
        i, v = fields.index("top_idx"), fields.index("top_val")
        gi, gv = _sorted_pairs(got[i].cpu().numpy(), got[v].cpu().numpy())
        wi, wv = _sorted_pairs(want[i].cpu().numpy(), want[v].cpu().numpy())
        if not (np.array_equal(gi, wi) and np.array_equal(gv, wv)):
            raise AssertionError(f"{name}: sorted output windows differ")
    return worst


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


# --------------------------------------------------------------------------
# A/B: the redesigned kernels against the earlier designs, in turns
# --------------------------------------------------------------------------

AB_TURNS = 2  # each variant timed this often, in mirrored order (a b c c b a)
AB = {}  # label -> {variant: [ms, ...]}: one JSON line at the end of the run


def ab_time(label, variants, reps, check=None):
    """Times each variant (name -> callable) by CUDA events over `reps`
    calls, AB_TURNS times in mirrored order within this process, and keeps
    the times under AB[label]. `check`, if given, is (fields, name of the
    variant the others must equal): every variant's outputs are held
    against it first."""
    if check is not None:
        fields, ref = check
        want = variants[ref]()
        for name, fn in variants.items():
            if name != ref:
                compare(f"A/B {label}: {name} against {ref}", fn(), want, fields)
    names = list(variants)
    got = {n: [] for n in names}
    for turn in range(AB_TURNS):
        for n in (names if turn % 2 == 0 else names[::-1]):
            got[n].append(cuda_ms(variants[n], reps))
    AB[label] = got
    log(f"A/B {label}: " + "; ".join(
        f"{n} {' / '.join(f'{x:.4f}' for x in xs)} ms" for n, xs in got.items()))
    return got


def tail_variants(args_list, fn_new):
    """The A/B variants of a tail over several calls (args, keywords): the
    new kernel on its automatic route and the re-reading route (the earlier
    body, unchanged)."""
    def run(fn, **kw):
        return lambda: [o for a, k in args_list for o in fn(*a, **{**k, **kw})]
    return {"new": run(fn_new), "reread route": run(fn_new, route="reread")}


def tail_routes(C):
    """The dense tail's routes a width can take: both up to the staged
    width, the re-reading one past it."""
    return ("auto", "reread") if C <= kernels.MAX_TAIL_SMEM_COLS else ("reread",)


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def select_bound(args, outs, k):
    """Bytes: every input read once, every output written once. Operations:
    per (row, column) the filter chain and key — one compare per taint
    slot, prev entry and evict entry plus 8 more — and the window's
    estimate per requested resource."""
    B, C = args[7].shape[0], args[0].shape[0]
    T, Kp, Ke, R = args[3].shape[1], args[14].shape[1], args[16].shape[1], args[1].shape[1]
    ops = B * C * (T + Kp + Ke + 8) + B * k * (4 * R + 12)
    return bound(nbytes(args) + nbytes(outs), ops)


def tail_bound(args_list, outs_list):
    """Per row of K window columns: three sorts of K keys (K log2 K
    compares each), one scan, and ~40 elementwise int64 operations per
    column."""
    ops, moved = 0, 0
    for args, outs in zip(args_list, outs_list):
        rows, K = args[0].shape
        ops += rows * (3 * K * max(K.bit_length() - 1, 1) + 2 * K + 40 * K)
        moved += nbytes(args) + nbytes(outs)
    return bound(moved, ops)


def dense_filter_bound(args, outs):
    """Bytes: every input read once, every output written once. Operations:
    per (row, column) the filter chain (one compare per taint slot, prev
    entry and evict entry plus 8), the estimate (4 per requested resource
    plus 4) and the splitmix64 tie (12)."""
    B, C = args[7].shape[0], args[0].shape[0]
    T, Kp, Ke, R = args[3].shape[1], args[14].shape[1], args[16].shape[1], args[1].shape[1]
    return bound(nbytes(args) + nbytes(outs), B * C * (T + Kp + Ke + 4 * R + 24))


def dense_tail_bound(filt_outs, rows_list, weight_tables, outs_list):
    """Bytes: the four filter outputs of each tail row read once (13 bytes a
    column), the weight table and every output written once. Operations:
    ~40 elementwise int64 operations per column (the weights, quota and
    bonus compare), as for the compact tail."""
    C = filt_outs[0].shape[1]
    moved = nbytes([weight_tables]) + sum(nbytes(o) for o in outs_list)
    ops = 0
    for rows in rows_list:
        n = rows.numel()
        moved += n * C * 13 + nbytes([rows])
        ops += n * C * 40
    return bound(moved, ops)


def mask_bound(feasible, rows, out, k=None):
    """Bytes: each id's filter row read once — for feas_idx (k given) only
    up to its k-th feasible column, where the warp stops, the whole row
    where it has fewer — the ids read and the output written once.
    Operations: one a column read."""
    C = feasible.shape[1]
    if k is None:
        cols = rows.numel() * C
    else:
        count = feasible.index_select(0, rows.long()).to(torch.int32).cumsum(-1)
        reach = (count >= k).to(torch.int32).argmax(-1) + 1
        cols = int(torch.where(count[:, -1] >= k, reach, C).sum())
    return bound(cols + nbytes([rows, out]), cols)


def dense_kernel_inputs(sched: ArrayScheduler, bindings):
    """The dense round's own kernel inputs, as _launch_once_partitioned
    builds them: rows permuted by class and encoded, the filter arguments,
    the class-1 / class-2 row ids with their windows, the real mask rows'
    ids (int32), their feas_idx window and the padded batch."""
    cls = np.asarray([sched._row_class(rb, False) for rb in bindings], np.int8)
    order = np.argsort(cls, kind="stable")
    bindings = [bindings[i] for i in order]
    cls = cls[order]
    raw = sched.batch_encoder.encode(bindings)
    batch = sched._pad(raw)
    dev = sched.device
    t = batch_from_numpy({n: getattr(batch, n) for n in SELECT_BATCH + (
        "strategy", "fresh", "weight_tables", "weight_idx")}, dev)
    filt_args = [sched._fleet_dev[n] for n in FLEET] + [t[n] for n in SELECT_BATCH] + [None]
    tails = []
    for want_cls, has_agg in ((1, False), (2, True)):
        idx_pad, nr = _pad_rows_idx(np.flatnonzero(cls == want_cls), sched._bucket)
        topk = min(pow2_bucket(min(int(raw.replicas[idx_pad[:nr]].max()), TOPK_TARGETS), lo=8),
                   TOPK_TARGETS)
        tails.append((torch.from_numpy(idx_pad).to(dev), topk, has_agg))
    mask_rows = np.flatnonzero(cls == 0)
    pc = raw.aff_masks.sum(axis=1)
    mk = int(pc[raw.aff_idx[mask_rows]].max(initial=0))
    k = min(pow2_bucket(mk, lo=8), len(sched.fleet.names))
    return filt_args, t, tails, torch.from_numpy(mask_rows.astype(np.int32)).to(dev), k, batch


def dense_tail_args(filt, t, rows):
    feas, _score, avail, prev, tie, _fc = filt
    return [feas, avail, prev, tie, rows, t["weight_tables"], t["weight_idx"], t["strategy"],
            t["replicas"], t["fresh"]]


def decision_view(d):
    spec = d.speculative
    return (d.key, d.error, d.affinity_name,
            None if d.targets is None else [(t.name, t.replicas) for t in d.targets],
            list(d.feasible), None if spec is None else decision_view(spec))


ALL_PATH_LAUNCHES = {}  # launches over every drive() of the run, by kernel


def drive(label, sched, bindings, rounds, expect, smi, run=None):
    """One main path: launch counts set to 0, a warm round and `rounds`
    timed rounds (host clock around a synchronised round), counts read.
    `expect` maps kernel name -> launches per round (exact; the other
    kernels must stay at 0). `run` is the round (default
    `sched.schedule(bindings)`). Returns (decisions, launch counts,
    times)."""
    if run is None:
        def run():
            return sched.schedule(bindings)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decisions = run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    times, gc_rounds = [], []
    for _ in range(rounds):
        full_gcs = gc.get_stats()[2]["collections"]
        t0 = time.perf_counter()
        decisions = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        gc_rounds.append(gc.get_stats()[2]["collections"] > full_gcs)
    launches = kernels.launch_counts()
    for n, c in launches.items():
        ALL_PATH_LAUNCHES[n] = ALL_PATH_LAUNCHES.get(n, 0) + c
    n_rounds = rounds + 1
    for n, c in launches.items():
        if c != expect.get(n, 0) * n_rounds:
            raise AssertionError(f"{label}: {n} launched {c} times in {n_rounds} rounds, "
                                 f"expected {expect.get(n, 0) * n_rounds}")
    p50, p90, p99 = (float(np.percentile(times, q)) for q in (50, 90, 99))
    with_gc = [x for x, g in zip(times, gc_rounds) if g]
    log(f"{label} on {smi}: warm {warm:.4f} s; p50 {p50:.4f} s p90 {p90:.4f} s p99 {p99:.4f} s "
        f"min {min(times):.4f} s max {max(times):.4f} s over {rounds} rounds; launches "
        f"{launches} over {n_rounds} rounds; {len(with_gc)} rounds with a full garbage "
        f"collection (median {np.median(with_gc) if with_gc else float('nan'):.4f} s)")
    return decisions, launches, times


def hold_against_cpu(label, clusters, bindings, decisions, cpu_run=None, **sched_kw):
    """Run the same bindings through the port's CPU round (`cpu_run(cpu
    scheduler)`, default `schedule(bindings)`; the scheduler built with
    `sched_kw`) and require identical decisions, speculative decisions
    included."""
    t0 = time.perf_counter()
    cpu_sched = ArrayScheduler(clusters, device="cpu", **sched_kw)
    want = cpu_run(cpu_sched) if cpu_run else cpu_sched.schedule(bindings)
    cpu_s = time.perf_counter() - t0
    got = [decision_view(d) for d in decisions]
    want = [decision_view(d) for d in want]
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"{label}: card and cpu decisions differ at row {bad}: "
                             f"{got[bad]} vs {want[bad]}")
    placed = sum(1 for d in decisions if d.ok)
    reps = sum(t.replicas for d in decisions if d.ok for t in d.targets)
    errs = sorted({d.error.split(" ")[0] for d in decisions if d.error})
    log(f"{label}: decisions identical to the cpu round on all {len(decisions)} rows "
        f"({placed} placed, {reps} replicas, error kinds {errs}); cpu round {cpu_s:.1f} s")


def check_compact_kernels(sched, bindings, dev, results):
    """Phase 3 for the compact round's kernels (B1, B2); returns their
    ms per round."""
    sel_args, k, t, tails = flagship_kernel_inputs(sched, bindings)
    B, C = sel_args[7].shape[0], sel_args[0].shape[0]
    n_tail = sum(int(idx.numel()) for idx, _, _ in tails)
    rng = np.random.default_rng(0)
    r_args = random_select_inputs(rng, dev, B, C)
    err = compare("candidate_select[random]",
                  kernels._select_launch(*r_args, k=k, plugin_bits=31),
                  kernels.select_plain(*r_args, k=k, plugin_bits=31), SELECT_OUT)
    r_tail = random_tail_inputs(rng, dev, n_tail, k, C)
    for has_agg, topk in ((True, 128), (False, 16), (True, 8)):
        err = max(err, compare(f"candidate_tail[random,{has_agg},{topk}]",
                               kernels._tail_launch(*r_tail, topk=topk, has_agg=has_agg),
                               kernels.tail_plain(*r_tail, topk=topk, has_agg=has_agg),
                               TAIL_OUT))
    log(f"random inputs (select {B}x{C} k={k}, tail {n_tail}x{k}): both compact kernels equal "
        "their plain versions (tolerance 0: integer outputs, compared exactly)")
    del r_args, r_tail
    for K in TAIL_CASE_KS:
        for case in TAIL_CASES:
            a = tail_case_inputs(rng, dev, TAIL_CASE_ROWS, K, C, case)
            for has_agg, topk in ((True, K if case == "topk = K" else 8), (False, 64)):
                err = max(err, compare(f"candidate_tail[{case}, K={K}, {has_agg}, {topk}]",
                                       kernels._tail_launch(*a, topk=topk, has_agg=has_agg),
                                       kernels.tail_plain(*a, topk=topk, has_agg=has_agg),
                                       TAIL_OUT))
            del a
    log(f"candidate_tail edge cases ({TAIL_CASE_ROWS} rows at K = {TAIL_CASE_KS}: "
        f"{', '.join(TAIL_CASES)}; with and without the Aggregated truncation) equal the plain "
        "version exactly")

    bits = sched._plugin_bits
    sel = kernels._select_launch(*sel_args, k=k, plugin_bits=bits)
    sel_err = compare("candidate_select[flagship]", sel,
                      kernels.select_plain(*sel_args, k=k, plugin_bits=bits), SELECT_OUT)
    t_args = [tail_args(sel, t, idx) for idx, _, _ in tails]
    t_outs = []
    tail_err = 0
    for a, (_, topk, has_agg) in zip(t_args, tails):
        out = kernels._tail_launch(*a, topk=topk, has_agg=has_agg)
        tail_err = max(tail_err, compare(f"candidate_tail[flagship,{has_agg}]", out,
                                         kernels.tail_plain(*a, topk=topk, has_agg=has_agg),
                                         TAIL_OUT))
        t_outs.append(out)
    sel_err = max(sel_err, compare("candidate_select[flagship, device-memory route]",
                                   kernels._select_launch(*sel_args, k=k, plugin_bits=bits,
                                                          route="wide"),
                                   kernels.select_plain(*sel_args, k=k, plugin_bits=bits),
                                   SELECT_OUT))
    x_args = sel_args[:-1] + [flagship_answers(np.random.default_rng(20), B, C, dev)]
    sel_err = max(sel_err, compare("candidate_select[flagship, extra_avail]",
                                   kernels._select_launch(*x_args, k=k, plugin_bits=bits),
                                   kernels.select_plain(*x_args, k=k, plugin_bits=bits),
                                   SELECT_OUT))
    del x_args
    log(f"compact flagship batch: select k={k} (also with a random extra_avail), tail rows "
        f"{[int(idx.numel()) for idx, _, _ in tails]}: both kernels equal their plain versions")

    err = max(err, check_select_edges(dev, C, k))
    sel_ms = min(ab_time("candidate_select, compact flagship", {
        "new": lambda: kernels._select_launch(*sel_args, k=k, plugin_bits=bits),
        "device-memory route": lambda: kernels._select_launch(*sel_args, k=k, plugin_bits=bits,
                                                              route="wide"),
    }, 10)["new"])
    sel_plain_ms = cuda_ms(lambda: kernels.select_plain(*sel_args, k=k, plugin_bits=bits), 3)

    def both_tails(fn):
        return lambda: [fn(*a, topk=topk, has_agg=h) for a, (_, topk, h) in zip(t_args, tails)]

    tail_ms = cuda_ms(both_tails(kernels._tail_launch), 20)
    tail_plain_ms = cuda_ms(both_tails(kernels.tail_plain), 3)
    tail_dev, _ = profiled_calls_ms(both_tails(kernels._tail_launch), 20)
    tail_host = host_enqueue_ms(both_tails(kernels._tail_launch), 20)
    sb, sb_by = select_bound(sel_args, sel, k)
    tb, tb_by = tail_bound(t_args, t_outs)
    results["candidate_select"] = dict(
        source="karmada_tpu_torch/kernels/csrc/candidate_select.cu",
        replaces="karmada_tpu/sched/candidates.py:210",
        max_abs_err=max(err, sel_err), ms=sel_ms, plain_ms=sel_plain_ms,
        bound_ms=sb, bound_by=sb_by, library_ms=None)
    results["candidate_tail"] = dict(
        source="karmada_tpu_torch/kernels/csrc/candidate_tail.cu",
        replaces="karmada_tpu/sched/candidates.py:280",
        max_abs_err=max(err, tail_err), ms=tail_ms, plain_ms=tail_plain_ms,
        bound_ms=tb, bound_by=tb_by, library_ms=None, device_ms=tail_dev)
    log(f"timing: select {sel_ms:.3f} ms (plain {sel_plain_ms:.3f}, bound {sb:.4f} {sb_by}); "
        f"tail, both launches of a round {tail_ms:.4f} ms (device {tail_dev:.4f} by the "
        f"profiler, host enqueue {tail_host:.4f}; plain {tail_plain_ms:.3f}, bound {tb:.4f} "
        f"{tb_by})")
    return sel_ms + tail_ms


def select_edge_inputs(rng, dev, case, B, C):
    """random_select_inputs with one edge of the window: "fewer feasible"
    (the affinity masks keep about 1 % of the columns, so most rows have
    fewer feasible columns than K), "none feasible" (every cluster dead);
    other cases as drawn (tie-heavy: the K-th value is shared with columns
    left out)."""
    args = random_select_inputs(rng, dev, B, C)
    names = FLEET + SELECT_BATCH
    if case == "fewer feasible":
        at = names.index("aff_masks")
        args[at] = torch.from_numpy(rng.random(tuple(args[at].shape)) < 0.012).to(dev)
    elif case == "none feasible":
        args[names.index("alive")].zero_()
    return args


def check_select_edges(dev, C, k):
    """candidate_select on seeded edge cases, both routes, against the
    plain version: heavy ties at the K-th value, fewer feasible columns
    than K, none feasible, K = C and a width that is no multiple of 32;
    then the selection alone (`_select_window_launch`) over int32 scores
    the filters never give (distinct over the whole int32 range, three
    tied values), all or no columns feasible, K = 1, 128 and C. Returns
    the largest error (0)."""
    rng = np.random.default_rng(31)
    err = 0
    for case, width, kk in (("ties at the K-th value", C, k), ("fewer feasible", C, k),
                            ("none feasible", C, k), ("K = C", 1007, 1007),
                            ("C % 32 != 0", C - 117, k)):
        args = select_edge_inputs(rng, dev, case, SELECT_EDGE_ROWS, width)
        want = kernels.select_plain(*args, k=kk, plugin_bits=31)
        for route in ("auto", "wide"):
            err = max(err, compare(f"candidate_select[{case}, C={width}, k={kk}, {route}]",
                                   kernels._select_launch(*args, k=kk, plugin_bits=31,
                                                          route=route), want, SELECT_OUT))
        counts = want[6]
        log(f"candidate_select edge '{case}' ({SELECT_EDGE_ROWS} x {width}, k={kk}): both routes "
            f"equal the plain version (feasible count per row {int(counts.min())}.."
            f"{int(counts.max())})")
        del args, want
    g = torch.Generator(device=dev)
    g.manual_seed(32)
    B = SELECT_EDGE_ROWS
    for label, width in (("flagship width", C), ("C % 32 != 0", C - 117)):
        for kind in ("distinct", "three values", "all feasible", "none feasible"):
            if kind == "distinct":
                score = torch.randint(-2**31, 2**31 - 1, (B, width), device=dev, generator=g,
                                      dtype=torch.int32)
                score[:, :2] = torch.tensor([-2**31, 2**31 - 1], dtype=torch.int32, device=dev)
            else:
                score = (torch.randint(0, 3, (B, width), device=dev, generator=g,
                                       dtype=torch.int32) * 6 - 5)
            p = {"all feasible": 1.0, "none feasible": 0.0}.get(kind, 0.6)
            feasible = torch.rand((B, width), device=dev, generator=g) < p
            for kk in (1, k, width):
                want = kernels.select_window_plain(feasible, score, kk)
                for route in ("auto", "wide"):
                    err = max(err, compare(
                        f"select_window[{label} {width}, {kind}, k={kk}, {route}]",
                        kernels._select_window_launch(feasible, score, kk, route=route), want,
                        ("cand_idx", "feas_count")))
    log(f"the selection alone ({B} rows at C = {C} and {C - 117}): distinct int32 scores over "
        "the whole range, three tied values, all and no columns feasible, K = 1, "
        f"{k} and C, both routes, equal the plain version")
    torch.cuda.empty_cache()
    return err


def check_dense_kernels(sched, bindings, dev, results):
    """Phase 3 for the dense round's kernels (B3, B4, B5', B6); returns
    their ms per dense flagship round."""
    filt_args, t, tails, mask_rows, mk, _ = dense_kernel_inputs(sched, bindings)
    B, C = filt_args[7].shape[0], filt_args[0].shape[0]
    rng = np.random.default_rng(1)

    # ---- seeded tie-heavy random inputs at the dense flagship shapes ----
    r_args = random_select_inputs(rng, dev, B, C)
    err_f = compare("dense_filter[random]", kernels._dense_filter_launch(*r_args, plugin_bits=31),
                    kernels.dense_filter_plain(*r_args, plugin_bits=31), FILTER_OUT)
    # the extra_mask channel (a per-row re-solve's spread selection)
    mask = torch.rand((B, C), device=dev) < 0.5
    err_f = max(err_f, compare(
        "dense_filter[random, extra_mask]",
        kernels._dense_filter_launch(*r_args, plugin_bits=31, extra_mask=mask),
        kernels.dense_filter_plain(*r_args, plugin_bits=31, extra_mask=mask), FILTER_OUT))
    del r_args, mask
    err_t = 0
    shapes = [(B, C, int(r.numel()), topk, h) for r, topk, h in tails]
    shapes += [(B, C, int(tails[1][0].numel()), 8, True), (B, C, int(tails[0][0].numel()), 0,
                                                            True),
               (64, WIDE_C, 48, 128, True), (64, WIDE_C, 48, 16, False), (64, WIDE_C, 48, 0,
                                                                          True)]
    for rb, rc, n, topk, has_agg in shapes:
        a = random_dense_tail_inputs(rng, dev, rb, rc, n)
        want = kernels.dense_tail_plain(*a, topk=topk, has_agg=has_agg)
        for route in tail_routes(rc):
            err_t = max(err_t, compare(
                f"dense_tail[random,{rc},{n},{topk},{has_agg},{route}]",
                kernels._dense_tail_launch(*a, topk=topk, has_agg=has_agg, route=route), want,
                TAIL_OUT))
        del a, want
    err_m, err_i = check_mask_kernels(dev, B, C, int(mask_rows.numel()), mk)
    log(f"random inputs (filter {B}x{C}, with and without extra_mask; tail "
        f"{[s[:4] for s in shapes]} (C, n, topk; topk 0: no window) on the shared-memory "
        f"route up to {kernels.MAX_TAIL_SMEM_COLS} columns and the re-reading route): the "
        "dense kernels equal their plain versions exactly")

    # ---- the dense flagship's own batch ----
    bits = sched._plugin_bits
    filt = kernels._dense_filter_launch(*filt_args, plugin_bits=bits)
    err_f = max(err_f, compare("dense_filter[flagship]", filt,
                               kernels.dense_filter_plain(*filt_args, plugin_bits=bits),
                               FILTER_OUT))
    t_args = [dense_tail_args(filt, t, rows) for rows, _, _ in tails]
    t_outs = []
    for a, (_, topk, has_agg) in zip(t_args, tails):
        out = kernels._dense_tail_launch(*a, topk=topk, has_agg=has_agg)
        want = kernels.dense_tail_plain(*a, topk=topk, has_agg=has_agg)
        err_t = max(err_t, compare(f"dense_tail[flagship,{has_agg}]", out, want, TAIL_OUT))
        err_t = max(err_t, compare(
            f"dense_tail[flagship,{has_agg},reread]",
            kernels._dense_tail_launch(*a, topk=topk, has_agg=has_agg, route="reread"), want,
            TAIL_OUT))
        t_outs.append(out)
    x_args = filt_args[:-1] + [flagship_answers(np.random.default_rng(21), B, C, dev)]
    err_f = max(err_f, compare("dense_filter[flagship, extra_avail]",
                               kernels._dense_filter_launch(*x_args, plugin_bits=bits),
                               kernels.dense_filter_plain(*x_args, plugin_bits=bits), FILTER_OUT))
    del x_args
    err_f = max(err_f, check_dense_filter_configs(dev, filt_args, bits))
    feas = filt[0]
    for k in (128, mk):  # idx: the main path's window
        idx = kernels._feas_idx_launch(feas, mask_rows, k)
        err_i = max(err_i, compare(f"feas_idx[flagship,{k}]", [idx],
                                   [kernels.feas_idx_plain(feas, mask_rows, k)], ("idx",)))
    err_m = max(err_m, compare("pack_rows[flagship]", [kernels._pack_rows_launch(feas, mask_rows)],
                               [kernels.pack_rows_plain(feas, mask_rows)], ("packed",)))
    log(f"dense flagship batch: filter {B}x{C} (also with a random extra_avail), tail rows "
        f"{[int(r.numel()) for r, _, _ in tails]} windows {[w for _, w, _ in tails]}, mask rows "
        f"{int(mask_rows.numel())} read in place (k={mk} and 128): the dense kernels equal their "
        "plain versions")

    # ---- timing on the dense flagship's own inputs ----
    f_ms = cuda_ms(lambda: kernels._dense_filter_launch(*filt_args, plugin_bits=bits), 10)
    f_plain = cuda_ms(lambda: kernels.dense_filter_plain(*filt_args, plugin_bits=bits), 3)
    f_dev, f_events = profiled_calls_ms(
        lambda: kernels._dense_filter_launch(*filt_args, plugin_bits=bits), 10)

    def both_tails(fn):
        return lambda: [fn(*a, topk=w, has_agg=h) for a, (_, w, h) in zip(t_args, tails)]

    t_ms = cuda_ms(both_tails(kernels._dense_tail_launch), 5)
    t_plain = cuda_ms(both_tails(kernels.dense_tail_plain), 3)
    tail_calls = [(a, {"topk": w, "has_agg": h}) for a, (_, w, h) in zip(t_args, tails)]
    ab_time("dense_tail, dense flagship round (both tails)",
            tail_variants(tail_calls, kernels._dense_tail_launch), 5,
            check=(TAIL_OUT * len(tail_calls), "new"))

    def feas_idx_call():
        return kernels._feas_idx_launch(feas, mask_rows, mk)

    i_ms = cuda_ms(feas_idx_call, 20)
    i_dev, i_events = profiled_calls_ms(feas_idx_call, 20)
    i_plain = cuda_ms(lambda: kernels.feas_idx_plain(feas, mask_rows, mk), 20)
    key = torch.where(feas.index_select(0, mask_rows.long()),
                      torch.arange(C, dtype=torch.int32, device=dev),
                      torch.tensor(kernels.FEAS_IDX_PAD, dtype=torch.int32, device=dev))
    if not torch.equal(torch.topk(key, mk, largest=False, sorted=True).values, idx):
        raise AssertionError("torch.topk disagrees with feas_idx on the flagship mask rows")
    i_lib = cuda_ms(lambda: torch.topk(key, mk, largest=False, sorted=True).values, 20)
    del key
    ib, ib_by = mask_bound(feas, mask_rows, idx, k=mk)
    pack = check_pack_rows_main_call(dev)
    fb, fb_by = dense_filter_bound(filt_args, filt)
    tb, tb_by = dense_tail_bound(filt, [r for r, _, _ in tails], t["weight_tables"], t_outs)
    csrc = "karmada_tpu_torch/kernels/csrc/"
    results["dense_filter"] = dict(
        source=csrc + "dense_filter.cu", replaces="karmada_tpu/sched/core.py:452",
        max_abs_err=err_f, ms=f_ms, plain_ms=f_plain, bound_ms=fb, bound_by=fb_by,
        library_ms=None, device_ms=f_dev)
    results["dense_tail"] = dict(
        source=csrc + "dense_tail.cu", replaces="karmada_tpu/sched/core.py:502",
        max_abs_err=err_t, ms=t_ms, plain_ms=t_plain, bound_ms=tb, bound_by=tb_by,
        library_ms=None)
    results["pack_rows"] = dict(
        source=csrc + "dense_mask.cu", replaces="karmada_tpu/sched/core.py:530",
        max_abs_err=max(err_m, pack["max_abs_err"]), library_ms=None,
        **{k: pack[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms")})
    results["feas_idx"] = dict(
        source=csrc + "dense_mask.cu", replaces="karmada_tpu/sched/core.py:539",
        max_abs_err=err_i, ms=i_ms, plain_ms=i_plain, bound_ms=ib, bound_by=ib_by,
        library_ms=i_lib, device_ms=i_dev)
    log(f"timing (dense flagship inputs): dense_filter {f_ms:.4f} ms (device {f_dev:.4f} by the "
        f"profiler: {_events_text(f_events)}; plain {f_plain:.3f}, bound {fb:.4f} {fb_by}); "
        f"dense_tail, both launches of a round {t_ms:.3f} ms (plain "
        f"{t_plain:.3f}, bound {tb:.4f} {tb_by}); feas_idx over the {int(mask_rows.numel())} "
        f"mask rows at k={mk} {i_ms:.4f} ms (device {i_dev:.4f} by the profiler: "
        f"{_events_text(i_events)}; plain {i_plain:.4f}, torch.topk {i_lib:.4f}, bound "
        f"{ib:.4f} {ib_by})")
    return f_ms + t_ms + i_ms


def random_mask_inputs(rng, dev, B, C, n):
    """Seeded filter rows bool [B, C] from empty to full (every 7th row
    sparse, row 0 all false, row 1 all true) and n int32 ids of them out
    of order and repeated (an eighth of the ids twice; rows 0 and 1
    among them)."""
    m = rng.random((B, C), dtype=np.float32) < rng.random((B, 1), dtype=np.float32)
    m[::7] = rng.random(m[::7].shape, dtype=np.float32) < 0.003
    m[0], m[1] = False, True
    rows = rng.permutation(B)[:n].astype(np.int32)
    rows[-(n // 8):] = rows[:n // 8]
    rows[:2] = (1, 0)
    return torch.from_numpy(m).to(dev), torch.from_numpy(rows).to(dev)


def check_mask_kernels(dev, B, C, n, mk):
    """pack_rows and feas_idx (k = mk and 128, or C where narrower) against
    their plain versions on seeded filter rows read through n row ids, at
    the dense flagship's width C, at MASK_SCALAR_WIDTHS (the scalar routes)
    and with the filter rows one byte off a 16-byte boundary. Returns their
    largest errors (0, 0)."""
    rng = np.random.default_rng(18)
    err_m = err_i = 0
    for width in (C,) + MASK_SCALAR_WIDTHS:
        feas, rows = random_mask_inputs(rng, dev, B, width, n)
        cases = [("", feas)]
        if width == C:
            cases.append((", off alignment", off_alignment(feas)))
        for tag, f in cases:
            label = f"random {B}x{width}{tag}"
            err_m = max(err_m, compare(f"pack_rows[{label}]", [kernels._pack_rows_launch(f, rows)],
                                       [kernels.pack_rows_plain(f, rows)], ("packed",)))
            for k in (min(mk, width), min(128, width)):
                err_i = max(err_i, compare(
                    f"feas_idx[{label}, k={k}]", [kernels._feas_idx_launch(f, rows, k)],
                    [kernels.feas_idx_plain(f, rows, k)], ("idx",)))
        del feas, rows, cases
    log(f"mask kernels on seeded filter rows ({B} x {(C,) + MASK_SCALAR_WIDTHS}, also off a "
        f"16-byte boundary) through {n} row ids out of order and repeated, k = {mk} and 128: "
        "pack_rows and feas_idx equal their plain versions exactly")
    torch.cuda.empty_cache()
    return err_m, err_i


def check_pack_rows_main_call(dev):
    """pack_rows on the call one whole-fleet Duplicated round makes
    (captured at launch): held against its plain version, then timed by
    CUDA events and torch.profiler beside its plain version and bound."""
    clusters, bindings = build_flagship(dense=True, whole_fleet_dup=True)
    sched = ArrayScheduler(clusters, device=dev)
    with captured_launches(("pack_rows",)) as cap:
        sched.schedule(bindings)
    del sched, clusters, bindings
    (args, _), = cap["pack_rows"]
    feas, rows = args
    packed = kernels._pack_rows_launch(feas, rows)
    err = compare("pack_rows[whole-fleet Duplicated]", [packed],
                  [kernels.pack_rows_plain(feas, rows)], ("packed",))

    def call():
        return kernels._pack_rows_launch(feas, rows)

    ms = cuda_ms(call, 20)
    dev_ms, events = profiled_calls_ms(call, 20)
    plain = cuda_ms(lambda: kernels.pack_rows_plain(feas, rows), 20)
    pb, pb_by = mask_bound(feas, rows, packed)
    log(f"pack_rows on the whole-fleet Duplicated round's call ({int(rows.numel())} of "
        f"{feas.shape[0]} filter rows x {feas.shape[1]}) equals its plain version; "
        f"{ms:.4f} ms (device {dev_ms:.4f} by the profiler: {_events_text(events)}; plain "
        f"{plain:.4f}, bound {pb:.4f} {pb_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": pb, "bound_by": pb_by,
            "device_ms": dev_ms}


@contextlib.contextmanager
def strict_solve_stage():
    """Inside the block the solve stage of every dense and compact round
    (`ArrayScheduler._solve_partitioned`, `candidates._solve_candidates`)
    runs under torch.cuda.set_sync_debug_mode("error"): any call there that
    synchronises the stream with the host raises. Yields the number of
    solve stages run."""
    ran = [0]

    def strict(fn):
        def run(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                ran[0] += 1
        return run

    dense, compact = ArrayScheduler._solve_partitioned, cand_mod._solve_candidates
    ArrayScheduler._solve_partitioned = strict(dense)
    cand_mod._solve_candidates = strict(compact)
    try:
        yield ran
    finally:
        ArrayScheduler._solve_partitioned = dense
        cand_mod._solve_candidates = compact


def check_solve_syncs(label, sched, bindings, decisions, sample=SYNC_CHECK_SAMPLE):
    """One round of a cell with its solve stages under strict_solve_stage;
    its decisions must be the cell's: every row's key, error and affinity,
    and every `sample`-th row whole (a whole-fleet Duplicated row's 5 000
    targets are built only when read, which is most of the check's time)."""
    torch.cuda.synchronize()
    with strict_solve_stage() as ran:
        got = sched.schedule(bindings)

    def brief(d):
        return d.key, d.error, d.affinity_name

    if ([brief(d) for d in got] != [brief(d) for d in decisions]
            or [decision_view(d) for d in got[::sample]]
            != [decision_view(d) for d in decisions[::sample]]):
        raise AssertionError(f"{label}: the round under the sync check decided otherwise")
    log(f"{label}: {ran[0]} solve stage(s) of one round ran under "
        "torch.cuda.set_sync_debug_mode('error') without a stream sync")


def check_dense_filter_configs(dev, flag_args, bits):
    """dense_filter against its plain version on config 1's (3 clusters,
    padded to 8 columns) and config 2's (100, padded to 128) own batches,
    each also with a random extra_mask and a random answer matrix; on the
    scalar route (random inputs at C % 4 != 0, and with answers and mask
    one element off alignment); and on the dense flagship's batch at a
    tightened capacity (the tiered launch passes its own). Returns the
    largest error (0)."""
    rng = np.random.default_rng(22)
    err = 0
    for label, (clusters, bindings) in (("config 1", build_dup3()), ("config 2", build_static())):
        sched = ArrayScheduler(clusters, device=dev)
        batch = sched._pad(sched.batch_encoder.encode(bindings))
        t = batch_from_numpy({n: getattr(batch, n) for n in SELECT_BATCH}, dev)
        args = [sched._fleet_dev[n] for n in FLEET] + [t[n] for n in SELECT_BATCH] + [None]
        B, C = args[7].shape[0], args[0].shape[0]
        mask = torch.from_numpy(rng.random((B, C)) < 0.6).to(dev)
        answers = torch.from_numpy(rng.integers(-1, 40, (B, C)).astype(np.int32)).to(dev)
        for tag, a, m in (("", args, None), (", extra_mask", args, mask),
                          (", extra_avail", args[:-1] + [answers], None)):
            err = max(err, compare(f"dense_filter[{label}{tag}]",
                                   kernels._dense_filter_launch(*a, plugin_bits=bits,
                                                                extra_mask=m),
                                   kernels.dense_filter_plain(*a, plugin_bits=bits,
                                                              extra_mask=m), FILTER_OUT))
        log(f"dense_filter on {label}'s batch ({B} x {C}; alone, with a random extra_mask, "
            "with a random extra_avail) equals its plain version")
    for B, C in DENSE_FILTER_SCALAR_SHAPES:
        args = random_select_inputs(rng, dev, B, C)
        mask = torch.rand((B, C), device=dev) < 0.6
        err = max(err, compare(f"dense_filter[random {B} x {C}, extra_mask]",
                               kernels._dense_filter_launch(*args, plugin_bits=bits,
                                                            extra_mask=mask),
                               kernels.dense_filter_plain(*args, plugin_bits=bits,
                                                          extra_mask=mask), FILTER_OUT))
    B, C = DENSE_FILTER_SCALAR_SHAPES[0][0], 4096
    args = random_select_inputs(rng, dev, B, C)
    flat = torch.full((B * C + 1,), -1, dtype=torch.int32, device=dev)
    flat[1:] = torch.randint(-1, 40, (B * C,), device=dev, dtype=torch.int32)
    args[-1] = flat[1:].view(B, C)
    mflat = torch.rand((B * C + 1,), device=dev) < 0.6
    mask = mflat[1:].view(B, C)
    err = max(err, compare(f"dense_filter[random {B} x {C}, answers and mask off alignment]",
                           kernels._dense_filter_launch(*args, plugin_bits=bits, extra_mask=mask),
                           kernels.dense_filter_plain(*args, plugin_bits=bits, extra_mask=mask),
                           FILTER_OUT))
    log(f"dense_filter on random inputs at {DENSE_FILTER_SCALAR_SHAPES} (C % 4 != 0) and with "
        f"answers and mask one element off alignment ({B} x {C}): the scalar route equals the "
        "plain version")
    tight = list(flag_args)
    tight[1] = flag_args[1] * 2 // 3 - 1
    err = max(err, compare("dense_filter[flagship, tightened capacity]",
                           kernels._dense_filter_launch(*tight, plugin_bits=bits),
                           kernels.dense_filter_plain(*tight, plugin_bits=bits), FILTER_OUT))
    return err


def random_group_inputs(rng, dev, B, C, S, neg_share=0.125):
    """Seeded tie-heavy group-score inputs: [B, C] filter outputs with few
    distinct scores and availabilities (so the name rank decides most
    orders), S row ids with repeats, need and target from 0 to past a
    region's size, a third of the rows Duplicated, and a share of the rows
    with negative availability (the exact quadratic branch)."""
    feas = rng.random((B, C)) < 0.85
    score = rng.choice([0, 0, 50, 100], (B, C)).astype(np.int32)
    avail = rng.choice([0, 1, 1, 3, 9, 40], (B, C)).astype(np.int32)
    prev = np.where(rng.random((B, C)) < 0.02, 2, 0).astype(np.int32)
    odd = rng.random(B) < neg_share
    avail = np.where(odd[:, None] & (rng.random((B, C)) < 0.05), -7, avail).astype(np.int32)
    d = {
        "feasible": feas, "score": score, "avail": avail, "prev": prev,
        "rows": rng.integers(0, B, S).astype(np.int32),
        "replicas": rng.integers(1, 64, S).astype(np.int64),
        "need": rng.integers(1, 9, S).astype(np.int64),
        "target": rng.integers(0, 400, S).astype(np.int64),
        "duplicated": rng.random(S) < 0.33,
    }
    return list(batch_from_numpy(d, dev).values())


def random_selection_inputs(rng, dev, B, C, R, n):
    """Seeded spread-tail inputs over a layout of R regions: [B, C] filter
    outputs with few distinct values, n row ids, each row choosing about
    half the regions, dynamic / Aggregated / static rows with Steady and
    Fresh modes."""
    feas = rng.random((B, C)) < 0.8
    prev = np.where(rng.random((B, C)) < 0.03, rng.integers(1, 4, (B, C)), 0)
    assigned = np.where(feas, prev, 0).sum(-1)
    replicas = rng.integers(1, 129, B)
    mode = np.arange(B) % 4
    replicas = np.where(mode == 2, assigned, replicas)
    d = {
        "feasible": feas,
        "avail": rng.choice([0, 2, 2, 2, 7, 40], (B, C)).astype(np.int32),
        "prev": prev.astype(np.int32),
        "tie": rng.integers(0, 3, (B, C)).astype(np.int32),
        "rows": rng.integers(0, B, n).astype(np.int32),
        "chosen": rng.random((n, R)) < 0.5,
        "strategy": rng.choice([2, 3, 4, 4], B).astype(np.int32),
        "replicas": np.maximum(replicas, 1).astype(np.int32),
        "fresh": mode == 3,
    }
    return batch_from_numpy(d, dev)


def random_combo_inputs(rng, dev, S, R):
    """Seeded tie-heavy group matrices: weights on a coarse grid, small
    values, absent regions."""
    d = {
        "weight": (rng.integers(0, 6, (S, R)) * 1000 + rng.integers(0, 2, (S, R))).astype(np.int64),
        "value": np.where(rng.random((S, R)) < 0.1, 0, rng.integers(1, 5, (S, R))).astype(np.int32),
    }
    return batch_from_numpy(d, dev)


def group_work(args, outs):
    """Bytes: the four filter outputs of each row's region members read
    once (13 bytes a member), the layout and row parameters, every output
    written once. Operations: ~20 integer operations per member (sums,
    compares, the prefix)."""
    S, Cp = args[4].numel(), args[9].numel()
    return S * Cp * 13 + nbytes(args[4:]) + nbytes(outs), S * Cp * 20


def selection_work(feas, rows, chosen, rid, outs, per_col_bytes, ops_per_col):
    """Bytes: per_col_bytes of filter outputs per selected row and column,
    the row's chosen regions and the region ids once, every output written
    once. Operations: ops_per_col per row and column."""
    n, C = rows.numel(), feas.shape[1]
    return (n * C * per_col_bytes + nbytes([rows, chosen, rid]) + nbytes(outs),
            n * C * ops_per_col)


def packed_selection_work(args, outs):
    return selection_work(*args, outs, 1, 1)


def spread_tail_work(args, outs):
    feas, _avail, _prev, _tie, rows, chosen, rid = args[:7]
    return selection_work(feas, rows, chosen, rid, outs, 13, 40)


def combo_work(args, outs):
    """Operations: per (row, combination) about 4 per member slot and 10
    more (the sums, presence, recorded-path test and compares); bytes: the
    inputs, the table and the outputs once."""
    S = args[0].shape[0]
    K, L = args[4].shape
    return nbytes(args) + nbytes(outs), S * K * (4 * L + 10)


# kernel -> (source, replaced program, outputs, bytes-and-operations model,
# position of the row-id / row argument); the launch and plain functions are
# kernels._<name>_launch and kernels.<name>_plain
SPREAD_KERNELS = {
    "group_score": ("group_score.cu", "karmada_tpu/sched/spread_batch.py:190", GROUP_OUT,
                    group_work, 4),
    "packed_selection": ("dense_mask.cu", "karmada_tpu/sched/spread_batch.py:448",
                         ("packed",), packed_selection_work, 1),
    "spread_tail": ("dense_tail.cu", "karmada_tpu/sched/spread_batch.py:455", SPREAD_TAIL_OUT,
                    spread_tail_work, 4),
    "combo_select": ("combo_select.cu", "karmada_tpu/sched/spread_batch.py:859", COMBO_OUT,
                     combo_work, 0),
}


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


@contextlib.contextmanager
def captured_launches(names):
    """Inside the block every launch of the kernels `names` also records a
    copy of its arguments (tensors cloned at launch time): {kernel:
    [(args, keywords), ...]}. The counting wrappers are untouched."""
    calls = {n: [] for n in names}
    saved = {n: getattr(kernels, f"_{n}_launch") for n in names}

    def recorder(n, fn):
        def record(*args, **kw):
            calls[n].append(([_clone(a) for a in args], {k: _clone(v) for k, v in kw.items()}))
            return fn(*args, **kw)
        return record

    for n, fn in saved.items():
        setattr(kernels, f"_{n}_launch", recorder(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(kernels, f"_{n}_launch", fn)


def main_path_spread_calls(cell, build_cell, expect, dev):
    """One round of a spread cell on the card with its spread launches
    captured; their count per kernel must be the cell's per-round launch
    count. Returns (calls, the cell's layout tensors and host layout)."""
    clusters, bindings = build_cell()
    sched = ArrayScheduler(clusters, device=dev)
    with captured_launches(SPREAD_KERNELS) as calls:
        sched.schedule(bindings)
    torch.cuda.synchronize()
    got = {n: len(c) for n, c in calls.items()}
    want = {n: expect.get(n, 0) for n in SPREAD_KERNELS}
    if got != want:
        raise AssertionError(f"{cell}: one round launched {got}, expected {want}")
    return calls, sched._layout_dev, sched._spread_layout


def run_calls(n, calls, plain=False, fresh_out=True):
    """Each recorded call of kernel `n` (or its plain version). An `out`
    buffer the call writes in place is cloned first unless `fresh_out` is
    off (timing), so the kernel and its plain version never share one."""
    fn = getattr(kernels, f"{n}_plain" if plain else f"_{n}_launch")
    outs = []
    for args, kw in calls:
        if fresh_out and kw.get("out") is not None:
            kw = {**kw, "out": kw["out"].clone()}
        outs.append(fn(*args, **kw))
    return [o if isinstance(o, tuple) else (o,) for o in outs]


def check_spread_kernels(dev, results):
    """Phase 3 for the spread kernels (B8, B9a, B9b, B10): first on the
    arguments the main path itself passes them in one round of config 4,
    config 4b and the drain cell (each kernel's time, plain time and bound
    per round come from config 4's round, combo_select's from the drain's),
    then on seeded tie-heavy inputs over those layouts."""
    rng = np.random.default_rng(2)
    errs = dict.fromkeys(SPREAD_KERNELS, 0)

    # ---- the main path's own arguments ----
    captured, lays, layouts = {}, {}, {}
    for cell, build_cell, expect in SPREAD_CELLS:
        if cell == "window":  # launches no spread kernel
            continue
        calls, lays[cell], layouts[cell] = main_path_spread_calls(cell, build_cell, expect, dev)
        rows = {}
        for n, cs in calls.items():
            _, _, fields, _, row_arg = SPREAD_KERNELS[n]
            wants = run_calls(n, cs, plain=True)
            for i, (got, want) in enumerate(zip(run_calls(n, cs), wants)):
                errs[n] = max(errs[n], compare(f"{n}[{cell} round, call {i}]", got, want, fields))
            if n == "group_score":  # its re-reading route too
                for i, ((args, kw), want) in enumerate(zip(cs, wants)):
                    errs[n] = max(errs[n], compare(
                        f"group_score[{cell} round, call {i}, reread]",
                        kernels._group_score_launch(*args, **kw, route="reread"), want, fields))
            if cs:
                rows[n] = [int(args[row_arg].shape[0]) for args, _ in cs]
        log(f"{cell}: one round's spread launches (rows per call {rows}) equal their plain "
            "versions exactly on the main path's own arguments")
        captured[cell] = calls

    timing = {}
    for cell in captured:
        parts = []
        for n, cs in captured[cell].items():
            if not cs:
                continue
            outs = run_calls(n, cs)
            work = SPREAD_KERNELS[n][3]
            moved, ops = map(sum, zip(*(work(a, o) for (a, _), o in zip(cs, outs))))
            b, by = bound(moved, ops)
            if n == "group_score":  # the staged route against the re-reading one
                ms = min(ab_time(f"group_score, {cell} round", {
                    "new": lambda: run_calls(n, cs),
                    "reread route": lambda: [kernels._group_score_launch(*a, **kw, route="reread")
                                             for a, kw in cs],
                }, 10)["new"])
            else:
                ms = cuda_ms(lambda: run_calls(n, cs), 10)
            plain = cuda_ms(lambda: run_calls(n, cs, plain=True), 3)
            timing[(cell, n)] = (ms, plain, b, by)
            parts.append(f"{n} {ms:.4f} ms (plain {plain:.4f}, bound {b:.4f} {by})")
            if n == "spread_tail":
                for i, (args, kw) in enumerate(cs):
                    errs[n] = max(errs[n], compare(
                        f"spread_tail[{cell} round, call {i}, reread]",
                        kernels._spread_tail_launch(*args, **kw, route="reread"),
                        kernels.spread_tail_plain(*args, **kw), SPREAD_TAIL_OUT))
                if cell == "config 4":
                    ab_time("spread_tail, config 4 round",
                            tail_variants(cs, kernels._spread_tail_launch), 10,
                            check=(SPREAD_TAIL_OUT * len(cs), "new"))
        log(f"timing ({cell} round, the main path's arguments, per round): " + "; ".join(parts))
    # B9a on config 4's call and the drain's, B10 on the drain's: device
    # time under torch.profiler and the host's enqueue, per round
    device_host = {}
    for cell, n in (("config 4", "packed_selection"), ("drain", "packed_selection"),
                    ("drain", "combo_select")):
        cs = captured[cell][n]
        device_host[(cell, n)] = (profiled_calls_ms(lambda: run_calls(n, cs), 10)[0],
                                  host_enqueue_ms(lambda: run_calls(n, cs), 10))
        log(f"{n}, {cell} round: device {device_host[(cell, n)][0]:.4f} ms, host enqueue "
            f"{device_host[(cell, n)][1]:.4f} ms")
    drain_rows = sum(int(a[1].shape[0]) for a, _ in captured["drain"]["packed_selection"])
    del captured
    torch.cuda.empty_cache()

    # ---- seeded tie-heavy inputs: B8, both routes ----
    C = lays["config 4"]["rid"].numel()

    def region_layout(region_id):
        n = int(region_id.max()) + 1
        return spread_batch.RegionLayout(
            region_id.astype(np.int32), [f"region-{i:02d}" for i in range(n)],
            rng.permutation(len(region_id)).astype(np.int32)).tensors(dev)

    stage = kernels.MAX_GROUP_STAGE
    one_col = rng.integers(-1, 16, C)
    one_col[one_col == 16] = -1
    one_col[rng.integers(C)] = 16  # region 16 holds one column
    past = np.where(np.arange(C) < stage + 1, 0, rng.integers(1, 16, C))  # one region past it
    for label, lay, width, neg in [
            ("config 4", lays["config 4"], C, 0.125),
            ("config 4b", lays["config 4b"], C, 0.125),
            ("config 4, non-negative", lays["config 4"], C, 0.0),
            ("a one-column region", region_layout(one_col), C, 0.125),
            (f"a region of {stage + 1} columns", region_layout(past), C, 0.125),
            (f"whole fleet, {stage} columns", region_layout(np.zeros(stage, np.int64)), stage,
             0.125),
            (f"whole fleet, {WIDE_C} columns", region_layout(np.zeros(WIDE_C, np.int64)), WIDE_C,
             0.125)]:
        a = random_group_inputs(rng, dev, 2 * SPREAD_REPS, width, SPREAD_REPS, neg_share=neg)
        a += [lay[k] for k in LAYOUT]
        want = kernels.group_score_plain(*a)
        for route in ("auto", "reread"):
            errs["group_score"] = max(errs["group_score"], compare(
                f"group_score[random, {label}, {route}]",
                kernels._group_score_launch(*a, route=route), want, GROUP_OUT))
        del a, want
    log(f"group_score: {SPREAD_REPS} random rows over the config-4 and config-4b layouts, a "
        f"one-column region, a region of {stage + 1} columns (past the staged route's "
        f"{stage}) and whole-fleet regions of {stage} and {WIDE_C} columns (1 row in 8 with "
        "negative availability) equal the plain version exactly on both routes")

    # ---- B9a packed_selection, B9b spread_tail ----
    lay4 = lays["config 4"]
    R = lay4["seg_start"].numel()
    d = random_selection_inputs(rng, dev, 2 * SPREAD_REPS, C, R, SPREAD_REPS)
    sel = (d["feasible"], d["rows"], d["chosen"], lay4["rid"])
    errs["packed_selection"] = max(errs["packed_selection"], compare(
        "packed_selection[random, config 4]", [kernels._packed_selection_launch(*sel)],
        [kernels.packed_selection_plain(*sel)], ("packed",)))
    t_args = [d[k] for k in ("feasible", "avail", "prev", "tie", "rows", "chosen")] + [
        lay4["rid"]] + [d[k] for k in ("strategy", "replicas", "fresh")]
    for topk, has_agg in ((32, True), (128, False)):
        errs["spread_tail"] = max(errs["spread_tail"], compare(
            f"spread_tail[random, config 4,{topk},{has_agg}]",
            kernels._spread_tail_launch(*t_args, topk=topk, has_agg=has_agg),
            kernels.spread_tail_plain(*t_args, topk=topk, has_agg=has_agg), SPREAD_TAIL_OUT))
    log(f"packed_selection and spread_tail: {SPREAD_REPS} random rows x {C} columns over the "
        "config-4 layout equal their plain versions exactly")
    del d, sel, t_args
    errs["packed_selection"] = max(errs["packed_selection"], check_selection_edges(rng, dev))

    # ---- B10 combo_select, then select_regions_batch through it ----
    table = spread_batch._combos(R, 3, 5)
    members_pad, sizes = table.tensors(dev)
    cd = random_combo_inputs(rng, dev, COMBO_ROWS, R)
    kmax_row = torch.from_numpy(rng.integers(3, 6, COMBO_ROWS).astype(np.int32)).to(dev)
    rname = torch.from_numpy(rng.permutation(R).astype(np.int32)).to(dev)
    c_args = (cd["weight"], cd["value"], kmax_row, rname, members_pad, sizes)
    for cmin in (3, 8):
        errs["combo_select"] = max(errs["combo_select"], compare(
            f"combo_select[random, config 4 table, cmin={cmin}]",
            kernels._combo_select_launch(*c_args, cmin=cmin, kmin=3),
            kernels.combo_select_plain(*c_args, cmin=cmin, kmin=3), COMBO_OUT))
    small = spread_batch._combos(10, 1, 10).tensors(dev)  # 7 * L > 62: no packed key
    cs = random_combo_inputs(rng, dev, 256, 10)
    s_args = (cs["weight"], cs["value"], torch.full((256,), 10, dtype=torch.int32, device=dev),
              rname[:10].argsort().to(torch.int32), *small)
    errs["combo_select"] = max(errs["combo_select"], compare(
        "combo_select[random, 10 regions, L=10]",
        kernels._combo_select_launch(*s_args, cmin=5, kmin=1),
        kernels.combo_select_plain(*s_args, cmin=5, kmin=1), COMBO_OUT))
    for label, table_t, R_t, kmin, kmax_hi in (("config 4 table", (members_pad, sizes), R, 3, 6),
                                               ("10 regions, L=10", small, 10, 1, 11)):
        td = tied_combo_inputs(rng, dev, COMBO_ROWS // 4, R_t)
        t_args = (td["weight"], td["value"], torch.from_numpy(rng.integers(
            kmin, kmax_hi, COMBO_ROWS // 4).astype(np.int32)).to(dev), rname[:R_t].argsort().to(
            torch.int32), *table_t)
        for cmin in (2, 4):
            errs["combo_select"] = max(errs["combo_select"], compare(
                f"combo_select[tied, {label}, cmin={cmin}]",
                kernels._combo_select_launch(*t_args, cmin=cmin, kmin=kmin),
                kernels.combo_select_plain(*t_args, cmin=cmin, kmin=kmin), COMBO_OUT))
    errs["combo_select"] = max(errs["combo_select"], check_combo_regions(rng, dev))
    W, V = cd["weight"].cpu().numpy(), cd["value"].cpu().numpy()
    W[:, 0] += np.arange(COMBO_ROWS)  # 4 096 distinct rows
    # rmax 4: the table C(16, 3..4) keeps 4 096 rows inside the device gate
    cfg = spread_batch.SpreadConfig(rmin=3, rmax=4, cmin=4, cmax=0, duplicated=False)
    before = kernels.launch_counts()["combo_select"]
    on_card = spread_batch.select_regions_batch(W, V, cfg, layouts["config 4"], on=dev)
    if kernels.launch_counts()["combo_select"] != before + 1:
        raise AssertionError("select_regions_batch on 4096 rows did not launch combo_select")
    host = spread_batch.select_regions_batch(W, V, cfg, layouts["config 4"], device=False)
    if not (np.array_equal(on_card.chosen, host.chosen) and on_card.errors == host.errors
            and sorted(on_card.fallback) == sorted(host.fallback)):
        raise AssertionError("select_regions_batch: the card's selection differs from the host's")
    log(f"combo_select: {COMBO_ROWS} random rows over the config-4 table C(16, 3..5) = "
        f"{len(table.members)} combinations (members read in place) and 256 rows at L = 10, "
        f"and {COMBO_ROWS // 4} rows of equal groups on each, equal the plain version; "
        f"select_regions_batch through it equals its host path on {COMBO_ROWS} distinct rows "
        f"({int(on_card.chosen.any(1).sum())} chosen, {len(on_card.errors)} errors, "
        f"{len(on_card.fallback)} fallback)")

    csrc = "karmada_tpu_torch/kernels/csrc/"
    for n, (src, repl, _, _, _) in SPREAD_KERNELS.items():
        cell = "drain" if n == "combo_select" else "config 4"
        ms, plain, b, by = timing[(cell, n)]
        results[n] = dict(source=csrc + src, replaces=repl, max_abs_err=errs[n],
                          ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)
        if (cell, n) in device_host:
            results[n].update(zip(("device_ms", "host_ms"), device_host[(cell, n)]))
    ms, plain, b, by = timing[("drain", "packed_selection")]
    results["packed_selection"].update(
        drain_ms=ms, drain_plain_ms=plain, drain_bound_ms=b, drain_bound_by=by,
        drain_device_ms=device_host[("drain", "packed_selection")][0],
        drain_host_ms=device_host[("drain", "packed_selection")][1], drain_rows=drain_rows)


def tied_combo_inputs(rng, dev, S, R):
    """Group matrices of equal groups: weights 4 000 or 5 000 and values
    1 (a few absent), so most combinations tie on (Σw, Σv) and the
    discovery key or the first index decides."""
    d = {
        "weight": np.where(rng.random((S, R)) < 0.8, 5000, 4000).astype(np.int64),
        "value": np.where(rng.random((S, R)) < 0.05, 0, 1).astype(np.int32),
    }
    return batch_from_numpy(d, dev)


def check_selection_edges(rng, dev):
    """packed_selection on seeded inputs at the edges of its routes:
    widths that are no multiple of 32 (SELECTION_EDGE_WIDTHS; 4 999, 13 and
    1 no multiple of 16 or 8 either: the scalar path), filter outputs off
    a 16-byte boundary (the scalar path), rows that chose no region, and a
    layout of SELECTION_WIDE_REGIONS regions (the choice read in place).
    Returns the largest error (0)."""
    err = 0
    cases = [(f"C={C}", C, 16, False, False) for C in SELECTION_EDGE_WIDTHS]
    cases += [("C=5120, off a 16-byte boundary", 5120, 16, True, False),
              ("C=5120, nothing chosen", 5120, 16, False, True),
              (f"C=5120, {SELECTION_WIDE_REGIONS} regions", 5120, SELECTION_WIDE_REGIONS, False,
               False)]
    for label, C, R, shifted, none in cases:
        n = 256 if R > 16 else SPREAD_REPS
        d = random_selection_inputs(rng, dev, 2 * n, C, R, n)
        feas, chosen = d["feasible"], d["chosen"]
        if shifted:
            feas = off_alignment(feas)
        if none:
            chosen = torch.zeros_like(chosen)
        rid = torch.from_numpy(rng.integers(0, R + 1, C).astype(np.int32)).to(dev)
        sel = (feas, d["rows"], chosen, rid)
        err = max(err, compare(f"packed_selection[{label}]", [kernels._packed_selection_launch(
            *sel)], [kernels.packed_selection_plain(*sel)], ("packed",)))
    log(f"packed_selection: seeded rows at widths {SELECTION_EDGE_WIDTHS}, off a 16-byte "
        f"boundary, with nothing chosen and over {SELECTION_WIDE_REGIONS} regions equal the "
        "plain version exactly")
    return err


def check_combo_regions(rng, dev):
    """combo_select past its former 64-region cap: every combination of
    one and of two regions of 65 and 200, and past the shared-memory
    regions (MAX_COMBO_SMEM_REGIONS) a random table of pairs and singles,
    against the plain version. Returns the largest error (0)."""
    err = 0
    for R in (65, 200):
        rname = torch.from_numpy(rng.permutation(R).astype(np.int32)).to(dev)
        for size in (1, 2):
            members_pad, sizes = spread_batch._combos(R, size, size).tensors(dev)
            S = COMBO_ROWS if R == 65 else COMBO_ROWS // 4
            cd = random_combo_inputs(rng, dev, S, R)
            kmax = torch.full((S,), size, dtype=torch.int32, device=dev)
            args = (cd["weight"], cd["value"], kmax, rname, members_pad, sizes)
            for cmin in (1, 4):
                err = max(err, compare(f"combo_select[R={R}, kmin=kmax={size}, cmin={cmin}]",
                                       kernels._combo_select_launch(*args, cmin=cmin, kmin=size),
                                       kernels.combo_select_plain(*args, cmin=cmin, kmin=size),
                                       COMBO_OUT))
    R = kernels.MAX_COMBO_SMEM_REGIONS + 52
    pairs = np.sort(np.stack([rng.choice(R, 2, replace=False) for _ in range(4000)]), 1)
    singles = np.stack([rng.choice(R, 96, replace=False), np.full(96, -1)], 1)
    members_pad = torch.from_numpy(np.concatenate([pairs, singles]).astype(np.int32)).to(dev)
    sizes = torch.from_numpy(np.array([2] * len(pairs) + [1] * 96, np.int32)).to(dev)
    cd = random_combo_inputs(rng, dev, COMBO_SCRATCH_ROWS, R)
    args = (cd["weight"], cd["value"],
            torch.full((COMBO_SCRATCH_ROWS,), 2, dtype=torch.int32, device=dev),
            torch.from_numpy(rng.permutation(R).astype(np.int32)).to(dev), members_pad, sizes)
    for cmin in (1, 4):
        err = max(err, compare(f"combo_select[R={R}, scratch route, cmin={cmin}]",
                               kernels._combo_select_launch(*args, cmin=cmin, kmin=1),
                               kernels.combo_select_plain(*args, cmin=cmin, kmin=1), COMBO_OUT))
    log(f"combo_select: {COMBO_ROWS} rows at R = 65 and {COMBO_ROWS // 4} at R = 200 over every "
        f"combination of one and of two regions, and {COMBO_SCRATCH_ROWS} rows at R = {R} "
        "(positions in the device scratch) equal the plain version")
    return err


# the launch wrappers the tier checks capture, and the launch counts of the
# tier cells (tier_consume counts its window mode apart)
TIER_KERNELS = ("tier_estimate", "tier_consume")
TIER_COUNTS = ("tier_estimate", "tier_consume", "tier_consume_window")
# tier_consume's mode in each tier cell: its kernel name and the reference
# line it replaces
CONSUME_MODES = {"tiers_dense": ("tier_consume", "karmada_tpu/sched/preemption.py:125"),
                 "tiers_compact": ("tier_consume_window", "karmada_tpu/sched/candidates.py:770")}
TIER_TIMING_REPS = 20  # rounds per CUDA-event window of the tier timings
# tier_consume's edge inputs on the card: (label, C, R, n, K)
TIER_CONSUME_EDGES = (
    ("C = 5 121", 5121, 4, 2560, 128),
    ("R = 1", 5120, 1, 2560, 128),
    ("R = 16, C = 5 121", 5121, 16, 700, 256),
    ("R = 17 (resource blocks of 16 and 1)", 5121, 17, 700, 256),
    ("one row", 5120, 4, 1, 128),
    ("all unscheduled", 5120, 4, 2560, 128),
    ("hot column", 5121, 4, 2560, 256),
    ("unaligned placed", 5120, 4, 2560, 128),
)


# tier_estimate's edge inputs on the card: (label, B, C, R, U, n, K), each
# in both modes (rows mode on both routes), with and without answers
TIER_ESTIMATE_EDGES = (
    ("C = 5 121, R = 17 (the scalar rows path)", 2048, 5121, 17, 8, 600, 128),
    ("R = 8", 2048, 5120, 8, 8, 600, 128),
    ("R = 16", 2048, 5120, 16, 8, 600, 128),
    ("every row distinct (U = B)", 2048, 5120, 4, 2048, 600, 128),
    ("a tier of one row", 2048, 5120, 4, 4, 1, 128),
    ("zero requests, capacities at and past INT32_MAX x req", 2048, 5120, 4, 6, 600, 128),
    ("columns without a summary", 2048, 5120, 4, 4, 600, 128),
    ("unknown requests", 2048, 5120, 4, 4, 600, 128),
    ("K = 13 (the scalar window path)", 2048, 5120, 4, 4, 600, 13),
)


class TierCall:
    """One captured call of a round's tier launcher (kernels.TierLauncher):
    the kernel, the launcher, the call's tensors cloned at launch and its
    keywords (a window-mode pair of main and speculative passes carries
    `reclaim`). `run` launches it again (uncounted), its plain version on
    the launcher's tensors, or with `split` a pair as the two launches it
    replaces; a rows-mode estimate writes a copy of the avail buffer
    unless `fresh_out` is off (timing: the launcher's own buffer).
    `torch_empty` hands a window estimate or a consumption outputs that
    torch.empty allocates at the call, in place of the launcher's."""

    def __init__(self, kernel, launcher, args, kw):
        self.kernel, self.launcher, self.args, self.kw = kernel, launcher, args, kw

    def run(self, plain=False, fresh_out=True, route="auto", split=False, torch_empty=False):
        L = self.launcher
        if self.kernel == "tier_consume":
            if plain:
                cap, placed, unsched, rows = self.args
                return kernels.tier_consume_plain(cap, placed, unsched, L.request, rows,
                                                  cand_idx=L.cand_idx)
            out = torch.empty((L.C, L.R), dtype=torch.int64, device=L.device) if torch_empty \
                else None
            return L.launch_consume(*self.args, out=out)
        window = None
        if torch_empty and L.cand_idx is not None:
            def window():
                return torch.empty((self.args[1].shape[0], L.K), dtype=torch.int32,
                                   device=L.device)
        if "reclaim" in self.kw:
            (cap, rows), rec, use = self.args, self.kw["reclaim"], self.kw["use_extra"]
            if plain:
                return (self.plain_estimate(cap, rows, use),
                        self.plain_estimate(cap + rec, rows, False))
            if split:
                return (L.launch_estimate(cap, rows, use_extra=use),
                        L.launch_estimate(cap + rec, rows, use_extra=False))
            return L.launch_estimate_pair(cap, rec, rows, use_extra=use,
                                          out=window and (window(), window()))
        out = None
        if L.cand_idx is None:
            out = L.avail.clone() if fresh_out else L.avail
        elif window:
            out = window()
        if plain:
            return self.plain_estimate(*self.args, self.kw["use_extra"], out)
        return L.launch_estimate(*self.args, out=out, route=route, **self.kw)

    def plain_estimate(self, cap, rows, use_extra, out=None):
        """tier_estimate_plain at `cap` over `rows` on the launcher's
        tensors (rows mode into `out`)."""
        L = self.launcher
        return kernels.tier_estimate_plain(
            cap, L.has_summary, L.req_unique, L.req_idx, L.replicas, L.unknown_request, rows,
            cand_idx=L.cand_idx, out=out, extra_avail=L.extra_avail if use_extra else None)

    def written(self, out):
        """The estimate's written part of its output, as a tuple (rows
        mode: the tier's rows of the buffer; a pair: both windows)."""
        if isinstance(out, tuple):
            return out
        if self.launcher.cand_idx is None:
            return (out.index_select(0, self.args[1].long()),)
        return (out,)

    def fields(self):
        return ("c_avail", "c_avail_speculative") if "reclaim" in self.kw else ("avail",)

    def uses_answers(self):
        return self.kw.get("use_extra", True) and self.launcher.extra_avail is not None


@contextlib.contextmanager
def captured_tier_calls():
    """Inside the block every tier launch of a round's launcher also
    records a TierCall: {"tier_estimate": [...], "tier_consume": [...]}.
    The launcher's counting methods are untouched."""
    calls = {n: [] for n in TIER_KERNELS}
    cls = kernels.TierLauncher
    est, pair, con = cls.launch_estimate, cls.launch_estimate_pair, cls.launch_consume

    def rec_est(self, cap, rows, **kw):
        calls["tier_estimate"].append(TierCall("tier_estimate", self, [cap.clone(), rows.clone()],
                                               {"use_extra": kw.get("use_extra", True)}))
        return est(self, cap, rows, **kw)

    def rec_pair(self, cap, reclaim, rows, **kw):
        calls["tier_estimate"].append(TierCall(
            "tier_estimate", self, [cap.clone(), rows.clone()],
            {"use_extra": kw.get("use_extra", True), "reclaim": reclaim.clone()}))
        return pair(self, cap, reclaim, rows, **kw)

    def rec_con(self, *args):
        calls["tier_consume"].append(TierCall("tier_consume", self, [_clone(a) for a in args], {}))
        return con(self, *args)

    cls.launch_estimate, cls.launch_estimate_pair, cls.launch_consume = rec_est, rec_pair, rec_con
    try:
        yield calls
    finally:
        cls.launch_estimate, cls.launch_estimate_pair, cls.launch_consume = est, pair, con


def tier_estimate_work(call):
    """Bytes: the estimates written once (rows mode: the tier's rows of the
    [B, C] buffer; window mode: [n, K]), the capacity, summary flags,
    unique requests and row ids read once, 9 bytes of row columns per row,
    the answers read at every element when the call min-merges them, in
    window mode the rows' candidate columns (a pair: both windows written
    and the reclaim read), and on the table route the [U, C] table written
    and read once. Operations: per evaluated entry (every element, twice
    for a pair, or the table's U x C) one division, compare and select per
    resource plus 8 clamps; per element on the table route 8."""
    L = call.launcher
    cap, rows = call.args
    n = rows.numel()
    C, R = cap.shape
    width = C if L.cand_idx is None else L.K
    moved = (n * width * 4 + nbytes([cap, L.has_summary, L.req_unique, rows]) + n * 9
             + (n * width * 4 if call.uses_answers() else 0))
    if "reclaim" in call.kw:  # a pair: the speculative window and the reclaim too
        return (moved + 2 * n * width * 4 + nbytes([call.kw["reclaim"]]),
                2 * n * width * (4 * R + 8))
    if L.cand_idx is not None:
        return moved + n * width * 4, n * width * (4 * R + 8)
    if kernels.estimate_route(L.U, n) == "table":
        return moved + 2 * L.U * C * 4, L.U * C * (4 * R + 8) + n * C * 8
    return moved, n * C * (4 * R + 8)


def tier_consume_work(call):
    """Bytes: the tier's placed matrix, flags and row ids read once, its
    rows' requests, the capacity read and written once (and the rows'
    candidate columns in window mode). Operations: a multiply and an add
    per placed entry and resource."""
    cap, placed, unsched, rows = call.args
    n, width = placed.shape
    C, R = cap.shape
    moved = nbytes([cap, placed, unsched, rows]) + n * R * 8 + C * R * 8
    if call.launcher.cand_idx is not None:
        moved += n * width * 4
    return moved, 2 * n * width * R


TIER_WORK = {"tier_estimate": tier_estimate_work, "tier_consume": tier_consume_work}


def random_tier_inputs(rng, dev, B, C, R, n, K):
    """Seeded tie-heavy tier inputs at the flagship shapes: capacities
    around zero and past INT32_MAX quotients, absent summaries, zero and
    absent requests, unknown requests; n distinct rows; placed matrices
    with few distinct values and most entries zero, unschedulable rows,
    memory-sized requests whose products pass 2**53, capacities the clamp
    zeroes."""
    U = 8
    cap = rng.integers(-10, 2_000_000, (C, R)).astype(np.int64)
    cap[::5, 0] = 0
    cap[::97] = 1 << 45
    req_u = rng.integers(0, 2000, (U, R)).astype(np.int64)
    req_u[0] = 0
    request = rng.integers(0, 3000, (B, R)).astype(np.int64)
    request[:, 1] = rng.integers(1 << 40, 1 << 41, B)
    ccap = rng.integers(0, 1 << 58, (C, R)).astype(np.int64)
    ccap[::3, 0] = rng.integers(0, 500, len(ccap[::3]))
    d = {
        "capacity": cap, "has_summary": rng.random(C) < 0.95, "req_unique": req_u,
        "req_idx": rng.integers(0, U, B).astype(np.int32),
        "replicas": rng.integers(0, 64, B).astype(np.int32),
        "unknown_request": rng.random(B) < 0.05,
        "rows": rng.permutation(B)[:n].astype(np.int32),
        "cand_idx": np.sort(rng.choice(C, (B, K)), axis=1).astype(np.int32),
        "placed": np.where(rng.random((n, C)) < 0.05, rng.integers(1, 4, (n, C)), 0).astype(
            np.int32),
        "placed_k": np.where(rng.random((n, K)) < 0.3, rng.integers(1, 9, (n, K)), 0).astype(
            np.int32),
        "unsched": rng.random(n) < 0.1, "request": request, "consume_cap": ccap,
    }
    return batch_from_numpy(d, dev)


def tier_consume_edge_inputs(rng, dev, label, C, R, n, K):
    """Seeded tier_consume inputs at one edge shape, for both modes:
    memory-sized requests in the last resource (sums past 2**53),
    capacities the clamp zeroes and negative ones; "all unscheduled"
    flags every row, "hot column" places every row on the last column
    (in every window too), "unaligned placed" hands the dense placed
    matrix over as a view 4 bytes past an aligned address."""
    B = n + 64
    cap = rng.integers(0, 1 << 58, (C, R)).astype(np.int64)
    cap[::3, 0] = rng.integers(0, 500, len(cap[::3]))
    cap[::11, -1] = -rng.integers(1, 1000, len(cap[::11]))
    request = rng.integers(0, 3000, (B, R)).astype(np.int64)
    request[:, -1] = rng.integers(1 << 40, 1 << 41, B)
    cand = np.sort(rng.choice(C, (B, K)), axis=1).astype(np.int32)
    placed = np.where(rng.random((n, C)) < 0.05, rng.integers(1, 4, (n, C)), 0).astype(np.int32)
    placed_k = np.where(rng.random((n, K)) < 0.3, rng.integers(1, 9, (n, K)), 0).astype(np.int32)
    unsched = rng.random(n) < 0.1
    if label == "all unscheduled":
        unsched[:] = True
    if label == "hot column":
        placed[:] = 0
        placed[:, -1] = rng.integers(1, 9, n)
        cand[:, -1] = C - 1
        placed_k[:] = 0
        placed_k[:, -1] = rng.integers(1, 9, n)
    d = batch_from_numpy({"cap": cap, "placed": placed, "placed_k": placed_k, "unsched": unsched,
                          "request": request, "rows": rng.permutation(B)[:n].astype(np.int32),
                          "cand_idx": cand}, dev)
    if label == "unaligned placed":
        buf = torch.empty(n * C + 1, dtype=torch.int32, device=dev)
        d["placed"] = buf[1:].view(n, C).copy_(d["placed"])
    return d


def edge_consume_launcher(e):
    """A round's TierLauncher over one tier_consume edge input set: its
    request table as the round's distinct requests (row b request b), every
    summary present."""
    B, R = e["request"].shape
    C, dev = e["cap"].shape[0], e["cap"].device
    e["avail"] = torch.zeros((B, C), dtype=torch.int32, device=dev)
    return kernels.TierLauncher(
        torch.ones(C, dtype=torch.bool, device=dev), e["request"],
        torch.arange(B, dtype=torch.int32, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev), request=e["request"])


def tier_estimate_edge_inputs(rng, dev, label, B, C, R, U, n, K):
    """Seeded tier_estimate inputs at one edge shape (TIER_ESTIMATE_EDGES):
    capacities around zero, negative ones and quotients past INT32_MAX;
    request 0 all zero (the "row's replicas" sentinel); the tier's n rows
    in random order; answers of -1, 0, below and far above the estimate.
    "every row distinct" gives row b request b; "zero requests" adds
    requests with zero resources and columns at INT32_MAX x req and one
    under; "columns without a summary" drops a third of the summaries,
    "unknown requests" flags a third of the rows."""
    cap = rng.integers(-10, 2_000_000, (C, R)).astype(np.int64)
    cap[::5, 0] = 0
    cap[3::11, -1] = -rng.integers(1, 1000, len(cap[3::11]))
    cap[::97] = 1 << 45
    req_u = rng.integers(1, 2000, (U, R)).astype(np.int64)
    req_u[0] = 0
    req_idx = rng.integers(0, U, B).astype(np.int32)
    if U == B:
        req_idx = rng.permutation(B).astype(np.int32)
    has_summary = rng.random(C) < 0.95
    unknown = rng.random(B) < 0.02
    if label.startswith("zero requests"):
        req_u[1, ::2] = 0  # some resources unrequested
        req_u[2] = [1] + [0] * (R - 1)
        i32 = 2**31 - 1
        for c0, u, dq in ((1, 3, 0), (2, 3, -1), (4, 2, 0), (6, 4, -1), (8, 5, 5)):
            cap[c0::13] = req_u[u] * i32 + dq
    if label == "columns without a summary":
        has_summary = rng.random(C) < 2 / 3
    if label == "unknown requests":
        unknown = rng.random(B) < 1 / 3
    answers = rng.choice([-1, 0, 1, 7, 60, 400, 1 << 20, 2**31 - 1], (B, C)).astype(np.int32)
    return batch_from_numpy({
        "capacity": cap, "has_summary": has_summary, "req_unique": req_u, "req_idx": req_idx,
        "replicas": rng.integers(0, 64, B).astype(np.int32), "unknown_request": unknown,
        "rows": rng.permutation(B)[:n].astype(np.int32),
        "cand_idx": rng.integers(0, C, (B, K)).astype(np.int32), "extra": answers}, dev)


def hold_tier_estimate(label, d):
    """tier_estimate on one input set (the ESTIMATE_ARGS, rows, cand_idx,
    extra) against its plain version, with and without the answers: the
    public wrapper in rows mode on both routes and in window mode, and a
    TierLauncher in both modes (the main path's calls). Returns the max
    abs error (0; a difference raises)."""
    est = [d[k] for k in ESTIMATE_ARGS] + [d["rows"]]
    B, C = d["req_idx"].shape[0], d["capacity"].shape[0]
    err = 0
    for extra, tag in ((None, ""), (d["extra"], ", answers")):
        def fresh():
            return torch.full((B, C), -5, dtype=torch.int32, device=d["capacity"].device)
        want_rows = kernels.tier_estimate_plain(*est, out=fresh(), extra_avail=extra)
        want_win = kernels.tier_estimate_plain(*est, cand_idx=d["cand_idx"], extra_avail=extra)
        for route in ("table", "element"):
            err = max(err, compare(f"tier_estimate[{label}, rows, {route}{tag}]",
                                   [kernels._tier_estimate_launch(*est, out=fresh(),
                                                                  extra_avail=extra,
                                                                  route=route)],
                                   [want_rows], ("avail",)))
        err = max(err, compare(f"tier_estimate[{label}, window{tag}]",
                               [kernels._tier_estimate_launch(*est, cand_idx=d["cand_idx"],
                                                              extra_avail=extra)],
                               [want_win], ("c_avail",)))
        launcher = kernels.TierLauncher(*[d[k] for k in ESTIMATE_ARGS[1:]], extra_avail=extra)
        err = max(err, compare(f"tier_estimate[{label}, launcher rows{tag}]",
                               [launcher.rows_mode(fresh()).launch_estimate(d["capacity"],
                                                                            d["rows"])],
                               [want_rows], ("avail",)))
        err = max(err, compare(f"tier_estimate[{label}, launcher window{tag}]",
                               [launcher.window_mode(d["cand_idx"]).launch_estimate(
                                   d["capacity"], d["rows"])], [want_win], ("c_avail",)))
    return err


def _short_event(name: str) -> str:
    """A device event's name without `void`, namespaces and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return re.sub(r"\b\w+::", "", name[:cut])[:60]


def profiled_calls_ms(fn, reps):
    """Device time per call of fn() over `reps` calls under torch.profiler
    (after one call outside it): (total ms, {event name: ms})."""
    fn()
    torch.cuda.synchronize()
    by = {k: us / 1e3 / reps
          for k, us in device_events_us(lambda: [fn() for _ in range(reps)]).items()}
    return sum(by.values()), by


def host_enqueue_ms(fn, reps):
    """Host time per call of fn() with no synchronisation in the window:
    how fast the host enqueues the calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _events_text(by, top=None) -> str:
    """Events and their ms, the longest first (the `top` longest)."""
    return ", ".join(f"{k} {v:.4f}"
                     for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top])


def consume_spread(call):
    """(nonzero placed entries, distinct columns they land on, the most
    entries on one column) of one captured tier_consume call: the window
    mode's atomics contend on the hottest columns."""
    cap, placed, _unsched, rows = call.args
    nz = placed != 0
    cand = call.launcher.cand_idx
    if cand is None:
        per_col = nz.sum(0)
    else:
        cols = cand.index_select(0, rows.long())[nz]
        per_col = torch.bincount(cols.long(), minlength=cap.shape[0])
    return int(nz.sum()), int((per_col > 0).sum()), int(per_col.max())


def tier_runs(cs, **kw):
    return [c.run(**kw) for c in cs]


def tier_timing(n, cs):
    """(ms, plain ms, bound ms, bound_by) per round of kernel n's captured
    calls cs (CUDA events)."""
    moved, ops = map(sum, zip(*(TIER_WORK[n](c) for c in cs)))
    b, by = bound(moved, ops)
    ms = cuda_ms(lambda: tier_runs(cs, fresh_out=False), TIER_TIMING_REPS)
    plain = cuda_ms(lambda: tier_runs(cs, plain=True, fresh_out=False), 3)
    return ms, plain, b, by


def estimate_timing(cs):
    """tier_estimate per round of one cell's captured calls cs (one mode):
    tier_timing's numbers, the device time under the profiler and the
    host's enqueue time. Returns (the numbers as the result line keys
    them, a log fragment)."""
    ms, plain, b, by = tier_timing("tier_estimate", cs)
    dev_ms, by_event = profiled_calls_ms(lambda: tier_runs(cs, fresh_out=False),
                                         TIER_TIMING_REPS)
    host = host_enqueue_ms(lambda: tier_runs(cs, fresh_out=False), TIER_TIMING_REPS)
    numbers = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, device_ms=dev_ms,
                   host_ms=host)
    pairs = sum("reclaim" in c.kw for c in cs)
    text = ""
    if cs[0].launcher.cand_idx is not None:
        text = "; " + outputs_ab(f"tier_estimate, {len(cs)} window-mode calls", cs)
    if pairs:  # the pairs against the two launches each replaces
        split_host = host_enqueue_ms(lambda: tier_runs(cs, fresh_out=False, split=True),
                                     TIER_TIMING_REPS)
        got = ab_time(f"tier_estimate, {len(cs)} calls of which {pairs} main + speculative "
                      "pairs, against each pair as two launches",
                      {"pairs": lambda: tier_runs(cs, fresh_out=False),
                       "two launches": lambda: tier_runs(cs, fresh_out=False, split=True)},
                      TIER_TIMING_REPS)
        text += (f"; {pairs} pairs: as two launches each {np.median(got['two launches']):.4f} "
                 f"ms, host enqueue {split_host:.4f}")
    return numbers, (f"tier_estimate {ms:.4f} ms, device {dev_ms:.4f} under the profiler "
                     f"({_events_text(by_event)}), host enqueue {host:.4f} (plain {plain:.4f}, "
                     f"bound {b:.4f} {by}){text}")


def outputs_ab(label, cs):
    """The captured calls cs with outputs cut from the launcher's blocks
    against outputs torch.empty allocates at each call, in turns (CUDA
    events), then each one's host enqueue. Returns a log fragment."""
    got = ab_time(f"{label}: outputs from the launcher's blocks against torch.empty each call",
                  {"blocks": lambda: tier_runs(cs, fresh_out=False),
                   "torch.empty": lambda: tier_runs(cs, fresh_out=False, torch_empty=True)},
                  TIER_TIMING_REPS)
    host = {n: host_enqueue_ms(lambda n=n: tier_runs(cs, fresh_out=False,
                                                      torch_empty=n == "torch.empty"),
                               TIER_TIMING_REPS) for n in got}
    return ("outputs " + ", ".join(f"{n} {np.median(xs):.4f} ms (host enqueue {host[n]:.4f})"
                                   for n, xs in got.items()))


def consume_timing(cs, dev):
    """tier_consume per round of one cell's captured calls cs (one mode):
    tier_timing's numbers, the library call's time (torch.mm in float64
    for the dense mode, exact only below 2**53; index_add_ for the window
    mode), the device time under the profiler (also by event) and the
    library call's, and the host's enqueue time of each. Returns
    (the numbers as the result line keys them, a log fragment)."""
    ms, plain, b, by = tier_timing("tier_consume", cs)
    L = cs[0].launcher
    if L.cand_idx is None:
        pq = [(c.args[1].double(), L.request.index_select(0, c.args[3].long()).double())
              for c in cs]

        def lib_call():
            return [torch.mm(p.t(), q) for p, q in pq]
        what = "torch.mm in float64"
    else:
        cv = []
        for c in cs:
            rows = c.args[3].long()
            req = L.request.index_select(0, rows)
            cols = L.cand_idx.index_select(0, rows).reshape(-1).long()
            cv.append((cols, (c.args[1].long()[:, :, None] * req[:, None, :]).reshape(
                -1, req.shape[1])))
        C, R = cs[0].args[0].shape

        def lib_call():
            return [torch.zeros((C, R), dtype=torch.int64, device=dev).index_add_(0, c, v)
                    for c, v in cv]
        what = "index_add_"
    lib = cuda_ms(lib_call, TIER_TIMING_REPS)
    total, by_event = profiled_calls_ms(lambda: tier_runs(cs, fresh_out=False), TIER_TIMING_REPS)
    lib_device, _ = profiled_calls_ms(lib_call, TIER_TIMING_REPS)
    host = host_enqueue_ms(lambda: tier_runs(cs, fresh_out=False), TIER_TIMING_REPS)
    lib_host = host_enqueue_ms(lib_call, TIER_TIMING_REPS)
    numbers = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                   device_ms=total, host_ms=host)
    return numbers, (
        f"tier_consume {ms:.4f} ms (plain {plain:.4f}, bound {b:.4f} {by}); its library call "
        f"({what}) {lib:.4f} ms; tier_consume device {total:.4f} ms under the profiler "
        f"({_events_text(by_event)}), the library call's {lib_device:.4f} ms; host enqueue "
        f"{host:.4f} ms, the library call's {lib_host:.4f} ms; "
        + outputs_ab(f"tier_consume, {len(cs)} calls", cs))


def hold_tier_calls(label, calls, errs, consume_name):
    """One round's captured tier calls against their plain versions (the
    rows-mode estimates on both routes too); errs[kernel] keeps the max."""
    for i, c in enumerate(calls["tier_estimate"]):
        want = c.written(c.run(plain=True))
        routes = ("table", "element") if c.launcher.cand_idx is None else ("auto",)
        for route in routes:
            errs["tier_estimate"] = max(errs["tier_estimate"], compare(
                f"tier_estimate[{label} round, call {i}, {route}]",
                c.written(c.run(route=route)), want, c.fields()))
    for i, c in enumerate(calls["tier_consume"]):
        errs[consume_name] = max(errs[consume_name], compare(
            f"{consume_name}[{label} round, call {i}]", [c.run()], [c.run(plain=True)],
            ("cap",)))


def check_tier_kernels(dev, results):
    """Phase 3 for the tier kernels (B11, B12's per-tier pieces): on seeded
    inputs at the flagship shapes in both modes, tier_estimate also at its
    edge shapes (TIER_ESTIMATE_EDGES) and tier_consume at its
    (TIER_CONSUME_EDGES); then on the calls one round of each tier cell
    makes through its launcher (captured at launch; the rows-mode
    estimates on both routes), with their time, device time, host enqueue,
    plain time and bound per round, the two routes of tiers_dense's
    estimate in turns, and tier_consume's library call (consume_timing).
    tiers_estimator's round is held and timed in its cell
    (run_tiers_estimator_cell), where its answers are built."""
    rng = np.random.default_rng(4)
    errs = dict.fromkeys(TIER_COUNTS, 0)
    B, C, K = shape_bucket(N_BINDINGS), shape_bucket(N_CLUSTERS), 128
    d = random_tier_inputs(rng, dev, B, C, 4, B // 4, K)
    d["extra"] = flagship_answers(rng, B, C, dev)
    errs["tier_estimate"] = hold_tier_estimate("random", d)
    con = (d["consume_cap"], d["placed"], d["unsched"], d["request"], d["rows"])
    errs["tier_consume"] = compare("tier_consume[random, dense]",
                                   [kernels._tier_consume_launch(*con)],
                                   [kernels.tier_consume_plain(*con)], ("cap",))
    con_k = (d["consume_cap"], d["placed_k"], d["unsched"], d["request"], d["rows"])
    errs["tier_consume_window"] = compare(
        "tier_consume[random, window]",
        [kernels._tier_consume_launch(*con_k, cand_idx=d["cand_idx"])],
        [kernels.tier_consume_plain(*con_k, cand_idx=d["cand_idx"])], ("cap",))
    log(f"random inputs ({B}x{C}, {B // 4} tier rows, window {K}): tier_estimate (with and "
        "without a random extra_avail, rows mode on both routes, the public wrapper and a "
        "launcher) and tier_consume equal their plain versions exactly in both modes")
    del d, con, con_k
    for label, eB, eC, eR, eU, en, eK in TIER_ESTIMATE_EDGES:
        e = tier_estimate_edge_inputs(rng, dev, label, eB, eC, eR, eU, en, eK)
        errs["tier_estimate"] = max(errs["tier_estimate"], hold_tier_estimate(label, e))
    log("edge inputs (" + "; ".join(f"{label}: B {eB}, C {eC}, R {eR}, U {eU}, n {en}, K {eK}"
                                   for label, eB, eC, eR, eU, en, eK in TIER_ESTIMATE_EDGES)
        + "): tier_estimate equals its plain version exactly in both modes, with and without "
        "answers of -1, 0 and past the estimate, rows mode on both routes")
    for label, C, R, n, K in TIER_CONSUME_EDGES:
        e = tier_consume_edge_inputs(rng, dev, label, C, R, n, K)
        launcher = edge_consume_launcher(e)
        for mode, name, placed, cand in (("dense", "tier_consume", e["placed"], None),
                                         (f"window K = {K}", "tier_consume_window",
                                          e["placed_k"], e["cand_idx"])):
            con = (e["cap"], placed, e["unsched"], e["request"], e["rows"])
            want = [kernels.tier_consume_plain(*con, cand_idx=cand)]
            if cand is None:
                launcher.rows_mode(e["avail"])
            else:
                launcher.window_mode(cand)
            for via, got in (("wrapper", kernels._tier_consume_launch(*con, cand_idx=cand)),
                             ("launcher", launcher.launch_consume(e["cap"], placed, e["unsched"],
                                                                  e["rows"]))):
                errs[name] = max(errs[name], compare(f"tier_consume[{label}, {mode}, {via}]",
                                                     [got], want, ("cap",)))
    log("edge inputs (" + "; ".join(f"{label}: C {C}, R {R}, n {n}, K {K}"
                                   for label, C, R, n, K in TIER_CONSUME_EDGES)
        + "): tier_consume equals its plain version exactly in both modes, through the public "
        "wrapper and a round's launcher")
    del e, con, launcher

    captured = {}
    for cell, duplicated, compact in TIER_CELLS:
        clusters, bindings, placed = build_tiers(duplicated=duplicated)
        sched = ArrayScheduler(clusters, device=dev)
        expect = tier_expect(sched, bindings, placed, compact)
        row_kernel = "tail" if compact else "dense_filter"  # B2's per-tier rows, B3
        with captured_launches((row_kernel,)) as row_calls, captured_tier_calls() as calls:
            tier_round(sched, bindings, placed)
        torch.cuda.synchronize()
        row_calls = row_calls[row_kernel]
        fields = TAIL_OUT if compact else FILTER_OUT
        name = "candidate_tail" if compact else "dense_filter"
        for i, (g, w) in enumerate(zip(run_calls(row_kernel, row_calls),
                                       run_calls(row_kernel, row_calls, plain=True))):
            e = compare(f"{name}[{cell} round, call {i}]", g, w, fields)
            if name in results:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
        log(f"{cell}: one round's {len(row_calls)} {name} launches (rows per call "
            f"{[int(a[0].shape[0]) if compact else int(a[7].shape[0]) for a, _ in row_calls]}) "
            "equal the plain version exactly on the main path's own arguments")
        del row_calls
        got = {n: len(c) for n, c in calls.items()}
        want = {"tier_estimate": expect["tier_estimate"],
                "tier_consume": expect.get("tier_consume", 0)
                + expect.get("tier_consume_window", 0)}
        if got != want:
            raise AssertionError(f"{cell}: one round launched {got}, expected {want}")
        hold_tier_calls(cell, calls, errs, CONSUME_MODES[cell][0])
        spread = [consume_spread(c) for c in calls["tier_consume"]]
        rows = {n: [int(c.args[1].shape[0] if n == "tier_estimate" else c.args[3].shape[0])
                    for c in cs] for n, cs in calls.items()}
        log(f"{cell}: one round's tier launches (rows per call {rows}, C x R "
            f"{tuple(calls['tier_consume'][0].args[0].shape)}, tier_consume's nonzero placed "
            "entries, the distinct columns they land on and the most on one column per call "
            f"{spread}) equal their plain versions exactly on the main path's own arguments "
            "(the rows-mode estimates on both routes)")
        captured[cell] = calls
        del sched, clusters, bindings, placed

    timing = {}
    for cell, calls in captured.items():
        cs = calls["tier_estimate"]
        timing[(cell, "tier_estimate")], est_text = estimate_timing(cs)
        if cs[0].launcher.cand_idx is None:
            ab_time(f"tier_estimate, {cell} round (rows mode, {len(cs)} launches), by route",
                    {r: (lambda r=r: tier_runs(cs, fresh_out=False, route=r))
                     for r in ("auto", "table", "element")}, TIER_TIMING_REPS)
        timing[cell], text = consume_timing(calls["tier_consume"], dev)
        mode = "rows" if cs[0].launcher.cand_idx is None else "window"
        log(f"timing ({cell} round, the main path's arguments, per round): {mode} mode, "
            f"{len(cs)} launches: {est_text}; {text}")
    del captured
    torch.cuda.empty_cache()
    csrc = "karmada_tpu_torch/kernels/csrc/tiers.cu"
    win = timing[("tiers_compact", "tier_estimate")]
    results["tier_estimate"] = dict(
        source=csrc, replaces="karmada_tpu/sched/preemption.py:125",
        max_abs_err=errs["tier_estimate"], library_ms=None,
        **timing[("tiers_dense", "tier_estimate")],
        **{f"window_{k}": v for k, v in win.items()},
        window_replaces="karmada_tpu/sched/candidates.py:770")
    for cell, (name, replaces) in CONSUME_MODES.items():
        results[name] = dict(source=csrc, replaces=replaces, max_abs_err=errs[name],
                             **timing[cell])


# --------------------------------------------------------------------------
# the estimator kernels (B14, B16) and the estimator cells
# --------------------------------------------------------------------------


def flagship_answers(rng, B, C, dev):
    """A registered-estimator answer matrix i32[B, C] at a flagship batch's
    shape: -1 (no answer) in 30 % of the cells, else 0 or values below and
    far above the general estimate."""
    a = rng.choice([0, 1, 7, 60, 400, 1 << 20], (B, C))
    a = np.where(rng.random((B, C)) < 0.3, -1, a).astype(np.int32)
    return torch.from_numpy(a).to(dev)


def fleet_args(members, names, reqs, dev):
    """The fleet kernel's arguments over MemberEstimators' snapshot of the
    concatenated node arrays (alloc, requested, pod_count, allowed,
    cluster_id, the cluster count, claimless_ok) with the [B, R] request
    matrix."""
    snap = MemberEstimators(members, device=dev)._fleet_snapshot(names)
    enc = NodeEncoder()
    request = np.stack([enc.request_vector(r.resource_request if r else {}) for r in reqs])
    return list(snap) + [torch.from_numpy(request.astype(np.int64)).to(dev)]


def fleet_main_args(members, names, reqs, dev):
    """The fleet kernel's arguments as max_available_replicas_rows passes
    them on the main path: the snapshot, the table of distinct requests,
    and as keywords each row's index into it (None when every row is
    distinct) and the snapshot's node ranges. Returns (args, keywords)."""
    est = MemberEstimators(members, device=dev)
    snap = est._fleet_snapshot(names)
    request_u, req_idx = distinct_requests(NodeEncoder(), reqs)
    idx = None if len(request_u) == len(req_idx) else torch.from_numpy(req_idx).to(dev)
    return (list(snap) + [torch.from_numpy(request_u).to(dev)],
            {"req_idx": idx, "node_off": est._fleet_off})


def random_fleet_args(rng, dev, C, B, R=4, shuffle=False):
    """Seeded node arrays, in cluster order unless `shuffle`: 0-5 nodes a
    cluster (every fifth without any), overcommitted nodes (requested >
    alloc), exhausted pod slots, tainted nodes (claimless_ok False), zero
    requests."""
    counts = rng.integers(0, 6, C)
    counts[::5] = 0
    cid = np.repeat(np.arange(C), counts).astype(np.int32)
    N = len(cid)
    alloc = rng.integers(0, 64_000, (N, R)).astype(np.int64)
    requested = (alloc * rng.uniform(0, 1.3, (N, R))).astype(np.int64)
    allowed = rng.integers(0, 120, N).astype(np.int64)
    pods = (allowed + rng.integers(-50, 5, N)).clip(0).astype(np.int64)
    ok = rng.random(N) < 0.8
    request = rng.choice([0, 1, 250, 1000, 7000], (B, R)).astype(np.int64)
    request[::4] = 0
    p = rng.permutation(N) if shuffle else np.arange(N)
    nodes = [torch.from_numpy(x[p]).to(dev) for x in (alloc, requested, pods, allowed, cid)]
    return nodes + [C, torch.from_numpy(ok[p]).to(dev), torch.from_numpy(request).to(dev)]


# int64 edge values of the fleet sweep's division: free capacities near
# +-2^62 and at 0 / 1, requests of 1, past the free capacity and near
# 2^63 - 1, pod slots past INT32_MAX (a node's cap then INT32_MAX, the
# cluster's sum past it)
EDGE_ALLOC = (-(2**62) - 5, -(2**62), -1, 0, 1, 7, 2**31 - 1, 2**31, 3 * (2**31 - 1),
              2**62 - 1, 2**62, 2**62 + 7)
EDGE_REQUESTED = (0, 1, 5, -3)
EDGE_REQUEST = (0, -1, 1, 3, 7, 1_000_000, 2**31 - 1, 2**62, 2**63 - 1)
EDGE_PODS = (0, 3, 110, 2**31 - 1, 2**31, 2**62)


def edge_fleet_args(rng, dev, C, B, R=4):
    """random_fleet_args' layout (in cluster order) over the int64 edge
    values above."""
    args = random_fleet_args(rng, dev, C, B, R)
    N = args[0].shape[0]
    pick = lambda pool, shape: torch.from_numpy(  # noqa: E731
        rng.choice(np.array(pool, np.int64), shape)).to(dev)
    args[0], args[1] = pick(EDGE_ALLOC, (N, R)), pick(EDGE_REQUESTED, (N, R))
    args[3] = pick(EDGE_PODS, N)
    args[2] = torch.minimum(pick(EDGE_PODS, N), args[3])
    args[-1] = pick(EDGE_REQUEST, (B, R))
    return args


def distinct_kw(args, dev, node_off=True):
    """The [B, R] request of `args` as a table of distinct rows and each
    row's index (the client's form); with `node_off`, the ranges of the
    nodes, which must lie in cluster order. Returns (args, keywords)."""
    request_u, inv = torch.unique(args[-1], dim=0, return_inverse=True)
    kw = {"req_idx": inv.to(torch.int32)}
    if node_off:
        cid = args[4].cpu().numpy()
        kw["node_off"] = torch.from_numpy(
            np.searchsorted(cid, np.arange(args[5] + 1)).astype(np.int32)).to(dev)
    return list(args[:-1]) + [request_u.contiguous()], kw


def dense_request(args, kw):
    """The [B, R] request matrix behind a call (the table gathered through
    the rows' index)."""
    idx = kw.get("req_idx")
    return args[-1] if idx is None else args[-1].index_select(0, idx.long())


def fleet_plain(args, kw=None):
    """The plain fleet estimate on the card in row chunks (one chunk at the
    flagship materialises 256 x 17 500 x 4 int64 per intermediate)."""
    *fleet, _ = args
    request = dense_request(args, kw or {})
    return torch.cat([kernels.fleet_estimate_plain(*fleet, request[i:i + PLAIN_ESTIMATE_ROWS])
                      for i in range(0, request.shape[0], PLAIN_ESTIMATE_ROWS)])


def fleet_work(args, out):
    """Bytes: every input read once, the [B, C] answers written once.
    Operations: one int64 division per (row, node, resource)."""
    return nbytes(args) + nbytes([out]), args[-1].shape[0] * args[0].shape[0] * args[0].shape[1]


def dynamic_rows(bindings):
    return [b for b, rb in enumerate(bindings)
            if strategy_code(rb.spec.placement, rb.spec.replicas) in (DYNAMIC_WEIGHT, AGGREGATED)]


def fixture_requests():
    """bench_estimator.py's batch: 12 distinct cpu x memory requests, 8
    times over (96 rows)."""
    GiB = 1024.0 ** 3
    return [ReplicaRequirements(resource_request={CPU: c, MEMORY: m * GiB})
            for c in (0.1, 0.25, 0.5, 1.0) for m in (0.5, 1.0, 2.0)] * 8


def check_estimator_kernels(dev, results, flag):
    """Phase 3 for B14 (fleet_estimate) and B16 (staleness_penalty):
    fleet_estimate on seeded node fleets with overcommitted nodes, zero
    requests, exhausted pod slots, tainted nodes and node-less clusters
    (nodes in cluster order and shuffled; rows as a [B, R] request, as a
    table of distinct requests with one (U = 1) or many, with and without
    the caller's node ranges; 5 000, 4 999 and 13 clusters; R = 17; int64
    edge values), on config 3's node fleet with its rows, on the flagship's
    node fleet with its 5 000 dynamic rows (both also in the form the
    estimator's sweep passes them: its distinct requests and node ranges)
    and on the reference estimator fixture (5 000 nodes, 100 000 pods) as
    one cluster; timed at the flagship sweep (with the caller's ranges and
    with the sort, and with every row distinct) and at config 3's;
    staleness_penalty through apply_staleness_penalty on a random i32
    [10 000, 5 000] matrix at ages 0-10."""
    rng = np.random.default_rng(30)
    err = 0
    base = random_fleet_args(rng, dev, N_CLUSTERS, 1024)
    one = list(base[:-1]) + [base[-1][3:4].expand(1024, -1).contiguous()]
    cases = [("random", base, {}),
             ("random, distinct requests", *distinct_kw(base, dev, node_off=False)),
             ("random, distinct requests and node ranges", *distinct_kw(base, dev)),
             ("random, one request (U = 1)", *distinct_kw(one, dev)),
             ("random, nodes shuffled", random_fleet_args(rng, dev, N_CLUSTERS, 1024,
                                                          shuffle=True), {}),
             ("random, 4 999 clusters", *distinct_kw(random_fleet_args(rng, dev, 4999, 512),
                                                     dev)),
             ("random, 13 clusters", random_fleet_args(rng, dev, 13, 77), {}),
             ("random, R = 17", random_fleet_args(rng, dev, N_CLUSTERS, 1024, R=17), {}),
             ("random, R = 17, distinct requests", *distinct_kw(
                 random_fleet_args(rng, dev, 999, 300, R=17), dev)),
             ("int64 edge values", edge_fleet_args(rng, dev, N_CLUSTERS, 512), {}),
             ("int64 edge values, distinct requests", *distinct_kw(
                 edge_fleet_args(rng, dev, 1001, 512), dev))]
    c3_clusters, c3_bindings = build_dynamic()
    c3_names = [c.name for c in c3_clusters]
    c3_members = estimator_members(c3_names)
    c3_reqs = [rb.spec.replica_requirements for rb in c3_bindings]
    c3_main = fleet_main_args(c3_members, c3_names, c3_reqs, dev)
    cases += [("config 3", fleet_args(c3_members, c3_names, c3_reqs, dev), {}),
              ("config 3, the sweep's form", *c3_main)]
    flag_reqs = [flag["bindings"][b].spec.replica_requirements
                 for b in dynamic_rows(flag["bindings"])]
    flag_args = fleet_args(flag["members"], flag["names"], flag_reqs, dev)
    flag_main = fleet_main_args(flag["members"], flag["names"], flag_reqs, dev)
    # every row distinct: the flagship's requests, each row's memory one
    # byte apart (its requests are 0 or whole MiB, so no two rows meet)
    spread = flag_args[-1].clone()
    spread[:, 1] += torch.arange(spread.shape[0], device=dev)
    flag_distinct = list(flag_args[:-1]) + [spread]
    cases += [("flagship", flag_args, {}), ("flagship, the sweep's form", *flag_main),
              ("flagship, every row distinct", flag_distinct,
               {"node_off": flag_main[1]["node_off"]})]
    t0 = time.perf_counter()
    fixture = build_estimator(*ESTIMATOR_FIXTURE)
    log(f"estimator fixture ({ESTIMATOR_FIXTURE[0]} nodes, {ESTIMATOR_FIXTURE[1]} pods) built "
        f"in {time.perf_counter() - t0:.1f} s")
    cases.append(("fixture", fleet_args({"fixture": Member(fixture)}, ["fixture"],
                                        fixture_requests(), dev), {}))
    for tag, args, kw in cases:
        got = kernels._fleet_estimate_launch(*args, **kw)
        err = max(err, compare(f"fleet_estimate[{tag}]", [got], [fleet_plain(args, kw)],
                               ("answers",)))
        if tag == "fixture" and got[:, 0].cpu().tolist() != fixture.max_available_replicas_batch(
                fixture_requests()):
            raise AssertionError("fleet_estimate[fixture] differs from the host estimator")
        log(f"fleet_estimate[{tag}]: {got.shape[0]} rows ({args[-1].shape[0]} distinct "
            f"requests) x {args[5]} clusters over {args[0].shape[0]} nodes equal the plain "
            f"version (answers {int(got.min())}..{int(got.max())}, {int((got == 0).sum())} "
            "zeros)")
    del cases, got
    # timed: the flagship sweep as the estimator passes it, with the sort
    # in place of its node ranges, with every row distinct; config 3's
    main_args, main_kw = flag_main
    out = kernels._fleet_estimate_launch(*main_args, **main_kw)
    ms = cuda_ms(lambda: kernels._fleet_estimate_launch(*main_args, **main_kw), 10)
    sort_kw = {"req_idx": main_kw["req_idx"]}
    ms_sort = cuda_ms(lambda: kernels._fleet_estimate_launch(*main_args, **sort_kw), 10)
    d_kw = {"node_off": main_kw["node_off"]}
    ms_distinct = cuda_ms(lambda: kernels._fleet_estimate_launch(*flag_distinct, **d_kw), 10)
    c3_out = kernels._fleet_estimate_launch(*c3_main[0], **c3_main[1])
    ms_c3 = cuda_ms(lambda: kernels._fleet_estimate_launch(*c3_main[0], **c3_main[1]), 10)
    plain = cuda_ms(lambda: fleet_plain(flag_args), 2)
    dev_main = sum(device_events_us(
        lambda: kernels._fleet_estimate_launch(*main_args, **main_kw)).values())
    dev_distinct = sum(device_events_us(
        lambda: kernels._fleet_estimate_launch(*flag_distinct, **d_kw)).values())
    b, by = bound(*fleet_work(flag_args, out))
    b_d, by_d = bound(*fleet_work(flag_distinct, out))
    c3_dense = list(c3_main[0][:-1]) + [dense_request(*c3_main)]
    b_c3, by_c3 = bound(*fleet_work(c3_dense, c3_out))
    results["fleet_estimate"] = dict(
        source="karmada_tpu_torch/kernels/csrc/fleet_estimate.cu",
        replaces="karmada_tpu/estimator/client.py:23", max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=None,
        device_ms=dev_main / 1e3 if dev_main > 0 else None)
    log(f"timing (the flagship sweep, {flag_args[-1].shape[0]} rows, "
        f"{main_args[-1].shape[0]} distinct requests x {flag_args[5]} clusters, "
        f"{flag_args[0].shape[0]} nodes): fleet_estimate {ms:.4f} ms with the snapshot's node "
        f"ranges (device {dev_main / 1e3:.4f}), {ms_sort:.4f} ms with the sort (plain "
        f"{plain:.4f}, bound {b:.4f} {by}); every row distinct {ms_distinct:.4f} ms (device "
        f"{dev_distinct / 1e3:.4f}; bound {b_d:.4f} {by_d}); config 3's sweep "
        f"({c3_dense[-1].shape[0]} rows, {c3_main[0][-1].shape[0]} distinct requests x "
        f"{c3_dense[5]} clusters, {c3_dense[0].shape[0]} nodes) {ms_c3:.4f} ms (bound "
        f"{b_c3:.4f} {by_c3})")
    del flag_args, flag_main, main_args, flag_distinct, c3_main, c3_dense, out, c3_out

    v = np.where(rng.random(STALENESS_SHAPE) < 0.2, -1,
                 rng.integers(0, 1 << 30, STALENESS_SHAPE)).astype(np.int32)
    v = torch.from_numpy(v).to(dev)
    s_err = 0
    for age in range(11):
        got = faults.apply_staleness_penalty(v, age)
        shift = min(age, faults.MAX_STALENESS_AGE)
        want = v if shift == 0 else kernels.staleness_penalty_plain(v, shift)
        s_err = max(s_err, compare(f"staleness_penalty[age {age}]", [got], [want], ("values",)))
        if age and not torch.equal(got[v < 0], v[v < 0]):
            raise AssertionError("staleness_penalty changed a discard sentinel")
    ms = cuda_ms(lambda: kernels._staleness_launch(v, 3), 20)
    plain = cuda_ms(lambda: kernels.staleness_penalty_plain(v, 3), 20)
    lib = cuda_ms(lambda: torch.where(v >= 0, v >> 3, v), 20)
    b, by = bound(2 * nbytes([v]), v.numel())
    results["staleness_penalty"] = dict(
        source="karmada_tpu_torch/kernels/csrc/staleness.cu",
        replaces="karmada_tpu/faults/staleness.py:46", max_abs_err=s_err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=lib)
    log(f"staleness_penalty on {tuple(v.shape)} at ages 0-10 equals its plain version; timing "
        f"(shift 3) {ms:.4f} ms (plain {plain:.4f}, torch.where {lib:.4f}, bound {b:.4f} {by})")
    del v, got, want
    torch.cuda.empty_cache()


def answers_hold(label, extra, members, names, bindings) -> None:
    """The round's answer matrix against the per-cluster host path: the
    member estimators' numpy answers on every dynamic row, -1 elsewhere."""
    dyn = dynamic_rows(bindings)
    want = np.full((len(bindings), len(names)), -1, np.int64)
    want[dyn] = host_rows(members, names, [bindings[b].spec.replica_requirements for b in dyn])
    if extra.shape != want.shape or not np.array_equal(extra, want):
        bad = np.argwhere(extra != want)[:5].tolist() if extra.shape == want.shape else "shape"
        raise AssertionError(f"{label}: the answer matrix differs from the per-cluster host "
                             f"path at {bad}")
    log(f"{label}: answer matrix {extra.shape} equals the per-cluster host path "
        f"({len(dyn)} dynamic rows, answers {int(extra[dyn].min())}..{int(extra.max())})")


def differ_count(a, b) -> int:
    def key(d):
        return d.ok, sorted((t.name, t.replicas) for t in (d.targets or []))

    return sum(key(x) != key(y) for x, y in zip(a, b))


def estimator_breakdown(label, registry, est, bindings, names, run_round, p50):
    """One more round split at its seams (host clock): the sweep
    (MemberEstimators: the request upload, the fleet kernel, the copy
    back), the registry's host merge, and the round given the answers
    (upload, launch, decode); then the device time of one profiled round."""
    spans = {"sweep": 0.0}
    orig = est.max_available_replicas_rows

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        spans["sweep"] += time.perf_counter() - t0
        return out

    est.max_available_replicas_rows = timed
    try:
        t0 = time.perf_counter()
        extra = registry.batch_estimates(bindings, names)
        t1 = time.perf_counter()
        run_round(extra)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        del est.max_available_replicas_rows
    by = device_events_us(lambda: run_round(registry.batch_estimates(bindings, names)))
    kernel_ms = sum(by.values()) / 1e3
    share = "not measured" if kernel_ms <= 0 else (
        f"{kernel_ms / 1e3:.4f} s = {kernel_ms / 1e3 / p50:.3f} of the p50 round (device busy "
        "share, torch.profiler, one round; ms by event: "
        f"{_events_text({k: us / 1e3 for k, us in by.items()}, top=8)})")
    log(f"{label} round breakdown: sweep (request upload + fleet_estimate + copy back) "
        f"{spans['sweep']:.4f} s, host merge {t1 - t0 - spans['sweep']:.4f} s, round given the "
        f"answers (upload + launch + decode) {t2 - t1:.4f} s; kernel time per round {share}")


def estimator_cell(label, dev, smi, clusters, bindings, members, rounds, expect):
    """A schedule() cell fed by the estimator sweep: the registry over
    in-process member estimators (the fleet kernel), then
    schedule(bindings, extra_avail=...) as the timed round; launches exact,
    the answers held against the per-cluster host path, decisions against
    the CPU round with the same answers. Returns (launches, decisions, the
    count of rows an answer-free schedule() decides otherwise)."""
    names = [c.name for c in clusters]
    est = MemberEstimators(members, device=dev)
    registry = EstimatorRegistry()
    registry.register_replica_estimator("members", est)
    sched = ArrayScheduler(clusters, device=dev)
    last = {}

    def run_round(extra):
        last["extra"] = extra
        return sched.schedule(bindings, extra_avail=extra)

    def run():
        return run_round(registry.batch_estimates(bindings, names))

    decisions, launches, times = drive(label, sched, bindings, rounds, expect, smi, run=run)
    extra = last["extra"]
    answers_hold(label, extra, members, names, bindings)
    estimator_breakdown(label, registry, est, bindings, names, run_round,
                        float(np.percentile(times, 50)))
    est.close()
    hold_against_cpu(label, clusters, bindings, decisions,
                     cpu_run=lambda s: s.schedule(bindings, extra_avail=extra))
    differ = differ_count(decisions, sched.schedule(bindings))
    log(f"{label}: {differ} of {len(decisions)} rows differ from schedule() without the "
        "estimator answers")
    return launches, differ


def run_estimator_cells(dev, smi, path_launches, flag, results):
    """Phase 4's estimator cells: config3 (BASELINE config 3),
    estimator_flagship (the flagship mix with member estimators on every
    cluster), degraded (bench.py build_degraded: a breaker open every other
    round, the staleness overlay feeding the round, launch parity) and
    tiers_estimator (the tiers_compact batch with answers through
    launch_tiered)."""
    path_launches.setdefault("fleet_estimate", 0)
    est_expect = {"fleet_estimate": 1, "candidate_select": 1, "candidate_tail": 2}
    clusters, bindings = build_dynamic()
    names = [c.name for c in clusters]
    launches, differ = estimator_cell(
        f"config3 ({len(clusters)} clusters x {len(bindings)} bindings, estimator answers)",
        dev, smi, clusters, bindings, estimator_members(names), CONFIG3_ROUNDS, est_expect)
    if differ == 0:
        raise AssertionError("config3: the estimator answers changed no decision")
    path_launches["fleet_estimate"] += launches["fleet_estimate"]
    del clusters, bindings

    launches, _ = estimator_cell(
        f"estimator_flagship ({N_CLUSTERS} clusters x {N_BINDINGS} bindings, estimator answers)",
        dev, smi, flag["clusters"], flag["bindings"], flag["members"], ESTIMATOR_ROUNDS,
        est_expect)
    path_launches["fleet_estimate"] += launches["fleet_estimate"]

    run_degraded_cell(dev, smi, path_launches)
    run_tiers_estimator_cell(dev, smi, path_launches, flag, results)


def run_degraded_cell(dev, smi, path_launches):
    """bench.py's degraded cell: the first cluster's breaker OPEN every
    other round, its answer column served from the staleness cache; a
    degraded round must launch exactly what a healthy one does."""
    from karmada_tpu_torch.metrics import degraded_rounds

    clusters, bindings, registry, breakers = build_degraded()
    sched = ArrayScheduler(clusters, device=dev)
    names = sched.fleet.names  # the bench sweeps the bucket-padded fleet
    dark = names[0]
    state = {"round": 0}
    per_leg = {"healthy": [], "degraded": []}
    kept = {}
    d0 = degraded_rounds.total()

    def run():
        state["round"] += 1
        degraded = state["round"] % 2 == 0  # the warm round is healthy
        br = breakers.for_member(dark)
        if degraded:
            for _ in range(breakers.failure_threshold):
                br.record_failure()
        else:
            br.record_success()
        extra = registry.batch_estimates(bindings, names)
        before = kernels.launch_counts()
        decisions = sched.schedule(bindings, extra_avail=extra)
        after = kernels.launch_counts()
        leg = "degraded" if degraded else "healthy"
        per_leg[leg].append({n: after[n] - before[n] for n in after})
        if degraded and registry.last_sweep_open:
            degraded_rounds.inc()
        kept[leg] = (extra, decisions, list(registry.last_sweep_open),
                     list(registry.last_sweep_stale))
        return decisions

    _, launches, _ = drive(f"degraded ({len(clusters)} clusters x {len(bindings)} bindings, "
                           "breaker open every other round)", sched, bindings, ESTIMATOR_ROUNDS,
                           {"candidate_select": 1, "candidate_tail": 1}, smi, run=run)
    path_launches["staleness_penalty"] = launches["staleness_penalty"]
    rounds = per_leg["healthy"] + per_leg["degraded"]
    if any(r != rounds[0] for r in rounds):
        raise AssertionError(f"degraded: launches per round differ between legs: {per_leg}")
    answers = registry.replica_estimators["bench-estimator"]._cache[(len(names), len(bindings))]
    h_extra, _, h_open, _ = kept["healthy"]
    g_extra, _, g_open, g_stale = kept["degraded"]
    want = answers.copy()
    want[:, 0] = faults.apply_staleness_penalty(answers[:, 0], 1)
    if not (np.array_equal(h_extra, answers) and np.array_equal(g_extra, want)
            and h_open == [] and g_open == g_stale == [dark]):
        raise AssertionError("degraded: the staleness overlay did not serve the decayed column")
    log(f"degraded: {len(per_leg['degraded'])} degraded and {len(per_leg['healthy'])} healthy "
        f"rounds launched the same kernels ({rounds[0]}); the open member's column was served "
        f"from the staleness cache, decayed once; karmada_degraded_rounds_total "
        f"+{degraded_rounds.total() - d0:.0f}")
    for leg in ("healthy", "degraded"):
        extra, decisions, _, _ = kept[leg]
        hold_against_cpu(f"degraded ({leg} round)", clusters, bindings, decisions,
                         cpu_run=lambda s, e=extra: s.schedule(bindings, extra_avail=e))
    # one more (healthy) round split at its seams: the registry's sweep,
    # merge and overlay (all host), then the round given the answers
    t0 = time.perf_counter()
    extra = registry.batch_estimates(bindings, names)
    t1 = time.perf_counter()
    state = sched._launch_solve(bindings, extra)
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    sched._materialize_solve(state)
    t4 = time.perf_counter()
    kernel_ms = profiled_device_ms(None, None, lambda: sched.schedule(bindings, extra_avail=extra))
    share = "not measured" if kernel_ms is None else f"{kernel_ms / 1e3:.4f} s (torch.profiler)"
    log(f"degraded round breakdown: registry sweep + merge + overlay {t1 - t0:.4f} s, launch "
        f"(classify + encode + upload + dispatch) {t2 - t1:.4f} s, wait for the device "
        f"{t3 - t2:.4f} s, materialize (copy back + decode) {t4 - t3:.4f} s; kernel time per "
        f"round {share}")


def run_tiers_estimator_cell(dev, smi, path_launches, flag, results):
    """The tiers_compact batch and fleet with member-estimator answers
    through launch_tiered: every tier's main pass min-merges them, the
    speculative pass runs in every tier without them (a zero-reclaim armed
    tier included); decisions and speculative decisions held against the
    CPU round, one round's tier_estimate and tier_consume launches against
    their plain versions, the latter also timed (consume_timing)."""
    clusters, bindings, placed = build_tiers(duplicated=False)
    names = [c.name for c in clusters]
    est = MemberEstimators(flag["members"], device=dev)
    registry = EstimatorRegistry()
    registry.register_replica_estimator("members", est)
    sched = ArrayScheduler(clusters, device=dev)
    expect = tier_expect(sched, bindings, placed, True, has_extra=True)
    expect["fleet_estimate"] = 1
    reclaim, armed = preemption._tier_reclaim(sched, bindings, placed)
    tier_of, _ = preemption._tier_assignment(bindings)
    zero = sorted({int(tier_of[i]) for i in armed if not reclaim[int(tier_of[i])].any()})
    if not zero:
        raise AssertionError("tiers_estimator: no armed tier with zero reclaim")
    last = {}

    def run():
        last["extra"] = registry.batch_estimates(bindings, names)
        return tier_round(sched, bindings, placed, last["extra"])

    label = f"tiers_estimator (tiered, {len(bindings)} rows, estimator answers)"
    decisions, launches, times = drive(label, sched, bindings, TIER_ROUNDS, expect, smi, run=run)
    add_launches(path_launches, launches, TIER_COUNTS + ("fleet_estimate",))
    extra = last["extra"]
    answers_hold("tiers_estimator", extra, flag["members"], names, bindings)
    estimator_breakdown("tiers_estimator", registry, est, bindings, names,
                        lambda e: tier_round(sched, bindings, placed, e),
                        float(np.percentile(times, 50)))
    with captured_tier_calls() as calls:
        tier_round(sched, bindings, placed, extra)
    torch.cuda.synchronize()
    errs = {"tier_estimate": 0, "tier_consume_window": 0}
    hold_tier_calls("tiers_estimator", calls, errs, "tier_consume_window")
    cs = calls["tier_estimate"]
    n_extra = sum(c.uses_answers() for c in cs)
    results["tier_estimate"]["max_abs_err"] = max(results["tier_estimate"]["max_abs_err"],
                                                  errs["tier_estimate"])
    numbers, est_text = estimate_timing(cs)
    log(f"tiers_estimator: one round's {len(cs)} tier_estimate launches ({n_extra} with the "
        f"answers, the speculative ones without) equal their plain version; timing (per round, "
        f"bound counting the answers' reads): {est_text}")
    results["tier_estimate"].update({f"estimator_{k}": v for k, v in numbers.items()})
    cs = calls["tier_consume"]
    r = results["tier_consume_window"]
    r["max_abs_err"] = max(r["max_abs_err"], errs["tier_consume_window"])
    log(f"tiers_estimator: one round's {len(cs)} tier_consume_window launches equal their plain "
        f"version; timing (per round): {consume_timing(cs, dev)[1]}")
    del calls, cs
    est.close()
    hold_against_cpu("tiers_estimator", clusters, bindings, decisions,
                     cpu_run=lambda s: tier_round(s, bindings, placed, extra))
    plain = tier_round(sched, bindings, placed)
    spec = [(d, d.speculative) for d in decisions if d.speculative is not None]
    log(f"tiers_estimator: {differ_count(decisions, plain)} of {len(decisions)} rows differ from "
        f"the tiered round without answers; armed tiers with zero reclaim {zero}; "
        f"{len(spec)} speculative decisions, {sum(differ_count([a], [b]) for a, b in spec)} "
        "differing from their main decision")


def plan_view(p):
    return (p.key, p.priority, p.feasible, p.error, [(t.name, t.replicas) for t in p.targets],
            [(v.key, v.cluster, v.replicas, v.priority) for v in p.victims])


def tier_breakdown(label, run, p50):
    """One more round of a tier cell split at its seams (host clock): the
    launch half (encode, upload, dispatch) of every `_launch_kernel_rows`,
    the wait for the device right after each, and the rest (copy back,
    decode, and the victim selection of a plan); then the device time of
    one profiled round."""
    spans = {"launch": 0.0, "wait": 0.0}
    orig = preemption._launch_kernel_rows

    def timed(*a, **kw):
        t0 = time.perf_counter()
        state = orig(*a, **kw)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        spans["launch"] += t1 - t0
        spans["wait"] += time.perf_counter() - t1
        return state

    preemption._launch_kernel_rows = timed
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        preemption._launch_kernel_rows = orig
    kernel_ms = profiled_device_ms(None, None, run)
    share = "not measured" if kernel_ms is None else (
        f"{kernel_ms / 1e3:.4f} s = {kernel_ms / 1e3 / p50:.3f} of the p50 round (device busy "
        "share, torch.profiler, one round)")
    log(f"{label} round breakdown: launch (encode + upload + dispatch) {spans['launch']:.4f} s, "
        f"wait for the device {spans['wait']:.4f} s, materialize (copy back + decode + host "
        f"rest) {total - spans['launch'] - spans['wait']:.4f} s; kernel time per round {share}")


def run_tier_cells(dev, smi, path_launches):
    """Phase 4's tier cells: tiers_dense and tiers_compact (launch_tiered +
    materialize_chunk, exact launches per round, decisions and speculative
    decisions held against the CPU round, the residual shown to bite
    against a tier-blind schedule()), then preempt_plan (plan_preemption,
    two launches per round, plans and one preview held against the
    CPU)."""
    for cell, duplicated, compact in TIER_CELLS:
        clusters, bindings, placed = build_tiers(duplicated=duplicated)
        sched = ArrayScheduler(clusters, device=dev)
        expect = tier_expect(sched, bindings, placed, compact)
        n0 = preemption.LAUNCHES.tiered

        def run(sched=sched, bindings=bindings, placed=placed):
            return tier_round(sched, bindings, placed)

        decisions, launches, times = drive(f"{cell} (tiered, {len(bindings)} rows)", sched,
                                           bindings, TIER_ROUNDS, expect, smi, run=run)
        if preemption.LAUNCHES.tiered - n0 != TIER_ROUNDS + 1:
            raise AssertionError(f"{cell}: LAUNCHES.tiered moved by "
                                 f"{preemption.LAUNCHES.tiered - n0}, expected {TIER_ROUNDS + 1}")
        add_launches(path_launches, launches, TIER_COUNTS)
        tier_breakdown(cell, run, float(np.percentile(times, 50)))
        hold_against_cpu(cell, clusters, bindings, decisions,
                         cpu_run=lambda s, b=bindings, p=placed: tier_round(s, b, p))
        blind = sched.schedule(bindings)

        def key(d):
            return d.ok, sorted((t.name, t.replicas) for t in (d.targets or []))

        differ = sum(key(a) != key(b) for a, b in zip(decisions, blind))
        spec = [d.speculative for d in decisions if d.speculative is not None]
        log(f"{cell}: {differ} of {len(decisions)} rows differ from a tier-blind schedule() of "
            f"the same batch; {len(spec)} armed rows decoded a speculative decision "
            f"({sum(d.ok for d in spec)} placed over the reclaimable capacity, "
            f"{sum(not d.ok for d in decisions if d.speculative is not None)} of them short "
            "without it)")
        if differ == 0:
            raise AssertionError(f"{cell}: the tier residual changed no decision")
        del sched, clusters, bindings, placed, decisions, blind

    clusters, placed, pre = build_preempt()
    sched = ArrayScheduler(clusters, device=dev)
    n0 = preemption.LAUNCHES.preempt

    def run_plan():
        return preemption.plan_preemption(sched, placed, pre)

    plans, _, times = drive(f"preempt_plan ({len(pre)} preemptors)", sched, None, TIER_ROUNDS,
                            {"candidate_select": 2, "candidate_tail": 2}, smi, run=run_plan)
    if preemption.LAUNCHES.preempt - n0 != 2 * (TIER_ROUNDS + 1):
        raise AssertionError(f"preempt_plan: LAUNCHES.preempt moved by "
                             f"{preemption.LAUNCHES.preempt - n0}")
    tier_breakdown("preempt_plan", run_plan, float(np.percentile(times, 50)))
    cpu_sched = ArrayScheduler(clusters, device="cpu")
    want = preemption.plan_preemption(cpu_sched, placed, pre)
    if [plan_view(p) for p in plans] != [plan_view(p) for p in want]:
        bad = next(i for i, (a, b) in enumerate(zip(plans, want)) if plan_view(a) != plan_view(b))
        raise AssertionError(f"preempt_plan: card and cpu plans differ at {bad}: "
                             f"{plan_view(plans[bad])} vs {plan_view(want[bad])}")
    preview = preemption.preview_preemption(clusters, placed + [pre[0]], pre[0], device=dev)
    alone = preemption.plan_preemption(sched, placed, [pre[0]])[0]
    cpu_preview = preemption.preview_preemption(clusters, placed + [pre[0]], pre[0], device="cpu")
    # the preview plans one preemptor against the snapshot: it equals that
    # preemptor's plan made alone (in the batch its group's joint victim
    # selection may cover less), and the cpu preview
    if not plan_view(preview) == plan_view(alone) == plan_view(cpu_preview):
        raise AssertionError(f"preempt_plan: the preview {plan_view(preview)} differs from the "
                             f"plan {plan_view(alone)} or the cpu preview "
                             f"{plan_view(cpu_preview)}")
    cut = sum(v.replicas for p in {p.priority: p for p in plans if p.feasible}.values()
              for v in p.victims)
    errs = sorted({p.error for p in plans if p.error})
    log(f"preempt_plan: plans identical to the cpu planner for all {len(plans)} preemptors "
        f"({sum(p.feasible for p in plans)} feasible, {cut} victim replicas cut, errors "
        f"{errs}); the preview of "
        f"{pre[0].metadata.key()} equals its plan ({len(preview.victims)} victim cuts)")
    if not (preview.feasible and preview.victims):
        raise AssertionError("preempt_plan: the previewed preemptor needed no victim; the fleet "
                             "is not tight")


def device_events_us(run):
    """Device time of run() under torch.profiler, by event name: the
    device's own events (kernels, copies, memsets), as the profiler's table
    footer sums them — the host-side launch events carry their kernels'
    time too and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            k = _short_event(e.name)
            by[k] = by.get(k, 0.0) + e.self_device_time_total
    return by


def profiled_device_ms(sched, bindings, run=None):
    """Device time of one round (`run()`, default `sched.schedule(bindings)`)
    under torch.profiler (device_events_us). None when the profiler records
    none here."""
    total_us = sum(device_events_us(run or (lambda: sched.schedule(bindings))).values())
    return total_us / 1e3 if total_us > 0 else None


def round_breakdown(label, sched, bindings, kernel_ms, p50):
    """One more round split at its seams (host clock), and the batch
    encode alone (row cache warm, as in the timed rounds). `kernel_ms`
    None: the device time comes from a profiled round instead."""
    t0 = time.perf_counter()
    state = sched._launch_solve(bindings)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sched._materialize_solve(state)
    t3 = time.perf_counter()
    sched.batch_encoder.encode(bindings)
    t4 = time.perf_counter()
    source = "from the phase-3 kernel timings"
    if kernel_ms is None:
        kernel_ms, source = profiled_device_ms(sched, bindings), "torch.profiler, one round"
    share = "not measured"
    if kernel_ms is not None:
        share = (f"{kernel_ms / 1e3:.4f} s = {kernel_ms / 1e3 / p50:.3f} of the p50 round "
                 f"(device busy share, {source})")
    log(f"{label} round breakdown: launch (classify + encode + upload + dispatch) "
        f"{t1 - t0:.4f} s [of which encode {t4 - t3:.4f} s], wait for the device "
        f"{t2 - t1:.4f} s, materialize (copy back + decode) {t3 - t2:.4f} s; kernel time per "
        f"round {share}")


# --------------------------------------------------------------------------
# the chunk surface (BASELINE config 5: churn, replay, the dirty refresh,
# the pipeline) and the wide routes of candidate_select / candidate_tail
# --------------------------------------------------------------------------


def _churn_bindings(rng, names, n_bindings):
    """bench.py's churn working set (`_churn_bindings`, the same draws):
    every binding with 1-4 previous clusters, Steady scale-up / scale-down
    / unchanged and Fresh reschedule in turn, one in three Aggregated."""
    n_clusters = len(names)
    bindings = []
    for i in range(n_bindings):
        prev_n = int(rng.integers(1, 5))
        prev_idx = rng.choice(n_clusters, size=prev_n, replace=False)
        prev = {}
        prev_total = 0
        for j in prev_idx:
            r = int(rng.integers(1, 8))
            prev[names[int(j)]] = r
            prev_total += r
        mode = i % 4
        if mode == 0:  # steady scale-up
            replicas = prev_total + int(rng.integers(1, 16))
        elif mode == 1:  # steady scale-down
            replicas = max(1, prev_total - int(rng.integers(1, prev_total + 1)))
        elif mode == 2:  # unchanged
            replicas = prev_total
        else:  # fresh reschedule
            replicas = prev_total + int(rng.integers(0, 8))
        rb = _binding(i, replicas, _dyn_placement(aggregated=(i % 3 == 0)),
                      float(rng.choice([0.25, 0.5])), prev=prev)
        if mode == 3:
            rb.spec.reschedule_triggered_at = 2.0
            rb.status.last_scheduled_time = 1.0
        bindings.append(rb)
    return bindings


def build_churn(seed=0, n_clusters=N_CLUSTERS, n_bindings=N_BINDINGS):
    """BASELINE config 5 (bench.py:353 build_churn): the steady-state
    replay round, 5 000 clusters x 10 000 bindings."""
    rng = np.random.default_rng(seed)
    clusters = synthetic_fleet(n_clusters, seed=seed)
    return clusters, _churn_bindings(rng, [c.name for c in clusters], n_bindings)


def churn_drift(bindings, dirty_frac=INCREMENTAL_DIRTY):
    """bench.py:442 build_churn_incremental's pre-round step: the next
    dirty_frac of the bindings (a cursor walks the list) get a generation
    bump and a replica drift, the store-update contract."""
    n_dirty = max(1, int(len(bindings) * dirty_frac))
    state = {"cursor": 0}

    def step():
        start = state["cursor"]
        for k in range(n_dirty):
            rb = bindings[(start + k) % len(bindings)]
            rb.metadata.generation += 1
            rb.spec.replicas = max(1, rb.spec.replicas + (k % 3) - 1)
        state["cursor"] = (start + n_dirty) % len(bindings)

    return step, n_dirty


def status_churn(clusters, rounds, seed=7, n_dirty=DIRTY_CLUSTERS):
    """`rounds` successive fleets in which n_dirty clusters change status
    each: allocated cpu redrawn, one in ten flips Ready, one in ten takes a
    NoSchedule taint (replacing its taints, so the taint axis never
    widens). Labels, provider, region and zone stay, so the dirty-column
    path applies, as member heartbeats drive it. Returns [(fleet, dirty
    names)]."""
    rng = np.random.default_rng(seed)
    live = list(clusters)
    out = []
    for r in range(rounds):
        dirty = set()
        for j, i in enumerate(rng.choice(len(live), n_dirty, replace=False)):
            c = copy.deepcopy(live[int(i)])
            alloc = c.status.resource_summary.allocatable[CPU]
            c.status.resource_summary.allocated[CPU] = float(alloc * rng.uniform(0.0, 0.95))
            if j % 10 == 0:
                for cond in c.status.conditions:
                    if cond.type == CLUSTER_CONDITION_READY:
                        cond.status = "False" if cond.status == "True" else "True"
            elif j % 10 == 1:
                c.spec.taints = [Taint(key="churn", value=f"r{r}", effect=EFFECT_NO_SCHEDULE)]
            live[int(i)] = c
            dirty.add(c.name)
        out.append((list(live), dirty))
    return out


def random_fleet_arrays(rng, C, T=4, G=6, R=4):
    """Seeded host arrays of every dtype the resident fleet holds (bool,
    int32, int64), by FLEET name."""
    return {
        "alive": rng.random(C) < 0.9,
        "capacity": rng.integers(-10, 2_000_000, (C, R)).astype(np.int64),
        "has_summary": rng.random(C) < 0.95,
        "taint_key": rng.integers(0, 4, (C, T)).astype(np.int32),
        "taint_value": rng.integers(0, 3, (C, T)).astype(np.int32),
        "taint_effect": rng.integers(0, 4, (C, T)).astype(np.int32),
        "api_ok": rng.random((C, G)) < 0.9,
    }


def random_fleet(rng, dev, C, T=4, G=6, R=4):
    """random_fleet_arrays on `dev`, in FLEET order."""
    t = batch_from_numpy(random_fleet_arrays(rng, C, T, G, R), dev)
    return [t[n] for n in FLEET]


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


# the refresh's cases at the churn width, both routes: (R, T, G, rows) with
# rows "churn" (DIRTY_CLUSTERS distinct and 8 repeated), "one", "last" (the
# last row and the first) or "every"; T = 0 leaves the taint fields without
# bytes, odd G gives rows of odd bytes. The first is timed.
SCATTER_EDGES = ((4, 4, 6, "churn"), (4, 0, 6, "churn"), (1, 4, 5, "last"), (5, 3, 7, "one"),
                 (4, 4, 6, "every"), (1, 0, 1, "last"))


def scatter_rows_ids(rng, C, kind):
    """The dirty row ids of one edge case (int64, host)."""
    if kind == "churn":
        rows = rng.choice(C, DIRTY_CLUSTERS, replace=False)
        return np.concatenate([rows, rows[:8]]).astype(np.int64)
    return {"one": np.array([C // 3]), "last": np.array([C - 1, 0]),
            "every": np.arange(C)}[kind].astype(np.int64)


def hold_scatter_routes(dev, label, base, new, rows):
    """Both routes of scatter_rows on one case against the plain version
    and index_copy_: separate sources (`_scatter_rows_launch`) and the
    staged block of a launcher bound to the destinations
    (`FleetScatter.refresh`, gathering from the host arrays `new`).
    Returns (max abs error, the launcher, its destinations, the host
    fleet, the ids and sources on the card, the plain result)."""
    idx = torch.from_numpy(rows).to(dev)
    srcs = [torch.from_numpy(np.ascontiguousarray(new[n][rows])).to(dev) for n in FLEET]
    start = [torch.from_numpy(base[n]).to(dev) for n in FLEET]
    want = kernels.scatter_rows_plain([x.clone() for x in start], idx, srcs)
    lib = [x.clone() for x in start]
    for d, x in zip(lib, srcs):
        d.index_copy_(0, idx, x)
    err = compare(f"scatter_rows[{label}, index_copy_]", want, lib, FLEET)
    got = [x.clone() for x in start]
    kernels._scatter_rows_launch(got, idx, srcs)
    err = max(err, compare(f"scatter_rows[{label}, separate sources]", got, want, FLEET))
    staged = [x.clone() for x in start]
    launcher = kernels.FleetScatter(dict(zip(FLEET, staged)))
    fleet = SimpleNamespace(**new)
    launcher.refresh(rows, fleet)
    err = max(err, compare(f"scatter_rows[{label}, staged]", staged, want, FLEET))
    keep = torch.ones(start[0].shape[0], dtype=torch.bool, device=dev)
    keep[idx] = False
    if not all(torch.equal(g[keep], b[keep]) for g, b in zip(staged, start)):
        raise AssertionError(f"scatter_rows[{label}] wrote a row outside idx")
    return err, launcher, staged, fleet, idx, srcs, want


def check_scatter_rows(dev, results):
    """B17 at the churn fleet's width (5 120) on SCATTER_EDGES, both
    routes against the plain version (`dst[idx] = src`) and index_copy_,
    then timed on the churn case: the bound route (a launcher's refresh:
    the host gather into one pinned block, one upload, one launch) by
    events, its device time split kernel / copy (torch.profiler) and its
    host enqueue; the separate-source route, the plain version and seven
    index_copy_ beside it."""
    rng = np.random.default_rng(40)
    C = shape_bucket(N_CLUSTERS)
    cases = []
    for R, T, G, kind in SCATTER_EDGES:
        rows = scatter_rows_ids(rng, C, kind)
        base, new = random_fleet_arrays(rng, C, T, G, R), random_fleet_arrays(rng, C, T, G, R)
        cases.append((rows, hold_scatter_routes(dev, f"R={R} T={T} G={G} {kind}", base, new,
                                                rows)))
    err = max(case[0] for _, case in cases)
    rows, (_, launcher, staged, fleet, idx, srcs, want) = cases[0]
    refresh = functools.partial(launcher.refresh, rows, fleet)
    ms = cuda_ms(refresh, 200)
    enqueue = host_enqueue_ms(refresh, 200)
    dev_ms, per_event = profiled_calls_ms(refresh, 50)
    kernel_dev = sum(v for k, v in per_event.items() if "scatter_rows" in k)
    sep = [x.clone() for x in staged]
    sep_ms = cuda_ms(lambda: kernels._scatter_rows_launch(sep, idx, srcs), 200)
    sep_dev = profiled_device_ms(None, None, lambda: kernels._scatter_rows_launch(sep, idx, srcs))
    plain = cuda_ms(lambda: kernels.scatter_rows_plain(want, idx, srcs), 50)
    lib = [x.clone() for x in staged]
    lib_ms = cuda_ms(lambda: [d.index_copy_(0, idx, x) for d, x in zip(lib, srcs)], 50)
    lib_dev_ms = profiled_device_ms(
        None, None, lambda: [d.index_copy_(0, idx, x) for d, x in zip(lib, srcs)])
    # bytes: the ids and the source rows read once, as many written
    b, by = bound(nbytes([idx]) + 2 * nbytes(srcs), 0)
    results["scatter_rows"] = dict(
        source="karmada_tpu_torch/kernels/csrc/scatter_rows.cu",
        replaces="karmada_tpu/sched/core.py:561", max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=lib_ms, device_ms=kernel_dev,
        copy_device_ms=dev_ms - kernel_dev, enqueue_ms=enqueue, separate_ms=sep_ms,
        separate_device_ms=sep_dev, library_device_ms=lib_dev_ms)
    log(f"scatter_rows: both routes equal the plain version and index_copy_ on "
        f"{len(SCATTER_EDGES)} cases at C = {C} (T = 0, odd G, R = 1 and 5, one row, the "
        f"last row, every row, {len(rows)} rows with 8 repeated); the bound route (pinned "
        f"block, one upload, one launch) {ms:.4f} ms by events, device {kernel_dev:.4f} ms "
        f"kernel + {dev_ms - kernel_dev:.4f} ms copy (torch.profiler, per call: {per_event}), host "
        f"enqueue {enqueue:.4f} ms; separate sources {sep_ms:.4f} ms (device "
        f"{fmt_ms(sep_dev)}); plain {plain:.4f}, index_copy_ x7 {lib_ms:.4f} (device "
        f"{fmt_ms(lib_dev_ms)}), bound {b:.6f} {by}: launch-bound")


def check_wide_tail(dev, results, flag):
    """candidate_tail past MAX_TAIL_K (dense_tail.cu's window mode): seeded
    tie-heavy windows at K = 192, 256 and 512, then the flagship batch's
    own K = 256 windows (flagship_k256's), timed there."""
    rng = np.random.default_rng(41)
    C = shape_bucket(N_CLUSTERS)
    err = 0
    for K in WIDE_TAIL_KS:
        r_tail = random_tail_inputs(rng, dev, WIDE_TAIL_ROWS, K, C)
        for has_agg, topk in ((True, 128), (False, 16), (True, 8)):
            err = max(err, compare(f"candidate_tail[wide random K={K},{has_agg},{topk}]",
                                   kernels._tail_launch(*r_tail, topk=topk, has_agg=has_agg),
                                   kernels.tail_plain(*r_tail, topk=topk, has_agg=has_agg),
                                   TAIL_OUT))
    del r_tail
    sched = ArrayScheduler(flag["clusters"], candidate_k=K256, device=dev)
    sel_args, k, t, tails = flagship_kernel_inputs(sched, flag["bindings"])
    if k != K256:
        raise AssertionError(f"flagship at candidate_k={K256}: effective K {k}")
    sel = kernels._select_launch(*sel_args, k=k, plugin_bits=sched._plugin_bits)
    t_args = [tail_args(sel, t, idx) for idx, _, _ in tails]
    outs = []
    for a, (_, topk, has_agg) in zip(t_args, tails):
        out = kernels._tail_launch(*a, topk=topk, has_agg=has_agg)
        err = max(err, compare(f"candidate_tail[flagship K={k},{has_agg}]", out,
                               kernels.tail_plain(*a, topk=topk, has_agg=has_agg), TAIL_OUT))
        outs.append(out)

    def both(fn):
        return lambda: [fn(*a, topk=topk, has_agg=h) for a, (_, topk, h) in zip(t_args, tails)]

    ms = cuda_ms(both(kernels._tail_launch), 10)
    plain = cuda_ms(both(kernels.tail_plain), 3)
    calls = [(a, {"topk": w, "has_agg": h}) for a, (_, w, h) in zip(t_args, tails)]
    for a, kw in calls:
        err = max(err, compare(f"candidate_tail[flagship K={k},{kw['has_agg']},reread]",
                               kernels._tail_launch(*a, **kw, route="reread"),
                               kernels.tail_plain(*a, **kw), TAIL_OUT))
    ab_time(f"dense_tail window mode, flagship K = {k} windows (both tails)",
            tail_variants(calls, kernels._tail_launch), 10,
            check=(TAIL_OUT * len(calls), "new"))
    b, by = tail_bound(t_args, outs)
    results["candidate_tail_wide"] = dict(
        source="karmada_tpu_torch/kernels/csrc/dense_tail.cu",
        replaces="karmada_tpu/sched/candidates.py:280", max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=None)
    log(f"candidate_tail wide route: random windows K = {WIDE_TAIL_KS} ({WIDE_TAIL_ROWS} rows) "
        f"and the flagship's K = {k} windows (rows {[int(i.numel()) for i, _, _ in tails]}) "
        f"equal the plain version; timing, both launches of a round {ms:.3f} ms (plain "
        f"{plain:.3f}, bound {b:.4f} {by})")


def select_threshold(Kt, Kp, Ke) -> int:
    """The widest row the in-block select route takes (select_route)."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if kernels.select_route(mid, Kt, Kp, Ke) == "candidate_select":
            lo = mid
        else:
            hi = mid - 1
    return lo


def check_wide_select(dev):
    """candidate_select on both sides of the in-block route's threshold
    (MAX_SELECT_SMEM): seeded tie-heavy rows at wide_40k's 20 480 columns,
    at the widest in-block width and one column past it, with and without
    a random extra_avail, each width on both routes. The main path's wide
    chunk is checked in phase 4 (check_wide_chunk), where that fixture is
    built."""
    rng = np.random.default_rng(42)
    err = 0
    probe = random_select_inputs(rng, dev, 1, 64)
    edge = select_threshold(probe[10].shape[2], probe[14].shape[1], probe[16].shape[1])
    for C in (20_480, edge, edge + 1):
        r_args = random_select_inputs(rng, dev, WIDE_SELECT_ROWS, C)
        route = kernels.select_route(C, r_args[10].shape[2], r_args[14].shape[1],
                                     r_args[16].shape[1])
        if route != ("candidate_select_wide" if C > edge else "candidate_select"):
            raise AssertionError(f"C={C} takes {route}, threshold {edge}")
        for tag, args in (("extra_avail", r_args), ("no answers", r_args[:-1] + [None])):
            want = kernels.select_plain(*args, k=128, plugin_bits=31)
            for forced in ("auto", "wide"):
                err = max(err, compare(f"candidate_select[random C={C} ({route}), {tag}, {forced}]",
                                       kernels._select_launch(*args, k=128, plugin_bits=31,
                                                              route=forced), want, SELECT_OUT))
            del want
        del r_args, args
    log(f"candidate_select: random rows at C = 20 480, {edge} (the widest in-block row) and "
        f"{edge + 1} ({WIDE_SELECT_ROWS} rows, with and without extra_avail, both routes) equal "
        "the plain version")
    torch.cuda.empty_cache()
    return err


def check_wide_chunk(dev, results, sched, bindings, err):
    """candidate_select on one chunk of the wide_40k round (its own batch,
    the pipelined chunk's rows): the in-block route the chunk takes and the
    device-memory route forced, both against the plain version and timed in
    turns; the device-memory route's row of the kernels line (no main path
    is wider than the in-block route's threshold) is its time here. `err`
    is the random checks' largest error."""
    rows = sched.pipeline_chunk_rows(len(sched.fleet.names))
    sel_args, k, _t, _tails = flagship_kernel_inputs(sched, bindings[:rows])
    bits = sched._plugin_bits
    sel = kernels._select_launch(*sel_args, k=k, plugin_bits=bits)
    want = kernels.select_plain(*sel_args, k=k, plugin_bits=bits)
    err = max(err, compare("candidate_select[wide_40k chunk]", sel, want, SELECT_OUT))
    err = max(err, compare("candidate_select[wide_40k chunk, device-memory route]",
                           kernels._select_launch(*sel_args, k=k, plugin_bits=bits, route="wide"),
                           want, SELECT_OUT))
    del want
    got = ab_time("candidate_select, wide_40k chunk", {
        "new": lambda: kernels._select_launch(*sel_args, k=k, plugin_bits=bits),
        "device-memory route": lambda: kernels._select_launch(*sel_args, k=k, plugin_bits=bits,
                                                              route="wide"),
    }, 5)
    ms, wide_ms = min(got["new"]), min(got["device-memory route"])
    plain = cuda_ms(lambda: kernels.select_plain(*sel_args, k=k, plugin_bits=bits), 2)
    b, by = select_bound(sel_args, sel, k)
    results["candidate_select_wide"] = dict(
        source="karmada_tpu_torch/kernels/csrc/candidate_select.cu",
        replaces="karmada_tpu/sched/candidates.py:210", max_abs_err=err, ms=wide_ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)
    log(f"candidate_select: one wide_40k chunk ({sel_args[7].shape[0]} x "
        f"{sel_args[0].shape[0]}, k={k}) equals the plain version on both routes; timing on "
        f"that chunk {ms:.3f} ms in-block, {wide_ms:.3f} ms device-memory route (plain "
        f"{plain:.3f}, bound {b:.4f} {by})")
    del sel_args, sel
    torch.cuda.empty_cache()


def chunk_expect(sched, n_rows, per_chunk):
    """Launches of one chunked round: `per_chunk` per chunk, as many
    chunks as _schedule_chunked cuts."""
    max_rows = sched._max_rows_per_round(len(sched.fleet.names))
    cap = max_rows
    if sched.pipeline_enabled:
        cap = min(max_rows, sched.pipeline_chunk_rows(len(sched.fleet.names)))
    n = len(chunk_spans(n_rows, plan_chunk_rows(n_rows, cap))) if n_rows > max_rows else 1
    return {name: c * n for name, c in per_chunk.items()}, n


def same_decisions(label, got, want):
    a = [decision_view(d) for d in got]
    b = [decision_view(d) for d in want]
    if a != b:
        bad = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        raise AssertionError(f"{label}: decisions differ at row {bad}: {a[bad]} vs {b[bad]}")


def pipeline_stats_line(stats):
    st = stats["stage_seconds"]
    return (f"{stats['chunks']} chunks of {stats['chunk_rows']} rows, stage seconds "
            f"{ {k: round(v, 4) for k, v in st.items()} }, wall {stats['wall_seconds']:.4f} s, "
            f"overlap ratio {stats['overlap_ratio']}")


def retry_bindings(clusters, seed=1, n_bindings=N_BINDINGS, every=RETRY_EVERY):
    """The churn working set with every `every`-th binding under ordered
    affinity terms whose first names no cluster of the fleet, so its row
    retries on the second (scheduler.go:562-625)."""
    names = [c.name for c in clusters]
    bindings = _churn_bindings(np.random.default_rng(seed), names, n_bindings)
    for rb in bindings[::every]:
        rb.spec.placement = pol.Placement(
            cluster_affinities=[
                pol.ClusterAffinityTerm(
                    affinity_name="primary",
                    affinity=pol.ClusterAffinity(cluster_names=["no-such-cluster"])),
                pol.ClusterAffinityTerm(
                    affinity_name="backup",
                    affinity=pol.ClusterAffinity(cluster_names=names[10:40])),
            ],
            replica_scheduling=rb.spec.placement.replica_scheduling,
        )
    return bindings


def timed_refresh(sched, clusters, dirty, spans):
    """sched.set_clusters(clusters, dirty_names=dirty), split on the host
    clock at its encode_cols call and its launcher's two steps: appends
    (dirty scan, encode_cols, the rest, whole, pack, upload + launch) in
    seconds to `spans`, the rest being pack + upload + launch and the
    bookkeeping around them; pack is the launcher's `stage` (the pinned
    block, the ids and the gathered rows), upload + launch its `_apply`."""
    enc, launcher = sched.encoder, sched._fleet_scatter
    marks = {}

    def marked(name, fn):
        def run(*a, **kw):
            marks[name + "0"] = time.perf_counter()
            out = fn(*a, **kw)
            marks[name + "1"] = time.perf_counter()
            return out
        return run

    enc.encode_cols = marked("enc", enc.encode_cols)
    launcher.stage = marked("stage", launcher.stage)
    launcher._apply = marked("apply", launcher._apply)
    try:
        t0 = time.perf_counter()
        sched.set_clusters(clusters, dirty_names=dirty)
        t3 = time.perf_counter()
    finally:
        del enc.encode_cols, launcher.stage, launcher._apply
    if len(marks) != 6:
        raise AssertionError(f"refresh: not one encode_cols and one launcher refresh ({marks})")
    t1, t2 = marks["enc0"], marks["enc1"]
    spans.append((t1 - t0, t2 - t1, t3 - t2, t3 - t0, marks["stage1"] - marks["stage0"],
                  marks["apply1"] - marks["apply0"]))


def check_resident_fleet(label, sched):
    """The resident fleet tensors against a full encode of the scheduler's
    clusters by the same encoder (same interned ids)."""
    full = sched.encoder.encode(sched.clusters)
    for n in FLEET:
        if not np.array_equal(sched._fleet_dev[n].cpu().numpy(), getattr(full, n)):
            raise AssertionError(f"{label}: resident {n} differs from a full re-encode")


def check_refresh_syncs(sched, clusters, dirty):
    """One dirty-column refresh (the whole set_clusters call) under
    torch.cuda.set_sync_debug_mode("error"): no stream sync, one launch."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sched.set_clusters(clusters, dirty_names=dirty)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if kernels.launch_counts()["scatter_rows"] != 1:
        raise AssertionError(f"refresh: {kernels.launch_counts()['scatter_rows']} scatter_rows "
                             "launches, expected 1")
    torch.cuda.synchronize()
    log(f"churn_dirty: one refresh ({len(dirty)} dirty clusters) ran under "
        "torch.cuda.set_sync_debug_mode('error') without a stream sync, one scatter_rows launch")


def sleep_cycles_per_ms():
    """torch.cuda._sleep's cycles a millisecond of device time on this card
    (calibrated once by events)."""
    probe = 1_000_000
    torch.cuda._sleep(probe)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    torch.cuda.synchronize()
    return probe / start.elapsed_time(end)


def queued_refresh(sched, fleets):
    """The refresh's host time (set_clusters entry to return) on an idle
    stream and behind device work queued ahead (torch.cuda._sleep), in
    turns over `fleets` (pairs of successive status changes). The work
    lasts QUEUED_WORK_MS, or three times the turn's idle refresh if that
    is longer, so a refresh that does not wait returns while it runs;
    fails if the work had ended when a queued refresh returned (the
    refresh waited for the stream)."""
    per_ms = sleep_cycles_per_ms()
    idle, queued, running = [], [], []
    for k in range(0, len(fleets), 2):
        torch.cuda.synchronize()
        timed_refresh(sched, *fleets[k], idle)
        torch.cuda.synchronize()
        work_ms = max(QUEUED_WORK_MS, 3e3 * idle[-1][3])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(int(per_ms * work_ms))
        end.record()
        timed_refresh(sched, *fleets[k + 1], queued)
        running.append(not end.query())
        torch.cuda.synchronize()
        queued[-1] += (start.elapsed_time(end),)
    i_ms = [x[3] * 1e3 for x in idle]
    q_ms = [x[3] * 1e3 for x in queued]
    work = [x[6] for x in queued]

    def parts(v):  # the rest, then pack and upload + launch
        return "; ".join(f"{x[2] * 1e3:.4f} ({x[4] * 1e3:.4f} + {x[5] * 1e3:.4f})" for x in v)

    log(f"churn_dirty: refresh host ms (set_clusters entry to return), idle stream "
        f"{', '.join(f'{x:.4f}' for x in i_ms)} (the rest (pack + upload and launch): "
        f"{parts(idle)}); with {', '.join(f'{x:.2f}' for x in work)} ms of device work queued "
        f"ahead {', '.join(f'{x:.4f}' for x in q_ms)} ({parts(queued)}); the work still running "
        f"when each queued refresh returned: {running}")
    if not all(running):
        raise AssertionError(f"refresh: the device work queued ahead ({work} ms) had ended when "
                             f"a refresh returned ({q_ms} ms): it waited for the stream")


def run_churn_dirty(dev, smi, path_launches, clusters, bindings, one):
    """churn_dirty: status heartbeats through the dirty-column path over
    the churn fleet (`one`: the compact round's launches a round), then
    the refresh's checks: its split, one refresh under the sync check,
    refreshes behind queued device work."""
    # the timed rounds' fleets, then one for the sync check and
    # QUEUED_REFRESH_TURNS pairs for the refresh with device work queued
    fleets = status_churn(clusters, CHUNK_ROUNDS + 2 + 2 * QUEUED_REFRESH_TURNS)
    dsched = ArrayScheduler(clusters, device=dev)
    dsched.schedule_incremental(bindings)
    encoder, launcher = dsched.batch_encoder, dsched._fleet_scatter
    state = {"i": 0, "splits": []}
    spans = []  # per round: dirty scan, encode_cols, pack + upload + launch, refresh, round
    dsched.stage_timer = timer = StageTimer()

    stages = []  # per round: the round's stage seconds (encode, solve, materialize)

    def run_dirty():
        live, dirty = fleets[state["i"]]
        state["i"] += 1
        timed_refresh(dsched, live, dirty, spans)
        before = dict(timer.totals)
        t0 = time.perf_counter()
        out = dsched.schedule_incremental(bindings)
        spans[-1] += (time.perf_counter() - t0,)
        stages.append({k: v - before.get(k, 0.0) for k, v in timer.totals.items()})
        state["splits"].append(dict(dsched.last_round_stats))
        return out

    decisions, launches, times = drive(
        f"churn_dirty ({DIRTY_CLUSTERS} clusters change status per round)", dsched, bindings,
        CHUNK_ROUNDS, {**one, "scatter_rows": 1}, smi, run=run_dirty)
    dsched.stage_timer = None
    path_launches["scatter_rows"] = launches["scatter_rows"]
    if dsched.batch_encoder is not encoder or dsched._fleet_scatter is not launcher:
        raise AssertionError("churn_dirty: the fleet was rebuilt (full re-encode)")
    if any(sp != {"replayed": 0, "solved": len(bindings)} for sp in state["splits"]):
        raise AssertionError(f"churn_dirty: round splits {state['splits']}")
    med = np.median(np.asarray(spans[1:]), axis=0)  # the timed rounds
    log(f"churn_dirty breakdown (host clock, median of {CHUNK_ROUNDS} timed rounds, p50 "
        f"{np.percentile(times, 50):.4f} s): refresh {med[3] * 1e3:.4f} ms = dirty scan "
        f"{med[0] * 1e3:.4f} + encode_cols {med[1] * 1e3:.4f} + the rest {med[2] * 1e3:.4f} "
        f"ms (pack {med[4] * 1e3:.4f}, upload + launch {med[5] * 1e3:.4f}); "
        f"schedule_incremental {med[6]:.4f} s (its stages: "
        + ", ".join(f"{k} {np.median([r.get(k, 0.0) for r in stages[1:]]):.4f} s"
                    for k in timer.totals) + ")")
    live = fleets[CHUNK_ROUNDS][0]
    check_resident_fleet("churn_dirty", dsched)
    fresh = ArrayScheduler(live, device=dev)
    same_decisions("churn_dirty vs a fresh scheduler on the card", decisions,
                   fresh.schedule(bindings))
    hold_against_cpu("churn_dirty", live, bindings, decisions)
    log(f"churn_dirty: {CHUNK_ROUNDS + 1} rounds, each one refresh (one pinned upload, one "
        "scatter_rows launch) into the resident fleet through the launcher bound at placement, "
        "the batch encoder kept, every binding solved (epoch bumped); resident tensors equal a "
        "full re-encode; decisions equal a fresh scheduler on the card and the cpu")
    del fresh
    check_refresh_syncs(dsched, *fleets[CHUNK_ROUNDS + 1])
    queued_refresh(dsched, fleets[CHUNK_ROUNDS + 2:])
    check_resident_fleet("churn_dirty after the refresh checks", dsched)
    del dsched, fleets


def run_churn_cells(dev, smi, path_launches, compact_ms):
    """Phase 4's config-5 cells over one churn fleet: churn (schedule(),
    one chunk), churn_incremental (schedule_incremental, 5 % of the
    bindings dirtied per round after a warm round), churn_dirty
    (set_clusters with dirty_names, then schedule_incremental: B17 every
    round, the encoder kept, every row solved), and pipeline (the churn
    round under a budget of B*C/8: serial and pipelined legs, 3 runs
    each; then one pipelined round with answers and affinity retries on
    the writer thread, under a side stream)."""
    clusters, bindings = build_churn()
    one = {"candidate_select": 1, "candidate_tail": 2}

    sched = ArrayScheduler(clusters, device=dev)
    decisions, launches, times = drive("churn (config 5, schedule())", sched, bindings,
                                       CHURN_ROUNDS, one, smi)
    # the compact flagship's phase-3 kernel time: the same shapes (10 240 x
    # 5 120 select, K = 128 tails)
    round_breakdown("churn", sched, bindings, compact_ms, float(np.percentile(times, 50)))
    hold_against_cpu("churn", clusters, bindings, decisions)

    # ---- churn_incremental (config 5b) ----
    inc = ArrayScheduler(clusters, device=dev)
    inc.schedule_incremental(bindings)  # the warm round fills the replay cache
    if inc.last_round_stats != {"replayed": 0, "solved": len(bindings)}:
        raise AssertionError(f"churn_incremental warm round: {inc.last_round_stats}")
    step, n_dirty = churn_drift(bindings)
    splits = []

    def run_inc():
        step()
        out = inc.schedule_incremental(bindings)
        splits.append(dict(inc.last_round_stats))
        return out

    decisions, _, _ = drive(f"churn_incremental (config 5b, {n_dirty} of {len(bindings)} "
                            "bindings dirtied per round)", inc, bindings, CHUNK_ROUNDS, one, smi,
                            run=run_inc)
    want_split = {"replayed": len(bindings) - n_dirty, "solved": n_dirty}
    if any(s != want_split for s in splits):
        raise AssertionError(f"churn_incremental: round splits {splits}, expected {want_split}")
    same_decisions("churn_incremental vs a cold schedule() on the card", decisions,
                   ArrayScheduler(clusters, device=dev).schedule(bindings))
    hold_against_cpu("churn_incremental", clusters, bindings, decisions)
    log(f"churn_incremental: every round replayed {want_split['replayed']} and solved "
        f"{n_dirty}; decisions equal a cold schedule() on the card and the cpu round")
    del inc

    run_churn_dirty(dev, smi, path_launches, clusters, bindings, one)

    # ---- pipeline: serial vs pipelined legs under a B*C/8 budget ----
    budget = max(1, (len(bindings) * len(clusters)) // 8)
    legs = {}
    for leg, pipelined in (("serial", None), ("pipelined", True)):
        s = ArrayScheduler(clusters, device=dev, pipeline=pipelined)
        s.max_bc_elems = budget
        legs[leg] = s
    if legs["serial"].pipeline_enabled:
        raise AssertionError("pipeline: the scheduler's default is not the serial executor")
    per = {}
    first = None
    order = tuple(legs) * PIPELINE_RUNS
    for run_i, leg in enumerate(order):
        s = legs[leg]
        expect, n_chunks = chunk_expect(s, len(bindings), one)
        stats = []

        def run_leg(s=s, stats=stats):
            out = s.schedule(bindings)
            stats.append(s.last_pipeline_stats)
            return out

        decisions, launches, times = drive(f"pipeline, {leg} leg (run {run_i // 2 + 1})", s,
                                           bindings, PIPELINE_ROUNDS, expect, smi, run=run_leg)
        if first is None:
            first = decisions
            # the bindings drifted in churn_incremental: the first leg's
            # decisions against the cpu round, every later one against it
            hold_against_cpu("pipeline (serial leg)", clusters, bindings, decisions)
        same_decisions(f"pipeline {leg} vs the serial leg", decisions, first)
        rec = per.setdefault(leg, {"times": [], "stats": []})
        rec["times"] += times
        rec["stats"] += stats[1:]
        log(f"pipeline {leg} (run {run_i // 2 + 1}): last round {pipeline_stats_line(stats[-1])}")
    serial_sum = None
    for leg, rec in per.items():
        ratios = [st["overlap_ratio"] for st in rec["stats"]]
        stages = {}
        for st in rec["stats"]:
            for k, v in st["stage_seconds"].items():
                stages[k] = stages.get(k, 0.0) + v / len(rec["stats"])
        total = sum(stages.values())
        serial_sum = total if serial_sum is None else serial_sum
        # stage seconds past the serial leg's: the overlapped stages took
        # longer (waits on the interpreter lock or the stream are one
        # hypothesis; nothing here measures them)
        log(f"pipeline {leg}: p50 {np.percentile(rec['times'], 50):.4f} s p90 "
            f"{np.percentile(rec['times'], 90):.4f} s over {len(rec['times'])} rounds "
            f"({PIPELINE_RUNS} runs); mean stage seconds "
            f"{ {k: round(v, 4) for k, v in stages.items()} } (sum {total:.4f} s, "
            f"{total - serial_sum:+.4f} s against the serial leg's, "
            f"{(total - serial_sum) / total:.3f} of this leg's stage time); overlap ratio "
            f"median {np.median(ratios):.4f} (min {min(ratios):.4f}, max {max(ratios):.4f})")
    log("pipeline: every leg's decisions equal the first serial leg's, held against the cpu")
    # a pipelined round with estimator answers and ordered affinity terms
    # whose first fails: the writer's retry sub-rounds upload through the
    # one pinned staging buffer while the caller's thread uploads the next
    # chunk's. It runs under a side stream, which the writer must enter.
    rbind = retry_bindings(clusters)
    rng = np.random.default_rng(21)
    extra = np.where(rng.random((len(rbind), len(clusters))) < 0.3, -1,
                     rng.choice([0, 1, 7, 60, 400, 1 << 20],
                                (len(rbind), len(clusters)))).astype(np.int32)
    piped = legs["pipelined"]
    uploads = set()
    upload = piped._staging.upload

    def recording_upload(*args):
        uploads.add(threading.current_thread().name)
        return upload(*args)

    piped._staging.upload = recording_upload
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = piped.schedule(rbind, extra_avail=extra)
    torch.cuda.current_stream().wait_stream(side)
    del piped._staging.upload
    log(f"pipeline with answers and retries, side stream: "
        f"{pipeline_stats_line(piped.last_pipeline_stats)}; uploads from {sorted(uploads)}")
    n_backup = sum(d.affinity_name == "backup" for d in got)
    if "sched-pipeline-writer" not in uploads or not n_backup:
        raise AssertionError(f"pipeline with answers: no retry upload on the writer thread "
                             f"({sorted(uploads)}, {n_backup} rows on the backup term)")
    same_decisions("pipeline with answers and retries: pipelined (side stream) vs serial", got,
                   legs["serial"].schedule(rbind, extra_avail=extra))
    hold_against_cpu("pipeline with answers and retries", clusters, rbind, got,
                     cpu_run=lambda c: c.schedule(rbind, extra_avail=extra))
    log(f"pipeline with answers and retries: {n_backup} rows placed on their backup term; "
        "decisions equal the serial leg's and the cpu round")
    del legs, piped, rbind, extra


def run_wide_cells(dev, smi, path_launches, flag, results, select_err):
    """wide_40k (the reference's 40k x 20k point, docs/PERF.md:390: the
    flagship's mix at 20 000 clusters x 40 000 bindings, compact, K = 128,
    the default budget; schedule() chunked and pipelined over the in-block
    select route, pipelined 7 x 6 144; the serial leg's decisions equal; a
    sample of rows from every chunk and class held against the cpu round
    at the same K) and flagship_k256 (the compact flagship at
    candidate_k=256: the K > 128 tail; a tiered compact round at K = 256
    too). The wide fixture is built here, so no earlier cell's garbage
    collections walk it."""
    t0 = time.perf_counter()
    clusters, bindings = build_flagship(n_clusters=WIDE_CLUSTERS, n_bindings=WIDE_BINDINGS)
    sched = ArrayScheduler(clusters, device=dev, pipeline=True)
    log(f"wide_40k: {len(clusters)} x {len(bindings)} (fleet width {len(sched.fleet.names)}) "
        f"built in {time.perf_counter() - t0:.1f} s")
    check_wide_chunk(dev, results, sched, bindings, select_err)
    per_chunk = {"candidate_select": 1, "candidate_tail": 2}
    expect, n_chunks = chunk_expect(sched, len(bindings), per_chunk)
    decisions, launches, times = drive(
        f"wide_40k ({len(clusters)} clusters x {len(bindings)} bindings, {n_chunks} pipelined "
        "chunks)", sched, bindings, WIDE_ROUNDS, expect, smi)
    path_launches["candidate_select"] += launches["candidate_select"]
    stats = sched.last_pipeline_stats
    log(f"wide_40k: {pipeline_stats_line(stats)}; candidate stats {sched.last_candidate_stats}")
    if stats["chunks"] != n_chunks or sched.last_candidate_stats["candidate_k"] != 128:
        raise AssertionError(f"wide_40k: {stats}, {sched.last_candidate_stats}")
    serial = ArrayScheduler(clusters, device=dev)
    serial.max_bc_elems = sched.max_bc_elems
    s_expect, s_chunks = chunk_expect(serial, len(bindings), per_chunk)
    serial_dec, _, _ = drive(f"wide_40k serial leg ({s_chunks} chunks)", serial, bindings,
                             WIDE_ROUNDS, s_expect, smi)
    log(f"wide_40k serial leg: {pipeline_stats_line(serial.last_pipeline_stats)}")
    same_decisions("wide_40k pipelined vs serial", decisions, serial_dec)
    del serial, serial_dec
    # the cpu sample: rows spread over every pipelined chunk and, inside
    # each, over every row class
    rows = sched.pipeline_chunk_rows(len(sched.fleet.names))
    spans = chunk_spans(len(bindings), plan_chunk_rows(len(bindings), rows))
    per_span = -(-WIDE_SAMPLE // len(spans))
    cls = np.asarray([sched._row_class(rb, False) for rb in bindings])
    pick = []
    for s, e in spans:
        for c in np.unique(cls[s:e]):
            members = s + np.flatnonzero(cls[s:e] == c)
            n = -(-per_span // len(np.unique(cls[s:e])))
            pick += members[np.linspace(0, len(members) - 1, min(n, len(members))).astype(int)].tolist()
    pick = sorted(set(pick))
    cpu = ArrayScheduler(clusters, device="cpu")
    t0 = time.perf_counter()
    want = cpu.schedule([bindings[i] for i in pick])
    same_decisions("wide_40k sample vs the cpu round", [decisions[i] for i in pick], want)
    if cpu.last_candidate_stats["candidate_k"] != sched.last_candidate_stats["candidate_k"]:
        raise AssertionError(f"wide_40k: cpu K {cpu.last_candidate_stats} vs card "
                             f"{sched.last_candidate_stats}")
    log(f"wide_40k: {len(pick)} sampled rows ({len(spans)} chunks x classes "
        f"{sorted(set(cls.tolist()))}) equal the cpu round at K = "
        f"{cpu.last_candidate_stats['candidate_k']} ({time.perf_counter() - t0:.1f} s)")
    del cpu, want, sched, clusters, bindings, decisions
    gc.collect()
    torch.cuda.empty_cache()

    # ---- flagship_k256 ----
    clusters, bindings = flag["clusters"], flag["bindings"]
    ksched = ArrayScheduler(clusters, candidate_k=K256, device=dev)
    decisions, launches, times = drive(f"flagship_k256 (candidate_k={K256})", ksched, bindings,
                                       CHUNK_ROUNDS, {"candidate_select": 1,
                                                      "candidate_tail_wide": 2}, smi)
    path_launches["candidate_tail_wide"] = launches["candidate_tail_wide"]
    if ksched.last_candidate_stats["candidate_k"] != K256:
        raise AssertionError(f"flagship_k256: {ksched.last_candidate_stats}")
    hold_against_cpu("flagship_k256", clusters, bindings, decisions, candidate_k=K256)
    tclusters, tbindings, placed = build_tiers(duplicated=False)
    tsched = ArrayScheduler(tclusters, candidate_k=K256, device=dev)
    expect = tier_expect(tsched, tbindings, placed, True)
    expect["candidate_tail_wide"] = expect.pop("candidate_tail")
    decisions, launches, _ = drive("tiers_compact at K = 256", tsched, tbindings, 1, expect, smi,
                                   run=lambda: tier_round(tsched, tbindings, placed))
    add_launches(path_launches, launches, ("candidate_tail_wide", "tier_consume_window"))
    hold_against_cpu("tiers_compact at K = 256", tclusters, tbindings, decisions,
                     cpu_run=lambda s: tier_round(s, tbindings, placed), candidate_k=K256)


# --------------------------------------------------------------------------
# the what-if simulation plane (Simulator's [S,B,C] scenario solve, the
# reports' inputs, the quota preflight)
# --------------------------------------------------------------------------


def build_whatif(seed=0, n_clusters=WHATIF_CLUSTERS, n_bindings=WHATIF_BINDINGS,
                 n_scenarios=WHATIF_SCENARIOS):
    """bench.py:521 build_whatif, the same draws: the churn working set on
    its fleet, and n_scenarios drains, readiness losses and capacity cuts
    (every fourth a cut of 32-255 cpu) on distinct clusters."""
    clusters, bindings = build_churn(seed=seed, n_clusters=n_clusters, n_bindings=n_bindings)
    names = [c.name for c in clusters]
    rng = np.random.default_rng(seed + 1)
    picks = rng.choice(n_clusters, size=n_scenarios, replace=False)
    scenarios = []
    for k in range(n_scenarios):
        name = names[int(picks[k])]
        if k % 4 == 3:
            scenarios.append(Scenario(kind=SCENARIO_CAPACITY, cluster=name,
                                      resources={"cpu": -float(rng.integers(32, 256))}))
        elif k % 4 == 2:
            scenarios.append(Scenario(kind=SCENARIO_LOSS, cluster=name))
        else:
            scenarios.append(Scenario(kind=SCENARIO_DRAIN, cluster=name))
    return clusters, bindings, scenarios


def whatif_mixed(clusters, bindings, scenarios, seed=5):
    """The whatif cell plus a Taint, a BindingSurge and a Composite (drain +
    taint + capacity cut + surge) scenario, and SIM_SPREAD_ROWS
    region-spread rows (config 4's placements), which take the
    per-scenario ArrayScheduler fallback."""
    names = [c.name for c in clusters]
    rng = np.random.default_rng(seed)
    extra = [
        Scenario(kind=SCENARIO_TAINT, cluster=names[7], taint_key="sim", taint_value="x"),
        Scenario(kind=SCENARIO_SURGE, surge_count=64, surge_replicas=6,
                 surge_request={CPU: 1.0}),
        Scenario(kind=SCENARIO_COMPOSITE, name="zone-outage", steps=[
            Scenario(kind=SCENARIO_DRAIN, cluster=names[11]),
            Scenario(kind=SCENARIO_TAINT, cluster=names[12], taint_key="sim",
                     taint_effect=EFFECT_NO_EXECUTE),
            Scenario(kind=SCENARIO_CAPACITY, cluster=names[13], resources={CPU: -200.0}),
            Scenario(kind=SCENARIO_SURGE, surge_count=16, surge_replicas=40,
                     surge_request={CPU: 4.0}),
        ]),
    ]
    placements = _spread_placements(rng, 4)
    spread = [_binding(100_000 + i, int(rng.integers(2, 12)), placements[i % 4], 0.5,
                       ns="spread") for i in range(SIM_SPREAD_ROWS)]
    return list(bindings) + spread, list(scenarios) + extra


def outcome_view(o, keys=None):
    """An outcome as comparable values: placements (sorted targets) and
    errors, over `keys` when given (a row sample), else with the per-cluster
    assigned / usage, the overcommitted clusters and the injected count."""
    pl = {k: sorted((t.name, t.replicas) for t in v) for k, v in o.placements.items()
          if keys is None or k in keys}
    er = {k: v for k, v in o.errors.items() if keys is None or k in keys}
    if keys is not None:
        return pl, er
    return pl, er, o.assigned.tolist(), o.usage.tolist(), list(o.overcommitted), o.injected


def same_outcomes(label, got, want, keys=None):
    for si, (g, w) in enumerate(zip(got, want)):
        a, b = outcome_view(g, keys), outcome_view(w, keys)
        if a != b:
            part = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            raise AssertionError(f"{label}: scenario {si} ({g.scenario.label()}) differs from "
                                 f"the reference in field {part}")


def hold_against_cpu_sim(label, clusters, bindings, scenarios, outcomes, keys=None):
    """The same simulation through the port's CPU Simulator; every outcome
    identical (over the rows `keys` when given)."""
    t0 = time.perf_counter()
    base, outs = Simulator(clusters, device="cpu").simulate(bindings, scenarios)
    same_outcomes(label, outcomes, [base] + outs, keys)
    n_err = sum(len(o.errors) for o in outcomes)
    over = sum(len(o.overcommitted) for o in outcomes)
    log(f"{label}: every outcome identical to the cpu Simulator "
        f"({'all rows' if keys is None else f'{len(keys)} sampled rows'}; {len(outcomes)} "
        f"outcomes, {n_err} unplaceable rows, {over} overcommitted clusters in all); cpu "
        f"simulate {time.perf_counter() - t0:.1f} s")


def hold_against_schedulers(label, clusters, bindings, scenarios, outcomes, dev):
    """Each outcome against a cold ArrayScheduler round on the card over
    the scenario's cluster list (drained clusters removed): the dense
    round, which is the solve the batched path reproduces."""
    for sc, out in zip(scenarios, outcomes):
        sched = ArrayScheduler(apply_scenario_objects(clusters, sc), candidate_k=0, device=dev)
        for rb, d in zip(bindings, sched.schedule(bindings)):
            key = rb.metadata.key()
            got = ((sorted((t.name, t.replicas) for t in out.placements[key]), None)
                   if key in out.placements else (None, out.errors.get(key)))
            want = (sorted((t.name, t.replicas) for t in d.targets), None) if d.ok else (
                None, d.error)
            if got != want:
                raise AssertionError(f"{label}: {sc.label()} row {key}: {got} vs the card's "
                                     f"ArrayScheduler {want}")
        del sched
    log(f"{label}: {', '.join(sc.label() for sc in scenarios)} identical to a cold dense "
        f"ArrayScheduler round on the card over each scenario's clusters, all "
        f"{len(bindings)} rows")


def sim_breakdown(label, sim, run, p50):
    """One more round split at its seams (host clock): the S scenario-fleet
    encodes, the batch encode, the solves (launch and device, synchronised
    before the host copies), and the rest (decode, the fallback, the
    overcommit check); then the device time of one round by
    torch.profiler and its share of the p50."""
    from karmada_tpu_torch.simulation import engine

    secs = {"fleet encode": 0.0, "batch encode": 0.0, "solve": 0.0}

    def timed(key, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if key == "solve":
                torch.cuda.synchronize()
            secs[key] += time.perf_counter() - t0
            return out
        return wrap

    saved = (sim._encode_scenario_fleets, sim.batch_encoder.encode, engine._sim_solve)
    sim._encode_scenario_fleets = timed("fleet encode", saved[0])
    sim.batch_encoder.encode = timed("batch encode", saved[1])
    engine._sim_solve = timed("solve", saved[2])
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        del sim._encode_scenario_fleets, sim.batch_encoder.encode
        engine._sim_solve = saved[2]
    rest = total - sum(secs.values())
    dev_ms = profiled_device_ms(None, None, run)
    share = "not measured" if dev_ms is None else (
        f"{dev_ms / 1e3:.4f} s = {dev_ms / 1e3 / p50:.3f} of the p50 round (device busy "
        "share, torch.profiler, one round)")
    log(f"{label} round breakdown: {total:.4f} s = fleet encode {secs['fleet encode']:.4f} s "
        f"+ batch encode {secs['batch encode']:.4f} s + solve (launch + device) "
        f"{secs['solve']:.4f} s + decode and the rest {rest:.4f} s; device time per round "
        f"{share}")
    return secs, rest, dev_ms


def random_sim_inputs(rng, dev, S, B, C, with_extra, drained=0.02):
    """Seeded sim_filter inputs: the tie-heavy random batch of the select
    checks, a stacked fleet of S random scenario fleets in which a share
    `drained` of each scenario's columns is a drained husk (not alive, no
    summary, no taints) whose present rank repeats its neighbour's, and
    every odd scenario's last two taint slots are padding (effect 0)."""
    args = random_select_inputs(rng, dev, B, C)
    fleets = [random_fleet(rng, dev, C) for _ in range(S)]
    stacked = [torch.stack([f[i] for f in fleets]).contiguous() for i in range(len(FLEET))]
    alive, _cap, has_summary, tk, tv, te, _api = stacked
    present = rng.random((S, C)) >= drained
    present[0] = True
    gone = torch.from_numpy(~present).to(dev)
    alive[gone] = False
    has_summary[gone] = False
    for t in (tk, tv, te):
        t[gone] = 0
        t[1::2, :, -2:] = 0
    tie_idx = torch.from_numpy(np.cumsum(present, axis=1).astype(np.int64)).to(dev)
    batch = args[len(FLEET):len(FLEET) + len(SELECT_BATCH)]
    return stacked + [tie_idx] + batch + [args[-1] if with_extra else None]


# sim_filter's seeded edge cases (tag, S, B, C, answers, variant): one
# distinct request and every row its own, widths that are no multiple of
# four, one scenario, a scenario drained whole, 17 resources, and the
# estimate's int64 edges (answers at, below and above INT32_MAX, caps of
# 2^63 - 1, requests of 1 and near 2^63 - 1, no requested resource)
SIM_EDGE_CASES = (
    ("U = 1", 3, 512, 1000, True, "one request"),
    ("U = B", 3, 512, 1000, False, "all distinct"),
    ("C = 4 999", 3, 256, 4999, True, None),
    ("C = 13", 2, 64, 13, False, None),
    ("S = 1", 1, 1024, 5000, True, None),
    ("a scenario drained whole", 4, 256, 1000, True, "drained"),
    ("R = 17", 3, 256, 1000, False, "R = 17"),
    ("int64 edge values", 3, 512, 1000, True, "edges"),
    ("int64 edge values, C = 1 001", 2, 300, 1001, False, "edges"),
)
EDGE_CAPACITY = (-5, 0, 1, 7, 2**31 - 2, 2**31 - 1, 2**31, 3 * (2**31 - 1) - 1,
                 3 * (2**31 - 1), 2**62 - 1, 2**62, 2**63 - 1)


def sim_edge_inputs(rng, dev, S, B, C, with_extra, variant):
    """random_sim_inputs with one edge of SIM_EDGE_CASES applied."""
    args = random_sim_inputs(rng, dev, S, B, C, with_extra)
    cap, req_u, req_idx = args[1], args[19], args[20]
    if variant == "one request":
        req_u, req_idx = req_u[1:2].clone(), torch.zeros_like(req_idx)
    elif variant == "all distinct":
        req_u = req_u.index_select(0, req_idx.long())
        req_u[:, 0] += torch.arange(B, device=dev)
        req_idx = torch.arange(B, dtype=torch.int32, device=dev)
    elif variant == "drained":
        for i in (0, 2, 3, 4, 5):  # alive, has_summary, the taints
            args[i][1] = 0
        args[7][1] = 0
    elif variant == "R = 17":
        cap = torch.from_numpy(rng.integers(-10, 2_000_000, (S, C, 17))).to(dev)
        u = rng.integers(0, 2000, (9, 17))
        u[0] = 0
        u[:, 5:12] *= rng.random((9, 7)) < 0.5
        req_u = torch.from_numpy(u.astype(np.int64)).to(dev)
        req_idx = torch.from_numpy(rng.integers(0, 9, B).astype(np.int32)).to(dev)
    elif variant == "edges":
        R = cap.shape[2]
        cap = torch.from_numpy(rng.choice(np.array(EDGE_CAPACITY, np.int64), (S, C, R))).to(dev)
        u = rng.choice(np.array(EDGE_REQUEST, np.int64), (24, R))
        u[0] = 0
        u[1] = [3, 0, 0, 0]  # 3 (2^31 - 1) // 3 is INT32_MAX: the row's replicas
        req_u = torch.from_numpy(u).to(dev)
        req_idx = torch.from_numpy(rng.integers(0, 24, B).astype(np.int32)).to(dev)
        reps = args[8].clone()
        reps[::7] = 2**31 - 1
        args[8] = reps
    args[1], args[19], args[20] = cap.contiguous(), req_u.contiguous(), req_idx
    return args


def sim_filter_bound(args, outs):
    """Bytes: every input read once, every output written once.
    Operations: per (scenario, row, column) the filter chain (one compare
    per taint slot, prev entry and evict entry plus 8), the estimate (4 per
    requested resource plus 4) and the tie (12)."""
    S, C = args[0].shape
    B, T, R = args[8].shape[0], args[3].shape[2], args[1].shape[2]
    Kp, Ke = args[15].shape[1], args[17].shape[1]
    return bound(nbytes(args) + nbytes(outs), S * B * C * (T + Kp + Ke + 4 * R + 24))


def sim_load_bound(args, outs):
    """What this run's data needs: bytes, the active rows of the result,
    the active mask and the request read once, the sums written once;
    operations, per (scenario, active row, column) one add and R
    multiply-adds of int64. Inactive rows need no work."""
    result, active, request = args
    cells = int(active.sum().item()) * result.shape[2]
    return bound(cells * result.element_size() + nbytes([active, request]) + nbytes(outs),
                 cells * (2 * request.shape[1] + 1))


def sim_load_library(args):
    """The one torch call that computes sim_load's sums, torch.bmm in
    float64: result^T [S, C, B] @ (active x [request, 1]) [S, B, R + 1];
    the float64 operands are prepared outside the timed call. Exact only
    while every sum stays below 2^53."""
    result, active, request = args
    S, B, _ = result.shape
    q = torch.cat([request, torch.ones((B, 1), dtype=torch.int64, device=request.device)], 1)
    q = (active[:, :, None].to(torch.float64) * q.to(torch.float64)[None]).contiguous()
    r = result.transpose(1, 2).to(torch.float64)
    return lambda: torch.bmm(r, q)


SIM_FILTER_OUT = ("feasible", "avail", "prev", "tie", "feas_count")
SIM_LOAD_OUT = ("assigned", "usage")


def check_sim_kernels(dev, results):
    """sim_filter and sim_load against their plain versions, exactly: on
    seeded inputs at the whatif shape (S = 17, B = 1 024, C = 512) with and
    without answers and at one whatif_churn5k chunk (S = 5, B = 10 240,
    C = 5 120), drained columns and padded taint slots in each; sim_load on
    seeded results with random active masks; then both on the arguments
    one round each of whatif and whatif_churn5k passes them (captured at
    launch), timed at the whatif_churn5k chunk, with torch.bmm in float64
    as sim_load's library call."""
    rng = np.random.default_rng(70)
    err_f = err_l = 0
    bits = ALL_PLUGIN_BITS
    for S, B, C, with_extra in SIM_CHECK_SHAPES:
        args = random_sim_inputs(rng, dev, S, B, C, with_extra)
        got = kernels._sim_filter_launch(*args, plugin_bits=bits)
        want = kernels.sim_filter_plain(*args, plugin_bits=bits)
        err_f = max(err_f, compare(f"sim_filter[random {S}x{B}x{C}, answers {with_extra}]",
                                   got, want, SIM_FILTER_OUT))
        del got, want
        gen = torch.Generator(device=dev).manual_seed(S * B + C)
        result = torch.randint(0, 9, (S, B, C), generator=gen, device=dev, dtype=torch.int32)
        result *= torch.rand((S, B, C), generator=gen, device=dev) < 0.3
        active = torch.rand((S, B), generator=gen, device=dev) < 0.8
        for R in SIM_LOAD_RESOURCES:  # one launch, then blocks of eight resources
            request = torch.randint(0, 1 << 34, (B, R), generator=gen, device=dev)
            err_l = max(err_l, compare(f"sim_load[random {S}x{B}x{C}, R {R}]",
                                       kernels._sim_load_launch(result, active, request),
                                       kernels.sim_load_plain(result, active, request),
                                       SIM_LOAD_OUT))
        # a width that is no multiple of four (the 4-byte loads)
        odd = result[:, :, :-1].contiguous()
        err_l = max(err_l, compare(f"sim_load[random {S}x{B}x{C - 1}]",
                                   kernels._sim_load_launch(odd, active, request),
                                   kernels.sim_load_plain(odd, active, request), SIM_LOAD_OUT))
        del args, result, odd
    for tag, S, B, C, with_extra, variant in SIM_EDGE_CASES:
        args = sim_edge_inputs(rng, dev, S, B, C, with_extra, variant)
        got = kernels._sim_filter_launch(*args, plugin_bits=bits)
        want = kernels.sim_filter_plain(*args, plugin_bits=bits)
        err_f = max(err_f, compare(f"sim_filter[{tag}: {S}x{B}x{C}, answers {with_extra}]",
                                   got, want, SIM_FILTER_OUT))
        log(f"sim_filter[{tag}: {S} x {B} x {C}, {args[19].shape[0]} distinct requests x "
            f"{args[1].shape[2]} resources, answers {with_extra}] equals its plain version "
            f"(avail {int(want[1].min())}..{int(want[1].max())}, "
            f"{int(want[0].sum())} feasible)")
        del args, got, want
    torch.cuda.empty_cache()
    log(f"sim_filter and sim_load: seeded inputs at (S, B, C, answers) {SIM_CHECK_SHAPES} "
        "(drained columns, padded taint slots, random active masks, byte-sized requests; "
        f"sim_load at R = {SIM_LOAD_RESOURCES} and at C - 1 columns) equal their plain "
        "versions")

    captured = {}
    for cell, build_cell in (("whatif", build_whatif),
                             ("whatif_churn5k", functools.partial(
                                 build_whatif, n_clusters=CHURN5K_CLUSTERS,
                                 n_bindings=CHURN5K_BINDINGS))):
        clusters, bindings, scenarios = build_cell()
        sim = Simulator(clusters, device=dev)
        names = ("sim_filter", "sim_load", "dense_tail")
        with captured_launches(names) as calls:
            sim.simulate(bindings, scenarios)
        torch.cuda.synchronize()
        n = sim.last_stats["batched_solves"]
        if {k: len(v) for k, v in calls.items()} != dict.fromkeys(names, n):
            raise AssertionError(f"{cell}: one round launched "
                                 f"{ {k: len(v) for k, v in calls.items()} } for {n} solves")
        # dense_tail over the whatif solve's S x B scenario rows, its output
        # windows compared through the decode's sort too (the churn5k
        # chunks' are timed only: their plain version, all rows at once,
        # needs tens of GB)
        calls["dense_tail"] = calls["dense_tail"][:1]
        if cell == "whatif":
            args, kw = calls["dense_tail"][0]
            compare(f"dense_tail[{cell} scenario rows]", kernels._dense_tail_launch(*args, **kw),
                    kernels.dense_tail_plain(*args, **kw), TAIL_OUT)
        for i, (args, kw) in enumerate(calls["sim_filter"]):
            err_f = max(err_f, compare(f"sim_filter[{cell} solve {i}]",
                                       kernels._sim_filter_launch(*args, **kw),
                                       kernels.sim_filter_plain(*args, **kw), SIM_FILTER_OUT))
        for i, (args, kw) in enumerate(calls["sim_load"]):
            err_l = max(err_l, compare(f"sim_load[{cell} solve {i}]",
                                       kernels._sim_load_launch(*args, **kw),
                                       kernels.sim_load_plain(*args, **kw), SIM_LOAD_OUT))
        captured[cell] = calls
        log(f"{cell}: the {n} solve(s) of one round: {', '.join(names)} on the arguments the "
            "round passed them equal their plain versions")
        del sim, clusters, bindings
    # timed at the first whatif_churn5k chunk (S = 5), and per whatif round
    f_args, f_kw = captured["whatif_churn5k"]["sim_filter"][0]
    l_args, l_kw = captured["whatif_churn5k"]["sim_load"][0]
    f_out = kernels._sim_filter_launch(*f_args, **f_kw)
    l_out = kernels._sim_load_launch(*l_args, **l_kw)
    ms_f = cuda_ms(lambda: kernels._sim_filter_launch(*f_args, **f_kw), 5)
    plain_f = cuda_ms(lambda: kernels.sim_filter_plain(*f_args, **f_kw), 2)
    ms_l = cuda_ms(lambda: kernels._sim_load_launch(*l_args, **l_kw), 5)
    plain_l = cuda_ms(lambda: kernels.sim_load_plain(*l_args, **l_kw), 2)
    lib = sim_load_library(l_args)
    lib_ms = cuda_ms(lib, 5)
    exact = bool(torch.equal(lib().round().to(torch.int64),
                             torch.cat([l_out[1], l_out[0][:, :, None]], 2)))
    top = int(max(l_out[1].max().item(), l_out[0].max().item()))
    w_args, w_kw = captured["whatif"]["sim_filter"][0]
    ms_fw = cuda_ms(lambda: kernels._sim_filter_launch(*w_args, **w_kw), 20)
    wl_args, wl_kw = captured["whatif"]["sim_load"][0]
    ms_lw = cuda_ms(lambda: kernels._sim_load_launch(*wl_args, **wl_kw), 20)
    # device time (torch.profiler: the memset and both launches) beside
    # the events' time, which also holds the wrapper's host enqueue
    dev_f = sum(device_events_us(lambda: kernels._sim_filter_launch(*f_args, **f_kw)).values())
    dev_fw = sum(device_events_us(lambda: kernels._sim_filter_launch(*w_args, **w_kw)).values())
    b_fw, by_fw = sim_filter_bound(w_args, kernels._sim_filter_launch(*w_args, **w_kw))
    b_lw, by_lw = sim_load_bound(wl_args, kernels._sim_load_launch(*wl_args, **wl_kw))
    b_f, by_f = sim_filter_bound(f_args, f_out)
    b_l, by_l = sim_load_bound(l_args, l_out)
    sim_load_ab = {"new": lambda: kernels._sim_load_launch(*l_args, **l_kw),
                   "torch.bmm float64": lib}
    ab_time(f"sim_load, whatif_churn5k chunk ({' x '.join(map(str, l_args[0].shape))}, "
            f"{int(l_args[1].sum())} active rows)", sim_load_ab, 5)
    # the solve's middle launch, dense_tail over the scenario rows
    tails = {}
    for cell, reps in (("whatif", 20), ("whatif_churn5k", 3)):
        args, kw = captured[cell]["dense_tail"][0]
        ab_time(f"dense_tail, {cell} solve's scenario rows ({args[4].numel()} x "
                f"{args[0].shape[1]})",
                tail_variants([(args, kw)], kernels._dense_tail_launch), reps,
                check=(TAIL_OUT, "new"))
        out = kernels._dense_tail_launch(*args, **kw)
        b, by = dense_tail_bound([args[0]], [args[4]], args[5], [out])
        # the plain version over a churn5k chunk's rows, 8 192 rows at a
        # time (all at once it needs tens of GB), summed
        rows = args[4]
        plain = sum(
            cuda_ms(lambda r=rows[i:i + 8192]: kernels.dense_tail_plain(
                *args[:4], r, *args[5:], **kw), 1)
            for i in range(0, rows.numel(), 8192)
        ) if cell == "whatif_churn5k" else cuda_ms(
            lambda: kernels.dense_tail_plain(*args, **kw), 2)
        tails[cell] = (args[0].shape, cuda_ms(lambda: kernels._dense_tail_launch(*args, **kw),
                                              reps), plain, b, by)
        del out
    S, B, C = l_args[0].shape
    results["sim_filter"] = dict(
        source="karmada_tpu_torch/kernels/csrc/dense_filter.cu",
        replaces="karmada_tpu/simulation/engine.py:261", max_abs_err=err_f, ms=ms_f,
        plain_ms=plain_f, bound_ms=b_f, bound_by=by_f, library_ms=None,
        device_ms=dev_f / 1e3 if dev_f > 0 else None)
    results["sim_load"] = dict(
        source="karmada_tpu_torch/kernels/csrc/sim_load.cu",
        replaces="karmada_tpu/simulation/engine.py:261", max_abs_err=err_l, ms=ms_l,
        plain_ms=plain_l, bound_ms=b_l, bound_by=by_l, library_ms=lib_ms)
    log(f"sim_filter at one whatif_churn5k chunk ({S} x {B} x {C}, {f_args[19].shape[0]} "
        f"distinct requests, {f_args[11].shape[0]} toleration tables): {ms_f:.4f} ms (device "
        f"{dev_f / 1e3:.4f}; plain {plain_f:.4f}, bound {b_f:.4f} {by_f}); at the whatif solve "
        f"({w_args[0].shape[0]} x {w_args[8].shape[0]} x {w_args[0].shape[1]}, "
        f"{w_args[19].shape[0]} distinct requests) {ms_fw:.4f} ms (device {dev_fw / 1e3:.4f}; "
        f"bound {b_fw:.4f} {by_fw})")
    for cell, (shape, ms, plain, b, by) in tails.items():
        log(f"dense_tail over the {cell} solve's {shape[0]} scenario rows x {shape[1]}: "
            f"{ms:.4f} ms (plain {fmt_ms(plain)}, bound {b:.4f} {by})")
    log(f"sim_load at that chunk: {ms_l:.4f} ms (plain {plain_l:.4f}, bound {b_l:.4f} {by_l}, "
        f"torch.bmm float64 {lib_ms:.4f} ms: largest sum {top} "
        f"{'<' if top < 2**53 else '>='} 2^53, bmm result exact {exact}); at the whatif "
        f"solve {ms_lw:.4f} ms (bound {b_lw:.4f} {by_lw})")
    del captured, f_out, l_out, lib, tails
    gc.collect()
    torch.cuda.empty_cache()


def run_sim_cells(dev, smi, path_launches):
    """Phase 4's simulation cells: whatif (bench.py:521 build_whatif, 500 x
    1 000, S = 16), whatif_mixed (its fleet with a taint, a surge, a
    composite and spread rows on the fallback), whatif_churn5k (the recipe
    at BASELINE config 5's size, four scenario chunks a round) and
    preflight (QuotaPreflight's deny and allow on the card)."""
    sim_names = ("sim_filter", "sim_load")
    counted = dict.fromkeys(sim_names, 0)
    one_solve = {"sim_filter": 1, "dense_tail": 1, "sim_load": 1}

    # ---- whatif ----
    clusters, bindings, scenarios = build_whatif()
    sim = Simulator(clusters, device=dev)
    outcomes, launches, times = drive(
        f"whatif (bench.py build_whatif: {len(clusters)} x {len(bindings)}, S = "
        f"{len(scenarios)})", None, None, WHATIF_ROUNDS, one_solve, smi,
        run=lambda: (lambda b, o: [b] + o)(*sim.simulate(bindings, scenarios)))
    for n in sim_names:
        counted[n] += launches[n]
    p50 = float(np.percentile(times, 50))
    if sim.last_stats["batched_solves"] != 1 or sim.last_stats["fallback_solves"]:
        raise AssertionError(f"whatif: {sim.last_stats}")
    hold_against_cpu_sim("whatif", clusters, bindings, scenarios, outcomes)
    sim_breakdown("whatif", sim, lambda: sim.simulate(bindings, scenarios), p50)
    # bench.py's sequential_once: S independent cold rounds on the card
    ArrayScheduler(apply_scenario_objects(clusters, scenarios[0]), device=dev).schedule(bindings)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for sc in scenarios:
        ArrayScheduler(apply_scenario_objects(clusters, sc), device=dev).schedule(bindings)
    torch.cuda.synchronize()
    seq = time.perf_counter() - t0
    log(f"whatif: {len(scenarios)} sequential cold ArrayScheduler rounds on the card (bench.py "
        f"sequential_once) {seq:.4f} s against the batched p50 {p50:.4f} s: amortization "
        f"{seq / p50:.2f}x; per scenario {p50 / len(scenarios):.4f} s batched, "
        f"{seq / len(scenarios):.4f} s sequential")

    # ---- whatif_mixed ----
    m_bindings, m_scenarios = whatif_mixed(clusters, bindings, scenarios)
    kernels.reset_launches()
    t0 = time.perf_counter()
    base, outs = sim.simulate(m_bindings, m_scenarios)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = kernels.launch_counts()
    stats = sim.last_stats
    if (got["sim_filter"], got["sim_load"]) != (1, 1) or stats["batched_solves"] != 1 \
            or stats["fallback_solves"] != len(m_scenarios) + 1 \
            or stats["fallback_rows"] != SIM_SPREAD_ROWS:
        raise AssertionError(f"whatif_mixed: launches {got}, stats {stats}")
    for n in sim_names:
        counted[n] += got[n]
    hold_against_cpu_sim("whatif_mixed", clusters, m_bindings, m_scenarios, [base] + outs)
    log(f"whatif_mixed on {smi}: one round {wall:.4f} s (S = {len(m_scenarios)}: taint, surge "
        f"and composite added; {stats['batched_rows']} batched rows, {stats['fallback_rows']} "
        f"spread rows in {stats['fallback_solves']} fallback rounds); launches "
        f"{ {k: v for k, v in got.items() if v} }; injected {[o.injected for o in outs]}; "
        f"overcommitted clusters {[len(o.overcommitted) for o in outs]}")
    del sim, clusters, bindings, m_bindings, base, outs, outcomes
    gc.collect()

    # ---- whatif_churn5k ----
    clusters, bindings, scenarios = build_whatif(n_clusters=CHURN5K_CLUSTERS,
                                                 n_bindings=CHURN5K_BINDINGS)
    sim = Simulator(clusters, device=dev)
    Bp, C = shape_bucket(len(bindings)), len(clusters)
    per = max(1, sim.max_bc_elems // (Bp * C))
    chunks = -(-(len(scenarios) + 1) // per)
    outcomes, launches, times = drive(
        f"whatif_churn5k ({C} x {len(bindings)}, S = {len(scenarios)}: {chunks} scenario "
        f"chunks of {per})", None, None, CHURN5K_ROUNDS,
        {n: chunks for n in one_solve}, smi,
        run=lambda: (lambda b, o: [b] + o)(*sim.simulate(bindings, scenarios)))
    for n in sim_names:
        counted[n] += launches[n]
    if sim.last_stats["batched_solves"] != chunks:
        raise AssertionError(f"whatif_churn5k: {sim.last_stats}")
    p50 = float(np.percentile(times, 50))
    first = [next(i for i, sc in enumerate(scenarios) if sc.kind == kind)
             for kind in (SCENARIO_DRAIN, SCENARIO_LOSS, SCENARIO_CAPACITY)]
    hold_against_schedulers(
        "whatif_churn5k", clusters, bindings,
        [Scenario(kind=SCENARIO_BASELINE, name="baseline")] + [scenarios[i] for i in first],
        [outcomes[0]] + [outcomes[i + 1] for i in first], dev)
    pick = np.random.default_rng(71).choice(len(bindings), CHURN5K_SAMPLE, replace=False)
    sample = [bindings[i] for i in sorted(pick)]
    hold_against_cpu_sim("whatif_churn5k", clusters, sample, scenarios, outcomes,
                         keys={rb.metadata.key() for rb in sample})
    sim_breakdown("whatif_churn5k", sim, lambda: sim.simulate(bindings, scenarios), p50)
    del sim, clusters, bindings, outcomes
    gc.collect()
    torch.cuda.empty_cache()

    # ---- preflight: QuotaPreflight on the card over a duck-typed store ----
    objs = synthetic_fleet(12, seed=7) + [
        _binding(0, 8, _dyn_placement(aggregated=False), 1.0, ns="default")]
    names = [c.name for c in objs[:12]]

    class ListStore:
        def list(self, kind, namespace=None):
            return [copy.deepcopy(o) for o in objs if o.kind == kind
                    and (namespace is None or o.metadata.namespace == namespace)]

    def quota(caps):
        return FederatedResourceQuota(
            metadata=ObjectMeta(name="quota", namespace="default"),
            spec=FederatedResourceQuotaSpec(overall={CPU: 1000.0}, static_assignments=[
                StaticClusterAssignment(cluster_name=c, hard={CPU: h}) for c, h in caps.items()]))

    card, cpu = QuotaPreflight(ListStore(), device=dev), QuotaPreflight(ListStore(), device="cpu")
    deny = AdmissionRequest(operation="CREATE", kind="FederatedResourceQuota",
                            obj=quota({n: 0.25 for n in names}))
    # every cluster cut to 20 cpu available: the 8 one-cpu replicas still fit
    allow = AdmissionRequest(operation="CREATE", kind="FederatedResourceQuota",
                             obj=quota({n: 20.0 for n in names}))
    messages, got = [], None
    for pf in (card, cpu):
        kernels.reset_launches()
        try:
            pf.validate(deny)
        except AdmissionDenied as e:
            messages.append(str(e))
        else:
            raise AssertionError("preflight: the stranding caps were admitted")
        pf.validate(allow)
        got = got or kernels.launch_counts()
    if messages[0] != messages[1] or "strands replicas" not in messages[0]:
        raise AssertionError(f"preflight: card and cpu denials differ: {messages}")
    if {k: v for k, v in got.items() if v} != {n: 2 for n in one_solve}:
        raise AssertionError(f"preflight: launches {got}")
    old = copy.deepcopy(allow.obj)
    kernels.reset_launches()
    card.validate(AdmissionRequest(operation="UPDATE", kind="FederatedResourceQuota",
                                   obj=allow.obj, old_thunk=lambda: old))
    if any(kernels.launch_counts().values()):
        raise AssertionError("preflight: a spec-unchanged update ran a solve")
    for n in sim_names:
        counted[n] += got[n]
    log(f"preflight on {smi}: the stranding caps denied on the card as on the cpu "
        f"({messages[0]!r}), the allowing caps admitted, one solve each; a spec-unchanged "
        "update ran none")
    path_launches.update(counted)


# --------------------------------------------------------------------------
# the dense-input program (graft entry) and the scheduler shim
# --------------------------------------------------------------------------


def random_dense_input_args(seed, dev, B, C, distinct=None):
    """Seeded inputs of the dense-input filter, in FILTER_ARGS's order:
    taints of every effect and tolerations over one small key / value
    alphabet (some columns tolerated, some not, padded slots), unknown
    GVKs, unknown-request rows, zero and absent requests, non-positive
    capacity, and eviction, affinity and previous-membership masks drawn
    independently of each other (prev_member is no function of any prev
    count), with answers that are -1 in about half the cells. The [B, C]
    tensors come from a seeded generator on the card. With `distinct` =
    n, each row's request, toleration row and gvk are those of one of n
    rows picked at random (so equal rows are seldom adjacent), as the
    flagship's four requests repeat; else nearly every row is distinct."""
    rng = np.random.default_rng(seed)
    R, T, G, K = 4, 4, 6, 6
    capacity = rng.integers(-10, 2_000_000, (C, R)).astype(np.int64)
    capacity[::5, 0] = 0
    request = rng.integers(0, 2000, (B, R)).astype(np.int64)
    request[rng.random((B, R)) < 0.3] = 0
    tol_op = rng.integers(0, 3, (B, K)).astype(np.int32)
    tol_op[::3, 2:] = 0  # padded toleration slots
    host = batch_from_numpy({
        "alive": rng.random(C) < 0.9,
        "capacity": capacity,
        "has_summary": rng.random(C) < 0.95,
        "taint_key": rng.integers(0, 4, (C, T)).astype(np.int32),
        "taint_value": rng.integers(0, 3, (C, T)).astype(np.int32),
        "taint_effect": rng.integers(0, 4, (C, T)).astype(np.int32),
        "api_ok": rng.random((C, G)) < 0.9,
        "replicas": rng.integers(0, 64, B).astype(np.int32),
        "request": request,
        "unknown_request": rng.random(B) < 0.05,
        "gvk": rng.integers(-1, G + 1, B).astype(np.int32),
        "tol_key": rng.integers(0, 4, (B, K)).astype(np.int32),
        "tol_value": rng.integers(0, 3, (B, K)).astype(np.int32),
        "tol_effect": rng.integers(0, 4, (B, K)).astype(np.int32),
        "tol_op": tol_op,
    }, dev)
    if distinct is not None:
        pick = torch.from_numpy(rng.integers(0, distinct, B)).to(dev)
        for n in ("request", "gvk", "tol_key", "tol_value", "tol_effect", "tol_op"):
            host[n] = host[n][pick].contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def mask(p):
        return torch.rand((B, C), device=dev, generator=g) < p

    answers = torch.randint(0, 50, (B, C), device=dev, generator=g, dtype=torch.int32)
    host.update(affinity_ok=mask(0.7), eviction_ok=mask(0.9), prev_member=mask(0.2),
                extra_avail=torch.where(mask(0.5), answers, -1))
    return [host[n] for n in FILTER_ARGS]


def dense_input_filter_bound(args, outs):
    """Bytes: every input read once, every output written once. Operations:
    per (row, column) the filter chain (one compare per taint slot plus
    8) and the estimate (4 per requested resource plus 4)."""
    C, R = args[1].shape
    B, T = args[7].shape[0], args[3].shape[1]
    return bound(nbytes(args) + nbytes(outs), B * C * (T + 4 * R + 12))


def random_schedule_args(seed, dev, B, C):
    """The dense-input program's 24 arguments, in SCHEDULE_ARGS's order:
    random_dense_input_args's, then the tail's, drawn as
    tests/test_torch_graft_entry.py draws them: every strategy code (and
    one past them), fresh rows, static weights with all-zero rows,
    previous replicas in about a fifth of the cells, drawn apart from
    prev_member, and tie-heavy ties (four values)."""
    a = dict(zip(FILTER_ARGS, random_dense_input_args(seed, dev, B, C)))
    rng = np.random.default_rng(seed + 1)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (B, C), device=dev, generator=g, dtype=dtype)

    static_weight = ints(0, 6, torch.int64)
    static_weight[torch.from_numpy(rng.random(B) < 0.25).to(dev)] = 0
    has_prev = torch.rand((B, C), device=dev, generator=g) < 0.2
    a.update(
        strategy=torch.from_numpy(rng.integers(0, 5, B).astype(np.int32)).to(dev),
        fresh=torch.from_numpy(rng.random(B) < 0.5).to(dev),
        static_weight=static_weight,
        prev_replicas=torch.where(has_prev, ints(1, 6, torch.int32), 0),
        tie=ints(0, 4, torch.int32))
    return [a[n] for n in SCHEDULE_ARGS]


def off_alignment(t):
    """The same values in a contiguous tensor whose first element is one
    element past an allocation's start (so off any 8-byte boundary)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_dense_input_filter(dev, results, B, C):
    """Phase 3 for the dense-input filter kernel: against its plain version
    on seeded inputs at the dense flagship shape (B x C; every row
    distinct, then rows drawn from INPUT_REPEATS requests and toleration
    rows), at a narrow shape (C < 128), at ODD_INPUT_SHAPE and with the
    answers and affinity mask off alignment (the scalar path), then the
    whole program on the first three with the tail's inputs beside them,
    _schedule_kernel (the kernel, then dense_tail over every row) against
    _schedule_body on the card. The flagship-shape kernel is timed (CUDA
    events, device time); its time on the main path's arguments comes with
    the graft_flagship cell."""
    err, timed = 0, []
    for rb, rc, distinct in ((B, C, None), (B, C, INPUT_REPEATS), NARROW_INPUT_SHAPE + (None,),
                             ODD_INPUT_SHAPE + (None,)):
        what = "every row distinct" if distinct is None else f"{distinct} distinct rows"
        if distinct is None:
            p = random_schedule_args(40 + rc, dev, rb, rc)
            a = [p[SCHEDULE_ARGS.index(n)] for n in FILTER_ARGS]
        else:
            p, a = None, random_dense_input_args(40 + rc, dev, rb, rc, distinct=distinct)
        err = max(err, compare(f"dense_input_filter[random,{rb}x{rc}, {what}]",
                               kernels._dense_input_filter_launch(*a),
                               kernels.dense_input_filter_plain(*a), DENSE_INPUT_OUT))
        if (rb, rc) == (B, C):
            ms = cuda_ms(lambda: kernels._dense_input_filter_launch(*a), 10)
            dev_ms, _ = profiled_calls_ms(lambda: kernels._dense_input_filter_launch(*a), 10)
            b, by = dense_input_filter_bound(a, kernels._dense_input_filter_launch(*a))
            timed.append(f"{what}: {ms:.4f} ms, device {dev_ms:.4f} (bound {b:.4f} {by})")
        if distinct is None:
            compare(f"_schedule_kernel[random,{rb}x{rc}, _schedule_body on the card]",
                    _schedule_kernel(*p), _schedule_body(*p), GRAFT_OUT)
        if (rb, rc) == ODD_INPUT_SHAPE:
            rc4 = rc + 3  # a multiple of 4: only the bases' alignment takes the scalar path
            a = random_dense_input_args(43 + rc, dev, rb, rc4)
            for k in (FILTER_ARGS.index("affinity_ok"), FILTER_ARGS.index("extra_avail")):
                a[k] = off_alignment(a[k])
            err = max(err, compare(f"dense_input_filter[random,{rb}x{rc4}, off alignment]",
                                   kernels._dense_input_filter_launch(*a),
                                   kernels.dense_input_filter_plain(*a), DENSE_INPUT_OUT))
        del a, p
    results["dense_input_filter"] = dict(
        source="karmada_tpu_torch/kernels/csrc/dense_filter.cu",
        replaces="karmada_tpu/sched/core.py:320", max_abs_err=err, ms=None, plain_ms=None,
        bound_ms=None, bound_by=None, library_ms=None)
    log(f"random inputs ({B}x{C} every row distinct and with {INPUT_REPEATS} distinct rows, "
        f"{NARROW_INPUT_SHAPE[0]}x{NARROW_INPUT_SHAPE[1]}, {ODD_INPUT_SHAPE[0]}x"
        f"{ODD_INPUT_SHAPE[1]}, off alignment): dense_input_filter equals its plain version "
        f"exactly, and _schedule_kernel equals _schedule_body in all six outputs; at "
        f"{B}x{C}: {'; '.join(timed)}")


def expect_launches(label, launches, expect):
    """Every kernel launched exactly `expect` times (others 0)."""
    for n, c in launches.items():
        if c != expect.get(n, 0):
            raise AssertionError(f"{label}: {n} launched {c} times, expected {expect.get(n, 0)}")


def add_launches(path_launches, launches, names):
    for n in names:
        path_launches[n] = path_launches.get(n, 0) + launches[n]


def run_graft_example(dev, path_launches):
    """graft_entry.entry() at 16 x 12 on the card: one program call, all
    six outputs against _schedule_body on the card and the port's CPU
    run."""
    kernels.reset_launches()
    fn, args = graft_entry.entry(device=dev)
    out = fn(*args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expect_launches("graft_example", launches, {"dense_input_filter": 1, "dense_tail": 1})
    add_launches(path_launches, launches, ("dense_input_filter", "dense_tail"))
    compare("graft_example[card, _schedule_body on the card]", out, _schedule_body(*args),
            GRAFT_OUT)
    compare("graft_example[card, cpu]", [o.cpu() for o in out], fn(*(a.cpu() for a in args)),
            GRAFT_OUT)
    log(f"graft_example ({tuple(args[-1].shape)}): the program on the card equals "
        f"_schedule_body on the card and the cpu run; {int(out[2].sum())} replicas placed")


def run_graft_flagship(dev, smi, path_launches, results, sched, bindings):
    """The dense flagship batch (the dense flagship check's permuted,
    padded batch) as the dense-input program's 24 arguments on the card:
    one captured call and GRAFT_ROUNDS timed calls (CUDA events, split at
    the filter's return), all six outputs against _schedule_body on the
    card, feasible / score / avail against B3 and each tail row's result
    against B4 on the factored form of the same batch, then the kernel's
    time, its plain version's and both bounds."""
    filt_args, t, tails, _, _, batch = dense_kernel_inputs(sched, bindings)
    t0 = time.perf_counter()
    args = graft_entry.schedule_args(sched, batch, dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    B, C = args[SCHEDULE_ARGS.index("affinity_ok")].shape
    fa = [args[SCHEDULE_ARGS.index(n)] for n in FILTER_ARGS]

    kernels.reset_launches()
    with captured_launches(["dense_input_filter"]) as cap:
        out = _schedule_kernel(*args)
    torch.cuda.synchronize()
    marks = []
    counted = kernels.dense_input_filter

    def marked(*a):
        r = counted(*a)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return r

    spans = []
    kernels.dense_input_filter = marked
    try:
        for _ in range(GRAFT_ROUNDS):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = _schedule_kernel(*args)
            e.record()
            spans.append((s, e))
        torch.cuda.synchronize()
    finally:
        kernels.dense_input_filter = counted
    launches = kernels.launch_counts()
    n_calls = GRAFT_ROUNDS + 1
    expect_launches("graft_flagship", launches,
                    {"dense_input_filter": n_calls, "dense_tail": n_calls})
    add_launches(path_launches, launches, ("dense_input_filter", "dense_tail"))
    total = [s.elapsed_time(e) for s, e in spans]
    filt_ms = [s.elapsed_time(m) for (s, _), m in zip(spans, marks)]
    tail_ms = [m.elapsed_time(e) for (_, e), m in zip(spans, marks)]

    def pct(xs):
        return f"p50 {np.percentile(xs, 50):.3f} ms p90 {np.percentile(xs, 90):.3f} ms"

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    want = _schedule_body(*args)
    e.record()
    torch.cuda.synchronize()
    body_ms = s.elapsed_time(e)
    compare("graft_flagship[card, _schedule_body on the card]", out, want, GRAFT_OUT)
    del want

    filt = kernels._dense_filter_launch(*filt_args, plugin_bits=sched._plugin_bits)
    compare("graft_flagship[feasible/score/avail, B3]", [out[0], out[1], out[5]],
            [filt[0], filt[1], filt[2]], DENSE_INPUT_OUT)
    n_tail = 0
    for rows, topk, has_agg in tails:
        o = kernels._dense_tail_launch(*dense_tail_args(filt, t, rows), topk=topk,
                                       has_agg=has_agg)
        r = rows.long()
        compare(f"graft_flagship[result rows, B4 {has_agg}]",
                [out[2].index_select(0, r), out[3][r], out[4][r]], o[:3],
                ("result", "unschedulable", "avail_sum"))
        n_tail += int(rows.numel())
    del filt

    (ca, _), = cap["dense_input_filter"]
    err = compare("dense_input_filter[captured flagship call]",
                  kernels._dense_input_filter_launch(*ca),
                  kernels.dense_input_filter_plain(*ca), DENSE_INPUT_OUT)
    del ca, cap
    # the program's tail over every row: no output window now; the earlier
    # design sorted a 128-column window the program then dropped
    ta = [out[0], out[5]] + [args[SCHEDULE_ARGS.index(n)] for n in (
        "prev_replicas", "tie")] + [torch.arange(B, dtype=torch.int32, device=dev)]
    ta += [args[SCHEDULE_ARGS.index("static_weight")], ta[4]] + [
        args[SCHEDULE_ARGS.index(n)] for n in ("strategy", "replicas", "fresh")]
    w = min(C, kernels.MAX_DENSE_TOPK)
    graft_ab = {
        "new (no window)": lambda: kernels._dense_tail_launch(*ta, topk=0, has_agg=True),
        "reread route (no window)": lambda: kernels._dense_tail_launch(
            *ta, topk=0, has_agg=True, route="reread"),
        "reread route (window 128)": lambda: kernels._dense_tail_launch(
            *ta, topk=w, has_agg=True, route="reread"),
    }
    kept = ("result", "unschedulable", "avail_sum", "nnz")
    new_out = graft_ab["new (no window)"]()
    compare("graft_flagship[tail, no window, against the program]", new_out[:3],
            [out[2], out[3], out[4]], kept[:3])
    for name, fn in graft_ab.items():
        compare(f"A/B graft_flagship tail: {name} against new", fn()[:4], new_out[:4], kept)
    ab_time(f"dense_tail, graft_flagship program's tail ({B} x {C})", graft_ab, 10)
    del ta, new_out
    k_ms = cuda_ms(lambda: kernels._dense_input_filter_launch(*fa), 10)
    k_dev, _ = profiled_calls_ms(lambda: kernels._dense_input_filter_launch(*fa), 10)
    k_plain = cuda_ms(lambda: kernels.dense_input_filter_plain(*fa), 1)
    fb, fb_by = dense_input_filter_bound(fa, [out[0], out[1], out[5]])
    tb, tb_by = dense_tail_bound([out[0]], [torch.arange(B, device=dev)],
                                 args[SCHEDULE_ARGS.index("static_weight")],
                                 [[out[2], out[3], out[4]]])
    r = results["dense_input_filter"]
    r.update(max_abs_err=max(r["max_abs_err"], err), ms=k_ms, plain_ms=k_plain, bound_ms=fb,
             bound_by=fb_by, device_ms=k_dev)
    log(f"graft_flagship ({B}x{C}) on {smi}: dense views built and uploaded in {prep_s:.2f} s "
        f"(args {nbytes(args) / 1e9:.2f} GB); program {pct(total)} over {GRAFT_ROUNDS} calls "
        f"(filter {pct(filt_ms)}, tail {pct(tail_ms)}); _schedule_body on the card "
        f"{body_ms:.3f} ms; launches {launches}; equal to _schedule_body, to B3's feasible/"
        f"score/avail and to B4's result on its {n_tail} tail rows; dense_input_filter "
        f"{k_ms:.4f} ms, device {k_dev:.4f} (plain {k_plain:.3f}, bound {fb:.4f} {fb_by}); the "
        f"tail over every row "
        f"bound {tb:.4f} {tb_by}; {int(out[2].sum())} replicas placed")


def post_body(url, data: bytes) -> bytes:
    """POST JSON bytes; any status but 200 fails the run."""
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            if r.status != 200:
                raise AssertionError(f"{url}: HTTP {r.status}")
            return r.read()
    except urllib.error.HTTPError as e:
        raise AssertionError(f"{url}: HTTP {e.code}: {e.read()[:2000]!r}") from None


def run_shim_flagship(dev, smi, path_launches, flag):
    """The compact flagship through SchedulerShimServer on 127.0.0.1 in
    plain HTTP: its 5 000 clusters as cluster JSON, then its 10 000 specs
    (each template uid pinned to the binding's uid, as the reference's
    wire-parity test pins it) in one /v1/scheduleBatch, a warm round and
    SHIM_ROUNDS timed ones split at the shim's round; the results against
    the in-process card round on the same objects, item for item, and a
    SHIM_SAMPLE-row sample covering every strategy against the cpu
    round."""
    clusters, bindings = flag["clusters"], flag["bindings"]
    t0 = time.perf_counter()
    cluster_body = json.dumps({"items": [k8sjson.cluster_to_json(c) for c in clusters]}).encode()
    items = []
    for b in bindings:
        doc = k8sjson.binding_spec_to_json(b.spec)
        doc["resource"]["uid"] = b.metadata.uid
        items.append({"spec": doc})
    body = json.dumps({"items": items}).encode()
    encode_s = time.perf_counter() - t0
    srv = SchedulerShimServer(device=dev)
    srv.start()
    spans = []
    try:
        t0 = time.perf_counter()
        reply = json.loads(post_body(f"{srv.url}/v1/clusters", cluster_body))
        sync_s = time.perf_counter() - t0
        if reply != {"count": len(clusters)}:
            raise AssertionError(f"shim_flagship: /v1/clusters replied {reply}")
        kernels.reset_launches()
        for r in range(SHIM_ROUNDS + 1):
            t0 = time.perf_counter()
            raw = post_body(f"{srv.url}/v1/scheduleBatch", body)
            t1 = time.perf_counter()
            if r:
                spans.append((t0, *srv.shim.last_round, t1))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        srv.stop()
    got = json.loads(raw)["results"]
    expect_launches("shim_flagship", launches, {"candidate_select": SHIM_ROUNDS + 1,
                                                "candidate_tail": 2 * (SHIM_ROUNDS + 1)})
    add_launches(path_launches, launches, ("candidate_select", "candidate_tail"))

    in_proc = ArrayScheduler(clusters, device=dev)
    want = [decision_json(d) for d in in_proc.schedule(bindings)]
    # the round on objects it has encoded before (the batch encoder's row
    # cache hits), then the shim's round on freshly parsed objects
    t0 = time.perf_counter()
    in_proc.schedule(bindings)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    srv.shim.schedule_batch(items)
    torch.cuda.synchronize()
    fresh_s = srv.shim.last_round[1] - srv.shim.last_round[0]
    if len(got) != len(want):
        raise AssertionError(f"shim_flagship: {len(got)} results for {len(want)} bindings")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        raise AssertionError(f"shim_flagship: {len(bad)} results differ from the in-process "
                             f"card round, first row {bad[0]}: {got[bad[0]]} vs {want[bad[0]]}")
    rng = np.random.default_rng(3)
    sample = np.sort(rng.choice(len(bindings), SHIM_SAMPLE, replace=False))
    sub = [bindings[i] for i in sample]
    kinds = {strategy_code(b.spec.placement, b.spec.replicas) for b in sub}
    if not {DUPLICATED, STATIC_WEIGHT, DYNAMIC_WEIGHT, AGGREGATED} <= kinds:
        raise AssertionError(f"shim_flagship: the sample covers strategies {sorted(kinds)} only")
    t0 = time.perf_counter()
    cpu = [decision_json(d) for d in ArrayScheduler(clusters, device="cpu").schedule(sub)]
    cpu_s = time.perf_counter() - t0
    bad = [int(i) for i, c in zip(sample, cpu) if got[i] != c]
    if bad:
        raise AssertionError(f"shim_flagship: sample rows {bad[:5]} differ from the cpu round")
    wire = [a - t for t, a, _, _ in spans]
    rnd = [b - a for _, a, b, _ in spans]
    send = [t1 - b for _, _, b, t1 in spans]
    tot = [t1 - t for t, _, _, t1 in spans]
    placed = sum(1 for g in got if "suggestedClusters" in g)

    def p50(xs):
        return float(np.percentile(xs, 50))

    log(f"shim_flagship ({len(clusters)} clusters x {len(bindings)} specs over HTTP, body "
        f"{len(body) / 1e6:.1f} MB, reply {len(raw) / 1e6:.1f} MB) on {smi}: JSON built in "
        f"{encode_s:.2f} s, /v1/clusters {sync_s:.2f} s; /v1/scheduleBatch p50 {p50(tot):.4f} s "
        f"(max {max(tot):.4f} s) over {SHIM_ROUNDS} rounds = wire + parse {p50(wire):.4f} s, "
        f"round {p50(rnd):.4f} s, encode + send {p50(send):.4f} s; launches {launches}; "
        f"{placed} placed; every result equals the in-process card round, and the "
        f"{SHIM_SAMPLE}-row sample (strategies {sorted(kinds)}) the cpu round ({cpu_s:.1f} s); "
        f"in process, the round on objects encoded before {warm_s:.4f} s, on freshly "
        f"parsed objects {fresh_s:.4f} s")


def run_graft_cells(dev, smi, path_launches, results, d_sched, d_bindings, flag):
    """graft_example, graft_flagship (on the dense flagship's scheduler),
    shim_flagship (on the compact flagship's objects) and shim_contract."""
    run_graft_example(dev, path_launches)
    run_graft_flagship(dev, smi, path_launches, results, d_sched, d_bindings)
    gc.collect()
    torch.cuda.empty_cache()
    run_shim_flagship(dev, smi, path_launches, flag)
    run_shim_contract(dev)


# --------------------------------------------------------------------------
# the mesh-sharded solve (B15): the tile filter, and the monolithic mesh
# round over a virtual mesh of the card (every card when there are several)
# --------------------------------------------------------------------------


def mesh_of(dev, shape) -> Mesh:
    """A (bindings, clusters) mesh of the given shape, every position `dev`."""
    grid = np.empty(shape[0] * shape[1], dtype=object)
    grid[:] = [dev] * grid.size
    return Mesh(grid.reshape(shape))


def random_tile_inputs(seed, dev, B, C, grid, shift=0):
    """Seeded full-width filter inputs (random_select_inputs's: tie-heavy,
    prev / evict ids anywhere in [-2, C + 3) with the sentinel C and a
    column listed twice, answers with -1s) at B x C, the fleet padded with
    dead columns to a multiple of the clusters axis Cp (the 2 x 3 cut's
    tiles are then no multiple of 32 wide), plus a random mask and score;
    then every (row group, column shard) tile's mesh_tile_filter
    arguments, the terms as column views of their row-group blocks. A
    `shift` moves every tile `shift` columns right (the fleet padded by as
    many more dead columns; the first `shift` columns in no tile), so the
    tiles' first columns and term views lie off a multiple of 4 where the
    tile widths do not."""
    rng = np.random.default_rng(seed)
    a = dict(zip(FLEET + SELECT_BATCH + ("extra_avail",), random_select_inputs(rng, dev, B, C)))
    mb, mc = grid
    Cp = -(-C // mc) * mc + shift
    if Cp > C:  # dead pad clusters: every fleet field 0 (alive False)
        pad = Cp - C
        for n in FLEET:
            a[n] = torch.cat([a[n], a[n].new_zeros((pad,) + tuple(a[n].shape[1:]))])
        for n, fill in (("aff_masks", False), ("extra_avail", -1)):
            a[n] = torch.cat([a[n], a[n].new_full((a[n].shape[0], pad), fill)], 1)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    a["extra_mask"] = torch.rand((B, Cp), device=dev, generator=g) < 0.85
    a["extra_score"] = torch.randint(-5, 60, (B, Cp), device=dev, generator=g, dtype=torch.int32)
    Bl, Cl = B // mb, (Cp - shift) // mc
    tiles = []
    for r in range(mb):
        rows = slice(r * Bl, (r + 1) * Bl)
        for j in range(mc):
            cols = slice(shift + j * Cl, shift + (j + 1) * Cl)
            args = [a[n][cols] for n in FLEET] + [
                a[n] if n in ("tol_tables", "req_unique") else
                a[n][:, cols].contiguous() if n == "aff_masks" else a[n][rows]
                for n in SELECT_BATCH
            ] + [a[n][rows, cols] for n in ("extra_avail", "extra_mask", "extra_score")]
            tiles.append((args, {"col0": shift + j * Cl, "plugin_bits": ALL_PLUGIN_BITS}))
    return tiles


def tile_filter_bound(calls, outs):
    """dense_filter_bound over the tiles of one pass: every input read once
    (the terms' tile views at their own size), every output written once,
    and per element the filter chain, the estimate and the tie."""
    moved, ops = 0, 0
    for (args, _), o in zip(calls, outs):
        B, C = args[7].shape[0], args[0].shape[0]
        T, Kp, Ke, R = args[3].shape[1], args[14].shape[1], args[16].shape[1], args[1].shape[1]
        moved += nbytes(args) + nbytes(o)
        ops += B * C * (T + Kp + Ke + 4 * R + 24)
    return bound(moved, ops)


def check_mesh_tile_filter(dev, results, B, C):
    """Phase 3 for the mesh tile filter: seeded inputs at the dense
    flagship's B x C cut into each of MESH_GRIDS and into 2 x 2 tiles
    shifted by MESH_SHIFT columns (the scalar path at widths that are
    multiples of 4), every tile against its plain version exactly, with all
    three terms and with none. Its time on the main path's own arguments
    comes with the mesh_flagship cell."""
    err, seen = 0, []
    for grid, shift in [(g, 0) for g in MESH_GRIDS] + [((2, 2), MESH_SHIFT)]:
        tiles = random_tile_inputs(70 + sum(grid) + shift, dev, B, C, grid, shift=shift)
        for k, (args, kw) in enumerate(tiles):
            for terms in (True, False):
                a = args if terms else args[:-3] + [None, None, None]
                err = max(err, compare(f"mesh_tile_filter[random {grid}, shift {shift}, tile {k}, "
                                       f"terms {terms}]",
                                       kernels._mesh_tile_filter_launch(*a, **kw),
                                       kernels.mesh_tile_filter_plain(*a, **kw), FILTER_OUT))
        k_ms = cuda_ms(lambda: [kernels._mesh_tile_filter_launch(*a, **kw) for a, kw in tiles], 5)
        seen.append(f"{grid} tiles {tiles[0][0][0].shape[0]} wide, first columns "
                    f"{[kw['col0'] for _, kw in tiles[:grid[1]]]}: one pass {k_ms:.4f} ms")
        del tiles
    results["mesh_tile_filter"] = dict(
        source="karmada_tpu_torch/kernels/csrc/dense_filter.cu",
        replaces="karmada_tpu/parallel/mesh.py:156", max_abs_err=err, ms=None, plain_ms=None,
        bound_ms=None, bound_by=None, library_ms=None)
    log(f"random inputs ({B}x{C} cut into {MESH_GRIDS}, and 2 x 2 shifted by {MESH_SHIFT}, "
        f"prev / evict ids in other tiles and at "
        f"the sentinel, answers with -1s, a random mask and score): every mesh_tile_filter "
        f"tile equals its plain version exactly, with the terms and without; timing with the "
        f"terms: {'; '.join(seen)}")


def with_tile_terms(calls, seed):
    """Captured tile filter calls, each with seeded answers (-1s among
    them), mask and score as column views of [B_l, Cp] row blocks at the
    tile's first column, as the mesh kernel passes its terms (Cp the
    padded width the tiles cut: the last tile's end)."""
    Cp = max(kw["col0"] + a[0].shape[0] for a, kw in calls)
    g = torch.Generator(device=calls[0][0][0].device)
    g.manual_seed(seed)
    out = []
    for a, kw in calls:
        B, C, c0 = a[7].shape[0], a[0].shape[0], kw["col0"]
        dev = a[0].device

        def block(lo, hi, dtype):
            return torch.randint(lo, hi, (B, Cp), device=dev, generator=g,
                                 dtype=dtype)[:, c0:c0 + C]
        mask = torch.rand((B, Cp), device=dev, generator=g)[:, c0:c0 + C] < 0.85
        out.append((a[:-3] + [block(-1, 40, torch.int32), mask, block(-5, 60, torch.int32)],
                    kw))
    return out


def check_captured_tiles(label, calls, seed):
    """Every captured tile call, as captured and with seeded terms, against
    the plain version; returns the largest difference."""
    err = 0
    for terms, cs in (("", calls), (", seeded terms", with_tile_terms(calls, seed))):
        for k, (a, kw) in enumerate(cs):
            err = max(err, compare(f"mesh_tile_filter[captured {label} tile {k}{terms}]",
                                   kernels._mesh_tile_filter_launch(*a, **kw),
                                   kernels.mesh_tile_filter_plain(*a, **kw), FILTER_OUT))
    return err


@contextlib.contextmanager
def mesh_marks(marks):
    """CUDA events around the mesh round's kernels: marks[-1] gets
    ("tile_start", event) and ("tile_end", ...) around each tile filter,
    ("tail_start", ...) and ("tail_end", ...) around each tail, and
    ("run_end", ...) when the mesh kernel returns (the row groups
    concatenated)."""
    tile, tail, run = kernels.mesh_tile_filter, kernels.dense_tail, MeshScheduleKernel.run

    def record(kind):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1].append((kind, ev))

    def marked_tile(*a, **kw):
        record("tile_start")
        out = tile(*a, **kw)
        record("tile_end")
        return out

    def marked_tail(*a, **kw):
        record("tail_start")
        out = tail(*a, **kw)
        record("tail_end")
        return out

    def marked_run(self, *a, **kw):
        out = run(self, *a, **kw)
        record("run_end")
        return out

    kernels.mesh_tile_filter, kernels.dense_tail = marked_tile, marked_tail
    MeshScheduleKernel.run = marked_run
    try:
        yield
    finally:
        kernels.mesh_tile_filter, kernels.dense_tail = tile, tail
        MeshScheduleKernel.run = run


def single_device_outputs(sched, batch):
    """The ten outputs of the single-device solve of a padded batch on the
    scheduler's device: B3 over every row, then B4 over every row with the
    mesh's window (the comparison's launches, not counted)."""
    dev = sched.device
    t = batch_from_numpy({n: getattr(batch, n) for n in SELECT_BATCH + (
        "strategy", "fresh", "weight_tables", "weight_idx")}, dev)
    filt = kernels._dense_filter_launch(
        *[sched._fleet_dev[n] for n in FLEET], *[t[n] for n in SELECT_BATCH], None,
        plugin_bits=sched._plugin_bits)
    feas, score, avail, prev, tie, fc = filt
    B, C = feas.shape
    tail = kernels._dense_tail_launch(
        feas, avail, prev, tie, torch.arange(B, dtype=torch.int32, device=dev),
        t["weight_tables"], t["weight_idx"], t["strategy"], t["replicas"], t["fresh"],
        topk=min(C, TOPK_TARGETS), has_agg=bool((batch.strategy == AGGREGATED).any()))
    result, unsched, avail_sum, nnz, top_idx, top_val = tail
    return feas, score, result, unsched, avail_sum, avail, fc, nnz, top_idx, top_val


def mesh_cell(label, dev, smi, mesh, clusters, bindings, card_decisions, rounds):
    """One mesh cell: ArrayScheduler(clusters, mesh=mesh, candidate_k=0) in
    the monolithic mode, a warm round and `rounds` timed ones (launches
    checked per round; CUDA events split tile filters / gathers / tails on
    a virtual mesh, a stage timer the host's encode / dispatch /
    materialize), decisions against the single-device card round on every
    row (targets and errors: the monolithic round, as the reference's,
    lists feasible clusters only for non-workload and spread rows) and
    against the cpu mesh round on a MESH_SAMPLE-row sample (everything),
    and the mesh kernel's ten outputs against the single-device B3 + B4 on
    the whole batch. Returns (launches, the scheduler, its padded batch)."""
    sched = ArrayScheduler(clusters, mesh=mesh, candidate_k=0, device=dev)
    sched.mesh_partitioned = False
    virtual = len({str(d) for d in mesh.devices.flat}) == 1
    n_tiles = mesh.devices.size
    expect = {"mesh_tile_filter": n_tiles, "dense_tail": mesh.shape["bindings"]}
    marks, stages = [], []

    def run():
        marks.append([])
        timer = StageTimer()
        with sched.pipeline_context(timer):
            out = sched.schedule(bindings)
        stages.append(timer.totals)
        return out

    ctx = mesh_marks(marks) if virtual else contextlib.nullcontext()
    with ctx:
        decisions, launches, times = drive(label, sched, bindings, rounds, expect, smi, run=run)
    p50 = float(np.percentile(times, 50))
    split = "not measured (cards of a real mesh run side by side)"
    if virtual:
        spans = {k: [] for k in ("total", "tiles", "tails", "between", "concat")}
        for m in marks[1:]:
            ev = {k: [e for kk, e in m if kk == k]
                  for k in ("tile_start", "tile_end", "tail_start", "tail_end", "run_end")}
            total = ev["tile_start"][0].elapsed_time(ev["run_end"][-1])
            tiles = sum(a.elapsed_time(b) for a, b in zip(ev["tile_start"], ev["tile_end"]))
            tails = sum(a.elapsed_time(b) for a, b in zip(ev["tail_start"], ev["tail_end"]))
            concat = ev["tail_end"][-1].elapsed_time(ev["run_end"][-1])
            for k, v in (("total", total), ("tiles", tiles), ("tails", tails), ("concat", concat),
                         ("between", total - tiles - tails - concat)):
                spans[k].append(v)
        p = {k: float(np.percentile(v, 50)) for k, v in spans.items()}
        split = (f"device p50 by CUDA events: {p['total']:.3f} ms from the first tile filter to "
                 f"the mesh kernel's return = tile filters {p['tiles']:.3f} + shard uploads, "
                 f"gathers and count sums {p['between']:.3f} + tails {p['tails']:.3f} + the row "
                 f"groups' concatenation {p['concat']:.3f} ms (virtual: every tile in turn on "
                 f"one card)")
    host = {k: float(np.percentile([s.get(k, 0.0) for s in stages[1:]], 50))
            for k in ("encode", "solve", "materialize")}
    log(f"{label} breakdown: host p50 encode {host['encode']:.4f} s, dispatch (solve) "
        f"{host['solve']:.4f} s, materialize (wait + copy back + decode) "
        f"{host['materialize']:.4f} s of the p50 round {p50:.4f} s; {split}")

    got = [decision_view(d) for d in decisions]
    want = [decision_view(d) for d in card_decisions]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g[:4] != w[:4]]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{label}: {len(bad)} rows differ from the single-device card "
                             f"round, first {bad[:1]}")
    rng = np.random.default_rng(9)
    idx = np.sort(rng.choice(len(bindings), MESH_SAMPLE, replace=False))
    cpu = ArrayScheduler(clusters, mesh=mesh_of("cpu", tuple(mesh.devices.shape)),
                         candidate_k=0, device="cpu")
    cpu.mesh_partitioned = False
    t0 = time.perf_counter()
    want = [decision_view(d) for d in cpu.schedule([bindings[i] for i in idx])]
    cpu_s = time.perf_counter() - t0
    bad = [int(i) for i, w in zip(idx, want) if got[i] != w]
    if bad:
        raise AssertionError(f"{label}: sample rows {bad[:5]} differ from the cpu mesh round")
    raw = sched.batch_encoder.encode(bindings)
    batch = sched._pad(raw)
    mesh_out = sched._mesh_solver()(batch)
    one = single_device_outputs(sched, batch)
    B, C = one[0].shape
    compare(f"{label}[mesh kernel, single-device B3 + B4]",
            [x[:B, :C] if x.dim() == 2 and k not in (8, 9) else x[:B]
             for k, x in enumerate(mesh_out)], one, MESH_OUT)
    placed = sum(1 for d in decisions if d.ok)
    log(f"{label} ({len(clusters)} clusters x {len(bindings)} bindings, fleet width "
        f"{len(sched.fleet.names)}, mesh {mesh.shape}{' virtual' if virtual else ''}): "
        f"{placed} placed; targets and errors equal the single-device card round on every "
        f"row, every field the cpu mesh round on a {MESH_SAMPLE}-row sample ({cpu_s:.1f} s); "
        "the mesh kernel's ten outputs equal the single-device B3 + B4 on the whole batch")
    del mesh_out, one
    return launches, sched, batch


def run_mesh_cells(dev, smi, path_launches, results, clusters, bindings, card_decisions):
    """mesh_flagship (the dense flagship's bindings over a 2 x 2 virtual
    mesh of the card), the tile filter on the arguments one of its rounds
    passes it (captured) with its times and bound, one 2 x 3 round at the
    same width (C padded to a multiple of 3), and the cell over every card
    when there are several."""
    launches, sched, batch = mesh_cell("mesh_flagship", dev, smi, virtual_mesh(4, dev),
                                       clusters, bindings, card_decisions, MESH_ROUNDS)
    add_launches(path_launches, launches, ("mesh_tile_filter", "dense_tail"))
    with captured_launches(["mesh_tile_filter"]) as cap:
        sched._mesh_solver()(batch)
    torch.cuda.synchronize()
    calls = cap["mesh_tile_filter"]
    err = check_captured_tiles("mesh_flagship", calls, 91)
    k_ms = cuda_ms(lambda: [kernels._mesh_tile_filter_launch(*a, **kw) for a, kw in calls], 10)
    k_dev, k_by = profiled_calls_ms(
        lambda: [kernels._mesh_tile_filter_launch(*a, **kw) for a, kw in calls], 10)
    k_plain = cuda_ms(lambda: [kernels.mesh_tile_filter_plain(*a, **kw) for a, kw in calls], 1)
    outs = [kernels._mesh_tile_filter_launch(*a, **kw) for a, kw in calls]
    tb, tb_by = tile_filter_bound(calls, outs)
    B, Cp = batch.replicas.shape[0], sched._mesh_kernel.padded_clusters
    gather_b, _ = bound(2 * 17 * B * Cp, 0)  # the five tile outputs read and written once
    one = single_device_outputs(sched, batch)
    tail_b, _ = dense_tail_bound([one[0]], [torch.arange(B, device=dev)],
                                 batch_from_numpy({"w": batch.weight_tables}, dev)["w"],
                                 [[one[2], one[3], one[4], one[7], one[8], one[9]]])
    r = results["mesh_tile_filter"]
    r.update(max_abs_err=max(r["max_abs_err"], err), ms=k_ms, plain_ms=k_plain, bound_ms=tb,
             bound_by=tb_by, device_ms=k_dev)
    log(f"mesh_tile_filter on one mesh_flagship round's {len(calls)} tiles (captured, "
        f"{calls[0][0][7].shape[0]} x {calls[0][0][0].shape[0]} each): equal to the plain version, "
        f"as captured and with seeded terms; {k_ms:.4f} ms for the round's tiles, device "
        f"{k_dev:.4f} ({_events_text(k_by)}) (plain {k_plain:.3f}, bound {tb:.4f} {tb_by}); "
        f"B15's bound per round: tiles {tb:.4f} + gathers {gather_b:.4f} (bytes) + tails "
        f"{tail_b:.4f} = {tb + gather_b + tail_b:.4f} ms")
    del calls, cap, outs, one
    gc.collect()
    torch.cuda.empty_cache()
    launches, sched, batch = mesh_cell("mesh_flagship 2x3 (ragged)", dev, smi,
                                       mesh_of(dev, (2, 3)), clusters, bindings, card_decisions, 1)
    add_launches(path_launches, launches, ("mesh_tile_filter", "dense_tail"))
    with captured_launches(["mesh_tile_filter"]) as cap:
        sched._mesh_solver()(batch)
    torch.cuda.synchronize()
    calls = cap["mesh_tile_filter"]
    err = check_captured_tiles("2x3", calls, 92)
    r["max_abs_err"] = max(r["max_abs_err"], err)
    k_ms = cuda_ms(lambda: [kernels._mesh_tile_filter_launch(*a, **kw) for a, kw in calls], 10)
    k_dev, _ = profiled_calls_ms(
        lambda: [kernels._mesh_tile_filter_launch(*a, **kw) for a, kw in calls], 10)
    log(f"mesh_tile_filter on the 2 x 3 round's {len(calls)} tiles (captured, "
        f"{calls[0][0][7].shape[0]} x {calls[0][0][0].shape[0]} each, first columns "
        f"{[kw['col0'] for _, kw in calls[:3]]}): equal to the plain version, as captured and "
        f"with seeded terms; {k_ms:.4f} ms for the round's tiles, device {k_dev:.4f}")
    del calls, cap, sched, batch
    n = torch.cuda.device_count()
    if n >= 2:
        launches, _, _ = mesh_cell(f"mesh_flagship over {n} cards", dev, smi, make_mesh(),
                                   clusters, bindings, card_decisions, MESH_ROUNDS)
        add_launches(path_launches, launches, ("mesh_tile_filter", "dense_tail"))
    else:
        log("mesh_flagship: one card visible; only the virtual meshes ran")
    gc.collect()
    torch.cuda.empty_cache()


def run_shim_contract(dev):
    """The reference shim contract's cases through the port's shim on the
    card (karmada_tpu_torch/testing/shim_contract.py)."""
    for case in CONTRACT_CASES:
        case(dev)
    torch.cuda.synchronize()
    log(f"shim_contract: {len(CONTRACT_CASES)} contract cases pass on the card "
        f"({', '.join(c.__name__[5:] for c in CONTRACT_CASES)})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--only", choices=("kernels", "sim", "graft", "mesh", "tiers", "refresh"),
                    help="build every kernel, run one group of phases, print no result line")
    opts = ap.parse_args(sys.argv[1:] if argv is None else argv)
    only = opts.only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card only",
              file=sys.stderr)
        return 2
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    log(f"build: {len(libs)} kernel sources in {time.perf_counter() - t0:.1f} s")
    if only == "tiers":
        results = {}
        check_tier_kernels(dev, results)
        log(f"--only tiers: the tier kernels passed ({json.dumps(results)}); no other kernel "
            "or cell was run")
        return 0
    if only == "refresh":
        results, path_launches = {}, {}
        check_scatter_rows(dev, results)
        clusters, bindings = build_churn()
        run_churn_dirty(dev, smi, path_launches, clusters, bindings,
                        {"candidate_select": 1, "candidate_tail": 2})
        log(f"--only refresh: scatter_rows and churn_dirty passed ({json.dumps(results)}; "
            f"launches {path_launches}); no other kernel or cell was run")
        return 0
    if only == "sim":
        results, path_launches = {}, {}
        check_sim_kernels(dev, results)
        run_sim_cells(dev, smi, path_launches)
        log(f"--only sim: the simulation kernels and cells passed (launches {path_launches}); "
            "no earlier kernel or cell was run")
        print(json.dumps({"ab": AB}), flush=True)
        return 0

    # ---- the flagship schedulers (their batches feed phase 3 too) ----
    t0 = time.perf_counter()
    clusters, bindings = build_flagship()
    sched = ArrayScheduler(clusters, device=dev)
    d_clusters, d_bindings = build_flagship(dense=True)
    d_sched = ArrayScheduler(d_clusters, device=dev)
    names = [c.name for c in clusters]
    flag = {"clusters": clusters, "bindings": bindings, "names": names,
            "members": estimator_members(names)}
    log(f"flagship: {len(clusters)} clusters x {len(bindings)} bindings, compact and dense "
        f"(dense-solve), with member estimators over "
        f"{sum(m.node_estimator.arrays.n_nodes for m in flag['members'].values())} shard_nodes "
        f"nodes, built in {time.perf_counter() - t0:.1f} s (fleet width "
        f"{len(sched.fleet.names)})")
    results = {}
    if only == "graft":
        path_launches = {}
        check_dense_input_filter(dev, results, shape_bucket(len(d_bindings)),
                                 len(d_sched.fleet.names))
        run_graft_cells(dev, smi, path_launches, results, d_sched, d_bindings, flag)
        log(f"--only graft: the dense-input filter and the graft and shim cells passed "
            f"(launches {path_launches}); no earlier kernel or cell was run")
        print(json.dumps({"ab": AB}), flush=True)
        return 0
    if only == "mesh":
        path_launches = {}
        check_mesh_tile_filter(dev, results, shape_bucket(len(d_bindings)),
                               len(d_sched.fleet.names))
        d_decisions = d_sched.schedule(d_bindings)
        del d_sched
        run_mesh_cells(dev, smi, path_launches, results, d_clusters, d_bindings, d_decisions)
        log(f"--only mesh: the tile filter and the mesh cells passed (launches "
            f"{path_launches}); no other kernel or cell was run")
        return 0

    # ---- phase 3: kernels against their plain versions on the card ----
    compact_ms = check_compact_kernels(sched, bindings, dev, results)
    dense_ms = check_dense_kernels(d_sched, d_bindings, dev, results)
    check_dense_input_filter(dev, results, shape_bucket(len(d_bindings)),
                             len(d_sched.fleet.names))
    check_mesh_tile_filter(dev, results, shape_bucket(len(d_bindings)), len(d_sched.fleet.names))
    # one round each of configs 4, 4b and drain (their bindings are built
    # again in phase 4, so no earlier cell's garbage collections walk them)
    check_spread_kernels(dev, results)
    check_tier_kernels(dev, results)
    check_estimator_kernels(dev, results, flag)
    check_scatter_rows(dev, results)
    check_wide_tail(dev, results, flag)
    select_err = check_wide_select(dev)
    check_sim_kernels(dev, results)
    gc.collect()
    torch.cuda.empty_cache()
    if only == "kernels":
        log("--only kernels: phase 3 passed; no main path was run")
        print(json.dumps({"ab": AB}), flush=True)
        return 0

    # ---- phase 4: the main paths ----
    path_launches = {}
    decisions, launches, times = drive(
        "compact flagship round", sched, bindings, TIMED_ROUNDS,
        {"candidate_select": 1, "candidate_tail": 2}, smi)
    path_launches.update({n: launches[n] for n in ("candidate_select", "candidate_tail")})
    log(f"candidate stats {sched.last_candidate_stats}")
    round_breakdown("compact flagship", sched, bindings, compact_ms,
                    float(np.percentile(times, 50)))
    hold_against_cpu("compact flagship", clusters, bindings, decisions)
    check_solve_syncs("compact flagship", sched, bindings, decisions)

    decisions, launches, times = drive(
        "dense flagship round (reason policy)", d_sched, d_bindings, TIMED_ROUNDS,
        {"dense_filter": 1, "dense_tail": 2, "feas_idx": 1}, smi)
    path_launches.update({n: launches[n] for n in ("dense_filter", "dense_tail", "feas_idx")})
    round_breakdown("dense flagship", d_sched, d_bindings, dense_ms,
                    float(np.percentile(times, 50)))
    hold_against_cpu("dense flagship", d_clusters, d_bindings, decisions)
    check_solve_syncs("dense flagship", d_sched, d_bindings, decisions)
    run_graft_cells(dev, smi, path_launches, results, d_sched, d_bindings, flag)
    del d_sched
    run_mesh_cells(dev, smi, path_launches, results, d_clusters, d_bindings, decisions)

    w_clusters, w_bindings = build_flagship(dense=True, whole_fleet_dup=True)
    w_sched = ArrayScheduler(w_clusters, device=dev)
    decisions, launches, _ = drive(
        "dense flagship, Duplicated over the whole fleet", w_sched, w_bindings, VARIANT_ROUNDS,
        {"dense_filter": 1, "dense_tail": 2, "pack_rows": 1}, smi)
    path_launches["pack_rows"] = launches["pack_rows"]
    hold_against_cpu("whole-fleet Duplicated", w_clusters, w_bindings, decisions)
    check_solve_syncs("whole-fleet Duplicated", w_sched, w_bindings, decisions)
    del w_sched

    s_clusters, s_bindings = build_static()
    decisions, _, _ = drive("config 2 (build_static, reason small_fleet)",
                            ArrayScheduler(s_clusters, device=dev), s_bindings, TIMED_ROUNDS,
                            {"dense_filter": 1, "dense_tail": 1}, smi)
    hold_against_cpu("config 2", s_clusters, s_bindings, decisions)

    c_clusters, c_bindings = build_dup3()
    decisions, _, _ = drive("config 1 (build_dup3, reason small_fleet)",
                            ArrayScheduler(c_clusters, device=dev), c_bindings, TIMED_ROUNDS,
                            {"dense_filter": 1, "feas_idx": 1}, smi)
    hold_against_cpu("config 1", c_clusters, c_bindings, decisions)

    for cell, build_cell, expect in SPREAD_CELLS:
        clusters_s, bindings_s = build_cell()
        sched_s = ArrayScheduler(clusters_s, device=dev)
        decisions, launches, times = drive(
            f"{cell} (spread)", sched_s, bindings_s,
            WINDOW_ROUNDS if cell == "window" else SPREAD_ROUNDS, expect, smi)
        for n in ("group_score", "packed_selection", "spread_tail", "combo_select"):
            path_launches[n] = path_launches.get(n, 0) + launches[n]
        round_breakdown(cell, sched_s, bindings_s, None, float(np.percentile(times, 50)))
        hold_against_cpu(cell, clusters_s, bindings_s, decisions)
        del sched_s, clusters_s, bindings_s, decisions

    run_tier_cells(dev, smi, path_launches)
    run_estimator_cells(dev, smi, path_launches, flag, results)
    run_churn_cells(dev, smi, path_launches, compact_ms)
    run_wide_cells(dev, smi, path_launches, flag, results, select_err)
    run_sim_cells(dev, smi, path_launches)

    # every kernel of a main path launched there; staleness_penalty serves
    # callers that hold an answer matrix on the card, and no path does: the
    # registry decays its stale columns in numpy, as the reference does;
    # candidate_select_wide serves fleets past the in-block route's ~54 500
    # columns, wider than any cell here (wide_40k's 20 480 stay in the block)
    off_path = ("staleness_penalty", "candidate_select_wide")
    idle = [n for n in results if n not in off_path and not path_launches.get(n)]
    if idle:
        raise AssertionError(f"kernels of the main paths never launched there: {idle}")
    log("launches over every drive() of the run (every cell's warm and timed rounds): "
        + json.dumps({n: c for n, c in ALL_PATH_LAUNCHES.items() if c}))
    print(json.dumps({"ab": AB}), flush=True)
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": path_launches.get(n, 0), "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "device_ms": r.get("device_ms"), "matches_plain": True,
         **{k: v for k, v in r.items()
            if k == "host_ms" or k.startswith(("window_", "estimator_", "drain_"))}}
        for n, r in results.items()
    ]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
