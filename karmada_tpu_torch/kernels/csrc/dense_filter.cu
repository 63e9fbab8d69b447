// dense_filter: phase 1 of the dense schedule round, and the three filters
// built on the same design (sim_filter, dense_input_filter,
// mesh_tile_filter).
//
// dense_filter replaces karmada_tpu/sched/core.py:452 `_filter_kernel_compact`
// (with decompress_batch's prev/evict scatters, `_device_tie` and
// filter_estimate_phase fused in). For every binding row b and cluster
// column c of the full [B, C] grid: feasibility under the in-tree filters,
// the locality score, the GeneralEstimator answer (min over requested
// resources of cap // req, with the reference's clamps in its order) and
// its min-merge with a registered-estimator answer, the previous replicas
// (the row's prev list scattered, last entry wins, ids outside [0, C)
// dropped), and the splitmix64 tie over the global cluster id; plus the
// row's feasible count. An optional per-row mask (bool [B, C], the
// reference's `extra_mask` of filter_phase,
// karmada_tpu/sched/core.py:178-179: the spread
// selection of a per-row re-solve when the ClusterAffinity plugin is off)
// is ANDed into the feasibility before the count.
//
// What bounds every entry on an H100: each writes four i32 and one bool
// output per element (or three i32, or one i32 and one bool) and reads at
// most a few bytes per element, so each is bound by memory bandwidth (about
// 0.9 GB at 10240 x 5120 for dense_filter). Most of an element's work
// depends on fewer indices than (b, c), so it is split as the reference's
// own estimate is (ops/assign.py general_estimate_unique, then
// general_estimate_apply): tables per distinct request and per distinct
// toleration row, then a pass that reads them.
//
// The factored entries (dense_filter, sim_filter, mesh_tile_filter), whose
// batch is already factored (models/batch.py: U distinct requests, Tt
// toleration tables), run two launches on the stream:
// - factor_kernel builds est_u [U, C] (i32: the minimum over requested
//   resources of cap // req through capped_div.cuh, 0 without a summary,
//   kEstReplicas for "the row's replicas" where no resource is requested
//   or the minimum reaches INT32_MAX), col_ok [Tt, C] (alive, and every
//   NoSchedule / NoExecute taint tolerated by table t) and api_t [G, C]
//   (api_ok transposed), from the fleet it is passed (the tiered launch
//   passes its own capacity, a mesh tile its own column slice); it also
//   zeroes the feasible counts. That is U C R divisions and Tt C T Kt
//   compares, never more than the per-element form's B C R and B C T Kt.
// - filter_main_kernel<kVec, kMode>, grid (column tiles, groups of 32
//   rows), 256 threads, each owning 4 adjacent columns of one row (32-256
//   threads a row, so narrow fleets run several rows side by side; fewer
//   where the tiles then pad C less, and for a mesh tile fewer while its
//   blocks are under eight a SM): the
//   block scatters each step's prev / evict lists into shared slots (last
//   prev entry wins through a 64-bit atomicMax on (k + 1) << 32 |
//   replicas), then every thread reads its columns from the tables (4-byte
//   loads of col_ok, api_t, the affinity row and the mask, 16-byte loads of
//   est_u and of the answers), applies the row's own clamps (replicas,
//   unknown_request, the answers' min-merge), sets the score (100 on a prev
//   column with the locality plugin on) and the tie (splitmix64 at the
//   global column id), and writes feasible as one 32-bit word and score,
//   avail, prev and tie as 16-byte stores; the feasible count is a warp sum
//   and one atomic a warp. kVec = false (C % 4 != 0, a tile's first column
//   or a term's row stride no multiple of 4, or the caller's answers, mask,
//   score or affinity table off alignment) takes 4-byte accesses
//   throughout.
//
// sim_filter, the second entry: the same filter and estimate over a
// scenario-stacked fleet, the first launch of the simulation plane's
// solve. Replaces the filter half of karmada_tpu/simulation/engine.py:261
// `_sim_kernel` (its decompress of the factored batch, then
// `_schedule_body`'s filter_estimate_phase under `jax.vmap` over the
// scenario axis, with the tie from `tie_from_index(seeds, tie_idx[s])`).
// It writes feasible, avail, prev and tie as [S, B, C] and the feasible
// count as [S, B] (no score: the simulation drops it). The same two
// launches, per scenario (grid z): factor_kernel builds est_u [S, U, C],
// col_ok [S, Tt, C] and api_t [S, G, C], and filter_main_kernel<kVec,
// kSim> stages its tile's tie indices once and writes the rows without the
// score and the mask. The tie comes from the scenario's 1-based present
// rank tie_idx[s, c] (a drained column repeats its neighbour's rank, but
// is never feasible), and extra_avail, shared by every scenario, is read
// at (b, c).
//
// mesh_tile_filter, the fourth entry: the tile filter of the mesh solve.
// Replaces the per-device half of karmada_tpu/parallel/mesh.py:156
// `_sharded_body` (decompress_batch with `col_offset`, core.py:363-393,
// then filter_estimate_phase on the local tile) together with the
// elementwise terms the reference applies after its all_gather (:208-219:
// the out-of-tree mask ANDed into feasibility, the score added, the
// registered-estimator answers min-merged where >= 0). One [B_l, C_l] tile
// of the global [Bp, Cp] problem whose first column is col0, through the
// same two launches (filter_main_kernel<kVec, kTile>): the fleet slice and
// the affinity table's column slice are the tile's own (C = C_l), so are
// the tables; the prev / evict lists hold GLOBAL column ids, made
// tile-local as they are staged (an id outside [col0, col0 + C_l), the Cp
// sentinel included, is skipped); the tie is splitmix64 at col0 + c; and
// the three [B_l, C_l] terms are read in place through their row strides
// (column slices of the row group's [B_l, Cp] blocks; null when absent),
// the score added as a wrapping int32 add. Since the terms are
// elementwise, applying them per tile equals applying them after the
// gather.
//
// dense_input_filter, the third entry: the filter half of the dense-input
// schedule program. Replaces karmada_tpu/sched/core.py:190-226
// filter_estimate_phase and the extra_avail min-merge of core.py:311, as
// core.py:320 `_schedule_kernel` runs them (every in-tree plugin on) over
// fully dense inputs: the tolerations as four [B, K] tables, the affinity,
// eviction and previous-membership masks as bool [B, C], the request as
// i64 [B, R] and the answers as i32 [B, C] (-1 = none). It writes
// feasible, score and avail only; the program's prev_replicas and tie are
// inputs that go to the tail as they are. Its inputs carry no factored
// index, so the factoring happens inside the kernel, over groups of 32
// rows: dense_input_group_kernel<kVec>, grid (column tiles of 256 columns,
// 128 for fleets of at most 128; about eight blocks a SM that stride over
// the row groups), 256 threads. A block stages its group's request rows
// and toleration rows (as int4 (key, value, effect, op), the row's gvk
// appended, so the API filter joins the toleration table) in shared
// memory and finds for each row the table entry it keeps for an equal row
// (a word hash, then an exact compare), else a new entry per distinct row
// (its first equal row in the group). A new entry's table rows over the
// tile's columns are built once, a thread a column: the estimate
// (factor_estimate's rule, the kEstReplicas sentinel, each cap // req
// through capped_div::floor_div_rcp from the request's reciprocal, one
// high multiply and one correction) and the column-ok bits (alive, api_ok
// at the gvk, every NoSchedule / NoExecute taint tolerated, four taints
// against each 16-byte toleration; a ballot word per 32 columns). The
// entries (up to 32 a kind) carry over to the block's next group, and are
// dropped together when a group's new rows do not fit. Then each row reads
// its two table rows and applies its own masks and clamps in the
// reference's order, 4 adjacent columns a thread: 4-byte loads of the
// three masks, a 16-byte load of the answers, feasible as one 32-bit word
// and score and avail as 16-byte stores (scalar where C % 4 != 0 or a base
// is off alignment). Every row distinct does the per-element form's work
// with a multiply in place of each int64 division, and never more; rows
// that repeat (the flagship's 4 requests over 10 240 rows) are tabulated
// once a block.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry points at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "capped_div.cuh"
#include "filter_common.cuh"
#include "vec4.cuh"

namespace {

using filter_common::FilterArgs;

constexpr int kThreads = 256;

// est_u's entries (filter_common.cuh, shared with tiers.cu's estimate so
// the two cannot drift apart)
using filter_common::factor_estimate;

// four adjacent elements a thread (vec4.cuh, shared with tiers.cu)
using vec4::aligned;
using vec4::lane4;
using vec4::load4;
using vec4::store4;

// ---- the factored entries: the tables, then the tiled main pass ----

// main pass: each thread owns 4 adjacent columns of one row; a block runs
// kThreads / qt rows side by side over a tile of 4 qt columns (qt = 32-256
// threads a row, so a warp never spans two rows) and walks groups of
// kGroupRows rows of one scenario
constexpr int kTileCols = 4 * kThreads;
constexpr int kGroupRows = 32;
constexpr int kFillBlocks = 8 * 132;  // about eight blocks on each of the 132 SMs

// The main pass's modes: dense_filter (the score, extra_mask, the tie at
// the column id), sim_filter (no score or mask, the tie at tie_idx[s, c]),
// mesh_tile_filter (dense_filter's, plus extra_score, global prev / evict
// ids and the tie at col0 + c).
enum Mode : int { kDense = 0, kSim = 1, kTile = 2 };

// The tables the main pass reads instead of redoing per row what depends
// on fewer indices than (s, b, c) (S = 1 but for sim_filter).
struct Tables {
  int32_t* est_u;   // [S,U,C] the estimate per distinct request
  uint8_t* col_ok;  // [S,Tt,C] alive and every taint tolerated by table t
  uint8_t* api_t;   // [S,G,C] api_ok transposed, so a row reads it along c
  int U, Tt;
};

// The elementwise terms the main pass reads at (b, c) through their row
// strides, each null when absent, and the tile's first global column.
struct Terms {
  const int32_t* avail;  // [B,ld_avail] answers, -1 = none (shared by every scenario)
  const uint8_t* mask;   // [B,ld_mask] ANDed into feasible (not sim_filter)
  const int32_t* score;  // [B,ld_score] added to the score (mesh_tile_filter)
  int64_t ld_avail, ld_mask, ld_score;
  int col0;  // 0 but for a mesh tile
};

// The main pass's outputs ([S,B,C] and [S,B]; no score for sim_filter).
struct MainOut {
  uint8_t* feasible;
  int32_t* score;
  int32_t* avail;
  int32_t* prev;
  int32_t* tie;
  int32_t* feas_count;  // zeroed by factor_kernel
};

// Grid (column blocks, table rows, S): block row j builds est_u for
// request j < U, col_ok for toleration table j - U < Tt, then api_t for
// gvk j - U - Tt; blockIdx.y strides over the U + Tt + G table rows. The
// blocks of table row 0 of scenario 0 also zero the n_count feasible
// counts, which the main pass adds to.
__global__ void __launch_bounds__(kThreads)
factor_kernel(FilterArgs p, Tables f, int32_t* feas_count, int64_t n_count) {
  extern __shared__ int32_t tol[];  // [4*Kt]
  const int s = blockIdx.z;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int64_t sc = (int64_t)s * p.C + c;
  if (blockIdx.y == 0 && s == 0) {
    for (int64_t i = c; i < n_count; i += (int64_t)gridDim.x * kThreads) feas_count[i] = 0;
  }
  const int rows = f.U + f.Tt + p.G;
  for (int j = blockIdx.y; j < rows; j += gridDim.y) {  // j is uniform over the block
    if (j < f.U) {
      if (c < p.C) {
        f.est_u[((int64_t)s * f.U + j) * p.C + c] =
            p.has_summary[sc] ? factor_estimate(p.capacity + sc * p.R,
                                                p.req_unique + (int64_t)j * p.R, p.R)
                              : 0;
      }
    } else if (j < f.U + f.Tt) {
      const int t = j - f.U;
      __syncthreads();  // the previous table's readers are done
      for (int i = threadIdx.x; i < 4 * p.Kt; i += kThreads) {
        tol[i] = p.tol_tables[(int64_t)t * 4 * p.Kt + i];
      }
      __syncthreads();
      if (c < p.C) {
        bool ok = p.alive[sc] != 0;
        if (p.plugin_bits & filter_common::kBitTaint) {
          const int64_t at = sc * p.T;
          ok = ok && filter_common::taints_tolerated(p.taint_key + at, p.taint_value + at,
                                                     p.taint_effect + at, p.T, tol, p.Kt);
        }
        f.col_ok[((int64_t)s * f.Tt + t) * p.C + c] = ok ? 1 : 0;
      }
    } else if (c < p.C) {
      const int g = j - f.U - f.Tt;
      f.api_t[((int64_t)s * p.G + g) * p.C + c] = p.api_ok[sc * p.G + g];
    }
  }
}

// Grid (column tiles, groups of kGroupRows rows, S; the groups beyond
// gridDim.y strided). The block walks its rows kThreads / qt at a time:
// the rows' prev and evict lists are scattered into the step's slots (a
// prev slot keeps (k + 1) << 32 | replicas of the highest entry k, so the
// last entry wins; an evict slot a flag; ids are global, so an id outside
// the tile's [col0 + c0, col0 + c1) is skipped), one barrier, and each
// thread writes its 4 columns from the factored tables, resetting its
// slots as it reads them. The slots are double-buffered, so one barrier a
// step suffices. Shared arrays are column-interleaved (column 4i + j of a
// row at j * kThreads + the row's first thread + i), so a warp's accesses
// are consecutive.
template <bool kVec, int kMode>
__global__ void __launch_bounds__(kThreads)
filter_main_kernel(FilterArgs p, const int64_t* tie_idx, Terms x, Tables f, MainOut o,
                   int qt) {
  __shared__ uint64_t tie_s[kMode == kSim ? kTileCols : 1];
  __shared__ unsigned long long slot[2][kTileCols];
  __shared__ uint8_t evicted[2][kTileCols];

  const int s = blockIdx.z;
  const int width = 4 * qt;  // the tile's columns
  const int par = kThreads / qt;  // rows side by side
  const int c0 = blockIdx.x * width;
  const int c1 = min(c0 + width, p.C);
  for (int i = threadIdx.x; i < kTileCols; i += kThreads) {
    slot[0][i] = slot[1][i] = 0;
    evicted[0][i] = evicted[1][i] = 0;
  }
  if constexpr (kMode == kSim) {
    for (int l = threadIdx.x; l < c1 - c0; l += kThreads) {
      tie_s[(l & 3) * qt + (l >> 2)] = (uint64_t)tie_idx[(int64_t)s * p.C + c0 + l];
    }
  }
  __syncthreads();

  const int sub = threadIdx.x / qt;  // this thread's row of the step
  const int qi = threadIdx.x - sub * qt;
  const int c = c0 + 4 * qi;  // its first column
  const int n = c1 - c;  // its columns inside the fleet (4 or more when kVec)
  const int per_row = p.Kp + p.Ke;
  const int groups = (p.B + kGroupRows - 1) / kGroupRows;
  int buf = 0;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    for (int rbase = g * kGroupRows; rbase < (g + 1) * kGroupRows; rbase += par, buf ^= 1) {
      for (int i = threadIdx.x; i < par * per_row; i += kThreads) {
        const int rs = i / per_row;
        const int k = i - rs * per_row;
        const int b = rbase + rs;
        if (b >= p.B) continue;
        const bool is_prev = k < p.Kp;
        const int id = is_prev ? p.prev_idx[(int64_t)b * p.Kp + k]
                               : p.evict_idx[(int64_t)b * p.Ke + k - p.Kp];
        const int64_t lid = (int64_t)id - x.col0;  // the id in the tile's columns
        if (lid < c0 || lid >= c1) continue;
        const int l = (int)lid - c0;
        const int at = (l & 3) * kThreads + rs * qt + (l >> 2);
        if (is_prev) {
          atomicMax(&slot[buf][at], ((unsigned long long)(k + 1) << 32) |
                                        (uint32_t)p.prev_rep[(int64_t)b * p.Kp + k]);
        } else {
          evicted[buf][at] = 1;
        }
      }
      __syncthreads();

      const int b = rbase + sub;
      unsigned int local = 0;
      if (b < p.B && n > 0) {
        const int bits = p.plugin_bits;
        uint32_t ok =
            load4<kVec>(f.col_ok + ((int64_t)s * f.Tt + p.tol_idx[b]) * p.C + c, n);
        if (bits & filter_common::kBitApi) {
          const int gv = p.gvk[b];
          ok = (p.G > 0 && gv < p.G)
                   ? ok & load4<kVec>(f.api_t + ((int64_t)s * p.G + max(gv, 0)) * p.C + c, n)
                   : 0u;
        }
        if (bits & filter_common::kBitAffinity) {
          ok &= load4<kVec>(p.aff_masks + (int64_t)p.aff_idx[b] * p.C + c, n);
        }
        if (kMode != kSim && x.mask != nullptr) {
          ok &= load4<kVec>(x.mask + (int64_t)b * x.ld_mask + c, n);
        }
        const int4 est =
            load4<kVec>(f.est_u + ((int64_t)s * f.U + p.req_idx[b]) * p.C + c, n);
        int4 extra = make_int4(-1, -1, -1, -1);
        if (x.avail != nullptr) extra = load4<kVec>(x.avail + (int64_t)b * x.ld_avail + c, n);
        int4 plus = make_int4(0, 0, 0, 0);
        if (kMode == kTile && x.score != nullptr) {
          plus = load4<kVec>(x.score + (int64_t)b * x.ld_score + c, n);
        }
        const int32_t reps = p.replicas[b];
        const bool unknown = p.unknown_request[b] != 0;
        const uint64_t seed = p.seeds[b];
        const bool evict_on = (bits & filter_common::kBitEviction) != 0;
        const bool locality = (bits & filter_common::kBitLocality) != 0;
        uint32_t feas = 0;
        int32_t score[4], avail[4], prev[4], tie[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = j * kThreads + threadIdx.x;
          const bool fj = ((ok >> (8 * j)) & 0xff) != 0 && !(evict_on && evicted[buf][at]);
          const unsigned long long sv = slot[buf][at];
          slot[buf][at] = 0;
          evicted[buf][at] = 0;
          avail[j] = filter_common::apply_row(lane4(est, j), reps, unknown, lane4(extra, j));
          prev[j] = (int32_t)(uint32_t)sv;
          // the reference's int32 add of extra_score, which wraps
          score[j] = (int32_t)((uint32_t)(locality && sv != 0 ? 100 : 0) +
                               (uint32_t)lane4(plus, j));
          tie[j] = kMode == kSim ? filter_common::tie_from_index(seed, tie_s[j * qt + qi])
                                 : filter_common::tie_value(seed, x.col0 + c + j);
          if (j < n && fj) {
            feas |= 1u << (8 * j);
            ++local;
          }
        }
        const int64_t row = ((int64_t)s * p.B + b) * p.C;
        store4<kVec>(o.feasible + row + c, feas, n);
        if constexpr (kMode != kSim) store4<kVec>(o.score + row + c, score, n);
        store4<kVec>(o.avail + row + c, avail, n);
        store4<kVec>(o.prev + row + c, prev, n);
        store4<kVec>(o.tie + row + c, tie, n);
      }
      // a warp lies inside one row: one atomic per warp and row
      local = __reduce_add_sync(0xffffffffu, local);
      if ((threadIdx.x & 31) == 0 && local != 0) {
        atomicAdd(reinterpret_cast<unsigned int*>(o.feas_count + (int64_t)s * p.B + b), local);
      }
    }
  }
}

// The two launches of the factored entries on `st`: the tables (and the
// counts zeroed), then the main pass over S scenarios of B rows. 16-byte
// accesses need C % 4 == 0 (every row start then aligned), a first column
// and term row strides that are multiples of 4, and aligned bases; the
// caller's terms and aff_masks may be views.
template <int kMode>
int launch_factored(const FilterArgs& p, const Tables& f, const MainOut& o,
                    const int64_t* tie_idx, const Terms& x, int S, cudaStream_t st) {
  const size_t tol_smem = 4 * (size_t)(4 * p.Kt);
  if (tol_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tol_smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int table_rows = f.U + f.Tt + p.G;
  const dim3 fgrid((p.C + kThreads - 1) / kThreads, table_rows < 65535 ? table_rows : 65535, S);
  factor_kernel<<<fgrid, kThreads, tol_smem, st>>>(p, f, o.feas_count, (int64_t)S * p.B);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // threads a row: the fewest of 32-256 whose 4 columns each cover C,
  // or fewer where the tiles then pad C less (a 2 560-column mesh tile
  // takes five tiles of 512, not three of 1 024)
  int qt = 32;
  while (qt < kThreads && 4 * qt < p.C) qt *= 2;
  const auto pad = [&](int q) { return (p.C + 4 * q - 1) / (4 * q) * (4 * q) - p.C; };
  for (int q = qt / 2; q >= 32; q /= 2) {
    if (pad(q) < pad(qt)) qt = q;
  }
  const int groups = (p.B + kGroupRows - 1) / kGroupRows;
  if (kMode == kTile) {  // a tile's blocks fill the card: narrower tiles where they are few
    while (qt > 32 && (p.C + 4 * qt - 1) / (4 * qt) * groups < kFillBlocks) qt /= 2;
  }
  const bool vec = p.C % 4 == 0 && x.col0 % 4 == 0 && x.ld_avail % 4 == 0 &&
                   x.ld_mask % 4 == 0 && x.ld_score % 4 == 0 && aligned(p.aff_masks, 4) &&
                   aligned(x.mask, 4) && aligned(x.avail, 16) && aligned(x.score, 16);
  const dim3 grid((p.C + 4 * qt - 1) / (4 * qt), groups < 65535 ? groups : 65535, S);
  if (vec) {
    filter_main_kernel<true, kMode><<<grid, kThreads, 0, st>>>(p, tie_idx, x, f, o, qt);
  } else {
    filter_main_kernel<false, kMode><<<grid, kThreads, 0, st>>>(p, tie_idx, x, f, o, qt);
  }
  return (int)cudaGetLastError();
}

// ---- dense_input_filter: the tables per group of rows, in shared memory ----

constexpr int kInputRows = 32;     // rows a block factors together (bits of a 32-bit mask)
constexpr int kInputEntries = 32;  // table rows a block keeps per kind

// The dense-input program's per-row inputs beside FilterArgs (whose
// aff_masks is then affinity_ok [B,C], req_unique the request [B,R] and
// extra_avail the answers [B,C]), and its outputs.
struct DenseRows {
  const int32_t* tol_key;      // [B,Kt]
  const int32_t* tol_value;    // [B,Kt]
  const int32_t* tol_effect;   // [B,Kt]
  const int32_t* tol_op;       // [B,Kt]
  const uint8_t* eviction_ok;  // [B,C]
  const uint8_t* prev_member;  // [B,C]
  uint8_t* feasible;           // [B,C]
  int32_t* score;              // [B,C]
  int32_t* avail;              // [B,C]
};

// The kernel's static shared arrays, an upper bound (688 bytes).
constexpr size_t kInputStatic = 1024;

// A toleration row as the kernel keeps it: Kt int4 (key, value, effect,
// op), then one int4 (gvk, 0, 0, 0).
__host__ __device__ inline int input_tol_words(int Kt) { return 4 * Kt + 4; }

// Dynamic shared memory of one block over a tile of `width` columns (a
// multiple of 32): the estimate table [32, width] i32, the column-ok table
// [32, width / 32] bit words, the requests [32, R] i64 twice (the group's
// rows, the tables' entries) and the entries' reciprocals, then the
// toleration rows [32, 4 Kt + 4] i32 twice.
size_t input_smem(int width, int R, int Kt) {
  return (size_t)kInputEntries * (4 * (size_t)width + (size_t)width / 8) +
         (size_t)kInputRows * 24 * (size_t)R + (size_t)kInputRows * 8 * input_tol_words(Kt);
}

// Whether the toleration row `tol` (Kt int4 in shared memory) tolerates
// every NoSchedule / NoExecute taint of the column whose T taint slots
// start at key_c, value_c and effect_c: filter_common::taints_tolerated's
// rule, four taints against each toleration, one 16-byte load a
// toleration.
__device__ inline bool tolerates_all(const int4* tol, int Kt, const int32_t* key_c,
                                     const int32_t* value_c, const int32_t* effect_c, int T) {
  for (int t0 = 0; t0 < T; t0 += 4) {
    int tk[4], tv[4], te[4];
    unsigned int hit = 0;  // bit j: taint t0 + j tolerated, or not to be
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j;
      te[j] = t < T ? effect_c[t] : 0;
      const bool need = te[j] == filter_common::kEffNoSchedule ||
                        te[j] == filter_common::kEffNoExecute;
      tk[j] = need ? key_c[t] : 0;
      tv[j] = need ? value_c[t] : 0;
      hit |= need ? 0u : 1u << j;
    }
    for (int k = 0; k < Kt && hit != 0xfu; ++k) {
      const int4 x = tol[k];  // key, value, effect, op
      if (x.w == filter_common::kTolOpNone) continue;
      const bool exists = x.w == filter_common::kTolOpExists;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool match = (x.x == tk[j] || (x.x == 0 && exists)) &&
                           (x.z == 0 || x.z == te[j]) && (exists || x.y == tv[j]);
        hit |= match ? 1u << j : 0u;
      }
    }
    if (hit != 0xfu) return false;
  }
  return true;
}

// Grid (column tiles of 4 qt columns, blocks that stride over the groups
// of kInputRows rows), kThreads threads, kThreads / qt rows side by side.
// The block keeps, for each kind (requests; toleration rows with their
// gvk), up to kInputEntries distinct rows and their table rows over its
// tile, from one group to the next. Per group:
// 1. stage the group's requests and toleration rows;
// 2. threads 0-31 (requests) and 32-63 (toleration rows), a row each: the
//    row's word hash, then its entry among the kept rows (equal hash, then
//    an exact compare), if any;
// 3. the same threads: the row's first equal row in the group;
// 4. the rows that found no entry get new ones (one per distinct row, its
//    first row's words copied in, a request's reciprocals beside them);
//    when they do not fit, every entry is dropped and the group's distinct
//    rows take entries from 0;
// 5. the new entries' table rows, a thread a column: factor_estimate's
//    rule (the kEstReplicas sentinel) through capped_div::floor_div_rcp;
//    alive, api_ok at the gvk and every taint tolerated, as ballot bits;
// 6. per row, its two table rows read with the row's own masks and clamps.
// Five blocks a SM (at most 48 registers; the shared memory allows five at
// the flagship's R = 4 and Kt = 6).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 5)
dense_input_group_kernel(FilterArgs p, DenseRows d, int qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t hash_s[2][kInputRows];
  __shared__ uint32_t entry_hash[2][kInputEntries];
  __shared__ int8_t hit_s[2][kInputRows];    // each row's kept entry, -1 for none
  __shared__ int8_t slot_s[2][kInputRows];   // each row's entry
  __shared__ unsigned int rep_mask[2];       // the rows that are their own first
  __shared__ unsigned int miss_mask[2];      // the rows without a kept entry
  __shared__ int n_kept[2], lo_s[2], n_next[2];

  const int width = 4 * qt;
  const int words = width / 32;  // column-ok bit words a table row
  const int R = p.R;
  const int Kt = p.Kt;
  const int tol_len = input_tol_words(Kt);
  int32_t* est_s = reinterpret_cast<int32_t*>(smem);                        // [32, width]
  uint32_t* okb_s = reinterpret_cast<uint32_t*>(est_s + kInputEntries * width);  // [32, words]
  int64_t* grp_req = reinterpret_cast<int64_t*>(okb_s + kInputEntries * words);  // [32, R]
  int64_t* ent_req = grp_req + kInputRows * R;                              // [32, R]
  uint64_t* ent_rcp = reinterpret_cast<uint64_t*>(ent_req + kInputEntries * R);  // [32, R]
  int32_t* grp_tol = reinterpret_cast<int32_t*>(ent_rcp + kInputEntries * R);    // [32, tol_len]
  int32_t* ent_tol = grp_tol + kInputRows * tol_len;                        // [32, tol_len]

  const int c0 = blockIdx.x * width;
  const int c1 = min(c0 + width, p.C);
  const int par = kThreads / qt;
  const int sub = threadIdx.x / qt;
  const int qi = threadIdx.x - sub * qt;
  const int l = 4 * qi;  // this thread's first column in the tile
  const int c = c0 + l;
  const int n = c1 - c;
  const int bits = p.plugin_bits;
  const int groups = (p.B + kInputRows - 1) / kInputRows;
  // threads 0-31 factor the requests, 32-63 the toleration rows: kind w, row i
  const int w = threadIdx.x / kInputRows;
  const int i = threadIdx.x % kInputRows;
  const bool factors = w < 2;
  const int len = w == 0 ? 2 * R : tol_len;  // the row's 32-bit words
  const uint32_t* grp_words = w == 0 ? reinterpret_cast<const uint32_t*>(grp_req)
                                     : reinterpret_cast<const uint32_t*>(grp_tol);
  uint32_t* ent_words = w == 0 ? reinterpret_cast<uint32_t*>(ent_req)
                               : reinterpret_cast<uint32_t*>(ent_tol);
  const uint32_t* mine = grp_words + (int64_t)i * len;
  // the table pass: a thread a column, kThreads / width threads sharing it
  const int lanes = kThreads / width;
  const int lc = threadIdx.x % width;
  const int lane = threadIdx.x / width;
  const int cc = c0 + lc;
  if (threadIdx.x < 2) n_kept[threadIdx.x] = 0;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const int r0 = g * kInputRows;
    const int nrows = min(kInputRows, p.B - r0);
    const bool mine_valid = factors && i < nrows;

    // 1. stage the group's requests and toleration rows (+ gvk)
    for (int k = threadIdx.x; k < nrows * R; k += kThreads) {
      grp_req[k] = p.req_unique[(int64_t)r0 * R + k];
    }
    for (int k = threadIdx.x; k < nrows * tol_len; k += kThreads) {
      const int row = k / tol_len;
      const int at = k - row * tol_len;
      const int64_t b = r0 + row;
      int32_t v = 0;
      if (at < 4 * Kt) {
        const int f = at & 3;
        const int32_t* src = f == 0 ? d.tol_key : f == 1 ? d.tol_value : f == 2 ? d.tol_effect
                                                                                 : d.tol_op;
        v = src[b * Kt + (at >> 2)];
      } else if (at == 4 * Kt) {
        v = p.gvk[b];
      }
      grp_tol[k] = v;
    }
    if (threadIdx.x < 2) rep_mask[threadIdx.x] = miss_mask[threadIdx.x] = 0;
    __syncthreads();

    // 2. the row's hash, and its kept entry if there is one
    uint32_t h = 0x811c9dc5u;
    int hit = -1;
    if (mine_valid) {
      for (int k = 0; k < len; ++k) h = (h ^ mine[k]) * 0x01000193u;
      hash_s[w][i] = h;
      const int kept = n_kept[w];
      for (int e = 0; e < kept && hit < 0; ++e) {
        if (entry_hash[w][e] != h) continue;
        const uint32_t* other = ent_words + (int64_t)e * len;
        bool eq = true;
        for (int k = 0; k < len && eq; ++k) eq = other[k] == mine[k];
        if (eq) hit = e;
      }
      hit_s[w][i] = (int8_t)hit;
      if (hit < 0) atomicOr(&miss_mask[w], 1u << i);
    }
    __syncthreads();

    // 3. the row's first equal row in the group (a row with a kept entry
    // needs it only when the new rows may not fit)
    int first = i;
    if (mine_valid && (hit < 0 || n_kept[w] + __popc(miss_mask[w]) > kInputEntries)) {
      for (int j = 0; j < i && first == i; ++j) {
        if (hash_s[w][j] != h || hit_s[w][j] != hit) continue;
        const uint32_t* other = grp_words + (int64_t)j * len;
        bool eq = true;
        for (int k = 0; k < len && eq; ++k) eq = other[k] == mine[k];
        if (eq) first = j;
      }
    }
    if (mine_valid && first == i) atomicOr(&rep_mask[w], 1u << i);
    __syncthreads();

    // 4. entries for the rows without one
    if (mine_valid) {
      const unsigned int reps = rep_mask[w];
      const unsigned int fresh = reps & miss_mask[w];
      const unsigned int below = (1u << first) - 1u;
      const int kept = n_kept[w];
      const bool refill = kept + __popc(fresh) > kInputEntries;
      int slot;
      bool is_new;
      if (refill) {  // drop every entry: the group's distinct rows from 0
        slot = __popc(reps & below);
        is_new = first == i;
      } else {
        slot = hit >= 0 ? hit : kept + __popc(fresh & below);
        is_new = hit < 0 && first == i;
      }
      slot_s[w][i] = (int8_t)slot;
      if (is_new) {
        uint32_t* to = ent_words + (int64_t)slot * len;
        for (int k = 0; k < len; ++k) to[k] = mine[k];
        entry_hash[w][slot] = h;
        if (w == 0) {
          for (int r = 0; r < R; ++r) {
            const int64_t q = grp_req[(int64_t)i * R + r];
            ent_rcp[(int64_t)slot * R + r] = capped_div::reciprocal(q > 0 ? (uint64_t)q : 1);
          }
        }
      }
      if (i == 0) {
        lo_s[w] = refill ? 0 : kept;
        n_next[w] = refill ? __popc(reps) : kept + __popc(fresh);
      }
    }
    __syncthreads();

    // 5. the new entries' table rows over the tile's columns, a thread a
    // column (its capacity and taints read once a group, from L1)
    const int n_req = n_next[0];
    const int n_tol = n_next[1];
    if (lo_s[0] < n_req) {
      const bool summ = cc < p.C && p.has_summary[cc];
      const int64_t* cap = p.capacity + (int64_t)(summ ? cc : 0) * R;
      for (int e = lo_s[0] + lane; e < n_req; e += lanes) {
        est_s[e * width + lc] =
            summ ? filter_common::factor_estimate_rcp(cap, ent_req + (int64_t)e * R,
                                                      ent_rcp + (int64_t)e * R, R)
                 : 0;
      }
    }
    if (lo_s[1] < n_tol) {
      const bool alive = cc < p.C && p.alive[cc] != 0;
      const int64_t at = (int64_t)(alive ? cc : 0) * p.T;
      for (int e = lo_s[1] + lane; e < n_tol; e += lanes) {  // uniform over each warp
        const int32_t* tol = ent_tol + (int64_t)e * tol_len;
        bool ok = alive;
        if (ok && (bits & filter_common::kBitApi)) {
          const int gv = tol[4 * Kt];
          ok = p.G > 0 && gv < p.G && p.api_ok[(int64_t)cc * p.G + max(gv, 0)] != 0;
        }
        if (ok && (bits & filter_common::kBitTaint)) {
          ok = tolerates_all(reinterpret_cast<const int4*>(tol), Kt, p.taint_key + at,
                             p.taint_value + at, p.taint_effect + at, p.T);
        }
        const unsigned int ballot = __ballot_sync(0xffffffffu, ok);
        if ((threadIdx.x & 31) == 0) okb_s[e * words + lc / 32] = ballot;
      }
    }
    __syncthreads();
    if (threadIdx.x < 2) n_kept[threadIdx.x] = n_next[threadIdx.x];

    // 6. per row: the tables, then the row's own masks and clamps
    if (n > 0) {
      for (int rs = sub; rs < nrows; rs += par) {
        const int b = r0 + rs;
        const int64_t at = (int64_t)b * p.C + c;
        const uint32_t okb = (okb_s[slot_s[1][rs] * words + l / 32] >> (l % 32)) & 0xfu;
        uint32_t ok = (okb & 1u) | ((okb & 2u) << 7) | ((okb & 4u) << 14) | ((okb & 8u) << 21);
        if (bits & filter_common::kBitAffinity) ok &= load4<kVec>(p.aff_masks + at, n);
        if (bits & filter_common::kBitEviction) ok &= load4<kVec>(d.eviction_ok + at, n);
        const uint32_t member = (bits & filter_common::kBitLocality)
                                    ? load4<kVec>(d.prev_member + at, n)
                                    : 0u;
        const int4 est = *reinterpret_cast<const int4*>(est_s + slot_s[0][rs] * width + l);
        int4 extra = make_int4(-1, -1, -1, -1);
        if (p.extra_avail != nullptr) extra = load4<kVec>(p.extra_avail + at, n);
        const int32_t reps = p.replicas[b];
        const bool unknown = p.unknown_request[b] != 0;
        uint32_t feas = 0;
        int32_t score[4], avail[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (((ok >> (8 * j)) & 0xff) != 0) feas |= 1u << (8 * j);
          score[j] = ((member >> (8 * j)) & 0xff) != 0 ? 100 : 0;
          avail[j] = filter_common::apply_row(lane4(est, j), reps, unknown, lane4(extra, j));
        }
        store4<kVec>(d.feasible + at, feas, n);
        store4<kVec>(d.score + at, score, n);
        store4<kVec>(d.avail + at, avail, n);
      }
    }
    __syncthreads();  // the next group overwrites the staging and the slots
  }
}

}  // namespace

// The fleet tables and the factored batch of B rows (U distinct requests,
// Tt toleration tables), extra_avail (i32 [B,C], -1 = no answer) and
// extra_mask (bool [B,C]), each null when absent, the factored tables'
// scratch (est_u i32 [U,C], col_ok and api_t u8 [Tt,C] and [G,C]) and the
// outputs. Builds the tables (zeroing the feasible counts), then runs the
// main pass: two launches on the stream.
extern "C" int dense_filter_launch(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int C, int R, int T, int G,
    const void* replicas, const void* unknown_request, const void* gvk,
    const void* tol_tables, const void* tol_idx, const void* aff_masks,
    const void* aff_idx, const void* prev_idx, const void* prev_rep,
    const void* evict_idx, const void* seeds, const void* req_unique,
    const void* req_idx, int B, int Kt, int Kp, int Ke, int U, int Tt, int plugin_bits,
    int has_extra, const void* extra_avail, const void* extra_mask, void* est_u, void* col_ok,
    void* api_t, void* feasible, void* score, void* avail, void* prev, void* tie,
    void* feas_count, void* stream) {
  if (B <= 0 || C <= 0 || U <= 0 || Tt <= 0) return (int)cudaErrorInvalidValue;
  const FilterArgs p = filter_common::make_filter_args(
      alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G,
      replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx, prev_idx,
      prev_rep, evict_idx, seeds, req_unique, req_idx, B, Kt, Kp, Ke, plugin_bits, has_extra,
      extra_avail);
  const Tables f{static_cast<int32_t*>(est_u), static_cast<uint8_t*>(col_ok),
                 static_cast<uint8_t*>(api_t), U, Tt};
  const MainOut o{static_cast<uint8_t*>(feasible), static_cast<int32_t*>(score),
                  static_cast<int32_t*>(avail),    static_cast<int32_t*>(prev),
                  static_cast<int32_t*>(tie),      static_cast<int32_t*>(feas_count)};
  const Terms x{p.extra_avail, static_cast<const uint8_t*>(extra_mask), nullptr, C, C, 0, 0};
  return launch_factored<kDense>(p, f, o, nullptr, x, 1, static_cast<cudaStream_t>(stream));
}

// The scenario-stacked fleet (alive [S,C], capacity [S,C,R], has_summary
// [S,C], taints [S,C,T], api_ok [S,C,G]) and tie_idx (int64 bits of the
// u64 1-based present rank, [S,C]) beside the factored batch of B rows
// (U distinct requests, Tt toleration tables), the factored tables'
// scratch (est_u i32 [S,U,C], col_ok and api_t u8 [S,Tt,C] and [S,G,C])
// and the outputs. Builds the tables (zeroing the feasible counts), then
// runs the main pass: two launches on the stream.
extern "C" int sim_filter_launch(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int S, int C, int R, int T, int G, const void* tie_idx,
    const void* replicas, const void* unknown_request, const void* gvk,
    const void* tol_tables, const void* tol_idx, const void* aff_masks,
    const void* aff_idx, const void* prev_idx, const void* prev_rep,
    const void* evict_idx, const void* seeds, const void* req_unique,
    const void* req_idx, int B, int Kt, int Kp, int Ke, int U, int Tt, int plugin_bits,
    int has_extra, const void* extra_avail, void* est_u, void* col_ok, void* api_t,
    void* feasible, void* avail, void* prev, void* tie, void* feas_count, void* stream) {
  if (S <= 0 || S > 65535 || B <= 0 || C <= 0 || U <= 0 || Tt <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const FilterArgs p = filter_common::make_filter_args(
      alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G,
      replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx, prev_idx,
      prev_rep, evict_idx, seeds, req_unique, req_idx, B, Kt, Kp, Ke, plugin_bits, has_extra,
      extra_avail);
  const Tables f{static_cast<int32_t*>(est_u), static_cast<uint8_t*>(col_ok),
                 static_cast<uint8_t*>(api_t), U, Tt};
  const MainOut o{static_cast<uint8_t*>(feasible), nullptr,
                  static_cast<int32_t*>(avail),    static_cast<int32_t*>(prev),
                  static_cast<int32_t*>(tie),      static_cast<int32_t*>(feas_count)};
  const Terms x{p.extra_avail, nullptr, nullptr, C, 0, 0, 0};
  return launch_factored<kSim>(p, f, o, static_cast<const int64_t*>(tie_idx), x, S,
                               static_cast<cudaStream_t>(stream));
}

// The fleet tables beside the dense batch of B rows: replicas, request
// [B,R] (i64), unknown_request, gvk, the four toleration tables [B,Kt],
// affinity_ok / eviction_ok / prev_member [B,C] (bool) and extra_avail
// [B,C] (i32, -1 = no answer), and the outputs feasible [B,C] (bool),
// score and avail [B,C] (i32). One launch on the stream.
extern "C" int dense_input_filter_launch(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int C, int R, int T, int G,
    const void* replicas, const void* request, const void* unknown_request, const void* gvk,
    const void* tol_key, const void* tol_value, const void* tol_effect, const void* tol_op,
    int Kt, const void* affinity_ok, const void* eviction_ok, const void* prev_member,
    const void* extra_avail, int B, int plugin_bits, void* feasible, void* score, void* avail,
    void* stream) {
  if (B <= 0 || C <= 0 || R < 0 || Kt < 0) return (int)cudaErrorInvalidValue;
  const FilterArgs p = filter_common::make_filter_args(
      alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G,
      replicas, unknown_request, gvk, nullptr, nullptr, affinity_ok, nullptr, nullptr, nullptr,
      nullptr, nullptr, request, nullptr, B, Kt, 0, 0, plugin_bits, extra_avail != nullptr,
      extra_avail);
  DenseRows d;
  d.tol_key = static_cast<const int32_t*>(tol_key);
  d.tol_value = static_cast<const int32_t*>(tol_value);
  d.tol_effect = static_cast<const int32_t*>(tol_effect);
  d.tol_op = static_cast<const int32_t*>(tol_op);
  d.eviction_ok = static_cast<const uint8_t*>(eviction_ok);
  d.prev_member = static_cast<const uint8_t*>(prev_member);
  d.feasible = static_cast<uint8_t*>(feasible);
  d.score = static_cast<int32_t*>(score);
  d.avail = static_cast<int32_t*>(avail);
  // 64 threads a row over 256-column tiles; narrow fleets 32 over 128
  const int qt = C > 128 ? 64 : 32;
  const size_t smem = input_smem(4 * qt, R, Kt);
  const bool vec = C % 4 == 0 && aligned(affinity_ok, 4) && aligned(eviction_ok, 4) &&
                   aligned(prev_member, 4) && aligned(extra_avail, 16) && aligned(feasible, 4) &&
                   aligned(score, 16) && aligned(avail, 16);
  const void* kernel = vec ? reinterpret_cast<const void*>(dense_input_group_kernel<true>)
                           : reinterpret_cast<const void*>(dense_input_group_kernel<false>);
  if (smem + kInputStatic > 48 * 1024) {  // the default cap, static arrays included
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // each block walks several groups, so its kept table rows serve them all
  const int tiles = (C + 4 * qt - 1) / (4 * qt);
  const int groups = (B + kInputRows - 1) / kInputRows;
  const int per_tile = (kFillBlocks + tiles - 1) / tiles;
  const int walkers = groups < per_tile ? groups : per_tile;
  const dim3 grid(tiles, walkers < 65535 ? walkers : 65535);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    dense_input_group_kernel<true><<<grid, kThreads, smem, st>>>(p, d, qt);
  } else {
    dense_input_group_kernel<false><<<grid, kThreads, smem, st>>>(p, d, qt);
  }
  return (int)cudaGetLastError();
}

// One [B, C] tile of the mesh solve: the tile's fleet slice (C columns),
// the row group's factored batch of B rows (U distinct requests, Tt
// toleration tables) with the affinity table's column slice [P, C], prev /
// evict ids over the global columns, the tile's first global column col0,
// the three terms (each null, or read through its row stride ld_*), the
// factored tables' scratch (est_u i32 [U,C], col_ok and api_t u8 [Tt,C]
// and [G,C]) and the outputs. Builds the tables (zeroing the feasible
// counts), then runs the main pass: two launches on the stream.
extern "C" int mesh_tile_filter_launch(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int C, int R, int T, int G,
    const void* replicas, const void* unknown_request, const void* gvk,
    const void* tol_tables, const void* tol_idx, const void* aff_masks,
    const void* aff_idx, const void* prev_idx, const void* prev_rep,
    const void* evict_idx, const void* seeds, const void* req_unique,
    const void* req_idx, int B, int Kt, int Kp, int Ke, int U, int Tt, int plugin_bits,
    int col0, const void* extra_avail, long long ld_avail, const void* extra_mask,
    long long ld_mask, const void* extra_score, long long ld_score, void* est_u, void* col_ok,
    void* api_t, void* feasible, void* score, void* avail, void* prev, void* tie,
    void* feas_count, void* stream) {
  if (B <= 0 || C <= 0 || U <= 0 || Tt <= 0 || col0 < 0) return (int)cudaErrorInvalidValue;
  const FilterArgs p = filter_common::make_filter_args(
      alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G,
      replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx, prev_idx,
      prev_rep, evict_idx, seeds, req_unique, req_idx, B, Kt, Kp, Ke, plugin_bits, 0, nullptr);
  const Tables f{static_cast<int32_t*>(est_u), static_cast<uint8_t*>(col_ok),
                 static_cast<uint8_t*>(api_t), U, Tt};
  const MainOut o{static_cast<uint8_t*>(feasible), static_cast<int32_t*>(score),
                  static_cast<int32_t*>(avail),    static_cast<int32_t*>(prev),
                  static_cast<int32_t*>(tie),      static_cast<int32_t*>(feas_count)};
  const Terms x{static_cast<const int32_t*>(extra_avail),
                static_cast<const uint8_t*>(extra_mask),
                static_cast<const int32_t*>(extra_score),
                ld_avail,
                ld_mask,
                ld_score,
                col0};
  return launch_factored<kTile>(p, f, o, nullptr, x, 1, static_cast<cudaStream_t>(stream));
}
