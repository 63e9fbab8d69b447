// dense_filter: phase 1 of the dense schedule round.
//
// Replaces karmada_tpu/sched/core.py:452 `_filter_kernel_compact` (with
// decompress_batch's prev/evict scatters, `_device_tie` and
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
// What bounds it on an H100: it writes four i32 and one bool [B, C]
// tensors, 17 bytes per element (about 0.9 GB at 10240 x 5120), so it is
// bound by memory bandwidth. Most of an element's work depends on fewer
// indices than (b, c), and the batch is already factored (models/batch.py:
// U distinct requests, Tt toleration tables), so the work is split as the
// reference's own estimate is (ops/assign.py general_estimate_unique, then
// general_estimate_apply), in two launches on the stream:
// - factor_kernel builds est_u [U, C] (i32: the minimum over requested
//   resources of cap // req through capped_div.cuh, 0 without a summary,
//   kEstReplicas for "the row's replicas" where no resource is requested
//   or the minimum reaches INT32_MAX), col_ok [Tt, C] (alive, and every
//   NoSchedule / NoExecute taint tolerated by table t) and api_t [G, C]
//   (api_ok transposed), from the capacity it is passed (the tiered
//   launch passes its own); it also zeroes the feasible counts. That is
//   U C R divisions and Tt C T Kt compares, never more than the
//   per-element form's B C R and B C T Kt.
// - filter_main_kernel<kVec, kDense = true>, grid (column tiles, groups of
//   32 rows), 256 threads, each owning 4 adjacent columns of one row
//   (32-256 threads a row, so narrow fleets run several rows side by
//   side): the block scatters each step's prev / evict lists into shared
//   slots (last prev entry wins through a 64-bit atomicMax on
//   (k + 1) << 32 | replicas), then every thread reads its columns from
//   the tables (4-byte loads of col_ok, api_t, the affinity row and the
//   mask, 16-byte loads of est_u and of the answers), applies the row's
//   own clamps (replicas, unknown_request, the answers' min-merge), sets
//   the score (100 on a prev column with the locality plugin on) and the
//   tie (splitmix64 at the column id), and writes feasible as one 32-bit
//   word and score, avail, prev and tie as 16-byte stores; the feasible
//   count is a warp sum and one atomic a warp. kVec = false (C % 4 != 0,
//   or the caller's answers, mask or affinity table off alignment) takes
//   4-byte accesses throughout.
//
// sim_filter, the second entry: the same filter and estimate over a
// scenario-stacked fleet, the first launch of the simulation plane's
// solve. Replaces the filter half of karmada_tpu/simulation/engine.py:261
// `_sim_kernel` (its decompress of the factored batch, then
// `_schedule_body`'s filter_estimate_phase under `jax.vmap` over the
// scenario axis, with the tie from `tie_from_index(seeds, tie_idx[s])`).
// It writes feasible, avail, prev and tie as [S, B, C] and the feasible
// count as [S, B] (no score: the simulation drops it). Bound by memory
// bandwidth: 13 bytes written per [S, B, C] element. The same two
// launches, per scenario (grid z): factor_kernel builds est_u [S, U, C],
// col_ok [S, Tt, C] and api_t [S, G, C], and filter_main_kernel<kVec,
// kDense = false> stages its tile's tie indices once and writes the rows
// without the score and the mask. The tie comes from the scenario's
// 1-based present rank tie_idx[s, c] (a drained column repeats its
// neighbour's rank, but is never feasible), and extra_avail, shared by
// every scenario, is read at (b, c).
//
// dense_input_filter, the third entry: the filter half of the dense-input
// schedule program. Replaces karmada_tpu/sched/core.py:190-226
// filter_estimate_phase and the extra_avail min-merge of core.py:311, as
// core.py:320 `_schedule_kernel` runs them (every in-tree plugin on) over
// fully dense inputs: the tolerations as four [B, K] tables, the
// affinity, eviction and previous-membership masks as bool [B, C], the
// request as i64 [B, R] and the answers as i32 [B, C] (-1 = none). Unlike
// dense_filter_kernel it reads no factored table, no prev/evict list and
// no seed: every input is read where it lies (nothing is restacked to
// [B, C] on the way in), through filter_common's eval_col / estimate with
// the kDenseRows switch, so the per-column rules stay those of the other
// entries. It writes feasible, score and avail only; the program's
// prev_replicas and tie are inputs that go to the tail as they are. One
// block of 256 threads per row stages the row's four toleration rows in
// shared memory. Bound by memory bandwidth: per element it reads three
// bool masks and the i32 answer and writes 9 bytes (about 0.84 GB at
// 10240 x 5120).
//
// mesh_tile_filter, the fourth entry: the tile filter of the mesh solve.
// Replaces the per-device half of karmada_tpu/parallel/mesh.py:156
// `_sharded_body` (decompress_batch with `col_offset`, core.py:363-393,
// then filter_estimate_phase on the local tile) together with the
// elementwise terms the reference applies after its all_gather (:208-219:
// the out-of-tree mask ANDed into feasibility, the score added, the
// registered-estimator answers min-merged where >= 0). Block b evaluates
// row b of one [B_l, C_l] tile of the global [Bp, Cp] problem whose first
// column is col0: the fleet slice and the affinity table's column slice
// are the tile's own (C = C_l), the prev / evict lists hold GLOBAL column
// ids and are made tile-local as they are staged in shared memory (an id
// outside [col0, col0 + C_l), the Cp sentinel included, becomes -1, which
// no column matches), the tie is splitmix64 at the global column col0 + c,
// and the three [B_l, C_l] terms are read in place through their row
// strides (column slices of the row group's [B_l, Cp] blocks; null when
// absent). Since the terms are elementwise, applying them per tile equals
// applying them after the gather. It writes feasible, score, avail, prev
// and tie as [B_l, C_l] and the tile's feasible count per row. Bound by
// memory bandwidth as dense_filter is: 17 bytes written per element, plus
// 9 read when all three terms are present.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry points at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "capped_div.cuh"
#include "filter_common.cuh"

namespace {

using filter_common::ColEval;
using filter_common::FilterArgs;

constexpr int kThreads = 256;

struct DenseOut {
  uint8_t* feasible;    // [B,C]
  int32_t* score;       // [B,C]
  int32_t* avail;       // [B,C]
  int32_t* prev;        // [B,C]
  int32_t* tie;         // [B,C]
  int32_t* feas_count;  // [B]
};

// ---- dense_filter and sim_filter: the factored tables, then the tiled main pass ----

// est_u's sentinel: "this row's replicas" (no resource requested, or the
// minimum reaches INT32_MAX); every other entry is the answer in
// [0, INT32_MAX).
constexpr int32_t kEstReplicas = -1;
// main pass: each thread owns 4 adjacent columns of one row; a block runs
// kThreads / qt rows side by side over a tile of 4 qt columns (qt = 32-256
// threads a row, so a warp never spans two rows) and walks groups of
// kGroupRows rows of one scenario
constexpr int kTileCols = 4 * kThreads;
constexpr int kGroupRows = 32;

// The tables the main pass reads instead of redoing per row what depends
// on fewer indices than (s, b, c) (S = 1 for dense_filter).
struct Tables {
  int32_t* est_u;   // [S,U,C] the estimate per distinct request
  uint8_t* col_ok;  // [S,Tt,C] alive and every taint tolerated by table t
  uint8_t* api_t;   // [S,G,C] api_ok transposed, so a row reads it along c
  int U, Tt;
};

// The main pass's outputs ([S,B,C] and [S,B]; score only in the dense mode).
struct MainOut {
  uint8_t* feasible;
  int32_t* score;
  int32_t* avail;
  int32_t* prev;
  int32_t* tie;
  int32_t* feas_count;  // zeroed by factor_kernel
};

// general_estimate_unique's minimum for request row u at (s, c), with the
// clamps of general_estimate_apply that do not depend on the row: 0
// without a summary, kEstReplicas when no resource is requested or the
// minimum reaches INT32_MAX. A resource with cap <= 0 answers 0.
__device__ inline int32_t factor_estimate(const FilterArgs& p, int s, int u, int c) {
  const int64_t sc = (int64_t)s * p.C + c;
  if (!p.has_summary[sc]) return 0;
  const int64_t* cap = p.capacity + sc * p.R;
  const int64_t* req = p.req_unique + (int64_t)u * p.R;
  bool any_req = false;
  int64_t est = filter_common::kI32Max;  // the cap: at or above it the answer is replicas
  for (int i = 0; i < p.R; ++i) {
    const int64_t q = req[i];
    if (q <= 0) continue;
    any_req = true;
    const int64_t v = cap[i];
    if (v <= 0) {
      est = 0;
      break;
    }
    est = capped_div::capped_div(v, q, est);
    if (est == 0) break;
  }
  if (!any_req || est >= filter_common::kI32Max) return kEstReplicas;
  return (int32_t)est;
}

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
      if (c < p.C) f.est_u[((int64_t)s * f.U + j) * p.C + c] = factor_estimate(p, s, j, c);
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

// Four adjacent elements: one 16-byte (or 4-byte for bytes) access where
// kVec, else four scalar ones of which those at or past `n` are skipped.
template <bool kVec>
__device__ __forceinline__ int4 load4(const int32_t* at, int n) {
  if (kVec) return *reinterpret_cast<const int4*>(at);
  int4 v = make_int4(0, 0, 0, 0);
  if (n > 0) v.x = at[0];
  if (n > 1) v.y = at[1];
  if (n > 2) v.z = at[2];
  if (n > 3) v.w = at[3];
  return v;
}

template <bool kVec>
__device__ __forceinline__ uint32_t load4(const uint8_t* at, int n) {
  if (kVec) return *reinterpret_cast<const uint32_t*>(at);
  uint32_t v = 0;
  for (int j = 0; j < 4 && j < n; ++j) v |= (uint32_t)at[j] << (8 * j);
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(int32_t* at, const int32_t (&v)[4], int n) {
  if (kVec) {
    *reinterpret_cast<int4*>(at) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < 4 && j < n; ++j) at[j] = v[j];
  }
}

__device__ __forceinline__ int lane4(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Grid (column tiles, groups of kGroupRows rows, S; the groups beyond
// gridDim.y strided). The block walks its rows kThreads / qt at a time:
// the rows' prev and evict lists are scattered into the step's slots (a
// prev slot keeps (k + 1) << 32 | replicas of the highest entry k, so the
// last entry wins; an evict slot a flag), one barrier, and each thread
// writes its 4 columns from the factored tables, resetting its slots as
// it reads them. The slots are double-buffered, so one barrier a step
// suffices. Shared arrays are column-interleaved (column 4i + j of a row
// at j * kThreads + the row's first thread + i), so a warp's accesses are
// consecutive. kDense: dense_filter (S = 1; the score, extra_mask, the
// tie at the column id); else sim_filter (the tie at tie_idx[s, c],
// staged once a block).
template <bool kVec, bool kDense>
__global__ void __launch_bounds__(kThreads)
filter_main_kernel(FilterArgs p, const int64_t* tie_idx, const uint8_t* extra_mask, Tables f,
                   MainOut o, int qt) {
  __shared__ uint64_t tie_s[kDense ? 1 : kTileCols];
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
  if constexpr (!kDense) {
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
        if (id < c0 || id >= c1) continue;
        const int l = id - c0;
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
        if (kDense && extra_mask != nullptr) {
          ok &= load4<kVec>(extra_mask + (int64_t)b * p.C + c, n);
        }
        const int4 est =
            load4<kVec>(f.est_u + ((int64_t)s * f.U + p.req_idx[b]) * p.C + c, n);
        int4 extra = make_int4(-1, -1, -1, -1);
        if (p.extra_avail != nullptr) {
          extra = load4<kVec>(p.extra_avail + (int64_t)b * p.C + c, n);
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
          const int32_t e = lane4(est, j);
          int32_t a = e == kEstReplicas ? reps : e;
          if (unknown) a = 0;
          const int32_t x = lane4(extra, j);
          if (x >= 0 && x < a) a = x;
          avail[j] = a;
          prev[j] = (int32_t)(uint32_t)sv;
          score[j] = locality && sv != 0 ? 100 : 0;
          tie[j] = kDense ? filter_common::tie_value(seed, c + j)
                          : filter_common::tie_from_index(seed, tie_s[j * qt + qi]);
          if (j < n && fj) {
            feas |= 1u << (8 * j);
            ++local;
          }
        }
        const int64_t row = ((int64_t)s * p.B + b) * p.C;
        if (kVec) {
          *reinterpret_cast<uint32_t*>(o.feasible + row + c) = feas;
        } else {
          for (int j = 0; j < 4 && j < n; ++j) o.feasible[row + c + j] = (feas >> (8 * j)) & 1;
        }
        if constexpr (kDense) store4<kVec>(o.score + row + c, score, n);
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

// The two launches of dense_filter and sim_filter on `st`: the tables
// (and the counts zeroed), then the main pass over S scenarios of B rows.
// 16-byte accesses need C % 4 == 0 (every row start then aligned) and
// aligned bases; the caller's extra_avail, extra_mask and aff_masks may be
// views.
template <bool kDense>
int launch_factored(const FilterArgs& p, const Tables& f, const MainOut& o,
                    const int64_t* tie_idx, const uint8_t* extra_mask, int S, cudaStream_t st) {
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

  // threads a row: the fewest of 32-256 whose 4 columns each cover C
  int qt = 32;
  while (qt < kThreads && 4 * qt < p.C) qt *= 2;
  const bool vec = p.C % 4 == 0 && (reinterpret_cast<uintptr_t>(p.aff_masks) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(extra_mask) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.extra_avail) & 15) == 0;
  const int groups = (p.B + kGroupRows - 1) / kGroupRows;
  const dim3 grid((p.C + 4 * qt - 1) / (4 * qt), groups < 65535 ? groups : 65535, S);
  if (vec) {
    filter_main_kernel<true, kDense><<<grid, kThreads, 0, st>>>(p, tie_idx, extra_mask, f, o, qt);
  } else {
    filter_main_kernel<false, kDense><<<grid, kThreads, 0, st>>>(p, tie_idx, extra_mask, f, o,
                                                                 qt);
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
dense_input_filter_kernel(FilterArgs p, uint8_t* feasible, int32_t* score, int32_t* avail) {
  extern __shared__ int32_t lists[];
  int32_t* tol = lists;  // [4*Kt]
  const int b = blockIdx.x;
  filter_common::load_row_tols(p, b, tol);
  __syncthreads();

  const int64_t row = (int64_t)b * p.C;
  for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
    const ColEval e = filter_common::eval_col<true>(p, b, c, tol, nullptr, nullptr, nullptr);
    feasible[row + c] = e.feasible ? 1 : 0;
    score[row + c] = e.score;
    avail[row + c] = filter_common::estimate<true>(p, b, c);
  }
}

// The three elementwise terms of a mesh tile, each null or read at
// (b, c) through its row stride.
struct TileTerms {
  const int32_t* extra_avail;  // [B,ld_avail], -1 = no answer
  const uint8_t* extra_mask;   // [B,ld_mask]
  const int32_t* extra_score;  // [B,ld_score]
  int64_t ld_avail, ld_mask, ld_score;
};

// A global column id made local to the tile [col0, col0 + C): -1 outside.
__device__ __forceinline__ int32_t tile_local(int32_t id, int col0, int C) {
  const int64_t v = (int64_t)id - col0;
  return (v >= 0 && v < C) ? (int32_t)v : -1;
}

__global__ void __launch_bounds__(kThreads)
mesh_tile_filter_kernel(FilterArgs p, int col0, TileTerms x, DenseOut o) {
  extern __shared__ int32_t lists[];
  int32_t* tol = lists;              // [4*Kt]
  int32_t* pidx = tol + 4 * p.Kt;    // [Kp]
  int32_t* prep = pidx + p.Kp;       // [Kp]
  int32_t* ev = prep + p.Kp;         // [Ke]
  __shared__ unsigned int count;

  const int b = blockIdx.x;
  const int32_t* tol_row = p.tol_tables + (int64_t)p.tol_idx[b] * 4 * p.Kt;
  for (int i = threadIdx.x; i < 4 * p.Kt; i += blockDim.x) tol[i] = tol_row[i];
  for (int i = threadIdx.x; i < p.Kp; i += blockDim.x) {
    pidx[i] = tile_local(p.prev_idx[(int64_t)b * p.Kp + i], col0, p.C);
    prep[i] = p.prev_rep[(int64_t)b * p.Kp + i];
  }
  for (int i = threadIdx.x; i < p.Ke; i += blockDim.x) {
    ev[i] = tile_local(p.evict_idx[(int64_t)b * p.Ke + i], col0, p.C);
  }
  if (threadIdx.x == 0) count = 0;
  __syncthreads();

  const uint64_t seed = p.seeds[b];
  const int64_t row = (int64_t)b * p.C;
  unsigned int local = 0;
  for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
    const ColEval e = filter_common::eval_col(p, b, c, tol, pidx, prep, ev);
    const bool feasible =
        e.feasible && (x.extra_mask == nullptr || x.extra_mask[b * x.ld_mask + c] != 0);
    int32_t score = e.score;
    if (x.extra_score != nullptr) {
      // the reference's int32 add, which wraps
      score = (int32_t)((uint32_t)score + (uint32_t)x.extra_score[b * x.ld_score + c]);
    }
    int32_t avail = filter_common::estimate(p, b, c);
    if (x.extra_avail != nullptr) {
      const int32_t a = x.extra_avail[b * x.ld_avail + c];
      if (a >= 0 && a < avail) avail = a;
    }
    o.feasible[row + c] = feasible ? 1 : 0;
    o.score[row + c] = score;
    o.avail[row + c] = avail;
    o.prev[row + c] = e.prev;
    o.tie[row + c] = filter_common::tie_value(seed, col0 + c);
    local += feasible ? 1u : 0u;
  }
  atomicAdd(&count, local);
  __syncthreads();
  if (threadIdx.x == 0) o.feas_count[b] = (int32_t)count;
}

size_t list_smem(int Kt, int Kp, int Ke) { return 4 * (size_t)(4 * Kt + 2 * Kp + Ke); }

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
  return launch_factored<true>(p, f, o, nullptr, static_cast<const uint8_t*>(extra_mask), 1,
                               static_cast<cudaStream_t>(stream));
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
  return launch_factored<false>(p, f, o, static_cast<const int64_t*>(tie_idx), nullptr, S,
                                static_cast<cudaStream_t>(stream));
}

// The fleet tables beside the dense batch of B rows: replicas, request
// [B,R] (i64), unknown_request, gvk, the four toleration tables [B,Kt],
// affinity_ok / eviction_ok / prev_member [B,C] (bool) and extra_avail
// [B,C] (i32, -1 = no answer). Every in-tree plugin is on.
extern "C" int dense_input_filter_launch(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int C, int R, int T, int G,
    const void* replicas, const void* request, const void* unknown_request, const void* gvk,
    const void* tol_key, const void* tol_value, const void* tol_effect, const void* tol_op,
    int Kt, const void* affinity_ok, const void* eviction_ok, const void* prev_member,
    const void* extra_avail, int B, int plugin_bits, void* feasible, void* score, void* avail,
    void* stream) {
  if (B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  FilterArgs p = filter_common::make_filter_args(
      alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G,
      replicas, unknown_request, gvk, nullptr, nullptr, affinity_ok, nullptr, nullptr, nullptr,
      nullptr, nullptr, request, nullptr, B, Kt, 0, 0, plugin_bits, 1, extra_avail);
  p.tol_rows[0] = static_cast<const int32_t*>(tol_key);
  p.tol_rows[1] = static_cast<const int32_t*>(tol_value);
  p.tol_rows[2] = static_cast<const int32_t*>(tol_effect);
  p.tol_rows[3] = static_cast<const int32_t*>(tol_op);
  p.eviction_ok = static_cast<const uint8_t*>(eviction_ok);
  p.prev_member = static_cast<const uint8_t*>(prev_member);
  const size_t smem = 4 * (size_t)(4 * Kt);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_input_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_input_filter_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<uint8_t*>(feasible), static_cast<int32_t*>(score),
      static_cast<int32_t*>(avail));
  return (int)cudaGetLastError();
}

// One [B, C] tile of the mesh solve: the tile's fleet slice (C columns),
// the row group's factored batch of B rows with the affinity table's
// column slice [P, C], prev / evict ids over the global columns, the
// tile's first global column col0, and the three terms (each null, with
// has_* 0, or read through its row stride ld_*).
extern "C" int mesh_tile_filter_launch(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int C, int R, int T, int G,
    const void* replicas, const void* unknown_request, const void* gvk,
    const void* tol_tables, const void* tol_idx, const void* aff_masks,
    const void* aff_idx, const void* prev_idx, const void* prev_rep,
    const void* evict_idx, const void* seeds, const void* req_unique,
    const void* req_idx, int B, int Kt, int Kp, int Ke, int plugin_bits, int col0,
    const void* extra_avail, long long ld_avail, const void* extra_mask, long long ld_mask,
    const void* extra_score, long long ld_score, void* feasible, void* score, void* avail,
    void* prev, void* tie, void* feas_count, void* stream) {
  if (B <= 0 || C <= 0 || col0 < 0) return (int)cudaErrorInvalidValue;
  const FilterArgs p = filter_common::make_filter_args(
      alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G,
      replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx, prev_idx,
      prev_rep, evict_idx, seeds, req_unique, req_idx, B, Kt, Kp, Ke, plugin_bits, 0, nullptr);
  TileTerms x;
  x.extra_avail = static_cast<const int32_t*>(extra_avail);
  x.extra_mask = static_cast<const uint8_t*>(extra_mask);
  x.extra_score = static_cast<const int32_t*>(extra_score);
  x.ld_avail = ld_avail;
  x.ld_mask = ld_mask;
  x.ld_score = ld_score;
  DenseOut o;
  o.feasible = static_cast<uint8_t*>(feasible);
  o.score = static_cast<int32_t*>(score);
  o.avail = static_cast<int32_t*>(avail);
  o.prev = static_cast<int32_t*>(prev);
  o.tie = static_cast<int32_t*>(tie);
  o.feas_count = static_cast<int32_t*>(feas_count);
  const size_t smem = list_smem(Kt, Kp, Ke);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mesh_tile_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mesh_tile_filter_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p, col0, x,
                                                                                    o);
  return (int)cudaGetLastError();
}
