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
// is ANDed into the feasibility before the count. The per-column code is
// filter_common.cuh, shared with candidate_select.cu.
//
// What bounds it on an H100: it is elementwise and writes four i32 and one
// bool [B, C] tensors, 17 bytes per element (about 0.9 GB at 10240 x 5120),
// so it is bound by memory bandwidth; the reads are the fleet tables (L2
// resident) and one affinity-mask row per binding. The per-element work is
// the taint x toleration loop, the prev/evict list scans from shared
// memory, one int64 division per requested resource and the splitmix64
// hash. One block of 256 threads per row: the row's toleration row and
// prev/evict lists are staged in shared memory once, the threads stride
// over the columns with coalesced stores, and the feasible count is a
// shared-memory sum, so no [B, C] tensor is read back.
//
// sim_filter, the second entry: the same per-column filter and estimate
// over a scenario-stacked fleet, the first launch of the simulation
// plane's solve. Replaces the filter half of
// karmada_tpu/simulation/engine.py:261 `_sim_kernel` (its decompress of
// the factored batch, then `_schedule_body`'s filter_estimate_phase under
// `jax.vmap` over the scenario axis, with the tie from
// `tie_from_index(seeds, tie_idx[s])`). Grid (B, S): block (b, s) stages
// row b's toleration row and prev/evict lists once, as dense_filter_kernel
// does, and evaluates every column against scenario s's slice of the
// stacked fleet (alive, capacity, has_summary, taints, api_ok, each
// [S, C, ...]); the tie comes from the scenario's 1-based present rank
// tie_idx[s, c] (a drained column repeats its neighbour's rank, but is
// never feasible), and extra_avail, shared by every scenario, is read at
// (b, c). It writes feasible, avail, prev and tie as [S, B, C] and the
// feasible count as [S, B]; the simulation drops the score, so none is
// written. Bound by memory bandwidth: 13 bytes written per [S, B, C]
// element; the fleet slices (S x C x (R + 3T + G) words) stay in L2.
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

__global__ void __launch_bounds__(kThreads)
dense_filter_kernel(FilterArgs p, DenseOut o, const uint8_t* extra_mask) {
  extern __shared__ int32_t lists[];
  int32_t* tol = lists;              // [4*Kt]
  int32_t* pidx = tol + 4 * p.Kt;    // [Kp]
  int32_t* prep = pidx + p.Kp;       // [Kp]
  int32_t* ev = prep + p.Kp;         // [Ke]
  __shared__ unsigned int count;

  const int b = blockIdx.x;
  filter_common::load_row_lists(p, b, tol, pidx, prep, ev);
  if (threadIdx.x == 0) count = 0;
  __syncthreads();

  const uint64_t seed = p.seeds[b];
  const int64_t row = (int64_t)b * p.C;
  unsigned int local = 0;
  for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
    const ColEval e = filter_common::eval_col(p, b, c, tol, pidx, prep, ev);
    const bool feasible = e.feasible && (extra_mask == nullptr || extra_mask[row + c] != 0);
    o.feasible[row + c] = feasible ? 1 : 0;
    o.score[row + c] = e.score;
    o.avail[row + c] = filter_common::estimate(p, b, c);
    o.prev[row + c] = e.prev;
    o.tie[row + c] = filter_common::tie_value(seed, c);
    local += feasible ? 1u : 0u;
  }
  atomicAdd(&count, local);
  __syncthreads();
  if (threadIdx.x == 0) o.feas_count[b] = (int32_t)count;
}

struct SimOut {
  uint8_t* feasible;    // [S,B,C]
  int32_t* avail;       // [S,B,C]
  int32_t* prev;        // [S,B,C]
  int32_t* tie;         // [S,B,C]
  int32_t* feas_count;  // [S,B]
};

__global__ void __launch_bounds__(kThreads)
sim_filter_kernel(FilterArgs p, const int64_t* tie_idx, SimOut o) {
  extern __shared__ int32_t lists[];
  int32_t* tol = lists;              // [4*Kt]
  int32_t* pidx = tol + 4 * p.Kt;    // [Kp]
  int32_t* prep = pidx + p.Kp;       // [Kp]
  int32_t* ev = prep + p.Kp;         // [Ke]
  __shared__ unsigned int count;

  const int b = blockIdx.x;
  const int s = blockIdx.y;
  // scenario s's slice of the stacked fleet; the batch is shared
  FilterArgs q = p;
  q.alive = p.alive + (int64_t)s * p.C;
  q.capacity = p.capacity + (int64_t)s * p.C * p.R;
  q.has_summary = p.has_summary + (int64_t)s * p.C;
  q.taint_key = p.taint_key + (int64_t)s * p.C * p.T;
  q.taint_value = p.taint_value + (int64_t)s * p.C * p.T;
  q.taint_effect = p.taint_effect + (int64_t)s * p.C * p.T;
  q.api_ok = p.api_ok + (int64_t)s * p.C * p.G;
  const int64_t* tidx = tie_idx + (int64_t)s * p.C;

  filter_common::load_row_lists(q, b, tol, pidx, prep, ev);
  if (threadIdx.x == 0) count = 0;
  __syncthreads();

  const uint64_t seed = q.seeds[b];
  const int64_t row = ((int64_t)s * q.B + b) * q.C;
  unsigned int local = 0;
  for (int c = threadIdx.x; c < q.C; c += blockDim.x) {
    const ColEval e = filter_common::eval_col(q, b, c, tol, pidx, prep, ev);
    o.feasible[row + c] = e.feasible ? 1 : 0;
    o.avail[row + c] = filter_common::estimate(q, b, c);
    o.prev[row + c] = e.prev;
    o.tie[row + c] = filter_common::tie_from_index(seed, (uint64_t)tidx[c]);
    local += e.feasible ? 1u : 0u;
  }
  atomicAdd(&count, local);
  __syncthreads();
  if (threadIdx.x == 0) o.feas_count[(int64_t)s * q.B + b] = (int32_t)count;
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

extern "C" int dense_filter_launch(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int C, int R, int T, int G,
    const void* replicas, const void* unknown_request, const void* gvk,
    const void* tol_tables, const void* tol_idx, const void* aff_masks,
    const void* aff_idx, const void* prev_idx, const void* prev_rep,
    const void* evict_idx, const void* seeds, const void* req_unique,
    const void* req_idx, int B, int Kt, int Kp, int Ke, int plugin_bits,
    int has_extra, const void* extra_avail, const void* extra_mask, void* feasible, void* score,
    void* avail, void* prev, void* tie, void* feas_count, void* stream) {
  if (B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const FilterArgs p = filter_common::make_filter_args(
      alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G,
      replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx, prev_idx,
      prev_rep, evict_idx, seeds, req_unique, req_idx, B, Kt, Kp, Ke, plugin_bits, has_extra,
      extra_avail);
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
        dense_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_filter_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, o, static_cast<const uint8_t*>(extra_mask));
  return (int)cudaGetLastError();
}

// The scenario-stacked fleet (alive [S,C], capacity [S,C,R], has_summary
// [S,C], taints [S,C,T], api_ok [S,C,G]) and tie_idx (int64 bits of the
// u64 1-based present rank, [S,C]) beside the factored batch of B rows.
extern "C" int sim_filter_launch(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int S, int C, int R, int T, int G, const void* tie_idx,
    const void* replicas, const void* unknown_request, const void* gvk,
    const void* tol_tables, const void* tol_idx, const void* aff_masks,
    const void* aff_idx, const void* prev_idx, const void* prev_rep,
    const void* evict_idx, const void* seeds, const void* req_unique,
    const void* req_idx, int B, int Kt, int Kp, int Ke, int plugin_bits,
    int has_extra, const void* extra_avail, void* feasible, void* avail, void* prev, void* tie,
    void* feas_count, void* stream) {
  if (S <= 0 || S > 65535 || B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const FilterArgs p = filter_common::make_filter_args(
      alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G,
      replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx, prev_idx,
      prev_rep, evict_idx, seeds, req_unique, req_idx, B, Kt, Kp, Ke, plugin_bits, has_extra,
      extra_avail);
  SimOut o;
  o.feasible = static_cast<uint8_t*>(feasible);
  o.avail = static_cast<int32_t*>(avail);
  o.prev = static_cast<int32_t*>(prev);
  o.tie = static_cast<int32_t*>(tie);
  o.feas_count = static_cast<int32_t*>(feas_count);
  const size_t smem = list_smem(Kt, Kp, Ke);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sim_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sim_filter_kernel<<<dim3(B, S), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int64_t*>(tie_idx), o);
  return (int)cudaGetLastError();
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
