// candidate_select: the candidate prepass of the compact schedule round.
//
// Replaces karmada_tpu/sched/candidates.py:210 `_candidate_select_kernel`
// (with spread_batch.py:434 `_pack_bits`, candidates.py:166 `_tie_at` and
// candidates.py:177 `_compact_estimate` fused in). For each binding row b
// and cluster column c: the in-tree filters (alive, taints against the
// row's tolerations, API enablement, affinity mask, eviction list) and the
// locality score; the top K columns by (feasible desc, score desc, column
// asc), in column order; then, at the K winners, feasibility, score,
// previous replicas, the GeneralEstimator answer (min over requested
// resources of cap // req, with the reference's clamps in its order), the
// registered-estimator min-merge and the splitmix64 tie; plus the exact
// feasible count and the packed feasible bits (bit j of byte i is column
// 8i+j).
//
// What bounds it on an H100: the reads are small (the fleet tables are
// shared by every row and stay in L2; per row only the affinity-mask row,
// C bytes, and O(K) outputs), so the floor is the C/8 packed bytes plus
// [B,K] outputs over memory bandwidth, well under a millisecond at
// 10240 x 5120; what is left is the filter chain per (row, column).
//
// The design: one block per row (256 threads, 512 past 8 192 columns), and
// nothing is sorted.
//   - Pass 1 evaluates the filter chain once per column (eval_col,
//     filter_common.cuh), keeps the column's score as an order-preserving
//     uint32 (score ^ 2^31) and its feasibility as a bit of the warp's
//     ballot word, writes the packed bytes and counts the feasible columns.
//   - The K-th (feasible, score) value v* is found by the MSB-first radix
//     select of radix_select.cuh (smem_select) over one feasibility class:
//     the feasible columns when there are at least K of them, else the
//     infeasible ones (every feasible column then wins). Its passes are
//     rebased to the class's score range, 8 bits a pass, so a row of a few
//     distinct scores ends in one histogram pass; any int32 score takes at
//     most four.
//   - The winners are the columns above v* plus the first K - n_above
//     columns equal to v*, in column order: each warp takes a contiguous
//     slice of the row, counts its above / equal columns by ballot, the
//     warps' counts are scanned, and a second ballot walk over the slice
//     gives every winner its window slot; the winner's outputs (the filter
//     chain again, the estimate and the tie) are evaluated there, at the K
//     winners only.
// Keys take 4 bytes a column plus the ballot bit (4.125 bytes, no padding):
// the in-block route keeps them in dynamic shared memory while they fit
// the wrapper's budget (kernels.MAX_SELECT_SMEM: about 54 500 columns);
// wider rows keep the same code with the scores in a uint32 [B, C] scratch
// in device memory and the feasibility read back from the packed output.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "filter_common.cuh"
#include "radix_select.cuh"

namespace {

using filter_common::ColEval;
using filter_common::FilterArgs;
using filter_common::estimate;
using filter_common::eval_col;
using filter_common::tie_value;

// 256 threads a block up to kWideCols columns, 512 past them: a row of
// wide_40k's 20 480 columns holds 84 KB of keys, two blocks an SM, so the
// wider block doubles the warps in flight (2.31 against 3.78 ms a wide_40k
// chunk on an H100, PERF.md)
constexpr int kThreads = 256;
constexpr int kWideThreads = 512;
constexpr int kWideCols = 8192;
constexpr uint32_t kFlip = 0x80000000u;  // int32 order as uint32 order

struct SelParams : FilterArgs {
  int K;
  int nbytes;  // ceil(C / 8)
  int nwords;  // ceil(C / 32)
  // outputs
  int32_t* cand_idx;    // [B,K]
  uint8_t* c_feas;      // [B,K]
  int32_t* c_score;     // [B,K]
  int32_t* c_avail;     // [B,K]
  int32_t* c_prev;      // [B,K]
  int32_t* c_tie;       // [B,K]
  int32_t* feas_count;  // [B]
  uint8_t* packed;      // [B,nbytes]
  uint32_t* keys;       // [B,C] scores of the device-memory route, else null
};

struct SelShared {
  SmemSelect sel;
  int count;
  int above[kMaxWarps];
  int equal[kMaxWarps];
};

// The window outputs of winner column c at slot t of row b.
__device__ __forceinline__ void write_window(const SelParams& p, int b, int t, int c,
                                             const int32_t* tol, const int32_t* pidx,
                                             const int32_t* prep, const int32_t* ev) {
  const ColEval e = eval_col(p, b, c, tol, pidx, prep, ev);
  const int64_t o = (int64_t)b * p.K + t;
  p.cand_idx[o] = c;
  p.c_feas[o] = e.feasible ? 1 : 0;
  p.c_score[o] = e.score;
  p.c_prev[o] = e.prev;
  p.c_avail[o] = estimate(p, b, c);
  p.c_tie[o] = tie_value(p.seeds[b], c);
}

// The top K of a row in column order: v*, the K-th largest (feasible,
// score) value, by smem_select over one feasibility class (tier 1: the
// feasible columns, when there are at least K; tier 0: the infeasible ones,
// after all F feasible columns), then the columns above v* and the first
// K - n_above equal to it, a contiguous slice of the row per warp:
// emit(t, c) for the winner c at window slot t. keys[c] is the column's
// score ^ 2^31 and feas(c) its feasibility; all threads of the block call it.
template <class Feas, class Emit>
__device__ void top_k_window(SelShared& s, int C, int K, int F, const uint32_t* keys, Feas feas,
                             Emit emit) {
  const uint32_t tier = F >= K ? 1u : 0u;
  const uint64_t k = tier ? (uint64_t)K : (uint64_t)(K - F);
  const Sel v = smem_select(
      s.sel, C, k, [&](int c) { return (uint64_t)(uint32_t)~keys[c]; },
      [&](int c) { return feas(c) == tier; });
  const uint32_t vstar = ~(uint32_t)v.key;
  const int n_above = (tier ? 0 : F) + (int)v.less;
  const int need_eq = K - n_above;  // >= 1: fewer than k members lie above v*

  auto above = [&](int c) {
    const uint32_t f = feas(c);
    return f > tier || (f == tier && keys[c] > vstar);
  };
  auto equal = [&](int c) { return feas(c) == tier && keys[c] == vstar; };
  const int lane = lane_id();
  const int warp = warp_id();
  const int nw = n_warps();
  const int chunk = ((C + nw - 1) / nw + 31) & ~31;
  const int c_lo = warp * chunk;
  const int c_hi = min(C, c_lo + chunk);
  int na = 0, ne = 0;
  for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
    const int c = c0 + lane;
    const bool in = c < c_hi;
    na += __popc(__ballot_sync(kFull, in && above(c)));
    ne += __popc(__ballot_sync(kFull, in && equal(c)));
  }
  if (lane == 0) {
    s.above[warp] = na;
    s.equal[warp] = ne;
  }
  __syncthreads();
  int ab = 0, eb = 0;  // above / equal columns before the warp's slice
  for (int w = 0; w < warp; ++w) {
    ab += s.above[w];
    eb += s.equal[w];
  }
  const unsigned lower = (1u << lane) - 1u;
  for (int c0 = c_lo; c0 < c_hi && ab + min(eb, need_eq) < K; c0 += 32) {
    const int c = c0 + lane;
    const bool in = c < c_hi;
    const bool a = in && above(c);
    const bool e = in && equal(c);
    const unsigned ba = __ballot_sync(kFull, a);
    const unsigned be = __ballot_sync(kFull, e);
    const int e_before = eb + __popc(be & lower);
    // a winner's slot: the winners at smaller columns
    if (a || (e && e_before < need_eq)) emit(ab + __popc(ba & lower) + min(e_before, need_eq), c);
    ab += __popc(ba);
    eb += __popc(be);
  }
}

// kInBlock: the row's keys and ballot words in dynamic shared memory;
// otherwise the keys in p.keys and the feasibility in the packed output.
template <bool kInBlock>
__global__ void __launch_bounds__(kWideThreads)
candidate_select_kernel(SelParams p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ SelShared s;
  int32_t* tol = reinterpret_cast<int32_t*>(dyn);  // [4*Kt]
  int32_t* pidx = tol + 4 * p.Kt;                   // [Kp]
  int32_t* prep = pidx + p.Kp;                      // [Kp]
  int32_t* ev = prep + p.Kp;                        // [Ke]
  uint32_t* fw = reinterpret_cast<uint32_t*>(ev + p.Ke);  // [nwords], in-block only
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int warp = warp_id();
  uint32_t* keys = kInBlock ? fw + p.nwords : p.keys + (int64_t)b * p.C;
  uint8_t* prow = p.packed + (int64_t)b * p.nbytes;

  filter_common::load_row_lists(p, b, tol, pidx, prep, ev);
  for (int d = tid; d < 256; d += blockDim.x) s.sel.hist[d] = 0;  // smem_select's bins
  if (tid == 0) s.count = 0;
  __syncthreads();

  // ---- pass 1: every column's key and ballot bit, the packed bytes and
  // the feasible count (warp-aligned steps: one ballot covers 32 columns)
  const int span = (p.C + blockDim.x - 1) / blockDim.x * blockDim.x;
  int local = 0;
  for (int base = 0; base < span; base += blockDim.x) {
    const int c = base + tid;
    bool f = false;
    if (c < p.C) {
      const ColEval e = eval_col(p, b, c, tol, pidx, prep, ev);
      f = e.feasible;
      keys[c] = (uint32_t)e.score ^ kFlip;
    }
    local += f ? 1 : 0;
    const unsigned bal = __ballot_sync(kFull, f);
    const int word = (base >> 5) + warp;
    if (kInBlock && lane == 0 && word < p.nwords) fw[word] = bal;
    if (lane < 4) {
      const int byte = 4 * word + lane;
      if (byte < p.nbytes) prow[byte] = (uint8_t)((bal >> (8 * lane)) & 0xffu);
    }
  }
  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(kFull, local, off);
  if (lane == 0) atomicAdd(&s.count, local);
  __syncthreads();
  const int F = s.count;
  if (tid == 0) p.feas_count[b] = F;

  auto feas = [&](int c) -> uint32_t {
    if constexpr (kInBlock) {
      return (fw[c >> 5] >> (c & 31)) & 1u;
    } else {
      return (uint32_t)(prow[c >> 3] >> (c & 7)) & 1u;
    }
  };
  top_k_window(s, p.C, p.K, F, keys, feas,
               [&](int t, int c) { write_window(p, b, t, c, tol, pidx, prep, ev); });
}

// The selection alone over given [B, C] feasibility and int32 scores (any
// values): the window's columns and the feasible count. It exists to hold
// top_k_window against its plain version over scores the in-tree filters
// never produce (they give 0 or 100); no schedule round calls it.
template <bool kInBlock>
__global__ void __launch_bounds__(kThreads, 1)  // no register cap: at ptxas's own 32 it spilled
select_window_kernel(const uint8_t* feasible, const int32_t* score, int C, int K,
                     int32_t* cand_idx, int32_t* feas_count, uint32_t* keys_g) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ SelShared s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nwords = (C + 31) / 32;
  uint32_t* fw = reinterpret_cast<uint32_t*>(dyn);
  uint32_t* keys = kInBlock ? fw + nwords : keys_g + (int64_t)b * C;
  const uint8_t* frow = feasible + (int64_t)b * C;
  for (int d = tid; d < 256; d += blockDim.x) s.sel.hist[d] = 0;
  if (tid == 0) s.count = 0;
  __syncthreads();
  const int span = (C + blockDim.x - 1) / blockDim.x * blockDim.x;
  int local = 0;
  for (int base = 0; base < span; base += blockDim.x) {
    const int c = base + tid;
    const bool f = c < C && frow[c] != 0;
    if (c < C) keys[c] = (uint32_t)score[(int64_t)b * C + c] ^ kFlip;
    local += f ? 1 : 0;
    const unsigned bal = __ballot_sync(kFull, f);
    const int word = (base >> 5) + warp_id();
    if (kInBlock && lane_id() == 0 && word < nwords) fw[word] = bal;
  }
  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(kFull, local, off);
  if (lane_id() == 0) atomicAdd(&s.count, local);
  __syncthreads();
  const int F = s.count;
  if (tid == 0) feas_count[b] = F;
  auto feas = [&](int c) -> uint32_t {
    if constexpr (kInBlock) {
      return (fw[c >> 5] >> (c & 31)) & 1u;
    } else {
      return frow[c] != 0 ? 1u : 0u;
    }
  };
  top_k_window(s, C, K, F, keys, feas,
               [&](int t, int c) { cand_idx[(int64_t)b * K + t] = c; });
}

template <bool kInBlock>
int launch(const SelParams& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(candidate_select_kernel<kInBlock>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = p.C > kWideCols ? kWideThreads : kThreads;
  candidate_select_kernel<kInBlock><<<p.B, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// `keys` null: the in-block route (the row's keys in shared memory);
// otherwise a uint32 [B, C] scratch for the device-memory route.
extern "C" int candidate_select_launch(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int C, int R, int T, int G,
    const void* replicas, const void* unknown_request, const void* gvk,
    const void* tol_tables, const void* tol_idx, const void* aff_masks,
    const void* aff_idx, const void* prev_idx, const void* prev_rep,
    const void* evict_idx, const void* seeds, const void* req_unique,
    const void* req_idx, int B, int Kt, int Kp, int Ke, int K, int plugin_bits,
    int has_extra, const void* extra_avail, void* cand_idx, void* c_feas,
    void* c_score, void* c_avail, void* c_prev, void* c_tie, void* feas_count,
    void* packed, void* keys, void* stream) {
  if (B <= 0 || K <= 0 || K > C) return (int)cudaErrorInvalidValue;
  SelParams p;
  static_cast<FilterArgs&>(p) = filter_common::make_filter_args(
      alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G,
      replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx, prev_idx,
      prev_rep, evict_idx, seeds, req_unique, req_idx, B, Kt, Kp, Ke, plugin_bits, has_extra,
      extra_avail);
  p.K = K;
  p.nbytes = (C + 7) / 8;
  p.nwords = (C + 31) / 32;
  p.cand_idx = static_cast<int32_t*>(cand_idx);
  p.c_feas = static_cast<uint8_t*>(c_feas);
  p.c_score = static_cast<int32_t*>(c_score);
  p.c_avail = static_cast<int32_t*>(c_avail);
  p.c_prev = static_cast<int32_t*>(c_prev);
  p.c_tie = static_cast<int32_t*>(c_tie);
  p.feas_count = static_cast<int32_t*>(feas_count);
  p.packed = static_cast<uint8_t*>(packed);
  p.keys = static_cast<uint32_t*>(keys);
  const size_t lists = 4 * (size_t)(4 * Kt + 2 * Kp + Ke);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keys == nullptr) return launch<true>(p, lists + 4 * ((size_t)p.nwords + (size_t)C), s);
  return launch<false>(p, lists, s);
}

// The selection alone (see select_window_kernel): `keys` null takes the
// in-block route, else a uint32 [B, C] scratch.
extern "C" int select_window_launch(const void* feasible, const void* score, int B, int C,
                                    int K, void* cand_idx, void* feas_count, void* keys,
                                    void* stream) {
  if (B <= 0 || K <= 0 || K > C) return (int)cudaErrorInvalidValue;
  const uint8_t* f = static_cast<const uint8_t*>(feasible);
  const int32_t* sc = static_cast<const int32_t*>(score);
  int32_t* ci = static_cast<int32_t*>(cand_idx);
  int32_t* fc = static_cast<int32_t*>(feas_count);
  uint32_t* kg = static_cast<uint32_t*>(keys);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t words = 4 * (size_t)((C + 31) / 32);
  cudaError_t err;
  if (kg == nullptr) {
    const size_t smem = words + 4 * (size_t)C;
    err = cudaFuncSetAttribute(select_window_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    select_window_kernel<true><<<B, kThreads, smem, st>>>(f, sc, C, K, ci, fc, nullptr);
  } else {
    select_window_kernel<false><<<B, kThreads, 0, st>>>(f, sc, C, K, ci, fc, kg);
  }
  return (int)cudaGetLastError();
}
