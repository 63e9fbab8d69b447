// candidate_select: the candidate prepass of the compact schedule round.
//
// Replaces karmada_tpu/sched/candidates.py:210 `_candidate_select_kernel`
// (with spread_batch.py:434 `_pack_bits`, candidates.py:166 `_tie_at` and
// candidates.py:177 `_compact_estimate` fused in). For each binding row b
// and cluster column c: the in-tree filters (alive, taints against the
// row's tolerations, API enablement, affinity mask, eviction list) and the
// locality score; the top K columns by (key desc, column asc) with
// key = (feasible << 33) + score, sorted by column ascending; then, at the
// K winners, feasibility, score, previous replicas, the GeneralEstimator
// answer (min over requested resources of cap // req, with the reference's
// clamps in its order), the registered-estimator min-merge and the
// splitmix64 tie; plus the exact feasible count and the packed feasible
// bits (bit j of byte i is column 8i+j).
//
// What bounds it on an H100: the reads are small (the fleet tables are
// shared by every row and stay in L2; per row only the affinity-mask row,
// C bytes, and O(K) outputs), so the floor is the C/8 packed bytes plus
// [B,K] outputs over memory bandwidth, well under a millisecond at
// 10240 x 5120. The real cost is the top-K selection: this first version
// bitonic-sorts the row's padded int64 keys (C padded to a power of two,
// 64 KB at C = 5120 -> 8192) in dynamic shared memory, O(C log^2 C)
// compare-swaps with a barrier per stage. One block of 512 threads per row
// keeps the keys on chip and never writes a [B, C] tensor.
//
// Past 16 384 columns the padded keys outgrow a block's shared memory
// (8 bytes x pow2(C) > 227 KB from pow2(C) = 32 768), so the wide route
// (candidate_select_wide_kernel) keeps them out of it: pass 1 writes the
// row's keys to a [B, C] int64 scratch tensor, the K-th largest key is
// found by the MSB-first radix select of radix_select.cuh (each pass
// re-reads the row's keys, 8 bytes a column, from L2 or device memory),
// and the K winners, which are exactly the columns at or above it (keys
// are distinct), are compacted in column order by a ballot scan per
// 512-column step, so nothing is sorted. It adds the scratch's write and
// its re-reads (~8 B x C x (1 + passes) per row) to the bytes above, and
// works for any width.
//
// The per-column filter, estimate and tie live in filter_common.cuh,
// shared with dense_filter.cu. Built by karmada_tpu_torch/kernels/build.py
// with nvcc for sm_90a and called through the plain C entry points at the
// bottom (ctypes).

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

constexpr int kThreads = 512;

struct SelParams : FilterArgs {
  int K;
  int Cp;      // C padded to a power of two (>= 1024)
  int Kw;      // K padded to a power of two
  int cb;      // bits of the column field in the sort key
  int nbytes;  // ceil(C / 8)
  // outputs
  int32_t* cand_idx;    // [B,K]
  uint8_t* c_feas;      // [B,K]
  int32_t* c_score;     // [B,K]
  int32_t* c_avail;     // [B,K]
  int32_t* c_prev;      // [B,K]
  int32_t* c_tie;       // [B,K]
  int32_t* feas_count;  // [B]
  uint8_t* packed;      // [B,nbytes]
};

// In-place bitonic sort of n (a power of two) keys in shared memory, all
// threads of the block taking part. descending = true sorts high first.
template <typename T>
__device__ void bitonic_sort(T* keys, int n, bool descending) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (n >> 1); q += blockDim.x) {
        const int i = 2 * q - (q & (j - 1));
        const int ixj = i + j;
        const T a = keys[i];
        const T c = keys[ixj];
        const bool up = ((i & k) == 0) != descending;  // this pair ascending?
        if (up ? (a > c) : (a < c)) {
          keys[i] = c;
          keys[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
}

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

__global__ void __launch_bounds__(kThreads)
candidate_select_kernel(SelParams p) {
  extern __shared__ int64_t smem[];
  int64_t* keys = smem;                                  // [Cp]
  int32_t* win = reinterpret_cast<int32_t*>(keys + p.Cp);  // [Kw]
  int32_t* tol = win + p.Kw;                             // [4*Kt]
  int32_t* pidx = tol + 4 * p.Kt;                        // [Kp]
  int32_t* prep = pidx + p.Kp;                           // [Kp]
  int32_t* ev = prep + p.Kp;                             // [Ke]
  __shared__ int count;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  filter_common::load_row_lists(p, b, tol, pidx, prep, ev);
  if (tid == 0) count = 0;
  __syncthreads();

  // pass 1: every column's key, the packed bits and the feasible count.
  // Columns go in warp-aligned steps, so one ballot covers 32 columns.
  const int64_t colmask = (int64_t(1) << p.cb) - 1;
  const int lane = tid & 31;
  int local = 0;
  for (int base = 0; base < p.Cp; base += blockDim.x) {
    const int c = base + tid;
    bool f = false;
    int64_t sortkey = INT64_MIN;
    if (c < p.C) {
      const ColEval e = eval_col(p, b, c, tol, pidx, prep, ev);
      f = e.feasible;
      const int64_t key = ((int64_t)f << 33) + (int64_t)e.score;
      sortkey = (key << p.cb) | (colmask - c);
    }
    keys[c] = sortkey;
    local += f ? 1 : 0;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane < 4) {
      const int byte = (base + (tid & ~31)) / 8 + lane;
      if (byte < p.nbytes) {
        p.packed[(int64_t)b * p.nbytes + byte] = (uint8_t)((bal >> (8 * lane)) & 0xffu);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(0xffffffffu, local, off);
  if (lane == 0) atomicAdd(&count, local);
  __syncthreads();
  if (tid == 0) p.feas_count[b] = count;

  // the top K keys: (key desc, column asc), the column being folded into
  // the low bits of every key so all keys are distinct
  bitonic_sort(keys, p.Cp, true);
  for (int t = tid; t < p.Kw; t += blockDim.x) {
    win[t] = t < p.K ? (int32_t)(colmask - (keys[t] & colmask)) : INT32_MAX;
  }
  __syncthreads();
  bitonic_sort(win, p.Kw, false);  // winners by column ascending

  for (int t = tid; t < p.K; t += blockDim.x) write_window(p, b, t, win[t], tol, pidx, prep, ev);
}

struct WideShared : RadixShared {
  int warp_total[kThreads / 32];
  int count;
};

// The wide route: keys in the [B, C] scratch `keys_g`, the K-th largest
// by radix select, the winners compacted in column order.
__global__ void __launch_bounds__(kThreads)
candidate_select_wide_kernel(SelParams p, int64_t* keys_g) {
  extern __shared__ int64_t smem[];
  int32_t* tol = reinterpret_cast<int32_t*>(smem);  // [4*Kt]
  int32_t* pidx = tol + 4 * p.Kt;                    // [Kp]
  int32_t* prep = pidx + p.Kp;                       // [Kp]
  int32_t* ev = prep + p.Kp;                         // [Ke]
  __shared__ WideShared s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  int64_t* keys = keys_g + (int64_t)b * p.C;
  filter_common::load_row_lists(p, b, tol, pidx, prep, ev);
  if (tid == 0) s.count = 0;
  __syncthreads();

  // pass 1: as the in-block kernel, the keys going to the scratch row
  const int64_t colmask = (int64_t(1) << p.cb) - 1;
  const int span = (p.C + blockDim.x - 1) / blockDim.x * blockDim.x;
  int local = 0;
  for (int base = 0; base < span; base += blockDim.x) {
    const int c = base + tid;
    bool f = false;
    if (c < p.C) {
      const ColEval e = eval_col(p, b, c, tol, pidx, prep, ev);
      f = e.feasible;
      const int64_t key = ((int64_t)f << 33) + (int64_t)e.score;
      keys[c] = (key << p.cb) | (colmask - c);
    }
    local += f ? 1 : 0;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane < 4) {
      const int byte = (base + (tid & ~31)) / 8 + lane;
      if (byte < p.nbytes) {
        p.packed[(int64_t)b * p.nbytes + byte] = (uint8_t)((bal >> (8 * lane)) & 0xffu);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(0xffffffffu, local, off);
  if (lane == 0) atomicAdd(&s.count, local);
  __syncthreads();
  if (tid == 0) p.feas_count[b] = s.count;

  // the K-th largest key, as the K-th smallest of its order-reversed bits
  // (select_kth's first barrier publishes the scratch row to the block)
  auto asc = [&](int c) { return ~((uint64_t)keys[c] ^ kSign); };
  uint64_t less;
  const uint64_t cut = select_kth(s, p.C, (uint64_t)p.K, asc, [](int) { return true; }, &less);

  // the winners in column order: a ballot per warp, the warps' totals in
  // shared memory, one 512-column step at a time
  int written = 0;
  for (int base = 0; base < span; base += blockDim.x) {
    const int c = base + tid;
    const bool win = c < p.C && asc(c) <= cut;
    const unsigned bal = __ballot_sync(0xffffffffu, win);
    if (lane == 0) s.warp_total[warp] = __popc(bal);
    __syncthreads();
    int before = written, step = 0;
    for (int w = 0; w < n_warps; ++w) {
      before += w < warp ? s.warp_total[w] : 0;
      step += s.warp_total[w];
    }
    if (win) {
      const int t = before + __popc(bal & ((1u << lane) - 1u));
      write_window(p, b, t, c, tol, pidx, prep, ev);
    }
    written += step;
    __syncthreads();
  }
}

int pow2_at_least(int n) {
  int v = 1;
  while (v < n) v <<= 1;
  return v;
}

int bit_length(int n) {
  int bits = 0;
  while (n > 0) {
    ++bits;
    n >>= 1;
  }
  return bits;
}

SelParams sel_params(
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
    void* packed) {
  SelParams p;
  static_cast<FilterArgs&>(p) = filter_common::make_filter_args(
      alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G,
      replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx, prev_idx,
      prev_rep, evict_idx, seeds, req_unique, req_idx, B, Kt, Kp, Ke, plugin_bits, has_extra,
      extra_avail);
  p.K = K;
  p.Cp = pow2_at_least(C < 1024 ? 1024 : C);
  p.Kw = pow2_at_least(K);
  p.cb = bit_length(C - 1) > 0 ? bit_length(C - 1) : 1;
  p.nbytes = (C + 7) / 8;
  p.cand_idx = static_cast<int32_t*>(cand_idx);
  p.c_feas = static_cast<uint8_t*>(c_feas);
  p.c_score = static_cast<int32_t*>(c_score);
  p.c_avail = static_cast<int32_t*>(c_avail);
  p.c_prev = static_cast<int32_t*>(c_prev);
  p.c_tie = static_cast<int32_t*>(c_tie);
  p.feas_count = static_cast<int32_t*>(feas_count);
  p.packed = static_cast<uint8_t*>(packed);
  return p;
}

}  // namespace

#define SEL_PARAMS_ARGS                                                                   \
  alive, capacity, has_summary, taint_key, taint_value, taint_effect, api_ok, C, R, T, G, \
      replicas, unknown_request, gvk, tol_tables, tol_idx, aff_masks, aff_idx, prev_idx,  \
      prev_rep, evict_idx, seeds, req_unique, req_idx, B, Kt, Kp, Ke, K, plugin_bits,     \
      has_extra, extra_avail, cand_idx, c_feas, c_score, c_avail, c_prev, c_tie,          \
      feas_count, packed

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
    void* packed, void* stream) {
  SelParams p = sel_params(SEL_PARAMS_ARGS);
  if (B <= 0 || K <= 0 || K > C || p.cb > 27) return (int)cudaErrorInvalidValue;

  const size_t smem = 8 * (size_t)p.Cp + 4 * (size_t)(p.Kw + 4 * Kt + 2 * Kp + Ke);
  cudaError_t err = cudaFuncSetAttribute(
      candidate_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  candidate_select_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The wide route (see the header): `keys` is an int64 [B, C] scratch.
extern "C" int candidate_select_wide_launch(
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
  SelParams p = sel_params(SEL_PARAMS_ARGS);
  if (B <= 0 || K <= 0 || K > C || p.cb > 27) return (int)cudaErrorInvalidValue;

  const size_t smem = 4 * (size_t)(4 * Kt + 2 * Kp + Ke);
  cudaError_t err = cudaFuncSetAttribute(
      candidate_select_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  candidate_select_wide_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<int64_t*>(keys));
  return (int)cudaGetLastError();
}
