// tiers: the per-tier pieces of the tiered schedule rounds, two kernels.
//
// The reference runs each tiered round as one XLA program
// (karmada_tpu/sched/preemption.py:125 `_tiered_kernel`, dense, and
// karmada_tpu/sched/candidates.py:770 `_tiered_candidate_kernel`, over
// candidate windows): the filter once, then per priority tier the estimate
// over the residual capacity, the division tail, and the subtraction of the
// tier's placed replicas times their requests from the capacity. The port
// composes those rounds from the filter, select and tail kernels it already
// has plus these two:
//
// tier_estimate: the GeneralEstimator answer at a capacity matrix passed in
// (the residual, or the residual plus the reclaimable capacity of the
// speculative preemption pass), with the reference's clamps in its order
// (filter_common.cuh estimate()), min-merged with the registered-estimator
// answers extra_avail[b, c] (i32[B, C], -1 = no answer) when they are
// given: the reference merges them into every tier's main pass and leaves
// them out of the speculative pass, which passes none.
//   - rows mode: for row ids rows[j], avail[rows[j], c] for every column c,
//     written into the [B, C] avail buffer the dense tail then reads
//     through the same row ids;
//   - window mode: c_avail[j, k] at the candidate column cand_idx[rows[j],
//     k] (the answer read at extra_avail[rows[j], cand_idx[rows[j], k]]),
//     the order of `_compact_estimate` (candidates.py:177), which is the
//     same clamp order.
// One block of 256 threads per row striding over the columns or window
// slots; each element is one int64 division per requested resource. Bound
// by memory bandwidth: 4 bytes written per element, the capacity matrix
// (C x R int64) stays in L2.
//
// tier_consume: cap' = max(cap - cons, 0) with cons[c, r] = sum over the
// tier's committed rows j (not unschedulable) of placed[j, c] *
// request[rows[j], r], all int64 and exact (no float product: memory
// requests in bytes times replicas pass 2^53; sums wrap as torch's int64
// does). One launch a call, after one cudaMemsetAsync that zeroes the
// caller's scratch: the [C, R] sums, then the counters. The blocks add
// their sums there with 64-bit atomics (integer adds commute, so the result
// does not depend on their order); the output, max(cap - cons, 0), is
// written once every sum is in.
//   - dense mode (placed i32[n, C]): bound by memory bandwidth, the placed
//     matrix read once. A block of 64 threads owns a strip of 256 columns,
//     four adjacent columns a thread read as one 16-byte load; blockIdx.y
//     cuts the rows into chunks so about eight blocks fill each SM. A
//     thread keeps kUnroll row loads in flight before it uses any, and
//     each row's requests (zero for an unschedulable row) are staged in
//     shared memory, so the inner loop has no branch but the skip of four
//     zero columns. R is a template parameter, so the 4 x R sums stay in
//     registers. One arrival counter per strip: the strip's last chunk to
//     arrive (__threadfence, then the counter) writes it. Rows whose width
//     is not a multiple of 4, or a placed matrix not on a 16-byte
//     boundary, take four 4-byte loads a thread instead.
//   - window mode (placed i32[n, K]): placed[j, k] scattered to column
//     cand_idx[rows[j], k]. A warp per row (any K, 32 slots a step), an
//     unschedulable row skipped whole and a zero entry before any atomic.
//     The bytes are few (~1 MB a call at the main path's sizes); the cost
//     is the atomics on hot columns (the same few clusters sit in most
//     windows: ~1 000 entries each of ~20 000 a call), so while the [C, R]
//     sums fit a block's shared memory (C R 8 <= kWinSmem bytes) each
//     block adds its rows there and then flushes its nonzero sums, one
//     global atomic per (block, column, resource). Every block adds into
//     every column, so the output waits for all of them: a cooperative
//     launch of at most one block of 16 warps per SM (all resident at
//     once) meets at a barrier on the first counter, then writes the
//     output over the whole grid.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry points at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "filter_common.cuh"

namespace {

using filter_common::FilterArgs;
using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kMaxR = 16;  // resources a consumption thread accumulates
// dense consumption
constexpr int kDenseThreads = 64;
constexpr int kStripCols = 4 * kDenseThreads;  // columns of one strip (one arrival counter)
constexpr int kStageRows = 64;                 // rows whose requests a block stages at a time
constexpr int kUnroll = 8;                     // row loads a thread keeps in flight
constexpr int kTargetBlocks = 8 * 132;         // about eight blocks on each of the 132 SMs
constexpr int kMinChunkRows = 32;
constexpr int kWinThreads = 512;       // window consumption: a warp per row
constexpr int kWinSmem = 227 * 1024;  // shared memory a block may take (sm_90)
constexpr int kClampBatch = 8;  // elements a clamping thread loads before it stores

__global__ void __launch_bounds__(kThreads)
tier_estimate_rows_kernel(FilterArgs p, const int32_t* rows, int32_t* avail) {
  const int b = rows[blockIdx.x];
  int32_t* out = avail + (int64_t)b * p.C;
  for (int c = threadIdx.x; c < p.C; c += blockDim.x) out[c] = filter_common::estimate(p, b, c);
}

__global__ void __launch_bounds__(kThreads)
tier_estimate_window_kernel(FilterArgs p, const int32_t* rows, const int32_t* cand_idx, int K,
                            int32_t* c_avail) {
  const int j = blockIdx.x;
  const int b = rows[j];
  const int32_t* cand = cand_idx + (int64_t)b * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    c_avail[(int64_t)j * K + k] = filter_common::estimate(p, b, cand[k]);
  }
}

// out[i] = max(cap[i] - sums[i], 0) for i in [lo, hi), the thread starting
// at lo + first and striding by `stride` threads, kClampBatch loads of
// each kind in flight; the sums are read from L2 (other blocks' atomics
// put them there).
__device__ void clamp_range(const int64_t* cap, const u64* sums, int64_t* out, int64_t lo,
                            int64_t hi, int64_t first, int64_t stride) {
  for (int64_t base = lo + first; base < hi; base += stride * kClampBatch) {
    u64 c[kClampBatch], q[kClampBatch];
#pragma unroll
    for (int u = 0; u < kClampBatch; ++u) {
      const int64_t i = base + u * stride;
      c[u] = i < hi ? (u64)cap[i] : 0;
      q[u] = i < hi ? __ldcg(sums + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kClampBatch; ++u) {
      const int64_t i = base + u * stride;
      const int64_t v = (int64_t)(c[u] - q[u]);
      if (i < hi) out[i] = v > 0 ? v : 0;
    }
  }
}

// Columns c0..c0+3 of one placed row (zero past C).
template <bool kVec>
__device__ __forceinline__ int4 load_cols(const int32_t* row, int c0, int C) {
  if (kVec) return __ldcs(reinterpret_cast<const int4*>(row + c0));
  int4 v;
  v.x = __ldcs(row + c0);
  v.y = c0 + 1 < C ? __ldcs(row + c0 + 1) : 0;
  v.z = c0 + 2 < C ? __ldcs(row + c0 + 2) : 0;
  v.w = c0 + 3 < C ? __ldcs(row + c0 + 3) : 0;
  return v;
}

template <int R, bool kVec>
__global__ void __launch_bounds__(kDenseThreads)
tier_consume_dense_kernel(const int64_t* cap, const int32_t* placed, const uint8_t* unsched,
                          const int64_t* request, const int32_t* rows, int n, int C,
                          int chunk_rows, u64* sums, int64_t* out, unsigned* strip_done) {
  __shared__ u64 req_s[kStageRows][R];
  const int c0 = blockIdx.x * kStripCols + threadIdx.x * 4;
  const bool live = c0 < C;
  u64 acc[4][R];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[k][r] = 0;
  }
  const int j0 = blockIdx.y * chunk_rows;
  const int j1 = min(n, j0 + chunk_rows);
  for (int s = j0; s < j1; s += kStageRows) {
    const int m = min(kStageRows, j1 - s);
    __syncthreads();  // the previous stage's requests are used up
    for (int i = threadIdx.x; i < m * R; i += kDenseThreads) {
      const int jj = i / R;
      const int j = s + jj;
      req_s[jj][i - jj * R] = unsched[j] ? 0 : (u64)request[(int64_t)rows[j] * R + i - jj * R];
    }
    __syncthreads();
    if (!live) continue;
    for (int u0 = 0; u0 < m; u0 += kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = u0 + u < m ? load_cols<kVec>(placed + (int64_t)(s + u0 + u) * C, c0, C)
                          : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if ((v[u].x | v[u].y | v[u].z | v[u].w) == 0) continue;
        const u64 px = (u64)(int64_t)v[u].x, py = (u64)(int64_t)v[u].y;
        const u64 pz = (u64)(int64_t)v[u].z, pw = (u64)(int64_t)v[u].w;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const u64 q = req_s[u0 + u][r];
          acc[0][r] += px * q;
          acc[1][r] += py * q;
          acc[2][r] += pz * q;
          acc[3][r] += pw * q;
        }
      }
    }
  }
  if (live) {
    u64* dst = sums + (int64_t)c0 * R;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= C) break;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (acc[k][r] != 0) atomicAdd(dst + k * R + r, acc[k][r]);
      }
    }
  }
  // the strip's last chunk to arrive writes the strip
  __shared__ bool last;
  __threadfence();  // this thread's atomics before the arrival
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(strip_done + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int64_t lo = (int64_t)blockIdx.x * kStripCols;
  clamp_range(cap, sums, out, lo * R, min((int64_t)C, lo + kStripCols) * R, threadIdx.x,
              kDenseThreads);
}

// The strips of C columns: one arrival counter each (dense mode).
int consume_strips(int C) { return (C + kStripCols - 1) / kStripCols; }

template <int R, bool kShared>
__global__ void __launch_bounds__(kWinThreads)
tier_consume_window_kernel(const int64_t* cap, const int32_t* placed, const uint8_t* unsched,
                           const int64_t* request, const int32_t* rows,
                           const int32_t* cand_idx, int n, int K, int C, u64* sums,
                           int64_t* out, unsigned* arrived) {
  extern __shared__ u64 block_sums[];  // [C, R] when kShared
  u64* acc = kShared ? block_sums : sums;
  if (kShared) {
    for (int i = threadIdx.x; i < C * R; i += kWinThreads) block_sums[i] = 0;
    __syncthreads();
  }
  constexpr int kWarps = kWinThreads / 32;
  const int lane = threadIdx.x % 32;
  for (int j = blockIdx.x * kWarps + threadIdx.x / 32; j < n; j += gridDim.x * kWarps) {
    if (unsched[j]) continue;
    const int64_t b = rows[j];
    u64 q[R];
#pragma unroll
    for (int r = 0; r < R; ++r) q[r] = (u64)request[b * R + r];
    const int32_t* p = placed + (int64_t)j * K;
    const int32_t* cand = cand_idx + b * K;
    for (int k = lane; k < K; k += 32) {
      const int32_t v = __ldcs(p + k);
      if (v == 0) continue;
      u64* dst = acc + (int64_t)cand[k] * R;
#pragma unroll
      for (int r = 0; r < R; ++r) atomicAdd(dst + r, (u64)(int64_t)v * q[r]);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < C * R; i += kWinThreads) {
      if (block_sums[i] != 0) atomicAdd(sums + i, block_sums[i]);
    }
  }
  // the grid barrier: every block resident (the cooperative launch), one
  // arrival each, after every thread's fence
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(arrived, 1u);
    while (*static_cast<volatile unsigned*>(arrived) < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
  clamp_range(cap, sums, out, 0, (int64_t)C * R, (int64_t)blockIdx.x * kWinThreads + threadIdx.x,
              (int64_t)gridDim.x * kWinThreads);
}

struct ConsumeArgs {
  const int64_t* cap;
  const int32_t* placed;
  const uint8_t* unsched;
  const int64_t* request;
  const int32_t* rows;
  const int32_t* cand_idx;
  int n, C, K;
  bool window;
  u64* sums;
  int64_t* out;
  unsigned* done;
};

template <int R>
int launch_consume(const ConsumeArgs& a, cudaStream_t s) {
  if (a.window) {  // one block per SM at most, all resident at once
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int warps = kWinThreads / 32;
    const long long smem = (long long)a.C * R * 8;
    const bool shared = smem <= kWinSmem;
    auto* kernel = shared ? tier_consume_window_kernel<R, true>
                          : tier_consume_window_kernel<R, false>;
    cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          kWinSmem);
    if (rc != cudaSuccess) return (int)rc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(std::max(1, std::min(sms, (a.n + warps - 1) / warps)));
    cfg.blockDim = dim3(kWinThreads);
    cfg.dynamicSmemBytes = shared ? (size_t)smem : 0;
    cfg.stream = s;
    cudaLaunchAttribute coop;
    coop.id = cudaLaunchAttributeCooperative;
    coop.val.cooperative = 1;
    cfg.attrs = &coop;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, kernel, a.cap, a.placed, a.unsched, a.request, a.rows,
                                   a.cand_idx, a.n, a.K, a.C, a.sums, a.out, a.done);
  }
  const int strips = consume_strips(a.C);
  int chunks = (kTargetBlocks + strips - 1) / strips;
  chunks = std::max(1, std::min(chunks, (a.n + kMinChunkRows - 1) / kMinChunkRows));
  const int chunk_rows = (a.n + chunks - 1) / chunks;
  if (chunk_rows > 0) chunks = (a.n + chunk_rows - 1) / chunk_rows;
  const dim3 grid(strips, chunks);
  const bool vec = a.C % 4 == 0 && reinterpret_cast<uintptr_t>(a.placed) % 16 == 0;
  if (vec) {
    tier_consume_dense_kernel<R, true><<<grid, kDenseThreads, 0, s>>>(
        a.cap, a.placed, a.unsched, a.request, a.rows, a.n, a.C, chunk_rows, a.sums, a.out,
        a.done);
  } else {
    tier_consume_dense_kernel<R, false><<<grid, kDenseThreads, 0, s>>>(
        a.cap, a.placed, a.unsched, a.request, a.rows, a.n, a.C, chunk_rows, a.sums, a.out,
        a.done);
  }
  return (int)cudaGetLastError();
}

template <int R = 1>
int dispatch_consume(int r, const ConsumeArgs& a, cudaStream_t s) {
  if constexpr (R > kMaxR) {
    return (int)cudaErrorInvalidValue;
  } else {
    return r == R ? launch_consume<R>(a, s) : dispatch_consume<R + 1>(r, a, s);
  }
}

FilterArgs estimate_args(const void* capacity, const void* has_summary, int C, int R,
                         const void* replicas, const void* unknown_request,
                         const void* req_unique, const void* req_idx,
                         const void* extra_avail) {
  FilterArgs p = {};
  p.capacity = static_cast<const int64_t*>(capacity);
  p.has_summary = static_cast<const uint8_t*>(has_summary);
  p.C = C;
  p.R = R;
  p.replicas = static_cast<const int32_t*>(replicas);
  p.unknown_request = static_cast<const uint8_t*>(unknown_request);
  p.req_unique = static_cast<const int64_t*>(req_unique);
  p.req_idx = static_cast<const int32_t*>(req_idx);
  p.extra_avail = static_cast<const int32_t*>(extra_avail);  // null: no answers
  return p;
}

}  // namespace

// rows mode when cand_idx is null (avail is the [B, C] buffer), window
// mode otherwise (out is c_avail [n, K]); extra_avail is the [B, C]
// answer matrix or null.
extern "C" int tier_estimate_launch(
    const void* capacity, const void* has_summary, int C, int R, const void* replicas,
    const void* unknown_request, const void* req_unique, const void* req_idx,
    const void* extra_avail, const void* rows, int n, const void* cand_idx, int K, void* out,
    void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const FilterArgs p = estimate_args(capacity, has_summary, C, R, replicas, unknown_request,
                                     req_unique, req_idx, extra_avail);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cand_idx == nullptr) {
    tier_estimate_rows_kernel<<<n, kThreads, 0, s>>>(p, static_cast<const int32_t*>(rows),
                                                      static_cast<int32_t*>(out));
  } else {
    if (K <= 0) return (int)cudaErrorInvalidValue;
    tier_estimate_window_kernel<<<n, kThreads, 0, s>>>(
        p, static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cand_idx), K,
        static_cast<int32_t*>(out));
  }
  return (int)cudaGetLastError();
}

// Dense mode (window == 0: placed is [n, C]) or window mode (placed is
// [n, K], cand_idx [B, K]). `out` is the [C, R] int64 output; `scratch`,
// of `scratch_bytes`, at least C x (R + 1) int64 words: the [C, R] sums
// (uint64), then the counters (uint32: one per 256-column strip in dense
// mode, the grid barrier's first in window mode). This entry zeroes the
// sums and counters on the stream, then launches the one kernel, which
// writes every element of out.
extern "C" int tier_consume_launch(
    const void* cap, int C, int R, const void* placed, const void* unsched,
    const void* request, const void* rows, int n, int window, const void* cand_idx, int K,
    void* out, void* scratch, long long scratch_bytes, void* stream) {
  if (C <= 0 || R <= 0 || R > kMaxR || n < 0 || K < 0) return (int)cudaErrorInvalidValue;
  const long long sum_bytes = (long long)C * R * 8;
  const long long used = sum_bytes + 4LL * consume_strips(C);
  if (scratch_bytes < (long long)C * (R + 1) * 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(scratch, 0, (size_t)used, s);
  if (rc != cudaSuccess) return (int)rc;
  ConsumeArgs a;
  a.cap = static_cast<const int64_t*>(cap);
  a.placed = static_cast<const int32_t*>(placed);
  a.unsched = static_cast<const uint8_t*>(unsched);
  a.request = static_cast<const int64_t*>(request);
  a.rows = static_cast<const int32_t*>(rows);
  a.cand_idx = static_cast<const int32_t*>(cand_idx);
  a.n = n;
  a.C = C;
  a.K = K;
  a.window = window != 0;
  a.sums = static_cast<u64*>(scratch);
  a.out = static_cast<int64_t*>(out);
  a.done = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) + sum_bytes);
  return dispatch_consume(R, a, s);
}
