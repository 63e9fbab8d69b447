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
// requests in bytes times replicas pass 2^53).
//   - dense mode: a column-parallel reduction. Each thread owns one column
//     and walks a chunk of the tier's rows, so the reads of `placed`
//     coalesce across the warp; blockIdx.y splits the rows into chunks so
//     enough blocks fill the card, and each thread adds its partial sums
//     into the [C, R] scratch with 64-bit atomics (integer adds commute, so
//     the result does not depend on their order);
//   - window mode: placed[j, k] scattered to column cand_idx[rows[j], k]
//     with 64-bit atomics, one block per row.
// A second launch applies the clamp. Bound by memory bandwidth: the tier's
// placed matrix is read once.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry points at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "filter_common.cuh"

namespace {

using filter_common::FilterArgs;

constexpr int kThreads = 256;
constexpr int kRowsPerChunk = 64;  // dense consumption: rows walked per thread
constexpr int kMaxR = 16;          // resources a consumption thread accumulates

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

__global__ void __launch_bounds__(kThreads)
tier_consume_dense_kernel(const int32_t* placed, const uint8_t* unsched, const int64_t* request,
                          const int32_t* rows, int n, int C, int R,
                          unsigned long long* cons) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  int64_t acc[kMaxR];
  for (int r = 0; r < R; ++r) acc[r] = 0;
  const int j0 = blockIdx.y * kRowsPerChunk;
  const int j1 = min(n, j0 + kRowsPerChunk);
  for (int j = j0; j < j1; ++j) {
    if (unsched[j]) continue;
    const int64_t v = placed[(int64_t)j * C + c];
    if (v == 0) continue;
    const int64_t* req = request + (int64_t)rows[j] * R;
    for (int r = 0; r < R; ++r) acc[r] += v * req[r];
  }
  for (int r = 0; r < R; ++r) {
    if (acc[r] != 0) atomicAdd(cons + (int64_t)c * R + r, (unsigned long long)acc[r]);
  }
}

__global__ void __launch_bounds__(kThreads)
tier_consume_window_kernel(const int32_t* placed, const uint8_t* unsched, const int64_t* request,
                           const int32_t* rows, const int32_t* cand_idx, int K, int R,
                           unsigned long long* cons) {
  const int j = blockIdx.x;
  if (unsched[j]) return;
  const int b = rows[j];
  const int64_t* req = request + (int64_t)b * R;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int64_t v = placed[(int64_t)j * K + k];
    if (v == 0) continue;
    const int64_t col = cand_idx[(int64_t)b * K + k];
    for (int r = 0; r < R; ++r) {
      atomicAdd(cons + col * R + r, (unsigned long long)(v * req[r]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tier_clamp_kernel(const int64_t* cap, const unsigned long long* cons, int64_t n, int64_t* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t v = cap[i] - (int64_t)cons[i];
  out[i] = v > 0 ? v : 0;
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

int clamp_launch(const void* cap, const void* cons, int C, int R, void* out, cudaStream_t s) {
  const int64_t n = (int64_t)C * R;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  tier_clamp_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const int64_t*>(cap), static_cast<const unsigned long long*>(cons), n,
      static_cast<int64_t*>(out));
  return (int)cudaGetLastError();
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

// dense mode when cand_idx is null (placed is [n, C]), window mode
// otherwise (placed is [n, K]). `cons` is a zeroed [C, R] int64 scratch.
extern "C" int tier_consume_launch(
    const void* cap, int C, int R, const void* placed, const void* unsched,
    const void* request, const void* rows, int n, const void* cand_idx, int K, void* cons,
    void* out, void* stream) {
  if (C <= 0 || R <= 0 || R > kMaxR) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* acc = static_cast<unsigned long long*>(cons);
  if (n > 0) {
    if (cand_idx == nullptr) {
      const dim3 grid((C + kThreads - 1) / kThreads, (n + kRowsPerChunk - 1) / kRowsPerChunk);
      tier_consume_dense_kernel<<<grid, kThreads, 0, s>>>(
          static_cast<const int32_t*>(placed), static_cast<const uint8_t*>(unsched),
          static_cast<const int64_t*>(request), static_cast<const int32_t*>(rows), n, C, R, acc);
    } else {
      if (K <= 0) return (int)cudaErrorInvalidValue;
      tier_consume_window_kernel<<<n, kThreads, 0, s>>>(
          static_cast<const int32_t*>(placed), static_cast<const uint8_t*>(unsched),
          static_cast<const int64_t*>(request), static_cast<const int32_t*>(rows),
          static_cast<const int32_t*>(cand_idx), K, R, acc);
    }
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return clamp_launch(cap, cons, C, R, out, s);
}
