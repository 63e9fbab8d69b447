// fleet_estimate: the estimator sweep over a whole fleet's nodes.
//
// Replaces karmada_tpu/estimator/client.py:23 `_fleet_rows_kernel`, which
// runs karmada_tpu/ops/estimate.py:53 `fleet_estimate` (with :23
// `node_available_replicas`) over the concatenated node arrays of every
// member cluster, each node masked by the claim-free feasibility (its
// taints). For row b and cluster c the answer is the sum over the
// cluster's nodes n of
//   per = min over r with request[b, r] > 0 of
//           floor((alloc[n, r] - requested[n, r]) / request[b, r])
//         (2^31 - 1 when no resource is requested),
//   per = min(per, max(allowed[n] - pod_count[n], 0)), clipped to
//         [0, 2^31 - 1], and 0 where !claimless_ok[n],
// summed in int64 and clipped to [0, 2^31 - 1] (int32 out). A cluster
// without nodes answers 0; the host overlays the discard sentinel on
// clusters without node state.
//
// The answer depends on the row only through its request, and a round's
// rows carry few distinct requests (they come from policies), so the
// caller passes a table of U distinct requests and each row's index into
// it, and each (request, cluster) pair is evaluated once:
// - fleet_sweep_kernel: a block takes 64 clusters and up to 32 distinct
//   requests. It stages its clusters' nodes in shared memory in chunks
//   (free = alloc - requested per resource, the node's cap
//   min(max(allowed - pod_count, 0), 2^31 - 1), 0 when the node is not
//   claim-free, and the node's cluster within the tile), computed once
//   and reused for every request; one thread per (request, node), so a
//   skewed cluster spreads over many threads, adds its node's answer into
//   a 64-bit shared sum per (request, cluster) (exact in any order); then
//   the block writes its [requests, clusters] sums, clipped.
// - fleet_gather_kernel: writes row b of the [B, C] answers as the table
//   row of its request (16-byte copies when C % 4 == 0). Rows that are
//   all distinct (no index) get the sweep's answers written in place.
// A node's answer needs the quotient only below its cap (at most 2^31 -
// 1), so a negative free capacity answers 0 at once and capped_div.cuh
// replaces the int64 division (a float64 estimate corrected exactly).
//
// Nodes lie in cluster order within `off` (i32[C + 1], each cluster's
// range), read through `order` (i32[N], a stable sort by cluster id, built
// by the wrapper when the caller gives no ranges) or in place when
// `order` is null (the estimator's snapshot concatenates nodes in cluster
// order and keeps its ranges beside them).
//
// Bound on an H100: the 4-byte [B, C] answers written once (100 MB at
// 5 000 x 5 000: 0.03 ms); the node arrays are read once per block of
// distinct requests (from L2), and the divisions are U N R at most.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "capped_div.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 64;  // clusters a sweep block
constexpr int kTileU = 32;  // distinct requests a sweep block
constexpr int kNodeBytes = 24 * 1024;  // shared memory for a chunk of staged nodes
constexpr int kMaxChunk = 1024;
constexpr int kMaxGridY = 65535;
constexpr int64_t kI32Max = capped_div::kI32Max;

// shared memory of one sweep block for a chunk of `chunk` nodes of R
// resources: the sums, the tile's ranges, then per node R free values,
// the cap and the cluster within the tile
size_t sweep_smem(int chunk, int R) {
  return sizeof(unsigned long long) * kTileU * kTileC + sizeof(int32_t) * (kTileC + 2) +
         (size_t)chunk * (8 * (size_t)R + 8 + 1);
}

__global__ void __launch_bounds__(kThreads)
fleet_sweep_kernel(const int64_t* alloc, const int64_t* requested, const int64_t* pod_count,
                   const int64_t* allowed, const uint8_t* claimless_ok, const int32_t* order,
                   const int32_t* off, int C, int R, const int64_t* request, int U, int chunk,
                   int32_t* ans) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);  // [kTileU][kTileC]
  int32_t* off_s = reinterpret_cast<int32_t*>(acc + kTileU * kTileC);   // [kTileC + 1]
  int64_t* free_s = reinterpret_cast<int64_t*>(off_s + kTileC + 2);     // [R][chunk]
  int64_t* cap_s = free_s + (size_t)R * chunk;                           // [chunk]
  uint8_t* cl_s = reinterpret_cast<uint8_t*>(cap_s + chunk);            // [chunk]

  const int c0 = blockIdx.x * kTileC;
  const int nc = min(kTileC, C - c0);
  const int u0 = blockIdx.y * kTileU;
  const int nu = min(kTileU, U - u0);
  for (int i = threadIdx.x; i < kTileU * kTileC; i += kThreads) acc[i] = 0;
  for (int i = threadIdx.x; i <= nc; i += kThreads) off_s[i] = off[c0 + i];
  __syncthreads();

  const int n1 = off_s[nc];
  for (int base = off_s[0]; base < n1; base += chunk) {
    const int m = min(chunk, n1 - base);
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const int pos = base + j;
      const int64_t node = order != nullptr ? order[pos] : pos;
      for (int r = 0; r < R; ++r) {  // wrapping int64 differences, as the reference's
        free_s[(size_t)r * chunk + j] = (int64_t)((uint64_t)alloc[node * R + r] -
                                                  (uint64_t)requested[node * R + r]);
      }
      int64_t pods = (int64_t)((uint64_t)allowed[node] - (uint64_t)pod_count[node]);
      pods = pods < 0 ? 0 : (pods > kI32Max ? kI32Max : pods);
      cap_s[j] = claimless_ok[node] ? pods : 0;
      int lo = 0, hi = nc - 1;  // the last cluster of the tile starting at or before pos
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (off_s[mid] <= pos) lo = mid; else hi = mid - 1;
      }
      cl_s[j] = (uint8_t)lo;
    }
    __syncthreads();
    for (int item = threadIdx.x; item < m * nu; item += kThreads) {
      const int u = item / m;
      const int j = item - u * m;
      const int64_t* req = request + (int64_t)(u0 + u) * R;
      int64_t per = cap_s[j];
      for (int r = 0; r < R && per > 0; ++r) {
        const int64_t q = req[r];
        if (q <= 0) continue;
        const int64_t f = free_s[(size_t)r * chunk + j];
        per = f < 0 ? 0 : capped_div::capped_div(f, q, per);
      }
      if (per > 0) atomicAdd(&acc[u * kTileC + cl_s[j]], (unsigned long long)per);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nu * kTileC; i += kThreads) {
    const int u = i / kTileC;
    const int cc = i - u * kTileC;
    if (cc >= nc) continue;
    const unsigned long long v = acc[i];
    ans[(int64_t)(u0 + u) * C + c0 + cc] = (int32_t)(v > (unsigned long long)kI32Max ? kI32Max : v);
  }
}

// out[b, :] = ans[req_idx[b], :], 4 columns a thread
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fleet_gather_kernel(const int32_t* ans, const int32_t* req_idx, int C, int B, int32_t* out) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (c >= C) return;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int32_t* src = ans + (int64_t)req_idx[b] * C + c;
    int32_t* dst = out + (int64_t)b * C + c;
    if (kVec) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      for (int j = 0; j < 4 && c + j < C; ++j) dst[j] = src[j];
    }
  }
}

}  // namespace

// Node arrays (alloc, requested [N, R]; pod_count, allowed, claimless_ok
// [N]), `order` (i32[N], null when the nodes lie in cluster order) and
// `off` (i32[C + 1]), the U distinct requests [U, R] and each of the B
// rows' index into them (null when the rows are the requests, U = B), a
// scratch for the [U, C] table (unused without an index) and the [B, C]
// answers. One or two launches on the stream.
extern "C" int fleet_estimate_launch(const void* alloc, const void* requested,
                                     const void* pod_count, const void* allowed,
                                     const void* claimless_ok, const void* order,
                                     const void* off, int C, int R, const void* request, int U,
                                     const void* req_idx, int B, void* ans, void* out,
                                     void* stream) {
  if (B <= 0 || C <= 0 || R <= 0 || U <= 0 || (req_idx == nullptr && U != B)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunk = kNodeBytes / (8 * R + 9);
  chunk = chunk < 1 ? 1 : (chunk > kMaxChunk ? kMaxChunk : chunk);
  const size_t smem = sweep_smem(chunk, R);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fleet_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int32_t* table = static_cast<int32_t*>(req_idx == nullptr ? out : ans);
  const int u_blocks = (U + kTileU - 1) / kTileU;
  const dim3 sgrid((C + kTileC - 1) / kTileC, u_blocks);
  if (u_blocks > kMaxGridY) return (int)cudaErrorInvalidValue;
  fleet_sweep_kernel<<<sgrid, kThreads, smem, st>>>(
      static_cast<const int64_t*>(alloc), static_cast<const int64_t*>(requested),
      static_cast<const int64_t*>(pod_count), static_cast<const int64_t*>(allowed),
      static_cast<const uint8_t*>(claimless_ok), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(off), C, R, static_cast<const int64_t*>(request), U, chunk,
      table);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || req_idx == nullptr) return (int)err;
  const dim3 ggrid((C + 4 * kThreads - 1) / (4 * kThreads), B < kMaxGridY ? B : kMaxGridY);
  const int32_t* idx = static_cast<const int32_t*>(req_idx);
  if (C % 4 == 0) {
    fleet_gather_kernel<true><<<ggrid, kThreads, 0, st>>>(table, idx, C, B,
                                                            static_cast<int32_t*>(out));
  } else {
    fleet_gather_kernel<false><<<ggrid, kThreads, 0, st>>>(table, idx, C, B,
                                                             static_cast<int32_t*>(out));
  }
  return (int)cudaGetLastError();
}
