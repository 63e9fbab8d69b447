// fleet_estimate: the estimator sweep over a whole fleet's nodes in one
// launch.
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
// The division floors explicitly: a node can be overcommitted
// (requested > alloc after a large placement) and C's `/` truncates
// toward zero. The reference reduces per cluster with a segment sum over
// the nodes' cluster ids; here `order` (i32[N]) is a stable sort of the
// nodes by cluster id and `off` (i32[C + 1]) each cluster's range in it,
// both built by the wrapper from the cluster ids, so one thread per
// (row, cluster) walks its cluster's nodes: no atomics, a fixed summation
// order, any node order.
//
// One thread per (b, c), 128 consecutive clusters per block, so the
// [B, C] output is written coalesced; blockIdx.y strides over the rows.
// The row's request is staged in shared memory for up to kMaxR resources;
// a wider request (kWide) is read in place, every thread of a block at the
// same address (one broadcast load), so any R runs in the one launch: the
// minimum over resources is taken per node before the sum over the
// cluster's nodes, so resource blocks could not be merged after it. The
// node arrays (about
// 17 500 nodes x 4 resources x 16 bytes at the flagship) stay in L2.
// Against the card's peak rates it is bound by the 4-byte outputs (100 MB
// at 5 000 x 5 000) over the B * N * R divisions (3.5e8); int64 division
// is a software sequence of some tens of instructions, so in practice the
// divisions set its time.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxR = 16;  // resources staged in shared memory
constexpr int kMaxGridY = 65535;
constexpr int64_t kI32Max = 2147483647LL;

__device__ inline int64_t floor_div(int64_t a, int64_t q) {  // q > 0
  int64_t v = a / q;
  if (a % q != 0 && a < 0) v -= 1;
  return v;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
fleet_estimate_kernel(const int64_t* alloc, const int64_t* requested, const int64_t* pod_count,
                      const int64_t* allowed, const uint8_t* claimless_ok,
                      const int32_t* order, const int32_t* off, const int64_t* request, int B,
                      int C, int R, int32_t* out) {
  __shared__ int64_t req_s[kMaxR];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const long long* req_g = reinterpret_cast<const long long*>(request + (int64_t)b * R);
    if (!kWide && threadIdx.x < R) req_s[threadIdx.x] = req_g[threadIdx.x];
    __syncthreads();
    if (c < C) {
      int64_t sum = 0;
      for (int i = off[c]; i < off[c + 1]; ++i) {
        const int n = order[i];
        if (!claimless_ok[n]) continue;
        int64_t per = kI32Max;
        for (int r = 0; r < R; ++r) {
          const int64_t q = kWide ? (int64_t)req_g[r] : req_s[r];
          if (q <= 0) continue;
          const int64_t v =
              floor_div(alloc[(int64_t)n * R + r] - requested[(int64_t)n * R + r], q);
          per = v < per ? v : per;
        }
        int64_t pods_left = allowed[n] - pod_count[n];
        pods_left = pods_left > 0 ? pods_left : 0;
        per = pods_left < per ? pods_left : per;
        per = per < 0 ? 0 : (per > kI32Max ? kI32Max : per);
        sum += per;
      }
      sum = sum > kI32Max ? kI32Max : sum;
      out[(int64_t)b * C + c] = (int32_t)sum;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int fleet_estimate_launch(const void* alloc, const void* requested,
                                     const void* pod_count, const void* allowed,
                                     const void* claimless_ok, const void* order,
                                     const void* off, int C, int R, const void* request, int B,
                                     void* out, void* stream) {
  if (B <= 0 || C <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kThreads - 1) / kThreads, B < kMaxGridY ? B : kMaxGridY);
  auto* kernel = R <= kMaxR ? fleet_estimate_kernel<false> : fleet_estimate_kernel<true>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(alloc), static_cast<const int64_t*>(requested),
      static_cast<const int64_t*>(pod_count), static_cast<const int64_t*>(allowed),
      static_cast<const uint8_t*>(claimless_ok), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(off),
      static_cast<const int64_t*>(request), B, C, R, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
