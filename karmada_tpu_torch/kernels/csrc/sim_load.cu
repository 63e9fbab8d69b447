// sim_load: the per-scenario load of the simulation plane's solve.
//
// Replaces the load half of karmada_tpu/simulation/engine.py:261
// `_sim_kernel` (engine.py:310-312, under `jax.vmap` over the scenarios):
//   r64 = where(active[s, :, None], result[s], 0)     i64 [B, C]
//   assigned[s, c]   = sum_b r64[b, c]
//   usage[s, c, r]   = sum_b r64[b, c] * request[b, r]   (r64.T @ request)
// over the division tail's [S, B, C] int32 result, the [S, B] row
// ownership (surge rows live only in their own scenario) and the batch's
// int64 [B, R] request, all in exact int64 (memory requests in bytes times
// replicas can pass 2^53, so no float product).
//
// What bounds it on an H100: the result is read once, 4 bytes per
// [S, B, C] element; the outputs are S x C x (R + 1) int64. One thread
// owns column c of scenario s (blockIdx.y), so the warp's reads of a result
// row coalesce along c; each thread keeps R <= kMaxR + 1 int64 sums in
// registers and walks rows in tiles of kTile whose request rows and active
// flags are staged in shared memory once per block. blockIdx.z splits the
// rows into chunks so enough blocks fill the card; each thread adds its
// partial sums into the zeroed outputs with 64-bit atomics (integer adds
// commute, so the result does not depend on their order).
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 8;        // resources a thread accumulates in registers
constexpr int kTile = 64;       // rows staged in shared memory at a time
constexpr int kTargetBlocks = 1056;  // 8 blocks on each of the 132 SMs

__global__ void __launch_bounds__(kThreads)
sim_load_kernel(const int32_t* result, const uint8_t* active, const int64_t* request, int B,
                int C, int R, int rows_per_split, unsigned long long* assigned,
                unsigned long long* usage) {
  __shared__ int64_t req_s[kTile * kMaxR];
  __shared__ uint8_t act_s[kTile];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int s = blockIdx.y;
  const int b0 = blockIdx.z * rows_per_split;
  const int b1 = min(B, b0 + rows_per_split);
  const int32_t* res = result + (int64_t)s * B * C;
  int64_t asg = 0;
  int64_t acc[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) acc[r] = 0;
  for (int t0 = b0; t0 < b1; t0 += kTile) {
    const int n = min(kTile, b1 - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < n * R; i += kThreads) req_s[i] = request[(int64_t)t0 * R + i];
    for (int i = threadIdx.x; i < n; i += kThreads) act_s[i] = active[(int64_t)s * B + t0 + i];
    __syncthreads();
    if (c < C) {
      for (int i = 0; i < n; ++i) {
        if (!act_s[i]) continue;
        const int64_t v = res[(int64_t)(t0 + i) * C + c];
        if (v == 0) continue;
        asg += v;
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < R) acc[r] += v * req_s[i * R + r];
        }
      }
    }
  }
  if (c >= C) return;
  const int64_t col = (int64_t)s * C + c;
  if (asg != 0) atomicAdd(assigned + col, (unsigned long long)asg);
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r < R && acc[r] != 0) atomicAdd(usage + col * R + r, (unsigned long long)acc[r]);
  }
}

}  // namespace

// result i32 [S,B,C], active bool [S,B], request i64 [B,R]; assigned
// (i64 [S,C]) and usage (i64 [S,C,R]) must be zeroed by the caller.
extern "C" int sim_load_launch(const void* result, const void* active, const void* request,
                               int S, int B, int C, int R, void* assigned, void* usage,
                               void* stream) {
  if (S <= 0 || S > 65535 || B <= 0 || C <= 0 || R < 0 || R > kMaxR) {
    return (int)cudaErrorInvalidValue;
  }
  const int col_blocks = (C + kThreads - 1) / kThreads;
  const int tiles = (B + kTile - 1) / kTile;
  int splits = (kTargetBlocks + col_blocks * S - 1) / (col_blocks * S);
  splits = splits < 1 ? 1 : (splits > tiles ? tiles : splits);
  const int rows_per_split = (tiles + splits - 1) / splits * kTile;
  splits = (B + rows_per_split - 1) / rows_per_split;
  sim_load_kernel<<<dim3(col_blocks, S, splits), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(result), static_cast<const uint8_t*>(active),
      static_cast<const int64_t*>(request), B, C, R, rows_per_split,
      static_cast<unsigned long long*>(assigned), static_cast<unsigned long long*>(usage));
  return (int)cudaGetLastError();
}
