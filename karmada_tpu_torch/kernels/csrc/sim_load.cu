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
// replicas can pass 2^53, so no float product; sums wrap as torch's int64
// does).
//
// What bounds it on an H100: the active rows of the result are read once,
// 4 bytes per element; the outputs are S x C x (R + 1) int64. A block of
// 128 threads owns a strip of 512 columns of scenario s (blockIdx.y), four
// adjacent columns a thread read as one 16-byte load, so a warp reads 512
// contiguous bytes of a row; blockIdx.z cuts the rows into chunks so about
// eight blocks fill each SM. Each block compacts its chunk's active row ids
// into shared memory once per tile of kTile rows, so inactive rows are
// never read, then keeps kUnroll row loads in flight before it uses any; a
// row's requests are read only where one of its four columns is nonzero
// (every lane of a warp reads the same row: one broadcast load). R is a
// template parameter, so the 4 x R sums stay in registers (no stack
// frame); any larger R runs in blocks of kBlockR resources, one launch a
// block, the first also summing the replicas. Each thread adds its partial
// sums into the outputs with 64-bit atomics (integer adds commute, so the
// result does not depend on their order); the C entry zeroes the outputs
// on the stream first.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 128;
constexpr int kStripCols = 4 * kThreads;  // columns of one block
constexpr int kBlockR = 8;                // resources one launch sums in registers
constexpr int kTile = 1024;               // rows whose active ids a block compacts at a time
constexpr int kUnroll = 8;                // row loads a thread keeps in flight
constexpr int kTargetBlocks = 8 * 132;    // about eight blocks on each of the 132 SMs
constexpr int kMinChunkRows = 64;

// Columns c0..c0+3 of one result row (zero past C).
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

// Resources [r0, r0 + RB) of a request matrix R wide (RB = 0: none);
// `assigned` is null for every resource block but the first.
template <int RB, bool kVec>
__global__ void __launch_bounds__(kThreads)
sim_load_kernel(const int32_t* result, const uint8_t* active, const int64_t* request, int B,
                int C, int R, int r0, int chunk_rows, u64* assigned, u64* usage) {
  __shared__ int32_t ids[kTile];
  __shared__ int n_ids;
  const int s = blockIdx.y;
  const int c0 = blockIdx.x * kStripCols + threadIdx.x * 4;
  const bool live = c0 < C;
  const int32_t* res = result + (int64_t)s * B * C;
  const uint8_t* act = active + (int64_t)s * B;
  u64 asg[4] = {0, 0, 0, 0};
  u64 acc[4][RB > 0 ? RB : 1];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[k][r] = 0;
  }
  const int b0 = blockIdx.z * chunk_rows;
  const int b1 = min(B, b0 + chunk_rows);
  for (int t0 = b0; t0 < b1; t0 += kTile) {
    const int t1 = min(b1, t0 + kTile);
    __syncthreads();  // the previous tile's ids are used up
    if (threadIdx.x == 0) n_ids = 0;
    __syncthreads();
    for (int b = t0 + threadIdx.x; b < t1; b += kThreads) {
      if (act[b]) ids[atomicAdd(&n_ids, 1)] = b;  // any order: the sums commute
    }
    __syncthreads();
    const int m = n_ids;
    if (!live) continue;
    for (int u0 = 0; u0 < m; u0 += kUnroll) {
      int4 v[kUnroll];
      int row[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        row[u] = u0 + u < m ? ids[u0 + u] : -1;
        v[u] = row[u] >= 0 ? load_cols<kVec>(res + (int64_t)row[u] * C, c0, C)
                           : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if ((v[u].x | v[u].y | v[u].z | v[u].w) == 0) continue;
        const u64 px = (u64)(int64_t)v[u].x, py = (u64)(int64_t)v[u].y;
        const u64 pz = (u64)(int64_t)v[u].z, pw = (u64)(int64_t)v[u].w;
        asg[0] += px;
        asg[1] += py;
        asg[2] += pz;
        asg[3] += pw;
        const int64_t* q = request + (int64_t)row[u] * R + r0;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const u64 qr = (u64)__ldg(reinterpret_cast<const long long*>(q + r));
          acc[0][r] += px * qr;
          acc[1][r] += py * qr;
          acc[2][r] += pz * qr;
          acc[3][r] += pw * qr;
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (c0 + k >= C) break;
    const int64_t col = (int64_t)s * C + c0 + k;
    if (assigned != nullptr && asg[k] != 0) atomicAdd(assigned + col, asg[k]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (acc[k][r] != 0) atomicAdd(usage + col * R + r0 + r, acc[k][r]);
    }
  }
}

struct LoadArgs {
  const int32_t* result;
  const uint8_t* active;
  const int64_t* request;
  int S, B, C, R;
  u64* assigned;
  u64* usage;
};

template <int RB>
void launch_block(const LoadArgs& a, int r0, bool first, cudaStream_t st) {
  const int strips = (a.C + kStripCols - 1) / kStripCols;
  int chunks = (kTargetBlocks + strips * a.S - 1) / (strips * a.S);
  chunks = chunks < 1 ? 1 : chunks;
  const int most = (a.B + kMinChunkRows - 1) / kMinChunkRows;
  chunks = chunks > most ? most : chunks;
  const int chunk_rows = (a.B + chunks - 1) / chunks;
  chunks = (a.B + chunk_rows - 1) / chunk_rows;
  const dim3 grid(strips, a.S, chunks);
  u64* asg = first ? a.assigned : nullptr;
  const bool vec = a.C % 4 == 0 && reinterpret_cast<uintptr_t>(a.result) % 16 == 0;
  if (vec) {
    sim_load_kernel<RB, true><<<grid, kThreads, 0, st>>>(a.result, a.active, a.request, a.B,
                                                         a.C, a.R, r0, chunk_rows, asg, a.usage);
  } else {
    sim_load_kernel<RB, false><<<grid, kThreads, 0, st>>>(a.result, a.active, a.request, a.B,
                                                          a.C, a.R, r0, chunk_rows, asg, a.usage);
  }
}

template <int RB = 1>
void dispatch_block(int rb, const LoadArgs& a, int r0, bool first, cudaStream_t st) {
  if constexpr (RB <= kBlockR) {
    if (rb == RB) {
      launch_block<RB>(a, r0, first, st);
    } else {
      dispatch_block<RB + 1>(rb, a, r0, first, st);
    }
  }
}

}  // namespace

// result i32 [S,B,C], active bool [S,B], request i64 [B,R] (any R >= 0);
// assigned (i64 [S,C]) and usage (i64 [S,C,R]) are zeroed here on the
// stream, then one launch per block of up to kBlockR resources (one launch
// when R = 0, for the replicas alone).
extern "C" int sim_load_launch(const void* result, const void* active, const void* request,
                               int S, int B, int C, int R, void* assigned, void* usage,
                               void* stream) {
  if (S <= 0 || S > 65535 || B <= 0 || C <= 0 || R < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(assigned, 0, (size_t)S * C * 8, st);
  if (rc == cudaSuccess && R > 0) rc = cudaMemsetAsync(usage, 0, (size_t)S * C * R * 8, st);
  if (rc != cudaSuccess) return (int)rc;
  LoadArgs a;
  a.result = static_cast<const int32_t*>(result);
  a.active = static_cast<const uint8_t*>(active);
  a.request = static_cast<const int64_t*>(request);
  a.S = S;
  a.B = B;
  a.C = C;
  a.R = R;
  a.assigned = static_cast<u64*>(assigned);
  a.usage = static_cast<u64*>(usage);
  if (R == 0) launch_block<0>(a, 0, true, st);  // the replicas alone
  for (int r0 = 0; r0 < R; r0 += kBlockR) {
    const int rb = R - r0 < kBlockR ? R - r0 : kBlockR;
    dispatch_block(rb, a, r0, r0 == 0, st);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  return (int)cudaGetLastError();
}
