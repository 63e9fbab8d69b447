// dense_mask: the target sets of Duplicated and non-workload rows in the
// dense schedule round and the spread round's selection masks, three
// entry points.
//
// pack_rows replaces karmada_tpu/sched/core.py:530 `_pack_rows_kernel`
// (spread_batch._pack_bits): bool[rows, C] -> u8[rows, ceil(C/8)], bit j
// of byte i is column 8i+j. One thread per output byte reads its eight
// columns; bound by memory bandwidth (C + C/8 bytes per row).
//
// packed_selection replaces karmada_tpu/sched/spread_batch.py:448
// `packed_selection_kernel` (with :425 `_apply_chosen` and :434
// `_pack_bits`): the same packing of feasible[rows[j], c] && column c in a
// region row j chose — `chosen` is the caller's bool[n, R], `rid[c]` the
// layout's region id + 1 (0 = regionless, never selected). One block per
// output row: the row's chosen regions are staged in shared memory behind
// a 0 for the regionless id (R + 1 bytes, read in place past
// kChosenSmem), then each thread packs 16 columns into 2 output bytes —
// one 16-byte load of the filter row (read through rows[j]; a warp's
// loads cover 512 contiguous bytes), four int4 loads of rid (the layout's
// constant, kept by L1 / L2), 16 shared-memory lookups, one 2-byte store.
// The row's last partial 16 columns, a C that is not a multiple of 16 and
// an input off a 16-byte boundary take a scalar path. One launch a call,
// no table built on the host. Bound by memory bandwidth (C bytes read
// and C/8 written per row). On an H100 the drain cell's call (5 000 rows
// x 5 120 columns) takes 0.022 ms of device time, a torch gather of the
// same rows 0.020 and pack_rows over the gathered rows 0.014; 32 columns
// a thread (two 16-byte loads 16 bytes apart in each thread) took 0.033.
//
// feas_idx replaces karmada_tpu/sched/core.py:539 `_feas_idx_kernel`: the
// ascending ids of the first k feasible columns of each row, padded with
// 2^30 past the row's feasible count (the reference takes the top k of
// -where(feasible, iota, 2^30), so the pads are values). One block per
// row: each thread counts the feasible columns of its contiguous segment,
// an exclusive scan over the block gives every segment its first output
// slot, and each thread writes its segment's ids below k. Bound by memory
// bandwidth (C bytes read, 4k written per row).
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry points at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 256;
constexpr int kIdxThreads = 256;
constexpr int kSelThreads = 256;  // most threads of a packed_selection block
constexpr int kChosenSmem = 48 * 1024;  // a row's staged chosen regions, bytes
constexpr int32_t kPad = 1 << 30;

__global__ void __launch_bounds__(kPackThreads)
pack_rows_kernel(const uint8_t* feas, int rows, int C, int nbytes, uint8_t* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)rows * nbytes) return;
  const int64_t r = i / nbytes;
  const int byte = (int)(i - r * nbytes);
  const uint8_t* row = feas + r * C;
  unsigned v = 0;
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * byte + j;
    if (c < C && row[c] != 0) v |= 1u << j;
  }
  out[i] = (uint8_t)v;
}

struct SelParams {
  const uint8_t* feas;    // [B, C] filter outputs
  const int32_t* rows;    // [n] filter row of each output row
  const uint8_t* chosen;  // [n, R] bool
  const int32_t* rid;     // [C] region id + 1, 0 = regionless
  int C, R, nbytes;
  bool vec;               // C % 16 == 0, feas and rid on 16-byte boundaries
  bool half_store;        // nbytes % 2 == 0 (out on a 2-byte boundary)
  uint8_t* out;           // [n, nbytes]
};

// bit k of the result: column c0 + k, feasible and in a chosen region
// (sel(id), id = rid); the vector route's 16 columns
template <typename Sel>
__device__ __forceinline__ unsigned pack16(const uint8_t* row, const int32_t* rid, int c0,
                                           Sel sel) {
  const uint4 f = __ldg(reinterpret_cast<const uint4*>(row + c0));
  const unsigned fb[4] = {f.x, f.y, f.z, f.w};
  const int4* g4 = reinterpret_cast<const int4*>(rid + c0);
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // 4 columns a step: one int4 of rid, one 32-bit lane of f
    const int4 g = __ldg(g4 + q);
    const unsigned b = fb[q];
    bits |= ((b & 0xffu) != 0 && sel(g.x) ? 1u : 0u) << (4 * q);
    bits |= ((b & 0xff00u) != 0 && sel(g.y) ? 1u : 0u) << (4 * q + 1);
    bits |= ((b & 0xff0000u) != 0 && sel(g.z) ? 1u : 0u) << (4 * q + 2);
    bits |= ((b & 0xff000000u) != 0 && sel(g.w) ? 1u : 0u) << (4 * q + 3);
  }
  return bits;
}

// kStaged: the row's chosen regions in shared memory (R + 1 <= kChosenSmem)
template <bool kStaged>
__global__ void __launch_bounds__(kSelThreads)
packed_selection_kernel(SelParams p) {
  extern __shared__ uint8_t sel_s[];
  const int64_t r = blockIdx.x;
  const uint8_t* chosen = p.chosen + r * p.R;
  if constexpr (kStaged) {
    for (int g = threadIdx.x; g <= p.R; g += blockDim.x) sel_s[g] = g == 0 ? 0 : chosen[g - 1];
    __syncthreads();
  }
  auto sel = [&](int g) -> bool {
    if constexpr (kStaged) {
      return sel_s[g] != 0;
    } else {
      return g != 0 && chosen[g - 1] != 0;
    }
  };
  const uint8_t* row = p.feas + (int64_t)p.rows[r] * p.C;
  uint8_t* dst = p.out + r * p.nbytes;
  const int halves = (p.C + 15) / 16;
  for (int h = threadIdx.x; h < halves; h += blockDim.x) {
    const int c0 = 16 * h;
    unsigned bits = 0;
    if (p.vec && c0 + 16 <= p.C) {
      bits = pack16(row, p.rid, c0, sel);
    } else {  // the scalar path
      const int hi = c0 + 16 < p.C ? c0 + 16 : p.C;
      for (int c = c0; c < hi; ++c) {
        if (row[c] != 0 && sel(p.rid[c])) bits |= 1u << (c - c0);
      }
    }
    if (p.half_store && 2 * h + 2 <= p.nbytes) {
      *reinterpret_cast<uint16_t*>(dst + 2 * h) = (uint16_t)bits;
    } else {
      for (int b = 0; b < 2 && 2 * h + b < p.nbytes; ++b) dst[2 * h + b] = (uint8_t)(bits >> 8 * b);
    }
  }
}

__global__ void __launch_bounds__(kIdxThreads)
feas_idx_kernel(const uint8_t* feas, int C, int k, int32_t* out) {
  __shared__ int scan[2][kIdxThreads];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* row = feas + (int64_t)r * C;
  int32_t* dst = out + (int64_t)r * k;
  const int seg = (C + kIdxThreads - 1) / kIdxThreads;
  const int lo = t * seg < C ? t * seg : C;
  const int hi = lo + seg < C ? lo + seg : C;
  int n = 0;
  for (int c = lo; c < hi; ++c) n += row[c] != 0;
  // inclusive scan of the segment counts (Hillis-Steele, double buffered)
  scan[0][t] = n;
  __syncthreads();
  int cur = 0;
  for (int off = 1; off < kIdxThreads; off <<= 1) {
    scan[cur ^ 1][t] = scan[cur][t] + (t >= off ? scan[cur][t - off] : 0);
    cur ^= 1;
    __syncthreads();
  }
  const int total = scan[cur][kIdxThreads - 1];
  int pos = scan[cur][t] - n;  // exclusive
  for (int c = lo; c < hi && pos < k; ++c) {
    if (row[c] != 0) dst[pos++] = c;
  }
  for (int j = (total < k ? total : k) + t; j < k; j += kIdxThreads) dst[j] = kPad;
}

}  // namespace

extern "C" int pack_rows_launch(const void* feas, int rows, int C, void* out, void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int nbytes = (C + 7) / 8;
  const int64_t n = (int64_t)rows * nbytes;
  const int64_t blocks = (n + kPackThreads - 1) / kPackThreads;
  pack_rows_kernel<<<(unsigned)blocks, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(feas), rows, C, nbytes, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// chosen: the caller's bool[n, R] (R >= 0); rows index the filter outputs
extern "C" int packed_selection_launch(const void* feas, int C, const void* rows, int n,
                                       const void* chosen, int R, const void* rid, void* out,
                                       void* stream) {
  if (n <= 0 || C <= 0 || R < 0) return (int)cudaErrorInvalidValue;
  SelParams p;
  p.feas = static_cast<const uint8_t*>(feas);
  p.rows = static_cast<const int32_t*>(rows);
  p.chosen = static_cast<const uint8_t*>(chosen);
  p.rid = static_cast<const int32_t*>(rid);
  p.C = C;
  p.R = R;
  p.nbytes = (C + 7) / 8;
  p.vec = C % 16 == 0 && reinterpret_cast<uintptr_t>(feas) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(rid) % 16 == 0;
  p.half_store = p.nbytes % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 2 == 0;
  p.out = static_cast<uint8_t*>(out);
  const int halves = (C + 15) / 16;
  const int threads = halves >= kSelThreads ? kSelThreads : (halves + 31) / 32 * 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R + 1 <= kChosenSmem) {
    packed_selection_kernel<true><<<n, threads, R + 1, st>>>(p);
  } else {
    packed_selection_kernel<false><<<n, threads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" int feas_idx_launch(const void* feas, int rows, int C, int k, void* out,
                               void* stream) {
  if (rows <= 0 || C <= 0 || k <= 0 || k > C) return (int)cudaErrorInvalidValue;
  feas_idx_kernel<<<rows, kIdxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(feas), C, k, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
