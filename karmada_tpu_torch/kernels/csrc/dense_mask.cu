// dense_mask: the target sets of Duplicated and non-workload rows in the
// dense schedule round, two entry points.
//
// pack_rows replaces karmada_tpu/sched/core.py:530 `_pack_rows_kernel`
// (spread_batch._pack_bits): bool[rows, C] -> u8[rows, ceil(C/8)], bit j
// of byte i is column 8i+j. One thread per output byte reads its eight
// columns; bound by memory bandwidth (C + C/8 bytes per row).
//
// packed_selection replaces karmada_tpu/sched/spread_batch.py:448
// `packed_selection_kernel` (with :425 `_apply_chosen`): the same packing
// of feasible[rows[j], c] && chosen[j, rid[c]] — the filter row read
// through its row id, a column kept only in a region the row chose
// (chosen is u8[n, R + 1], column 0 the regionless id, never chosen). The
// same kernel with the selection compiled in; the extra reads (the row's
// small chosen table and rid, both cached) leave it bound by memory.
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
constexpr int32_t kPad = 1 << 30;

struct Selection {
  const int32_t* rows;    // [n] filter row of each output row
  const uint8_t* chosen;  // [n, R1]
  int R1;
  const int32_t* rid;     // [C]
};

template <bool kSel>
__global__ void __launch_bounds__(kPackThreads)
pack_rows_kernel(const uint8_t* feas, int rows, int C, int nbytes, uint8_t* out, Selection sel) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)rows * nbytes) return;
  const int64_t r = i / nbytes;
  const int byte = (int)(i - r * nbytes);
  const uint8_t* row = feas + (kSel ? (int64_t)sel.rows[r] : r) * C;
  unsigned v = 0;
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * byte + j;
    bool on = c < C && row[c] != 0;
    if constexpr (kSel) on = on && sel.chosen[r * sel.R1 + sel.rid[c]] != 0;
    if (on) v |= 1u << j;
  }
  out[i] = (uint8_t)v;
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
  pack_rows_kernel<false>
      <<<(unsigned)blocks, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(feas), rows, C, nbytes, static_cast<uint8_t*>(out),
          Selection{});
  return (int)cudaGetLastError();
}

extern "C" int packed_selection_launch(const void* feas, int C, const void* rows, int n,
                                       const void* chosen, int R1, const void* rid, void* out,
                                       void* stream) {
  if (n <= 0 || C <= 0 || R1 <= 0) return (int)cudaErrorInvalidValue;
  const int nbytes = (C + 7) / 8;
  const int64_t blocks = ((int64_t)n * nbytes + kPackThreads - 1) / kPackThreads;
  const Selection sel{static_cast<const int32_t*>(rows), static_cast<const uint8_t*>(chosen), R1,
                      static_cast<const int32_t*>(rid)};
  pack_rows_kernel<true>
      <<<(unsigned)blocks, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(feas), n, C, nbytes, static_cast<uint8_t*>(out), sel);
  return (int)cudaGetLastError();
}

extern "C" int feas_idx_launch(const void* feas, int rows, int C, int k, void* out,
                               void* stream) {
  if (rows <= 0 || C <= 0 || k <= 0 || k > C) return (int)cudaErrorInvalidValue;
  feas_idx_kernel<<<rows, kIdxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(feas), C, k, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
