// dense_mask: the target sets of Duplicated and non-workload rows in the
// dense schedule round and the spread round's selection masks, three
// entry points, each one launch that reads the filter outputs in place
// through the caller's row ids (int32[n], any order, repeats allowed).
//
// pack_rows replaces karmada_tpu/sched/core.py:530 `_pack_rows_kernel`
// (spread_batch._pack_bits) on the filter rows `rows`: bool[B, C] ->
// u8[n, ceil(C/8)], bit j of byte i is column 8i+j of feasible[rows[r]].
// packed_selection replaces karmada_tpu/sched/spread_batch.py:448
// `packed_selection_kernel` (with :425 `_apply_chosen` and :434
// `_pack_bits`): the same packing of feasible[rows[r], c] && column c in
// a region row r chose — `chosen` is the caller's bool[n, R], `rid[c]` the
// layout's region id + 1 (0 = regionless, never selected).
// Both are one body, `pack_kernel<kSelect, kStaged>` (pack_rows: kSelect
// off, no region test, no `rid` load, no choice read). One block per
// output row; with kSelect the row's chosen regions are staged in shared
// memory behind a 0 for the regionless id (R + 1 bytes, read in place past
// kChosenSmem). Each thread packs 16 columns into 2 output bytes: one
// 16-byte load of the filter row (a warp's loads cover 512 contiguous
// bytes) and one 2-byte store; with kSelect four int4 loads of rid (the
// layout's constant, kept by L1 / L2) and 16 shared-memory lookups. The
// row's last partial 16 columns, a C that is not a multiple of 16 and an
// input off a 16-byte boundary take a scalar path. Bound by memory
// bandwidth (C bytes read and C/8 written per row). On an H100 the drain
// cell's selection (5 000 rows x 5 120 columns) takes 0.022 ms of device
// time, a torch gather of the same rows 0.020; 32 columns a thread (two
// 16-byte loads 16 bytes apart in each thread) took 0.033.
//
// feas_idx replaces karmada_tpu/sched/core.py:539 `_feas_idx_kernel` on
// the filter rows `rows`: the ascending ids of the first k feasible
// columns of feasible[rows[r]], padded with 2^30 past the row's feasible
// count (the reference takes the top k of -where(feasible, iota, 2^30), so
// the pads are values; that top k is not reproduced, its result is). One
// warp per row, kIdxWarps rows a block, no shared memory and no barrier.
// Each step every lane loads 16 columns with one 16-byte load (a warp
// covers 512 contiguous bytes), turns them into a 16-bit mask of nonzero
// bytes, and a warp exclusive scan of the masks' popcounts
// (__shfl_up_sync) gives each lane its first output slot; the lane writes
// its ids below k in ascending order. The running count rides in a
// register from lane 31's inclusive sum, and the warp stops once it
// reaches k; the pads follow from min(count, k). The first step goes
// alone, then kIdxSteps loads are in flight before the first of them is
// scanned. A C that is not a multiple of 16 or an input off a 16-byte
// boundary takes the scalar route: a column a lane, a ballot a step.
// Bound by memory bandwidth (C bytes read, 4k written per row; a row with
// k feasible columns early reads less). On an H100 the dense flagship's
// call (2 500 rows x 5 120 columns, k = 16, every row done within its
// first step) takes 0.0026 ms of device time; with four steps in flight
// from the first it took 0.0036. pack_rows on the whole-fleet Duplicated
// round's call (2 500 rows x 5 120) takes 0.0046 against a bound of
// 0.0043.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry points at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kIdxWarps = 8;  // rows (a warp each) of a feas_idx block
constexpr int kIdxSteps = 4;  // 512-column steps a warp loads before it scans them
constexpr int kSelThreads = 256;  // most threads of a pack_kernel block
constexpr int kChosenSmem = 48 * 1024;  // a row's staged chosen regions, bytes
constexpr int32_t kPad = 1 << 30;

struct SelParams {
  const uint8_t* feas;    // [B, C] filter outputs
  const int32_t* rows;    // [n] filter row of each output row
  const uint8_t* chosen;  // [n, R] bool (kSelect only)
  const int32_t* rid;     // [C] region id + 1, 0 = regionless (kSelect only)
  int C, R, nbytes;
  bool vec;               // C % 16 == 0, feas (and rid) on 16-byte boundaries
  bool half_store;        // nbytes % 2 == 0 (out on a 2-byte boundary)
  uint8_t* out;           // [n, nbytes]
};

// bit k of the result: byte k of the 16 is nonzero
__device__ __forceinline__ unsigned nonzero16(const uint4 f) {
  const unsigned fb[4] = {f.x, f.y, f.z, f.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // 0xff per nonzero byte, kept at bit b of byte b, then the four bytes summed into the top one
    const unsigned x = __vcmpne4(fb[q], 0u) & 0x08040201u;
    bits |= ((x * 0x01010101u) >> 24) << (4 * q);
  }
  return bits;
}

// bit k of the result: column c0 + k, feasible and (kSelect) in a chosen
// region (sel(id), id = rid); the vector route's 16 columns
template <bool kSelect, typename Sel>
__device__ __forceinline__ unsigned pack16(const uint8_t* row, const int32_t* rid, int c0,
                                           Sel sel) {
  const uint4 f = __ldg(reinterpret_cast<const uint4*>(row + c0));
  if constexpr (!kSelect) {
    return nonzero16(f);
  } else {
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
}

// kSelect: pack the selection (packed_selection), else the feasible row
// (pack_rows). kStaged: the row's chosen regions in shared memory
// (R + 1 <= kChosenSmem; kSelect only)
template <bool kSelect, bool kStaged>
__global__ void __launch_bounds__(kSelThreads)
pack_kernel(SelParams p) {
  extern __shared__ uint8_t sel_s[];
  const int64_t r = blockIdx.x;
  const uint8_t* chosen = p.chosen + r * p.R;
  if constexpr (kSelect && kStaged) {
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
      bits = pack16<kSelect>(row, p.rid, c0, sel);
    } else {  // the scalar path
      const int hi = c0 + 16 < p.C ? c0 + 16 : p.C;
      for (int c = c0; c < hi; ++c) {
        bool on = row[c] != 0;
        if constexpr (kSelect) on = on && sel(p.rid[c]);
        if (on) bits |= 1u << (c - c0);
      }
    }
    if (p.half_store && 2 * h + 2 <= p.nbytes) {
      *reinterpret_cast<uint16_t*>(dst + 2 * h) = (uint16_t)bits;
    } else {
      for (int b = 0; b < 2 && 2 * h + b < p.nbytes; ++b) dst[2 * h + b] = (uint8_t)(bits >> 8 * b);
    }
  }
}

struct IdxParams {
  const uint8_t* feas;  // [B, C] filter outputs
  const int32_t* rows;  // [n] filter row of each output row
  int n, C, k;
  int32_t* out;         // [n, k]
};

// kSteps 512-column steps of one row from column c0 (the vector route):
// every lane loads its 16 columns of each step, then each step is scanned
// in order, its ids below k written; `base` is the warp's running count
template <int kSteps>
__device__ __forceinline__ void idx_steps(const uint8_t* row, int c0, int C, int k, int lane,
                                          int& base, int32_t* dst) {
  uint4 f[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = c0 + 512 * s + 16 * lane;
    f[s] = c < C ? __ldg(reinterpret_cast<const uint4*>(row + c)) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    unsigned m = nonzero16(f[s]);
    const int cnt = __popc(m);
    int incl = cnt;  // inclusive scan of the lanes' counts
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    const int c = c0 + 512 * s + 16 * lane;
    for (int pos = base + incl - cnt; m != 0 && pos < k; m &= m - 1) dst[pos++] = c + __ffs(m) - 1;
    base += __shfl_sync(kFull, incl, 31);
  }
}

// kVec: C % 16 == 0 and feas on a 16-byte boundary (16 columns a lane a
// step), else a column a lane a step
template <bool kVec>
__global__ void __launch_bounds__(32 * kIdxWarps)
feas_idx_kernel(IdxParams p) {
  const int lane = threadIdx.x & 31;
  const int64_t j = (int64_t)blockIdx.x * kIdxWarps + (threadIdx.x >> 5);
  if (j >= p.n) return;  // the whole warp
  const uint8_t* row = p.feas + (int64_t)p.rows[j] * p.C;
  int32_t* dst = p.out + j * p.k;
  int base = 0;  // feasible columns before the current step (the same in every lane)
  if constexpr (kVec) {
    // the first step alone: a row whose first k feasible columns lie in
    // its first 512 reads no more
    idx_steps<1>(row, 0, p.C, p.k, lane, base, dst);
    for (int c0 = 512; c0 < p.C && base < p.k; c0 += 512 * kIdxSteps) {
      idx_steps<kIdxSteps>(row, c0, p.C, p.k, lane, base, dst);
    }
  } else {
    for (int c0 = 0; c0 < p.C && base < p.k; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < p.C && row[c] != 0;
      const unsigned b = __ballot_sync(kFull, on);
      const int pos = base + __popc(b & ((1u << lane) - 1u));
      if (on && pos < p.k) dst[pos] = c;
      base += __popc(b);
    }
  }
  for (int q = (base < p.k ? base : p.k) + lane; q < p.k; q += 32) dst[q] = kPad;
}

// the launch of pack_kernel over n output rows
template <bool kSelect>
int pack_launch(const SelParams& p, int n, cudaStream_t st) {
  const int halves = (p.C + 15) / 16;
  const int threads = halves >= kSelThreads ? kSelThreads : (halves + 31) / 32 * 32;
  if (!kSelect) {
    pack_kernel<false, false><<<n, threads, 0, st>>>(p);
  } else if (p.R + 1 <= kChosenSmem) {
    pack_kernel<true, true><<<n, threads, p.R + 1, st>>>(p);
  } else {
    pack_kernel<true, false><<<n, threads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

SelParams sel_params(const void* feas, int C, const void* rows, void* out) {
  SelParams p;
  p.feas = static_cast<const uint8_t*>(feas);
  p.rows = static_cast<const int32_t*>(rows);
  p.chosen = nullptr;
  p.rid = nullptr;
  p.C = C;
  p.R = 0;
  p.nbytes = (C + 7) / 8;
  p.vec = C % 16 == 0 && reinterpret_cast<uintptr_t>(feas) % 16 == 0;
  p.half_store = p.nbytes % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 2 == 0;
  p.out = static_cast<uint8_t*>(out);
  return p;
}

}  // namespace

// rows index the filter outputs feas [B, C]
extern "C" int pack_rows_launch(const void* feas, int C, const void* rows, int n, void* out,
                                void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  return pack_launch<false>(sel_params(feas, C, rows, out), n, static_cast<cudaStream_t>(stream));
}

// chosen: the caller's bool[n, R] (R >= 0); rows index the filter outputs
extern "C" int packed_selection_launch(const void* feas, int C, const void* rows, int n,
                                       const void* chosen, int R, const void* rid, void* out,
                                       void* stream) {
  if (n <= 0 || C <= 0 || R < 0) return (int)cudaErrorInvalidValue;
  SelParams p = sel_params(feas, C, rows, out);
  p.chosen = static_cast<const uint8_t*>(chosen);
  p.rid = static_cast<const int32_t*>(rid);
  p.R = R;
  p.vec = p.vec && reinterpret_cast<uintptr_t>(rid) % 16 == 0;
  return pack_launch<true>(p, n, static_cast<cudaStream_t>(stream));
}

// rows index the filter outputs feas [B, C]; out is int32[n, k], 0 < k <= C
extern "C" int feas_idx_launch(const void* feas, int C, const void* rows, int n, int k, void* out,
                               void* stream) {
  if (n <= 0 || C <= 0 || k <= 0 || k > C) return (int)cudaErrorInvalidValue;
  IdxParams p;
  p.feas = static_cast<const uint8_t*>(feas);
  p.rows = static_cast<const int32_t*>(rows);
  p.n = n;
  p.C = C;
  p.k = k;
  p.out = static_cast<int32_t*>(out);
  const unsigned blocks = (unsigned)((n + kIdxWarps - 1) / kIdxWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 16 == 0 && reinterpret_cast<uintptr_t>(feas) % 16 == 0) {
    feas_idx_kernel<true><<<blocks, 32 * kIdxWarps, 0, st>>>(p);
  } else {
    feas_idx_kernel<false><<<blocks, 32 * kIdxWarps, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
