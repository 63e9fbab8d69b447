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
// speculative preemption pass), with the reference's clamps in its order,
// min-merged with the registered-estimator answers extra_avail[b, c]
// (i32[B, C], -1 = no answer) when they are given: the reference merges
// them into every tier's main pass and leaves them out of the speculative
// pass, which passes none. Each answer is filter_common.cuh's
// factor_estimate (each cap // req through capped_div.cuh, the
// kEstReplicas sentinel; or its reciprocal form), dense_filter.cu's table
// entry, then the row's clamps (apply_row), so the tier estimate and the
// dense filter evaluate one function.
//   - rows mode: for row ids rows[j], avail[rows[j], c] for every column c,
//     written in place into the [B, C] avail buffer the dense tail then
//     reads through the same row ids (the other rows untouched). The write
//     is the cost (n x C x 4 bytes; the capacity, C x R int64, stays in
//     L2). Two routes, chosen by the caller (kernels.estimate_route):
//     - table (the tier's rows share few requests: the flagship's ~2 560
//       tier rows share 4): tier_table_kernel builds est_u [U, C] at the
//       capacity (U x C entries), then tier_rows_kernel<kVec>, grid (column
//       tiles, groups of 16 of the tier's rows), 256 threads, each owning
//       4 adjacent columns of one row (32-256 threads a row, as
//       dense_filter.cu's main pass), reads est_u[req_idx[b]] and the
//       answers with 16-byte loads and writes with 16-byte streaming
//       stores (the avail rows are read again only by the tail);
//     - element (distinct requests about as many as the tier's rows):
//       tier_element_kernel, a thread a column, its capacities read once
//       into registers for every row, each row's requests and their
//       reciprocals staged in shared memory (capped_div::floor_div_rcp:
//       one high multiply and a correction a resource; past 16 resources
//       capped_div itself), 4-byte streaming stores coalesced over the
//       warp.
//     The group's row ids and row columns are staged once in shared
//     memory. Scalar accesses where C % 4 != 0 or a base is off a 16-byte
//     boundary.
//   - window mode: c_avail[j, k] at the candidate column cand_idx[rows[j],
//     k] (the answer read at extra_avail[rows[j], cand_idx[rows[j], k]]),
//     the order of `_compact_estimate` (candidates.py:177), which is the
//     same clamp order. A thread a window slot, 128 threads a row (the
//     width rounded up to a warp when narrower), each slot's estimate
//     through the row's staged reciprocals over the capacity row in L2.
//     A later tier's main pass (at the residual, with the answers) and
//     speculative pass (at the residual plus the tier's reclaim, summed in
//     the kernel, without them) can run as one launch with two outputs.
//   One launch a call (two on the table route). The per-round launcher
//   (kernels.TierLauncher) builds a TierRound of the round's constant
//   pointers once and passes only the capacity, the rows, the use of the
//   answers and the outputs per call (tier_estimate_round).
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
//   The one entry (tier_consume_round) takes the request, the window, the
//   scratch and the stream from a TierRound that the host builds once per
//   request table (kernels._TierConsume: a round's launcher, or one call
//   of the public wrapper).
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry points at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "filter_common.cuh"
#include "vec4.cuh"

namespace {

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

// The estimate's inputs beside the capacity a call passes.
struct EstArgs {
  const int64_t* cap;              // [C,R]
  const uint8_t* has_summary;      // [C]
  const int64_t* req_unique;       // [U,R]
  const int32_t* req_idx;          // [B]
  const int32_t* replicas;         // [B]
  const uint8_t* unknown_request;  // [B]
  const int32_t* extra;            // [B,C] answers or null
  const int32_t* rows;             // [n]
  const int32_t* est_u;            // [U,C] (the table route) or null
  const int64_t* reclaim;          // [C,R] (window mode's paired speculative pass) or null
  int C, R, U, n;
};

// The estimate of column c for request row u (filter_common.cuh), 0
// without a summary.
__device__ __forceinline__ int32_t column_estimate(const EstArgs& a, int c, int u) {
  return a.has_summary[c] ? filter_common::factor_estimate(a.cap + (int64_t)c * a.R,
                                                           a.req_unique + (int64_t)u * a.R, a.R)
                          : 0;
}

// The table route's first launch: est_u[u, c], grid (column blocks,
// request rows; blockIdx.y strides over U).
__global__ void __launch_bounds__(kThreads) tier_table_kernel(EstArgs a, int32_t* est_u) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.C) return;
  for (int u = blockIdx.y; u < a.U; u += gridDim.y) {
    est_u[(int64_t)u * a.C + c] = column_estimate(a, c, u);
  }
}

// The estimate's routes: est_u's entry read (kTable, rows mode), or per
// element through the row's request reciprocals staged in shared memory
// (kRcp, up to kRcpMaxR resources) or through capped_div (kDirect, wider
// requests).
enum Route : int { kTable = 0, kRcp = 1, kDirect = 2 };
constexpr int kRcpMaxR = 16;
constexpr int kEstGroupRows = 16;  // rows a rows-mode block stages at a time

// Rows j0 .. j0 + m - 1's ids and row columns into shared memory (threads
// 0 .. m - 1), and with kRcp, after a barrier, their requests and the
// requests' reciprocals (a thread a resource). Ends with a barrier.
template <int kRoute>
__device__ __forceinline__ void stage_rows(const EstArgs& a, int j0, int m, int32_t* row_s,
                                           int32_t* req_s, int32_t* reps_s, bool* unknown_s,
                                           int64_t* q_s, uint64_t* rcp_s) {
  if ((int)threadIdx.x < m) {
    const int b = a.rows[j0 + threadIdx.x];
    row_s[threadIdx.x] = b;
    req_s[threadIdx.x] = a.req_idx[b];
    reps_s[threadIdx.x] = a.replicas[b];
    unknown_s[threadIdx.x] = a.unknown_request[b] != 0;
  }
  __syncthreads();
  if constexpr (kRoute == kRcp) {
    if ((int)threadIdx.x < m * a.R) {
      const int rs = threadIdx.x / a.R;
      const int i = threadIdx.x - rs * a.R;
      const int64_t q = a.req_unique[(int64_t)req_s[rs] * a.R + i];
      q_s[rs * kRcpMaxR + i] = q;
      rcp_s[rs * kRcpMaxR + i] = capped_div::reciprocal(q > 0 ? (uint64_t)q : 1);
    }
    __syncthreads();
  }
}

// A column's estimate for staged row rs (request u) on a per-element
// route, its capacities cap_at(i).
template <int kRoute, class CapAt>
__device__ __forceinline__ int32_t element_estimate_at(const EstArgs& a, CapAt cap_at, int u,
                                                       int rs, const int64_t* q_s,
                                                       const uint64_t* rcp_s) {
  if constexpr (kRoute == kRcp) {
    return filter_common::factor_estimate_rcp_at(cap_at, q_s + rs * kRcpMaxR,
                                                 rcp_s + rs * kRcpMaxR, a.R);
  } else {
    return filter_common::factor_estimate_at(cap_at, a.req_unique + (int64_t)u * a.R, a.R);
  }
}

// Rows mode's table route, grid (column tiles of 4 qt columns, groups of
// kEstGroupRows of the tier's rows; blockIdx.y strides over the groups).
// The block stages its group's row ids and row columns, then walks the
// rows kThreads / qt at a time, each thread writing 4 adjacent columns of
// one row from est_u's row.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) tier_rows_kernel(EstArgs a, int32_t* avail, int qt) {
  __shared__ int32_t row_s[kEstGroupRows], req_s[kEstGroupRows], reps_s[kEstGroupRows];
  __shared__ bool unknown_s[kEstGroupRows];
  const int par = kThreads / qt;
  const int sub = threadIdx.x / qt;
  const int c0 = blockIdx.x * 4 * qt;
  const int c = c0 + 4 * (threadIdx.x - sub * qt);
  const int nc = min(c0 + 4 * qt, a.C) - c;  // this thread's columns (4 or more when kVec)
  const int groups = (a.n + kEstGroupRows - 1) / kEstGroupRows;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const int j0 = g * kEstGroupRows;
    const int m = min(kEstGroupRows, a.n - j0);
    __syncthreads();  // the previous group's rows are read
    stage_rows<kTable>(a, j0, m, row_s, req_s, reps_s, unknown_s, nullptr, nullptr);
    if (nc <= 0) continue;
#pragma unroll 4
    for (int rs = sub; rs < m; rs += par) {
      const int64_t at = (int64_t)row_s[rs] * a.C + c;
      const int4 est = vec4::load4<kVec>(a.est_u + (int64_t)req_s[rs] * a.C + c, nc);
      int4 extra = make_int4(-1, -1, -1, -1);
      if (a.extra != nullptr) extra = vec4::load4<kVec>(a.extra + at, nc);
      int32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = filter_common::apply_row(vec4::lane4(est, j), reps_s[rs], unknown_s[rs],
                                        vec4::lane4(extra, j));
      }
      if (kVec) {  // streaming: written once, read by the tail after the whole tier
        __stcs(reinterpret_cast<int4*>(avail + at), make_int4(v[0], v[1], v[2], v[3]));
      } else {
        vec4::store4<kVec>(avail + at, v, nc);
      }
    }
  }
}

// Rows mode's per-element routes, grid (column blocks of kThreads, groups
// of kEstGroupRows of the tier's rows; blockIdx.y strides over the
// groups), a thread a column: its summary flag and, on the kRcp route,
// its capacities (kCapR >= R of them) read once into registers for every
// row; each row's estimate through the staged requests and reciprocals
// (kRcp) or through capped_div (kDirect); 4-byte stores, coalesced over
// the warp.
template <int kRoute, int kCapR>
__global__ void __launch_bounds__(kThreads) tier_element_kernel(EstArgs a, int32_t* avail) {
  __shared__ int32_t row_s[kEstGroupRows], req_s[kEstGroupRows], reps_s[kEstGroupRows];
  __shared__ bool unknown_s[kEstGroupRows];
  __shared__ int64_t q_s[kRoute == kRcp ? kEstGroupRows * kRcpMaxR : 1];
  __shared__ uint64_t rcp_s[kRoute == kRcp ? kEstGroupRows * kRcpMaxR : 1];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < a.C;
  const bool summ = live && a.has_summary[c] != 0;
  const int64_t* cap = a.cap + (int64_t)(summ ? c : 0) * a.R;
  int64_t capv[kCapR];
#pragma unroll
  for (int i = 0; i < kCapR; ++i) capv[i] = kRoute == kRcp && summ && i < a.R ? cap[i] : 0;
  const int groups = (a.n + kEstGroupRows - 1) / kEstGroupRows;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const int j0 = g * kEstGroupRows;
    const int m = min(kEstGroupRows, a.n - j0);
    __syncthreads();  // the previous group's rows are read
    stage_rows<kRoute>(a, j0, m, row_s, req_s, reps_s, unknown_s, q_s, rcp_s);
    if (!live) continue;
    for (int rs = 0; rs < m; ++rs) {
      int32_t e = 0;
      if (summ) {
        if constexpr (kRoute == kRcp) {
          e = filter_common::factor_estimate_rcp_at<kCapR>(
              [&capv](int i) { return capv[i]; }, q_s + rs * kRcpMaxR, rcp_s + rs * kRcpMaxR,
              a.R);
        } else {
          e = filter_common::factor_estimate(cap, a.req_unique + (int64_t)req_s[rs] * a.R, a.R);
        }
      }
      const int64_t at = (int64_t)row_s[rs] * a.C + c;
      __stcs(avail + at, filter_common::apply_row(e, reps_s[rs], unknown_s[rs],
                                                  a.extra == nullptr ? -1 : a.extra[at]));
    }
  }
}

// Window mode: tpr threads a row (the window's width rounded up to a
// warp, at most 128), kThreads / tpr rows a block, a thread a window slot
// (the candidate columns read and the answers written coalesced, 4 bytes
// a thread). kPair also writes the speculative pass into out2: the same
// slots at the capacity plus a.reclaim (the int64 sum, wrapping as
// torch's add does), without the answers.
constexpr int kWindowRowThreads = 128;

template <int kRoute, bool kPair>
__global__ void __launch_bounds__(kThreads)
tier_window_kernel(EstArgs a, const int32_t* cand_idx, int K, int32_t* out, int32_t* out2,
                   int tpr) {
  constexpr int kRows = kThreads / 32;  // rows a block holds at most
  __shared__ int32_t row_s[kRows], req_s[kRows], reps_s[kRows];
  __shared__ bool unknown_s[kRows];
  __shared__ int64_t q_s[kRoute == kRcp ? kRows * kRcpMaxR : 1];
  __shared__ uint64_t rcp_s[kRoute == kRcp ? kRows * kRcpMaxR : 1];
  const int per = kThreads / tpr;
  const int j0 = blockIdx.x * per;
  const int m = min(per, a.n - j0);
  stage_rows<kRoute>(a, j0, m, row_s, req_s, reps_s, unknown_s, q_s, rcp_s);
  const int rs = threadIdx.x / tpr;
  if (rs >= m) return;
  const int b = row_s[rs];
  const int u = req_s[rs];
  const int32_t reps = reps_s[rs];
  const bool unknown = unknown_s[rs];
  const int32_t* cand = cand_idx + (int64_t)b * K;
  const int32_t* extra = a.extra == nullptr ? nullptr : a.extra + (int64_t)b * a.C;
  const int64_t row = (int64_t)(j0 + rs) * K;
  for (int k = threadIdx.x - rs * tpr; k < K; k += tpr) {
    const int col = cand[k];
    const bool summ = a.has_summary[col] != 0;
    const int64_t* cap = a.cap + (int64_t)col * a.R;
    const int32_t e =
        summ ? element_estimate_at<kRoute>(a, [cap](int i) { return cap[i]; }, u, rs, q_s, rcp_s)
             : 0;
    out[row + k] = filter_common::apply_row(e, reps, unknown, extra == nullptr ? -1 : extra[col]);
    if constexpr (kPair) {
      const int64_t* rec = a.reclaim + (int64_t)col * a.R;
      const auto both = [cap, rec](int i) {
        return (int64_t)((uint64_t)cap[i] + (uint64_t)rec[i]);
      };
      const int32_t e2 = summ ? element_estimate_at<kRoute>(a, both, u, rs, q_s, rcp_s) : 0;
      out2[row + k] = filter_common::apply_row(e2, reps, unknown, -1);
    }
  }
}

template <int kRoute>
void launch_window(const EstArgs& a, const int32_t* cand_idx, int K, int32_t* out,
                   int32_t* out2, cudaStream_t s) {
  const int tpr = std::min(kWindowRowThreads, (K + 31) / 32 * 32);
  const int per = kThreads / tpr;
  const dim3 grid((a.n + per - 1) / per);
  if (a.reclaim != nullptr) {
    tier_window_kernel<kRoute, true><<<grid, kThreads, 0, s>>>(a, cand_idx, K, out, out2, tpr);
  } else {
    tier_window_kernel<kRoute, false><<<grid, kThreads, 0, s>>>(a, cand_idx, K, out, out2, tpr);
  }
}

// One estimate call: rows mode when cand_idx is null (out is the [B, C]
// avail buffer), window mode otherwise (out is c_avail [n, K]; with
// a.reclaim set, out2 the speculative pass's); the table route when
// a.est_u is set (rows mode only).
int launch_estimate(const EstArgs& a, const int32_t* cand_idx, int K, int32_t* out,
                    int32_t* out2, cudaStream_t s) {
  if (a.n <= 0 || a.C <= 0) return (int)cudaErrorInvalidValue;
  const bool rcp = a.R <= kRcpMaxR;
  if (cand_idx != nullptr) {
    if (K <= 0 || (a.reclaim != nullptr && out2 == nullptr)) return (int)cudaErrorInvalidValue;
    if (rcp) {
      launch_window<kRcp>(a, cand_idx, K, out, out2, s);
    } else {
      launch_window<kDirect>(a, cand_idx, K, out, out2, s);
    }
    return (int)cudaGetLastError();
  }
  if (a.reclaim != nullptr) return (int)cudaErrorInvalidValue;
  const int groups = (a.n + kEstGroupRows - 1) / kEstGroupRows;
  if (a.est_u == nullptr) {  // a per-element route
    const dim3 egrid((a.C + kThreads - 1) / kThreads, std::min(groups, 65535));
    if (a.R <= 4) {
      tier_element_kernel<kRcp, 4><<<egrid, kThreads, 0, s>>>(a, out);
    } else if (a.R <= 8) {
      tier_element_kernel<kRcp, 8><<<egrid, kThreads, 0, s>>>(a, out);
    } else if (rcp) {
      tier_element_kernel<kRcp, kRcpMaxR><<<egrid, kThreads, 0, s>>>(a, out);
    } else {
      tier_element_kernel<kDirect, 1><<<egrid, kThreads, 0, s>>>(a, out);
    }
    return (int)cudaGetLastError();
  }
  const dim3 tgrid((a.C + kThreads - 1) / kThreads, std::min(a.U, 65535));
  tier_table_kernel<<<tgrid, kThreads, 0, s>>>(a, const_cast<int32_t*>(a.est_u));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // threads a row: the fewest of 32-256 whose 4 columns each cover C, or
  // fewer where the tiles then pad C less (dense_filter.cu's rule)
  int qt = 32;
  while (qt < kThreads && 4 * qt < a.C) qt *= 2;
  const auto pad = [&](int q) { return (a.C + 4 * q - 1) / (4 * q) * (4 * q) - a.C; };
  for (int q = qt / 2; q >= 32; q /= 2) {
    if (pad(q) < pad(qt)) qt = q;
  }
  const dim3 grid((a.C + 4 * qt - 1) / (4 * qt), std::min(groups, 65535));
  const bool vec = a.C % 4 == 0 && vec4::aligned(out, 16) && vec4::aligned(a.extra, 16) &&
                   vec4::aligned(a.est_u, 16);
  if (vec) {
    tier_rows_kernel<true><<<grid, kThreads, 0, s>>>(a, out, qt);
  } else {
    tier_rows_kernel<false><<<grid, kThreads, 0, s>>>(a, out, qt);
  }
  return (int)cudaGetLastError();
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
  int n, C, R, K;
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

// Zero the scratch (the [C, R] sums, then the counters) on the stream and
// launch the consumption of its mode once.
int run_consume(ConsumeArgs a, void* scratch, long long scratch_bytes, cudaStream_t s) {
  if (a.C <= 0 || a.R <= 0 || a.R > kMaxR || a.n < 0 || a.K < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long sum_bytes = (long long)a.C * a.R * 8;
  const long long used = sum_bytes + 4LL * consume_strips(a.C);
  if (scratch_bytes < (long long)a.C * (a.R + 1) * 8) return (int)cudaErrorInvalidValue;
  const cudaError_t rc = cudaMemsetAsync(scratch, 0, (size_t)used, s);
  if (rc != cudaSuccess) return (int)rc;
  a.sums = static_cast<u64*>(scratch);
  a.done = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) + sum_bytes);
  return dispatch_consume(a.R, a, s);
}

}  // namespace

// One round's constant pointers and sizes, in host memory (built once a
// round by kernels.TierLauncher and kernels._TierConsume, a ctypes
// Structure of the same layout):
// the estimate's row columns and request table, the answers (or null),
// the window (cand_idx, or null in rows mode), the table route's est_u
// scratch (or null), and the consumption's request [B, R] (R of this
// resource block), its scratch and the stream.
struct TierRound {
  const uint8_t* has_summary;      // [C]
  const int64_t* req_unique;       // [U,R]
  const int32_t* req_idx;          // [B]
  const int32_t* replicas;         // [B]
  const uint8_t* unknown_request;  // [B]
  const int32_t* extra_avail;      // [B,C] or null
  const int32_t* cand_idx;         // [B,K] or null
  int32_t* est_u;                  // [U,C] or null
  const int64_t* request;          // [B,R] or null
  void* scratch;                   // C x (R + 1) int64 words
  long long scratch_bytes;
  void* stream;
  int B, C, R, U, K;
};

// The launcher's estimate: `capacity` [C, R] and the tier's `rows` [n];
// the answers min-merged when use_extra and the round has them, the table
// route when use_table (rows mode; the round's est_u is then set). With
// `reclaim` [C, R] (window mode) the same launch also writes the
// speculative pass at capacity + reclaim, without the answers, to out2.
extern "C" int tier_estimate_round(const TierRound* t, const void* capacity,
                                   const void* reclaim, const void* rows, int n, int use_extra,
                                   int use_table, void* out, void* out2) {
  if (use_table && t->est_u == nullptr) return (int)cudaErrorInvalidValue;
  const EstArgs a{static_cast<const int64_t*>(capacity), t->has_summary, t->req_unique,
                  t->req_idx, t->replicas, t->unknown_request,
                  use_extra ? t->extra_avail : nullptr, static_cast<const int32_t*>(rows),
                  use_table && t->cand_idx == nullptr ? t->est_u : nullptr,
                  static_cast<const int64_t*>(reclaim), t->C, t->R, t->U, n};
  return launch_estimate(a, t->cand_idx, t->K, static_cast<int32_t*>(out),
                         static_cast<int32_t*>(out2), static_cast<cudaStream_t>(t->stream));
}

// The consumption: the tier's capacity `cap` [C, R], its placements
// (dense [n, C], or [n, K] in window mode: the round's cand_idx set) and
// unschedulable flags, its rows; writes `out` [C, R]. The round's scratch,
// of scratch_bytes, holds at least C x (R + 1) int64 words: the [C, R]
// sums (uint64), then the counters (uint32: one per 256-column strip in
// dense mode, the grid barrier's first in window mode). The entry zeroes
// the sums and counters on the stream, then launches the one kernel, which
// writes every element of out.
extern "C" int tier_consume_round(const TierRound* t, const void* cap, const void* placed,
                                  const void* unsched, const void* rows, int n, void* out) {
  ConsumeArgs a = {};
  a.cap = static_cast<const int64_t*>(cap);
  a.placed = static_cast<const int32_t*>(placed);
  a.unsched = static_cast<const uint8_t*>(unsched);
  a.request = t->request;
  a.rows = static_cast<const int32_t*>(rows);
  a.cand_idx = t->cand_idx;
  a.n = n;
  a.C = t->C;
  a.R = t->R;
  a.K = t->K;
  a.window = t->cand_idx != nullptr;
  a.out = static_cast<int64_t*>(out);
  return run_consume(a, t->scratch, t->scratch_bytes, static_cast<cudaStream_t>(t->stream));
}
