// candidate_merge: the cross-shard window merge of the partitioned mesh's
// compact round.
//
// Under the partitioned mesh (parallel/mesh.py `partitioned_select`) each
// (row group, column shard) tile runs candidate_select over its own columns
// (col0 mode) and keeps its top K_s = min(K, C_l) columns. This kernel is
// the merge the reference leaves to GSPMD when it partitions
// karmada_tpu/sched/candidates.py:210 `_candidate_select_kernel` over a
// column-sharded fleet: for each row of a row group, the top K of the c
// shards' windows by (feasible desc, score desc, global column asc), in
// global column order, with the five gathered fields carried along, and
// the row's feasible count summed over the shards.
//
// The merge is exact. The order is total and every shard's window is that
// shard's top K_s under it, so the union of the windows holds the global
// top K (a column outside its shard's window has K_s >= K columns of its
// shard above it, or none at all when K_s = C_l). The shards come in
// column order and each window is in column order, so the concatenation
// of the windows, (shard, slot), is in global column order: a threshold
// select followed by a stable compaction gives the output in column order
// with no sort.
//
// The design: one block a row (256 threads). The row's W = sum K_s keys,
// ~((feasible << 32) | (score ^ 2^31)) so that the best comes first, are
// staged in dynamic shared memory (8 bytes an entry); the K-th smallest key
// v* is found by radix_select.cuh's smem_select (MSB-first, 8 bits a pass,
// rebased to the row's key range: in-tree scores end in one pass); then,
// as in candidate_select.cu's top_k_window, each warp takes a contiguous
// slice of the W entries, counts the entries below v* and equal to it by
// ballot, the warps' counts are scanned, and a second ballot walk gives
// every winner (the entries below v*, then the first K - n_below entries
// equal to it) its output slot, where its six fields are copied.
//
// What bounds it on an H100: the merge must read each window entry's key
// (c_feas and c_score, 5 bytes), the other four fields of the row's K
// winners (16 bytes each) and a 4-byte feasible count a shard a row, and
// write 21 bytes an output entry: at the flagship's row group (5 120 rows,
// two 128-wide windows, K 128) about 6 030 bytes a row, 31 MB, some 9
// microseconds at 3.35 TB/s. This kernel reads a winner's key again with
// its other fields (5 bytes more a winner); the rest is the block's
// barriers.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

constexpr int kMaxShards = 16;  // kernels.MAX_MERGE_SHARDS
constexpr int kThreads = 256;
constexpr uint32_t kFlip = 0x80000000u;  // int32 order as uint32 order

// One shard's window over a row group ([B, K] each, row-major) and its
// feasible counts ([B]).
struct MergeShard {
  const int32_t* cand_idx;
  const uint8_t* c_feas;
  const int32_t* c_score;
  const int32_t* c_avail;
  const int32_t* c_prev;
  const int32_t* c_tie;
  const int32_t* feas_count;
  int K;
};

struct MergeArgs {
  MergeShard shard[kMaxShards];
  int c;  // shards
  int B;  // rows
  int K;  // output window
  int W;  // sum of the shards' K
  // outputs, [B, K] and [B]
  int32_t* cand_idx;
  uint8_t* c_feas;
  int32_t* c_score;
  int32_t* c_avail;
  int32_t* c_prev;
  int32_t* c_tie;
  int32_t* feas_count;
};

struct MergeShared {
  SmemSelect sel;
  MergeShard shard[kMaxShards];  // the parameters' table, indexed at run time
  int base[kMaxShards + 1];  // each shard's first entry in the row's W
  int below[kMaxWarps];
  int equal[kMaxWarps];
};

__global__ void __launch_bounds__(kThreads) candidate_merge_kernel(MergeArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ MergeShared s;
  uint64_t* key = reinterpret_cast<uint64_t*>(dyn);  // [W]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int warp = warp_id();
  const int nw = n_warps();

  if (tid == 0) {
    int o = 0;
    int fc = 0;
    for (int j = 0; j < a.c; ++j) {
      s.shard[j] = a.shard[j];
      s.base[j] = o;
      o += a.shard[j].K;
      fc += a.shard[j].feas_count[b];
    }
    s.base[a.c] = o;
    a.feas_count[b] = fc;
  }
  for (int d = tid; d < 256; d += blockDim.x) s.sel.hist[d] = 0;  // smem_select's bins
  __syncthreads();

  // ---- the row's keys, ascending = (feasible desc, score desc) ----
  for (int j = 0; j < a.c; ++j) {
    const MergeShard& m = s.shard[j];
    const int64_t row = (int64_t)b * m.K;
    const int o = s.base[j];
    for (int i = tid; i < m.K; i += blockDim.x) {
      const uint64_t f = m.c_feas[row + i] != 0 ? 1ull : 0ull;
      const uint64_t sc = (uint32_t)m.c_score[row + i] ^ kFlip;
      key[o + i] = ~((f << 32) | sc);
    }
  }
  __syncthreads();

  const int W = a.W;
  const int K = a.K;
  const Sel v = smem_select(
      s.sel, W, (uint64_t)K, [&](int p) { return key[p]; }, [](int) { return true; });
  const uint64_t vstar = v.key;
  const int n_below = (int)v.less;
  const int need_eq = K - n_below;  // >= 1: fewer than K entries lie below v*

  // ---- the winners in (shard, slot) order: a contiguous slice a warp ----
  const int chunk = ((W + nw - 1) / nw + 31) & ~31;
  const int p_lo = warp * chunk;
  const int p_hi = min(W, p_lo + chunk);
  int nb = 0, ne = 0;
  for (int p0 = p_lo; p0 < p_hi; p0 += 32) {
    const int p = p0 + lane;
    const bool in = p < p_hi;
    nb += __popc(__ballot_sync(kFull, in && key[p] < vstar));
    ne += __popc(__ballot_sync(kFull, in && key[p] == vstar));
  }
  if (lane == 0) {
    s.below[warp] = nb;
    s.equal[warp] = ne;
  }
  __syncthreads();
  int bb = 0, eb = 0;  // below / equal entries before the warp's slice
  for (int w = 0; w < warp; ++w) {
    bb += s.below[w];
    eb += s.equal[w];
  }
  const unsigned lower = (1u << lane) - 1u;
  const int64_t out_row = (int64_t)b * K;
  for (int p0 = p_lo; p0 < p_hi && bb + min(eb, need_eq) < K; p0 += 32) {
    const int p = p0 + lane;
    const bool in = p < p_hi;
    const bool lo = in && key[p] < vstar;
    const bool eq = in && key[p] == vstar;
    const unsigned bl = __ballot_sync(kFull, lo);
    const unsigned be = __ballot_sync(kFull, eq);
    const int e_before = eb + __popc(be & lower);
    if (lo || (eq && e_before < need_eq)) {
      const int t = bb + __popc(bl & lower) + min(e_before, need_eq);
      int j = 0;
      while (p >= s.base[j + 1]) ++j;
      const MergeShard& m = s.shard[j];
      const int64_t at = (int64_t)b * m.K + (p - s.base[j]);
      const int64_t o = out_row + t;
      a.cand_idx[o] = m.cand_idx[at];
      a.c_feas[o] = m.c_feas[at];
      a.c_score[o] = m.c_score[at];
      a.c_avail[o] = m.c_avail[at];
      a.c_prev[o] = m.c_prev[at];
      a.c_tie[o] = m.c_tie[at];
    }
    bb += __popc(bl);
    eb += __popc(be);
  }
}

}  // namespace

// `shards` points at c MergeShard records in host memory (kernels.
// _MergeShard: seven device pointers and the window's width K_s, in column
// order of the shards); the outputs are [B, K] (and [B] for the feasible
// count) on the same device. K must not exceed the windows' total width.
extern "C" int candidate_merge_launch(const void* shards, int c, int B, int K, void* cand_idx,
                                      void* c_feas, void* c_score, void* c_avail, void* c_prev,
                                      void* c_tie, void* feas_count, void* stream) {
  if (c <= 0 || c > kMaxShards || B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  MergeArgs a;
  const MergeShard* in = static_cast<const MergeShard*>(shards);
  int W = 0;
  for (int j = 0; j < c; ++j) {
    if (in[j].K < 0) return (int)cudaErrorInvalidValue;
    a.shard[j] = in[j];
    W += in[j].K;
  }
  for (int j = c; j < kMaxShards; ++j) a.shard[j] = MergeShard{};
  if (K > W) return (int)cudaErrorInvalidValue;
  a.c = c;
  a.B = B;
  a.K = K;
  a.W = W;
  a.cand_idx = static_cast<int32_t*>(cand_idx);
  a.c_feas = static_cast<uint8_t*>(c_feas);
  a.c_score = static_cast<int32_t*>(c_score);
  a.c_avail = static_cast<int32_t*>(c_avail);
  a.c_prev = static_cast<int32_t*>(c_prev);
  a.c_tie = static_cast<int32_t*>(c_tie);
  a.feas_count = static_cast<int32_t*>(feas_count);
  const size_t smem = 8 * (size_t)W;
  cudaError_t err = cudaFuncSetAttribute(candidate_merge_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  candidate_merge_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
