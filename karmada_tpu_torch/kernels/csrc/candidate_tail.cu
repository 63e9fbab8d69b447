// candidate_tail: the replica-division tail over compact candidate windows.
//
// Replaces karmada_tpu/sched/candidates.py:280 `_candidate_tail_kernel`
// (with core.py:230 `assignment_tail`, ops/assign.py:279 `combined_assign`,
// `take_by_weight`, `_aggregated_keep` and core.py:254 `compact_outputs`
// fused in). One block of 128 threads per row; thread j holds window
// column j (j < K, the window of at most 128 candidate clusters). In int64,
// as the reference with x64 on:
//   - static weights (feasible-masked, all-zero -> 1 over the feasible set)
//     and dynamic weights with the Steady up/down/eq and Fresh modes;
//   - the Aggregated truncation: a bitonic sort of (prior desc, weight
//     desc, column asc), an inclusive scan of the sorted weights, and the
//     prefix that covers the target;
//   - TakeByWeight: quota = floor(w * t / sum w), then +1 to the first
//     `rem` columns in (weight desc, (last desc, tie asc), column asc)
//     order (a second bitonic sort gives every column its rank);
//   - the output window: the top min(K, topk) of the result by (value desc,
//     column asc), mapped to global cluster ids through cand_idx, and nnz.
// The full [rows, K] result is written too (rows whose nnz outruns the
// window decode from it).
//
// What bounds it on an H100: a row reads and writes O(K) values (about
// 2.5 KB), so at ~7.5k rows the bytes are ~20 MB, a few microseconds of
// memory time; the work is three 128-wide sorts (28 barrier stages each)
// and a handful of block reductions per row. It is latency bound: the
// design keeps everything in registers and shared memory, runs one row
// per block so 16 blocks share an SM, and never touches a [rows, C]
// tensor.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDuplicated = 1;
constexpr int kStaticWeight = 2;
constexpr int kDynamicWeight = 3;
constexpr int kAggregated = 4;
constexpr int64_t kI32Max = 2147483647;

struct TailParams {
  const uint8_t* feas;           // [rows,K]
  const int32_t* avail;          // [rows,K]
  const int32_t* prev;           // [rows,K]
  const int32_t* tie;            // [rows,K]
  const int32_t* cand;           // [rows,K] global cluster ids
  const int64_t* weight_tables;  // [W,Cw]
  int Cw;
  const int32_t* weight_idx;  // [rows]
  const int32_t* strategy;    // [rows]
  const int32_t* replicas;    // [rows]
  const uint8_t* fresh;       // [rows]
  int rows, K, topk, has_agg;
  int32_t* result;     // [rows,K]
  uint8_t* unsched;    // [rows]
  int32_t* avail_sum;  // [rows]
  int32_t* nnz;        // [rows]
  int32_t* top_idx;    // [rows,topk]
  int32_t* top_val;    // [rows,topk]
};

struct Shared {
  int64_t k1[kThreads];
  int64_t k2[kThreads];
  int32_t col[kThreads];
  int32_t rank[kThreads];
  int64_t scan[2][kThreads];
  int64_t red[kWarps];
  int32_t res[kThreads];
};

__device__ __forceinline__ int64_t wrap_mul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}

__device__ __forceinline__ int32_t wrap_i32(int64_t v) {
  return (int32_t)(uint32_t)(uint64_t)v;
}

// floor division for b >= 1 (jnp's // on int64)
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && (a < 0)) q -= 1;
  return q;
}

// Sum over the block; every thread gets the total.
__device__ int64_t block_sum(Shared& s, int64_t v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) s.red[warp] = v;
  __syncthreads();
  int64_t total = 0;
  for (int w = 0; w < kWarps; ++w) total += s.red[w];
  __syncthreads();
  return total;
}

__device__ __forceinline__ bool triple_less(int64_t a1, int64_t a2, int32_t ac,
                                            int64_t b1, int64_t b2, int32_t bc) {
  if (a1 != b1) return a1 < b1;
  if (a2 != b2) return a2 < b2;
  return ac < bc;
}

// Sort the block's 128 (k1, k2, column) triples ascending (a total order:
// columns are distinct) and write each thread's rank to s.rank. Padding
// lanes carry INT64_MAX keys and sort last.
__device__ void sort_triples(Shared& s, int64_t k1, int64_t k2) {
  const int j0 = threadIdx.x;
  s.k1[j0] = k1;
  s.k2[j0] = k2;
  s.col[j0] = j0;
  __syncthreads();
  for (int k = 2; k <= kThreads; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int q = threadIdx.x;
      if (q < kThreads / 2) {
        const int i = 2 * q - (q & (j - 1));
        const int ixj = i + j;
        const bool up = (i & k) == 0;
        const bool gt = triple_less(s.k1[ixj], s.k2[ixj], s.col[ixj], s.k1[i], s.k2[i], s.col[i]);
        if (up == gt) {
          const int64_t t1 = s.k1[i], t2 = s.k2[i];
          const int32_t tc = s.col[i];
          s.k1[i] = s.k1[ixj];
          s.k2[i] = s.k2[ixj];
          s.col[i] = s.col[ixj];
          s.k1[ixj] = t1;
          s.k2[ixj] = t2;
          s.col[ixj] = tc;
        }
      }
      __syncthreads();
    }
  }
  s.rank[s.col[j0]] = j0;
  __syncthreads();
}

// The reference's _cutoff_le after a sort: the first k positions of the
// order, k clipped to the window.
__device__ __forceinline__ bool first_k(int rank, int64_t k, int K) {
  if (k <= 0) return false;
  int64_t last = k - 1;
  if (last > K - 1) last = K - 1;
  return rank <= last;
}

__global__ void __launch_bounds__(kThreads)
candidate_tail_kernel(TailParams p) {
  __shared__ Shared s;
  const int row = blockIdx.x;
  const int j = threadIdx.x;
  const int K = p.K;
  const bool active = j < K;
  const int64_t o = (int64_t)row * K + j;

  const int strat = p.strategy[row];
  const bool is_static = strat == kStaticWeight;
  const bool is_dyn = strat == kDynamicWeight || strat == kAggregated;
  const bool aggregated = strat == kAggregated;
  const bool fresh = p.fresh[row] != 0;
  const int32_t reps = p.replicas[row];

  const bool f = active && p.feas[o] != 0;
  const int32_t pv = active ? p.prev[o] : 0;
  const int32_t av = active ? p.avail[o] : 0;
  const int32_t tv = active ? p.tie[o] : 0;
  const int64_t raw_w =
      active ? p.weight_tables[(int64_t)p.weight_idx[row] * p.Cw + p.cand[o]] : 0;

  // --- static inputs (assignment.go:194-206) ---
  int64_t w_static = f ? raw_w : 0;
  if (block_sum(s, w_static) == 0 && f) w_static = 1;
  const int32_t last_static = f ? pv : 0;

  // --- dynamic inputs (assignment.go:208-239) ---
  const int64_t avail_m = f ? (int64_t)av : 0;
  const int64_t prev_m = f ? (int64_t)pv : 0;
  const int64_t assigned = block_sum(s, prev_m);
  const int64_t target = reps;
  const bool down = !fresh && assigned > target;
  const bool up = !fresh && assigned < target;
  const bool eq = !fresh && assigned == target;
  int64_t w_dyn = fresh ? avail_m + prev_m : (down ? prev_m : avail_m);
  const int32_t init_dyn = up ? wrap_i32(prev_m) : 0;
  const int64_t tgt_dyn = up ? target - assigned : target;
  const int64_t asum = block_sum(s, w_dyn);
  const bool unsched = is_dyn && !eq && asum < tgt_dyn;

  if (p.has_agg) {
    // Aggregated truncation: keep the shortest (prior desc, weight desc,
    // column asc) prefix whose cumulative weight covers the target
    const bool prior = up && prev_m > 0;
    sort_triples(s, active ? -(int64_t)prior : INT64_MAX, active ? -w_dyn : INT64_MAX);
    // inclusive scan of the sorted weights (Hillis-Steele, double buffered)
    const int src_lane = s.col[j];
    const int64_t ws = src_lane < K ? s.k2[j] * -1 : 0;  // sorted weight at position j
    s.scan[0][j] = ws;
    __syncthreads();
    int cur = 0;
    for (int off = 1; off < kThreads; off <<= 1) {
      const int64_t v = s.scan[cur][j] + (j >= off ? s.scan[cur][j - off] : 0);
      s.scan[cur ^ 1][j] = v;
      cur ^= 1;
      __syncthreads();
    }
    const int64_t cum = s.scan[cur][j];
    const bool keep_sorted = j < K && (cum - ws) < tgt_dyn;
    const int64_t kcount = block_sum(s, keep_sorted ? 1 : 0);
    const bool keep = first_k(s.rank[j], kcount, K);
    if (aggregated && !eq && !keep) w_dyn = 0;
  }
  const int32_t last_dyn = up ? wrap_i32(prev_m) : 0;

  // --- row-select into ONE dispense (take_by_weight) ---
  const int64_t weight = is_static ? w_static : w_dyn;
  const int32_t last = is_static ? last_static : last_dyn;
  const int32_t init = is_static ? 0 : init_dyn;
  const int32_t tgt = wrap_i32(is_static ? target : tgt_dyn);
  const int64_t t64 = tgt;
  const int64_t sum_w = block_sum(s, weight);
  const int64_t safe = sum_w > 1 ? sum_w : 1;
  const int64_t quota = floordiv(wrap_mul(weight, t64), safe);
  const int64_t rem = t64 - block_sum(s, quota);
  const int64_t last_tie = (int64_t)((uint64_t)(kI32Max - (int64_t)last) << 32) | (int64_t)tv;
  sort_triples(s, active ? -weight : INT64_MAX, active ? last_tie : INT64_MAX);
  const bool bonus = first_k(s.rank[j], rem, K) && weight > 0;
  int32_t res = wrap_i32(quota + (bonus ? 1 : 0));
  if (!(sum_w > 0)) res = 0;
  const int32_t dispensed = (int32_t)((uint32_t)init + (uint32_t)res);

  int32_t sd = (is_dyn && eq) ? wrap_i32(prev_m) : dispensed;
  if (unsched) sd = 0;
  int32_t result = 0;
  if (strat == kDuplicated) {
    result = f ? reps : 0;
  } else if (is_static || is_dyn) {
    result = sd;
  }
  if (!active) result = 0;

  // --- outputs: full window row, then the compact window ---
  if (active) p.result[o] = result;
  s.res[j] = result;
  const int64_t n = block_sum(s, (active && result > 0) ? 1 : 0);
  sort_triples(s, active ? -(int64_t)result : INT64_MAX, 0);
  if (j < p.topk) {
    const int lane = s.col[j];
    p.top_idx[(int64_t)row * p.topk + j] = p.cand[(int64_t)row * K + lane];
    p.top_val[(int64_t)row * p.topk + j] = s.res[lane];
  }
  if (j == 0) {
    p.unsched[row] = unsched ? 1 : 0;
    p.avail_sum[row] = wrap_i32(asum);
    p.nnz[row] = (int32_t)n;
  }
}

}  // namespace

extern "C" int candidate_tail_launch(
    const void* feas, const void* avail, const void* prev, const void* tie,
    const void* cand, const void* weight_tables, int Cw, const void* weight_idx,
    const void* strategy, const void* replicas, const void* fresh, int rows, int K,
    int topk, int has_agg, void* result, void* unsched, void* avail_sum, void* nnz,
    void* top_idx, void* top_val, void* stream) {
  if (rows <= 0 || K <= 0 || K > kThreads || topk <= 0 || topk > K) {
    return (int)cudaErrorInvalidValue;
  }
  TailParams p;
  p.feas = static_cast<const uint8_t*>(feas);
  p.avail = static_cast<const int32_t*>(avail);
  p.prev = static_cast<const int32_t*>(prev);
  p.tie = static_cast<const int32_t*>(tie);
  p.cand = static_cast<const int32_t*>(cand);
  p.weight_tables = static_cast<const int64_t*>(weight_tables);
  p.Cw = Cw;
  p.weight_idx = static_cast<const int32_t*>(weight_idx);
  p.strategy = static_cast<const int32_t*>(strategy);
  p.replicas = static_cast<const int32_t*>(replicas);
  p.fresh = static_cast<const uint8_t*>(fresh);
  p.rows = rows;
  p.K = K;
  p.topk = topk;
  p.has_agg = has_agg;
  p.result = static_cast<int32_t*>(result);
  p.unsched = static_cast<uint8_t*>(unsched);
  p.avail_sum = static_cast<int32_t*>(avail_sum);
  p.nnz = static_cast<int32_t*>(nnz);
  p.top_idx = static_cast<int32_t*>(top_idx);
  p.top_val = static_cast<int32_t*>(top_val);
  candidate_tail_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
