// candidate_tail: the replica-division tail over compact candidate windows.
//
// Replaces karmada_tpu/sched/candidates.py:280 `_candidate_tail_kernel`
// (with core.py:230 `assignment_tail`, ops/assign.py:279 `combined_assign`,
// `take_by_weight`, `_aggregated_keep` and core.py:254 `compact_outputs`
// fused in). One warp per row, several rows a block; lane l holds window
// columns 4l .. 4l + 3 (the window of at most 128 candidate clusters). In
// int64, as the reference with x64 on:
//   - static weights (feasible-masked, all-zero -> 1 over the feasible set)
//     and dynamic weights with the Steady up/down/eq and Fresh modes;
//   - the Aggregated truncation (only on an Aggregated row that is not
//     Steady eq, a choice uniform over the warp): a sort of (prior desc,
//     weight desc, column asc), a warp scan of the sorted weights, and the
//     prefix that covers the target;
//   - TakeByWeight: quota = floor(w * t / sum w), then +1 to the first
//     `rem` columns in (weight desc, (last desc, tie asc), column asc)
//     order (sorted only when some remainder is left to give); where every
//     weight is in [0, 2^31) the quota is a float64 product with the row's
//     1 / sum w and one exact correction, with no int64 division;
//   - the output window: the top min(K, topk) of the result by (value desc,
//     column asc), mapped to global cluster ids through cand_idx, and nnz.
// The full [rows, K] result is written too (rows whose nnz outruns the
// window decode from it).
//
// Each order is a bitonic sort of the warp's 128 keys held in registers,
// 4 a lane (position 4 lane + j): the 28 compare-exchange stages with a
// partner distance of 4 or more exchange through __shfl_xor_sync, those of
// distance 1 and 2 run inside a lane; padding positions (j >= K) carry the
// largest key and sort last. The truncation's and the window's keys pack
// into one 64-bit word with the column in the low 7 bits (the weights there
// are sums of two int32 values, the results int32); so does the bonus
// order's where every last and tie of the row is >= 0 and the spans of its
// weights and lasts fit 25 bits together, else it is (-weight, last_tie)
// in full int64 and the column. Where only the first k positions of an
// order are used (the truncation, the bonus), the key at position k - 1
// is broadcast and each column compares its own key with it, as the
// reference's _cutoff_le does. Sums and counts are shuffle reductions;
// nothing goes through shared memory and there is no barrier.
//
// What bounds it on an H100: a row reads and writes O(K) values (about
// 2.5 KB), so at ~7.5k rows the bytes are ~20 MB, a few microseconds of
// memory time; the work is the sorts' shuffles and compares, two or three
// 128-wide sorts a row, so it is bound by issued instructions.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 rows a block
constexpr int kCols = 4;  // window columns a lane
constexpr int kWindow = 32 * kCols;
constexpr unsigned kFull = 0xffffffffu;
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

// The warp's sum of each lane's 4 values; every lane gets it.
__device__ __forceinline__ int64_t warp_sum(const int64_t (&v)[kCols]) {
  int64_t s = v[0] + v[1] + v[2] + v[3];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(kFull, s, m);
  return s;
}

// The warp's maximum and minimum of one value a lane; every lane gets them.
template <class T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const T o = __shfl_xor_sync(kFull, v, m);
    v = o > v ? o : v;
  }
  return v;
}

template <class T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const T o = __shfl_xor_sync(kFull, v, m);
    v = o < v ? o : v;
  }
  return v;
}

// How many of the warp's 128 flags are set.
__device__ __forceinline__ int warp_count(const bool (&v)[kCols]) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) n += __popc(__ballot_sync(kFull, v[j]));
  return n;
}

// A one-word key (unsigned order; the padding's is ~0).
struct Key64 {
  uint64_t k;
  __device__ __forceinline__ bool operator<(const Key64& o) const { return k < o.k; }
  __device__ __forceinline__ Key64 from_lane(int src) const {
    return {__shfl_sync(kFull, k, src)};
  }
  __device__ __forceinline__ Key64 xor_lane(int m) const {
    return {__shfl_xor_sync(kFull, k, m)};
  }
};

// The bonus order's key: (a, b) in signed int64 order, then the column.
struct KeyWide {
  int64_t a, b;
  int32_t c;
  __device__ __forceinline__ bool operator<(const KeyWide& o) const {
    if (a != o.a) return a < o.a;
    if (b != o.b) return b < o.b;
    return c < o.c;
  }
  __device__ __forceinline__ KeyWide from_lane(int src) const {
    return {__shfl_sync(kFull, a, src), __shfl_sync(kFull, b, src), __shfl_sync(kFull, c, src)};
  }
  __device__ __forceinline__ KeyWide xor_lane(int m) const {
    return {__shfl_xor_sync(kFull, a, m), __shfl_xor_sync(kFull, b, m),
            __shfl_xor_sync(kFull, c, m)};
  }
};

// Bitonic sort of the warp's 128 keys ascending, position 4 lane + j in
// v[j]. Equal keys must be interchangeable (every key of a real column is
// unique: it holds the column).
template <class Key>
__device__ __forceinline__ void warp_sort(Key (&v)[kCols], int lane) {
#pragma unroll
  for (int k = 2; k <= kWindow; k <<= 1) {
#pragma unroll
    for (int d = k >> 1; d > 0; d >>= 1) {
      if (d >= kCols) {  // the partner is lane ^ (d / 4), same register
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int i = kCols * lane + j;
          const Key o = v[j].xor_lane(d / kCols);
          // the lower position of an ascending pair keeps the smaller key
          const bool take_min = ((i & d) == 0) == ((i & k) == 0);
          if (take_min == (o < v[j])) v[j] = o;
        }
      } else {  // the partner is register j ^ d of this lane
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (j & d) continue;
          const bool up = ((kCols * lane + j) & k) == 0;
          if (up ? (v[j + d] < v[j]) : (v[j] < v[j + d])) {
            const Key t = v[j];
            v[j] = v[j + d];
            v[j + d] = t;
          }
        }
      }
    }
  }
}

// The sorted key at position q (uniform over the warp).
template <class Key>
__device__ __forceinline__ Key key_at(const Key (&v)[kCols], int q) {
  const int j = q & (kCols - 1);
  const Key mine = j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
  return mine.from_lane(q / kCols);
}

// Whether a key lies in the first k positions of its sorted order (the
// reference's _cutoff_le): k clipped to the window, none for k <= 0.
template <class Key>
__device__ __forceinline__ void first_k(const Key (&sorted)[kCols], const Key (&own)[kCols],
                                        const bool (&active)[kCols], int64_t k, int K,
                                        bool (&out)[kCols]) {
  if (k <= 0) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[j] = false;
    return;
  }
  const Key cut = key_at(sorted, (int)(k - 1 < K - 1 ? k - 1 : K - 1));
#pragma unroll
  for (int j = 0; j < kCols; ++j) out[j] = active[j] && !(cut < own[j]);
}

// floor(p / s) for 0 <= p < 2^62 and a quotient below 2^31, with r the
// float64 1 / s of the row: p * r is within 2^-20 of the quotient, so one
// exact correction step (the 128-bit product's high word checked) gives
// the floor, as capped_div.cuh does; no int64 division.
__device__ __forceinline__ int64_t quota_div(int64_t p, int64_t s, double r) {
  const uint64_t up = (uint64_t)p, us = (uint64_t)s;
  uint64_t q = (uint64_t)((double)p * r);
  if (__umul64hi(q, us) != 0 || q * us > up) {
    q -= 1;
  } else if (up - q * us >= us) {
    q += 1;
  }
  return (int64_t)q;
}

// The truncation's key: prior desc, weight desc, column asc. The weight is
// a sum of two int32 values, so 2^32 - w is in [2, 2^33].
__device__ __forceinline__ uint64_t agg_key(bool prior, int64_t w, int col) {
  return ((uint64_t)(prior ? 0 : 1) << 41) | ((uint64_t)((int64_t(1) << 32) - w) << 7) |
         (uint64_t)col;
}

__device__ __forceinline__ int64_t agg_key_weight(uint64_t key) {
  return (int64_t(1) << 32) - (int64_t)((key >> 7) & ((uint64_t(1) << 34) - 1));
}

__global__ void __launch_bounds__(kThreads)
candidate_tail_kernel(TailParams p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // the whole warp
  const int K = p.K;
  const int64_t base = (int64_t)row * K;

  const int strat = p.strategy[row];
  const bool is_static = strat == kStaticWeight;
  const bool is_dyn = strat == kDynamicWeight || strat == kAggregated;
  const bool aggregated = strat == kAggregated;
  const bool fresh = p.fresh[row] != 0;
  const int32_t reps = p.replicas[row];
  const int64_t* wrow = p.weight_tables + (int64_t)p.weight_idx[row] * p.Cw;

  bool active[kCols], f[kCols];
  int32_t pv[kCols], tv[kCols];
  int64_t w_static[kCols], avail_m[kCols], prev_m[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = kCols * lane + j;
    active[j] = col < K;
    f[j] = active[j] && p.feas[base + col] != 0;
    pv[j] = active[j] ? p.prev[base + col] : 0;
    tv[j] = active[j] ? p.tie[base + col] : 0;
    w_static[j] = f[j] ? wrow[p.cand[base + col]] : 0;
    avail_m[j] = f[j] ? (int64_t)p.avail[base + col] : 0;
    prev_m[j] = f[j] ? (int64_t)pv[j] : 0;
  }

  // --- static inputs (assignment.go:194-206) ---
  if (warp_sum(w_static) == 0) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) w_static[j] = f[j] ? 1 : 0;
  }

  // --- dynamic inputs (assignment.go:208-239) ---
  const int64_t assigned = warp_sum(prev_m);
  const int64_t target = reps;
  const bool down = !fresh && assigned > target;
  const bool up = !fresh && assigned < target;
  const bool eq = !fresh && assigned == target;
  int64_t w_dyn[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    w_dyn[j] = fresh ? avail_m[j] + prev_m[j] : (down ? prev_m[j] : avail_m[j]);
  }
  const int64_t tgt_dyn = up ? target - assigned : target;
  const int64_t asum = warp_sum(w_dyn);
  const bool unsched = is_dyn && !eq && asum < tgt_dyn;

  if (p.has_agg && aggregated && !eq) {
    // Aggregated truncation: keep the shortest (prior desc, weight desc,
    // column asc) prefix whose cumulative weight covers the target
    Key64 own[kCols], s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      own[j].k = active[j] ? agg_key(up && prev_m[j] > 0, w_dyn[j], kCols * lane + j) : ~0ull;
      s[j] = own[j];
    }
    warp_sort(s, lane);
    // inclusive scan of the sorted weights: within the lane, then over lanes
    int64_t ws[kCols], cum[kCols];
    int64_t run = 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      ws[j] = s[j].k == ~0ull ? 0 : agg_key_weight(s[j].k);
      run += ws[j];
      cum[j] = run;
    }
    int64_t scan = run;
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      const int64_t v = __shfl_up_sync(kFull, scan, m);
      if (lane >= m) scan += v;
    }
    bool keep_sorted[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      keep_sorted[j] = kCols * lane + j < K && (scan - run + cum[j] - ws[j]) < tgt_dyn;
    }
    bool keep[kCols];
    first_k(s, own, active, warp_count(keep_sorted), K, keep);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (!keep[j]) w_dyn[j] = 0;
    }
  }

  // --- row-select into ONE dispense (take_by_weight) ---
  int64_t weight[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) weight[j] = is_static ? w_static[j] : w_dyn[j];
  const int64_t t64 = wrap_i32(is_static ? target : tgt_dyn);
  const int64_t sum_w = warp_sum(weight);
  const int64_t safe = sum_w > 1 ? sum_w : 1;
  // every weight in [0, 2^31) and t64 >= 0: w * t64 is exact and each
  // quota is at most t64 < 2^31 (w <= sum_w), so quota_div applies
  bool small = t64 >= 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) small = small && weight[j] >= 0 && weight[j] <= kI32Max;
  int64_t quota[kCols];
  if (__all_sync(kFull, small)) {
    const double r = 1.0 / (double)safe;
#pragma unroll
    for (int j = 0; j < kCols; ++j) quota[j] = quota_div(weight[j] * t64, safe, r);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) quota[j] = floordiv(wrap_mul(weight[j], t64), safe);
  }
  const int64_t rem = t64 - warp_sum(quota);
  bool bonus[kCols] = {false, false, false, false};
  if (sum_w > 0 && rem > 0) {
    // last: the static row's previous replicas, the dynamic row's on a
    // Steady scale-up, else 0
    int32_t last[kCols];
    int64_t wmax = INT64_MIN, wmin = INT64_MAX;
    int32_t lmax = INT32_MIN, lmin = INT32_MAX;
    bool nonneg = true;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      last[j] = is_static ? (f[j] ? pv[j] : 0) : (up ? wrap_i32(prev_m[j]) : 0);
      if (active[j]) {
        wmax = weight[j] > wmax ? weight[j] : wmax;
        wmin = weight[j] < wmin ? weight[j] : wmin;
        lmax = last[j] > lmax ? last[j] : lmax;
        lmin = last[j] < lmin ? last[j] : lmin;
        nonneg = nonneg && last[j] >= 0 && tv[j] >= 0;
      }
    }
    wmax = warp_max(wmax);
    wmin = warp_min(wmin);
    lmax = warp_max(lmax);
    lmin = warp_min(lmin);
    const int wb = 64 - __clzll((long long)((uint64_t)wmax - (uint64_t)wmin));
    const int lb = 32 - __clz((int)((uint32_t)lmax - (uint32_t)lmin));
    if (__all_sync(kFull, nonneg) && wb + lb <= 25) {
      // with every last and tie >= 0, last_tie orders as (last desc, tie
      // asc), so the key packs into one word: (wmax - w, lmax - last, tie,
      // column), below 2^63
      Key64 own[kCols], s[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        own[j].k = active[j] ? ((uint64_t)wmax - (uint64_t)weight[j]) << (lb + 38) |
                                   (uint64_t)(uint32_t)(lmax - last[j]) << 38 |
                                   (uint64_t)tv[j] << 7 | (uint64_t)(kCols * lane + j)
                             : ~0ull;
        s[j] = own[j];
      }
      warp_sort(s, lane);
      first_k(s, own, active, rem, K, bonus);
    } else {
      KeyWide own[kCols], s[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = kCols * lane + j;
        const int64_t last_tie =
            (int64_t)((uint64_t)(kI32Max - (int64_t)last[j]) << 32) | (int64_t)tv[j];
        own[j] = active[j] ? KeyWide{-weight[j], last_tie, col}
                           : KeyWide{INT64_MAX, INT64_MAX, col};
        s[j] = own[j];
      }
      warp_sort(s, lane);
      first_k(s, own, active, rem, K, bonus);
    }
  }

  int32_t result[kCols];
  bool positive[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    int32_t res = wrap_i32(quota[j] + (bonus[j] && weight[j] > 0 ? 1 : 0));
    if (!(sum_w > 0)) res = 0;
    const int32_t init = !is_static && up ? wrap_i32(prev_m[j]) : 0;
    int32_t sd = (is_dyn && eq) ? wrap_i32(prev_m[j]) : (int32_t)((uint32_t)init + (uint32_t)res);
    if (unsched) sd = 0;
    int32_t r = 0;
    if (strat == kDuplicated) {
      r = f[j] ? reps : 0;
    } else if (is_static || is_dyn) {
      r = sd;
    }
    result[j] = active[j] ? r : 0;
    positive[j] = active[j] && result[j] > 0;
  }

  // --- outputs: full window row, then the compact window ---
  Key64 s[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = kCols * lane + j;
    if (active[j]) p.result[base + col] = result[j];
    s[j].k = active[j] ? ((uint64_t)(uint32_t)(kI32Max - (int64_t)result[j]) << 7) | (uint64_t)col
                       : ~0ull;
  }
  const int n = warp_count(positive);
  warp_sort(s, lane);
  const int tw = p.topk;
  const int64_t obase = (int64_t)row * tw;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int q = kCols * lane + j;
    if (q < tw) {
      p.top_idx[obase + q] = p.cand[base + (int)(s[j].k & (kWindow - 1))];
      p.top_val[obase + q] = (int32_t)(kI32Max - (int64_t)(s[j].k >> 7));
    }
  }
  if (lane == 0) {
    p.unsched[row] = unsched ? 1 : 0;
    p.avail_sum[row] = wrap_i32(asum);
    p.nnz[row] = n;
  }
}

}  // namespace

extern "C" int candidate_tail_launch(
    const void* feas, const void* avail, const void* prev, const void* tie,
    const void* cand, const void* weight_tables, int Cw, const void* weight_idx,
    const void* strategy, const void* replicas, const void* fresh, int rows, int K,
    int topk, int has_agg, void* result, void* unsched, void* avail_sum, void* nnz,
    void* top_idx, void* top_val, void* stream) {
  if (rows <= 0 || K <= 0 || K > kWindow || topk <= 0 || topk > K) {
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
  const int per_block = kThreads / 32;
  candidate_tail_kernel<<<(rows + per_block - 1) / per_block, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
