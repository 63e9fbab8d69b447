// dense_tail: the replica-division tail over full fleet rows (phase 2 of
// the dense schedule round).
//
// Replaces karmada_tpu/sched/core.py:502 `_tail_kernel` (with core.py:230
// `assignment_tail`, ops/assign.py:279 `combined_assign`, :149
// `take_by_weight`, :178 `_aggregated_keep`, :113 `_cutoff_le` and
// core.py:254 `compact_outputs` fused in). One block per output row reads
// the dense-filter outputs (feasible, avail, prev, tie) of its batch row
// through the row id, in int64 as the reference with x64 on:
//   - static weights (feasible-masked; an all-zero row weighs 1 on every
//     feasible column) and dynamic weights with the Steady up/down/eq and
//     Fresh modes;
//   - the Aggregated truncation: keep the shortest (prior desc, weight
//     desc, column asc) prefix whose exclusive weighted prefix sum stays
//     below the target;
//   - TakeByWeight: quota = floor(w * t / sum w), then +1 to the first
//     `rem` columns in (weight desc, (last desc, tie asc), column asc);
//   - the result row, nnz, and the top min(C, topk) of the result by
//     (value desc, column asc).
// The same kernel, with the selection compiled in (kSpread), replaces
// karmada_tpu/sched/spread_batch.py:455 `spread_tail_kernel`: the spread
// round's division re-run over each row's selection — a column takes part
// only when feasible and in a region the row chose — with zero static
// weights (static-weight placements ignore spread constraints), plus the
// selection's feasible count. In window mode (kWindow) it replaces
// karmada_tpu/sched/candidates.py:280 `_candidate_tail_kernel` for windows
// wider than candidate_tail.cu's 128-thread block: the rows are the
// [rows, K] candidate windows themselves (output row j is window row j),
// a column's static weight is read at its global cluster id through
// cand_idx, and the output window's ids are mapped through cand_idx too.
// Window columns ascend by global id, so the local column order is the
// global one and every tie-break matches the dense solve's.
//
// Rows are thousands of columns wide, so nothing is sorted. Every order
// statistic is a SELECTION: an MSB-first radix select with 8-bit digit
// histograms in shared memory, over keys rebased to the row's key range so
// that small ranges take few passes, each pass re-reading the row from
// global memory (L1/L2 resident). The bonus cutoff selects the rem-th
// (weight, packed last/tie, column) triple one key at a time; a column is
// in the bonus set iff its triple is at or before the cutoff, which is the
// reference's `_cutoff_le` compare. The Aggregated prefix walks the same
// digits with per-digit weight sums beside the counts: the boundary key is
// the largest one whose weighted rank is below the target, and inside its
// group of equal keys (all of one weight) the count follows by division.
// That walk needs non-negative weights (a monotone prefix sum); a row with
// a negative weight, which no encoded batch produces, counts its prefix
// exactly by a quadratic pass instead. The output window holds at most 128
// entries: its cutoff is selected the same way and its members are sorted
// in shared memory. Any width works; shared memory is fixed (about 4.2 KB).
//
// What bounds it on an H100: bytes are 13 per input element read once plus
// the i32 result row (about 0.6 GB for the 8k rows x 5120 columns of the
// dense flagship), so the bound is memory; this first version re-reads each
// row once per selection pass (some 10-30 passes) and serialises its
// histograms through shared-memory atomics, so it runs well above that
// bound. Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a
// and called through the plain C entry points at the bottom (ctypes). The
// radix selections live in radix_select.cuh, shared with group_score.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kDuplicated = 1;
constexpr int kStaticWeight = 2;
constexpr int kDynamicWeight = 3;
constexpr int kAggregated = 4;
constexpr int64_t kI32Max = 2147483647;
constexpr uint64_t kLow32 = 0xffffffffull;
constexpr int kTopMax = 128;

// what a row is: a dense-filter row read through its row id, the spread
// re-run over a row's selection, or a candidate window
constexpr int kDense = 0;
constexpr int kSpread = 1;
constexpr int kWindow = 2;

struct TailParams {
  const uint8_t* feas;  // [B,C] dense-filter outputs
  const int32_t* avail;
  const int32_t* prev;
  const int32_t* tie;
  int C;
  const int32_t* rows;           // [n] batch row of each output row
  const int64_t* weight_tables;  // [W,C]
  const int32_t* weight_idx;     // [B]
  const int32_t* strategy;       // [B]
  const int32_t* replicas;       // [B]
  const uint8_t* fresh;          // [B]
  int topk, has_agg;
  int32_t* result;     // [n,C]
  uint8_t* unsched;    // [n]
  int32_t* avail_sum;  // [n]
  int32_t* nnz;        // [n]
  int32_t* top_idx;    // [n,topk]
  int32_t* top_val;    // [n,topk]
  // the spread re-run (spread_tail_launch): output row j keeps only the
  // columns whose region rid[c] it chose, chosen[j * R1 + rid[c]] != 0
  // (column 0 of the table is the regionless column, never chosen); static
  // weights are zero and the selection's feasible count is written
  const uint8_t* chosen;  // [n,R1]
  int R1;
  const int32_t* rid;    // [C]
  int32_t* feas_count;   // [n]
  // the window mode (window_tail_launch): the inputs are [n, C] windows,
  // rows is unused, and column c of row j is cluster cand[j * C + c] of a
  // fleet of Cw columns (the weight tables' width)
  const int32_t* cand;  // [n,C]
  int Cw;
};

struct Shared : RadixShared {
  long long mins[3];
  unsigned long long topkey[kTopMax];
  unsigned int slots;
};

struct Cutoff {
  bool any;  // false: no column qualifies
  uint64_t a, b;
  int col;
};

// The k-th smallest (a, b, column) triple over all columns, one key at a
// time (1 <= k <= C).
template <class KeyA, class KeyB>
__device__ Cutoff select_triple(Shared& s, int C, uint64_t k, KeyA a_of, KeyB b_of) {
  Cutoff t;
  t.any = true;
  uint64_t less;
  t.a = select_kth(s, C, k, a_of, [](int) { return true; }, &less);
  k -= less;
  const uint64_t a0 = t.a;
  t.b = select_kth(s, C, k, b_of, [&](int c) { return a_of(c) == a0; }, &less);
  k -= less;
  const uint64_t b0 = t.b;
  t.col = (int)select_kth(
      s, C, k, [](int c) { return (uint64_t)c; },
      [&](int c) { return a_of(c) == a0 && b_of(c) == b0; }, &less);
  return t;
}

struct RowCtx {
  int64_t base;            // offset of the batch row in the [B,C] inputs
  const int64_t* wrow;     // its static weight table row
  const uint8_t* chosen;   // its chosen regions (the spread re-run)
  const int32_t* cand;     // its window's cluster ids (the window mode)
  bool is_static, fresh, up, down, all_zero;
  bool trunc;  // the Aggregated truncation applies
  Cutoff agg;  // keep a column iff its (prior, weight, column) is at or before
};

// Whether column c takes part: feasible and, in the spread re-run, in a
// chosen region.
template <int kMode>
__device__ __forceinline__ bool feas_at(const TailParams& p, const RowCtx& r, int c) {
  const bool f = p.feas[r.base + c] != 0;
  if constexpr (kMode == kSpread) {
    return f && r.chosen[p.rid[c]] != 0;
  } else {
    return f;
  }
}

// The static weight of column c (zero in the spread re-run, read at the
// window column's cluster id in the window mode).
template <int kMode>
__device__ __forceinline__ int64_t static_w(const RowCtx& r, int c) {
  if constexpr (kMode == kSpread) {
    return 0;
  } else if constexpr (kMode == kWindow) {
    return r.wrow[r.cand[c]];
  } else {
    return r.wrow[c];
  }
}

// The dynamic weight of column c before the truncation, and its prev_m.
template <int kMode>
__device__ __forceinline__ int64_t dyn_weight(const TailParams& p, const RowCtx& r, int c,
                                              int64_t* prev_m) {
  const bool f = feas_at<kMode>(p, r, c);
  const int64_t am = f ? (int64_t)p.avail[r.base + c] : 0;
  const int64_t pm = f ? (int64_t)p.prev[r.base + c] : 0;
  *prev_m = pm;
  return r.fresh ? am + pm : (r.down ? pm : am);
}

__device__ __forceinline__ uint64_t prior_key(const RowCtx& r, int64_t prev_m) {
  return (r.up && prev_m > 0) ? 0 : 1;  // ascending -prior
}

struct DivIn {
  int64_t weight;
  int32_t last;
  int32_t init;
};

// The dispenser inputs of column c (combined_assign's row-select).
template <int kMode>
__device__ DivIn div_in(const TailParams& p, const RowCtx& r, int c) {
  DivIn d;
  if (r.is_static) {
    const bool f = feas_at<kMode>(p, r, c);
    int64_t w = f ? static_w<kMode>(r, c) : 0;
    if (r.all_zero && f) w = 1;
    d.weight = w;
    d.last = f ? p.prev[r.base + c] : 0;
    d.init = 0;
    return d;
  }
  int64_t pm;
  int64_t w = dyn_weight<kMode>(p, r, c, &pm);
  if (r.trunc &&
      !(r.agg.any && triple_le(prior_key(r, pm), neg_key(w), c, r.agg.a, r.agg.b, r.agg.col))) {
    w = 0;
  }
  d.weight = w;
  d.last = r.up ? wrap_i32(pm) : 0;
  d.init = d.last;
  return d;
}

// The Aggregated truncation cutoff: the k-th (prior desc, weight desc,
// column asc) triple, k the number of sorted positions whose exclusive
// weighted prefix sum is below tgt.
template <int kMode>
__device__ Cutoff aggregated_cutoff(const TailParams& p, const RowCtx& r, Shared& s,
                                    int64_t tgt, bool monotone) {
  const int C = p.C;
  auto a_of = [&](int c) {
    int64_t pm;
    dyn_weight<kMode>(p, r, c, &pm);
    return prior_key(r, pm);
  };
  auto b_of = [&](int c) {
    int64_t pm;
    return neg_key(dyn_weight<kMode>(p, r, c, &pm));
  };
  Cutoff cut;
  cut.any = false;
  if (monotone) {
    // every weight lies in [0, 2^32): one 33-bit key (prior, weight)
    auto comp = [&](int c) {
      int64_t pm;
      const int64_t w = dyn_weight<kMode>(p, r, c, &pm);
      return (prior_key(r, pm) << 32) | (kLow32 - (uint64_t)w);
    };
    auto w_of = [&](int c) {
      int64_t pm;
      return (uint64_t)dyn_weight<kMode>(p, r, c, &pm);
    };
    const Walk wk = weighted_walk(s, C, tgt, comp, w_of, [](int) { return true; });
    if (!wk.found) return cut;
    // inside the boundary group every member weighs w_g: member j (in column
    // order) starts at rank + j * w_g
    const int64_t w_g = (int64_t)(kLow32 - (wk.v & kLow32));
    uint64_t in = wk.n;
    if (w_g > 0) {
      const uint64_t need = (uint64_t)((tgt - wk.rank + w_g - 1) / w_g);
      in = need < in ? need : in;
    }
    const uint64_t v = wk.v;
    uint64_t less;
    cut.col = (int)select_kth(
        s, C, in, [](int c) { return (uint64_t)c; }, [&](int c) { return comp(c) == v; }, &less);
    cut.any = true;
    cut.a = v >> 32;
    cut.b = neg_key(w_g);
    return cut;
  }
  // a negative weight: count the positions by their exact prefix sums
  uint64_t count = 0;
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const uint64_t aj = a_of(j), bj = b_of(j);
    uint64_t before = 0;
    for (int i = 0; i < C; ++i) {
      int64_t pm;
      const int64_t wi = dyn_weight<kMode>(p, r, i, &pm);
      if (i != j && triple_le(prior_key(r, pm), neg_key(wi), i, aj, bj, j)) {
        before += (uint64_t)wi;
      }
    }
    count += (int64_t)before < tgt ? 1 : 0;
  }
  count = block_sum(s, count);
  if (count == 0) return cut;
  return select_triple(s, C, count, a_of, b_of);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
dense_tail_kernel(TailParams p) {
  __shared__ Shared s;
  const int j = blockIdx.x;
  const int b = kMode == kWindow ? j : p.rows[j];
  const int C = p.C;
  const int tid = threadIdx.x;

  RowCtx r;
  r.base = (int64_t)b * C;
  r.wrow = kMode == kSpread ? nullptr
                            : p.weight_tables + (int64_t)p.weight_idx[b] *
                                                    (kMode == kWindow ? p.Cw : C);
  r.chosen = kMode == kSpread ? p.chosen + (int64_t)j * p.R1 : nullptr;
  r.cand = kMode == kWindow ? p.cand + r.base : nullptr;
  const int strat = p.strategy[b];
  r.is_static = strat == kStaticWeight;
  const bool is_dyn = strat == kDynamicWeight || strat == kAggregated;
  r.fresh = p.fresh[b] != 0;
  const int32_t reps = p.replicas[b];

  // ---- pass 1: the row sums and the weights' signs ----
  if (tid == 0) {
    s.mins[0] = s.mins[1] = s.mins[2] = 0;
  }
  uint64_t sw = 0, sa = 0, sp = 0, nf = 0;
  long long ma = 0, mp = 0, mf = 0;
  for (int c = tid; c < C; c += blockDim.x) {
    const bool f = feas_at<kMode>(p, r, c);
    const int64_t am = f ? (int64_t)p.avail[r.base + c] : 0;
    const int64_t pm = f ? (int64_t)p.prev[r.base + c] : 0;
    nf += f ? 1 : 0;
    sw += f ? (uint64_t)static_w<kMode>(r, c) : 0;
    sa += (uint64_t)am;
    sp += (uint64_t)pm;
    ma = am < ma ? am : ma;
    mp = pm < mp ? pm : mp;
    mf = am + pm < mf ? am + pm : mf;
  }
  __syncthreads();
  atomicMin(&s.mins[0], ma);
  atomicMin(&s.mins[1], mp);
  atomicMin(&s.mins[2], mf);
  sw = block_sum(s, sw);
  sa = block_sum(s, sa);
  sp = block_sum(s, sp);
  if constexpr (kMode == kSpread) {
    nf = block_sum(s, nf);
    if (tid == 0) p.feas_count[j] = (int32_t)nf;
  }
  r.all_zero = sw == 0;
  const int64_t assigned = (int64_t)sp;
  const int64_t target = reps;
  r.down = !r.fresh && assigned > target;
  r.up = !r.fresh && assigned < target;
  const bool eq = !r.fresh && assigned == target;
  const int64_t tgt_dyn = r.up ? target - assigned : target;
  const int64_t asum = (int64_t)(r.fresh ? sa + sp : (r.down ? sp : sa));
  const bool unsched = is_dyn && !eq && asum < tgt_dyn;
  const long long w_min = r.fresh ? s.mins[2] : (r.down ? s.mins[1] : s.mins[0]);

  // ---- the dispenser, for the rows whose result it decides ----
  const bool dispense = r.is_static || (is_dyn && !eq && !unsched);
  r.trunc = p.has_agg && strat == kAggregated && !eq;
  r.agg.any = false;
  int64_t sum_w = 0, t64 = 0, safe = 1;
  Cutoff bonus;
  bonus.any = false;
  bool bonus_all = false;
  if (dispense) {
    if (r.trunc) r.agg = aggregated_cutoff<kMode>(p, r, s, tgt_dyn, w_min >= 0);
    uint64_t acc = 0;
    for (int c = tid; c < C; c += blockDim.x) acc += (uint64_t)div_in<kMode>(p, r, c).weight;
    sum_w = (int64_t)block_sum(s, acc);
    t64 = wrap_i32(r.is_static ? target : tgt_dyn);
    safe = sum_w > 1 ? sum_w : 1;
    acc = 0;
    for (int c = tid; c < C; c += blockDim.x) {
      acc += (uint64_t)floordiv(wrap_mul(div_in<kMode>(p, r, c).weight, t64), safe);
    }
    const int64_t rem = (int64_t)((uint64_t)t64 - block_sum(s, acc));
    if (sum_w > 0 && rem > 0) {
      if (rem >= C) {
        bonus_all = true;
      } else {
        auto a_of = [&](int c) { return neg_key(div_in<kMode>(p, r, c).weight); };
        auto b_of = [&](int c) {
          const DivIn d = div_in<kMode>(p, r, c);
          const uint64_t k2 = ((uint64_t)(kI32Max - (int64_t)d.last) << 32) |
                              (uint64_t)(int64_t)p.tie[r.base + c];
          return k2 ^ kSign;
        };
        bonus = select_triple(s, C, (uint64_t)rem, a_of, b_of);
      }
    }
  }

  // ---- the result row and nnz ----
  int32_t* res_row = p.result + (int64_t)j * C;
  uint64_t pos = 0;
  for (int c = tid; c < C; c += blockDim.x) {
    const bool f = feas_at<kMode>(p, r, c);
    int32_t v = 0;
    if (strat == kDuplicated) {
      v = f ? reps : 0;
    } else if (r.is_static || is_dyn) {
      if (unsched) {
        v = 0;
      } else if (is_dyn && eq) {
        v = f ? p.prev[r.base + c] : 0;
      } else {
        const DivIn d = div_in<kMode>(p, r, c);
        bool plus = false;
        if (d.weight > 0) {
          if (bonus_all) {
            plus = true;
          } else if (bonus.any) {
            const uint64_t k2 = ((uint64_t)(kI32Max - (int64_t)d.last) << 32) |
                                (uint64_t)(int64_t)p.tie[r.base + c];
            plus = triple_le(neg_key(d.weight), k2 ^ kSign, c, bonus.a, bonus.b, bonus.col);
          }
        }
        int32_t q = wrap_i32(floordiv(wrap_mul(d.weight, t64), safe) + (plus ? 1 : 0));
        if (!(sum_w > 0)) q = 0;
        v = (int32_t)((uint32_t)d.init + (uint32_t)q);
      }
    }
    res_row[c] = v;
    pos += v > 0 ? 1 : 0;
  }
  pos = block_sum(s, pos);  // its barrier also publishes the result row
  if (tid == 0) {
    p.unsched[j] = unsched ? 1 : 0;
    p.avail_sum[j] = wrap_i32(asum);
    p.nnz[j] = (int32_t)pos;
    s.slots = 0;
  }

  // ---- the output window: top `topk` by (value desc, column asc) ----
  auto top_key = [&](int c) {
    return ((uint64_t)(kI32Max - (int64_t)res_row[c]) << 32) | (uint64_t)c;
  };
  uint64_t cut = ~0ull;
  if (p.topk < C) {
    uint64_t less;
    cut = select_kth(s, C, (uint64_t)p.topk, top_key, [](int) { return true; }, &less);
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    const uint64_t k = top_key(c);
    if (k <= cut) s.topkey[atomicAdd(&s.slots, 1u)] = k;
  }
  __syncthreads();
  for (int i = p.topk + tid; i < kTopMax; i += blockDim.x) s.topkey[i] = ~0ull;
  __syncthreads();
  // bitonic sort of the kTopMax window keys, ascending
  for (int k = 2; k <= kTopMax; k <<= 1) {
    for (int m = k >> 1; m > 0; m >>= 1) {
      if (tid < kTopMax / 2) {
        const int i = 2 * tid - (tid & (m - 1));
        const int ixm = i + m;
        const bool up = (i & k) == 0;
        const unsigned long long x = s.topkey[i], y = s.topkey[ixm];
        if (up == (x > y)) {
          s.topkey[i] = y;
          s.topkey[ixm] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < p.topk; i += blockDim.x) {
    const uint64_t k = s.topkey[i];
    const int col = (int)(k & kLow32);
    p.top_idx[(int64_t)j * p.topk + i] = kMode == kWindow ? r.cand[col] : col;
    p.top_val[(int64_t)j * p.topk + i] = (int32_t)(kI32Max - (int64_t)(k >> 32));
  }
}

TailParams tail_params(const void* feas, const void* avail, const void* prev, const void* tie,
                       int C, const void* rows, const void* strategy, const void* replicas,
                       const void* fresh, int topk, int has_agg, void* result, void* unsched,
                       void* avail_sum, void* nnz, void* top_idx, void* top_val) {
  TailParams p = {};
  p.feas = static_cast<const uint8_t*>(feas);
  p.avail = static_cast<const int32_t*>(avail);
  p.prev = static_cast<const int32_t*>(prev);
  p.tie = static_cast<const int32_t*>(tie);
  p.C = C;
  p.rows = static_cast<const int32_t*>(rows);
  p.strategy = static_cast<const int32_t*>(strategy);
  p.replicas = static_cast<const int32_t*>(replicas);
  p.fresh = static_cast<const uint8_t*>(fresh);
  p.topk = topk;
  p.has_agg = has_agg;
  p.result = static_cast<int32_t*>(result);
  p.unsched = static_cast<uint8_t*>(unsched);
  p.avail_sum = static_cast<int32_t*>(avail_sum);
  p.nnz = static_cast<int32_t*>(nnz);
  p.top_idx = static_cast<int32_t*>(top_idx);
  p.top_val = static_cast<int32_t*>(top_val);
  return p;
}

}  // namespace

extern "C" int dense_tail_launch(
    const void* feas, const void* avail, const void* prev, const void* tie, int C,
    const void* rows, int n, const void* weight_tables, const void* weight_idx,
    const void* strategy, const void* replicas, const void* fresh, int topk, int has_agg,
    void* result, void* unsched, void* avail_sum, void* nnz, void* top_idx, void* top_val,
    void* stream) {
  if (n <= 0 || C <= 0 || topk <= 0 || topk > kTopMax || topk > C) {
    return (int)cudaErrorInvalidValue;
  }
  TailParams p = tail_params(feas, avail, prev, tie, C, rows, strategy, replicas, fresh, topk,
                             has_agg, result, unsched, avail_sum, nnz, top_idx, top_val);
  p.weight_tables = static_cast<const int64_t*>(weight_tables);
  p.weight_idx = static_cast<const int32_t*>(weight_idx);
  dense_tail_kernel<kDense><<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The spread re-run: the same tail over each output row's selection (see
// TailParams.chosen), zero static weights, plus the selection's feasible
// count. Replaces karmada_tpu/sched/spread_batch.py:455 `spread_tail_kernel`.
extern "C" int spread_tail_launch(
    const void* feas, const void* avail, const void* prev, const void* tie, int C,
    const void* rows, int n, const void* chosen, int R1, const void* rid,
    const void* strategy, const void* replicas, const void* fresh, int topk, int has_agg,
    void* result, void* unsched, void* avail_sum, void* feas_count, void* nnz, void* top_idx,
    void* top_val, void* stream) {
  if (n <= 0 || C <= 0 || R1 <= 0 || topk <= 0 || topk > kTopMax || topk > C) {
    return (int)cudaErrorInvalidValue;
  }
  TailParams p = tail_params(feas, avail, prev, tie, C, rows, strategy, replicas, fresh, topk,
                             has_agg, result, unsched, avail_sum, nnz, top_idx, top_val);
  p.chosen = static_cast<const uint8_t*>(chosen);
  p.R1 = R1;
  p.rid = static_cast<const int32_t*>(rid);
  p.feas_count = static_cast<int32_t*>(feas_count);
  dense_tail_kernel<kSpread><<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The window mode: the tail over [n, K] candidate windows (see
// TailParams.cand), for windows wider than candidate_tail.cu's block.
// Replaces karmada_tpu/sched/candidates.py:280 `_candidate_tail_kernel`.
extern "C" int window_tail_launch(
    const void* feas, const void* avail, const void* prev, const void* tie, const void* cand,
    int n, int K, const void* weight_tables, int Cw, const void* weight_idx,
    const void* strategy, const void* replicas, const void* fresh, int topk, int has_agg,
    void* result, void* unsched, void* avail_sum, void* nnz, void* top_idx, void* top_val,
    void* stream) {
  if (n <= 0 || K <= 0 || Cw <= 0 || topk <= 0 || topk > kTopMax || topk > K) {
    return (int)cudaErrorInvalidValue;
  }
  TailParams p = tail_params(feas, avail, prev, tie, K, nullptr, strategy, replicas, fresh,
                             topk, has_agg, result, unsched, avail_sum, nnz, top_idx, top_val);
  p.weight_tables = static_cast<const int64_t*>(weight_tables);
  p.weight_idx = static_cast<const int32_t*>(weight_idx);
  p.cand = static_cast<const int32_t*>(cand);
  p.Cw = Cw;
  dense_tail_kernel<kWindow><<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
