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
// histograms, over keys rebased to the row's key range so that small ranges
// take few passes. The bonus cutoff selects the rem-th (weight, packed
// last/tie, column) triple one key at a time; a column is in the bonus set
// iff its triple is at or before the cutoff, which is the reference's
// `_cutoff_le` compare. The Aggregated prefix walks the same digits with
// per-digit weight sums beside the counts: the boundary key is the largest
// one whose weighted rank is below the target, and inside its group of
// equal keys (all of one weight) the count follows by division. That walk
// needs non-negative weights (a monotone prefix sum); a row with a negative
// weight, which no encoded batch produces, counts its prefix exactly by a
// quadratic pass instead. The output window holds at most 128 entries: its
// cutoff is selected the same way and its members are sorted in shared
// memory. With topk = 0 (dense_tail_launch only) there is no window: the
// callers that drop it (the graft program, the per-row re-solve) skip its
// selection and sort.
//
// What bounds it on an H100: bytes, 13 per input element read once plus
// the i32 result row (about 0.4 GB for the 10 240 rows x 5 120 columns of
// the graft program). Two routes, both exact:
//   - the shared-memory route (a block of 384 threads per row, two blocks
//     an SM at 5 120 columns): the row is read from device memory once and
//     staged in dynamic shared memory (17 bytes a column, up to 12 288
//     columns, about 215 KB of the 227 KB a block may take); every selection pass then
//     sweeps shared memory, its histogram takes one shared-memory atomic per
//     distinct digit of a warp, warp 0 picks the digit with a shuffle scan,
//     and a pass that leaves one member ends the selection
//     (radix_select.cuh, "Rows staged in shared memory");
//   - the re-reading route, for wider rows: each pass re-reads the row from
//     global memory (L1/L2 resident) and its histograms take one
//     shared-memory atomic per column; shared memory is fixed (about 4.2 KB).
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry points at the bottom (ctypes). The
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

// Bitonic sort of the kTopMax window keys in shared memory, ascending
// (every thread of the block calls it).
__device__ void sort_window(unsigned long long* key, int tid) {
  for (int k = 2; k <= kTopMax; k <<= 1) {
    for (int m = k >> 1; m > 0; m >>= 1) {
      if (tid < kTopMax / 2) {
        const int i = 2 * tid - (tid & (m - 1));
        const int ixm = i + m;
        const bool up = (i & k) == 0;
        const unsigned long long x = key[i], y = key[ixm];
        if (up == (x > y)) {
          key[i] = y;
          key[ixm] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The re-reading route, for rows wider than shared memory holds: every
// pass reads the row from device memory (L1/L2) again.
template <int kMode, bool kWin>
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
  if constexpr (!kWin) return;

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
  sort_window(s.topkey, tid);
  for (int i = tid; i < p.topk; i += blockDim.x) {
    const uint64_t k = s.topkey[i];
    const int col = (int)(k & kLow32);
    p.top_idx[(int64_t)j * p.topk + i] = kMode == kWindow ? r.cand[col] : col;
    p.top_val[(int64_t)j * p.topk + i] = (int32_t)(kI32Max - (int64_t)(k >> 32));
  }
}

// ---------------------------------------------------------------------------
// The shared-memory route: the row read from device memory once.
//
// The block stages its row as the per-column values every later step needs:
// the dispenser weight (int64; the masked availability until the row sums
// are known), the masked previous replicas, the tie and the feasibility
// (17 bytes a column, plus a ballot word per 32 columns of scratch), all in
// dynamic shared memory. Every sweep after that visits the columns the
// thread staged itself (column c = tid, tid + blockDim.x, ...), so only the
// selections, the non-monotone Aggregated count and the output window read
// columns other threads wrote, each after a barrier. The selections are
// radix_select.cuh's shared-memory ones. The division tie cutoff and the
// output window select a key, then take the k-th column among the members
// with that key in column order (one ballot sweep) unless the key's member
// was unique already.

// 384 threads, two blocks an SM: at most 80 registers a thread (512
// threads at 64 spilled), and two rows of 5 120 columns (2 x 92 KB) fit
constexpr int kSmemThreads = 384;
constexpr int kSmemLimit = 232448;  // shared memory a block may take on sm_90 (227 KB)
constexpr int kSmemMaxCols = 12288;  // the widest row the route stages (about 215 KB)

struct SmemShared : SmemSelect {
  unsigned long long topkey[kTopMax];
  unsigned int slots;
};

// Built with -DDENSE_TAIL_PHASES (scripts/torch_tail_phases.py, never by
// build.py), thread 0 of each block adds the cycles of each phase of the
// shared-memory route into g_phase; dense_tail_phase_cycles reads and
// zeroes them. Phases: 0 staging and row sums, 1 weights, 2 Aggregated
// cutoff, 3 quota sums, 4 bonus cutoff, 5 result row, 6 window cutoff,
// 7 window gather and sort.
#ifdef DENSE_TAIL_PHASES
constexpr int kPhases = 8;
__device__ unsigned long long g_phase[kPhases];
#define PHASE_START long long phase_t = clock64()
#define PHASE(i)                                                    \
  do {                                                              \
    if (threadIdx.x == 0) {                                         \
      const long long t = clock64();                                \
      atomicAdd(&g_phase[i], (unsigned long long)(t - phase_t));    \
      phase_t = t;                                                  \
    }                                                               \
  } while (0)
#else
#define PHASE_START
#define PHASE(i)
#endif

// Dynamic shared memory of one row C columns wide: weight (i64), masked
// prev (i32), tie (i32) / later the result, the ballot words, feasibility.
__host__ __device__ constexpr size_t smem_words(int C) { return ((size_t)C + 31) / 32; }
__host__ __device__ constexpr size_t smem_bytes(int C) {
  return (size_t)C * 16 + smem_words(C) * 4 + (size_t)C;
}

// Block-wide minima of three int64 values (each at most 0: the minima
// start at 0, as the row-reading kernel's do); every thread gets them.
__device__ void smem_mins(SmemSelect& s, int64_t (&m)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) m[i] = warp_min_i64(m[i]);
  if (lane_id() == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) s.red[warp_id()][i] = (unsigned long long)m[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    int64_t v = 0;
    for (int w = 0; w < n_warps(); ++w) {
      const int64_t t = (int64_t)s.red[w][i];
      v = t < v ? t : v;
    }
    m[i] = v;
  }
  __syncthreads();
}

// select_triple over a staged row: the k-th smallest (a, b, column) triple
// (1 <= k <= C); a level whose selected key has a single member ends it.
template <class KeyA, class KeyB>
__device__ Cutoff smem_triple(SmemSelect& s, unsigned* words, int C, uint64_t k, KeyA a_of,
                              KeyB b_of) {
  Cutoff t;
  t.any = true;
  const Sel sa = smem_select(s, C, k, a_of, [](int) { return true; });
  t.a = sa.key;
  k -= sa.less;
  if (sa.item >= 0) {
    t.b = b_of(sa.item);
    t.col = sa.item;
    return t;
  }
  const uint64_t a0 = t.a;
  const Sel sb = smem_select(s, C, k, b_of, [&](int c) { return a_of(c) == a0; });
  t.b = sb.key;
  k -= sb.less;
  if (sb.item >= 0) {
    t.col = sb.item;
    return t;
  }
  const uint64_t b0 = t.b;
  t.col = smem_nth(s, words, C, k, [&](int c) { return a_of(c) == a0 && b_of(c) == b0; });
  return t;
}

template <int kMode, bool kWin>
__global__ void __launch_bounds__(kSmemThreads, 2)
dense_tail_smem_kernel(TailParams p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ SmemShared s;
  const int j = blockIdx.x;
  const int b = kMode == kWindow ? j : p.rows[j];
  const int C = p.C;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  int64_t* w = reinterpret_cast<int64_t*>(dyn);
  int32_t* pmv = reinterpret_cast<int32_t*>(w + C);
  int32_t* tv = pmv + C;  // the tie; the result once it is written
  unsigned* words = reinterpret_cast<unsigned*>(tv + C);
  uint8_t* fv = reinterpret_cast<uint8_t*>(words + smem_words(C));

  const int64_t base = (int64_t)b * C;
  const int strat = p.strategy[b];
  const bool is_static = strat == kStaticWeight;
  const bool is_dyn = strat == kDynamicWeight || strat == kAggregated;
  const bool fresh = p.fresh[b] != 0;
  const int32_t reps = p.replicas[b];
  const int64_t* wrow = kMode == kSpread ? nullptr
                                         : p.weight_tables + (int64_t)p.weight_idx[b] *
                                                                 (kMode == kWindow ? p.Cw : C);
  const uint8_t* chosen = kMode == kSpread ? p.chosen + (int64_t)j * p.R1 : nullptr;
  const int32_t* cand = kMode == kWindow ? p.cand + base : nullptr;
  PHASE_START;
  for (int i = tid; i < 256; i += bd) {
    s.hist[i] = 0;
    s.wsum[i] = 0;
  }

  // ---- the one read of the row: stage it, with its sums and minima ----
  uint64_t sums[4] = {0, 0, 0, 0};  // static weight, avail, prev, feasible
  int64_t ma = 0, mp = 0, mf = 0;
  for (int c = tid; c < C; c += bd) {
    bool f = p.feas[base + c] != 0;
    if constexpr (kMode == kSpread) f = f && chosen[p.rid[c]] != 0;
    const int64_t am = f ? (int64_t)p.avail[base + c] : 0;
    const int32_t pm = f ? p.prev[base + c] : 0;
    int64_t sw = 0;
    if constexpr (kMode != kSpread) {
      if (is_static && f) sw = kMode == kWindow ? wrow[cand[c]] : wrow[c];
    }
    w[c] = is_static ? sw : am;
    pmv[c] = pm;
    tv[c] = p.tie[base + c];
    fv[c] = f ? 1 : 0;
    sums[0] += (uint64_t)sw;
    sums[1] += (uint64_t)am;
    sums[2] += (uint64_t)(int64_t)pm;
    sums[3] += f ? 1 : 0;
    ma = am < ma ? am : ma;
    mp = pm < mp ? pm : mp;
    mf = am + pm < mf ? am + pm : mf;
  }
  int64_t mins[3] = {ma, mp, mf};
  smem_mins(s, mins);
  smem_sums<4>(s, sums);
  if constexpr (kMode == kSpread) {
    if (tid == 0) p.feas_count[j] = (int32_t)sums[3];
  }
  const int64_t min_a = mins[0], min_p = mins[1], min_f = mins[2];
  const bool all_zero = sums[0] == 0;
  const int64_t assigned = (int64_t)sums[2];
  const int64_t target = reps;
  const bool down = !fresh && assigned > target;
  const bool up = !fresh && assigned < target;
  const bool eq = !fresh && assigned == target;
  const int64_t tgt_dyn = up ? target - assigned : target;
  const int64_t asum = (int64_t)(fresh ? sums[1] + sums[2] : (down ? sums[2] : sums[1]));
  const bool unsched = is_dyn && !eq && asum < tgt_dyn;
  const int64_t w_min = fresh ? min_f : (down ? min_p : min_a);
  PHASE(0);

  // ---- the dispenser, for the rows whose result it decides ----
  const bool dispense = is_static || (is_dyn && !eq && !unsched);
  const bool trunc = p.has_agg && strat == kAggregated && !eq;
  auto prior = [&](int c) -> uint64_t { return (up && pmv[c] > 0) ? 0 : 1; };
  auto last_of = [&](int c) -> int32_t { return (is_static || up) ? pmv[c] : 0; };
  auto bonus_b = [&](int c) -> uint64_t {
    return (((uint64_t)(kI32Max - (int64_t)last_of(c)) << 32) | (uint64_t)(int64_t)tv[c]) ^
           kSign;
  };
  int64_t sum_w = 0, t64 = 0, safe = 1;
  Cutoff bonus;
  bonus.any = false;
  bool bonus_all = false;
  if (dispense) {
    if (is_static) {
      if (all_zero) {
        for (int c = tid; c < C; c += bd) w[c] = fv[c];
      }
    } else {
      for (int c = tid; c < C; c += bd) {
        const int64_t am = w[c], pm = pmv[c];
        w[c] = fresh ? am + pm : (down ? pm : am);
      }
    }
    __syncthreads();  // the weights, for the selections' reads of any column
    PHASE(1);
    if (trunc) {
      // the Aggregated truncation: keep the shortest (prior desc, weight
      // desc, column asc) prefix whose exclusive weighted sum stays below
      // the target
      Cutoff cut;
      cut.any = false;
      if (w_min >= 0) {  // every weight in [0, 2^32): one key (prior, weight)
        auto comp = [&](int c) { return (prior(c) << 32) | (kLow32 - (uint64_t)w[c]); };
        const Walk wk = smem_walk(
            s, C, tgt_dyn, comp, [&](int c) { return (uint64_t)w[c]; },
            [](int) { return true; });
        if (wk.found) {
          const int64_t w_g = (int64_t)(kLow32 - (wk.v & kLow32));
          uint64_t in = wk.n;
          if (w_g > 0) {
            const uint64_t need = (uint64_t)((tgt_dyn - wk.rank + w_g - 1) / w_g);
            in = need < in ? need : in;
          }
          const uint64_t v = wk.v;
          cut.col = smem_nth(s, words, C, in, [&](int c) { return comp(c) == v; });
          cut.any = true;
          cut.a = v >> 32;
          cut.b = neg_key(w_g);
        }
      } else {  // a negative weight: count the positions by exact prefix sums
        uint64_t count = 0;
        for (int c = tid; c < C; c += bd) {
          const uint64_t aj = prior(c), bj = neg_key(w[c]);
          uint64_t before = 0;
          for (int i = 0; i < C; ++i) {
            if (i != c && triple_le(prior(i), neg_key(w[i]), i, aj, bj, c)) {
              before += (uint64_t)w[i];
            }
          }
          count += (int64_t)before < tgt_dyn ? 1 : 0;
        }
        count = smem_sum(s, count);
        if (count > 0) {
          cut = smem_triple(s, words, C, count, prior, [&](int c) { return neg_key(w[c]); });
        }
      }
      // the selections' last barrier follows every read of another
      // thread's weight, and each thread truncates its own columns
      for (int c = tid; c < C; c += bd) {
        if (!(cut.any && triple_le(prior(c), neg_key(w[c]), c, cut.a, cut.b, cut.col))) {
          w[c] = 0;
        }
      }
    }
    PHASE(2);
    uint64_t acc = 0;
    for (int c = tid; c < C; c += bd) acc += (uint64_t)w[c];
    sum_w = (int64_t)smem_sum(s, acc);
    t64 = wrap_i32(is_static ? target : tgt_dyn);
    safe = sum_w > 1 ? sum_w : 1;
    acc = 0;
    for (int c = tid; c < C; c += bd) acc += (uint64_t)floordiv(wrap_mul(w[c], t64), safe);
    const int64_t rem = (int64_t)((uint64_t)t64 - smem_sum(s, acc));
    PHASE(3);
    if (sum_w > 0 && rem > 0) {
      if (rem >= C) {
        bonus_all = true;
      } else {
        bonus = smem_triple(s, words, C, (uint64_t)rem, [&](int c) { return neg_key(w[c]); },
                            bonus_b);
      }
    }
    PHASE(4);
  }

  // ---- the result row (written once) and nnz ----
  int32_t* res_row = p.result + (int64_t)j * C;
  uint64_t pos = 0;
  for (int c = tid; c < C; c += bd) {
    const bool f = fv[c] != 0;
    int32_t v = 0;
    if (strat == kDuplicated) {
      v = f ? reps : 0;
    } else if (is_static || is_dyn) {
      if (unsched) {
        v = 0;
      } else if (is_dyn && eq) {
        v = pmv[c];
      } else {
        const int64_t wc = w[c];
        bool plus = false;
        if (wc > 0) {
          plus = bonus_all ||
                 (bonus.any && triple_le(neg_key(wc), bonus_b(c), c, bonus.a, bonus.b, bonus.col));
        }
        int32_t q = wrap_i32(floordiv(wrap_mul(wc, t64), safe) + (plus ? 1 : 0));
        if (!(sum_w > 0)) q = 0;
        const int32_t init = is_static ? 0 : last_of(c);
        v = (int32_t)((uint32_t)init + (uint32_t)q);
      }
    }
    res_row[c] = v;
    tv[c] = v;
    pos += v > 0 ? 1 : 0;
  }
  pos = smem_sum(s, pos);  // its barriers also publish the staged result
  if (tid == 0) {
    p.unsched[j] = unsched ? 1 : 0;
    p.avail_sum[j] = wrap_i32(asum);
    p.nnz[j] = (int32_t)pos;
    s.slots = 0;
  }
  PHASE(5);
  if constexpr (!kWin) return;

  // ---- the output window: top `topk` by (value desc, column asc) ----
  auto vkey = [&](int c) -> uint64_t { return (uint64_t)(kI32Max - (int64_t)tv[c]); };
  uint64_t cut = ~0ull;
  if (p.topk < C) {
    const Sel vs = smem_select(s, C, (uint64_t)p.topk, vkey, [](int) { return true; });
    int col = vs.item;
    if (col < 0) {
      const uint64_t v0 = vs.key;
      col = smem_nth(s, words, C, (uint64_t)p.topk - vs.less,
                     [&](int c) { return vkey(c) == v0; });
    }
    cut = (vs.key << 32) | (uint64_t)col;
  }
  PHASE(6);
  __syncthreads();
  for (int c = tid; c < C; c += bd) {
    const uint64_t k = (vkey(c) << 32) | (uint64_t)c;
    if (k <= cut) s.topkey[atomicAdd(&s.slots, 1u)] = k;
  }
  __syncthreads();
  // the topk keys are distinct (the column is in them): each lands at its
  // rank, with no sort and no barrier
  if (tid < p.topk) {
    const uint64_t k = s.topkey[tid];
    int i = 0;
    for (int q = 0; q < p.topk; ++q) i += s.topkey[q] < k ? 1 : 0;
    const int col = (int)(k & kLow32);
    p.top_idx[(int64_t)j * p.topk + i] = kMode == kWindow ? cand[col] : col;
    p.top_val[(int64_t)j * p.topk + i] = (int32_t)(kI32Max - (int64_t)(k >> 32));
  }
  PHASE(7);
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

// The route of a call: 0 the shared-memory route up to kSmemMaxCols
// columns, else the re-reading one; 1 forces the re-reading one, so both
// can be held against the plain version and timed at any width.
constexpr int kRouteAuto = 0;
constexpr int kRouteReread = 1;

template <int kMode, bool kWin>
int launch_tail(const TailParams& p, int n, int route, cudaStream_t st) {
  const size_t dyn = smem_bytes(p.C);
  const bool fits = p.C <= kSmemMaxCols;
  // the static shared memory (ptxas may round it up) with room to spare
  static_assert(smem_bytes(kSmemMaxCols) + sizeof(SmemShared) + 1024 <= (size_t)kSmemLimit,
                "the widest staged row must fit a block's shared memory");
  if (route != kRouteAuto && route != kRouteReread) {
    return (int)cudaErrorInvalidValue;
  }
  if (route == kRouteReread || !fits) {
    dense_tail_kernel<kMode, kWin><<<n, kThreads, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  if (dyn > 48 * 1024) {  // past the default: opt in to the widest row once per device
    static unsigned long long opted = 0;
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return (int)rc;
    if (dev >= 64 || !(opted >> dev & 1ull)) {
      rc = cudaFuncSetAttribute(dense_tail_smem_kernel<kMode, kWin>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_bytes(kSmemMaxCols));
      if (rc != cudaSuccess) return (int)rc;
      if (dev < 64) opted |= 1ull << dev;
    }
  }
  dense_tail_smem_kernel<kMode, kWin><<<n, kSmemThreads, dyn, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// topk = 0: no output window (top_idx / top_val unused); the result,
// unsched, avail_sum and nnz are written as with one.
extern "C" int dense_tail_launch(
    const void* feas, const void* avail, const void* prev, const void* tie, int C,
    const void* rows, int n, const void* weight_tables, const void* weight_idx,
    const void* strategy, const void* replicas, const void* fresh, int topk, int has_agg,
    int route, void* result, void* unsched, void* avail_sum, void* nnz, void* top_idx,
    void* top_val, void* stream) {
  if (n <= 0 || C <= 0 || topk < 0 || topk > kTopMax || topk > C) {
    return (int)cudaErrorInvalidValue;
  }
  TailParams p = tail_params(feas, avail, prev, tie, C, rows, strategy, replicas, fresh, topk,
                             has_agg, result, unsched, avail_sum, nnz, top_idx, top_val);
  p.weight_tables = static_cast<const int64_t*>(weight_tables);
  p.weight_idx = static_cast<const int32_t*>(weight_idx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return topk > 0 ? launch_tail<kDense, true>(p, n, route, st)
                  : launch_tail<kDense, false>(p, n, route, st);
}

// The spread re-run: the same tail over each output row's selection (see
// TailParams.chosen), zero static weights, plus the selection's feasible
// count. Replaces karmada_tpu/sched/spread_batch.py:455 `spread_tail_kernel`.
extern "C" int spread_tail_launch(
    const void* feas, const void* avail, const void* prev, const void* tie, int C,
    const void* rows, int n, const void* chosen, int R1, const void* rid,
    const void* strategy, const void* replicas, const void* fresh, int topk, int has_agg,
    int route, void* result, void* unsched, void* avail_sum, void* feas_count, void* nnz,
    void* top_idx, void* top_val, void* stream) {
  if (n <= 0 || C <= 0 || R1 <= 0 || topk <= 0 || topk > kTopMax || topk > C) {
    return (int)cudaErrorInvalidValue;
  }
  TailParams p = tail_params(feas, avail, prev, tie, C, rows, strategy, replicas, fresh, topk,
                             has_agg, result, unsched, avail_sum, nnz, top_idx, top_val);
  p.chosen = static_cast<const uint8_t*>(chosen);
  p.R1 = R1;
  p.rid = static_cast<const int32_t*>(rid);
  p.feas_count = static_cast<int32_t*>(feas_count);
  return launch_tail<kSpread, true>(p, n, route, static_cast<cudaStream_t>(stream));
}

// The window mode: the tail over [n, K] candidate windows (see
// TailParams.cand), for windows wider than candidate_tail.cu's block.
// Replaces karmada_tpu/sched/candidates.py:280 `_candidate_tail_kernel`.
extern "C" int window_tail_launch(
    const void* feas, const void* avail, const void* prev, const void* tie, const void* cand,
    int n, int K, const void* weight_tables, int Cw, const void* weight_idx,
    const void* strategy, const void* replicas, const void* fresh, int topk, int has_agg,
    int route, void* result, void* unsched, void* avail_sum, void* nnz, void* top_idx,
    void* top_val, void* stream) {
  if (n <= 0 || K <= 0 || Cw <= 0 || topk <= 0 || topk > kTopMax || topk > K) {
    return (int)cudaErrorInvalidValue;
  }
  TailParams p = tail_params(feas, avail, prev, tie, K, nullptr, strategy, replicas, fresh,
                             topk, has_agg, result, unsched, avail_sum, nnz, top_idx, top_val);
  p.weight_tables = static_cast<const int64_t*>(weight_tables);
  p.weight_idx = static_cast<const int32_t*>(weight_idx);
  p.cand = static_cast<const int32_t*>(cand);
  p.Cw = Cw;
  return launch_tail<kWindow, true>(p, n, route, static_cast<cudaStream_t>(stream));
}

#ifdef DENSE_TAIL_PHASES
// The phase cycles summed since the last call (kPhases values), then zeroed.
extern "C" int dense_tail_phase_cycles(unsigned long long* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (rc == cudaSuccess) {
    const unsigned long long zero[kPhases] = {};
    rc = cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase));
  }
  return (int)rc;
}
#endif
