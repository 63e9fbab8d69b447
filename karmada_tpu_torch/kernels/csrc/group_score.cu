// group_score: the spread round's group scoring, every (row, region) pair
// in one launch.
//
// Replaces karmada_tpu/sched/spread_batch.py:190 `group_score_kernel` and
// its skew-proof twin :298 `group_score_kernel_segmented` (the two give the
// same outputs). One block per (representative row, region) reads the
// dense-filter outputs of its batch row through the row id, over the
// region's members: the permuted columns perm[seg_start[g]:seg_end[g]] of
// the fleet's RegionLayout. calcGroupScore (group_clusters.go:143-330):
//   - value = feasible members, avail_sum = the sum of their availability
//     av = avail + prev (int64);
//   - Duplicated rows: cnt * 1000 + floor(sum score / cnt) over the members
//     with av >= replicas (0 when none);
//   - Divided rows: av_sum * 1000 + floor(score sum / value) when av_sum is
//     below the target, else target * 1000 + floor(prefix score sum /
//     (k + 1)) at the FIRST position k of the sortClusters order (score
//     desc, av desc, name rank asc; util.go:43-57) with k + 1 >= need and a
//     prefix availability >= target (value when there is none);
//   - weight 0 for a region without feasible members; the row's feasible
//     count over all C columns.
// Divisions floor (scores are non-negative in-tree; a negative one floors
// toward -inf as the reference's // does).
//
// Regions run from a handful of columns to the whole fleet, so nothing is
// sorted and shared memory is fixed: the order statistics are the radix
// selections of radix_select.cuh over the members, re-read through perm on
// every pass. Only the position k and the score sum up to it depend on the
// order. With non-negative availability the prefix sum is monotone, so k is
// max(need - 1, k_t) with k_t the first position whose prefix reaches the
// target: a weighted digit walk finds k_t one key of the (score, av, rank)
// tuple at a time (the tuple is compared exactly; it does not fit one
// 64-bit key). A row with a negative av in a region, which no encoded batch
// produces, finds k by an exact quadratic pass over the members instead.
// The member at position k is then selected one key at a time and the
// scores at or before it summed.
//
// What bounds it on an H100: bytes — 13 per member read once (feasible,
// score, avail, prev) plus the outputs; this first version re-reads each
// region some 10-25 times (one pass per digit of each selection) and
// serialises its histograms through shared-memory atomics, so it runs well
// above that bound. Built by karmada_tpu_torch/kernels/build.py with nvcc
// for sm_90a and called through the plain C entry point at the bottom
// (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kWeightUnit = 1000;
constexpr unsigned long long kNoPos = ~0ull;

struct Params {
  const uint8_t* feas;  // [B,C] dense-filter outputs
  const int32_t* score;
  const int32_t* avail;
  const int32_t* prev;
  int C;
  const int32_t* rows;      // [S] batch row of each output row
  const int64_t* replicas;  // [S]
  const int64_t* need;      // [S]
  const int64_t* target;    // [S]
  const uint8_t* dup;       // [S]
  const int32_t* perm;      // [Cp] permuted -> original column
  const int32_t* seg_start;  // [R]
  const int32_t* seg_end;    // [R]
  const int32_t* rank_p;     // [Cp] name rank of each permuted column
  int R;
  int64_t* weight;      // [S,R]
  int32_t* value;       // [S,R]
  int64_t* avail_sum;   // [S,R]
  int32_t* feas_count;  // [S]
};

struct Shared : RadixShared {
  long long min_av;
  unsigned long long kpos;
};

struct Key3 {
  uint64_t a, b;
  int c;
};

__global__ void __launch_bounds__(kThreads)
group_score_kernel(Params p) {
  __shared__ Shared s;
  const int nb = p.R > 0 ? p.R : 1;
  const int row = blockIdx.x / nb;
  const int g = blockIdx.x % nb;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)p.rows[row] * p.C;

  if (g == 0) {  // the row's feasible count over the whole fleet
    uint64_t n = 0;
    for (int c = tid; c < p.C; c += blockDim.x) n += p.feas[base + c] != 0 ? 1 : 0;
    n = block_sum(s, n);
    if (tid == 0) p.feas_count[row] = (int32_t)n;
  }
  if (g >= p.R) return;

  const int lo = p.seg_start[g];
  const int w = p.seg_end[g] > lo ? p.seg_end[g] - lo : 0;
  auto col = [&](int i) { return (int64_t)p.perm[lo + i]; };
  auto member = [&](int i) { return p.feas[base + col(i)] != 0; };
  auto av_of = [&](int i) {
    const int64_t c = col(i);
    return (int64_t)p.avail[base + c] + (int64_t)p.prev[base + c];
  };
  auto sc_of = [&](int i) { return (int64_t)p.score[base + col(i)]; };
  // the sortClusters order, one key at a time, each ascending
  auto a_of = [&](int i) { return neg_key(sc_of(i)); };
  auto b_of = [&](int i) { return neg_key(av_of(i)); };
  auto c_of = [&](int i) { return (uint64_t)p.rank_p[lo + i]; };

  // ---- pass 1: the order-free sums ----
  const int64_t reps = p.replicas[row];
  if (tid == 0) s.min_av = 0;
  uint64_t val = 0, av_sum = 0, sc_sum = 0, cnt = 0, sc_dup = 0;
  long long min_av = 0;
  for (int i = tid; i < w; i += blockDim.x) {
    if (!member(i)) continue;
    const int64_t av = av_of(i), sc = sc_of(i);
    ++val;
    av_sum += (uint64_t)av;
    sc_sum += (uint64_t)sc;
    if (av >= reps) {
      ++cnt;
      sc_dup += (uint64_t)sc;
    }
    min_av = av < min_av ? av : min_av;
  }
  __syncthreads();
  atomicMin(&s.min_av, min_av);
  val = block_sum(s, val);
  av_sum = block_sum(s, av_sum);
  sc_sum = block_sum(s, sc_sum);
  cnt = block_sum(s, cnt);
  sc_dup = block_sum(s, sc_dup);  // its barriers also publish min_av

  const int64_t value = (int64_t)val, asum = (int64_t)av_sum;
  const int64_t tgt = p.target[row];
  int64_t weight = 0;
  if (value == 0) {
    weight = 0;
  } else if (p.dup[row] != 0) {
    weight = cnt > 0 ? (int64_t)cnt * kWeightUnit + floordiv((int64_t)sc_dup, (int64_t)cnt) : 0;
  } else if (asum < tgt) {
    weight = asum * kWeightUnit + floordiv((int64_t)sc_sum, value);
  } else {
    // ---- the first position k with k + 1 >= need and prefix av >= tgt ----
    const int64_t need = p.need[row];
    const uint64_t k_need = need > 1 ? (uint64_t)(need - 1) : 0;
    uint64_t k = kNoPos;
    if (s.min_av >= 0) {
      // monotone prefix: k = max(need - 1, k_t), k_t the position of the
      // member whose prefix first reaches tgt (0 when tgt <= 0)
      uint64_t k_t = 0;
      if (tgt > 0) {
        auto w_of = [&](int i) { return (uint64_t)av_of(i); };
        const Walk w1 = weighted_walk(s, w, tgt, a_of, w_of, member);
        const uint64_t a0 = w1.v;
        auto in_a = [&](int i) { return member(i) && a_of(i) == a0; };
        const Walk w2 = weighted_walk(s, w, tgt - w1.rank, b_of, w_of, in_a);
        const uint64_t b0 = w2.v;
        auto in_ab = [&](int i) { return in_a(i) && b_of(i) == b0; };
        const Walk w3 = weighted_walk(s, w, tgt - w1.rank - w2.rank, c_of, w_of, in_ab);
        k_t = w1.before + w2.before + w3.before;
      }
      k = k_t > k_need ? k_t : k_need;
      if (k >= (uint64_t)value) k = kNoPos;
    } else {
      // a negative av: every member's position and inclusive prefix, exactly
      if (tid == 0) s.kpos = kNoPos;
      __syncthreads();
      for (int j = tid; j < w; j += blockDim.x) {
        if (!member(j)) continue;
        const uint64_t aj = a_of(j), bj = b_of(j);
        const int cj = (int)c_of(j);
        uint64_t pos = 0;
        int64_t incl = 0;
        for (int i = 0; i < w; ++i) {
          if (!member(i)) continue;
          if (triple_le(a_of(i), b_of(i), (int)c_of(i), aj, bj, cj)) {
            incl += av_of(i);
            pos += i != j ? 1 : 0;
          }
        }
        if (pos + 1 >= (uint64_t)(need > 0 ? need : 0) && incl >= tgt) {
          atomicMin(&s.kpos, (unsigned long long)pos);
        }
      }
      __syncthreads();
      k = s.kpos;
    }
    int64_t sc_at = (int64_t)sc_sum, denom = value;
    if (k != kNoPos) {
      // the member at position k, one key at a time, then the scores up to it
      uint64_t m = k + 1, less;
      Key3 kk;
      kk.a = select_kth(s, w, m, a_of, member, &less);
      m -= less;
      const uint64_t a0 = kk.a;
      auto in_a = [&](int i) { return member(i) && a_of(i) == a0; };
      kk.b = select_kth(s, w, m, b_of, in_a, &less);
      m -= less;
      const uint64_t b0 = kk.b;
      kk.c = (int)select_kth(
          s, w, m, c_of, [&](int i) { return in_a(i) && b_of(i) == b0; }, &less);
      uint64_t acc = 0;
      for (int i = tid; i < w; i += blockDim.x) {
        if (member(i) && triple_le(a_of(i), b_of(i), (int)c_of(i), kk.a, kk.b, kk.c)) {
          acc += (uint64_t)sc_of(i);
        }
      }
      sc_at = (int64_t)block_sum(s, acc);
      denom = (int64_t)k + 1;
    }
    weight = tgt * kWeightUnit + floordiv(sc_at, denom);
  }
  if (tid == 0) {
    const int64_t o = (int64_t)row * p.R + g;
    p.weight[o] = weight;
    p.value[o] = (int32_t)value;
    p.avail_sum[o] = asum;
  }
}

}  // namespace

extern "C" int group_score_launch(
    const void* feas, const void* score, const void* avail, const void* prev, int C,
    const void* rows, int S, const void* replicas, const void* need, const void* target,
    const void* dup, const void* perm, const void* seg_start, const void* seg_end,
    const void* rank_p, int R, void* weight, void* value, void* avail_sum, void* feas_count,
    void* stream) {
  if (S <= 0 || C <= 0 || R < 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.feas = static_cast<const uint8_t*>(feas);
  p.score = static_cast<const int32_t*>(score);
  p.avail = static_cast<const int32_t*>(avail);
  p.prev = static_cast<const int32_t*>(prev);
  p.C = C;
  p.rows = static_cast<const int32_t*>(rows);
  p.replicas = static_cast<const int64_t*>(replicas);
  p.need = static_cast<const int64_t*>(need);
  p.target = static_cast<const int64_t*>(target);
  p.dup = static_cast<const uint8_t*>(dup);
  p.perm = static_cast<const int32_t*>(perm);
  p.seg_start = static_cast<const int32_t*>(seg_start);
  p.seg_end = static_cast<const int32_t*>(seg_end);
  p.rank_p = static_cast<const int32_t*>(rank_p);
  p.R = R;
  p.weight = static_cast<int64_t*>(weight);
  p.value = static_cast<int32_t*>(value);
  p.avail_sum = static_cast<int64_t*>(avail_sum);
  p.feas_count = static_cast<int32_t*>(feas_count);
  const int64_t blocks = (int64_t)S * (R > 0 ? R : 1);
  group_score_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
