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
// Only the position k and the score sum up to it depend on the order. With
// non-negative availability the prefix sum is monotone, so k is
// max(need - 1, k_t) with k_t the first position whose prefix reaches the
// target: a weighted digit walk finds k_t one key of the (score, av, rank)
// tuple at a time (the tuple is compared exactly; it does not fit one
// 64-bit key). A row with a negative av in a region, which no encoded batch
// produces, finds k by an exact quadratic pass over the members instead.
// The member at position k is then selected one key at a time and the
// scores at or before it summed.
//
// Two routes, one body (divided_weight, over either set of selections):
//   - staged (regions of at most kStageMax = 1024 columns, every region of
//     configs 4 and 4b but 4b's 3 000-column mega region): the block reads
//     the region once, perm coalesced and the four filter outputs gathered
//     through it, and compacts its feasible members into dynamic shared
//     memory (av int64, score and name rank int32: 16 bytes a member); every
//     walk and selection then runs there (radix_select.cuh's smem_walk and
//     smem_select: warp-aggregated histograms, a shuffle-scan digit pick,
//     no device-memory traffic);
//   - re-reading (wider regions, or every region with route 1): the walks
//     and selections re-read the members through perm on every digit pass
//     (weighted_walk, select_kth).
// The row's feasible count comes from blocks of their own after the
// (row, region) blocks, a warp per row reading its C bytes 16 at a time
// (regions need not cover the fleet: regionless and padded columns count).
//
// What bounds it on an H100: bytes — 13 per member read once (feasible,
// score, avail, prev) plus the outputs and each row's C feasible bytes.
// 128-thread blocks: a config-4 region holds some 300 members, so a wider
// block would idle, and the small blocks keep some 11 blocks an SM in
// flight over hundreds of rows x 16-31 regions. Built by
// karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and called
// through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStageMax = 1024;  // members a block stages in shared memory
constexpr int kCountWarps = kThreads / 32;  // rows per feasible-count block
constexpr int64_t kWeightUnit = 1000;
constexpr unsigned long long kNoPos = ~0ull;

struct Params {
  const uint8_t* feas;  // [B,C] dense-filter outputs
  const int32_t* score;
  const int32_t* avail;
  const int32_t* prev;
  int C;
  const int32_t* rows;      // [S] batch row of each output row
  int S;
  const int64_t* replicas;  // [S]
  const int64_t* need;      // [S]
  const int64_t* target;    // [S]
  const uint8_t* dup;       // [S]
  const int32_t* perm;      // [Cp] permuted -> original column
  const int32_t* seg_start;  // [R]
  const int32_t* seg_end;    // [R]
  const int32_t* rank_p;     // [Cp] name rank of each permuted column
  int R;
  int stage_cap;  // widest region staged (0: every region re-read)
  int64_t* weight;      // [S,R]
  int32_t* value;       // [S,R]
  int64_t* avail_sum;   // [S,R]
  int32_t* feas_count;  // [S]
};

union SelectShared {
  RadixShared r;
  SmemSelect m;
};

struct Shared {
  SelectShared u;
  long long min_av;
  unsigned long long kpos;
  unsigned int n;
};

// The order statistics over the members a route can see.
struct Reread {
  RadixShared& s;
  template <class K, class W, class M>
  __device__ Walk walk(int n, int64_t tgt, K key, W w, M m) {
    return weighted_walk(s, n, tgt, key, w, m);
  }
  template <class K, class M>
  __device__ uint64_t kth(int n, uint64_t k, K key, M m, uint64_t* less) {
    return select_kth(s, n, k, key, m, less);
  }
  __device__ uint64_t sum(uint64_t v) { return block_sum(s, v); }
};

struct Staged {
  SmemSelect& s;
  template <class K, class W, class M>
  __device__ Walk walk(int n, int64_t tgt, K key, W w, M m) {
    return smem_walk(s, n, tgt, key, w, m);
  }
  template <class K, class M>
  __device__ uint64_t kth(int n, uint64_t k, K key, M m, uint64_t* less) {
    const Sel r = smem_select(s, n, k, key, m);
    *less = r.less;
    return r.key;
  }
  __device__ uint64_t sum(uint64_t v) { return smem_sum(s, v); }
};

// The Divided weight of a region whose availability reaches the target:
// items 0..n-1 with `member`, score `sc_of`, availability `av_of` and name
// rank `rk_of`; value > 0 members; nonneg: no member has av < 0.
template <class Ops, class M, class Sc, class Av, class Rk>
__device__ int64_t divided_weight(Ops ops, Shared& s, int n, M member, Sc sc_of, Av av_of,
                                  Rk rk_of, int64_t value, int64_t sc_sum, int64_t tgt,
                                  int64_t need, bool nonneg) {
  // the sortClusters order, one key at a time, each ascending
  auto a_of = [&](int i) { return neg_key(sc_of(i)); };
  auto b_of = [&](int i) { return neg_key(av_of(i)); };
  auto c_of = [&](int i) { return (uint64_t)rk_of(i); };
  const uint64_t k_need = need > 1 ? (uint64_t)(need - 1) : 0;
  uint64_t k = kNoPos;
  if (nonneg) {
    // monotone prefix: k = max(need - 1, k_t), k_t the position of the
    // member whose prefix first reaches tgt (0 when tgt <= 0)
    uint64_t k_t = 0;
    if (tgt > 0) {
      auto w_of = [&](int i) { return (uint64_t)av_of(i); };
      const Walk w1 = ops.walk(n, tgt, a_of, w_of, member);
      const uint64_t a0 = w1.v;
      auto in_a = [&](int i) { return member(i) && a_of(i) == a0; };
      const Walk w2 = ops.walk(n, tgt - w1.rank, b_of, w_of, in_a);
      const uint64_t b0 = w2.v;
      auto in_ab = [&](int i) { return in_a(i) && b_of(i) == b0; };
      const Walk w3 = ops.walk(n, tgt - w1.rank - w2.rank, c_of, w_of, in_ab);
      k_t = w1.before + w2.before + w3.before;
    }
    k = k_t > k_need ? k_t : k_need;
    if (k >= (uint64_t)value) k = kNoPos;
  } else {
    // a negative av: every member's position and inclusive prefix, exactly
    if (threadIdx.x == 0) s.kpos = kNoPos;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      if (!member(j)) continue;
      const uint64_t aj = a_of(j), bj = b_of(j);
      const int cj = (int)c_of(j);
      uint64_t pos = 0;
      int64_t incl = 0;
      for (int i = 0; i < n; ++i) {
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
  int64_t sc_at = sc_sum, denom = value;
  if (k != kNoPos) {
    // the member at position k, one key at a time, then the scores up to it
    uint64_t m = k + 1, less;
    const uint64_t ka = ops.kth(n, m, a_of, member, &less);
    m -= less;
    auto in_a = [&](int i) { return member(i) && a_of(i) == ka; };
    const uint64_t kb = ops.kth(n, m, b_of, in_a, &less);
    m -= less;
    const int kc = (int)ops.kth(
        n, m, c_of, [&](int i) { return in_a(i) && b_of(i) == kb; }, &less);
    uint64_t acc = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (member(i) && triple_le(a_of(i), b_of(i), (int)c_of(i), ka, kb, kc)) {
        acc += (uint64_t)sc_of(i);
      }
    }
    sc_at = (int64_t)ops.sum(acc);
    denom = (int64_t)k + 1;
  }
  return tgt * kWeightUnit + floordiv(sc_at, denom);
}

// The weight from the order-free sums, or from divided_weight.
template <class Div>
__device__ int64_t region_weight(const Params& p, int row, int64_t value, int64_t asum,
                                 uint64_t sc_sum, uint64_t cnt, uint64_t sc_dup, Div divided) {
  if (value == 0) return 0;
  if (p.dup[row] != 0) {
    return cnt > 0 ? (int64_t)cnt * kWeightUnit + floordiv((int64_t)sc_dup, (int64_t)cnt) : 0;
  }
  const int64_t tgt = p.target[row];
  if (asum < tgt) return asum * kWeightUnit + floordiv((int64_t)sc_sum, value);
  return divided(tgt);
}

// The row's feasible count, a warp per row: 16-byte loads between an
// unaligned head and tail.
__device__ void count_rows(const Params& p, int blk) {
  const int row = blk * kCountWarps + warp_id();
  if (row >= p.S) return;
  const int lane = lane_id();
  const uint8_t* f = p.feas + (int64_t)p.rows[row] * p.C;
  int head = (int)((16 - ((uintptr_t)f & 15)) & 15);
  head = head < p.C ? head : p.C;
  const int nv = (p.C - head) >> 4;
  unsigned n = 0;
  for (int c = lane; c < head; c += 32) n += f[c] != 0 ? 1 : 0;
  const uint4* v = reinterpret_cast<const uint4*>(f + head);
  auto nonzero_bytes = [](unsigned x) {
    x |= x >> 4;
    x |= x >> 2;
    x |= x >> 1;
    return (unsigned)__popc(x & 0x01010101u);
  };
  for (int i = lane; i < nv; i += 32) {
    const uint4 x = v[i];
    n += nonzero_bytes(x.x) + nonzero_bytes(x.y) + nonzero_bytes(x.z) + nonzero_bytes(x.w);
  }
  for (int c = head + 16 * nv + lane; c < p.C; c += 32) n += f[c] != 0 ? 1 : 0;
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
  if (lane == 0) p.feas_count[row] = (int32_t)n;
}

__global__ void __launch_bounds__(kThreads)
group_score_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared s;
  const int64_t pairs = (int64_t)p.S * p.R;
  if ((int64_t)blockIdx.x >= pairs) {
    count_rows(p, (int)(blockIdx.x - pairs));
    return;
  }
  const int row = blockIdx.x / p.R;
  const int g = blockIdx.x % p.R;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)p.rows[row] * p.C;
  const int lo = p.seg_start[g];
  const int w = p.seg_end[g] > lo ? p.seg_end[g] - lo : 0;
  const int64_t reps = p.replicas[row];
  if (tid == 0) {
    s.min_av = 0;
    s.n = 0;
  }

  int64_t value, asum;
  uint64_t sums[4];  // av, score, Duplicated count, Duplicated score
  int64_t weight;
  if (w <= p.stage_cap) {
    // ---- staged: the feasible members compacted into shared memory ----
    int64_t* st_av = reinterpret_cast<int64_t*>(dyn);  // [stage_cap]
    int32_t* st_sc = reinterpret_cast<int32_t*>(st_av + p.stage_cap);
    int32_t* st_rk = st_sc + p.stage_cap;
    for (int d = tid; d < 256; d += blockDim.x) {  // the walks' bins start at zero
      s.u.m.hist[d] = 0;
      s.u.m.wsum[d] = 0;
    }
    __syncthreads();
    uint64_t av_sum = 0, sc_sum = 0, cnt = 0, sc_dup = 0;
    long long min_av = 0;
    for (int i0 = 0; i0 < w; i0 += blockDim.x) {
      const int i = i0 + tid;
      int64_t col = 0;
      bool f = false;
      if (i < w) {
        col = p.perm[lo + i];
        f = p.feas[base + col] != 0;
      }
      const unsigned bal = __ballot_sync(kFull, f);
      unsigned at = 0;
      if (lane_id() == 0 && bal != 0) at = atomicAdd(&s.n, (unsigned)__popc(bal));
      at = __shfl_sync(kFull, at, 0) + __popc(bal & ((1u << lane_id()) - 1u));
      if (f) {
        const int64_t av = (int64_t)p.avail[base + col] + (int64_t)p.prev[base + col];
        const int32_t sc = p.score[base + col];
        st_av[at] = av;
        st_sc[at] = sc;
        st_rk[at] = p.rank_p[lo + i];
        av_sum += (uint64_t)av;
        sc_sum += (uint64_t)(int64_t)sc;
        if (av >= reps) {
          ++cnt;
          sc_dup += (uint64_t)(int64_t)sc;
        }
        min_av = av < min_av ? av : min_av;
      }
    }
    atomicMin(&s.min_av, min_av);
    sums[0] = av_sum;
    sums[1] = sc_sum;
    sums[2] = cnt;
    sums[3] = sc_dup;
    smem_sums<4>(s.u.m, sums);  // its barriers also publish n and min_av
    const int n = (int)s.n;
    value = n;
    asum = (int64_t)sums[0];
    weight = region_weight(p, row, value, asum, sums[1], sums[2], sums[3], [&](int64_t tgt) {
      return divided_weight(
          Staged{s.u.m}, s, n, [](int) { return true; },
          [&](int i) { return (int64_t)st_sc[i]; }, [&](int i) { return st_av[i]; },
          [&](int i) { return st_rk[i]; }, value, (int64_t)sums[1], tgt, p.need[row],
          s.min_av >= 0);
    });
  } else {
    // ---- re-reading: the members through perm on every pass ----
    auto col = [&](int i) { return (int64_t)p.perm[lo + i]; };
    auto member = [&](int i) { return p.feas[base + col(i)] != 0; };
    auto av_of = [&](int i) {
      const int64_t c = col(i);
      return (int64_t)p.avail[base + c] + (int64_t)p.prev[base + c];
    };
    auto sc_of = [&](int i) { return (int64_t)p.score[base + col(i)]; };
    auto rk_of = [&](int i) { return p.rank_p[lo + i]; };
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
    RadixShared& r = s.u.r;
    val = block_sum(r, val);
    sums[0] = block_sum(r, av_sum);
    sums[1] = block_sum(r, sc_sum);
    sums[2] = block_sum(r, cnt);
    sums[3] = block_sum(r, sc_dup);  // its barriers also publish min_av
    value = (int64_t)val;
    asum = (int64_t)sums[0];
    weight = region_weight(p, row, value, asum, sums[1], sums[2], sums[3], [&](int64_t tgt) {
      return divided_weight(Reread{r}, s, w, member, sc_of, av_of, rk_of, value,
                            (int64_t)sums[1], tgt, p.need[row], s.min_av >= 0);
    });
  }
  if (tid == 0) {
    const int64_t o = (int64_t)row * p.R + g;
    p.weight[o] = weight;
    p.value[o] = (int32_t)value;
    p.avail_sum[o] = asum;
  }
}

}  // namespace

// route 0 stages every region of at most kStageMax columns, route 1
// re-reads every region.
extern "C" int group_score_launch(
    const void* feas, const void* score, const void* avail, const void* prev, int C,
    const void* rows, int S, const void* replicas, const void* need, const void* target,
    const void* dup, const void* perm, const void* seg_start, const void* seg_end,
    const void* rank_p, int R, int Cp, int route, void* weight, void* value, void* avail_sum,
    void* feas_count, void* stream) {
  if (S <= 0 || C <= 0 || R < 0 || Cp < 0 || route < 0 || route > 1) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.feas = static_cast<const uint8_t*>(feas);
  p.score = static_cast<const int32_t*>(score);
  p.avail = static_cast<const int32_t*>(avail);
  p.prev = static_cast<const int32_t*>(prev);
  p.C = C;
  p.rows = static_cast<const int32_t*>(rows);
  p.S = S;
  p.replicas = static_cast<const int64_t*>(replicas);
  p.need = static_cast<const int64_t*>(need);
  p.target = static_cast<const int64_t*>(target);
  p.dup = static_cast<const uint8_t*>(dup);
  p.perm = static_cast<const int32_t*>(perm);
  p.seg_start = static_cast<const int32_t*>(seg_start);
  p.seg_end = static_cast<const int32_t*>(seg_end);
  p.rank_p = static_cast<const int32_t*>(rank_p);
  p.R = R;
  // no region is wider than the layout's Cp columns
  p.stage_cap = route == 1 ? 0 : (Cp < kStageMax ? Cp : kStageMax);
  p.weight = static_cast<int64_t*>(weight);
  p.value = static_cast<int32_t*>(value);
  p.avail_sum = static_cast<int64_t*>(avail_sum);
  p.feas_count = static_cast<int32_t*>(feas_count);
  const int64_t blocks = (int64_t)S * R + (S + kCountWarps - 1) / kCountWarps;
  const size_t smem = 16 * (size_t)p.stage_cap;
  group_score_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
