// radix_select.cuh: block-wide order statistics over a row without sorting
// it, shared by the kernels that select inside rows too wide to sort in
// shared memory (dense_tail.cu, group_score.cu).
//
// Every helper is called by all threads of a block. A helper visits the
// items 0..n-1 of its caller (columns of a row, members of a region) through
// two callables: `key_of(i)`, an unsigned 64-bit key in the order wanted,
// and `member(i)`, whether item i takes part. Selections are MSB-first radix
// selects with 8-bit digit histograms in shared memory, over keys rebased to
// the members' key range so that small ranges take few passes; each pass
// re-reads the items from global memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr uint64_t kSign = 1ull << 63;

struct RadixShared {
  unsigned long long acc[3];
  unsigned long long sel[4];
  unsigned int hist[256];
  unsigned long long wsum[256];
};

__device__ __forceinline__ uint64_t neg_key(int64_t v) {  // ascending -v
  return (0ull - (uint64_t)v) ^ kSign;
}

__device__ __forceinline__ int64_t wrap_mul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}

__device__ __forceinline__ int32_t wrap_i32(int64_t v) {
  return (int32_t)(uint32_t)(uint64_t)v;
}

// floor division for b >= 1 (torch's floor division on int64)
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && (a < 0)) q -= 1;
  return q;
}

// true when r and prefix agree on every bit at position >= s
__device__ __forceinline__ bool same_above(uint64_t r, uint64_t prefix, int s) {
  return s >= 64 || ((r ^ prefix) >> s) == 0;
}

__device__ __forceinline__ int bit_length(uint64_t v) {
  return v == 0 ? 0 : 64 - __clzll((long long)v);
}

__device__ __forceinline__ bool triple_le(uint64_t a, uint64_t b, int c, uint64_t a0,
                                          uint64_t b0, int c0) {
  if (a != a0) return a < a0;
  if (b != b0) return b < b0;
  return c <= c0;
}

// Block-wide wrapping sum; every thread gets the total.
__device__ inline uint64_t block_sum(RadixShared& s, uint64_t v) {
  __syncthreads();
  if (threadIdx.x == 0) s.acc[0] = 0;
  __syncthreads();
  atomicAdd(&s.acc[0], (unsigned long long)v);
  __syncthreads();
  return s.acc[0];
}

// Range [lo, hi] and count of the member keys (lo > hi when none).
template <class Key, class Member>
__device__ void key_range(RadixShared& s, int C, Key key_of, Member member, uint64_t* lo_out,
                          uint64_t* hi_out, uint64_t* count_out) {
  __syncthreads();
  if (threadIdx.x == 0) {
    s.acc[0] = ~0ull;
    s.acc[1] = 0;
    s.acc[2] = 0;
  }
  __syncthreads();
  uint64_t lo = ~0ull, hi = 0, cnt = 0;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    if (!member(c)) continue;
    const uint64_t v = key_of(c);
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
    ++cnt;
  }
  atomicMin(&s.acc[0], (unsigned long long)lo);
  atomicMax(&s.acc[1], (unsigned long long)hi);
  atomicAdd(&s.acc[2], (unsigned long long)cnt);
  __syncthreads();
  *lo_out = s.acc[0];
  *hi_out = s.acc[1];
  *count_out = s.acc[2];
}

// The k-th smallest member key (1 <= k <= member count) by an MSB-first
// radix select; *less gets the number of members strictly below it.
template <class Key, class Member>
__device__ uint64_t select_kth(RadixShared& s, int C, uint64_t k, Key key_of, Member member,
                               uint64_t* less) {
  uint64_t lo, hi, cnt;
  key_range(s, C, key_of, member, &lo, &hi, &cnt);
  const int bits = hi > lo ? bit_length(hi - lo) : 0;
  uint64_t prefix = 0, kk = k, below = 0;
  for (int shift = ((bits + 7) / 8 - 1) * 8; shift >= 0; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) s.hist[d] = 0;
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      if (!member(c)) continue;
      const uint64_t r = key_of(c) - lo;
      if (same_above(r, prefix, shift + 8)) atomicAdd(&s.hist[(r >> shift) & 255], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint64_t cum = 0;
      int d = 0;
      for (; d < 255; ++d) {
        if (cum + s.hist[d] >= kk) break;
        cum += s.hist[d];
      }
      s.sel[0] = (unsigned long long)d;
      s.sel[1] = cum;
    }
    __syncthreads();
    prefix |= (uint64_t)s.sel[0] << shift;
    kk -= s.sel[1];
    below += s.sel[1];
  }
  *less = below;
  return lo + prefix;
}

struct Walk {
  bool found;
  uint64_t v;       // the boundary key
  int64_t rank;     // its weighted rank: the sum of member weights below it
  uint64_t before;  // members strictly below it
  uint64_t n;       // members equal to it
};

// The largest member key v whose weighted rank (the sum of the weights of
// the members with a smaller key) is below tgt. Weights must be
// non-negative with a sum that fits int64, so the rank is monotone in the
// key and the walk keeps, at every digit, the last bucket that starts
// below tgt.
template <class Key, class Weight, class Member>
__device__ Walk weighted_walk(RadixShared& s, int C, int64_t tgt, Key key_of, Weight w_of,
                              Member member) {
  uint64_t lo, hi, cnt;
  key_range(s, C, key_of, member, &lo, &hi, &cnt);
  Walk out;
  out.found = cnt > 0 && 0 < tgt;
  out.v = lo;
  out.rank = 0;
  out.before = 0;
  out.n = cnt;
  if (!out.found) return out;
  const int bits = hi > lo ? bit_length(hi - lo) : 0;
  uint64_t prefix = 0;
  for (int shift = ((bits + 7) / 8 - 1) * 8; shift >= 0; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) {
      s.hist[d] = 0;
      s.wsum[d] = 0;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      if (!member(c)) continue;
      const uint64_t r = key_of(c) - lo;
      if (!same_above(r, prefix, shift + 8)) continue;
      const int d = (int)((r >> shift) & 255);
      atomicAdd(&s.hist[d], 1u);
      atomicAdd(&s.wsum[d], (unsigned long long)w_of(c));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int64_t rank = out.rank;
      uint64_t before = out.before;
      int best = 0;
      int64_t best_rank = rank;
      uint64_t best_before = before;
      for (int d = 0; d < 256; ++d) {
        if (s.hist[d] > 0 && rank < tgt) {
          best = d;
          best_rank = rank;
          best_before = before;
        }
        rank += (int64_t)s.wsum[d];
        before += s.hist[d];
      }
      s.sel[0] = (unsigned long long)best;
      s.sel[1] = (unsigned long long)best_rank;
      s.sel[2] = best_before;
      s.sel[3] = s.hist[best];
    }
    __syncthreads();
    prefix |= (uint64_t)s.sel[0] << shift;
    out.rank = (int64_t)s.sel[1];
    out.before = s.sel[2];
    out.n = s.sel[3];
  }
  out.v = lo + prefix;
  return out;
}

// ---------------------------------------------------------------------------
// Rows staged in shared memory (dense_tail.cu's shared-memory route).
//
// The same selections over items a block already holds in shared memory, so
// a pass costs no device-memory traffic. Every sweep visits item c = c0 +
// threadIdx.x for c0 = 0, blockDim.x, ... (warp-uniform, so the warp
// intrinsics see every lane). Histograms take one shared-memory atomic per
// distinct digit of a warp (__match_any_sync groups the lanes), not one per
// item; the digit is chosen by warp 0 in parallel (eight bins a lane and a
// shuffle scan), which also zeroes the bins for the next pass (the bins are
// zero at every entry: the caller zeroes them once). A pass that leaves a
// single member in its bucket ends the selection: one more sweep reads that
// member's key and item. The k-th member in item order takes one sweep of
// ballots and a scan of the ballot words.

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;

struct SmemSelect {
  unsigned int hist[256];
  unsigned long long wsum[256];
  unsigned long long red[kMaxWarps][4];
  unsigned long long sel_u[4];
  long long sel_i[2];
};

struct Sel {
  uint64_t key;   // the selected key
  uint64_t less;  // members strictly below it
  int item;       // its item when it is the only member with that key, else -1
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }
__device__ __forceinline__ int n_warps() { return blockDim.x >> 5; }

__device__ __forceinline__ uint64_t warp_sum_u64(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ uint64_t warp_min_u64(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t t = __shfl_xor_sync(kFull, v, o);
    v = t < v ? t : v;
  }
  return v;
}

__device__ __forceinline__ uint64_t warp_max_u64(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t t = __shfl_xor_sync(kFull, v, o);
    v = t > v ? t : v;
  }
  return v;
}

__device__ __forceinline__ int64_t warp_min_i64(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t t = __shfl_xor_sync(kFull, v, o);
    v = t < v ? t : v;
  }
  return v;
}

// Block-wide wrapping sums of N values (N <= 4); every thread gets them.
template <int N>
__device__ void smem_sums(SmemSelect& s, uint64_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum_u64(v[i]);
  if (lane_id() == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) s.red[warp_id()][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t t = 0;
    for (int w = 0; w < n_warps(); ++w) t += s.red[w][i];
    v[i] = t;
  }
  __syncthreads();
}

__device__ __forceinline__ uint64_t smem_sum(SmemSelect& s, uint64_t v) {
  uint64_t a[1] = {v};
  smem_sums<1>(s, a);
  return a[0];
}

// Range [lo, hi] and count of the member keys (lo > hi when none).
template <class Key, class Member>
__device__ void smem_range(SmemSelect& s, int n, Key key_of, Member member, uint64_t* lo_out,
                           uint64_t* hi_out, uint64_t* count_out) {
  uint64_t lo = ~0ull, hi = 0, cnt = 0;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    if (!member(c)) continue;
    const uint64_t v = key_of(c);
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
    ++cnt;
  }
  lo = warp_min_u64(lo);
  hi = warp_max_u64(hi);
  cnt = warp_sum_u64(cnt);
  if (lane_id() == 0) {
    s.red[warp_id()][0] = lo;
    s.red[warp_id()][1] = hi;
    s.red[warp_id()][2] = cnt;
  }
  __syncthreads();
  lo = ~0ull;
  hi = 0;
  cnt = 0;
  for (int w = 0; w < n_warps(); ++w) {
    lo = s.red[w][0] < lo ? s.red[w][0] : lo;
    hi = s.red[w][1] > hi ? s.red[w][1] : hi;
    cnt += s.red[w][2];
  }
  __syncthreads();
  *lo_out = lo;
  *hi_out = hi;
  *count_out = cnt;
}

// One shared-memory increment per distinct digit of the warp's lanes that
// take part (all 32 lanes call it).
__device__ __forceinline__ void hist_add(SmemSelect& s, bool part, unsigned d) {
  const unsigned peers = __match_any_sync(kFull, part ? d : kFull);
  if (part && __ffs(peers) - 1 == lane_id()) atomicAdd(&s.hist[d], (unsigned)__popc(peers));
}

// hist_add with each digit's weight sum beside its count (w < 2^32): the
// lanes of one digit sum their weights in two 16-bit halves
// (__reduce_add_sync over the digit's lanes), so one lane adds the group's
// count and sum, not each lane its own 64-bit weight (a 64-bit shared
// atomic add is a compare-and-swap loop, which a hot bin serialises).
__device__ __forceinline__ void hist_add_weighted(SmemSelect& s, bool part, unsigned d,
                                                  uint64_t w) {
  const unsigned peers = __match_any_sync(kFull, part ? d : kFull);
  const unsigned lo = __reduce_add_sync(peers, part ? (unsigned)(w & 0xffffu) : 0u);
  const unsigned hi = __reduce_add_sync(peers, part ? (unsigned)(w >> 16) : 0u);
  if (part && __ffs(peers) - 1 == lane_id()) {
    atomicAdd(&s.hist[d], (unsigned)__popc(peers));
    const uint64_t sum = ((uint64_t)hi << 16) + lo;
    if (sum != 0) atomicAdd(&s.wsum[d], (unsigned long long)sum);
  }
}

// Warp 0: the digit whose bucket holds the kk-th member; writes (digit,
// members below it, members in it) to sel_u[0..2] and zeroes the bins.
__device__ void pick_digit(SmemSelect& s, uint64_t kk) {
  if (warp_id() != 0) return;
  const int lane = lane_id();
  unsigned h[8];
  uint64_t local = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = s.hist[8 * lane + j];
    local += h[j];
  }
  uint64_t incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  const uint64_t excl = incl - local;
  const uint64_t total = __shfl_sync(kFull, incl, 31);
  if (kk > total) {  // no bucket reaches kk (no caller asks): the last digit
    if (lane == 31) {
      s.sel_u[0] = 255;
      s.sel_u[1] = total - h[7];
      s.sel_u[2] = h[7];
    }
  } else if (excl < kk && kk <= incl) {
    // the first of the lane's buckets whose end reaches kk (the last one
    // when none before it does), without indexing h at run time
    uint64_t cum = excl, at = excl;
    int d = 7;
    unsigned hd = h[7];
    bool found = false;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      if (!found && cum + h[j] >= kk) {
        found = true;
        d = j;
        hd = h[j];
        at = cum;
      }
      cum += h[j];
    }
    s.sel_u[0] = (unsigned long long)(8 * lane + d);
    s.sel_u[1] = found ? at : cum;
    s.sel_u[2] = hd;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) s.hist[8 * lane + j] = 0;
}

// The k-th smallest member key (1 <= k <= member count).
template <class Key, class Member>
__device__ Sel smem_select(SmemSelect& s, int n, uint64_t k, Key key_of, Member member) {
  uint64_t lo, hi, cnt;
  smem_range(s, n, key_of, member, &lo, &hi, &cnt);
  Sel out;
  out.item = -1;
  const int bits = hi > lo ? bit_length(hi - lo) : 0;
  uint64_t prefix = 0, kk = k, below = 0;
  for (int shift = ((bits + 7) / 8 - 1) * 8; shift >= 0; shift -= 8) {
    for (int c0 = 0; c0 < n; c0 += blockDim.x) {
      const int c = c0 + threadIdx.x;
      bool part = false;
      unsigned d = 0;
      if (c < n && member(c)) {
        const uint64_t r = key_of(c) - lo;
        if (same_above(r, prefix, shift + 8)) {
          part = true;
          d = (unsigned)((r >> shift) & 255);
        }
      }
      hist_add(s, part, d);
    }
    __syncthreads();
    pick_digit(s, kk);
    __syncthreads();
    prefix |= (uint64_t)s.sel_u[0] << shift;
    kk -= s.sel_u[1];
    below += s.sel_u[1];
    if (s.sel_u[2] == 1) {  // one member left: read it
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        if (member(c)) {
          const uint64_t v = key_of(c);
          if (same_above(v - lo, prefix, shift)) {
            s.sel_u[3] = v;
            s.sel_i[0] = c;
          }
        }
      }
      __syncthreads();
      out.key = s.sel_u[3];
      out.item = (int)s.sel_i[0];
      out.less = below;
      return out;
    }
  }
  out.key = lo + prefix;
  out.less = below;
  return out;
}

// The item of the k-th member in item order (1 <= k <= member count);
// `words` holds ceil(n / 32) ballot words of scratch.
template <class Member>
__device__ int smem_nth(SmemSelect& s, unsigned* words, int n, uint64_t k, Member member) {
  for (int c0 = 0; c0 < n; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const unsigned b = __ballot_sync(kFull, c < n && member(c));
    const int first = c0 + 32 * warp_id();
    if (lane_id() == 0 && first < n) words[first >> 5] = b;
  }
  __syncthreads();
  if (warp_id() == 0) {
    const int lane = lane_id();
    const int nw = (n + 31) >> 5;
    const int per = (nw + 31) >> 5;
    const int w0 = lane * per, w1 = min(nw, w0 + per);
    uint64_t local = 0;
    for (int w = w0; w < w1; ++w) local += __popc(words[w]);
    uint64_t incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    uint64_t cum = incl - local;
    if (cum < k && k <= incl) {
      for (int w = w0; w < w1; ++w) {
        unsigned m = words[w];
        const uint64_t p = (uint64_t)__popc(m);
        if (cum + p >= k) {
          for (uint64_t i = cum + 1; i < k; ++i) m &= m - 1;  // drop the lower members
          s.sel_i[1] = 32 * w + __ffs(m) - 1;
          break;
        }
        cum += p;
      }
    }
  }
  __syncthreads();
  return (int)s.sel_i[1];
}

// weighted_walk over staged items: the largest member key v whose weighted
// rank is below tgt (weights in [0, 2^32)).
template <class Key, class Weight, class Member>
__device__ Walk smem_walk(SmemSelect& s, int n, int64_t tgt, Key key_of, Weight w_of,
                          Member member) {
  uint64_t lo, hi, cnt;
  smem_range(s, n, key_of, member, &lo, &hi, &cnt);
  Walk out;
  out.found = cnt > 0 && 0 < tgt;
  out.v = lo;
  out.rank = 0;
  out.before = 0;
  out.n = cnt;
  if (!out.found) return out;
  const int bits = hi > lo ? bit_length(hi - lo) : 0;
  uint64_t prefix = 0;
  for (int shift = ((bits + 7) / 8 - 1) * 8; shift >= 0; shift -= 8) {
    for (int c0 = 0; c0 < n; c0 += blockDim.x) {
      const int c = c0 + threadIdx.x;
      bool part = false;
      unsigned d = 0;
      uint64_t w = 0;
      if (c < n && member(c)) {
        const uint64_t r = key_of(c) - lo;
        if (same_above(r, prefix, shift + 8)) {
          part = true;
          d = (unsigned)((r >> shift) & 255);
          w = w_of(c);
        }
      }
      hist_add_weighted(s, part, d, w);
    }
    __syncthreads();
    if (warp_id() == 0) {
      const int lane = lane_id();
      unsigned h[8];
      uint64_t ws[8];
      uint64_t lw = 0, lc = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[j] = s.hist[8 * lane + j];
        ws[j] = s.wsum[8 * lane + j];
        lw += ws[j];
        lc += h[j];
      }
      uint64_t iw = lw, ic = lc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint64_t tw = __shfl_up_sync(kFull, iw, o);
        const uint64_t tc = __shfl_up_sync(kFull, ic, o);
        if (lane >= o) {
          iw += tw;
          ic += tc;
        }
      }
      // the lane's last bucket that is nonempty and starts below tgt
      int64_t rank = out.rank + (int64_t)(iw - lw);
      uint64_t before = out.before + (ic - lc);
      int best = -1;
      int64_t best_rank = 0;
      uint64_t best_before = 0;
      unsigned best_n = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (h[j] > 0 && rank < tgt) {
          best = 8 * lane + j;
          best_rank = rank;
          best_before = before;
          best_n = h[j];
        }
        rank += (int64_t)ws[j];
        before += h[j];
      }
      const unsigned top = __reduce_max_sync(kFull, (unsigned)(best + 1));
      if (top == 0) {  // none: the walk's first bucket, as the row-reading walk
        if (lane == 0) {
          s.sel_u[0] = 0;
          s.sel_u[1] = (unsigned long long)out.rank;
          s.sel_u[2] = out.before;
          s.sel_u[3] = h[0];
        }
      } else if ((unsigned)(best + 1) == top) {
        s.sel_u[0] = (unsigned long long)best;
        s.sel_u[1] = (unsigned long long)best_rank;
        s.sel_u[2] = best_before;
        s.sel_u[3] = best_n;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s.hist[8 * lane + j] = 0;
        s.wsum[8 * lane + j] = 0;
      }
    }
    __syncthreads();
    prefix |= (uint64_t)s.sel_u[0] << shift;
    out.rank = (int64_t)s.sel_u[1];
    out.before = s.sel_u[2];
    out.n = s.sel_u[3];
  }
  out.v = lo + prefix;
  return out;
}
