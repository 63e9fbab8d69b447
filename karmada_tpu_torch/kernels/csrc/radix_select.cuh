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
