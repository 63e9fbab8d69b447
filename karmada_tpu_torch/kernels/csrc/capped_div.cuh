// capped_div.cuh: floor(x / d) in exact integer arithmetic, without the
// int64 division's software sequence, in two forms.
//
// capped_div: min(lim, floor(x / d)). Shared by filter_common.cuh's
// factor_estimate (the GeneralEstimator's cap // req, answers at or above
// INT32_MAX become the row's replicas: dense_filter.cu's factor pass,
// tiers.cu's estimate) and fleet_estimate.cu (a node's free capacity //
// request, capped by its pods left).
//
// Both callers only need the quotient below a cap lim <= INT32_MAX. So:
// when d > x the quotient is 0; when lim * d <= x (the 128-bit product
// tested through its high word) the quotient is at least lim; otherwise it
// is below lim < 2^31, and one float64 division gets it to within one:
// x and d round to 53 bits and the quotient rounds once, a relative error
// under 2^-51, which at a quotient below 2^31 is under 2^-20 absolute. One
// exact correction step, t * d against x with the product's high word
// checked, then gives the floor. Exact over the whole non-negative int64
// range of x and every d >= 1.
//
// floor_div_rcp: floor(x / d) from the divisor's reciprocal m =
// reciprocal(d) = ceil(2^64 / d), computed once per divisor, for a divisor
// shared by many dividends (filter_common.cuh's factor_estimate_rcp:
// dense_filter.cu's dense-input tables, one request over a tile's
// columns; tiers.cu's per-element routes, one row's request over its
// columns). x m / 2^64 lies in [x / d, x / d +
// x / 2^64), and x < 2^63, so the high word t of x m is floor(x / d) or one
// more; t d <= x + d < 2^64 tells which. Exact for 0 <= x < 2^63 and
// 1 <= d < 2^63 (d = 1, whose m would need 65 bits, has m = 0).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace capped_div {

constexpr int64_t kI32Max = 2147483647;

// min(lim, floor(x / d)) for x >= 0, d >= 1, 0 <= lim <= INT32_MAX.
__device__ __forceinline__ int64_t capped_div(int64_t x, int64_t d, int64_t lim) {
  if (lim <= 0) return 0;
  const uint64_t ux = (uint64_t)x, ud = (uint64_t)d, ul = (uint64_t)lim;
  if (ud > ux) return 0;
  if (__umul64hi(ul, ud) == 0 && ul * ud <= ux) return lim;
  uint64_t t = (uint64_t)((double)ux / (double)ud);
  if (__umul64hi(t, ud) != 0 || t * ud > ux) {
    t -= 1;
  } else if (ux - t * ud >= ud) {
    t += 1;
  }
  return (int64_t)t;
}

// ceil(2^64 / d) for d >= 2 (it fits 64 bits); 0 for d = 1.
__device__ __forceinline__ uint64_t reciprocal(uint64_t d) { return d <= 1 ? 0 : ~0ull / d + 1; }

// floor(x / d) for 0 <= x < 2^63, 1 <= d < 2^63, m = reciprocal(d).
__device__ __forceinline__ uint64_t floor_div_rcp(uint64_t x, uint64_t d, uint64_t m) {
  if (m == 0) return x;
  const uint64_t t = __umul64hi(x, m);
  return t * d > x ? t - 1 : t;
}

}  // namespace capped_div
