// capped_div.cuh: min(lim, floor(x / d)) in exact integer arithmetic,
// without the int64 division's software sequence. Shared by
// dense_filter.cu's sim_filter prologue (the GeneralEstimator's cap // req,
// answers at or above INT32_MAX become the row's replicas) and
// fleet_estimate.cu (a node's free capacity // request, capped by its
// pods left).
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

}  // namespace capped_div
