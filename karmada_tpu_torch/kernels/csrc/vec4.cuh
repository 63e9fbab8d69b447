// vec4.cuh: four adjacent elements a thread, as one 16-byte (or, for
// bytes, one 4-byte) access where the caller's kVec says the width and the
// base allow it, else as scalar accesses that skip the elements at or past
// the row's end. Shared by dense_filter.cu's main passes and tiers.cu's
// estimate.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vec4 {

// Four adjacent elements: one 16-byte (or 4-byte for bytes) access where
// kVec, else four scalar ones of which those at or past `n` are skipped.
template <bool kVec>
__device__ __forceinline__ int4 load4(const int32_t* at, int n) {
  if (kVec) return *reinterpret_cast<const int4*>(at);
  int4 v = make_int4(0, 0, 0, 0);
  if (n > 0) v.x = at[0];
  if (n > 1) v.y = at[1];
  if (n > 2) v.z = at[2];
  if (n > 3) v.w = at[3];
  return v;
}

template <bool kVec>
__device__ __forceinline__ uint32_t load4(const uint8_t* at, int n) {
  if (kVec) return *reinterpret_cast<const uint32_t*>(at);
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n) v |= (uint32_t)at[j] << (8 * j);
  }
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(int32_t* at, const int32_t (&v)[4], int n) {
  if (kVec) {
    *reinterpret_cast<int4*>(at) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) at[j] = v[j];
    }
  }
}

// The four bytes of a feasibility word (0 or 1 each) as one 32-bit store
// where kVec, else byte by byte.
template <bool kVec>
__device__ __forceinline__ void store4(uint8_t* at, uint32_t v, int n) {
  if (kVec) {
    *reinterpret_cast<uint32_t*>(at) = v;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) at[j] = (v >> (8 * j)) & 1;
    }
  }
}

__device__ __forceinline__ int lane4(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

inline bool aligned(const void* at, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(at) & (bytes - 1)) == 0;
}

}  // namespace vec4
