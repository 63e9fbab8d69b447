// staleness: the degraded-mode decay of estimator answers.
//
// Replaces karmada_tpu/faults/staleness.py:46 `_apply_jnp`:
//   out = values >= 0 ? values >> shift : values
// over an int32 answer matrix, the discard sentinel (-1) and every other
// negative value passing through untouched, shift in [1, 8]. One thread
// per element; bound by memory bandwidth (4 bytes read, 4 written).
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
staleness_kernel(const int32_t* values, int64_t n, int shift, int32_t* out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t v = values[i];
  out[i] = v >= 0 ? (v >> shift) : v;
}

}  // namespace

extern "C" int staleness_launch(const void* values, int64_t n, int shift, void* out,
                                void* stream) {
  if (n <= 0 || shift < 1 || shift > 31) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  staleness_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values), n, shift, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
