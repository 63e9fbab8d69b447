// scatter_rows: the dirty-column refresh of the resident fleet tensors.
//
// Replaces karmada_tpu/sched/core.py:561 `_scatter_rows_kernel`
// (`dst.at[idx].set(src)` with dst donated), which the reference runs once
// for each of the seven resident fleet tensors (alive, capacity,
// has_summary, taint_key/value/effect, api_ok) when a status change
// re-encodes a few clusters. Here one launch writes all of them in place:
// a table of up to kMaxTensors (dst, src, row bytes, dst rows) entries, a
// block per (dirty row, tensor) and a thread per byte of the row. Bytes,
// not elements, so one kernel serves bool, int32 and int64 rows alike; the
// row width is the tensor's row stride times its item size. A duplicate
// index writes the same bytes twice, which the callers guarantee by
// passing the rows of one re-encoded fleet (so the result does not depend
// on the order of the writes); an index outside [0, dst rows) writes
// nothing.
//
// What bounds it on an H100: a round's dirty rows are a few kB (50
// clusters x ~100 bytes across the seven tensors), so the bound is a
// nanosecond of memory time and the kernel is bound by its launch. The
// design's only aim is one launch for all seven tensors instead of seven.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTensors = 8;

struct ScatterTable {
  uint8_t* dst[kMaxTensors];
  const uint8_t* src[kMaxTensors];
  int64_t row_bytes[kMaxTensors];
  int64_t dst_rows[kMaxTensors];
};

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(ScatterTable t, const int64_t* idx) {
  const int i = blockIdx.x;  // dirty row
  const int e = blockIdx.y;  // tensor
  const int64_t row = idx[i];
  if (row < 0 || row >= t.dst_rows[e]) return;
  const int64_t w = t.row_bytes[e];
  uint8_t* dst = t.dst[e] + row * w;
  const uint8_t* src = t.src[e] + (int64_t)i * w;
  for (int64_t byte = threadIdx.x; byte < w; byte += blockDim.x) dst[byte] = src[byte];
}

}  // namespace

// dsts / srcs: n_tensors device pointers each (host arrays); row_bytes and
// dst_rows: n_tensors int64 each; idx: int64 [n] on the device.
extern "C" int scatter_rows_launch(void* const* dsts, const void* const* srcs,
                                   const int64_t* row_bytes, const int64_t* dst_rows,
                                   int n_tensors, const void* idx, int n, void* stream) {
  if (n <= 0 || n_tensors <= 0 || n_tensors > kMaxTensors) {
    return (int)cudaErrorInvalidValue;
  }
  ScatterTable t = {};
  for (int e = 0; e < n_tensors; ++e) {
    if (row_bytes[e] <= 0 || dst_rows[e] < 0) return (int)cudaErrorInvalidValue;
    t.dst[e] = static_cast<uint8_t*>(dsts[e]);
    t.src[e] = static_cast<const uint8_t*>(srcs[e]);
    t.row_bytes[e] = row_bytes[e];
    t.dst_rows[e] = dst_rows[e];
  }
  const dim3 grid((unsigned)n, (unsigned)n_tensors);
  scatter_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const int64_t*>(idx));
  return (int)cudaGetLastError();
}
