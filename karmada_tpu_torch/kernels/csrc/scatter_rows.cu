// scatter_rows: the dirty-column refresh of the resident fleet tensors.
//
// Replaces karmada_tpu/sched/core.py:561 `_scatter_rows_kernel`
// (`dst.at[idx].set(src)` with dst donated), which the reference runs once
// for each of the seven resident fleet tensors (alive, capacity,
// has_summary, taint_key/value/effect, api_ok) when a status change
// re-encodes a few clusters. Here one launch writes all of them in place.
//
// The table (ScatterTable, mirrored by kernels._ScatterTable) holds up to
// kMaxTensors destinations, each its device pointer, rows, elements a row
// and element size (1, 4 or 8 bytes), and a source for each: a base
// pointer and a row stride in bytes. One block a dirty row: its first
// thread reads the row's id once into shared memory, then the block's
// threads walk the row's flattened (destination, element) space, each
// store a whole element (an int64 is never written byte by byte, so a
// reader never sees half of one). A duplicate id writes the same row
// twice, which the callers guarantee carries identical values (rows of
// one re-encoded fleet), so the result does not depend on the order of
// the writes; an id outside [0, destination rows) writes nothing.
//
// Two sources, one kernel:
// - scatter_rows_launch: separate device tensors (the table's src and
//   src_stride filled by the caller), the ids a device int64 [n];
// - scatter_rows_staged: one staging block uploaded in one copy, laid out
//   as the ids (int64 [n]) at offset 0, then each destination's n source
//   rows in table order, every segment starting at a 16-byte boundary
//   (kernels._staged_layout computes the same offsets). The entry fills
//   the sources from the block's address and n, so a table bound once per
//   placed fleet serves every refresh.
//
// What bounds it on an H100: a refresh moves a few kB (50 clusters x ~100
// bytes across the seven tensors), a nanosecond of memory time, so the
// kernel is bound by its launch; its design aims only at one launch and
// one upload for all seven tensors. No wgmma, no TMA: nothing here would
// use them.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry points at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxTensors = 8;

// the host's table, as kernels._ScatterTable lays it out (outside the
// anonymous namespace: the C entries take it, and are exported)
struct ScatterTable {
  void* dst[kMaxTensors];
  const void* src[kMaxTensors];
  long long src_stride[kMaxTensors];  // bytes between source rows
  long long rows[kMaxTensors];        // destination rows
  long long row_elems[kMaxTensors];   // elements a row
  int elem_bytes[kMaxTensors];        // 1, 4 or 8
  int n_dst;
};

namespace {

constexpr int kThreads = 128;

// the kernel's copy: the table plus each destination's first element in
// the flattened row (row_start[n_dst] = elements a dirty row carries)
struct Plan {
  uint8_t* dst[kMaxTensors];
  const uint8_t* src[kMaxTensors];
  int64_t src_stride[kMaxTensors];
  int64_t rows[kMaxTensors];
  int64_t row_elems[kMaxTensors];
  int64_t row_start[kMaxTensors + 1];
  int elem_bytes[kMaxTensors];
  int n_dst;
};

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(Plan p, const int64_t* __restrict__ idx) {
  __shared__ int64_t row_s;
  const int64_t i = blockIdx.x;  // dirty row
  if (threadIdx.x == 0) row_s = idx[i];
  __syncthreads();
  const int64_t row = row_s;
  const int64_t total = p.row_start[p.n_dst];
  for (int64_t k = threadIdx.x; k < total; k += blockDim.x) {
    int e = 0;
    while (k >= p.row_start[e + 1]) ++e;
    if (row < 0 || row >= p.rows[e]) continue;
    const int64_t j = k - p.row_start[e];
    const int64_t w = p.row_elems[e];
    const uint8_t* s = p.src[e] + i * p.src_stride[e];
    uint8_t* d = p.dst[e];
    switch (p.elem_bytes[e]) {
      case 8:
        reinterpret_cast<int64_t*>(d)[row * w + j] = reinterpret_cast<const int64_t*>(s)[j];
        break;
      case 4:
        reinterpret_cast<int32_t*>(d)[row * w + j] = reinterpret_cast<const int32_t*>(s)[j];
        break;
      default:
        d[row * w + j] = s[j];
    }
  }
}

int64_t align16(int64_t b) { return (b + 15) / 16 * 16; }

// the table checked and turned into the kernel's plan (sources as given)
int make_plan(const ScatterTable* t, Plan* p) {
  if (t->n_dst <= 0 || t->n_dst > kMaxTensors) return (int)cudaErrorInvalidValue;
  *p = Plan{};
  p->n_dst = t->n_dst;
  p->row_start[0] = 0;
  for (int e = 0; e < t->n_dst; ++e) {
    const int eb = t->elem_bytes[e];
    if ((eb != 1 && eb != 4 && eb != 8) || t->row_elems[e] <= 0 || t->rows[e] < 0) {
      return (int)cudaErrorInvalidValue;
    }
    p->dst[e] = static_cast<uint8_t*>(t->dst[e]);
    p->src[e] = static_cast<const uint8_t*>(t->src[e]);
    p->src_stride[e] = t->src_stride[e];
    p->rows[e] = t->rows[e];
    p->row_elems[e] = t->row_elems[e];
    p->elem_bytes[e] = eb;
    p->row_start[e + 1] = p->row_start[e] + t->row_elems[e];
  }
  return 0;
}

int launch(const Plan& p, const int64_t* idx, int n, void* stream) {
  scatter_rows_kernel<<<(unsigned)n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// Separate sources: t's src / src_stride give each destination's n source
// rows; idx: int64 [n] on the device.
extern "C" int scatter_rows_launch(const ScatterTable* t, const void* idx, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const int rc = make_plan(t, &p);
  if (rc != 0) return rc;
  return launch(p, static_cast<const int64_t*>(idx), n, stream);
}

// One staging block (layout above) on the device; t's src / src_stride
// are not read.
extern "C" int scatter_rows_staged(const ScatterTable* t, const void* staging, int n,
                                   void* stream) {
  if (n <= 0 || staging == nullptr) return (int)cudaErrorInvalidValue;
  Plan p;
  const int rc = make_plan(t, &p);
  if (rc != 0) return rc;
  const uint8_t* base = static_cast<const uint8_t*>(staging);
  int64_t off = align16((int64_t)n * 8);
  for (int e = 0; e < p.n_dst; ++e) {
    p.src[e] = base + off;
    p.src_stride[e] = p.row_elems[e] * p.elem_bytes[e];
    off += align16((int64_t)n * p.src_stride[e]);
  }
  return launch(p, reinterpret_cast<const int64_t*>(base), n, stream);
}
