// combo_select: the spread round's winner selection over the enumerated
// region combinations, one row per block.
//
// Replaces karmada_tpu/sched/spread_batch.py:859 `_combo_select_kernel`
// (selectGroups, select_groups.go:100-230). For each row and each
// combination of members[k] (L slots, -1 = pad) over the row's R regions
// (any R >= 1):
//   - sum_w, sum_v: the members' group weights and values (int64);
//   - feasible: every member present (value > 0), sum_v >= cmin, the
//     combination's size <= the row's kmax, and RECORDED by the reference's
//     DFS — its size is below kmin + 1, or dropping its last member in the
//     row's group order (value asc, weight desc, name rank asc) leaves
//     sum_v below cmin;
//   - the winner: max sum_w over the feasible combinations (-2^62 masks the
//     rest; none_feasible when the max is the mask), then max sum_v among
//     those, then, when 7 * L <= 62, the least discovery key — the members'
//     group-order positions sorted ascending (pads 127), 7 bits a slot
//     added in int64 (see disc_key) — with n_ties 1 (0 when nothing is a candidate); otherwise the first
//     candidate and the real candidate count. Equal keys take the lowest
//     combination index, as argmin / argmax do.
//
// The row's weights, values and group-order positions (an O(R^2) count)
// stay in dynamic shared memory, 16 bytes a region, up to kSmemRegions
// regions (32 KB); past that the weights and values are read in place from
// the [S, R] inputs and the positions go to an int32 [S, R] scratch that the
// wrapper allocates (one kernel instance per route, the same code over
// either set of pointers). Each thread walks combinations in
// index order, three passes (max weight, max value among those, the key),
// each ending in a block reduction through shared-memory atomics; the
// least index among a thread's equal keys is its first, so the lowest
// index wins. What bounds it on an H100: operations — about 6L + 10
// integer operations per (row, combination) and pass; the members table
// (K x L x 4 bytes) is read from L2 by every row. Built by
// karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and called
// through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemRegions = 2048;  // a row's regions staged in shared memory
constexpr int kPackedSlots = 8;     // 7 * L <= 62
constexpr long long kNeg = -(1LL << 62);
constexpr long long kMasked = 1LL << 62;
constexpr long long kNoKey = 0x7fffffffffffffffLL;

struct Params {
  const int64_t* weight;    // [S,R]
  const int32_t* value;     // [S,R]
  const int32_t* kmax_row;  // [S]
  const int32_t* rname;     // [R] region-name ranks
  int S, R;
  const int32_t* members;  // [K,L], -1 = pad
  const int32_t* sizes;    // [K]
  int K, L;
  int cmin, kmin;
  int32_t* first_idx;       // [S]
  int32_t* n_ties;          // [S]
  uint8_t* none_feasible;   // [S]
  int32_t* pos_scratch;     // [S,R] group-order positions past kSmemRegions
};

// A row's regions: shared memory, or the inputs in place and the scratch.
struct Regions {
  const long long* w;
  const int32_t* v;
  const int32_t* pos;
};

struct Shared {
  long long best_w, best_v;
  long long best_key;
  unsigned int first, count;
};

struct Combo {
  long long sum_w, sum_v;
  bool feasible;
};

__device__ Combo eval(const Params& p, const Regions& s, int kmax, int k) {
  Combo c;
  c.sum_w = 0;
  c.sum_v = 0;
  bool present = true;
  int last = -1, last_pos = -1;
  const int32_t* m = p.members + (int64_t)k * p.L;
  for (int l = 0; l < p.L; ++l) {
    const int r = m[l];
    if (r < 0) continue;
    c.sum_w += s.w[r];
    c.sum_v += (long long)s.v[r];
    present = present && s.v[r] > 0;
    if (s.pos[r] > last_pos) {
      last_pos = s.pos[r];
      last = r;
    }
  }
  const int size = p.sizes[k];
  const bool recorded =
      (size - 1 < p.kmin) || (last >= 0 && c.sum_v - (long long)s.v[last] < p.cmin);
  c.feasible = present && c.sum_v >= p.cmin && size <= kmax && recorded;
  return c;
}

// The discovery key: the members' group-order positions, ascending, pads
// 127 (L <= kPackedSlots), summed as position << 7 (L - 1 - l) in wrapping
// int64, the reference's sum: past 128 regions a position outgrows its 7
// bits and the fields overlap, so they are added, not ORed. Each position
// goes to its rank among the slots (ties by slot), so the slots stay in
// registers (no sort through local memory).
__device__ long long disc_key(const Params& p, const Regions& s, int k) {
  int v[kPackedSlots];
  const int32_t* m = p.members + (int64_t)k * p.L;
#pragma unroll
  for (int l = 0; l < kPackedSlots; ++l) {
    if (l == p.L) break;
    v[l] = m[l] < 0 ? 127 : s.pos[m[l]];
  }
  unsigned long long key = 0;
#pragma unroll
  for (int l = 0; l < kPackedSlots; ++l) {
    if (l == p.L) break;
    int rank = 0;
#pragma unroll
    for (int q = 0; q < kPackedSlots; ++q) {
      if (q == p.L) break;
      rank += v[q] < v[l] || (v[q] == v[l] && q < l) ? 1 : 0;
    }
    key += (unsigned long long)v[l] << (7 * (p.L - 1 - rank));
  }
  return (long long)key;
}

// kSmem: the row's regions staged in shared memory (each route its own
// instance, so the compiler sees the staged arrays' address space and the
// hot loops keep shared-memory loads); otherwise read in place.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
combo_select_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared s;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int R = p.R;
  const int64_t at = (int64_t)row * R;
  Regions g;
  int32_t* pos;
  if constexpr (kSmem) {  // [R] weights, [R] values, [R] positions
    long long* w = reinterpret_cast<long long*>(dyn);
    int32_t* v = reinterpret_cast<int32_t*>(w + R);
    pos = v + R;
    for (int r = tid; r < R; r += blockDim.x) {
      w[r] = p.weight[at + r];
      v[r] = p.value[at + r];
    }
    g.w = w;
    g.v = v;
  } else {
    pos = p.pos_scratch + at;
    g.w = reinterpret_cast<const long long*>(p.weight) + at;
    g.v = p.value + at;
  }
  g.pos = pos;
  if (tid == 0) {
    s.best_w = kNeg;
    s.best_v = kNeg;
    s.best_key = kNoKey;
    s.first = (unsigned)p.K;
    s.count = 0;
  }
  __syncthreads();
  // group order (value asc, weight desc, name rank asc): regions before r
  for (int r = tid; r < R; r += blockDim.x) {
    const long long wr = g.w[r];
    const int32_t vr = g.v[r], nr = p.rname[r];
    int before = 0;
    for (int q = 0; q < R; ++q) {
      const int32_t vq = g.v[q];
      const bool b = vq < vr || (vq == vr && (g.w[q] > wr || (g.w[q] == wr && p.rname[q] < nr)));
      before += b ? 1 : 0;
    }
    pos[r] = before;
  }
  __syncthreads();
  const int kmax = p.kmax_row[row];

  // ---- pass 1: the best weight sum ----
  long long bw = kNeg;
  for (int k = tid; k < p.K; k += blockDim.x) {
    const Combo c = eval(p, g, kmax, k);
    const long long wm = c.feasible ? c.sum_w : kNeg;
    bw = wm > bw ? wm : bw;
  }
  atomicMax(&s.best_w, bw);
  __syncthreads();
  const long long best_w = s.best_w;

  // ---- pass 2: the best value sum among them ----
  long long bv = kNeg;
  for (int k = tid; k < p.K; k += blockDim.x) {
    const Combo c = eval(p, g, kmax, k);
    if (c.feasible && c.sum_w == best_w) bv = c.sum_v > bv ? c.sum_v : bv;
  }
  atomicMax(&s.best_v, bv);
  __syncthreads();
  const long long best_v = s.best_v;

  // ---- pass 3: the winner among the candidates ----
  const bool packed = 7 * p.L <= 62;
  long long my_key = kNoKey;
  unsigned int my_first = (unsigned)p.K, my_count = 0;
  for (int k = tid; k < p.K; k += blockDim.x) {
    const Combo c = eval(p, g, kmax, k);
    const bool cand2 = c.feasible && c.sum_w == best_w && c.sum_v == best_v;
    my_count += cand2 ? 1 : 0;
    // k runs ascending: the first index of a thread's least key is its own
    const long long key = packed ? (cand2 ? disc_key(p, g, k) : kMasked)
                                 : (cand2 ? 0LL : kMasked);
    if (key < my_key) {
      my_key = key;
      my_first = (unsigned)k;
    }
  }
  atomicMin(&s.best_key, my_key);
  atomicAdd(&s.count, my_count);
  __syncthreads();
  if (my_key == s.best_key) atomicMin(&s.first, my_first);
  __syncthreads();
  if (tid == 0) {
    // no candidate: every key is masked, so index 0 wins — argmin of the
    // masked keys and argmax of an all-False row both give 0
    p.first_idx[row] = (int32_t)s.first;
    p.n_ties[row] = packed ? (s.count > 0 ? 1 : 0) : (int32_t)s.count;
    p.none_feasible[row] = best_w == kNeg ? 1 : 0;
  }
}

}  // namespace

extern "C" int combo_select_launch(
    const void* weight, const void* value, const void* kmax_row, const void* rname, int S,
    int R, const void* members, const void* sizes, int K, int L, int cmin, int kmin,
    void* first_idx, void* n_ties, void* none_feasible, void* pos_scratch, void* stream) {
  // past kSmemRegions the positions need the caller's [S, R] scratch
  if (S <= 0 || R <= 0 || K <= 0 || L <= 0 || (R > kSmemRegions && pos_scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.weight = static_cast<const int64_t*>(weight);
  p.value = static_cast<const int32_t*>(value);
  p.kmax_row = static_cast<const int32_t*>(kmax_row);
  p.rname = static_cast<const int32_t*>(rname);
  p.S = S;
  p.R = R;
  p.members = static_cast<const int32_t*>(members);
  p.sizes = static_cast<const int32_t*>(sizes);
  p.K = K;
  p.L = L;
  p.cmin = cmin;
  p.kmin = kmin;
  p.first_idx = static_cast<int32_t*>(first_idx);
  p.n_ties = static_cast<int32_t*>(n_ties);
  p.none_feasible = static_cast<uint8_t*>(none_feasible);
  p.pos_scratch = static_cast<int32_t*>(pos_scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > kSmemRegions) {
    combo_select_kernel<false><<<S, kThreads, 0, st>>>(p);
  } else {
    combo_select_kernel<true><<<S, kThreads, 16 * (size_t)R, st>>>(p);
  }
  return (int)cudaGetLastError();
}
