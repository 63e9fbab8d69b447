// combo_select: the spread round's winner selection over the enumerated
// region combinations, one warp a row, one pass.
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
//   - the winner: max sum_w over the feasible combinations (none_feasible
//     when there is none), then max sum_v among those, then, when
//     7 * L <= 62, the least discovery key — the members' group-order
//     positions sorted ascending (pads 127), 7 bits a slot added in int64
//     (see disc_key) — with n_ties 1 (0 when nothing is a candidate);
//     otherwise the first candidate and the real candidate count. Equal
//     keys take the lowest combination index, as argmin / argmax do.
//
// Design. A block takes up to kRowsMax rows, one warp each. The members
// table and sizes go to shared memory once a block while K * (L + 1) * 4
// bytes fit kTableSmem (64 KB: K <= 4 096 at L = 3, 2 730 at L = 5);
// past that they are read in place through the read-only cache. Up to
// kSmemRegions regions a row, the warp stages its row's weights and
// values and the block the region-name ranks (16 bytes a region and row,
// at most kRegionSmem a block: fewer rows a block past 512 regions); past
// that the weights and values are read in place from the [S, R] inputs
// and the positions go to an int32 [S, R] scratch that the wrapper
// allocates. The warp computes its row's group-order positions (an O(R^2)
// count over the lanes), then each lane walks combinations lane,
// lane + 32, ... once, keeping its best under the reference's order — max
// sum_w, max sum_v, then (packed key) the least key, then the least index
// — and the count of its candidates whose (sum_w, sum_v) equal its best.
// A butterfly of warp shuffles merges the lanes, with no shared-memory
// atomics: a lane whose (sum_w, sum_v) is greater replaces the other;
// equal pairs add their counts and keep the least (key, index).
//
// Why that is the three-pass answer: the merged pair is the max over every
// feasible combination of the row. A lane whose best pair is below it holds
// no candidate (none of its combinations exceeds its best); a lane whose
// best pair equals it counted exactly its candidates, which all carry that
// pair. So the summed count is the row's candidate count (n_ties when the
// key is not packed), and the least (key, index) over those lanes is the
// least over all candidates: the first index among the least keys. With no
// feasible combination the pair stays (kNeg, kNeg): first_idx 0, n_ties 0,
// none_feasible 1 (argmin of the masked keys and argmax of an all-False
// row both give 0).
//
// Outputs: one int32 [3, S] block (first_idx, n_ties, none_feasible as 0 or
// 1), every element written. What bounds it on an H100: operations — about
// 4L + 10 integer operations per (row, combination), each evaluated once.
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsMax = 8;                 // rows (warps) a block
constexpr int kSmemRegions = 2048;          // a row's regions staged in shared memory
constexpr size_t kRegionSmem = 64 * 1024;   // the staged rows' regions, bytes a block
constexpr size_t kTableSmem = 64 * 1024;    // members and sizes, staged while they fit
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory without the attribute
constexpr int kPackedSlots = 8;             // 7 * L <= 62
constexpr long long kNeg = -(1LL << 62);
constexpr long long kNoKey = 0x7fffffffffffffffLL;
constexpr unsigned kFull = 0xffffffffu;

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
  int rows;                // rows a block
  bool packed;             // 7 * L <= 62: the discovery key decides ties
  int32_t* out;            // [3, S]: first_idx, n_ties, none_feasible
  int32_t* pos_scratch;    // [S,R] group-order positions past kSmemRegions
};

// A row's regions: shared memory, or the inputs in place and the scratch.
struct Regions {
  const long long* w;
  const int32_t* v;
  const int32_t* pos;
};

// A lane's best candidate so far, and how many of its candidates share
// the best (w, v).
struct Best {
  long long w, v, key;
  int idx;
  unsigned count;
};

__device__ __forceinline__ void merge(Best& a, const Best& b) {
  if (b.w > a.w || (b.w == a.w && b.v > a.v)) {
    a = b;
  } else if (b.w == a.w && b.v == a.v) {
    a.count += b.count;
    if (b.key < a.key || (b.key == a.key && b.idx < a.idx)) {
      a.key = b.key;
      a.idx = b.idx;
    }
  }
}

struct Combo {
  long long sum_w, sum_v;
  bool feasible;
};

__device__ __forceinline__ Combo eval(const Params& p, const Regions& s, const int32_t* m,
                                      int size, int kmax) {
  Combo c;
  c.sum_w = 0;
  c.sum_v = 0;
  bool present = true;
  int last = -1, last_pos = -1;
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
__device__ __forceinline__ long long disc_key(const Params& p, const Regions& s,
                                              const int32_t* m) {
  int v[kPackedSlots];
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

// kRegions: the rows' regions (and the name ranks) staged in shared
// memory; kTable: the members table and sizes staged. Each pair of routes
// is its own instance, so the hot loop's loads keep their address space.
template <bool kRegions, bool kTable>
__global__ void __launch_bounds__(32 * kRowsMax)
combo_select_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = p.R;
  // [rows][R] weights, [rows][R] values, [rows][R] positions, [R] name
  // ranks (kRegions), then [K][L] members and [K] sizes (kTable)
  unsigned char* at = dyn;
  long long* w_s = nullptr;
  int32_t *v_s = nullptr, *pos_s = nullptr, *rname_s = nullptr;
  if constexpr (kRegions) {
    w_s = reinterpret_cast<long long*>(at);
    v_s = reinterpret_cast<int32_t*>(w_s + (size_t)p.rows * R);
    pos_s = v_s + (size_t)p.rows * R;
    rname_s = pos_s + (size_t)p.rows * R;
    at = reinterpret_cast<unsigned char*>(rname_s + R);
    for (int r = threadIdx.x; r < R; r += blockDim.x) rname_s[r] = p.rname[r];
  }
  const int32_t* members = p.members;
  const int32_t* sizes = p.sizes;
  if constexpr (kTable) {
    int32_t* m_s = reinterpret_cast<int32_t*>(at);
    int32_t* z_s = m_s + (size_t)p.K * p.L;
    for (int i = threadIdx.x; i < p.K * p.L; i += blockDim.x) m_s[i] = __ldg(p.members + i);
    for (int i = threadIdx.x; i < p.K; i += blockDim.x) z_s[i] = __ldg(p.sizes + i);
    members = m_s;
    sizes = z_s;
  }
  if constexpr (kRegions || kTable) __syncthreads();
  const int row = blockIdx.x * p.rows + warp;
  if (row >= p.S) return;  // whole warps: no barrier follows

  const int64_t at_row = (int64_t)row * R;
  Regions g;
  const int32_t* rname;
  int32_t* pos;
  if constexpr (kRegions) {
    long long* w = w_s + (size_t)warp * R;
    int32_t* v = v_s + (size_t)warp * R;
    pos = pos_s + (size_t)warp * R;
    for (int r = lane; r < R; r += 32) {
      w[r] = p.weight[at_row + r];
      v[r] = p.value[at_row + r];
    }
    __syncwarp();
    g.w = w;
    g.v = v;
    rname = rname_s;
  } else {
    pos = p.pos_scratch + at_row;
    g.w = reinterpret_cast<const long long*>(p.weight) + at_row;
    g.v = p.value + at_row;
    rname = p.rname;
  }
  g.pos = pos;
  // group order (value asc, weight desc, name rank asc): regions before r
  for (int r = lane; r < R; r += 32) {
    const long long wr = g.w[r];
    const int32_t vr = g.v[r], nr = rname[r];
    int before = 0;
    for (int q = 0; q < R; ++q) {
      const int32_t vq = g.v[q];
      const bool b = vq < vr || (vq == vr && (g.w[q] > wr || (g.w[q] == wr && rname[q] < nr)));
      before += b ? 1 : 0;
    }
    pos[r] = before;
  }
  __syncwarp();

  // ---- one pass: each lane's best and its tie count ----
  const int kmax = p.kmax_row[row];
  Best b{kNeg, kNeg, kNoKey, p.K, 0u};
  for (int k = lane; k < p.K; k += 32) {  // ascending: a lane keeps its first of equal keys
    const int32_t* m = members + (size_t)k * p.L;
    const Combo c = eval(p, g, m, sizes[k], kmax);
    if (!c.feasible) continue;
    const bool better = c.sum_w > b.w || (c.sum_w == b.w && c.sum_v > b.v);
    if (!better && (c.sum_w != b.w || c.sum_v != b.v)) continue;
    const long long key = p.packed ? disc_key(p, g, m) : 0LL;
    if (better) {
      b = Best{c.sum_w, c.sum_v, key, k, 1u};
    } else {
      ++b.count;
      if (key < b.key) {
        b.key = key;
        b.idx = k;
      }
    }
  }
  // ---- the lanes merged by a butterfly of shuffles ----
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.w = __shfl_xor_sync(kFull, b.w, off);
    o.v = __shfl_xor_sync(kFull, b.v, off);
    o.key = __shfl_xor_sync(kFull, b.key, off);
    o.idx = __shfl_xor_sync(kFull, b.idx, off);
    o.count = __shfl_xor_sync(kFull, b.count, off);
    merge(b, o);
  }
  if (lane == 0) {
    const bool none = b.w == kNeg;
    p.out[row] = none ? 0 : b.idx;
    p.out[p.S + row] = none ? 0 : (p.packed ? 1 : (int32_t)b.count);
    p.out[2 * p.S + row] = none ? 1 : 0;
  }
}

template <bool kRegions, bool kTable>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t st) {
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(combo_select_kernel<kRegions, kTable>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (p.S + p.rows - 1) / p.rows;
  combo_select_kernel<kRegions, kTable><<<grid, 32 * p.rows, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int combo_select_launch(
    const void* weight, const void* value, const void* kmax_row, const void* rname, int S,
    int R, const void* members, const void* sizes, int K, int L, int cmin, int kmin, void* out,
    void* pos_scratch, void* stream) {
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
  p.packed = 7 * L <= 62;
  p.out = static_cast<int32_t*>(out);
  p.pos_scratch = static_cast<int32_t*>(pos_scratch);
  const bool regions = R <= kSmemRegions;
  const size_t table = (size_t)4 * K * (L + 1);
  const bool staged_table = table <= kTableSmem;
  p.rows = kRowsMax;
  while (regions && p.rows > 1 && (size_t)16 * p.rows * R > kRegionSmem) p.rows >>= 1;
  const size_t smem =
      (regions ? (size_t)16 * p.rows * R + (size_t)4 * R : 0) + (staged_table ? table : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (regions) {
    e = staged_table ? launch<true, true>(p, smem, st) : launch<true, false>(p, smem, st);
  } else {
    e = staged_table ? launch<false, true>(p, smem, st) : launch<false, false>(p, smem, st);
  }
  return (int)e;
}
