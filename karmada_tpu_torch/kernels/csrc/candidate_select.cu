// candidate_select: the candidate prepass of the compact schedule round.
//
// Replaces karmada_tpu/sched/candidates.py:209 `_candidate_select_kernel`
// (with spread_batch.py:434 `_pack_bits`, candidates.py:166 `_tie_at` and
// candidates.py:177 `_compact_estimate` fused in). For each binding row b
// and cluster column c: the in-tree filters (alive, taints against the
// row's tolerations, API enablement, affinity mask, eviction list) and the
// locality score; the top K columns by (key desc, column asc) with
// key = (feasible << 33) + score, sorted by column ascending; then, at the
// K winners, feasibility, score, previous replicas, the GeneralEstimator
// answer (min over requested resources of cap // req, with the reference's
// clamps in its order), the registered-estimator min-merge and the
// splitmix64 tie; plus the exact feasible count and the packed feasible
// bits (bit j of byte i is column 8i+j).
//
// What bounds it on an H100: the reads are small (the fleet tables are
// shared by every row and stay in L2; per row only the affinity-mask row,
// C bytes, and O(K) outputs), so the floor is the C/8 packed bytes plus
// [B,K] outputs over memory bandwidth, well under a millisecond at
// 10240 x 5120. The real cost is the top-K selection: this first version
// bitonic-sorts the row's padded int64 keys (C padded to a power of two,
// 64 KB at C = 5120 -> 8192) in dynamic shared memory, O(C log^2 C)
// compare-swaps with a barrier per stage. One block of 512 threads per row
// keeps the keys on chip and never writes a [B, C] tensor. A radix select
// of the K-th key is the planned faster version.
//
// Built by karmada_tpu_torch/kernels/build.py with nvcc for sm_90a and
// called through the plain C entry point at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBitApi = 1;
constexpr int kBitTaint = 2;
constexpr int kBitAffinity = 4;
constexpr int kBitEviction = 8;
constexpr int kBitLocality = 16;
constexpr int kTolOpNone = 0;
constexpr int kTolOpExists = 2;
constexpr int kEffNoSchedule = 1;
constexpr int kEffNoExecute = 3;
constexpr int64_t kBig = int64_t(1) << 62;
constexpr int64_t kI32Max = 2147483647;

struct SelParams {
  // fleet
  const uint8_t* alive;         // [C]
  const int64_t* capacity;      // [C,R]
  const uint8_t* has_summary;   // [C]
  const int32_t* taint_key;     // [C,T]
  const int32_t* taint_value;   // [C,T]
  const int32_t* taint_effect;  // [C,T]
  const uint8_t* api_ok;        // [C,G]
  int C, R, T, G;
  // batch
  const int32_t* replicas;         // [B]
  const uint8_t* unknown_request;  // [B]
  const int32_t* gvk;              // [B]
  const int32_t* tol_tables;       // [Tt,4,Kt]
  const int32_t* tol_idx;          // [B]
  const uint8_t* aff_masks;        // [P,C]
  const int32_t* aff_idx;          // [B]
  const int32_t* prev_idx;         // [B,Kp]
  const int32_t* prev_rep;         // [B,Kp]
  const int32_t* evict_idx;        // [B,Ke]
  const uint64_t* seeds;           // [B]
  const int64_t* req_unique;       // [U,R]
  const int32_t* req_idx;          // [B]
  const int32_t* extra_avail;      // [B,C] or null
  int B, Kt, Kp, Ke, K, plugin_bits;
  int Cp;      // C padded to a power of two (>= 1024)
  int Kw;      // K padded to a power of two
  int cb;      // bits of the column field in the sort key
  int nbytes;  // ceil(C / 8)
  // outputs
  int32_t* cand_idx;    // [B,K]
  uint8_t* c_feas;      // [B,K]
  int32_t* c_score;     // [B,K]
  int32_t* c_avail;     // [B,K]
  int32_t* c_prev;      // [B,K]
  int32_t* c_tie;       // [B,K]
  int32_t* feas_count;  // [B]
  uint8_t* packed;      // [B,nbytes]
};

struct ColEval {
  bool feasible;
  int32_t score;
  int32_t prev;
};

// Filters + locality score for column c of row b. `tol` is the row's
// [4,Kt] toleration table row, `pidx`/`prep`/`ev` its prev/evict lists,
// all in shared memory. A prev column listed twice takes its LAST entry.
__device__ ColEval eval_col(const SelParams& p, int b, int c, const int32_t* tol,
                            const int32_t* pidx, const int32_t* prep,
                            const int32_t* ev) {
  bool ok = p.alive[c] != 0;
  if (p.plugin_bits & kBitTaint) {
    for (int t = 0; t < p.T; ++t) {
      const int te = p.taint_effect[c * p.T + t];
      if (te != kEffNoSchedule && te != kEffNoExecute) continue;
      const int tk = p.taint_key[c * p.T + t];
      const int tv = p.taint_value[c * p.T + t];
      bool tolerated = false;
      for (int k = 0; k < p.Kt; ++k) {
        const int op = tol[3 * p.Kt + k];
        if (op == kTolOpNone) continue;
        const int key = tol[k];
        const int val = tol[p.Kt + k];
        const int eff = tol[2 * p.Kt + k];
        const bool key_match = key == tk || (key == 0 && op == kTolOpExists);
        const bool effect_match = eff == 0 || eff == te;
        const bool value_match = op == kTolOpExists || val == tv;
        if (key_match && effect_match && value_match) {
          tolerated = true;
          break;
        }
      }
      if (!tolerated) ok = false;
    }
  }
  if (p.plugin_bits & kBitApi) {
    const int g = p.gvk[b];
    bool api = false;
    if (p.G > 0 && g < p.G) {
      const int gc = g < 0 ? 0 : g;
      api = p.api_ok[(int64_t)c * p.G + gc] != 0;
    }
    ok = ok && api;
  }
  if (p.plugin_bits & kBitAffinity) {
    ok = ok && p.aff_masks[(int64_t)p.aff_idx[b] * p.C + c] != 0;
  }
  if (p.plugin_bits & kBitEviction) {
    for (int k = 0; k < p.Ke; ++k) {
      if (ev[k] == c) ok = false;
    }
  }
  bool member = false;
  int32_t prev = 0;
  for (int k = 0; k < p.Kp; ++k) {
    if (pidx[k] == c) {
      member = true;
      prev = prep[k];
    }
  }
  ColEval out;
  out.feasible = ok;
  out.score = (p.plugin_bits & kBitLocality) && member ? 100 : 0;
  out.prev = prev;
  return out;
}

__device__ __forceinline__ int32_t tie_value(uint64_t seed, int col) {
  uint64_t x = seed ^ ((uint64_t)col + 1ull);
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  x = x ^ (x >> 31);
  return (int32_t)(x >> 33);
}

// GeneralEstimator answer for row b at column c, in the order of the
// reference's _compact_estimate / general_estimate_unique: per requested
// resource cap // req (cap > 0, req >= 1, so C's truncating division
// equals the floor), 0 where cap <= 0; no requested resource -> replicas;
// no summary -> 0; >= INT32_MAX -> replicas; unknown request -> 0; then
// the min-merge with a non-negative registered-estimator answer.
__device__ int32_t estimate(const SelParams& p, int b, int c) {
  const int r = p.req_idx[b];
  bool any_req = false;
  int64_t est = kBig;
  for (int i = 0; i < p.R; ++i) {
    const int64_t q = p.req_unique[(int64_t)r * p.R + i];
    if (q <= 0) continue;
    any_req = true;
    const int64_t cap = p.capacity[(int64_t)c * p.R + i];
    const int64_t v = cap <= 0 ? 0 : cap / q;
    est = v < est ? v : est;
  }
  const int64_t reps = p.replicas[b];
  if (!any_req) est = reps;
  if (!p.has_summary[c]) est = 0;
  if (est >= kI32Max) est = reps;
  int32_t avail = (int32_t)(uint32_t)(uint64_t)est;
  if (p.unknown_request[b]) avail = 0;
  if (p.extra_avail != nullptr) {
    const int32_t e = p.extra_avail[(int64_t)b * p.C + c];
    if (e >= 0 && e < avail) avail = e;
  }
  return avail;
}

// In-place bitonic sort of n (a power of two) keys in shared memory, all
// threads of the block taking part. descending = true sorts high first.
template <typename T>
__device__ void bitonic_sort(T* keys, int n, bool descending) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (n >> 1); q += blockDim.x) {
        const int i = 2 * q - (q & (j - 1));
        const int ixj = i + j;
        const T a = keys[i];
        const T c = keys[ixj];
        const bool up = ((i & k) == 0) != descending;  // this pair ascending?
        if (up ? (a > c) : (a < c)) {
          keys[i] = c;
          keys[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
candidate_select_kernel(SelParams p) {
  extern __shared__ int64_t smem[];
  int64_t* keys = smem;                                  // [Cp]
  int32_t* win = reinterpret_cast<int32_t*>(keys + p.Cp);  // [Kw]
  int32_t* tol = win + p.Kw;                             // [4*Kt]
  int32_t* pidx = tol + 4 * p.Kt;                        // [Kp]
  int32_t* prep = pidx + p.Kp;                           // [Kp]
  int32_t* ev = prep + p.Kp;                             // [Ke]
  __shared__ int count;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* tol_row = p.tol_tables + (int64_t)p.tol_idx[b] * 4 * p.Kt;
  for (int i = tid; i < 4 * p.Kt; i += blockDim.x) tol[i] = tol_row[i];
  for (int i = tid; i < p.Kp; i += blockDim.x) {
    pidx[i] = p.prev_idx[(int64_t)b * p.Kp + i];
    prep[i] = p.prev_rep[(int64_t)b * p.Kp + i];
  }
  for (int i = tid; i < p.Ke; i += blockDim.x) ev[i] = p.evict_idx[(int64_t)b * p.Ke + i];
  if (tid == 0) count = 0;
  __syncthreads();

  // pass 1: every column's key, the packed bits and the feasible count.
  // Columns go in warp-aligned steps, so one ballot covers 32 columns.
  const int64_t colmask = (int64_t(1) << p.cb) - 1;
  const int lane = tid & 31;
  int local = 0;
  for (int base = 0; base < p.Cp; base += blockDim.x) {
    const int c = base + tid;
    bool f = false;
    int64_t sortkey = INT64_MIN;
    if (c < p.C) {
      const ColEval e = eval_col(p, b, c, tol, pidx, prep, ev);
      f = e.feasible;
      const int64_t key = ((int64_t)f << 33) + (int64_t)e.score;
      sortkey = (key << p.cb) | (colmask - c);
    }
    keys[c] = sortkey;
    local += f ? 1 : 0;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane < 4) {
      const int byte = (base + (tid & ~31)) / 8 + lane;
      if (byte < p.nbytes) {
        p.packed[(int64_t)b * p.nbytes + byte] = (uint8_t)((bal >> (8 * lane)) & 0xffu);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(0xffffffffu, local, off);
  if (lane == 0) atomicAdd(&count, local);
  __syncthreads();
  if (tid == 0) p.feas_count[b] = count;

  // the top K keys: (key desc, column asc), the column being folded into
  // the low bits of every key so all keys are distinct
  bitonic_sort(keys, p.Cp, true);
  for (int t = tid; t < p.Kw; t += blockDim.x) {
    win[t] = t < p.K ? (int32_t)(colmask - (keys[t] & colmask)) : INT32_MAX;
  }
  __syncthreads();
  bitonic_sort(win, p.Kw, false);  // winners by column ascending

  for (int t = tid; t < p.K; t += blockDim.x) {
    const int c = win[t];
    const ColEval e = eval_col(p, b, c, tol, pidx, prep, ev);
    const int64_t o = (int64_t)b * p.K + t;
    p.cand_idx[o] = c;
    p.c_feas[o] = e.feasible ? 1 : 0;
    p.c_score[o] = e.score;
    p.c_prev[o] = e.prev;
    p.c_avail[o] = estimate(p, b, c);
    p.c_tie[o] = tie_value(p.seeds[b], c);
  }
}

int pow2_at_least(int n) {
  int v = 1;
  while (v < n) v <<= 1;
  return v;
}

int bit_length(int n) {
  int bits = 0;
  while (n > 0) {
    ++bits;
    n >>= 1;
  }
  return bits;
}

}  // namespace

extern "C" int candidate_select_launch(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int C, int R, int T, int G,
    const void* replicas, const void* unknown_request, const void* gvk,
    const void* tol_tables, const void* tol_idx, const void* aff_masks,
    const void* aff_idx, const void* prev_idx, const void* prev_rep,
    const void* evict_idx, const void* seeds, const void* req_unique,
    const void* req_idx, int B, int Kt, int Kp, int Ke, int K, int plugin_bits,
    int has_extra, const void* extra_avail, void* cand_idx, void* c_feas,
    void* c_score, void* c_avail, void* c_prev, void* c_tie, void* feas_count,
    void* packed, void* stream) {
  SelParams p;
  p.alive = static_cast<const uint8_t*>(alive);
  p.capacity = static_cast<const int64_t*>(capacity);
  p.has_summary = static_cast<const uint8_t*>(has_summary);
  p.taint_key = static_cast<const int32_t*>(taint_key);
  p.taint_value = static_cast<const int32_t*>(taint_value);
  p.taint_effect = static_cast<const int32_t*>(taint_effect);
  p.api_ok = static_cast<const uint8_t*>(api_ok);
  p.C = C;
  p.R = R;
  p.T = T;
  p.G = G;
  p.replicas = static_cast<const int32_t*>(replicas);
  p.unknown_request = static_cast<const uint8_t*>(unknown_request);
  p.gvk = static_cast<const int32_t*>(gvk);
  p.tol_tables = static_cast<const int32_t*>(tol_tables);
  p.tol_idx = static_cast<const int32_t*>(tol_idx);
  p.aff_masks = static_cast<const uint8_t*>(aff_masks);
  p.aff_idx = static_cast<const int32_t*>(aff_idx);
  p.prev_idx = static_cast<const int32_t*>(prev_idx);
  p.prev_rep = static_cast<const int32_t*>(prev_rep);
  p.evict_idx = static_cast<const int32_t*>(evict_idx);
  p.seeds = static_cast<const uint64_t*>(seeds);
  p.req_unique = static_cast<const int64_t*>(req_unique);
  p.req_idx = static_cast<const int32_t*>(req_idx);
  p.extra_avail = has_extra ? static_cast<const int32_t*>(extra_avail) : nullptr;
  p.B = B;
  p.Kt = Kt;
  p.Kp = Kp;
  p.Ke = Ke;
  p.K = K;
  p.plugin_bits = plugin_bits;
  p.Cp = pow2_at_least(C < 1024 ? 1024 : C);
  p.Kw = pow2_at_least(K);
  p.cb = bit_length(C - 1) > 0 ? bit_length(C - 1) : 1;
  p.nbytes = (C + 7) / 8;
  p.cand_idx = static_cast<int32_t*>(cand_idx);
  p.c_feas = static_cast<uint8_t*>(c_feas);
  p.c_score = static_cast<int32_t*>(c_score);
  p.c_avail = static_cast<int32_t*>(c_avail);
  p.c_prev = static_cast<int32_t*>(c_prev);
  p.c_tie = static_cast<int32_t*>(c_tie);
  p.feas_count = static_cast<int32_t*>(feas_count);
  p.packed = static_cast<uint8_t*>(packed);
  if (B <= 0 || K <= 0 || K > C || p.cb > 27) return (int)cudaErrorInvalidValue;

  const size_t smem = 8 * (size_t)p.Cp + 4 * (size_t)(p.Kw + 4 * Kt + 2 * Kp + Ke);
  cudaError_t err = cudaFuncSetAttribute(
      candidate_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  candidate_select_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
