// filter_common.cuh: the per-(row, column) filter, estimate and tie of the
// schedule rounds, shared so the kernels cannot drift apart:
// candidate_select.cu evaluates the filter chain per element through
// eval_col and, at its K winners, estimate; tiers.cu evaluates estimate
// per element over a capacity it is passed; dense_filter.cu's entries
// build factored tables (per distinct request and toleration row) and take
// the tie from tie_value / tie_from_index, the factored ones with
// taints_tolerated, the dense-input one with the same rule over four
// taints at a time (its tolerates_all).
//
// - eval_col: the in-tree filters (alive, taints against the row's
//   toleration table row, API enablement, affinity mask, eviction list),
//   the locality score and the previous replicas (the prev list scattered
//   with the last entry winning; ids outside [0, C) never match);
// - taints_tolerated: whether a [4, Kt] toleration row tolerates every
//   NoSchedule / NoExecute taint of a column;
// - tie_value / tie_from_index: splitmix64 over the global cluster id, or
//   over an explicit 1-based index (uint64);
// - estimate: the GeneralEstimator answer with the reference's clamps in
//   its order, then the registered-estimator min-merge;
// - factor_estimate / kEstReplicas: the same answer's part that depends
//   only on the request and the column, the entry of the factored tables
//   (dense_filter.cu's est_u) and of tiers.cu's estimate, which resolve
//   the sentinel to the row's replicas and apply the row's own clamps
//   (apply_row); factor_estimate_rcp the same through the request's
//   reciprocals (dense_filter.cu's dense-input tables, tiers.cu's
//   per-element routes).
//
// Mirrors karmada_tpu/sched/core.py filter_phase / filter_estimate_phase,
// decompress_batch and tie_from_index, and ops/assign.py
// general_estimate_unique / general_estimate_apply.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "capped_div.cuh"

namespace filter_common {

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

// The fleet tables and the factored batch (models/batch.py BindingBatch).
struct FilterArgs {
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
  int B, Kt, Kp, Ke, plugin_bits;
};

// Row b's toleration table row and prev/evict lists, copied into shared
// memory by the whole block (the caller synchronises after).
__device__ inline void load_row_lists(const FilterArgs& p, int b, int32_t* tol,
                                      int32_t* pidx, int32_t* prep, int32_t* ev) {
  const int32_t* tol_row = p.tol_tables + (int64_t)p.tol_idx[b] * 4 * p.Kt;
  for (int i = threadIdx.x; i < 4 * p.Kt; i += blockDim.x) tol[i] = tol_row[i];
  for (int i = threadIdx.x; i < p.Kp; i += blockDim.x) {
    pidx[i] = p.prev_idx[(int64_t)b * p.Kp + i];
    prep[i] = p.prev_rep[(int64_t)b * p.Kp + i];
  }
  for (int i = threadIdx.x; i < p.Ke; i += blockDim.x) ev[i] = p.evict_idx[(int64_t)b * p.Ke + i];
}

struct ColEval {
  bool feasible;
  int32_t score;
  int32_t prev;
};

// Whether the [4,Kt] toleration table row `tol` (shared memory) tolerates
// every NoSchedule / NoExecute taint of a column, whose T taint slots
// start at `key_c`, `value_c` and `effect_c`.
__device__ inline bool taints_tolerated(const int32_t* key_c, const int32_t* value_c,
                                        const int32_t* effect_c, int T, const int32_t* tol,
                                        int Kt) {
  bool ok = true;
  for (int t = 0; t < T; ++t) {
    const int te = effect_c[t];
    if (te != kEffNoSchedule && te != kEffNoExecute) continue;
    const int tk = key_c[t];
    const int tv = value_c[t];
    bool tolerated = false;
    for (int k = 0; k < Kt; ++k) {
      const int op = tol[3 * Kt + k];
      if (op == kTolOpNone) continue;
      const int key = tol[k];
      const int val = tol[Kt + k];
      const int eff = tol[2 * Kt + k];
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
  return ok;
}

// Filters + locality score for column c of row b. `tol` is the row's
// [4,Kt] toleration table row, `pidx`/`prep`/`ev` its prev/evict lists,
// all in shared memory. A prev column listed twice takes its LAST entry.
__device__ inline ColEval eval_col(const FilterArgs& p, int b, int c, const int32_t* tol,
                                   const int32_t* pidx, const int32_t* prep,
                                   const int32_t* ev) {
  bool ok = p.alive[c] != 0;
  if (p.plugin_bits & kBitTaint) {
    const int64_t at = (int64_t)c * p.T;
    ok = ok && taints_tolerated(p.taint_key + at, p.taint_value + at, p.taint_effect + at, p.T,
                                tol, p.Kt);
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

// splitmix64 at the 1-based global cluster index `idx` (the reference's
// tie_from_index; the simulation plane passes each scenario's remapped
// index, in which a drained cluster vanishes from the range).
__device__ __forceinline__ int32_t tie_from_index(uint64_t seed, uint64_t idx) {
  uint64_t x = seed ^ idx;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  x = x ^ (x >> 31);
  return (int32_t)(x >> 33);
}

// splitmix64 at the 0-based global cluster id `col` (the stream of
// models/batch.py tie_matrix, which counts ids from 1).
__device__ __forceinline__ int32_t tie_value(uint64_t seed, int col) {
  return tie_from_index(seed, (uint64_t)col + 1ull);
}

// GeneralEstimator answer for row b at column c, in the order of the
// reference's general_estimate_unique / general_estimate_apply: per
// requested resource cap // req (cap > 0, req >= 1, so C's truncating
// division equals the floor), 0 where cap <= 0; no requested resource ->
// replicas; no summary -> 0; >= INT32_MAX -> replicas; i32 cast; unknown
// request -> 0; then the min-merge with a non-negative registered-estimator
// answer.
__device__ inline int32_t estimate(const FilterArgs& p, int b, int c) {
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

// The factored estimate's sentinel: "this row's replicas" (no resource
// requested, or the minimum reaches INT32_MAX); every other entry is the
// answer in [0, INT32_MAX).
constexpr int32_t kEstReplicas = -1;

// general_estimate_unique's minimum for the request `req` (R resources)
// against the capacity row of a column with a summary (resource i's
// capacity cap_at(i)), with the clamps of general_estimate_apply that do
// not depend on the row: kEstReplicas when no resource is requested or
// the minimum reaches INT32_MAX. A resource with cap <= 0 answers 0; each
// cap // req goes through capped_div (no int64 division). A column
// without a summary answers 0: the callers test it. With the row's clamps
// (the sentinel to replicas, unknown_request to 0, the answers'
// min-merge) it equals estimate() above.
template <class CapAt>
__device__ __forceinline__ int32_t factor_estimate_at(CapAt cap_at, const int64_t* req, int R) {
  bool any_req = false;
  int64_t est = kI32Max;  // the cap: at or above it the answer is replicas
  for (int i = 0; i < R; ++i) {
    const int64_t q = req[i];
    if (q <= 0) continue;
    any_req = true;
    const int64_t v = cap_at(i);
    if (v <= 0) {
      est = 0;
      break;
    }
    est = capped_div::capped_div(v, q, est);
    if (est == 0) break;
  }
  if (!any_req || est >= kI32Max) return kEstReplicas;
  return (int32_t)est;
}

__device__ inline int32_t factor_estimate(const int64_t* cap, const int64_t* req, int R) {
  return factor_estimate_at([cap](int i) { return cap[i]; }, req, R);
}

// factor_estimate through the request's reciprocals rcp[i] =
// capped_div::reciprocal(req[i]) (a request shared by many columns): one
// high multiply and one correction per requested resource. Equal to
// factor_estimate (the same sentinel, 0 for a resource with cap <= 0).
// kUnroll > 0 (R <= kUnroll) unrolls the resources, so a caller's
// capacities in a register array stay there.
template <int kUnroll = 0, class CapAt>
__device__ __forceinline__ int32_t factor_estimate_rcp_at(CapAt cap_at, const int64_t* req,
                                                          const uint64_t* rcp, int R) {
  bool any_req = false;
  uint64_t est = kI32Max;
#pragma unroll
  for (int i = 0; i < (kUnroll > 0 ? kUnroll : R); ++i) {
    if (kUnroll > 0 && i >= R) break;
    const int64_t q = req[i];
    if (q <= 0) continue;
    any_req = true;
    const int64_t v = cap_at(i);
    const uint64_t t = v <= 0 ? 0 : capped_div::floor_div_rcp((uint64_t)v, (uint64_t)q, rcp[i]);
    est = t < est ? t : est;
  }
  return (!any_req || est >= (uint64_t)kI32Max) ? kEstReplicas : (int32_t)est;
}

__device__ inline int32_t factor_estimate_rcp(const int64_t* cap, const int64_t* req,
                                              const uint64_t* rcp, int R) {
  return factor_estimate_rcp_at([cap](int i) { return cap[i]; }, req, rcp, R);
}

// A factored estimate with the row's clamps: the sentinel to the row's
// replicas, an unknown request to 0, then the min-merge with a
// non-negative registered-estimator answer `extra` (-1 = none).
__device__ __forceinline__ int32_t apply_row(int32_t e, int32_t reps, bool unknown,
                                             int32_t extra) {
  int32_t a = e == kEstReplicas ? reps : e;
  if (unknown) a = 0;
  if (extra >= 0 && extra < a) a = extra;
  return a;
}

// Fill the FilterArgs of a launch from its plain C arguments.
inline FilterArgs make_filter_args(
    const void* alive, const void* capacity, const void* has_summary,
    const void* taint_key, const void* taint_value, const void* taint_effect,
    const void* api_ok, int C, int R, int T, int G, const void* replicas,
    const void* unknown_request, const void* gvk, const void* tol_tables,
    const void* tol_idx, const void* aff_masks, const void* aff_idx,
    const void* prev_idx, const void* prev_rep, const void* evict_idx,
    const void* seeds, const void* req_unique, const void* req_idx, int B, int Kt,
    int Kp, int Ke, int plugin_bits, int has_extra, const void* extra_avail) {
  FilterArgs p;
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
  p.plugin_bits = plugin_bits;
  return p;
}

}  // namespace filter_common
