// Requirement-mask algebra as __device__ functions, shared by the FFD loop
// kernel (ffd_loop.cu), the phase-1 waterfill kernel (relax_place.cu) and the
// invariant-gate kernel (gate_counts.cu).
//
// Device counterpart of karpenter_tpu_torch/ops/masks.py (and of the JAX
// package's ops/masks.py): closed-world requirement rows over a per-batch
// label vocabulary (see models/problem.py). A row of one entity holds, per
// label key k:
//
//   adm[k*W + w]  int32 word w of the admitted-lane bits (lane 32w+i is bit i)
//   comp[k]       uint8 complement set (admits values outside the vocabulary)
//   def[k]        uint8 key present in the requirement map
//   gt[k], lt[k]  int32 integer bounds, sentinels GT_NONE / LT_NONE
//
// Every function here evaluates the general (bounded) arm; on problems with
// no Gt/Lt bound anywhere the bounds are sentinels and the answers equal the
// JAX package's bounds-free arm.
//
// Build with -fmad=false: fits() must round 1e-6 + 1e-6*|a| as two separate
// float32 operations, exactly like the plain PyTorch version, or a boundary
// fit verdict can flip and send a whole solve down another path.
#pragma once

#include <cstdint>

namespace kt {

constexpr int GT_NONE = -2147483647;  // -(2**31) + 1
constexpr int LT_NONE = 2147483647;   // 2**31 - 1
constexpr int MAXI = 2147483647;
constexpr int ZONE_KEY = 0;
constexpr int CT_KEY = 1;
constexpr int HOSTNAME_KEY = 2;

// One requirement row's pointers (already offset to the entity).
struct Row {
  const int* adm;
  const uint8_t* comp;
  const uint8_t* def;
  const int* gt;
  const int* lt;
};

__device__ __forceinline__ Row row_at(const int* adm, const uint8_t* comp, const uint8_t* def,
                                      const int* gt, const int* lt, long e, int K, int W) {
  Row r;
  r.adm = adm + e * K * W;
  r.comp = comp + e * K;
  r.def = def + e * K;
  r.gt = gt + e * K;
  r.lt = lt + e * K;
  return r;
}

__device__ __forceinline__ bool bit_of(const int* words, int v) {
  return (static_cast<unsigned>(words[v >> 5]) >> (v & 31)) & 1u;
}

// Lanes satisfying the integer bounds (requirement.go:238-254) are folded into
// negative_polarity below: unbounded keys admit every valid lane.
__device__ __forceinline__ bool unbounded(int gt, int lt) { return gt <= GT_NONE && lt >= LT_NONE; }

// Operator() in {NotIn, DoesNotExist} for key k of a row (requirement.go:197-208):
// a complement reads NotIn when it excludes some in-bounds vocab value; a
// concrete set reads DoesNotExist when no lane is admitted.
__device__ inline bool negative_polarity_key(const int* adm_k, bool comp, int gt, int lt,
                                             const int* lvw_k, const float* ln_k, int W) {
  if (!comp) {
    for (int w = 0; w < W; ++w)
      if (adm_k[w] != 0) return false;
    return true;
  }
  if (unbounded(gt, lt)) {
    for (int w = 0; w < W; ++w)
      if (lvw_k[w] & ~adm_k[w]) return true;
    return false;
  }
  const float fgt = static_cast<float>(gt);
  const float flt = static_cast<float>(lt);
  for (int v = 0; v < 32 * W; ++v) {
    if (!bit_of(lvw_k, v) || bit_of(adm_k, v)) continue;
    const float x = ln_k[v];
    if (x == x && x > fgt && x < flt) return true;
  }
  return false;
}

// nonempty(intersect(a, b)) for key k (requirement.go:128-161, 210-215).
__device__ __forceinline__ bool merged_nonempty_key(const Row& a, const Row& b, int k, int W) {
  for (int w = 0; w < W; ++w)
    if (a.adm[k * W + w] & b.adm[k * W + w]) return true;
  if (!(a.comp[k] && b.comp[k])) return false;
  const int gt = max(a.gt[k], b.gt[k]);
  const int lt = min(a.lt[k], b.lt[k]);
  return gt < lt;
}

// Requirements.Intersects (requirements.go:241-258) from precomputed
// per-key polarities of both rows.
__device__ inline bool intersects_ok(const Row& a, const uint8_t* a_neg, const Row& b,
                                     const uint8_t* b_neg, int K, int W) {
  for (int k = 0; k < K; ++k) {
    if (!(a.def[k] && b.def[k])) continue;
    if (a_neg[k] && b_neg[k]) continue;
    if (!merged_nonempty_key(a, b, k, W)) return false;
  }
  return true;
}

// Requirements.Compatible (requirements.go:163-174): incoming keys undefined on
// r must be allowed-undefined or of negative polarity; then the rows intersect.
__device__ inline bool compatible_ok(const Row& r, const uint8_t* r_neg, const Row& inc,
                                     const uint8_t* inc_neg, const uint8_t* allow, int K, int W) {
  for (int k = 0; k < K; ++k)
    if (inc.def[k] && !r.def[k] && !(allow && allow[k]) && !inc_neg[k]) return false;
  return intersects_ok(r, r_neg, inc, inc_neg, K, W);
}

// resources.Fits: requests <= avail + (1e-6 + 1e-6*|avail|) on every resource.
__device__ __forceinline__ bool fits_add(const float* base, const float* add, const float* avail, int R) {
  for (int r = 0; r < R; ++r) {
    const float a = avail[r];
    const float eps = 1e-6f + 1e-6f * fabsf(a);
    const float req = add ? base[r] + add[r] : base[r];
    if (!(req <= a + eps)) return false;
  }
  return true;
}

// has_offering (nodeclaim.go:270-278): some available offering of type t has
// its zone and capacity-type lanes admitted by the row.
__device__ __forceinline__ bool has_offering(const int* adm, int W, const int* zone_t,
                                             const int* ct_t, const uint8_t* ok_t, int O) {
  const int* zw = adm + ZONE_KEY * W;
  const int* cw = adm + CT_KEY * W;
  for (int o = 0; o < O; ++o)
    if (ok_t[o] && bit_of(zw, zone_t[o]) && bit_of(cw, ct_t[o])) return true;
  return false;
}

// Instance-type tables of the problem.
struct ITs {
  const int* adm;
  const uint8_t* comp;
  const uint8_t* def;
  const int* gt;
  const int* lt;
  const uint8_t* neg;
  const float* alloc;
  const int* offer_zone;
  const int* offer_ct;
  const uint8_t* offer_ok;
};

// The instance-type tables of a kernel's argument struct.
template <class A>
__device__ __forceinline__ ITs its_of(const A& a) {
  ITs its;
  its.adm = a.it_adm;
  its.comp = a.it_comp;
  its.def = a.it_def;
  its.gt = a.it_gt;
  its.lt = a.it_lt;
  its.neg = a.it_neg;
  its.alloc = a.it_alloc;
  its.offer_zone = a.offer_zone;
  its.offer_ct = a.offer_ct;
  its.offer_ok = a.offer_ok;
  return its;
}

// NodePool limits: template j's pessimistic capacity of type t fits its
// remaining headroom.
template <class A>
__device__ __forceinline__ bool within_limits(const A& a, int j, int t) {
  return fits_add(a.it_cap + (long)t * a.R, nullptr, a.remaining + (long)j * a.R, a.R);
}

// The instance-type survival test of one bin row against type t
// (ffd_core._make_it_gate): compatible x fits x offering.
__device__ inline bool it_gate(const Row& bin, const uint8_t* bin_neg, const float* req_base,
                               const float* req_add, const ITs& its, int t, int K, int W, int R,
                               int O) {
  Row it = row_at(its.adm, its.comp, its.def, its.gt, its.lt, t, K, W);
  if (!intersects_ok(bin, bin_neg, it, its.neg + (long)t * K, K, W)) return false;
  if (!fits_add(req_base, req_add, its.alloc + (long)t * R, R)) return false;
  return has_offering(bin.adm, W, its.offer_zone + (long)t * O, its.offer_ct + (long)t * O,
                      its.offer_ok + (long)t * O, O);
}

}  // namespace kt
