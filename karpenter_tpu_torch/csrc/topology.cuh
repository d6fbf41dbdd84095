// Topology device code shared by the FFD loop kernel (ffd_loop.cu) and the
// phase-1 waterfill kernel (relax_place.cu).
//
// Device counterpart of karpenter_tpu_torch/ops/topology_kernels.record_delta
// (Topology.Record, reference topology.go:125-148).
#pragma once

#include "masks.cuh"

namespace kt {

// The problem's topology groups and their node filters.
struct TopoGroups {
  const int* type;  // [G] 0 spread / 1 affinity / 2 anti-affinity
  const int* key;   // [G]
  const uint8_t* inverse;
  const uint8_t* has_filter;
  const int* flt_adm;  // [G, F, K, W]
  const uint8_t* flt_comp;
  const uint8_t* flt_def;
  const int* flt_gt;
  const int* flt_lt;
  const uint8_t* flt_neg;
  const uint8_t* flt_valid;  // [G, F]
  int F;
};

template <class A>
__device__ __forceinline__ TopoGroups topo_of(const A& a) {
  TopoGroups tg;
  tg.type = a.grp_type;
  tg.key = a.grp_key;
  tg.inverse = a.grp_inverse;
  tg.has_filter = a.grp_has_filter;
  tg.flt_adm = a.flt_adm;
  tg.flt_comp = a.flt_comp;
  tg.flt_def = a.flt_def;
  tg.flt_gt = a.flt_gt;
  tg.flt_lt = a.flt_lt;
  tg.flt_neg = a.flt_neg;
  tg.flt_valid = a.flt_valid;
  tg.F = a.F;
  return tg;
}

// Whether group g records a pod committed to a bin whose final row is
// ``row``: every admitted lane of the row on the group's key is then counted
// once. The key must be concrete in the row and the row must pass the
// group's node filter; spread and affinity groups record only a single
// domain; an inverse group records the pods that own it.
__device__ inline bool records_group(const TopoGroups& tg, int g, const Row& row, const uint8_t* row_neg,
                                     bool selects, bool owned, const uint8_t* allow, int K, int W) {
  const int kg = tg.key[g];
  const bool concrete = !row.comp[kg];
  bool filt = !tg.has_filter[g];
  for (int f = 0; f < tg.F && !filt; ++f) {
    const long gf = (long)g * tg.F + f;
    if (!tg.flt_valid[gf]) continue;
    const Row term = row_at(tg.flt_adm, tg.flt_comp, tg.flt_def, tg.flt_gt, tg.flt_lt, gf, K, W);
    filt = compatible_ok(row, row_neg, term, tg.flt_neg + gf * K, allow, K, W);
  }
  int pop = 0;
  for (int w = 0; w < W; ++w) pop += __popc(row.adm[kg * W + w]);
  const int type = tg.type[g];
  const bool regular = selects && filt && !tg.inverse[g] && concrete && ((type == 0 || type == 1) ? pop == 1 : true);
  const bool inverse = tg.inverse[g] && owned && concrete;
  return regular || inverse;
}

}  // namespace kt
