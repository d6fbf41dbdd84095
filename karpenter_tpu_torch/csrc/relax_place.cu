// relax_place: phase 1 of the two-phase solve, the dense waterfill, in one launch.
//
// Replaces the JAX package's device program
//   ops/relax.py:162 _relax_place_jit (_relax_impl :124, over
//   ops/relax_common.py eligibility :70, plan_groups :168, commit_assignment :299)
// and computes what ops/relax.relax_place_plain computes: the eligibility
// screen, bin-groups over adjacent byte-equal eligible pods, the template
// pick, the best-packing instance type and normalised demand, the waterfill
// slots, the real-gate rounding ladder, and the commit of claims, verdicts
// and topology counts.
//
// What bounds it on an H100: little. The work is a few hundred thousand
// instance-type tests (groups x templates x types, then claims x types per
// ladder rung) and a pass or two over the pods; the tables are L2-resident.
// What the stages need is ordering: each reads the previous one's result
// over the whole batch (group ids are a prefix count, slots a prefix sum).
//
// What the design does about it: ONE block walks the stages with block
// barriers between them, its threads spread over pods, groups x templates x
// types, or claims x types inside a stage. Sums whose float rounding depends
// on the order of their adds are taken in pod-index order by one thread per
// sum, exactly as the plain version takes them on the host: the group and
// claim request sums (a claim's pods are a contiguous range of its group),
// and the waterfill's float64 prefix sum over the batch. Integer and max
// reductions use atomics, whose order does not matter. So the kernel and the
// plain version agree bit for bit. Using more blocks for the type tests is
// later work; at the 10k shape this phase is small beside the repair loop.
//
// The kernel counts its instance-type tests and the topology lanes it
// records (WORK_*) into ``work``, so a run's operation bound is read from
// what this data needed.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// masks.cuh for why FMA contraction must stay off).
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

#include "topology.cuh"

using namespace kt;

namespace {

constexpr int THREADS = 512;
constexpr int KIND_CLAIM = 1;
constexpr int KIND_NEW_CLAIM = 2;
constexpr int KIND_FAIL = 3;
constexpr int TYPE_ANTI_AFFINITY = 2;

constexpr int WORK_TYPE_TESTS = 0;    // (row, instance type) survival tests
constexpr int WORK_RECORD_LANES = 1;  // (claim, group, lane) record tests
constexpr int NWORK = 2;

}  // namespace

// Field order is mirrored by _RELAX_POINTERS / _RELAX_INTS in
// karpenter_tpu_torch/ops/relax.py; relax_place_args_size() lets the wrapper
// check it.
struct RelaxArgs {
  // vocabulary
  const int* lvw;            // [K, W] lane_valid words
  const float* ln;           // [K, V] lane_numeric
  const uint8_t* wellknown;  // [K]
  // pods
  const int* pod_adm;  // [P, K, W]
  const uint8_t* pod_comp;
  const uint8_t* pod_def;
  const int* pod_gt;
  const int* pod_lt;
  const uint8_t* pod_neg;
  const float* pod_requests;    // [P, R]
  const uint8_t* pod_tol_tpl;   // [P, TPL]
  const uint8_t* pod_tol_node;  // [P, N]
  const uint8_t* pod_ports;     // [P, PT]
  const uint8_t* pod_conflict;  // [P, PT]
  const uint8_t* pod_match;     // [P, G]
  const uint8_t* pod_selects;   // [P, G]
  const uint8_t* pod_owned;     // [P, G]
  const int* pod_vols;          // [P, D]
  const uint8_t* pod_active;    // [P]
  // instance types
  const int* it_adm;
  const uint8_t* it_comp;
  const uint8_t* it_def;
  const int* it_gt;
  const int* it_lt;
  const uint8_t* it_neg;
  const float* it_alloc;  // [T, R]
  const float* it_cap;    // [T, R]
  const int* offer_zone;  // [T, O]
  const int* offer_ct;    // [T, O]
  const uint8_t* offer_ok;
  // templates
  const int* tpl_adm;
  const uint8_t* tpl_comp;
  const uint8_t* tpl_def;
  const int* tpl_gt;
  const int* tpl_lt;
  const uint8_t* tpl_neg;
  const float* tpl_overhead;  // [TPL, R]
  const uint8_t* tpl_it_ok;   // [TPL, T]
  const float* remaining;     // [TPL, R] NodePool headroom (+inf unlimited)
  // existing nodes (their initial state)
  const int* node_adm;
  const uint8_t* node_comp;
  const uint8_t* node_def;
  const int* node_gt;
  const int* node_lt;
  const uint8_t* node_neg;
  const float* node_overhead;  // [N, R]
  const float* node_avail;     // [N, R]
  const int* node_vol_used;    // [N, D]
  const int* node_vol_limits;  // [N, D]
  // topology groups
  const int* grp_type;
  const int* grp_key;
  const uint8_t* grp_inverse;
  const uint8_t* grp_has_filter;
  const int* flt_adm;  // [G, F, K, W]
  const uint8_t* flt_comp;
  const uint8_t* flt_def;
  const int* flt_gt;
  const int* flt_lt;
  const uint8_t* flt_neg;
  const uint8_t* flt_valid;  // [G, F]
  const int* host_lane;      // [CH]
  // the claim and topology state, initial on entry, committed on exit
  int* claim_adm;  // [C, K, W]
  uint8_t* claim_comp;
  uint8_t* claim_def;
  int* claim_gt;
  int* claim_lt;
  float* claim_requests;  // [C, R]
  uint8_t* claim_it_ok;   // [C, T]
  uint8_t* claim_open;
  int* claim_npods;
  int* claim_tpl;
  int* grp_counts;  // [G, V]
  uint8_t* grp_registered;
  // outputs
  int* kind;                 // [P]
  int* index;                // [P]
  uint8_t* residue;          // [P] pods the repair pass steps
  int* stats;                // [4] eligible, placed, demoted, claims
  unsigned long long* work;  // [NWORK]: WORK_* counters
  void* workspace;           // relax_place_workspace_bytes() bytes
  // dims
  int P, K, V, W, C, N, T, TPL, R, O, PT, D, G, F, CH, n_passes;
};

// The kernel's working arrays, carved out of RelaxArgs::workspace.
struct Workspace {
  uint8_t* elig0;     // [P] eligibility screen
  uint8_t* head;      // [P] group heads
  uint8_t* elig;      // [P] eligible, in a group below C with a template
  uint8_t* assigned;  // [P]
  int* gid;           // [P] group id (valid where elig0)
  int* binp;          // [P] waterfill bin within the group
  int* slot;          // [P] claim slot
  float* w;           // [P] normalised demand
  double* start;      // [P] exclusive prefix sum of w
  int* hp;            // [C] head pod of each group
  int* glast;         // [C] last pod of each group
  uint8_t* gvalid;    // [C]
  int* tpick;         // [C] picked template
  int* nbins;         // [C] highest bin of each group
  int* slotbase;      // [C] first slot of each group
  float* gmax;        // [C, R] elementwise-max member request
  float* gsum;        // [C, R] summed member requests
  float* capvec;      // [C, R] best-packing instance type's capacity
  int* m_adm;         // [C, TPL, K, W] template rows merged with the head's
  uint8_t* m_comp;    // [C, TPL, K]
  uint8_t* m_def;
  int* m_gt;
  int* m_lt;
  uint8_t* m_neg;
  uint8_t* tpl_compat;  // [C, TPL]
  uint8_t* it_ok_max;   // [C, TPL, T]
  int* g_of_c;          // [C] owning group of each claim slot
  int* cfirst;          // [C] first / last pod proposed for the slot
  int* clast;
  int* lastp;  // [C] last assigned pod
  int* firstp;
  int* npods;
  int* feas;
  uint8_t* open;
  int* r_adm;  // [C, K, W] claim rows (merged, pinned to the minted hostname)
  uint8_t* r_comp;
  uint8_t* r_def;
  int* r_gt;
  int* r_lt;
  uint8_t* r_neg;
  float* sums;  // [C, R]
  int* selcnt;  // [C, G] assigned pods selecting each recording group
};

namespace {

// Lay the workspace arrays out from ``base`` (16-byte aligned); returns the
// bytes needed. With base == nullptr only the size is computed.
size_t carve(const RelaxArgs& a, char* base, Workspace* s) {
  size_t off = 0;
  auto take = [&](auto& ptr, size_t n) {
    using T = std::remove_pointer_t<std::remove_reference_t<decltype(ptr)>>;
    off = (off + 15) & ~size_t(15);
    ptr = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += n * sizeof(T);
  };
  const size_t P = a.P, C = a.C, CT = (size_t)a.C * a.TPL, K = a.K, W = a.W;
  take(s->elig0, P);
  take(s->head, P);
  take(s->elig, P);
  take(s->assigned, P);
  take(s->gid, P);
  take(s->binp, P);
  take(s->slot, P);
  take(s->w, P);
  take(s->start, P);
  take(s->hp, C);
  take(s->glast, C);
  take(s->gvalid, C);
  take(s->tpick, C);
  take(s->nbins, C);
  take(s->slotbase, C);
  take(s->gmax, C * a.R);
  take(s->gsum, C * a.R);
  take(s->capvec, C * a.R);
  take(s->m_adm, CT * K * W);
  take(s->m_comp, CT * K);
  take(s->m_def, CT * K);
  take(s->m_gt, CT * K);
  take(s->m_lt, CT * K);
  take(s->m_neg, CT * K);
  take(s->tpl_compat, CT);
  take(s->it_ok_max, CT * a.T);
  take(s->g_of_c, C);
  take(s->cfirst, C);
  take(s->clast, C);
  take(s->lastp, C);
  take(s->firstp, C);
  take(s->npods, C);
  take(s->feas, C);
  take(s->open, C);
  take(s->r_adm, C * K * W);
  take(s->r_comp, C * K);
  take(s->r_def, C * K);
  take(s->r_gt, C * K);
  take(s->r_lt, C * K);
  take(s->r_neg, C * K);
  take(s->sums, C * a.R);
  take(s->selcnt, C * a.G);
  return off;
}

__device__ __forceinline__ Row pod_row(const RelaxArgs& a, int p) {
  return row_at(a.pod_adm, a.pod_comp, a.pod_def, a.pod_gt, a.pod_lt, p, a.K, a.W);
}

// ops/relax_common.eligibility for pod p.
__device__ bool eligible(const RelaxArgs& a, int p, bool all_inf) {
  if (!a.pod_active[p] || !all_inf) return false;
  for (int q = 0; q < a.PT; ++q)
    if (a.pod_ports[(long)p * a.PT + q] || a.pod_conflict[(long)p * a.PT + q]) return false;
  for (int g = 0; g < a.G; ++g) {
    const long pg = (long)p * a.G + g;
    if (a.pod_match[pg] || a.pod_owned[pg]) return false;
    if (a.pod_selects[pg] && (a.grp_inverse[g] || a.grp_type[g] == TYPE_ANTI_AFFINITY)) return false;
  }
  if (a.pod_def[(long)p * a.K + HOSTNAME_KEY]) return false;
  // an existing node that may take the pod keeps node-priority semantics
  const Row pod = pod_row(a, p);
  const uint8_t* pod_neg = a.pod_neg + (long)p * a.K;
  const float* req = a.pod_requests + (long)p * a.R;
  for (int n = 0; n < a.N; ++n) {
    if (!a.pod_tol_node[(long)p * a.N + n]) continue;
    if (!fits_add(a.node_overhead + (long)n * a.R, req, a.node_avail + (long)n * a.R, a.R)) continue;
    bool vol_ok = true;
    for (int d = 0; d < a.D; ++d)
      if (a.node_vol_used[(long)n * a.D + d] + a.pod_vols[(long)p * a.D + d] > a.node_vol_limits[(long)n * a.D + d])
        vol_ok = false;
    if (!vol_ok) continue;
    const Row node = row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, n, a.K, a.W);
    if (intersects_ok(pod, pod_neg, node, a.node_neg + (long)n * a.K, a.K, a.W)) return false;
  }
  return true;
}

// Pod p's requirement row and template tolerations equal pod p-1's.
__device__ bool same_as_prev(const RelaxArgs& a, int p) {
  const int K = a.K, KW = a.K * a.W;
  for (int i = 0; i < KW; ++i)
    if (a.pod_adm[(long)p * KW + i] != a.pod_adm[(long)(p - 1) * KW + i]) return false;
  for (int k = 0; k < K; ++k) {
    const long i = (long)p * K + k, j = (long)(p - 1) * K + k;
    if (a.pod_comp[i] != a.pod_comp[j] || a.pod_def[i] != a.pod_def[j] || a.pod_gt[i] != a.pod_gt[j] ||
        a.pod_lt[i] != a.pod_lt[j])
      return false;
  }
  for (int j = 0; j < a.TPL; ++j)
    if (a.pod_tol_tpl[(long)p * a.TPL + j] != a.pod_tol_tpl[(long)(p - 1) * a.TPL + j]) return false;
  return true;
}

// NodePool gate of template j and type t (ops/relax_common.plan_groups' prior).
__device__ __forceinline__ bool prior_ok(const RelaxArgs& a, int j, int t) {
  return a.tpl_it_ok[(long)j * a.T + t] && within_limits(a, j, t);
}

// The real instance-type gate of claim c's row plus its summed requests.
__device__ __forceinline__ bool claim_type_ok(const RelaxArgs& a, const Workspace& s, const ITs& its, int c, int t) {
  const int j = s.tpick[s.g_of_c[c]];
  const Row row = row_at(s.r_adm, s.r_comp, s.r_def, s.r_gt, s.r_lt, c, a.K, a.W);
  return prior_ok(a, j, t) && it_gate(row, s.r_neg + (long)c * a.K, a.tpl_overhead + (long)j * a.R,
                                      s.sums + (long)c * a.R, its, t, a.K, a.W, a.R, a.O);
}

// Each claim's summed requests over its assigned pods, in pod order.
__device__ void claim_sums(const RelaxArgs& a, const Workspace& s) {
  for (int i = threadIdx.x; i < a.C * a.R; i += THREADS) {
    const int c = i / a.R, r = i % a.R;
    float sum = 0.f;
    for (int p = s.cfirst[c]; p <= s.clast[c]; ++p)
      if (s.assigned[p] && s.slot[p] == c) sum += a.pod_requests[(long)p * a.R + r];
    s.sums[i] = sum;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1) relax_place_kernel(RelaxArgs a, Workspace s) {
  __shared__ int s_scan[THREADS];
  __shared__ int s_all_inf;
  __shared__ int s_stats[4];
  __shared__ unsigned long long s_work[NWORK];
  const int tid = threadIdx.x;
  const int P = a.P, K = a.K, W = a.W, C = a.C, T = a.T, TPL = a.TPL, R = a.R, G = a.G, V = a.V;
  const int CT = C * TPL;
  const ITs its = its_of(a);
  unsigned long long tests = 0;  // this thread's instance-type tests

  // -- 0. initial values
  if (tid == 0) {
    int all_inf = 1;
    for (int i = 0; i < a.TPL * R; ++i) all_inf &= isinf(a.remaining[i]) ? 1 : 0;
    s_all_inf = all_inf;
  }
  if (tid < 4) s_stats[tid] = 0;
  if (tid < NWORK) s_work[tid] = 0;
  for (int c = tid; c < C; c += THREADS) {
    s.hp[c] = 0;
    s.glast[c] = -1;
    s.gvalid[c] = 0;
    s.nbins[c] = -1;
    s.g_of_c[c] = 0;
    s.cfirst[c] = P;
    s.clast[c] = -1;
    s.firstp[c] = P;
    s.npods[c] = 0;
    s.open[c] = 0;
  }
  __syncthreads();

  // -- 1. eligibility, then group heads: an eligible pod whose predecessor is
  // ineligible or differs in requirement row or template tolerations
  for (int p = tid; p < P; p += THREADS) s.elig0[p] = eligible(a, p, s_all_inf);
  __syncthreads();
  for (int p = tid; p < P; p += THREADS) s.head[p] = s.elig0[p] && !(p > 0 && s.elig0[p - 1] && same_as_prev(a, p));
  __syncthreads();

  // -- 2. group ids: heads up to and including p, minus one (a block scan
  // over contiguous chunks of pods)
  const int chunk = (P + THREADS - 1) / THREADS;
  const int lo = min(P, tid * chunk), hi = min(P, lo + chunk);
  int nh = 0;
  for (int p = lo; p < hi; ++p) nh += s.head[p];
  s_scan[tid] = nh;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int i = 0; i < THREADS; ++i) {
      const int x = s_scan[i];
      s_scan[i] = run;
      run += x;
    }
  }
  __syncthreads();
  int run = s_scan[tid];
  for (int p = lo; p < hi; ++p) {
    run += s.head[p];
    s.gid[p] = run - 1;
  }
  __syncthreads();
  // the group axis is capped at C; a group's members are the contiguous
  // pods from its head to glast
  for (int p = tid; p < P; p += THREADS) {
    const int g = s.gid[p];
    const bool e = s.elig0[p] && g < C;
    s.elig[p] = e;
    if (e) {
      atomicMax(&s.glast[g], p);
      if (s.head[p]) {
        s.hp[g] = p;
        s.gvalid[g] = 1;
      }
    }
  }
  __syncthreads();

  // -- 3. each group's elementwise-max member request
  for (int i = tid; i < C * R; i += THREADS) {
    const int g = i / R, r = i % R;
    float m = 0.f;
    if (s.gvalid[g])
      for (int p = s.hp[g]; p <= s.glast[g]; ++p) m = fmaxf(m, a.pod_requests[(long)p * R + r]);
    s.gmax[i] = m;
  }

  // -- 4. every template's row merged with each group's head row, its
  // polarity, and template compatibility (with the well-known allowance)
  for (int i = tid; i < CT * K * W; i += THREADS) {
    const int ci = i / (K * W), kw = i % (K * W), g = ci / TPL, j = ci % TPL;
    if (s.gvalid[g]) s.m_adm[i] = a.tpl_adm[(long)j * K * W + kw] & a.pod_adm[(long)s.hp[g] * K * W + kw];
  }
  for (int i = tid; i < CT * K; i += THREADS) {
    const int ci = i / K, k = i % K, g = ci / TPL, j = ci % TPL;
    if (!s.gvalid[g]) continue;
    const long pk = (long)s.hp[g] * K + k, jk = (long)j * K + k;
    s.m_comp[i] = a.tpl_comp[jk] && a.pod_comp[pk];
    s.m_def[i] = a.tpl_def[jk] || a.pod_def[pk];
    s.m_gt[i] = max(a.tpl_gt[jk], a.pod_gt[pk]);
    s.m_lt[i] = min(a.tpl_lt[jk], a.pod_lt[pk]);
  }
  __syncthreads();
  for (int i = tid; i < CT * K; i += THREADS) {
    const int ci = i / K, k = i % K, g = ci / TPL;
    if (s.gvalid[g])
      s.m_neg[i] = negative_polarity_key(s.m_adm + (long)i * W, s.m_comp[i], s.m_gt[i], s.m_lt[i], a.lvw + k * W,
                                         a.ln + (long)k * V, W);
  }
  for (int ci = tid; ci < CT; ci += THREADS) {
    const int g = ci / TPL, j = ci % TPL;
    if (!s.gvalid[g]) continue;
    const Row tpl = row_at(a.tpl_adm, a.tpl_comp, a.tpl_def, a.tpl_gt, a.tpl_lt, j, K, W);
    s.tpl_compat[ci] =
        compatible_ok(tpl, a.tpl_neg + (long)j * K, pod_row(a, s.hp[g]), a.pod_neg + (long)s.hp[g] * K, a.wellknown, K, W);
  }
  __syncthreads();

  // -- 5. instance-type survival of each merged row against the group's
  // max member: if it fits a type per resource, every member does
  for (long i = tid; i < (long)CT * T; i += THREADS) {
    const int ci = (int)(i / T), t = (int)(i % T), g = ci / TPL, j = ci % TPL;
    bool ok = false;
    if (s.gvalid[g]) {
      ++tests;
      const Row m = row_at(s.m_adm, s.m_comp, s.m_def, s.m_gt, s.m_lt, ci, K, W);
      ok = prior_ok(a, j, t) && it_gate(m, s.m_neg + (long)ci * K, a.tpl_overhead + (long)j * R,
                                        s.gmax + (long)g * R, its, t, K, W, R, a.O);
    }
    s.it_ok_max[i] = ok;
  }
  __syncthreads();

  // -- 6. template pick: the first template the head tolerates, compatible
  // with the group, with a surviving instance type; a group with none goes
  // to the repair pass
  for (int g = tid; g < C; g += THREADS) {
    if (!s.gvalid[g]) continue;
    int pick = TPL;
    for (int j = 0; j < TPL && pick == TPL; ++j) {
      const int ci = g * TPL + j;
      if (!a.pod_tol_tpl[(long)s.hp[g] * TPL + j] || !s.tpl_compat[ci]) continue;
      for (int t = 0; t < T; ++t)
        if (s.it_ok_max[(long)ci * T + t]) {
          pick = j;
          break;
        }
    }
    if (pick == TPL) s.gvalid[g] = 0;
    s.tpick[g] = min(pick, TPL - 1);
  }
  __syncthreads();
  for (int p = tid; p < P; p += THREADS)
    if (s.elig[p] && !s.gvalid[s.gid[p]]) s.elig[p] = 0;
  __syncthreads();

  // -- 7. each group's request sum (in pod order) and its best-packing
  // instance type: the fewest fractional bins among the types the max
  // member survives on
  for (int i = tid; i < C * R; i += THREADS) {
    const int g = i / R, r = i % R;
    float sum = 0.f;
    if (s.gvalid[g])
      for (int p = s.hp[g]; p <= s.glast[g]; ++p) sum += a.pod_requests[(long)p * R + r];
    s.gsum[i] = sum;
  }
  __syncthreads();
  for (int g = tid; g < C; g += THREADS) {
    if (!s.gvalid[g]) continue;
    const int j = s.tpick[g];
    const float* ov = a.tpl_overhead + (long)j * R;
    const float* gs = s.gsum + (long)g * R;
    const uint8_t* ok = s.it_ok_max + (long)(g * TPL + j) * T;
    float best = INFINITY;
    int tau = 0;
    for (int t = 0; t < T; ++t) {
      float frac = 0.f;
      bool no_room = false;
      for (int r = 0; r < R; ++r) {
        if (!(gs[r] > 0.f)) continue;
        const float cap = a.it_alloc[(long)t * R + r] - ov[r];
        frac = fmaxf(frac, gs[r] / fmaxf(cap, 1e-9f));
        no_room |= cap <= 0.f;
      }
      const float v = (ok[t] && !no_room) ? frac : INFINITY;
      if (v < best) {  // the first minimum, as argmin takes it
        best = v;
        tau = t;
      }
    }
    for (int r = 0; r < R; ++r) s.capvec[(long)g * R + r] = a.it_alloc[(long)tau * R + r] - ov[r];
  }
  __syncthreads();

  // -- 8. each eligible pod's demand, normalised by its group's capacity
  for (int p = tid; p < P; p += THREADS) {
    float size = 0.f;
    if (s.elig[p]) {
      const float* cv = s.capvec + (long)s.gid[p] * R;
      const float* req = a.pod_requests + (long)p * R;
      for (int r = 0; r < R; ++r)
        if (req[r] > 0.f) size = fmaxf(size, req[r] / fmaxf(cv[r], 1e-9f));
      size = fminf(fmaxf(size, 1e-6f), 1.0f);
    }
    s.w[p] = size;
  }
  __syncthreads();

  // -- 9. the waterfill: one float64 prefix sum in pod order
  // (ops/relax.waterfill_bins); a pod's bin is floor(level + 1e-6) with level
  // the demand of its group's earlier pods; a group takes as many slots as
  // its highest bin, in group order
  if (tid == 0) {
    double acc = 0.0;
    for (int p = 0; p < P; ++p) {
      s.start[p] = acc;
      acc += (double)s.w[p];
    }
  }
  __syncthreads();
  for (int p = tid; p < P; p += THREADS) {
    if (!s.elig[p]) continue;
    const int g = s.gid[p];
    const double level = s.start[p] - s.start[s.hp[g]];
    const int b = max((int)floor(level + 1e-6), 0);
    s.binp[p] = b;
    atomicMax(&s.nbins[g], b);
  }
  __syncthreads();
  if (tid == 0) {
    int base = 0;
    for (int g = 0; g < C; ++g) {
      s.slotbase[g] = base;
      base += s.gvalid[g] ? s.nbins[g] + 1 : 0;
    }
  }
  __syncthreads();
  // slots beyond C overflow to the repair pass
  for (int p = tid; p < P; p += THREADS) {
    bool as = false;
    if (s.elig[p]) {
      const int sl = s.slotbase[s.gid[p]] + s.binp[p];
      s.slot[p] = sl;
      as = sl < C;
      if (as) {
        atomicMax(&s.g_of_c[sl], s.gid[p]);
        atomicMin(&s.cfirst[sl], p);
        atomicMax(&s.clast[sl], p);
      }
    }
    s.assigned[p] = as;
  }
  __syncthreads();

  // -- 10. claim rows: the owning group's merged template row, pinned to the
  // slot's minted hostname (ffd_core._pin_hostname)
  for (int i = tid; i < C * K * W; i += THREADS) {
    const int c = i / (K * W), kw = i % (K * W);
    if (s.clast[c] < 0) continue;
    const int g = s.g_of_c[c], ci = g * TPL + s.tpick[g];
    int word = s.m_adm[(long)ci * K * W + kw];
    if (a.CH > 0 && kw / W == HOSTNAME_KEY) {
      const int lane = a.host_lane[min(c, a.CH - 1)];
      word &= (kw % W == (lane >> 5)) ? (int)(1u << (lane & 31)) : 0;
    }
    s.r_adm[i] = word;
  }
  for (int i = tid; i < C * K; i += THREADS) {
    const int c = i / K, k = i % K;
    if (s.clast[c] < 0) continue;
    const int g = s.g_of_c[c];
    const long mi = (long)(g * TPL + s.tpick[g]) * K + k;
    const bool pin = a.CH > 0 && k == HOSTNAME_KEY;
    s.r_comp[i] = pin ? 0 : s.m_comp[mi];
    s.r_def[i] = pin ? 1 : s.m_def[mi];
    s.r_gt[i] = s.m_gt[mi];
    s.r_lt[i] = s.m_lt[mi];
  }
  __syncthreads();
  for (int i = tid; i < C * K; i += THREADS) {
    const int c = i / K, k = i % K;
    if (s.clast[c] >= 0)
      s.r_neg[i] = negative_polarity_key(s.r_adm + (long)i * W, s.r_comp[i], s.r_gt[i], s.r_lt[i], a.lvw + k * W,
                                         a.ln + (long)k * V, W);
  }
  __syncthreads();

  // -- 11. the rounding ladder: each rung demotes the last-assigned pod of
  // every claim the real gate rejects; the final rung demotes whole claims
  for (int rung = 0; rung <= a.n_passes; ++rung) {
    for (int c = tid; c < C; c += THREADS) {
      s.feas[c] = 0;
      s.lastp[c] = -1;
    }
    claim_sums(a, s);  // ends in a barrier
    for (long i = tid; i < (long)C * T; i += THREADS) {
      const int c = (int)(i / T), t = (int)(i % T);
      if (s.clast[c] < 0) continue;
      ++tests;
      if (claim_type_ok(a, s, its, c, t)) s.feas[c] = 1;
    }
    for (int p = tid; p < P; p += THREADS)
      if (s.assigned[p]) atomicMax(&s.lastp[s.slot[p]], p);
    __syncthreads();
    for (int p = tid; p < P; p += THREADS) {
      if (!s.assigned[p]) continue;
      const int c = s.slot[p];
      if (!s.feas[c] && (rung == a.n_passes || p == s.lastp[c])) s.assigned[p] = 0;
    }
    __syncthreads();
  }

  // -- 12. commit the surviving claims
  for (int c = tid; c < C; c += THREADS) s.feas[c] = 0;
  claim_sums(a, s);
  for (int p = tid; p < P; p += THREADS) {
    if (!s.assigned[p]) continue;
    atomicAdd(&s.npods[s.slot[p]], 1);
    atomicMin(&s.firstp[s.slot[p]], p);
  }
  for (long i = tid; i < (long)C * T; i += THREADS) {
    const int c = (int)(i / T), t = (int)(i % T);
    bool ok = false;
    if (s.clast[c] >= 0) {
      ++tests;
      ok = claim_type_ok(a, s, its, c, t);
    }
    a.claim_it_ok[i] = ok;
    if (ok) s.feas[c] = 1;
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    const bool open = s.npods[c] > 0 && s.feas[c];
    const int j = s.tpick[s.g_of_c[c]];
    s.open[c] = open;
    a.claim_open[c] = open;
    a.claim_npods[c] = open ? s.npods[c] : 0;
    a.claim_tpl[c] = open ? j : 0;
    for (int r = 0; r < R; ++r)
      a.claim_requests[(long)c * R + r] = open ? a.tpl_overhead[(long)j * R + r] + s.sums[(long)c * R + r] : 0.f;
    if (open) atomicAdd(&s_stats[3], 1);
  }
  __syncthreads();
  for (long i = tid; i < (long)C * T; i += THREADS)
    if (!s.open[i / T]) a.claim_it_ok[i] = 0;
  for (int i = tid; i < C * K * W; i += THREADS)
    if (s.open[i / (K * W)]) a.claim_adm[i] = s.r_adm[i];
  for (int i = tid; i < C * K; i += THREADS) {
    if (!s.open[i / K]) continue;
    a.claim_comp[i] = s.r_comp[i];
    a.claim_def[i] = s.r_def[i];
    a.claim_gt[i] = s.r_gt[i];
    a.claim_lt[i] = s.r_lt[i];
  }

  // -- 13. topology: an open claim registers its minted hostname lane for
  // every hostname-keyed group, and records its row once per assigned pod
  // that selects a group (ops/topology_kernels.record_delta with an
  // all-select probe; eligible pods own no group)
  if (G > 0) {
    if (a.CH > 0)
      for (int i = tid; i < C * G; i += THREADS) {
        const int c = i / G, g = i % G;
        if (s.open[c] && a.grp_key[g] == HOSTNAME_KEY) a.grp_registered[(long)g * V + a.host_lane[min(c, a.CH - 1)]] = 1;
      }
    const TopoGroups tg = topo_of(a);
    for (int i = tid; i < C * G; i += THREADS) {
      const int c = i / G, g = i % G;
      int n = 0;
      if (s.open[c]) {
        for (int p = s.cfirst[c]; p <= s.clast[c]; ++p)
          if (s.assigned[p] && s.slot[p] == c && a.pod_selects[(long)p * G + g]) ++n;
        const Row row = row_at(s.r_adm, s.r_comp, s.r_def, s.r_gt, s.r_lt, c, K, W);
        if (n > 0 && !records_group(tg, g, row, s.r_neg + (long)c * K, true, false, a.wellknown, K, W)) n = 0;
      }
      s.selcnt[i] = n;
    }
    __syncthreads();
    unsigned long long lanes = 0;
    for (long i = tid; i < (long)G * V; i += THREADS) {
      const int g = (int)(i / V), v = (int)(i % V), kg = a.grp_key[g];
      int add = 0;
      for (int c = 0; c < C; ++c) {
        const int n = s.selcnt[(long)c * G + g];
        if (n > 0) {
          ++lanes;
          if (bit_of(s.r_adm + ((long)c * K + kg) * W, v)) add += n;
        }
      }
      if (add > 0) {
        a.grp_counts[i] += add;
        a.grp_registered[i] = 1;
      }
    }
    atomicAdd(&s_work[WORK_RECORD_LANES], lanes);
  }

  // -- 14. verdicts, residue and stats
  for (int p = tid; p < P; p += THREADS) {
    const bool as = s.assigned[p];
    a.kind[p] = as ? (p == s.firstp[s.slot[p]] ? KIND_NEW_CLAIM : KIND_CLAIM) : KIND_FAIL;
    a.index[p] = as ? s.slot[p] : -1;
    a.residue[p] = a.pod_active[p] && !as;
    if (s.elig0[p]) {
      atomicAdd(&s_stats[0], 1);
      if (!as) atomicAdd(&s_stats[2], 1);
    }
    if (as) atomicAdd(&s_stats[1], 1);
  }
  atomicAdd(&s_work[WORK_TYPE_TESTS], tests);
  __syncthreads();
  if (tid < 4) a.stats[tid] = s_stats[tid];
  if (tid < NWORK) a.work[tid] = s_work[tid];
}

}  // namespace

extern "C" int relax_place_args_size() { return (int)sizeof(RelaxArgs); }

// Bytes of workspace the wrapper allocates for these dims.
extern "C" long long relax_place_workspace_bytes(const RelaxArgs* args) {
  Workspace s;
  return (long long)carve(*args, nullptr, &s);
}

// Launch on ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int relax_place_launch(const RelaxArgs* args, void* stream) {
  Workspace s;
  carve(*args, static_cast<char*>(args->workspace), &s);
  relax_place_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*args, s);
  return (int)cudaGetLastError();
}
