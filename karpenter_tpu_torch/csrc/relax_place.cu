// relax_place: phase 1 of the two-phase solve in one launch: the dense
// waterfill, or (mode 1) the convex projected-gradient solve.
//
// Replaces the JAX package's device programs
//   ops/relax.py:162 _relax_place_jit (_relax_impl :124, over
//   ops/relax_common.py eligibility :70, plan_groups :168, commit_assignment :299)
//   ops/relax2.py:314 _relax2_place_jit (_relax2_impl :226, _pgd_step_op :179,
//   _round_lff :197; program 17), in mode 1
//   parallel/mesh.py:517 shard_relax2_sweeps_program's phase 1 (program 14),
//   in mode 1 with one block per partition (relax_place_lanes_launch)
// and computes what ops/relax.relax_place_plain (mode 0) and
// ops/relax2.relax2_place_plain (mode 1) compute: the eligibility screen,
// bin-groups over adjacent byte-equal eligible pods, the template pick, the
// best-packing instance type and normalised demand, the slots (the waterfill's,
// or the convex mode's windows, trips and largest-fraction-first rounding),
// the real-gate rounding ladder, and the commit of claims, verdicts and
// topology counts.
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
// The convex mode (stage 9c) replaces the waterfill's stage 9. Its
// fractional assignment X (P x 16 floats, 655 KB at 10k) lives in the
// workspace. Each trip takes every bin's load with one warp per bin,
// adding its contributing pods in pod order (a bin's contributors are a
// contiguous run of its group's pods, whose preferred bins never decrease;
// the lanes read 32 of them at once and each lane adds the 32 products in
// order), then updates the rows with one thread per pod (a row's 16 columns
// summed in order), with block barriers between the two. The rounding compacts each bin's candidates in pod order
// (a warp per bin), ranks each by descending share then pod index (a
// thread per candidate, counting over its bin), and admits them in rank
// order while the bin's running load stays within 1 + 1e-6. These are the
// plain version's orders, so the two agree bit for bit.
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
constexpr int NWARPS = THREADS / 32;
constexpr int KIND_CLAIM = 1;
constexpr int KIND_NEW_CLAIM = 2;
constexpr int KIND_FAIL = 3;
constexpr int TYPE_ANTI_AFFINITY = 2;

constexpr int WORK_TYPE_TESTS = 0;    // (row, instance type) survival tests
constexpr int WORK_RECORD_LANES = 1;  // (claim, group, lane) record tests
constexpr int WORK_PGD_COLUMNS = 2;   // mode 1: valid (pod, window column) pairs times trips
constexpr int NWORK = 3;

// the convex mode's constants (ops/relax2.py)
constexpr int WINDOW = 16;
constexpr float RHO = 8.0f;
constexpr float GAMMA = 0.02f;
constexpr float BETA = 0.05f;
constexpr float MIN_REL_MASS = 0.9999f;
constexpr float SCAN_TOL = 0.001f;
constexpr float ADMIT = 1.000001f;
constexpr int NSTATS = 9;

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
  int* stats;                // [NSTATS] eligible, placed, demoted, claims; mode 1 also
                             // pgd_iterations, residual and capviol (float bits),
                             // overflow, round_demoted
  unsigned long long* work;  // [NWORK]: WORK_* counters
  void* workspace;           // relax_place_workspace_bytes() bytes
  // dims
  int P, K, V, W, C, N, T, TPL, R, O, PT, D, G, F, CH, n_passes, mode, iters;
  float step;  // mode 1: the gradient step
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
  // the convex mode
  float* X;      // [P, WINDOW] fractional assignment
  int* pref;     // [P] preferred (warm-start) bin
  int* lo;       // [P] first slot of the pod's group
  int* vmask;    // [P] valid window columns
  int* key_bin;  // [P] rounded bin (C when repaired)
  float* frac;   // [P] best share
  int* border;   // [P] candidates by bin, in pod order
  float* cfrac;  // [P] their best shares
  int* sorted;   // [P] candidates by bin, then descending share
  float* gw;     // [C] group mass
  float* load;   // [C] bin load
  int* bfirst;   // [C] first / last pod whose window covers the bin
  int* blast;
  int* bcount;   // [C] candidates per bin
  int* bbase;    // [C] first border entry of the bin
};

namespace {

// One array of ``n`` T at the next 16-byte boundary after ``off``.
template <class T>
__host__ __device__ __forceinline__ void take_n(T*& ptr, size_t n, char* base, size_t& off) {
  off = (off + 15) & ~size_t(15);
  ptr = base ? reinterpret_cast<T*>(base + off) : nullptr;
  off += n * sizeof(T);
}

// Lay the workspace arrays out from ``base`` (16-byte aligned); returns the
// bytes needed. With base == nullptr only the size is computed. Host and
// device: the lanes mode carves each lane's workspace in its own block.
__host__ __device__ size_t carve(const RelaxArgs& a, char* base, Workspace* s) {
  size_t off = 0;
  const size_t P = a.P, C = a.C, CT = (size_t)a.C * a.TPL, K = a.K, W = a.W;
  take_n(s->elig0, P, base, off);
  take_n(s->head, P, base, off);
  take_n(s->elig, P, base, off);
  take_n(s->assigned, P, base, off);
  take_n(s->gid, P, base, off);
  take_n(s->binp, P, base, off);
  take_n(s->slot, P, base, off);
  take_n(s->w, P, base, off);
  take_n(s->start, P, base, off);
  take_n(s->hp, C, base, off);
  take_n(s->glast, C, base, off);
  take_n(s->gvalid, C, base, off);
  take_n(s->tpick, C, base, off);
  take_n(s->nbins, C, base, off);
  take_n(s->slotbase, C, base, off);
  take_n(s->gmax, C * a.R, base, off);
  take_n(s->gsum, C * a.R, base, off);
  take_n(s->capvec, C * a.R, base, off);
  take_n(s->m_adm, CT * K * W, base, off);
  take_n(s->m_comp, CT * K, base, off);
  take_n(s->m_def, CT * K, base, off);
  take_n(s->m_gt, CT * K, base, off);
  take_n(s->m_lt, CT * K, base, off);
  take_n(s->m_neg, CT * K, base, off);
  take_n(s->tpl_compat, CT, base, off);
  take_n(s->it_ok_max, CT * a.T, base, off);
  take_n(s->g_of_c, C, base, off);
  take_n(s->cfirst, C, base, off);
  take_n(s->clast, C, base, off);
  take_n(s->lastp, C, base, off);
  take_n(s->firstp, C, base, off);
  take_n(s->npods, C, base, off);
  take_n(s->feas, C, base, off);
  take_n(s->open, C, base, off);
  take_n(s->r_adm, C * K * W, base, off);
  take_n(s->r_comp, C * K, base, off);
  take_n(s->r_def, C * K, base, off);
  take_n(s->r_gt, C * K, base, off);
  take_n(s->r_lt, C * K, base, off);
  take_n(s->r_neg, C * K, base, off);
  take_n(s->sums, C * a.R, base, off);
  take_n(s->selcnt, C * a.G, base, off);
  if (a.mode == 1) {
    take_n(s->X, P * WINDOW, base, off);
    take_n(s->pref, P, base, off);
    take_n(s->lo, P, base, off);
    take_n(s->vmask, P, base, off);
    take_n(s->key_bin, P, base, off);
    take_n(s->frac, P, base, off);
    take_n(s->border, P, base, off);
    take_n(s->cfrac, P, base, off);
    take_n(s->sorted, P, base, off);
    take_n(s->gw, C, base, off);
    take_n(s->load, C, base, off);
    take_n(s->bfirst, C, base, off);
    take_n(s->blast, C, base, off);
    take_n(s->bcount, C, base, off);
    take_n(s->bbase, C, base, off);
  }
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

// -- 9c. the convex mode's slots (ops/relax2.relax2_place_plain): each
// group's bins, the warm start and windows, the projected-gradient trips,
// and the largest-fraction-first rounding. Called by every thread.
__device__ void convex_slots(const RelaxArgs& a, const Workspace& s, int* s_stats, unsigned long long* s_work) {
  __shared__ unsigned s_dmax;  // the trip's max |dX| (float bits; nonnegative)
  __shared__ unsigned s_cmax;  // the final max overload (float bits)
  __shared__ int s_conv;
  __shared__ float s_delta;
  __shared__ int s_ncand;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int P = a.P, C = a.C;

  // each group's mass (its pods in order) and bins: ceil(mass) + 1
  for (int g = tid; g < C; g += THREADS) {
    float m = 0.f;
    if (s.gvalid[g])
      for (int p = s.hp[g]; p <= s.glast[g]; ++p)
        if (s.elig[p]) m += s.w[p];
    s.gw[g] = m;
    s.nbins[g] = (s.gvalid[g] && m > 0.f) ? min((int)ceilf(m) + 1, C) : 0;
  }
  if (tid == 0) {
    s_conv = -1;
    s_dmax = 0;
    s_cmax = 0;
    s_delta = INFINITY;
  }
  __syncthreads();
  if (tid == 0) {
    int base = 0;
    for (int g = 0; g < C; ++g) {
      s.slotbase[g] = base;
      base += s.nbins[g];
    }
  }
  __syncthreads();

  // the warm start at the waterfill bin (the float64 prefix sum of stage 9),
  // the window's valid columns, and each bin's range of covering pods
  unsigned long long cols = 0;
  int overflow = 0;
  for (int p = tid; p < P; p += THREADS) {
    float* x = s.X + (long)p * WINDOW;
    int vm = 0;
    if (s.elig[p]) {
      const int g = s.gid[p];
      const int lo = s.slotbase[g], hi = lo + s.nbins[g];
      const double level = s.start[p] - s.start[s.hp[g]];
      const int pref = min(lo + max((int)floor(level + 1e-6), 0), max(hi - 1, lo));
      for (int j = 0; j < WINDOW; ++j) {
        const int c = pref + j - WINDOW / 2;
        const bool v = c >= lo && c < hi && c < C;
        if (v) {
          vm |= 1 << j;
          atomicMin(&s.bfirst[c], p);
          atomicMax(&s.blast[c], p);
        }
        x[j] = (v && c == pref) ? 1.f : 0.f;
      }
      s.pref[p] = pref;
      s.lo[p] = lo;
      if (!vm) ++overflow;
    } else {
      for (int j = 0; j < WINDOW; ++j) x[j] = 0.f;
    }
    s.vmask[p] = vm;
    cols += __popc(vm);
  }
  if (overflow) atomicAdd(&s_stats[7], overflow);
  atomicAdd(&s_work[WORK_PGD_COLUMNS], cols * (unsigned long long)(a.iters + 1));
  __syncthreads();

  // the trips; the last pass (t == iters) takes the final loads only
  for (int t = 0; t <= a.iters; ++t) {
    // each bin's load, its covering pods added in pod order: a warp per
    // bin, its lanes reading 32 pods at once, lane 0 adding their products
    // in order (a pod that does not cover the bin adds +0, which changes
    // no sum of nonnegative terms)
    for (int c = warp; c < C; c += NWARPS) {
      float l = 0.f;
      const int last = s.blast[c];
      for (int base = s.bfirst[c]; base <= last; base += 32) {
        const int p = base + lane;
        float v = 0.f;
        if (p <= last) {
          const int j = c - s.pref[p] + WINDOW / 2;
          if (j >= 0 && j < WINDOW && ((s.vmask[p] >> j) & 1)) v = s.X[(long)p * WINDOW + j] * s.w[p];
        }
        for (int k = 0; k < 32; ++k) l += __shfl_sync(0xffffffffu, v, k);
      }
      if (lane == 0) {
        s.load[c] = l;
        if (t == a.iters) atomicMax(&s_cmax, __float_as_uint(fmaxf(l - 1.f, 0.f)));
      }
    }
    __syncthreads();
    if (t == a.iters) break;
    // each row: the gradient step, the clip to [0, 1], the rescale of a row
    // whose mass (its columns added in order) exceeds 1
    float dmax = 0.f;
    for (int p = tid; p < P; p += THREADS) {
      const int vm = s.vmask[p];
      if (!vm) continue;
      float* x = s.X + (long)p * WINDOW;
      const int pref = s.pref[p], lo = s.lo[p];
      const float w = s.w[p];
      float xn[WINDOW];
      float rowsum = 0.f;
      for (int j = 0; j < WINDOW; ++j) {
        float v = 0.f;
        if ((vm >> j) & 1) {
          const int c = pref + j - WINDOW / 2;
          const float over = fmaxf(s.load[c] - 1.f, 0.f);
          const float price = GAMMA * (float)(c - lo) + BETA * (float)abs(c - pref);
          const float grad = w * ((price - 1.f) + RHO * over);
          v = fminf(fmaxf(x[j] - a.step * grad, 0.f), 1.f);
        }
        xn[j] = v;
        rowsum += v;
      }
      const float d = fmaxf(rowsum, 1.f);
      for (int j = 0; j < WINDOW; ++j) {
        const float v = xn[j] / d;
        dmax = fmaxf(dmax, fabsf(v - x[j]));
        x[j] = v;
      }
    }
    if (dmax > 0.f) atomicMax(&s_dmax, __float_as_uint(dmax));
    __syncthreads();
    if (tid == 0) {
      s_delta = __uint_as_float(s_dmax);
      if (s_conv < 0 && s_delta < SCAN_TOL) s_conv = t + 1;
      s_dmax = 0;
    }
    __syncthreads();
  }

  // rounding: each pod's heaviest column (the first of equal ones) names its
  // bin; a pod whose best share times its valid columns is below
  // MIN_REL_MASS is repaired
  for (int p = tid; p < P; p += THREADS) {
    const int vm = s.vmask[p];
    const float* x = s.X + (long)p * WINDOW;
    int best = 0;
    float fr = (vm & 1) ? x[0] : -1.f;
    for (int j = 1; j < WINDOW; ++j) {
      const float v = ((vm >> j) & 1) ? x[j] : -1.f;
      if (v > fr) {
        fr = v;
        best = j;
      }
    }
    const int slot = vm ? s.pref[p] + best - WINDOW / 2 : -1;
    const bool cand = vm && fr * (float)__popc(vm) >= MIN_REL_MASS;
    s.key_bin[p] = cand ? slot : C;
    s.frac[p] = fr;
    s.slot[p] = slot;
    s.assigned[p] = 0;
    if (cand) atomicAdd(&s.bcount[slot], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int base = 0;
    for (int c = 0; c < C; ++c) {
      s.bbase[c] = base;
      base += s.bcount[c];
    }
    s_ncand = base;
  }
  __syncthreads();
  // each bin's candidates in pod order (a warp per bin compacts its range)
  for (int c = warp; c < C; c += NWARPS) {
    const int last = s.blast[c];
    int n = s.bbase[c];
    for (int base = s.bfirst[c]; base <= last; base += 32) {
      const int p = base + lane;
      const bool is = p <= last && s.key_bin[p] == c;
      const unsigned m = __ballot_sync(0xffffffffu, is);
      if (is) {
        const int i = n + __popc(m & ((1u << lane) - 1u));
        s.border[i] = p;
        s.cfrac[i] = s.frac[p];
      }
      n += __popc(m);
    }
  }
  __syncthreads();
  // each candidate's rank in its bin: descending share, then pod index
  for (int i = tid; i < s_ncand; i += THREADS) {
    const int c = s.key_bin[s.border[i]];
    const int lo = s.bbase[c], hi = lo + s.bcount[c];
    const float f = s.cfrac[i];
    int r = 0;
    for (int k = lo; k < hi; ++k) r += s.cfrac[k] > f || (s.cfrac[k] == f && k < i);
    s.sorted[lo + r] = s.border[i];
  }
  __syncthreads();
  // each bin admits its candidates in that order while its running load
  // stays within ADMIT
  for (int c = tid; c < C; c += THREADS) {
    float l = 0.f;
    for (int i = s.bbase[c]; i < s.bbase[c] + s.bcount[c]; ++i) {
      l += s.w[s.sorted[i]];
      s.assigned[s.sorted[i]] = l <= ADMIT;
    }
  }
  __syncthreads();
  int round_demoted = 0;
  for (int p = tid; p < P; p += THREADS) {
    const bool as = s.elig[p] && s.assigned[p];
    s.assigned[p] = as;
    if (s.elig[p] && !as) ++round_demoted;
    if (as) {
      const int sl = s.slot[p];
      atomicMax(&s.g_of_c[sl], s.gid[p]);
      atomicMin(&s.cfirst[sl], p);
      atomicMax(&s.clast[sl], p);
    }
  }
  if (round_demoted) atomicAdd(&s_stats[8], round_demoted);
  if (tid == 0) {
    s_stats[4] = s_conv >= 0 ? s_conv : a.iters;
    s_stats[5] = __float_as_int(s_delta);
    s_stats[6] = (int)s_cmax;
  }
  __syncthreads();
}

// The whole phase, inlined into both kernels below; its per-block state is
// static shared memory declared here and in the stages it calls.
__device__ __forceinline__ void relax_body(const RelaxArgs& a, const Workspace& s) {
  __shared__ int s_scan[THREADS];
  __shared__ int s_all_inf;
  __shared__ int s_stats[NSTATS];
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
  if (tid < NSTATS) s_stats[tid] = 0;
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
    if (a.mode == 1) {
      s.bfirst[c] = P;
      s.blast[c] = -1;
      s.bcount[c] = 0;
    }
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
  // its highest bin, in group order. The convex mode takes its warm start
  // from the same sum (stage 9c).
  if (tid == 0) {
    double acc = 0.0;
    for (int p = 0; p < P; ++p) {
      s.start[p] = acc;
      acc += (double)s.w[p];
    }
  }
  __syncthreads();
  if (a.mode == 1) convex_slots(a, s, s_stats, s_work);
  if (a.mode == 0) {
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
  }  // mode 0

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
  if (tid < NSTATS) a.stats[tid] = s_stats[tid];
  if (tid < NWORK) a.work[tid] = s_work[tid];
}

__global__ void __launch_bounds__(THREADS, 1) relax_place_kernel(RelaxArgs a, Workspace s) { relax_body(a, s); }

// The lanes mode (program 14's convex phase 1 per partition): block b runs
// lane b's whole phase from its own argument struct, with its own
// workspace carved in the block, and its own verdicts, state, stats and
// work counters.
__global__ void __launch_bounds__(THREADS, 1) relax_place_lanes_kernel(const RelaxArgs* lanes) {
  __shared__ RelaxArgs a;
  __shared__ Workspace s;
  if (threadIdx.x == 0) {
    a = lanes[blockIdx.x];
    carve(a, static_cast<char*>(a.workspace), &s);
  }
  __syncthreads();
  relax_body(a, s);
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

// The lanes mode's launch: one RelaxArgs per lane in device memory, each
// with its own workspace of relax_place_workspace_bytes for its dims.
// Mirrored by RelaxLanesArgs in karpenter_tpu_torch/ops/relax.py.
struct RelaxLanesArgs {
  const RelaxArgs* lanes;  // [L], device memory
  int L;
};

extern "C" int relax_place_lanes_args_size() { return (int)sizeof(RelaxLanesArgs); }

// Grid L, one block per lane (one block an SM: up to 132 lanes in one wave
// on an H100, more queue behind it).
extern "C" int relax_place_lanes_launch(const RelaxLanesArgs* args, void* stream) {
  if (args->L <= 0) return 0;
  relax_place_lanes_kernel<<<args->L, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(args->lanes);
  return (int)cudaGetLastError();
}
