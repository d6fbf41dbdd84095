// ffd_loop: the whole FFD requeue loop of one provisioning solve, in one launch.
//
// Replaces the JAX package's device programs
//   ops/ffd_sweeps.py:1910 _solve_ffd_sweeps_fresh_jit (_sweeps_impl :1632)
//   ops/ffd_sweeps.py:1922 _solve_ffd_sweeps_carried_jit (seeded with kind0/index0)
//   ops/ffd_step.py:483/:506 _solve_ffd_jit / _solve_ffd_fresh_jit (one-pass mode)
// and steps pods one at a time through the logic of ops/ffd_step.make_step
// (the parity anchor: the JAX chain/stride commits are bit-identical to it).
//
// What bounds it on an H100: the loop is sequential over pods (a pod's
// verdict depends on every earlier commit), so one step's latency times the
// number of steps is the run time. Each step reads the pod's rows, every
// open bin's requirement row, and — the bulk — the claims x instance-types
// survival test (compat over K x W packed words, fits over R, offerings over
// O) until each candidate claim finds one surviving type. The state
// (claims, nodes, topology counters; ~1 MB at 128 claims x 512 types) is
// L2-resident, so each step is bound by on-chip latency, not by HBM bytes.
//
// What the design does about it: ONE persistent thread block walks the queue
// pod by pod, sweep after sweep, with the state updated in place in device
// memory and no host round trip inside a solve. Inside a step the threads
// split the work — a warp per bin (existing node, open claim, template) for
// the merge + topology gate with the value lanes across the warp's threads,
// a warp per candidate claim for the instance-type survival test (32 types
// per ballot, stopping at the first surviving chunk), threads over types for
// the committed row — and block-wide atomicMin picks the winner (first node,
// fewest-pods claim with lowest-slot tie-break, first template). One thread
// commits the scalars.
//
// The kernel counts its own work as it goes (WORK_*: bin gates, topology
// lanes of matched groups, instance-type tests, block barriers) into ``work``,
// so a run's operation and latency bounds are read from what this data
// needed, not estimated from shapes.
//
// This uses one SM of the card's 132. Keeping the claim and instance-type
// tables resident in shared memory, splitting the claims x types test across
// blocks, and the JAX package's closed-form chain commits are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// masks.cuh for why FMA contraction must stay off).
#include <cuda_runtime.h>

#include "topology.cuh"

using namespace kt;

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 1 << 30;
constexpr int KIND_NODE = 0;
constexpr int KIND_CLAIM = 1;
constexpr int KIND_NEW_CLAIM = 2;
constexpr int KIND_FAIL = 3;
constexpr int KIND_NO_SLOT = 4;

// work counters, written to FfdArgs::work at the end of a launch
constexpr int WORK_BIN_GATES = 0;    // bin rows merged + gated against a pod
constexpr int WORK_TOPO_LANES = 1;   // value lanes of matched topology groups read
constexpr int WORK_TYPE_TESTS = 2;   // (bin, instance type) survival tests
constexpr int WORK_BARRIERS = 3;     // block-wide barriers
constexpr int NWORK = 4;

__shared__ unsigned long long s_work[NWORK];

__device__ __forceinline__ void count_work(int i, long n) { atomicAdd(&s_work[i], (unsigned long long)n); }

// __syncthreads, counted
__device__ __forceinline__ void block_sync() {
  if (threadIdx.x == 0) s_work[WORK_BARRIERS] += 1;
  __syncthreads();
}

}  // namespace

// Field order is mirrored by FfdArgs in karpenter_tpu_torch/ops/ffd_sweeps.py
// (pointers first, then ints); ffd_loop_args_size() lets the wrapper check it.
struct FfdArgs {
  // vocabulary
  const int* lvw;            // [K, W] lane_valid words
  const float* ln;           // [K, V] lane_numeric
  const int* lex;            // [K, V] lane_lex_rank
  const uint8_t* wellknown;  // [K]
  // pods
  const int* pod_adm;
  const uint8_t* pod_comp;
  const uint8_t* pod_def;
  const int* pod_gt;
  const int* pod_lt;
  const uint8_t* pod_neg;
  const int* pod_strict_adm;  // [P, K, W]
  const float* pod_requests;  // [P, R]
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
  // existing nodes
  const float* node_avail;     // [N, R]
  const int* node_vol_limits;  // [N, D]
  // topology groups
  const int* grp_type;
  const int* grp_key;
  const int* grp_max_skew;
  const int* grp_min_domains;
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
  // verdict seeds (carried repair pass): null for a fresh solve
  const int* kind0;   // [P]
  const int* index0;  // [P]
  // carried state (updated in place)
  int* claim_adm;
  uint8_t* claim_comp;
  uint8_t* claim_def;
  int* claim_gt;
  int* claim_lt;
  float* claim_requests;
  uint8_t* claim_it_ok;
  uint8_t* claim_open;
  int* claim_npods;
  int* claim_tpl;
  uint8_t* claim_ports;
  int* node_adm;
  uint8_t* node_comp;
  uint8_t* node_def;
  int* node_gt;
  int* node_lt;
  float* node_requests;
  int* node_npods;
  uint8_t* node_ports;
  int* node_vol_used;
  float* remaining;  // [TPL, R]
  int* grp_counts;   // [G, V]
  uint8_t* grp_registered;
  // scratch: merged + narrowed rows per bin (nodes, claims, templates)
  int* fin_adm;
  uint8_t* fin_comp;
  uint8_t* fin_def;
  int* fin_gt;
  int* fin_lt;
  uint8_t* fin_neg;
  uint8_t* bin_ok;
  int* queue;  // [2P]
  // outputs
  int* kind;      // [P]
  int* index;     // [P]
  int* counters;  // [2]: pods stepped, sweeps
  unsigned long long* work;  // [NWORK]: WORK_* counters
  // dims
  int P, K, V, W, C, N, T, TPL, R, O, PT, D, G, F, CH, one_pass;
};

namespace {

struct Shared {
  int node_pick, claim_rank, tpl_pick, free_slot;
  int kind, index, bin, host_lane;
  int qlen, nqlen, noslot, progress, cur, stepped, sweeps;
};

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ bool registered_at(const FfdArgs& a, int g, int kg, int v, int extra_lane) {
  return a.grp_registered[(long)g * a.V + v] || (extra_lane >= 0 && kg == HOSTNAME_KEY && v == extra_lane);
}

// Per-group quantities of TopologyGroup.Get that depend on the pod but not on
// the bin: the spread global minimum, the affinity bootstrap's best rank and
// whether anything is placed yet (ops/topology_kernels.allowed_domains).
// ``extra_lane`` registers the fresh claim's minted hostname lane.
__device__ void group_prep(const FfdArgs& a, int p, int extra_lane, int* s_gmin, int* s_boot,
                           int* s_nothing) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < a.G; g += NWARPS) {
    const int kg = a.grp_key[g];
    const int* pdw = a.pod_strict_adm + ((long)p * a.K + kg) * a.W;
    if (lane == 0 && a.pod_match[(long)p * a.G + g]) count_work(WORK_TOPO_LANES, a.V);
    int cmin = MAXI, lmin = MAXI, nsup = 0, pos = 0;
    for (int v = lane; v < a.V; v += 32) {
      if (registered_at(a, g, kg, v, extra_lane) && bit_of(pdw, v)) {
        const int cnt = a.grp_counts[(long)g * a.V + v];
        cmin = min(cmin, cnt);
        lmin = min(lmin, a.lex[(long)kg * a.V + v]);
        nsup += 1;
        pos |= cnt > 0;
      }
    }
    cmin = warp_min(cmin);
    lmin = warp_min(lmin);
    nsup = warp_sum(nsup);
    pos = __any_sync(FULL, pos);
    if (lane == 0) {
      int gmin = cmin;
      const int md = a.grp_min_domains[g];
      if (md >= 0 && nsup < md) gmin = 0;
      if (kg == HOSTNAME_KEY) gmin = 0;
      s_gmin[g] = gmin;
      s_boot[g] = lmin;
      s_nothing[g] = !pos;
    }
  }
}

// One warp: merge the bin's row with the pod's, apply the topology gate
// (TopologyGroup.Get + AddRequirements, ops/topology_kernels.topo_gate) and
// write the narrowed row to the fin_* scratch of bin ``b``. Returns
// Compatible(base, pod) && topology-ok, uniform across the warp.
__device__ bool bin_gate(const FfdArgs& a, int p, const Row& base, const uint8_t* base_neg, int b,
                         const uint8_t* allow, int pin_lane, int extra_lane, const int* s_gmin,
                         const int* s_boot, const int* s_nothing) {
  const int lane = threadIdx.x & 31;
  const int K = a.K, W = a.W, V = a.V;
  const Row pod = row_at(a.pod_adm, a.pod_comp, a.pod_def, a.pod_gt, a.pod_lt, p, K, W);
  const uint8_t* pod_neg = a.pod_neg + (long)p * K;
  if (lane == 0) count_work(WORK_BIN_GATES, 1);

  // Compatible from the merged row (masks.compatible_from_merged); lane k
  // takes key k
  bool lane_ok = true;
  if (lane < K) {
    const int k = lane;
    const bool bneg = base_neg ? base_neg[k] != 0
                               : negative_polarity_key(base.adm + k * W, base.comp[k], base.gt[k],
                                                       base.lt[k], a.lvw + k * W, a.ln + (long)k * V, W);
    const bool both_def = base.def[k] && pod.def[k];
    const bool inter_ok = !both_def || (bneg && pod_neg[k]) || merged_nonempty_key(base, pod, k, W);
    const bool undef_bad = pod.def[k] && !base.def[k] && !(allow && allow[k]) && !pod_neg[k];
    lane_ok = inter_ok && !undef_bad;
  }
  bool ok = __all_sync(FULL, lane_ok);

  int* fadm = a.fin_adm + (long)b * K * W;
  uint8_t* fcomp = a.fin_comp + (long)b * K;
  uint8_t* fdef = a.fin_def + (long)b * K;
  int* fgt = a.fin_gt + (long)b * K;
  int* flt = a.fin_lt + (long)b * K;
  for (int i = lane; i < K * W; i += 32) fadm[i] = base.adm[i] & pod.adm[i];
  if (lane < K) {
    fcomp[lane] = base.comp[lane] && pod.comp[lane];
    fdef[lane] = base.def[lane] || pod.def[lane];
    fgt[lane] = max(base.gt[lane], pod.gt[lane]);
    flt[lane] = min(base.lt[lane], pod.lt[lane]);
  }
  __syncwarp();
  if (pin_lane >= 0) {
    // pin the fresh claim's minted hostname (ffd_core._pin_hostname)
    for (int w = lane; w < W; w += 32)
      fadm[HOSTNAME_KEY * W + w] &= (w == (pin_lane >> 5)) ? (int)(1u << (pin_lane & 31)) : 0;
    if (lane == 0) {
      fcomp[HOSTNAME_KEY] = 0;
      fdef[HOSTNAME_KEY] = 1;
    }
    __syncwarp();
  }

  const uint8_t* match = a.pod_match + (long)p * a.G;
  for (int k = 0; k < K && a.G > 0; ++k) {
    bool touched = false;
    unsigned lim = FULL;  // bit j: lane 32j + lane stays allowed on key k
    const int* ndw = fadm + k * W;  // the merged row's lanes (node_dom)
    const int* pdw = a.pod_strict_adm + ((long)p * K + k) * W;
    for (int g = 0; g < a.G; ++g) {
      if (!match[g] || a.grp_key[g] != k) continue;
      touched = true;
      if (lane == 0) count_work(WORK_TOPO_LANES, V);
      const int type = a.grp_type[g];
      const int sel = a.pod_selects[(long)p * a.G + g];
      const int* cnt = a.grp_counts + (long)g * V;
      const int* lexk = a.lex + (long)k * V;
      int best = MAXI;
      if (type == 0) {
        // spread (topologygroup.go:163-213): lowest count first,
        // lexicographically-first value on ties
        for (int j = 0; j < W; ++j) {
          const int v = 32 * j + lane;
          const int self = cnt[v] + sel;
          if (registered_at(a, g, k, v, extra_lane) && bit_of(ndw, v) &&
              self - s_gmin[g] <= a.grp_max_skew[g])
            best = min(best, self * V + min(lexk[v], V - 1));
        }
        best = warp_min(best);
      } else if (type == 1) {
        for (int j = 0; j < W; ++j) {
          const int v = 32 * j + lane;
          if (registered_at(a, g, k, v, extra_lane) && bit_of(pdw, v) && bit_of(ndw, v))
            best = min(best, lexk[v]);
        }
        best = warp_min(best);
      }
      unsigned amask = 0;
      for (int j = 0; j < W; ++j) {
        const int v = 32 * j + lane;
        const bool reg = registered_at(a, g, k, v, extra_lane);
        const bool pd = bit_of(pdw, v);
        const bool nd = bit_of(ndw, v);
        bool allowed;
        if (type == 0) {
          const int self = cnt[v] + sel;
          const bool elig = reg && nd && self - s_gmin[g] <= a.grp_max_skew[g];
          allowed = elig && best < MAXI && self * V + min(lexk[v], V - 1) == best;
        } else if (type == 1) {
          // affinity (topologygroup.go:215-246) with the self-select
          // bootstrap when nothing is placed yet
          const bool positive = reg && cnt[v] > 0 && pd;
          const bool inter = reg && pd && nd;
          const bool boot_inter = inter && best < MAXI && lexk[v] == best;
          const bool boot_any = reg && pd && s_boot[g] < MAXI && lexk[v] == s_boot[g];
          allowed = positive || ((boot_inter || boot_any) && s_nothing[g] && sel);
        } else {
          // anti-affinity (topologygroup.go:248-256)
          allowed = reg && cnt[v] == 0 && pd;
        }
        if (allowed) amask |= 1u << j;
      }
      if (!__any_sync(FULL, amask != 0)) ok = false;  // the group allows no domain
      lim &= amask;
    }
    if (!touched) continue;
    bool any_new = false;
    for (int j = 0; j < W; ++j) {
      const bool keep = bit_of(ndw, 32 * j + lane) && ((lim >> j) & 1u);
      const unsigned word = __ballot_sync(FULL, keep);
      any_new |= word != 0;
      if (lane == 0) fadm[k * W + j] = (int)word;
    }
    const bool key_ok = any_new && (fdef[k] || (allow && allow[k]));
    if (!key_ok) ok = false;
    __syncwarp();
    if (lane == 0) {
      fcomp[k] = 0;
      fdef[k] = 1;
    }
    __syncwarp();
  }
  // polarity of the narrowed row, read by the instance-type gate and Record
  if (lane < K)
    a.fin_neg[(long)b * K + lane] = negative_polarity_key(fadm + lane * W, fcomp[lane], fgt[lane],
                                                          flt[lane], a.lvw + lane * W,
                                                          a.ln + (long)lane * V, W);
  __syncwarp();
  return ok;
}

__device__ __forceinline__ Row fin_row(const FfdArgs& a, int b) {
  return row_at(a.fin_adm, a.fin_comp, a.fin_def, a.fin_gt, a.fin_lt, b, a.K, a.W);
}

__device__ __forceinline__ bool tpl_type_ok(const FfdArgs& a, const ITs& its, int p, int j, int t) {
  const int b = a.N + a.C + j;
  return a.tpl_it_ok[(long)j * a.T + t] && within_limits(a, j, t) &&
         it_gate(fin_row(a, b), a.fin_neg + (long)b * a.K, a.tpl_overhead + (long)j * a.R,
                 a.pod_requests + (long)p * a.R, its, t, a.K, a.W, a.R, a.O);
}

__device__ __forceinline__ bool claim_type_ok(const FfdArgs& a, const ITs& its, int p, int c, int t) {
  const int b = a.N + c;
  return a.claim_it_ok[(long)c * a.T + t] &&
         it_gate(fin_row(a, b), a.fin_neg + (long)b * a.K, a.claim_requests + (long)c * a.R,
                 a.pod_requests + (long)p * a.R, its, t, a.K, a.W, a.R, a.O);
}

__device__ void copy_row(const FfdArgs& a, int b, int* adm, uint8_t* comp, uint8_t* def, int* gt,
                         int* lt, int e) {
  const int K = a.K, W = a.W;
  for (int i = threadIdx.x; i < K * W; i += THREADS) adm[(long)e * K * W + i] = a.fin_adm[(long)b * K * W + i];
  for (int k = threadIdx.x; k < K; k += THREADS) {
    comp[(long)e * K + k] = a.fin_comp[(long)b * K + k];
    def[(long)e * K + k] = a.fin_def[(long)b * K + k];
    gt[(long)e * K + k] = a.fin_gt[(long)b * K + k];
    lt[(long)e * K + k] = a.fin_lt[(long)b * K + k];
  }
}

// Place pod p (ops/ffd_step.make_step): nodes, then open claims by fewest
// pods, then a fresh claim from the first accepting template; commit.
__device__ void step(const FfdArgs& a, int p, Shared& s, int* s_gmin, int* s_boot, int* s_nothing,
                     int* s_maxcap) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, W = a.W, N = a.N, C = a.C, R = a.R;
  const ITs its = its_of(a);
  const float* preq = a.pod_requests + (long)p * R;
  const uint8_t* pconf = a.pod_conflict + (long)p * a.PT;
  if (tid == 0) {
    s.node_pick = N;
    s.claim_rank = BIG;
    s.tpl_pick = a.TPL;
    s.free_slot = C;
  }
  for (int r = tid; r < R; r += THREADS) s_maxcap[r] = 0;  // bits of 0.0f
  group_prep(a, p, -1, s_gmin, s_boot, s_nothing);
  block_sync();

  // -- 1. existing nodes
  for (int n = warp; n < N; n += NWARPS) {
    const Row base = row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, n, K, W);
    bool ok = bin_gate(a, p, base, nullptr, n, nullptr, -1, -1, s_gmin, s_boot, s_nothing);
    if (lane == 0 && ok) {
      ok = a.pod_tol_node[(long)p * N + n] &&
           fits_add(a.node_requests + (long)n * R, preq, a.node_avail + (long)n * R, R);
      for (int q = 0; q < a.PT && ok; ++q)
        if (a.node_ports[(long)n * a.PT + q] && pconf[q]) ok = false;
      for (int d = 0; d < a.D && ok; ++d)
        if (a.node_vol_used[(long)n * a.D + d] + a.pod_vols[(long)p * a.D + d] > a.node_vol_limits[(long)n * a.D + d])
          ok = false;
      if (ok) atomicMin(&s.node_pick, n);
    }
  }
  for (int c = tid; c < C; c += THREADS)
    if (!a.claim_open[c]) atomicMin(&s.free_slot, c);
  block_sync();
  const bool any_node = s.node_pick < N;

  // -- 2. open claims, fewest pods first (only read when no node accepts)
  if (!any_node) {
    for (int c = warp; c < C; c += NWARPS) {
      if (!a.claim_open[c]) continue;
      const Row base = row_at(a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, c, K, W);
      bool ok = bin_gate(a, p, base, nullptr, N + c, a.wellknown, -1, -1, s_gmin, s_boot, s_nothing);
      if (ok) {
        ok = a.pod_tol_tpl[(long)p * a.TPL + a.claim_tpl[c]] != 0;
        for (int q = 0; q < a.PT && ok; ++q)
          if (a.claim_ports[(long)c * a.PT + q] && pconf[q]) ok = false;
      }
      if (lane == 0) a.bin_ok[N + c] = ok;
    }
    block_sync();
    // the claims x instance-types survival test: a warp per candidate claim,
    // 32 types per ballot, stopping at the first chunk with a survivor
    for (int c = warp; c < C; c += NWARPS) {
      if (!a.claim_open[c] || !a.bin_ok[N + c]) continue;
      const int rank = a.claim_npods[c] * C + c;
      // skip a claim already beaten (one read, broadcast: the warp must agree)
      int best = 0;
      if (lane == 0) best = *(volatile int*)&s.claim_rank;
      if (rank >= __shfl_sync(FULL, best, 0)) continue;
      for (int t0 = 0; t0 < a.T; t0 += 32) {
        const int t = t0 + lane;
        if (lane == 0) count_work(WORK_TYPE_TESTS, min(32, a.T - t0));
        const bool ok = t < a.T && claim_type_ok(a, its, p, c, t);
        if (__any_sync(FULL, ok)) {
          if (lane == 0) atomicMin(&s.claim_rank, rank);
          break;
        }
      }
    }
    block_sync();
  }
  const bool any_claim = s.claim_rank < BIG;
  const bool has_slot = s.free_slot < C;

  // -- 3. fresh claim from templates, weight order; the prospective slot's
  // hostname is minted, pinned and registered before the gates see it
  if (!any_node && !any_claim && has_slot) {
    const int host = a.CH > 0 ? a.host_lane[min(s.free_slot, a.CH - 1)] : -1;
    group_prep(a, p, host, s_gmin, s_boot, s_nothing);
    block_sync();
    for (int j = warp; j < a.TPL; j += NWARPS) {
      const int b = N + C + j;
      const Row base = row_at(a.tpl_adm, a.tpl_comp, a.tpl_def, a.tpl_gt, a.tpl_lt, j, K, W);
      bool ok = bin_gate(a, p, base, a.tpl_neg + (long)j * K, b, a.wellknown, host, host, s_gmin,
                         s_boot, s_nothing);
      ok = ok && a.pod_tol_tpl[(long)p * a.TPL + j];
      if (!ok) continue;
      for (int t0 = 0; t0 < a.T; t0 += 32) {
        const int t = t0 + lane;
        if (lane == 0) count_work(WORK_TYPE_TESTS, min(32, a.T - t0));
        const bool tok = t < a.T && tpl_type_ok(a, its, p, j, t);
        if (__any_sync(FULL, tok)) {
          if (lane == 0) atomicMin(&s.tpl_pick, j);
          break;
        }
      }
    }
    if (tid == 0) s.host_lane = host;
    block_sync();
  }

  if (tid == 0) {
    int kind, index = -1, bin = -1;
    if (any_node) {
      kind = KIND_NODE;
      index = s.node_pick;
      bin = index;
    } else if (any_claim) {
      kind = KIND_CLAIM;
      index = s.claim_rank % C;
      bin = N + index;
    } else if (!has_slot) {
      kind = KIND_NO_SLOT;
    } else if (s.tpl_pick < a.TPL) {
      kind = KIND_NEW_CLAIM;
      index = s.free_slot;
      bin = N + C + s.tpl_pick;
    } else {
      kind = KIND_FAIL;
    }
    s.kind = kind;
    s.index = index;
    s.bin = bin;
    a.kind[p] = kind;
    a.index[p] = index;
  }
  block_sync();
  const int kind = s.kind;
  if (kind == KIND_FAIL || kind == KIND_NO_SLOT) return;
  const int idx = s.index, bin = s.bin;

  // -- commit (every gate above read the pre-commit state)
  if (kind == KIND_NODE) {
    copy_row(a, bin, a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, idx);
    for (int r = tid; r < R; r += THREADS) a.node_requests[(long)idx * R + r] += preq[r];
    for (int q = tid; q < a.PT; q += THREADS) a.node_ports[(long)idx * a.PT + q] |= a.pod_ports[(long)p * a.PT + q];
    for (int d = tid; d < a.D; d += THREADS) a.node_vol_used[(long)idx * a.D + d] += a.pod_vols[(long)p * a.D + d];
    if (tid == 0) a.node_npods[idx] += 1;
  } else if (kind == KIND_CLAIM) {
    // the committed row of survivors, read against the pre-commit requests
    if (tid == 0) count_work(WORK_TYPE_TESTS, a.T);
    for (int t = tid; t < a.T; t += THREADS) a.claim_it_ok[(long)idx * a.T + t] = claim_type_ok(a, its, p, idx, t);
    block_sync();
    copy_row(a, bin, a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, idx);
    for (int r = tid; r < R; r += THREADS) a.claim_requests[(long)idx * R + r] += preq[r];
    for (int q = tid; q < a.PT; q += THREADS) a.claim_ports[(long)idx * a.PT + q] |= a.pod_ports[(long)p * a.PT + q];
    if (tid == 0) a.claim_npods[idx] += 1;
  } else {
    const int j = s.tpl_pick;
    if (tid == 0) count_work(WORK_TYPE_TESTS, a.T);
    for (int t = tid; t < a.T; t += THREADS) {
      const bool ok = tpl_type_ok(a, its, p, j, t);
      a.claim_it_ok[(long)idx * a.T + t] = ok;
      if (ok)  // caps are >= 0, so their float bits order as ints
        for (int r = 0; r < R; ++r) atomicMax(&s_maxcap[r], __float_as_int(a.it_cap[(long)t * R + r]));
    }
    block_sync();
    copy_row(a, bin, a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, idx);
    for (int r = tid; r < R; r += THREADS) {
      a.claim_requests[(long)idx * R + r] = a.tpl_overhead[(long)j * R + r] + preq[r];
      // opening a claim burns pessimistic headroom (subtractMax)
      a.remaining[(long)j * R + r] = a.remaining[(long)j * R + r] - __int_as_float(s_maxcap[r]);
    }
    for (int q = tid; q < a.PT; q += THREADS) a.claim_ports[(long)idx * a.PT + q] = a.pod_ports[(long)p * a.PT + q] || a.claim_ports[(long)idx * a.PT + q];
    if (s.host_lane >= 0)
      for (int g = tid; g < a.G; g += THREADS)
        if (a.grp_key[g] == HOSTNAME_KEY) a.grp_registered[(long)g * a.V + s.host_lane] = 1;
    if (tid == 0) {
      a.claim_open[idx] = 1;
      a.claim_npods[idx] += 1;
      a.claim_tpl[idx] = j;
    }
  }

  // -- topology record for the chosen bin (topology.go:125-148)
  bool any_rec = false;
  for (int g = 0; g < a.G; ++g)
    any_rec |= a.pod_selects[(long)p * a.G + g] || a.pod_owned[(long)p * a.G + g];
  if (!any_rec) return;
  block_sync();
  const Row rec = fin_row(a, bin);
  const uint8_t* rec_neg = a.fin_neg + (long)bin * K;
  const uint8_t* allow = kind == KIND_NODE ? nullptr : a.wellknown;
  const TopoGroups tg = topo_of(a);
  for (int g = warp; g < a.G; g += NWARPS) {
    const int kg = a.grp_key[g];
    if (!records_group(tg, g, rec, rec_neg, a.pod_selects[(long)p * a.G + g], a.pod_owned[(long)p * a.G + g],
                       allow, K, W))
      continue;
    if (lane == 0) count_work(WORK_TOPO_LANES, a.V);
    for (int v = lane; v < a.V; v += 32) {
      if (bit_of(rec.adm + kg * W, v)) {
        a.grp_counts[(long)g * a.V + v] += 1;
        a.grp_registered[(long)g * a.V + v] = 1;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) ffd_loop_kernel(FfdArgs a) {
  __shared__ Shared s;
  extern __shared__ int dyn[];
  int* s_gmin = dyn;
  int* s_boot = dyn + a.G;
  int* s_nothing = dyn + 2 * a.G;
  int* s_maxcap = dyn + 3 * a.G;
  const int tid = threadIdx.x;

  // the carried repair pass (ops/ffd_sweeps.py:1938-1941) seeds the rows of
  // phase 1's placements, which are inactive here and never stepped
  for (int p = tid; p < a.P; p += THREADS) {
    a.kind[p] = a.kind0 ? a.kind0[p] : KIND_FAIL;
    a.index[p] = a.index0 ? a.index0[p] : -1;
  }
  if (tid < NWORK) s_work[tid] = 0;
  __syncthreads();
  if (a.one_pass) {
    for (int p = 0; p < a.P; ++p) {
      if (!a.pod_active[p]) continue;  // padding rows fail without touching state
      step(a, p, s, s_gmin, s_boot, s_nothing, s_maxcap);
      block_sync();
    }
    if (tid < NWORK) a.work[tid] = s_work[tid];
    return;
  }

  // compact initial queue: active rows in FFD order (ffd_sweeps.py:1686-1690)
  int* q = a.queue;
  int* nq = a.queue + a.P;
  if (tid == 0) {
    int n = 0;
    for (int p = 0; p < a.P; ++p)
      if (a.pod_active[p]) q[n++] = p;
    s.qlen = n;
    s.progress = 1;
    s.noslot = 0;
    s.stepped = 0;
    s.sweeps = 0;
  }
  block_sync();
  // requeue until a sweep makes no progress or a pod ran out of claim slots
  while (s.progress && s.qlen > 0 && !s.noslot) {
    if (tid == 0) s.nqlen = 0;
    block_sync();
    const int qlen = s.qlen;
    for (int i = 0; i < qlen; ++i) {
      const int p = q[i];
      step(a, p, s, s_gmin, s_boot, s_nothing, s_maxcap);
      block_sync();
      if (tid == 0) {
        const int k = s.kind;
        if (k == KIND_FAIL) nq[s.nqlen++] = p;
        if (k == KIND_NO_SLOT) s.noslot = 1;
        s.stepped += 1;
      }
    }
    block_sync();
    if (tid == 0) {
      s.progress = s.nqlen < qlen;
      s.qlen = s.nqlen;
      s.sweeps += 1;
    }
    int* tmp = q;
    q = nq;
    nq = tmp;
    block_sync();
  }
  if (tid == 0) {
    a.counters[0] = s.stepped;
    a.counters[1] = s.sweeps;
  }
  if (tid < NWORK) a.work[tid] = s_work[tid];
}

// Measures the cost of one counted block barrier (block_sync) in a block of
// the loop's size: ``n`` barriers, nothing else. Not part of the solve.
__global__ void __launch_bounds__(THREADS, 1) sync_probe_kernel(int n) {
  if (threadIdx.x < NWORK) s_work[threadIdx.x] = 0;
  __syncthreads();
  for (int i = 0; i < n; ++i) block_sync();
}

}  // namespace

extern "C" int ffd_loop_args_size() { return (int)sizeof(FfdArgs); }

// Launch on ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int ffd_loop_launch(const FfdArgs* args, void* stream) {
  const size_t smem = (size_t)(3 * args->G + args->R) * sizeof(int);
  ffd_loop_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int ffd_sync_probe_launch(int n, void* stream) {
  sync_probe_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(n);
  return (int)cudaGetLastError();
}
