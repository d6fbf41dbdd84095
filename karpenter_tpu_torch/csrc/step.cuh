// The per-pod FFD step as device code, shared by the FFD loop kernel
// (ffd_loop.cu) and the consolidation screen kernel (runs_screen.cu).
//
// Device counterpart of karpenter_tpu_torch/ops/ffd_step.make_step (the JAX
// package's ops/ffd_step._make_step): one block places one pod in the
// reference's priority order (scheduler.go:238-285) against the state its
// argument struct points at. The functions are templates over that struct:
// any struct with ffd_loop.cu FfdArgs' field names works, so a kernel that
// keeps one state per block hands each block a struct whose state pointers
// are offset to its own slot. The caller writes the verdict rows from
// Shared::kind / Shared::index after the call.
//
// Threads: THREADS per block. Inside a step the threads split the work — a
// warp per bin (existing node, open claim, template) for the merge and the
// topology gate, a warp per candidate claim for the instance-type survival
// test, threads over types for the committed row — and block-wide atomicMin
// picks the winner. Every barrier is block-wide: callers keep the control
// flow around a step uniform across the block.
//
// No shape limit: the per-key work loops over keys in strides of 32 (a warp
// lane per key), and the topology gate folds its allowed-lane masks over the
// value words in chunks of 64 (a 64-bit mask per warp lane), so any K and V
// that fit the device's memory run.
#pragma once

#include <cuda_runtime.h>

#include "topology.cuh"

using namespace kt;

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 1 << 30;
constexpr int BIG_CAP = 1 << 20;  // ffd_core._BIG_CAP
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

struct Shared {
  int node_pick, claim_rank, tpl_pick, free_slot;
  int kind, index, bin, host_lane;
  int qlen, nqlen, noslot, progress, cur, stepped, sweeps, chains, chain_pods;
  int rank2, node_static;  // second-best claim rank; a node passes its static gates
};

// What a chain commit (chain.cuh) reads of the evaluation beyond the verdict:
// the surviving types and per-type capacity of every claim that passes its
// gates, against the pre-commit state, and every open claim's gates before
// and of the topology.
struct ChainEval {
  uint8_t* ok_t;  // [C, T] claim_it_ok2 (rows of claims that pass their gates)
  int* cap_t;     // [C, T] more pods of this kind each type takes
  int* capc;      // [C] the claim's capacity for the chain, 0 unless it passes
  int* pre;       // [C] claim_ok_pre: open, tolerated, ports, compatible
  int* topo;      // [C] the topology gate passed
};

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// ops/ffd_core._capacity: pods of ``req`` that fit in ``avail - used``
__device__ int capacity(const float* avail, const float* used, const float* req, int R) {
  float mn = (float)BIG_CAP;
  bool zero_ok = true;
  for (int r = 0; r < R; ++r) {
    const float a = avail[r];
    const float eps = 1e-6f + 1e-6f * fabsf(a);
    const float room = a + eps - used[r];
    if (req[r] > 0.0f)
      mn = fminf(mn, floorf(room / req[r]));
    else if (!(room >= 0.0f))
      zero_ok = false;
  }
  if (!zero_ok) return 0;
  return (int)fminf(fmaxf(mn, 0.0f), (float)BIG_CAP);
}

// ``base + take * req`` rounded once (ops/ffd_core._add_times)
__device__ __forceinline__ float add_times(float base, int take, float req) {
  return __double2float_rn((double)base + (double)take * (double)req);
}

// ops/ffd_core._water_level: largest L with sum(clip(L - lvl, 0, cap)) <= units
__device__ int water_level(const int* lvl, const int* cap, int n, int units) {
  int lo = 0, hi = 2 * BIG_CAP;
  for (int it = 0; it < 22; ++it) {
    const int mid = (lo + hi + 1) / 2;
    int used = 0;
    for (int c = 0; c < n; ++c) used += min(max(mid - lvl[c], 0), cap[c]);
    if (used <= units)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}


template <class A>
__device__ __forceinline__ bool registered_at(const A& a, int g, int kg, int v, int extra_lane) {
  return a.grp_registered[(long)g * a.V + v] || (extra_lane >= 0 && kg == HOSTNAME_KEY && v == extra_lane);
}

// Per-group quantities of TopologyGroup.Get that depend on the pod but not on
// the bin: the spread global minimum, the affinity bootstrap's best rank and
// whether anything is placed yet (ops/topology_kernels.allowed_domains).
// ``extra_lane`` registers the fresh claim's minted hostname lane.
template <class A>
__device__ void group_prep(const A& a, int p, int extra_lane, int* s_gmin, int* s_boot,
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
// Compatible(base, pod) && topology-ok, uniform across the warp; ``parts``
// (optional) receives the two halves apart: [0] compatible, [1] topology.
template <class A>
__device__ bool bin_gate(const A& a, int p, const Row& base, const uint8_t* base_neg, int b,
                         const uint8_t* allow, int pin_lane, int extra_lane, const int* s_gmin,
                         const int* s_boot, const int* s_nothing, bool* parts = nullptr) {
  const int lane = threadIdx.x & 31;
  const int K = a.K, W = a.W, V = a.V;
  const Row pod = row_at(a.pod_adm, a.pod_comp, a.pod_def, a.pod_gt, a.pod_lt, p, K, W);
  const uint8_t* pod_neg = a.pod_neg + (long)p * K;
  if (lane == 0) count_work(WORK_BIN_GATES, 1);

  // Compatible from the merged row (masks.compatible_from_merged); lane l
  // takes keys l, l + 32, ...
  bool lane_ok = true;
  for (int k = lane; k < K; k += 32) {
    const bool bneg = base_neg ? base_neg[k] != 0
                               : negative_polarity_key(base.adm + k * W, base.comp[k], base.gt[k],
                                                       base.lt[k], a.lvw + k * W, a.ln + (long)k * V, W);
    const bool both_def = base.def[k] && pod.def[k];
    const bool inter_ok = !both_def || (bneg && pod_neg[k]) || merged_nonempty_key(base, pod, k, W);
    const bool undef_bad = pod.def[k] && !base.def[k] && !(allow && allow[k]) && !pod_neg[k];
    lane_ok = lane_ok && inter_ok && !undef_bad;
  }
  const bool compat = __all_sync(FULL, lane_ok);
  bool topo = true;

  int* fadm = a.fin_adm + (long)b * K * W;
  uint8_t* fcomp = a.fin_comp + (long)b * K;
  uint8_t* fdef = a.fin_def + (long)b * K;
  int* fgt = a.fin_gt + (long)b * K;
  int* flt = a.fin_lt + (long)b * K;
  for (int i = lane; i < K * W; i += 32) fadm[i] = base.adm[i] & pod.adm[i];
  for (int k = lane; k < K; k += 32) {
    fcomp[k] = base.comp[k] && pod.comp[k];
    fdef[k] = base.def[k] || pod.def[k];
    fgt[k] = max(base.gt[k], pod.gt[k]);
    flt[k] = min(base.lt[k], pod.lt[k]);
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
    for (int g = 0; g < a.G; ++g) touched |= match[g] && a.grp_key[g] == k;
    if (!touched) continue;
    // the merged row's lanes on key k (node_dom), read from the inputs: the
    // narrowed words below overwrite fadm chunk by chunk
    const int* bw = base.adm + k * W;
    const int* qw = pod.adm + k * W;
    const bool pinned = pin_lane >= 0 && k == HOSTNAME_KEY;
    auto nd_bit = [&](int v) { return bit_of(bw, v) && bit_of(qw, v) && (!pinned || v == pin_lane); };
    const int* pdw = a.pod_strict_adm + ((long)p * K + k) * W;
    const int* lexk = a.lex + (long)k * V;
    bool any_new = false;
    // bit j - j0 of a warp lane's mask: lane 32j + lane stays allowed
    for (int j0 = 0; j0 < W; j0 += 64) {
      const int j1 = min(W, j0 + 64);
      unsigned long long lim = ~0ull;
      for (int g = 0; g < a.G; ++g) {
        if (!match[g] || a.grp_key[g] != k) continue;
        if (lane == 0 && j0 == 0) count_work(WORK_TOPO_LANES, V);
        const int type = a.grp_type[g];
        const int sel = a.pod_selects[(long)p * a.G + g];
        const int* cnt = a.grp_counts + (long)g * V;
        int best = MAXI;
        if (type == 0) {
          // spread (topologygroup.go:163-213): lowest count first,
          // lexicographically-first value on ties
          for (int j = 0; j < W; ++j) {
            const int v = 32 * j + lane;
            const int self = cnt[v] + sel;
            if (registered_at(a, g, k, v, extra_lane) && nd_bit(v) && self - s_gmin[g] <= a.grp_max_skew[g])
              best = min(best, self * V + min(lexk[v], V - 1));
          }
          best = warp_min(best);
        } else if (type == 1) {
          for (int j = 0; j < W; ++j) {
            const int v = 32 * j + lane;
            if (registered_at(a, g, k, v, extra_lane) && bit_of(pdw, v) && nd_bit(v)) best = min(best, lexk[v]);
          }
          best = warp_min(best);
        }
        unsigned long long amask = 0;
        for (int j = j0; j < j1; ++j) {
          const int v = 32 * j + lane;
          const bool reg = registered_at(a, g, k, v, extra_lane);
          const bool pd = bit_of(pdw, v);
          bool allowed;
          if (type == 0) {
            const int self = cnt[v] + sel;
            const bool elig = reg && nd_bit(v) && self - s_gmin[g] <= a.grp_max_skew[g];
            allowed = elig && best < MAXI && self * V + min(lexk[v], V - 1) == best;
          } else if (type == 1) {
            // affinity (topologygroup.go:215-246) with the self-select
            // bootstrap when nothing is placed yet
            const bool positive = reg && cnt[v] > 0 && pd;
            const bool inter = reg && pd && nd_bit(v);
            const bool boot_inter = inter && best < MAXI && lexk[v] == best;
            const bool boot_any = reg && pd && s_boot[g] < MAXI && lexk[v] == s_boot[g];
            allowed = positive || ((boot_inter || boot_any) && s_nothing[g] && sel);
          } else {
            // anti-affinity (topologygroup.go:248-256)
            allowed = reg && cnt[v] == 0 && pd;
          }
          if (allowed) amask |= 1ull << (j - j0);
        }
        lim &= amask;
      }
      // a group allowing no domain leaves no lane here, so the key fails
      for (int j = j0; j < j1; ++j) {
        const bool keep = nd_bit(32 * j + lane) && ((lim >> (j - j0)) & 1ull);
        const unsigned word = __ballot_sync(FULL, keep);
        any_new |= word != 0;
        if (lane == 0) fadm[k * W + j] = (int)word;
      }
    }
    const bool key_ok = any_new && (fdef[k] || (allow && allow[k]));
    if (!key_ok) topo = false;
    __syncwarp();
    if (lane == 0) {
      fcomp[k] = 0;
      fdef[k] = 1;
    }
    __syncwarp();
  }
  // polarity of the narrowed row, read by the instance-type gate and Record
  for (int k = lane; k < K; k += 32)
    a.fin_neg[(long)b * K + k] = negative_polarity_key(fadm + k * W, fcomp[k], fgt[k], flt[k], a.lvw + k * W,
                                                       a.ln + (long)k * V, W);
  __syncwarp();
  if (parts) {
    parts[0] = compat;
    parts[1] = topo;
  }
  return compat && topo;
}

template <class A>
__device__ __forceinline__ Row fin_row(const A& a, int b) {
  return row_at(a.fin_adm, a.fin_comp, a.fin_def, a.fin_gt, a.fin_lt, b, a.K, a.W);
}

template <class A>
__device__ __forceinline__ bool tpl_type_ok(const A& a, const ITs& its, int p, int j, int t) {
  const int b = a.N + a.C + j;
  return a.tpl_it_ok[(long)j * a.T + t] && within_limits(a, j, t) &&
         it_gate(fin_row(a, b), a.fin_neg + (long)b * a.K, a.tpl_overhead + (long)j * a.R,
                 a.pod_requests + (long)p * a.R, its, t, a.K, a.W, a.R, a.O);
}

template <class A>
__device__ __forceinline__ bool claim_type_ok(const A& a, const ITs& its, int p, int c, int t) {
  const int b = a.N + c;
  return a.claim_it_ok[(long)c * a.T + t] &&
         it_gate(fin_row(a, b), a.fin_neg + (long)b * a.K, a.claim_requests + (long)c * a.R,
                 a.pod_requests + (long)p * a.R, its, t, a.K, a.W, a.R, a.O);
}

template <class A>
__device__ void copy_row(const A& a, int b, int* adm, uint8_t* comp, uint8_t* def, int* gt,
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

// A member of a topology run (ops/topo_runs.make_topo_run_commit) steps
// with the run head's rows ``p`` but records with its own select row
// ``psel``; existing nodes take it while their capacity at the run's start
// (``res_cap``) exceeds the members already there (``taken``, which the
// step increments instead of adding the member's requests).
struct TopoRun {
  int psel;
  const int* res_cap;
  int* taken;
};

// Evaluate pod p (ops/ffd_step.make_step): nodes, then open claims by fewest
// pods, then a fresh claim from the first accepting template. Leaves the
// verdict in s.kind / s.index / s.bin and the bins' narrowed rows in the
// fin_* scratch; commits nothing. With ``ch`` (a chain commit follows) it
// also fills the ChainEval tables, s.rank2 and s.node_static: the types of
// every claim that passes its gates are tested in full instead of up to the
// first survivor.
template <class A>
__device__ void step_eval(const A& a, int p, Shared& s, int* s_gmin, int* s_boot, int* s_nothing,
                          int* s_maxcap, const TopoRun* tr = nullptr, const ChainEval* ch = nullptr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, W = a.W, N = a.N, C = a.C, R = a.R;
  const ITs its = its_of(a);
  const float* preq = a.pod_requests + (long)p * R;
  const uint8_t* pconf = a.pod_conflict + (long)p * a.PT;
  if (tid == 0) {
    s.node_pick = N;
    s.claim_rank = BIG;
    s.rank2 = BIG;
    s.node_static = 0;
    s.tpl_pick = a.TPL;
    s.free_slot = C;
  }
  for (int r = tid; r < R; r += THREADS) s_maxcap[r] = 0;  // bits of 0.0f
  group_prep(a, p, -1, s_gmin, s_boot, s_nothing);
  block_sync();

  // -- 1. existing nodes
  for (int n = warp; n < N; n += NWARPS) {
    const Row base = row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, n, K, W);
    bool parts[2];
    bin_gate(a, p, base, nullptr, n, nullptr, -1, -1, s_gmin, s_boot, s_nothing, parts);
    if (lane == 0) {
      // the gates that do not read the topology counters; a topology run
      // reads the node's integer capacity at the run's start less its
      // members placed so far, and has no volumes
      bool st = parts[0] && a.pod_tol_node[(long)p * N + n] &&
                (tr ? tr->res_cap[n] - tr->taken[n] > 0
                    : fits_add(a.node_requests + (long)n * R, preq, a.node_avail + (long)n * R, R));
      for (int q = 0; q < a.PT && st; ++q)
        if (a.node_ports[(long)n * a.PT + q] && pconf[q]) st = false;
      for (int d = 0; d < a.D && st && !tr; ++d)
        if (a.node_vol_used[(long)n * a.D + d] + a.pod_vols[(long)p * a.D + d] > a.node_vol_limits[(long)n * a.D + d])
          st = false;
      if (st) s.node_static = 1;
      if (st && parts[1]) atomicMin(&s.node_pick, n);
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
      bool parts[2];
      bin_gate(a, p, base, nullptr, N + c, a.wellknown, -1, -1, s_gmin, s_boot, s_nothing, parts);
      bool pre = parts[0] && a.pod_tol_tpl[(long)p * a.TPL + a.claim_tpl[c]] != 0;
      for (int q = 0; q < a.PT && pre; ++q)
        if (a.claim_ports[(long)c * a.PT + q] && pconf[q]) pre = false;
      if (lane == 0) {
        a.bin_ok[N + c] = pre && parts[1];
        if (ch) {
          ch->pre[c] = pre;
          ch->topo[c] = parts[1];
        }
      }
    }
    block_sync();
    if (ch) {
      // the full claims x instance-types table of the claims that pass
      // their gates: survivors and capacities (a claim that fails them takes
      // no pod of the chain; the spread mini-scan fills its row if it runs)
      int port_cap = BIG_CAP;
      for (int q = 0; q < a.PT; ++q)
        if (a.pod_ports[(long)p * a.PT + q]) port_cap = 1;
      for (int c = warp; c < C; c += NWARPS) {
        if (!a.claim_open[c] || !a.bin_ok[N + c]) {
          if (lane == 0) {
            ch->capc[c] = 0;
            if (!a.claim_open[c]) {
              ch->pre[c] = 0;
              ch->topo[c] = 0;
            }
          }
          continue;
        }
        int best = 0;
        bool any = false;
        for (int t = lane; t < a.T; t += 32) {
          const bool okt = claim_type_ok(a, its, p, c, t);
          const int cap = capacity(a.it_alloc + (long)t * R, a.claim_requests + (long)c * R, preq, R);
          ch->ok_t[(long)c * a.T + t] = okt;
          ch->cap_t[(long)c * a.T + t] = cap;
          if (okt) {
            any = true;
            best = max(best, cap);
          }
        }
        best = warp_max(best);
        any = __any_sync(FULL, any);
        if (lane == 0) {
          count_work(WORK_TYPE_TESTS, a.T);
          const bool cok = a.bin_ok[N + c] && any;
          a.bin_ok[N + c] = cok;
          ch->capc[c] = cok ? min(best, port_cap) : 0;
          if (cok) atomicMin(&s.claim_rank, a.claim_npods[c] * C + c);
        }
      }
      block_sync();
      for (int c = tid; c < C; c += THREADS) {
        const int rank = a.claim_npods[c] * C + c;
        if (a.claim_open[c] && a.bin_ok[N + c] && rank != s.claim_rank) atomicMin(&s.rank2, rank);
      }
    } else {
      // the claims x instance-types survival test: a warp per candidate
      // claim, 32 types per ballot, stopping at the first chunk with a
      // survivor
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
  }
  block_sync();
}

// Commit pod p's verdict of the step_eval just before (every gate read the
// pre-commit state) and record it. ``cap_gate``: the sweeps loop's commit,
// which also keeps a claim's type only while one more pod fits its integer
// capacity (ops/ffd_sweeps narrow_iter's ``cap_ct_all >= take``).
template <class A>
__device__ void step_commit(const A& a, int p, Shared& s, int* s_maxcap, const TopoRun* tr = nullptr,
                            bool cap_gate = false) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, W = a.W, R = a.R;
  const ITs its = its_of(a);
  const float* preq = a.pod_requests + (long)p * R;
  const int kind = s.kind;
  if (kind == KIND_FAIL || kind == KIND_NO_SLOT) return;
  const int idx = s.index, bin = s.bin;

  if (kind == KIND_NODE && tr) {
    // a topology run applies its members' node requests after the run
    copy_row(a, bin, a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, idx);
    if (tid == 0) tr->taken[idx] += 1;
  } else if (kind == KIND_NODE) {
    copy_row(a, bin, a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, idx);
    for (int r = tid; r < R; r += THREADS) a.node_requests[(long)idx * R + r] += preq[r];
    for (int q = tid; q < a.PT; q += THREADS) a.node_ports[(long)idx * a.PT + q] |= a.pod_ports[(long)p * a.PT + q];
    for (int d = tid; d < a.D; d += THREADS) a.node_vol_used[(long)idx * a.D + d] += a.pod_vols[(long)p * a.D + d];
    if (tid == 0) a.node_npods[idx] += 1;
  } else if (kind == KIND_CLAIM) {
    // the committed row of survivors, read against the pre-commit requests
    if (tid == 0) count_work(WORK_TYPE_TESTS, a.T);
    for (int t = tid; t < a.T; t += THREADS)
      a.claim_it_ok[(long)idx * a.T + t] =
          claim_type_ok(a, its, p, idx, t) &&
          (!cap_gate || capacity(a.it_alloc + (long)t * R, a.claim_requests + (long)idx * R, preq, R) >= 1);
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
  // a topology run's member records with its own select row
  const int ps = tr ? tr->psel : p;
  bool any_rec = false;
  for (int g = 0; g < a.G; ++g)
    any_rec |= a.pod_selects[(long)ps * a.G + g] || a.pod_owned[(long)p * a.G + g];
  if (!any_rec) return;
  block_sync();
  const Row rec = fin_row(a, bin);
  const uint8_t* rec_neg = a.fin_neg + (long)bin * K;
  const uint8_t* allow = kind == KIND_NODE ? nullptr : a.wellknown;
  const TopoGroups tg = topo_of(a);
  for (int g = warp; g < a.G; g += NWARPS) {
    const int kg = a.grp_key[g];
    if (!records_group(tg, g, rec, rec_neg, a.pod_selects[(long)ps * a.G + g], a.pod_owned[(long)p * a.G + g],
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

// Place pod p: step_eval, then step_commit.
template <class A>
__device__ void step(const A& a, int p, Shared& s, int* s_gmin, int* s_boot, int* s_nothing,
                     int* s_maxcap, const TopoRun* tr = nullptr) {
  step_eval(a, p, s, s_gmin, s_boot, s_nothing, s_maxcap, tr);
  step_commit(a, p, s, s_maxcap, tr);
}

}  // namespace
