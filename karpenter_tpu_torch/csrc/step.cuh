// The per-pod FFD step as device code, shared by the FFD loop kernel
// (ffd_loop.cu) and the consolidation screen kernel (runs_screen.cu).
//
// Device counterpart of karpenter_tpu_torch/ops/ffd_step.make_step (the JAX
// package's ops/ffd_step._make_step): places one pod in the reference's
// priority order (scheduler.go:238-285) against the state its argument struct
// points at. The functions are templates over that struct: any struct with
// ffd_loop.cu FfdArgs' field names works, so a kernel that keeps one state
// per block hands each block a struct whose state pointers are offset to its
// own slot. The caller writes the verdict rows from Shared::kind /
// Shared::index after the call.
//
// They are templates over a Scope too: who runs the step. ``BlockScope`` is
// one block alone (the screen's lanes in its block layout, the explain
// pass): every barrier is a block barrier and the block owns every instance
// type. ``ClusterScope`` is one block of a thread-block cluster that runs one
// solve (ffd_loop; the screen's lanes in its cluster layout): the
// bins' gates and the topology groups go to the cluster's warps round-robin,
// each block owns a slice of the instance types (its TypeSlice, resident in
// its shared memory or read from device memory), the cross-block results
// meet in the leader block's shared memory through distributed shared memory
// with integer atomics (the same answer in any order), and a cluster barrier
// orders every block's writes before any block reads them. Scalar decisions
// run the same way in every block, each on its own copy (Shared, the chain's
// per-block scratch), so the cluster's control flow is uniform. Both scopes
// run the same step: a lone block is a cluster of one, whose atomics land in
// its own shared memory.
//
// Threads: THREADS per block. A warp per bin (existing node, open claim,
// template) merges and gates the bin; the survival tests go a warp per
// (claim, 32 types); integer atomicMin/Max/Or pick the winners.
//
// No shape limit: the per-key work loops over keys in strides of 32 (a warp
// lane per key), and the topology gate folds its allowed-lane masks over the
// value words in chunks of 64 (a 64-bit mask per warp lane), so any K and V
// that fit the device's memory run.
#pragma once

#include <cuda_runtime.h>

#include "hopper.cuh"
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
constexpr int WORK_BIN_GATES = 0;         // bin rows merged + gated against a pod
constexpr int WORK_TOPO_LANES = 1;        // value lanes of matched topology groups read
constexpr int WORK_TYPE_TESTS = 2;        // (bin, instance type) survival tests a scan in rank order needs
constexpr int WORK_BARRIERS = 3;          // block-wide barriers (the leader block's)
constexpr int WORK_CLUSTER_BARRIERS = 4;  // cluster-wide barriers
constexpr int NWORK = 5;

__shared__ unsigned long long s_work[NWORK];

__device__ __forceinline__ void count_work(int i, long n) { atomicAdd(&s_work[i], (unsigned long long)n); }

// __syncthreads, counted
__device__ __forceinline__ void block_sync() {
  if (threadIdx.x == 0) s_work[WORK_BARRIERS] += 1;
  __syncthreads();
}

// section counters (FfdArgs::sections): clock64 cycles of the loop by
// section, read by thread 0 right after the barrier that ends a section.
// sec_to(x) closes the section in progress and opens x.
constexpr int SEC_GROUP_PREP = 0;  // group_prep (TopologyGroup.Get's per-pod part)
constexpr int SEC_BIN_GATES = 1;   // node and claim gates
constexpr int SEC_TABLE = 2;       // the claims x types table of a chain head
constexpr int SEC_FIRST = 3;       // the first-survivor test
constexpr int SEC_TEMPLATE = 4;    // template gates and their type test
constexpr int SEC_CHAIN = 5;       // stack/fill safety, the spread shape
constexpr int SEC_FILL = 6;
constexpr int SEC_ROUND = 7;
constexpr int SEC_SPREAD = 8;
constexpr int SEC_SINGLE = 9;
constexpr int SEC_COMMIT = 10;     // state rows of a commit
constexpr int SEC_RECORD = 11;     // topology records
constexpr int SEC_QUEUE = 12;      // chain scan, verdict, verdict rows, requeue
constexpr int SEC_WAVE = 13;       // the wavefront's own bookkeeping
constexpr int NSEC = 14;

// [NSEC] cycles, then the clock of the last mark and the open section
__shared__ long long s_sec[NSEC + 2];

__device__ __forceinline__ void sec_to(int next) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    s_sec[s_sec[NSEC + 1]] += now - s_sec[NSEC];
    s_sec[NSEC] = now;
    s_sec[NSEC + 1] = next;
  }
}

__device__ __forceinline__ void sec_start() {
  if (threadIdx.x < NSEC) s_sec[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    s_sec[NSEC] = clock64();
    s_sec[NSEC + 1] = SEC_QUEUE;
  }
}

struct Shared {
  int node_pick, claim_rank, tpl_pick, free_slot;
  int kind, index, bin, host_lane;
  int qlen, nqlen, noslot, progress, cur, stepped, sweeps, chains, chain_pods;
  int rank2, node_static;  // second-best claim rank; a node passes its static gates
  int ncand;               // candidate claims (StepMem::cand)
};

// The cross-block reduction targets of a step: the leader block's copy
// receives every block's atomics (a lone block's, its own).
struct Red {
  int node_pick, node_static, insensitive;
};

// A step's per-block shared arrays (dynamic shared memory, carved by the
// kernel). gmin/boot/nothing are written into every block's copy; maxcap,
// any/best/fs and tok/tfs receive the cluster's atomics in the leader's copy.
struct StepMem {
  int* gmin;     // [G] spread global minimum
  int* boot;     // [G] affinity bootstrap's best rank
  int* nothing;  // [G] nothing placed yet
  int* mg;       // [G] the pod's matched groups (group_prep), or null
  int* mk;       // [G] their keys
  int* nm;       // [1] how many
  int* maxcap;   // [R] a fresh claim's largest surviving capacity (float bits)
  int* any;      // [C] the claim keeps a type (chain table)
  int* best;     // [C] its best capacity
  int* fs;       // [C] its first surviving type
  int* cand;     // [C] this block's list of candidate claims
  int* tok;      // [TPL] the template passes its gates
  int* tfs;      // [TPL] its first surviving type
};

// A block's instance types [t0, t1) and its tables, every pointer indexed by
// the global type t: resident slices in shared memory (offset by -t0, row
// stride tstride = the slice width) or the tables in device memory (stride T).
struct TypeSlice {
  int t0, t1, tstride;
  ITs its;
  const float* cap;       // it_cap [t * R]
  const uint8_t* tpl_ok;  // tpl_it_ok [j * tstride + t]
  uint8_t* cio;           // claim_it_ok [c * tstride + t]
  uint8_t* ok_t;          // the chain head's survivors [c * tstride + t]
  uint8_t* cap_t;         // their capacities, saturated at 255 (chain.cuh)
};

template <bool CL>
struct Scope {
  int rank, size;
  TypeSlice ts;
  __device__ __forceinline__ bool leader() const { return rank == 0; }
  __device__ __forceinline__ int gwarp() const { return rank * NWARPS + (int)(threadIdx.x >> 5); }
  __device__ __forceinline__ int nwarps() const { return size * NWARPS; }
  __device__ __forceinline__ int gthread() const { return rank * THREADS + (int)threadIdx.x; }
  __device__ __forceinline__ int nthreads() const { return size * THREADS; }
  // the copy of a shared-memory object in block r / in the leader
  template <class T>
  __device__ __forceinline__ T* at(T* p, int r) const {
    if constexpr (CL)
      return map_rank(p, r);
    else
      return p;
  }
  template <class T>
  __device__ __forceinline__ T* lead(T* p) const {
    return at(p, 0);
  }
  // a section mark (sec_to) of the cluster's loop; a lone block marks none
  __device__ __forceinline__ void mark(int next) const {
    if constexpr (CL) sec_to(next);
  }
  // the barrier that orders cross-block results: cluster-wide (counted as a
  // cluster barrier), or the block's own
  __device__ __forceinline__ void sync() const {
    if constexpr (CL) {
      if (threadIdx.x == 0) s_work[WORK_CLUSTER_BARRIERS] += 1;
      cluster_barrier();
    } else {
      block_sync();
    }
  }
};
using BlockScope = Scope<false>;
using ClusterScope = Scope<true>;

// A block alone without a type slice, and the group scratch of a kernel
// that calls group_prep and bin_gate without the step (attribute.cu).
__device__ __forceinline__ BlockScope lone_block() {
  BlockScope sc{};
  sc.rank = 0;
  sc.size = 1;
  return sc;
}

__device__ __forceinline__ StepMem group_mem(int* gmin, int* boot, int* nothing, int* maxcap = nullptr) {
  StepMem m{};
  m.gmin = gmin;
  m.boot = boot;
  m.nothing = nothing;
  m.maxcap = maxcap;
  return m;
}

// What a chain commit (chain.cuh) reads of the evaluation beyond the verdict,
// in the block's own scratch rows: each claim's capacity for the chain (0
// unless it passes its gates and keeps a type), its gates before and of the
// topology, and whether it passes all of them. ``stride``: the distance
// between two blocks' rows (the gates write pre/topo into every block's).
// The surviving types and per-type capacities are TypeSlice::ok_t / cap_t.
struct ChainEval {
  int* capc;  // [C]
  int* pre;   // [C] claim_ok_pre: open, tolerated, ports, compatible
  int* topo;  // [C] the topology gate passed
  int* cok;   // [C] open, gates passed and a type kept
  long stride;
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

// ops/ffd_core._water_level, by one warp: the largest L with
// sum(clip(L - lvl, 0, cap)) <= units, by a 22-step bisection, each step's
// sum over the n claims a warp_sum (integer, so the order does not change
// it). A lane keeps its first four claims' levels and caps in registers for
// the 22 steps.
__device__ int warp_water_level(const int* lvl, const int* cap, int n, int units) {
  const int lane = threadIdx.x & 31;
  int lv[4], cp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    lv[i] = c < n ? lvl[c] : 0;
    cp[i] = c < n ? cap[c] : 0;
  }
  int lo = 0, hi = 2 * BIG_CAP;
  for (int it = 0; it < 22; ++it) {
    const int mid = (lo + hi + 1) / 2;
    int used = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) used += min(max(mid - lv[i], 0), cp[i]);
    for (int c = lane + 128; c < n; c += 32) used += min(max(mid - lvl[c], 0), cap[c]);
    used = warp_sum(used);
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
// whether anything is placed yet (ops/topology_kernels.allowed_domains), a
// warp per group over the scope's warps, written into every block's copy.
// ``extra_lane`` registers the fresh claim's minted hostname lane. With
// m.mg, each block also lists the pod's matched groups and their keys for
// bin_gate.
template <class S, class A>
__device__ void group_prep(const S& sc, const A& a, int p, int extra_lane, const StepMem& m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = sc.gwarp(); g < a.G; g += sc.nwarps()) {
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
    if (lane < sc.size) {
      int gmin = cmin;
      const int md = a.grp_min_domains[g];
      if (md >= 0 && nsup < md) gmin = 0;
      if (kg == HOSTNAME_KEY) gmin = 0;
      sc.at(m.gmin, lane)[g] = gmin;
      sc.at(m.boot, lane)[g] = lmin;
      sc.at(m.nothing, lane)[g] = !pos;
    }
  }
  if (m.mg && warp == NWARPS - 1) {
    // the pod's matched groups in group order, by the last warp of each block
    const uint8_t* match = a.pod_match + (long)p * a.G;
    int n = 0;
    for (int g0 = 0; g0 < a.G; g0 += 32) {
      const int g = g0 + lane;
      const bool on = g < a.G && match[g];
      const unsigned word = __ballot_sync(FULL, on);
      if (on) {
        const int at = n + __popc(word & ((1u << lane) - 1u));
        m.mg[at] = g;
        m.mk[at] = a.grp_key[g];
      }
      n += __popc(word);
    }
    if (lane == 0) *m.nm = n;
  }
}

// One warp: merge the bin's row with the pod's, apply the topology gate
// (TopologyGroup.Get + AddRequirements, ops/topology_kernels.topo_gate) and
// write the narrowed row to the fin_* scratch of bin ``b``. Returns
// Compatible(base, pod) && topology-ok, uniform across the warp; ``parts``
// (optional) receives the two halves apart: [0] compatible, [1] topology.
// With LIST, ``m`` carries the pod's matched groups from group_prep (the
// step); without, the warp finds them in the pod's match row.
template <bool LIST = false, class A>
__device__ bool bin_gate(const A& a, int p, const Row& base, const uint8_t* base_neg, int b,
                         const uint8_t* allow, int pin_lane, int extra_lane, const int* s_gmin,
                         const int* s_boot, const int* s_nothing, bool* parts = nullptr,
                         const StepMem* m = nullptr) {
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

  // the keys the pod's matched groups touch, each once: from the list, the
  // first entry of each key; without it, every key with a matched group
  const uint8_t* match = a.pod_match + (long)p * a.G;
  const int nm = LIST ? *m->nm : 0;
  const int nkeys = LIST ? nm : (a.G > 0 ? K : 0);
  for (int i = 0; i < nkeys; ++i) {
    int k;
    if constexpr (LIST) {
      k = m->mk[i];
      bool seen = false;
      for (int j = 0; j < i && !seen; ++j) seen = m->mk[j] == k;
      if (seen) continue;
    } else {
      k = i;
      bool touched = false;
      for (int g = 0; g < a.G; ++g) touched |= match[g] && a.grp_key[g] == k;
      if (!touched) continue;
    }
    // the matched groups of key k: list entries from i, or every group
    const int j_first = LIST ? i : 0, j_end = LIST ? nm : a.G;
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
      for (int jg = j_first; jg < j_end; ++jg) {
        int g = jg;
        if constexpr (LIST) {
          g = m->mg[jg];
          if (m->mk[jg] != k) continue;
        } else if (!match[g] || a.grp_key[g] != k) {
          continue;
        }
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
            const int self = cnt[v] + sel, lx = lexk[v];
            const bool reg = registered_at(a, g, k, v, extra_lane);
            if (reg && nd_bit(v) && self - s_gmin[g] <= a.grp_max_skew[g]) best = min(best, self * V + min(lx, V - 1));
          }
          best = warp_min(best);
        } else if (type == 1) {
          for (int j = 0; j < W; ++j) {
            const int v = 32 * j + lane;
            const int lx = lexk[v];
            const bool reg = registered_at(a, g, k, v, extra_lane);
            if (reg && bit_of(pdw, v) && nd_bit(v)) best = min(best, lx);
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

// NodePool limits (template j's pessimistic capacity of type t fits its
// remaining headroom), then the survival test of the template's row
template <class A>
__device__ __forceinline__ bool tpl_type_ok(const TypeSlice& ts, const A& a, int p, int j, int t) {
  const int b = a.N + a.C + j;
  return ts.tpl_ok[(long)j * ts.tstride + t] &&
         fits_add(ts.cap + (long)t * a.R, nullptr, a.remaining + (long)j * a.R, a.R) &&
         it_gate(fin_row(a, b), a.fin_neg + (long)b * a.K, a.tpl_overhead + (long)j * a.R,
                 a.pod_requests + (long)p * a.R, ts.its, t, a.K, a.W, a.R, a.O);
}

template <class A>
__device__ __forceinline__ bool claim_type_ok(const TypeSlice& ts, const A& a, int p, int c, int t) {
  const int b = a.N + c;
  return ts.cio[(long)c * ts.tstride + t] &&
         it_gate(fin_row(a, b), a.fin_neg + (long)b * a.K, a.claim_requests + (long)c * a.R,
                 a.pod_requests + (long)p * a.R, ts.its, t, a.K, a.W, a.R, a.O);
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

// This block's list of the claims that are open and pass their gates
// (bin_ok), in slot order, into m.cand / s.ncand (one warp, then a barrier).
template <class A>
__device__ void candidate_claims(const A& a, Shared& s, const StepMem& m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    int n = 0;
    for (int c0 = 0; c0 < a.C; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < a.C && a.claim_open[c] && a.bin_ok[a.N + c];
      const unsigned word = __ballot_sync(FULL, on);
      if (on) m.cand[n + __popc(word & ((1u << lane) - 1u))] = c;
      n += __popc(word);
    }
    if (lane == 0) s.ncand = n;
  }
  block_sync();
}

// The first surviving type of claim c (template j) in the block's slice, a
// warp over 32 types at a time from t0 (MAXI if none); the lanes agree.
template <class A>
__device__ int first_claim_type(const TypeSlice& ts, const A& a, int p, int c) {
  const int lane = threadIdx.x & 31;
  for (int t0 = ts.t0; t0 < ts.t1; t0 += 32) {
    const int t = t0 + lane;
    const unsigned word = __ballot_sync(FULL, t < ts.t1 && claim_type_ok(ts, a, p, c, t));
    if (word) return t0 + __ffs(word) - 1;
  }
  return MAXI;
}

template <class A>
__device__ int first_tpl_type(const TypeSlice& ts, const A& a, int p, int j) {
  const int lane = threadIdx.x & 31;
  for (int t0 = ts.t0; t0 < ts.t1; t0 += 32) {
    const int t = t0 + lane;
    const unsigned word = __ballot_sync(FULL, t < ts.t1 && tpl_type_ok(ts, a, p, j, t));
    if (word) return t0 + __ffs(word) - 1;
  }
  return MAXI;
}

// The type tests a block alone needs to meet the first survivor ``fs``, 32
// types a round from type 0 (all T when none survives).
__device__ __forceinline__ long first_tests(int fs, int T) { return fs < T ? min(T, (fs / 32 + 1) * 32) : T; }

// Evaluate pod p (ops/ffd_step.make_step): nodes, then open claims by fewest
// pods, then a fresh claim from the first accepting template. Leaves the
// verdict in s.kind / s.index / s.bin and the bins' narrowed rows in the
// fin_* scratch; commits nothing. With ``ch`` (a chain commit follows; the
// cluster scope) it also fills the block's slice of ok_t / cap_t, the
// ChainEval rows, s.rank2 and s.node_static: the types of every claim that
// passes its gates are tested in full instead of up to the first survivor.
// Every block of a cluster leaves the same verdict in its own Shared.
template <class S, class A>
__device__ void step_eval(const S& sc, const A& a, int p, Shared& s, Red& red, const StepMem& m,
                          const TopoRun* tr = nullptr, const ChainEval* ch = nullptr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gw = sc.gwarp(), nw = sc.nwarps();
  const int K = a.K, W = a.W, N = a.N, C = a.C, R = a.R, T = a.T;
  const TypeSlice& ts = sc.ts;
  const float* preq = a.pod_requests + (long)p * R;
  const uint8_t* pconf = a.pod_conflict + (long)p * a.PT;
  if (tid == 0) {
    s.node_pick = N;
    s.claim_rank = BIG;
    s.rank2 = BIG;
    s.node_static = 0;
    s.tpl_pick = a.TPL;
    s.free_slot = C;
    red.node_pick = N;
    red.node_static = 0;
    red.insensitive = 1;
  }
  sc.mark(SEC_GROUP_PREP);
  for (int r = tid; r < R; r += THREADS) m.maxcap[r] = 0;  // bits of 0.0f
  for (int c = tid; c < C; c += THREADS) {
    m.any[c] = 0;
    m.best[c] = 0;
    m.fs[c] = MAXI;
  }
  for (int j = tid; j < a.TPL; j += THREADS) {
    m.tok[j] = 0;
    m.tfs[j] = MAXI;
  }
  group_prep(sc, a, p, -1, m);
  sc.sync();
  sc.mark(SEC_BIN_GATES);
  Red* red0 = sc.lead(&red);

  // -- 1. existing nodes
  for (int n = gw; n < N; n += nw) {
    const Row base = row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, n, K, W);
    bool parts[2];
    bin_gate<true>(a, p, base, nullptr, n, nullptr, -1, -1, m.gmin, m.boot, m.nothing, parts, &m);
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
      if (st) atomicMax(&red0->node_static, 1);
      if (st && parts[1]) atomicMin(&red0->node_pick, n);
    }
  }
  for (int c = tid; c < C; c += THREADS)
    if (!a.claim_open[c]) atomicMin(&s.free_slot, c);
  if (N > 0)
    sc.sync();
  else
    block_sync();
  if (tid == 0) {
    s.node_pick = red0->node_pick;
    s.node_static = red0->node_static;
  }
  block_sync();
  const bool any_node = s.node_pick < N;

  // -- 2. open claims, fewest pods first (only read when no node accepts)
  if (!any_node) {
    for (int c = gw; c < C; c += nw) {
      if (!a.claim_open[c]) continue;
      const Row base = row_at(a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, c, K, W);
      bool parts[2];
      bin_gate<true>(a, p, base, nullptr, N + c, a.wellknown, -1, -1, m.gmin, m.boot, m.nothing, parts, &m);
      bool pre = parts[0] && a.pod_tol_tpl[(long)p * a.TPL + a.claim_tpl[c]] != 0;
      for (int q = 0; q < a.PT && pre; ++q)
        if (a.claim_ports[(long)c * a.PT + q] && pconf[q]) pre = false;
      if (lane == 0) {
        a.bin_ok[N + c] = pre && parts[1];
        if (ch)
          for (int r = 0; r < sc.size; ++r) {
            ch->pre[(long)(r - sc.rank) * ch->stride + c] = pre;
            ch->topo[(long)(r - sc.rank) * ch->stride + c] = parts[1];
          }
      }
    }
    sc.sync();
    sc.mark(ch ? SEC_TABLE : SEC_FIRST);
    candidate_claims(a, s, m);
    const int ncand = s.ncand;
    if (ch) {
      // the full claims x instance-types table of the claims that pass
      // their gates, over the block's slice: survivors and capacities (a
      // claim that fails them takes no pod of the chain; the spread
      // mini-scan fills its row if it runs), a warp per (claim, 32 types);
      // a capacity is read only where its type survives
      const int nchunk = (ts.t1 - ts.t0 + 31) / 32;
      for (int w = warp; w < ncand * nchunk; w += NWARPS) {
        const int c = m.cand[w / nchunk];
        const int t = ts.t0 + (w % nchunk) * 32 + lane;
        bool okt = false;
        int cap = 0;
        if (t < ts.t1) {
          okt = claim_type_ok(ts, a, p, c, t);
          if (okt) cap = capacity(ts.its.alloc + (long)t * R, a.claim_requests + (long)c * R, preq, R);
          ts.ok_t[(long)c * ts.tstride + t] = okt;
          ts.cap_t[(long)c * ts.tstride + t] = (uint8_t)min(cap, 255);
        }
        const int best = warp_max(cap);
        if (__any_sync(FULL, okt) && lane == 0) {
          atomicOr(sc.lead(m.any) + c, 1);
          atomicMax(sc.lead(m.best) + c, best);
        }
      }
      if (sc.leader() && tid == 0) count_work(WORK_TYPE_TESTS, (long)ncand * T);
      sc.sync();
      // every block: the claims that keep a type, their capacity for the
      // chain and the two best ranks, from the leader's reduction
      int port_cap = BIG_CAP;
      for (int q = 0; q < a.PT; ++q)
        if (a.pod_ports[(long)p * a.PT + q]) port_cap = 1;
      const int* any0 = sc.lead(m.any);
      const int* best0 = sc.lead(m.best);
      for (int c = tid; c < C; c += THREADS) {
        const bool open = a.claim_open[c];
        const bool cok = open && a.bin_ok[N + c] && any0[c];
        ch->cok[c] = cok;
        ch->capc[c] = cok ? min(best0[c], port_cap) : 0;
        if (!open) {
          ch->pre[c] = 0;
          ch->topo[c] = 0;
        }
        if (cok) atomicMin(&s.claim_rank, a.claim_npods[c] * C + c);
      }
      block_sync();
      for (int c = tid; c < C; c += THREADS) {
        const int rank = a.claim_npods[c] * C + c;
        if (ch->cok[c] && rank != s.claim_rank) atomicMin(&s.rank2, rank);
      }
    } else {
      // the claims x instance-types survival test: a warp per candidate
      // claim over the block's slice, up to its first surviving chunk
      for (int i = warp; i < ncand; i += NWARPS) {
        const int c = m.cand[i];
        const int f = first_claim_type(ts, a, p, c);
        if (lane == 0 && f < MAXI) atomicMin(sc.lead(m.fs) + c, f);
      }
      sc.sync();
      const int* fs0 = sc.lead(m.fs);
      for (int i = tid; i < ncand; i += THREADS) {
        const int c = m.cand[i];
        if (fs0[c] < MAXI) atomicMin(&s.claim_rank, a.claim_npods[c] * C + c);
      }
    }
    block_sync();
    if (!ch && sc.leader() && tid == 0) {
      // the bound's yardstick: the tests a scan of the candidates in rank
      // order needs, whatever this design ran. All T for each claim ranked
      // before the winner (none survives), the winner's up to its first
      // survivor, nothing after it; all T each when none wins.
      const int* fs0 = sc.lead(m.fs);
      long tests = 0;
      for (int i = 0; i < s.ncand; ++i) {
        const int c = m.cand[i];
        if (a.claim_npods[c] * C + c <= s.claim_rank) tests += first_tests(fs0[c], T);
      }
      count_work(WORK_TYPE_TESTS, tests);
    }
  }
  const bool any_claim = s.claim_rank < BIG;
  const bool has_slot = s.free_slot < C;

  // -- 3. fresh claim from templates, weight order; the prospective slot's
  // hostname is minted, pinned and registered before the gates see it
  if (!any_node && !any_claim && has_slot) {
    const int host = a.CH > 0 ? a.host_lane[min(s.free_slot, a.CH - 1)] : -1;
    sc.mark(SEC_GROUP_PREP);
    group_prep(sc, a, p, host, m);
    sc.sync();
    sc.mark(SEC_TEMPLATE);
    // the templates' gates on the scope's warps, then each block's slice
    // of the passing templates' types, up to the first surviving chunk
    for (int j = gw; j < a.TPL; j += nw) {
      const Row base = row_at(a.tpl_adm, a.tpl_comp, a.tpl_def, a.tpl_gt, a.tpl_lt, j, K, W);
      const bool ok = bin_gate<true>(a, p, base, a.tpl_neg + (long)j * K, N + C + j, a.wellknown, host, host,
                                     m.gmin, m.boot, m.nothing, nullptr, &m) &&
                      a.pod_tol_tpl[(long)p * a.TPL + j];
      if (lane == 0) sc.lead(m.tok)[j] = ok;
    }
    sc.sync();
    const int* tok0 = sc.lead(m.tok);
    for (int j = warp; j < a.TPL; j += NWARPS) {
      if (!tok0[j]) continue;
      const int f = first_tpl_type(ts, a, p, j);
      if (lane == 0 && f < MAXI) atomicMin(sc.lead(m.tfs) + j, f);
    }
    sc.sync();
    if (tid == 0) {
      // the first passing template with a survivor; the yardstick counts
      // the tests of a scan in template order up to it
      const int* tfs0 = sc.lead(m.tfs);
      long tests = 0;
      for (int j = 0; j < a.TPL && s.tpl_pick == a.TPL; ++j) {
        if (!tok0[j]) continue;
        tests += first_tests(tfs0[j], T);
        if (tfs0[j] < MAXI) s.tpl_pick = j;
      }
      if (sc.leader()) count_work(WORK_TYPE_TESTS, tests);
      s.host_lane = host;
    }
    block_sync();
  }
  sc.mark(SEC_QUEUE);

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
// capacity (ops/ffd_sweeps narrow_iter's ``cap_ct_all >= take``). First
// every block writes its slice of the committed survivors row against the
// pre-commit state; after a barrier the leader block writes the bin's state
// rows while the records go to the scope's warps, a group each. The caller
// puts a barrier after it before anything reads the state.
template <class S, class A>
__device__ void step_commit(const S& sc, const A& a, int p, Shared& s, const StepMem& m, const TopoRun* tr = nullptr,
                            bool cap_gate = false) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int K = a.K, W = a.W, R = a.R;
  const TypeSlice& ts = sc.ts;
  const float* preq = a.pod_requests + (long)p * R;
  const int kind = s.kind;
  if (kind == KIND_FAIL || kind == KIND_NO_SLOT) return;
  const int idx = s.index, bin = s.bin;
  sc.mark(SEC_COMMIT);

  if (kind == KIND_CLAIM) {
    // the committed row of survivors, read against the pre-commit requests
    if (sc.leader() && tid == 0) count_work(WORK_TYPE_TESTS, a.T);
    for (int t = ts.t0 + tid; t < ts.t1; t += THREADS)
      ts.cio[(long)idx * ts.tstride + t] =
          claim_type_ok(ts, a, p, idx, t) &&
          (!cap_gate || capacity(ts.its.alloc + (long)t * R, a.claim_requests + (long)idx * R, preq, R) >= 1);
    sc.sync();
  } else if (kind == KIND_NEW_CLAIM) {
    const int j = s.tpl_pick;
    if (sc.leader() && tid == 0) count_work(WORK_TYPE_TESTS, a.T);
    int* maxcap0 = sc.lead(m.maxcap);
    for (int t = ts.t0 + tid; t < ts.t1; t += THREADS) {
      const bool ok = tpl_type_ok(ts, a, p, j, t);
      ts.cio[(long)idx * ts.tstride + t] = ok;
      if (ok)  // caps are >= 0, so their float bits order as ints
        for (int r = 0; r < R; ++r) atomicMax(&maxcap0[r], __float_as_int(ts.cap[(long)t * R + r]));
    }
    sc.sync();
  }

  if (sc.leader()) {
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
      copy_row(a, bin, a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, idx);
      for (int r = tid; r < R; r += THREADS) a.claim_requests[(long)idx * R + r] += preq[r];
      for (int q = tid; q < a.PT; q += THREADS) a.claim_ports[(long)idx * a.PT + q] |= a.pod_ports[(long)p * a.PT + q];
      if (tid == 0) a.claim_npods[idx] += 1;
    } else {
      const int j = s.tpl_pick;
      copy_row(a, bin, a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, idx);
      for (int r = tid; r < R; r += THREADS) {
        a.claim_requests[(long)idx * R + r] = a.tpl_overhead[(long)j * R + r] + preq[r];
        // opening a claim burns pessimistic headroom (subtractMax)
        a.remaining[(long)j * R + r] = a.remaining[(long)j * R + r] - __int_as_float(m.maxcap[r]);
      }
      for (int q = tid; q < a.PT; q += THREADS)
        a.claim_ports[(long)idx * a.PT + q] = a.pod_ports[(long)p * a.PT + q] || a.claim_ports[(long)idx * a.PT + q];
      if (tid == 0) {
        a.claim_open[idx] = 1;
        a.claim_npods[idx] += 1;
        a.claim_tpl[idx] = j;
      }
    }
  }

  // -- the fresh claim's minted hostname lane, and the topology record for
  // the chosen bin (topology.go:125-148), a warp per group; a topology run's
  // member records with its own select row
  const int ps = tr ? tr->psel : p;
  bool any_rec = false;
  for (int g = 0; g < a.G; ++g)
    any_rec |= a.pod_selects[(long)ps * a.G + g] || a.pod_owned[(long)p * a.G + g];
  const int host = kind == KIND_NEW_CLAIM ? s.host_lane : -1;
  if (!any_rec && host < 0) return;
  if (any_rec) sc.mark(SEC_RECORD);
  const Row rec = fin_row(a, bin);
  const uint8_t* rec_neg = a.fin_neg + (long)bin * K;
  const uint8_t* allow = kind == KIND_NODE ? nullptr : a.wellknown;
  const TopoGroups tg = topo_of(a);
  for (int g = sc.gwarp(); g < a.G; g += sc.nwarps()) {
    const int kg = a.grp_key[g];
    if (host >= 0 && kg == HOSTNAME_KEY && lane == 0) a.grp_registered[(long)g * a.V + host] = 1;
    if (!any_rec || !records_group(tg, g, rec, rec_neg, a.pod_selects[(long)ps * a.G + g],
                                   a.pod_owned[(long)p * a.G + g], allow, K, W))
      continue;
    __syncwarp();
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
template <class S, class A>
__device__ void step(const S& sc, const A& a, int p, Shared& s, Red& red, const StepMem& m,
                     const TopoRun* tr = nullptr) {
  step_eval(sc, a, p, s, red, m, tr);
  step_commit(sc, a, p, s, m, tr);
}

}  // namespace
