// ffd_loop: the whole FFD requeue loop of one provisioning solve, in one launch.
//
// Replaces the JAX package's device programs
//   ops/ffd_sweeps.py:1910 _solve_ffd_sweeps_fresh_jit (_sweeps_impl :1632)
//   ops/ffd_sweeps.py:1922 _solve_ffd_sweeps_carried_jit (seeded with kind0/index0)
//   ops/ffd_step.py:483/:506 _solve_ffd_jit / _solve_ffd_fresh_jit (one-pass mode)
// In the sweeps modes each iteration evaluates the pod at the queue cursor
// and commits its chain of chain-identical successors (csrc/chain.cuh, the
// JAX package's narrow_iter); the one-pass mode steps one pod at a time
// through ops/ffd_step.make_step's logic, as program 2 has no chains.
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
// commits the scalars. The step itself is csrc/step.cuh, shared with the
// consolidation screen's kernel (runs_screen.cu). A chain commit (chain.cuh)
// consumes up to 64 queue entries an iteration: at 10k the fresh loop runs
// about a fifth as many iterations as pods, each dearer (the types of every
// claim that passes its gates tested in full, then the waterfill, the round
// or the spread mini-scan).
//
// The kernel counts its own work as it goes (WORK_*: bin gates, topology
// lanes of matched groups, instance-type tests, block barriers) into ``work``,
// so a run's operation and latency bounds are read from what this data
// needed, not estimated from shapes.
//
// This uses one SM of the card's 132. Keeping the claim and instance-type
// tables resident in shared memory and splitting the claims x types test
// across blocks are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// masks.cuh for why FMA contraction must stay off).
#include "chain.cuh"
#include "step.cuh"

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
  const uint8_t* pod_eqprev_chain;  // [P] the row extends its predecessor's chain
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
  uint8_t* ok_t;  // [C, T] chain commit: claim_it_ok2 of the head
  int* cap_t;     // [C, T] chain commit: per-type capacity
  int* chain_c;   // [NCS, C] chain commit: per-claim scratch
  int* chain_v;   // [NVS, V] chain commit: per-lane scratch
  // outputs
  int* kind;      // [P]
  int* index;     // [P]
  int* counters;  // [4]: narrow iterations, sweeps, chain commits, chain pods
  unsigned long long* work;  // [NWORK]: WORK_* counters
  // dims
  int P, K, V, W, C, N, T, TPL, R, O, PT, D, G, F, CH, one_pass;
};

namespace {

__global__ void __launch_bounds__(THREADS, 1) ffd_loop_kernel(FfdArgs a) {
  __shared__ Shared s;
  __shared__ ChainShared cs;
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
      if (tid == 0) {
        a.kind[p] = s.kind;
        a.index[p] = s.index;
      }
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
    s.chains = 0;
    s.chain_pods = 0;
  }
  block_sync();
  // requeue until a sweep makes no progress or a pod ran out of claim slots
  while (s.progress && s.qlen > 0 && !s.noslot) {
    if (tid == 0) s.nqlen = 0;
    block_sync();
    const int qlen = s.qlen;
    for (int i = 0; i < qlen;) {
      const int p = q[i];
      if (tid == 0) {
        // the chain run at the cursor: consecutive rows, each chain-identical
        int kc = 1;
        while (kc < STRIDE && i + kc < qlen && q[i + kc] == p + kc && a.pod_eqprev_chain[p + kc]) ++kc;
        cs.kc = kc;
      }
      block_sync();
      narrow_iter(a, p, s, cs, s_gmin, s_boot, s_nothing, s_maxcap);
      block_sync();
      const int k = cs.k, kind = s.kind;
      for (int x = tid; x < k; x += THREADS) {
        a.kind[p + x] = kind;
        a.index[p + x] = cs.of[x];
      }
      if (tid == 0) {
        if (kind == KIND_FAIL)
          for (int x = 0; x < k; ++x) nq[s.nqlen++] = p + x;
        if (kind == KIND_NO_SLOT) s.noslot = 1;
        s.stepped += 1;
        if (k > 1) {
          s.chains += 1;
          s.chain_pods += k;
        }
      }
      i += k;
      block_sync();
    }
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
    a.counters[2] = s.chains;
    a.counters[3] = s.chain_pods;
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
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(ffd_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    // above the card's opt-in limit: the caller raises KernelDeviceError;
    // clear the error so that it does not surface at a later launch
    if (e != cudaSuccess) return (int)cudaGetLastError();
  }
  ffd_loop_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int ffd_sync_probe_launch(int n, void* stream) {
  sync_probe_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(n);
  return (int)cudaGetLastError();
}
