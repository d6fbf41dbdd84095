// ffd_loop: the whole FFD requeue loop of one provisioning solve, in one launch.
//
// Replaces the JAX package's device programs
//   ops/ffd_sweeps.py:1910 _solve_ffd_sweeps_fresh_jit (_sweeps_impl :1632)
//   ops/ffd_sweeps.py:1922 _solve_ffd_sweeps_carried_jit (seeded with kind0/index0)
//   ops/ffd_step.py:483/:506 _solve_ffd_jit / _solve_ffd_fresh_jit (one-pass mode)
//   ops/ffd_sweeps.py:2002/:2024 the learned-order twins of the two sweeps
//   programs (program 6, with order_scores from lane_scores.cu)
//   parallel/mesh.py:468 shard_sweeps_program (program 13) and the carried
//   half of :517 shard_relax2_sweeps_program (program 14), in the lanes mode
//   (ffd_loop_lanes_launch: one cluster per lane)
// In the sweeps modes each iteration evaluates the pod at the queue cursor
// and commits its chain of chain-identical successors (csrc/chain.cuh, the
// JAX package's narrow_iter), and with ``wavefront`` > 0 acts on up to that
// many further chain heads (csrc/wave.cuh, the JAX package's _wave_extend
// :473, KARPENTER_TPU_WAVEFRONT); the one-pass mode steps one pod at a time
// through ops/ffd_step.make_step's logic, as program 2 has no chains (and no
// wavefront).
//
// What bounds it on an H100: the loop is sequential over pods (a verdict
// depends on every earlier commit), so one iteration's latency times the
// iterations is the run time. Its operations (the work counters below) are
// a few tens of microseconds of the card's peak for a whole 10k solve; its
// state (~1 MB at 128 claims x 512 types) stays in L2. What an iteration
// costs is on-chip latency: the barriers between its phases (a cluster
// barrier costs ~0.7 us) and the longest chain of dependent loads within
// each phase: one bin gate, one round of a claim's type tests. The split of
// the leader block's cycles by section (``sections``) shows which phase
// holds an iteration (PERF.md section 5).
//
// What the design does about it: ONE solve runs on a thread-block cluster
// of ``cluster`` blocks (the wrapper's planner, ops/ffd_sweeps.loop_plan,
// picks it: 16 for a lone solve, an H100's largest cluster and faster at
// 10k than the portable 8; 8 or fewer a lane in the lanes mode, so that the
// lanes share the card's SMs). Each block owns
//   * a slice of the instance types, [rank * tslice, +tslice): the claims x
//     types table, the first-survivor and template type tests, the committed
//     survivors rows and the spread's type rows over its slice, a warp per
//     (claim, 32 types). With ``resident`` its slice of the type tables
//     (requirement rows, allocatable, capacity, offerings, the templates'
//     survivors) is copied once into its shared memory by TMA bulk copies,
//     and its slice of the claims' survivors (claim_it_ok, written back at
//     the end: decode, the gate and the next launch read it), of the chain
//     head's survivors (ok_t) and of their capacities (cap_t) lives there
//     for the whole launch; the planner chooses it when the slice fits what a
//     block may opt into, and otherwise the same code reads those tables
//     from device memory.
//   * every cluster-th bin gate, topology group (group_prep, the records)
//     and claim of the committed rows' lists, round-robin over its warps.
// The cross-block results (the first node, a claim's surviving types and
// best capacity, a template's first survivor, a fresh claim's largest
// capacity, the spread's insensitivity) are integer atomics into the leader
// block's shared memory through distributed shared memory: the same answer
// in any order, so the verdicts are exact. A cluster barrier (release/
// acquire at cluster scope) orders every block's writes before another reads
// them; data that stays in a block meets at block barriers. The scalar
// decisions (the verdict, the chain's analysis and branch, the waterfill,
// the queue) run the same way in every block on its own copies (Shared,
// ChainShared, WaveShared, its own rows of chain_c, chain_v, queue and the
// wavefront's marks), so the cluster's control flow is uniform; the leader
// block alone writes the state rows, the verdict rows and the counters.
// The plan arrives in the argument struct; a launch whose cluster is not
// the one it was planned for, or whose slices miss a type, traps.
//
// cap_t is uint8, saturated at 255, and that is exact: every use compares it
// with a member count no larger than the chain's STRIDE (64) — the chain
// commit's and the wavefront's ``cap_t >= take`` (chain.cuh, wave.cuh) — and
// the claim's best capacity for the chain (capc: the waterfill's caps, the
// round's and the spread's ``> 0`` and decrements, the single's min with the
// rank gap, the wavefront's fit) is taken from the unsaturated capacities.
//
// The kernel counts its own work as it goes (WORK_*: bin gates, topology
// lanes of matched groups, the type tests a scan of the bins in rank order
// needs whatever this design runs, the leader block's block barriers and
// the cluster barriers) into ``work``, and the leader's clock by section
// (SEC_*) into ``sections``, so a run's operation and latency bounds and the
// split of its time are read from what this data needed.
//
// With ``order_scores`` (the learned order) the queue of the next sweep is
// sorted at each sweep boundary, stably by descending score
// (ops/ffd_sweeps.py:1843-1850): each entry's rank is the number of entries
// with a higher score or an equal one earlier in the queue (threads over
// entries; -0.0 equals +0.0).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// masks.cuh for why FMA contraction must stay off).
#include "chain.cuh"
#include "step.cuh"
#include "wave.cuh"

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
  // the learned order's per-row scores: null without the policy
  const float* order_scores;  // [P]
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
  int* queue;     // [cluster, 2P] each block's queue and requeue
  uint8_t* ok_t;  // [C, T] chain commit: claim_it_ok2 of the head (read when not resident)
  uint8_t* cap_t; // [C, T] chain commit: per-type capacity, saturated at 255 (same)
  int* chain_c;   // [cluster, NCS, C] chain commit: each block's per-claim scratch
  int* chain_v;   // [cluster, NVS, V] chain commit: each block's per-lane scratch
  int* wave;      // the wavefront's scratch (wave.cuh); null without it
  // outputs
  int* kind;      // [P]
  int* index;     // [P]
  int* counters;  // [7]: narrow iterations, sweeps, chain commits, chain pods,
                  // wave commits, wave pods, retry lanes
  unsigned long long* work;  // [NWORK]: WORK_* counters
  long long* sections;       // [NSEC]: the leader's clock64 cycles by section (SEC_*)
  int* plan;                 // [3]: the cluster the launch ran on, resident, the slice width
  int* wave_hist;  // [wavefront + 2]: iterations by lanes consumed; null without it
  // dims; ``wavefront``: the extra lanes after each narrow iteration (0: off);
  // the launch's plan (ops/ffd_sweeps.loop_plan): blocks per cluster, the
  // types a block owns, whether its slice of the type tables is resident in
  // its shared memory, and the dynamic shared memory bytes of a block
  int P, K, V, W, C, N, T, TPL, R, O, PT, D, G, F, CH, one_pass, wavefront,
      cluster, tslice, resident, smem;
};

// The lanes mode's launch: one FfdArgs per lane in device memory, one cluster
// per lane, every lane with the launch's plan (the widest lane's shared
// memory). Mirrored by FfdLanesArgs in karpenter_tpu_torch/ops/ffd_sweeps.py.
struct FfdLanesArgs {
  const FfdArgs* lanes;  // [L], device memory
  int L, cluster, smem;
};

namespace {

__device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Hands out 16-byte-aligned arrays of the block's dynamic shared memory, in
// the order ops/ffd_sweeps.loop_plan sizes them.
struct Carver {
  char* base;
  size_t used;
  template <class T>
  __device__ T* take(long n) {
    T* p = reinterpret_cast<T*>(base + used);
    used += align16((size_t)n * sizeof(T));
    return p;
  }
};

// The block's slice of the type tables in shared memory, loaded once: TMA
// bulk copies for the contiguous tables (16-byte aligned, a multiple of 16
// bytes; a table that is not is copied by the threads), the threads for the
// strided rows (the templates' and the claims' survivors).
__device__ void load_slice(const FfdArgs& a, TypeSlice& ts, Carver& cv, uint64_t* bar) {
  const int tid = threadIdx.x;
  const int K = a.K, W = a.W, R = a.R, O = a.O, T = a.T, nt = a.tslice;
  const int t0 = ts.t0, n = ts.t1 - ts.t0;
  int* adm = cv.take<int>((long)nt * K * W);
  int* gt = cv.take<int>((long)nt * K);
  int* lt = cv.take<int>((long)nt * K);
  float* alloc = cv.take<float>((long)nt * R);
  float* cap = cv.take<float>((long)nt * R);
  int* oz = cv.take<int>((long)nt * O);
  int* oc = cv.take<int>((long)nt * O);
  uint8_t* comp = cv.take<uint8_t>((long)nt * K);
  uint8_t* def = cv.take<uint8_t>((long)nt * K);
  uint8_t* neg = cv.take<uint8_t>((long)nt * K);
  uint8_t* ook = cv.take<uint8_t>((long)nt * O);
  uint8_t* tpl = cv.take<uint8_t>((long)a.TPL * nt);
  uint8_t* cio = cv.take<uint8_t>((long)a.C * nt);
  uint8_t* okt = cv.take<uint8_t>((long)a.C * nt);
  uint8_t* capt = cv.take<uint8_t>((long)a.C * nt);
  struct Piece {
    void* dst;
    const void* src;
    uint32_t bytes;
  };
  const Piece pieces[11] = {
      {adm, a.it_adm + (long)t0 * K * W, (uint32_t)(n * K * W * 4)},
      {gt, a.it_gt + (long)t0 * K, (uint32_t)(n * K * 4)},
      {lt, a.it_lt + (long)t0 * K, (uint32_t)(n * K * 4)},
      {alloc, a.it_alloc + (long)t0 * R, (uint32_t)(n * R * 4)},
      {cap, a.it_cap + (long)t0 * R, (uint32_t)(n * R * 4)},
      {oz, a.offer_zone + (long)t0 * O, (uint32_t)(n * O * 4)},
      {oc, a.offer_ct + (long)t0 * O, (uint32_t)(n * O * 4)},
      {comp, a.it_comp + (long)t0 * K, (uint32_t)(n * K)},
      {def, a.it_def + (long)t0 * K, (uint32_t)(n * K)},
      {neg, a.it_neg + (long)t0 * K, (uint32_t)(n * K)},
      {ook, a.offer_ok + (long)t0 * O, (uint32_t)(n * O)},
  };
  auto bulk = [](const Piece& pc) {
    return pc.bytes > 0 && pc.bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(pc.dst) & 15) == 0 &&
           (reinterpret_cast<uintptr_t>(pc.src) & 15) == 0;
  };
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();
  if (tid == 0) {
    uint32_t total = 0;
    for (const Piece& pc : pieces)
      if (bulk(pc)) total += pc.bytes;
    mbar_arrive_expect(bar, total);
    for (const Piece& pc : pieces)
      if (bulk(pc)) bulk_load(pc.dst, pc.src, pc.bytes, bar);
  }
  for (const Piece& pc : pieces)
    if (!bulk(pc))
      for (uint32_t i = tid; i < pc.bytes; i += THREADS)
        static_cast<char*>(pc.dst)[i] = static_cast<const char*>(pc.src)[i];
  for (int i = tid; i < a.TPL * n; i += THREADS) tpl[(i / n) * nt + i % n] = a.tpl_it_ok[(long)(i / n) * T + t0 + i % n];
  for (int i = tid; i < a.C * n; i += THREADS) cio[(i / n) * nt + i % n] = a.claim_it_ok[(long)(i / n) * T + t0 + i % n];
  mbar_wait(bar, 0);
  __syncthreads();
  // every table indexed by the global type
  ts.tstride = nt;
  ts.its.adm = adm - (long)t0 * K * W;
  ts.its.gt = gt - (long)t0 * K;
  ts.its.lt = lt - (long)t0 * K;
  ts.its.alloc = alloc - (long)t0 * R;
  ts.cap = cap - (long)t0 * R;
  ts.its.offer_zone = oz - (long)t0 * O;
  ts.its.offer_ct = oc - (long)t0 * O;
  ts.its.comp = comp - (long)t0 * K;
  ts.its.def = def - (long)t0 * K;
  ts.its.neg = neg - (long)t0 * K;
  ts.its.offer_ok = ook - (long)t0 * O;
  ts.tpl_ok = tpl - t0;
  ts.cio = cio - t0;
  ts.ok_t = okt - t0;
  ts.cap_t = capt - t0;
}

// The loop of one solve on one cluster (the block's part of it). The
// per-block state sits in static shared memory declared here, so each block
// has its own. Inlined into both kernels below.
__device__ __forceinline__ void loop_body(const FfdArgs& a) {
  __shared__ Shared s;
  __shared__ ChainShared cs;
  __shared__ WaveShared ws;
  __shared__ Red red;
  __shared__ uint64_t bar;
  extern __shared__ __align__(16) char dyn[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  ClusterScope sc;
  sc.rank = cluster_rank();
  sc.size = cluster_blocks();
  const bool leader = sc.leader();
  sc.ts.t0 = min(a.T, sc.rank * a.tslice);
  sc.ts.t1 = min(a.T, sc.ts.t0 + a.tslice);
  Carver cv{dyn, 0};
  StepMem m;
  m.gmin = cv.take<int>(a.G);
  m.boot = cv.take<int>(a.G);
  m.nothing = cv.take<int>(a.G);
  m.mg = cv.take<int>(a.G);
  m.mk = cv.take<int>(a.G);
  m.nm = cv.take<int>(1);
  m.maxcap = cv.take<int>(a.R);
  m.any = cv.take<int>(a.C);
  m.best = cv.take<int>(a.C);
  m.fs = cv.take<int>(a.C);
  m.cand = cv.take<int>(a.C);
  m.tok = cv.take<int>(a.TPL);
  m.tfs = cv.take<int>(a.TPL);
  if (a.resident) {
    load_slice(a, sc.ts, cv, &bar);
  } else {
    sc.ts.tstride = a.T;
    sc.ts.its = its_of(a);
    sc.ts.cap = a.it_cap;
    sc.ts.tpl_ok = a.tpl_it_ok;
    sc.ts.cio = a.claim_it_ok;
    sc.ts.ok_t = a.ok_t;
    sc.ts.cap_t = a.cap_t;
  }
  // the planner and the kernel disagree: the carve outgrows the plan's
  // shared memory, the launch runs on another cluster than the one planned
  // for, or the slices miss a type (one check: a second costs spills)
  if (cv.used > (size_t)a.smem || a.cluster != sc.size || (long)a.tslice * sc.size < a.T) __trap();

  // the carried repair pass (ops/ffd_sweeps.py:1938-1941) seeds the rows of
  // phase 1's placements, which are inactive here and never stepped
  if (leader) {
    for (int p = tid; p < a.P; p += THREADS) {
      a.kind[p] = a.kind0 ? a.kind0[p] : KIND_FAIL;
      a.index[p] = a.index0 ? a.index0[p] : -1;
    }
    for (int x = tid; x < a.wavefront + 2 && a.wave_hist; x += THREADS) a.wave_hist[x] = 0;
    if (tid == 0) {
      a.plan[0] = sc.size;
      a.plan[1] = a.resident;
      a.plan[2] = a.tslice;
    }
  }
  if (tid < NWORK) s_work[tid] = 0;
  sec_start();
  if (tid == 0) {
    ws.commits = 0;
    ws.pods = 0;
    ws.retries = 0;
  }
  // every block of the cluster is running before any reaches another's
  // shared memory
  sc.sync();

  if (a.one_pass) {
    for (int p = 0; p < a.P; ++p) {
      if (!a.pod_active[p]) continue;  // padding rows fail without touching state
      step(sc, a, p, s, red, m);
      if (leader && tid == 0) {
        a.kind[p] = s.kind;
        a.index[p] = s.index;
      }
      sc.sync();
      sc.mark(SEC_QUEUE);
    }
  } else {
    // compact initial queue: active rows in FFD order (ffd_sweeps.py:1686-1690),
    // each block its own copy
    int* q = a.queue + (long)sc.rank * 2 * a.P;
    int* nq = q + a.P;
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
        // the chain run at the cursor: consecutive rows, each chain-identical
        if (warp == 0) {
          const int kc = chain_run(q, i, qlen, p, a.pod_eqprev_chain);
          if (lane == 0) cs.kc = kc;
        }
        block_sync();
        narrow_iter(sc, a, p, s, cs, red, m);
        // the commit's state rows and records, before anything reads them
        sc.sync();
        sc.mark(SEC_QUEUE);
        const int k = cs.k, kind = s.kind;
        if (leader)
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
        if (a.wavefront > 0) {
          // further chain heads, after a whole chain that opened no claim
          const bool cont = k == cs.kc && kind != KIND_NEW_CLAIM && kind != KIND_NO_SLOT;
          wave_step(sc, a, q, i, qlen, cont, nq, s, ws, red, m);
          sc.mark(SEC_QUEUE);
          i += ws.consumed;
          if (leader && tid == 0) a.wave_hist[1 + ws.n_lanes] += 1;
          block_sync();
        }
      }
      if (tid == 0) {
        s.progress = s.nqlen < qlen;
        s.qlen = s.nqlen;
        s.sweeps += 1;
      }
      if (a.order_scores) {
        // the next queue, sorted into the spent one
        block_sync();
        const int n = s.qlen;
        for (int i = tid; i < n; i += THREADS) {
          const float si = a.order_scores[nq[i]];
          int r = 0;
          for (int k = 0; k < n; ++k) {
            const float sk = a.order_scores[nq[k]];
            r += (sk > si) || (sk == si && k < i);
          }
          q[r] = nq[i];
        }
      } else {
        int* tmp = q;
        q = nq;
        nq = tmp;
      }
      block_sync();
    }
    if (leader && tid == 0) {
      a.counters[0] = s.stepped;
      a.counters[1] = s.sweeps;
      a.counters[2] = s.chains;
      a.counters[3] = s.chain_pods;
      a.counters[4] = ws.commits;
      a.counters[5] = ws.pods;
      a.counters[6] = ws.retries;
    }
  }
  sc.mark(SEC_QUEUE);
  // the claims' survivors back to their state tensor, each block its slice
  if (a.resident) {
    const int t0 = sc.ts.t0, n = sc.ts.t1 - t0;
    for (int i = tid; i < a.C * n; i += THREADS)
      a.claim_it_ok[(long)(i / n) * a.T + t0 + i % n] = sc.ts.cio[(long)(i / n) * a.tslice + t0 + i % n];
  }
  // the work of every block into the leader's counters (the barrier counts
  // are the leader's own), then the leader writes them out; no block leaves
  // while another may still reach its shared memory
  __syncthreads();  // the section counters (not counted)
  if (!leader && tid <= WORK_TYPE_TESTS) atomicAdd(sc.lead(&s_work[tid]), s_work[tid]);
  cluster_barrier();
  if (leader) {
    if (tid < NWORK) a.work[tid] = s_work[tid];
    if (tid < NSEC) a.sections[tid] = s_sec[tid];
  }
}

__global__ void __launch_bounds__(THREADS, 1) ffd_loop_kernel(FfdArgs a) { loop_body(a); }

// The lanes mode (the JAX package's partitioned sweeps, programs 13 and 14's
// repair): cluster c runs lane c's whole loop from its own argument struct,
// which points at the lane's own problem rows, state, scratch, verdicts,
// counters and work counters (nothing is shared between lanes but the
// launch), and exits when its own loop converges.
__global__ void __launch_bounds__(THREADS, 1) ffd_loop_lanes_kernel(const FfdArgs* lanes) {
  __shared__ FfdArgs a;
  if (threadIdx.x == 0) a = lanes[blockIdx.x / cluster_blocks()];
  __syncthreads();
  loop_body(a);
}

// Measures the cost of one barrier of the loop: ``cluster`` 0, ``n`` counted
// block barriers (block_sync) in one block of the loop's size; ``cluster`` k
// >= 1, ``n`` cluster barriers in one cluster of k such blocks. Nothing else.
// Not part of the solve.
__global__ void __launch_bounds__(THREADS, 1) sync_probe_kernel(int n, int cluster) {
  if (threadIdx.x < NWORK) s_work[threadIdx.x] = 0;
  __syncthreads();
  if (cluster > 0) {
    for (int i = 0; i < n; ++i) cluster_barrier();
  } else {
    for (int i = 0; i < n; ++i) block_sync();
  }
}

}  // namespace

extern "C" int ffd_loop_args_size() { return (int)sizeof(FfdArgs); }

// Launch one cluster on ``stream``; returns 0 or the CUDA error.
extern "C" int ffd_loop_launch(const FfdArgs* args, void* stream) {
  return cluster_launch(ffd_loop_kernel, args->cluster, args->cluster, THREADS, (size_t)args->smem,
                        static_cast<cudaStream_t>(stream), *args);
}

extern "C" int ffd_loop_lanes_args_size() { return (int)sizeof(FfdLanesArgs); }

// The lanes mode: L clusters, one per lane. Clusters that the card cannot
// hold at once wait for a running one to finish (correct, no longer
// concurrent).
extern "C" int ffd_loop_lanes_launch(const FfdLanesArgs* args, void* stream) {
  if (args->L <= 0) return 0;
  return cluster_launch(ffd_loop_lanes_kernel, args->L * args->cluster, args->cluster, THREADS, (size_t)args->smem,
                        static_cast<cudaStream_t>(stream), args->lanes);
}

// ``n`` barriers alone: block barriers in one block (``cluster`` 0) or
// cluster barriers in one cluster of ``cluster`` blocks.
extern "C" int ffd_sync_probe_launch(int n, int cluster, void* stream) {
  return cluster_launch(sync_probe_kernel, max(cluster, 1), max(cluster, 1), THREADS, 0, static_cast<cudaStream_t>(stream),
                        n, cluster);
}
