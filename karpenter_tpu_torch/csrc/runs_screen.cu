// runs_screen: the consolidation screen's run-compressed scan, every
// candidate lane in one launch.
//
// Replaces the JAX package's device programs
//   parallel/mesh.py:321 _residual_screen_jit (residual mode: one pass over
//     the shared run trim from the carried base world)
//   parallel/mesh.py:232 _lean_screen_jit (full mode: up to three passes
//     from each lane's initial state and topology census)
//   parallel/mesh.py:154 _batched_screen_jit and :88 _batched_solve_jit
//     (stacked mode: the full mode's passes, 3 or 1, where every lane is a
//     whole problem of its own, stacked on a leading axis with its own
//     vocabulary, tables, run axis and initial state; ``stacked`` = 1)
//   ops/ffd_runs.py:519 _solve_ffd_runs_jit, the scan both vmap over lanes,
//     with its commits: the per-pod step (RUN_SINGLE, step.cuh), the
//     closed-form run commit _make_run_commit :53 (RUN_ANALYTIC) and the
//     topology run commit ops/topo_runs.make_topo_run_commit :73 (RUN_TOPO).
//
// What bounds it on an H100: each lane is a dependent scan over runs (a
// run's commit reads every earlier commit's state), so a lane's time is the
// latency of its chain of commits; the lanes are independent, and the
// launch lasts as long as its slowest lane. Per commit the work is a bin
// gate per existing node, open claim and template (a chain of dependent L2
// loads each), the claims x instance types and templates x types capacity
// tables (K x W compat words, O offerings, R float divisions each), and a
// few scans over the run's rows and the claims. The shared problem (~1 MB)
// and a lane's state (~40 KB at 256 nodes) are L2-resident.
//
// What the design does about it: the wrapper's planner
// (parallel/mesh.screen_plan) picks a layout per launch from the lanes, the
// card's SMs and the lane's rows, and both layouts run one body, a template
// over the scope of step.cuh:
//   * LAYOUT_CLUSTER (few lanes of many rows: the serve layer's 8 x 1,250):
//     one thread-block cluster of ``cluster`` blocks per lane, its per-pod
//     steps in
//     ClusterScope as ffd_loop's lanes mode runs them (the bins' gates and
//     the topology groups over the cluster's warps, each block a slice of the
//     instance types), and the closed-form commit's gates, type tables,
//     records and row writes over the cluster's warps too. Its scalar
//     decisions (the ordinals, the fill of the nodes, the claims' water
//     level, the fresh claims) run alike in every block on its own copies in
//     shared memory; a block's results that another reads meet at a cluster
//     barrier, written into every block's copy or the leader's through
//     distributed shared memory; the leader block alone writes the state
//     rows of a fresh claim.
//   * LAYOUT_BLOCK (many lanes: the screen's 320; and lanes of few rows,
//     where a cluster barrier's ~0.6 us outweighs the cluster's warps): one
//     512-thread block per lane, one resident on each SM (128 registers a
//     thread fill its register file). A lane's time is its chain of gates,
//     spread over its warps: smaller blocks three to an SM, all 320 lanes in
//     one wave, were 1.5-2.3x slower (PERF.md section 5).
// The blocks (clusters) take the lanes heaviest first (``order``, the
// wrapper's sort by the lane's active rows), so that the lanes that set the
// launch's length start in the first wave, and the light ones fill the SMs
// around them. Each lane walks its runs in
// order with its state in its own slot of device memory. The shared problem
// is read by every lane; the lane's variant arrays are indexed by its lane.
// A block builds its lane's view of the argument struct in shared memory
// (state pointers offset to its slot) and hands it to the per-pod step of
// step.cuh, so RUN_SINGLE and every RUN_TOPO member run the ffd_loop
// kernel's own step. In stacked mode the view also offsets every problem
// table and the start state to the lane's own slot, so nothing is shared but
// the dimensions. The analytic commit keeps the JAX package's closed form:
// integer capacities (a float division and a floor), the claims' water level
// by a 22-step bisection (one warp, each step's sum a warp sum), the
// temporal ordinal -> bin maps (block scans; the claims phase's (level,
// claim) order built once per commit), one template claim opened at a time
// with its limit headroom burned once per open. The state update
// ``requests + take * pod_requests`` rounds once (a float64 multiply-add
// rounded to float32), as the JAX package's CPU compilation contracts it.
// Every layout computes the same commits in the same order, so each equals
// the plain version bit for bit.
//
// Counted work (per lane, ``work``): the step's four counters (bin gates,
// topology lanes, type tests, barriers; the analytic commit adds its own
// gates and type tests to them), runs committed by mode, pods stepped and
// pods committed in closed form; and each lane's leader clock by section
// (``sections``).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.
#include "step.cuh"

// Field order is mirrored by RunsArgs in karpenter_tpu_torch/parallel/mesh.py
// (pointers first, then ints); runs_screen_args_size() lets the wrapper check
// it. The field names the step reads are FfdArgs' (step.cuh).
struct RunsArgs {
  // vocabulary
  const int* lvw;
  const float* ln;
  const int* lex;
  const uint8_t* wellknown;
  // pods (shared)
  const int* pod_adm;
  const uint8_t* pod_comp;
  const uint8_t* pod_def;
  const int* pod_gt;
  const int* pod_lt;
  const uint8_t* pod_neg;
  const int* pod_strict_adm;
  const float* pod_requests;
  const uint8_t* pod_tol_tpl;
  const uint8_t* pod_tol_node;
  const uint8_t* pod_ports;
  const uint8_t* pod_conflict;
  const uint8_t* pod_match;
  const uint8_t* pod_selects;
  const uint8_t* pod_owned;
  const int* pod_vols;
  // instance types
  const int* it_adm;
  const uint8_t* it_comp;
  const uint8_t* it_def;
  const int* it_gt;
  const int* it_lt;
  const uint8_t* it_neg;
  const float* it_alloc;
  const float* it_cap;
  const int* offer_zone;
  const int* offer_ct;
  const uint8_t* offer_ok;
  // templates
  const int* tpl_adm;
  const uint8_t* tpl_comp;
  const uint8_t* tpl_def;
  const int* tpl_gt;
  const int* tpl_lt;
  const uint8_t* tpl_neg;
  const float* tpl_overhead;
  const uint8_t* tpl_it_ok;
  const int* node_vol_limits;
  // topology groups
  const int* grp_type;
  const int* grp_key;
  const int* grp_max_skew;
  const int* grp_min_domains;
  const uint8_t* grp_inverse;
  const uint8_t* grp_has_filter;
  const int* flt_adm;
  const uint8_t* flt_comp;
  const uint8_t* flt_def;
  const int* flt_gt;
  const int* flt_lt;
  const uint8_t* flt_neg;
  const uint8_t* flt_valid;
  const int* host_lane;
  // the run axis every lane walks: [RN]
  const int* run_start;
  const int* run_len;
  const int* run_mode;
  // the state every lane starts from
  const int* init_claim_adm;
  const uint8_t* init_claim_comp;
  const uint8_t* init_claim_def;
  const int* init_claim_gt;
  const int* init_claim_lt;
  const float* init_claim_requests;
  const uint8_t* init_claim_it_ok;
  const uint8_t* init_claim_open;
  const int* init_claim_npods;
  const int* init_claim_tpl;
  const uint8_t* init_claim_ports;
  const int* init_node_adm;
  const uint8_t* init_node_comp;
  const uint8_t* init_node_def;
  const int* init_node_gt;
  const int* init_node_lt;
  const float* init_node_requests;
  const int* init_node_npods;
  const uint8_t* init_node_ports;
  const int* init_node_vol_used;
  const float* init_remaining;
  const int* init_grp_counts;
  const uint8_t* init_grp_registered;
  // per lane: deleted node rows [B, N, R], active rows [B, P + MR] (updated
  // between passes), and in full mode the lane's census [B, G, V] (else null)
  const float* node_avail;
  uint8_t* pod_active;
  const int* lane_grp_counts0;
  const uint8_t* lane_grp_registered0;
  // per lane: the state, [B, ...] of the init_* shapes
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
  float* remaining;
  int* grp_counts;
  uint8_t* grp_registered;
  // per lane scratch: merged rows per bin (nodes, claims, templates), a flag
  // per bin, the claims' and templates' type survivors and capacities
  // [C + TPL, T], the nodes' capacities and takes of a topology run
  int* fin_adm;
  uint8_t* fin_comp;
  uint8_t* fin_def;
  int* fin_gt;
  int* fin_lt;
  uint8_t* fin_neg;
  uint8_t* bin_ok;
  uint8_t* ok_t;
  int* cap_t;
  int* node_cap;
  int* node_taken;
  // per lane outputs
  int* kind;                 // [B, P]
  int* index;                // [B, P]
  unsigned long long* work;  // [B, NWORK_RS]
  long long* sections;       // [B, NRSEC]: each lane's clock64 cycles by section (RS_SEC_*)
  const int* order;          // [B] the lane each cluster (block) runs, the heaviest first; null: in order
  int* plan;                 // [3]: the layout, the blocks per lane and the threads per block it ran with
  // dims
  // stacked: 1 when every lane is a whole problem of its own (the batched
  // programs): the problem tables above and the init_* state then carry a
  // leading lane axis too, and the lane census pointers are null
  // layout: LAYOUT_* of the launch's plan (parallel/mesh.screen_plan), and
  // its blocks per lane (a cluster in LAYOUT_CLUSTER, else 1)
  int P, K, V, W, C, N, T, TPL, R, O, PT, D, G, F, CH, B, RN, MR, passes, stacked, layout, cluster;
};

namespace {

constexpr int RUN_SINGLE = 0;
constexpr int RUN_ANALYTIC = 1;

// the launch's layouts (parallel/mesh.py SCREEN_LAYOUTS)
constexpr int LAYOUT_BLOCK = 0;
constexpr int LAYOUT_CLUSTER = 1;

// per-lane counters after the step's NWORK
constexpr int RW_RUNS_SINGLE = 0;
constexpr int RW_RUNS_ANALYTIC = 1;
constexpr int RW_RUNS_TOPO = 2;
constexpr int RW_PODS_STEPPED = 3;
constexpr int RW_PODS_ANALYTIC = 4;
constexpr int NRWORK = 5;
constexpr int NWORK_RS = NWORK + NRWORK;

__shared__ unsigned long long s_rwork[NRWORK];

// section counters (RunsArgs::sections): a lane's clock64 cycles by
// section, read by thread 0 of each block right after the barrier that ends
// one (the lane's leader block's are written out). rs_to(x) closes the
// section in progress and opens x.
constexpr int RS_SEC_INIT = 0;       // the lane's start state
constexpr int RS_SEC_SINGLE = 1;     // RUN_SINGLE: the per-pod step
constexpr int RS_SEC_A_NODES = 2;    // RUN_ANALYTIC: ordinals, the nodes' gates and capacities
constexpr int RS_SEC_A_CLAIMS = 3;   // node takes, claims' gates and types, the water level, claim takes
constexpr int RS_SEC_A_TPL = 4;      // fresh template claims
constexpr int RS_SEC_A_ROWS = 5;     // each member's (kind, index)
constexpr int RS_SEC_A_RECORD = 6;   // records, verdict rows
constexpr int RS_SEC_TOPO = 7;       // RUN_TOPO
constexpr int RS_SEC_PASS = 8;       // a pass's active set
constexpr int NRSEC = 9;

__shared__ long long s_rsec[NRSEC + 2];

__device__ __forceinline__ void rs_to(int next) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    s_rsec[s_rsec[NRSEC + 1]] += now - s_rsec[NRSEC];
    s_rsec[NRSEC] = now;
    s_rsec[NRSEC + 1] = next;
  }
}

// the analytic commit's scalars (every block its own copy)
struct RunShared {
  int k, port_cap, placed_n, rem, m, rem2, placed_new, noslot;
  int c_rem, keep, free_slot, pick, take, host;
};

// dynamic shared memory, carved per launch (every block its own)
struct Dyn {
  int* gmin;  // [G] the step's group scratch
  int* boot;
  int* nothing;
  int* maxcap;  // [R]
  int* act;     // [MR] window rows: active member
  int* ord;     // [MR] temporal ordinal
  int* krow;    // [MR] this commit's kind per row
  int* irow;    // [MR] this commit's index per row
  int* seq;     // [MR] the claims phase's claim by ordinal
  int* ncap;    // [N]
  int* ncum;    // [N]
  int* capc;    // [C]
  int* take;    // [C]
  int* plvl;    // [C] claim levels before the commit
  int* newtake;  // [C]
  int* newcum;   // [C]
  int* cumtake;  // [C] exclusive prefix of take
  int* tcompat;  // [TPL]
  int* qt;       // [TPL]
  int* wsum;     // [32] a block scan's warp totals
  StepMem sm;    // the step's arrays: gmin, boot, nothing, maxcap and its own
  Red* red;      // the step's reduction targets
};

// instance type t against a merged bin row: compatible and offered (the
// analytic commit's type table reads fit through its capacity instead)
__device__ __forceinline__ bool it_compat_offer(const Row& bin, const uint8_t* bin_neg, const ITs& its, int t,
                                                int K, int W, int O) {
  const Row it = row_at(its.adm, its.comp, its.def, its.gt, its.lt, t, K, W);
  if (!intersects_ok(bin, bin_neg, it, its.neg + (long)t * K, K, W)) return false;
  return has_offering(bin.adm, W, its.offer_zone + (long)t * O, its.offer_ct + (long)t * O,
                      its.offer_ok + (long)t * O, O);
}

// one warp copies merged row ``b`` of the scratch into entity row ``e``
__device__ void warp_copy_row(const RunsArgs& a, int b, int* adm, uint8_t* comp, uint8_t* def, int* gt, int* lt,
                              int e) {
  const int lane = threadIdx.x & 31, K = a.K, W = a.W;
  for (int i = lane; i < K * W; i += 32) adm[(long)e * K * W + i] = a.fin_adm[(long)b * K * W + i];
  for (int k = lane; k < K; k += 32) {
    comp[(long)e * K + k] = a.fin_comp[(long)b * K + k];
    def[(long)e * K + k] = a.fin_def[(long)b * K + k];
    gt[(long)e * K + k] = a.fin_gt[(long)b * K + k];
    lt[(long)e * K + k] = a.fin_lt[(long)b * K + k];
  }
}

// number of entries of the nondecreasing x[0..n) that are <= v
__device__ __forceinline__ int upper_bound(const int* x, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (x[mid] <= v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int warp_incl_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The prefix sums of x[0..n) into out (inclusive with ``incl``, else
// exclusive) by the whole block, a contiguous chunk per thread; returns the
// total. Integers: exact in any order. Called by every thread of the block.
__device__ int block_scan(const int* x, int* out, int n, bool incl, int* wsum) {
  constexpr int NT = THREADS, NW = NWARPS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (n + NT - 1) / NT;
  const int lo = min(n, tid * chunk), hi = min(n, lo + chunk);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += x[i];
  const int in = warp_incl_scan(sum);
  if (lane == 31) wsum[warp] = in;
  block_sync();
  if (warp == 0) {
    const int v = warp_incl_scan(lane < NW ? wsum[lane] : 0);
    if (lane < NW) wsum[lane] = v;
  }
  block_sync();
  int run = in - sum + (warp > 0 ? wsum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int xi = x[i];
    out[i] = incl ? run + xi : run;
    run += xi;
  }
  const int total = wsum[NW - 1];
  block_sync();
  return total;
}

// The same in one warp (the caller's): small axes (the claims).
__device__ int warp_scan(const int* x, int* out, int n, bool incl) {
  const int lane = threadIdx.x & 31;
  int run = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int v = i < n ? x[i] : 0;
    const int in = warp_incl_scan(v);
    if (i < n) out[i] = run + (incl ? in : in - v);
    run += __shfl_sync(FULL, in, 31);
  }
  return run;
}

__device__ __forceinline__ int warp_reduce_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// a value into every block's copy of a shared array (one thread)
template <class S>
__device__ __forceinline__ void to_all(const S& sc, int* arr, int i, int v) {
  for (int r = 0; r < sc.size; ++r) sc.at(arr, r)[i] = v;
}

// the window rows this commit covers take its verdicts, except rows a
// previous pass already placed (kind/index keep the first placement); the
// rows over the scope's threads
template <class S>
__device__ void write_rows(const S& sc, const RunsArgs& a, const Dyn& d, int start, int len) {
  for (int i = sc.gthread(); i < len; i += sc.nthreads()) {
    const int row = start + i;
    if (a.kind[row] >= KIND_FAIL) {
      a.kind[row] = d.krow[i];
      a.index[row] = d.irow[i];
    }
  }
}

// RUN_ANALYTIC (ops/ffd_runs.make_run_commit): the whole run in closed form
template <class S>
__device__ void analytic_commit(const S& sc, const RunsArgs& a, int p, int start, int len, RunShared& rs,
                                const Dyn& d) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gw = sc.gwarp(), nw = sc.nwarps();
  const int K = a.K, W = a.W, N = a.N, C = a.C, T = a.T, TPL = a.TPL, R = a.R, MR = a.MR;
  const ITs its = its_of(a);
  const float* preq = a.pod_requests + (long)p * R;
  const uint8_t* pconf = a.pod_conflict + (long)p * a.PT;
  for (int i = tid; i < MR; i += THREADS) {
    d.act[i] = i < len && a.pod_active[start + i];
    d.krow[i] = KIND_FAIL;
    d.irow[i] = -1;
  }
  block_sync();
  // the active members' temporal ordinals
  const int k = block_scan(d.act, d.ord, MR, true, d.wsum);
  for (int i = tid; i < MR; i += THREADS) d.ord[i] -= 1;
  if (tid == 0) {
    rs.k = k;
    bool ports = false;
    for (int q = 0; q < a.PT; ++q) ports |= a.pod_ports[(long)p * a.PT + q] != 0;
    rs.port_cap = ports ? 1 : BIG_CAP;
    rs.placed_n = 0;
    rs.placed_new = 0;
    rs.noslot = 0;
    if (sc.leader()) {
      s_rwork[RW_RUNS_ANALYTIC] += 1;
      s_rwork[RW_PODS_ANALYTIC] += k;
    }
  }
  block_sync();
  if (k == 0) {  // no active member: nothing to commit
    write_rows(sc, a, d, start, len);
    sc.sync();
    return;
  }

  // -- 1. existing nodes: first-fit fill in node order
  if (N > 0) {
    for (int n = gw; n < N; n += nw) {
      const Row base = row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, n, K, W);
      const bool ok = bin_gate(a, p, base, nullptr, n, nullptr, -1, -1, d.gmin, d.boot, d.nothing);
      if (lane == 0) {
        int cap = 0;
        bool port_ok = true;
        for (int q = 0; q < a.PT; ++q)
          if (a.node_ports[(long)n * a.PT + q] && pconf[q]) port_ok = false;
        if (ok && port_ok && a.pod_tol_node[(long)p * N + n]) {
          int vol = BIG_CAP;
          for (int dd = 0; dd < a.D; ++dd) {
            const int pv = a.pod_vols[(long)p * a.D + dd];
            if (pv <= 0) continue;
            // an over-limit attach count reads as 0 capacity, not negative
            const int room = a.node_vol_limits[(long)n * a.D + dd] - a.node_vol_used[(long)n * a.D + dd];
            vol = min(vol, room > 0 ? room / pv : 0);
          }
          const int rc = capacity(a.node_avail + (long)n * R, a.node_requests + (long)n * R, preq, R);
          cap = min(min(rc, vol), rs.port_cap);
        }
        to_all(sc, d.ncap, n, cap);
      }
    }
    sc.sync();
    const int cum = block_scan(d.ncap, d.ncum, N, true, d.wsum);
    if (tid == 0) rs.placed_n = min(k, cum);
    block_sync();
    rs_to(RS_SEC_A_CLAIMS);
    for (int n = gw; n < N; n += nw) {
      const int take = min(max(k - (d.ncum[n] - d.ncap[n]), 0), d.ncap[n]);
      for (int r = lane; r < R; r += 32)
        a.node_requests[(long)n * R + r] = add_times(a.node_requests[(long)n * R + r], take, preq[r]);
      if (take > 0) {
        warp_copy_row(a, n, a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, n);
        for (int q = lane; q < a.PT; q += 32) a.node_ports[(long)n * a.PT + q] |= a.pod_ports[(long)p * a.PT + q];
        for (int dd = lane; dd < a.D; dd += 32)
          a.node_vol_used[(long)n * a.D + dd] += take * a.pod_vols[(long)p * a.D + dd];
        if (lane == 0) a.node_npods[n] += take;
      }
      if (lane == 0) a.bin_ok[n] = take > 0;
    }
  }
  if (tid == 0) rs.rem = k - rs.placed_n;

  // -- 2. open claims: fewest-pods waterfill bounded by each claim's capacity
  for (int c = gw; c < C; c += nw) {
    if (!a.claim_open[c]) {
      if (lane == 0) {
        to_all(sc, d.capc, c, 0);
        to_all(sc, d.plvl, c, a.claim_npods[c]);
      }
      continue;
    }
    const Row base = row_at(a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, c, K, W);
    bool ok = bin_gate(a, p, base, nullptr, N + c, a.wellknown, -1, -1, d.gmin, d.boot, d.nothing);
    ok = ok && a.pod_tol_tpl[(long)p * TPL + a.claim_tpl[c]];
    for (int q = 0; q < a.PT && ok; ++q)
      if (a.claim_ports[(long)c * a.PT + q] && pconf[q]) ok = false;
    const Row fin = fin_row(a, N + c);
    const uint8_t* fneg = a.fin_neg + (long)(N + c) * K;
    int best = 0;
    for (int t = lane; t < T; t += 32) {
      const bool itok = a.claim_it_ok[(long)c * T + t] && it_compat_offer(fin, fneg, its, t, K, W, a.O);
      const int cap = capacity(a.it_alloc + (long)t * R, a.claim_requests + (long)c * R, preq, R);
      a.ok_t[(long)c * T + t] = itok;
      a.cap_t[(long)c * T + t] = cap;
      if (itok) best = max(best, cap);
    }
    best = warp_max(best);
    if (lane == 0) {
      count_work(WORK_TYPE_TESTS, T);
      to_all(sc, d.capc, c, ok ? min(best, rs.port_cap) : 0);
      to_all(sc, d.plvl, c, a.claim_npods[c]);
    }
  }
  sc.sync();
  if (warp == 0) {
    // the claims' water level, their takes, and the leftover's +1 in claim
    // order (one warp, every block on its own copies)
    int sum = 0;
    for (int c = lane; c < C; c += 32) sum += d.capc[c];
    sum = warp_reduce_sum(sum);
    const int m = min(rs.rem, sum);
    const int L = warp_water_level(d.plvl, d.capc, C, m);
    int taken = 0;
    for (int c = lane; c < C; c += 32) {
      d.take[c] = min(max(L - d.plvl[c], 0), d.capc[c]);
      taken += d.take[c];
    }
    taken = warp_reduce_sum(taken);
    const int leftover = m - taken;
    int run = 0;
    for (int base = 0; base < C; base += 32) {
      const int c = base + lane;
      const bool at = c < C && d.plvl[c] + d.take[c] == L && d.take[c] < d.capc[c];
      const int in = warp_incl_scan(at);
      if (at && run + in <= leftover) d.take[c] += 1;
      run += __shfl_sync(FULL, in, 31);
    }
    __syncwarp();
    warp_scan(d.take, d.cumtake, C, false);
    if (lane == 0) {
      rs.m = m;
      rs.rem2 = rs.rem - m;
    }
  }
  for (int c = tid; c < C; c += THREADS) d.newtake[c] = 0;
  block_sync();
  for (int c = gw; c < C; c += nw) {
    const int take = d.take[c];
    for (int r = lane; r < R; r += 32)
      a.claim_requests[(long)c * R + r] = add_times(a.claim_requests[(long)c * R + r], take, preq[r]);
    if (take > 0) {
      warp_copy_row(a, N + c, a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, c);
      for (int t = lane; t < T; t += 32)
        a.claim_it_ok[(long)c * T + t] = a.ok_t[(long)c * T + t] && a.cap_t[(long)c * T + t] >= take;
      for (int q = lane; q < a.PT; q += 32) a.claim_ports[(long)c * a.PT + q] |= a.pod_ports[(long)p * a.PT + q];
      if (lane == 0) a.claim_npods[c] += take;
    }
    if (lane == 0) a.bin_ok[N + c] = take > 0;
  }
  rs_to(RS_SEC_A_TPL);

  // -- 3. fresh template claims, one open at a time; the template-side
  // merges, compat and capacities depend only on the pod
  if (rs.rem2 > 0) {
    for (int j = gw; j < TPL; j += nw) {
      const int b = N + C + j;
      const Row base = row_at(a.tpl_adm, a.tpl_comp, a.tpl_def, a.tpl_gt, a.tpl_lt, j, K, W);
      const bool ok = bin_gate(a, p, base, a.tpl_neg + (long)j * K, b, a.wellknown, -1, -1, d.gmin, d.boot,
                               d.nothing);
      const Row fin = fin_row(a, b);
      const uint8_t* fneg = a.fin_neg + (long)b * K;
      for (int t = lane; t < T; t += 32) {
        const int cap = capacity(a.it_alloc + (long)t * R, a.tpl_overhead + (long)j * R, preq, R);
        a.ok_t[(long)(C + j) * T + t] =
            a.tpl_it_ok[(long)j * T + t] && cap >= 1 && it_compat_offer(fin, fneg, its, t, K, W, a.O);
        a.cap_t[(long)(C + j) * T + t] = cap;
      }
      if (lane == 0) {
        count_work(WORK_TYPE_TESTS, T);
        to_all(sc, d.tcompat, j, ok);
      }
    }
    if (tid == 0) {
      rs.c_rem = rs.rem2;
      rs.keep = 1;
    }
    // the claims' rows, survivors and counts of stage 2 before the slot
    // search below reads the claims
    sc.sync();
    while (rs.keep && rs.c_rem > 0) {
      for (int j = gw; j < TPL; j += nw) {
        int q = 0;
        for (int t = lane; t < T; t += 32)
          if (a.ok_t[(long)(C + j) * T + t] && within_limits(a, j, t)) q = max(q, a.cap_t[(long)(C + j) * T + t]);
        q = warp_max(q);
        if (lane == 0) {
          count_work(WORK_TYPE_TESTS, T);
          to_all(sc, d.qt, j, q);
        }
      }
      for (int r = tid; r < R; r += THREADS) d.maxcap[r] = 0;  // bits of 0.0f
      sc.sync();
      if (tid == 0) {
        int slot = C;
        for (int c = 0; c < C; ++c)
          if (!a.claim_open[c]) {
            slot = c;
            break;
          }
        int pick = TPL;
        for (int j = 0; j < TPL; ++j)
          if (a.pod_tol_tpl[(long)p * TPL + j] && d.tcompat[j] && d.qt[j] >= 1) {
            pick = j;
            break;
          }
        const bool can = pick < TPL && slot < C;
        rs.free_slot = slot;
        rs.pick = pick;
        rs.take = can ? min(rs.c_rem, min(d.qt[pick], rs.port_cap)) : 0;
        rs.keep = can;
        rs.noslot |= slot >= C;
        rs.host = a.CH > 0 ? a.host_lane[min(slot, a.CH - 1)] : -1;
      }
      block_sync();
      if (rs.take > 0) {
        const int slot = rs.free_slot, j = rs.pick, take = rs.take, host = rs.host;
        // the committed claim row: the merged template row, with the slot's
        // minted hostname pinned (the leader's first warp)
        if (sc.leader() && warp == 0) {
          warp_copy_row(a, N + C + j, a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, slot);
          __syncwarp();
          if (host >= 0) {
            for (int w = lane; w < W; w += 32)
              a.claim_adm[((long)slot * K + HOSTNAME_KEY) * W + w] &=
                  (w == (host >> 5)) ? (int)(1u << (host & 31)) : 0;
            if (lane == 0) {
              a.claim_comp[(long)slot * K + HOSTNAME_KEY] = 0;
              a.claim_def[(long)slot * K + HOSTNAME_KEY] = 1;
            }
          }
        }
        // survivors with the first pod aboard, read before the headroom
        // burns; the largest capacity into the leader's copy
        int* maxcap0 = sc.lead(d.maxcap);
        for (int t = sc.gthread(); t < T; t += sc.nthreads()) {
          const bool surv = a.ok_t[(long)(C + j) * T + t] && within_limits(a, j, t);
          a.claim_it_ok[(long)slot * T + t] = surv && a.cap_t[(long)(C + j) * T + t] >= take;
          if (surv)  // caps are >= 0, so their float bits order as ints
            for (int r = 0; r < R; ++r) atomicMax(&maxcap0[r], __float_as_int(a.it_cap[(long)t * R + r]));
        }
        if (sc.leader()) {
          for (int r = tid; r < R; r += THREADS)
            a.claim_requests[(long)slot * R + r] = add_times(a.tpl_overhead[(long)j * R + r], take, preq[r]);
          for (int q = tid; q < a.PT; q += THREADS)
            a.claim_ports[(long)slot * a.PT + q] |= a.pod_ports[(long)p * a.PT + q];
        }
        sc.sync();
        // opening a claim burns pessimistic headroom (subtractMax) and
        // registers its hostname lane for hostname topologies
        if (sc.leader()) {
          for (int r = tid; r < R; r += THREADS)
            a.remaining[(long)j * R + r] = a.remaining[(long)j * R + r] - __int_as_float(d.maxcap[r]);
          if (host >= 0)
            for (int g = tid; g < a.G; g += THREADS)
              if (a.grp_key[g] == HOSTNAME_KEY) a.grp_registered[(long)g * a.V + host] = 1;
          if (tid == 0) {
            a.claim_open[slot] = 1;
            a.claim_npods[slot] += take;
            a.claim_tpl[slot] = j;
            a.bin_ok[N + slot] = 1;
          }
        }
        if (tid == 0) {
          d.newtake[slot] += take;
          rs.c_rem -= take;
          rs.placed_new += take;
        }
        sc.sync();
      }
    }
  }
  if (warp == 0) warp_scan(d.newtake, d.newcum, C, true);
  block_sync();
  rs_to(RS_SEC_A_ROWS);

  // -- 4. each member's (kind, index), in temporal order (every block all
  // rows, into its own copy); the claims phase's j-th assignment, in the
  // order (level before, claim index), built once: assignment (c, level L)
  // sits after every assignment at a lower level and every claim before c
  // at L
  const int placed_n = rs.placed_n, m = rs.m, placed_new = rs.placed_new;
  for (int q = tid; q < m; q += THREADS) {
    const int c = upper_bound(d.cumtake, C, q) - 1;
    const int L = d.plvl[c] + (q - d.cumtake[c]);
    int pos = 0;
    for (int c2 = 0; c2 < C; ++c2) {
      pos += min(max(L - d.plvl[c2], 0), d.take[c2]);
      pos += c2 < c && d.plvl[c2] <= L && L < d.plvl[c2] + d.take[c2];
    }
    d.seq[pos] = c;
  }
  block_sync();
  for (int i = tid; i < len; i += THREADS) {
    if (!d.act[i]) continue;
    const int o = d.ord[i];
    int kind, index;
    if (o < placed_n) {
      kind = KIND_NODE;
      index = upper_bound(d.ncum, N, o);
    } else if (o < placed_n + m) {
      kind = KIND_CLAIM;
      index = d.seq[o - placed_n];
    } else if (o < placed_n + m + placed_new) {
      const int nc = o - placed_n - m;
      index = upper_bound(d.newcum, C, nc);
      const int ci = min(index, C - 1);
      // the pod that opens a slot reads NEW_CLAIM, later joiners CLAIM
      kind = nc == d.newcum[ci] - d.newtake[ci] ? KIND_NEW_CLAIM : KIND_CLAIM;
    } else {
      kind = rs.noslot ? KIND_NO_SLOT : KIND_FAIL;
      index = -1;
    }
    d.krow[i] = kind;
    d.irow[i] = index;
  }
  // the bins' final rows (every block's takes and fresh claims) before the
  // records read them
  sc.sync();
  rs_to(RS_SEC_A_RECORD);

  // -- 5. Topology.Record of every placed member against its bin's final
  // row; members are topology-blind, so their records simply sum
  if (a.G > 0) {
    // polarity of the final rows of the bins that took members
    for (int x = sc.gthread(); x < (N + C) * K; x += sc.nthreads()) {
      const int b = x / K, kk = x % K;
      if (!a.bin_ok[b]) continue;
      const Row row = b < N ? row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, b, K, W)
                            : row_at(a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, b - N, K, W);
      a.fin_neg[(long)b * K + kk] = negative_polarity_key(row.adm + kk * W, row.comp[kk], row.gt[kk], row.lt[kk],
                                                          a.lvw + kk * W, a.ln + (long)kk * a.V, W);
    }
    sc.sync();
    const TopoGroups tg = topo_of(a);
    for (int g = gw; g < a.G; g += nw) {
      const int kg = a.grp_key[g];
      for (int i = 0; i < len; ++i) {
        if (d.krow[i] >= KIND_FAIL || !a.pod_selects[(long)(start + i) * a.G + g]) continue;
        const int b = d.krow[i] == KIND_NODE ? d.irow[i] : N + d.irow[i];
        const Row row = b < N ? row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, b, K, W)
                              : row_at(a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, b - N, K, W);
        if (!records_group(tg, g, row, a.fin_neg + (long)b * K, true, false, b < N ? nullptr : a.wellknown, K, W))
          continue;
        if (lane == 0) count_work(WORK_TOPO_LANES, a.V);
        for (int v = lane; v < a.V; v += 32)
          if (bit_of(row.adm + kg * W, v)) {
            a.grp_counts[(long)g * a.V + v] += 1;
            a.grp_registered[(long)g * a.V + v] = 1;
          }
      }
    }
  }
  write_rows(sc, a, d, start, len);
  sc.sync();
}

// RUN_TOPO (ops/topo_runs.make_topo_run_commit): each active member through
// the step, nodes gated by their capacity at the run's start
template <class S>
__device__ void topo_commit(const S& sc, const RunsArgs& a, int p, int start, int len, Shared& s, const Dyn& d) {
  const int tid = threadIdx.x, N = a.N, R = a.R;
  const float* preq = a.pod_requests + (long)p * R;
  for (int i = tid; i < a.MR; i += THREADS) {
    d.krow[i] = KIND_FAIL;
    d.irow[i] = -1;
  }
  for (int n = sc.gthread(); n < N; n += sc.nthreads()) {
    a.node_cap[n] = capacity(a.node_avail + (long)n * R, a.node_requests + (long)n * R, preq, R);
    a.node_taken[n] = 0;
  }
  if (sc.leader() && tid == 0) s_rwork[RW_RUNS_TOPO] += 1;
  sc.sync();
  TopoRun tr{0, a.node_cap, a.node_taken};
  for (int i = 0; i < min(len, a.MR); ++i) {
    if (!a.pod_active[start + i]) continue;
    tr.psel = start + i;
    step(sc, a, p, s, *d.red, d.sm, &tr);
    if (tid == 0) {
      d.krow[i] = s.kind;
      d.irow[i] = s.index;
      if (sc.leader()) s_rwork[RW_PODS_STEPPED] += 1;
    }
    sc.sync();
  }
  // the members' node requests, counts and ports, in bulk
  for (int x = sc.gthread(); x < N * R; x += sc.nthreads()) {
    const int n = x / R, r = x % R;
    a.node_requests[x] = add_times(a.node_requests[x], a.node_taken[n], preq[r]);
  }
  for (int n = sc.gthread(); n < N; n += sc.nthreads()) {
    const int taken = a.node_taken[n];
    a.node_npods[n] += taken;
    if (taken > 0)
      for (int q = 0; q < a.PT; ++q) a.node_ports[(long)n * a.PT + q] |= a.pod_ports[(long)p * a.PT + q];
  }
  block_sync();
  write_rows(sc, a, d, start, len);
  sc.sync();
}

// ``n`` elements from src to dst over the scope's threads, 16 bytes a
// thread where both are aligned
template <class S, class T>
__device__ __forceinline__ void copy_n(const S& sc, T* dst, const T* src, long n) {
  const long bytes = n * (long)sizeof(T);
  char* db = reinterpret_cast<char*>(dst);
  const char* sb = reinterpret_cast<const char*>(src);
  long i = sc.gthread(), head = 0;
  if (((reinterpret_cast<uintptr_t>(db) | reinterpret_cast<uintptr_t>(sb)) & 15) == 0) {
    head = bytes / 16 * 16;
#pragma unroll 4
    for (long x = i; x < bytes / 16; x += sc.nthreads())
      reinterpret_cast<int4*>(db)[x] = reinterpret_cast<const int4*>(sb)[x];
  }
  for (long x = head + i; x < bytes; x += sc.nthreads()) db[x] = sb[x];
}

// the argument struct as lane ``b`` sees it: per-lane pointers at its slot
__device__ void lane_view(const RunsArgs& g, RunsArgs& a, int b) {
  a = g;
  const long K = g.K, W = g.W, C = g.C, N = g.N, T = g.T, TPL = g.TPL, R = g.R, PT = g.PT, D = g.D;
  const long G = g.G, V = g.V, P = g.P, bins = N + C + TPL, N1 = N > 0 ? N : 1;
  a.node_avail += b * N * R;
  a.pod_active += b * (P + g.MR);
  if (g.lane_grp_counts0) {
    a.lane_grp_counts0 += b * G * V;
    a.lane_grp_registered0 += b * G * V;
  }
  a.claim_adm += b * C * K * W;
  a.claim_comp += b * C * K;
  a.claim_def += b * C * K;
  a.claim_gt += b * C * K;
  a.claim_lt += b * C * K;
  a.claim_requests += b * C * R;
  a.claim_it_ok += b * C * T;
  a.claim_open += b * C;
  a.claim_npods += b * C;
  a.claim_tpl += b * C;
  a.claim_ports += b * C * PT;
  a.node_adm += b * N * K * W;
  a.node_comp += b * N * K;
  a.node_def += b * N * K;
  a.node_gt += b * N * K;
  a.node_lt += b * N * K;
  a.node_requests += b * N * R;
  a.node_npods += b * N;
  a.node_ports += b * N * PT;
  a.node_vol_used += b * N * D;
  a.remaining += b * TPL * R;
  a.grp_counts += b * G * V;
  a.grp_registered += b * G * V;
  a.fin_adm += b * bins * K * W;
  a.fin_comp += b * bins * K;
  a.fin_def += b * bins * K;
  a.fin_gt += b * bins * K;
  a.fin_lt += b * bins * K;
  a.fin_neg += b * bins * K;
  a.bin_ok += b * bins;
  a.ok_t += b * (C + TPL) * T;
  a.cap_t += b * (C + TPL) * T;
  a.node_cap += b * N1;
  a.node_taken += b * N1;
  a.kind += b * P;
  a.index += b * P;
  a.work += b * NWORK_RS;
  a.sections += b * NRSEC;
  if (!g.stacked) return;
  // stacked mode: lane b's own problem tables and start state, each leaf
  // advanced by b x its per-lane element count (mirrored by lane_elems in
  // mesh.py, which the wrapper checks against the tensors it stacked)
  const long O = g.O, F = g.F, CH = g.CH, RN = g.RN, KW = K * W;
#define RS_LANE(field, n) a.field += b * (n)
  RS_LANE(lvw, KW);
  RS_LANE(ln, K * V);
  RS_LANE(lex, K * V);
  RS_LANE(wellknown, K);
  RS_LANE(pod_adm, P * KW);
  RS_LANE(pod_comp, P * K);
  RS_LANE(pod_def, P * K);
  RS_LANE(pod_gt, P * K);
  RS_LANE(pod_lt, P * K);
  RS_LANE(pod_neg, P * K);
  RS_LANE(pod_strict_adm, P * KW);
  RS_LANE(pod_requests, P * R);
  RS_LANE(pod_tol_tpl, P * TPL);
  RS_LANE(pod_tol_node, P * N);
  RS_LANE(pod_ports, P * PT);
  RS_LANE(pod_conflict, P * PT);
  RS_LANE(pod_match, P * G);
  RS_LANE(pod_selects, P * G);
  RS_LANE(pod_owned, P * G);
  RS_LANE(pod_vols, P * D);
  RS_LANE(it_adm, T * KW);
  RS_LANE(it_comp, T * K);
  RS_LANE(it_def, T * K);
  RS_LANE(it_gt, T * K);
  RS_LANE(it_lt, T * K);
  RS_LANE(it_neg, T * K);
  RS_LANE(it_alloc, T * R);
  RS_LANE(it_cap, T * R);
  RS_LANE(offer_zone, T * O);
  RS_LANE(offer_ct, T * O);
  RS_LANE(offer_ok, T * O);
  RS_LANE(tpl_adm, TPL * KW);
  RS_LANE(tpl_comp, TPL * K);
  RS_LANE(tpl_def, TPL * K);
  RS_LANE(tpl_gt, TPL * K);
  RS_LANE(tpl_lt, TPL * K);
  RS_LANE(tpl_neg, TPL * K);
  RS_LANE(tpl_overhead, TPL * R);
  RS_LANE(tpl_it_ok, TPL * T);
  RS_LANE(node_vol_limits, N * D);
  RS_LANE(grp_type, G);
  RS_LANE(grp_key, G);
  RS_LANE(grp_max_skew, G);
  RS_LANE(grp_min_domains, G);
  RS_LANE(grp_inverse, G);
  RS_LANE(grp_has_filter, G);
  RS_LANE(flt_adm, G * F * KW);
  RS_LANE(flt_comp, G * F * K);
  RS_LANE(flt_def, G * F * K);
  RS_LANE(flt_gt, G * F * K);
  RS_LANE(flt_lt, G * F * K);
  RS_LANE(flt_neg, G * F * K);
  RS_LANE(flt_valid, G * F);
  RS_LANE(host_lane, CH);
  RS_LANE(run_start, RN);
  RS_LANE(run_len, RN);
  RS_LANE(run_mode, RN);
  RS_LANE(init_claim_adm, C * KW);
  RS_LANE(init_claim_comp, C * K);
  RS_LANE(init_claim_def, C * K);
  RS_LANE(init_claim_gt, C * K);
  RS_LANE(init_claim_lt, C * K);
  RS_LANE(init_claim_requests, C * R);
  RS_LANE(init_claim_it_ok, C * T);
  RS_LANE(init_claim_open, C);
  RS_LANE(init_claim_npods, C);
  RS_LANE(init_claim_tpl, C);
  RS_LANE(init_claim_ports, C * PT);
  RS_LANE(init_node_adm, N * KW);
  RS_LANE(init_node_comp, N * K);
  RS_LANE(init_node_def, N * K);
  RS_LANE(init_node_gt, N * K);
  RS_LANE(init_node_lt, N * K);
  RS_LANE(init_node_requests, N * R);
  RS_LANE(init_node_npods, N);
  RS_LANE(init_node_ports, N * PT);
  RS_LANE(init_node_vol_used, N * D);
  RS_LANE(init_remaining, TPL * R);
  RS_LANE(init_grp_counts, G * V);
  RS_LANE(init_grp_registered, G * V);
#undef RS_LANE
}

// One lane (the cluster's or block's ``lane``) walks its runs, every pass.
template <class S>
__device__ __forceinline__ void lane_body(const RunsArgs& args, S sc) {
  __shared__ RunsArgs a;
  __shared__ Shared s;
  __shared__ RunShared rs;
  __shared__ Red red;
  extern __shared__ int dyn[];
  const int tid = threadIdx.x;
  const int slot = (int)blockIdx.x / sc.size;
  const int lane_id = args.order ? args.order[slot] : slot;
  if (tid == 0) lane_view(args, a, lane_id);
  if (tid < NWORK) s_work[tid] = 0;
  if (tid < NRWORK) s_rwork[tid] = 0;
  if (tid < NRSEC) s_rsec[tid] = 0;
  if (tid == 0) {
    s_rsec[NRSEC] = clock64();
    s_rsec[NRSEC + 1] = RS_SEC_INIT;
  }
  sec_start();  // the step's own section marks (a cluster's)
  __syncthreads();
  // the plan and the launch disagree: a plan made for another block shape
  if (args.cluster != sc.size || (int)blockDim.x != THREADS) __trap();
  const int G = a.G, R = a.R, MR = a.MR, N = a.N, C = a.C, TPL = a.TPL;
  Dyn d;
  int* x = dyn;
  d.gmin = x; x += G;
  d.boot = x; x += G;
  d.nothing = x; x += G;
  d.maxcap = x; x += R;
  d.act = x; x += MR;
  d.ord = x; x += MR;
  d.krow = x; x += MR;
  d.irow = x; x += MR;
  d.seq = x; x += MR;
  d.ncap = x; x += N;
  d.ncum = x; x += N;
  d.capc = x; x += C;
  d.take = x; x += C;
  d.plvl = x; x += C;
  d.newtake = x; x += C;
  d.newcum = x; x += C;
  d.cumtake = x; x += C;
  d.tcompat = x; x += TPL;
  d.qt = x; x += TPL;
  d.wsum = x; x += 32;
  d.sm = group_mem(d.gmin, d.boot, d.nothing, d.maxcap);
  d.sm.mg = x; x += G;
  d.sm.mk = x; x += G;
  d.sm.any = x; x += C;
  d.sm.best = x; x += C;
  d.sm.fs = x; x += C;
  d.sm.cand = x; x += C;
  d.sm.tok = x; x += TPL;
  d.sm.tfs = x; x += TPL;
  d.sm.nm = x;
  d.red = &red;
  // every block owns a slice of the types; the tables stay in device memory
  sc.ts.tstride = a.T;
  sc.ts.its = its_of(a);
  sc.ts.cap = a.it_cap;
  sc.ts.tpl_ok = a.tpl_it_ok;
  sc.ts.cio = a.claim_it_ok;
  sc.ts.ok_t = nullptr;
  sc.ts.cap_t = nullptr;
  const int tslice = (a.T + sc.size - 1) / sc.size;
  sc.ts.t0 = min(a.T, sc.rank * tslice);
  sc.ts.t1 = min(a.T, sc.ts.t0 + tslice);
  const bool leader = sc.leader();

  // the lane's state: a copy of the start state, with the lane's census in
  // full mode (over the scope's threads)
  const long K = a.K, W = a.W;
  copy_n(sc, a.claim_adm, a.init_claim_adm, C * K * W);
  copy_n(sc, a.claim_comp, a.init_claim_comp, C * K);
  copy_n(sc, a.claim_def, a.init_claim_def, C * K);
  copy_n(sc, a.claim_gt, a.init_claim_gt, C * K);
  copy_n(sc, a.claim_lt, a.init_claim_lt, C * K);
  copy_n(sc, a.claim_requests, a.init_claim_requests, (long)C * R);
  copy_n(sc, a.claim_it_ok, a.init_claim_it_ok, (long)C * a.T);
  copy_n(sc, a.claim_open, a.init_claim_open, (long)C);
  copy_n(sc, a.claim_npods, a.init_claim_npods, (long)C);
  copy_n(sc, a.claim_tpl, a.init_claim_tpl, (long)C);
  copy_n(sc, a.claim_ports, a.init_claim_ports, (long)C * a.PT);
  copy_n(sc, a.node_adm, a.init_node_adm, N * K * W);
  copy_n(sc, a.node_comp, a.init_node_comp, N * K);
  copy_n(sc, a.node_def, a.init_node_def, N * K);
  copy_n(sc, a.node_gt, a.init_node_gt, N * K);
  copy_n(sc, a.node_lt, a.init_node_lt, N * K);
  copy_n(sc, a.node_requests, a.init_node_requests, (long)N * R);
  copy_n(sc, a.node_npods, a.init_node_npods, (long)N);
  copy_n(sc, a.node_ports, a.init_node_ports, (long)N * a.PT);
  copy_n(sc, a.node_vol_used, a.init_node_vol_used, (long)N * a.D);
  copy_n(sc, a.remaining, a.init_remaining, (long)TPL * R);
  copy_n(sc, a.grp_counts, a.lane_grp_counts0 ? a.lane_grp_counts0 : a.init_grp_counts, (long)G * a.V);
  copy_n(sc, a.grp_registered, a.lane_grp_registered0 ? a.lane_grp_registered0 : a.init_grp_registered, (long)G * a.V);
  for (int p = sc.gthread(); p < a.P; p += sc.nthreads()) {
    a.kind[p] = KIND_FAIL;
    a.index[p] = -1;
  }
  if (leader && tid == 0 && lane_id == 0) {
    args.plan[0] = args.layout;
    args.plan[1] = sc.size;
    args.plan[2] = THREADS;
  }
  // every block of the cluster is running before any reaches another's
  // shared memory, and the start state is in place
  sc.sync();

  for (int pass = 0; pass < a.passes; ++pass) {
    for (int r = 0; r < a.RN; ++r) {
      const int start = a.run_start[r], len = a.run_len[r], mode = a.run_mode[r];
      if (len <= 0) continue;  // a padding or trimmed-out run: a no-op
      rs_to(mode == RUN_SINGLE ? RS_SEC_SINGLE : mode == RUN_ANALYTIC ? RS_SEC_A_NODES : RS_SEC_TOPO);
      if (mode == RUN_SINGLE) {
        // an inactive row fails without touching state
        if (a.pod_active[start]) {
          step(sc, a, start, s, *d.red, d.sm);
          if (leader && tid == 0) {
            a.kind[start] = s.kind;
            a.index[start] = s.index;
            s_rwork[RW_PODS_STEPPED] += 1;
          }
        } else if (leader && tid == 0 && a.kind[start] >= KIND_FAIL) {
          a.kind[start] = KIND_FAIL;
          a.index[start] = -1;
        }
        if (leader && tid == 0) s_rwork[RW_RUNS_SINGLE] += 1;
        sc.sync();
      } else if (mode == RUN_ANALYTIC) {
        analytic_commit(sc, a, start, start, len, rs, d);
      } else {
        topo_commit(sc, a, start, start, len, s, d);
      }
    }
    rs_to(RS_SEC_PASS);
    if (pass + 1 < a.passes) {
      // placed rows leave the next pass's active set
      for (int p = sc.gthread(); p < a.P; p += sc.nthreads())
        if (a.kind[p] < KIND_FAIL) a.pod_active[p] = 0;
      sc.sync();
    }
  }
  // the work of every block into the leader's counters (the barrier counts
  // are the leader's own), then the leader writes them out; no block leaves
  // while another may still reach its shared memory
  __syncthreads();
  rs_to(RS_SEC_PASS);
  if (sc.size > 1) {
    if (!leader && tid <= WORK_TYPE_TESTS) atomicAdd(sc.lead(&s_work[tid]), s_work[tid]);
    cluster_barrier();
  }
  if (leader) {
    if (tid < NWORK) a.work[tid] = s_work[tid];
    if (tid < NRWORK) a.work[NWORK + tid] = s_rwork[tid];
    if (tid < NRSEC) a.sections[tid] = s_rsec[tid];
  }
}

// LAYOUT_BLOCK: one 512-thread block per lane
__global__ void __launch_bounds__(THREADS, 1) runs_screen_kernel(RunsArgs args) {
  BlockScope sc{};
  sc.rank = 0;
  sc.size = 1;
  lane_body(args, sc);
}

// LAYOUT_CLUSTER: one cluster of args.cluster 512-thread blocks per lane
__global__ void __launch_bounds__(THREADS, 1) runs_screen_cluster_kernel(RunsArgs args) {
  ClusterScope sc{};
  sc.rank = cluster_rank();
  sc.size = cluster_blocks();
  lane_body(args, sc);
}

}  // namespace

extern "C" int runs_screen_args_size() { return (int)sizeof(RunsArgs); }

// Dynamic shared memory of one block for these dims (Dyn).
extern "C" long long runs_screen_smem_bytes(const RunsArgs* args) {
  const RunsArgs& a = *args;
  return (long long)(5 * a.G + a.R + 5 * a.MR + 2 * a.N + 10 * a.C + 4 * a.TPL + 32 + 1) * sizeof(int);
}

// Launch on ``stream`` in the layout of args->layout; returns 0 or the
// CUDA error (a layout the card cannot hold is refused, never run in
// another shape).
extern "C" int runs_screen_launch(const RunsArgs* args, void* stream) {
  const RunsArgs& a = *args;
  const size_t smem = (size_t)runs_screen_smem_bytes(args);
  if (a.B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.layout == LAYOUT_CLUSTER)
    return cluster_launch(runs_screen_cluster_kernel, a.B * a.cluster, a.cluster, THREADS, smem, st, a);
  if (a.cluster != 1 || a.layout != LAYOUT_BLOCK) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(runs_screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // above the card's opt-in limit: the caller raises KernelDeviceError;
  // clear the error so that it does not surface at a later launch
  if (e != cudaSuccess) return (int)cudaGetLastError();
  runs_screen_kernel<<<a.B, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}
