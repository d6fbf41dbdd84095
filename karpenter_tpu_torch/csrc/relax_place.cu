// relax_place: phase 1 of the two-phase solve in one launch: the dense
// waterfill, or (mode 1) the convex projected-gradient solve.
//
// Replaces the JAX package's device programs
//   ops/relax.py:162 _relax_place_jit (_relax_impl :124, over
//   ops/relax_common.py eligibility :70, plan_groups :168, commit_assignment :299)
//   ops/relax2.py:314 _relax2_place_jit (_relax2_impl :226, _pgd_step_op :179,
//   _round_lff :197; program 17), in mode 1
//   parallel/mesh.py:517 shard_relax2_sweeps_program's phase 1 (program 14),
//   in mode 1 with one cluster per partition (relax_place_lanes_launch)
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
// ladder rung), a pass or two over the pods and, in mode 1, 24 trips over the
// P x 16 fractional assignment; the tables are L2-resident. What the stages
// need is ordering: each reads the previous one's result over the whole batch
// (group ids are a prefix count, slots a prefix sum), so the time is the
// stages' latency chain, and a stage run by too few threads, or one long
// serial sum, holds the whole phase (PERF.md section 5: the leader's clock by
// stage, ``sections``).
//
// What the design does about it: ONE solve runs on a thread-block cluster of
// ``cluster`` blocks (the wrapper's planner, ops/relax.relax_plan: 16 for a
// lone solve, up to 8 a lane in the lanes mode, where cluster c runs lane c),
// with cluster barriers between the stages; the single launch and the lanes
// launch run one body. Each stage spreads its items over the cluster's
// threads or warps: pods (a warp per pod for the eligibility screen, whose
// port and group rows it reads as coalesced words), groups x templates x
// types and claims x types (the instance-type tests), a warp per group (the
// template pick, the best type, the group sums) or per bin (the convex
// loads). The workspace lives in device memory, shared by the cluster's
// blocks; integer and max reductions use atomics (global, or into the leader
// block's shared memory through distributed shared memory), whose order does
// not matter; the integer prefix sums (group ids, slot bases) are block scans
// joined across the cluster. Every float sum whose rounding depends on the
// order of its adds is taken in pod-index order by one thread, as the plain
// version takes it: the group and claim request sums and the group masses (a
// warp stages 64 pods' values in its shared memory at a time, with their
// loads in flight together, then one lane per resource adds them in order)
// and the convex mode's bin loads. The waterfill's float64 prefix sum is
// taken exactly in integers over the cluster, which equals the sequential
// float64 sum bit for bit while the batch's demand sums below 512 (above it,
// one lane adds in pod order; prefix_sum). So the kernel and the plain
// version agree bit for bit, at every cluster size.
//
// Where the time goes now (PERF.md section 5): the eligibility screen's two
// passes over the pods' rows (a few dependent L2 loads a pod; at the fleet's
// 1,024 topology groups, 44 MB of group rows a lane) and, in mode 1, the
// longest bin's chain of ordered adds each trip.
//
// The convex mode (stage 9c) replaces the waterfill's stage 9. Its
// fractional assignment X (P x 16 floats, 655 KB at 10k) lives in the
// workspace. A bin's contributors are a contiguous run of its group's pods
// (whose preferred bins never decrease), so each trip's row update (a thread
// per pod, over the cluster) writes every product X[p, j] * w[p] into bin
// c's own contiguous row of products (``ybin``, at the pod's offset from the
// bin's first contributor; slots of pods that do not contribute stay 0), and
// the bin's load is then one warp's coalesced read of that row, with one lane
// adding the nonzero products in pod order (a zero product changes no sum of
// nonnegative terms). The rounding compacts each bin's candidates in pod
// order (a warp per bin), ranks each by descending share then pod index (a
// thread per candidate, counting over its bin), and admits them in rank order
// while the bin's running load stays within 1 + 1e-6 (a warp per bin, one
// lane adding). These are the plain version's orders, so the two agree bit
// for bit.
//
// The kernel counts its instance-type tests and the topology lanes it
// records (WORK_*) into ``work``, so a run's operation bound is read from
// what this data needed. A launch whose cluster is not the one its plan was
// made for traps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// masks.cuh for why FMA contraction must stay off).
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

#include "hopper.cuh"
#include "topology.cuh"

using namespace kt;

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_CLUSTER = 16;
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

// an ordered sum stages STAGE pods of up to STAGE_COLS columns a round
constexpr int STAGE = 64;
constexpr int STAGE_COLS = 8;
// the float64 prefix sum stages PREFIX_STAGE pods a round
constexpr int PREFIX_STAGE = 256;

// section counters (RelaxArgs::sections): clock64 cycles of the phase by
// stage, read by thread 0 right after the barrier that ends a stage.
// sec_to(x) closes the stage in progress and opens x.
constexpr int SEC_INIT = 0;      // initial values
constexpr int SEC_ELIG = 1;      // eligibility screen, group heads
constexpr int SEC_GROUPS = 2;    // group ids, members
constexpr int SEC_MERGE = 3;     // group maxima, merged template rows, polarity, compat
constexpr int SEC_SURVIVE = 4;   // the groups x templates x types survival tests
constexpr int SEC_PICK = 5;      // template pick, request sums, best type
constexpr int SEC_DEMAND = 6;    // normalised demand
constexpr int SEC_PREFIX = 7;    // the float64 prefix sum
constexpr int SEC_SLOTS = 8;     // waterfill slots; convex: mass, bins, warm start
constexpr int SEC_LOADS = 9;     // convex: the trips' bin loads
constexpr int SEC_UPDATE = 10;   // convex: the trips' row updates
constexpr int SEC_ROUND = 11;    // convex: rounding
constexpr int SEC_ROWS = 12;     // claim rows
constexpr int SEC_LADDER = 13;   // the rounding ladder
constexpr int SEC_COMMIT = 14;   // commit of the surviving claims
constexpr int SEC_TOPO = 15;     // topology records
constexpr int SEC_VERDICT = 16;  // verdicts, residue, stats
constexpr int NSEC = 17;

// [NSEC] cycles, then the clock of the last mark and the open stage
__shared__ long long s_sec[NSEC + 2];

__device__ __forceinline__ void sec_to(int next) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    s_sec[s_sec[NSEC + 1]] += now - s_sec[NSEC];
    s_sec[NSEC] = now;
    s_sec[NSEC + 1] = next;
  }
}

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
  long long* sections;       // [NSEC]: the leader's clock64 cycles by stage (SEC_*)
  int* plan;                 // [1]: the cluster the launch ran on
  void* workspace;           // relax_place_workspace_bytes() bytes
  // dims; ``cluster``: the blocks of the launch's plan (ops/relax.relax_plan)
  int P, K, V, W, C, N, T, TPL, R, O, PT, D, G, F, CH, n_passes, mode, iters, cluster;
  float step;  // mode 1: the gradient step
};

// The kernel's working arrays, carved out of RelaxArgs::workspace (device
// memory, shared by the blocks of the lane's cluster).
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
  int* gmax;          // [C, R] elementwise-max member request (float bits: requests are >= 0)
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
  int* total;   // [1] the convex mode's candidate count
  // the convex mode
  float* X;      // [P, WINDOW] fractional assignment
  float* ybin;   // [P * WINDOW] each bin's products, in pod order from its first contributor
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
  int* ybase;    // [C] the bin's first product in ybin
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
// device: the lanes mode carves each lane's workspace in its blocks.
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
  take_n(s->total, 1, base, off);
  if (a.mode == 1) {
    take_n(s->X, P * WINDOW, base, off);
    take_n(s->ybin, P * WINDOW, base, off);
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
    take_n(s->ybase, C, base, off);
    take_n(s->bcount, C, base, off);
    take_n(s->bbase, C, base, off);
  }
  return off;
}

// One lane's (one solve's) cluster as one of its blocks sees it: the
// block's rank, the blocks, and the thread and warp indices over all of them.
struct Cl {
  int rank, size;
  __device__ __forceinline__ bool leader() const { return rank == 0; }
  __device__ __forceinline__ int gt() const { return rank * THREADS + (int)threadIdx.x; }
  __device__ __forceinline__ int nt() const { return size * THREADS; }
  __device__ __forceinline__ int gw() const { return rank * NWARPS + (int)(threadIdx.x >> 5); }
  __device__ __forceinline__ int nw() const { return size * NWARPS; }
  // the leader block's copy of a shared-memory object
  template <class T>
  __device__ __forceinline__ T* lead(T* p) const {
    return map_rank(p, 0);
  }
};

// the block's per-stage scratch (static shared memory)
__shared__ long long s_wsum[NWARPS];       // a block scan's warp totals
__shared__ long long s_btot[MAX_CLUSTER];  // the leader's copy: each block's scan total
__shared__ long long s_boff, s_total;      // this block's offset in a cluster scan, and the scan's total
__shared__ int s_all_inf;
__shared__ int s_stats[NSTATS];
__shared__ unsigned long long s_work[NWORK];
__shared__ __align__(16) float s_stage[NWARPS][STAGE * STAGE_COLS];  // each warp's ordered-sum staging
__shared__ double s_pre[PREFIX_STAGE];                 // the prefix sum's staging
__shared__ float s_prew[PREFIX_STAGE];
__shared__ unsigned s_dmax;  // convex, the leader's copy: the trip's max |dX| (float bits; nonnegative)
__shared__ unsigned s_cmax;  // the final max overload (float bits)
__shared__ int s_conv;
__shared__ float s_delta;

template <class T>
__device__ __forceinline__ T warp_incl_scan(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

template <class T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// The exclusive prefix of ``v`` over the cluster's threads in (block rank,
// thread) order, and the total over the cluster into s_total. Called by
// every thread of every block; integers, so exact in any order.
__device__ long long cluster_excl_scan(const Cl& cl, long long v) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long incl = warp_incl_scan(v);
  __syncthreads();  // s_wsum's previous readers are done
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long x = warp_incl_scan(lane < NWARPS ? s_wsum[lane] : 0ll);
    if (lane < NWARPS) s_wsum[lane] = x;
  }
  __syncthreads();
  const long long before = (warp > 0 ? s_wsum[warp - 1] : 0ll) + incl - v;
  if (tid == 0) cl.lead(s_btot)[cl.rank] = s_wsum[NWARPS - 1];
  cluster_barrier();
  if (tid == 0) {
    long long off = 0, total = 0;
    const long long* tot = cl.lead(s_btot);
    for (int r = 0; r < cl.size; ++r) {
      if (r < cl.rank) off += tot[r];
      total += tot[r];
    }
    s_boff = off;
    s_total = total;
  }
  __syncthreads();
  return s_boff + before;
}

// The lanes of a warp that hold consecutive pods, grouped by ``key`` (a
// claim slot, a group; -1 for none): each group's lanes, its lowest lane
// (which makes the group's one atomic) and its highest. All 32 lanes call it.
struct Peers {
  unsigned mask;
  int low, high;
  __device__ __forceinline__ bool leads() const { return (int)(threadIdx.x & 31) == low; }
};
__device__ __forceinline__ Peers peers_of(int key) {
  Peers q;
  q.mask = __match_any_sync(FULL, key);
  q.low = __ffs(q.mask) - 1;
  q.high = 31 - __clz(q.mask);
  return q;
}

// The exclusive prefix sums of ``x[0..n)`` into ``out`` (and the total into
// *total when given), by one warp: integers, so exact in any order.
__device__ void warp_excl_scan(const int* x, int* out, int n, int* total) {
  const int lane = threadIdx.x & 31;
  int run = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int v = i < n ? x[i] : 0;
    const int incl = warp_incl_scan(v);
    if (i < n) out[i] = run + incl - v;
    run += __shfl_sync(FULL, incl, 31);
  }
  if (total && lane == 0) *total = run;
}

// Lanes c < ncol (<= STAGE_COLS) of the calling warp get the float sum over
// the pods p in [lo, hi] where keep(p) of val(p, c), added in pod order: the
// same adds, in the same order, as one thread's loop over the pods. The warp
// stages STAGE pods a round in its buffer, column by column (their loads in
// flight together; a pod it does not keep stages +0.0, which changes no sum
// that starts at +0.0), then each of lanes 0..ncol-1 adds its column's row
// four values a load.
template <class Keep, class Val>
__device__ float warp_ordered_sum(int lo, int hi, int ncol, Keep keep, Val val) {
  constexpr int PER = STAGE / 32;
  const int lane = threadIdx.x & 31;
  float* buf = s_stage[threadIdx.x >> 5];
  float acc = 0.f;
  for (int base = lo; base <= hi; base += STAGE) {
    bool k[PER];
    float v[PER][STAGE_COLS];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int p = base + 32 * i + lane;
      k[i] = p <= hi && keep(p);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int c = 0; c < STAGE_COLS; ++c) v[i][c] = k[i] && c < ncol ? val(base + 32 * i + lane, c) : 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int c = 0; c < STAGE_COLS; ++c) buf[c * STAGE + 32 * i + lane] = v[i][c];
    __syncwarp();
    if (lane < ncol) {
      const float4* row = reinterpret_cast<const float4*>(buf + lane * STAGE);
#pragma unroll
      for (int q = 0; q < STAGE / 4; ++q) {
        const float4 x = row[q];
        acc += x.x;
        acc += x.y;
        acc += x.z;
        acc += x.w;
      }
    }
    __syncwarp();
  }
  return acc;
}

// The claim slots' owning group and first and last member, from a warp of
// consecutive pods base + lane, each with its slot (-1 for none) and group:
// one atomic of each per run of lanes sharing a slot. All 32 lanes call it.
__device__ __forceinline__ void claim_members(const Workspace& s, int base, int slot, int g) {
  const Peers q = peers_of(slot);
  if (slot >= 0 && q.leads()) {
    atomicMax(&s.g_of_c[slot], g);
    atomicMin(&s.cfirst[slot], base + q.low);
    atomicMax(&s.clast[slot], base + q.high);
  }
}

__device__ __forceinline__ Row pod_row(const RelaxArgs& a, int p) {
  return row_at(a.pod_adm, a.pod_comp, a.pod_def, a.pod_gt, a.pod_lt, p, a.K, a.W);
}

// One byte of a row of bytes, or (aligned) its four bytes as a word.
__device__ __forceinline__ unsigned bytes4(const uint8_t* row, int i) {
  return *reinterpret_cast<const unsigned*>(row + i);
}

// ops/relax_common.eligibility for pod p, by one warp (the lanes agree).
// The port and group rows are read 16 (or 4) entries a lane where the row
// length and alignment allow it, every load of a row in flight together.
__device__ bool eligible_warp(const RelaxArgs& a, int p, bool all_inf) {
  const int lane = threadIdx.x & 31;
  const bool on = a.pod_active[p] && all_inf && !a.pod_def[(long)p * a.K + HOSTNAME_KEY];
  bool bad = false;
  for (int q = lane; q < a.PT; q += 32)
    bad |= a.pod_ports[(long)p * a.PT + q] || a.pod_conflict[(long)p * a.PT + q];
  const uint8_t* match = a.pod_match + (long)p * a.G;
  const uint8_t* owned = a.pod_owned + (long)p * a.G;
  const uint8_t* sel = a.pod_selects + (long)p * a.G;
  auto blocking = [&](int g) { return a.grp_inverse[g] || a.grp_type[g] == TYPE_ANTI_AFFINITY; };
  const uintptr_t rows = reinterpret_cast<uintptr_t>(a.pod_match) | reinterpret_cast<uintptr_t>(a.pod_owned) |
                         reinterpret_cast<uintptr_t>(a.pod_selects);
  if (a.G % 16 == 0 && (rows & 15) == 0) {
    for (int g = 16 * lane; g < a.G; g += 512) {
      const uint4 m = *reinterpret_cast<const uint4*>(match + g);
      const uint4 o = *reinterpret_cast<const uint4*>(owned + g);
      const uint4 w = *reinterpret_cast<const uint4*>(sel + g);
      bad |= (m.x | m.y | m.z | m.w | o.x | o.y | o.z | o.w) != 0u;
      const unsigned sw[4] = {w.x, w.y, w.z, w.w};
      for (int b = 0; b < 16; ++b)
        if ((sw[b >> 2] >> (8 * (b & 3))) & 0xffu) bad |= blocking(g + b);
    }
  } else if (a.G % 4 == 0 && (rows & 3) == 0) {
    for (int g = 4 * lane; g < a.G; g += 128) {
      bad |= (*reinterpret_cast<const unsigned*>(match + g) | *reinterpret_cast<const unsigned*>(owned + g)) != 0u;
      const unsigned sw = *reinterpret_cast<const unsigned*>(sel + g);
      for (int b = 0; b < 4; ++b)
        if ((sw >> (8 * b)) & 0xffu) bad |= blocking(g + b);
    }
  } else {
    for (int g = lane; g < a.G; g += 32) bad |= match[g] || owned[g] || (sel[g] && blocking(g));
  }
  if (!on || __any_sync(FULL, bad)) return false;
  // an existing node that may take the pod keeps node-priority semantics (a
  // lane per node)
  const Row pod = pod_row(a, p);
  const uint8_t* pod_neg = a.pod_neg + (long)p * a.K;
  const float* req = a.pod_requests + (long)p * a.R;
  bool takes = false;
  for (int n = lane; n < a.N; n += 32) {
    if (!a.pod_tol_node[(long)p * a.N + n]) continue;
    if (!fits_add(a.node_overhead + (long)n * a.R, req, a.node_avail + (long)n * a.R, a.R)) continue;
    bool vol_ok = true;
    for (int d = 0; d < a.D; ++d)
      if (a.node_vol_used[(long)n * a.D + d] + a.pod_vols[(long)p * a.D + d] > a.node_vol_limits[(long)n * a.D + d])
        vol_ok = false;
    if (!vol_ok) continue;
    const Row node = row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, n, a.K, a.W);
    if (intersects_ok(pod, pod_neg, node, a.node_neg + (long)n * a.K, a.K, a.W)) takes = true;
  }
  return !__any_sync(FULL, takes);
}

// Pod p's requirement row and template tolerations equal pod p-1's, by one
// warp (the lanes agree).
__device__ bool same_as_prev_warp(const RelaxArgs& a, int p) {
  const int lane = threadIdx.x & 31;
  const int K = a.K, KW = a.K * a.W;
  bool diff = false;
  for (int i = lane; i < KW; i += 32) diff |= a.pod_adm[(long)p * KW + i] != a.pod_adm[(long)(p - 1) * KW + i];
  for (int k = lane; k < K; k += 32) {
    const long i = (long)p * K + k, j = (long)(p - 1) * K + k;
    diff |= a.pod_comp[i] != a.pod_comp[j] || a.pod_def[i] != a.pod_def[j] || a.pod_gt[i] != a.pod_gt[j] ||
            a.pod_lt[i] != a.pod_lt[j];
  }
  for (int j = lane; j < a.TPL; j += 32)
    diff |= a.pod_tol_tpl[(long)p * a.TPL + j] != a.pod_tol_tpl[(long)(p - 1) * a.TPL + j];
  return !__any_sync(FULL, diff);
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

// Each claim's summed requests over its assigned pods, in pod order (a warp
// per claim over the cluster), then a cluster barrier.
__device__ void claim_sums(const RelaxArgs& a, const Workspace& s, const Cl& cl) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < a.R; c0 += STAGE_COLS) {
    const int ncol = min(STAGE_COLS, a.R - c0);
    for (int c = cl.gw(); c < a.C; c += cl.nw()) {
      const float sum = warp_ordered_sum(
          s.cfirst[c], s.clast[c], ncol, [&](int p) { return s.assigned[p] && s.slot[p] == c; },
          [&](int p, int r) { return a.pod_requests[(long)p * a.R + c0 + r]; });
      if (lane < ncol) s.sums[(long)c * a.R + c0 + lane] = sum;
    }
  }
  cluster_barrier();
}

// The float64 exclusive prefix sum of w over the pods, in pod order: the
// same value, bit for bit, as numpy's sequential cumsum. Each w is 0 or a
// float32 in [1e-6, 1], so a multiple of 2^-43: w * 2^43 is an integer below
// 2^43, and the cluster takes the integer prefix sums exactly, in any order.
// While their total stays below 2^52 (demand summing below 512), every
// partial sum of the sequential float64 loop is exact, so it equals the
// integer sum times 2^-43. Above that, warp 0 of the leader block takes the
// sequential sum: the warp stages PREFIX_STAGE demands, lane 0 adds them one
// after another, the warp writes the sums out. Ends in a cluster barrier.
__device__ void prefix_sum(const RelaxArgs& a, const Workspace& s, const Cl& cl) {
  constexpr float SCALE = 8796093022208.0f;  // 2^43
  const int P = a.P;
  const int chunk = (P + cl.nt() - 1) / cl.nt();
  const int lo = min(P, cl.gt() * chunk), hi = min(P, lo + chunk);
  long long sum = 0;
  for (int p = lo; p < hi; ++p) sum += (long long)(s.w[p] * SCALE);
  long long run = cluster_excl_scan(cl, sum);
  if (s_total < (1ll << 52)) {
    for (int p = lo; p < hi; ++p) {
      s.start[p] = (double)run * 0x1p-43;
      run += (long long)(s.w[p] * SCALE);
    }
    cluster_barrier();
    return;
  }
  if (cl.leader() && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double acc = 0.0;
    for (int base = 0; base < P; base += PREFIX_STAGE) {
      const int n = min(PREFIX_STAGE, P - base);
      float v[PREFIX_STAGE / 32];
#pragma unroll
      for (int k = 0; k < PREFIX_STAGE / 32; ++k) {
        const int i = 32 * k + lane;
        v[k] = i < n ? s.w[base + i] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < PREFIX_STAGE / 32; ++k) s_prew[32 * k + lane] = v[k];
      __syncwarp();
      if (lane == 0)
        for (int i = 0; i < n; ++i) {
          s_pre[i] = acc;
          acc += (double)s_prew[i];
        }
      __syncwarp();
      for (int i = lane; i < n; i += 32) s.start[base + i] = s_pre[i];
      __syncwarp();
    }
  }
  cluster_barrier();
}

// -- 9c. the convex mode's slots (ops/relax2.relax2_place_plain): each
// group's bins, the warm start and windows, the projected-gradient trips,
// and the largest-fraction-first rounding. Called by every thread of the
// cluster; ends in a cluster barrier.
__device__ void convex_slots(const RelaxArgs& a, const Workspace& s, const Cl& cl) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int P = a.P, C = a.C;
  int* stats0 = cl.lead(s_stats);

  // each group's mass (its pods in order, a warp per group) and bins:
  // ceil(mass) + 1
  for (int g = cl.gw(); g < C; g += cl.nw()) {
    const bool v = s.gvalid[g];
    const float m = warp_ordered_sum(v ? s.hp[g] : 0, v ? s.glast[g] : -1, 1, [&](int p) { return s.elig[p] != 0; },
                                     [&](int p, int) { return s.w[p]; });
    if (lane == 0) {
      s.gw[g] = m;
      s.nbins[g] = (v && m > 0.f) ? min((int)ceilf(m) + 1, C) : 0;
    }
  }
  if (cl.leader() && tid == 0) {
    s_conv = -1;
    s_dmax = 0;
    s_cmax = 0;
    s_delta = INFINITY;
  }
  cluster_barrier();
  if (cl.leader() && tid < 32) warp_excl_scan(s.nbins, s.slotbase, C, nullptr);
  cluster_barrier();

  // the warm start at the waterfill bin (the float64 prefix sum of stage 9)
  // and the window's valid columns
  unsigned long long cols = 0;
  int overflow = 0;
  for (int p = cl.gt(); p < P; p += cl.nt()) {
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
        if (v) vm |= 1 << j;
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
  cols = warp_sum(cols);
  overflow = warp_sum(overflow);
  if (lane == 0) {
    if (overflow) atomicAdd(&stats0[7], overflow);
    atomicAdd(cl.lead(&s_work[WORK_PGD_COLUMNS]), cols * (unsigned long long)(a.iters + 1));
  }
  cluster_barrier();
  // each bin's range of covering pods: bin c lies in one group's slots, whose
  // pods' preferred bins never decrease, and a pod's window covers c when its
  // preferred bin is within [c - 7, c + 8]: the range is the run of the
  // group's pods with such a preferred bin (two binary searches)
  for (int c = cl.gt(); c < C; c += cl.nt()) {
    int g = C;
    {
      int lo = 0, hi = C;  // the groups whose first slot is <= c
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (s.slotbase[mid] <= c)
          lo = mid + 1;
        else
          hi = mid;
      }
      for (g = lo - 1; g >= 0 && s.nbins[g] == 0; --g) {
      }
    }
    int first = P, last = -1;
    if (g >= 0 && c < s.slotbase[g] + s.nbins[g]) {
      int lo = s.hp[g], hi = s.glast[g] + 1;  // the first pod preferring a bin >= c - 7
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (s.pref[mid] < c - WINDOW / 2 + 1)
          lo = mid + 1;
        else
          hi = mid;
      }
      first = lo;
      lo = first, hi = s.glast[g] + 1;  // past the last pod preferring a bin <= c + 8
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (s.pref[mid] <= c + WINDOW / 2)
          lo = mid + 1;
        else
          hi = mid;
      }
      last = lo - 1;
      if (last < first) first = P, last = -1;
    }
    s.bfirst[c] = first;
    s.blast[c] = last;
  }
  cluster_barrier();
  // each bin's row of products: one slot per pod of its covering range
  if (cl.leader() && tid < 32) {
    int run = 0;
    for (int base = 0; base < C; base += 32) {
      const int c = base + lane;
      const int n = c < C && s.blast[c] >= 0 ? s.blast[c] - s.bfirst[c] + 1 : 0;
      const int incl = warp_incl_scan(n);
      if (c < C) s.ybase[c] = run + incl - n;
      run += __shfl_sync(FULL, incl, 31);
    }
    // a pod lies in the ranges of at most WINDOW bins (its group's bins
    // whose windows hold its preferred bin, which never decreases)
    if (run > WINDOW * P) __trap();
  }
  cluster_barrier();
  // the products of the warm start
  for (int p = cl.gt(); p < P; p += cl.nt()) {
    const int vm = s.vmask[p];
    for (int j = 0; j < WINDOW; ++j)
      if ((vm >> j) & 1) {
        const int c = s.pref[p] + j - WINDOW / 2;
        s.ybin[s.ybase[c] + p - s.bfirst[c]] = s.X[(long)p * WINDOW + j] * s.w[p];
      }
  }
  cluster_barrier();
  sec_to(SEC_LOADS);

  // the trips; the last pass (t == iters) takes the final loads only
  unsigned* dmax0 = cl.lead(&s_dmax);
  for (int t = 0; t <= a.iters; ++t) {
    // each bin's load: its row of products added in pod order, a warp per
    // bin, the lanes staging 512 products at once, lane 0 adding them in
    // order (the slots of pods that do not contribute hold +0.0, which
    // changes no sum of nonnegative terms)
    for (int c = cl.gw(); c < C; c += cl.nw()) {
      float l = 0.f;
      const int n = s.blast[c] >= 0 ? s.blast[c] - s.bfirst[c] + 1 : 0;
      const float* row = s.ybin + s.ybase[c];
      float* buf = s_stage[tid >> 5];
      for (int base = 0; base < n; base += STAGE * STAGE_COLS) {
        const int m = min(STAGE * STAGE_COLS, n - base);
        float v[STAGE * STAGE_COLS / 32];
#pragma unroll
        for (int k = 0; k < STAGE * STAGE_COLS / 32; ++k) {
          const int i = 32 * k + lane;
          v[k] = i < m ? row[base + i] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < STAGE * STAGE_COLS / 32; ++k) buf[32 * k + lane] = v[k];
        __syncwarp();
        if (lane == 0) {
          const float4* b4 = reinterpret_cast<const float4*>(buf);
#pragma unroll 8
          for (int q = 0; q < (m + 3) / 4; ++q) {
            const float4 x = b4[q];
            l += x.x;
            l += x.y;
            l += x.z;
            l += x.w;
          }
        }
        __syncwarp();
      }
      if (lane == 0) {
        s.load[c] = l;
        if (t == a.iters) atomicMax(cl.lead(&s_cmax), __float_as_uint(fmaxf(l - 1.f, 0.f)));
      }
    }
    cluster_barrier();
    sec_to(SEC_UPDATE);
    if (t == a.iters) break;
    // each row: the gradient step, the clip to [0, 1], the rescale of a row
    // whose mass (its columns added in order) exceeds 1; then its products
    float dmax = 0.f;
    for (int p = cl.gt(); p < P; p += cl.nt()) {
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
        if ((vm >> j) & 1) {
          const int c = pref + j - WINDOW / 2;
          s.ybin[s.ybase[c] + p - s.bfirst[c]] = v * w;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dmax = fmaxf(dmax, __shfl_xor_sync(FULL, dmax, o));
    if (lane == 0 && dmax > 0.f) atomicMax(dmax0, __float_as_uint(dmax));
    cluster_barrier();
    if (cl.leader() && tid == 0) {
      s_delta = __uint_as_float(s_dmax);
      if (s_conv < 0 && s_delta < SCAN_TOL) s_conv = t + 1;
      s_dmax = 0;
    }
    sec_to(SEC_LOADS);
  }
  sec_to(SEC_ROUND);

  // rounding: each pod's heaviest column (the first of equal ones) names its
  // bin; a pod whose best share times its valid columns is below
  // MIN_REL_MASS is repaired
  for (int base = cl.gt() - lane; base < P; base += cl.nt()) {
    const int p = min(base + lane, P - 1);
    const bool in = base + lane < P;
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
    const bool cand = in && vm && fr * (float)__popc(vm) >= MIN_REL_MASS;
    if (in) {
      s.key_bin[p] = cand ? slot : C;
      s.frac[p] = fr;
      s.slot[p] = slot;
      s.assigned[p] = 0;
    }
    const Peers q = peers_of(cand ? slot : -1);
    if (cand && q.leads()) atomicAdd(&s.bcount[slot], __popc(q.mask));
  }
  cluster_barrier();
  if (cl.leader() && tid < 32) warp_excl_scan(s.bcount, s.bbase, C, s.total);
  cluster_barrier();
  // each bin's candidates in pod order (a warp per bin compacts its range;
  // its lanes read 4 x 32 keys a round)
  for (int c = cl.gw(); c < C; c += cl.nw()) {
    const int last = s.blast[c];
    int n = s.bbase[c];
    for (int base = s.bfirst[c]; base <= last; base += 128) {
      bool is[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = base + 32 * i + lane;
        is[i] = p <= last && s.key_bin[p] == c;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = base + 32 * i + lane;
        const unsigned m = __ballot_sync(FULL, is[i]);
        if (is[i]) {
          const int k = n + __popc(m & ((1u << lane) - 1u));
          s.border[k] = p;
          s.cfrac[k] = s.frac[p];
        }
        n += __popc(m);
      }
    }
  }
  cluster_barrier();
  // each candidate's rank in its bin: descending share, then pod index
  const int ncand = *s.total;
  for (int i = cl.gt(); i < ncand; i += cl.nt()) {
    const int c = s.key_bin[s.border[i]];
    const int lo = s.bbase[c], hi = lo + s.bcount[c];
    const float f = s.cfrac[i];
    int r = 0;
    for (int k = lo; k < hi; ++k) r += s.cfrac[k] > f || (s.cfrac[k] == f && k < i);
    s.sorted[lo + r] = s.border[i];
  }
  cluster_barrier();
  // each bin admits its candidates in that order while its running load
  // stays within ADMIT (a warp per bin stages 32 candidates' demands, lane 0
  // adds them in order)
  for (int c = cl.gw(); c < C; c += cl.nw()) {
    float* buf = s_stage[tid >> 5];
    float l = 0.f;
    const int lo = s.bbase[c], hi = lo + s.bcount[c];
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      const int p = i < hi ? s.sorted[i] : 0;
      buf[lane] = i < hi ? s.w[p] : 0.f;
      __syncwarp();
      if (lane == 0)
        for (int k = 0; k < min(32, hi - base); ++k) {
          l += buf[k];
          buf[32 + k] = l <= ADMIT ? 1.f : 0.f;
        }
      __syncwarp();
      if (i < hi) s.assigned[p] = buf[32 + lane] != 0.f;
      __syncwarp();
    }
  }
  cluster_barrier();
  int round_demoted = 0;
  for (int base = cl.gt() - lane; base < P; base += cl.nt()) {
    const int p = base + lane;
    bool as = false;
    if (p < P) {
      as = s.elig[p] && s.assigned[p];
      s.assigned[p] = as;
      if (s.elig[p] && !as) ++round_demoted;
    }
    claim_members(s, base, as ? s.slot[p] : -1, as ? s.gid[p] : 0);
  }
  round_demoted = warp_sum(round_demoted);
  if (lane == 0 && round_demoted) atomicAdd(&stats0[8], round_demoted);
  cluster_barrier();
  if (cl.leader() && tid == 0) {
    s_stats[4] = s_conv >= 0 ? s_conv : a.iters;
    s_stats[5] = __float_as_int(s_delta);
    s_stats[6] = (int)s_cmax;
  }
  sec_to(SEC_ROWS);
}

// The whole phase of one solve (one lane), run by every block of its
// cluster; inlined into both kernels below. ``a`` and ``s`` are the lane's
// argument struct and workspace.
__device__ __forceinline__ void relax_body(const RelaxArgs& a, const Workspace& s) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int P = a.P, K = a.K, W = a.W, C = a.C, T = a.T, TPL = a.TPL, R = a.R, G = a.G, V = a.V;
  const int CT = C * TPL;
  const ITs its = its_of(a);
  Cl cl;
  cl.rank = cluster_rank();
  cl.size = cluster_blocks();
  // the plan and the launch disagree: a plan made for another cluster size
  if (a.cluster != cl.size || cl.size > MAX_CLUSTER) __trap();
  int* stats0 = cl.lead(s_stats);
  unsigned long long tests = 0;  // this thread's instance-type tests
  if (tid < NSEC) s_sec[tid] = 0;
  if (tid == 0) {
    s_sec[NSEC] = clock64();
    s_sec[NSEC + 1] = SEC_INIT;
  }

  // -- 0. initial values; every block's copies, the workspace's over the
  // cluster
  if (tid == 0) {
    int all_inf = 1;
    for (int i = 0; i < a.TPL * R; ++i) all_inf &= isinf(a.remaining[i]) ? 1 : 0;
    s_all_inf = all_inf;
  }
  if (tid < NSTATS) s_stats[tid] = 0;
  if (tid < NWORK) s_work[tid] = 0;
  for (int c = cl.gt(); c < C; c += cl.nt()) {
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
  for (int i = cl.gt(); i < C * R; i += cl.nt()) s.gmax[i] = 0;  // bits of 0.0f
  if (a.mode == 1)
    for (long i = cl.gt(); i < (long)P * WINDOW; i += cl.nt()) s.ybin[i] = 0.f;
  if (cl.leader() && tid == 0) a.plan[0] = cl.size;
  // every block of the cluster is running before any reaches another's
  // shared memory
  cluster_barrier();
  sec_to(SEC_ELIG);

  // -- 1. eligibility, then group heads: an eligible pod whose predecessor is
  // ineligible or differs in requirement row or template tolerations (a warp
  // per pod)
  for (int p = cl.gw(); p < P; p += cl.nw()) {
    const bool e = eligible_warp(a, p, s_all_inf);
    if (lane == 0) s.elig0[p] = e;
  }
  cluster_barrier();
  for (int p = cl.gw(); p < P; p += cl.nw()) {
    const bool h = s.elig0[p] && !(p > 0 && s.elig0[p - 1] && same_as_prev_warp(a, p));
    if (lane == 0) s.head[p] = h;
  }
  cluster_barrier();
  sec_to(SEC_GROUPS);

  // -- 2. group ids: heads up to and including p, minus one (a scan over
  // contiguous chunks of pods, one chunk per thread of the cluster)
  const int chunk = (P + cl.nt() - 1) / cl.nt();
  const int lo = min(P, cl.gt() * chunk), hi = min(P, lo + chunk);
  int nh = 0;
  for (int p = lo; p < hi; ++p) nh += s.head[p];
  int run = (int)cluster_excl_scan(cl, nh);
  for (int p = lo; p < hi; ++p) {
    run += s.head[p];
    s.gid[p] = run - 1;
  }
  cluster_barrier();
  // the group axis is capped at C; a group's members are the contiguous
  // pods from its head to glast
  for (int base = cl.gt() - lane; base < P; base += cl.nt()) {
    const int p = base + lane;
    const int g = p < P ? s.gid[p] : -1;
    const bool e = p < P && s.elig0[p] && g < C;
    if (p < P) s.elig[p] = e;
    if (e && s.head[p]) {
      s.hp[g] = p;
      s.gvalid[g] = 1;
    }
    const Peers q = peers_of(e ? g : -1);
    if (e && q.leads()) atomicMax(&s.glast[g], base + q.high);
  }
  cluster_barrier();
  sec_to(SEC_MERGE);

  // -- 3. each group's elementwise-max member request: a warp per 32 pods,
  // a max over each run of one group's pods (group ids never decrease), one
  // atomic per run (requests are >= 0, so their float bits order as ints)
  for (int base = 32 * cl.gw(); base < P; base += 32 * cl.nw()) {
    const int p = base + lane;
    const int key = p < P && s.elig[p] ? s.gid[p] : -1;
    const int prev = __shfl_up_sync(FULL, key, 1);
    const bool head = key >= 0 && (lane == 0 || prev != key);
    for (int r = 0; r < R; ++r) {
      float v = key >= 0 ? a.pod_requests[(long)p * R + r] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(FULL, v, o);
        const int ku = __shfl_down_sync(FULL, key, o);
        if (lane + o < 32 && ku == key) v = fmaxf(v, u);
      }
      if (head && v > 0.f) atomicMax(&s.gmax[(long)key * R + r], __float_as_int(v));
    }
  }

  // -- 4. every template's row merged with each group's head row, its
  // polarity, and template compatibility (with the well-known allowance)
  for (int i = cl.gt(); i < CT * K * W; i += cl.nt()) {
    const int ci = i / (K * W), kw = i % (K * W), g = ci / TPL, j = ci % TPL;
    if (s.gvalid[g]) s.m_adm[i] = a.tpl_adm[(long)j * K * W + kw] & a.pod_adm[(long)s.hp[g] * K * W + kw];
  }
  for (int i = cl.gt(); i < CT * K; i += cl.nt()) {
    const int ci = i / K, k = i % K, g = ci / TPL, j = ci % TPL;
    if (!s.gvalid[g]) continue;
    const long pk = (long)s.hp[g] * K + k, jk = (long)j * K + k;
    s.m_comp[i] = a.tpl_comp[jk] && a.pod_comp[pk];
    s.m_def[i] = a.tpl_def[jk] || a.pod_def[pk];
    s.m_gt[i] = max(a.tpl_gt[jk], a.pod_gt[pk]);
    s.m_lt[i] = min(a.tpl_lt[jk], a.pod_lt[pk]);
  }
  cluster_barrier();
  for (int i = cl.gt(); i < CT * K; i += cl.nt()) {
    const int ci = i / K, k = i % K, g = ci / TPL;
    if (s.gvalid[g])
      s.m_neg[i] = negative_polarity_key(s.m_adm + (long)i * W, s.m_comp[i], s.m_gt[i], s.m_lt[i], a.lvw + k * W,
                                         a.ln + (long)k * V, W);
  }
  for (int ci = cl.gt(); ci < CT; ci += cl.nt()) {
    const int g = ci / TPL, j = ci % TPL;
    if (!s.gvalid[g]) continue;
    const Row tpl = row_at(a.tpl_adm, a.tpl_comp, a.tpl_def, a.tpl_gt, a.tpl_lt, j, K, W);
    s.tpl_compat[ci] =
        compatible_ok(tpl, a.tpl_neg + (long)j * K, pod_row(a, s.hp[g]), a.pod_neg + (long)s.hp[g] * K, a.wellknown, K, W);
  }
  cluster_barrier();
  sec_to(SEC_SURVIVE);

  // -- 5. instance-type survival of each merged row against the group's
  // max member: if it fits a type per resource, every member does
  const float* gmax = reinterpret_cast<const float*>(s.gmax);
  for (long i = cl.gt(); i < (long)CT * T; i += cl.nt()) {
    const int ci = (int)(i / T), t = (int)(i % T), g = ci / TPL, j = ci % TPL;
    bool ok = false;
    if (s.gvalid[g]) {
      ++tests;
      const Row m = row_at(s.m_adm, s.m_comp, s.m_def, s.m_gt, s.m_lt, ci, K, W);
      ok = prior_ok(a, j, t) && it_gate(m, s.m_neg + (long)ci * K, a.tpl_overhead + (long)j * R,
                                        gmax + (long)g * R, its, t, K, W, R, a.O);
    }
    s.it_ok_max[i] = ok;
  }
  cluster_barrier();
  sec_to(SEC_PICK);

  // -- 6. template pick: the first template the head tolerates, compatible
  // with the group, with a surviving instance type (a warp per group); a
  // group with none goes to the repair pass
  for (int g = cl.gw(); g < C; g += cl.nw()) {
    if (!s.gvalid[g]) continue;
    int pick = TPL;
    for (int j = 0; j < TPL && pick == TPL; ++j) {
      const int ci = g * TPL + j;
      if (!a.pod_tol_tpl[(long)s.hp[g] * TPL + j] || !s.tpl_compat[ci]) continue;
      bool any = false;
      for (int t0 = 0; t0 < T && !any; t0 += 32) any = __any_sync(FULL, t0 + lane < T && s.it_ok_max[(long)ci * T + t0 + lane]);
      if (any) pick = j;
    }
    if (lane == 0) {
      if (pick == TPL) s.gvalid[g] = 0;
      s.tpick[g] = min(pick, TPL - 1);
    }
  }
  cluster_barrier();
  for (int p = cl.gt(); p < P; p += cl.nt())
    if (s.elig[p] && !s.gvalid[s.gid[p]]) s.elig[p] = 0;

  // -- 7. each group's request sum (in pod order) and its best-packing
  // instance type: the fewest fractional bins among the types the max
  // member survives on (a warp per group; the first minimum, as argmin takes
  // it)
  for (int g = cl.gw(); g < C; g += cl.nw()) {
    const bool v = s.gvalid[g];
    for (int c0 = 0; c0 < R; c0 += STAGE_COLS) {
      const int ncol = min(STAGE_COLS, R - c0);
      const float sum = warp_ordered_sum(v ? s.hp[g] : 0, v ? s.glast[g] : -1, ncol, [](int) { return true; },
                                         [&](int p, int r) { return a.pod_requests[(long)p * R + c0 + r]; });
      if (lane < ncol) s.gsum[(long)g * R + c0 + lane] = sum;
    }
    __syncwarp();
    if (!v) continue;
    const int j = s.tpick[g];
    const float* ov = a.tpl_overhead + (long)j * R;
    const float* gs = s.gsum + (long)g * R;
    const uint8_t* ok = s.it_ok_max + (long)(g * TPL + j) * T;
    float best = INFINITY;
    int tau = MAXI;
    for (int t = lane; t < T; t += 32) {
      float frac = 0.f;
      bool no_room = false;
      for (int r = 0; r < R; ++r) {
        if (!(gs[r] > 0.f)) continue;
        const float cap = a.it_alloc[(long)t * R + r] - ov[r];
        frac = fmaxf(frac, gs[r] / fmaxf(cap, 1e-9f));
        no_room |= cap <= 0.f;
      }
      const float v = (ok[t] && !no_room) ? frac : INFINITY;
      if (v < best) {  // a lane's types ascend: its first minimum
        best = v;
        tau = t;
      }
    }
    // the warp's first minimum: the least type among the lanes' least value
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, o);
      const int ot = __shfl_xor_sync(FULL, tau, o);
      if (ob < best || (ob == best && ot < tau)) {
        best = ob;
        tau = ot;
      }
    }
    if (tau == MAXI) tau = 0;  // no type survives: type 0, as argmin over all-inf
    for (int r = lane; r < R; r += 32) s.capvec[(long)g * R + r] = a.it_alloc[(long)tau * R + r] - ov[r];
  }
  cluster_barrier();
  sec_to(SEC_DEMAND);

  // -- 8. each eligible pod's demand, normalised by its group's capacity
  for (int p = cl.gt(); p < P; p += cl.nt()) {
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
  cluster_barrier();
  sec_to(SEC_PREFIX);

  // -- 9. the waterfill: one float64 prefix sum in pod order
  // (ops/relax.waterfill_bins); a pod's bin is floor(level + 1e-6) with level
  // the demand of its group's earlier pods; a group takes as many slots as
  // its highest bin, in group order. The convex mode takes its warm start
  // from the same sum (stage 9c).
  prefix_sum(a, s, cl);  // ends in a cluster barrier
  sec_to(SEC_SLOTS);
  if (a.mode == 1) convex_slots(a, s, cl);
  if (a.mode == 0) {
    for (int base = cl.gt() - lane; base < P; base += cl.nt()) {
      const int p = base + lane;
      const bool e = p < P && s.elig[p];
      int b = 0;
      if (e) {
        const double level = s.start[p] - s.start[s.hp[s.gid[p]]];
        b = max((int)floor(level + 1e-6), 0);
        s.binp[p] = b;
      }
      // a group's bins never decrease over its pods: its run's highest lane
      // holds the run's highest bin
      const Peers q = peers_of(e ? s.gid[p] : -1);
      const int top = __shfl_sync(FULL, b, q.high);
      if (e && q.leads()) atomicMax(&s.nbins[s.gid[p]], top);
    }
    cluster_barrier();
    if (cl.leader() && tid < 32) {
      // a group takes nbins + 1 slots (its highest bin, from 0)
      int run = 0;
      for (int base = 0; base < C; base += 32) {
        const int g = base + lane;
        const int n = g < C && s.gvalid[g] ? s.nbins[g] + 1 : 0;
        const int incl = warp_incl_scan(n);
        if (g < C) s.slotbase[g] = run + incl - n;
        run += __shfl_sync(FULL, incl, 31);
      }
    }
    cluster_barrier();
    // slots beyond C overflow to the repair pass
    for (int base = cl.gt() - lane; base < P; base += cl.nt()) {
      const int p = base + lane;
      bool as = false;
      int sl = -1;
      if (p < P) {
        if (s.elig[p]) {
          sl = s.slotbase[s.gid[p]] + s.binp[p];
          s.slot[p] = sl;
          as = sl < C;
        }
        s.assigned[p] = as;
      }
      claim_members(s, base, as ? sl : -1, as ? s.gid[p] : 0);
    }
    cluster_barrier();
    sec_to(SEC_ROWS);
  }  // mode 0

  // -- 10. claim rows: the owning group's merged template row, pinned to the
  // slot's minted hostname (ffd_core._pin_hostname)
  for (int i = cl.gt(); i < C * K * W; i += cl.nt()) {
    const int c = i / (K * W), kw = i % (K * W);
    if (s.clast[c] < 0) continue;
    const int g = s.g_of_c[c], ci = g * TPL + s.tpick[g];
    int word = s.m_adm[(long)ci * K * W + kw];
    if (a.CH > 0 && kw / W == HOSTNAME_KEY) {
      const int hl = a.host_lane[min(c, a.CH - 1)];
      word &= (kw % W == (hl >> 5)) ? (int)(1u << (hl & 31)) : 0;
    }
    s.r_adm[i] = word;
  }
  for (int i = cl.gt(); i < C * K; i += cl.nt()) {
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
  cluster_barrier();
  for (int i = cl.gt(); i < C * K; i += cl.nt()) {
    const int c = i / K, k = i % K;
    if (s.clast[c] >= 0)
      s.r_neg[i] = negative_polarity_key(s.r_adm + (long)i * W, s.r_comp[i], s.r_gt[i], s.r_lt[i], a.lvw + k * W,
                                         a.ln + (long)k * V, W);
  }
  cluster_barrier();
  sec_to(SEC_LADDER);

  // -- 11. the rounding ladder: each rung demotes the last-assigned pod of
  // every claim the real gate rejects; the final rung demotes whole claims
  for (int rung = 0; rung <= a.n_passes; ++rung) {
    for (int c = cl.gt(); c < C; c += cl.nt()) {
      s.feas[c] = 0;
      s.lastp[c] = -1;
    }
    claim_sums(a, s, cl);  // ends in a cluster barrier
    for (long i = cl.gt(); i < (long)C * T; i += cl.nt()) {
      const int c = (int)(i / T), t = (int)(i % T);
      if (s.clast[c] < 0) continue;
      ++tests;
      if (claim_type_ok(a, s, its, c, t)) s.feas[c] = 1;
    }
    for (int base = cl.gt() - lane; base < P; base += cl.nt()) {
      const int p = base + lane;
      const int sl = p < P && s.assigned[p] ? s.slot[p] : -1;
      const Peers q = peers_of(sl);
      if (sl >= 0 && q.leads()) atomicMax(&s.lastp[sl], base + q.high);
    }
    cluster_barrier();
    for (int p = cl.gt(); p < P; p += cl.nt()) {
      if (!s.assigned[p]) continue;
      const int c = s.slot[p];
      if (!s.feas[c] && (rung == a.n_passes || p == s.lastp[c])) s.assigned[p] = 0;
    }
    cluster_barrier();
  }
  sec_to(SEC_COMMIT);

  // -- 12. commit the surviving claims
  for (int c = cl.gt(); c < C; c += cl.nt()) s.feas[c] = 0;
  claim_sums(a, s, cl);
  for (int base = cl.gt() - lane; base < P; base += cl.nt()) {
    const int p = base + lane;
    const int sl = p < P && s.assigned[p] ? s.slot[p] : -1;
    const Peers q = peers_of(sl);
    if (sl >= 0 && q.leads()) {
      atomicAdd(&s.npods[sl], __popc(q.mask));
      atomicMin(&s.firstp[sl], base + q.low);
    }
  }
  for (long i = cl.gt(); i < (long)C * T; i += cl.nt()) {
    const int c = (int)(i / T), t = (int)(i % T);
    bool ok = false;
    if (s.clast[c] >= 0) {
      ++tests;
      ok = claim_type_ok(a, s, its, c, t);
    }
    a.claim_it_ok[i] = ok;
    if (ok) s.feas[c] = 1;
  }
  cluster_barrier();
  int opened = 0;
  for (int c = cl.gt(); c < C; c += cl.nt()) {
    const bool open = s.npods[c] > 0 && s.feas[c];
    const int j = s.tpick[s.g_of_c[c]];
    s.open[c] = open;
    a.claim_open[c] = open;
    a.claim_npods[c] = open ? s.npods[c] : 0;
    a.claim_tpl[c] = open ? j : 0;
    for (int r = 0; r < R; ++r)
      a.claim_requests[(long)c * R + r] = open ? a.tpl_overhead[(long)j * R + r] + s.sums[(long)c * R + r] : 0.f;
    opened += open;
  }
  if (opened) atomicAdd(&stats0[3], opened);
  cluster_barrier();
  for (long i = cl.gt(); i < (long)C * T; i += cl.nt())
    if (!s.open[i / T]) a.claim_it_ok[i] = 0;
  for (int i = cl.gt(); i < C * K * W; i += cl.nt())
    if (s.open[i / (K * W)]) a.claim_adm[i] = s.r_adm[i];
  for (int i = cl.gt(); i < C * K; i += cl.nt()) {
    if (!s.open[i / K]) continue;
    a.claim_comp[i] = s.r_comp[i];
    a.claim_def[i] = s.r_def[i];
    a.claim_gt[i] = s.r_gt[i];
    a.claim_lt[i] = s.r_lt[i];
  }
  cluster_barrier();
  sec_to(SEC_TOPO);

  // -- 13. topology: an open claim registers its minted hostname lane for
  // every hostname-keyed group, and records its row once per assigned pod
  // that selects a group (ops/topology_kernels.record_delta with an
  // all-select probe; eligible pods own no group)
  if (G > 0) {
    if (a.CH > 0)
      for (int i = cl.gt(); i < C * G; i += cl.nt()) {
        const int c = i / G, g = i % G;
        if (s.open[c] && a.grp_key[g] == HOSTNAME_KEY) a.grp_registered[(long)g * V + a.host_lane[min(c, a.CH - 1)]] = 1;
      }
    const TopoGroups tg = topo_of(a);
    for (int i = cl.gt(); i < C * G; i += cl.nt()) {
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
    cluster_barrier();
    unsigned long long lanes = 0;
    for (long i = cl.gt(); i < (long)G * V; i += cl.nt()) {
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
    lanes = warp_sum(lanes);
    if (lane == 0 && lanes) atomicAdd(cl.lead(&s_work[WORK_RECORD_LANES]), lanes);
  }
  cluster_barrier();
  sec_to(SEC_VERDICT);

  // -- 14. verdicts, residue and stats
  int n_elig = 0, n_placed = 0, n_demoted = 0;
  for (int p = cl.gt(); p < P; p += cl.nt()) {
    const bool as = s.assigned[p];
    a.kind[p] = as ? (p == s.firstp[s.slot[p]] ? KIND_NEW_CLAIM : KIND_CLAIM) : KIND_FAIL;
    a.index[p] = as ? s.slot[p] : -1;
    a.residue[p] = a.pod_active[p] && !as;
    if (s.elig0[p]) {
      ++n_elig;
      if (!as) ++n_demoted;
    }
    if (as) ++n_placed;
  }
  n_elig = warp_sum(n_elig);
  n_placed = warp_sum(n_placed);
  n_demoted = warp_sum(n_demoted);
  tests = warp_sum(tests);
  if (lane == 0) {
    if (n_elig) atomicAdd(&stats0[0], n_elig);
    if (n_placed) atomicAdd(&stats0[1], n_placed);
    if (n_demoted) atomicAdd(&stats0[2], n_demoted);
    if (tests) atomicAdd(cl.lead(&s_work[WORK_TYPE_TESTS]), tests);
  }
  // every block's counts are in the leader's before it writes them out, and
  // no block leaves while another may still reach its shared memory
  cluster_barrier();
  sec_to(SEC_VERDICT);
  if (cl.leader()) {
    if (tid < NSTATS) a.stats[tid] = s_stats[tid];
    if (tid < NWORK) a.work[tid] = s_work[tid];
    if (tid < NSEC) a.sections[tid] = s_sec[tid];
  }
}

__global__ void __launch_bounds__(THREADS, 1) relax_place_kernel(RelaxArgs a, Workspace s) { relax_body(a, s); }

// The lanes mode (program 14's convex phase 1 per partition): cluster c runs
// lane c's whole phase from its own argument struct, with its own workspace
// (carved in each of its blocks), and its own verdicts, state, stats and
// work counters.
__global__ void __launch_bounds__(THREADS, 1) relax_place_lanes_kernel(const RelaxArgs* lanes) {
  __shared__ RelaxArgs a;
  __shared__ Workspace s;
  if (threadIdx.x == 0) {
    a = lanes[blockIdx.x / cluster_blocks()];
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

// Launch one cluster of args->cluster blocks on ``stream``; returns 0 or the
// CUDA error.
extern "C" int relax_place_launch(const RelaxArgs* args, void* stream) {
  Workspace s;
  carve(*args, static_cast<char*>(args->workspace), &s);
  return cluster_launch(relax_place_kernel, args->cluster, args->cluster, THREADS, 0,
                        static_cast<cudaStream_t>(stream), *args, s);
}

// The lanes mode's launch: one RelaxArgs per lane in device memory, each
// with its own workspace of relax_place_workspace_bytes for its dims and the
// launch's cluster. Mirrored by RelaxLanesArgs in
// karpenter_tpu_torch/ops/relax.py.
struct RelaxLanesArgs {
  const RelaxArgs* lanes;  // [L], device memory
  int L, cluster;
};

extern "C" int relax_place_lanes_args_size() { return (int)sizeof(RelaxLanesArgs); }

// L clusters of args->cluster blocks, one per lane; clusters that the card
// cannot hold at once wait for a running one to finish.
extern "C" int relax_place_lanes_launch(const RelaxLanesArgs* args, void* stream) {
  if (args->L <= 0) return 0;
  return cluster_launch(relax_place_lanes_kernel, args->L * args->cluster, args->cluster, THREADS, 0,
                        static_cast<cudaStream_t>(stream), args->lanes);
}
