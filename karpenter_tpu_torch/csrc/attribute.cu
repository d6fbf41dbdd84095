// attribute: the explain pass, the gate-family attribution of failed pods.
//
// Replaces the JAX package's device program
//   ops/ffd_step.py:730 _attribute_jit (vmap of _make_attribution :532 over
//   32-row chunks; the chunks exist only for its static shapes)
// and computes, for each pod row of ``rows``, the obs/explain.py wire words
// (union, blockers, near) against the final state of a solve: per candidate
// class (existing nodes, open claims, fresh templates), which gate families
// (resources, requirements, taints, host-ports, topology, claim-capacity,
// volume) failed on some, on every, or alone on one candidate
// (ops/masks.family_bitmask).
//
// What bounds it on an H100: per row, a bin gate (merge + topology) for
// every live node, open claim and template that admits a type, and for every
// type an open claim keeps or a template admits within its limits the
// instance-type survival test split in its compat-and-offer and its fit
// halves (K x W compat words, O offerings, R compares a type). The work
// counters count just the gates and tests the launch needs: the gates of
// the rows it attributes, and for each bin the types in rank order up to the
// first that passes both halves (after it no type can change the bin's
// mask), as a scan in rank order needs them; padded rows and types ruled
// out before the test are not counted. Two more counters count what every
// row and every listed type would be (``entry_gates``,
// ``listed_type_tests``: the work of a launch that attributes every row and
// tests every listed type, as the block-per-row kernel before it counted),
// for comparison only. The rows are
// independent; the state (~1 MB at 128 claims x 512 types) is L2-resident.
// So a launch is bound by the operations of those tests, spread over the
// rows. What holds it back is latency: a gate is a warp's chain of
// dependent loads (the topology gate's group counts, lanes and ranks; the
// merged row written and read back), ~25,000 cycles from L2.
//
// What the design does about it: one persistent block per SM, its 16 warps
// in teams of TW (fewer rows, wider teams: ops/ffd_step.attr_team_warps),
// each team a row at a time from a queue shared by the grid (an atomic
// counter), so that rows of different cost spread over every SM. Each block first copies into its shared memory what every row
// reads (the lane tables, the topology groups' counts and registrations,
// the instance-type tables, as far as they fit: ``plan``); each team copies
// its row's pod words, and each warp keeps the bin's merged row in its own
// shared slot. The step's own gate code (step.cuh bin_gate and group_prep,
// read-only) runs a warp per bin over a view whose pointers lead to those
// copies, so the gate's chain of loads is a chain of shared-memory loads.
// The type halves run across the warp's lanes; each bin's 7-bit fail mask
// folds into the team's class bytes by shared atomics (OR for union and
// near, AND for blockers). Rows whose encoded tensors are byte-identical
// (``pod_eqprev`` runs) give the same words: under the dedup plan
// (ops/ffd_step.attr_row_plan) the launch attributes one row of each such
// set, and the wrapper copies its words to the rest.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (fits
// rounds like the plain version).
#include "step.cuh"

// Field order is mirrored by AttrArgs in karpenter_tpu_torch/ops/ffd_step.py
// (pointers first, then ints); attribute_args_size() lets the wrapper check
// it. The field names the step's gate code reads are FfdArgs'.
struct AttrArgs {
  // vocabulary
  const int* lvw;
  const float* ln;
  const int* lex;
  const uint8_t* wellknown;
  // pods
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
  const uint8_t* pod_conflict;
  const uint8_t* pod_match;
  const uint8_t* pod_selects;
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
  // existing nodes
  const float* node_avail;
  const int* node_vol_limits;
  // topology groups
  const int* grp_type;
  const int* grp_key;
  const int* grp_max_skew;
  const int* grp_min_domains;
  const int* host_lane;
  // the final state (read only)
  const int* claim_adm;
  const uint8_t* claim_comp;
  const uint8_t* claim_def;
  const int* claim_gt;
  const int* claim_lt;
  const float* claim_requests;
  const uint8_t* claim_it_ok;
  const uint8_t* claim_open;
  const int* claim_tpl;
  const uint8_t* claim_ports;
  const int* node_adm;
  const uint8_t* node_comp;
  const uint8_t* node_def;
  const int* node_gt;
  const int* node_lt;
  const float* node_requests;
  const uint8_t* node_ports;
  const int* node_vol_used;
  const float* remaining;
  const int* grp_counts;
  const uint8_t* grp_registered;
  const int* rows;   // [B] pod rows to attribute
  const int* mult;   // [B] the rows each row's words stand for (its own and its copies'; null: 1)
  // outputs
  int* words;                // [B, 3]: union, blockers, near
  unsigned long long* work;  // [NWORK + 2]: WORK_* counters, then AW_*, summed over blocks
  long long* sections;       // [ASEC]: cycles by section, summed over teams
  int* next;                 // [1] the queue's head (zeroed by the launch)
  int* plan;                 // [5] blocks, teams a block; lane, group and type tables resident
  // dims; TW: warps a team (2, 4, 8 or 16)
  int K, V, W, C, N, T, TPL, R, O, PT, D, G, CH, B, NB, TW;
};

namespace {

// family bits of obs/explain.py FAM_*
constexpr int FAM_RESOURCES = 1 << 0;
constexpr int FAM_REQUIREMENTS = 1 << 1;
constexpr int FAM_TAINTS = 1 << 2;
constexpr int FAM_PORTS = 1 << 3;
constexpr int FAM_TOPOLOGY = 1 << 4;
constexpr int FAM_CLAIM_CAPACITY = 1 << 5;
constexpr int FAM_VOLUME = 1 << 6;
constexpr int EMPTY = 1 << 7;


// sections: each team's thread 0 cycles between the team's barriers (summed
// over teams), then the warps' own cycles (lane 0) in each part of a bin
// (ops/ffd_step.ATTR_SECTIONS)
constexpr int ASEC_PREP = 0, ASEC_BINS = 1, ASEC_PREP2 = 2, ASEC_TPLS = 3, ASEC_WORDS = 4;
constexpr int ASEC_NODE_GATE = 5, ASEC_CLAIM_GATE = 6, ASEC_CLAIM_TYPES = 7, ASEC_TPL_GATE = 8, ASEC_TPL_TYPES = 9;
constexpr int ASEC_LOAD = 10;
constexpr int ASEC = 11;
__shared__ unsigned long long s_asec[ASEC];

// the comparison counters after step.cuh's WORK_* (ops/ffd_step.ATTR_WORK_COUNTERS):
// the gates of every entry of ``rows`` (each attributed row's gates times
// ``mult``), and every listed type of every such gate tested
constexpr int AW_ENTRY_GATES = 0, AW_LISTED_TESTS = 1, NAWORK = 2;
__shared__ unsigned long long s_awork[NAWORK];

// What the step's gate code (bin_gate, group_prep) reads, with FfdArgs'
// field names: a view whose pointers lead to the block's and the team's
// shared copies (or to device memory where a table did not fit), the pod
// at row 0 and the merged row at bin 0.
struct AttrView {
  int K, V, W, G;
  const int* lvw;
  const float* ln;
  const int* lex;
  const int* pod_adm;
  const uint8_t* pod_comp;
  const uint8_t* pod_def;
  const int* pod_gt;
  const int* pod_lt;
  const uint8_t* pod_neg;
  const int* pod_strict_adm;
  const uint8_t* pod_match;
  const uint8_t* pod_selects;
  const int* grp_type;
  const int* grp_key;
  const int* grp_max_skew;
  const int* grp_min_domains;
  const int* grp_counts;
  const uint8_t* grp_registered;
  int* fin_adm;
  uint8_t* fin_comp;
  uint8_t* fin_def;
  int* fin_gt;
  int* fin_lt;
  uint8_t* fin_neg;
};

// One team's shared state: its row (the pod's words), the per-group
// quantities of group_prep, the class bytes it folds into.
struct Team {
  int* adm;  // [K * W]
  int* strict;
  int* gt;  // [K]
  int* lt;
  uint8_t* comp;  // [K]
  uint8_t* def;
  uint8_t* neg;
  uint8_t* match;  // [G]
  uint8_t* selects;
  float* req;  // [R]
  int* gmin;   // [G]
  int* boot;
  int* nothing;
  int* mg;  // [G] the row's matched groups in group order, and their keys
  int* mk;
  int* s;   // [16]: entry, -, matched groups, gates, then uni[3], blk[3], near[3], present[3]
};

// The team's barrier (a named barrier per team: bar 0 is __syncthreads).
__device__ __forceinline__ void team_sync(int team, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(threads) : "memory");
}

// A team's warps as the scope of group_prep: a block alone whose warps are
// the team's.
struct TeamScope {
  int rank, size, tw, n;
  __device__ __forceinline__ int gwarp() const { return tw; }
  __device__ __forceinline__ int nwarps() const { return n; }
  template <class T>
  __device__ __forceinline__ T* at(T* p, int) const {
    return p;
  }
};

// fold one live candidate's fail mask into its class bytes
__device__ __forceinline__ void fold(int* s, int cls, int mask) {
  atomicOr(&s[4 + cls], mask);
  atomicAnd(&s[7 + cls], mask);
  if (__popc(mask) == 1) atomicOr(&s[10 + cls], mask);
  s[13 + cls] = 1;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// The tests a chunk of 32 types needs, scanned in rank order: its tested
// types (``tested``, a ballot) up to the first that passes both halves
// (``fit``), or all of them when none does.
__device__ __forceinline__ int needed_tests(unsigned tested, unsigned fit) {
  return __popc(fit ? tested & ((2u << (__ffs(fit) - 1)) - 1u) : tested);
}

// The bytes of the block-wide tables: the lanes and groups' scalars (always
// in shared memory), the groups' counts and registrations, the type tables.
struct Sizes {
  size_t base, lanes, groups, types, teams;
};

// One team's area, in the kernel's carve order: the row (adm, strict, gt,
// lt, comp, def, neg, match, selects, requests), gmin, boot, nothing, the
// matched groups and their keys, the scalars; then each warp's merged row (adm, gt, lt, comp, def, neg), view
// and bin slot (the bin's row: adm, gt, lt, comp, def; its listed types;
// its requests).
__host__ __device__ inline size_t team_bytes(const AttrArgs& a) {
  const size_t K = a.K, W = a.W, G = a.G, R = a.R;
  const size_t row = 2 * align16(4 * K * W) + 2 * align16(4 * K) + 3 * align16(K) + 2 * align16(G) +
                     align16(4 * R) + 5 * align16(4 * G) + align16(4 * 16);
  const size_t fin = align16(4 * K * W) + 2 * align16(4 * K) + 3 * align16(K) + align16(sizeof(AttrView));
  const size_t base = align16(4 * K * W) + 2 * align16(4 * K) + 2 * align16(K) + align16(a.T) + align16(4 * R);
  return row + (size_t)a.TW * (fin + base);
}

// The block-wide tables in the kernel's carve order: the lane words and the
// groups' scalars (always in shared memory), the lanes' values and ranks,
// the groups' counts and registrations, the type tables (each set where it
// fits, in that order).
__host__ __device__ inline Sizes sizes_of(const AttrArgs& a) {
  const size_t K = a.K, V = a.V, W = a.W, G = a.G, T = a.T, R = a.R, O = a.O;
  Sizes z;
  z.base = align16(4 * K * W) + 4 * align16(4 * G);
  z.lanes = 2 * align16(4 * K * V);
  z.groups = align16(4 * G * V) + align16(G * V);
  z.types = align16(4 * T * K * W) + 2 * align16(4 * T * K) + 3 * align16(T * K) + 2 * align16(4 * T * R) +
            2 * align16(4 * T * O) + align16(T * O);
  z.teams = (size_t)(NWARPS / a.TW) * team_bytes(a);
  return z;
}

__device__ __forceinline__ char* take(char*& at, size_t bytes) {
  char* p = at;
  at += align16(bytes);
  return p;
}

// copy ``bytes`` from global to shared, 16 bytes a thread where both are aligned
__device__ void copy_in(void* dst, const void* src, size_t bytes) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const size_t n16 = bytes / 16;
    for (size_t i = threadIdx.x; i < n16; i += THREADS)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    for (size_t i = n16 * 16 + threadIdx.x; i < bytes; i += THREADS)
      static_cast<char*>(dst)[i] = static_cast<const char*>(src)[i];
  } else {
    for (size_t i = threadIdx.x; i < bytes; i += THREADS) static_cast<char*>(dst)[i] = static_cast<const char*>(src)[i];
  }
}

// A warp's bin slot: the bin's row, its listed types, its requests (or a
// template's remaining headroom), staged in shared memory before the gate.
struct Slot {
  int* adm;
  int* gt;
  int* lt;
  uint8_t* comp;
  uint8_t* def;
  uint8_t* listed;
  float* req;
};

// The warp copies row e of a requirement table into its slot (after the
// previous bin's last read of it) and returns the slot's row; the caller
// __syncwarp()s before the row is read.
__device__ __forceinline__ Row stage_row(const Slot& sl, const int* adm, const uint8_t* comp, const uint8_t* def,
                                         const int* gt, const int* lt, long e, int K, int W) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int i = lane; i < K * W; i += 32) sl.adm[i] = adm[e * K * W + i];
  for (int k = lane; k < K; k += 32) {
    sl.gt[k] = gt[e * K + k];
    sl.lt[k] = lt[e * K + k];
    sl.comp[k] = comp[e * K + k];
    sl.def[k] = def[e * K + k];
  }
  return row_at(sl.adm, sl.comp, sl.def, sl.gt, sl.lt, 0, K, W);
}

// The warp copies n bytes, 16 at a time where both ends allow it.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src, int n) {
  const int lane = threadIdx.x & 31;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    for (int i = lane; i < n / 16; i += 32) reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    for (int i = n / 16 * 16 + lane; i < n; i += 32) dst[i] = src[i];
  } else {
    for (int i = lane; i < n; i += 32) dst[i] = src[i];
  }
}

template <class T>
__device__ __forceinline__ const T* resident(char*& at, const T* src, size_t count, bool on) {
  if (!on) return src;
  T* dst = reinterpret_cast<T*>(take(at, sizeof(T) * count));
  copy_in(dst, src, sizeof(T) * count);
  return dst;
}

__global__ void __launch_bounds__(THREADS, 1) attribute_kernel(AttrArgs a, int lanes_on, int groups_on, int types_on) {
  extern __shared__ __align__(16) char dyn[];
  __shared__ ITs s_its;
  __shared__ int s_host, s_free;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TW = a.TW, TT = 32 * TW;
  const int team = warp / TW, tw = warp % TW, ttid = tid % TT;
  const int K = a.K, W = a.W, V = a.V, G = a.G, N = a.N, C = a.C, T = a.T, TPL = a.TPL, R = a.R;
  const long long t_load = clock64();
  if (blockIdx.x == 0 && tid == 0) {
    a.plan[0] = gridDim.x;
    a.plan[1] = NWARPS / TW;
    a.plan[2] = lanes_on;
    a.plan[3] = groups_on;
    a.plan[4] = types_on;
  }
  if (tid < NWORK) s_work[tid] = 0;
  if (tid < NAWORK) s_awork[tid] = 0;
  if (tid < ASEC) s_asec[tid] = 0;
  if (tid == 0) s_free = C;
  __syncthreads();
  for (int c = tid; c < C; c += THREADS)
    if (!a.claim_open[c]) atomicMin(&s_free, c);

  // the block-wide tables, as far as they fit (the launch's plan)
  char* at = dyn;
  const int* lvw = resident(at, a.lvw, (size_t)K * W, true);
  const int* grp_type = resident(at, a.grp_type, G, true);
  const int* grp_key = resident(at, a.grp_key, G, true);
  const int* grp_max_skew = resident(at, a.grp_max_skew, G, true);
  const int* grp_min_domains = resident(at, a.grp_min_domains, G, true);
  const float* ln = resident(at, a.ln, (size_t)K * V, lanes_on);
  const int* lex = resident(at, a.lex, (size_t)K * V, lanes_on);
  const int* grp_counts = resident(at, a.grp_counts, (size_t)G * V, groups_on);
  const uint8_t* grp_registered = resident(at, a.grp_registered, (size_t)G * V, groups_on);
  const float* it_cap;
  {
    const int* adm = resident(at, a.it_adm, (size_t)T * K * W, types_on);
    const int* gt = resident(at, a.it_gt, (size_t)T * K, types_on);
    const int* lt = resident(at, a.it_lt, (size_t)T * K, types_on);
    const uint8_t* comp = resident(at, a.it_comp, (size_t)T * K, types_on);
    const uint8_t* def = resident(at, a.it_def, (size_t)T * K, types_on);
    const uint8_t* neg = resident(at, a.it_neg, (size_t)T * K, types_on);
    const float* alloc = resident(at, a.it_alloc, (size_t)T * R, types_on);
    it_cap = resident(at, a.it_cap, (size_t)T * R, types_on);
    const int* zone = resident(at, a.offer_zone, (size_t)T * a.O, types_on);
    const int* ct = resident(at, a.offer_ct, (size_t)T * a.O, types_on);
    const uint8_t* ok = resident(at, a.offer_ok, (size_t)T * a.O, types_on);
    if (tid == 0) {
      s_its.adm = adm;
      s_its.gt = gt;
      s_its.lt = lt;
      s_its.comp = comp;
      s_its.def = def;
      s_its.neg = neg;
      s_its.alloc = alloc;
      s_its.offer_zone = zone;
      s_its.offer_ct = ct;
      s_its.offer_ok = ok;
    }
  }
  // this team's row, group quantities and class bytes; each warp's merged row
  at += (size_t)team * team_bytes(a);
  Team tm;
  tm.adm = reinterpret_cast<int*>(take(at, 4 * K * W));
  tm.strict = reinterpret_cast<int*>(take(at, 4 * K * W));
  tm.gt = reinterpret_cast<int*>(take(at, 4 * K));
  tm.lt = reinterpret_cast<int*>(take(at, 4 * K));
  tm.comp = reinterpret_cast<uint8_t*>(take(at, K));
  tm.def = reinterpret_cast<uint8_t*>(take(at, K));
  tm.neg = reinterpret_cast<uint8_t*>(take(at, K));
  tm.match = reinterpret_cast<uint8_t*>(take(at, G));
  tm.selects = reinterpret_cast<uint8_t*>(take(at, G));
  tm.req = reinterpret_cast<float*>(take(at, 4 * R));
  tm.gmin = reinterpret_cast<int*>(take(at, 4 * G));
  tm.boot = reinterpret_cast<int*>(take(at, 4 * G));
  tm.nothing = reinterpret_cast<int*>(take(at, 4 * G));
  tm.mg = reinterpret_cast<int*>(take(at, 4 * G));
  tm.mk = reinterpret_cast<int*>(take(at, 4 * G));
  tm.s = reinterpret_cast<int*>(take(at, 4 * 16));
  AttrView* view = nullptr;
  Slot slot{};
  for (int w = 0; w < TW; ++w) {
    int* fadm = reinterpret_cast<int*>(take(at, 4 * K * W));
    int* fgt = reinterpret_cast<int*>(take(at, 4 * K));
    int* flt = reinterpret_cast<int*>(take(at, 4 * K));
    uint8_t* fcomp = reinterpret_cast<uint8_t*>(take(at, K));
    uint8_t* fdef = reinterpret_cast<uint8_t*>(take(at, K));
    uint8_t* fneg = reinterpret_cast<uint8_t*>(take(at, K));
    AttrView* v = reinterpret_cast<AttrView*>(take(at, sizeof(AttrView)));
    Slot sl;
    sl.adm = reinterpret_cast<int*>(take(at, 4 * K * W));
    sl.gt = reinterpret_cast<int*>(take(at, 4 * K));
    sl.lt = reinterpret_cast<int*>(take(at, 4 * K));
    sl.comp = reinterpret_cast<uint8_t*>(take(at, K));
    sl.def = reinterpret_cast<uint8_t*>(take(at, K));
    sl.listed = reinterpret_cast<uint8_t*>(take(at, T));
    sl.req = reinterpret_cast<float*>(take(at, 4 * R));
    if (w == tw) {
      slot = sl;
      view = v;
      if (lane == 0) {
        v->K = K, v->V = V, v->W = W, v->G = G;
        v->lvw = lvw, v->ln = ln, v->lex = lex;
        v->pod_adm = tm.adm, v->pod_comp = tm.comp, v->pod_def = tm.def, v->pod_gt = tm.gt, v->pod_lt = tm.lt;
        v->pod_neg = tm.neg, v->pod_strict_adm = tm.strict, v->pod_match = tm.match, v->pod_selects = tm.selects;
        v->grp_type = grp_type, v->grp_key = grp_key, v->grp_max_skew = grp_max_skew;
        v->grp_min_domains = grp_min_domains, v->grp_counts = grp_counts, v->grp_registered = grp_registered;
        v->fin_adm = fadm, v->fin_comp = fcomp, v->fin_def = fdef, v->fin_gt = fgt, v->fin_lt = flt;
        v->fin_neg = fneg;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    s_host = a.CH > 0 ? a.host_lane[min(s_free, a.CH - 1)] : -1;
    s_asec[ASEC_LOAD] += (unsigned long long)(clock64() - t_load);
  }
  __syncthreads();
  const AttrView& v = *view;
  const ITs& its = s_its;
  const int host = s_host;
  const TeamScope tsc{0, 1, tw, TW};
  const StepMem gm = group_mem(tm.gmin, tm.boot, tm.nothing);
  // the gates read the row's matched groups from its list (step.cuh's LIST
  // path), the group count in s[2]
  StepMem gl = gm;
  gl.mg = tm.mg;
  gl.mk = tm.mk;
  gl.nm = tm.s + 2;
  const Row prow = row_at(tm.adm, tm.comp, tm.def, tm.gt, tm.lt, 0, K, W);
  const Row fin = row_at(v.fin_adm, v.fin_comp, v.fin_def, v.fin_gt, v.fin_lt, 0, K, W);
  int* s = tm.s;
  long long mark = clock64();
  auto amark = [&](int sec) {
    if (ttid == 0) {
      const long long now = clock64();
      atomicAdd(&s_asec[sec], (unsigned long long)(now - mark));
      mark = now;
    }
  };

  for (;;) {
    if (ttid == 0) {
      const int i = atomicAdd(a.next, 1);
      s[0] = i < a.B ? i : -1;
    }
    team_sync(team, TT);
    const int entry = s[0];
    if (entry < 0) break;
    const int p = a.rows[entry];
    // the team's copy of the row
    for (int i = ttid; i < K * W; i += TT) {
      tm.adm[i] = a.pod_adm[(long)p * K * W + i];
      tm.strict[i] = a.pod_strict_adm[(long)p * K * W + i];
    }
    for (int k = ttid; k < K; k += TT) {
      tm.gt[k] = a.pod_gt[(long)p * K + k];
      tm.lt[k] = a.pod_lt[(long)p * K + k];
      tm.comp[k] = a.pod_comp[(long)p * K + k];
      tm.def[k] = a.pod_def[(long)p * K + k];
      tm.neg[k] = a.pod_neg[(long)p * K + k];
    }
    for (int g = ttid; g < G; g += TT) {
      tm.match[g] = a.pod_match[(long)p * G + g];
      tm.selects[g] = a.pod_selects[(long)p * G + g];
    }
    for (int r = ttid; r < R; r += TT) tm.req[r] = a.pod_requests[(long)p * R + r];
    if (ttid < 3) {
      s[4 + ttid] = 0;      // union
      s[7 + ttid] = 0x7f;   // blockers
      s[10 + ttid] = 0;     // near
      s[13 + ttid] = 0;     // present
    }
    if (ttid == 0) s[2] = 0, s[3] = 0;
    team_sync(team, TT);
    if (tw == 0) {
      // the row's matched groups in group order (group_prep's list, by this
      // team's first warp)
      int nm = 0;
      for (int g0 = 0; g0 < G; g0 += 32) {
        const int g = g0 + lane;
        const bool on = g < G && tm.match[g];
        const unsigned word = __ballot_sync(FULL, on);
        if (on) {
          const int at_ = nm + __popc(word & ((1u << lane) - 1u));
          tm.mg[at_] = g;
          tm.mk[at_] = grp_key[g];
        }
        nm += __popc(word);
      }
      if (lane == 0) s[2] = nm;
    }
    group_prep(tsc, v, 0, -1, gm);
    team_sync(team, TT);
    amark(ASEC_PREP);
    const uint8_t* pconf = a.pod_conflict + (long)p * a.PT;
    int gates = 0;

    // -- existing nodes (padded rows, node_avail -1, are no candidates), then
    // the open claims: the type test in its two halves against the merged row
    for (int item = tw; item < N + C; item += TW) {
      if (item < N) {
        const int n = item;
        bool live = false;
        for (int x = lane; x < R; x += 32) live |= a.node_avail[(long)n * R + x] >= 0.0f;
        if (!__any_sync(FULL, live)) continue;
        const long long w0 = clock64();
        const Row base = stage_row(slot, a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, n, K, W);
        __syncwarp();
        bool parts[2];
        bin_gate<true>(v, 0, base, nullptr, 0, nullptr, -1, -1, tm.gmin, tm.boot, tm.nothing, parts, &gl);
        gates += 1;
        if (lane == 0) {
          atomicAdd(&s_asec[ASEC_NODE_GATE], (unsigned long long)(clock64() - w0));
          bool port_ok = true;
          for (int q = 0; q < a.PT; ++q)
            if (a.node_ports[(long)n * a.PT + q] && pconf[q]) port_ok = false;
          bool vol_ok = true;
          for (int d = 0; d < a.D; ++d)
            if (a.node_vol_used[(long)n * a.D + d] + a.pod_vols[(long)p * a.D + d] >
                a.node_vol_limits[(long)n * a.D + d])
              vol_ok = false;
          const bool fit = fits_add(a.node_requests + (long)n * R, tm.req, a.node_avail + (long)n * R, R);
          const int mask = (fit ? 0 : FAM_RESOURCES) | (parts[0] ? 0 : FAM_REQUIREMENTS) |
                           (a.pod_tol_node[(long)p * N + n] ? 0 : FAM_TAINTS) | (port_ok ? 0 : FAM_PORTS) |
                           (parts[1] ? 0 : FAM_TOPOLOGY) | (vol_ok ? 0 : FAM_VOLUME);
          fold(s, 0, mask);
        }
        continue;
      }
      const int c = item - N;
      if (!a.claim_open[c]) continue;
      const long long w0 = clock64();
      const Row base = stage_row(slot, a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, c, K, W);
      stage_bytes(slot.listed, a.claim_it_ok + (long)c * T, T);
      for (int r = lane; r < R; r += 32) slot.req[r] = a.claim_requests[(long)c * R + r];
      __syncwarp();
      bool parts[2];
      bin_gate<true>(v, 0, base, nullptr, 0, a.wellknown, -1, -1, tm.gmin, tm.boot, tm.nothing, parts, &gl);
      gates += 1;
      const long long w1 = clock64();
      // once some type passes both halves, no other can change the claim's
      // mask, so the warp stops testing (the words are the same)
      bool base_any = false, co_any = false, fit_any = false;
      int tests = 0, listed_n = 0;
      for (int t0 = 0; t0 < T; t0 += 32) {
        const int t = t0 + lane;
        const bool listed = t < T && slot.listed[t];
        listed_n += listed;
        base_any |= listed;
        if (__any_sync(FULL, fit_any)) continue;
        bool co = false, fit = false;
        if (listed) {
          const Row it = row_at(its.adm, its.comp, its.def, its.gt, its.lt, t, K, W);
          co = intersects_ok(fin, v.fin_neg, it, its.neg + (long)t * K, K, W) &&
               has_offering(fin.adm, W, its.offer_zone + (long)t * a.O, its.offer_ct + (long)t * a.O,
                            its.offer_ok + (long)t * a.O, a.O);
          fit = co && fits_add(slot.req, tm.req, its.alloc + (long)t * R, R);
        }
        co_any |= co;
        fit_any |= fit;
        tests += needed_tests(__ballot_sync(FULL, listed), __ballot_sync(FULL, fit));
      }
      base_any = __any_sync(FULL, base_any);
      co_any = __any_sync(FULL, co_any);
      fit_any = __any_sync(FULL, fit_any);
      listed_n = warp_sum(listed_n);
      if (lane == 0) {
        atomicAdd(&s_asec[ASEC_CLAIM_GATE], (unsigned long long)(w1 - w0));
        atomicAdd(&s_asec[ASEC_CLAIM_TYPES], (unsigned long long)(clock64() - w1));
        count_work(WORK_TYPE_TESTS, tests);
        atomicAdd(&s_awork[AW_LISTED_TESTS], (unsigned long long)listed_n * (a.mult ? a.mult[entry] : 1));
        bool port_ok = true;
        for (int q = 0; q < a.PT; ++q)
          if (a.claim_ports[(long)c * a.PT + q] && pconf[q]) port_ok = false;
        const bool res = (co_any && !fit_any) || !base_any;
        const bool req = !parts[0] || (base_any && !co_any);
        const int mask = (res ? FAM_RESOURCES : 0) | (req ? FAM_REQUIREMENTS : 0) |
                         (a.pod_tol_tpl[(long)p * TPL + a.claim_tpl[c]] ? 0 : FAM_TAINTS) |
                         (port_ok ? 0 : FAM_PORTS) | (parts[1] ? 0 : FAM_TOPOLOGY);
        fold(s, 1, mask);
      }
    }
    team_sync(team, TT);
    amark(ASEC_BINS);

    // -- fresh templates, with the prospective slot's hostname minted, pinned
    // and registered as the step mints it
    group_prep(tsc, v, 0, host, gm);
    team_sync(team, TT);
    amark(ASEC_PREP2);
    for (int j = tw; j < TPL; j += TW) {
      // padded template rows admit no type (ops/padding.py): no candidates
      bool base_any = false;
      for (int t = lane; t < T; t += 32) base_any |= a.tpl_it_ok[(long)j * T + t] != 0;
      if (!__any_sync(FULL, base_any)) continue;
      const long long w0 = clock64();
      const Row base = stage_row(slot, a.tpl_adm, a.tpl_comp, a.tpl_def, a.tpl_gt, a.tpl_lt, j, K, W);
      stage_bytes(slot.listed, a.tpl_it_ok + (long)j * T, T);
      for (int r = lane; r < R; r += 32) slot.req[r] = a.remaining[(long)j * R + r];
      __syncwarp();
      bool parts[2];
      bin_gate<true>(v, 0, base, a.tpl_neg + (long)j * K, 0, a.wellknown, host, host, tm.gmin, tm.boot,
                     tm.nothing, parts, &gl);
      gates += 1;
      const long long w1 = clock64();
      // as the claims' loop over the types within the limits: the testing
      // stops once some type passes both halves
      bool cap_any = false, co_any = false, fit_any = false;
      int tests = 0, listed_n = 0;
      for (int t0 = 0; t0 < T; t0 += 32) {
        const int t = t0 + lane;
        const bool cap = t < T && slot.listed[t] && fits_add(it_cap + (long)t * R, nullptr, slot.req, R);
        listed_n += cap;
        cap_any |= cap;
        if (__any_sync(FULL, fit_any)) continue;
        bool co = false, fit = false;
        if (cap) {
          const Row it = row_at(its.adm, its.comp, its.def, its.gt, its.lt, t, K, W);
          co = intersects_ok(fin, v.fin_neg, it, its.neg + (long)t * K, K, W) &&
               has_offering(fin.adm, W, its.offer_zone + (long)t * a.O, its.offer_ct + (long)t * a.O,
                            its.offer_ok + (long)t * a.O, a.O);
          fit = co && fits_add(a.tpl_overhead + (long)j * R, tm.req, its.alloc + (long)t * R, R);
        }
        co_any |= co;
        fit_any |= fit;
        tests += needed_tests(__ballot_sync(FULL, cap), __ballot_sync(FULL, fit));
      }
      cap_any = __any_sync(FULL, cap_any);
      co_any = __any_sync(FULL, co_any);
      fit_any = __any_sync(FULL, fit_any);
      listed_n = warp_sum(listed_n);
      if (lane == 0) {
        atomicAdd(&s_asec[ASEC_TPL_GATE], (unsigned long long)(w1 - w0));
        atomicAdd(&s_asec[ASEC_TPL_TYPES], (unsigned long long)(clock64() - w1));
        count_work(WORK_TYPE_TESTS, tests);
        atomicAdd(&s_awork[AW_LISTED_TESTS], (unsigned long long)listed_n * (a.mult ? a.mult[entry] : 1));
        const bool res = co_any && !fit_any;
        const bool req = !parts[0] || (cap_any && !co_any);
        const int mask = (res ? FAM_RESOURCES : 0) | (req ? FAM_REQUIREMENTS : 0) |
                         (a.pod_tol_tpl[(long)p * TPL + j] ? 0 : FAM_TAINTS) | (parts[1] ? 0 : FAM_TOPOLOGY) |
                         (cap_any ? 0 : FAM_CLAIM_CAPACITY);
        fold(s, 2, mask);
      }
    }
    if (lane == 0 && gates) atomicAdd(&s[3], gates);
    team_sync(team, TT);
    amark(ASEC_TPLS);
    if (ttid == 0) {
      int w[3] = {0, 0, 0};
      for (int c = 0; c < 3; ++c) {
        const int blk = s[13 + c] ? s[7 + c] : EMPTY;
        w[0] |= s[4 + c] << (8 * c);
        w[1] |= blk << (8 * c);
        w[2] |= s[10 + c] << (8 * c);
      }
      a.words[(long)entry * 3 + 0] = w[0];
      a.words[(long)entry * 3 + 1] = w[1];
      a.words[(long)entry * 3 + 2] = w[2];
      // the gates of the entries that take these words
      atomicAdd(&s_awork[AW_ENTRY_GATES], (unsigned long long)s[3] * (a.mult ? a.mult[entry] : 1));
      count_work(WORK_BARRIERS, 6);  // the team's barriers a row
    }
    amark(ASEC_WORDS);
  }
  __syncthreads();
  if (tid < NWORK) atomicAdd(&a.work[tid], s_work[tid]);
  if (tid < NAWORK) atomicAdd(&a.work[NWORK + tid], s_awork[tid]);
  if (tid < ASEC) atomicAdd(reinterpret_cast<unsigned long long*>(&a.sections[tid]), s_asec[tid]);
}

}  // namespace

extern "C" int attribute_args_size() { return (int)sizeof(AttrArgs); }

// Launch on ``stream`` (NB persistent blocks over the queue of B entries):
// the block-wide tables each in shared memory where they fit beside the
// teams' areas (the kernel writes this plan to ``args->plan``). Returns
// cudaGetLastError() (0 on success); a shape whose teams' areas alone exceed
// what a block may opt into is refused (the caller raises KernelDeviceError).
extern "C" int attribute_launch(const AttrArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // the kernel's static shared memory (step.cuh's work counters, this file's
  // sections and type-table pointers) stays out of the dynamic budget
  const size_t budget = optin > 4096 ? (size_t)optin - 4096 : 0;
  if (args->TW < 2 || args->TW > NWARPS || NWARPS % args->TW) return (int)cudaErrorInvalidValue;
  const Sizes z = sizes_of(*args);
  size_t smem = z.base + z.teams;
  int lanes_on = 0, groups_on = 0, types_on = 0;
  if (smem + z.lanes <= budget) {
    smem += z.lanes;
    lanes_on = 1;
  }
  if (smem + z.groups <= budget) {
    smem += z.groups;
    groups_on = 1;
  }
  if (smem + z.types <= budget) {
    smem += z.types;
    types_on = 1;
  }
  cudaError_t e = cudaFuncSetAttribute(attribute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // above the card's opt-in limit: the caller raises KernelDeviceError;
  // clear the error so that it does not surface at a later launch
  if (e != cudaSuccess) return (int)cudaGetLastError();
  if (args->B <= 0) return 0;
  e = cudaMemsetAsync(args->next, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)cudaGetLastError();
  attribute_kernel<<<args->NB, THREADS, smem, st>>>(*args, lanes_on, groups_on, types_on);
  return (int)cudaGetLastError();
}
