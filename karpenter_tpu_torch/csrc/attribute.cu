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
// counters count just those gates and tests (padded rows and types ruled
// out before the test are skipped, and not counted). The rows are
// independent; the state (~1 MB at 128 claims x 512 types) is L2-resident.
// So a launch is bound by the operations of those tests, spread over the
// rows.
//
// What the design does about it: one block per row (block-strided when the
// rows outnumber ATTR_MAX_BLOCKS in ops/ffd_step.py), each with its own slot
// of the merged-row scratch; inside a block, the step's own gate code
// (step.cuh bin_gate and group_prep, read-only: no commit, no record) runs a
// warp per bin with the value lanes across the warp, the type halves run
// across the warp's lanes, and each bin's 7-bit fail mask folds into the
// class bytes by block atomics (OR for union and near, AND for blockers).
// Nothing is written but the words and the work counters.
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
  const int* rows;  // [B] pod rows to attribute
  // scratch: one slot of merged rows per block, [NB, N + C + TPL, K, ...]
  int* fin_adm;
  uint8_t* fin_comp;
  uint8_t* fin_def;
  int* fin_gt;
  int* fin_lt;
  uint8_t* fin_neg;
  // outputs
  int* words;                // [B, 3]: union, blockers, near
  unsigned long long* work;  // [NWORK]: WORK_* counters, summed over blocks
  // dims
  int K, V, W, C, N, T, TPL, R, O, PT, D, G, CH, B, NB;
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

struct AttrShared {
  int free_slot;
  int uni[3], blk[3], near[3], present[3];
};

// fold one live candidate's fail mask into its class bytes
__device__ __forceinline__ void fold(AttrShared& as, int cls, int mask) {
  atomicOr(&as.uni[cls], mask);
  atomicAnd(&as.blk[cls], mask);
  if (__popc(mask) == 1) atomicOr(&as.near[cls], mask);
  as.present[cls] = 1;
}

__global__ void __launch_bounds__(THREADS, 1) attribute_kernel(AttrArgs args) {
  __shared__ AttrArgs a;
  __shared__ AttrShared as;
  extern __shared__ int dyn[];
  int* s_gmin = dyn;
  int* s_boot = dyn + args.G;
  int* s_nothing = dyn + 2 * args.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    // this block's slot of the merged-row scratch
    a = args;
    const long bins = (long)args.N + args.C + args.TPL, KW = (long)args.K * args.W;
    a.fin_adm += blockIdx.x * bins * KW;
    a.fin_comp += blockIdx.x * bins * args.K;
    a.fin_def += blockIdx.x * bins * args.K;
    a.fin_gt += blockIdx.x * bins * args.K;
    a.fin_lt += blockIdx.x * bins * args.K;
    a.fin_neg += blockIdx.x * bins * args.K;
  }
  if (tid < NWORK) s_work[tid] = 0;
  __syncthreads();
  const int K = a.K, W = a.W, N = a.N, C = a.C, T = a.T, TPL = a.TPL, R = a.R;
  const ITs its = its_of(a);

  for (int r = blockIdx.x; r < a.B; r += a.NB) {
    const int p = a.rows[r];
    const float* preq = a.pod_requests + (long)p * R;
    const uint8_t* pconf = a.pod_conflict + (long)p * a.PT;
    if (tid == 0) {
      as.free_slot = C;
      for (int c = 0; c < 3; ++c) {
        as.uni[c] = 0;
        as.blk[c] = 0x7f;
        as.near[c] = 0;
        as.present[c] = 0;
      }
    }
    group_prep(lone_block(), a, p, -1, group_mem(s_gmin, s_boot, s_nothing));
    block_sync();
    for (int c = tid; c < C; c += THREADS)
      if (!a.claim_open[c]) atomicMin(&as.free_slot, c);

    // -- existing nodes (padded rows, node_avail -1, are no candidates)
    for (int n = warp; n < N; n += NWARPS) {
      bool live = false;
      for (int x = lane; x < R; x += 32) live |= a.node_avail[(long)n * R + x] >= 0.0f;
      if (!__any_sync(FULL, live)) continue;
      const Row base = row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, n, K, W);
      bool parts[2];
      bin_gate(a, p, base, nullptr, n, nullptr, -1, -1, s_gmin, s_boot, s_nothing, parts);
      if (lane == 0) {
        bool port_ok = true;
        for (int q = 0; q < a.PT; ++q)
          if (a.node_ports[(long)n * a.PT + q] && pconf[q]) port_ok = false;
        bool vol_ok = true;
        for (int d = 0; d < a.D; ++d)
          if (a.node_vol_used[(long)n * a.D + d] + a.pod_vols[(long)p * a.D + d] > a.node_vol_limits[(long)n * a.D + d])
            vol_ok = false;
        const bool fit = fits_add(a.node_requests + (long)n * R, preq, a.node_avail + (long)n * R, R);
        const int mask = (fit ? 0 : FAM_RESOURCES) | (parts[0] ? 0 : FAM_REQUIREMENTS) |
                         (a.pod_tol_node[(long)p * N + n] ? 0 : FAM_TAINTS) | (port_ok ? 0 : FAM_PORTS) |
                         (parts[1] ? 0 : FAM_TOPOLOGY) | (vol_ok ? 0 : FAM_VOLUME);
        fold(as, 0, mask);
      }
    }

    // -- open claims: the type test in its two halves against the narrowed row
    for (int c = warp; c < C; c += NWARPS) {
      if (!a.claim_open[c]) continue;
      const int b = N + c;
      const Row base = row_at(a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, c, K, W);
      bool parts[2];
      bin_gate(a, p, base, nullptr, b, a.wellknown, -1, -1, s_gmin, s_boot, s_nothing, parts);
      const Row fin = fin_row(a, b);
      const uint8_t* fneg = a.fin_neg + (long)b * K;
      bool base_any = false, co_any = false, fit_any = false;
      int tests = 0;
      for (int t = lane; t < T; t += 32) {
        if (!a.claim_it_ok[(long)c * T + t]) continue;
        base_any = true;
        tests += 1;
        const Row it = row_at(its.adm, its.comp, its.def, its.gt, its.lt, t, K, W);
        const bool co = intersects_ok(fin, fneg, it, its.neg + (long)t * K, K, W) &&
                        has_offering(fin.adm, W, its.offer_zone + (long)t * a.O, its.offer_ct + (long)t * a.O,
                                     its.offer_ok + (long)t * a.O, a.O);
        co_any |= co;
        fit_any |= co && fits_add(a.claim_requests + (long)c * R, preq, its.alloc + (long)t * R, R);
      }
      base_any = __any_sync(FULL, base_any);
      co_any = __any_sync(FULL, co_any);
      fit_any = __any_sync(FULL, fit_any);
      tests = warp_sum(tests);
      if (lane == 0) {
        count_work(WORK_TYPE_TESTS, tests);
        bool port_ok = true;
        for (int q = 0; q < a.PT; ++q)
          if (a.claim_ports[(long)c * a.PT + q] && pconf[q]) port_ok = false;
        const bool res = (co_any && !fit_any) || !base_any;
        const bool req = !parts[0] || (base_any && !co_any);
        const int mask = (res ? FAM_RESOURCES : 0) | (req ? FAM_REQUIREMENTS : 0) |
                         (a.pod_tol_tpl[(long)p * TPL + a.claim_tpl[c]] ? 0 : FAM_TAINTS) |
                         (port_ok ? 0 : FAM_PORTS) | (parts[1] ? 0 : FAM_TOPOLOGY);
        fold(as, 1, mask);
      }
    }
    block_sync();

    // -- fresh templates, with the prospective slot's hostname minted, pinned
    // and registered as the step mints it
    const int host = a.CH > 0 ? a.host_lane[min(as.free_slot, a.CH - 1)] : -1;
    group_prep(lone_block(), a, p, host, group_mem(s_gmin, s_boot, s_nothing));
    block_sync();
    for (int j = warp; j < TPL; j += NWARPS) {
      // padded template rows admit no type (ops/padding.py): no candidates
      bool base_any = false;
      for (int t = lane; t < T; t += 32) base_any |= a.tpl_it_ok[(long)j * T + t] != 0;
      if (!__any_sync(FULL, base_any)) continue;
      const int b = N + C + j;
      const Row base = row_at(a.tpl_adm, a.tpl_comp, a.tpl_def, a.tpl_gt, a.tpl_lt, j, K, W);
      bool parts[2];
      bin_gate(a, p, base, a.tpl_neg + (long)j * K, b, a.wellknown, host, host, s_gmin, s_boot, s_nothing, parts);
      const Row fin = fin_row(a, b);
      const uint8_t* fneg = a.fin_neg + (long)b * K;
      bool cap_any = false, co_any = false, fit_any = false;
      int tests = 0;
      for (int t = lane; t < T; t += 32) {
        if (!a.tpl_it_ok[(long)j * T + t] || !within_limits(a, j, t)) continue;
        cap_any = true;
        tests += 1;
        const Row it = row_at(its.adm, its.comp, its.def, its.gt, its.lt, t, K, W);
        const bool co = intersects_ok(fin, fneg, it, its.neg + (long)t * K, K, W) &&
                        has_offering(fin.adm, W, its.offer_zone + (long)t * a.O, its.offer_ct + (long)t * a.O,
                                     its.offer_ok + (long)t * a.O, a.O);
        co_any |= co;
        fit_any |= co && fits_add(a.tpl_overhead + (long)j * R, preq, its.alloc + (long)t * R, R);
      }
      cap_any = __any_sync(FULL, cap_any);
      co_any = __any_sync(FULL, co_any);
      fit_any = __any_sync(FULL, fit_any);
      tests = warp_sum(tests);
      if (lane == 0) {
        count_work(WORK_TYPE_TESTS, tests);
        const bool res = co_any && !fit_any;
        const bool req = !parts[0] || (cap_any && !co_any);
        const int mask = (res ? FAM_RESOURCES : 0) | (req ? FAM_REQUIREMENTS : 0) |
                         (a.pod_tol_tpl[(long)p * TPL + j] ? 0 : FAM_TAINTS) | (parts[1] ? 0 : FAM_TOPOLOGY) |
                         (cap_any ? 0 : FAM_CLAIM_CAPACITY);
        fold(as, 2, mask);
      }
    }
    block_sync();
    if (tid == 0) {
      int w[3] = {0, 0, 0};
      for (int c = 0; c < 3; ++c) {
        const int blk = as.present[c] ? as.blk[c] : EMPTY;
        w[0] |= as.uni[c] << (8 * c);
        w[1] |= blk << (8 * c);
        w[2] |= as.near[c] << (8 * c);
      }
      a.words[(long)r * 3 + 0] = w[0];
      a.words[(long)r * 3 + 1] = w[1];
      a.words[(long)r * 3 + 2] = w[2];
    }
    block_sync();
  }
  if (tid < NWORK) atomicAdd(&a.work[tid], s_work[tid]);
}

}  // namespace

extern "C" int attribute_args_size() { return (int)sizeof(AttrArgs); }

// Launch on ``stream`` (NB blocks walking the B rows); returns
// cudaGetLastError() (0 on success).
extern "C" int attribute_launch(const AttrArgs* args, void* stream) {
  const size_t smem = (size_t)(3 * args->G) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(attribute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    // above the card's opt-in limit: the caller raises KernelDeviceError;
    // clear the error so that it does not surface at a later launch
    if (e != cudaSuccess) return (int)cudaGetLastError();
  }
  if (args->B <= 0) return 0;
  attribute_kernel<<<args->NB, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
