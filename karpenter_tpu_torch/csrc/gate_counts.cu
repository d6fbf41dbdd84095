// gate_counts: the seven placement invariants of one solve result as
// violation counts.
//
// Replaces the JAX package's device program verify/device.py:259 _gate_jit
// (_gate_impl :134). Same inputs (the padded problem the solve consumed plus
// the decoded result as a flat pod -> bin assignment) and the same int32[7]
// output, in verify/device.INVARIANTS order:
//   0 claim-requests  1 claim-capacity  2 instance-type-survivor
//   3 taint-admissibility  4 host-port  5 requirement-intersection
//   6 node-capacity
//
// What bounds it on an H100: one pass over the pod rows (requests, ports,
// requirement words) plus the claims x instance-types survivor test; at
// 10k pods x 128 claims x 512 types that is a few MB read once, so it is
// launch- and latency-bound, far from the card's memory rate.
//
// What the design does about it: two launches in one wrapper call. gate_scatter
// (a grid over pods) accumulates the per-bin sums with atomicAdd; gate_check
// (one grid: pod blocks, then one block per claim, then node blocks) tests
// every predicate in parallel and atomically bumps the counts. The float
// atomics sum in run-dependent order; the rounding (~1e-6 relative) is far
// below the claim-requests tolerance (1e-4 relative), so the integer counts
// equal the plain version's. It shares masks.cuh with the loop kernel, so
// the survivor test is the same instance-type gate the solve applied.
//
// Fused mode (the epilogue of the JAX package's ops/fused.py:302
// _solve_ffd_fused_gate_jit, fused_gate_counts :271): ``pod_bin`` is null
// and the launch reads ffd_loop's final state where the loop left it, with
// no host step between the two launches. Each pod's bin comes from the
// loop's kind/index (a claim slot on KIND_CLAIM / KIND_NEW_CLAIM, C + node
// on KIND_NODE, else unplaced); the claim rows are the loop's own packed
// state rows (the minted hostname pin included), active and with
// requirements where the claim is open, reported requests the claim's
// accumulated requests, listed types its surviving types. The claim rows'
// polarity, which the unfused wrapper computes on the host side, is
// computed by gate_scatter's extra blocks into ``neg_out`` (= claim_neg).
#include <cuda_runtime.h>

#include "masks.cuh"

using namespace kt;

// Field order is mirrored by GateArgs in karpenter_tpu_torch/verify/device.py.
struct GateKernelArgs {
  const int* lvw;
  const float* ln;
  // pods
  const int* pod_adm;
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
  // instance types
  const int* it_adm;
  const uint8_t* it_comp;
  const uint8_t* it_def;
  const int* it_gt;
  const int* it_lt;
  const uint8_t* it_neg;
  const float* it_alloc;
  const int* offer_zone;
  const int* offer_ct;
  const uint8_t* offer_ok;
  const float* tpl_overhead;  // [TPL, R]
  // existing nodes
  const int* node_adm;
  const uint8_t* node_comp;
  const uint8_t* node_def;
  const int* node_gt;
  const int* node_lt;
  const uint8_t* node_neg;
  const float* node_avail;
  const float* node_overhead;
  const uint8_t* node_used_ports;
  // the result under test
  const int* claim_adm;
  const uint8_t* claim_comp;
  const uint8_t* claim_def;
  const int* claim_gt;
  const int* claim_lt;
  const uint8_t* claim_neg;
  const int* claim_tpl;
  const uint8_t* claim_active;
  const float* claim_reported;  // [C, R]
  const uint8_t* claim_its;     // [C, T]
  const uint8_t* claim_has_reqs;
  const int* pod_bin;  // [P]; null in fused mode
  const uint8_t* pod_check;
  // fused mode: ffd_loop's verdict rows, from which each pod's bin derives
  const int* kind;   // [P]
  const int* index;  // [P]
  // scratch (zeroed by the wrapper) and output
  float* summed;  // [C, R]
  float* nsum;    // [N, R]
  int* ngot;      // [N]
  int* port_cnt;  // [C + N, PT]
  uint8_t* neg_out;  // [C, K] fused mode: the claim rows' polarity (claim_neg points here)
  int* counts;    // [7]
  int P, K, W, T, TPL, C, N, R, O, PT;
};

namespace {

constexpr int THREADS = 256;
constexpr float ABS_TOL = 1e-6f;
constexpr float REL_TOL = 1e-4f;
// ffd_loop's verdict kinds (ops/ffd_core.py KIND_*)
constexpr int KIND_NODE = 0;
constexpr int KIND_CLAIM = 1;
constexpr int KIND_NEW_CLAIM = 2;

// The bin of pod row p: claim slot 0..C-1, node C..C+N-1, or -1.
__device__ __forceinline__ int bin_of(const GateKernelArgs& a, int p) {
  if (a.pod_bin) return a.pod_bin[p];
  const int kind = a.kind[p];
  if (kind == KIND_CLAIM || kind == KIND_NEW_CLAIM) return a.index[p];
  if (kind == KIND_NODE) return a.C + a.index[p];
  return -1;
}

// Blocks past the pod blocks (fused mode only): one thread per claim key.
__device__ void claim_polarity(const GateKernelArgs& a, int e) {
  if (e >= a.C * a.K) return;
  const int k = e % a.K;
  a.neg_out[e] = negative_polarity_key(a.claim_adm + (long)e * a.W, a.claim_comp[e], a.claim_gt[e],
                                       a.claim_lt[e], a.lvw + (long)k * a.W, a.ln + (long)k * 32 * a.W,
                                       a.W) ? 1 : 0;
}

__global__ void gate_scatter(GateKernelArgs a, int pod_blocks) {
  if ((int)blockIdx.x >= pod_blocks) {
    claim_polarity(a, (blockIdx.x - pod_blocks) * blockDim.x + threadIdx.x);
    return;
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.P) return;
  const int b = bin_of(a, p);
  if (b < 0 || b >= a.C + a.N) return;
  const float* req = a.pod_requests + (long)p * a.R;
  if (b < a.C) {
    for (int r = 0; r < a.R; ++r) atomicAdd(&a.summed[(long)b * a.R + r], req[r]);
  } else {
    const int n = b - a.C;
    for (int r = 0; r < a.R; ++r) atomicAdd(&a.nsum[(long)n * a.R + r], req[r]);
    atomicAdd(&a.ngot[n], 1);
  }
  for (int q = 0; q < a.PT; ++q)
    if (a.pod_ports[(long)p * a.PT + q]) atomicAdd(&a.port_cnt[(long)b * a.PT + q], 1);
}

__device__ void check_pod(const GateKernelArgs& a, int p) {
  const int b = bin_of(a, p);
  const bool on_claim = b >= 0 && b < a.C;
  const bool on_node = b >= a.C && b < a.C + a.N;
  if (!on_claim && !on_node) return;
  // taint-admissibility: pod_tol_* are True where the pod tolerates the bin
  const bool tol = on_claim
                       ? a.pod_tol_tpl[(long)p * a.TPL + min(max(a.claim_tpl[b], 0), a.TPL - 1)]
                       : a.pod_tol_node[(long)p * a.N + (b - a.C)];
  if (!tol) atomicAdd(&a.counts[3], 1);
  // host-port: a conflict lane used by another pod of the bin or pre-used
  // by its node
  for (int q = 0; q < a.PT; ++q) {
    if (!a.pod_conflict[(long)p * a.PT + q]) continue;
    int others = a.port_cnt[(long)b * a.PT + q] - (a.pod_ports[(long)p * a.PT + q] ? 1 : 0);
    if (on_node) others += a.node_used_ports[(long)(b - a.C) * a.PT + q] ? 1 : 0;
    if (others > 0) {
      atomicAdd(&a.counts[4], 1);
      break;
    }
  }
  // requirement-intersection against the bin's published row
  if (!a.pod_check[p]) return;
  if (on_claim && !a.claim_has_reqs[b]) return;
  const Row pod = row_at(a.pod_adm, a.pod_comp, a.pod_def, a.pod_gt, a.pod_lt, p, a.K, a.W);
  bool ok;
  if (on_claim) {
    const Row bin = row_at(a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, b, a.K, a.W);
    ok = intersects_ok(bin, a.claim_neg + (long)b * a.K, pod, a.pod_neg + (long)p * a.K, a.K, a.W);
  } else {
    const int n = b - a.C;
    const Row bin = row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, n, a.K, a.W);
    ok = intersects_ok(bin, a.node_neg + (long)n * a.K, pod, a.pod_neg + (long)p * a.K, a.K, a.W);
  }
  if (!ok) atomicAdd(&a.counts[5], 1);
}

__device__ void check_claim(const GateKernelArgs& a, int c, float* expected, int* flags) {
  const int tid = threadIdx.x;
  if (!a.claim_active[c]) return;  // uniform per block
  if (tid < 3) flags[tid] = 0;
  const int tpl = min(max(a.claim_tpl[c], 0), a.TPL - 1);
  for (int r = tid; r < a.R; r += blockDim.x)
    expected[r] = a.summed[(long)c * a.R + r] + a.tpl_overhead[(long)tpl * a.R + r];
  __syncthreads();
  if (tid == 0) {
    // claim-requests: published requests equal overhead + placed requests
    for (int r = 0; r < a.R; ++r) {
      const float e = expected[r], rep = a.claim_reported[(long)c * a.R + r];
      const float err = fabsf(e - rep);
      const float tol = ABS_TOL + REL_TOL * fmaxf(fabsf(e), fabsf(rep));
      if (err > tol) {
        atomicAdd(&a.counts[0], 1);
        break;
      }
    }
  }
  ITs its;
  its.adm = a.it_adm;
  its.comp = a.it_comp;
  its.def = a.it_def;
  its.gt = a.it_gt;
  its.lt = a.it_lt;
  its.neg = a.it_neg;
  its.alloc = a.it_alloc;
  its.offer_zone = a.offer_zone;
  its.offer_ct = a.offer_ct;
  its.offer_ok = a.offer_ok;
  const Row row = row_at(a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, c, a.K, a.W);
  const uint8_t* row_neg = a.claim_neg + (long)c * a.K;
  const bool has_reqs = a.claim_has_reqs[c];
  for (int t = tid; t < a.T; t += blockDim.x) {
    if (!a.claim_its[(long)c * a.T + t]) continue;
    flags[0] = 1;  // some type is listed
    if (fits_add(expected, nullptr, a.it_alloc + (long)t * a.R, a.R)) flags[1] = 1;
    if (has_reqs && !it_gate(row, row_neg, expected, nullptr, its, t, a.K, a.W, a.R, a.O))
      flags[2] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    if (flags[0] && !flags[1]) atomicAdd(&a.counts[1], 1);  // claim-capacity
    if (flags[2]) atomicAdd(&a.counts[2], 1);              // instance-type-survivor
  }
}

__device__ void check_node(const GateKernelArgs& a, int n) {
  if (!a.ngot[n]) return;
  const float* avail = a.node_avail + (long)n * a.R;
  for (int r = 0; r < a.R; ++r) {
    const float used = a.node_overhead[(long)n * a.R + r] + a.nsum[(long)n * a.R + r];
    const float eps = 1e-6f + 1e-6f * fabsf(avail[r]);
    if (!(used <= avail[r] + eps)) {
      atomicAdd(&a.counts[6], 1);
      return;
    }
  }
}

__global__ void gate_check(GateKernelArgs a, int pod_blocks, int node_blocks) {
  extern __shared__ float expected[];
  __shared__ int flags[3];
  const int blk = blockIdx.x;
  if (blk < pod_blocks) {
    const int p = blk * blockDim.x + threadIdx.x;
    if (p < a.P) check_pod(a, p);
  } else if (blk < pod_blocks + a.C) {
    check_claim(a, blk - pod_blocks, expected, flags);
  } else {
    const int n = (blk - pod_blocks - a.C) * blockDim.x + threadIdx.x;
    if (n < a.N) check_node(a, n);
  }
}

}  // namespace

extern "C" int gate_args_size() { return (int)sizeof(GateKernelArgs); }

// Both launches on ``stream``; returns cudaGetLastError() (0 on success).
// In fused mode (pod_bin null) the first launch also computes the claim
// rows' polarity, which the second reads.
extern "C" int gate_counts_launch(const GateKernelArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pod_blocks = (args->P + THREADS - 1) / THREADS;
  const int neg_blocks = args->pod_bin ? 0 : (args->C * args->K + THREADS - 1) / THREADS;
  const int node_blocks = (args->N + THREADS - 1) / THREADS;
  if (pod_blocks + neg_blocks > 0) gate_scatter<<<pod_blocks + neg_blocks, THREADS, 0, st>>>(*args, pod_blocks);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int blocks = pod_blocks + args->C + node_blocks;
  if (blocks > 0)
    gate_check<<<blocks, THREADS, (size_t)args->R * sizeof(float), st>>>(*args, pod_blocks, node_blocks);
  return (int)cudaGetLastError();
}
