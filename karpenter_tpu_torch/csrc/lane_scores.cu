// lane_scores: the learned order's per-row score (program 6's scorer).
//
// Replaces the JAX package's ops/policy.py:102 lane_scores (lane_features
// :47, score_features :86), which its policy sweeps programs
// (ops/ffd_sweeps.py:2002 _solve_ffd_sweeps_fresh_policy_jit, :2024
// _solve_ffd_sweeps_carried_policy_jit) trace in front of the loop, and
// computes what ops/policy.lane_scores_plain computes: ten feature columns
// per pod row (log1p of the request sum and of the largest request, the
// defined-key share, the admitted share of the valid value lanes, host
// ports, the template toleration share, matched and owned topology groups,
// the chain-head and gate-identity bits) and a linear or one-hidden-layer
// tanh head over them.
//
// What bounds it on an H100: the bytes of the pod rows (the packed lane
// words dominate: P x K x W int32) against 3.35 TB/s; the arithmetic is a
// few dozen operations a row. The solve writes only the scores; the feature
// columns are written only where a caller asks for them (the tests).
//
// What the design does about it: one warp per pod row, its lanes striding
// the row's packed words, keys, ports, templates and groups, with warp
// shuffles for the counts; lane 0 then takes the request sum and the head's
// products in index order (the plain version's order; -fmad=false keeps each
// product and add rounded on its own), so kernel and plain agree but for the
// log1p implementation. One launch per policy solve, on the current stream,
// before ffd_loop reads the scores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // 8 rows a block
constexpr int NF = 10;        // feature columns (ops/policy.N_LANE_FEATURES)

}  // namespace

// Field order is mirrored by _LANE_POINTERS / _LANE_INTS in
// karpenter_tpu_torch/ops/policy.py; lane_scores_args_size() lets the
// wrapper check it.
struct LaneArgs {
  const float* req;             // [P, R]
  const uint8_t* defined;       // [P, K]
  const int* adm;               // [P, K, W] packed admitted lanes
  const int* lvw;               // [K, W] packed lane_valid
  const uint8_t* ports;         // [P, PT]
  const uint8_t* tol_tpl;       // [P, TPL]
  const uint8_t* match;         // [P, G]
  const uint8_t* owned;         // [P, G]
  const uint8_t* eqprev_chain;  // [P] or null (no chain rows: every row a head)
  const uint8_t* eqprev_gate;   // [P] or null
  const float* weights;         // hidden rows [H, NF] and biases [H] (H > 0), then the
                                // output weights [H or NF] and bias
  float* feats;                 // [P, NF] or null (the solve reads only the scores)
  float* scores;                // [P]
  int P, R, K, W, PT, TPL, G, hidden;
};

namespace {

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS) lane_scores_kernel(LaneArgs a) {
  const int p = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (p >= a.P) return;  // whole warps leave together
  const int KW = a.K * a.W;
  int nvalid = 0, nadm = 0, ndef = 0, nport = 0, ntol = 0, nmatch = 0, nowned = 0;
  for (int i = lane; i < KW; i += 32) {
    const int lv = a.lvw[i];
    nvalid += __popc(lv);
    nadm += __popc(a.adm[(long)p * KW + i] & lv);
  }
  for (int k = lane; k < a.K; k += 32) ndef += a.defined[(long)p * a.K + k] ? 1 : 0;
  for (int q = lane; q < a.PT; q += 32) nport |= a.ports[(long)p * a.PT + q] ? 1 : 0;
  for (int j = lane; j < a.TPL; j += 32) ntol += a.tol_tpl[(long)p * a.TPL + j] ? 1 : 0;
  for (int g = lane; g < a.G; g += 32) {
    nmatch += a.match[(long)p * a.G + g] ? 1 : 0;
    nowned += a.owned[(long)p * a.G + g] ? 1 : 0;
  }
  nvalid = warp_sum(nvalid);
  nadm = warp_sum(nadm);
  ndef = warp_sum(ndef);
  nport = warp_sum(nport);
  ntol = warp_sum(ntol);
  nmatch = warp_sum(nmatch);
  nowned = warp_sum(nowned);
  if (lane != 0) return;

  const float* req = a.req + (long)p * a.R;
  float total = 0.f, top = 0.f;
  for (int r = 0; r < a.R; ++r) {
    total += req[r];
    top = r == 0 ? req[0] : fmaxf(top, req[r]);
  }
  float f[NF];
  f[0] = log1pf(total);
  f[1] = log1pf(top);
  f[2] = (float)ndef / (float)a.K;
  f[3] = (float)nadm / fmaxf((float)nvalid, 1.f);
  f[4] = nport ? 1.f : 0.f;
  f[5] = (float)ntol / (float)a.TPL;
  f[6] = (float)nmatch;
  f[7] = (float)nowned;
  f[8] = 1.f - ((a.eqprev_chain && a.eqprev_chain[p]) ? 1.f : 0.f);
  f[9] = (a.eqprev_gate && a.eqprev_gate[p]) ? 1.f : 0.f;
  if (a.feats)
    for (int i = 0; i < NF; ++i) a.feats[(long)p * NF + i] = f[i];

  // the head: products added in index order, then the bias
  const float* wt = a.weights;
  float score;
  if (a.hidden > 0) {
    const float* b1 = wt + a.hidden * NF;
    const float* w = b1 + a.hidden;
    score = 0.f;
    for (int h = 0; h < a.hidden; ++h) {
      float acc = f[0] * wt[h * NF];
      for (int i = 1; i < NF; ++i) acc = acc + f[i] * wt[h * NF + i];
      const float v = tanhf(acc + b1[h]) * w[h];
      score = h == 0 ? v : score + v;
    }
    score = score + w[a.hidden];
  } else {
    score = f[0] * wt[0];
    for (int i = 1; i < NF; ++i) score = score + f[i] * wt[i];
    score = score + wt[NF];
  }
  a.scores[p] = score;
}

}  // namespace

extern "C" int lane_scores_args_size() { return (int)sizeof(LaneArgs); }

// Launch on ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int lane_scores_launch(const LaneArgs* args, void* stream) {
  if (args->P <= 0) return 0;
  const int blocks = (args->P + THREADS / 32 - 1) / (THREADS / 32);
  lane_scores_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
