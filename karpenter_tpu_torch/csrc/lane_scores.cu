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
// few dozen operations a row (a few hundred with a wide tanh head). The
// solve writes only the scores; the feature columns are written only where
// a caller asks for them (the tests).
//
// What the design does about it: a thread per row, so a warp covers 32
// consecutive rows and a solve's 10,240 rows are one wave of small blocks.
// Each thread reads its row's lane words with 16-byte loads (where the row
// is a whole number of them) against lane_valid's words in shared memory,
// and its byte rows (defined keys, ports, tolerations, groups) as 32-bit
// words counted with __popc (the bools are 0/1 bytes). The head is staged
// into shared memory once per block, a tile of hidden units at a time, so
// any hidden width runs; each thread then evaluates its own row's head in
// the plain version's order (products added in index order, -fmad=false
// keeping each product and add rounded on its own), so kernel and plain
// agree but for the log1p and tanh implementations. The inputs are the
// tables the solve's ffd_loop launch reads (ops/ffd_sweeps.problem_tensors),
// built once for both launches. One launch per policy solve, on the current
// stream, before ffd_loop reads the scores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 64;  // rows a block: 160 blocks at 10,240 rows, one wave
constexpr int NF = 10;       // feature columns (ops/policy.N_LANE_FEATURES)
constexpr int HTILE = 64;    // hidden units staged in shared memory at a time

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

// true bytes of a 0/1 byte row of n bytes
__device__ __forceinline__ int count_bytes(const uint8_t* row, int n) {
  int c = 0;
  if (((reinterpret_cast<uintptr_t>(row) | static_cast<uintptr_t>(n)) & 3) == 0) {
    const unsigned* w = reinterpret_cast<const unsigned*>(row);
    for (int i = 0; i < (n >> 2); ++i) c += __popc(w[i]);
  } else {
    for (int i = 0; i < n; ++i) c += row[i] ? 1 : 0;
  }
  return c;
}

// any true byte in a 0/1 byte row of n bytes
__device__ __forceinline__ bool any_byte(const uint8_t* row, int n) {
  unsigned acc = 0;
  if (((reinterpret_cast<uintptr_t>(row) | static_cast<uintptr_t>(n)) & 3) == 0) {
    const unsigned* w = reinterpret_cast<const unsigned*>(row);
    for (int i = 0; i < (n >> 2); ++i) acc |= w[i];
  } else {
    for (int i = 0; i < n; ++i) acc |= row[i];
  }
  return acc != 0;
}

__global__ void __launch_bounds__(THREADS) lane_scores_kernel(LaneArgs a) {
  extern __shared__ int smem[];
  const int KW = a.K * a.W;
  int* lvw = smem;                                     // [KW]
  float* head = reinterpret_cast<float*>(smem + KW);  // a tile of the head
  __shared__ int nvalid_s;
  if (threadIdx.x == 0) nvalid_s = 0;
  __syncthreads();
  int nv = 0;
  for (int i = threadIdx.x; i < KW; i += THREADS) {
    lvw[i] = a.lvw[i];
    nv += __popc(a.lvw[i]);
  }
  atomicAdd(&nvalid_s, nv);
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool active = p < a.P;  // no early exit: every thread takes the head's barriers
  __syncthreads();

  float f[NF];
  if (active) {
    int nadm = 0;
    const int* adm = a.adm + static_cast<long long>(p) * KW;
    if ((KW & 3) == 0 && (reinterpret_cast<uintptr_t>(a.adm) & 15) == 0) {
      const int4* row = reinterpret_cast<const int4*>(adm);
      for (int i = 0; i < (KW >> 2); ++i) {
        const int4 x = row[i];
        nadm += __popc(x.x & lvw[4 * i]) + __popc(x.y & lvw[4 * i + 1]) + __popc(x.z & lvw[4 * i + 2]) +
                __popc(x.w & lvw[4 * i + 3]);
      }
    } else {
      for (int i = 0; i < KW; ++i) nadm += __popc(adm[i] & lvw[i]);
    }
    const float* req = a.req + static_cast<long long>(p) * a.R;
    float total = 0.f, top = 0.f;
    for (int r = 0; r < a.R; ++r) {
      total += req[r];
      top = r == 0 ? req[0] : fmaxf(top, req[r]);
    }
    const long long pg = static_cast<long long>(p) * a.G;
    f[0] = log1pf(total);
    f[1] = log1pf(top);
    f[2] = (float)count_bytes(a.defined + static_cast<long long>(p) * a.K, a.K) / (float)a.K;
    f[3] = (float)nadm / fmaxf((float)nvalid_s, 1.f);
    f[4] = any_byte(a.ports + static_cast<long long>(p) * a.PT, a.PT) ? 1.f : 0.f;
    f[5] = (float)count_bytes(a.tol_tpl + static_cast<long long>(p) * a.TPL, a.TPL) / (float)a.TPL;
    f[6] = (float)count_bytes(a.match + pg, a.G);
    f[7] = (float)count_bytes(a.owned + pg, a.G);
    f[8] = 1.f - ((a.eqprev_chain && a.eqprev_chain[p]) ? 1.f : 0.f);
    f[9] = (a.eqprev_gate && a.eqprev_gate[p]) ? 1.f : 0.f;
    if (a.feats)
      for (int i = 0; i < NF; ++i) a.feats[static_cast<long long>(p) * NF + i] = f[i];
  }

  // the head: products added in index order, then the bias
  float score = 0.f;
  const float* wt = a.weights;
  if (a.hidden > 0) {
    const int H = a.hidden;
    const float* b1 = wt + static_cast<long long>(H) * NF;
    const float* w = b1 + H;
    for (int h0 = 0; h0 < H; h0 += HTILE) {
      const int n = min(HTILE, H - h0);
      __syncthreads();  // the previous tile is read
      for (int i = threadIdx.x; i < n * NF; i += THREADS) head[i] = wt[static_cast<long long>(h0) * NF + i];
      for (int i = threadIdx.x; i < n; i += THREADS) {
        head[n * NF + i] = b1[h0 + i];
        head[n * NF + n + i] = w[h0 + i];
      }
      __syncthreads();
      if (active) {
        for (int h = 0; h < n; ++h) {
          const float* row = head + h * NF;
          float acc = f[0] * row[0];
          for (int i = 1; i < NF; ++i) acc = acc + f[i] * row[i];
          const float v = tanhf(acc + head[n * NF + h]) * head[n * NF + n + h];
          score = h0 + h == 0 ? v : score + v;
        }
      }
    }
    score = score + w[H];
  } else {
    for (int i = threadIdx.x; i <= NF; i += THREADS) head[i] = wt[i];
    __syncthreads();
    if (active) {
      score = f[0] * head[0];
      for (int i = 1; i < NF; ++i) score = score + f[i] * head[i];
      score = score + head[NF];
    }
  }
  if (active) a.scores[p] = score;
}

}  // namespace

extern "C" int lane_scores_args_size() { return (int)sizeof(LaneArgs); }

// Launch on ``stream``; returns cudaGetLastError() (0 on success). The
// dynamic shared memory is lane_valid's words and one tile of the head.
extern "C" int lane_scores_launch(const LaneArgs* args, void* stream) {
  if (args->P <= 0) return 0;
  const int tile = args->hidden > 0 ? HTILE * (NF + 2) : NF + 1;
  const size_t smem = sizeof(int) * (static_cast<size_t>(args->K) * args->W + tile);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(lane_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (args->P + THREADS - 1) / THREADS;
  lane_scores_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
