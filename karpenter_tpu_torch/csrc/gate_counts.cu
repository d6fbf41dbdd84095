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
// What the design does about it: one launch on one thread-block cluster of
// NB blocks (verify/device.gate_blocks), in four stages with a cluster barrier
// between them.
//   A  each block takes a contiguous segment of the rows: their bins, and
//      each row's rank among the earlier rows of its bin in the segment
//      (warp 0 walks the segment 32 rows at a time: __match_any_sync groups
//      a chunk's rows by bin, a shared running count per bin carries the
//      ranks from chunk to chunk), the segment's count per bin; the claim
//      rows' polarity; the taint and requirement checks of its rows.
//   B1 every block adds the segments' counts into each bin's start (an
//      exclusive scan) and scatters its rows to ``order`` at start + the
//      earlier segments' count + rank: the rows bucketed by bin, each bin's
//      rows in row order (a stable counting sort).
//   B2 each bin's request sums from its own rows only, in row order, as one
//      lane's chain of adds per resource: the plain version's
//      relax_common.ordered_sum, bit for bit, so a claim packed to within
//      float32 rounding of its capacity gets the same verdict each time. A
//      bin of at least LONG_ROWS rows is a whole block's: its other warps
//      stage the next chunk of rows in shared memory while warp 0 adds the
//      current one. The other bins are a warp's each, 32 x RPL rows staged
//      at a time. The same warp or block counts the bin's rows and host
//      ports. The blocks without a long bin also run the compat-and-offering
//      half of the survivor test, a warp per (claim, 32 listed types).
//   B3 the host-port check of every row, each claim's request equality (a
//      warp, lanes over resources), the fit half of the survivor and
//      capacity tests (a warp per (claim, 32 types)), the node checks; the
//      per-claim results meet as integer flags (atomicOr), which the leader
//      folds into the counts after the last barrier.
// Every count and flag is an integer, so none depends on the order of the
// blocks or warps.
//
// The row limit: a block's shared memory holds its segment's rows' bins and
// ranks (8 B a row, P / NB rows), the bins' counts and starts (8 B a bin),
// the claim rows' polarity and a 72 KiB staging area (``carve``, mirrored by
// verify/device.gate_smem_bytes). At 16 blocks and 128 claims on an H100
// (227 KiB a block) that is about 314,000 rows; a launch over more is
// refused by the runtime (the wrapper raises KernelDeviceError), not run in
// another shape.
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
// polarity, which the unfused wrapper computes on the host side, is computed
// in stage A (every block its own copy; block 0 writes ``neg_out``).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.
#include <cuda_runtime.h>

#include "hopper.cuh"
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
  // workspace: every word is written before it is read (the caller zeroes nothing)
  float* summed;     // [C, R] each claim's requests, added in row order
  float* nsum;       // [N, R] each node's requests, added in row order
  int* ngot;         // [N] rows landed on each node
  int* port_cnt;     // [C + N, PT] rows of each bin using each port lane
  uint8_t* neg_out;  // [C, K] fused mode: the claim rows' polarity (claim_neg points here)
  int* order;        // [P] the placed rows bucketed by bin, each bin's in row order
  int* seg_cnt;      // [NB, C + N] each segment's rows per bin
  int* claim_flags;  // [C, 4] some listed type: fails compat-or-offering, is listed, fits, does not fit
  int* blk_counts;   // [NB, 7] each block's counts
  int* counts;       // [7] the output
  long long* sections;  // [GSLOTS] the leader's cycles by stage, its block and cluster barriers
  int P, K, W, T, TPL, C, N, R, O, PT, NB;
};

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NCOUNT = 7;
constexpr float ABS_TOL = 1e-6f;
constexpr float REL_TOL = 1e-4f;
// a bin of at least this many rows is summed by a whole block
constexpr int LONG_ROWS = 256;
// the shared stage of the request rows, a column of rows per resource (a
// lane's chain reads its column 4 rows at a time): per warp 32 x RPL rows,
// per block (a long bin) two buffers of BLOCK_STAGE floats; the two overlap
constexpr int WARP_STAGE = 1152;   // floats a warp: RS x (32 RPL + PAD) <= 1152
constexpr int BLOCK_STAGE = 8448;  // floats a buffer: RS x (rows + PAD) <= 8448
constexpr int PAD = 4;             // floats between columns: their lanes' vector reads hit other banks
// ffd_loop's verdict kinds (ops/ffd_core.py KIND_*)
constexpr int KIND_NODE = 0;
constexpr int KIND_CLAIM = 1;
constexpr int KIND_NEW_CLAIM = 2;
// claim_flags words
constexpr int F_CO_BAD = 0, F_LISTED = 1, F_FIT = 2, F_MISFIT = 3;

// the leader's cycles by stage (verify/device.GATE_SECTIONS): the work of a
// stage up to the block's barrier that ends it, then the wait at the
// cluster barrier
constexpr int GS_ROWS = 0, GS_ROW_CHECKS = 1, GS_WAIT_A = 2, GS_SCATTER = 3, GS_WAIT_B1 = 4, GS_SUMS = 5,
              GS_WAIT_B2 = 6, GS_CHECKS = 7, GS_FOLD = 8, GSEC = 9;
// then the leader's block and cluster barriers (the latency floor's count)
constexpr int GS_BLOCK_BARRIERS = GSEC, GS_CLUSTER_BARRIERS = GSEC + 1, GSLOTS = GSEC + 2;

__shared__ long long s_sec[GSLOTS + 1];  // the last slot: the clock of the last mark
__shared__ int s_lc[NCOUNT];             // this block's counts

__device__ __forceinline__ void mark(int sec) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    s_sec[sec] += now - s_sec[GSLOTS];
    s_sec[GSLOTS] = now;
  }
}

// __syncthreads and the cluster barrier, counted
__device__ __forceinline__ void bsync() {
  if (threadIdx.x == 0) s_sec[GS_BLOCK_BARRIERS] += 1;
  __syncthreads();
}

__device__ __forceinline__ void csync() {
  if (threadIdx.x == 0) s_sec[GS_CLUSTER_BARRIERS] += 1;
  cluster_barrier();
}

// The bin of pod row p: claim slot 0..C-1, node C..C+N-1, or -1.
__device__ __forceinline__ int bin_of(const GateKernelArgs& a, int p) {
  int b;
  if (a.pod_bin) {
    b = a.pod_bin[p];
  } else {
    const int kind = a.kind[p];
    b = (kind == KIND_CLAIM || kind == KIND_NEW_CLAIM) ? a.index[p] : kind == KIND_NODE ? a.C + a.index[p] : -1;
  }
  return (b >= 0 && b < a.C + a.N) ? b : -1;
}

// The dynamic shared memory of a block, carved once per launch.
struct Mem {
  int* run;      // [B + 1] A: running counts per bin; B1 on: each bin's start
  int* off;      // [B] B1: the earlier segments' rows per bin
  int* bin;      // [SEG] the segment's rows' bins
  int* rnk;      // [SEG] and ranks
  float* stage;  // the staged request rows (WARP_STAGE a warp, or 2 x BLOCK_STAGE)
  uint8_t* neg;  // [C * K] the claim rows' polarity
};

__host__ __device__ __forceinline__ int seg_rows(int P, int NB) { return (P + NB - 1) / NB; }
// resources a staged row holds (32 at a time), and rows a lane stages
__host__ __device__ __forceinline__ int stage_cols(int R) { return R < 32 ? (R > 0 ? R : 1) : 32; }
__host__ __device__ __forceinline__ int rows_per_lane(int RS) { return RS <= 8 ? 4 : RS <= 16 ? 2 : 1; }
__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// The block's shared memory, carved once per launch.
__host__ __device__ inline size_t carve(const GateKernelArgs& a, char* base, Mem* m) {
  const int B = a.C + a.N, SEG = seg_rows(a.P, a.NB);
  const int stage = NWARPS * WARP_STAGE > 2 * BLOCK_STAGE ? NWARPS * WARP_STAGE : 2 * BLOCK_STAGE;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + at : nullptr;
    at += align16(bytes);
    return p;
  };
  Mem mm;
  mm.run = reinterpret_cast<int*>(take(sizeof(int) * (B + 1)));
  mm.off = reinterpret_cast<int*>(take(sizeof(int) * B));
  mm.bin = reinterpret_cast<int*>(take(sizeof(int) * SEG));
  mm.rnk = reinterpret_cast<int*>(take(sizeof(int) * SEG));
  mm.stage = reinterpret_cast<float*>(take(sizeof(float) * stage));
  mm.neg = reinterpret_cast<uint8_t*>(take((size_t)a.C * a.K));
  if (m) *m = mm;
  return at;
}

// -- stage A: the segment's rows ------------------------------------------------

__device__ void stage_rows(const GateKernelArgs& a, int seg, const Mem& m) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.C + a.N, SEG = seg_rows(a.P, a.NB);
  const int p0 = seg * SEG, n = max(0, min(a.P, p0 + SEG) - p0);
  for (int b = tid; b < B; b += THREADS) m.run[b] = 0;
  for (int i = tid; i < n; i += THREADS) m.bin[i] = bin_of(a, p0 + i);
  if (seg == 0) {  // the counters of stages B2-B3, visible after the first cluster barrier
    for (int e = tid; e < 4 * a.C; e += THREADS) a.claim_flags[e] = 0;
    for (long e = tid; e < (long)B * a.PT; e += THREADS) a.port_cnt[e] = 0;
  }
  bsync();
  if (warp == 0) {
    // ranks: a chunk's rows grouped by bin; the group's lowest lane carries
    // the bin's running count on
    const unsigned below = (1u << lane) - 1u;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const int b = i < n ? m.bin[i] : -1;
      const unsigned peers = __match_any_sync(FULL, b);
      const int r = b >= 0 ? m.run[b] + __popc(peers & below) : 0;
      __syncwarp();
      if (b >= 0 && !(peers & below)) m.run[b] += __popc(peers);
      __syncwarp();
      if (i < n) m.rnk[i] = r;
    }
  } else {
    // the claim rows' polarity, computed (fused mode) or copied
    for (int e = tid - 32; e < a.C * a.K; e += THREADS - 32) {
      uint8_t v;
      if (a.pod_bin) {
        v = a.claim_neg[e];
      } else {
        const int k = e % a.K;
        v = negative_polarity_key(a.claim_adm + (long)e * a.W, a.claim_comp[e], a.claim_gt[e], a.claim_lt[e],
                                  a.lvw + (long)k * a.W, a.ln + (long)k * 32 * a.W, a.W) ? 1 : 0;
        if (seg == 0) a.neg_out[e] = v;
      }
      m.neg[e] = v;
    }
  }
  bsync();
  for (int b = tid; b < B; b += THREADS) a.seg_cnt[(long)seg * B + b] = m.run[b];
}

// The taint and requirement checks of the segment's rows.
__device__ void stage_row_checks(const GateKernelArgs& a, int seg, const Mem& m) {
  const int SEG = seg_rows(a.P, a.NB);
  const int p0 = seg * SEG, n = max(0, min(a.P, p0 + SEG) - p0);
  int taint = 0, inter = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int b = m.bin[i], p = p0 + i;
    if (b < 0) continue;
    const bool on_claim = b < a.C;
    // taint-admissibility: pod_tol_* are True where the pod tolerates the bin
    const bool tol = on_claim ? a.pod_tol_tpl[(long)p * a.TPL + min(max(a.claim_tpl[b], 0), a.TPL - 1)]
                              : a.pod_tol_node[(long)p * a.N + (b - a.C)];
    taint += !tol;
    // requirement-intersection against the bin's published row
    if (!a.pod_check[p] || (on_claim && !a.claim_has_reqs[b])) continue;
    const Row pod = row_at(a.pod_adm, a.pod_comp, a.pod_def, a.pod_gt, a.pod_lt, p, a.K, a.W);
    bool ok;
    if (on_claim) {
      const Row bin = row_at(a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, b, a.K, a.W);
      ok = intersects_ok(bin, m.neg + (long)b * a.K, pod, a.pod_neg + (long)p * a.K, a.K, a.W);
    } else {
      const int nd = b - a.C;
      const Row bin = row_at(a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, nd, a.K, a.W);
      ok = intersects_ok(bin, a.node_neg + (long)nd * a.K, pod, a.pod_neg + (long)p * a.K, a.K, a.W);
    }
    inter += !ok;
  }
  if (taint) atomicAdd(&s_lc[3], taint);
  if (inter) atomicAdd(&s_lc[5], inter);
}

// -- stage B ------------------------------------------------------------------

// In-place exclusive scan of x[0..n) by the block, x[n] = the total.
__device__ void block_scan(int* x, int n) {
  __shared__ int s_warp[NWARPS];
  __shared__ int s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_carry = 0;
  bsync();
  for (int i0 = 0; i0 < n; i0 += THREADS) {
    const int i = i0 + tid;
    const int v = i < n ? x[i] : 0;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) s_warp[warp] = inc;
    bsync();
    if (warp == 0) {
      int w = lane < NWARPS ? s_warp[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += y;
      }
      if (lane < NWARPS) s_warp[lane] = w;  // inclusive over warps
    }
    bsync();
    const int before = s_carry + (warp ? s_warp[warp - 1] : 0) + inc - v;
    if (i < n) x[i] = before;
    bsync();
    if (tid == THREADS - 1) s_carry = before + v;
    bsync();
  }
  if (tid == 0) x[n] = s_carry;
  bsync();
}

// Each bin's start into m.run (every block its own copy), then the rows of
// segment ``seg`` scattered into ``order``.
__device__ void stage_scatter(const GateKernelArgs& a, int seg, const Mem& m) {
  const int tid = threadIdx.x;
  const int B = a.C + a.N, SEG = seg_rows(a.P, a.NB);
  for (int b = tid; b < B; b += THREADS) {
    int tot = 0, base = 0;
    for (int s = 0; s < a.NB; ++s) {
      const int c = a.seg_cnt[(long)s * B + b];
      if (s < seg) base += c;
      tot += c;
    }
    m.run[b] = tot;
    m.off[b] = base;
  }
  bsync();
  block_scan(m.run, B);
  const int p0 = seg * SEG, n = max(0, min(a.P, p0 + SEG) - p0);
  for (int i = tid; i < n; i += THREADS) {
    const int b = m.bin[i];
    if (b >= 0) a.order[m.run[b] + m.off[b] + m.rnk[i]] = p0 + i;
  }
}

// acc + x[0] + x[1] + ... + x[n - 1], one add at a time in that order; x
// is 16-byte aligned, read 16 rows ahead of the adds, 4 at a time
__device__ __forceinline__ float chain(float acc, const float* x, int n) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  int j = 0;
  if (n >= 16) {
    float4 cur[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) cur[u] = x4[u];
    for (; j + 16 <= n; j += 16) {
      float4 nxt[4];
      const bool more = j + 32 <= n;
#pragma unroll
      for (int u = 0; u < 4; ++u) nxt[u] = more ? x4[(j + 16) / 4 + u] : cur[u];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc = acc + cur[u].x;
        acc = acc + cur[u].y;
        acc = acc + cur[u].z;
        acc = acc + cur[u].w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) cur[u] = nxt[u];
    }
  }
  for (; j < n; ++j) acc = acc + x[j];
  return acc;
}

__device__ __forceinline__ float* bin_out(const GateKernelArgs& a, int b) {
  return b < a.C ? a.summed + (long)b * a.R : a.nsum + (long)(b - a.C) * a.R;
}

// The host ports of row p count toward its bin (integer atomics, once per row).
__device__ __forceinline__ void count_ports(const GateKernelArgs& a, int b, long p) {
  for (int q = 0; q < a.PT; ++q)
    if (a.pod_ports[p * a.PT + q]) atomicAdd(&a.port_cnt[(long)b * a.PT + q], 1);
}

// A short bin by one warp: its rows, 32 x RPL at a time, stage their request
// rows (32 resources at a time) in the warp's shared memory; lane r then
// adds resource r of each in row order into a register, from 0, as the
// plain version does.
__device__ void warp_bin(const GateKernelArgs& a, int b, const Mem& m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int RS = stage_cols(a.R), CH = 32 * rows_per_lane(RS), COL = CH + PAD;
  float* stage = m.stage + (long)warp * WARP_STAGE;
  const int s = m.run[b], cnt = m.run[b + 1] - s;
  float* out = bin_out(a, b);
  for (int r0 = 0; r0 < a.R; r0 += 32) {
    const int nr = min(32, a.R - r0);
    float acc = 0.f;
    for (int j0 = 0; j0 < cnt; j0 += CH) {
      const int nj = min(CH, cnt - j0);
      for (int jj = lane; jj < nj; jj += 32) {
        const long p = a.order[s + j0 + jj];
        const float* req = a.pod_requests + p * a.R + r0;
        for (int r = 0; r < nr; ++r) stage[r * COL + jj] = req[r];
        if (r0 == 0) count_ports(a, b, p);
      }
      __syncwarp();
      if (lane < nr) acc = chain(acc, stage + lane * COL, nj);
      __syncwarp();
    }
    if (lane < nr) out[r0 + lane] = acc;
  }
  if (b >= a.C && lane == 0) a.ngot[b - a.C] = cnt;
}

// A long bin by the whole block: warps 1.. stage the next chunk of rows into
// one buffer while warp 0's lanes add the current chunk from the other, in
// row order (the same chain as warp_bin's).
__device__ void block_bin(const GateKernelArgs& a, int b, const Mem& m) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int RS = stage_cols(a.R), CR = (BLOCK_STAGE / RS - PAD) / 16 * 16, COL = CR + PAD;
  const int s = m.run[b], cnt = m.run[b + 1] - s;
  float* out = bin_out(a, b);
  for (int r0 = 0; r0 < a.R; r0 += 32) {
    const int nr = min(32, a.R - r0);
    auto load = [&](int k, int t0, int nt) {
      float* buf = m.stage + (k & 1) * BLOCK_STAGE;
      const int j0 = k * CR, nj = min(CR, cnt - j0);
      for (int jj = t0; jj < nj; jj += nt) {
        const long p = a.order[s + j0 + jj];
        const float* req = a.pod_requests + p * a.R + r0;
        for (int r = 0; r < nr; ++r) buf[r * COL + jj] = req[r];
        if (r0 == 0) count_ports(a, b, p);
      }
    };
    const int chunks = (cnt + CR - 1) / CR;
    load(0, tid, THREADS);
    bsync();
    float acc = 0.f;
    for (int k = 0; k < chunks; ++k) {
      if (warp == 0) {
        if (lane < nr) acc = chain(acc, m.stage + (k & 1) * BLOCK_STAGE + lane * COL, min(CR, cnt - k * CR));
      } else if (k + 1 < chunks) {
        load(k + 1, tid - 32, THREADS - 32);
      }
      bsync();
    }
    if (warp == 0 && lane < nr) out[r0 + lane] = acc;
  }
  if (tid == 32 && b >= a.C) a.ngot[b - a.C] = cnt;
  bsync();
}

// The compat-and-offering half of the survivor test: warp ``gw`` of ``nw``
// takes (claim, 32 types) items; a claim with a listed type that fails it
// sets its CO_BAD flag.
__device__ void stage_compat(const GateKernelArgs& a, int gw, int nw, const Mem& m) {
  const int lane = threadIdx.x & 31;
  const int chunks = (a.T + 31) / 32;
  for (long item = gw; item < (long)a.C * chunks; item += nw) {
    const int c = (int)(item / chunks), t = (int)(item % chunks) * 32 + lane;
    if (!a.claim_active[c] || !a.claim_has_reqs[c]) continue;
    bool bad = false;
    if (t < a.T && a.claim_its[(long)c * a.T + t]) {
      const Row row = row_at(a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, c, a.K, a.W);
      const Row it = row_at(a.it_adm, a.it_comp, a.it_def, a.it_gt, a.it_lt, t, a.K, a.W);
      bad = !(intersects_ok(row, m.neg + (long)c * a.K, it, a.it_neg + (long)t * a.K, a.K, a.W) &&
              has_offering(row.adm, a.W, a.offer_zone + (long)t * a.O, a.offer_ct + (long)t * a.O,
                           a.offer_ok + (long)t * a.O, a.O));
    }
    if (__any_sync(FULL, bad) && lane == 0) atomicOr(&a.claim_flags[4 * c + F_CO_BAD], 1);
  }
}

// The host-port check of the segment's rows, each claim's request equality,
// the fit half of the type tests and the node checks, over the cluster's
// warps and threads (gw of nw warps, gt of nt threads).
__device__ void stage_checks(const GateKernelArgs& a, int seg, int gw, int nw, int gt, int nt, const Mem& m) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int SEG = seg_rows(a.P, a.NB);
  const int p0 = seg * SEG, n = max(0, min(a.P, p0 + SEG) - p0);
  int port = 0, node = 0;
  // host-port: a conflict lane used by another row of the bin or pre-used by its node
  for (int i = tid; i < n; i += THREADS) {
    const int b = m.bin[i], p = p0 + i;
    if (b < 0) continue;
    for (int q = 0; q < a.PT; ++q) {
      if (!a.pod_conflict[(long)p * a.PT + q]) continue;
      int others = a.port_cnt[(long)b * a.PT + q] - (a.pod_ports[(long)p * a.PT + q] ? 1 : 0);
      if (b >= a.C) others += a.node_used_ports[(long)(b - a.C) * a.PT + q] ? 1 : 0;
      if (others > 0) {
        port += 1;
        break;
      }
    }
  }
  // node-capacity: overhead plus landed rows fits, on nodes that got rows
  for (int nd = gt; nd < a.N; nd += nt) {
    if (!a.ngot[nd]) continue;
    const float* avail = a.node_avail + (long)nd * a.R;
    for (int r = 0; r < a.R; ++r) {
      const float used = a.node_overhead[(long)nd * a.R + r] + a.nsum[(long)nd * a.R + r];
      const float eps = 1e-6f + 1e-6f * fabsf(avail[r]);
      if (!(used <= avail[r] + eps)) {
        node += 1;
        break;
      }
    }
  }
  if (port) atomicAdd(&s_lc[4], port);
  if (node) atomicAdd(&s_lc[6], node);
  // claim-requests: published requests equal overhead + placed requests
  for (int c = gw; c < a.C; c += nw) {
    if (!a.claim_active[c]) continue;
    const int tpl = min(max(a.claim_tpl[c], 0), a.TPL - 1);
    bool bad = false;
    for (int r = lane; r < a.R; r += 32) {
      const float e = a.summed[(long)c * a.R + r] + a.tpl_overhead[(long)tpl * a.R + r];
      const float rep = a.claim_reported[(long)c * a.R + r];
      const float err = fabsf(e - rep);
      const float tol = ABS_TOL + REL_TOL * fmaxf(fabsf(e), fabsf(rep));
      bad |= err > tol;
    }
    if (__any_sync(FULL, bad) && lane == 0) atomicAdd(&s_lc[0], 1);
  }
  // the fit half: each listed type against overhead + placed requests
  const int chunks = (a.T + 31) / 32;
  for (long item = gw; item < (long)a.C * chunks; item += nw) {
    const int c = (int)(item / chunks), t = (int)(item % chunks) * 32 + lane;
    if (!a.claim_active[c]) continue;
    const bool listed = t < a.T && a.claim_its[(long)c * a.T + t];
    bool fit = false;
    if (listed) {
      const int tpl = min(max(a.claim_tpl[c], 0), a.TPL - 1);
      const float* alloc = a.it_alloc + (long)t * a.R;
      fit = true;
      for (int r = 0; r < a.R && fit; ++r) {
        const float e = a.summed[(long)c * a.R + r] + a.tpl_overhead[(long)tpl * a.R + r];
        const float av = alloc[r];
        const float eps = 1e-6f + 1e-6f * fabsf(av);
        fit = e <= av + eps;
      }
    }
    const unsigned any_listed = __ballot_sync(FULL, listed), any_fit = __ballot_sync(FULL, fit),
                   any_misfit = __ballot_sync(FULL, listed && !fit);
    if (lane == 0) {
      if (any_listed) atomicOr(&a.claim_flags[4 * c + F_LISTED], 1);
      if (any_fit) atomicOr(&a.claim_flags[4 * c + F_FIT], 1);
      if (any_misfit) atomicOr(&a.claim_flags[4 * c + F_MISFIT], 1);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) gate_kernel(GateKernelArgs a) {
  extern __shared__ __align__(16) char dyn[];
  __shared__ int s_nlong;
  Mem m;
  carve(a, dyn, &m);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rank = cluster_rank(), B = a.C + a.N;
  if (tid < NCOUNT) s_lc[tid] = 0;
  if (tid < GSLOTS) s_sec[tid] = 0;
  if (tid == 0) s_sec[GSLOTS] = clock64();
  __syncthreads();

  stage_rows(a, rank, m);
  bsync();
  mark(GS_ROWS);
  stage_row_checks(a, rank, m);
  bsync();
  mark(GS_ROW_CHECKS);
  csync();
  mark(GS_WAIT_A);

  stage_scatter(a, rank, m);
  bsync();
  mark(GS_SCATTER);
  csync();
  mark(GS_WAIT_B1);

  // the long bins, i-th to block i % NB; the other bins and the compat tests
  // over the warps of the blocks without a long bin (of all, if every
  // block has one)
  if (tid == 0) s_nlong = 0;
  bsync();
  for (int b = tid; b < B; b += THREADS)
    if (m.run[b + 1] - m.run[b] >= LONG_ROWS) atomicAdd(&s_nlong, 1);
  bsync();
  const int nlong = s_nlong, busy = min(nlong, a.NB);
  for (int b = 0, i = 0; b < B; ++b) {
    if (m.run[b + 1] - m.run[b] < LONG_ROWS) continue;
    if (i++ % a.NB == rank) block_bin(a, b, m);
  }
  const int r0 = busy < a.NB ? busy : 0, workers = a.NB - r0;
  if (rank >= r0) {
    const int gw = (rank - r0) * NWARPS + warp, nw = workers * NWARPS;
    for (int b = gw; b < B; b += nw)
      if (m.run[b + 1] - m.run[b] < LONG_ROWS) warp_bin(a, b, m);
    stage_compat(a, gw, nw, m);
  }
  bsync();
  mark(GS_SUMS);
  csync();
  mark(GS_WAIT_B2);

  stage_checks(a, rank, rank * NWARPS + warp, a.NB * NWARPS, rank * THREADS + tid, a.NB * THREADS, m);
  bsync();
  mark(GS_CHECKS);
  if (tid < NCOUNT) a.blk_counts[rank * NCOUNT + tid] = s_lc[tid];
  csync();
  if (rank == 0) {
    // the leader folds the blocks' counts and the claims' flags
    if (tid < NCOUNT) {
      int total = 0;
      for (int r = 0; r < a.NB; ++r) total += a.blk_counts[r * NCOUNT + tid];
      atomicAdd(&s_lc[tid], total - s_lc[tid]);
    }
    bsync();
    int cap = 0, surv = 0;
    for (int c = tid; c < a.C; c += THREADS) {
      const int* f = a.claim_flags + 4 * c;
      if (!a.claim_active[c] || !f[F_LISTED]) continue;
      cap += !f[F_FIT];  // claim-capacity: some listed type fits the recomputed totals
      // instance-type-survivor: every listed type passes compat x offering x fit
      surv += a.claim_has_reqs[c] && (f[F_CO_BAD] || f[F_MISFIT]);
    }
    if (cap) atomicAdd(&s_lc[1], cap);
    if (surv) atomicAdd(&s_lc[2], surv);
    bsync();
    if (tid < NCOUNT) a.counts[tid] = s_lc[tid];
    mark(GS_FOLD);
    if (tid < GSLOTS) a.sections[tid] = s_sec[tid];
  }
}

}  // namespace

extern "C" int gate_args_size() { return (int)sizeof(GateKernelArgs); }

// A block's dynamic shared memory for ``args`` (carve): the wrapper's mirror
// (verify/device.gate_smem_bytes) is held to it by the card tests.
extern "C" long long gate_counts_smem(const GateKernelArgs* args) { return (long long)carve(*args, nullptr, nullptr); }

// One launch on ``stream``: a cluster of NB blocks. Returns 0 or the CUDA
// error (a cluster or shared memory the card cannot hold is refused, not
// run in another shape).
extern "C" int gate_counts_launch(const GateKernelArgs* args, void* stream) {
  if (args->NB < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = carve(*args, nullptr, nullptr);
  return cluster_launch(gate_kernel, args->NB, args->NB, THREADS, smem, static_cast<cudaStream_t>(stream), *args);
}
