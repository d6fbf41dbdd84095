// patch_world: one churn cycle's row patch of the device-resident world.
//
// Replaces the JAX package's device program ops/fused.py:211
// _patch_world_jit. For every pod-axis leaf of the world (kept in the
// kernels' layout: packed lane words, polarity rows, requests, tolerations,
// ports, ...) and every padded row r:
//   out[r] = use_fresh[r] ? pack(stack[fresh_sel[r]]) : prev[gather_idx[r]]
// and the small full-ship leaves (pod_active, the eqprev rows, the run
// tables) are copied whole from the shipped buffer.
//
// What bounds it on an H100: bytes. It reads each surviving row of each
// leaf once, the shipped rows once, and writes every row once (a few MB at
// 10k pods), with no arithmetic beyond packing the few shipped rows: the
// card's memory rate, 3.35 TB/s, sets the bound, and at these sizes the
// launch itself.
//
// What the design does about it: between the arrivals and the deletes the
// survivors' previous rows run consecutively, so the host cuts the splice
// into work lists (ops/fused.patch_plan): survivor pieces (destination row,
// previous row, rows), at most PIECE_ROWS rows each, and the rows built from
// a shipped row (destination row, shipped row). One launch gives every work
// item a warp of its own, in a grid as large as the work (a persistent grid
// walking the items was 1-2 us slower, as was the leaf table staged in each
// block's shared memory; per-row index lanes without the plan, a lane a row
// and a warp walking each 32 rows' fresh rows, were 5-10x slower: PERF.md
// section 5):
//   - a (piece, leaf) item copies one contiguous byte range at the widest
//     width that both ends and the length allow (16, 8, 4 or 1 B), with no
//     index arithmetic per element;
//   - a shipped row takes 1 + (packed leaves) items, built from the row as
//     the encoder gave it: one item copies the row of every leaf whose
//     shipped rows already have its type, a lane a leaf; one item a packed
//     leaf turns the admitted lanes into lane words by __ballot_sync, and
//     the pod group's item then writes the group's polarity row (masks.cuh
//     negative_polarity_key, against the world's lvw and ln);
//   - a full-ship chunk copies FULL_CHUNK bytes of a full-ship leaf.
// No item waits on another, so a cycle is still one launch. The leaf table
// and the work lists arrive in the same device buffer as the shipped rows,
// in one copy. gather_idx is not monotone (arrivals sort into the middle of
// the batch), so the output is never the input: the caller hands each
// leaf's spare buffer as ``out`` and swaps the two afterwards
// (ops/fused.patch_world).
#include <cuda_runtime.h>
#include <stdint.h>

#include "masks.cuh"

// One leaf of the patch; field order is mirrored by _LEAF_FIELDS in
// karpenter_tpu_torch/ops/fused.py (one int64 word a field).
struct PatchLeaf {
  const uint8_t* prev;      // row leaves: the previous buffer; full-ship leaves: unused
  uint8_t* out;             // row leaves: the spare buffer; full-ship leaves: the destination
  const uint8_t* stk;       // row leaves: the shipped rows, encoder's form (null for OP_NEG);
                            // full-ship leaves: the new contents
  long long row_bytes;      // one row of ``out`` (row leaves); the whole leaf (full-ship leaves)
  long long stk_row_bytes;  // one shipped row
  long long op;             // OP_*: how a shipped row becomes a row of ``out``
  long long aux;            // OP_PACK: the table index of the group's polarity leaf, or -1
};

// Field order is mirrored by _PATCH_POINTERS / _PATCH_INTS in karpenter_tpu_torch/ops/fused.py.
struct PatchKernelArgs {
  const PatchLeaf* leaves;  // [L + FL]: the row leaves, then the full-ship leaves
  const int* pieces;        // [NP, 3] (destination row, previous row, rows): survivor runs
  const int* fresh;         // [NF, 2] (destination row, shipped row): rows built from a shipped row
  const int* lvw;           // [K, W] the world's packed lane_valid
  const float* ln;          // [K, 32 W] the world's lane_numeric
  int L, FL, NP, NF, FP, FC, K, W;  // FP: work items a fresh row takes (1 + the OP_PACK leaves)
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEAVES = 32;
constexpr long long FULL_CHUNK = 4096;  // ops/fused.FULL_CHUNK
// ops/fused.OP_*: a byte copy of the shipped row; the admitted lanes packed
// into lane words (and, with aux >= 0, the group's polarity row); a polarity
// leaf, written by its group's OP_PACK item
constexpr long long OP_COPY = 0, OP_PACK = 1, OP_NEG = 2;
constexpr unsigned FULL = 0xffffffffu;

// n bytes from src to dst by one warp, at the widest width that both
// addresses and n allow
__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src, long long n, int lane) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(dst) |
                               reinterpret_cast<unsigned long long>(src) | static_cast<unsigned long long>(n);
  if ((a & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
    for (long long i = lane; i < (n >> 4); i += 32) d[i] = s[i];
  } else if ((a & 7) == 0) {
    uint2* d = reinterpret_cast<uint2*>(dst);
    const uint2* s = reinterpret_cast<const uint2*>(src);
#pragma unroll 4
    for (long long i = lane; i < (n >> 3); i += 32) d[i] = s[i];
  } else if ((a & 3) == 0) {
    unsigned* d = reinterpret_cast<unsigned*>(dst);
    const unsigned* s = reinterpret_cast<const unsigned*>(src);
#pragma unroll 4
    for (long long i = lane; i < (n >> 2); i += 32) d[i] = s[i];
  } else {
    for (long long i = lane; i < n; i += 32) dst[i] = src[i];
  }
}

// n bytes from src to dst by one thread (a short row), at the widest width
// that both addresses and n allow
__device__ __forceinline__ void thread_copy(uint8_t* dst, const uint8_t* src, long long n) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(dst) |
                               reinterpret_cast<unsigned long long>(src) | static_cast<unsigned long long>(n);
  if ((a & 15) == 0) {
    for (long long i = 0; i < (n >> 4); ++i) reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else if ((a & 7) == 0) {
    for (long long i = 0; i < (n >> 3); ++i) reinterpret_cast<uint2*>(dst)[i] = reinterpret_cast<const uint2*>(src)[i];
  } else if ((a & 3) == 0) {
    for (long long i = 0; i < (n >> 2); ++i)
      reinterpret_cast<unsigned*>(dst)[i] = reinterpret_cast<const unsigned*>(src)[i];
  } else {
    for (long long i = 0; i < n; ++i) dst[i] = src[i];
  }
}

// Part ``part`` of destination row r from shipped row s, by one warp: part 0
// copies every OP_COPY leaf's row, a lane a leaf; part p >= 1 packs the p-th
// OP_PACK leaf (and its group's polarity row).
__device__ void fresh_part(const PatchKernelArgs& a, const PatchLeaf* sl, int part, long long r, long long s,
                           int lane) {
  const long long op = lane < a.L ? sl[lane].op : OP_NEG;
  if (part == 0) {
    if (op == OP_COPY) {
      const PatchLeaf& lf = sl[lane];
      thread_copy(lf.out + r * lf.row_bytes, lf.stk + s * lf.stk_row_bytes, lf.row_bytes);
    }
    return;
  }
  unsigned packs = __ballot_sync(FULL, op == OP_PACK);
  for (int k = 1; k < part; ++k) packs &= packs - 1;
  const int l = __ffs(packs) - 1;
  const PatchLeaf& lf = sl[l];
  const uint8_t* src = lf.stk + s * lf.stk_row_bytes;
  // bool[K, VS] -> int32[K, W], lane 32w + i of key k in bit i of word (k, w)
  const int K = a.K, W = a.W;
  const int VS = static_cast<int>(lf.stk_row_bytes / K);
  int* words = reinterpret_cast<int*>(lf.out + r * lf.row_bytes);
  for (int q = 0; q < K * W; ++q) {
    const int k = q / W;
    const int v = (q - k * W) * 32 + lane;
    const unsigned word = __ballot_sync(FULL, v < VS && src[static_cast<long long>(k) * VS + v]);
    if (lane == (q & 31)) words[q] = static_cast<int>(word);
  }
  if (lf.aux < 0) return;
  __syncwarp();  // the words above, written by the warp's lanes, are read below
  // the group's polarity row: its comp, gt and lt leaves follow the words
  // at +1, +3 and +4 (ops/fused.upload_patch checks the order)
  const PatchLeaf& comp = sl[l + 1];
  const PatchLeaf& gt = sl[l + 3];
  const PatchLeaf& lt = sl[l + 4];
  const PatchLeaf& neg = sl[lf.aux];
  const uint8_t* comp_row = comp.stk + s * comp.stk_row_bytes;
  const int* gt_row = reinterpret_cast<const int*>(gt.stk + s * gt.stk_row_bytes);
  const int* lt_row = reinterpret_cast<const int*>(lt.stk + s * lt.stk_row_bytes);
  for (int k = lane; k < K; k += 32)
    neg.out[r * neg.row_bytes + k] = kt::negative_polarity_key(
        words + k * W, comp_row[k] != 0, gt_row[k], lt_row[k], a.lvw + k * W, a.ln + static_cast<long long>(k) * 32 * W,
        W);
}

__global__ void __launch_bounds__(THREADS) patch_world_kernel(PatchKernelArgs a) {
  const PatchLeaf* sl = a.leaves;  // read through the cache: a few hundred bytes every warp reads
  const int lane = threadIdx.x & 31;
  const long long fresh_items = static_cast<long long>(a.NF) * a.FP;
  const long long copy_items = static_cast<long long>(a.NP) * a.L;
  const long long total = fresh_items + copy_items + a.FC;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long i = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32; i < total; i += stride) {
    if (i < fresh_items) {
      const long long f = i / a.FP;
      fresh_part(a, sl, static_cast<int>(i - f * a.FP), a.fresh[2 * f], a.fresh[2 * f + 1], lane);
    } else if (i < fresh_items + copy_items) {
      const long long j = i - fresh_items;
      const long long p = j / a.L;
      const PatchLeaf& lf = sl[j - p * a.L];
      const long long rb = lf.row_bytes;
      warp_copy(lf.out + a.pieces[3 * p] * rb, lf.prev + a.pieces[3 * p + 1] * rb, a.pieces[3 * p + 2] * rb, lane);
    } else {
      long long c = i - fresh_items - copy_items;
      for (int f = 0; f < a.FL; ++f) {
        const PatchLeaf& lf = sl[a.L + f];
        const long long chunks = (lf.row_bytes + FULL_CHUNK - 1) / FULL_CHUNK;
        if (c < chunks) {
          const long long off = c * FULL_CHUNK;
          warp_copy(lf.out + off, lf.stk + off, min(FULL_CHUNK, lf.row_bytes - off), lane);
          break;
        }
        c -= chunks;
      }
    }
  }
}

}  // namespace

extern "C" int patch_world_args_size() { return (int)sizeof(PatchKernelArgs); }

// One launch on ``stream``, a warp per work item; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a leaf
// table with more leaves than a warp has lanes.
extern "C" int patch_world_launch(const PatchKernelArgs* args, void* stream) {
  if (args->L + args->FL > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  const long long items = static_cast<long long>(args->NF) * args->FP + static_cast<long long>(args->NP) * args->L +
                          args->FC;
  if (items <= 0) return 0;
  const int blocks = static_cast<int>((items + WARPS - 1) / WARPS);
  patch_world_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
