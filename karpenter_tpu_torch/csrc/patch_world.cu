// patch_world: one churn cycle's row patch of the device-resident world.
//
// Replaces the JAX package's device program ops/fused.py:211
// _patch_world_jit. For every pod-axis leaf of the world (kept in the
// kernels' layout: packed lane words, polarity rows, requests, tolerations,
// ports, ...) and every padded row r:
//   out[r] = use_fresh[r] ? stack[fresh_sel[r]] : prev[gather_idx[r]]
// and the small full-ship leaves (pod_active, the eqprev rows, the run
// tables) are copied whole from the shipped buffer.
//
// What bounds it on an H100: bytes. It reads each surviving row of each
// leaf once, the shipped stack rows once, and writes every row once (a few
// MB at 10k pods), with no arithmetic beyond the index math: the card's
// memory rate, 3.35 TB/s, sets the bound, and at these sizes the launch
// itself.
//
// What the design does about it: one launch covers every leaf: a grid of
// (row blocks) x (leaves), each block copying ROWS rows of one leaf, in
// 4-byte words where the leaf's row is a whole number of words and bytes
// otherwise. The leaf table (previous buffer, output buffer, stack rows,
// row bytes) and the index lanes arrive in the same device buffer as the
// stack, in one copy. gather_idx is not monotone (arrivals sort into the
// middle of the batch), so the output is never the input: the caller hands
// each leaf's spare buffer as ``out`` and swaps the two afterwards
// (ops/fused.patch_world).
#include <cuda_runtime.h>
#include <stdint.h>

// One leaf of the patch. Row leaves: prev/out are the world's two buffers,
// stk the shipped rows, row_bytes one row's size. Full-ship leaves: prev is
// unused, stk the new contents, row_bytes the total size.
struct PatchLeaf {
  const uint8_t* prev;
  uint8_t* out;
  const uint8_t* stk;
  long long row_bytes;
};

// Field order is mirrored by _PatchKernelArgs in karpenter_tpu_torch/ops/fused.py.
struct PatchKernelArgs {
  const PatchLeaf* leaves;  // [L + FL]: the row leaves, then the full-ship leaves
  const int* gather_idx;    // [P]
  const uint8_t* use_fresh;  // [P]
  const int* fresh_sel;     // [P]
  int L, FL, P;
};

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 32;  // rows of one leaf per block

__global__ void patch_world_kernel(PatchKernelArgs a) {
  const PatchLeaf leaf = a.leaves[blockIdx.y];
  if ((int)blockIdx.y >= a.L) {
    // a full-ship leaf: the row blocks split its bytes
    const long long n = leaf.row_bytes;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
      leaf.out[i] = leaf.stk[i];
    return;
  }
  const int r0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, a.P - r0);
  if (rows <= 0) return;
  const long long rb = leaf.row_bytes;
  if ((rb & 3) == 0) {
    const long long words = rb >> 2;
    const long long total = words * rows;
    for (long long e = threadIdx.x; e < total; e += blockDim.x) {
      const int r = r0 + (int)(e / words);
      const long long w = e % words;
      const int* src = a.use_fresh[r]
                           ? reinterpret_cast<const int*>(leaf.stk + (long long)a.fresh_sel[r] * rb)
                           : reinterpret_cast<const int*>(leaf.prev + (long long)a.gather_idx[r] * rb);
      reinterpret_cast<int*>(leaf.out + (long long)r * rb)[w] = src[w];
    }
  } else {
    const long long total = rb * rows;
    for (long long e = threadIdx.x; e < total; e += blockDim.x) {
      const int r = r0 + (int)(e / rb);
      const long long c = e % rb;
      const uint8_t* src = a.use_fresh[r] ? leaf.stk + (long long)a.fresh_sel[r] * rb
                                          : leaf.prev + (long long)a.gather_idx[r] * rb;
      leaf.out[(long long)r * rb + c] = src[c];
    }
  }
}

}  // namespace

extern "C" int patch_world_args_size() { return (int)sizeof(PatchKernelArgs); }

// One launch on ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int patch_world_launch(const PatchKernelArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int leaves = args->L + args->FL;
  const int row_blocks = (args->P + ROWS - 1) / ROWS;
  if (leaves > 0 && row_blocks > 0)
    patch_world_kernel<<<dim3(row_blocks, leaves), THREADS, 0, st>>>(*args);
  return (int)cudaGetLastError();
}
