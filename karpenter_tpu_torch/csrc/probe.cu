// probe: the mesh-health re-entry probe of one device, as a kernel.
//
// Replaces the JAX package's device program
//   verify/device.py:316 probe_device (:326 jax.jit(jnp.sum) over
//   arange(16, float32) placed on the probed device; program 18)
// and computes what verify/device.probe_sum_plain computes: the float32 sum
// of n values (n <= 32) added in index order, x[0] + x[1] + ... + x[n-1].
//
// What bounds it on an H100: nothing but the launch itself. It reads 64
// bytes and writes 4; its point is that the device ran a kernel and
// returned correct arithmetic (120.0 for arange(16)), not that the runtime
// still lists the device.
//
// What the design does about it: one warp. Lane i loads x[i]; lane 0 reads
// every lane's value through the warp shuffle in index order and adds them
// one by one, so the rounding order is the plain version's whatever the
// input, and writes the float.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.
#include <cuda_runtime.h>

// Field order is mirrored by ProbeArgs in karpenter_tpu_torch/verify/device.py
// (pointers first, then ints); probe_args_size() lets the wrapper check it.
struct ProbeArgs {
  const float* x;  // [n]
  float* out;      // [1]
  int n;           // values to add, 1..32
};

namespace {

constexpr unsigned FULL = 0xffffffffu;

__global__ void probe_kernel(ProbeArgs a) {
  const int lane = threadIdx.x;
  const float v = lane < a.n ? a.x[lane] : 0.f;
  float total = 0.f;
  for (int i = 0; i < a.n; ++i) {
    const float xi = __shfl_sync(FULL, v, i);
    total = i == 0 ? xi : total + xi;
  }
  if (lane == 0) a.out[0] = total;
}

}  // namespace

extern "C" int probe_args_size() { return (int)sizeof(ProbeArgs); }

// Launch on ``stream``; returns cudaGetLastError() (0 on success). A count
// outside 1..32 is refused with cudaErrorInvalidValue before any launch.
extern "C" int probe_launch(const ProbeArgs* args, void* stream) {
  if (args->n < 1 || args->n > 32) return (int)cudaErrorInvalidValue;
  probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
