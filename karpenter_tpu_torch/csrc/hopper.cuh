// Hopper's cluster and bulk-copy primitives, as the kernels that run one
// solve on a thread-block cluster use them (ffd_loop.cu through step.cuh,
// relax_place.cu, runs_screen.cu): the blocks of a cluster meet at cluster
// barriers, reach each other's shared memory (distributed shared memory),
// and load their slices of the instance-type tables with TMA bulk copies that
// complete on an mbarrier; cluster_launch starts a grid of clusters.
// Every function is a thin wrapper, so that the rest of the kernel reads as
// plain CUDA.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace kt {

// the block's rank in its cluster, and the cluster's size in blocks (1 in a
// launch without clusters)
__device__ __forceinline__ int cluster_rank() { return (int)cooperative_groups::this_cluster().block_rank(); }
__device__ __forceinline__ int cluster_blocks() { return (int)cooperative_groups::this_cluster().num_blocks(); }

// barrier.cluster.arrive.release + barrier.cluster.wait.acquire: every
// thread of every block of the cluster, and what each wrote before it (global
// or shared, its own block's or another's) is visible to all after it
__device__ __forceinline__ void cluster_barrier() { cooperative_groups::this_cluster().sync(); }

// the address of ``p`` (a shared-memory address of this block) in block
// ``rank`` of the cluster
template <class T>
__device__ __forceinline__ T* map_rank(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an mbarrier expecting ``count`` arrivals; the init is made visible to the
// async proxy (the bulk copies) before use
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects ``bytes`` of bulk copies to complete
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// wait until phase ``phase`` of the mbarrier completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// TMA bulk copy of ``bytes`` (a multiple of 16; both addresses 16-byte
// aligned) from global to this block's shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Launch ``blocks`` blocks of ``threads`` threads of ``kernel`` in clusters
// of ``cluster`` blocks with ``smem`` bytes of dynamic shared memory each.
// Returns 0, or the CUDA error the runtime gave (cleared, so that it does not
// surface at a later launch): a cluster the card cannot schedule (too large,
// or too much shared memory for its blocks to be resident together) is
// refused here and never run in a smaller shape.
template <class... Args>
int cluster_launch(void (*kernel)(Args...), int blocks, int cluster, int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (cluster < 1 || blocks % cluster != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && cluster > 8) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, reinterpret_cast<const void*>(kernel), &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace kt
