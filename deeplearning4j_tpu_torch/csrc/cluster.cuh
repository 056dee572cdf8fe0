// Thread-block clusters, shared by the kernels that exchange partial results
// through distributed shared memory: K8 (lstm_cell.cu), K9 (decode_attn.cu)
// and K10 (mq_decode_attn.cu).

#pragma once

#include <cuda_runtime.h>

namespace dl4j {

// The two halves of a cluster barrier with no memory ordering: a CTA
// arrives when it starts and waits before it first writes to another CTA's
// shared memory, so that every CTA of the cluster is running by then.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A launch of `grid` x `block` with `smem` bytes of dynamic shared memory on
// `stream`, in clusters of (cx, cy, 1) CTAs (one attribute, kept in attr).
inline cudaLaunchConfig_t cluster_config(dim3 grid, dim3 block, size_t smem,
                                         cudaStream_t stream, unsigned cx,
                                         unsigned cy,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = cy;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace dl4j
