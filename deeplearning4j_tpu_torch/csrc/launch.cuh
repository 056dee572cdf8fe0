// Launch helpers shared by the kernels that take more than the default 48 KB
// of dynamic shared memory or report their resources: K3, the fused K4 + K5
// and K10 (through flash_attn_common.cuh), K7 and K8.

#pragma once

#include <cuda_runtime.h>

namespace dl4j {

// Raise `kernel`'s dynamic shared-memory cap to `bytes` where the launch
// takes more than the default cap. `Kernel` is a kernel's function or its
// address as `const void*`.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;  // within the default dynamic cap
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The resources of a kernel launched with `threads` threads and `bytes` of
// dynamic shared memory: out[0] registers a thread, out[1] threads a CTA,
// out[2] shared-memory bytes a CTA (static and dynamic), out[3] local
// (spill) bytes a thread, out[4] the CTAs one SM holds at once (CUDA's
// occupancy calculator).
template <typename Kernel>
int occupancy_of(Kernel kernel, int threads, size_t bytes, int* out) {
  int e;
  if ((e = allow_smem(kernel, bytes)) != 0) return e;
  cudaFuncAttributes fa;
  if ((e = (int)cudaFuncGetAttributes(&fa, kernel)) != 0) return e;
  out[0] = fa.numRegs;
  out[1] = threads;
  out[2] = (int)(fa.sharedSizeBytes + bytes);
  out[3] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel,
                                                            threads, bytes);
}

}  // namespace dl4j
