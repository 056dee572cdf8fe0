// Shared by K3 (flash_attn_fwd.cu) and the fused backward K4 + K5
// (flash_attn_bwd.cu): operand strides, warp reductions, the score of a
// (query, key) pair, the staging of their tiles by asynchronous copies
// (cp_async.cuh), and the 16-bit tensor-core product (ldmatrix,
// mma.sync.m16n8k16). The launch helpers come from launch.cuh.
//
// The backward recomputes the forward's scores and must get them bit for
// bit: on a fully masked row every score is the clamped bias
// finfo(float32).min, m is that value, and p = exp(s - m) / l is the uniform
// 1/Tk only if s - m is exactly 0 (the JAX package's note on its saved
// softmax statistics, ops/flash_attention.py _fwd_kernel). So every f32
// kernel computes a score the same way: the dot product over d in order, one
// fused multiply-add per term from 0, then s = dot * scale + bias as a
// rounded product and a rounded sum (no fused multiply-add). The
// multiply-add of two factors does not depend on their order, so K3, which
// walks d with a row of q against a row of k, and the backward, which walks
// d over a register tile of (query, key) pairs, agree. (The backward's
// 16-bit kernel takes its scores from the tensor cores; flash_attn_bwd.cu
// says why a masked row still gets s - m = 0 there.)

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "epilogue_act.cuh"
#include "launch.cuh"

namespace dl4j {

// (batch, head, row) element strides of a [B, H, T, d] operand whose last
// dimension is contiguous.
struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The score from its dot product: a rounded product, then a rounded sum.
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// ---- asynchronous copies ---------------------------------------------------

// Rows [r0, r0 + N) of a [T, d] operand (row stride ts elements, last
// dimension contiguous) into shared memory rows RS elements apart, D columns,
// zero beyond `rows` and beyond d, by the block's NT threads: one cp.async
// per 16 bytes when `vec`, else element by element.
template <typename T, int N, int D, int RS, int NT>
__device__ __forceinline__ void stage(T* __restrict__ dst,
                                      const T* __restrict__ src, long long ts,
                                      int r0, int rows, int d, bool vec) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);  // elements per copy
    constexpr int C = D / E;                // copies per row
    for (int i = threadIdx.x; i < N * C; i += NT) {
      const int r = i / C;
      const int c = (i - r * C) * E;
      const bool in = r0 + r < rows && c < d;
      const int n = in ? min(E, d - c) : 0;
      cp_async16(dst + r * RS + c, in ? src + (r0 + r) * ts + c : src,
                 n * (int)sizeof(T));
    }
  } else {
    for (int i = threadIdx.x; i < N * D; i += NT) {
      const int r = i / D;
      const int c = i - r * D;
      dst[r * RS + c] = (r0 + r < rows && c < d) ? src[(r0 + r) * ts + c]
                                                 : from_f32<T>(0.0f);
    }
  }
}

// N rows of D 16-bit elements (row stride RS) to f32 rows (stride FS).
template <typename T, int N, int D, int RS, int FS, int NT>
__device__ __forceinline__ void widen(float* __restrict__ dst,
                                      const T* __restrict__ src) {
  for (int i = threadIdx.x; i < N * D; i += NT) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * FS + c] = to_f32<T>(src[r * RS + c]);
  }
}

// ---- 16-bit tensor-core products -------------------------------------------

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// c += a b for one 16 x 8 x 16 tile: a row-major 16 x 16, b 16 x 8 as two
// registers (k pairs of one column), c f32.
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace dl4j
