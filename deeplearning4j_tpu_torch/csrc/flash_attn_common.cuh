// Shared by K3 (flash_attn_fwd.cu) and the fused backward K4 + K5
// (flash_attn_bwd.cu): operand strides, warp reductions, and the score of a
// (query, key) pair.
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

#include "epilogue_act.cuh"

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

// s[r] = rows[r] . vec over D floats: rows are R rows `stride` floats apart,
// vec one row, both in shared memory and 16-byte aligned. The terms are
// added in order c = 0 .. D-1 with one fused multiply-add each, starting
// from 0; zero padding beyond d adds nothing.
template <int D, int R>
__device__ __forceinline__ void row_dots(const float* __restrict__ rows,
                                         int stride,
                                         const float* __restrict__ vec,
                                         float (&s)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    const float4 b = *reinterpret_cast<const float4*>(vec + c);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(rows + r * stride + c);
      s[r] = fmaf(a.x, b.x, s[r]);
      s[r] = fmaf(a.y, b.y, s[r]);
      s[r] = fmaf(a.z, b.z, s[r]);
      s[r] = fmaf(a.w, b.w, s[r]);
    }
  }
}

// The score from its dot product: a rounded product, then a rounded sum.
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// Rows [r0, r0 + N) of a [T, d] operand (row stride ts, last dimension
// contiguous) into shared memory as f32 rows `stride` floats apart, zero
// beyond T and beyond d (up to D columns), by the block's NT threads. N, D
// and NT are compile-time constants so that the loop unrolls and its loads
// are all in flight together.
template <typename T, int D, int N, int NT>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int stride,
                                           const T* __restrict__ src,
                                           long long ts, int r0, int rows,
                                           int d) {
  for (int i = threadIdx.x; i < N * D; i += NT) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * stride + c] = (r0 + r < rows && c < d)
        ? to_f32<T>(src[(r0 + r) * ts + c]) : 0.0f;
  }
}

// The same rows of two operands at once (k and v, or q and do).
template <typename T, int D, int N, int NT>
__device__ __forceinline__ void stage_row_pairs(
    float* __restrict__ da, float* __restrict__ db, int stride,
    const T* __restrict__ a, long long as, const T* __restrict__ b,
    long long bs, int r0, int rows, int d) {
  for (int i = threadIdx.x; i < N * D; i += NT) {
    const int r = i / D;
    const int c = i - r * D;
    const bool in = r0 + r < rows && c < d;
    da[r * stride + c] = in ? to_f32<T>(a[(r0 + r) * as + c]) : 0.0f;
    db[r * stride + c] = in ? to_f32<T>(b[(r0 + r) * bs + c]) : 0.0f;
  }
}

}  // namespace dl4j
