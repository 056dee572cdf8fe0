// Shared by K1 (affine_act.cu) and K2 (affine_act_bwd.cu): the activation
// table, its derivative from the pre-activation, and the f32 conversions of
// the three element types.
//
// The formulas are those of deeplearning4j_tpu/ops/fused_epilogues.py
// (_act_fwd and _act_grad). The derivative keeps that module's tie
// convention: relu' is 0 at z == 0, relu6' is 0 at z == 0 and at z == 6.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace dl4j {

// The order matches ACTS in kernels/affine_act.py.
enum Act { IDENTITY = 0, RELU, RELU6, TANH, SIGMOID, GELU, GELU_EXACT };

// z = x*scale + shift as a rounded product, then a rounded sum: no fused
// multiply-add. The plain PyTorch versions compute the same two roundings,
// so K1, K2 and the plain versions agree bit for bit on z, and the ties of
// relu' (z == 0) and relu6' (z == 0, z == 6) fall on the same side in all of
// them.
__device__ __forceinline__ float affine(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
}

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluA = 0.044715f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

template <int ACT>
__device__ __forceinline__ float act_fn(float z) {
  if constexpr (ACT == IDENTITY) {
    return z;
  } else if constexpr (ACT == RELU) {
    return fmaxf(z, 0.0f);
  } else if constexpr (ACT == RELU6) {
    return fminf(fmaxf(z, 0.0f), 6.0f);
  } else if constexpr (ACT == TANH) {
    return tanhf(z);
  } else if constexpr (ACT == SIGMOID) {
    return 1.0f / (1.0f + expf(-z));
  } else if constexpr (ACT == GELU) {  // tanh approximation (DL4J GELU)
    const float u = kSqrt2OverPi * (z + kGeluA * z * z * z);
    return 0.5f * z * (1.0f + tanhf(u));
  } else {  // GELU_EXACT: erf form (ONNX Gelu)
    return 0.5f * z * (1.0f + erff(z * kInvSqrt2));
  }
}

// d act / d z, recomputed from the pre-activation (no residual saved).
template <int ACT>
__device__ __forceinline__ float act_grad(float z) {
  if constexpr (ACT == IDENTITY) {
    return 1.0f;
  } else if constexpr (ACT == RELU) {
    return z > 0.0f ? 1.0f : 0.0f;
  } else if constexpr (ACT == RELU6) {
    return (z > 0.0f && z < 6.0f) ? 1.0f : 0.0f;
  } else if constexpr (ACT == TANH) {
    const float t = tanhf(z);
    return 1.0f - t * t;
  } else if constexpr (ACT == SIGMOID) {
    const float s = 1.0f / (1.0f + expf(-z));
    return s * (1.0f - s);
  } else if constexpr (ACT == GELU) {
    const float u = kSqrt2OverPi * (z + kGeluA * z * z * z);
    const float t = tanhf(u);
    const float du = kSqrt2OverPi * (1.0f + 3.0f * kGeluA * z * z);
    return 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * du;
  } else {  // GELU_EXACT
    const float cdf = 0.5f * (1.0f + erff(z * kInvSqrt2));
    const float pdf = kInvSqrt2Pi * expf(-0.5f * z * z);
    return cdf + z * pdf;
  }
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);  // round to nearest even
}

}  // namespace dl4j
