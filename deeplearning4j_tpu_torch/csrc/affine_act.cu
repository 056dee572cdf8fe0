// K1: the affine + activation epilogue, y = act(x * scale + shift).
//
// Replaces deeplearning4j_tpu/ops/fused_epilogues.py::_fused_epilogue_affine_fwd
// (its pallas_call is in _affine_fwd_impl; bn_act and bias_act reach it).
//
// x and y are row-major [rows, C] buffers in f32, bf16 or f16; scale and
// shift are f32 vectors of length C (scale may be null: y = act(x + shift)).
// The channel of element i is i mod C.
//
// Bound: memory traffic. The kernel reads and writes rows*C elements once
// each (plus 2*C floats of scale and shift); its arithmetic is a few flops
// per element, far below the card's f32 rate.
//
// Design: one pass with no intermediate kept in device memory. A
// grid-stride loop walks the buffer in 16-byte vectors when C is a multiple
// of the vector width (a vector then never straddles two rows), else one
// element at a time. scale and shift come through the read-only cache
// (__ldg): they are the only data reused. The math is f32; the store
// rounds to x's dtype once. The loop bound masks the ragged tail, so any
// row count works (the TPU kernel needed rows to tile its row blocks).
//
// z = x*scale + shift is a rounded product and a rounded sum (affine() in
// epilogue_act.cuh, no fused multiply-add), as in the plain version; the
// activations' tanhf/expf/erff differ from PyTorch's by an ulp or two.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue_act.cuh"

namespace {

using namespace dl4j;

// VEC elements per step: 16 / sizeof(T) on the vector path, else 1.
template <typename T, int ACT, int VEC>
__global__ void affine_act_kernel(const T* __restrict__ x,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ shift,
                                  T* __restrict__ y, long long n_steps,
                                  int cols) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < n_steps; v += stride) {
    const long long base = v * VEC;
    const int c0 = (int)(base % cols);
    alignas(16) T in[VEC];
    alignas(16) T out[VEC];
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(in) = __ldg(reinterpret_cast<const uint4*>(x) + v);
    } else {
      in[0] = x[base];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float b = __ldg(shift + c0 + j);
      const float z = scale != nullptr
                          ? affine(to_f32<T>(in[j]), __ldg(scale + c0 + j), b)
                          : to_f32<T>(in[j]) + b;
      out[j] = from_f32<T>(act_fn<ACT>(z));
    }
    if constexpr (VEC > 1) {
      reinterpret_cast<uint4*>(y)[v] = *reinterpret_cast<const uint4*>(out);
    } else {
      y[base] = out[0];
    }
  }
}

template <typename T, int ACT>
void launch(const void* x, const float* scale, const float* shift, void* y,
            long long n, int cols, int vec, int max_blocks,
            cudaStream_t stream) {
  const int threads = 256;
  constexpr int V = 16 / sizeof(T);
  const long long steps = vec ? n / V : n;
  long long blocks = (steps + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (vec) {
    affine_act_kernel<T, ACT, V><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), scale, shift, static_cast<T*>(y), steps, cols);
  } else {
    affine_act_kernel<T, ACT, 1><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), scale, shift, static_cast<T*>(y), steps, cols);
  }
}

template <typename T>
bool launch_act(int act, const void* x, const float* scale, const float* shift,
                void* y, long long n, int cols, int vec, int max_blocks,
                cudaStream_t stream) {
  switch (act) {
    case IDENTITY: launch<T, IDENTITY>(x, scale, shift, y, n, cols, vec, max_blocks, stream); return true;
    case RELU: launch<T, RELU>(x, scale, shift, y, n, cols, vec, max_blocks, stream); return true;
    case RELU6: launch<T, RELU6>(x, scale, shift, y, n, cols, vec, max_blocks, stream); return true;
    case TANH: launch<T, TANH>(x, scale, shift, y, n, cols, vec, max_blocks, stream); return true;
    case SIGMOID: launch<T, SIGMOID>(x, scale, shift, y, n, cols, vec, max_blocks, stream); return true;
    case GELU: launch<T, GELU>(x, scale, shift, y, n, cols, vec, max_blocks, stream); return true;
    case GELU_EXACT: launch<T, GELU_EXACT>(x, scale, shift, y, n, cols, vec, max_blocks, stream); return true;
    default: return false;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16. vec: 1 when cols is a multiple of
// 16 / sizeof(T) and x, y are 16-byte aligned. Returns the CUDA error of the
// launch (0 on success), or cudaErrorInvalidValue for an unknown act/dtype.
extern "C" int dl4j_affine_act(const void* x, const float* scale,
                               const float* shift, void* y, long long rows,
                               int cols, int act, int dtype, int vec,
                               int max_blocks, void* stream) {
  const long long n = rows * (long long)cols;
  if (n <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (dtype) {
    case 0: ok = launch_act<float>(act, x, scale, shift, y, n, cols, vec, max_blocks, st); break;
    case 1: ok = launch_act<__nv_bfloat16>(act, x, scale, shift, y, n, cols, vec, max_blocks, st); break;
    case 2: ok = launch_act<__half>(act, x, scale, shift, y, n, cols, vec, max_blocks, st); break;
    default: break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
