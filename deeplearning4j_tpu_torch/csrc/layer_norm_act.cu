// K6: the LayerNorm + affine + activation epilogue. For each row of a
// row-major [rows, C] buffer:
//
//   mu   = mean(x)
//   var  = mean((x - mu)^2)            (two passes, never E[x^2] - E[x]^2)
//   rstd = rsqrt(var + eps)
//   y    = act((x - mu) * rstd * gamma + beta), in x's dtype
//
// and mu and rstd are written as one f32 per row (the backward's residuals).
//
// Replaces deeplearning4j_tpu/ops/fused_epilogues.py::_fused_epilogue_ln_fwd
// (its pallas_call is in _ln_fwd_impl; layer_norm_act reaches it). The TPU
// kernel wrote mu and rstd replicated over 128 lanes; here each is one f32
// per row.
//
// x and y are f32, bf16 or f16; gamma and beta f32 vectors of length C.
//
// Bound: memory traffic. The kernel reads x and writes y once each (plus
// two [C] vectors and two f32 per row); its arithmetic is a dozen flops per
// element plus the activation, far below the card's f32 rate.
//
// Design: a row lives in registers between its two passes, so x is read
// from device memory once. A row belongs to a group of G = 32 * WPR
// threads (one warp when C <= 1024, then 4 or 8 warps up to 8192 columns,
// kernels/layer_norm_act.py::MAX_COLS); thread t of
// the group holds the NV elements t, t + G, ..., t + (NV-1)*G (neighbouring
// threads read neighbouring addresses), masked past C, so any C up to
// G * NV and any row count work. The row sums are a warp's xor butterfly
// (every lane ends with the same bits: float addition commutes) and, for
// WPR > 1, the warps' sums added in a fixed order through shared memory:
// the same inputs give the same bits on every run. A block is
// max(4, WPR) warps: four rows of one warp each, or one row.
//
// xhat = (x - mu) * rstd and z = xhat * gamma + beta are rounded products
// and sums (no fused multiply-add), as the plain PyTorch version computes
// them; mu, the variance and rsqrtf differ from PyTorch's in summation
// order and an ulp or two, which kernels/layer_norm_act.py's tolerance
// states. The activation is epilogue_act.cuh's, bit for bit K1's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue_act.cuh"

namespace {

using namespace dl4j;

template <int WPR>
__host__ __device__ constexpr int block_threads() {
  return 32 * (WPR > 4 ? WPR : 4);
}

// The sum of v over a row group of WPR warps, the same bits in every thread
// of the group. red: WPR floats of shared memory (unused when WPR == 1).
template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (WPR > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    v = red[0];
#pragma unroll
    for (int w = 1; w < WPR; ++w) v += red[w];
  }
  return v;
}

template <typename T, int ACT, int NV, int WPR>
__global__ void __launch_bounds__(block_threads<WPR>())
layer_norm_act_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mu_out, float* __restrict__ rstd_out,
                      long long rows, int cols, float eps) {
  constexpr int G = 32 * WPR;
  constexpr int ROWS_PER_BLOCK = block_threads<WPR>() / G;
  __shared__ float red[2][WPR];
  const int t = threadIdx.x % G;
  const long long row =
      (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / G;
  // WPR == 1: no block barrier, a group past the last row leaves; WPR > 1:
  // the block is one row, and the grid has no block past the last row
  if (row >= rows) return;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;

  float v[NV];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = t + k * G;
    v[k] = c < cols ? to_f32<T>(xr[c]) : 0.0f;
    s += v[k];
  }
  const float mu = row_sum<WPR>(s, red[0]) / (float)cols;
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = t + k * G;
    if (c < cols) {
      v[k] = __fsub_rn(v[k], mu);
      q = __fadd_rn(q, __fmul_rn(v[k], v[k]));
    }
  }
  const float var = row_sum<WPR>(q, red[1]) / (float)cols;
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = t + k * G;
    if (c < cols) {
      const float xhat = __fmul_rn(v[k], rstd);
      const float z = affine(xhat, __ldg(gamma + c), __ldg(beta + c));
      yr[c] = from_f32<T>(act_fn<ACT>(z));
    }
  }
  if (t == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T, int ACT, int NV, int WPR>
void launch(const void* x, const float* gamma, const float* beta, void* y,
            float* mu, float* rstd, long long rows, int cols, float eps,
            cudaStream_t stream) {
  constexpr int threads = block_threads<WPR>();
  constexpr int rows_per_block = threads / (32 * WPR);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  layer_norm_act_kernel<T, ACT, NV, WPR><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), mu, rstd,
      rows, cols, eps);
}

template <typename T, int ACT>
bool launch_cfg(int nv, int wpr, const void* x, const float* gamma,
                const float* beta, void* y, float* mu, float* rstd,
                long long rows, int cols, float eps, cudaStream_t st) {
  // the (NV, WPR) pairs of kernels/layer_norm_act.py::row_config
  if (wpr == 1 && nv == 8) launch<T, ACT, 8, 1>(x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
  else if (wpr == 1 && nv == 16) launch<T, ACT, 16, 1>(x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
  else if (wpr == 1 && nv == 24) launch<T, ACT, 24, 1>(x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
  else if (wpr == 1 && nv == 32) launch<T, ACT, 32, 1>(x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
  else if (wpr == 4 && nv == 32) launch<T, ACT, 32, 4>(x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
  else if (wpr == 8 && nv == 32) launch<T, ACT, 32, 8>(x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
  else return false;
  return true;
}

template <typename T>
bool launch_act(int act, int nv, int wpr, const void* x, const float* gamma,
                const float* beta, void* y, float* mu, float* rstd,
                long long rows, int cols, float eps, cudaStream_t st) {
  switch (act) {
    case IDENTITY: return launch_cfg<T, IDENTITY>(nv, wpr, x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
    case RELU: return launch_cfg<T, RELU>(nv, wpr, x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
    case RELU6: return launch_cfg<T, RELU6>(nv, wpr, x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
    case TANH: return launch_cfg<T, TANH>(nv, wpr, x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
    case SIGMOID: return launch_cfg<T, SIGMOID>(nv, wpr, x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
    case GELU: return launch_cfg<T, GELU>(nv, wpr, x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
    case GELU_EXACT: return launch_cfg<T, GELU_EXACT>(nv, wpr, x, gamma, beta, y, mu, rstd, rows, cols, eps, st);
    default: return false;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16. (nv, wpr): one of row_config's pairs,
// with cols <= 32 * wpr * nv. mu and rstd: rows floats each. Returns the
// CUDA error of the launch (0 on success), or cudaErrorInvalidValue for a
// bad argument.
extern "C" int dl4j_layer_norm_act(const void* x, const float* gamma,
                                   const float* beta, void* y, float* mu,
                                   float* rstd, long long rows, int cols,
                                   float eps, int act, int dtype, int nv,
                                   int wpr, void* stream) {
  if (rows <= 0 || cols <= 0 || (long long)cols > 32LL * wpr * nv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (dtype) {
    case 0: ok = launch_act<float>(act, nv, wpr, x, gamma, beta, y, mu, rstd, rows, cols, eps, st); break;
    case 1: ok = launch_act<__nv_bfloat16>(act, nv, wpr, x, gamma, beta, y, mu, rstd, rows, cols, eps, st); break;
    case 2: ok = launch_act<__half>(act, nv, wpr, x, gamma, beta, y, mu, rstd, rows, cols, eps, st); break;
    default: break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
