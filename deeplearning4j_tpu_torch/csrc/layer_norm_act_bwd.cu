// K7: the LayerNorm-epilogue backward. Given x, gamma, beta, the forward's
// per-row mu and rstd, and dy = dL/dy for y = act(xhat * gamma + beta):
//
//   xhat   = (x - mu) * rstd,  z = xhat * gamma + beta   (recomputed, f32)
//   dz     = dy * act'(z),     dxh = dz * gamma
//   dx     = (dxh - mean(dxh) - xhat * mean(dxh * xhat)) * rstd, x's dtype
//   dgamma = sum over rows of dz * xhat                   (f32 [C])
//   dbeta  = sum over rows of dz                          (f32 [C])
//
// Replaces deeplearning4j_tpu/ops/fused_epilogues.py::_fused_epilogue_ln_bwd
// (its pallas_call is in _ln_bwd_impl, the backward rule of the custom VJP
// that layer_norm_act reaches).
//
// x, dy and dx are row-major [rows, C] buffers in f32, bf16 or f16; gamma,
// beta, dgamma and dbeta f32 vectors of length C; mu and rstd one f32 per
// row.
//
// Bound: memory traffic. The kernel reads x and dy and writes dx once each
// (3 * rows * C elements), plus [C] vectors and two f32 per row; a few
// dozen flops per element at most, far below the card's f32 rate.
//
// Design: K6's row layout (a row in the registers of a group of
// G = 32 * WPR threads, thread t holding columns t, t + G, ..., masked past
// C) for the row-local means, and K2's deterministic two-stage reduction
// (affine_act_bwd.cu) for the column sums, with no atomics:
//
// 1. layer_norm_act_bwd_partial: block b owns the consecutive rows
//    [b * rows_per_block, ...); its row groups (four warps, or one group of
//    WPR warps) take those rows in turn, write dx, and keep each of their
//    columns' sums of dz * xhat and dz in registers. The block adds its
//    groups' sums in a fixed order (in shared memory) and writes one row of
//    the partials [blocks, C].
// 2. layer_norm_act_bwd_final: one thread column per channel adds the
//    blocks' partials in a fixed order.
//
// The wrapper takes the block count from the shape and the card's SM count
// alone (kernels/layer_norm_act.py::bwd_grid), so the same inputs give
// bitwise-equal dx, dgamma and dbeta on every run. The row means are a
// warp's xor butterfly and the warps' sums in a fixed order, as in K6.
//
// xhat, z, dz, dxh and dx are rounded products and sums (no fused
// multiply-add), in the plain PyTorch version's order; the activation's
// derivative is epilogue_act.cuh's, bit for bit K2's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue_act.cuh"

namespace {

using namespace dl4j;

constexpr int kFinalTx = 32;
constexpr int kFinalTy = 8;

template <int WPR>
__host__ __device__ constexpr int block_threads() {
  return 32 * (WPR > 4 ? WPR : 4);
}

// K6's row sum: the same bits in every thread of the row group.
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
layer_norm_act_bwd_partial(const T* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const float* __restrict__ mu,
                           const float* __restrict__ rstd,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ dg_part,
                           float* __restrict__ db_part, long long rows,
                           int cols, long long rows_per_block) {
  constexpr int G = 32 * WPR;
  constexpr int GROUPS = block_threads<WPR>() / G;
  extern __shared__ float smem[];  // [2][GROUPS][cols] when GROUPS > 1
  __shared__ float red[2][WPR];
  const int t = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  long long r_end = r_begin + rows_per_block;
  if (r_end > rows) r_end = rows;

  float acc_g[NV], acc_b[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    acc_g[k] = 0.0f;
    acc_b[k] = 0.0f;
  }
  // WPR > 1: one group per block, so every thread walks the same rows and
  // the barriers in row_sum are reached by the whole block
  for (long long r = r_begin + grp; r < r_end; r += GROUPS) {
    const float m = mu[r], rs = rstd[r];
    const T* xr = x + r * cols;
    const T* gr = dy + r * cols;
    float xh[NV], dxh[NV];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = t + k * G;
      xh[k] = 0.0f;
      dxh[k] = 0.0f;
      if (c < cols) {
        // gamma and beta come through the read-only cache for every row:
        // registers go to the row and the column sums
        const float g = __ldg(gamma + c);
        xh[k] = __fmul_rn(__fsub_rn(to_f32<T>(xr[c]), m), rs);
        const float z = affine(xh[k], g, __ldg(beta + c));
        const float dz = __fmul_rn(to_f32<T>(gr[c]), act_grad<ACT>(z));
        acc_g[k] = __fadd_rn(acc_g[k], __fmul_rn(dz, xh[k]));
        acc_b[k] += dz;
        dxh[k] = __fmul_rn(dz, g);
        s1 += dxh[k];
        s2 = __fadd_rn(s2, __fmul_rn(dxh[k], xh[k]));
      }
    }
    const float m1 = row_sum<WPR>(s1, red[0]) / (float)cols;
    const float m2 = row_sum<WPR>(s2, red[1]) / (float)cols;
    T* dr = dx + r * cols;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = t + k * G;
      if (c < cols) {
        const float d = __fsub_rn(__fsub_rn(dxh[k], m1), __fmul_rn(xh[k], m2));
        dr[c] = from_f32<T>(__fmul_rn(d, rs));
      }
    }
    if constexpr (WPR > 1) __syncthreads();  // red is reused by the next row
  }

  const long long o = (long long)blockIdx.x * cols;
  if constexpr (GROUPS == 1) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = t + k * G;
      if (c < cols) {
        dg_part[o + c] = acc_g[k];
        db_part[o + c] = acc_b[k];
      }
    }
  } else {
    float* sg = smem;
    float* sb = smem + GROUPS * cols;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = t + k * G;
      if (c < cols) {
        sg[grp * cols + c] = acc_g[k];
        sb[grp * cols + c] = acc_b[k];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      float a = sg[c], b = sb[c];
#pragma unroll
      for (int g = 1; g < GROUPS; ++g) {
        a += sg[g * cols + c];
        b += sb[g * cols + c];
      }
      dg_part[o + c] = a;
      db_part[o + c] = b;
    }
  }
}

__global__ void __launch_bounds__(kFinalTx * kFinalTy)
layer_norm_act_bwd_final(const float* __restrict__ dg_part,
                         const float* __restrict__ db_part,
                         float* __restrict__ dgamma,
                         float* __restrict__ dbeta, int blocks, int cols) {
  __shared__ float sm_g[kFinalTy][kFinalTx];
  __shared__ float sm_b[kFinalTy][kFinalTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kFinalTx + tx;
  float g = 0.0f, b = 0.0f;
  if (col < cols) {
    for (int i = ty; i < blocks; i += kFinalTy) {
      const long long o = (long long)i * cols + col;
      g += dg_part[o];
      b += db_part[o];
    }
  }
  sm_g[ty][tx] = g;
  sm_b[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && col < cols) {
    float sg = 0.0f, sb = 0.0f;
    for (int k = 0; k < kFinalTy; ++k) {
      sg += sm_g[k][tx];
      sb += sm_b[k][tx];
    }
    dgamma[col] = sg;
    dbeta[col] = sb;
  }
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;
  const float* mu;
  const float* rstd;
  const void* dy;
  void* dx;
  float* dg_part;
  float* db_part;
  long long rows;
  int cols;
  int blocks;
};

template <typename T, int ACT, int NV, int WPR>
void launch(const Args& a, cudaStream_t stream) {
  constexpr int threads = block_threads<WPR>();
  constexpr int groups = threads / (32 * WPR);
  const long long rows_per_block = (a.rows + a.blocks - 1) / a.blocks;
  const size_t smem = groups > 1 ? 2 * sizeof(float) * groups * (size_t)a.cols : 0;
  layer_norm_act_bwd_partial<T, ACT, NV, WPR><<<(unsigned)a.blocks, threads, smem, stream>>>(
      static_cast<const T*>(a.x), a.gamma, a.beta, a.mu, a.rstd,
      static_cast<const T*>(a.dy), static_cast<T*>(a.dx), a.dg_part,
      a.db_part, a.rows, a.cols, rows_per_block);
}

template <typename T, int ACT>
bool launch_cfg(int nv, int wpr, const Args& a, cudaStream_t st) {
  // the (NV, WPR) pairs of kernels/layer_norm_act.py::row_config
  if (wpr == 1 && nv == 8) launch<T, ACT, 8, 1>(a, st);
  else if (wpr == 1 && nv == 16) launch<T, ACT, 16, 1>(a, st);
  else if (wpr == 1 && nv == 24) launch<T, ACT, 24, 1>(a, st);
  else if (wpr == 1 && nv == 32) launch<T, ACT, 32, 1>(a, st);
  else if (wpr == 4 && nv == 32) launch<T, ACT, 32, 4>(a, st);
  else if (wpr == 8 && nv == 32) launch<T, ACT, 32, 8>(a, st);
  else return false;
  return true;
}

template <typename T>
bool launch_act(int act, int nv, int wpr, const Args& a, cudaStream_t st) {
  switch (act) {
    case IDENTITY: return launch_cfg<T, IDENTITY>(nv, wpr, a, st);
    case RELU: return launch_cfg<T, RELU>(nv, wpr, a, st);
    case RELU6: return launch_cfg<T, RELU6>(nv, wpr, a, st);
    case TANH: return launch_cfg<T, TANH>(nv, wpr, a, st);
    case SIGMOID: return launch_cfg<T, SIGMOID>(nv, wpr, a, st);
    case GELU: return launch_cfg<T, GELU>(nv, wpr, a, st);
    case GELU_EXACT: return launch_cfg<T, GELU_EXACT>(nv, wpr, a, st);
    default: return false;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16. (nv, wpr): one of row_config's pairs,
// with cols <= 32 * wpr * nv; blocks: the partial kernel's grid (at most
// 65535 and at most rows). partials: 2 * blocks * cols floats of scratch
// (dgamma's partials, then dbeta's). Returns the CUDA error of the launches
// (0 on success), or cudaErrorInvalidValue for a bad argument.
extern "C" int dl4j_layer_norm_act_bwd(
    const void* x, const float* gamma, const float* beta, const float* mu,
    const float* rstd, const void* dy, void* dx, float* dgamma, float* dbeta,
    float* partials, long long rows, int cols, int act, int dtype, int nv,
    int wpr, int blocks, void* stream) {
  if (rows <= 0 || cols <= 0 || (long long)cols > 32LL * wpr * nv ||
      blocks <= 0 || blocks > 65535 || blocks > rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{x, gamma, beta, mu, rstd, dy, dx, partials,
               partials + (long long)blocks * cols, rows, cols, blocks};
  bool ok = false;
  switch (dtype) {
    case 0: ok = launch_act<float>(act, nv, wpr, a, st); break;
    case 1: ok = launch_act<__nv_bfloat16>(act, nv, wpr, a, st); break;
    case 2: ok = launch_act<__half>(act, nv, wpr, a, st); break;
    default: break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((cols + kFinalTx - 1) / kFinalTx));
  const dim3 block(kFinalTx, kFinalTy);
  layer_norm_act_bwd_final<<<grid, block, 0, st>>>(
      a.dg_part, a.db_part, dgamma, dbeta, blocks, cols);
  return (int)cudaGetLastError();
}
