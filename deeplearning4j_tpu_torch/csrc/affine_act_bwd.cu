// K2: the affine-epilogue backward. Given dy = dL/dy for y = act(x*scale +
// shift):
//
//   z      = x*scale + shift                (recomputed, f32)
//   dz     = dy * act'(z)
//   dx     = dz*scale (dz when scale is null), in x's dtype
//   dscale = sum over rows of dz*x          (f32 [C])
//   dshift = sum over rows of dz            (f32 [C])
//
// Replaces deeplearning4j_tpu/ops/fused_epilogues.py::_fused_epilogue_affine_bwd
// (its pallas_call is in _affine_bwd_impl, the backward rule of the custom
// VJP that bn_act and bias_act reach).
//
// x, dy and dx are row-major [rows, C] buffers in f32, bf16 or f16; scale
// (may be null), shift, dscale and dshift are f32 vectors of length C.
//
// Bound: memory traffic. The kernel reads x and dy and writes dx once each
// (3*rows*C elements) plus four [C] vectors; a few dozen flops per element
// at most, far below the card's f32 rate.
//
// Design: the TPU kernel carried the per-channel sums in VMEM scratch
// across a sequential grid. Here blocks run in parallel, so the column
// sums are a deterministic two-stage reduction, with no atomics:
//
// 1. affine_act_bwd_partial: a 2-D grid. blockIdx.x picks a tile of
//    TX*VEC columns, blockIdx.y a group of consecutive rows. A block is
//    TX x TY threads (TX*TY = 256); thread (tx, ty) owns VEC adjacent
//    columns (16-byte vectors when C allows) and walks the group's rows
//    ty, ty+TY, ... writing dx and keeping its f32 sums in registers. The
//    block then adds its TY partial sums per column in a fixed order in
//    shared memory and writes one row of the partials [groups, C].
// 2. affine_act_bwd_final: one thread column per channel adds the groups'
//    partials in a fixed order.
//
// The wrapper picks TX and the group count from the shape alone (and the
// card's SM count), so the same inputs give bitwise-equal dscale and dshift
// on every run. TX adapts to C (C = 64 in f32 is 16 threads of 4 floats, so
// a warp reads two whole rows) and the group count to rows (many rows and
// few channels get many groups; few rows and wide C many column tiles). The
// row loop bound masks the ragged tail, so any row count works.
//
// z is recomputed with affine() (epilogue_act.cuh: a rounded product and a
// rounded sum, no fused multiply-add), exactly as K1 and the plain versions
// compute it, so the z differentiated here is bit for bit the z the forward
// activated: the ties at relu's 0 and relu6's 0 and 6 agree with the forward
// and with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue_act.cuh"

namespace {

using namespace dl4j;

constexpr int kThreads = 256;
constexpr int kFinalTx = 32;
constexpr int kFinalTy = kThreads / kFinalTx;

template <typename T, int ACT, int VEC, bool HAS_SCALE>
__global__ void __launch_bounds__(kThreads)
affine_act_bwd_partial(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ shift, const T* __restrict__ dy,
                       T* __restrict__ dx, float* __restrict__ ds_part,
                       float* __restrict__ db_part, long long rows, int cols,
                       long long rows_per_group) {
  extern __shared__ float smem[];  // [2][TY][TX*VEC]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tile = blockDim.x * VEC;
  const int c0 = blockIdx.x * tile + tx * VEC;
  const bool active = c0 < cols;  // on the vector path VEC divides cols
  const long long r_begin = (long long)blockIdx.y * rows_per_group;
  long long r_end = r_begin + rows_per_group;
  if (r_end > rows) r_end = rows;

  float s[VEC], b[VEC], acc_s[VEC], acc_b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    acc_s[j] = 0.0f;
    acc_b[j] = 0.0f;
    s[j] = (active && HAS_SCALE) ? __ldg(scale + c0 + j) : 1.0f;
    b[j] = active ? __ldg(shift + c0 + j) : 0.0f;
  }
  if (active) {
    for (long long r = r_begin + ty; r < r_end; r += blockDim.y) {
      const long long off = r * cols + c0;
      alignas(16) T xin[VEC];
      alignas(16) T gin[VEC];
      alignas(16) T out[VEC];
      if constexpr (VEC > 1) {
        *reinterpret_cast<uint4*>(xin) = __ldg(reinterpret_cast<const uint4*>(x + off));
        *reinterpret_cast<uint4*>(gin) = __ldg(reinterpret_cast<const uint4*>(dy + off));
      } else {
        xin[0] = x[off];
        gin[0] = dy[off];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f32<T>(xin[j]);
        const float z = HAS_SCALE ? affine(xf, s[j], b[j]) : xf + b[j];
        const float dz = to_f32<T>(gin[j]) * act_grad<ACT>(z);
        out[j] = from_f32<T>(HAS_SCALE ? dz * s[j] : dz);
        if constexpr (HAS_SCALE) acc_s[j] += dz * xf;
        acc_b[j] += dz;
      }
      if constexpr (VEC > 1) {
        *reinterpret_cast<uint4*>(dx + off) = *reinterpret_cast<const uint4*>(out);
      } else {
        dx[off] = out[0];
      }
    }
  }

  // block reduction over ty, in a fixed order
  const int ty_n = blockDim.y;
  float* sm_s = smem;
  float* sm_b = smem + ty_n * tile;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sm_s[ty * tile + tx * VEC + j] = acc_s[j];
    sm_b[ty * tile + tx * VEC + j] = acc_b[j];
  }
  __syncthreads();
  const int t = ty * blockDim.x + tx;
  const int col = blockIdx.x * tile + t;
  if (t < tile && col < cols) {
    float sum_s = 0.0f, sum_b = 0.0f;
    for (int k = 0; k < ty_n; ++k) {
      sum_s += sm_s[k * tile + t];
      sum_b += sm_b[k * tile + t];
    }
    const long long o = (long long)blockIdx.y * cols + col;
    if constexpr (HAS_SCALE) ds_part[o] = sum_s;
    db_part[o] = sum_b;
  }
}

__global__ void __launch_bounds__(kThreads)
affine_act_bwd_final(const float* __restrict__ ds_part,
                     const float* __restrict__ db_part,
                     float* __restrict__ dscale, float* __restrict__ dshift,
                     int groups, int cols) {
  __shared__ float sm_s[kFinalTy][kFinalTx];
  __shared__ float sm_b[kFinalTy][kFinalTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kFinalTx + tx;
  const bool has_scale = dscale != nullptr;
  float s = 0.0f, b = 0.0f;
  if (col < cols) {
    for (int g = ty; g < groups; g += kFinalTy) {
      const long long o = (long long)g * cols + col;
      if (has_scale) s += ds_part[o];
      b += db_part[o];
    }
  }
  sm_s[ty][tx] = s;
  sm_b[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && col < cols) {
    float sum_s = 0.0f, sum_b = 0.0f;
    for (int k = 0; k < kFinalTy; ++k) {
      sum_s += sm_s[k][tx];
      sum_b += sm_b[k][tx];
    }
    if (has_scale) dscale[col] = sum_s;
    dshift[col] = sum_b;
  }
}

template <typename T, int ACT, int VEC, bool HAS_SCALE>
void launch_partial(const void* x, const float* scale, const float* shift,
                    const void* dy, void* dx, float* ds_part, float* db_part,
                    long long rows, int cols, int tx, int groups,
                    cudaStream_t stream) {
  const int ty = kThreads / tx;
  const int tile = tx * VEC;
  const dim3 grid((unsigned)((cols + tile - 1) / tile), (unsigned)groups);
  const dim3 block((unsigned)tx, (unsigned)ty);
  const long long rows_per_group = (rows + groups - 1) / groups;
  const size_t smem = 2 * sizeof(float) * (size_t)kThreads * VEC;
  affine_act_bwd_partial<T, ACT, VEC, HAS_SCALE><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<const T*>(dy),
      static_cast<T*>(dx), ds_part, db_part, rows, cols, rows_per_group);
}

template <typename T, int ACT>
void launch_vec(const void* x, const float* scale, const float* shift,
                const void* dy, void* dx, float* ds_part, float* db_part,
                long long rows, int cols, int vec, int tx, int groups,
                cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    if (scale != nullptr)
      launch_partial<T, ACT, V, true>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, tx, groups, stream);
    else
      launch_partial<T, ACT, V, false>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, tx, groups, stream);
  } else {
    if (scale != nullptr)
      launch_partial<T, ACT, 1, true>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, tx, groups, stream);
    else
      launch_partial<T, ACT, 1, false>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, tx, groups, stream);
  }
}

template <typename T>
bool launch_act(int act, const void* x, const float* scale, const float* shift,
                const void* dy, void* dx, float* ds_part, float* db_part,
                long long rows, int cols, int vec, int tx, int groups,
                cudaStream_t st) {
  switch (act) {
    case IDENTITY: launch_vec<T, IDENTITY>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, vec, tx, groups, st); return true;
    case RELU: launch_vec<T, RELU>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, vec, tx, groups, st); return true;
    case RELU6: launch_vec<T, RELU6>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, vec, tx, groups, st); return true;
    case TANH: launch_vec<T, TANH>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, vec, tx, groups, st); return true;
    case SIGMOID: launch_vec<T, SIGMOID>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, vec, tx, groups, st); return true;
    case GELU: launch_vec<T, GELU>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, vec, tx, groups, st); return true;
    case GELU_EXACT: launch_vec<T, GELU_EXACT>(x, scale, shift, dy, dx, ds_part, db_part, rows, cols, vec, tx, groups, st); return true;
    default: return false;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16. vec: 1 when cols is a multiple of
// 16 / sizeof(T) and x, dy, dx are 16-byte aligned. tx: threads per block
// along the columns (a power of two <= 32); groups: row groups (gridDim.y).
// partials: 2 * groups * cols floats of scratch (dscale's partials, then
// dshift's). dscale is null exactly when scale is. Returns the CUDA error
// of the launches (0 on success), or cudaErrorInvalidValue for a bad
// argument.
extern "C" int dl4j_affine_act_bwd(const void* x, const float* scale,
                                   const float* shift, const void* dy,
                                   void* dx, float* dscale, float* dshift,
                                   float* partials, long long rows, int cols,
                                   int act, int dtype, int vec, int tx,
                                   int groups, void* stream) {
  if (rows <= 0 || cols <= 0 || groups <= 0 || groups > 65535 || tx <= 0 ||
      tx > 32 || (tx & (tx - 1)) != 0 || (scale == nullptr) != (dscale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ds_part = partials;
  float* db_part = partials + (long long)groups * cols;
  bool ok = false;
  switch (dtype) {
    case 0: ok = launch_act<float>(act, x, scale, shift, dy, dx, ds_part, db_part, rows, cols, vec, tx, groups, st); break;
    case 1: ok = launch_act<__nv_bfloat16>(act, x, scale, shift, dy, dx, ds_part, db_part, rows, cols, vec, tx, groups, st); break;
    case 2: ok = launch_act<__half>(act, x, scale, shift, dy, dx, ds_part, db_part, rows, cols, vec, tx, groups, st); break;
    default: break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((cols + kFinalTx - 1) / kFinalTx));
  const dim3 block(kFinalTx, kFinalTy);
  affine_act_bwd_final<<<grid, block, 0, st>>>(
      ds_part, db_part, dscale, dshift, groups, cols);
  return (int)cudaGetLastError();
}
