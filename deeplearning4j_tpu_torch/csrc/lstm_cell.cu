// K8: one LSTM step, gate order [i, f, o, g].
//
// Replaces deeplearning4j_tpu/ops/pallas_kernels.py::_lstm_kernel (its
// pallas_call is in lstm_cell_fused). Computes, for every batch row b and
// unit j of a [B, F] input x, a [B, U] state (h, c), weights W [F, 4U],
// RW [U, 4U] and bias [4U]:
//
//   z   = x @ W + h @ RW + bias                   (f32 accumulation)
//   i   = sigmoid(z[:, j]),  f = sigmoid(z[:, U + j] + forget_bias)
//   o   = sigmoid(z[:, 2U + j]),  g = tanh(z[:, 3U + j])
//   c'  = f * c + i * g,  h' = o * tanh(c')
//
// and writes h' and c' rounded once to x's dtype. Inputs are f32, bf16 or
// f16, all of one type; a 16-bit value is exact in f32, so the products are
// exact and only the sums round, as with the TPU kernel's
// preferred_element_type=f32. The bias is added after the products, the
// forget bias inside the gate (not folded into the bias), c is read as f32.
//
// Bound: at the serving shapes (B = 32, F + U = 333 or 512, U = 256) one
// step moves about 1-2 MB (the weights dominate) and does 2B(F+U)4U flops,
// so bytes and operations take about the same least time, both under a
// microsecond; the launch costs more. The TPU kernel held all operands in
// VMEM in one block; here blocks run in parallel on 132 SMs and nothing
// carries over between them.
//
// Design (a simple, right kernel first):
// - A block of 256 threads owns a tile of BT batch rows and UT = 8 units,
//   and computes the four gate columns {j, U + j, 2U + j, 3U + j} of each,
//   so the whole gate chain finishes in registers. BT is 1, 2, 4 or 8 (the
//   least power of two that covers B, at most 8); the rest of the block's
//   threads split the reduction: KS = 256 / (BT * UT) slices of each
//   64-wide chunk of the reduction axis. At U = 256 the grid is 32 unit
//   tiles times ceil(B / BT) row tiles (128 blocks at B = 32), which
//   spreads the step over the SMs where one wide unit tile would not.
// - The reduction runs over the concatenated axis [x | h] of length F + U
//   (first over F with W, then over U with RW), staging each chunk of the
//   operands in shared memory as f32: the x/h rows of the tile and the
//   4 * UT weight columns. The next chunk's loads are in flight in
//   registers while the current chunk's products run.
// - Each thread keeps four f32 sums (one per gate) over its slice; the
//   slices are added in a fixed order (slice 0, 1, ...) through shared
//   memory. Every output element is written once by one thread, with no
//   atomics, so reruns are bitwise equal.
// - x, h and c are read through a row stride (x_t = x[:, t, :] of a
//   [B, T, F] sequence is read in place); W, RW, bias and the outputs are
//   contiguous.
// - c' = f*c + i*g and h' = o*tanh(c') are rounded products and sums (no
//   fused multiply-add), as in the plain version; expf and tanhf may differ
//   from PyTorch's by an ulp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue_act.cuh"

namespace {

using namespace dl4j;

constexpr int kThreads = 256;
constexpr int kUnits = 8;    // UT: units per block
constexpr int kChunk = 64;   // reduction-axis elements staged per step

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const T* __restrict__ x, long long sx,
                 const T* __restrict__ h, long long sh,
                 const T* __restrict__ c, long long sc,
                 const T* __restrict__ w, const T* __restrict__ rw,
                 const T* __restrict__ bias, T* __restrict__ h_out,
                 T* __restrict__ c_out, int B, int F, int U,
                 float forget_bias) {
  constexpr int kTile = BT * kUnits;       // (row, unit) pairs per block
  constexpr int kSlices = kThreads / kTile;
  constexpr int kPer = kChunk / kSlices;   // chunk elements per slice
  constexpr int kCols = 4 * kUnits;        // weight columns per block

  __shared__ float xs[BT][kChunk + 1];
  __shared__ float ws[kChunk][kCols + 1];
  __shared__ float4 red[kThreads];

  const int tid = threadIdx.x;
  const int e = tid % kTile;
  const int s = tid / kTile;
  const int r = e / kUnits;
  const int j = e % kUnits;
  const int row0 = blockIdx.y * BT;
  const int unit0 = blockIdx.x * kUnits;
  const int K = F + U;
  const long long ld = 4LL * U;  // row length of W and RW

  // Each thread stages kXPer operand-row values and kWPer weight values
  // of a chunk. The loads of chunk k0 + kChunk are issued into registers
  // before the products of chunk k0 run, so their latency overlaps the
  // arithmetic; every load is predicated (0 outside the tensors), with no
  // branch between them, so all of a thread's loads are in flight at once.
  constexpr int kXPer = (BT * kChunk + kThreads - 1) / kThreads;
  constexpr int kWPer = kChunk * kCols / kThreads;
  float xv[kXPer];
  float wv[kWPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kXPer; ++it) {
      const int idx = tid + it * kThreads;
      const int row = row0 + idx / kChunk;
      const int k = k0 + idx % kChunk;
      const bool ok = idx < BT * kChunk && row < B && k < K;
      const T* src = k < F ? x + row * sx + k : h + row * sh + (k - F);
      xv[it] = ok ? to_f32<T>(*src) : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < kWPer; ++it) {
      const int idx = tid + it * kThreads;
      const int k = k0 + idx / kCols;
      const int col = idx % kCols;
      const int unit = unit0 + col % kUnits;
      const bool ok = k < K && unit < U;
      const long long wc = (long long)(col / kUnits) * U + unit;
      const T* src = k < F ? w + k * ld + wc : rw + (k - F) * ld + wc;
      wv[it] = ok ? to_f32<T>(*src) : 0.0f;
    }
  };

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kChunk) {
#pragma unroll
    for (int it = 0; it < kXPer; ++it) {
      const int idx = tid + it * kThreads;
      if (idx < BT * kChunk) xs[idx / kChunk][idx % kChunk] = xv[it];
    }
#pragma unroll
    for (int it = 0; it < kWPer; ++it) {
      const int idx = tid + it * kThreads;
      ws[idx / kCols][idx % kCols] = wv[it];
    }
    __syncthreads();
    if (k0 + kChunk < K) fetch(k0 + kChunk);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int kk = s * kPer + q;
      const float a = xs[r][kk];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[g] = fmaf(a, ws[kk][g * kUnits + j], acc[g]);
      }
    }
    __syncthreads();
  }

  red[tid] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (s != 0) return;
  for (int t = 1; t < kSlices; ++t) {  // fixed order: reruns are bitwise equal
    const float4 p = red[t * kTile + e];
    acc[0] += p.x;
    acc[1] += p.y;
    acc[2] += p.z;
    acc[3] += p.w;
  }
  const int row = row0 + r;
  const int unit = unit0 + j;
  if (row >= B || unit >= U) return;
  const float zi = acc[0] + to_f32<T>(bias[unit]);
  const float zf = acc[1] + to_f32<T>(bias[U + unit]);
  const float zo = acc[2] + to_f32<T>(bias[2 * U + unit]);
  const float zg = acc[3] + to_f32<T>(bias[3 * U + unit]);
  const float ig = act_fn<SIGMOID>(zi);
  const float fg = act_fn<SIGMOID>(zf + forget_bias);
  const float og = act_fn<SIGMOID>(zo);
  const float gg = act_fn<TANH>(zg);
  const float cp = to_f32<T>(c[row * sc + unit]);
  const float cn = __fadd_rn(__fmul_rn(fg, cp), __fmul_rn(ig, gg));
  const float hn = __fmul_rn(og, act_fn<TANH>(cn));
  h_out[(long long)row * U + unit] = from_f32<T>(hn);
  c_out[(long long)row * U + unit] = from_f32<T>(cn);
}

template <typename T>
bool launch(int row_tile, const void* x, long long sx, const void* h,
            long long sh, const void* c, long long sc, const void* w,
            const void* rw, const void* bias, void* h_out, void* c_out,
            int B, int F, int U, float forget_bias, cudaStream_t stream) {
  const dim3 grid((U + kUnits - 1) / kUnits, (B + row_tile - 1) / row_tile);
  const T* xp = static_cast<const T*>(x);
  const T* hp = static_cast<const T*>(h);
  const T* cp = static_cast<const T*>(c);
  const T* wp = static_cast<const T*>(w);
  const T* rwp = static_cast<const T*>(rw);
  const T* bp = static_cast<const T*>(bias);
  T* ho = static_cast<T*>(h_out);
  T* co = static_cast<T*>(c_out);
  switch (row_tile) {
    case 1: lstm_cell_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xp, sx, hp, sh, cp, sc, wp, rwp, bp, ho, co, B, F, U, forget_bias); return true;
    case 2: lstm_cell_kernel<T, 2><<<grid, kThreads, 0, stream>>>(xp, sx, hp, sh, cp, sc, wp, rwp, bp, ho, co, B, F, U, forget_bias); return true;
    case 4: lstm_cell_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xp, sx, hp, sh, cp, sc, wp, rwp, bp, ho, co, B, F, U, forget_bias); return true;
    case 8: lstm_cell_kernel<T, 8><<<grid, kThreads, 0, stream>>>(xp, sx, hp, sh, cp, sc, wp, rwp, bp, ho, co, B, F, U, forget_bias); return true;
    default: return false;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16 (every operand of that type). sx, sh,
// sc: row strides of x, h and c in elements (their last dimension is
// contiguous). row_tile: 1, 2, 4 or 8 batch rows per block. Returns the
// CUDA error of the launch (0 on success), or cudaErrorInvalidValue for an
// unknown dtype or row tile, or a shape the grid cannot hold.
extern "C" int dl4j_lstm_cell(const void* x, long long sx, const void* h,
                              long long sh, const void* c, long long sc,
                              const void* w, const void* rw, const void* bias,
                              void* h_out, void* c_out, int B, int F, int U,
                              float forget_bias, int dtype, int row_tile,
                              void* stream) {
  if (B <= 0 || F < 0 || U <= 0) return (int)cudaErrorInvalidValue;
  if ((B + row_tile - 1) / (row_tile > 0 ? row_tile : 1) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (dtype) {
    case 0: ok = launch<float>(row_tile, x, sx, h, sh, c, sc, w, rw, bias, h_out, c_out, B, F, U, forget_bias, st); break;
    case 1: ok = launch<__nv_bfloat16>(row_tile, x, sx, h, sh, c, sc, w, rw, bias, h_out, c_out, B, F, U, forget_bias, st); break;
    case 2: ok = launch<__half>(row_tile, x, sx, h, sh, c, sc, w, rw, bias, h_out, c_out, B, F, U, forget_bias, st); break;
    default: break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
