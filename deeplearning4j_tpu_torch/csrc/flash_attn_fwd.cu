// K3: the flash-attention forward,
//
//   o = softmax(q k^T * scale + kb[b]) v,   m = row max,   l = row sum,
//
// Replaces deeplearning4j_tpu/ops/flash_attention.py::_fwd_kernel (its
// pallas_call is in _fwd_impl; attention -> flash_attention -> _flash
// reach it, and the SameDiff op attention.fused_sdpa enters attention).
//
// q is [B, H, Tq, d], k and v are [B, H, Tk, d], o has q's shape; each is
// addressed through its own (batch, head, row) element strides, with the
// last dimension contiguous, so the head-split views a transformer makes
// ([B, T, H, d] memory read as [B, H, T, d]) need no copy. kb is the
// optional f32 key bias [B, Tk] (the mask, already clamped to
// finfo(float32).min by the wrapper), shared by the H heads of a batch
// row. m and l are f32 [B*H, Tq]: the final running max and the row sum
// of exp(s - m) (1 where that sum is 0), which the backward will read.
// The element type is f32, bf16 or f16; the math is f32: the scores, the
// softmax and the accumulation of p v, with p rounded to v's type before
// the product (the TPU kernel's p.astype(v.dtype)), and o rounded once.
//
// Bound: at BERT-base shapes (T = 128, d = 64) a score costs 2d flops in
// q k^T and 2d in p v and the inputs are read once, so the f32 operations
// bound it (4 G T^2 d over 67 TFLOP/s is 1.6x the bytes over 3.35 TB/s).
//
// Design: one CTA of 4 warps per (batch*head, block of 64 query rows); the
// TPU's sequential key grid is the loop inside the CTA. The q block is
// converted to f32 into shared memory once. Each key tile of 32 rows of k
// and v is staged in shared memory (f32, rows padded to D+4 floats so the
// 16-byte reads of 8 consecutive rows hit 32 distinct banks), zero beyond
// Tk and beyond d. Each warp owns 16 query rows: lane j computes the
// scores of key j against its 16 rows (float4 reads of k row j, broadcast
// reads of q), the row max comes from a warp shuffle, and the online
// softmax (f32 running max m, per-lane partial sums of l, the running
// p v sums rescaled by alpha = exp(m_old - m_new)) stays in registers.
// The rounded p tile goes through shared memory so that each lane can
// add p v for its own output columns (lane, lane+32, ...), reading v
// rows conflict-free. Keys past Tk get s = -inf (p = 0), query rows past
// Tq are computed but not stored: ragged lengths need no padding and no
// shape fallback. A fully masked row has all scores equal to the clamped
// bias, so it gets uniform attention, as in the plain version.
//
// s = dot * scale + kb is a rounded product and a rounded sum (no fused
// multiply-add), as in the plain version; the dot products and sums run in
// another order than PyTorch's, and expf may differ from PyTorch's exp by
// an ulp. The score routine is flash_attn_common.cuh's, which K4 and K5
// share, so the backward recomputes these scores bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attn_common.cuh"

namespace {

using namespace dl4j;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;               // query rows per warp
constexpr int kBQ = kWarps * kRows;     // query rows per CTA
constexpr int kBK = 32;                 // keys per tile: one per lane

template <int D>
__host__ __device__ constexpr int kv_stride() { return D + 4; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * D + 2 * (size_t)kBK * kv_stride<D>()
                          + (size_t)kWarps * kRows * kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ kb,
                      T* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int H, int Tq, int Tk, int d,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      float scale) {
  constexpr int KS = kv_stride<D>();
  constexpr int CPL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* sq = smem;                    // [kBQ][D]
  float* sk = sq + kBQ * D;            // [kBK][KS]
  float* sv = sk + kBK * KS;           // [kBK][KS]
  float* sp = sv + kBK * KS;           // [kWarps][kRows][kBK]

  const int g = blockIdx.x;
  const int b = g / H;
  const int h = g - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* qg = q + b * qs.b + h * qs.h;
  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;
  const float* kbrow = kb != nullptr ? kb + (long long)b * Tk : nullptr;

  stage_rows<T, D, kBQ, kThreads>(sq, D, qg, qs.t, q0, Tq, d);

  float acc[kRows][CPL];
  float m_run[kRows];
  float l_run[kRows];  // this lane's share of the row sum
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[r][j] = 0.0f;
  }

  const float* qw = sq + warp * kRows * D;
  float* pw = sp + warp * kRows * kBK;

  for (int j0 = 0; j0 < Tk; j0 += kBK) {
    __syncthreads();  // the q block is stored; the last tile is consumed
    stage_row_pairs<T, D, kBK, kThreads>(sk, sv, KS, kg, ks.t, vg, vs.t, j0,
                                         Tk, d);
    __syncthreads();

    // scores of key j0 + lane against the warp's rows
    float s[kRows];
    row_dots<D, kRows>(qw, D, sk + lane * KS, s);
    const int key = j0 + lane;
    const bool valid = key < Tk;
    const float bias = (valid && kbrow != nullptr) ? kbrow[key] : 0.0f;

    // online softmax; p rounded to v's type goes to the warp's p tile
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sr = valid ? score(s[r], scale, bias) : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(sr));
      const float alpha = expf(m_run[r] - m_new);
      const float p = expf(sr - m_new);
      l_run[r] = fmaf(l_run[r], alpha, p);
      m_run[r] = m_new;
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[r][j] *= alpha;
      pw[r * kBK + lane] = to_f32<T>(from_f32<T>(p));
    }
    __syncwarp();

    // acc[r][j] += sum over the tile's keys of p[r][key] * v[key][lane + 32 j]
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float vv[4][CPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) vv[u][j] = sv[(kk + u) * KS + lane + 32 * j];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(pw + r * kBK + kk);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          float a = acc[r][j];
          a = fmaf(pp.x, vv[0][j], a);
          a = fmaf(pp.y, vv[1][j], a);
          a = fmaf(pp.z, vv[2][j], a);
          a = fmaf(pp.w, vv[3][j], a);
          acc[r][j] = a;
        }
      }
    }
    __syncwarp();
  }

  T* og = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float l = warp_sum(l_run[r]);
    const float safe = l == 0.0f ? 1.0f : l;
    const int row = q0 + warp * kRows + r;
    if (row < Tq) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        if (c < d) og[row * os.t + c] = from_f32<T>(acc[r][j] / safe);
      }
      if (lane == 0) {
        m_out[(long long)g * Tq + row] = m_run[r];
        l_out[(long long)g * Tq + row] = safe;
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* kb,
           void* o, float* m, float* l, int B, int H, int Tq, int Tk, int d,
           const long long* st, float scale, cudaStream_t stream) {
  auto kernel = flash_attn_fwd_kernel<T, D>;
  constexpr size_t bytes = smem_bytes<D>();
  if constexpr (bytes > 48 * 1024) {  // above the default dynamic cap
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((Tq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kb, static_cast<T*>(o), m, l, H, Tq, Tk, d,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const float* kb,
             void* o, float* m, float* l, int B, int H, int Tq, int Tk, int d,
             const long long* st, float scale, cudaStream_t stream) {
  if (d <= 32) return launch<T, 32>(q, k, v, kb, o, m, l, B, H, Tq, Tk, d, st, scale, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, kb, o, m, l, B, H, Tq, Tk, d, st, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, kb, o, m, l, B, H, Tq, Tk, d, st, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 element strides, (batch, head, row) of q, k, v and o in that
// order. dtype: 0 = f32, 1 = bf16, 2 = f16. kb may be null. Returns the CUDA
// error of the launch (0 on success), or cudaErrorInvalidValue for a shape,
// head dimension (1..128) or dtype the kernel does not take.
extern "C" int dl4j_flash_attn_fwd(const void* q, const void* k, const void* v,
                                   const float* kb, void* o, float* m, float* l,
                                   int B, int H, int Tq, int Tk, int d,
                                   const long long* strides, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || d <= 0 || d > 128 ||
      (Tq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, kb, o, m, l, B, H, Tq, Tk, d, strides, scale, st);
    case 1: return launch_d<__nv_bfloat16>(q, k, v, kb, o, m, l, B, H, Tq, Tk, d, strides, scale, st);
    case 2: return launch_d<__half>(q, k, v, kb, o, m, l, B, H, Tq, Tk, d, strides, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
