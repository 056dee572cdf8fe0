// K4 and K5: the flash-attention backward. From the forward's o (through
// di), m and l and the output gradient do, with s = q k^T * scale + kb[b],
//
//   p  = exp(s - m) * (1 / l)                 (recomputed, never stored)
//   dp = do v^T,    ds = p * (dp - di) * scale,    di = rowsum(o * do)
//   K4:  dq = ds k                            (ds rounded to k's type)
//   K5:  dv = p^T do,  dk = ds^T q            (p rounded to do's type, ds
//                                              to q's type)
//
// K4 replaces deeplearning4j_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// K5 ::_bwd_dkv_kernel (their pallas_calls are in _bwd_impl, reached from
// the custom VJP _flash_bwd). di is computed by the caller, as there.
//
// q and do are [B, H, Tq, d], k and v [B, H, Tk, d], each addressed through
// its own (batch, head, row) element strides with the last dimension
// contiguous (the head split of a [B, T, H*d] projection is read in place);
// dq, dk and dv are written through their own strides (the wrapper gives
// them q's, k's and v's layout). kb is the optional f32 key bias [B, Tk]
// (clamped to finfo(float32).min by the caller). m, l and di are f32
// [B*H, Tq]: one value per row, not the TPU's 128 replicated lanes; l is
// already the safe sum (1 where the sum was 0), and p multiplies by 1 / l
// as the TPU kernel does. The element type is f32, bf16 or f16; the math is
// f32, and each output is rounded once.
//
// The scores are recomputed bit for bit as K3 made them (row_dots and score
// of flash_attn_common.cuh), so a fully masked row, whose scores all equal
// m, gets s - m = 0 exactly and the uniform p = 1/Tk.
//
// Bound: at BERT-base shapes (T = 128, d = 64) K4 does 6 multiply-add
// passes of d per score (q k^T, do v^T, ds k) and K5 8 (q k^T, do v^T,
// p^T do, ds^T q); their f32 operations bound them (6 and 8 G T^2 d flops
// over 67 TFLOP/s are 1.9x and 2.1x the bytes over 3.35 TB/s).
//
// Design: CUDA cores and f32 fused multiply-adds; no atomics, so each
// output element is written once and a rerun is bitwise equal.
// - K4: one CTA of 4 warps per (batch*head, block of 64 query rows), the
//   TPU's sequential key grid as the loop inside it. The CTA's q and do
//   rows, and their m, 1/l and di, are staged once; each key tile of 32
//   rows of k and v is staged in shared memory (f32, rows padded to D+4
//   floats). A warp owns 16 query rows and lane j computes the scores and
//   dp of key j against them; the rounded ds tile goes through shared
//   memory so that each lane adds ds k for its own output columns (lane,
//   lane+32, ...). dq stays in registers.
// - K5: one CTA of 4 warps per (batch*head, block of 4*KR key rows), the
//   TPU's inner "arbitrary" query grid as the loop inside it. The CTA's k
//   and v rows (and their bias) are staged once; each query tile of 32 rows
//   of q and do (with m, 1/l and di) is staged in shared memory. A warp
//   owns KR key rows (16, or 8 at d > 64 to keep dk and dv in registers)
//   and lane i computes the scores and dp of query i against them; the
//   rounded p and ds tiles go through shared memory so that each lane adds
//   p^T do and ds^T q for its own columns. dk and dv stay in registers.
// Keys past Tk and queries past Tq get p = 0 and are not stored: ragged
// lengths and cross attention (Tq != Tk) need no padding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attn_common.cuh"

namespace {

using namespace dl4j;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;             // K4: query rows per warp
constexpr int kBQ = kWarps * kRows;   // K4: query rows per CTA
constexpr int kTile = 32;             // keys (K4) or queries (K5) per tile

template <int D>
__host__ __device__ constexpr int padded() { return D + 4; }

// K5: key rows per warp
template <int D>
__host__ __device__ constexpr int dkv_rows() { return D <= 64 ? 16 : 8; }

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kBQ * D + 2 * (size_t)kTile * padded<D>()
                          + 3 * (size_t)kBQ + (size_t)kWarps * kRows * kTile);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int KB = kWarps * dkv_rows<D>();
  return sizeof(float) * (2 * (size_t)KB * D + (size_t)KB
                          + 2 * (size_t)kTile * padded<D>() + 3 * (size_t)kTile
                          + 2 * (size_t)kWarps * dkv_rows<D>() * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ kb,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const float* __restrict__ di_in,
                         const T* __restrict__ dout, T* __restrict__ dq,
                         int H, int Tq, int Tk, int d, Strides qs, Strides ks,
                         Strides vs, Strides dos, Strides dqs, float scale) {
  constexpr int KS = padded<D>();
  constexpr int CPL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* sq = smem;                    // [kBQ][D]
  float* sdo = sq + kBQ * D;           // [kBQ][D]
  float* sk = sdo + kBQ * D;           // [kTile][KS]
  float* sv = sk + kTile * KS;         // [kTile][KS]
  float* sm = sv + kTile * KS;         // [kBQ] m
  float* sil = sm + kBQ;               // [kBQ] 1 / l
  float* sdi = sil + kBQ;              // [kBQ] di
  float* sds = sdi + kBQ;              // [kWarps][kRows][kTile]

  const int g = blockIdx.x;
  const int b = g / H;
  const int h = g - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;
  const float* kbrow = kb != nullptr ? kb + (long long)b * Tk : nullptr;

  stage_row_pairs<T, D, kBQ, kThreads>(sq, sdo, D, q + b * qs.b + h * qs.h,
                                       qs.t, dout + b * dos.b + h * dos.h,
                                       dos.t, q0, Tq, d);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < Tq;
    const long long at = (long long)g * Tq + q0 + r;
    sm[r] = in ? m_in[at] : 0.0f;
    sil[r] = in ? 1.0f / l_in[at] : 0.0f;
    sdi[r] = in ? di_in[at] : 0.0f;
  }

  float acc[kRows][CPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[r][j] = 0.0f;
  }
  const int w0 = warp * kRows;
  const float* qw = sq + w0 * D;
  const float* dow = sdo + w0 * D;
  float* dsw = sds + w0 * kTile;

  for (int j0 = 0; j0 < Tk; j0 += kTile) {
    __syncthreads();  // the rows are staged; the last tile is consumed
    stage_row_pairs<T, D, kTile, kThreads>(sk, sv, KS, kg, ks.t, vg, vs.t,
                                           j0, Tk, d);
    __syncthreads();

    // scores and dp of key j0 + lane against the warp's rows
    float s[kRows], dp[kRows];
    row_dots<D, kRows>(qw, D, sk + lane * KS, s);
    row_dots<D, kRows>(dow, D, sv + lane * KS, dp);
    const int key = j0 + lane;
    const bool valid = key < Tk;
    const float bias = (valid && kbrow != nullptr) ? kbrow[key] : 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = valid
          ? __fmul_rn(expf(__fsub_rn(score(s[r], scale, bias), sm[w0 + r])),
                      sil[w0 + r])
          : 0.0f;
      const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[r], sdi[w0 + r])),
                                 scale);
      dsw[r * kTile + lane] = to_f32<T>(from_f32<T>(ds));
    }
    __syncwarp();

    // acc[r][j] += sum over the tile's keys of ds[r][key] * k[key][lane+32j]
#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float kv[4][CPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) kv[u][j] = sk[(kk + u) * KS + lane + 32 * j];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(dsw + r * kTile + kk);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          float x = acc[r][j];
          x = fmaf(a.x, kv[0][j], x);
          x = fmaf(a.y, kv[1][j], x);
          x = fmaf(a.z, kv[2][j], x);
          x = fmaf(a.w, kv[3][j], x);
          acc[r][j] = x;
        }
      }
    }
    __syncwarp();
  }

  T* dqg = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + w0 + r;
    if (row < Tq) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        if (c < d) dqg[row * dqs.t + c] = from_f32<T>(acc[r][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ kb,
                          const float* __restrict__ m_in,
                          const float* __restrict__ l_in,
                          const float* __restrict__ di_in,
                          const T* __restrict__ dout, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int Tq, int Tk, int d,
                          Strides qs, Strides ks, Strides vs, Strides dos,
                          Strides dks, Strides dvs, float scale) {
  constexpr int QS = padded<D>();
  constexpr int CPL = D / 32;
  constexpr int KR = dkv_rows<D>();   // key rows per warp
  constexpr int KB = kWarps * KR;     // key rows per CTA
  extern __shared__ float smem[];
  float* sk = smem;                    // [KB][D]
  float* sv = sk + KB * D;             // [KB][D]
  float* sb = sv + KB * D;             // [KB] key bias
  float* sq = sb + KB;                 // [kTile][QS]
  float* sdo = sq + kTile * QS;        // [kTile][QS]
  float* sm = sdo + kTile * QS;        // [kTile] m
  float* sil = sm + kTile;             // [kTile] 1 / l
  float* sdi = sil + kTile;            // [kTile] di
  float* sp = sdi + kTile;             // [kWarps][KR][kTile]
  float* sds = sp + kWarps * KR * kTile;  // [kWarps][KR][kTile]

  const int g = blockIdx.x;
  const int b = g / H;
  const int h = g - b * H;
  const int k0 = blockIdx.y * KB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* qg = q + b * qs.b + h * qs.h;
  const T* dog = dout + b * dos.b + h * dos.h;

  stage_row_pairs<T, D, KB, kThreads>(sk, sv, D, k + b * ks.b + h * ks.h,
                                      ks.t, v + b * vs.b + h * vs.h, vs.t,
                                      k0, Tk, d);
  for (int r = threadIdx.x; r < KB; r += kThreads)
    sb[r] = (kb != nullptr && k0 + r < Tk) ? kb[(long long)b * Tk + k0 + r]
                                           : 0.0f;

  float dka[KR][CPL], dva[KR][CPL];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) dka[r][j] = dva[r][j] = 0.0f;
  }
  const int w0 = warp * KR;
  const float* kw = sk + w0 * D;
  const float* vw = sv + w0 * D;
  float* pw = sp + w0 * kTile;
  float* dsw = sds + w0 * kTile;

  for (int i0 = 0; i0 < Tq; i0 += kTile) {
    __syncthreads();  // the key rows are staged; the last tile is consumed
    stage_row_pairs<T, D, kTile, kThreads>(sq, sdo, QS, qg, qs.t, dog, dos.t,
                                           i0, Tq, d);
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const bool in = i0 + r < Tq;
      const long long at = (long long)g * Tq + i0 + r;
      sm[r] = in ? m_in[at] : 0.0f;
      sil[r] = in ? 1.0f / l_in[at] : 0.0f;
      sdi[r] = in ? di_in[at] : 0.0f;
    }
    __syncthreads();

    // scores and dp of query i0 + lane against the warp's key rows
    float s[KR], dp[KR];
    row_dots<D, KR>(kw, D, sq + lane * QS, s);
    row_dots<D, KR>(vw, D, sdo + lane * QS, dp);
    const bool qvalid = i0 + lane < Tq;
    const float m = sm[lane], il = sil[lane], di = sdi[lane];
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      const bool valid = qvalid && k0 + w0 + r < Tk;
      const float p = valid
          ? __fmul_rn(expf(__fsub_rn(score(s[r], scale, sb[w0 + r]), m)), il)
          : 0.0f;
      const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[r], di)), scale);
      pw[r * kTile + lane] = to_f32<T>(from_f32<T>(p));
      dsw[r * kTile + lane] = to_f32<T>(from_f32<T>(ds));
    }
    __syncwarp();

    // dv[r][j] += sum over the tile's queries of p[r][i] * do[i][lane+32j],
    // dk[r][j] += sum over the tile's queries of ds[r][i] * q[i][lane+32j]
#pragma unroll 2
    for (int ii = 0; ii < kTile; ii += 4) {
      float dov[4][CPL], qv[4][CPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          dov[u][j] = sdo[(ii + u) * QS + lane + 32 * j];
          qv[u][j] = sq[(ii + u) * QS + lane + 32 * j];
        }
      }
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(pw + r * kTile + ii);
        const float4 c = *reinterpret_cast<const float4*>(dsw + r * kTile + ii);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          float x = dva[r][j];
          x = fmaf(a.x, dov[0][j], x);
          x = fmaf(a.y, dov[1][j], x);
          x = fmaf(a.z, dov[2][j], x);
          x = fmaf(a.w, dov[3][j], x);
          dva[r][j] = x;
          float y = dka[r][j];
          y = fmaf(c.x, qv[0][j], y);
          y = fmaf(c.y, qv[1][j], y);
          y = fmaf(c.z, qv[2][j], y);
          y = fmaf(c.w, qv[3][j], y);
          dka[r][j] = y;
        }
      }
    }
    __syncwarp();
  }

  T* dkg = dk + b * dks.b + h * dks.h;
  T* dvg = dv + b * dvs.b + h * dvs.h;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int row = k0 + w0 + r;
    if (row < Tk) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        if (c < d) {
          dkg[row * dks.t + c] = from_f32<T>(dka[r][j]);
          dvg[row * dvs.t + c] = from_f32<T>(dva[r][j]);
        }
      }
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;  // within the default dynamic cap
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const float* kb,
              const float* m, const float* l, const float* di,
              const void* dout, void* dq, int B, int H, int Tq, int Tk, int d,
              const long long* st, float scale, cudaStream_t stream) {
  auto kernel = flash_attn_bwd_dq_kernel<T, D>;
  constexpr size_t bytes = dq_smem_bytes<D>();
  const int e = allow_smem(kernel, bytes);
  if (e != 0) return e;
  const dim3 grid((unsigned)(B * H), (unsigned)((Tq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kb, m, l, di, static_cast<const T*>(dout),
      static_cast<T*>(dq), H, Tq, Tk, d, at(st, 0), at(st, 1), at(st, 2),
      at(st, 3), at(st, 4), scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const float* kb,
               const float* m, const float* l, const float* di,
               const void* dout, void* dk, void* dv, int B, int H, int Tq,
               int Tk, int d, const long long* st, float scale,
               cudaStream_t stream) {
  auto kernel = flash_attn_bwd_dkv_kernel<T, D>;
  constexpr size_t bytes = dkv_smem_bytes<D>();
  constexpr int KB = kWarps * dkv_rows<D>();
  const int e = allow_smem(kernel, bytes);
  if (e != 0) return e;
  const dim3 grid((unsigned)(B * H), (unsigned)((Tk + KB - 1) / KB));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kb, m, l, di, static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, d, at(st, 0),
      at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5), scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dq_d(const void* q, const void* k, const void* v, const float* kb,
         const float* m, const float* l, const float* di, const void* dout,
         void* dq, int B, int H, int Tq, int Tk, int d, const long long* st,
         float scale, cudaStream_t s) {
  if (d <= 32) return launch_dq<T, 32>(q, k, v, kb, m, l, di, dout, dq, B, H, Tq, Tk, d, st, scale, s);
  if (d <= 64) return launch_dq<T, 64>(q, k, v, kb, m, l, di, dout, dq, B, H, Tq, Tk, d, st, scale, s);
  if (d <= 128) return launch_dq<T, 128>(q, k, v, kb, m, l, di, dout, dq, B, H, Tq, Tk, d, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dkv_d(const void* q, const void* k, const void* v, const float* kb,
          const float* m, const float* l, const float* di, const void* dout,
          void* dk, void* dv, int B, int H, int Tq, int Tk, int d,
          const long long* st, float scale, cudaStream_t s) {
  if (d <= 32) return launch_dkv<T, 32>(q, k, v, kb, m, l, di, dout, dk, dv, B, H, Tq, Tk, d, st, scale, s);
  if (d <= 64) return launch_dkv<T, 64>(q, k, v, kb, m, l, di, dout, dk, dv, B, H, Tq, Tk, d, st, scale, s);
  if (d <= 128) return launch_dkv<T, 128>(q, k, v, kb, m, l, di, dout, dk, dv, B, H, Tq, Tk, d, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int B, int H, int Tq, int Tk, int d, int block, int rows) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || d <= 0 || d > 128 ||
         (rows + block - 1) / block > 65535;
}

}  // namespace

// strides: 15 element strides, (batch, head, row) of q, k, v, do and dq in
// that order. dtype: 0 = f32, 1 = bf16, 2 = f16. kb may be null; m, l and di
// are f32 [B*H, Tq]. Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a shape, head dimension (1..128) or dtype the
// kernel does not take.
extern "C" int dl4j_flash_attn_bwd_dq(const void* q, const void* k,
                                      const void* v, const float* kb,
                                      const float* m, const float* l,
                                      const float* di, const void* dout,
                                      void* dq, int B, int H, int Tq, int Tk,
                                      int d, const long long* strides,
                                      float scale, int dtype, void* stream) {
  if (bad_shape(B, H, Tq, Tk, d, kBQ, Tq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dq_d<float>(q, k, v, kb, m, l, di, dout, dq, B, H, Tq, Tk, d, strides, scale, s);
    case 1: return dq_d<__nv_bfloat16>(q, k, v, kb, m, l, di, dout, dq, B, H, Tq, Tk, d, strides, scale, s);
    case 2: return dq_d<__half>(q, k, v, kb, m, l, di, dout, dq, B, H, Tq, Tk, d, strides, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// strides: 18 element strides, (batch, head, row) of q, k, v, do, dk and dv
// in that order; otherwise as dl4j_flash_attn_bwd_dq.
extern "C" int dl4j_flash_attn_bwd_dkv(const void* q, const void* k,
                                       const void* v, const float* kb,
                                       const float* m, const float* l,
                                       const float* di, const void* dout,
                                       void* dk, void* dv, int B, int H,
                                       int Tq, int Tk, int d,
                                       const long long* strides, float scale,
                                       int dtype, void* stream) {
  if (bad_shape(B, H, Tq, Tk, d, 4 * 8, Tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dkv_d<float>(q, k, v, kb, m, l, di, dout, dk, dv, B, H, Tq, Tk, d, strides, scale, s);
    case 1: return dkv_d<__nv_bfloat16>(q, k, v, kb, m, l, di, dout, dk, dv, B, H, Tq, Tk, d, strides, scale, s);
    case 2: return dkv_d<__half>(q, k, v, kb, m, l, di, dout, dk, dv, B, H, Tq, Tk, d, strides, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
