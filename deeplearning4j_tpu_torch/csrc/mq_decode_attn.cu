// K10: multi-query decode attention, the speculative verify window,
//
//   o[b, h, i] = softmax(q[b, h, i] k[b, h, :L+1+i]^T * scale)
//                v[b, h, :L+1+i],   i = 0 .. nq-1,  L = lengths[b],
//
// Replaces deeplearning4j_tpu/ops/flash_attention.py::_mq_decode_kernel
// (:220; pallas_call at :398 through _mq_impl :388 and
// decode_multiquery_attention :763), which decode_multiquery_dispatch
// (:1091) reaches from SelfAttentionLayer.decode_step when the paged
// engine verifies a window of k speculated tokens.
//
// q is [B, H, nq, d], k and v are [B, H, C, d], each addressed through its
// own (batch, head, row) element strides with the last dimension
// contiguous, so q is read in place from the head split of a [B, nq, H*d]
// projection. lengths is int32 [B]: the cache rows BEFORE the window (the
// window's own rows are already inserted at L .. L+nq-1). Query i may
// attend column c iff c < L + 1 + i; a query with L + 1 + i <= 0 sees no
// column and gets uniform weights over all C rows, as the TPU kernel gives
// it (there every score is finfo(float32).min, so p = 1 for every key;
// here every score of such a query is 0, the same p = 1). o is
// [B, H, nq, d] in q's type. The element type is f32, bf16 or f16; the
// math is f32: s = (q . k) * scale (a rounded product after the dot), an
// online softmax per query, p rounded to v's type before p v, the p v sums
// in f32, o = acc / l (l == 0 -> 1) rounded once.
//
// Bound: nq query rows per (b, h) do 4 nq d flops per key against 2 d
// elements of k and v, so at the verify window's nq = 4 in f32 the bytes
// still bound it: the rows [0, min(C, L + nq)) of k and v plus q, o and
// lengths over 3.35 TB/s. The TPU kernel streams the whole bucket and masks
// it; this one reads nothing past L + nq (all C only for a row whose first
// query is fully masked).
//
// Design: K9's split-KV scheme (decode_attn.cu) widened to a window. One
// CTA per (b, h, split) holds all nq query rows; each key of its chunk is
// loaded ONCE and scored against every query whose bound admits it, and
// each query keeps its own running max, sum and p v columns. The split
// count comes from C, B*H and the 132 SMs (kernels/decode_attention.py::
// num_splits), never from the lengths, so the host reads nothing off the
// device on a verify. Inside a CTA of 4 warps a key is owned by a group of
// D/COLS lanes, each holding COLS consecutive columns (one vector load per
// lane where d, the pointers and the strides allow 16-byte loads); COLS
// shrinks as the window grows so that the q and p v registers of KQ
// queries stay near 64 a lane. A group's dot product is an in-order fmaf
// chain over its lane's columns, summed over the group by xor shuffles.
// The key groups of a warp, then the warps of the CTA, are merged per query
// in a fixed order; with one split the CTA writes o, else it writes (m, l,
// acc) per query to f32 scratch and a second kernel merges the splits of a
// (b, h, i) row in split order. No atomics: a rerun is bitwise equal.
// Tensor cores, TMA and reading the pages in place of the gathered cache
// are left for later: at nq = 4 the kernel is bound by the bytes it reads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attn_common.cuh"

namespace {

using namespace dl4j;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplits = 64;
constexpr int kMaxQueries = 16;

template <int N>
struct VecOf;
template <>
struct VecOf<16> { using type = uint4; };
template <>
struct VecOf<8> { using type = uint2; };
template <>
struct VecOf<4> { using type = unsigned int; };

// Merge (m2, l2, acc2) into (m, l, acc): the state of the union of the two
// key sets. A side that saw no key has m = -inf and weight 0. Each term is
// a rounded product and a rounded sum, independent of the sides' order.
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[N],
                                      float m2, float l2,
                                      const float (&acc2)[N]) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;  // both empty
  const float wa = m == -INFINITY ? 0.0f : expf(m - M);
  const float wb = m2 == -INFINITY ? 0.0f : expf(m2 - M);
  l = __fadd_rn(__fmul_rn(l, wa), __fmul_rn(l2, wb));
#pragma unroll
  for (int i = 0; i < N; ++i)
    acc[i] = __fadd_rn(__fmul_rn(acc[i], wa), __fmul_rn(acc2[i], wb));
  m = M;
}

// COLS elements of one row from column c0 into f32, zero past d or when
// `pred` is false. VEC_OK: d is a multiple of 16 bytes' worth of elements
// and the base pointers and strides fall on 16 bytes, so one aligned load
// of COLS elements (COLS divides that count) serves.
template <typename T, int COLS, bool VEC_OK>
__device__ __forceinline__ void load_cols(float (&dst)[COLS],
                                          const T* __restrict__ row, int c0,
                                          int d, bool pred) {
  if constexpr (VEC_OK) {
    if (pred && c0 < d) {
      using V = typename VecOf<COLS * sizeof(T)>::type;
      const V raw = *reinterpret_cast<const V*>(row + c0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < COLS; ++i) dst[i] = to_f32<T>(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < COLS; ++i) dst[i] = 0.0f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < COLS; ++i)
      dst[i] = (pred && c0 + i < d) ? to_f32<T>(row[c0 + i]) : 0.0f;
  }
}

// Columns per lane: at most 16 bytes' worth, at least D / 32 (a key group
// fits a warp), and 32 / KQ where that is more, so that the q and p v
// registers (2 KQ COLS) stay near 64.
template <typename T, int D, int KQ>
struct Tile {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int WANT = D / 32 > 32 / KQ ? D / 32 : 32 / KQ;
  static constexpr int COLS = VEC < WANT ? VEC : WANT;
  static constexpr int LPK = D / COLS;      // lanes per key group
  static constexpr int KPW = 32 / LPK;      // key groups per warp
  static constexpr int NG = kWarps * KPW;   // key groups per CTA
  static constexpr int U = KQ <= 4 ? 4 : 2; // keys per group per step
};

template <typename T, int D, int KQ, bool VEC_OK>
__global__ void __launch_bounds__(kThreads)
mq_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ o, float* __restrict__ part_m,
                 float* __restrict__ part_l, float* __restrict__ part_acc,
                 int H, int C, int d, int nq, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale) {
  using TL = Tile<T, D, KQ>;
  constexpr int COLS = TL::COLS, LPK = TL::LPK, KPW = TL::KPW, NG = TL::NG,
                U = TL::U;
  static_assert(LPK >= 1 && LPK <= 32 && COLS * LPK == D, "head tile");

  __shared__ float sm_m[kWarps][KQ], sm_l[kWarps][KQ];
  __shared__ float sm_acc[kWarps][KQ][D];

  const int g = blockIdx.x;
  const int b = g / H;
  const int h = g - b * H;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPK;               // key group within the warp
  const int c0 = (lane - grp * LPK) * COLS;  // this lane's first column
  const int slot = warp * KPW + grp;        // key group within the CTA

  // rows the window reads: all C when query 0 is fully masked (uniform
  // weights), else [0, min(C, L + nq)); this split's chunk of them
  const long long L = lengths[b];
  const int rows = L + 1 <= 0 ? C : (int)min((long long)C, L + nq);
  const int chunk = (rows + splits - 1) / splits;
  const int j0 = min(split * chunk, rows);
  const int j1 = min(j0 + chunk, rows);

  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;

  float qv[KQ][COLS];
  float m[KQ], l[KQ], acc[KQ][COLS];
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    const T* qr = q + b * qs.b + h * qs.h + (long long)i * qs.t;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      qv[i][j] = (i < nq && c0 + j < d) ? to_f32<T>(qr[c0 + j]) : 0.0f;
      acc[i][j] = 0.0f;
    }
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }

  for (int base = j0; base < j1; base += U * NG) {
    float kk[U][COLS], vv[U][COLS];
    int key[U];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      key[u] = base + u * NG + slot;
      in[u] = key[u] < j1;
      load_cols<T, COLS, VEC_OK>(kk[u], kg + (long long)key[u] * ks.t, c0,
                                 d, in[u]);
      load_cols<T, COLS, VEC_OK>(vv[u], vg + (long long)key[u] * vs.t, c0,
                                 d, in[u]);
    }
#pragma unroll
    for (int i = 0; i < KQ; ++i) {
      if (i >= nq) break;  // nq is the same for the whole grid
      const long long bound = L + 1 + i;
      const bool uniform = bound <= 0;
      float s[U];
      float m_new = m[i];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < COLS; ++j) dot = fmaf(qv[i][j], kk[u][j], dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const bool ok = in[u] && (uniform || key[u] < bound);
        s[u] = !ok ? -INFINITY : (uniform ? 0.0f : __fmul_rn(dot, scale));
        m_new = fmaxf(m_new, s[u]);
      }
      if (m_new != -INFINITY) {  // some key of this group admitted
        const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_new);
        float li = l[i] * alpha;
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[i][j] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = s[u] == -INFINITY ? 0.0f : expf(s[u] - m_new);
          li += p;
          const float pr = to_f32<T>(from_f32<T>(p));  // p in v's type
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            acc[i][j] = fmaf(pr, vv[u][j], acc[i][j]);
        }
        l[i] = li;
        m[i] = m_new;
      }
    }
  }

  // per query, the warp's key groups merged pairwise by xor shuffles
  // (group 0 ends with the warp's state), then parked in shared memory
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    if (i >= nq) break;
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[i], off);
      float a2[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        a2[j] = __shfl_xor_sync(0xffffffffu, acc[i][j], off);
      merge<COLS>(m[i], l[i], acc[i], m2, l2, a2);
    }
    if (grp == 0) {
      if (lane == 0) {
        sm_m[warp][i] = m[i];
        sm_l[warp][i] = l[i];
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) sm_acc[warp][i][c0 + j] = acc[i][j];
    }
  }
  __syncthreads();

  // the warps, merged in order 0..3; one thread per (query, column)
  for (int idx = threadIdx.x; idx < nq * d; idx += kThreads) {
    const int i = idx / d;
    const int c = idx - i * d;
    float wm = sm_m[0][i], wl = sm_l[0][i];
    float wa[1] = {sm_acc[0][i][c]};
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float a2[1] = {sm_acc[w][i][c]};
      merge<1>(wm, wl, wa, sm_m[w][i], sm_l[w][i], a2);
    }
    if (splits == 1) {
      const float safe = wl == 0.0f ? 1.0f : wl;
      o[b * os.b + h * os.h + (long long)i * os.t + c] =
          from_f32<T>(wa[0] / safe);
      continue;
    }
    const long long p = ((long long)g * splits + split) * nq + i;
    part_acc[p * d + c] = wa[0];
    if (c == 0) {
      part_m[p] = wm;
      part_l[p] = wl;
    }
  }
}

// The splits of each (b, h, i) row merged in split order, then o = acc / l,
// rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mq_decode_combine(const float* __restrict__ part_m,
                  const float* __restrict__ part_l,
                  const float* __restrict__ part_acc, T* __restrict__ o,
                  int H, int d, int nq, int splits, Strides os) {
  const int g = blockIdx.x;
  const int b = g / H;
  const int h = g - b * H;
  for (int idx = threadIdx.x; idx < nq * d; idx += blockDim.x) {
    const int i = idx / d;
    const int c = idx - i * d;
    long long p = (long long)g * splits * nq + i;
    float wm = part_m[p], wl = part_l[p];
    float wa[1] = {part_acc[p * d + c]};
    for (int s = 1; s < splits; ++s) {
      p += nq;
      const float a2[1] = {part_acc[p * d + c]};
      merge<1>(wm, wl, wa, part_m[p], part_l[p], a2);
    }
    const float safe = wl == 0.0f ? 1.0f : wl;
    o[b * os.b + h * os.h + (long long)i * os.t + c] =
        from_f32<T>(wa[0] / safe);
  }
}

template <typename T, int D, int KQ, bool VEC_OK>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, float* pm, float* pl, float* pacc, int B, int H, int C,
           int d, int nq, int splits, const long long* st, float scale,
           cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((unsigned)(B * H), (unsigned)splits);
  mq_decode_kernel<T, D, KQ, VEC_OK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), pm, pl, pacc, H,
      C, d, nq, qs, ks, vs, os, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  mq_decode_combine<T><<<B * H, kThreads, 0, stream>>>(
      pm, pl, pacc, static_cast<T*>(o), H, d, nq, splits, os);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool VEC_OK>
int launch_q(const void* q, const void* k, const void* v, const int* lengths,
             void* o, float* pm, float* pl, float* pacc, int B, int H, int C,
             int d, int nq, int splits, const long long* st, float scale,
             cudaStream_t stream) {
  if (nq <= 4)
    return launch<T, D, 4, VEC_OK>(q, k, v, lengths, o, pm, pl, pacc, B, H,
                                   C, d, nq, splits, st, scale, stream);
  if (nq <= 8)
    return launch<T, D, 8, VEC_OK>(q, k, v, lengths, o, pm, pl, pacc, B, H,
                                   C, d, nq, splits, st, scale, stream);
  return launch<T, D, 16, VEC_OK>(q, k, v, lengths, o, pm, pl, pacc, B, H, C,
                                  d, nq, splits, st, scale, stream);
}

template <typename T, bool VEC_OK>
int launch_d(const void* q, const void* k, const void* v, const int* lengths,
             void* o, float* pm, float* pl, float* pacc, int B, int H, int C,
             int d, int nq, int splits, const long long* st, float scale,
             cudaStream_t stream) {
  if (d <= 32)
    return launch_q<T, 32, VEC_OK>(q, k, v, lengths, o, pm, pl, pacc, B, H,
                                   C, d, nq, splits, st, scale, stream);
  if (d <= 64)
    return launch_q<T, 64, VEC_OK>(q, k, v, lengths, o, pm, pl, pacc, B, H,
                                   C, d, nq, splits, st, scale, stream);
  return launch_q<T, 128, VEC_OK>(q, k, v, lengths, o, pm, pl, pacc, B, H, C,
                                  d, nq, splits, st, scale, stream);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const int* lengths,
             void* o, float* pm, float* pl, float* pacc, int B, int H, int C,
             int d, int nq, int splits, const long long* st, float scale,
             int vec_ok, cudaStream_t stream) {
  return vec_ok ? launch_d<T, true>(q, k, v, lengths, o, pm, pl, pacc, B, H,
                                    C, d, nq, splits, st, scale, stream)
                : launch_d<T, false>(q, k, v, lengths, o, pm, pl, pacc, B, H,
                                     C, d, nq, splits, st, scale, stream);
}

}  // namespace

// strides: 12 element strides: (batch, head, row) of q, k, v and o.
// part_m, part_l: f32 [B*H*splits*nq]; part_acc: f32 [B*H*splits*nq*d]
// (unused, may be null, when splits == 1). vec_ok: d, the k/v pointers and
// strides allow 16-byte loads. dtype: 0 = f32, 1 = bf16, 2 = f16. Returns
// the CUDA error of the launches (0 on success), or cudaErrorInvalidValue
// for a shape, head dimension (1..128), window (1..16 queries), split
// count (1..64) or dtype the kernel does not take.
extern "C" int dl4j_mq_decode_attn(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   void* o, float* part_m, float* part_l,
                                   float* part_acc, int B, int H, int C,
                                   int d, int nq, int splits,
                                   const long long* strides, float scale,
                                   int vec_ok, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || C <= 0 || d <= 0 || d > 128 || nq < 1 ||
      nq > kMaxQueries || splits < 1 || splits > kMaxSplits ||
      (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_t<float>(q, k, v, lengths, o, part_m, part_l, part_acc, B, H, C, d, nq, splits, strides, scale, vec_ok, st);
    case 1: return launch_t<__nv_bfloat16>(q, k, v, lengths, o, part_m, part_l, part_acc, B, H, C, d, nq, splits, strides, scale, vec_ok, st);
    case 2: return launch_t<__half>(q, k, v, lengths, o, part_m, part_l, part_acc, B, H, C, d, nq, splits, strides, scale, vec_ok, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
