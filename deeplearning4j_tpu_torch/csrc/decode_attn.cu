// K9: single-query decode attention over a length-masked KV cache,
//
//   o[b, h] = softmax(q[b, h] k[b, h, :L]^T * scale) v[b, h, :L],
//   L = lengths[b] clamped to the cache length C,
//
// Replaces deeplearning4j_tpu/ops/flash_attention.py::decode_attention
// (:576), which runs the flash forward kernel _fwd_kernel through _fwd_impl
// (:616) at bq = 1 with length_bias (:556) as the key bias; decode_dispatch
// (:1027) reaches it from SelfAttentionLayer.decode_step.
//
// q is [B, H, 1, d], k and v are [B, H, C, d], each addressed through its
// own (batch, head[, row]) element strides with the last dimension
// contiguous, so q is read in place from the head split of a [B, 1, H*d]
// projection. lengths is int32 [B]: the valid cache entries of each row,
// the just-appended token included. o is [B, H, 1, d] in q's type. The
// element type is f32, bf16 or f16; the math is f32: s = (q . k) * scale
// (a rounded product after the dot), an online softmax, p rounded to v's
// type before p v, the p v sums in f32, o rounded once.
//
// Rows with L <= 0 (an inactive slot, a fresh state) get uniform weights
// over all C rows, as the TPU kernel gives them: there every score is the
// clamped bias finfo(float32).min, so p = 1 for every key. Here every
// score of such a row is 0, which gives the same p = 1. L >= C reads all C
// rows.
//
// Bound: one query row per (b, h) does 4 d flops per key against 2 d
// elements of k and v read once, so the bytes bound it: the valid k/v rows
// plus q, o and lengths over 3.35 TB/s. The TPU kernel streams the whole
// bucket and masks it; this one reads nothing past L.
//
// Design (split-KV): a single query row would leave most of the card idle
// with one CTA per (b, h), so the grid is (B*H, splits) and each CTA takes
// a contiguous chunk of the row's L valid keys. The number of splits is
// picked on the host from the cache length C (an upper bound of L that
// needs no device read), B*H, and the 132 SMs (kernels/decode_attention.py
// ::num_splits): enough CTAs for about four per SM, at least 64 keys of C
// per split, at most 64 splits. Inside a CTA of 4 warps, a key is owned by
// a group of D/VEC lanes, each holding VEC consecutive columns (VEC = 16
// bytes of the element type, one 16-byte load per lane where d, the
// pointers and the strides allow); a warp holds 32*VEC/D such groups. A
// group's dot product is an in-order fmaf chain over its lane's columns
// summed over the group by xor shuffles, so every lane of the group has the
// same score. Each group keeps its own online softmax (m, l, and its
// lane's VEC columns of the p v sum), four keys per step with all their
// loads issued first. The groups of a warp, then the warps of the CTA, are
// merged in a fixed order; with one split the CTA writes o, else it writes
// (m, l, acc) to f32 scratch and a second kernel merges the splits of a
// row in split order. No atomics: a rerun is bitwise equal.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attn_common.cuh"

namespace {

using namespace dl4j;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // keys per group per step, loads issued first
constexpr int kMaxSplits = 64;

// Online-softmax state of one key group: running max, running sum, and the
// lane's columns of the p v sum.
template <int N>
struct State {
  float m, l, acc[N];
};

// Merge (m2, l2, acc2) into (m, l, acc): the state of the union of the two
// key sets. A side that saw no key has m = -inf and weight 0. The sums are
// a rounded product and a rounded sum per term, which do not depend on the
// order of the two sides.
template <int N>
__device__ __forceinline__ void merge(State<N>& a, float m2, float l2,
                                      const float (&acc2)[N]) {
  const float M = fmaxf(a.m, m2);
  if (M == -INFINITY) return;  // both empty
  const float wa = a.m == -INFINITY ? 0.0f : expf(a.m - M);
  const float wb = m2 == -INFINITY ? 0.0f : expf(m2 - M);
  a.l = __fadd_rn(__fmul_rn(a.l, wa), __fmul_rn(l2, wb));
#pragma unroll
  for (int i = 0; i < N; ++i)
    a.acc[i] = __fadd_rn(__fmul_rn(a.acc[i], wa), __fmul_rn(acc2[i], wb));
  a.m = M;
}

// VEC elements of one row from column c0 into f32, zero past d or when
// `pred` is false. VEC_OK: d, the base pointers and the strides allow one
// 16-byte load.
template <typename T, int VEC, bool VEC_OK>
__device__ __forceinline__ void load_cols(float (&dst)[VEC],
                                          const T* __restrict__ row, int c0,
                                          int d, bool pred) {
  if constexpr (VEC_OK) {
    if (pred && c0 < d) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + c0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[i] = to_f32<T>(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[i] = 0.0f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      dst[i] = (pred && c0 + i < d) ? to_f32<T>(row[c0 + i]) : 0.0f;
  }
}

template <typename T, int D, bool VEC_OK>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ o, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   int H, int C, int d, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LPK = D / VEC;            // lanes per key group
  static_assert(LPK >= 1 && LPK <= 32, "head tile");
  constexpr int KPW = 32 / LPK;           // key groups per warp
  constexpr int NG = kWarps * KPW;        // key groups per CTA

  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int g = blockIdx.x;
  const int b = g / H;
  const int h = g - b * H;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPK;             // key group within the warp
  const int c0 = (lane - grp * LPK) * VEC;  // this lane's first column
  const int slot = warp * KPW + grp;      // key group within the CTA

  const int len = lengths[b];
  const bool uniform = len <= 0;
  const int valid = uniform ? C : min(len, C);
  const int chunk = (valid + splits - 1) / splits;
  const int j0 = min(split * chunk, valid);
  const int j1 = min(j0 + chunk, valid);

  const T* qg = q + b * qs.b + h * qs.h;
  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;

  float qv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    qv[i] = c0 + i < d ? to_f32<T>(qg[c0 + i]) : 0.0f;

  State<VEC> st;
  st.m = -INFINITY;
  st.l = 0.0f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) st.acc[i] = 0.0f;

  for (int base = j0; base < j1; base += kUnroll * NG) {
    float kk[kUnroll][VEC], vv[kUnroll][VEC];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + u * NG + slot;
      in[u] = key < j1;
      load_cols<T, VEC, VEC_OK>(kk[u], kg + (long long)key * ks.t, c0, d,
                                in[u]);
      load_cols<T, VEC, VEC_OK>(vv[u], vg + (long long)key * vs.t, c0, d,
                                in[u]);
    }
    float s[kUnroll];
    float m_new = st.m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot = fmaf(qv[i], kk[u][i], dot);
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = !in[u] ? -INFINITY : (uniform ? 0.0f : __fmul_rn(dot, scale));
      m_new = fmaxf(m_new, s[u]);
    }
    if (m_new == -INFINITY) continue;  // no key of this group in the step
    const float alpha = st.m == -INFINITY ? 0.0f : expf(st.m - m_new);
    float l = st.l * alpha;
#pragma unroll
    for (int i = 0; i < VEC; ++i) st.acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = in[u] ? expf(s[u] - m_new) : 0.0f;
      l += p;
      const float pr = to_f32<T>(from_f32<T>(p));  // p in v's type
#pragma unroll
      for (int i = 0; i < VEC; ++i) st.acc[i] = fmaf(pr, vv[u][i], st.acc[i]);
    }
    st.l = l;
    st.m = m_new;
  }

  // the warp's key groups, merged pairwise by xor shuffles (group 0 ends
  // with the warp's state; every merge is symmetric in its two sides)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, st.m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, st.l, off);
    float a2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      a2[i] = __shfl_xor_sync(0xffffffffu, st.acc[i], off);
    merge<VEC>(st, m2, l2, a2);
  }
  if (grp == 0) {
    if (lane == 0) {
      sm_m[warp] = st.m;
      sm_l[warp] = st.l;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[warp][c0 + i] = st.acc[i];
  }
  __syncthreads();

  // the warps, merged in order 0..3; one thread per column
  const int c = threadIdx.x;
  if (c >= d) return;
  State<1> w;
  w.m = sm_m[0];
  w.l = sm_l[0];
  w.acc[0] = sm_acc[0][c];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    const float a2[1] = {sm_acc[i][c]};
    merge<1>(w, sm_m[i], sm_l[i], a2);
  }
  if (splits == 1) {
    const float safe = w.l == 0.0f ? 1.0f : w.l;
    o[b * os.b + h * os.h + c] = from_f32<T>(w.acc[0] / safe);
    return;
  }
  const long long p = (long long)g * splits + split;
  part_acc[p * d + c] = w.acc[0];
  if (c == 0) {
    part_m[p] = w.m;
    part_l[p] = w.l;
  }
}

// The splits of each (b, h) merged in split order, then o = acc / l,
// rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_combine(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ o,
                    int H, int d, int splits, Strides os) {
  const int g = blockIdx.x;
  const int b = g / H;
  const int h = g - b * H;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const long long p0 = (long long)g * splits;
    State<1> w;
    w.m = part_m[p0];
    w.l = part_l[p0];
    w.acc[0] = part_acc[p0 * d + c];
    for (int s = 1; s < splits; ++s) {
      const float a2[1] = {part_acc[(p0 + s) * d + c]};
      merge<1>(w, part_m[p0 + s], part_l[p0 + s], a2);
    }
    const float safe = w.l == 0.0f ? 1.0f : w.l;
    o[b * os.b + h * os.h + c] = from_f32<T>(w.acc[0] / safe);
  }
}

template <typename T, int D, bool VEC_OK>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, float* pm, float* pl, float* pacc, int B, int H, int C,
           int d, int splits, const long long* st, float scale,
           cudaStream_t stream) {
  const Strides qs{st[0], st[1], 0}, ks{st[2], st[3], st[4]},
      vs{st[5], st[6], st[7]}, os{st[8], st[9], 0};
  const dim3 grid((unsigned)(B * H), (unsigned)splits);
  decode_attn_kernel<T, D, VEC_OK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), pm, pl, pacc, H,
      C, d, qs, ks, vs, os, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  decode_attn_combine<T><<<B * H, kThreads, 0, stream>>>(
      pm, pl, pacc, static_cast<T*>(o), H, d, splits, os);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC_OK>
int launch_d(const void* q, const void* k, const void* v, const int* lengths,
             void* o, float* pm, float* pl, float* pacc, int B, int H, int C,
             int d, int splits, const long long* st, float scale,
             cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32, VEC_OK>(q, k, v, lengths, o, pm, pl, pacc, B, H, C,
                                 d, splits, st, scale, stream);
  if (d <= 64)
    return launch<T, 64, VEC_OK>(q, k, v, lengths, o, pm, pl, pacc, B, H, C,
                                 d, splits, st, scale, stream);
  return launch<T, 128, VEC_OK>(q, k, v, lengths, o, pm, pl, pacc, B, H, C,
                                d, splits, st, scale, stream);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const int* lengths,
             void* o, float* pm, float* pl, float* pacc, int B, int H, int C,
             int d, int splits, const long long* st, float scale, int vec_ok,
             cudaStream_t stream) {
  return vec_ok ? launch_d<T, true>(q, k, v, lengths, o, pm, pl, pacc, B, H,
                                    C, d, splits, st, scale, stream)
                : launch_d<T, false>(q, k, v, lengths, o, pm, pl, pacc, B, H,
                                     C, d, splits, st, scale, stream);
}

}  // namespace

// strides: 10 element strides: (batch, head) of q, (batch, head, row) of k
// and v, (batch, head) of o. part_m, part_l: f32 [B*H*splits]; part_acc:
// f32 [B*H*splits*d] (unused, may be null, when splits == 1). vec_ok: d,
// the pointers and the strides allow 16-byte loads. dtype: 0 = f32, 1 =
// bf16, 2 = f16. Returns the CUDA error of the launches (0 on success), or
// cudaErrorInvalidValue for a shape, head dimension (1..128), split count
// (1..64) or dtype the kernel does not take.
extern "C" int dl4j_decode_attn(const void* q, const void* k, const void* v,
                                const int* lengths, void* o, float* part_m,
                                float* part_l, float* part_acc, int B, int H,
                                int C, int d, int splits,
                                const long long* strides, float scale,
                                int vec_ok, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || C <= 0 || d <= 0 || d > 128 || splits < 1 ||
      splits > kMaxSplits || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_t<float>(q, k, v, lengths, o, part_m, part_l, part_acc, B, H, C, d, splits, strides, scale, vec_ok, st);
    case 1: return launch_t<__nv_bfloat16>(q, k, v, lengths, o, part_m, part_l, part_acc, B, H, C, d, splits, strides, scale, vec_ok, st);
    case 2: return launch_t<__half>(q, k, v, lengths, o, part_m, part_l, part_acc, B, H, C, d, splits, strides, scale, vec_ok, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
