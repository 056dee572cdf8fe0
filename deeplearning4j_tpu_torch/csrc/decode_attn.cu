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
// Design (split-KV in one launch): a single query row would leave most of
// the card idle with one CTA per (b, h), so the grid is (B*H, splits) and
// each CTA takes a contiguous chunk of the row's L valid keys. The number
// of splits is picked on the host from the cache length C (an upper bound
// of L that needs no device read), B*H, and the 132 SMs
// (kernels/decode_attention.py::num_splits): enough CTAs for about four
// per SM, at least 64 keys of C per split, at most 8 splits, the portable
// cluster size. Where the grid has fewer than two CTAs an SM the CTA has 8
// warps, else 4 (the host's choice, `threads`). Inside a CTA, a key is
// owned by a group of D/VEC lanes, each holding VEC consecutive columns
// (VEC = 16 bytes of the element type, one 16-byte load per lane where d,
// the pointers and the strides allow); a warp holds 32*VEC/D such groups.
// A group's dot product is an in-order fmaf chain over its lane's columns
// summed over the group by xor shuffles, so every lane of the group has
// the same score. Each group keeps its own online softmax (m, l, and its
// lane's VEC columns of the p v sum), four keys per step with all their
// loads issued first. The groups of a warp, then the warps of the CTA, are
// merged in a fixed order. With one split the CTA writes o. Else the
// splits of a row form one thread-block cluster of (1, splits, 1) CTAs:
// each rank stores its merged (m, l, acc[d]) into its own slot of rank 0's
// shared memory (distributed shared memory), and after one cluster barrier
// rank 0 merges the slots in rank order and writes o. One kernel, no
// device-memory scratch, no atomics: a rerun is bitwise equal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"
#include "flash_attn_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dl4j;

constexpr int kUnroll = 4;  // keys per group per step, loads issued first
constexpr int kMaxSplits = 8;  // the portable cluster size

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

// One slot of rank 0's shared memory per rank of a cluster: the rank's
// merged state.
template <int D>
struct Slot {
  float m, l, acc[D];
};

template <typename T, int D, int W, bool VEC_OK>
__global__ void __launch_bounds__(32 * W)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ o, int H, int C, int d, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LPK = D / VEC;            // lanes per key group
  static_assert(LPK >= 1 && LPK <= 32, "head tile");
  constexpr int KPW = 32 / LPK;           // key groups per warp
  constexpr int NG = W * KPW;             // key groups per CTA

  __shared__ float sm_m[W], sm_l[W];
  __shared__ float sm_acc[W][D];
  __shared__ Slot<D> slots[kMaxSplits];   // rank 0's, filled by every rank

  // the cluster spans the grid's y: rank = split
  const int splits = gridDim.y;
  if (splits > 1) cluster_arrive();  // waited on before the remote stores

  const int g = blockIdx.x;
  const int b = g / H;
  const int h = g - b * H;
  const int split = blockIdx.y;
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

  // the warps, merged in order; one thread per column (every thread stays
  // for the cluster barriers)
  const int c = threadIdx.x;
  const bool col = c < d;
  State<1> w;
  if (col) {
    w.m = sm_m[0];
    w.l = sm_l[0];
    w.acc[0] = sm_acc[0][c];
#pragma unroll
    for (int i = 1; i < W; ++i) {
      const float a2[1] = {sm_acc[i][c]};
      merge<1>(w, sm_m[i], sm_l[i], a2);
    }
  }
  T* out = o + b * os.b + h * os.h;
  if (splits == 1) {
    if (col) out[c] = from_f32<T>(w.acc[0] / (w.l == 0.0f ? 1.0f : w.l));
    return;
  }

  // this rank's state into its slot of rank 0's shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();  // every CTA of the cluster has started
  Slot<D>* dst = cluster.map_shared_rank(&slots[split], 0);
  if (col) {
    dst->acc[c] = w.acc[0];
    if (c == 0) {
      dst->m = w.m;
      dst->l = w.l;
    }
  }
  cluster.sync();  // every rank's slot has arrived
  if (split != 0 || !col) return;

  // rank 0: the splits merged in rank order, then o = acc / l, rounded once
  w.m = slots[0].m;
  w.l = slots[0].l;
  w.acc[0] = slots[0].acc[c];
  for (int r = 1; r < splits; ++r) {
    const float a2[1] = {slots[r].acc[c]};
    merge<1>(w, slots[r].m, slots[r].l, a2);
  }
  out[c] = from_f32<T>(w.acc[0] / (w.l == 0.0f ? 1.0f : w.l));
}

// An empty kernel launched as K9 is: the fixed cost of a launch.
__global__ void decode_attn_floor_kernel() {}

template <typename T, int D>
const void* pick_w(int threads, bool vec_ok) {
  if (threads == 256)
    return vec_ok ? (const void*)decode_attn_kernel<T, D, 8, true>
                  : (const void*)decode_attn_kernel<T, D, 8, false>;
  return vec_ok ? (const void*)decode_attn_kernel<T, D, 4, true>
                : (const void*)decode_attn_kernel<T, D, 4, false>;
}

template <typename T>
const void* pick_d(int d, int threads, bool vec_ok) {
  if (d <= 32) return pick_w<T, 32>(threads, vec_ok);
  if (d <= 64) return pick_w<T, 64>(threads, vec_ok);
  return pick_w<T, 128>(threads, vec_ok);
}

// The kernel instance for (dtype, d, threads, vec_ok).
const void* pick(int dtype, int d, int threads, bool vec_ok) {
  switch (dtype) {
    case 0: return pick_d<float>(d, threads, vec_ok);
    case 1: return pick_d<__nv_bfloat16>(d, threads, vec_ok);
    default: return pick_d<__half>(d, threads, vec_ok);
  }
}

bool valid(int B, int H, int C, int d, int splits, int threads, int dtype) {
  return B > 0 && H > 0 && C > 0 && d > 0 && d <= 128 && splits >= 1 &&
         splits <= kMaxSplits && (threads == 128 || threads == 256) &&
         dtype >= 0 && dtype <= 2 && (long long)B * H <= 2147483647LL;
}

}  // namespace

// strides: 10 element strides: (batch, head) of q, (batch, head, row) of k
// and v, (batch, head) of o. splits: the CTAs (one cluster) of each (b, h)
// row; threads: 128 or 256 a CTA. vec_ok: d, the pointers and the strides
// allow 16-byte loads. dtype: 0 = f32, 1 = bf16, 2 = f16. Returns the CUDA
// error of the launch (0 on success), or cudaErrorInvalidValue for a shape,
// head dimension (1..128), split count (1..8), thread count or dtype the
// kernel does not take.
extern "C" int dl4j_decode_attn(const void* q, const void* k, const void* v,
                                const int* lengths, void* o, int B, int H,
                                int C, int d, int splits, int threads,
                                const long long* strides, float scale,
                                int vec_ok, int dtype, void* stream) {
  if (!valid(B, H, C, d, splits, threads, dtype))
    return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  Strides qs{st[0], st[1], 0}, ks{st[2], st[3], st[4]},
      vs{st[5], st[6], st[7]}, os{st[8], st[9], 0};
  void* args[] = {(void*)&q, (void*)&k, (void*)&v, (void*)&lengths,
                  (void*)&o, (void*)&H, (void*)&C, (void*)&d,
                  (void*)&qs, (void*)&ks, (void*)&vs, (void*)&os,
                  (void*)&scale};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3((unsigned)(B * H), (unsigned)splits), dim3(threads), 0,
      static_cast<cudaStream_t>(stream), 1, (unsigned)splits, attr);
  int e;
  if ((e = (int)cudaLaunchKernelExC(&cfg, pick(dtype, d, threads,
                                                  vec_ok != 0),
                                     args)) != 0)
    return e;
  return (int)cudaGetLastError();
}

// An empty kernel with K9's grid, block, cluster and shared memory at this
// shape, on `stream`: what a launch costs before any work. Returns the CUDA
// error of the launch.
extern "C" int dl4j_decode_attn_floor(int B, int H, int C, int d, int splits,
                                      int threads, int dtype, void* stream) {
  if (!valid(B, H, C, d, splits, threads, dtype))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  int e;
  if ((e = (int)cudaFuncGetAttributes(&fa, pick(dtype, d, threads, true))) !=
      0)
    return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3((unsigned)(B * H), (unsigned)splits), dim3(threads),
      fa.sharedSizeBytes, static_cast<cudaStream_t>(stream), 1,
      (unsigned)splits, attr);
  if ((e = (int)cudaLaunchKernelEx(&cfg, decode_attn_floor_kernel)) != 0)
    return e;
  return (int)cudaGetLastError();
}
