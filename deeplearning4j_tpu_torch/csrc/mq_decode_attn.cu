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
// Design (one launch, staged keys):
// - Split-KV as K9 (decode_attn.cu): the grid is (B*H, splits), the split
//   count from C, B*H and the 132 SMs (kernels/decode_attention.py::
//   num_splits, at most 8), never from the lengths, so the host reads
//   nothing off the device on a verify. Each CTA of 4 warps takes a
//   contiguous chunk of the row's keys and holds all nq query rows (KQ =
//   4, 8 or 16 of them, the rest zero).
// - The chunk is walked in tiles of TK keys: 64, or 32 where a row of D
//   elements passes 128 bytes and the grid has more CTAs than SMs (8 KB a
//   k or v tile, so that at f32, d = 64 six CTAs fit an SM; with at most
//   one CTA an SM, one tile of 64 takes half the rounds). Each tile's k
//   and v rows are staged into shared memory by 16-byte cp.async copies
//   into a double buffer, the next tile's copies in flight while this one
//   is computed (element copies where a row is not 16-byte aligned, the
//   wrapper's vec_ok). Rows past the chunk and columns past d are zero. A
//   staged row is unpadded; its 16-byte chunks are permuted by the row's
//   index (tile_at), so the lanes that read one column of consecutive
//   rows meet no bank conflict.
// - Scores: warp w owns queries w KQ/4 .. (w + 1) KQ/4 - 1, lane j the
//   tile's key j (and j + 32 in a tile of 64). A lane walks its key's
//   staged row in order, 16 bytes at a time, against the warp's q rows
//   (f32 in shared memory, one broadcast read for all lanes), so each
//   (query, key) dot is one in-order fmaf chain in one thread: no shuffle
//   per key. The tile's max per query is one warp reduction; p = exp(s -
//   m) goes to a [TK][KQ] shared tile, rounded to v's type, and each lane
//   keeps its own share of l (summed over the warp once, at the end). The
//   rescale factor of each query goes beside it.
// - p v: warp w owns keys w TK/4 .. of the tile, lane the columns lane
//   D/32 .. of every query; per key it reads the v row once and the key's
//   KQ p values by broadcast. The four warps' partial sums share each
//   query's running max and are added in warp order at the end.
// - The splits of a row form one thread-block cluster of (1, splits, 1)
//   CTAs: each rank stores its (m, l, acc[d]) of every query into its own
//   slot of rank 0's shared memory, and after one cluster barrier rank 0
//   merges the slots in rank order and writes o. No device-memory
//   scratch, no second kernel, no atomics: a rerun is bitwise equal.
// - Shared memory, at most (f32, d = 128, nq = 16, 8 splits, 64-key
//   tiles): 131,072 bytes of k/v tiles, 8,192 of q, 4,096 of p, 192 of
//   softmax state and 66,560 of slots: 210,112 bytes, one CTA an SM; at
//   f32, d = 64, nq = 4, 2 splits: 36,464 bytes with 32-key tiles (six
//   CTAs an SM), 69,744 with 64-key tiles (the verify path's 64 CTAs).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"
#include "flash_attn_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dl4j;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kMaxQueries = 16;
constexpr int kSms = 132;  // an H100 SXM's (kernels/decode_attention.py)

// Merge (m2, l2, a2) into (m, l, a): the state of the union of the two key
// sets. A side that saw no key has m = -inf and weight 0. Each term is a
// rounded product and a rounded sum, independent of the sides' order.
__device__ __forceinline__ void merge(float& m, float& l, float& a, float m2,
                                      float l2, float a2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;  // both empty
  const float wa = m == -INFINITY ? 0.0f : expf(m - M);
  const float wb = m2 == -INFINITY ? 0.0f : expf(m2 - M);
  l = __fadd_rn(__fmul_rn(l, wa), __fmul_rn(l2, wb));
  a = __fadd_rn(__fmul_rn(a, wa), __fmul_rn(a2, wb));
  m = M;
}

template <int N>
struct VecOf;
template <>
struct VecOf<2> { using type = unsigned short; };
template <>
struct VecOf<4> { using type = unsigned int; };
template <>
struct VecOf<8> { using type = uint2; };
template <>
struct VecOf<16> { using type = uint4; };

// N consecutive elements of shared memory (aligned to their size) as f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(float (&dst)[N], const T* p) {
  using V = typename VecOf<N * sizeof(T)>::type;
  const V raw = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = to_f32<T>(e[i]);
}

// The tiling and the shared-memory layout of one instance: TK keys a tile.
template <typename T, int D, int KQ, int TK>
struct Geo {
  static constexpr int E = 16 / (int)sizeof(T);  // elements a 16-byte copy
  static constexpr int KPL = TK / 32;        // keys a lane, scores
  static constexpr int QW = KQ / kWarps;     // queries a warp, scores
  static constexpr int KW = TK / kWarps;     // keys a warp, p v
  static constexpr int CV = D / 32;          // columns a lane, p v
  static constexpr int TILE = TK * D;        // elements of one k or v tile
  static constexpr size_t kStage = 4 * (size_t)TILE * sizeof(T);
  static constexpr size_t kRed = (size_t)kWarps * KQ * D * 4;
  // k/v double buffer; after the walk, the warps' partial p v sums
  static constexpr size_t kUnion = kStage > kRed ? kStage : kRed;
  // q [KQ][D], p [TK][KQ], then rescale, m and l [KQ] each (f32)
  static constexpr size_t kFixed =
      kUnion + (size_t)(KQ * D + TK * KQ + 3 * KQ) * 4;
  static constexpr size_t kSlot = (size_t)KQ * (D + 2);  // floats a rank
  static size_t smem(int splits) { return kFixed + splits * kSlot * 4; }
  static_assert(KQ % kWarps == 0 && D % 32 == 0 && kFixed % 16 == 0,
                "tile");
};

// Element (r, c) of a staged tile: rows of D elements, unpadded, with the
// 16-byte chunks of row r permuted by (r & SW), so that 8 lanes reading 16
// bytes at one column of 8 consecutive rows hit 8 different bank groups.
template <typename T, int D>
__device__ __forceinline__ int tile_at(int r, int c) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int CH = D / E;
  constexpr int SW = (CH < 8 ? CH : 8) - 1;
  return r * D + (((c / E) ^ (r & SW)) * E) + (c & (E - 1));
}

// Rows [r0, r0 + TK) of a [T, d] operand (row stride ts elements, last
// dimension contiguous) into a staged tile, zero past `rows` and past d, by
// the CTA's threads: one cp.async per 16 bytes when `vec`, else element by
// element.
template <typename T, int D, int TK>
__device__ __forceinline__ void stage_tile(T* __restrict__ dst,
                                           const T* __restrict__ src,
                                           long long ts, int r0, int rows,
                                           int d, bool vec) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int CH = D / E;
    for (int i = threadIdx.x; i < TK * CH; i += kThreads) {
      const int r = i / CH;
      const int c = (i - r * CH) * E;
      const bool in = r0 + r < rows && c < d;
      cp_async16(dst + tile_at<T, D>(r, c), in ? src + (r0 + r) * ts + c : src,
                 in ? min(E, d - c) * (int)sizeof(T) : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      dst[tile_at<T, D>(r, c)] = r0 + r < rows && c < d
                                     ? src[(r0 + r) * ts + c]
                                     : from_f32<T>(0.0f);
    }
  }
}

template <typename T, int D, int KQ, int TK>
__global__ void __launch_bounds__(kThreads)
mq_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ o, int H, int C, int d, int nq, Strides qs,
                 Strides ks, Strides vs, Strides os, float scale, int vec) {
  using G = Geo<T, D, KQ, TK>;
  constexpr int E = G::E, KPL = G::KPL, QW = G::QW,
                KW = G::KW, CV = G::CV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kt = reinterpret_cast<T*>(smem);                   // [2][TK][D]
  T* vt = kt + 2 * G::TILE;                             // [2][TK][D]
  float* red = reinterpret_cast<float*>(smem);          // [warps][KQ][D]
  float* qf = reinterpret_cast<float*>(smem + G::kUnion);  // [KQ][D]
  float* pt = qf + KQ * D;                              // [TK][KQ]
  float* rescale = pt + TK * KQ;                        // [KQ]
  float* fm = rescale + KQ;                             // [KQ]
  float* fl = fm + KQ;                                  // [KQ]
  float* slots = fl + KQ;  // [splits][KQ * D acc, KQ m, KQ l], rank 0's

  // the cluster spans the grid's y: rank = split
  const int splits = gridDim.y;
  if (splits > 1) cluster_arrive();  // waited on before the remote stores

  const int g = blockIdx.x;
  const int b = g / H;
  const int h = g - b * H;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // rows the window reads: all C when query 0 is fully masked (uniform
  // weights), else [0, min(C, L + nq)); this split's chunk of them
  const long long L = lengths[b];
  const int rows = L + 1 <= 0 ? C : (int)min((long long)C, L + nq);
  const int chunk = (rows + splits - 1) / splits;
  const int j0 = min(split * chunk, rows);
  const int j1 = min(j0 + chunk, rows);
  const int tiles = (j1 - j0 + TK - 1) / TK;

  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;
  if (tiles > 0) {
    stage_tile<T, D, TK>(kt, kg, ks.t, j0, j1, d, vec);
    stage_tile<T, D, TK>(vt, vg, vs.t, j0, j1, d, vec);
    cp_async_commit();
  }
  const T* qg = q + b * qs.b + h * qs.h;
  for (int idx = tid; idx < KQ * D; idx += kThreads) {
    const int i = idx / D, c = idx - i * D;
    qf[idx] = i < nq && c < d ? to_f32<T>(qg[i * qs.t + c]) : 0.0f;
  }

  // this warp's queries: running max, and the lane's share of the sum
  float m[QW], lsum[QW];
#pragma unroll
  for (int r = 0; r < QW; ++r) {
    m[r] = -INFINITY;
    lsum[r] = 0.0f;
  }
  // the lane's columns of every query's p v sum over this warp's keys
  float acc[KQ][CV];
#pragma unroll
  for (int i = 0; i < KQ; ++i)
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[i][c] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    const int base = j0 + t * TK;
    const T* kb = kt + (t & 1) * G::TILE;
    const T* vb = vt + (t & 1) * G::TILE;
    if (t + 1 < tiles) {  // the next tile's copies, into the other buffer
      T* nk = kt + ((t + 1) & 1) * G::TILE;
      T* nv = vt + ((t + 1) & 1) * G::TILE;
      stage_tile<T, D, TK>(nk, kg, ks.t, base + TK, j1, d, vec);
      stage_tile<T, D, TK>(nv, vg, vs.t, base + TK, j1, d, vec);
      cp_async_commit();
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();  // this tile (and q) visible to every thread

    // ---- scores: lane keys base + lane + 32 u, warp queries ----
    float dot[QW][KPL];
#pragma unroll
    for (int r = 0; r < QW; ++r)
#pragma unroll
      for (int u = 0; u < KPL; ++u) dot[r][u] = 0.0f;
#pragma unroll 4
    for (int c0 = 0; c0 < D; c0 += E) {
      float kf[KPL][E];
#pragma unroll
      for (int u = 0; u < KPL; ++u)
        load_f32<T, E>(kf[u], kb + tile_at<T, D>(lane + 32 * u, c0));
#pragma unroll
      for (int r = 0; r < QW; ++r) {
        const float* qr = qf + (warp * QW + r) * D + c0;
#pragma unroll
        for (int e4 = 0; e4 < E; e4 += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qr + e4);
          const float qe[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int u = 0; u < KPL; ++u)
              dot[r][u] = fmaf(qe[e], kf[u][e4 + e], dot[r][u]);
        }
      }
    }
    // ---- online softmax per query: the tile's max over the warp ----
#pragma unroll
    for (int r = 0; r < QW; ++r) {
      const int i = warp * QW + r;
      const long long bound = L + 1 + i;
      const bool uniform = bound <= 0;
      float s[KPL];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const int key = base + lane + 32 * u;
        const bool ok = i < nq && key < j1 && (uniform || key < bound);
        s[u] = !ok ? -INFINITY
                   : (uniform ? 0.0f : __fmul_rn(dot[r][u], scale));
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float a = m[r] == -INFINITY ? 0.0f : expf(m[r] - m_new);
      float ls = lsum[r] * a;
#pragma unroll
      for (int u = 0; u < KPL; ++u) {
        const float p = s[u] == -INFINITY ? 0.0f : expf(s[u] - m_new);
        ls += p;
        pt[(lane + 32 * u) * KQ + i] = to_f32<T>(from_f32<T>(p));
      }
      lsum[r] = ls;
      m[r] = m_new;
      if (lane == 0) rescale[i] = a;
    }
    __syncthreads();  // p and the rescale factors visible

    // ---- p v: warp keys w KW .., lane columns lane CV .., all queries ----
#pragma unroll
    for (int i4 = 0; i4 < KQ; i4 += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(rescale + i4);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < CV; ++c) acc[i4 + e][c] *= av[e];
    }
#pragma unroll 4
    for (int jj = 0; jj < KW; ++jj) {
      const int j = warp * KW + jj;
      float vv[CV];
      load_f32<T, CV>(vv, vb + tile_at<T, D>(j, lane * CV));
#pragma unroll
      for (int i4 = 0; i4 < KQ; i4 += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pt + j * KQ + i4);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < CV; ++c)
            acc[i4 + e][c] = fmaf(pv[e], vv[c], acc[i4 + e][c]);
      }
    }
    __syncthreads();  // the tile and p consumed before they are rewritten
  }

  // ---- this CTA's state: m and l per query, the warps' p v in order ----
#pragma unroll
  for (int r = 0; r < QW; ++r) {
    const float l = warp_sum(lsum[r]);
    if (lane == 0) {
      fm[warp * QW + r] = m[r];
      fl[warp * QW + r] = l;
    }
  }
#pragma unroll
  for (int i = 0; i < KQ; ++i)
#pragma unroll
    for (int c = 0; c < CV; ++c)
      red[(warp * KQ + i) * D + lane * CV + c] = acc[i][c];
  __syncthreads();

  float* dst = nullptr;  // this rank's slot in rank 0's shared memory
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) {
    cluster_wait();  // every CTA of the cluster has started
    dst = cluster.map_shared_rank(slots + split * G::kSlot, 0);
  }
  for (int idx = tid; idx < nq * d; idx += kThreads) {
    const int i = idx / d, c = idx - i * d;
    float a = red[i * D + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += red[(w * KQ + i) * D + c];
    if (splits == 1) {
      o[b * os.b + h * os.h + (long long)i * os.t + c] =
          from_f32<T>(a / (fl[i] == 0.0f ? 1.0f : fl[i]));
      continue;
    }
    dst[i * D + c] = a;
    if (c == 0) {
      dst[KQ * D + i] = fm[i];
      dst[KQ * D + KQ + i] = fl[i];
    }
  }
  if (splits == 1) return;
  cluster.sync();  // every rank's slot has arrived
  if (split != 0) return;

  // rank 0: the splits merged in rank order, then o = acc / l, rounded once
  for (int idx = tid; idx < nq * d; idx += kThreads) {
    const int i = idx / d, c = idx - i * d;
    float wm = slots[KQ * D + i], wl = slots[KQ * D + KQ + i];
    float wa = slots[i * D + c];
    for (int r = 1; r < splits; ++r) {
      const float* sl = slots + r * G::kSlot;
      merge(wm, wl, wa, sl[KQ * D + i], sl[KQ * D + KQ + i], sl[i * D + c]);
    }
    o[b * os.b + h * os.h + (long long)i * os.t + c] =
        from_f32<T>(wa / (wl == 0.0f ? 1.0f : wl));
  }
}

// An empty kernel launched as K10 is: the fixed cost of a launch.
__global__ void mq_decode_floor_kernel() {}

// An instance's kernel and its shared memory at `splits`.
struct Instance {
  const void* fn;
  size_t smem;
};

template <typename T, int D, int KQ, int TK>
Instance instance(int splits) {
  return {(const void*)mq_decode_kernel<T, D, KQ, TK>,
          Geo<T, D, KQ, TK>::smem(splits)};
}

// 64 keys a tile where a row has at most 128 bytes, or where the grid holds
// at most one CTA an SM (`wide`: occupancy buys nothing there, and a tile
// of 64 halves the rounds); else 32, 8 KB a k or v tile, so that more CTAs
// share an SM.
template <typename T, int D, int KQ>
Instance instance(int splits, bool wide) {
  if constexpr (D * (int)sizeof(T) <= 128) {
    return instance<T, D, KQ, 64>(splits);
  } else {
    return wide ? instance<T, D, KQ, 64>(splits)
                : instance<T, D, KQ, 32>(splits);
  }
}

template <typename T, int D>
Instance pick_q(int nq, int splits, bool wide) {
  if (nq <= 4) return instance<T, D, 4>(splits, wide);
  if (nq <= 8) return instance<T, D, 8>(splits, wide);
  return instance<T, D, 16>(splits, wide);
}

template <typename T>
Instance pick_d(int d, int nq, int splits, bool wide) {
  if (d <= 32) return pick_q<T, 32>(nq, splits, wide);
  if (d <= 64) return pick_q<T, 64>(nq, splits, wide);
  return pick_q<T, 128>(nq, splits, wide);
}

bool valid(int B, int H, int C, int d, int nq, int splits, int dtype) {
  return B > 0 && H > 0 && C > 0 && d > 0 && d <= 128 && nq >= 1 &&
         nq <= kMaxQueries && splits >= 1 && splits <= kMaxSplits &&
         dtype >= 0 && dtype <= 2 && (long long)B * H <= 2147483647LL;
}

// The instance for a grid of (B*H, splits) CTAs.
Instance pick(int B, int H, int d, int nq, int splits, int dtype) {
  const bool wide = (long long)B * H * splits <= kSms;
  switch (dtype) {
    case 0: return pick_d<float>(d, nq, splits, wide);
    case 1: return pick_d<__nv_bfloat16>(d, nq, splits, wide);
    default: return pick_d<__half>(d, nq, splits, wide);
  }
}

// K10's launch configuration: grid (B*H, splits) of 128 threads in clusters
// of (1, splits), with the instance's shared memory (allowed past 48 KB on
// the kernel first).
int configure(const Instance& in, int B, int H, int splits,
              cudaStream_t stream, cudaLaunchAttribute* attr,
              cudaLaunchConfig_t* cfg) {
  if (const int e = allow_smem(in.fn, in.smem)) return e;
  *cfg = cluster_config(dim3((unsigned)(B * H), (unsigned)splits),
                        dim3(kThreads), in.smem, stream, 1,
                        (unsigned)splits, attr);
  return 0;
}

}  // namespace

// strides: 12 element strides: (batch, head, row) of q, k, v and o. splits:
// the CTAs (one cluster) of each (b, h) row. vec_ok: d, the k/v pointers
// and strides allow 16-byte copies. dtype: 0 = f32, 1 = bf16, 2 = f16.
// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a shape, head dimension (1..128), window (1..16
// queries), split count (1..8) or dtype the kernel does not take.
extern "C" int dl4j_mq_decode_attn(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   void* o, int B, int H, int C, int d,
                                   int nq, int splits,
                                   const long long* strides, float scale,
                                   int vec_ok, int dtype, void* stream) {
  if (!valid(B, H, C, d, nq, splits, dtype))
    return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  int vec = vec_ok != 0;
  void* args[] = {(void*)&q, (void*)&k, (void*)&v, (void*)&lengths,
                  (void*)&o, (void*)&H, (void*)&C, (void*)&d, (void*)&nq,
                  (void*)&qs, (void*)&ks, (void*)&vs, (void*)&os,
                  (void*)&scale, (void*)&vec};
  const Instance in = pick(B, H, d, nq, splits, dtype);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int e;
  if ((e = configure(in, B, H, splits, static_cast<cudaStream_t>(stream),
                     attr, &cfg)) != 0)
    return e;
  if ((e = (int)cudaLaunchKernelExC(&cfg, in.fn, args)) != 0) return e;
  return (int)cudaGetLastError();
}

// The dynamic shared memory, in bytes, of one CTA at this shape (0 for a
// shape the kernel does not take).
extern "C" long long dl4j_mq_decode_attn_smem(int B, int H, int d, int nq,
                                              int splits, int dtype) {
  if (!valid(B, H, 1, d, nq, splits, dtype)) return 0;
  return (long long)pick(B, H, d, nq, splits, dtype).smem;
}

// An empty kernel with K10's grid, block, cluster and shared memory at this
// shape, on `stream`: what a launch costs before any work. Returns the CUDA
// error of the launch.
extern "C" int dl4j_mq_decode_attn_floor(int B, int H, int C, int d, int nq,
                                         int splits, int dtype,
                                         void* stream) {
  if (!valid(B, H, C, d, nq, splits, dtype))
    return (int)cudaErrorInvalidValue;
  const Instance in{(const void*)mq_decode_floor_kernel,
                    pick(B, H, d, nq, splits, dtype).smem};
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int e;
  if ((e = configure(in, B, H, splits, static_cast<cudaStream_t>(stream),
                     attr, &cfg)) != 0)
    return e;
  if ((e = (int)cudaLaunchKernelEx(&cfg, mq_decode_floor_kernel)) != 0)
    return e;
  return (int)cudaGetLastError();
}
