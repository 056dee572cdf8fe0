// K4 + K5: the flash-attention backward as one kernel that gives dq, dk and
// dv in a single pass. From the forward's o (through di), m and l and the
// output gradient do, with s = q k^T * scale + kb[b],
//
//   p  = exp(s - m) * (1 / l)                 (recomputed, never stored)
//   dp = do v^T,    ds = p * (dp - di) * scale,    di = rowsum(o * do)
//   dq = ds k       (ds rounded to k's type)
//   dv = p^T do     (p rounded to do's type)
//   dk = ds^T q     (ds rounded to q's type)
//
// It replaces deeplearning4j_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (their pallas_calls are in _bwd_impl, reached from the
// custom VJP _flash_bwd). di is computed by the caller, as there.
//
// q and do are [B, H, Tq, d], k and v [B, H, Tk, d], each addressed through
// its own (batch, head, row) element strides with the last dimension
// contiguous (the head split of a [B, T, H*d] projection is read in place);
// dq, dk and dv are written through their own strides. kb is the optional
// f32 key bias [B, Tk] (clamped to finfo(float32).min by the caller). m, l
// and di are f32 [B*H, Tq]: one value per row; l is already the safe sum
// (1 where the sum was 0), and p multiplies by 1 / l as the TPU kernels do.
// The element type is f32, bf16 or f16; the sums are f32 and each output is
// rounded once. A null dq skips ds k; null dk and dv skip p^T do and ds^T q.
//
// Bound: at BERT-base shapes (T = 128, d = 64) the five products q k^T,
// do v^T, p^T do, ds^T q and ds k are 10 G T^2 d flops. In f32 on CUDA cores
// they bound the kernel (4.03 GFLOP over 67 TFLOP/s is 2.3x the 88.7 MB over
// 3.35 TB/s); in 16 bits at the tensor-core rate the bytes would (44.7 MB,
// 3.3x the flops over 989 TFLOP/s), but the two products this kernel keeps
// on CUDA cores (below) cost 1.6 GFLOP at the f32 rate.
//
// Design: one CTA per (batch*head, block of BK keys). The CTA stages its k
// and v rows once, keeps dk and dv in registers, and walks the query tiles:
// for each it stages q, do, m, l and di, computes s and dp once, forms p and
// ds, adds p^T do into dv and ds^T q into dk, and computes that tile's
// ds k. Every operand is read from device memory once per key block. Tiles
// are staged with cp.async (16 bytes a copy, zero-filled past d and past the
// last row) when every operand's rows start on 16-byte boundaries, else
// element by element. dq needs no float atomics, so a rerun is bitwise
// equal: when one key block covers Tk (BERT's T = 128) the tile's dq is
// complete in the CTA and is written once; otherwise each key block writes
// an f32 partial to a workspace [n_kblocks, B*H, Tq, d] and
// flash_attn_bwd_dq_sum_kernel adds the partials in key-block order and
// rounds once. Keys past Tk and queries past Tq get p = 0 and are not stored.
//
// - f32 (flash_attn_bwd_f32_kernel; precision "highest", no TF32): CUDA
//   cores, 256 threads, BK = 128 keys (64 at d > 64), query tiles of 64.
//   Each thread owns a two-dimensional register tile of every product: 4 x
//   BK/16 (query, key) pairs of s and dp, BK/32 keys x d/8 columns of dk
//   and dv, 4 x d/16 (query, column) pairs of dq. Operands are read from
//   shared memory as float4 and reused across the tile (rows padded by 4
//   floats so that 8 consecutive rows hit 32 distinct banks). s is walked
//   over d in order with one fused multiply-add a term from 0, then
//   score(): the contract of flash_attn_common.cuh, so the recomputed
//   scores equal K3's bit for bit and a fully masked row gets s - m = 0
//   exactly. dq = ds k reads a transposed copy of k made once per CTA. The
//   next query tile's copies are issued as soon as q and do are consumed,
//   so they overlap ds k.
// - bf16 / f16 (flash_attn_bwd_mma_kernel): the three products of 16-bit
//   operands, p^T do, ds^T q and ds k, on the tensor cores through
//   mma.sync.m16n8k16 with f32 accumulators, operands loaded with ldmatrix
//   from shared memory staged by cp.async, q and do double-buffered across
//   query tiles. BK / 16 warps each own 16 keys, and each thread holds s^T
//   and dp^T in the mma accumulator layout (keys as rows), so p^T and
//   ds^T, rounded to 16 bits, are the A operands of dv += p^T do and
//   dk += ds^T q straight from registers; ds^T goes to shared memory once
//   for dq = ds k. s and dp themselves are summed on CUDA cores from f32
//   copies of the tiles, in K3's order (so s is K3's bit for bit, and a
//   fully masked row gets s - m = 0): the tensor cores' f32 sums round
//   differently from an in-order f32 sum, by enough that the 16-bit
//   roundings of p and ds flip against the plain version and dq, dk and
//   dv leave its 2-ulp tolerance (measured: up to 81 ulps of f16).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attn_common.cuh"

namespace {

using namespace dl4j;

// ---- what a launch is given ---------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* kb;
  const float* m;
  const float* l;
  const float* di;
  void* dq;    // null: no dq
  void* dk;    // null (with dv): no dk and dv
  void* dv;
  float* ws;   // [nkb, B*H, Tq, d] f32 dq partials when nkb > 1
  int H, Tq, Tk, d, nkb;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float scale;
  int vec;      // every row of q, k, v and do starts on a 16-byte boundary
  int vec_out;  // and every row of dk and dv
};

// m, l and di of query rows [q0, q0 + N) of head row g into st[0..N),
// st[N..2N), st[2N..3N), zero past Tq (needs 3N threads).
template <int N>
__device__ __forceinline__ void stage_stats(float* __restrict__ st,
                                            const Args& a, int g, int q0) {
  const int t = threadIdx.x;
  if (t < 3 * N) {
    const int which = t / N;
    const int r = t - which * N;
    const float* src = which == 0 ? a.m : which == 1 ? a.l : a.di;
    const bool in = q0 + r < a.Tq;
    cp_async4(st + t, src + (in ? (long long)g * a.Tq + q0 + r : 0),
              in ? 4 : 0);
  }
}

// The CTA's key bias rows [k0, k0 + N) into sb (0 without a bias or past Tk).
template <int N, int NT>
__device__ __forceinline__ void stage_bias(float* __restrict__ sb,
                                           const Args& a, int b, int k0) {
  for (int r = threadIdx.x; r < N; r += NT)
    sb[r] = (a.kb != nullptr && k0 + r < a.Tk)
        ? a.kb[(long long)b * a.Tk + k0 + r] : 0.0f;
}

// p and ds of one (query, key) pair, as the plain version computes them:
// p = exp(s - m) * il with il = 1 / l (0 outside Tq x Tk), ds = p * (dp -
// di) * scale.
__device__ __forceinline__ float p_of(float dot, float bias, float m,
                                      float il, float scale, bool in) {
  return in ? __fmul_rn(expf(__fsub_rn(score(dot, scale, bias), m)), il)
            : 0.0f;
}

__device__ __forceinline__ float ds_of(float p, float dpv, float di,
                                       float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dpv, di)), scale);
}

// dq of one element: written once (one key block) or as this block's f32
// partial.
template <typename T>
__device__ __forceinline__ void put_dq(const Args& a, int g, int b, int h,
                                       int row, int c, float x) {
  if (a.nkb == 1) {
    static_cast<T*>(a.dq)[b * a.dqs.b + h * a.dqs.h + row * a.dqs.t + c] =
        from_f32<T>(x);
  } else {
    a.ws[(((long long)blockIdx.y * gridDim.x + g) * a.Tq + row) * a.d + c] =
        x;
  }
}

// ---- f32: CUDA cores, register tiles -------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32BQ = 64;  // query rows per tile
constexpr int kRowGroups = kF32BQ / 4;  // s, dp and dq: 4 query rows a thread

template <int D>
__host__ __device__ constexpr int key_block() { return D <= 64 ? 128 : 64; }

// Shared-memory layout of the f32 kernel, in floats.
template <int D>
struct F32Layout {
  static constexpr int BK = key_block<D>();
  static constexpr int RS = D + 4;   // rows of k, v, q, do
  static constexpr int PS = BK + 4;  // rows of p, ds ([query][key]) and k^T
  static constexpr int K = 0;
  static constexpr int V = K + BK * RS;
  static constexpr int KT = V + BK * RS;       // k^T [D][BK]
  static constexpr int Q = KT + D * PS;
  static constexpr int DO = Q + kF32BQ * RS;
  static constexpr int P = DO + kF32BQ * RS;
  static constexpr int DS = P + kF32BQ * PS;
  static constexpr int ST = DS + kF32BQ * PS;  // m, l, di
  static constexpr int B = ST + 3 * kF32BQ;
  static constexpr int TOTAL = B + BK;
  static constexpr size_t BYTES = sizeof(float) * (size_t)TOTAL;
};

// n consecutive floats of shared memory (n = 1, 2 or 4) into r.
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x; r[1] = x.y;
  } else {
    r[0] = *p;
  }
}

template <int D, int NT>
__global__ void __launch_bounds__(NT, 1)
flash_attn_bwd_f32_kernel(const Args a) {
  using L = F32Layout<D>;
  constexpr int BK = L::BK, RS = L::RS, PS = L::PS, BQ = kF32BQ;
  constexpr int RG = kRowGroups;
  constexpr int AKG = NT / RG;   // s, dp: key groups
  constexpr int TJ = BK / AKG;   // s, dp: keys per thread (4 query rows)
  constexpr int TJB = 8 * BK / NT;  // dk, dv: keys per thread
  constexpr int CG = D / 32;     // dk, dv: float4 column groups per thread
  constexpr int CC = NT / RG;    // dq: column groups
  constexpr int TC = D / CC;     // dq: columns per thread (4 query rows)
  static_assert(TJ >= 1 && TJB >= 1 && TJB <= 4 && TC >= 1, "tiling");
  extern __shared__ __align__(16) float smem[];
  float* sK = smem + L::K;
  float* sV = smem + L::V;
  float* sKT = smem + L::KT;
  float* sQ = smem + L::Q;
  float* sDO = smem + L::DO;
  float* sP = smem + L::P;
  float* sDS = smem + L::DS;
  float* sM = smem + L::ST;
  float* sL = sM + BQ;
  float* sDI = sL + BQ;
  float* sB = smem + L::B;

  const int g = blockIdx.x;
  const int b = g / a.H;
  const int h = g - b * a.H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const bool want_dq = a.dq != nullptr;
  const bool want_dkv = a.dk != nullptr;
  const bool vec = a.vec != 0;
  const float* q = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h;

  stage<float, BK, D, RS, NT>(
      sK, static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h, a.ks.t,
      k0, a.Tk, a.d, vec);
  stage<float, BQ, D, RS, NT>(sQ, q, a.qs.t, 0, a.Tq, a.d, vec);
  stage<float, BK, D, RS, NT>(
      sV, static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h, a.vs.t,
      k0, a.Tk, a.d, vec);
  stage<float, BQ, D, RS, NT>(sDO, dout, a.dos.t, 0, a.Tq, a.d, vec);
  stage_stats<BQ>(sM, a, g, 0);
  cp_async_commit();
  stage_bias<BK, NT>(sB, a, b, k0);
  cp_async_wait_all();
  __syncthreads();
  if (want_dq) {  // k^T for dq = ds k, once per CTA
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i % BK;
      const int c = i / BK;
      sKT[c * PS + j] = sK[j * RS + c];
    }
  }

  // s, dp: query rows ai + RG v, keys aj + AKG u
  const int ai = tid / AKG, aj = tid % AKG;
  // dk, dv: keys TJB bj + u, columns 4 bc + 32 cg + e
  const int bj = tid >> 3, bc = tid & 7;
  // dq: query rows ci + RG v, columns cc + CC w
  const int ci = tid / CC, cc = tid % CC;

  float dka[TJB][4 * CG], dva[TJB][4 * CG];
#pragma unroll
  for (int u = 0; u < TJB; ++u) {
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) dka[u][c] = dva[u][c] = 0.0f;
  }

  for (int q0 = 0; q0 < a.Tq; q0 += BQ) {
    __syncthreads();  // this tile is staged; the last tile's ds is consumed
    const int nq = min(BQ, a.Tq - q0);

    // ---- s = q k^T, then p; dp = do v^T, then ds --------------------------
    // p goes to shared memory and is read back for ds, so that s and dp
    // never hold registers together
    {
      float s[4][TJ];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
#pragma unroll
        for (int u = 0; u < TJ; ++u) s[v][u] = 0.0f;
      }
#pragma unroll 2
      for (int c = 0; c < D; c += 4) {  // in order over d: K3's scores
        float4 kf[TJ];
#pragma unroll
        for (int u = 0; u < TJ; ++u)
          kf[u] = *reinterpret_cast<const float4*>(sK + (aj + AKG * u) * RS + c);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 qf =
              *reinterpret_cast<const float4*>(sQ + (ai + RG * v) * RS + c);
#pragma unroll
          for (int u = 0; u < TJ; ++u) {
            float x = s[v][u];
            x = fmaf(qf.x, kf[u].x, x);
            x = fmaf(qf.y, kf[u].y, x);
            x = fmaf(qf.z, kf[u].z, x);
            x = fmaf(qf.w, kf[u].w, x);
            s[v][u] = x;
          }
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = ai + RG * v;
        const bool qin = r < nq;
        const float m = sM[r], il = 1.0f / sL[r];
#pragma unroll
        for (int u = 0; u < TJ; ++u) {
          const int j = aj + AKG * u;
          sP[r * PS + j] = p_of(s[v][u], sB[j], m, il, a.scale,
                                qin && k0 + j < a.Tk);
        }
      }
    }
    {
      float dp[4][TJ];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
#pragma unroll
        for (int u = 0; u < TJ; ++u) dp[v][u] = 0.0f;
      }
#pragma unroll 2
      for (int c = 0; c < D; c += 4) {
        float4 vf[TJ];
#pragma unroll
        for (int u = 0; u < TJ; ++u)
          vf[u] = *reinterpret_cast<const float4*>(sV + (aj + AKG * u) * RS + c);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 df =
              *reinterpret_cast<const float4*>(sDO + (ai + RG * v) * RS + c);
#pragma unroll
          for (int u = 0; u < TJ; ++u) {
            float x = dp[v][u];
            x = fmaf(df.x, vf[u].x, x);
            x = fmaf(df.y, vf[u].y, x);
            x = fmaf(df.z, vf[u].z, x);
            x = fmaf(df.w, vf[u].w, x);
            dp[v][u] = x;
          }
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = ai + RG * v;
        const float di = sDI[r];
#pragma unroll
        for (int u = 0; u < TJ; ++u) {
          const int j = aj + AKG * u;  // p was written by this thread
          sDS[r * PS + j] = ds_of(sP[r * PS + j], dp[v][u], di, a.scale);
        }
      }
    }
    __syncthreads();  // p and ds are in shared memory

    // ---- dv += p^T do and dk += ds^T q --------------------------------------
    if (want_dkv) {
#pragma unroll 4
      for (int i = 0; i < nq; ++i) {
        float pj[TJB], dsj[TJB];
        lds<TJB>(pj, sP + i * PS + TJB * bj);
        lds<TJB>(dsj, sDS + i * PS + TJB * bj);
#pragma unroll
        for (int cg = 0; cg < CG; ++cg) {
          const float4 df = *reinterpret_cast<const float4*>(
              sDO + i * RS + 4 * bc + 32 * cg);
          const float4 qf = *reinterpret_cast<const float4*>(
              sQ + i * RS + 4 * bc + 32 * cg);
#pragma unroll
          for (int u = 0; u < TJB; ++u) {
            dva[u][4 * cg + 0] = fmaf(pj[u], df.x, dva[u][4 * cg + 0]);
            dva[u][4 * cg + 1] = fmaf(pj[u], df.y, dva[u][4 * cg + 1]);
            dva[u][4 * cg + 2] = fmaf(pj[u], df.z, dva[u][4 * cg + 2]);
            dva[u][4 * cg + 3] = fmaf(pj[u], df.w, dva[u][4 * cg + 3]);
            dka[u][4 * cg + 0] = fmaf(dsj[u], qf.x, dka[u][4 * cg + 0]);
            dka[u][4 * cg + 1] = fmaf(dsj[u], qf.y, dka[u][4 * cg + 1]);
            dka[u][4 * cg + 2] = fmaf(dsj[u], qf.z, dka[u][4 * cg + 2]);
            dka[u][4 * cg + 3] = fmaf(dsj[u], qf.w, dka[u][4 * cg + 3]);
          }
        }
      }
      __syncthreads();  // q and do are consumed
    }

    // the next tile's copies overlap ds k
    if (q0 + BQ < a.Tq) {
      stage<float, BQ, D, RS, NT>(sQ, q, a.qs.t, q0 + BQ, a.Tq, a.d, vec);
      stage<float, BQ, D, RS, NT>(sDO, dout, a.dos.t, q0 + BQ, a.Tq, a.d,
                                  vec);
      stage_stats<BQ>(sM, a, g, q0 + BQ);
      cp_async_commit();
    }

    // ---- dq = ds k ----------------------------------------------------------
    if (want_dq) {
      float acc[4][TC];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
#pragma unroll
        for (int w = 0; w < TC; ++w) acc[v][w] = 0.0f;
      }
      const int nk = min(BK, a.Tk - k0);  // ds is 0 past Tk
#pragma unroll 2
      for (int j = 0; j < nk; j += 4) {
        float4 kt[TC];
#pragma unroll
        for (int w = 0; w < TC; ++w)
          kt[w] = *reinterpret_cast<const float4*>(sKT + (cc + CC * w) * PS + j);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 df =
              *reinterpret_cast<const float4*>(sDS + (ci + RG * v) * PS + j);
#pragma unroll
          for (int w = 0; w < TC; ++w) {
            float x = acc[v][w];
            x = fmaf(df.x, kt[w].x, x);
            x = fmaf(df.y, kt[w].y, x);
            x = fmaf(df.z, kt[w].z, x);
            x = fmaf(df.w, kt[w].w, x);
            acc[v][w] = x;
          }
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = ci + RG * v;
        if (r < nq) {
#pragma unroll
          for (int w = 0; w < TC; ++w) {
            const int c = cc + CC * w;
            if (c < a.d) put_dq<float>(a, g, b, h, q0 + r, c, acc[v][w]);
          }
        }
      }
    }
    cp_async_wait_all();
  }

  if (want_dkv) {
    float* dk = static_cast<float*>(a.dk) + b * a.dks.b + h * a.dks.h;
    float* dv = static_cast<float*>(a.dv) + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
    for (int u = 0; u < TJB; ++u) {
      const int row = k0 + TJB * bj + u;
      if (row < a.Tk) {
#pragma unroll
        for (int cg = 0; cg < CG; ++cg) {
          const int c = 4 * bc + 32 * cg;
          if (a.vec_out && c + 3 < a.d) {  // one 16-byte store
            *reinterpret_cast<float4*>(dk + row * a.dks.t + c) = make_float4(
                dka[u][4 * cg], dka[u][4 * cg + 1], dka[u][4 * cg + 2],
                dka[u][4 * cg + 3]);
            *reinterpret_cast<float4*>(dv + row * a.dvs.t + c) = make_float4(
                dva[u][4 * cg], dva[u][4 * cg + 1], dva[u][4 * cg + 2],
                dva[u][4 * cg + 3]);
            continue;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e < a.d) {
              dk[row * a.dks.t + c + e] = dka[u][4 * cg + e];
              dv[row * a.dvs.t + c + e] = dva[u][4 * cg + e];
            }
          }
        }
      }
    }
  }
}

// ---- bf16 / f16: tensor cores (mma.sync m16n8k16) -------------------------

// Tiles and shared-memory layout of the 16-bit kernel (byte offsets).
template <int D>
struct MmaLayout {
  static constexpr int BK = key_block<D>();
  static constexpr int BQ = D <= 64 ? 64 : 32;  // query rows per tile
  static constexpr int NW = BK / 16;            // warps: 16 keys each
  static constexpr int NT = 32 * NW;
  static constexpr int RS = D + 8;   // rows of k, v, q, do (elements)
  static constexpr int FS = D + 4;   // rows of their f32 copies (floats)
  static constexpr int SS = BQ + 8;  // rows of ds^T [key][query]
  static constexpr int QG = BQ / 16;          // dq: groups of 16 query rows
  static constexpr int DW = D * QG / NW;      // dq: columns per warp
  static constexpr int K = 0;
  static constexpr int V = K + 2 * BK * RS;
  static constexpr int Q = V + 2 * BK * RS;   // two buffers
  static constexpr int DO = Q + 2 * 2 * BQ * RS;
  static constexpr int DST = DO + 2 * 2 * BQ * RS;
  static constexpr int ST = DST + 2 * BK * SS;  // two buffers of m, l, di
  static constexpr int B = ST + 4 * 2 * 3 * BQ;
  static constexpr int FK = B + 4 * BK;         // f32 copies for s and dp
  static constexpr int FV = FK + 4 * BK * FS;
  static constexpr int FQ = FV + 4 * BK * FS;
  static constexpr int FDO = FQ + 4 * BQ * FS;
  static constexpr size_t BYTES = (size_t)FDO + 4 * BQ * FS;
};

template <typename T, int D>
__global__ void __launch_bounds__(MmaLayout<D>::NT, 1)
flash_attn_bwd_mma_kernel(const Args a) {
  using L = MmaLayout<D>;
  constexpr int BK = L::BK, BQ = L::BQ, RS = L::RS, FS = L::FS, SS = L::SS;
  constexpr int NT = L::NT;
  constexpr int NQ = BQ / 8;  // n-tiles of 8 queries
  constexpr int ND = D / 8;   // n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw + L::K);
  T* sV = reinterpret_cast<T*>(smem_raw + L::V);
  T* sQ = reinterpret_cast<T*>(smem_raw + L::Q);
  T* sDO = reinterpret_cast<T*>(smem_raw + L::DO);
  T* sDST = reinterpret_cast<T*>(smem_raw + L::DST);
  float* sST = reinterpret_cast<float*>(smem_raw + L::ST);
  float* sB = reinterpret_cast<float*>(smem_raw + L::B);
  float* fK = reinterpret_cast<float*>(smem_raw + L::FK);
  float* fV = reinterpret_cast<float*>(smem_raw + L::FV);
  float* fQ = reinterpret_cast<float*>(smem_raw + L::FQ);
  float* fDO = reinterpret_cast<float*>(smem_raw + L::FDO);

  const int g = blockIdx.x;
  const int b = g / a.H;
  const int h = g - b * a.H;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the mma fragment's row, pair
  const int kw = 16 * warp;                 // the warp's first key row
  const bool want_dq = a.dq != nullptr;
  const bool want_dkv = a.dk != nullptr;
  const bool vec = a.vec != 0;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;

  stage<T, BK, D, RS, NT>(
      sK, static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h, a.ks.t, k0,
      a.Tk, a.d, vec);
  stage<T, BK, D, RS, NT>(
      sV, static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h, a.vs.t, k0,
      a.Tk, a.d, vec);
  stage<T, BQ, D, RS, NT>(sQ, q, a.qs.t, 0, a.Tq, a.d, vec);
  stage<T, BQ, D, RS, NT>(sDO, dout, a.dos.t, 0, a.Tq, a.d, vec);
  stage_stats<BQ>(sST, a, g, 0);
  cp_async_commit();
  stage_bias<BK, NT>(sB, a, b, k0);
  cp_async_wait_all();
  __syncthreads();
  widen<T, BK, D, RS, FS, NT>(fK, sK);
  widen<T, BK, D, RS, FS, NT>(fV, sV);
  widen<T, BQ, D, RS, FS, NT>(fQ, sQ);
  widen<T, BQ, D, RS, FS, NT>(fDO, sDO);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;
  }

  int buf = 0;
  for (int q0 = 0; q0 < a.Tq; q0 += BQ, buf ^= 1) {
    __syncthreads();  // this tile is widened; the last tile's ds^T is read
    if (q0 + BQ < a.Tq) {  // the next tile's copies overlap this tile
      const int nb = buf ^ 1;
      stage<T, BQ, D, RS, NT>(sQ + nb * BQ * RS, q, a.qs.t, q0 + BQ, a.Tq,
                              a.d, vec);
      stage<T, BQ, D, RS, NT>(sDO + nb * BQ * RS, dout, a.dos.t, q0 + BQ,
                              a.Tq, a.d, vec);
      stage_stats<BQ>(sST + nb * 3 * BQ, a, g, q0 + BQ);
      cp_async_commit();
    }
    const T* cQ = sQ + buf * BQ * RS;
    const T* cDO = sDO + buf * BQ * RS;
    const float* cM = sST + buf * 3 * BQ;
    const float* cL = cM + BQ;
    const float* cDI = cL + BQ;

    // ---- s^T and dp^T for the warp's 16 keys x BQ queries, in the mma
    // accumulator layout (rows gq and gq + 8, columns 8n + 2tq + e), on
    // CUDA cores in K3's order: the tensor cores' f32 sums round
    // differently, and the 16-bit roundings of p and ds that follow would
    // then flip against the plain version ----
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
    }
    const float* k_r0 = fK + (kw + gq) * FS;
    const float* v_r0 = fV + (kw + gq) * FS;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k_r0 + c);
      const float4 kb8 = *reinterpret_cast<const float4*>(k_r0 + 8 * FS + c);
      const float4 va = *reinterpret_cast<const float4*>(v_r0 + c);
      const float4 vb8 = *reinterpret_cast<const float4*>(v_r0 + 8 * FS + c);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * n + 2 * tq + e;
          const float4 x = *reinterpret_cast<const float4*>(fQ + qi * FS + c);
          const float4 y = *reinterpret_cast<const float4*>(fDO + qi * FS + c);
          float s0 = st[n][e], s1 = st[n][2 + e];
          float d0 = dpt[n][e], d1 = dpt[n][2 + e];
          s0 = fmaf(x.x, ka.x, s0); s1 = fmaf(x.x, kb8.x, s1);
          d0 = fmaf(y.x, va.x, d0); d1 = fmaf(y.x, vb8.x, d1);
          s0 = fmaf(x.y, ka.y, s0); s1 = fmaf(x.y, kb8.y, s1);
          d0 = fmaf(y.y, va.y, d0); d1 = fmaf(y.y, vb8.y, d1);
          s0 = fmaf(x.z, ka.z, s0); s1 = fmaf(x.z, kb8.z, s1);
          d0 = fmaf(y.z, va.z, d0); d1 = fmaf(y.z, vb8.z, d1);
          s0 = fmaf(x.w, ka.w, s0); s1 = fmaf(x.w, kb8.w, s1);
          d0 = fmaf(y.w, va.w, d0); d1 = fmaf(y.w, vb8.w, d1);
          st[n][e] = s0; st[n][2 + e] = s1;
          dpt[n][e] = d0; dpt[n][2 + e] = d1;
        }
      }
    }

    // ---- p^T and ds^T in place; each fragment row is one key ----------------
    float il[NQ][2];  // 1 / l of the thread's queries
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) il[n][e] = 1.0f / cL[8 * n + 2 * tq + e];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = kw + gq + 8 * hf;
      const bool kin = k0 + key < a.Tk;
      const float bias = sB[key];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * n + 2 * tq + e;
          const float p = p_of(st[n][2 * hf + e], bias, cM[qi], il[n][e],
                               a.scale, kin && q0 + qi < a.Tq);
          st[n][2 * hf + e] = p;
          dpt[n][2 * hf + e] = ds_of(p, dpt[n][2 * hf + e], cDI[qi],
                                     a.scale);
        }
      }
    }

    // ---- dv += p^T do and dk += ds^T q (A operands from registers) ----------
    if (want_dkv) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t pa[4] = {
            pack2<T>(st[2 * kk][0], st[2 * kk][1]),
            pack2<T>(st[2 * kk][2], st[2 * kk][3]),
            pack2<T>(st[2 * kk + 1][0], st[2 * kk + 1][1]),
            pack2<T>(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack2<T>(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack2<T>(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack2<T>(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack2<T>(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
        const int row = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          const int col = 16 * np + ((lane >> 4) << 3);
          uint32_t bo[4], bqq[4];
          ldsm_x4_t(bo, cDO + row * RS + col);
          ldsm_x4_t(bqq, cQ + row * RS + col);
          mma<T>(dva[2 * np], pa, bo[0], bo[1]);
          mma<T>(dva[2 * np + 1], pa, bo[2], bo[3]);
          mma<T>(dka[2 * np], da, bqq[0], bqq[1]);
          mma<T>(dka[2 * np + 1], da, bqq[2], bqq[3]);
        }
      }
    }

    // ---- dq = ds k: ds^T through shared memory ------------------------------
    if (want_dq) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int n = 0; n < NQ; ++n)
          *reinterpret_cast<uint32_t*>(
              sDST + (kw + gq + 8 * hf) * SS + 8 * n + 2 * tq) =
              pack2<T>(dpt[n][2 * hf], dpt[n][2 * hf + 1]);
      }
      __syncthreads();
      constexpr int DW = L::DW;
      const int qm = 16 * (warp % L::QG);
      const int dn = DW * (warp / L::QG);
      float acc[DW / 8][4];
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
      }
      const int nk = min(BK, a.Tk - k0);  // ds is 0 past Tk
      const int mi = lane >> 3;
      for (int kk = 0; kk < nk; kk += 16) {
        uint32_t da[4];
        ldsm_x4_t(da, sDST + (kk + (lane & 7) + ((mi >> 1) << 3)) * SS + qm +
                          ((mi & 1) << 3));
        const int row = kk + (lane & 7) + ((mi & 1) << 3);
#pragma unroll
        for (int np = 0; np < DW / 16; ++np) {
          uint32_t bk[4];
          ldsm_x4_t(bk, sK + row * RS + dn + 16 * np + ((lane >> 4) << 3));
          mma<T>(acc[2 * np], da, bk[0], bk[1]);
          mma<T>(acc[2 * np + 1], da, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = q0 + qm + gq + 8 * hf;
        if (r < a.Tq) {
#pragma unroll
          for (int n = 0; n < DW / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = dn + 8 * n + 2 * tq + e;
              if (c < a.d) put_dq<T>(a, g, b, h, r, c, acc[n][2 * hf + e]);
            }
          }
        }
      }
    }
    if (q0 + BQ < a.Tq) {  // the next tile, widened for its s and dp
      cp_async_wait_all();
      __syncthreads();  // it has landed; this tile's s and dp are done
      widen<T, BQ, D, RS, FS, NT>(fQ, sQ + (buf ^ 1) * BQ * RS);
      widen<T, BQ, D, RS, FS, NT>(fDO, sDO + (buf ^ 1) * BQ * RS);
    }
  }

  if (want_dkv) {
    T* dk = static_cast<T*>(a.dk) + b * a.dks.b + h * a.dks.h;
    T* dv = static_cast<T*>(a.dv) + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = k0 + kw + gq + 8 * hf;
      if (row < a.Tk) {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * n + 2 * tq + e;
            if (c < a.d) {
              dk[row * a.dks.t + c] = from_f32<T>(dka[n][2 * hf + e]);
              dv[row * a.dvs.t + c] = from_f32<T>(dva[n][2 * hf + e]);
            }
          }
        }
      }
    }
  }
}

// ---- dq from the key blocks' partials --------------------------------------

// dq = the f32 partials [nkb, G, Tq, d] summed in key-block order, rounded
// once, written through dq's strides.
template <typename T>
__global__ void __launch_bounds__(256)
flash_attn_bwd_dq_sum_kernel(const float* __restrict__ ws, T* __restrict__ dq,
                             int nkb, int H, int Tq, int d, long long n,
                             Strides dqs) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % d);
    const long long rg = i / d;
    const int r = (int)(rg % Tq);
    const long long g = rg / Tq;
    const long long b = g / H;
    const long long h = g - b * H;
    float s = 0.0f;
    for (int j = 0; j < nkb; ++j) s += ws[j * n + i];
    dq[b * dqs.b + h * dqs.h + r * dqs.t + c] = from_f32<T>(s);
  }
}

// ---- launches --------------------------------------------------------------

template <typename T, int D>
int launch(const Args& a, int G, cudaStream_t stream) {
  const dim3 grid((unsigned)G, (unsigned)a.nkb);
  int e;
  if constexpr (sizeof(T) == 4) {
    auto kernel = flash_attn_bwd_f32_kernel<D, kF32Threads>;
    constexpr size_t bytes = F32Layout<D>::BYTES;
    if ((e = allow_smem(kernel, bytes)) != 0) return e;
    kernel<<<grid, kF32Threads, bytes, stream>>>(a);
  } else {
    auto kernel = flash_attn_bwd_mma_kernel<T, D>;
    constexpr size_t bytes = MmaLayout<D>::BYTES;
    if ((e = allow_smem(kernel, bytes)) != 0) return e;
    kernel<<<grid, MmaLayout<D>::NT, bytes, stream>>>(a);
  }
  if ((e = (int)cudaGetLastError()) != 0) return e;
  if (a.dq != nullptr && a.nkb > 1) {
    const long long n = (long long)G * a.Tq * a.d;
    const long long blocks = (n + 255) / 256;
    flash_attn_bwd_dq_sum_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                                      256, 0, stream>>>(
        a.ws, static_cast<T*>(a.dq), a.nkb, a.H, a.Tq, a.d, n, a.dqs);
    e = (int)cudaGetLastError();
  }
  return e;
}

template <typename T>
int launch_d(const Args& a, int G, cudaStream_t s) {
  if (a.d <= 32) return launch<T, 32>(a, G, s);
  if (a.d <= 64) return launch<T, 64>(a, G, s);
  return launch<T, 128>(a, G, s);
}

template <typename T, int D>
int occupancy(int* out) {
  if constexpr (sizeof(T) == 4)
    return occupancy_of(flash_attn_bwd_f32_kernel<D, kF32Threads>,
                        kF32Threads, F32Layout<D>::BYTES, out);
  else
    return occupancy_of(flash_attn_bwd_mma_kernel<T, D>, MmaLayout<D>::NT,
                        MmaLayout<D>::BYTES, out);
}

template <typename T>
int occupancy_d(int d, int* out) {
  if (d <= 32) return occupancy<T, 32>(out);
  if (d <= 64) return occupancy<T, 64>(out);
  return occupancy<T, 128>(out);
}

int key_block_of(int d) {
  return d <= 32 ? key_block<32>() : d <= 64 ? key_block<64>()
                                             : key_block<128>();
}

Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace

// The keys one CTA covers at head dimension d and element type dtype (0 =
// f32, 1 = bf16, 2 = f16): dq takes ceil(Tk / key_block) partials when Tk is
// above it. 0 for what the kernel does not take.
extern "C" int dl4j_flash_attn_bwd_key_block(int d, int dtype) {
  if (d <= 0 || d > 128 || dtype < 0 || dtype > 2) return 0;
  return key_block_of(d);
}

// The fused kernel's resources at head dimension d and element type dtype
// (as above) into out[5]: registers a thread, threads a CTA, shared-memory
// bytes a CTA, local bytes a thread, CTAs resident on one SM. Returns the CUDA
// error, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int dl4j_flash_attn_bwd_occupancy(int d, int dtype, int* out) {
  if (d <= 0 || d > 128 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return occupancy_d<float>(d, out);
    case 1: return occupancy_d<__nv_bfloat16>(d, out);
    default: return occupancy_d<__half>(d, out);
  }
}

// strides: 21 element strides, (batch, head, row) of q, k, v, do, dq, dk and
// dv in that order (any values for an output not asked for). dq may be null
// (no dq); dk and dv are both null or both set. ws: f32 [nkb, B*H, Tq, d]
// with nkb = ceil(Tk / key_block), needed when dq is asked for and nkb > 1.
// kb may be null; m, l and di are f32 [B*H, Tq]. vec bit 0: every one of q,
// k, v and do starts on 16 bytes and has row, head and batch strides of 16
// bytes; bit 1: so have dk and dv.
// Returns the CUDA error of the launches (0 on success), or
// cudaErrorInvalidValue for a shape, head dimension (1..128), dtype or
// output set the kernel does not take.
extern "C" int dl4j_flash_attn_bwd(const void* q, const void* k,
                                   const void* v, const float* kb,
                                   const float* m, const float* l,
                                   const float* di, const void* dout,
                                   void* dq, void* dk, void* dv, float* ws,
                                   int B, int H, int Tq, int Tk, int d,
                                   const long long* strides, float scale,
                                   int dtype, int vec, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || d <= 0 || d > 128 ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int bk = key_block_of(d);
  const int nkb = (Tk + bk - 1) / bk;
  if (nkb > 65535 || (dk == nullptr) != (dv == nullptr) ||
      (dq == nullptr && dk == nullptr) ||
      (dq != nullptr && nkb > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, kb, m, l, di, dq, dk, dv, ws, H, Tq, Tk, d, nkb,
         at(strides, 0), at(strides, 1), at(strides, 2), at(strides, 3),
         at(strides, 4), at(strides, 5), at(strides, 6), scale, vec & 1,
         (vec >> 1) & 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(a, B * H, s);
    case 1: return launch_d<__nv_bfloat16>(a, B * H, s);
    default: return launch_d<__half>(a, B * H, s);
  }
}
