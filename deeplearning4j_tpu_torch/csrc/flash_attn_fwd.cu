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
// On CUDA cores the products are held back by the shared-memory loads that
// feed them, so the design reuses every loaded operand across a register
// tile.
//
// Design: one CTA of 256 threads per (batch*head, block of 64 query rows);
// the TPU's sequential key grid is the loop inside the CTA, over key tiles
// of BK = 64 keys (32 at d > 64). The q block and each tile of k, v and the
// key bias are staged by cp.async, 16 bytes a copy (zero-filled past d and
// past the last row) when every row of q, k and v starts on a 16-byte
// boundary, else element by element; the next tile's copies are issued
// before this tile's products, into the other of two buffers, k (with the
// bias) and v as two groups, so that the scores wait for k alone. Thread
// (ai, aj) = (tid / 16, tid % 16) owns query rows ai + 16 v (v = 0..3):
//
// - scores: a register tile of 4 rows x BK/16 keys (aj + 16 u), each pair
//   the dot product over d in order, one fused multiply-add a term from 0,
//   then score(): flash_attn_common.cuh's contract, so the backward, which
//   recomputes the scores, gets them bit for bit and a fully masked row
//   gets s - m = 0 exactly. Each q and k float4 read from shared memory
//   (rows padded by 4 floats: 8 consecutive rows hit 32 distinct banks)
//   feeds 4 rows or 4 keys.
// - online softmax: the 16 threads that share a row are one half-warp; the
//   tile's row max comes from 4 shuffles, the running max m and the row
//   sums (a partial per thread, summed over the half-warp at the end) stay
//   in registers, and p v is rescaled by alpha = exp(m_old - m_new).
// - p v: p, rounded to v's type, goes to shared memory once.
//   f32 (flash_attn_fwd_kernel<float, D>): o is a register tile of the
//   same 4 rows x d/16 columns; each p and v float4 feeds 4 rows or 4
//   columns. (8 rows a thread in 128 threads was 5% slower: fewer warps.)
//   bf16 / f16: the tensor cores, mma.sync.m16n8k16 with f32 accumulators,
//   p and v loaded by ldmatrix from 16-bit copies; warp w owns rows
//   16 (w % 4) .. + 15 and half of o's columns. p is already rounded to
//   v's type, so the products are exact and only the order of the f32 sum
//   changes. The scores stay on CUDA cores, from f32 copies of q and k, in
//   the shared order: tensor-core scores round unlike the in-order f32 sum
//   (flash_attn_bwd.cu records what that cost the backward).
// - keys past Tk get s = -inf (p = 0), query rows past Tq are computed but
//   not stored: ragged lengths need no padding and no shape fallback. A
//   fully masked row has all scores equal to the clamped bias, so it gets
//   uniform attention, as in the plain version.
// - the sums run in a fixed order (no atomics), so reruns are bitwise
//   equal; they run in another order than PyTorch's, and expf may differ
//   from PyTorch's exp by an ulp. s = dot * scale + kb is a rounded product
//   and a rounded sum (no fused multiply-add), as in the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attn_common.cuh"

namespace {

using namespace dl4j;

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per CTA
constexpr int kGroups = 16;    // key / column groups (aj)
constexpr int RV = 4;          // query rows per thread
constexpr int NRG = kBQ / RV;  // row groups (ai): rows ai + NRG v

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* kb;
  void* o;
  float* m;
  float* l;
  int H, Tq, Tk, d;
  Strides qs, ks, vs, os;
  float scale;
  int vec;      // every row of q, k and v starts on a 16-byte boundary
  int vec_out;  // and every row of o
};

template <int D>
__host__ __device__ constexpr int key_tile() { return D <= 64 ? 64 : 32; }

// Shared-memory layout in bytes. f32: q, two buffers of k and of v, all
// f32 rows FS floats apart, and p. 16-bit: f32 copies of q and of the
// current k tile (for the scores), 16-bit q, two buffers of 16-bit k and v
// (HS elements a row, for ldmatrix), 16-bit p, and the rows' alpha and l.
// Both: two buffers of the key bias.
template <typename T, int D>
struct Layout {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BK = key_tile<D>();
  static constexpr int FS = D + 4;
  static constexpr int HS = D + 8;
  static constexpr int PS = F32 ? BK + 16 : BK + 8;  // rows of p
  static constexpr int FQ = 0;
  static constexpr int FK = FQ + 4 * kBQ * FS;
  static constexpr int FV = FK + 4 * BK * FS * (F32 ? 2 : 1);
  static constexpr int HQ = FV + (F32 ? 4 * 2 * BK * FS : 0);
  static constexpr int HK = HQ + (F32 ? 0 : 2 * kBQ * HS);
  static constexpr int HV = HK + (F32 ? 0 : 2 * 2 * BK * HS);
  static constexpr int P = HV + (F32 ? 0 : 2 * 2 * BK * HS);
  static constexpr int BIAS = P + (F32 ? 4 : 2) * kBQ * PS;
  static constexpr int ROW = BIAS + 4 * 2 * BK;
  static constexpr size_t BYTES = (size_t)ROW + (F32 ? 0 : 4 * 2 * kBQ);
};

// The sum of v over the 16 lanes of a half-warp (xor 8, 4, 2, 1), and the
// max.
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attn_fwd_kernel(const Args a) {
  using L = Layout<T, D>;
  constexpr bool F32 = L::F32;
  constexpr int BK = L::BK, FS = L::FS, HS = L::HS, PS = L::PS;
  constexpr int TJ = BK / kGroups;  // keys per thread in a tile
  constexpr int CW = D / kGroups;   // f32: o columns per thread
  constexpr int NT8 = D / 16;       // 16-bit: n-tiles of 8 columns per warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* fQ = reinterpret_cast<float*>(smem + L::FQ);
  float* fK = reinterpret_cast<float*>(smem + L::FK);
  float* fV = reinterpret_cast<float*>(smem + L::FV);
  T* hQ = reinterpret_cast<T*>(smem + L::HQ);
  T* hK = reinterpret_cast<T*>(smem + L::HK);
  T* hV = reinterpret_cast<T*>(smem + L::HV);
  float* sB = reinterpret_cast<float*>(smem + L::BIAS);
  float* sAlpha = reinterpret_cast<float*>(smem + L::ROW);  // 16-bit only
  float* sL = sAlpha + kBQ;

  // the query blocks of one head are neighbours in the grid, so they run
  // together and the later ones find k and v in L2
  const int g = blockIdx.x;
  const int b = g / a.H;
  const int h = g - b * a.H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int ai = tid >> 4, aj = tid & 15;
  const bool vec = a.vec != 0;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* kbrow = a.kb != nullptr ? a.kb + (long long)b * a.Tk : nullptr;

  // k and the key bias, then v, of keys [j0, j0 + BK) into buffer `buf`:
  // two groups of copies, so that the scores need not wait for v
  auto stage_k = [&](int j0, int buf) {
    if constexpr (F32)
      stage<float, BK, D, FS, kThreads>(fK + buf * BK * FS, kg, a.ks.t, j0,
                                        a.Tk, a.d, vec);
    else
      stage<T, BK, D, HS, kThreads>(hK + buf * BK * HS, kg, a.ks.t, j0, a.Tk,
                                    a.d, vec);
    for (int r = tid; r < BK; r += kThreads) {
      float* dst = sB + buf * BK + r;
      if (kbrow == nullptr) {
        *dst = 0.0f;
      } else {
        const bool in = j0 + r < a.Tk;
        cp_async4(dst, kbrow + (in ? j0 + r : 0), in ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  auto stage_v = [&](int j0, int buf) {
    if constexpr (F32)
      stage<float, BK, D, FS, kThreads>(fV + buf * BK * FS, vg, a.vs.t, j0,
                                        a.Tk, a.d, vec);
    else
      stage<T, BK, D, HS, kThreads>(hV + buf * BK * HS, vg, a.vs.t, j0, a.Tk,
                                    a.d, vec);
    cp_async_commit();
  };

  if constexpr (F32)
    stage<float, kBQ, D, FS, kThreads>(fQ, qg, a.qs.t, q0, a.Tq, a.d, vec);
  else
    stage<T, kBQ, D, HS, kThreads>(hQ, qg, a.qs.t, q0, a.Tq, a.d, vec);
  stage_k(0, 0);  // one group with q
  stage_v(0, 0);

  float m_run[RV], l_run[RV];  // l_run: this thread's share of the row sum
#pragma unroll
  for (int v = 0; v < RV; ++v) {
    m_run[v] = -INFINITY;
    l_run[v] = 0.0f;
  }
  // o: f32 a register tile [RV rows][CW columns]; 16-bit the mma
  // accumulators of NT8 n-tiles
  float o[F32 ? RV : 1][F32 ? CW : 1];
  float om[F32 ? 1 : NT8][4];
#pragma unroll
  for (int v = 0; v < RV; ++v) {
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      if constexpr (F32) o[v][c] = 0.0f;
    }
  }
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (!F32) om[n][e] = 0.0f;
    }
  }

  int buf = 0;
  for (int j0 = 0; j0 < a.Tk; j0 += BK, buf ^= 1) {
    cp_async_wait_group<1>();  // this tile's k (v may be in flight)
    __syncthreads();  // k has landed; the last tile is consumed
    const bool next = j0 + BK < a.Tk;
    if (next) {
      stage_k(j0 + BK, buf ^ 1);
      stage_v(j0 + BK, buf ^ 1);
    }
    const float* cK = fK;
    if constexpr (F32) {
      cK = fK + buf * BK * FS;
    } else {  // f32 copies of q (once) and of this k tile for the scores
      if (j0 == 0) widen<T, kBQ, D, HS, FS, kThreads>(fQ, hQ);
      widen<T, BK, D, HS, FS, kThreads>(fK, hK + buf * BK * HS);
      __syncthreads();
    }

    // ---- scores: rows ai + NRG v, keys aj + 16 u, over d in order ----
    float s[RV][TJ];
#pragma unroll
    for (int v = 0; v < RV; ++v) {
#pragma unroll
      for (int u = 0; u < TJ; ++u) s[v][u] = 0.0f;
    }
#pragma unroll(F32 ? D / 4 : 4)
    for (int c = 0; c < D; c += 4) {
      float4 kf[TJ];
#pragma unroll
      for (int u = 0; u < TJ; ++u)
        kf[u] = *reinterpret_cast<const float4*>(cK + (aj + 16 * u) * FS + c);
#pragma unroll
      for (int v = 0; v < RV; ++v) {
        const float4 qf =
            *reinterpret_cast<const float4*>(fQ + (ai + NRG * v) * FS + c);
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

    // ---- online softmax; p rounded to v's type into shared memory ----
    const float* cB = sB + buf * BK;
    float alpha[RV];
#pragma unroll
    for (int v = 0; v < RV; ++v) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < TJ; ++u) {
        const int j = aj + 16 * u;
        s[v][u] = j0 + j < a.Tk ? score(s[v][u], a.scale, cB[j]) : -INFINITY;
        mx = fmaxf(mx, s[v][u]);
      }
      const float m_new = fmaxf(m_run[v], half_max(mx));
      alpha[v] = expf(m_run[v] - m_new);
      float lsum = l_run[v] * alpha[v];
      const int row = ai + NRG * v;
#pragma unroll
      for (int u = 0; u < TJ; ++u) {
        const float p = expf(s[v][u] - m_new);
        lsum += p;
        if constexpr (F32)
          reinterpret_cast<float*>(smem + L::P)[row * PS + aj + 16 * u] = p;
        else
          reinterpret_cast<T*>(smem + L::P)[row * PS + aj + 16 * u] =
              from_f32<T>(p);
      }
      l_run[v] = lsum;
      m_run[v] = m_new;
      if constexpr (!F32) {
        if (aj == 0) sAlpha[row] = alpha[v];
      }
    }

    // ---- o = o * alpha + p v ----
    if (next)  // this tile's v
      cp_async_wait_group<2>();
    else
      cp_async_wait_group<0>();
    if constexpr (F32) {
      const float* sP = reinterpret_cast<const float*>(smem + L::P);
      const float* cV = fV + buf * BK * FS;
      __syncthreads();  // v has landed; each row's p is written
#pragma unroll
      for (int v = 0; v < RV; ++v) {
#pragma unroll
        for (int c = 0; c < CW; ++c) o[v][c] *= alpha[v];
      }
#pragma unroll 4
      for (int j = 0; j < BK; j += 4) {
        float4 pr[RV];
#pragma unroll
        for (int v = 0; v < RV; ++v)
          pr[v] = *reinterpret_cast<const float4*>(sP + (ai + NRG * v) * PS +
                                                   j);
        float vv[4][CW];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vr = cV + (j + u) * FS;
          if constexpr (D >= 64) {
#pragma unroll
            for (int w = 0; w < CW / 4; ++w) {
              const float4 x =
                  *reinterpret_cast<const float4*>(vr + 64 * w + 4 * aj);
              vv[u][4 * w] = x.x; vv[u][4 * w + 1] = x.y;
              vv[u][4 * w + 2] = x.z; vv[u][4 * w + 3] = x.w;
            }
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vr + 2 * aj);
            vv[u][0] = x.x; vv[u][1] = x.y;
          }
        }
#pragma unroll
        for (int v = 0; v < RV; ++v) {
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            float x = o[v][c];
            x = fmaf(pr[v].x, vv[0][c], x);
            x = fmaf(pr[v].y, vv[1][c], x);
            x = fmaf(pr[v].z, vv[2][c], x);
            x = fmaf(pr[v].w, vv[3][c], x);
            o[v][c] = x;
          }
        }
      }
    } else {
      const T* sP = reinterpret_cast<const T*>(smem + L::P);
      const T* cV = hV + buf * BK * HS;
      const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2;
      const int mt = warp & 3;  // rows 16 mt .. 16 mt + 15
      const int cb = (warp >> 2) * (D / 2);  // the warp's half of o
      __syncthreads();  // v has landed; p and alpha of every row are written
      const float a0 = sAlpha[16 * mt + gq], a1 = sAlpha[16 * mt + gq + 8];
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        om[n][0] *= a0; om[n][1] *= a0;
        om[n][2] *= a1; om[n][3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        ldsm_x4(pa, sP + (16 * mt + (lane & 15)) * PS + 16 * kk +
                        ((lane >> 4) << 3));
        const int row = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int np = 0; np < NT8 / 2; ++np) {
          uint32_t bv[4];
          ldsm_x4_t(bv, cV + row * HS + cb + 16 * np + ((lane >> 4) << 3));
          mma<T>(om[2 * np], pa, bv[0], bv[1]);
          mma<T>(om[2 * np + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }

  cp_async_wait_all();  // Tk = 0: the first tile's copies

  // ---- the row sums, m and l, then o = acc / l rounded once ----
  float safe[RV];
#pragma unroll
  for (int v = 0; v < RV; ++v) {
    const float l = half_sum(l_run[v]);
    safe[v] = l == 0.0f ? 1.0f : l;
    const int row = q0 + ai + NRG * v;
    if (aj == 0) {
      if (row < a.Tq) {
        a.m[(long long)g * a.Tq + row] = m_run[v];
        a.l[(long long)g * a.Tq + row] = safe[v];
      }
      if constexpr (!F32) sL[ai + NRG * v] = safe[v];
    }
  }
  T* og = static_cast<T*>(a.o) + b * a.os.b + h * a.os.h;
  if constexpr (F32) {
#pragma unroll
    for (int v = 0; v < RV; ++v) {
      const int row = q0 + ai + NRG * v;
      if (row >= a.Tq) continue;
      float* orow = reinterpret_cast<float*>(og) + row * a.os.t;
      if constexpr (D >= 64) {
#pragma unroll
        for (int w = 0; w < CW / 4; ++w) {
          const int c = 64 * w + 4 * aj;
          if (a.vec_out && c + 3 < a.d) {  // one 16-byte store
            *reinterpret_cast<float4*>(orow + c) = make_float4(
                o[v][4 * w] / safe[v], o[v][4 * w + 1] / safe[v],
                o[v][4 * w + 2] / safe[v], o[v][4 * w + 3] / safe[v]);
            continue;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < a.d) orow[c + e] = o[v][4 * w + e] / safe[v];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (2 * aj + e < a.d) orow[2 * aj + e] = o[v][e] / safe[v];
      }
    }
  } else {
    __syncthreads();  // every row's l is in sL
    const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
    const int mt = warp & 3;
    const int cb = (warp >> 2) * (D / 2);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * mt + gq + 8 * hf;
      const int row = q0 + r;
      if (row >= a.Tq) continue;
      const float lr = sL[r];
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = cb + 8 * n + 2 * tq + e;
          if (c < a.d)
            og[row * a.os.t + c] = from_f32<T>(om[n][2 * hf + e] / lr);
        }
      }
    }
  }
}

template <typename T, int D>
__host__ int launch(const Args& a, int G, cudaStream_t stream) {
  auto kernel = flash_attn_fwd_kernel<T, D>;
  constexpr size_t bytes = Layout<T, D>::BYTES;
  int e;
  if ((e = allow_smem(kernel, bytes)) != 0) return e;
  const dim3 grid((unsigned)G, (unsigned)((a.Tq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int G, cudaStream_t s) {
  if (a.d <= 32) return launch<T, 32>(a, G, s);
  if (a.d <= 64) return launch<T, 64>(a, G, s);
  return launch<T, 128>(a, G, s);
}

template <typename T, int D>
int occupancy(int* out) {
  return occupancy_of(flash_attn_fwd_kernel<T, D>, kThreads,
                      Layout<T, D>::BYTES, out);
}

template <typename T>
int occupancy_d(int d, int* out) {
  if (d <= 32) return occupancy<T, 32>(out);
  if (d <= 64) return occupancy<T, 64>(out);
  return occupancy<T, 128>(out);
}

// True when p and every (batch, head, row) stride of the operand are
// multiples of 16 bytes.
bool rows16(const void* p, const long long* st, int itemsize) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] * itemsize % 16 != 0) return false;
  return true;
}

}  // namespace

// The kernel's resources at head dimension d and element type dtype (0 =
// f32, 1 = bf16, 2 = f16) into out[5]: registers a thread, threads a CTA,
// shared-memory bytes a CTA, local bytes a thread, CTAs resident on one SM.
// Returns the CUDA error, or cudaErrorInvalidValue for what the kernel does
// not take.
extern "C" int dl4j_flash_attn_fwd_occupancy(int d, int dtype, int* out) {
  if (d <= 0 || d > 128 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return occupancy_d<float>(d, out);
    case 1: return occupancy_d<__nv_bfloat16>(d, out);
    default: return occupancy_d<__half>(d, out);
  }
}

// strides: 12 element strides, (batch, head, row) of q, k, v and o in that
// order. dtype: 0 = f32, 1 = bf16, 2 = f16. kb may be null. The 16-byte
// copies are taken when q, k and v start on 16 bytes and all their strides
// are multiples of 16 bytes, and the 16-byte stores of f32 o when o's are
// (kernels/flash_attention.py::_rows_aligned states the same rule). Returns
// the CUDA error of the launch (0 on success), or cudaErrorInvalidValue for
// a shape, head dimension (1..128) or dtype the kernel does not take.
extern "C" int dl4j_flash_attn_fwd(const void* q, const void* k, const void* v,
                                   const float* kb, void* o, float* m, float* l,
                                   int B, int H, int Tq, int Tk, int d,
                                   const long long* strides, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || d <= 0 || d > 128 ||
      dtype < 0 || dtype > 2 || (Tq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  const Args a{q, k, v, kb, o, m, l, H, Tq, Tk, d,
               Strides{strides[0], strides[1], strides[2]},
               Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]},
               Strides{strides[9], strides[10], strides[11]}, scale,
               rows16(q, strides, itemsize) && rows16(k, strides + 3, itemsize)
                   && rows16(v, strides + 6, itemsize),
               rows16(o, strides + 9, itemsize)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(a, B * H, st);
    case 1: return launch_d<__nv_bfloat16>(a, B * H, st);
    default: return launch_d<__half>(a, B * H, st);
  }
}
