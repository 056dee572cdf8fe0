// K7: the LayerNorm-epilogue backward. Given x, gamma, beta, the forward's
// per-row mu and rstd, and dy = dL/dy for y = act(xhat * gamma + beta):
//
//   xhat   = (x - mu) * rstd,  z = xhat * gamma + beta   (recomputed, f32)
//   dz     = dy * act'(z),     dxh = dz * gamma
//   dx     = (dxh - mean(dxh) - xhat * mean(dxh * xhat)) * rstd, x's dtype
//   dgamma = sum over rows of dz * xhat                   (f32 [C])
//   dbeta  = sum over rows of dz                          (f32 [C])
//
// Replaces deeplearning4j_tpu/ops/fused_epilogues.py::_fused_epilogue_ln_bwd
// (its pallas_call is in _ln_bwd_impl, the backward rule of the custom VJP
// that layer_norm_act reaches).
//
// x, dy and dx are row-major [rows, C] buffers in f32, bf16 or f16; gamma,
// beta, dgamma and dbeta f32 vectors of length C; mu and rstd one f32 per
// row.
//
// Bound: memory traffic. The kernel reads x and dy and writes dx once each
// (3 * rows * C elements), plus [C] vectors and two f32 per row; a few
// dozen flops per element at most, far below the card's f32 rate.
//
// Design: one launch a call, a small persistent grid, rows staged ahead.
//
// - Rows. A row lives in the registers of a group of G = 32 * WPR threads
//   (one warp up to 1024 columns, 4 or 8 warps above; NV values a thread,
//   kernels/layer_norm_act.py::row_config). A CTA of 256 threads holds
//   GROUPS = 256 / G groups (8 up to 1024 columns) and streams one
//   contiguous run of rows; its groups take those rows in turn. The grid
//   has one CTA an SM, all resident at once, so every CTA walks many rows
//   and the merge below reads one workspace row an SM.
// - Staging. Where a row's bytes are a multiple of 16 and the pointers
//   16-byte aligned, each group keeps a ring of STAGES row slots (x, dy,
//   and each thread's copy of the row's mu and rstd) in shared memory, and
//   fills the slots STAGES - 1 rows ahead with cp.async: 16-byte copies of
//   x and dy, 4-byte ones of mu and rstd. Each thread copies exactly the
//   16-byte chunks it reads back (chunk t + j * G of the row), so a
//   thread's own cp.async.wait_group makes its row visible to it and the
//   staging needs no barrier. Shared memory is read, and dx written, in
//   16-byte vectors. gamma and beta are copied into shared memory once a
//   CTA. Rows whose bytes are not a multiple of 16 (C = 37 in f32, odd C in
//   16-bit) take the same kernel without the ring: scalar loads straight
//   from device memory, column t + k * G of a thread's k-th value.
// - Column sums, in one launch with a fixed order and no float atomics.
//   Each thread sums dz * xhat and dz of its columns over its group's rows
//   in row order; the CTA adds its groups' sums in group order (in shared
//   memory, reusing the ring) and writes its totals as one row of a
//   per-device workspace [ctas][2 * C]. The launch is cooperative, so every
//   CTA is resident at once and they can meet at a grid barrier (an
//   integer arrival count and generation, reset by the last to arrive).
//   Then the CTAs add the 2 * C (array, column) pairs over the CTAs' rows
//   in CTA order, in blocks of 32 pairs: a lane a pair (a warp reads one
//   128-byte line of a row); R warps share a block, each adding a
//   contiguous run of at most 32 rows (all loaded at once) in order, the
//   runs' sums added in run order (R = 8 for 132 CTAs, 1 up to 32). 48
//   CTAs share the merge at C = 768, so no CTA walks all the others' sums
//   alone.
// - Layout, measured at (4096, 768) against two CTAs of 128 threads an SM
//   and 2 to 4 stages: 256 threads an SM and 3 stages were the fastest in
//   both f32 and bf16 (PERF.md section 6, "Tried").
// - gamma and beta are loaded before the ring's first copies are issued,
//   so that they are not queued behind them.
// - Instances. One kernel a (dtype, row layout, staged or not): 36 in
//   all. The activation is an argument: the identity (the fused BERT
//   path's) takes one pass with dz = dy; any other takes act'(z) over the
//   row's values in one uniform branch (each case an unrolled loop),
//   between a pass that makes xhat and z and one that makes dz and dxh,
//   which reads dy and gamma again from shared memory.
//
// The wrapper takes the layout from the shape and the card's SM count
// alone (kernels/layer_norm_act.py::bwd_layout), so the same inputs give
// bitwise-equal dx, dgamma and dbeta on every run. The row means are a
// warp's xor butterfly and the warps' sums in a fixed order, as in K6.
//
// xhat, z, dz, dxh and dx are rounded products and sums (no fused
// multiply-add), in the plain PyTorch version's order; the activation's
// derivative is epilogue_act.cuh's, bit for bit K2's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "epilogue_act.cuh"
#include "launch.cuh"

namespace {

using namespace dl4j;

constexpr int kMaxStages = 3;
constexpr int kMergeLoads = 32;  // workspace rows a lane loads at once

// A CTA: 8 warps, one to an SM (kernels/layer_norm_act.py::bwd_layout).
constexpr int kThreads = 256;

// The dynamic shared memory of a CTA: gamma and beta (later the CTA's
// column totals), each thread's (mu, rstd) slot of every stage, and the
// larger of the row ring and the groups' column sums; at least a float a
// thread (the merge's warp sums).
__host__ __device__ inline size_t smem_bytes(int cols, int itemsize,
                                             int threads, int groups,
                                             int stages, bool staged) {
  const size_t gb = 2 * sizeof(float) * (size_t)cols;
  const size_t mr = staged ? 2 * sizeof(float) * (size_t)threads * stages : 0;
  const size_t ring =
      staged ? (size_t)groups * stages * 2 * (size_t)cols * itemsize : 0;
  const size_t red = groups > 1 ? 2 * sizeof(float) * (size_t)groups * cols : 0;
  const size_t all = gb + mr + (ring > red ? ring : red);
  const size_t merge = sizeof(float) * (size_t)threads;
  return all > merge ? all : merge;
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (pending is STAGES - 1: 1 or 2).
__device__ __forceinline__ void wait_pending(int pending) {
  if (pending >= 2) cp_async_wait_group<2>();
  else cp_async_wait_group<1>();
}

// VEC elements of T at p (16 bytes when VEC * sizeof(T) == 16) as f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC * sizeof(T) == 16) {
    alignas(16) T v[VEC];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int q = 0; q < VEC; ++q) out[q] = to_f32<T>(v[q]);
  } else {
    static_assert(VEC == 1, "a vector is 16 bytes or one element");
    out[0] = to_f32<T>(*p);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr (VEC * sizeof(T) == 16) {
    alignas(16) T v[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = from_f32<T>(in[q]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  } else {
    p[0] = from_f32<T>(in[0]);
  }
}

// VEC f32 from shared memory at s (16-byte aligned when VEC >= 4).
template <int VEC>
__device__ __forceinline__ void load_f32(const float* s, float* out) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int q = 0; q < VEC; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s + q);
      out[q] = v.x;
      out[q + 1] = v.y;
      out[q + 2] = v.z;
      out[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) out[q] = s[q];
  }
}

// VEC f32 into shared memory at s (16-byte aligned when VEC >= 4): 16-byte
// stores, so that lanes VEC apart hit no bank twice.
template <int VEC>
__device__ __forceinline__ void store_f32(float* s, const float* in) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int q = 0; q < VEC; q += 4)
      *reinterpret_cast<float4*>(s + q) =
          make_float4(in[q], in[q + 1], in[q + 2], in[q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) s[q] = in[q];
  }
}

// The two row sums of group grp: a warp's xor butterfly, then (WPR > 1)
// the group's warps' sums in warp order, through red (the row's parity
// half of a [2][2][8] buffer, indexed by the CTA's warp) and the group's
// own named barrier (groups walk different numbers of rows); the same
// bits in every thread of the group.
template <int WPR>
__device__ __forceinline__ void row_sums(float& a, float& b, float (*red)[8],
                                         int grp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if constexpr (WPR > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[0][warp] = a;
      red[1][warp] = b;
    }
    // barrier 1 + grp, the group's 32 * WPR threads (0 is __syncthreads)
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * WPR)
                 : "memory");
    const int w0 = grp * WPR;
    a = red[0][w0];
    b = red[1][w0];
#pragma unroll
    for (int w = 1; w < WPR; ++w) {
      a += red[0][w0 + w];
      b += red[1][w0 + w];
    }
  }
}

// z -> act'(z) over a row's NV values, the activation chosen at run time
// (each case its own unrolled loop).
template <int NV>
__device__ __forceinline__ void act_grads(int act, float* z) {
#define DL4J_ACT_CASE(A)                                      \
  case A:                                                     \
    _Pragma("unroll") for (int e = 0; e < NV; ++e) z[e] =    \
        act_grad<A>(z[e]);                                    \
    break;
  switch (act) {
    DL4J_ACT_CASE(IDENTITY)
    DL4J_ACT_CASE(RELU)
    DL4J_ACT_CASE(RELU6)
    DL4J_ACT_CASE(TANH)
    DL4J_ACT_CASE(SIGMOID)
    DL4J_ACT_CASE(GELU)
    default:
      _Pragma("unroll") for (int e = 0; e < NV; ++e) z[e] =
          act_grad<GELU_EXACT>(z[e]);
  }
#undef DL4J_ACT_CASE
}

// One row's xhat, dxh, column-sum updates and row sums (s1 = sum dxh, s2 =
// sum dxh * xhat) over a thread's NV values. The identity reads x, dy and
// gamma once (dz = dy); any other activation makes xhat and z, takes
// act'(z) over the row in one uniform branch (each case an unrolled loop),
// then reads dy and gamma again (shared memory, or unstaged the cache) for
// dz = dy * act'(z).
template <bool IDENT, typename T, int NV, int VEC, int G>
__device__ __forceinline__ void row_grads(const T* sx, const T* sd,
                                          const float* gs, int cols, int t,
                                          int act, float m, float rs,
                                          float* xh, float* dxh,
                                          float* acc_g, float* acc_b,
                                          float& s1, float& s2) {
  constexpr int NVV = NV / VEC;
  if constexpr (!IDENT) {
#pragma unroll
    for (int j = 0; j < NVV; ++j) {
      const int c = (t + j * G) * VEC;
      if (c < cols) {
        float xv[VEC], g[VEC], b[VEC];
        load_vec<T, VEC>(sx + c, xv);
        load_f32<VEC>(gs + c, g);
        load_f32<VEC>(gs + cols + c, b);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const int e = j * VEC + q;
          xh[e] = __fmul_rn(__fsub_rn(xv[q], m), rs);
          dxh[e] = affine(xh[e], g[q], b[q]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          xh[j * VEC + q] = 0.0f;
          dxh[j * VEC + q] = 0.0f;
        }
      }
    }
    act_grads<NV>(act, dxh);
  }
#pragma unroll
  for (int j = 0; j < NVV; ++j) {
    const int c = (t + j * G) * VEC;
    if (c < cols) {
      float dv[VEC], g[VEC];
      load_vec<T, VEC>(sd + c, dv);
      load_f32<VEC>(gs + c, g);
      if constexpr (IDENT) {
        float xv[VEC];
        load_vec<T, VEC>(sx + c, xv);
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          xh[j * VEC + q] = __fmul_rn(__fsub_rn(xv[q], m), rs);
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const int e = j * VEC + q;
        // act'(z) = 1: dz = dy * 1 = dy exactly
        const float dz = IDENT ? dv[q] : __fmul_rn(dv[q], dxh[e]);
        acc_g[e] = __fadd_rn(acc_g[e], __fmul_rn(dz, xh[e]));
        acc_b[e] += dz;
        dxh[e] = __fmul_rn(dz, g[q]);
        s1 += dxh[e];
        s2 = __fadd_rn(s2, __fmul_rn(dxh[e], xh[e]));
      }
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        xh[j * VEC + q] = 0.0f;
        dxh[j * VEC + q] = 0.0f;
      }
    }
  }
}

// A barrier of every CTA of a co-resident grid (thread 0 of each CTA calls
// it after a CTA barrier; bar = {arrivals, generation}, arrivals zero between
// uses). Each CTA's writes before it are visible to every CTA after it.
__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int ctas) {
  volatile unsigned int* gen = bar + 1;
  const unsigned int g = *gen;  // read before this CTA arrives
  __threadfence();  // this CTA's writes, and the read above, come first
  if (atomicAdd(bar, 1u) == ctas - 1) {
    bar[0] = 0;  // every CTA has arrived: ready for the next use
    __threadfence();
    atomicAdd(bar + 1, 1u);
  } else {
    while (*gen == g) __nanosleep(64);
  }
  __threadfence();
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;
  const float* mu;
  const float* rstd;
  const void* dy;
  void* dx;
  float* dgamma;
  float* dbeta;
  float* part;        // [ctas][2 * cols] workspace
  unsigned int* bar;  // the grid barrier's {arrivals, generation}
  long long rows;
  long long rows_per_cta;
  int cols;
  int stages;
  int act;
};

template <typename T, int NV, int WPR, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
layer_norm_act_bwd_kernel(const Args a) {
  constexpr int THREADS = kThreads;
  constexpr int G = 32 * WPR;
  constexpr int GROUPS = THREADS / G;
  constexpr int VEC = STAGED ? 16 / (int)sizeof(T) : 1;
  constexpr int NVV = NV / VEC;
  static_assert(NV % VEC == 0, "whole vectors a thread");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][2][8];
  const int cols = a.cols;
  const int S = a.stages;
  float* gs = reinterpret_cast<float*>(smem);  // gamma, then beta
  float* mr = gs + 2 * cols;                   // [GROUPS][S][G][2]
  unsigned char* ring_bytes =
      reinterpret_cast<unsigned char*>(mr + (STAGED ? 2 * THREADS * S : 0));
  T* ring = reinterpret_cast<T*>(ring_bytes);  // [GROUPS][S][2][cols]

  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  const int t = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const long long r_begin = (long long)blockIdx.x * a.rows_per_cta;
  long long r_end = r_begin + a.rows_per_cta;
  if (r_end > a.rows) r_end = a.rows;
  const long long first = r_begin + grp;
  const int n = first < r_end ? (int)((r_end - first + GROUPS - 1) / GROUPS)
                              : 0;

  // row i of this group into stage i % S (a commit group either way)
  auto issue = [&](int i) {
    if constexpr (STAGED) {
      if (i < n) {
        const long long r = first + (long long)i * GROUPS;
        const int s = i % S;
        T* sx = ring + (size_t)((grp * S + s) * 2) * cols;
        T* sd = sx + cols;
        const T* gx = x + r * cols;
        const T* gd = dy + r * cols;
#pragma unroll
        for (int j = 0; j < NVV; ++j) {
          const int c = (t + j * G) * VEC;
          if (c < cols) {
            cp_async16(sx + c, gx + c, 16);
            cp_async16(sd + c, gd + c, 16);
          }
        }
        float* m = mr + 2 * ((grp * S + s) * G + t);
        cp_async4(m, a.mu + r, 4);
        cp_async4(m + 1, a.rstd + r, 4);
      }
      cp_async_commit();
    }
  };

  // gamma and beta ahead of the ring's copies in the memory queue: their
  // loads are issued first and stored once the first rows are on the way
  constexpr int kGb = 8;  // values of each a thread loads ahead
  float gv[kGb], bv[kGb];
#pragma unroll
  for (int k = 0; k < kGb; ++k) {
    const int c = threadIdx.x + k * THREADS;
    gv[k] = c < cols ? __ldg(a.gamma + c) : 0.0f;
    bv[k] = c < cols ? __ldg(a.beta + c) : 0.0f;
  }
  if constexpr (STAGED) {
    for (int i = 0; i < S - 1; ++i) issue(i);
  }
#pragma unroll
  for (int k = 0; k < kGb; ++k) {
    const int c = threadIdx.x + k * THREADS;
    if (c < cols) {
      gs[c] = gv[k];
      gs[cols + c] = bv[k];
    }
  }
  for (int c = threadIdx.x + kGb * THREADS; c < cols; c += THREADS) {
    gs[c] = a.gamma[c];
    gs[cols + c] = a.beta[c];
  }
  __syncthreads();

  float acc_g[NV], acc_b[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    acc_g[k] = 0.0f;
    acc_b[k] = 0.0f;
  }

  for (int i = 0; i < n; ++i) {
    const long long r = first + (long long)i * GROUPS;
    const T* sx;
    const T* sd;
    float m, rs;
    if constexpr (STAGED) {
      issue(i + S - 1);  // the slot row i - 1 left; its values are in use
      wait_pending(S - 1);
      const int s = i % S;
      sx = ring + (size_t)((grp * S + s) * 2) * cols;
      sd = sx + cols;
      const float* mp = mr + 2 * ((grp * S + s) * G + t);
      m = mp[0];
      rs = mp[1];
    } else {
      sx = x + r * cols;
      sd = dy + r * cols;
      m = a.mu[r];
      rs = a.rstd[r];
    }
    float xh[NV], dxh[NV];
    float s1 = 0.0f, s2 = 0.0f;
    if (a.act == IDENTITY)
      row_grads<true, T, NV, VEC, G>(sx, sd, gs, cols, t, a.act, m, rs, xh,
                                     dxh, acc_g, acc_b, s1, s2);
    else
      row_grads<false, T, NV, VEC, G>(sx, sd, gs, cols, t, a.act, m, rs, xh,
                                      dxh, acc_g, acc_b, s1, s2);
    row_sums<WPR>(s1, s2, red[i & 1], grp);
    const float m1 = s1 / (float)cols;
    const float m2 = s2 / (float)cols;
    T* dr = dx + r * cols;
#pragma unroll
    for (int j = 0; j < NVV; ++j) {
      const int c = (t + j * G) * VEC;
      if (c < cols) {
        float d[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const int e = j * VEC + q;
          d[q] = __fmul_rn(
              __fsub_rn(__fsub_rn(dxh[e], m1), __fmul_rn(xh[e], m2)), rs);
        }
        store_vec<T, VEC>(dr + c, d);
      }
    }
  }
  if constexpr (STAGED) cp_async_wait_all();
  __syncthreads();  // the ring and gamma/beta are free from here

  // the CTA's column totals into tot (gamma/beta's place): each group's
  // sums, added in group order where the CTA has several (through the
  // ring's place, [GROUPS][2][cols])
  float* tot = gs;
  float* red_g = reinterpret_cast<float*>(ring_bytes);
  float* mine = GROUPS == 1 ? tot : red_g + (size_t)grp * 2 * cols;
#pragma unroll
  for (int j = 0; j < NVV; ++j) {
    const int c = (t + j * G) * VEC;
    if (c < cols) {
      store_f32<VEC>(mine + c, acc_g + j * VEC);
      store_f32<VEC>(mine + cols + c, acc_b + j * VEC);
    }
  }
  if constexpr (GROUPS > 1) {
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += THREADS) {
      float sg = red_g[c], sb = red_g[cols + c];
#pragma unroll
      for (int g = 1; g < GROUPS; ++g) {
        sg += red_g[(size_t)g * 2 * cols + c];
        sb += red_g[((size_t)g * 2 + 1) * cols + c];
      }
      tot[c] = sg;
      tot[cols + c] = sb;
    }
  }
  __syncthreads();

  // this CTA's row of the workspace [ctas][2 * cols], then every CTA waits
  // for every other (the grid is co-resident: a cooperative launch)
  const int npairs = 2 * cols;
  float* row = a.part + (size_t)blockIdx.x * npairs;
  for (int p = threadIdx.x; p < npairs; p += THREADS) row[p] = tot[p];
  __syncthreads();
  if (threadIdx.x == 0) grid_barrier(a.bar, gridDim.x);
  __syncthreads();

  // The merge: a pair block is 32 pairs (pair p: dgamma's column p, then
  // dbeta's column p - cols), lane l of a warp pair 32 * k + l, so a warp
  // reads one 128-byte line of a workspace row. R warps share a block (the
  // least power of two that leaves each at most 32 rows, up to 8): warp
  // part q adds rows [q * span, (q + 1) * span) in order, kMergeLoads at a
  // time all loaded first, and the parts' sums are added in part order. A
  // CTA takes 8 / R blocks at a time, blocks b * 8 / R, ... and every
  // ctas * 8 / R after.
  constexpr int WARPS = THREADS / 32;
  int R = 1;
  while (R < WARPS && R * 32 < (int)gridDim.x) R *= 2;
  const int w = threadIdx.x >> 5;
  const int slot = w / R, q = w % R;
  const int span = ((int)gridDim.x + R - 1) / R;
  const int b0 = q * span;
  const int b1 = min((int)gridDim.x, b0 + span);
  const int step = WARPS / R;
  float* warp_sums = gs;  // [WARPS][32] (smem_bytes), free by now
  for (int kb = blockIdx.x * step; kb * 32 < npairs; kb += gridDim.x * step) {
    const int p = (kb + slot) * 32 + (threadIdx.x & 31);
    float s = 0.0f;
    if (p < npairs) {
      const float* src = a.part + p;
      for (int b = b0; b < b1; b += kMergeLoads) {
        float v[kMergeLoads];
#pragma unroll
        for (int j = 0; j < kMergeLoads; ++j)
          v[j] = b + j < b1 ? __ldcg(src + (size_t)(b + j) * npairs) : 0.0f;
#pragma unroll
        for (int j = 0; j < kMergeLoads; ++j)
          if (b + j < b1) s += v[j];
      }
    }
    if (R > 1) {
      warp_sums[threadIdx.x] = s;
      __syncthreads();
      if (q == 0) {
#pragma unroll
        for (int k = 1; k < WARPS; ++k)
          if (k < R) s += warp_sums[(w + k) * 32 + (threadIdx.x & 31)];
      }
      __syncthreads();  // warp_sums is reused by the next blocks
    }
    if (q == 0 && p < npairs) {
      if (p < cols) a.dgamma[p] = s;
      else a.dbeta[p - cols] = s;
    }
  }
}

// An empty kernel launched as K7 is: the fixed cost of a launch.
__global__ void layer_norm_act_bwd_floor_kernel() {}

template <typename T, int NV, int WPR>
const void* pick_staged(bool staged) {
  return staged ? (const void*)layer_norm_act_bwd_kernel<T, NV, WPR, true>
                : (const void*)layer_norm_act_bwd_kernel<T, NV, WPR, false>;
}

template <typename T>
const void* pick_cfg(int nv, int wpr, bool staged) {
  // the (NV, WPR) pairs of kernels/layer_norm_act.py::row_config
  if (wpr == 1 && nv == 8) return pick_staged<T, 8, 1>(staged);
  if (wpr == 1 && nv == 16) return pick_staged<T, 16, 1>(staged);
  if (wpr == 1 && nv == 24) return pick_staged<T, 24, 1>(staged);
  if (wpr == 1 && nv == 32) return pick_staged<T, 32, 1>(staged);
  if (wpr == 4 && nv == 32) return pick_staged<T, 32, 4>(staged);
  if (wpr == 8 && nv == 32) return pick_staged<T, 32, 8>(staged);
  return nullptr;
}

// The kernel instance for (dtype, nv, wpr, staged), or null.
const void* pick(int dtype, int nv, int wpr, bool staged) {
  switch (dtype) {
    case 0: return pick_cfg<float>(nv, wpr, staged);
    case 1: return pick_cfg<__nv_bfloat16>(nv, wpr, staged);
    case 2: return pick_cfg<__half>(nv, wpr, staged);
    default: return nullptr;
  }
}

// A launch: its kernel, threads and dynamic shared memory, or false for an
// argument the kernel does not take.
struct Launch {
  const void* fn;
  int threads;
  size_t smem;
};

bool plan(long long rows, int cols, int act, int dtype, int nv, int wpr,
          int stages, int ctas, long long rows_per_cta, int staged,
          Launch* l) {
  if (rows <= 0 || cols <= 0 || dtype < 0 || dtype > 2 || act < IDENTITY ||
      act > GELU_EXACT || (long long)cols > 32LL * wpr * nv || stages < 2 ||
      stages > kMaxStages || ctas < 1 || ctas > 65535 ||
      rows_per_cta <= 0 || rows_per_cta * ctas < rows)
    return false;
  const int itemsize = dtype == 0 ? 4 : 2;
  if (staged && ((long long)cols * itemsize) % 16 != 0) return false;
  l->fn = pick(dtype, nv, wpr, staged != 0);
  if (l->fn == nullptr) return false;
  l->threads = kThreads;
  l->smem = smem_bytes(cols, itemsize, l->threads, l->threads / (32 * wpr),
                       stages, staged != 0);
  return l->smem + 1024 <= 227 * 1024;  // and the static shared memory
}

// A cooperative launch of `ctas` x `threads` with `smem` bytes of dynamic
// shared memory on `stream`: every CTA is resident at once, or the launch
// fails (cudaErrorCooperativeLaunchTooLarge) without running.
cudaLaunchConfig_t coop_config(int ctas, const Launch& l, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3((unsigned)l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16. (nv, wpr): one of row_config's pairs,
// with cols <= 32 * wpr * nv. stages (2..4), ctas (all resident at once)
// and rows_per_cta: bwd_layout's; staged: 1 where cols * itemsize is a
// multiple of 16 and x, dy and dx are 16-byte aligned. part: ctas * 2 *
// cols floats of workspace; bar: 2 unsigned ints, zero before the first
// call (each call leaves the first zero). Returns the CUDA error of the
// launch (0 on success), or cudaErrorInvalidValue for a bad argument.
extern "C" int dl4j_layer_norm_act_bwd(
    const void* x, const float* gamma, const float* beta, const float* mu,
    const float* rstd, const void* dy, void* dx, float* dgamma, float* dbeta,
    float* part, unsigned int* bar, long long rows, int cols, int act,
    int dtype, int nv, int wpr, int stages, int ctas, long long rows_per_cta,
    int staged, void* stream) {
  Launch l;
  if (!plan(rows, cols, act, dtype, nv, wpr, stages, ctas, rows_per_cta,
            staged, &l))
    return (int)cudaErrorInvalidValue;
  int e;
  if ((e = allow_smem(l.fn, l.smem)) != 0) return e;
  const Args a{x, gamma, beta, mu, rstd, dy, dx, dgamma, dbeta, part,
               bar, rows, rows_per_cta, cols, stages, act};
  void* args[] = {(void*)&a};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      coop_config(ctas, l, static_cast<cudaStream_t>(stream), attr);
  if ((e = (int)cudaLaunchKernelExC(&cfg, l.fn, args)) != 0) {
    cudaGetLastError();  // a refused launch leaves no error for the next
    return e;
  }
  return (int)cudaGetLastError();
}

// The kernel's resources at this layout into out[5]: registers a thread,
// threads a CTA, shared-memory bytes a CTA (static and dynamic), local
// (spill) bytes a thread and CTAs resident on one SM (CUDA's occupancy
// calculator).
extern "C" int dl4j_layer_norm_act_bwd_occupancy(
    long long rows, int cols, int act, int dtype, int nv, int wpr,
    int stages, int ctas, long long rows_per_cta, int staged, int* out) {
  Launch l;
  if (!plan(rows, cols, act, dtype, nv, wpr, stages, ctas, rows_per_cta,
            staged, &l))
    return (int)cudaErrorInvalidValue;
  int e;
  return occupancy_of(l.fn, l.threads, l.smem, out);
}

// An empty kernel with K7's grid, block, cooperative launch and shared
// memory at this layout, on `stream`: what a launch costs before any work.
// Returns the CUDA error of the launch.
extern "C" int dl4j_layer_norm_act_bwd_floor(
    long long rows, int cols, int act, int dtype, int nv, int wpr,
    int stages, int ctas, long long rows_per_cta, int staged, void* stream) {
  Launch l;
  if (!plan(rows, cols, act, dtype, nv, wpr, stages, ctas, rows_per_cta,
            staged, &l))
    return (int)cudaErrorInvalidValue;
  int e;
  if ((e = allow_smem((const void*)layer_norm_act_bwd_floor_kernel,
                      l.smem)) != 0)
    return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      coop_config(ctas, l, static_cast<cudaStream_t>(stream), attr);
  if ((e = (int)cudaLaunchKernelEx(&cfg, layer_norm_act_bwd_floor_kernel)) !=
      0) {
    cudaGetLastError();
    return e;
  }
  return (int)cudaGetLastError();
}
