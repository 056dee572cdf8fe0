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
// step moves about 1.5-2.3 MB (the weights dominate) and does 2B(F+U)4U
// flops, so bytes and operations take about the same least time, both
// under a microsecond. A step is too small to fill the card for long, so
// what it costs is latency: the launch, and each round trip to device
// memory. The TPU kernel held all operands in VMEM in one block; here blocks
// run in parallel on 132 SMs and nothing carries over between them.
//
// Design: one round of copies, one round of products, one exchange.
// - A thread-block cluster of CS CTAs (1, 2, 4 or 8: the fewest that cut
//   the reduction axis [x | h] of length K = F + U into slices of at most
//   128, each slice a multiple of 16) owns UT = 8 units and RT batch rows
//   (8 when B <= 8, else 32; more rows take row tiles in the grid). Rank r
//   of the cluster reduces over slice r. At U = 256 and B <= 32 the grid
//   is 32 unit tiles x 4 ranks = 128 CTAs, one per SM, and each weight is
//   read once a step.
// - Each CTA stages its whole operand slice in shared memory in one round
//   of cp.async copies before it waits once: the RT rows of [x | h] over
//   its slice, and the slice's rows of the 4 * UT weight columns {j, U + j,
//   2U + j, 3U + j}. The copies are 16 bytes each when every row starts on
//   a 16-byte boundary (x, h and their row strides, F, and U for the
//   weights; the wrapper decides, as `vec`), else 4 bytes each (a 16-bit
//   element path loads a batch, then stores it). Everything past B, U and
//   K is zero. The c and bias of the pair a thread finishes are read
//   before the copies, so their latency hides behind them.
// - 256 threads = 4 sub-slices of the CTA's slice x 64 (row group, column
//   group) tiles; a thread sums rows rg + 8 i x 4 gate columns over its
//   sub-slice in order, reading x and the weights 4 at a time, each x
//   value reused for 4 columns and each weight for RT / 8 rows. The 4
//   sub-slices' sums are then added in order.
// - Distributed shared memory: each rank stores the partial z of every
//   (row, unit) pair in the shared memory of the rank that finishes the
//   pair (1/CS of them each), one slot per source rank; after one cluster
//   barrier the finishing rank adds its slots in rank order. Every output
//   element is written once by one thread, with no atomics, so reruns are
//   bitwise equal.
// - The gate chain runs on the summed z as before: the bias added after the
//   products, c' = f*c + i*g and h' = o*tanh(c') as rounded products and
//   sums (no fused multiply-add), as in the plain version; expf and tanhf
//   may differ from PyTorch's by an ulp.
// - x, h and c are read through a row stride (x_t = x[:, t, :] of a
//   [B, T, F] sequence is read in place); W, RW, bias and the outputs are
//   contiguous.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "cp_async.cuh"
#include "epilogue_act.cuh"
#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dl4j;

constexpr int kThreads = 256;
constexpr int kUnits = 8;          // UT: units per cluster
constexpr int kPairs = 64;  // (row group, column group) tiles a sub-slice
constexpr int kSub = kThreads / kPairs;  // sub-slices of a CTA's slice
constexpr int kRowGroups = kPairs / kUnits;
constexpr int kSliceTarget = 128;  // reduction elements a CTA aims at
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kSmemLimit = 232448; // dynamic shared memory a CTA may use

struct Args {
  const void* x;
  long long sx;
  const void* h;
  long long sh;
  const void* c;
  long long sc;
  const void* w;
  const void* rw;
  const void* bias;
  void* h_out;
  void* c_out;
  int B, F, U;
  float forget_bias;
  int ks;      // reduction elements per cluster rank, a multiple of 16
  int vec_xh;  // [x | h] rows by 16-byte copies
  int vec_w;   // weight rows by 16-byte copies
};

// The launch's geometry, the same on the host and in the kernel.
struct Geometry {
  int cluster, slice, row_tile, grid_x, grid_y;
  size_t smem;
};

// Shared memory of a CTA: the [x | h] rows (RT x (slice + 16 bytes)), the
// weight rows (slice x 4 UT), the sub-slices' partial z (kSub x RT x 4 UT
// f32) and the rank's z (RT x UT x 4 gates f32).
size_t smem_bytes(int row_tile, int slice, int itemsize) {
  const int pad = 16 / itemsize;
  return (size_t)row_tile * (slice + pad) * itemsize
         + (size_t)slice * 4 * kUnits * itemsize
         + (size_t)(kSub + 1) * row_tile * kUnits * 16;
}

Geometry geometry(int B, int F, int U, int itemsize) {
  const int K = F + U;
  int cs = 1;
  while (cs < kMaxCluster && (K + cs - 1) / cs > kSliceTarget) cs *= 2;
  const int slice = ((K + cs - 1) / cs + 15) / 16 * 16;
  const int rt = B <= 8 ? 8 : 32;
  return Geometry{cs, slice, rt, cs * ((U + kUnits - 1) / kUnits),
                  (B + rt - 1) / rt, smem_bytes(rt, slice, itemsize)};
}

// Four consecutive elements of shared memory as f32 (16 bytes in f32, 8 in
// 16 bits; 16- or 8-byte aligned).
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
    return make_float4(to_f32<T>(e[0]), to_f32<T>(e[1]), to_f32<T>(e[2]),
                       to_f32<T>(e[3]));
  }
}

// n elements into shared memory by the block's threads, element by element:
// at(i, d) gives the i-th element's source (null: zero) and sets its offset
// d in dst; `any` is a valid global address for the copies of zeros. 4-byte
// cp.async in f32; 16-bit loads in batches of 8 a thread, all of a batch in
// flight before its stores.
template <typename T, typename At>
__device__ __forceinline__ void copy_elements(T* __restrict__ dst, int n,
                                              const T* any, At at) {
  if constexpr (sizeof(T) == 4) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      int d;
      const T* p = at(i, d);
      cp_async4(dst + d, p != nullptr ? p : any, p != nullptr ? 4 : 0);
    }
  } else {
    for (int i0 = threadIdx.x; i0 < n; i0 += 8 * kThreads) {
      T v[8];
      int d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = i0 + e * kThreads;
        const T* p = i < n ? at(i, d[e]) : nullptr;
        v[e] = p != nullptr ? *p : from_f32<T>(0.0f);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (i0 + e * kThreads < n) dst[d[e]] = v[e];
    }
  }
}

template <typename T, int RT>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const Args a) {
  constexpr int E = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int TR = RT / kRowGroups;     // rows per thread
  constexpr int WR = 4 * kUnits;          // elements of a weight row
  const int ks = a.ks;
  const int xs_stride = ks + E;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                     // [RT][ks + E]
  T* ws = xs + RT * xs_stride;                             // [ks][4][UT]
  float* red = reinterpret_cast<float*>(ws + ks * WR);     // [kSub][RT][4 UT]
  // [cs][RT UT / cs]: the partial z of this rank's pairs, by source rank
  float4* zin = reinterpret_cast<float4*>(red + kSub * RT * WR);

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();  // waited on before the first remote store
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int unit0 = (blockIdx.x / cs) * kUnits;
  const int row0 = blockIdx.y * RT;
  const int k0 = rank * ks;
  const int K = a.F + a.U;
  const long long ld = 4LL * a.U;  // row length of W and RW
  const int tid = threadIdx.x;
  const T* x = static_cast<const T*>(a.x);
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const T* rw = static_cast<const T*>(a.rw);

  // The (row, unit) pair this thread finishes, if any: its c and bias are
  // read now, so that their latency hides behind the rest.
  const int mine = RT * kUnits / cs;
  const int pr = (rank * mine + tid) / kUnits;
  const int pu = (rank * mine + tid) % kUnits;
  const bool finish = tid < mine && row0 + pr < a.B && unit0 + pu < a.U;
  float c_prev = 0.0f, bias[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (finish) {
    const T* bp = static_cast<const T*>(a.bias) + unit0 + pu;
    c_prev = to_f32<T>(static_cast<const T*>(a.c)[(row0 + pr) * a.sc +
                                                  unit0 + pu]);
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = to_f32<T>(bp[g * a.U]);
  }

  // ---- one round of copies: the slice of [x | h] and of the weights ----
  auto xh_src = [&](int r, int kk) -> const T* {  // null: zero
    const int k = k0 + kk, row = row0 + r;
    if (row >= a.B || k >= K) return nullptr;
    return k < a.F ? x + row * a.sx + k : h + row * a.sh + (k - a.F);
  };
  auto w_src = [&](int kk, int g, int u) -> const T* {
    const int k = k0 + kk, unit = unit0 + u;
    if (k >= K || unit >= a.U) return nullptr;
    return (k < a.F ? w + k * ld : rw + (k - a.F) * ld) + g * a.U + unit;
  };
  if (a.vec_xh) {
    const int chunks = ks / E;
    for (int i = tid; i < RT * chunks; i += kThreads) {
      const int r = i / chunks;
      const int kk = (i - r * chunks) * E;
      const T* src = xh_src(r, kk);
      cp_async16(xs + r * xs_stride + kk, src != nullptr ? src : x,
                 src != nullptr ? min(E, K - k0 - kk) * (int)sizeof(T) : 0);
    }
  } else {
    copy_elements<T>(xs, RT * ks, x, [&](int i, int& d) {
      const int r = i / ks, kk = i - (i / ks) * ks;
      d = r * xs_stride + kk;
      return xh_src(r, kk);
    });
  }
  if (a.vec_w) {
    constexpr int C = kUnits / E;  // copies per gate row (2 in f32, 1 else)
    for (int i = tid; i < ks * 4 * C; i += kThreads) {
      const int kk = i / (4 * C);
      const int gc = i - kk * 4 * C;
      const int g = gc / C;
      const int u = (gc - g * C) * E;
      const T* src = w_src(kk, g, u);
      cp_async16(ws + kk * WR + g * kUnits + u, src != nullptr ? src : w,
                 src != nullptr
                     ? min(E, a.U - unit0 - u) * (int)sizeof(T) : 0);
    }
  } else {
    copy_elements<T>(ws, ks * WR, w, [&](int i, int& d) {
      const int kk = i / WR, gu = i - (i / WR) * WR;
      d = i;
      return w_src(kk, gu / kUnits, gu % kUnits);
    });
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // ---- partial z: rows rg + 8 i x columns 4 cg .. 4 cg + 3 of the 4 UT
  // gate columns, over a quarter of the slice in order ----
  const int sub = tid / kPairs;
  const int t = tid - sub * kPairs;
  const int rg = t / kUnits;
  const int cg = t - rg * kUnits;
  const int per = ks / kSub;  // a multiple of 4
  float acc[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }
  const T* xr = xs + rg * xs_stride;
  const T* wc = ws + 4 * cg;
  for (int kk = sub * per; kk < (sub + 1) * per; kk += 4) {
    float4 wv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) wv[e] = load4<T>(wc + (kk + e) * WR);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float4 xv = load4<T>(xr + i * kRowGroups * xs_stride + kk);
      const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][0] = fmaf(xe[e], wv[e].x, acc[i][0]);
        acc[i][1] = fmaf(xe[e], wv[e].y, acc[i][1]);
        acc[i][2] = fmaf(xe[e], wv[e].z, acc[i][2]);
        acc[i][3] = fmaf(xe[e], wv[e].w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TR; ++i)
    *reinterpret_cast<float4*>(red + (sub * RT + rg + kRowGroups * i) * WR +
                               4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();

  // ---- this rank's z: the sub-slices added in order, each pair's 4 gates
  // sent to the rank that finishes the pair (slot [this rank][pair]) ----
  cluster_wait();  // every CTA of the cluster has started
  if (tid < RT * kUnits) {
    const int r = tid / kUnits, c4 = tid % kUnits;
    float4 z = *reinterpret_cast<const float4*>(red + r * WR + 4 * c4);
#pragma unroll
    for (int s = 1; s < kSub; ++s) {
      const float4 v =
          *reinterpret_cast<const float4*>(red + (s * RT + r) * WR + 4 * c4);
      z.x += v.x;
      z.y += v.y;
      z.z += v.z;
      z.w += v.w;
    }
    const int g = c4 >> 1;              // columns g UT + u .. + 3
    const int p = r * kUnits + (c4 & 1) * 4;  // the pair of unit u
    const float zs[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int owner = (p + e) / mine;
      float* dst = reinterpret_cast<float*>(cluster.map_shared_rank(
          zin + rank * mine + (p + e - owner * mine), owner));
      dst[g] = zs[e];
    }
  }
  cluster.sync();  // every rank's z has arrived

  // ---- this rank's pairs: z summed in rank order, then the gate chain ----
  if (finish) {
    float4 z = zin[tid];
    for (int q = 1; q < cs; ++q) {
      const float4 v = zin[q * mine + tid];
      z.x += v.x;
      z.y += v.y;
      z.z += v.z;
      z.w += v.w;
    }
    const float ig = act_fn<SIGMOID>(z.x + bias[0]);
    const float fg = act_fn<SIGMOID>((z.y + bias[1]) + a.forget_bias);
    const float og = act_fn<SIGMOID>(z.z + bias[2]);
    const float gg = act_fn<TANH>(z.w + bias[3]);
    const float cn = __fadd_rn(__fmul_rn(fg, c_prev), __fmul_rn(ig, gg));
    const float hn = __fmul_rn(og, act_fn<TANH>(cn));
    const long long o = (long long)(row0 + pr) * a.U + unit0 + pu;
    static_cast<T*>(a.h_out)[o] = from_f32<T>(hn);
    static_cast<T*>(a.c_out)[o] = from_f32<T>(cn);
  }
}

// An empty kernel launched as K8 is: the fixed cost of a launch.
__global__ void __launch_bounds__(kThreads) lstm_cell_floor_kernel() {}

// K8's launch configuration at geometry g: grid, 256 threads, the dynamic
// shared memory and the cluster dimension (one attribute, in attr).
cudaLaunchConfig_t config(const Geometry& g, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g.grid_x, (unsigned)g.grid_y, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int RT>
int launch_rt(const Args& a, const Geometry& g, cudaStream_t stream) {
  auto kernel = lstm_cell_kernel<T, RT>;
  int e;
  if ((e = allow_smem(kernel, g.smem)) != 0) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(g, stream, attr);
  if ((e = (int)cudaLaunchKernelEx(&cfg, kernel, a)) != 0) return e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, const Geometry& g, cudaStream_t stream) {
  if (g.row_tile == 8) return launch_rt<T, 8>(a, g, stream);
  return launch_rt<T, 32>(a, g, stream);
}

bool valid(int B, int F, int U, int dtype, Geometry* g) {
  if (B <= 0 || F < 0 || U <= 0 || dtype < 0 || dtype > 2) return false;
  *g = geometry(B, F, U, dtype == 0 ? 4 : 2);
  return g->grid_y <= 65535 && g->smem <= (size_t)kSmemLimit;
}

}  // namespace

// The launch's geometry into out[6]: cluster size, reduction elements per
// rank, rows per CTA, grid x (cluster x unit tiles), grid y (row tiles),
// dynamic shared-memory bytes a CTA. Returns cudaErrorInvalidValue for a
// shape or dtype the kernel does not take (the slice must fit in shared
// memory), else 0.
extern "C" int dl4j_lstm_cell_geometry(int B, int F, int U, int dtype,
                                       int* out) {
  Geometry g{};
  const bool ok = valid(B, F, U, dtype, &g);
  out[0] = g.cluster;
  out[1] = g.slice;
  out[2] = g.row_tile;
  out[3] = g.grid_x;
  out[4] = g.grid_y;
  out[5] = (int)g.smem;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// The kernel's resources at this shape into out[6]: registers a thread,
// threads a CTA, shared-memory bytes a CTA, local bytes a thread, CTAs
// resident on one SM, and clusters resident on the card at once.
extern "C" int dl4j_lstm_cell_occupancy(int B, int F, int U, int dtype,
                                        int* out) {
  Geometry g{};
  if (!valid(B, F, U, dtype, &g)) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  switch (dtype * 2 + (g.row_tile == 8 ? 0 : 1)) {
    case 0: fn = (const void*)lstm_cell_kernel<float, 8>; break;
    case 1: fn = (const void*)lstm_cell_kernel<float, 32>; break;
    case 2: fn = (const void*)lstm_cell_kernel<__nv_bfloat16, 8>; break;
    case 3: fn = (const void*)lstm_cell_kernel<__nv_bfloat16, 32>; break;
    case 4: fn = (const void*)lstm_cell_kernel<__half, 8>; break;
    default: fn = (const void*)lstm_cell_kernel<__half, 32>; break;
  }
  int e;
  if ((e = occupancy_of(fn, kThreads, g.smem, out)) != 0) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(g, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(&out[5], fn, &cfg);
}

// An empty kernel with K8's grid, block, cluster and shared memory at this
// shape, on `stream`: what a launch costs before any work. Returns the CUDA
// error of the launch.
extern "C" int dl4j_lstm_cell_floor(int B, int F, int U, int dtype,
                                    void* stream) {
  Geometry g{};
  if (!valid(B, F, U, dtype, &g)) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)lstm_cell_floor_kernel;
  int e;
  if ((e = allow_smem(fn, g.smem)) != 0) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(g, static_cast<cudaStream_t>(stream), attr);
  if ((e = (int)cudaLaunchKernelEx(&cfg, lstm_cell_floor_kernel)) != 0)
    return e;
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16, 2 = f16 (every operand of that type). sx, sh,
// sc: row strides of x, h and c in elements (their last dimension is
// contiguous). vec bit 0: x and h start on 16 bytes, their row strides and
// F are multiples of 16 bytes ([x | h] by 16-byte copies); bit 1: W and RW
// start on 16 bytes and U is a multiple of 16 bytes (the weights by 16-byte
// copies). Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for an unknown dtype, or a shape the grid or shared
// memory cannot hold (dl4j_lstm_cell_geometry).
extern "C" int dl4j_lstm_cell(const void* x, long long sx, const void* h,
                              long long sh, const void* c, long long sc,
                              const void* w, const void* rw, const void* bias,
                              void* h_out, void* c_out, int B, int F, int U,
                              float forget_bias, int dtype, int vec,
                              void* stream) {
  Geometry g{};
  if (!valid(B, F, U, dtype, &g)) return (int)cudaErrorInvalidValue;
  const Args a{x, sx, h, sh, c, sc, w, rw, bias, h_out, c_out, B, F, U,
               forget_bias, g.slice, vec & 1, (vec >> 1) & 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, g, st);
    case 1: return launch<__nv_bfloat16>(a, g, st);
    default: return launch<__half>(a, g, st);
  }
}
