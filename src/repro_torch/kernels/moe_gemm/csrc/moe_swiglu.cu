// Fused expert SwiGLU for Hopper (sm_90a): per expert e,
//     y[e] = (silu(x[e] · Wg[e]) ⊙ (x[e] · Wu[e])) · Wd[e]
// on the capacity-dispatched buffer x (E, C, d), with wg/wu (E, d, ff)
// and wd (E, ff, d), all float32 or all bfloat16; the math is float32
// inside and y (E, C, d) is written in x's type.
//
// Replaces the JAX package's TPU kernel moe_swiglu_tpu / _moe_kernel
// (src/repro/kernels/moe_gemm/kernel.py).  The TPU kernel streams ff in
// blocks along a sequential grid axis and accumulates the (C block, d)
// output in VMEM scratch, so the activation h = silu(g) ⊙ u never reaches
// HBM.  Blocks of a CUDA grid run in no order and a block's registers
// cannot hold a wide output tile, so the decode body keeps h on chip
// with small tiles, and the prefill body writes h once to device memory
// between two large-tile kernels (below).
//
// Bound: at prefill (granite-moe: E 32, C 1280, d 1024, ff 512) the
// 6·E·C·d·ff products over the bf16 tensor-core rate bind, above the
// bytes; at decode (C = 2..16) the expert weights' bytes bind.
//
// Three bodies; the wrapper (kernel.py::body_for) names one per call and
// the launch refuses any other pairing:
//
// * wgmma (bfloat16, C above 16: prefill), two kernels, namespace
//   hopper_tc.  A block that owns all of d for 128 capacity rows would
//   need a 128 x d float32 accumulator (512 KB at d 1024), too large for
//   registers, and 32-row tiles (the mma.sync body) re-read every
//   expert's weights C/32 times (40 at granite's prefill, 4.0 GB a
//   launch).  So h goes through device memory once:
//     1. gate_up: tiles of (expert, 128 capacity rows, 128 ff columns);
//        g = x·Wg and u = x·Wu as one m64n256k16 wgmma a warpgroup (64
//        rows each), Wg's and Wu's column blocks adjacent in shared
//        memory so they read as one 256-column B; the epilogue forms
//        silu(g)·u in float32 and writes h as bf16 hi and
//        lo = bf16(h - hi) to two (E, C, ff) workspaces.
//     2. down: tiles of (expert, 128 rows, 256 d columns);
//        y = h_hi·Wd + h_lo·Wd as two m64n256k16 wgmmas into one float32
//        accumulator over ff, cast to bf16 once.
//   Weights are re-read C/128 times (10 at prefill), the h round trip
//   costs 4·E·C·ff bytes (168 MB at prefill), and hi + lo makes the
//   tensor-core work 8/6 of the bound's.  Both kernels stream their
//   operands by TMA into a ring of 128-byte-swizzled stages (4 of 48 KB,
//   3 of 64 KB) with an mbarrier each; the weights are read MN-major
//   (wgmma's transposed B).  There is no producer warp: the last
//   warpgroup done with a stage issues the copy of the step STAGES
//   ahead into it, as in flash_attention.cu, and a step's products stay
//   in flight while the next step's are issued.  Blocks are persistent
//   (one an SM) and their ring runs on across tiles, so a tile's first
//   copies overlap the previous tile's last products and epilogue.
//   Tiles are numbered row tile first, so the blocks in flight share an
//   expert's weight tiles in L2.  TMA reads zeros past C, d and ff, and
//   the epilogues mask their stores, so ragged C (engine prefills give
//   40-320) and ff (1000, 1408) need no padding.
// * mma.sync (bfloat16, C up to 16: decode; and other bf16 shapes it
//   takes): mma.sync m16n8k16 bf16 -> f32.  BM = 16 rows a block (one
//   m16 tile: decode's capacities are at most 16 rows), 8 warps; the x
//   tile sits in shared memory as bf16.  Each ff step of BF = 64:
//     1. g and u (16 x 64) accumulate over d in chunks of KC = 128
//        d-rows of Wg and Wu staged in shared memory (ldmatrix, .trans
//        for the weights); each warp owns one 8-column n-tile of both,
//        so silu(g)·u is formed in its registers;
//     2. h is split into bf16 hi + lo (h - hi) in shared memory, so the
//        second product keeps h to ~16 bits of mantissa (the contract is
//        float32 h: one bf16 rounding of h alone would move y by ~1e-3
//        of its RMS);
//     3. y (16 x d, float32) += h_hi·Wd + h_lo·Wd, Wd staged 16 ff-rows
//        at a time, each warp owning d/8 columns: d/16 accumulators a
//        thread, 128 at d 2048.  Shared memory at d 2048 is 136 KB (x
//        16 x 2056 bf16, Wd's 16 rows as wide, h hi + lo), one block an
//        SM.
//   At decode the capacity tile is mostly empty rows and only E blocks
//   would run, so the plan splits ff into FS slices (grid z) until about
//   two blocks per SM are in flight; each slice writes float32 partial
//   outputs to a workspace and a second kernel sums the slices in a fixed
//   order and casts (no atomics, the same bits every run).  h never
//   leaves the block.  Loads and math alternate behind barriers: at
//   decode the weights' bytes bind, not the pipeline.
// * CUDA cores (float32, and any shape neither tensor-core body takes):
//   BC = 16 rows a block, fp32 FMAs, the x tile in shared memory as
//   float32; lane l owns ff column f0 + l of g and u, warp w every eighth
//   group of 4 d-rows; the 8 warps' partial sums meet in shared memory,
//   where h = silu(g)·u is formed; every thread then adds h·Wd for its
//   ceil(d/256) output columns.  d up to 2048.
//
// Ragged edges on the last two: ff columns past ff read as zero weights
// (so h = silu(0)·0 = 0), capacity rows past C load as zero and are not
// written, d columns past d are neither read nor written.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moe_tc.cuh"          // wgmma products, the ring, tensor maps

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// ===========================================================================
// Tensor-core path (bfloat16)
// ===========================================================================
namespace tc {

constexpr int BM = 16;         // capacity rows a block (one m16 tile)
constexpr int BF = 64;         // ff columns a step
constexpr int KC = 128;        // d-rows of Wg/Wu staged per chunk
constexpr int WK = 16;         // ff-rows of Wd staged per sub-step
constexpr int THREADS = 256;   // 8 warps
constexpr int PAD = 8;         // bf16 a shared row is padded by (16 bytes)
constexpr int MAX_D = 2048;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma(float* c, const unsigned* a, unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int buf_elems(int d) {
  return 2 * KC * (BF + PAD) > WK * (d + PAD) ? 2 * KC * (BF + PAD)
                                              : WK * (d + PAD);
}

size_t smem_bytes(int d) {
  return sizeof(bf16) * ((size_t)BM * (d + PAD) + buf_elems(d) +
                         2 * (size_t)BM * (BF + PAD));
}

// NTW: 8-column n-tiles of y a warp owns (d = 64·NTW, NTW even).
// ws == nullptr: write y; else write float32 partials of slice
// blockIdx.z to ws (FS, E, C, d).
template <int NTW>
__global__ void __launch_bounds__(THREADS)
moe_swiglu_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                      const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                      bf16* __restrict__ y, float* __restrict__ ws, int C,
                      int ff, int ffs) {
  constexpr int D = 64 * NTW;
  constexpr int XP = D + PAD, HP = BF + PAD;
  extern __shared__ uint4 smem4[];
  bf16* xs = reinterpret_cast<bf16*>(smem4);          // [BM][XP]
  bf16* buf = xs + BM * XP;          // Wg|Wu [2][KC][HP], or Wd [WK][XP]
  bf16* hhi = buf + buf_elems(D);                     // [BM][HP]
  bf16* hlo = hhi + BM * HP;                          // [BM][HP]

  const int E = gridDim.y, e = blockIdx.y;
  const int c0 = blockIdx.x * BM;
  const int rows = min(BM, C - c0);
  const int f_begin = blockIdx.z * ffs;
  const int f_end = min(ff, f_begin + ffs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < BM * (D / 8); i += THREADS) {
    const int r = i / (D / 8), cv = i % (D / 8);
    uint4 v = zero;
    if (r < rows)
      v = *reinterpret_cast<const uint4*>(x + ((size_t)e * C + c0 + r) * D +
                                          cv * 8);
    *reinterpret_cast<uint4*>(xs + r * XP + cv * 8) = v;
  }
  const bf16* wge = wg + (size_t)e * D * ff;
  const bf16* wue = wu + (size_t)e * D * ff;
  const bf16* wde = wd + (size_t)e * ff * D;

  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;

  for (int f0 = f_begin; f0 < f_end; f0 += BF) {
    // 1. g, u (BM x BF) over d
    float g[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < D; k0 += KC) {
      __syncthreads();                     // buf is free
      for (int i = tid; i < 2 * KC * (BF / 8); i += THREADS) {
        const int m = i / (KC * (BF / 8)), j = i % (KC * (BF / 8));
        const int kr = j / (BF / 8), cv = j % (BF / 8);
        const int f = f0 + cv * 8;         // ff % 8 == 0: whole or none
        uint4 v = zero;
        if (f < f_end)
          v = *reinterpret_cast<const uint4*>(
              (m ? wue : wge) + (size_t)(k0 + kr) * ff + f);
        *reinterpret_cast<uint4*>(buf + (m * KC + kr) * HP + cv * 8) = v;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        unsigned a[4], b[4];               // b[0..1] Wg, b[2..3] Wu
        ldsm_x4(a, xs + (lane & 15) * XP + k0 + ks + (lane >> 4) * 8);
        ldsm_x4_t(b, buf + ((lane >> 4) * KC + ks + (lane & 15)) * HP +
                         warp * 8);
        mma(g, a, b[0], b[1]);
        mma(u, a, b[2], b[3]);
      }
    }
    // 2. h = silu(g)·u as bf16 hi + lo, into shared memory
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = gid + 8 * half, c = warp * 8 + 2 * tq;
      const float h0 = silu(g[2 * half]) * u[2 * half];
      const float h1 = silu(g[2 * half + 1]) * u[2 * half + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(h0, h1);
      const float2 hif = __bfloat1622float2(hi);
      *reinterpret_cast<__nv_bfloat162*>(hhi + r * HP + c) = hi;
      *reinterpret_cast<__nv_bfloat162*>(hlo + r * HP + c) =
          __floats2bfloat162_rn(h0 - hif.x, h1 - hif.y);
    }
    // 3. acc += (h_hi + h_lo) · Wd[f0 : f0 + BF]
#pragma unroll 1
    for (int kk = 0; kk < BF; kk += WK) {
      __syncthreads();                     // h written, buf free
      for (int i = tid; i < WK * (D / 8); i += THREADS) {
        const int kr = i / (D / 8), cv = i % (D / 8);
        const int f = f0 + kk + kr;
        uint4 v = zero;
        if (f < f_end)
          v = *reinterpret_cast<const uint4*>(wde + (size_t)f * D + cv * 8);
        *reinterpret_cast<uint4*>(buf + kr * XP + cv * 8) = v;
      }
      __syncthreads();
      unsigned ahi[4], alo[4];
      const int off = (lane & 15) * HP + kk + (lane >> 4) * 8;
      ldsm_x4(ahi, hhi + off);
      ldsm_x4(alo, hlo + off);
#pragma unroll
      for (int p = 0; p < NTW; p += 2) {
        unsigned b[4];                     // n-tiles p and p + 1
        ldsm_x4_t(b, buf + (lane & 15) * XP + warp * (D / 8) + p * 8 +
                         (lane >> 4) * 8);
        mma(acc[p], ahi, b[0], b[1]);
        mma(acc[p], alo, b[0], b[1]);
        mma(acc[p + 1], ahi, b[2], b[3]);
        mma(acc[p + 1], alo, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = gid + 8 * half;
      if (r >= rows) continue;
      const int col = warp * (D / 8) + n * 8 + 2 * tq;
      const float v0 = acc[n][2 * half], v1 = acc[n][2 * half + 1];
      const size_t row = (size_t)e * C + c0 + r;
      if (ws)
        *reinterpret_cast<float2*>(
            ws + ((size_t)blockIdx.z * E * C + row) * D + col) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(y + row * D + col) =
            __floats2bfloat162_rn(v0, v1);
    }
}

// y[i] = sum over the FS slices of ws[s][i], in slice order, as bf16.
__global__ void sum_slices_kernel(const float* __restrict__ ws,
                                  bf16* __restrict__ y, size_t n, int fs) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < fs; ++z) s += ws[z * n + i];
    y[i] = __float2bfloat16_rn(s);
  }
}

bool takes(int d, int ff) {
  return d % 128 == 0 && d <= MAX_D && ff % 8 == 0;
}

// ff slices: enough blocks for about two a SM, each slice a whole number
// of BF steps.
int slices(int E, int C, int ff, int num_sms) {
  const int blocks = E * ((C + BM - 1) / BM);
  const int steps = (ff + BF - 1) / BF;
  int fs = (2 * num_sms + blocks - 1) / blocks;
  fs = fs < 1 ? 1 : (fs > steps ? steps : fs);
  const int per = (steps + fs - 1) / fs;
  return (steps + per - 1) / per;
}

template <int NTW>
int launch_ntw(const void* x, const void* wg, const void* wu, const void* wd,
               void* y, float* ws, int E, int C, int ff, int fs,
               cudaStream_t stream) {
  const int d = 64 * NTW;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      moe_swiglu_mma_kernel<NTW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int steps = (ff + BF - 1) / BF;
  const int ffs = ((steps + fs - 1) / fs) * BF;
  dim3 grid((C + BM - 1) / BM, E, fs);
  moe_swiglu_mma_kernel<NTW><<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)wg, (const bf16*)wu, (const bf16*)wd,
      (bf16*)y, fs > 1 ? ws : nullptr, C, ff, ffs);
  err = cudaGetLastError();
  if (err != cudaSuccess || fs == 1) return (int)err;
  const size_t n = (size_t)E * C * d;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_slices_kernel<<<blocks, 256, 0, stream>>>(ws, (bf16*)y, n, fs);
  return (int)cudaGetLastError();
}

int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* y, float* ws, int E, int C, int d, int ff, int fs,
           cudaStream_t stream) {
  if (fs > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  switch (d / 64) {
    case 2: return launch_ntw<2>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 4: return launch_ntw<4>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 6: return launch_ntw<6>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 8: return launch_ntw<8>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 10:
      return launch_ntw<10>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 12:
      return launch_ntw<12>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 14:
      return launch_ntw<14>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 16:
      return launch_ntw<16>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 18:
      return launch_ntw<18>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 20:
      return launch_ntw<20>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 22:
      return launch_ntw<22>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 24:
      return launch_ntw<24>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 26:
      return launch_ntw<26>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 28:
      return launch_ntw<28>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 30:
      return launch_ntw<30>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
    case 32:
      return launch_ntw<32>(x, wg, wu, wd, y, ws, E, C, ff, fs, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ===========================================================================
// CUDA-core path (float32, and bfloat16 shapes the tensor cores skip)
// ===========================================================================
namespace cc {

constexpr int BC = 16;                 // capacity rows a block
constexpr int BF = 32;                 // ff columns a step (one a lane)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DPT = 8;             // d <= THREADS * MAX_DPT = 2048

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)BC * d + (size_t)WARPS * 2 * BC * BF +
                          (size_t)BC * BF);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
moe_swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                  const T* __restrict__ wu, const T* __restrict__ wd,
                  T* __restrict__ y, int C, int d, int ff) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);      // [BC][d]
  float* part = xs + BC * d;                        // [WARPS][2][BC][BF]
  float* hs = part + WARPS * 2 * BC * BF;           // [BC][BF]

  const int e = blockIdx.y;
  const int c0 = blockIdx.x * BC;
  const int rows = min(BC, C - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* xe = x + ((size_t)e * C + c0) * d;
  for (int i = tid; i < BC * d; i += THREADS)
    xs[i] = (i / d) < rows ? to_f(xe[i]) : 0.f;
  const T* wge = wg + (size_t)e * d * ff;
  const T* wue = wu + (size_t)e * d * ff;
  const T* wde = wd + (size_t)e * ff * d;

  float acc[BC][DPT];
#pragma unroll
  for (int r = 0; r < BC; ++r)
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[r][i] = 0.f;
  __syncthreads();

  for (int f0 = 0; f0 < ff; f0 += BF) {
    // 1. partial g, u of the (BC, BF) tile over this warp's d-rows
    const int f = f0 + lane;
    const bool f_ok = f < ff;
    float ga[BC], ua[BC];
#pragma unroll
    for (int r = 0; r < BC; ++r) ga[r] = ua[r] = 0.f;
    for (int k = 4 * warp; k < d; k += 4 * WARPS) {
      float gw[4], uw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t o = (size_t)(k + q) * ff + f;
        gw[q] = f_ok ? to_f(wge[o]) : 0.f;
        uw[q] = f_ok ? to_f(wue[o]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BC; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * d + k);
        ga[r] += xv.x * gw[0] + xv.y * gw[1] + xv.z * gw[2] + xv.w * gw[3];
        ua[r] += xv.x * uw[0] + xv.y * uw[1] + xv.z * uw[2] + xv.w * uw[3];
      }
    }
    float* pg = part + (warp * 2) * BC * BF;
    float* pu = pg + BC * BF;
#pragma unroll
    for (int r = 0; r < BC; ++r) {
      pg[r * BF + lane] = ga[r];
      pu[r * BF + lane] = ua[r];
    }
    __syncthreads();

    // 2. h = silu(g) * u, in shared memory only
    for (int i = tid; i < BC * BF; i += THREADS) {
      float g = 0.f, u = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        g += part[(w * 2) * BC * BF + i];
        u += part[(w * 2 + 1) * BC * BF + i];
      }
      hs[i] = silu(g) * u;
    }
    __syncthreads();

    // 3. acc += h · Wd[f0 : f0 + BF] for this thread's columns.  The next
    // step writes `part` only after its phase 1 and `hs` only after the
    // barrier that follows, by which time every thread has left this loop.
    const int fn = min(BF, ff - f0);
    for (int fi = 0; fi < fn; ++fi) {
      const T* wrow = wde + (size_t)(f0 + fi) * d;
      float wv[DPT];
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int j = tid + i * THREADS;
        wv[i] = j < d ? to_f(wrow[j]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BC; ++r) {
        const float hv = hs[r * BF + fi];
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[r][i] += hv * wv[i];
      }
    }
  }

  T* ye = y + ((size_t)e * C + c0) * d;
#pragma unroll
  for (int r = 0; r < BC; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int j = tid + i * THREADS;
      if (j < d) ye[(size_t)r * d + j] = from_f<T>(acc[r][i]);
    }
  }
}

template <typename T, int DPT>
int launch_dpt(const void* x, const void* wg, const void* wu, const void* wd,
               void* y, int E, int C, int d, int ff, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      moe_swiglu_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + BC - 1) / BC, E);
  moe_swiglu_kernel<T, DPT><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)wg, (const T*)wu, (const T*)wd, (T*)y, C, d, ff);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* y, int E, int C, int d, int ff, cudaStream_t stream) {
  if (d % 4 || d > THREADS * MAX_DPT) return (int)cudaErrorInvalidValue;
  const int dpt = (d + THREADS - 1) / THREADS;
  if (dpt <= 1) return launch_dpt<T, 1>(x, wg, wu, wd, y, E, C, d, ff, stream);
  if (dpt <= 2) return launch_dpt<T, 2>(x, wg, wu, wd, y, E, C, d, ff, stream);
  if (dpt <= 4) return launch_dpt<T, 4>(x, wg, wu, wd, y, E, C, d, ff, stream);
  return launch_dpt<T, 8>(x, wg, wu, wd, y, E, C, d, ff, stream);
}

}  // namespace cc

// ===========================================================================
// Hopper tensor-core path (bfloat16, C above DECODE_C): wgmma + TMA
// ===========================================================================
namespace hopper_tc {

using namespace moe_tc;

// committed wgmma groups left in flight while the next step is issued
// (0, waiting for each step's products, was slower in a trial build)
constexpr int PIPE = 1;
// consumer warpgroups, 64 rows each (3, with 192-row tiles and two down
// stages, was slower in a trial build)
constexpr int NWG = 2;
constexpr int BM = 64 * NWG;     // capacity rows a tile
constexpr int BK = 64;           // reduction step: one 128-byte row of bf16
constexpr int THREADS = 128 * NWG;
constexpr int TILE_A = BM * BK * 2;          // a BM x 64 bf16 tile

// gate/up: 128 ff columns a tile; a stage holds X | Wg | Wu, and Wg's two
// 64-column blocks and Wu's are adjacent, so one n256 wgmma reads them as
// one B of 256 columns: g in accumulators 0..63, u in 64..127
constexpr int BN1 = 128, STAGES1 = 4;
constexpr int W1_BYTES = BK * BN1 * 2;       // 2 blocks of 64 columns
constexpr int STAGE1 = TILE_A + 2 * W1_BYTES;
// down: 256 d columns a tile, stages of H_hi | H_lo | Wd
constexpr int BN2 = 256, STAGES2 = 3;
constexpr int W2_BYTES = BK * BN2 * 2;       // 4 blocks of 64 columns
constexpr int STAGE2 = 2 * TILE_A + W2_BYTES;

constexpr int SMEM1 = ring_bytes(STAGE1, STAGES1);
constexpr int SMEM2 = ring_bytes(STAGE2, STAGES2);

// silu by the multi-function unit's exp2 and a fast division (a few ulp
// of float32, far inside the 16 bits that h keeps as bf16 hi + lo); the
// epilogue runs it on every element of a tile while the tensor cores
// wait
__device__ __forceinline__ float silu_fast(float g) {
  return __fdividef(g, 1.f + __expf(-g));
}

// h = silu(x·Wg) ⊙ (x·Wu) of each tile (128 capacity rows, 128 ff
// columns, one expert), written as bf16 hi and lo = bf16(h - hi) to hhi /
// hlo (E, C, ff).  tmX: x as (d, C, E); tmG, tmU: wg, wu as (ff, d, E).
__global__ void __launch_bounds__(THREADS, 1)
gate_up_kernel(const __grid_constant__ CUtensorMap tmX,
               const __grid_constant__ CUtensorMap tmG,
               const __grid_constant__ CUtensorMap tmU,
               bf16* __restrict__ hhi, bf16* __restrict__ hlo, int E, int C,
               int d, int ff) {
  extern __shared__ uint8_t smem_raw[];
  Ring<STAGES1, NWG> ring(smem_raw, STAGE1);
  const Tiles tiles((C + BM - 1) / BM, (ff + BN1 - 1) / BN1,
                    (d + BK - 1) / BK, E);
  const int KT = tiles.KT, G = tiles.steps();
  auto load = [&](int g) {
    int m, n, e;
    tiles.coords(g, m, n, e);
    const int k0 = (g % KT) * BK;
    const uint32_t sX = ring.base + (g % STAGES1) * STAGE1;
    const uint32_t sG = sX + TILE_A, sU = sG + W1_BYTES, bar = ring.full(g);
    mbar_expect(bar, STAGE1);
    tma_load_3d(sX, &tmX, bar, k0, m * BM, e);
#pragma unroll
    for (int cb = 0; cb < BN1 / 64; ++cb) {
      tma_load_3d(sG + cb * BK * 128, &tmG, bar, n * BN1 + 64 * cb, k0, e);
      tma_load_3d(sU + cb * BK * 128, &tmU, bar, n * BN1 + 64 * cb, k0, e);
    }
  };
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < G && g < STAGES1; ++g) load(g);

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  float gu[BN1];                       // g: 0 .. BN1/2, u: BN1/2 ..
#pragma unroll
  for (int i = 0; i < BN1; ++i) gu[i] = 0.f;
  for (int g0 = 0; g0 < G; g0 += KT) {  // one tile: steps g0 .. g0 + KT
    for (int g = g0; g < g0 + KT; ++g) {
      ring.wait(g);
      const uint32_t sX = ring.base + (g % STAGES1) * STAGE1;
      wgmma_fence();
      fence_regs(gu);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_ss_n256<0, 1>(
            gu, desc_sw128(sX + wg * 64 * 128 + ks * 32, 16, 1024),
            desc_sw128(sX + TILE_A + ks * 16 * 128, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait<PIPE>();              // step g - 1's products are done
      fence_regs(gu);
      if (g > g0 && ring.release(g - 1, wg, t) && g - 1 + STAGES1 < G)
        load(g - 1 + STAGES1);
    }
    wgmma_wait<0>();
    fence_regs(gu);
    const int gl = g0 + KT - 1;
    if (ring.release(gl, wg, t) && gl + STAGES1 < G) load(gl + STAGES1);

    int m, n, e;
    tiles.coords(g0, m, n, e);
    const int r0 = m * BM + 64 * wg + 16 * warp + (lane >> 2);
    const int c = n * BN1 + 2 * (lane & 3);
#pragma unroll
    for (int jj = 0; jj < BN1 / 8; ++jj) {
      const int col = c + 8 * jj;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        const int i0 = 4 * jj + 2 * half;
        // ff % 8 == 0, so col < ff means col + 1 < ff too
        float* u_ = gu + BN1 / 2;
        if (row < C && col < ff) {
          const float h0 = silu_fast(gu[i0]) * u_[i0];
          const float h1 = silu_fast(gu[i0 + 1]) * u_[i0 + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(h0, h1);
          const float2 hf = __bfloat1622float2(hi);
          const size_t off = ((size_t)e * C + row) * ff + col;
          *reinterpret_cast<__nv_bfloat162*>(hhi + off) = hi;
          *reinterpret_cast<uint32_t*>(hlo + off) =
              pack_bf16(h0 - hf.x, h1 - hf.y);
        }
        gu[i0] = gu[i0 + 1] = u_[i0] = u_[i0 + 1] = 0.f;
      }
    }
  }
}

// y = h_hi·Wd + h_lo·Wd of each tile (128 capacity rows, 256 d columns,
// one expert), one float32 accumulator, cast to bf16 once.  tmHh, tmHl:
// h as (ff, C, E); tmD: wd as (d, ff, E).
__global__ void __launch_bounds__(THREADS, 1)
down_kernel(const __grid_constant__ CUtensorMap tmHh,
            const __grid_constant__ CUtensorMap tmHl,
            const __grid_constant__ CUtensorMap tmD, bf16* __restrict__ y,
            int E, int C, int d, int ff) {
  extern __shared__ uint8_t smem_raw[];
  Ring<STAGES2, NWG> ring(smem_raw, STAGE2);
  const Tiles tiles((C + BM - 1) / BM, (d + BN2 - 1) / BN2,
                    (ff + BK - 1) / BK, E);
  const int KT = tiles.KT, G = tiles.steps();
  auto load = [&](int g) {
    int m, n, e;
    tiles.coords(g, m, n, e);
    const int k0 = (g % KT) * BK;
    const uint32_t sH = ring.base + (g % STAGES2) * STAGE2;
    const uint32_t sW = sH + 2 * TILE_A, bar = ring.full(g);
    mbar_expect(bar, STAGE2);
    tma_load_3d(sH, &tmHh, bar, k0, m * BM, e);
    tma_load_3d(sH + TILE_A, &tmHl, bar, k0, m * BM, e);
#pragma unroll
    for (int cb = 0; cb < BN2 / 64; ++cb)
      tma_load_3d(sW + cb * BK * 128, &tmD, bar, n * BN2 + 64 * cb, k0, e);
  };
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < G && g < STAGES2; ++g) load(g);

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  float acc[BN2 / 2];
#pragma unroll
  for (int i = 0; i < BN2 / 2; ++i) acc[i] = 0.f;
  for (int g0 = 0; g0 < G; g0 += KT) {  // one tile: steps g0 .. g0 + KT
    for (int g = g0; g < g0 + KT; ++g) {
      ring.wait(g);
      const uint32_t sH = ring.base + (g % STAGES2) * STAGE2;
      const uint32_t sW = sH + 2 * TILE_A;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const uint32_t a = sH + wg * 64 * 128 + ks * 32;
        const uint64_t db = desc_sw128(sW + ks * 16 * 128, BK * 128, 1024);
        wgmma_ss_n256<0, 1>(acc, desc_sw128(a, 16, 1024), db);
        wgmma_ss_n256<0, 1>(acc, desc_sw128(a + TILE_A, 16, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<PIPE>();              // step g - 1's products are done
      fence_regs(acc);
      if (g > g0 && ring.release(g - 1, wg, t) && g - 1 + STAGES2 < G)
        load(g - 1 + STAGES2);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    const int gl = g0 + KT - 1;
    if (ring.release(gl, wg, t) && gl + STAGES2 < G) load(gl + STAGES2);

    int m, n, e;
    tiles.coords(g0, m, n, e);
    const int r0 = m * BM + 64 * wg + 16 * warp + (lane >> 2);
    const int c = n * BN2 + 2 * (lane & 3);
#pragma unroll
    for (int jj = 0; jj < BN2 / 8; ++jj) {
      const int col = c + 8 * jj;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        const int i0 = 4 * jj + 2 * half;
        // d % 8 == 0, so col < d means col + 1 < d too
        if (row < C && col < d)
          *reinterpret_cast<uint32_t*>(y + ((size_t)e * C + row) * d + col) =
              pack_bf16(acc[i0], acc[i0 + 1]);
        acc[i0] = acc[i0 + 1] = 0.f;
      }
    }
  }
}

bool takes(int d, int ff) { return d % 8 == 0 && ff % 8 == 0; }

int launch(const void* x, const void* wg_, const void* wu, const void* wd,
           void* y, void* hhi, void* hlo, int E, int C, int d, int ff,
           int sms, cudaStream_t stream) {
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM1);
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM2);
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr2 != cudaSuccess) return (int)attr2;
  if (!takes(d, ff) || hhi == nullptr || hlo == nullptr || sms <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tg, tu, th, tl, td;
  int err = tensor_map(&tx, x, d, C, E, BM);
  if (!err) err = tensor_map(&tg, wg_, ff, d, E, BK);
  if (!err) err = tensor_map(&tu, wu, ff, d, E, BK);
  if (!err) err = tensor_map(&th, hhi, ff, C, E, BM);
  if (!err) err = tensor_map(&tl, hlo, ff, C, E, BM);
  if (!err) err = tensor_map(&td, wd, d, ff, E, BK);
  if (err) return err;
  const int mt = (C + BM - 1) / BM;
  const int n1 = mt * ((ff + BN1 - 1) / BN1) * E;
  const int n2 = mt * ((d + BN2 - 1) / BN2) * E;
  gate_up_kernel<<<n1 < sms ? n1 : sms, THREADS, SMEM1, stream>>>(
      tx, tg, tu, (bf16*)hhi, (bf16*)hlo, E, C, d, ff);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  down_kernel<<<n2 < sms ? n2 : sms, THREADS, SMEM2, stream>>>(
      th, tl, td, (bf16*)y, E, C, d, ff);
  return (int)cudaGetLastError();
}

}  // namespace hopper_tc

}  // namespace

extern "C" {

// How many ff slices the mma.sync path takes for this shape (>= 1), or 0
// when that path does not take it (dtype: 0 = float32, 1 = bfloat16).
// Slices above 1 need a float32 workspace of (slices, E, C, d).
int mcsa_moe_swiglu_plan(int E, int C, int d, int ff, int dtype,
                         int num_sms) {
  if (dtype != 1 || !tc::takes(d, ff) || E <= 0 || C <= 0) return 0;
  return tc::slices(E, C, ff, num_sms);
}

// x, y: (E, C, d); wg, wu: (E, d, ff); wd: (E, ff, d); all contiguous
// and 16-byte aligned.  body: 0 = CUDA cores (float32 or bfloat16, d a
// multiple of 4 up to 2048), 1 = mma.sync (bfloat16; fs what
// mcsa_moe_swiglu_plan returned, ws the workspace when fs > 1),
// 2 = wgmma + TMA (bfloat16, d and ff multiples of 8; ws and ws2 hold
// h_hi and h_lo, two bf16 (E, C, ff) tensors, 16-byte aligned; at most
// sms persistent blocks, one an SM).  Any other pairing returns
// cudaErrorInvalidValue.
int mcsa_moe_swiglu_launch(const void* x, const void* wg, const void* wu,
                           const void* wd, void* y, void* ws, void* ws2,
                           int E, int C, int d, int ff, int fs, int sms,
                           int dtype, int body, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E <= 0 || C <= 0 || d <= 0 || ff <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (body == 2) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return hopper_tc::launch(x, wg, wu, wd, y, ws, ws2, E, C, d, ff, sms,
                             s);
  }
  if (body == 1) {
    if (dtype != 1 || fs < 1 || !tc::takes(d, ff))
      return (int)cudaErrorInvalidValue;
    return tc::launch(x, wg, wu, wd, y, (float*)ws, E, C, d, ff, fs, s);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return cc::launch<float>(x, wg, wu, wd, y, E, C, d, ff, s);
  if (dtype == 1)
    return cc::launch<__nv_bfloat16>(x, wg, wu, wd, y, E, C, d, ff, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the wgmma body's two kernels (bytes).
int mcsa_moe_swiglu_wgmma_smem(int which) {
  return which == 0 ? hopper_tc::SMEM1 : hopper_tc::SMEM2;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
