// Fused expert SwiGLU backward for Hopper (sm_90a): the gradients of
//     y[e] = (silu(x[e] · Wg[e]) ⊙ (x[e] · Wu[e])) · Wd[e]
// (csrc/moe_swiglu.cu, float32 math inside) for an output gradient dy, on
// the capacity-dispatched buffer x (E, C, d), wg/wu (E, d, ff) and wd
// (E, ff, d), all float32 or all bfloat16.  With G = x·Wg, U = x·Wu,
// σ = sigmoid(G), H = silu(G) ⊙ U and dH = dy·Wdᵀ:
//     dWd = Hᵀ·dy,  dG = dH ⊙ U ⊙ σ(1 + G(1 − σ)),  dU = dH ⊙ silu(G),
//     dx = dG·Wgᵀ + dU·Wuᵀ,  dWg = xᵀ·dG,  dWu = xᵀ·dU.
//
// What it replaces: no Pallas kernel.  The JAX package's train step
// differentiates its jnp _moe_local (src/repro/models/moe.py:58) with
// XLA; its forward kernel is moe_swiglu_tpu
// (src/repro/kernels/moe_gemm/kernel.py:59).  The port's model reaches the
// forward through its CUDA kernel, so the backward of that call is this
// file.  The forward keeps H in float32 (its contract), so this is the
// gradient of that float32 H; the reference's bf16 model rounds silu(G)
// to bf16 before the product, which this does not copy.
//
// Bound: operations, 12·E·C·d·ff (dH, dWd, dx's two, dWg, dWu) on the
// bf16 tensor cores; this design adds G and U's recomputation (16 in
// all) so that the forward stays what serving launches.
//
// Design (the simple one that is right): three launches of one tiled
// product, 64 x 64 output tiles, 4 warps, k steps of 32 staged in shared
// memory with 16-byte loads, each operand kept in the layout it has in
// device memory (K- or M/N-contiguous) and read by ldmatrix, with .trans
// for the M/N-contiguous ones; mma.sync m16n8k16 bf16 -> f32 (each warp a
// 32 x 32 quarter of the tile).  float32 runs the same tiles on the CUDA
// cores (each thread 4 x 8 outputs), so its checks keep full float32
// products.
//   1. hidden: per (expert, 64 capacity rows, 64 ff columns), G, U and dH
//      over d into three float32 accumulators; the epilogue writes H, dG
//      and dU in x's type to three (E, C, ff) scratch tensors.
//   2. dx: per (expert, 64 rows, 64 d columns), dG·Wgᵀ then dU·Wuᵀ into
//      one accumulator over ff.
//   3. dw: per (expert, output tile) of dWg, dWu (d x ff) and dWd (ff x
//      d), grid z naming which, a sum over the C capacity rows.
// Every output tile is owned by one block, which sums its k steps in a
// fixed order: no atomics, the same bits on every run.  Rows past C and
// columns past d or ff load as zeros and are not stored; d and ff must be
// multiples of 8 (whole 16-byte loads).
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the
// launches go on the caller's stream and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TM = 64;         // output rows a tile
constexpr int TN = 64;         // output columns a tile
constexpr int BK = 32;         // k a stage
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// shared-memory padding a row (16 bytes), elements of a 16-byte load
template <typename T> struct Lay {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int V = 16 / sizeof(T);
  static constexpr int KP = BK + PAD;      // pitch of a K-contiguous tile
  static constexpr int MP = TM + PAD;      // pitch of an M/N-contiguous one
  static constexpr int ELEMS = TM * KP > BK * MP ? TM * KP : BK * MP;
};

// Stage k step [k0, k0 + BK) of a 64-wide slice [mn0, mn0 + 64) of an
// operand.  KC: element (mn, k) at src[mn * ld + k], kept as [64][KP];
// else at src[k * ld + mn], kept as [BK][MP].  Out-of-range 16-byte
// pieces are zeros.
template <typename T, bool KC>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int ld, int mn0, int k0, int MN,
                                      int K) {
  using L = Lay<T>;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  constexpr int ROWS = KC ? TM : BK, COLS = KC ? BK : TM;
  constexpr int P = KC ? L::KP : L::MP;
  for (int e = threadIdx.x; e < ROWS * (COLS / L::V); e += THREADS) {
    const int r = e / (COLS / L::V), c = (e % (COLS / L::V)) * L::V;
    const int gr = KC ? mn0 + r : k0 + r, gc = KC ? k0 + c : mn0 + c;
    const bool ok = KC ? (gr < MN && gc < K) : (gr < K && gc < MN);
    uint4 val = zero;
    if (ok) val = *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc);
    *reinterpret_cast<uint4*>(dst + r * P + c) = val;
  }
}

// ---------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16, warp w a 32 x 32 quarter (rows 32(w & 1),
// columns 32(w >> 1)); acc[(mt * 4 + nt) * 4 + q]
// ---------------------------------------------------------------------
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

template <bool AK, bool BKC>
__device__ __forceinline__ void tile_step(float (&acc)[32], const bf16* As,
                                          const bf16* Bs) {
  using L = Lay<bf16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 1), wn = 32 * (warp >> 1);
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m0 = wm + 16 * mt;
      if (AK)
        ldsm_x4(a[mt], As + (m0 + (lane & 15)) * L::KP + ks + (lane >> 4) * 8);
      else
        ldsm_x4_t(a[mt], As + (ks + (lane & 7) + ((lane >> 4) << 3)) * L::MP +
                             m0 + ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0 = wn + 16 * p;
      unsigned b[4];       // b[0..1] columns n0.., b[2..3] n0 + 8..
      if (BKC)
        ldsm_x4(b, Bs + (n0 + (lane & 7) + ((lane >> 4) << 3)) * L::KP + ks +
                       ((lane >> 3) & 1) * 8);
      else
        ldsm_x4_t(b, Bs + (ks + (lane & 15)) * L::MP + n0 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma(acc + (mt * 4 + 2 * p) * 4, a[mt], b[0], b[1]);
        mma(acc + (mt * 4 + 2 * p + 1) * 4, a[mt], b[2], b[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// float32: CUDA cores, thread (ty, tx) = (tid / 8, tid % 8) owns rows
// ty + 16a and columns tx + 8b; acc[a * 8 + b]
// ---------------------------------------------------------------------
template <bool AK, bool BKC>
__device__ __forceinline__ void tile_step(float (&acc)[32], const float* As,
                                          const float* Bs) {
  using L = Lay<float>;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float av[4], bv[8];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int m = ty + 16 * a;
      av[a] = AK ? As[m * L::KP + k] : As[k * L::MP + m];
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int n = tx + 8 * b;
      bv[b] = BKC ? Bs[n * L::KP + k] : Bs[k * L::MP + n];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b)
        acc[a * 8 + b] = fmaf(av[a], bv[b], acc[a * 8 + b]);
  }
}

// (row, column) in the tile of accumulator element idx
template <typename T>
__device__ __forceinline__ void coord(int idx, int& r, int& c) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int mt = idx >> 4, nt = (idx >> 2) & 3, q = idx & 3;
    r = 32 * (warp & 1) + 16 * mt + (lane >> 2) + 8 * (q >> 1);
    c = 32 * (warp >> 1) + 8 * nt + 2 * (lane & 3) + (q & 1);
  } else {
    r = (threadIdx.x >> 3) + 16 * (idx >> 3);
    c = (threadIdx.x & 7) + 8 * (idx & 7);
  }
}

// acc += op(A) · op(B) over k in [0, K) for the tile at (m0, n0): A (M x K)
// with element (m, k) at A[m * lda + k] (AK) or A[k * lda + m]; B (K x N)
// with element (k, n) at B[n * ldb + k] (BKC) or B[k * ldb + n]
template <typename T, bool AK, bool BKC>
__device__ __forceinline__ void gemm(float (&acc)[32], const T* __restrict__ A, int lda,
                     const T* __restrict__ B, int ldb, int m0, int n0, int M,
                     int N, int K, T* As, T* Bs) {
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();                     // the last stage is consumed
    stage<T, AK>(As, A, lda, m0, k0, M, K);
    stage<T, BKC>(Bs, B, ldb, n0, k0, N, K);
    __syncthreads();
    tile_step<AK, BKC>(acc, As, Bs);
  }
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
}

template <typename T>
__device__ __forceinline__ void store(const float (&acc)[32], T* out, int ld,
                                      int m0, int n0, int M, int N) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int r, c;
    coord<T>(i, r, c);
    if (m0 + r < M && n0 + c < N)
      out[(size_t)(m0 + r) * ld + n0 + c] = from_f<T>(acc[i]);
  }
}

// 1. H, dG, dU (E, C, ff)
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_hidden(const T* __restrict__ x, const T* __restrict__ wg,
           const T* __restrict__ wu, const T* __restrict__ wd,
           const T* __restrict__ dy, T* __restrict__ h, T* __restrict__ dg,
           T* __restrict__ du, int C, int d, int ff) {
  __shared__ uint4 sa[Lay<T>::ELEMS * sizeof(T) / 16];
  __shared__ uint4 sb[Lay<T>::ELEMS * sizeof(T) / 16];
  T* As = reinterpret_cast<T*>(sa);
  T* Bs = reinterpret_cast<T*>(sb);
  const int e = blockIdx.z, m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const T* xe = x + (size_t)e * C * d;
  const T* dye = dy + (size_t)e * C * d;
  float ag[32], au[32], adh[32];
  zero(ag);
  zero(au);
  zero(adh);
  gemm<T, true, false>(ag, xe, d, wg + (size_t)e * d * ff, ff, m0, n0, C, ff,
                       d, As, Bs);
  gemm<T, true, false>(au, xe, d, wu + (size_t)e * d * ff, ff, m0, n0, C, ff,
                       d, As, Bs);
  gemm<T, true, true>(adh, dye, d, wd + (size_t)e * ff * d, d, m0, n0, C, ff,
                      d, As, Bs);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int r, c;
    coord<T>(i, r, c);
    if (m0 + r >= C || n0 + c >= ff) continue;
    const float g = ag[i], u = au[i], dhv = adh[i];
    const float s = 1.f / (1.f + expf(-g));
    const float sl = g * s;
    const size_t o = ((size_t)e * C + m0 + r) * ff + n0 + c;
    h[o] = from_f<T>(sl * u);
    dg[o] = from_f<T>(dhv * u * (s * (1.f + g * (1.f - s))));
    du[o] = from_f<T>(dhv * sl);
  }
}

// 2. dx = dG·Wgᵀ + dU·Wuᵀ (E, C, d)
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dx(const T* __restrict__ dg, const T* __restrict__ du,
       const T* __restrict__ wg, const T* __restrict__ wu,
       T* __restrict__ dx, int C, int d, int ff) {
  __shared__ uint4 sa[Lay<T>::ELEMS * sizeof(T) / 16];
  __shared__ uint4 sb[Lay<T>::ELEMS * sizeof(T) / 16];
  T* As = reinterpret_cast<T*>(sa);
  T* Bs = reinterpret_cast<T*>(sb);
  const int e = blockIdx.z, m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[32];
  zero(acc);
  // one copy of the main loop for both products (two inlined copies
  // spilled in float32)
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass)
    gemm<T, true, true>(acc, (pass ? du : dg) + (size_t)e * C * ff, ff,
                        (pass ? wu : wg) + (size_t)e * d * ff, ff, m0, n0,
                        C, d, ff, As, Bs);
  store<T>(acc, dx + (size_t)e * C * d, d, m0, n0, C, d);
}

// 3. dWg = xᵀ·dG, dWu = xᵀ·dU (E, d, ff) and dWd = Hᵀ·dy (E, ff, d), z
// naming which
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dw(const T* __restrict__ x, const T* __restrict__ h,
       const T* __restrict__ dg, const T* __restrict__ du,
       const T* __restrict__ dy, T* __restrict__ dwg, T* __restrict__ dwu,
       T* __restrict__ dwd, int C, int d, int ff) {
  __shared__ uint4 sa[Lay<T>::ELEMS * sizeof(T) / 16];
  __shared__ uint4 sb[Lay<T>::ELEMS * sizeof(T) / 16];
  T* As = reinterpret_cast<T*>(sa);
  T* Bs = reinterpret_cast<T*>(sb);
  const int e = blockIdx.y, z = blockIdx.z;
  const int M = z == 2 ? ff : d, N = z == 2 ? d : ff;
  const int tn = (N + TN - 1) / TN;
  const int m0 = (blockIdx.x / tn) * TM, n0 = (blockIdx.x % tn) * TN;
  const size_t cd = (size_t)e * C * d, cf = (size_t)e * C * ff;
  const T* A = z == 2 ? h + cf : x + cd;
  const T* B = z == 0 ? dg + cf : z == 1 ? du + cf : dy + cd;
  T* out = (z == 0 ? dwg : z == 1 ? dwu : dwd) + (size_t)e * d * ff;
  float acc[32];
  zero(acc);
  gemm<T, false, false>(acc, A, M, B, N, m0, n0, M, N, C, As, Bs);
  store<T>(acc, out, N, m0, n0, M, N);
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           const void* dy, void* dx, void* dwg, void* dwu, void* dwd,
           void* h, void* dg, void* du, int E, int C, int d, int ff,
           cudaStream_t s) {
  const T *tx = (const T*)x, *tg = (const T*)wg, *tu = (const T*)wu;
  const dim3 g1((ff + TN - 1) / TN, (C + TM - 1) / TM, E);
  bwd_hidden<T><<<g1, THREADS, 0, s>>>(tx, tg, tu, (const T*)wd,
                                       (const T*)dy, (T*)h, (T*)dg, (T*)du,
                                       C, d, ff);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((d + TN - 1) / TN, (C + TM - 1) / TM, E);
  bwd_dx<T><<<g2, THREADS, 0, s>>>((const T*)dg, (const T*)du, tg, tu,
                                   (T*)dx, C, d, ff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g3(((d + TM - 1) / TM) * ((ff + TN - 1) / TN), E, 3);
  bwd_dw<T><<<g3, THREADS, 0, s>>>(tx, (const T*)h, (const T*)dg,
                                   (const T*)du, (const T*)dy, (T*)dwg,
                                   (T*)dwu, (T*)dwd, C, d, ff);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy, dx: (E, C, d); wg, wu, dwg, dwu: (E, d, ff); wd, dwd: (E, ff, d);
// h, dg, du: (E, C, ff) scratch; all one type (dtype 0 = float32,
// 1 = bfloat16), contiguous and 16-byte aligned; d and ff multiples of 8.
int mcsa_moe_swiglu_bwd_launch(const void* x, const void* wg, const void* wu,
                               const void* wd, const void* dy, void* dx,
                               void* dwg, void* dwu, void* dwd, void* h,
                               void* dg, void* du, int E, int C, int d,
                               int ff, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E <= 0 || C <= 0 || d <= 0 || ff <= 0 || E > 65535 || d % 8 ||
      ff % 8 || (C + TM - 1) / TM > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, wg, wu, wd, dy, dx, dwg, dwu, dwd, h, dg, du, E,
                         C, d, ff, s);
  if (dtype == 1)
    return launch<bf16>(x, wg, wu, wd, dy, dx, dwg, dwu, dwd, h, dg, du, E,
                        C, d, ff, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
