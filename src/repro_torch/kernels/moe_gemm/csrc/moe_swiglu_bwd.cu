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
// Three bodies; the wrapper (backward.py::body_for) names one per call
// and the launch refuses any other pairing.  Each is three launches of
// the same three products:
//   1. hidden: G, U and dH over d into three float32 accumulators; the
//      epilogue writes H, dG and dU in x's type to three (E, C, ff)
//      scratch tensors (each rounded once).
//   2. dx = dG·Wgᵀ + dU·Wuᵀ, one accumulator over 2·ff.
//   3. dw: dWg = xᵀ·dG, dWu = xᵀ·dU (E, d, ff) and dWd = Hᵀ·dy (E, ff,
//      d), sums over the C capacity rows.
// Every output tile is owned by one block, which sums its k steps in a
// fixed order: no atomics, the same bits on every run.  Rows past C and
// columns past d or ff load as zeros and are not stored; d and ff must be
// multiples of 8 (whole 16-byte loads, 16-byte tensor-map strides).
//
// * wgmma + TMA (bfloat16, C above 16: training; namespace hopper_tc), on
//   the forward's building blocks (moe_tc.cuh): persistent blocks, one an
//   SM, of two consumer warpgroups (64 rows each of a 128-row tile); a
//   ring of 4 stages of 48 KB (a 128 x 64 A tile and a 64 x 256 B tile,
//   128-byte swizzled, filled by TMA); m64n256k16 / m64n128k16 wgmma with
//   a step's products in flight while the next is issued.  Each launch
//   walks its tiles row tile first, so the blocks in flight share an
//   expert's weight tiles (launches 1 and 2) or activation slices (3) in
//   L2.  The three products, each a reduction of 64-wide steps:
//     1. hidden: tiles of (expert, 128 capacity rows, 128 ff columns);
//        steps over d of x with [Wg|Wu] read as one MN-major B of 256
//        columns (as the forward's gate_up), then steps over d of dy with
//        Wd's 128 rows as a K-major B (Wd is (ff, d): a row of Wd is a
//        column of Wdᵀ).  Three accumulators, G|U (128 registers a
//        thread) and dH (64): 192 of a thread's 255, so the ff tile is
//        128 (256 would need 384); ptxas: 244 registers, no spill (179
//        and 167 in launches 2 and 3).  H, dG and dU are formed in place
//        of G, U and dH.
//     2. dx: tiles of (expert, 128 rows, 256 d columns); steps over ff of
//        dG with Wg's rows as a K-major B (256 rows of 64), then of dU
//        with Wu's: one reduction over 2·ff.
//     3. dw: tiles of [dWg|dWu] (128 d rows, 128 ff columns each, one
//        n256 product with [dG|dU] as its B, as launch 1 reads [Wg|Wu])
//        and of dWd (128 ff rows, 256 d columns); steps over C.  The A
//        operands xᵀ and Hᵀ are read MN-major by wgmma's transpose from
//        x's and H's own tiles (64 capacity rows x 64 columns each), and
//        dG, dU and dy as MN-major B.
//   The weights are re-read C/128 times (10 at granite-moe's training
//   shape), not C/64 (20) as the mma.sync tiles do, and the copies overlap
//   the products.  Every epilogue goes through a 16 KB block of shared
//   memory a warpgroup (64 rows x 128 columns of bf16, 16-byte chunks
//   XOR-swizzled by row, so neither side has a bank conflict), and leaves
//   it in whole 16-byte vectors, two 256-byte rows a warp: the
//   accumulators' own layout gives 4-byte stores 16 bytes a row, and
//   storing that way made the three launches 1.2x slower in all
//   (tools/kernel_ab.py, PERF.md).  What binds them on the H100:
//   copies, not the tensor cores.  Launch 1 with either product taken
//   out, or with no product at all, ran about as long as with both (the
//   stage copies at ~5.5 TB/s over the card); its epilogue (three
//   outputs and an exp a value) does not overlap the next tile's
//   products.  Running launch 1's two products in one step of 80 KB (two
//   stages), or in alternate steps, was no faster.
// * mma.sync (bfloat16, C up to 16: decode-sized capacities; namespace
//   mma_sync), the first design: 64 x 64 output tiles, 4 warps, k steps of 32
//   staged in shared memory with 16-byte loads, each operand kept in the
//   layout it has in device memory (K- or M/N-contiguous) and read by
//   ldmatrix, with .trans for the M/N-contiguous ones; mma.sync m16n8k16
//   bf16 -> f32 (each warp a 32 x 32 quarter of the tile).
// * CUDA cores (float32): the same tiles, each thread 4 x 8 outputs, so
//   the float32 checks keep full float32 products.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the
// launches go on the caller's stream and return cudaGetLastError().
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moe_tc.cuh"   // wgmma products, the ring, tensor maps

namespace {

namespace mma_sync {

typedef __nv_bfloat16 bf16;

constexpr int TM = 64;         // output rows a tile
constexpr int TN = 64;         // output columns a tile
constexpr int BK = 32;         // k a stage
constexpr int THREADS = 128;

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

}  // namespace mma_sync

// ===========================================================================
// Hopper tensor-core body (bfloat16, C above 16): wgmma + TMA
// ===========================================================================
namespace hopper_tc {

using namespace moe_tc;

// committed wgmma groups left in flight while the next step is issued
constexpr int PIPE = 1;
constexpr int NWG = 2;                   // consumer warpgroups, 64 rows each
constexpr int BM = 64 * NWG;             // rows of an output tile
constexpr int BK = 64;                   // a step: one 128-byte row of bf16
constexpr int THREADS = 128 * NWG;
constexpr int BLK = BK * 128;            // a 64 x 64 bf16 block (8 KB)
constexpr int TILE_A = BM * BK * 2;      // a 128 x 64 A tile (16 KB)
constexpr int BN = 256;                  // B columns a step, at most
constexpr int STAGE = TILE_A + BN * BK * 2;  // 48 KB
constexpr int STAGES = 4;
// after the ring's stages: its mbarriers and counters (12·STAGES bytes,
// within 64), then a warpgroup's 64 x 128 bf16 output block each
constexpr int OUT = STAGES * STAGE + 64;
constexpr int OUT_BYTES = 64 * 128 * 2;
constexpr int SMEM = OUT + NWG * OUT_BYTES + 1024;
constexpr int BF = 128;                  // ff columns of a hidden tile

// This warpgroup's output block in shared memory (generic pointer)
__device__ __forceinline__ uint8_t* out_block(uint8_t* raw, uint32_t base,
                                              int wg) {
  return raw + (base - smem_addr(raw)) + OUT + wg * OUT_BYTES;
}

// Store 128 columns of a warpgroup's 64 accumulator rows (its registers
// acc[off .. off + 64) of an m64n256 / m64n128 tile: row 16·warp + lane/4
// (+ 8), columns 8jj + 2(lane % 4)) as bf16 to dst (row r at dst + r·ld),
// rows at or past `rows` and columns at or past `cols` skipped (cols a
// multiple of 8).  The block goes through shared memory, 16-byte chunks
// XOR-swizzled by row, so that every thread then stores whole 16-byte
// vectors and a warp two whole 256-byte rows.
template <int N>
__device__ __forceinline__ void store_block(const float (&acc)[N], int off,
                                            uint8_t* buf, bf16* dst,
                                            size_t ld, int rows, int cols,
                                            int wg, int t) {
  const int warp = t >> 5, lane = t & 31;
  warpgroup_sync(1 + wg);              // the block's last reads are done
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + (lane >> 2) + 8 * half;
      const int i0 = off + 4 * jj + 2 * half;
      *reinterpret_cast<uint32_t*>(buf + r * 256 + (jj ^ (r & 7)) * 16 +
                                   4 * (lane & 3)) =
          pack_bf16(acc[i0], acc[i0 + 1]);
    }
  warpgroup_sync(1 + wg);
  const int k = t & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (t >> 4) + 8 * i;
    if (r < rows && 8 * k < cols)
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + 8 * k) =
          *reinterpret_cast<const uint4*>(buf + r * 256 +
                                          (k ^ (r & 7)) * 16);
  }
}

// 1. hidden.  Tile (128 capacity rows, BF ff columns, one expert), 2·KD
// steps: G|U += x·[Wg|Wu] over d (steps 0 .. KD), then dH += dy·Wdᵀ over
// d (KD .. 2·KD); H = silu(G) ⊙ U, dG = dH ⊙ U ⊙ σ(1 + G(1 − σ)) and dU =
// dH ⊙ silu(G) stored as bf16 to (E, C, ff).  tmX, tmDY: x, dy as (d, C,
// E), boxes of 128 rows; tmG, tmU: wg, wu as (ff, d, E), boxes of 64 rows
// (MN-major B); tmD: wd as (d, ff, E), boxes of BF rows (K-major B).
__global__ void __launch_bounds__(THREADS, 1)
hidden_kernel(const __grid_constant__ CUtensorMap tmX,
              const __grid_constant__ CUtensorMap tmDY,
              const __grid_constant__ CUtensorMap tmG,
              const __grid_constant__ CUtensorMap tmU,
              const __grid_constant__ CUtensorMap tmD, bf16* __restrict__ h,
              bf16* __restrict__ dg, bf16* __restrict__ du, int E, int C,
              int d, int ff) {
  extern __shared__ uint8_t smem_raw[];
  Ring<STAGES, NWG> ring(smem_raw, STAGE);
  const int KD = (d + BK - 1) / BK;
  const Tiles tiles((C + BM - 1) / BM, (ff + BF - 1) / BF, 2 * KD, E);
  const int KT = tiles.KT, G = tiles.steps();
  auto load = [&](int g) {
    int m, n, e;
    tiles.coords(g, m, n, e);
    const int s = g % KT;
    const uint32_t sA = ring.base + (g % STAGES) * STAGE, sB = sA + TILE_A;
    const uint32_t bar = ring.full(g);
    if (s < KD) {
      const int k0 = s * BK;
      mbar_expect(bar, TILE_A + 2 * BF * BK * 2);
      tma_load_3d(sA, &tmX, bar, k0, m * BM, e);
#pragma unroll
      for (int cb = 0; cb < BF / 64; ++cb) {
        tma_load_3d(sB + cb * BLK, &tmG, bar, n * BF + 64 * cb, k0, e);
        tma_load_3d(sB + (BF / 64 + cb) * BLK, &tmU, bar, n * BF + 64 * cb,
                    k0, e);
      }
    } else {
      const int k0 = (s - KD) * BK;
      mbar_expect(bar, TILE_A + BF * BK * 2);
      tma_load_3d(sA, &tmDY, bar, k0, m * BM, e);
      tma_load_3d(sB, &tmD, bar, k0, n * BF, e);
    }
  };
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < G && g < STAGES; ++g) load(g);

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int t = threadIdx.x & 127;
  float gu[BF];                        // G: 0 .. BF/2, U: BF/2 ..
  float dh[BF / 2];
#pragma unroll
  for (int i = 0; i < BF; ++i) gu[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BF / 2; ++i) dh[i] = 0.f;
  for (int g0 = 0; g0 < G; g0 += KT) {  // one tile: steps g0 .. g0 + KT
    for (int g = g0; g < g0 + KT; ++g) {
      ring.wait(g);
      const uint32_t sA = ring.base + (g % STAGES) * STAGE + wg * 64 * 128;
      const uint32_t sB = ring.base + (g % STAGES) * STAGE + TILE_A;
      wgmma_fence();
      if (g - g0 < KD) {
        fence_regs(gu);
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_ss_n256<0, 1>(gu, desc_sw128(sA + ks * 32, 16, 1024),
                              desc_sw128(sB + ks * 16 * 128, BLK, 1024));
      } else {
        fence_regs(dh);
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_ss_n128<0, 0>(dh, desc_sw128(sA + ks * 32, 16, 1024),
                              desc_sw128(sB + ks * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<PIPE>();              // step g - 1's products are done
      fence_regs(gu);
      fence_regs(dh);
      if (g > g0 && ring.release(g - 1, wg, t) && g - 1 + STAGES < G)
        load(g - 1 + STAGES);
    }
    wgmma_wait<0>();
    fence_regs(gu);
    fence_regs(dh);
    const int gl = g0 + KT - 1;
    if (ring.release(gl, wg, t) && gl + STAGES < G) load(gl + STAGES);

    // H, dG, dU in place of G, U, dH, then each stored through the
    // warpgroup's output block
    int m, n, e;
    tiles.coords(g0, m, n, e);
#pragma unroll
    for (int i = 0; i < BF / 2; ++i) {
      const float gv = gu[i], uv = gu[BF / 2 + i], dhv = dh[i];
      const float sg = 1.f / (1.f + expf(-gv));
      const float sl = gv * sg;
      gu[i] = sl * uv;
      gu[BF / 2 + i] = dhv * uv * (sg * (1.f + gv * (1.f - sg)));
      dh[i] = dhv * sl;
    }
    const int row0 = m * BM + 64 * wg;
    const size_t at = ((size_t)e * C + row0) * ff + n * BF;
    uint8_t* buf = out_block(smem_raw, ring.base, wg);
    store_block(gu, 0, buf, h + at, ff, C - row0, ff - n * BF, wg, t);
    store_block(gu, BF / 2, buf, dg + at, ff, C - row0, ff - n * BF, wg, t);
    store_block(dh, 0, buf, du + at, ff, C - row0, ff - n * BF, wg, t);
#pragma unroll
    for (int i = 0; i < BF; ++i) gu[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BF / 2; ++i) dh[i] = 0.f;
  }
}

// 2. dx.  Tile (128 capacity rows, 256 d columns, one expert), 2·KF steps
// over ff: dG·Wgᵀ, then dU·Wuᵀ, into one accumulator, stored as bf16.
// tmDG, tmDU: dG, dU as (ff, C, E), boxes of 128 rows; tmG, tmU: wg, wu as
// (ff, d, E), boxes of 256 rows (K-major B).
__global__ void __launch_bounds__(THREADS, 1)
dx_kernel(const __grid_constant__ CUtensorMap tmDG,
          const __grid_constant__ CUtensorMap tmDU,
          const __grid_constant__ CUtensorMap tmG,
          const __grid_constant__ CUtensorMap tmU, bf16* __restrict__ dx,
          int E, int C, int d, int ff) {
  extern __shared__ uint8_t smem_raw[];
  Ring<STAGES, NWG> ring(smem_raw, STAGE);
  const int KF = (ff + BK - 1) / BK;
  const Tiles tiles((C + BM - 1) / BM, (d + BN - 1) / BN, 2 * KF, E);
  const int KT = tiles.KT, G = tiles.steps();
  auto load = [&](int g) {
    int m, n, e;
    tiles.coords(g, m, n, e);
    const int s = g % KT;
    const bool up = s >= KF;
    const int k0 = (up ? s - KF : s) * BK;
    const uint32_t sA = ring.base + (g % STAGES) * STAGE, sB = sA + TILE_A;
    const uint32_t bar = ring.full(g);
    mbar_expect(bar, STAGE);
    tma_load_3d(sA, up ? &tmDU : &tmDG, bar, k0, m * BM, e);
    tma_load_3d(sB, up ? &tmU : &tmG, bar, k0, n * BN, e);
  };
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < G && g < STAGES; ++g) load(g);

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int t = threadIdx.x & 127;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int g0 = 0; g0 < G; g0 += KT) {
    for (int g = g0; g < g0 + KT; ++g) {
      ring.wait(g);
      const uint32_t sA = ring.base + (g % STAGES) * STAGE + wg * 64 * 128;
      const uint32_t sB = ring.base + (g % STAGES) * STAGE + TILE_A;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_ss_n256<0, 0>(acc, desc_sw128(sA + ks * 32, 16, 1024),
                            desc_sw128(sB + ks * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<PIPE>();
      fence_regs(acc);
      if (g > g0 && ring.release(g - 1, wg, t) && g - 1 + STAGES < G)
        load(g - 1 + STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    const int gl = g0 + KT - 1;
    if (ring.release(gl, wg, t) && gl + STAGES < G) load(gl + STAGES);

    int m, n, e;
    tiles.coords(g0, m, n, e);
    const int row0 = m * BM + 64 * wg;
    bf16* at = dx + ((size_t)e * C + row0) * d + n * BN;
    uint8_t* buf = out_block(smem_raw, ring.base, wg);
    store_block(acc, 0, buf, at, d, C - row0, d - n * BN, wg, t);
    store_block(acc, BN / 4, buf, at + 128, d, C - row0, d - n * BN - 128,
                wg, t);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  }
}

// 3. dw.  Per expert, T0 tiles of [dWg|dWu] (128 d rows, 128 ff columns
// of each: A = xᵀ, B = [dG|dU]) and then T1 tiles of dWd (128 ff rows, 256
// d columns: A = Hᵀ, B = dy), each KC steps over C.  Every operand is a
// (C, width) activation read in 64 x 64 blocks: A MN-major (wgmma's
// transpose: a block's 64 columns are a warpgroup's 64 output rows), B
// MN-major.  tmX, tmDY: x, dy as (d, C, E); tmH, tmDG, tmDU: H, dG, dU as
// (ff, C, E); boxes of 64 rows.
__global__ void __launch_bounds__(THREADS, 1)
dw_kernel(const __grid_constant__ CUtensorMap tmX,
          const __grid_constant__ CUtensorMap tmH,
          const __grid_constant__ CUtensorMap tmDG,
          const __grid_constant__ CUtensorMap tmDU,
          const __grid_constant__ CUtensorMap tmDY, bf16* __restrict__ dwg,
          bf16* __restrict__ dwu, bf16* __restrict__ dwd, int E, int C,
          int d, int ff) {
  extern __shared__ uint8_t smem_raw[];
  Ring<STAGES, NWG> ring(smem_raw, STAGE);
  const int MT0 = (d + BM - 1) / BM, T0 = MT0 * ((ff + BF - 1) / BF);
  const int MT1 = (ff + BM - 1) / BM, T1 = MT1 * ((d + BN - 1) / BN);
  // a tile: (r, 0, e), r < T0 a [dWg|dWu] tile, else a dWd tile
  const Tiles tiles(T0 + T1, 1, (C + BK - 1) / BK, E);
  const int KT = tiles.KT, G = tiles.steps();
  auto load = [&](int g) {
    int r, n, e;
    tiles.coords(g, r, n, e);
    const int c0 = (g % KT) * BK;
    const uint32_t sA = ring.base + (g % STAGES) * STAGE, sB = sA + TILE_A;
    const uint32_t bar = ring.full(g);
    mbar_expect(bar, STAGE);
    if (r < T0) {
      const int m = r % MT0;
      n = r / MT0;
#pragma unroll
      for (int w = 0; w < NWG; ++w)
        tma_load_3d(sA + w * BLK, &tmX, bar, m * BM + 64 * w, c0, e);
#pragma unroll
      for (int cb = 0; cb < BF / 64; ++cb) {
        tma_load_3d(sB + cb * BLK, &tmDG, bar, n * BF + 64 * cb, c0, e);
        tma_load_3d(sB + (BF / 64 + cb) * BLK, &tmDU, bar, n * BF + 64 * cb,
                    c0, e);
      }
    } else {
      const int m = (r - T0) % MT1;
      n = (r - T0) / MT1;
#pragma unroll
      for (int w = 0; w < NWG; ++w)
        tma_load_3d(sA + w * BLK, &tmH, bar, m * BM + 64 * w, c0, e);
#pragma unroll
      for (int cb = 0; cb < BN / 64; ++cb)
        tma_load_3d(sB + cb * BLK, &tmDY, bar, n * BN + 64 * cb, c0, e);
    }
  };
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < G && g < STAGES; ++g) load(g);

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int t = threadIdx.x & 127;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int g0 = 0; g0 < G; g0 += KT) {
    for (int g = g0; g < g0 + KT; ++g) {
      ring.wait(g);
      const uint32_t sA = ring.base + (g % STAGES) * STAGE + wg * BLK;
      const uint32_t sB = ring.base + (g % STAGES) * STAGE + TILE_A;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_ss_n256<1, 1>(acc, desc_sw128(sA + ks * 16 * 128, BLK, 1024),
                            desc_sw128(sB + ks * 16 * 128, BLK, 1024));
      wgmma_commit();
      wgmma_wait<PIPE>();
      fence_regs(acc);
      if (g > g0 && ring.release(g - 1, wg, t) && g - 1 + STAGES < G)
        load(g - 1 + STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    const int gl = g0 + KT - 1;
    if (ring.release(gl, wg, t) && gl + STAGES < G) load(gl + STAGES);

    int r, n_, e;
    tiles.coords(g0, r, n_, e);
    const bool w01 = r < T0;
    const int m = w01 ? r % MT0 : (r - T0) % MT1;
    const int n = w01 ? r / MT0 : (r - T0) / MT1;
    const int row0 = m * BM + 64 * wg;
    uint8_t* buf = out_block(smem_raw, ring.base, wg);
    if (w01) {                         // columns 0..127 dWg, 128.. dWu
      const size_t at = ((size_t)e * d + row0) * ff + n * BF;
      store_block(acc, 0, buf, dwg + at, ff, d - row0, ff - n * BF, wg, t);
      store_block(acc, BN / 4, buf, dwu + at, ff, d - row0, ff - n * BF, wg,
                  t);
    } else {
      bf16* at = dwd + ((size_t)e * ff + row0) * d + n * BN;
      store_block(acc, 0, buf, at, d, ff - row0, d - n * BN, wg, t);
      store_block(acc, BN / 4, buf, at + 128, d, ff - row0,
                  d - n * BN - 128, wg, t);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  }
}

int launch(const void* x, const void* wg_, const void* wu, const void* wd,
           const void* dy, void* dx, void* dwg, void* dwu, void* dwd,
           void* h, void* dg, void* du, int E, int C, int d, int ff, int sms,
           cudaStream_t s) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        hidden_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  // launch 1: x, dy by 128 rows; wg, wu by 64 d rows; wd by BF ff rows
  CUtensorMap tx, tdy, tg, tu, td;
  int err = tensor_map(&tx, x, d, C, E, BM);
  if (!err) err = tensor_map(&tdy, dy, d, C, E, BM);
  if (!err) err = tensor_map(&tg, wg_, ff, d, E, BK);
  if (!err) err = tensor_map(&tu, wu, ff, d, E, BK);
  if (!err) err = tensor_map(&td, wd, d, ff, E, BF);
  // launch 2: dG, dU by 128 rows; wg, wu by 256 d rows
  CUtensorMap tdg, tdu, tg2, tu2;
  if (!err) err = tensor_map(&tdg, dg, ff, C, E, BM);
  if (!err) err = tensor_map(&tdu, du, ff, C, E, BM);
  if (!err) err = tensor_map(&tg2, wg_, ff, d, E, BN);
  if (!err) err = tensor_map(&tu2, wu, ff, d, E, BN);
  // launch 3: x, H, dG, dU, dy by 64 capacity rows
  CUtensorMap tx3, th3, tdg3, tdu3, tdy3;
  if (!err) err = tensor_map(&tx3, x, d, C, E, BK);
  if (!err) err = tensor_map(&th3, h, ff, C, E, BK);
  if (!err) err = tensor_map(&tdg3, dg, ff, C, E, BK);
  if (!err) err = tensor_map(&tdu3, du, ff, C, E, BK);
  if (!err) err = tensor_map(&tdy3, dy, d, C, E, BK);
  if (err) return err;
  const int mt = (C + BM - 1) / BM;
  const int n1 = mt * ((ff + BF - 1) / BF) * E;
  const int n2 = mt * ((d + BN - 1) / BN) * E;
  const int n3 = (((d + BM - 1) / BM) * ((ff + BF - 1) / BF) +
                  ((ff + BM - 1) / BM) * ((d + BN - 1) / BN)) * E;
  hidden_kernel<<<n1 < sms ? n1 : sms, THREADS, SMEM, s>>>(
      tx, tdy, tg, tu, td, (bf16*)h, (bf16*)dg, (bf16*)du, E, C, d, ff);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dx_kernel<<<n2 < sms ? n2 : sms, THREADS, SMEM, s>>>(
      tdg, tdu, tg2, tu2, (bf16*)dx, E, C, d, ff);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dw_kernel<<<n3 < sms ? n3 : sms, THREADS, SMEM, s>>>(
      tx3, th3, tdg3, tdu3, tdy3, (bf16*)dwg, (bf16*)dwu, (bf16*)dwd, E, C,
      d, ff);
  return (int)cudaGetLastError();
}

}  // namespace hopper_tc

}  // namespace

extern "C" {

// x, dy, dx: (E, C, d); wg, wu, dwg, dwu: (E, d, ff); wd, dwd: (E, ff, d);
// h, dg, du: (E, C, ff) scratch; all one type, contiguous and 16-byte
// aligned; d and ff multiples of 8.  dtype: 0 = float32, 1 = bfloat16;
// body: 0 = CUDA cores, 1 = mma.sync, 2 = wgmma + TMA (at most sms
// persistent blocks, one an SM).  The pairings taken are (float32, CUDA
// cores), (bfloat16, mma.sync) and (bfloat16, wgmma); anything else
// returns cudaErrorInvalidValue.
int mcsa_moe_swiglu_bwd_launch(const void* x, const void* wg, const void* wu,
                               const void* wd, const void* dy, void* dx,
                               void* dwg, void* dwu, void* dwd, void* h,
                               void* dg, void* du, int E, int C, int d,
                               int ff, int sms, int dtype, int body,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E <= 0 || C <= 0 || d <= 0 || ff <= 0 || E > 65535 || d % 8 ||
      ff % 8 || (C + mma_sync::TM - 1) / mma_sync::TM > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && body == 0)
    return mma_sync::launch<float>(x, wg, wu, wd, dy, dx, dwg, dwu, dwd, h,
                                   dg, du, E, C, d, ff, s);
  if (dtype == 1 && body == 1)
    return mma_sync::launch<__nv_bfloat16>(x, wg, wu, wd, dy, dx, dwg, dwu,
                                           dwd, h, dg, du, E, C, d, ff, s);
  if (dtype == 1 && body == 2)
    return hopper_tc::launch(x, wg, wu, wd, dy, dx, dwg, dwu, dwd, h, dg, du,
                             E, C, d, ff, sms, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a wgmma + TMA block (bytes; the three kernels
// take the same ring).
int mcsa_moe_swiglu_bwd_wgmma_smem() { return hopper_tc::SMEM; }

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
