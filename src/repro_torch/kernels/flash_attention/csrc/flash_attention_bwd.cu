// Flash attention backward for Hopper (sm_90a): the gradients dq, dk, dv
// of the forward in csrc/flash_attention.cu (online-softmax GQA attention,
// causal and sliding-window masks) for an output gradient dout, in the
// model layout q (B, Sq, Hq, HD), k/v (B, Skv, Hkv, HD), HD 32, 64, 128 or
// 256.
//
// What it replaces: no Pallas kernel.  The JAX package's train step
// differentiates its jnp flash_attention (src/repro/models/transformer.py:
// 250) with XLA; its forward kernel is flash_attention_tpu
// (src/repro/kernels/flash_attention/kernel.py:98).  The port's model
// reaches the forward through its CUDA kernel, so the backward of that call
// is this file: FA-2's algorithm, with P = exp(s − LSE), dV = Pᵀ·dO, dP =
// dO·Vᵀ, D = rowsum(dO ⊙ O), dS = P ⊙ (dP − D), dQ = scale·dS·K, dK =
// scale·dSᵀ·Q, dK and dV summed over the Hq/Hkv query heads of a k/v head.
//
// What bounds it: operations.  Per unmasked (query, key) pair the design
// runs 8 products of 2·HD flops (S and dP twice, once for dK/dV and once
// for dQ; dV, dK, and dQ's two), against the bound's 2.5x the forward's
// 4·HD (chip_smoke.py counts it so).  At starcoder2-3b's shape the bytes
// (q, k, v, out, dout in; dq, dk, dv out) are a few percent of that time.
// So the products belong on the bf16 tensor cores, and the design keeps
// every tile in shared memory, fed by TMA, as the forward's body does.
//
// Two bodies, chosen by the type, never by a fallback:
//   * bfloat16 -> the tensor-core body (namespace tc), at every head_dim,
//     four launches:
//       1. delta: one pass over dout, out and out_lo (the forward's
//          rounding residual) packs (LSE, D) a row into stats (B, Hq,
//          Sq_pad) float2, Sq_pad = Sq rounded up to 64 (rows past Sq get
//          zeros), D = rowsum(dO ⊙ (out + out_lo)) in float32.  LSE comes
//          from the forward (base 2), so no pass recomputes the scores.
//       2. dkdv: grid (B·Hkv·nsplit, kv tiles), one warpgroup a block (two
//          at HD 256, below).  K and V of 64 keys stay in shared memory
//          (TMA, the forward's 128-byte swizzle); the block walks hps =
//          Hq/Hkv/nsplit query heads and, for each, the q tiles of the
//          causal/window band, through a two-stage TMA ring of (Q, dO,
//          stats) tiles.  Per q tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (wgmma,
//          both operands in shared memory; dPᵀ runs while Pᵀ = 2^(x −
//          LSE) is formed in registers); dV += Pᵀ·dO with Pᵀ as the bf16
//          register A operand; dSᵀ = Pᵀ ⊙ (dPᵀ − D) in float32 while dV's
//          product runs; dK += dSᵀ·Q with dSᵀ as plain bf16.  Q and dO
//          serve as K-major B operands in the first two products and as
//          MN-major ones in the last two, from the same swizzled tile.  dK
//          and dV stay in float32 registers over the block's heads and are
//          stored once.
//       3. sum (only when nsplit > 1): the nsplit float32 partials of dK
//          and dV summed in split order into bf16.
//       4. dq: grid (B·Hq, q tiles), one warpgroup a block (two at HD
//          256).  Q, dO and the rows' (LSE, D) stay; K and V tiles come
//          through the ring.  Per kv tile: S = Q·Kᵀ and dP = dO·Vᵀ, dS in
//          float32 registers, then dQ += dS_hi·K + dS_lo·K with K as the
//          MN-major B operand.
//     No atomics: a block owns its outputs, and the split count follows
//     the shape alone (backward.py::group_split), so two runs on the same
//     inputs give the same bits.
//   * float32 -> the CUDA-core body (namespace cc, the first design): fp32
//     FMAs, so the exact 1e-5 checks keep full float32 products; a pre-pass
//     recomputes LSE and takes D from the float32 out.  At HD 256 its
//     tiles are 32 rows, not 64: four float32 tiles of 64 x 260 would need
//     266 KB of shared memory, a block may take 227 KB.
//
// Head_dim 256 on the tensor cores (recurrentgemma-9b's local layers).
// dK and dV of 64 keys x 256 columns would be 256 float32 accumulator
// registers a thread of one warpgroup, past the 255 a thread may have.
// So a block there is two warpgroups (256 threads), warpgroup w owning
// output columns [128w, 128w + 128) of dK and dV (dkdv) or of dQ (dq):
// 128 accumulator registers a thread in dkdv, as at HD 128.  Each
// warpgroup computes the whole 64 x 64 Sᵀ and dPᵀ (S and dP in dq) over
// all 256 columns itself, and the two products that reduce over keys or
// query rows (dV += Pᵀ·dO, dK += dSᵀ·Q; dQ += dS·K) read only its half of
// dO, Q or K (the MN-major B starts 2 column blocks in).  Computing the
// scores twice costs 1.5x the tensor work of computing them once (24
// products of 64 x 64 x 64 a tile pair in each kernel, not 16), and buys
// what a hand-over
// through shared memory would have to repair: no tile leaves a
// warpgroup's registers, no barrier but the ring's, and the numerics are
// those of HD ≤ 128 exactly.  A hand-over of P in bf16 would be a
// rounding the HD ≤ 128 design does not make, and P's error in dS = P ⊙
// (dP − D) reaches dQ as the shared key component does
// (tests/test_torch_attn_bwd_rounding.py shows that variant breach);
// handing over float32 tiles would add 32 KB to a block already at 194
// KB.  Shared memory: a 64-row bf16 tile is 32 KB at HD 256, so K, V and
// two stages of (Q, dO) take 192 KB (dq: Q, dO and two stages of (K,
// V)), and one block fits an SM (two at HD ≤ 128): 132 slots for
// group_split, where HD ≤ 128 has 264.  ptxas reports the registers and
// spills of every instance in chip_smoke.py's [build] lines, which fail
// on a spill.
//
// Why D in float32, and dS as hi + lo only in dQ.  An error δD_i enters dQ_i
// as −δD_i·Σ_j P_ij k_j.  When the keys share a common component c (a bias,
// as trained keys often have), Σ_j P_ij k_j carries c whatever P is, so
// dQ's error grows with c; D from bf16 out breaches the bf16 checks at c =
// 2 (tests/test_torch_attn_bwd_rounding.py simulates every rounding here).
// Hence D = rowsum(dO ⊙ (out + out_lo)), with ~16 bits of O.  dQ's own
// product sums dS_ij·k_j over the same keys, so bf16 rounding of dS adds
// errors that c scales in the same way: dS goes in as hi + lo (hi =
// bf16(dS), lo = bf16(dS − hi)), two products a k step.  dK = dSᵀ·Q and
// dV = Pᵀ·dO sum over query rows, which share no such component: plain
// bf16 dSᵀ and Pᵀ keep them at one bf16 rounding (the same simulation).
//
// Register budget (tensor-core body).  At HD 128 the dK and dV
// accumulators are 128 float32 registers a thread (64 keys x 128 columns
// each over a warpgroup), and a q tile adds Sᵀ/Pᵀ and dPᵀ/dSᵀ (32 each)
// and their bf16 fragments (16 each): about 210 live at the peak (ptxas:
// 234 registers at HD 128, 170 at 64 and 32, no spill).  So a block is one
// warpgroup of 64 keys (not the forward's two or three of 64 rows each),
// and two blocks share an SM (2 x 128 x 240 registers fit its 64 K).  The
// dQ kernel (ptxas: 155 at HD 128) takes the same shape.  At HD 256 each
// of the two warpgroups holds what one holds at HD 128 (dq: half its
// accumulators), so one block of 256 threads fits the SM's registers
// (ptxas: 234 and 156 at HD 256, no spill).  The stage
// a block finishes is refilled by its thread 0 after a block barrier,
// with no release counter.
//
// Splitting a k/v head's query heads (GQA).  starcoder2-3b's 24/2 heads
// give 2 k/v heads, so one block per (kv tile, k/v head, batch) is 128
// blocks, and a causal kv tile 0 walks 16 q tiles x 12 heads while tile 15
// walks 12.  backward.py::group_split splits the 12 heads over nsplit
// blocks (4 at that shape: 512 blocks) until the heaviest block is no
// longer than the mean work of the card's slots (264 at HD ≤ 128, two
// blocks an SM; 132 at HD 256, where recurrentgemma-9b's 16/1 heads at S
// 2560 split 4 ways); their float32 partials are summed by launch 3.  Causal blocks run heaviest
// first: the kv tile (dK/dV) or q tile (dQ) is the grid's slowest axis.
//
// Semantics kept from the forward (and so from attention_ref): q position
// i aligns with key i (the caller refuses causal Sq != Skv); a pair is
// kept when k < Skv and, if causal, q >= k and, with a window, q - k <
// window; rows past Sq and keys past Skv come in as zeros and get P = 0.
//
// Shared memory (tensor-core body), bytes at HD 128 (HD 32 pads to 64):
// dkdv K, V + 2 stages x (Q, dO) of 64 x 128 bf16 + 2 x 512 of stats =
// 97 KiB; dq Q, dO + 2 x (K, V) = 96 KiB; at HD 256 193 and 192 KiB; +
// mbarriers and 1 KiB to align the swizzle atoms (backward.py::smem_bytes
// mirrors Cfg).
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launches
// go on the caller's stream and return cudaGetLastError().
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"   // wgmma products, bf16 packing, tensor maps

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool keep(int qp, int kp, int Sq, int Skv,
                                     int causal, int window) {
  bool ok = qp < Sq && kp < Skv;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------
// CUDA-core body, float32
// ---------------------------------------------------------------------
namespace cc {

// R (q rows and keys a tile) is 64, or 32 at HD 256, where four float32
// tiles of 64 rows would need 266 KB of shared memory, more than a block
// may take (227 KB); 32-row tiles take 133 KB.  A thread owns rows (or
// keys) ty + 16a and tx + 16b, a, b < R / 16.
constexpr int THREADS = 256;    // 16 x 16
constexpr int PS = 80;          // pitch of the P / dS tile

template <int HD>
constexpr int rows_for() { return HD > 128 ? 32 : 64; }

// 4 consecutive elements of src (16-byte aligned)
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

// Copy `rows` rows of one head (HD elements each, `stride` elements apart)
// into shared memory with row pitch HD + 4; rows at or past `valid` are
// zeros.
template <int HD>
__device__ void load_tile(float* dst, const float* src, size_t stride,
                          int rows, int valid) {
  constexpr int P = HD + 4, PER_ROW = HD / 4;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = load4(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * P + c) = val;
  }
}

// s[a][b] = sum_d A[ty + 16a][d] * B[tx + 16b][d] (A, B: pitch HD + 4)
template <int HD, int RA>
__device__ __forceinline__ void nt_tile(float (&s)[RA][RA],
                                        const float* __restrict__ A,
                                        const float* __restrict__ B, int ty,
                                        int tx) {
  constexpr int P = HD + 4;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RA; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[RA], bv[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = load4(A + (ty + 16 * a) * P + d);
#pragma unroll
    for (int b = 0; b < RA; ++b) bv[b] = load4(B + (tx + 16 * b) * P + d);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RA; ++b) {
        float t = s[a][b];
        t = fmaf(av[a].x, bv[b].x, t);
        t = fmaf(av[a].y, bv[b].y, t);
        t = fmaf(av[a].z, bv[b].z, t);
        t = fmaf(av[a].w, bv[b].w, t);
        s[a][b] = t;
      }
  }
}

// Column groups of a 64 x HD accumulator: VW columns each, NG of them a
// thread, so a thread holds 4 rows x NC = NG * VW floats.
template <int HD>
struct Acc {
  static constexpr int VW = HD >= 64 ? 4 : 2;
  static constexpr int NG = HD / (16 * VW);
  static constexpr int NC = NG * VW;
  __device__ static int col(int tx, int e) { return VW * tx + 16 * VW * e; }
};

// acc[a][..] += sum_k M(ty + 16a, k) * B[k][cols of tx], k over 16·RA:
// M(r, k) is Ms[k * PS + r] when TRANS (Pᵀ or dSᵀ: r is a key) and
// Ms[r * PS + k] otherwise (dS: r is a q row); B has pitch HD + 4.
template <int HD, bool TRANS, int RA>
__device__ __forceinline__ void acc_tile(float (&acc)[RA][Acc<HD>::NC],
                                         const float* __restrict__ Ms,
                                         const float* __restrict__ B,
                                         int ty, int tx) {
  using C = Acc<HD>;
  constexpr int P = HD + 4;
#pragma unroll 2
  for (int k = 0; k < 16 * RA; ++k) {
    float m[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a)
      m[a] = TRANS ? Ms[k * PS + ty + 16 * a] : Ms[(ty + 16 * a) * PS + k];
#pragma unroll
    for (int e = 0; e < C::NG; ++e) {
      const float* src = B + k * P + C::col(tx, e);
      float bv[C::VW];
      if constexpr (C::VW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(src);
        bv[0] = t.x; bv[1] = t.y; bv[2] = t.z; bv[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(src);
        bv[0] = t.x; bv[1] = t.y;
      }
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int j = 0; j < C::VW; ++j)
          acc[a][e * C::VW + j] = fmaf(m[a], bv[j], acc[a][e * C::VW + j]);
    }
  }
}

// Store 4 rows (ty + 16a) of an accumulator times `mul` to dst (row r at
// dst + r * stride), rows at or past `valid` skipped.
template <int HD, int RA>
__device__ __forceinline__ void store_acc(const float (&acc)[RA][Acc<HD>::NC],
                                          float* dst, size_t stride,
                                          int valid, float mul, int ty,
                                          int tx) {
  using C = Acc<HD>;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + 16 * a;
    if (r >= valid) continue;
#pragma unroll
    for (int e = 0; e < C::NG; ++e)
#pragma unroll
      for (int j = 0; j < C::VW; ++j)
        dst[r * stride + C::col(tx, e) + j] = acc[a][e * C::VW + j] * mul;
  }
}

// The kv tiles [kt_begin, kt_end) of BK keys that q rows [q0, q_last] meet.
template <int BK>
__device__ __forceinline__ void kv_band(int q0, int q_last, int Skv,
                                        int causal, int window,
                                        int& kt_begin, int& kt_end) {
  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  kt_begin = k_begin / BK;
  kt_end = (k_end + BK - 1) / BK;
}

// 1. LSE (natural log) and D = rowsum(dO ⊙ out), TPR threads a row
template <int HD, int R>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_prep(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ out, const float* __restrict__ dout,
              float* __restrict__ lse, float* __restrict__ delta, int Sq,
              int Skv, int Hq, int Hkv, float scale, int causal,
              int window) {
  constexpr int P = HD + 4, RA = R / 16, BQ = R, BK = R;
  constexpr int TPR = THREADS / R;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * P;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t q_stride = (size_t)Hq * HD, kv_stride = (size_t)Hkv * HD;
  const size_t q_off = (((size_t)b * Sq + q0) * Hq + h) * HD;
  const size_t row0 = ((size_t)b * Hq + h) * Sq + q0;   // into lse / delta

  // D: TPR threads a row, every (4·TPR)-th group of 4 columns each
  {
    const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
    float s = 0.f;
    if (q0 + r < Sq) {
      const float* o = out + q_off + r * q_stride;
      const float* g = dout + q_off + r * q_stride;
      for (int c = part * 4; c < HD; c += 4 * TPR) {
        const float4 ov = load4(o + c), gv = load4(g + c);
        s += ov.x * gv.x + ov.y * gv.y + ov.z * gv.z + ov.w * gv.w;
      }
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (part == 0 && q0 + r < Sq) delta[row0 + r] = s;
  }

  load_tile<HD>(Qs, q + q_off, q_stride, BQ, Sq - q0);
  int kt_begin, kt_end;
  kv_band<BK>(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window, kt_begin,
              kt_end);
  float m[RA], l[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                       // previous K tile consumed
    load_tile<HD>(Ks, k + (((size_t)b * Skv + k0) * Hkv + hk) * HD,
                  kv_stride, BK, Skv - k0);
    __syncthreads();
    float s[RA][RA];
    nt_tile<HD, RA>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int qp = q0 + ty + 16 * a;
      float mt = NEG_INF;
#pragma unroll
      for (int bb = 0; bb < RA; ++bb) {
        const bool ok = keep(qp, k0 + tx + 16 * bb, Sq, Skv, causal, window);
        s[a][bb] = ok ? s[a][bb] * scale : NEG_INF;
        mt = fmaxf(mt, s[a][bb]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[a], mt);
      float rs = 0.f;
#pragma unroll
      for (int bb = 0; bb < RA; ++bb)
        rs += s[a][bb] > 0.5f * NEG_INF ? expf(s[a][bb] - mn) : 0.f;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * expf(m[a] - mn) + rs;
      m[a] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int r = ty + 16 * a;
      if (q0 + r < Sq) lse[row0 + r] = m[a] + logf(fmaxf(l[a], 1e-30f));
    }
  }
}

// 2. dK and dV
template <int HD, int R>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int Sq,
              int Skv, int Hq, int Hkv, float scale, int causal,
              int window) {
  using C = Acc<HD>;
  constexpr int P = HD + 4, RA = R / 16, BQ = R, BK = R;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * P;
  float* Qs = Vs + BK * P;
  float* Gs = Qs + BQ * P;                 // dout tile
  float* Ps = Gs + BQ * P;                 // P, then dS: [q][key]
  float* Ls = Ps + BQ * PS;
  float* Ds = Ls + BQ;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t q_stride = (size_t)Hq * HD, kv_stride = (size_t)Hkv * HD;
  const size_t kv_off = (((size_t)b * Skv + k0) * Hkv + hk) * HD;
  load_tile<HD>(Ks, k + kv_off, kv_stride, BK, Skv - k0);
  load_tile<HD>(Vs, v + kv_off, kv_stride, BK, Skv - k0);

  // the q tiles whose rows meet keys [k0, k_last]
  const int k_last = min(k0 + BK, Skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
  const int qt_begin = q_begin / BQ, qt_end = (q_end + BQ - 1) / BQ;

  float dka[RA][C::NC], dva[RA][C::NC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < C::NC; ++c) dka[a][c] = dva[a][c] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      const size_t q_off = (((size_t)b * Sq + q0) * Hq + h) * HD;
      const size_t row0 = ((size_t)b * Hq + h) * Sq + q0;
      __syncthreads();                     // the last tiles are consumed
      load_tile<HD>(Qs, q + q_off, q_stride, BQ, Sq - q0);
      load_tile<HD>(Gs, dout + q_off, q_stride, BQ, Sq - q0);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool in = q0 + i < Sq;
        Ls[i] = in ? lse[row0 + i] : 0.f;
        Ds[i] = in ? delta[row0 + i] : 0.f;
      }
      __syncthreads();
      float p[RA][RA], dp[RA][RA];
      nt_tile<HD, RA>(p, Qs, Ks, ty, tx);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int bb = 0; bb < RA; ++bb) {
          const int c = tx + 16 * bb;
          const bool ok = keep(q0 + r, k0 + c, Sq, Skv, causal, window);
          p[a][bb] = ok ? expf(p[a][bb] * scale - Ls[r]) : 0.f;
          Ps[r * PS + c] = p[a][bb];
        }
      }
      nt_tile<HD, RA>(dp, Gs, Vs, ty, tx);
      __syncthreads();                     // P is whole
      acc_tile<HD, true, RA>(dva, Ps, Gs, ty, tx);
      __syncthreads();                     // P is read: dS takes its place
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int bb = 0; bb < RA; ++bb)
          Ps[r * PS + tx + 16 * bb] = p[a][bb] * (dp[a][bb] - Ds[r]);
      }
      __syncthreads();
      acc_tile<HD, true, RA>(dka, Ps, Qs, ty, tx);
    }
  }
  store_acc<HD, RA>(dka, dk + kv_off, kv_stride, Skv - k0, scale, ty, tx);
  store_acc<HD, RA>(dva, dv + kv_off, kv_stride, Skv - k0, 1.f, ty, tx);
}

// 3. dQ
template <int HD, int R>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv,
            float scale, int causal, int window) {
  using C = Acc<HD>;
  constexpr int P = HD + 4, RA = R / 16, BQ = R, BK = R;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + BQ * P;
  float* Ks = Gs + BQ * P;
  float* Vs = Ks + BK * P;
  float* Ps = Vs + BK * P;                 // dS: [q][key]
  float* Ls = Ps + BQ * PS;
  float* Ds = Ls + BQ;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t q_stride = (size_t)Hq * HD, kv_stride = (size_t)Hkv * HD;
  const size_t q_off = (((size_t)b * Sq + q0) * Hq + h) * HD;
  const size_t row0 = ((size_t)b * Hq + h) * Sq + q0;
  load_tile<HD>(Qs, q + q_off, q_stride, BQ, Sq - q0);
  load_tile<HD>(Gs, dout + q_off, q_stride, BQ, Sq - q0);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const bool in = q0 + i < Sq;
    Ls[i] = in ? lse[row0 + i] : 0.f;
    Ds[i] = in ? delta[row0 + i] : 0.f;
  }
  int kt_begin, kt_end;
  kv_band<BK>(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window, kt_begin,
              kt_end);

  float dqa[RA][C::NC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < C::NC; ++c) dqa[a][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const size_t kv_off = (((size_t)b * Skv + k0) * Hkv + hk) * HD;
    __syncthreads();                       // the last K and dS are consumed
    load_tile<HD>(Ks, k + kv_off, kv_stride, BK, Skv - k0);
    load_tile<HD>(Vs, v + kv_off, kv_stride, BK, Skv - k0);
    __syncthreads();
    float s[RA][RA], dp[RA][RA];
    nt_tile<HD, RA>(s, Qs, Ks, ty, tx);
    nt_tile<HD, RA>(dp, Gs, Vs, ty, tx);
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int bb = 0; bb < RA; ++bb) {
        const int c = tx + 16 * bb;
        const bool ok = keep(q0 + r, k0 + c, Sq, Skv, causal, window);
        const float pv = ok ? expf(s[a][bb] * scale - Ls[r]) : 0.f;
        Ps[r * PS + c] = pv * (dp[a][bb] - Ds[r]);
      }
    }
    __syncthreads();
    acc_tile<HD, false, RA>(dqa, Ps, Ks, ty, tx);
  }
  store_acc<HD, RA>(dqa, dq + q_off, q_stride, Sq - q0, scale, ty, tx);
}

template <int HD, int R>
constexpr size_t prep_smem() {
  return sizeof(float) * (size_t)(2 * R) * (HD + 4);
}
template <int HD, int R>
constexpr size_t grad_smem() {
  return sizeof(float) * ((size_t)(4 * R) * (HD + 4) + R * PS + 2 * R);
}

// the pre-pass recomputes LSE (natural log) into `lse` and D from out
template <int HD>
int launch(const float* q, const float* k, const float* v, const float* out,
           const float* dout, float* dq, float* dk, float* dv, float* lse,
           float* delta, int B, int Sq, int Skv, int Hq, int Hkv,
           float scale, int causal, int window, cudaStream_t s) {
  constexpr int R = rows_for<HD>();
  auto prep = attn_bwd_prep<HD, R>;
  auto dkdv = attn_bwd_dkdv<HD, R>;
  auto dqk = attn_bwd_dq<HD, R>;
  static const int attr = [&] {
    int e = set_smem(prep, prep_smem<HD, R>());
    if (!e) e = set_smem(dkdv, grad_smem<HD, R>());
    if (!e) e = set_smem(dqk, grad_smem<HD, R>());
    return e;
  }();
  if (attr) return attr;
  const dim3 qgrid((Sq + R - 1) / R, Hq, B), kgrid((Skv + R - 1) / R, Hkv,
                                                   B);
  prep<<<qgrid, THREADS, prep_smem<HD, R>(), s>>>(
      q, k, out, dout, lse, delta, Sq, Skv, Hq, Hkv, scale, causal, window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv<<<kgrid, THREADS, grad_smem<HD, R>(), s>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Skv, Hq, Hkv, scale, causal,
      window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dqk<<<qgrid, THREADS, grad_smem<HD, R>(), s>>>(
      q, k, v, dout, lse, delta, dq, Sq, Skv, Hq, Hkv, scale, causal,
      window);
  return (int)cudaGetLastError();
}

// float32 at head_dim hd (32, 64, 128, 256): scratch holds LSE, then D
int launch_f32(int hd, const void* q, const void* k, const void* v,
               const void* out, const void* dout, void* dq, void* dk,
               void* dv, float* scratch, int B, int Sq, int Skv, int Hq,
               int Hkv, float scale, int causal, int window, cudaStream_t s) {
  float* lse = scratch;
  float* delta = scratch + (size_t)B * Hq * Sq;
#define MCSA_CC_F32(HD)                                                     \
  case HD:                                                                  \
    return launch<HD>((const float*)q, (const float*)k, (const float*)v,    \
                      (const float*)out, (const float*)dout, (float*)dq,    \
                      (float*)dk, (float*)dv, lse, delta, B, Sq, Skv, Hq,   \
                      Hkv, scale, causal, window, s);
  switch (hd) {
    MCSA_CC_F32(32)
    MCSA_CC_F32(64)
    MCSA_CC_F32(128)
    MCSA_CC_F32(256)
  }
#undef MCSA_CC_F32
  return (int)cudaErrorInvalidValue;
}

}  // namespace cc

// ---------------------------------------------------------------------
// Tensor-core body, bfloat16
// ---------------------------------------------------------------------
namespace tc {

using namespace attn_tc;

constexpr int TILE_ROWS = 64;      // q rows and keys a tile
constexpr int STAGES = 2;

template <int HD>
struct Cfg {
  static constexpr int HDP = HD < 64 ? 64 : HD;    // padded width in smem
  static constexpr int NCB = HDP / 64;             // 128-byte column blocks
  static constexpr int TILE = TILE_ROWS * HDP * 2; // one bf16 tile
  // warpgroups a block: one, or two at HD 256, each owning HO of the
  // output's HDP columns (HS of HD stored); one block an SM at HD 256,
  // two below
  static constexpr int NWG = HD > 128 ? 2 : 1;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BLOCKS_PER_SM = NWG == 1 ? 2 : 1;
  static constexpr int HO = HDP / NWG;
  static constexpr int HS = HD / NWG;
  static constexpr int STATS = TILE_ROWS * 8;      // 64 (LSE, D) pairs
  // dkdv: K, V, STAGES x (Q, dO), STAGES stats rows, then the mbarriers
  // (K/V, then one a stage)
  static constexpr int KV_BAR = (2 + 2 * STAGES) * TILE + STAGES * STATS;
  static constexpr int KV_BYTES = KV_BAR + 8 * (1 + STAGES) + 1024;
  // dq: Q, dO, STAGES x (K, V), then the mbarriers (Q/dO, then a stage)
  static constexpr int Q_BAR = (2 + 2 * STAGES) * TILE;
  static constexpr int Q_BYTES = Q_BAR + 8 * (1 + STAGES) + 1024;
};

// the bf16 A fragments of a 64 x 64 accumulator (k steps of 16 columns:
// groups 2kb and 2kb + 1 of its registers, as the forward feeds P·V)
__device__ __forceinline__ void a_frags(const float (&s)[32],
                                        uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const int g0 = 8 * kb, g1 = 8 * kb + 4;
    a[kb][0] = pack_bf16(s[g0], s[g0 + 1]);
    a[kb][1] = pack_bf16(s[g0 + 2], s[g0 + 3]);
    a[kb][2] = pack_bf16(s[g1], s[g1 + 1]);
    a[kb][3] = pack_bf16(s[g1 + 2], s[g1 + 3]);
  }
}

// the same as hi + lo fragments
__device__ __forceinline__ void a_frags_split(const float (&s)[32],
                                              uint32_t (&hi)[4][4],
                                              uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const int g0 = 8 * kb, g1 = 8 * kb + 4;
    split_bf16(s[g0], s[g0 + 1], hi[kb][0], lo[kb][0]);
    split_bf16(s[g0 + 2], s[g0 + 3], hi[kb][1], lo[kb][1]);
    split_bf16(s[g1], s[g1 + 1], hi[kb][2], lo[kb][2]);
    split_bf16(s[g1 + 2], s[g1 + 3], hi[kb][3], lo[kb][3]);
  }
}

// d (64 x 64) = A (64 rows of tile a) · B (64 rows of tile b)ᵀ over HD
// columns, both K-major in shared memory (swizzled, 64-row column blocks)
template <int HD>
__device__ __forceinline__ void nt_product(float (&d)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t off = (ks >> 2) * TILE_ROWS * 128 + (ks & 3) * 32;
    wgmma_ss_n64(d, desc_sw128(a + off, 16, 1024),
                 desc_sw128(b + off, 16, 1024), ks > 0);
  }
}

// d (64 x HDP) += A (bf16 fragments, 64 x 64) · tile b (64 rows x HDP,
// MN-major B)
template <int HDP>
__device__ __forceinline__ void nn_product(float (&d)[HDP / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
    wgmma_pv<HDP>(d, a[kb],
                  desc_sw128(b + kb * 16 * 128, TILE_ROWS * 128, 1024));
}

// Store a thread's rows r0 and r0 + 8 of a 64 x HDP accumulator times
// `mul` (columns < HD) as bf16 pairs, or as float32 pairs when f32 is
// given; row r lives at dst + r * stride; rows at or past `valid` skipped.
template <int HD, int HDP>
__device__ __forceinline__ void store_rows(const float (&acc)[HDP / 2],
                                           bf16* dst, float* f32,
                                           size_t stride, int r0, int c2,
                                           int valid, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= valid) continue;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      const float a = acc[4 * jj + 2 * half] * mul;
      const float b = acc[4 * jj + 2 * half + 1] * mul;
      const size_t off = r * stride + 8 * jj + c2;
      if (f32 != nullptr)
        *reinterpret_cast<float2*>(f32 + off) = make_float2(a, b);
      else
        *reinterpret_cast<uint32_t*>(dst + off) = pack_bf16(a, b);
    }
  }
}

// 1. (LSE, D) a row.  TPR threads a row, one 16-byte vector each.
template <int HD>
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const bf16* __restrict__ out,
                      const bf16* __restrict__ out_lo,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      float2* __restrict__ stats, int Sq, int Sq_pad, int Hq,
                      int n_rows) {
  constexpr int TPR = HD / 8;
  const int row = blockIdx.x * (256 / TPR) + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const bool live = row < n_rows;
  const int r = row % Sq_pad, bh = row / Sq_pad;  // stats row (b·Hq + h, r)
  float s = 0.f;
  if (live && r < Sq) {
    const int h = bh % Hq, b = bh / Hq;
    const size_t off = (((size_t)b * Sq + r) * Hq + h) * HD + 8 * lane;
    const uint4 o = *reinterpret_cast<const uint4*>(out + off);
    const uint4 l = *reinterpret_cast<const uint4*>(out_lo + off);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&l);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fo = __bfloat1622float2(o2[i]);
      const float2 fl = __bfloat1622float2(l2[i]);
      const float2 fg = __bfloat1622float2(g2[i]);
      s = fmaf(fo.x + fl.x, fg.x, s);             // out + out_lo is exact
      s = fmaf(fo.y + fl.y, fg.y, s);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (live && lane == 0)
    stats[row] = make_float2(r < Sq ? lse[(size_t)bh * Sq + r] : 0.f, s);
}

// 2. dK and dV of 64 keys over hps query heads
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::BLOCKS_PER_SM)
attn_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tmQ,
                        const __grid_constant__ CUtensorMap tmK,
                        const __grid_constant__ CUtensorMap tmV,
                        const __grid_constant__ CUtensorMap tmG,
                        const float2* __restrict__ stats,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        float* __restrict__ partial, int Sq, int Sq_pad,
                        int Skv, int Hq, int Hkv, int nsplit, float scale,
                        float scale_log2, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int NCB = C::NCB, HO = C::HO, NA = HO / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + C::TILE;
  const uint32_t sRing = base + 2 * C::TILE;       // stage s: Q, then dO
  const uint32_t sStats = base + (2 + 2 * STAGES) * C::TILE;
  const uint32_t barKV = base + C::KV_BAR;         // then full[0..STAGES)
  const float2* stats_s =
      reinterpret_cast<const float2*>(smem_raw + (sStats - raw));

  const int kt = blockIdx.y;                       // heaviest (causal) first
  const int groups = Hkv * nsplit;
  const int b = blockIdx.x / groups, hs = blockIdx.x % groups;
  const int hk = hs / nsplit, split = hs % nsplit;
  const int hps = Hq / Hkv / nsplit;               // query heads a block
  const int h_first = hk * (Hq / Hkv) + split * hps;
  const int k0 = kt * TILE_ROWS, k_last = min(k0 + TILE_ROWS, Skv) - 1;
  // warpgroup wg owns output columns wg·HO..; with one warpgroup these
  // are constants, so the code of HD ≤ 128 is that of a one-group block
  const int t = threadIdx.x, lane = t & 31;
  const int warp = C::NWG == 1 ? t >> 5 : (t >> 5) & 3;
  const int wg = C::NWG == 1 ? 0 : t >> 7;
  const uint32_t col_off = wg * (HO / 64) * TILE_ROWS * 128;
  const int kr0 = k0 + 16 * warp + (lane >> 2), kr1 = kr0 + 8;
  const int c2 = 2 * (lane & 3);

  // the q tiles whose rows meet keys [k0, k_last]; iteration it visits
  // head h_first + it / n_qt, q tile qt_begin + it % n_qt
  const int qt_begin = causal ? k0 / TILE_ROWS : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
  const int n_qt = max(0, (q_end + TILE_ROWS - 1) / TILE_ROWS - qt_begin);
  const int n_it = hps * n_qt;

  auto sQ_of = [&](int it) { return sRing + 2 * (it % STAGES) * C::TILE; };
  auto full_of = [&](int it) { return barKV + 8 + 8 * (it % STAGES); };
  auto load_qg = [&](int it) {                     // one thread issues it
    const int h = h_first + it / n_qt;
    const int q0 = (qt_begin + it % n_qt) * TILE_ROWS;
    const uint32_t sQ = sQ_of(it), bar = full_of(it);
    mbar_expect(bar, 2 * C::TILE + C::STATS);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load(sQ + cb * TILE_ROWS * 128, &tmQ, bar, 64 * cb, h, q0, b);
      tma_load(sQ + C::TILE + cb * TILE_ROWS * 128, &tmG, bar, 64 * cb, h,
               q0, b);
    }
    bulk_load(sStats + (it % STAGES) * C::STATS,
              stats + ((size_t)b * Hq + h) * Sq_pad + q0, C::STATS, bar);
  };
  if (t == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(barKV + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect(barKV, 2 * C::TILE);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load(sK + cb * TILE_ROWS * 128, &tmK, barKV, 64 * cb, hk, k0, b);
      tma_load(sV + cb * TILE_ROWS * 128, &tmV, barKV, 64 * cb, hk, k0, b);
    }
    for (int it = 0; it < n_it && it < STAGES; ++it) load_qg(it);
  }

  float dka[NA], dva[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(barKV, 0);

  for (int it = 0; it < n_it; ++it) {
    mbar_wait(full_of(it), (it / STAGES) & 1);
    const int q0 = (qt_begin + it % n_qt) * TILE_ROWS;
    const uint32_t sQ = sQ_of(it), sG = sQ + C::TILE;
    const float2* st = stats_s + (it % STAGES) * TILE_ROWS;

    // Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ, as two groups
    float s[32], dp[32];
    wgmma_fence();
    nt_product<HD>(s, sK, sQ);
    wgmma_commit();
    nt_product<HD>(dp, sV, sG);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // Pᵀ = 2^(x − LSE) of column (query) c, zero where masked; a thread
    // holds keys kr0 (registers 4jj + e) and kr1 (4jj + 2 + e) of columns
    // 8jj + c2 + e
    const bool edge = (causal && q0 < k0 + TILE_ROWS - 1) ||
                      (window > 0 && q0 + TILE_ROWS - 1 - k0 >= window) ||
                      k0 + TILE_ROWS > Skv || q0 + TILE_ROWS > Sq;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + c2 + e;
        const float L = st[c].x;
        float p0 = fast_exp2(s[4 * jj + e] * scale_log2 - L);
        float p1 = fast_exp2(s[4 * jj + 2 + e] * scale_log2 - L);
        if (edge) {
          p0 = keep(q0 + c, kr0, Sq, Skv, causal, window) ? p0 : 0.f;
          p1 = keep(q0 + c, kr1, Sq, Skv, causal, window) ? p1 : 0.f;
        }
        s[4 * jj + e] = p0;
        s[4 * jj + 2 + e] = p1;
      }
    }
    uint32_t pa[4][4];
    a_frags(s, pa);
    wgmma_wait<0>();
    fence_regs(dp);

    // dV += Pᵀ·dO (Pᵀ plain bf16), and meanwhile dSᵀ = Pᵀ ⊙ (dPᵀ − D)
    wgmma_fence();
    fence_regs(dva);
    nn_product<HO>(dva, pa, sG + col_off);
    wgmma_commit();
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float D = st[8 * jj + c2 + e].y;
        dp[4 * jj + e] = s[4 * jj + e] * (dp[4 * jj + e] - D);
        dp[4 * jj + 2 + e] = s[4 * jj + 2 + e] * (dp[4 * jj + 2 + e] - D);
      }
    }
    uint32_t da[4][4];
    a_frags(dp, da);

    // dK += dSᵀ·Q (dSᵀ plain bf16)
    wgmma_fence();
    fence_regs(dka);
    nn_product<HO>(dka, da, sQ + col_off);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(da);

    // the stage is consumed: refill it with iteration it + STAGES
    __syncthreads();
    if (t == 0 && it + STAGES < n_it) load_qg(it + STAGES);
  }

  const size_t stride = (size_t)Hkv * HD;
  const size_t off = ((size_t)b * Skv + k0) * Hkv * HD + (size_t)hk * HD +
                     (size_t)wg * C::HS;
  const int r0 = 16 * warp + (lane >> 2), valid = Skv - k0;
  if (nsplit == 1) {
    store_rows<C::HS, HO>(dka, dk + off, nullptr, stride, r0, c2, valid,
                          scale);
    store_rows<C::HS, HO>(dva, dv + off, nullptr, stride, r0, c2, valid,
                          1.f);
  } else {
    const size_t n = (size_t)gridDim.x / groups * Skv * stride;  // dK's size
    store_rows<C::HS, HO>(dka, nullptr, partial + split * n + off, stride,
                          r0, c2, valid, scale);
    store_rows<C::HS, HO>(dva, nullptr, partial + (nsplit + split) * n + off,
                          stride, r0, c2, valid, 1.f);
  }
}

// 3. dK and dV from their nsplit float32 partials, summed in split order:
// element i of the 2n (dK's n, then dV's), 4 a thread
__global__ void __launch_bounds__(256)
attn_bwd_sum_kernel(const float* __restrict__ partial, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int nsplit, size_t n) {
  size_t i = ((size_t)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  if (is_v) i -= n;
  const float* src = partial + (is_v ? (size_t)nsplit * n : 0) + i;
  float4 a = *reinterpret_cast<const float4*>(src);
  for (int sp = 1; sp < nsplit; ++sp) {
    const float4 p = *reinterpret_cast<const float4*>(src + sp * n);
    a.x += p.x;
    a.y += p.y;
    a.z += p.z;
    a.w += p.w;
  }
  *reinterpret_cast<uint2*>((is_v ? dv : dk) + i) =
      make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
}

// 4. dQ of 64 query rows
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::BLOCKS_PER_SM)
attn_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tmQ,
                      const __grid_constant__ CUtensorMap tmK,
                      const __grid_constant__ CUtensorMap tmV,
                      const __grid_constant__ CUtensorMap tmG,
                      const float2* __restrict__ stats, bf16* __restrict__ dq,
                      int Sq, int Sq_pad, int Skv, int Hq, int Hkv,
                      float scale, float scale_log2, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int NCB = C::NCB, HO = C::HO, NA = HO / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sG = base + C::TILE;
  const uint32_t sRing = base + 2 * C::TILE;       // stage s: K, then V
  const uint32_t barQ = base + C::Q_BAR;           // then full[0..STAGES)

  const int n_qtiles = (Sq + TILE_ROWS - 1) / TILE_ROWS;
  const int qt = causal ? n_qtiles - 1 - blockIdx.y : blockIdx.y;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * TILE_ROWS, q_last = min(q0 + TILE_ROWS, Sq) - 1;
  // warpgroup wg owns output columns wg·HO..; with one warpgroup these
  // are constants, so the code of HD ≤ 128 is that of a one-group block
  const int t = threadIdx.x, lane = t & 31;
  const int warp = C::NWG == 1 ? t >> 5 : (t >> 5) & 3;
  const int wg = C::NWG == 1 ? 0 : t >> 7;
  const uint32_t col_off = wg * (HO / 64) * TILE_ROWS * 128;
  const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  const int c2 = 2 * (lane & 3);

  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int kt_begin = k_begin / TILE_ROWS;
  const int kt_end = (k_end + TILE_ROWS - 1) / TILE_ROWS;

  auto sK_of = [&](int kt) {
    return sRing + 2 * ((kt - kt_begin) % STAGES) * C::TILE;
  };
  auto full_of = [&](int kt) {
    return barQ + 8 + 8 * ((kt - kt_begin) % STAGES);
  };
  auto load_kv = [&](int kt) {                     // one thread issues it
    const uint32_t sK = sK_of(kt), bar = full_of(kt);
    mbar_expect(bar, 2 * C::TILE);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load(sK + cb * TILE_ROWS * 128, &tmK, bar, 64 * cb, hk,
               kt * TILE_ROWS, b);
      tma_load(sK + C::TILE + cb * TILE_ROWS * 128, &tmV, bar, 64 * cb, hk,
               kt * TILE_ROWS, b);
    }
  };
  if (t == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(barQ + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect(barQ, 2 * C::TILE);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load(sQ + cb * TILE_ROWS * 128, &tmQ, barQ, 64 * cb, h, q0, b);
      tma_load(sG + cb * TILE_ROWS * 128, &tmG, barQ, 64 * cb, h, q0, b);
    }
    for (int kt = kt_begin; kt < kt_end && kt < kt_begin + STAGES; ++kt)
      load_kv(kt);
  }
  // this thread's rows' (LSE, D); rows past Sq read the zeros of the pad
  const float2* srow = stats + ((size_t)b * Hq + h) * Sq_pad;
  const float2 st0 = srow[r0], st1 = srow[r1];

  float dqa[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dqa[i] = 0.f;
  mbar_wait(barQ, 0);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    mbar_wait(full_of(kt), ((kt - kt_begin) / STAGES) & 1);
    const uint32_t sK = sK_of(kt), sV = sK + C::TILE;
    const int k0 = kt * TILE_ROWS;

    // S = Q·Kᵀ, then dP = dO·Vᵀ, as two groups
    float s[32], dp[32];
    wgmma_fence();
    nt_product<HD>(s, sQ, sK);
    wgmma_commit();
    nt_product<HD>(dp, sG, sV);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P = 2^(x − LSE), zero where masked: rows r0 (registers 4jj + e) and
    // r1 (4jj + 2 + e), keys k0 + 8jj + c2 + e
    const bool edge = (causal && k0 + TILE_ROWS - 1 > q0) ||
                      (window > 0 && k0 <= q_last - window) ||
                      k0 + TILE_ROWS > Skv;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = fast_exp2(s[4 * jj + e] * scale_log2 - st0.x);
        float p1 = fast_exp2(s[4 * jj + 2 + e] * scale_log2 - st1.x);
        if (edge) {
          const int kp = k0 + 8 * jj + c2 + e;
          p0 = keep(r0, kp, Sq, Skv, causal, window) ? p0 : 0.f;
          p1 = keep(r1, kp, Sq, Skv, causal, window) ? p1 : 0.f;
        }
        s[4 * jj + e] = p0;
        s[4 * jj + 2 + e] = p1;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P ⊙ (dP − D) in float32; dQ += dS_hi·K + dS_lo·K
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * jj + e] = s[4 * jj + e] * (dp[4 * jj + e] - st0.y);
        dp[4 * jj + 2 + e] = s[4 * jj + 2 + e] * (dp[4 * jj + 2 + e] - st1.y);
      }
    }
    uint32_t dsh[4][4], dsl[4][4];
    a_frags_split(dp, dsh, dsl);
    wgmma_fence();
    fence_regs(dqa);
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const uint64_t db =
          desc_sw128(sK + col_off + kb * 16 * 128, TILE_ROWS * 128, 1024);
      wgmma_pv<HO>(dqa, dsh[kb], db);
      wgmma_pv<HO>(dqa, dsl[kb], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(dsh);
    fence_regs(dsl);

    // the stage is consumed: refill it with tile kt + STAGES
    __syncthreads();
    if (t == 0 && kt + STAGES < kt_end) load_kv(kt + STAGES);
  }

  store_rows<C::HS, HO>(dqa,
                        dq + (((size_t)b * Sq + q0) * Hq + h) * HD +
                            (size_t)wg * C::HS,
                        nullptr, (size_t)Hq * HD, 16 * warp + (lane >> 2),
                        c2, Sq - q0, scale);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* out_lo, const void* dout, const float* lse, void* dq,
           void* dk, void* dv, float2* stats, float* partial, int B, int Sq,
           int Skv, int Hq, int Hkv, float scale, int causal, int window,
           int nsplit, cudaStream_t s) {
  using C = Cfg<HD>;
  auto dkdv = attn_bwd_dkdv_tc_kernel<HD>;
  auto dqk = attn_bwd_dq_tc_kernel<HD>;
  static const int attr = [&] {
    int e = set_smem(dkdv, C::KV_BYTES);
    if (!e) e = set_smem(dqk, C::Q_BYTES);
    return e;
  }();
  if (attr) return attr;
  if (out_lo == nullptr || lse == nullptr || nsplit < 1 ||
      (Hq / Hkv) % nsplit || (nsplit > 1) != (partial != nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tg;
  int err = tensor_map(&tq, q, B, Sq, Hq, HD, TILE_ROWS);
  if (!err) err = tensor_map(&tk, k, B, Skv, Hkv, HD, TILE_ROWS);
  if (!err) err = tensor_map(&tv, v, B, Skv, Hkv, HD, TILE_ROWS);
  if (!err) err = tensor_map(&tg, dout, B, Sq, Hq, HD, TILE_ROWS);
  if (err) return err;
  const int Sq_pad = (Sq + TILE_ROWS - 1) / TILE_ROWS * TILE_ROWS;
  const int n_rows = B * Hq * Sq_pad;
  constexpr int RPB = 256 / (HD / 8);
  attn_bwd_delta_kernel<HD><<<(n_rows + RPB - 1) / RPB, 256, 0, s>>>(
      (const bf16*)out, (const bf16*)out_lo, (const bf16*)dout, lse, stats,
      Sq, Sq_pad, Hq, n_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * LOG2E;
  const dim3 kgrid(B * Hkv * nsplit, (Skv + TILE_ROWS - 1) / TILE_ROWS);
  dkdv<<<kgrid, C::THREADS, C::KV_BYTES, s>>>(
      tq, tk, tv, tg, stats, (bf16*)dk, (bf16*)dv, partial, Sq, Sq_pad, Skv,
      Hq, Hkv, nsplit, scale, scale_log2, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (nsplit > 1) {
    const size_t n = (size_t)B * Skv * Hkv * HD;
    attn_bwd_sum_kernel<<<(unsigned)((2 * n / 4 + 255) / 256), 256, 0, s>>>(
        partial, (bf16*)dk, (bf16*)dv, nsplit, n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 qgrid(B * Hq, (Sq + TILE_ROWS - 1) / TILE_ROWS);
  dqk<<<qgrid, C::THREADS, C::Q_BYTES, s>>>(tq, tk, tv, tg, stats, (bf16*)dq,
                                         Sq, Sq_pad, Skv, Hq, Hkv, scale,
                                         scale_log2, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; body: 0 = CUDA cores, 1 = tensor
// cores.  The pairings taken are (float32, CUDA cores) and (bfloat16,
// tensor cores), each at hd 32, 64, 128 or 256; anything else returns
// cudaErrorInvalidValue.  q, k, v, out, dout, dq, dk, dv: that dtype,
// contiguous in the model layout, 16-byte aligned; Hq % Hkv == 0.
//   * CUDA cores, float32: out_lo, lse and partial null, nsplit 1; scratch
//     (2, B, Hq, Sq) float32 (LSE, then D).
//   * tensor cores: out_lo (out's shape) and lse (B, Hq, Sq) float32 from
//     the training forward; scratch (B, Hq, Sq_pad, 2) float32, Sq_pad =
//     Sq rounded up to 64; nsplit divides Hq / Hkv; partial (2, nsplit, B,
//     Skv, Hkv, hd) float32 when nsplit > 1, else null.
int mcsa_attention_bwd_launch(const void* q, const void* k, const void* v,
                              const void* out, const void* out_lo,
                              const void* dout, const float* lse, void* dq,
                              void* dk, void* dv, void* scratch,
                              float* partial, int B, int Sq, int Skv, int Hq,
                              int Hkv, int hd, float scale, int causal,
                              int window, int dtype, int body, int nsplit,
                              void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && body == 0) {
    if (out_lo != nullptr || lse != nullptr || partial != nullptr ||
        nsplit != 1)
      return (int)cudaErrorInvalidValue;
    return cc::launch_f32(hd, q, k, v, out, dout, dq, dk, dv,
                          (float*)scratch, B, Sq, Skv, Hq, Hkv, scale, causal,
                          window, s);
  }
  if (dtype == 1 && body == 1) {
    float2* stats = (float2*)scratch;
    switch (hd) {
      case 32:
        return tc::launch<32>(q, k, v, out, out_lo, dout, lse, dq, dk, dv,
                              stats, partial, B, Sq, Skv, Hq, Hkv, scale,
                              causal, window, nsplit, s);
      case 64:
        return tc::launch<64>(q, k, v, out, out_lo, dout, lse, dq, dk, dv,
                              stats, partial, B, Sq, Skv, Hq, Hkv, scale,
                              causal, window, nsplit, s);
      case 128:
        return tc::launch<128>(q, k, v, out, out_lo, dout, lse, dq, dk, dv,
                               stats, partial, B, Sq, Skv, Hq, Hkv, scale,
                               causal, window, nsplit, s);
      case 256:
        return tc::launch<256>(q, k, v, out, out_lo, dout, lse, dq, dk, dv,
                               stats, partial, B, Sq, Skv, Hq, Hkv, scale,
                               causal, window, nsplit, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a tensor-core block at head_dim hd: kernel 0 =
// dK/dV, 1 = dQ (bytes), or -1 for a pair that has no instance.
int mcsa_attention_bwd_smem(int hd, int kernel) {
  int kv = -1, qb = -1;
  switch (hd) {
    case 32: kv = tc::Cfg<32>::KV_BYTES; qb = tc::Cfg<32>::Q_BYTES; break;
    case 64: kv = tc::Cfg<64>::KV_BYTES; qb = tc::Cfg<64>::Q_BYTES; break;
    case 128: kv = tc::Cfg<128>::KV_BYTES; qb = tc::Cfg<128>::Q_BYTES; break;
    case 256: kv = tc::Cfg<256>::KV_BYTES; qb = tc::Cfg<256>::Q_BYTES; break;
  }
  return kernel == 0 ? kv : kernel == 1 ? qb : -1;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
