// Flash attention backward for Hopper (sm_90a): the gradients dq, dk, dv
// of the forward in csrc/flash_attention.cu (online-softmax GQA attention,
// causal and sliding-window masks) for an output gradient dout, in the
// model layout q (B, Sq, Hq, HD), k/v (B, Skv, Hkv, HD), HD 32, 64 or 128,
// float32 or bfloat16 in and out, float32 arithmetic throughout.
//
// The JAX package has no backward kernel: its train step differentiates
// the jnp flash_attention (src/repro/models/transformer.py:250) with XLA,
// and its forward kernel is flash_attention_tpu
// (src/repro/kernels/flash_attention/kernel.py:98).  The port's model
// reaches the forward through its CUDA kernel, so the backward of that
// call is this file: FA-2's algorithm, on the CUDA cores.
//
// The softmax statistics are recomputed, not taken from the forward: the
// forward's output bits stay what the inference path has always had, and
// its kernel stays as it is.  Three launches, no atomics, so two runs on
// the same inputs give the same bits:
//   1. prep: grid (q tiles, Hq, B).  LSE = m + log(l) of each q row over
//      the keys its masks leave (the forward's online softmax without the
//      P·V product), and D = rowsum(dout ⊙ out), both float32 (B, Hq, Sq).
//   2. dkdv: grid (kv tiles, Hkv, B).  A block holds its 64 keys' K and V
//      and walks the Hq/Hkv query heads of its group and, for each, the q
//      tiles of the causal/window band: P = exp(scale·q·k − LSE), dV +=
//      Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − D), dK += dSᵀ·Q; the whole
//      group's contributions are summed in registers and stored once
//      (dK times scale).
//   3. dq: grid (q tiles, Hq, B).  A block holds its 64 query rows' Q,
//      dO, LSE and D and walks the band's kv tiles: dQ += dS·K (times
//      scale at the end).
// Semantics kept from the forward (and so from attention_ref): q position
// i aligns with key i (the caller refuses causal Sq != Skv); a pair is
// kept when k < Skv and, if causal, q >= k and, with a window, q - k <
// window; rows past Sq and keys past Skv are zeros and get p = 0.
//
// Bound: operations.  The masks' pairs times 2.5x the forward's 4·HD
// flops (chip_smoke.py counts it so); this first design spends about 16·HD
// flops a pair (two recomputed score products and the four gradient
// products), in float32 on the CUDA cores, so it sits far from the bf16
// tensor-core bound.  Speed is later work (ROADMAP: wgmma and TMA, as the
// forward's tensor-core body).
//
// Layout of a block: 256 threads as 16 x 16 (ty, tx).  A 64 x 64 score
// tile gives thread (ty, tx) rows ty + 16a and columns tx + 16b (a, b <
// 4); a 64 x HD accumulator gives it rows ty + 16a and VW-wide column
// groups VW·tx + 16·VW·e (VW = 4, or 2 at HD 32).  Tiles live in shared
// memory as float32 with a row pitch of HD + 4 (q, k, v, dout) or 80 (the
// P / dS tile), which keeps the reads below free of bank conflicts.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launches
// go on the caller's stream and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;          // q rows a tile
constexpr int BK = 64;          // keys a tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int PS = 80;          // pitch of the P / dS tile

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

// 4 consecutive elements of src as floats (src 8- or 16-byte aligned)
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Copy `rows` rows of one head (HD elements each, `stride` elements apart)
// into shared memory as float32 with row pitch HD + 4; rows at or past
// `valid` are zeros.
template <typename T, int HD>
__device__ void load_tile(float* dst, const T* src, size_t stride, int rows,
                          int valid) {
  constexpr int P = HD + 4, PER_ROW = HD / 4;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = load4(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * P + c) = val;
  }
}

// s[a][b] = sum_d A[ty + 16a][d] * B[tx + 16b][d] (A, B: pitch HD + 4)
template <int HD>
__device__ __forceinline__ void nt_tile(float (&s)[4][4],
                                        const float* __restrict__ A,
                                        const float* __restrict__ B, int ty,
                                        int tx) {
  constexpr int P = HD + 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = load4(A + (ty + 16 * a) * P + d);
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = load4(B + (tx + 16 * b) * P + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
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

// acc[a][..] += sum_k M(ty + 16a, k) * B[k][cols of tx], k over 64: M(r, k)
// is Ms[k * PS + r] when TRANS (Pᵀ or dSᵀ: r is a key) and Ms[r * PS + k]
// otherwise (dS: r is a q row); B has pitch HD + 4.
template <int HD, bool TRANS>
__device__ __forceinline__ void acc_tile(float (&acc)[4][Acc<HD>::NC],
                                         const float* __restrict__ Ms,
                                         const float* __restrict__ B,
                                         int ty, int tx) {
  using C = Acc<HD>;
  constexpr int P = HD + 4;
#pragma unroll 2
  for (int k = 0; k < 64; ++k) {
    float m[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
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
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < C::VW; ++j)
          acc[a][e * C::VW + j] = fmaf(m[a], bv[j], acc[a][e * C::VW + j]);
    }
  }
}

// Store 4 rows (ty + 16a) of an accumulator times `mul` to dst (row r at
// dst + r * stride), rows at or past `valid` skipped.
template <typename T, int HD>
__device__ __forceinline__ void store_acc(const float (&acc)[4][Acc<HD>::NC],
                                          T* dst, size_t stride, int valid,
                                          float mul, int ty, int tx) {
  using C = Acc<HD>;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (r >= valid) continue;
#pragma unroll
    for (int e = 0; e < C::NG; ++e)
#pragma unroll
      for (int j = 0; j < C::VW; ++j)
        dst[r * stride + C::col(tx, e) + j] =
            from_f<T>(acc[a][e * C::VW + j] * mul);
  }
}

__device__ __forceinline__ bool keep(int qp, int kp, int Sq, int Skv,
                                     int causal, int window) {
  bool ok = qp < Sq && kp < Skv;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

// The kv tiles [kt_begin, kt_end) that q rows [q0, q_last] meet.
__device__ __forceinline__ void kv_band(int q0, int q_last, int Skv,
                                        int causal, int window,
                                        int& kt_begin, int& kt_end) {
  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  kt_begin = k_begin / BK;
  kt_end = (k_end + BK - 1) / BK;
}

// ---------------------------------------------------------------------
// 1. LSE and D
// ---------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_prep(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ out, const T* __restrict__ dout,
              float* __restrict__ lse, float* __restrict__ delta, int Sq,
              int Skv, int Hq, int Hkv, float scale, int causal,
              int window) {
  constexpr int P = HD + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * P;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t q_stride = (size_t)Hq * HD, kv_stride = (size_t)Hkv * HD;
  const size_t q_off = (((size_t)b * Sq + q0) * Hq + h) * HD;
  const size_t row0 = ((size_t)b * Hq + h) * Sq + q0;   // into lse / delta

  // D: 4 threads a row, HD / 4 columns each
  {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    float s = 0.f;
    if (q0 + r < Sq) {
      const T* o = out + q_off + r * q_stride;
      const T* g = dout + q_off + r * q_stride;
      for (int c = part * 4; c < HD; c += 16) {
        const float4 ov = load4(o + c), gv = load4(g + c);
        s += ov.x * gv.x + ov.y * gv.y + ov.z * gv.z + ov.w * gv.w;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0 && q0 + r < Sq) delta[row0 + r] = s;
  }

  load_tile<T, HD>(Qs, q + q_off, q_stride, BQ, Sq - q0);
  int kt_begin, kt_end;
  kv_band(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window, kt_begin, kt_end);
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                       // previous K tile consumed
    load_tile<T, HD>(Ks, k + (((size_t)b * Skv + k0) * Hkv + hk) * HD,
                     kv_stride, BK, Skv - k0);
    __syncthreads();
    float s[4][4];
    nt_tile<HD>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q0 + ty + 16 * a;
      float mt = NEG_INF;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
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
      for (int bb = 0; bb < 4; ++bb)
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
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      if (q0 + r < Sq) lse[row0 + r] = m[a] + logf(fmaxf(l[a], 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------
// 2. dK and dV
// ---------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
              int Hq, int Hkv, float scale, int causal, int window) {
  using C = Acc<HD>;
  constexpr int P = HD + 4;
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
  load_tile<T, HD>(Ks, k + kv_off, kv_stride, BK, Skv - k0);
  load_tile<T, HD>(Vs, v + kv_off, kv_stride, BK, Skv - k0);

  // the q tiles whose rows meet keys [k0, k_last]
  const int k_last = min(k0 + BK, Skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
  const int qt_begin = q_begin / BQ, qt_end = (q_end + BQ - 1) / BQ;

  float dka[4][C::NC], dva[4][C::NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < C::NC; ++c) dka[a][c] = dva[a][c] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      const size_t q_off = (((size_t)b * Sq + q0) * Hq + h) * HD;
      const size_t row0 = ((size_t)b * Hq + h) * Sq + q0;
      __syncthreads();                     // the last tiles are consumed
      load_tile<T, HD>(Qs, q + q_off, q_stride, BQ, Sq - q0);
      load_tile<T, HD>(Gs, dout + q_off, q_stride, BQ, Sq - q0);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool in = q0 + i < Sq;
        Ls[i] = in ? lse[row0 + i] : 0.f;
        Ds[i] = in ? delta[row0 + i] : 0.f;
      }
      __syncthreads();
      float p[4][4], dp[4][4];
      nt_tile<HD>(p, Qs, Ks, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int c = tx + 16 * bb;
          const bool ok = keep(q0 + r, k0 + c, Sq, Skv, causal, window);
          p[a][bb] = ok ? expf(p[a][bb] * scale - Ls[r]) : 0.f;
          Ps[r * PS + c] = p[a][bb];
        }
      }
      nt_tile<HD>(dp, Gs, Vs, ty, tx);
      __syncthreads();                     // P is whole
      acc_tile<HD, true>(dva, Ps, Gs, ty, tx);
      __syncthreads();                     // P is read: dS takes its place
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          Ps[r * PS + tx + 16 * bb] = p[a][bb] * (dp[a][bb] - Ds[r]);
      }
      __syncthreads();
      acc_tile<HD, true>(dka, Ps, Qs, ty, tx);
    }
  }
  store_acc<T, HD>(dka, dk + kv_off, kv_stride, Skv - k0, scale, ty, tx);
  store_acc<T, HD>(dva, dv + kv_off, kv_stride, Skv - k0, 1.f, ty, tx);
}

// ---------------------------------------------------------------------
// 3. dQ
// ---------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv,
            float scale, int causal, int window) {
  using C = Acc<HD>;
  constexpr int P = HD + 4;
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
  load_tile<T, HD>(Qs, q + q_off, q_stride, BQ, Sq - q0);
  load_tile<T, HD>(Gs, dout + q_off, q_stride, BQ, Sq - q0);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const bool in = q0 + i < Sq;
    Ls[i] = in ? lse[row0 + i] : 0.f;
    Ds[i] = in ? delta[row0 + i] : 0.f;
  }
  int kt_begin, kt_end;
  kv_band(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window, kt_begin, kt_end);

  float dqa[4][C::NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < C::NC; ++c) dqa[a][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const size_t kv_off = (((size_t)b * Skv + k0) * Hkv + hk) * HD;
    __syncthreads();                       // the last K and dS are consumed
    load_tile<T, HD>(Ks, k + kv_off, kv_stride, BK, Skv - k0);
    load_tile<T, HD>(Vs, v + kv_off, kv_stride, BK, Skv - k0);
    __syncthreads();
    float s[4][4], dp[4][4];
    nt_tile<HD>(s, Qs, Ks, ty, tx);
    nt_tile<HD>(dp, Gs, Vs, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int c = tx + 16 * bb;
        const bool ok = keep(q0 + r, k0 + c, Sq, Skv, causal, window);
        const float pv = ok ? expf(s[a][bb] * scale - Ls[r]) : 0.f;
        Ps[r * PS + c] = pv * (dp[a][bb] - Ds[r]);
      }
    }
    __syncthreads();
    acc_tile<HD, false>(dqa, Ps, Ks, ty, tx);
  }
  store_acc<T, HD>(dqa, dq + q_off, q_stride, Sq - q0, scale, ty, tx);
}

template <int HD>
constexpr size_t prep_smem() {
  return sizeof(float) * (size_t)(BQ + BK) * (HD + 4);
}
template <int HD>
constexpr size_t grad_smem() {
  return sizeof(float) *
         ((size_t)(2 * BQ + 2 * BK) * (HD + 4) + BQ * PS + 2 * BQ);
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int B, int Sq, int Skv, int Hq, int Hkv,
           float scale, int causal, int window, cudaStream_t s) {
  auto prep = attn_bwd_prep<T, HD>;
  auto dkdv = attn_bwd_dkdv<T, HD>;
  auto dqk = attn_bwd_dq<T, HD>;
  static const int attr = [&] {
    int e = set_smem(prep, prep_smem<HD>());
    if (!e) e = set_smem(dkdv, grad_smem<HD>());
    if (!e) e = set_smem(dqk, grad_smem<HD>());
    return e;
  }();
  if (attr) return attr;
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v;
  const dim3 qgrid((Sq + BQ - 1) / BQ, Hq, B), kgrid((Skv + BK - 1) / BK, Hkv,
                                                     B);
  prep<<<qgrid, THREADS, prep_smem<HD>(), s>>>(
      tq, tk, (const T*)out, (const T*)dout, lse, delta, Sq, Skv, Hq, Hkv,
      scale, causal, window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv<<<kgrid, THREADS, grad_smem<HD>(), s>>>(
      tq, tk, tv, (const T*)dout, lse, delta, (T*)dk, (T*)dv, Sq, Skv, Hq,
      Hkv, scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dqk<<<qgrid, THREADS, grad_smem<HD>(), s>>>(
      tq, tk, tv, (const T*)dout, lse, delta, (T*)dq, Sq, Skv, Hq, Hkv,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* out, const void* dout, void* dq, void* dk, void* dv,
              float* lse, float* delta, int B, int Sq, int Skv, int Hq,
              int Hkv, float scale, int causal, int window, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, Sq,
                           Skv, Hq, Hkv, scale, causal, window, s);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, Sq,
                           Skv, Hq, Hkv, scale, causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, dq, dk, dv, lse, delta, B,
                            Sq, Skv, Hq, Hkv, scale, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv all of
// it); all contiguous in the model layout, 16-byte aligned; Hq % Hkv == 0;
// hd in {32, 64, 128}.  lse, delta: (B, Hq, Sq) float32 scratch.
int mcsa_attention_bwd_launch(const void* q, const void* k, const void* v,
                              const void* out, const void* dout, void* dq,
                              void* dk, void* dv, float* lse, float* delta,
                              int B, int Sq, int Skv, int Hq, int Hkv,
                              int hd, float scale, int causal, int window,
                              int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, out, dout, dq, dk, dv, lse, delta, B,
                            Sq, Skv, Hq, Hkv, scale, causal, window, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, dout, dq, dk, dv, lse,
                                    delta, B, Sq, Skv, Hq, Hkv, scale, causal,
                                    window, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
