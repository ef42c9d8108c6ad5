// Flash attention for Hopper (sm_90a): online-softmax GQA attention with
// causal and sliding-window masks, float32 accumulation, inputs and output
// in float32 or bfloat16, in the model layout q (B, Sq, Hq, HD),
// k/v (B, Skv, Hkv, HD), out (B, Sq, Hq, HD).
//
// Replaces the JAX package's TPU kernel flash_attention_tpu /
// _attn_kernel (src/repro/kernels/flash_attention/kernel.py).  The TPU
// kernel walks the kv blocks as a sequential grid axis and carries the
// softmax state (m, l, acc) in VMEM scratch; blocks of a CUDA grid run in
// no order, so here one block owns one (batch, q tile, q head) and walks
// its kv tiles in a loop, with the state in registers.
//
// Semantics kept from the TPU kernel, so both equal attention_ref:
//   * q position i aligns with k position i (the caller refuses causal
//     Sq != Skv);
//   * masked scores are NEG_INF = -1e30, not -inf: a row with no valid key
//     in a visited tile gets p = exp(0) = 1 there, which the first tile
//     with a valid key wipes out through corr = exp(-1e30 - m) = 0;
//   * k/v rows past Skv are loaded as zeros (0 * garbage would still
//     poison p @ v);
//   * kv tiles wholly outside the causal / window band are skipped;
//   * out = acc / max(l, 1e-30), scale applied to q.k before masking.
//
// Bound: at prefill shapes (S = 1024..2560, HD = 64..256) the causal or
// windowed FLOPs (4·B·Hq·HD per unmasked pair) over the card's bf16
// tensor-core rate bind, well above the bytes.  This first kernel is
// simple and right before it is fast: it computes with fp32 FMAs on CUDA
// cores, not on the tensor cores, so it sits far above that bound.  Design for the CUDA cores: 64 q rows x 32
// keys a tile, 128 threads, each thread owns 4 q rows x 4 keys of the
// score tile and 4 rows x HD/8 columns of the output; tiles sit in shared
// memory as float32 (row pitch HD+4 so that 16-byte reads by the 8 threads
// of a row group hit 8 different bank groups), read as float4.  The 8
// threads that share a q row are neighbouring lanes, so row max and row
// sum are three xor-shuffles.  Heavier causal q tiles are scheduled first.
// At HD 256 (recurrentgemma) a thread holds 4 x 32 = 128 float
// accumulators (226-232 registers, no spill) and a block 138.5 KiB of
// shared memory, inside the 227 KB opt-in: one block per SM.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 32;          // keys per tile
constexpr int THREADS = 128;    // 16 row groups x 8 lanes
constexpr int RPT = 4;          // q rows per thread
constexpr int KPT = 4;          // keys per thread (BK / 8)
constexpr int PS = BK + 4;      // pitch of the probability tile
constexpr float NEG_INF = -1e30f;

template <typename T> struct Ld;
template <> struct Ld<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store4(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <> struct Ld<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store4(__nv_bfloat16* p, const float* in) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(in[0], in[1]);
    h[1] = __floats2bfloat162_rn(in[2], in[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// Copy `rows` rows of one head (HD contiguous elements each, `stride`
// elements apart) into shared memory as float32 with row pitch `pitch`;
// rows at or past `valid` are zeros.
template <typename T, int HD>
__device__ void load_tile(float* dst, int pitch, const T* src, size_t stride,
                          int rows, int valid) {
  constexpr int N = Ld<T>::N;
  constexpr int PER_ROW = HD / N;
  for (int v = threadIdx.x; v < rows * PER_ROW; v += THREADS) {
    const int r = v / PER_ROW, c = (v % PER_ROW) * N;
    float buf[N];
    if (r < valid) {
      Ld<T>::load(src + r * stride + c, buf);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) buf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(dst + r * pitch + c + e) =
          make_float4(buf[e], buf[e + 1], buf[e + 2], buf[e + 3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int Sq, int Skv, int Hq, int Hkv, float scale,
                       int causal, int window) {
  constexpr int QP = HD + 4;           // pitch of the q and k tiles
  constexpr int NC = HD / 32;          // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* Ps = Vs + BK * HD;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blockIdx.x;          // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;

  const size_t q_stride = (size_t)Hq * HD, kv_stride = (size_t)Hkv * HD;
  load_tile<T, HD>(Qs, QP, q + (((size_t)b * Sq + q0) * Hq + h) * HD,
                   q_stride, BQ, Sq - q0);

  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int kt_begin = k_begin / BK, kt_end = (k_end + BK - 1) / BK;

  float m[RPT], l[RPT], acc[RPT][NC * 4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // previous tile fully consumed
    const size_t kv_off = (((size_t)b * Skv + k0) * Hkv + hk) * HD;
    load_tile<T, HD>(Ks, QP, k + kv_off, kv_stride, BK, Skv - k0);
    load_tile<T, HD>(Vs, HD, v + kv_off, kv_stride, BK, Skv - k0);
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (tr * RPT + i) * QP + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tc + 8 * j) * QP + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + tr * RPT + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = k0 + tc + 8 * j;
        bool ok = kpos < Skv && qpos < Sq;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(tr * RPT + i) * PS + tc + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (tr * RPT + i) * PS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (kk + e) * HD + 32 * c + 4 * tc);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y
                          : e == 2 ? p4[i].z : p4[i].w;
            acc[i][4 * c + 0] += p * vv.x;
            acc[i][4 * c + 1] += p * vv.y;
            acc[i][4 * c + 2] += p * vv.z;
            acc[i][4 * c + 3] += p * vv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + tr * RPT + i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * Sq + qpos) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = acc[i][4 * c + e] * inv;
      Ld<T>::store4(o + 32 * c + 4 * tc, r);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int Hq, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr int QP = HD + 4;
  constexpr size_t smem = sizeof(float) *
      (size_t)(BQ * QP + BK * QP + BK * HD + BQ * PS);
  auto kern = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B), block(THREADS);
  kern<<<grid, block, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, Hq, Hkv,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                float scale, int causal, int window, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, scale,
                                  causal, window, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, scale,
                                  causal, window, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, scale,
                                    causal, window, s);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Skv, Hq, Hkv, scale,
                                    causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous in the model
// layout; Hq % Hkv == 0; hd in {32, 64, 128, 256}.
int mcsa_flash_attention_launch(const void* q, const void* k, const void* v,
                                void* out, int B, int Sq, int Skv, int Hq,
                                int Hkv, int hd, float scale, int causal,
                                int window, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, Sq, Skv, Hq, Hkv, scale,
                              causal, window, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Skv, Hq, Hkv,
                                      scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
