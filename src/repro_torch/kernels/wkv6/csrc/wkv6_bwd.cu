// RWKV-6 WKV backward for Hopper (sm_90a): the gradients of the recurrence
// in csrc/wkv6.cu, per (batch, head) with head size N and state S (N x N,
// S[i][j] = S[k_dim i][v_dim j]),
//     y_t = S_{t-1}ᵀ r_t + v_t (r_t·(u ⊙ k_t)),
//     S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,   S_{-1} = s0 (or zero),
// for the output gradients dy (B, S, H, N) float32 and, optionally, ds
// (the final state's).  With Ĝ_t = ∂L/∂S_t carried backwards from
// Ĝ_{S-1} = ds (or zero):
//     Ĝ_{t-1} = diag(w_t) Ĝ_t + r_t dy_tᵀ
//     dr_t = S_{t-1} dy_t + u ⊙ k_t (v_t·dy_t)
//     dk_t = Ĝ_t v_t + u ⊙ r_t (v_t·dy_t)
//     dv_t = Ĝ_tᵀ k_t + (r_t·(u ⊙ k_t)) dy_t
//     dw_t = rowsum(Ĝ_t ⊙ S_{t-1})
//     du   = Σ_b Σ_t r_t ⊙ k_t (v_t·dy_t)      (per (b, h) here; the
//                                              wrapper sums over b)
//     ds0  = Ĝ_{-1}.
//
// What it replaces: no Pallas kernel.  The JAX package's train step
// differentiates its jnp wkv6_scan (src/repro/models/rwkv.py:95) with
// XLA; its forward kernel is wkv6_tpu (src/repro/kernels/wkv6/kernel.py:
// 66).  The port's model reaches the forward through its CUDA kernel, so
// the backward of that call is this file.
//
// No division by w and no log of w: the model's w reaches exactly 0 in
// float32 (exp(-e^10)) and 1 (exp(-e^-20)), so S_{t-1} cannot be undone
// from S_t, and dw cannot come from a cumulative log-decay.  The states
// the reverse walk needs come from re-running the recurrence forward.
//
// Design (the simple one that is right; serial in t): one block per
// (batch, head), 2N threads.
//   * Threads 0..N-1 are row threads: thread i holds row i of S and of Ĝ
//     in registers.  The recurrences of both rows are row-local, and so
//     are dr_t[i], dk_t[i] and dw_t[i] (sums over j of its own rows).
//   * Threads N..2N-1 are column threads: thread j holds column j of Ĝ,
//     whose recurrence is column-local too, and forms dv_t[j] (a sum over
//     i) without a cross-thread reduction.  Both halves update Ĝ with the
//     same float32 expression, so they hold the same values.
//   1. Forward walk: the row threads re-run the recurrence from s0 and
//      store S_{t-1} at every segment start (every SEG steps) to a float32
//      workspace (B·H, ceil(S/SEG), N, N), column-major so a warp's
//      stores are contiguous.
//   2. Reverse walk, segment by segment from the last: r, k, v, w and dy
//      of the segment's steps go to shared memory (every thread reads
//      them as broadcasts), SEG threads form the steps' v·dy and
//      r·(u ⊙ k); the row threads re-run the segment from its
//      checkpoint and keep each S_{t-1} in shared memory (rows padded to
//      N + 1 words: a warp's 32 rows hit 32 banks); then all threads walk
//      the segment's steps backwards.
//   Shared memory at N 64: SEG (8) states of 64 x 65 floats, 133 KB, and
//   the steps' vectors, 10 KB: one block an SM.  The workspace is N^2
//   floats every SEG steps: 335 MB at rwkv6-3b's training shape (B 4, S
//   1024, H 40).
// No atomics: each block owns its outputs and du's per-(b, h) partial, so
// two runs on the same inputs give the same bits.
//
// Bound: operations.  A step does about 8 operations a state element
// (the recompute's multiply-add, Ĝ's, and the four products over it:
// S·dy, Ĝ·v, Ĝᵀ·k, Ĝ ⊙ S), against the forward's 3; chip_smoke.py counts
// it so (OPS["wkv6_bwd"]).  The serial chain of S dependent steps a
// block, not the operations, sets this design's time; a chunked form on
// the tensor cores is later work (ROADMAP).
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 8;         // steps a segment (a checkpoint each)

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

template <int N>
constexpr size_t smem_bytes() {
  // states [SEG][N][N + 1], vectors [SEG][5][N], u [N], dots [2][SEG]
  return sizeof(float) *
         ((size_t)SEG * N * (N + 1) + (size_t)SEG * 5 * N + N + 2 * SEG);
}

// vector slots of a staged step
enum { VR = 0, VK = 1, VV = 2, VW = 3, VDY = 4 };

template <typename T, int N>
__global__ void __launch_bounds__(2 * N, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy, const float* __restrict__ ds,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, float* __restrict__ ckpt, int S,
                int H) {
  extern __shared__ float4 smem4[];
  float* states = reinterpret_cast<float*>(smem4);   // [SEG][N][N + 1]
  float* vec = states + SEG * N * (N + 1);           // [SEG][5][N]
  float* us = vec + SEG * 5 * N;                     // [N]
  float* dots = us + N;                              // v·dy, r·(u ⊙ k)

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const bool row = tid < N;
  const int i = row ? tid : tid - N;    // row i, or column j = i
  const int nseg = (S + SEG - 1) / SEG;
  float* ck = ckpt + (size_t)bh * nseg * N * N;
  const size_t step_stride = (size_t)H * N;
  const size_t head0 = ((size_t)b * S * H + h) * N;   // (b, 0, h, 0)

  if (tid < N) us[tid] = u[h * N + tid];

  // stage steps [t0, t0 + L) of the vectors in `slots` (a bit mask)
  auto stage = [&](int t0, int L, int slots) {
    for (int e = tid; e < L * 5 * N; e += 2 * N) {
      const int l = e / (5 * N), q = (e / N) % 5, c = e % N;
      if (!(slots >> q & 1)) continue;
      const size_t g = head0 + (size_t)(t0 + l) * step_stride + c;
      float x;
      switch (q) {
        case VR: x = to_f(r[g]); break;
        case VK: x = to_f(k[g]); break;
        case VV: x = to_f(v[g]); break;
        case VW: x = w[g]; break;
        default: x = dy[g]; break;
      }
      vec[(l * 5 + q) * N + c] = x;
    }
  };

  // 1. forward walk: checkpoints of S_{t-1} at every segment start
  float s[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    s[j] = (row && s0) ? s0[((size_t)bh * N + i) * N + j] : 0.f;
  for (int c = 0; c < nseg; ++c) {
    const int t0 = c * SEG, L = min(SEG, S - t0);
    __syncthreads();                     // the last segment's vectors read
    stage(t0, L, 1 << VK | 1 << VV | 1 << VW);
    __syncthreads();
    if (row) {
#pragma unroll
      for (int j = 0; j < N; ++j) ck[((size_t)c * N + j) * N + i] = s[j];
      for (int l = 0; l < L; ++l) {
        const float* vv = vec + (l * 5 + VV) * N;
        const float wi = vec[(l * 5 + VW) * N + i];
        const float ki = vec[(l * 5 + VK) * N + i];
#pragma unroll
        for (int j = 0; j < N; ++j) s[j] = fmaf(wi, s[j], ki * vv[j]);
      }
    }
  }

  // 2. reverse walk; G is row i of Ĝ (row threads) or column j (column
  // threads)
  float G[N];
#pragma unroll
  for (int x = 0; x < N; ++x)
    G[x] = ds ? (row ? ds[((size_t)bh * N + i) * N + x]
                     : ds[((size_t)bh * N + x) * N + i])
              : 0.f;
  float du_acc = 0.f;
  for (int c = nseg - 1; c >= 0; --c) {
    const int t0 = c * SEG, L = min(SEG, S - t0);
    __syncthreads();                     // the last segment is done with
    stage(t0, L, 0x1f);
    __syncthreads();
    if (tid < L) {
      const float* vr = vec + (tid * 5 + VR) * N;
      const float* vk = vec + (tid * 5 + VK) * N;
      const float* vv = vec + (tid * 5 + VV) * N;
      const float* vd = vec + (tid * 5 + VDY) * N;
      float vdy = 0.f, ruk = 0.f;
      for (int x = 0; x < N; ++x) {
        vdy = fmaf(vv[x], vd[x], vdy);
        ruk = fmaf(vr[x], us[x] * vk[x], ruk);
      }
      dots[tid] = vdy;
      dots[SEG + tid] = ruk;
    }
    if (row) {                           // the segment's S_{t-1}
#pragma unroll
      for (int j = 0; j < N; ++j) s[j] = ck[((size_t)c * N + j) * N + i];
      for (int l = 0; l < L; ++l) {
        float* st = states + ((size_t)l * N + i) * (N + 1);
        const float* vv = vec + (l * 5 + VV) * N;
        const float wi = vec[(l * 5 + VW) * N + i];
        const float ki = vec[(l * 5 + VK) * N + i];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          st[j] = s[j];
          s[j] = fmaf(wi, s[j], ki * vv[j]);
        }
      }
    }
    __syncthreads();                     // dots ready
    for (int l = L - 1; l >= 0; --l) {
      const size_t g = head0 + (size_t)(t0 + l) * step_stride + i;
      const float* vr = vec + (l * 5 + VR) * N;
      const float* vk = vec + (l * 5 + VK) * N;
      const float* vv = vec + (l * 5 + VV) * N;
      const float* vw = vec + (l * 5 + VW) * N;
      const float* vd = vec + (l * 5 + VDY) * N;
      if (row) {
        const float* st = states + ((size_t)l * N + i) * (N + 1);
        const float ri = vr[i], ki = vk[i], wi = vw[i], ui = us[i];
        const float vdy = dots[l];
        float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float sp = st[j], dj = vd[j];
          a_dr = fmaf(sp, dj, a_dr);
          a_dk = fmaf(G[j], vv[j], a_dk);
          a_dw = fmaf(G[j], sp, a_dw);
          G[j] = fmaf(wi, G[j], ri * dj);
        }
        dr[g] = from_f<T>(a_dr + ui * ki * vdy);
        dk[g] = from_f<T>(a_dk + ui * ri * vdy);
        dw[g] = a_dw;
        du_acc = fmaf(ri * ki, vdy, du_acc);
      } else {
        const float dj = vd[i], ruk = dots[SEG + l];
        float a_dv = 0.f;
#pragma unroll
        for (int x = 0; x < N; ++x) {
          a_dv = fmaf(G[x], vk[x], a_dv);
          G[x] = fmaf(vw[x], G[x], vr[x] * dj);
        }
        dv[g] = from_f<T>(a_dv + dj * ruk);
      }
    }
  }
  if (row) {
    du_part[(size_t)bh * N + i] = du_acc;
    if (ds0) {
#pragma unroll
      for (int j = 0; j < N; ++j) ds0[((size_t)bh * N + i) * N + j] = G[j];
    }
  }
}

template <typename T, int N>
int launch_n(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, const float* dy,
             const float* ds, void* dr, void* dk, void* dv, float* dw,
             float* du_part, float* ds0, float* ckpt, int B, int S, int H,
             cudaStream_t st) {
  auto kern = wkv6_bwd_kernel<T, N>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<N>());
  if (attr != cudaSuccess) return (int)attr;
  kern<<<B * H, 2 * N, smem_bytes<N>(), st>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, dy, ds, (T*)dr,
      (T*)dk, (T*)dv, dw, du_part, ds0, ckpt, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, const float* dy, const float* ds,
           void* dr, void* dk, void* dv, float* dw, float* du_part,
           float* ds0, float* ckpt, int B, int S, int H, int n,
           cudaStream_t st) {
  if (n == 32)
    return launch_n<T, 32>(r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw,
                           du_part, ds0, ckpt, B, S, H, st);
  if (n == 64)
    return launch_n<T, 64>(r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw,
                           du_part, ds0, ckpt, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype of r/k/v and dr/dk/dv: 0 = float32, 1 = bfloat16.  w, u, s0, dy,
// ds, dw, du_part (B, H, n), ds0 (B, H, n, n) and ckpt (B·H,
// mcsa_wkv6_bwd_segments(S), n, n) are float32; s0 and ds may be null
// (zeros) and ds0 null (not wanted).  n is 32 or 64.  All contiguous.
int mcsa_wkv6_bwd_launch(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         const void* dy, const void* ds, void* dr, void* dk,
                         void* dv, void* dw, void* du_part, void* ds0,
                         void* ckpt, int B, int S, int H, int n, int dtype,
                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *wf = (const float*)w, *uf = (const float*)u;
  const float *s0f = (const float*)s0, *dyf = (const float*)dy;
  const float* dsf = (const float*)ds;
  float *dwf = (float*)dw, *duf = (float*)du_part, *ds0f = (float*)ds0;
  float* ckf = (float*)ckpt;
  if (dtype == 0)
    return launch<float>(r, k, v, wf, uf, s0f, dyf, dsf, dr, dk, dv, dwf,
                         duf, ds0f, ckf, B, S, H, n, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, dyf, dsf, dr, dk, dv,
                                 dwf, duf, ds0f, ckf, B, S, H, n, st);
  return (int)cudaErrorInvalidValue;
}

// Checkpoints the workspace holds for S steps: one every SEG steps.
int mcsa_wkv6_bwd_segments(int S) { return (S + SEG - 1) / SEG; }

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
