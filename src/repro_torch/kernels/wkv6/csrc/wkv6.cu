// RWKV-6 WKV recurrence for Hopper (sm_90a), per (batch, head) with head
// size N and state S (N x N, k-major, S[i][j] = S[k_dim i][v_dim j]):
//     y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] * sum_i r_t[i] (u[i] k_t[i])
//     S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// from S = s0 (or zero), returning y (f32) and the final state (f32).
// Layout is the model's: r, k, v, w (B, S, H, N), u (H, N), s0 and
// s_final (B, H, N, N); r/k/v float32 or bfloat16, w/u/s float32.
//
// Replaces the JAX package's TPU kernel wkv6_tpu / _wkv6_kernel
// (src/repro/kernels/wkv6/kernel.py), with the contract of the model's
// wkv6_scan (src/repro/models/rwkv.py): the TPU kernel starts from zero
// and returns no state, while decode needs the state in and out.  The TPU
// kernel keeps S in VMEM across a sequential grid axis of time chunks;
// here one block owns one (batch, head) and the loop over time runs
// inside it, so the TPU kernel's chunk has no counterpart.
//
// Design (that of the known CUDA wkv kernels, with the k axis split):
// P = 4 neighbouring threads share a v column j, each holding N/P rows
// of S[:, j] in registers for the whole sequence.  Time steps are staged
// TC at a time: r_t, k_t, v_t, w_t of TC steps go to shared memory (u·k
// premultiplied as the model does it; rows padded one word per part so
// the P parts read different banks), one barrier, then each thread runs
// the TC steps from shared-memory broadcasts, and the P partial sums of
// y_j and of the bonus meet by two warp shuffles.  No global load sits
// on the serial chain of steps: a v_t read from device memory inside
// the loop cost a load latency a step and held the kernel at 13x its
// bound.
//
// Bound: every state element takes 3 operations a step (one FMA for y, a
// multiply and an FMA for the update), against bytes of r/k/v/w/y plus
// the two states; at rwkv6-3b's prefill (B 4, S 1024, H 40, N 64) the two
// are close, the operations slightly above.  The kernel is serial over
// time and runs B·H blocks (160 at B 4, 40 at engine prefill on 132
// SMs): latency, not either bound, sets its time.  Splitting k over P
// threads gives each SM P times the warps to hide it; a chunked parallel
// form over time is later work.
//
// Aliasing: decode passes the cache's own state as s0 and as s_final.
// Each thread reads its rows of its column before the loop and writes
// them after, and those (and blocks) are disjoint, so that is safe; the
// two pointers are therefore not __restrict__.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 16;                 // time steps staged per barrier
constexpr int P = 4;                   // threads per v column

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(N * P)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0,
            float* __restrict__ y, float* s_final, int S, int H) {
  constexpr int R = N / P;             // rows of S a thread holds
  constexpr int W = N + P;             // a staged row, one pad word a part
  __shared__ float rs[TC][W], ks[TC][W], uks[TC][W], ws[TC][W], vs[TC][N];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x / P, q = threadIdx.x % P;
  const int i0 = q * R;                // this thread's rows i0 .. i0 + R
  const size_t sbase = (size_t)bh * N * N;

  float st[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    st[i] = s0 ? s0[sbase + (size_t)(i0 + i) * N + j] : 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tn = min(TC, S - t0);
    __syncthreads();                     // the previous chunk is consumed
    for (int e = threadIdx.x; e < tn * N; e += N * P) {
      const int tt = e / N, i = e % N, si = i + i / R;
      const size_t off = (((size_t)b * S + t0 + tt) * H + h) * N + i;
      const float kf = to_f(k[off]);
      rs[tt][si] = to_f(r[off]);
      ks[tt][si] = kf;
      uks[tt][si] = u[h * N + i] * kf;
      ws[tt][si] = w[off];
      vs[tt][i] = to_f(v[off]);
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      const size_t off = (((size_t)b * S + t0 + tt) * H + h) * N + j;
      const float vj = vs[tt][j];
      const int si = i0 + q;             // padded index of row i0
      float yp = 0.f, bonus = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float ri = rs[tt][si + i];
        yp += ri * st[i];
        bonus += ri * uks[tt][si + i];
      }
#pragma unroll
      for (int o = 1; o < P; o <<= 1) {
        yp += __shfl_xor_sync(0xffffffffu, yp, o);
        bonus += __shfl_xor_sync(0xffffffffu, bonus, o);
      }
      if (q == 0) y[off] = yp + vj * bonus;
#pragma unroll
      for (int i = 0; i < R; ++i)
        st[i] = ws[tt][si + i] * st[i] + ks[tt][si + i] * vj;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    s_final[sbase + (size_t)(i0 + i) * N + j] = st[i];
}

template <typename T, int N>
int launch_n(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* y, float* s_final,
             int B, int S, int H, cudaStream_t stream) {
  wkv6_kernel<T, N><<<B * H, N * P, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, y, s_final, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* s_final, int B,
           int S, int H, int n, cudaStream_t stream) {
  if (B <= 0 || S < 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (n == 64)
    return launch_n<T, 64>(r, k, v, w, u, s0, y, s_final, B, S, H, stream);
  if (n == 32)
    return launch_n<T, 32>(r, k, v, w, u, s0, y, s_final, B, S, H, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype of r/k/v: 0 = float32, 1 = bfloat16.  w, u, s0, y, s_final are
// float32; s0 may be null (zero state) and may equal s_final.  n is 32 or
// 64.  All contiguous.
int mcsa_wkv6_launch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* y,
                     void* s_final, int B, int S, int H, int n, int dtype,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* wf = (const float*)w;
  const float* uf = (const float*)u;
  const float* s0f = (const float*)s0;
  float* yf = (float*)y;
  float* sf = (float*)s_final;
  if (dtype == 0)
    return launch<float>(r, k, v, wf, uf, s0f, yf, sf, B, S, H, n, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, yf, sf, B, S, H, n,
                                 st);
  return (int)cudaErrorInvalidValue;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
