// RMSNorm backward for Hopper (sm_90a): given x (rows, d), w (d,) and the
// output's gradient g (rows, d), both in float32 or both in bfloat16,
//   inv  = rsqrt(mean(x^2) + eps)                  (float32, per row)
//   dx   = inv * g*(1+w) - x * inv^3 * sum(g*(1+w)*x) / d
//   dw   = sum over rows of g * x * inv
// with every statistic and sum in float32; dx is stored in x's type and dw
// in w's.
//
// The JAX package has no backward kernel: its train step differentiates
// the jnp rms_norm (src/repro/models/layers.py:44) with XLA, and its
// forward kernel is rmsnorm_tpu (src/repro/kernels/rmsnorm/kernel.py:27).
// The port's model reaches the forward through its CUDA kernel
// (csrc/rmsnorm.cu), so the backward of that call is this kernel.
//
// Bound: bytes.  x, g and w are read and dx and dw written once each, with
// a few flops an element.  The design is simple first:
//   * stage 1 (rmsnorm_bwd_rows): a block of 256 threads is 256 / TPR row
//     groups of TPR threads (a warp a row for d <= 1024, such as the
//     qk-norm's 128; the whole block a row above); a group walks its rows
//     (block b, group r: rows b*RPB + r, then + gridDim.x*RPB, ...), and
//     thread `lane` of a group owns columns lane, lane + TPR, ...  A row
//     is read once for sum(x^2) and sum(g*(1+w)*x), reduced with warp
//     shuffles (and shared memory across the warps of a block-wide row),
//     then read again (from L1/L2) to write dx.  Each group adds g*x*inv
//     into its own float32 row of shared memory, column by column, so no
//     two threads ever add to one address; at the end the block sums its
//     groups' rows in a fixed order into partial[block] (nblocks x d).
//   * stage 2 (rmsnorm_bwd_dw): one thread a column sums the nblocks
//     partials in block order and stores dw.
// No atomics anywhere, and the number of blocks is fixed by the wrapper
// (kernel.py: at most 264, whatever the card), so two runs on the same
// inputs give the same bits.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launches
// go on the caller's stream and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

// Dynamic shared memory: RPB rows of d floats, one per row group.
template <typename T, int TPR>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ partial, int rows, int d, float eps) {
  constexpr int RPB = THREADS / TPR;
  extern __shared__ float acc_all[];
  __shared__ float red[2][THREADS / 32];
  const int group = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  float* acc = acc_all + (size_t)group * d;
  for (int c = lane; c < d; c += TPR) acc[c] = 0.f;

  // `first` is uniform over the block, so every thread runs the same
  // iterations (the shuffles and barriers below need all of them)
  for (size_t first = (size_t)blockIdx.x * RPB; first < (size_t)rows;
       first += (size_t)gridDim.x * RPB) {
    const size_t row = first + group;
    const bool live = row < (size_t)rows;
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    float ss = 0.f, sgx = 0.f;
    if (live) {
      for (int c = lane; c < d; c += TPR) {
        const float xv = to_f(xr[c]);
        const float gv = to_f(gr[c]) * (1.f + to_f(w[c]));
        ss = fmaf(xv, xv, ss);
        sgx = fmaf(gv, xv, sgx);
      }
    }
#pragma unroll
    for (int off = (TPR < 32 ? TPR : 32) / 2; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
    }
    if constexpr (TPR > 32) {
      const int warp = threadIdx.x / 32;
      if (threadIdx.x % 32 == 0) {
        red[0][warp] = ss;
        red[1][warp] = sgx;
      }
      __syncthreads();
      ss = 0.f;
      sgx = 0.f;
      const int first_warp = group * (TPR / 32);
#pragma unroll
      for (int i = 0; i < TPR / 32; ++i) {
        ss += red[0][first_warp + i];
        sgx += red[1][first_warp + i];
      }
      __syncthreads();                       // red is free again
    }
    if (live) {
      const float inv = rsqrtf(ss / (float)d + eps);
      const float k = inv * inv * inv * (sgx / (float)d);
      T* dr = dx + row * d;
      for (int c = lane; c < d; c += TPR) {
        const float xv = to_f(xr[c]);
        const float graw = to_f(gr[c]);
        const float gv = graw * (1.f + to_f(w[c]));
        dr[c] = from_f<T>(inv * gv - k * xv);
        acc[c] = fmaf(graw, xv * inv, acc[c]);
      }
    }
  }
  __syncthreads();
  // the block's partial: its groups' rows summed in group order
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < RPB; ++r) s += acc_all[(size_t)r * d + c];
    partial[(size_t)blockIdx.x * d + c] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_dw(const float* __restrict__ partial, T* __restrict__ dw,
               int nblocks, int d) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * d + c];
  dw[c] = from_f<T>(s);
}

template <typename T, int TPR>
int launch(const void* x, const void* w, const void* g, void* dx, void* dw,
           float* partial, int rows, int d, float eps, int nblocks,
           cudaStream_t s) {
  constexpr int RPB = THREADS / TPR;
  const size_t smem = sizeof(float) * (size_t)RPB * d;
  auto kern = rmsnorm_bwd_rows<T, TPR>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<nblocks, THREADS, smem, s>>>((const T*)x, (const T*)w, (const T*)g,
                                      (T*)dx, partial, rows, d, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_dw<T><<<(d + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      partial, (T*)dw, nblocks, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tpr(int tpr, const void* x, const void* w, const void* g,
               void* dx, void* dw, float* partial, int rows, int d,
               float eps, int nblocks, cudaStream_t s) {
  if (tpr == 32)
    return launch<T, 32>(x, w, g, dx, dw, partial, rows, d, eps, nblocks, s);
  if (tpr == THREADS)
    return launch<T, THREADS>(x, w, g, dx, dw, partial, rows, d, eps,
                              nblocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, g, dx, dw all of it).  x, g, dx:
// (rows, d) contiguous; w, dw: (d,); partial: (nblocks, d) float32
// scratch.  tpr: 32 or 256 threads a row; nblocks >= 1 blocks in stage 1.
int mcsa_rmsnorm_bwd_launch(const void* x, const void* w, const void* g,
                            void* dx, void* dw, float* partial, int rows,
                            int d, float eps, int dtype, int tpr,
                            int nblocks, void* stream) {
  if (rows <= 0 || d <= 0 || nblocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_tpr<float>(tpr, x, w, g, dx, dw, partial, rows, d, eps,
                             nblocks, s);
  if (dtype == 1)
    return launch_tpr<__nv_bfloat16>(tpr, x, w, g, dx, dw, partial, rows, d,
                                     eps, nblocks, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
