// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + w),
// statistics in float32, output in x's type (float32 or bfloat16).
//
// Replaces the JAX package's TPU kernel rmsnorm_tpu / _rmsnorm_kernel
// (src/repro/kernels/rmsnorm/kernel.py).  The TPU kernel normalises an
// (rb, d) tile held in VMEM; here one block of RMS_THREADS threads owns
// one row.
//
// Bound: bytes.  Each element is read once and written once (plus w),
// and the arithmetic is a few flops per element, far below the ~295
// flops per byte where the H100 stops being memory bound.  So the design
// only has to stream: 16-byte vector loads and stores (8 bf16 or 4 f32 a
// thread), a warp-shuffle reduction of the sum of squares, and a second
// read of the row that hits L1/L2 (d = 3072 bf16 is 6 KB a row), which
// keeps the row out of shared memory.  A row is 16-byte vectors only: d
// must be a multiple of 4 (f32) or 8 (bf16), which d_model 3072 and the
// qk-norm's head_dim 128 are.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RMS_THREADS = 256;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
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
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// Sum over the block; every thread gets the total.
__device__ float block_sum(float v) {
  __shared__ float warp_part[RMS_THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < RMS_THREADS / 32; ++i) total += warp_part[i];
  return total;
}

// x, w and y are 16-byte aligned and d is a multiple of the vector width
// (the wrapper refuses anything else), so every row is vector aligned.
template <typename T>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int d, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  constexpr int N = Vec<T>::N;
  float ss = 0.f;
  for (int i = threadIdx.x * N; i < d; i += RMS_THREADS * N) {
    float v[N];
    Vec<T>::load(xr + i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) ss += v[j] * v[j];
  }
  const float inv = rsqrtf(block_sum(ss) / (float)d + eps);
  for (int i = threadIdx.x * N; i < d; i += RMS_THREADS * N) {
    float v[N], g[N];
    Vec<T>::load(xr + i, v);
    Vec<T>::load(w + i, g);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = v[j] * inv * (1.f + g[j]);
    Vec<T>::store(yr + i, v);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int d,
           float eps, cudaStream_t stream) {
  if (d % Vec<T>::N || ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16)
    return (int)cudaErrorMisalignedAddress;
  rmsnorm_kernel<T><<<rows, RMS_THREADS, 0, stream>>>(
      (const T*)x, (const T*)w, (T*)y, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (rows, d) contiguous; w: (d,);
// all three 16-byte aligned, d a multiple of 16 bytes.
int mcsa_rmsnorm_launch(const void* x, const void* w, void* y, int rows,
                        int d, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, y, rows, d, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
