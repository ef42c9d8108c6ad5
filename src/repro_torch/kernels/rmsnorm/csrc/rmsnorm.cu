// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + w),
// statistics in float32, output in x's type (float32 or bfloat16).
//
// Replaces the JAX package's TPU kernel rmsnorm_tpu / _rmsnorm_kernel
// (src/repro/kernels/rmsnorm/kernel.py).  The TPU kernel normalises an
// (rb, d) tile held in VMEM; here a group of TPR threads owns one row and
// holds it in registers.
//
// Bound: bytes.  Each element is read once and written once (plus w),
// and the arithmetic is a few flops per element, far below the ~295
// flops per byte where the H100 stops being memory bound.  So the design
// is one pass over the row with as many loads in flight as possible:
//   * a row is d / N 16-byte vectors (N = 8 bf16 or 4 f32); each of its
//     TPR threads issues all V (<= 12) of its vector loads before it uses
//     any, and keeps them in registers;
//   * rows of up to 12 x 32 vectors (bf16 d <= 3072) get one warp, or a
//     group of lanes for short rows such as the qk-norm's 128: the sum of
//     squares is reduced with warp shuffles only, with no shared memory
//     and no barrier, and a block of 256 threads holds 256 / TPR rows;
//   * longer rows, and launches of fewer than 128 rows (decode), get 256
//     threads (one row a block), the warps' partial sums added through
//     shared memory: on the H100 that beat a warp a row at d 4096 (bf16)
//     and spreads a handful of decode rows over as many SMs;
//   * (1 + w) is applied from registers and the row is stored once;
//   * for a warp a row or less, the grid is one wave of blocks that walk
//     the rows, so each thread loads its V vectors of w once, before its
//     first row; 256-thread rows get a block each (on the H100 that beat
//     the walking wave at d 4096 bf16 and d 3072 f32);
//   * x is loaded and y stored with the streaming cache hint (__ldcs,
//     __stcs): each is touched once.  On the H100 (4096 x 3072 bf16) the
//     hint, w held in registers and the one-wave grid were each measured
//     faster than without.
// The wrapper (kernel.py::launch_shape) picks TPR and V from d and the
// row count; only the instances listed in launch_v() exist, and any other
// pair is refused.
// A row is 16-byte vectors only: d must be a multiple of 4 (f32) or 8
// (bf16).
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  __device__ static uint4 pack(const float* in) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                      __float_as_uint(in[2]), __float_as_uint(in[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    return raw;
  }
};

// x, w and y are 16-byte aligned and d is a multiple of the vector width
// (the launch refuses anything else), so every row is vector aligned.
// Vector j of a thread is vector lane + j * TPR of its row.  A block walks
// rows first, first + gridDim.x * RPB, ...: with a one-wave grid (TPR <=
// 32) w is read once per thread; at 256 threads a row each block has
// one row.
template <typename T, int TPR, int V>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  constexpr int RPB = THREADS / TPR;           // rows per block at a time
  const int nvec = d / N;
  const int lane = threadIdx.x % TPR;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4 wr[V];                                 // w, loaded once
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = lane + j * TPR;
    wr[j] = i < nvec ? wv[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  // `first` is uniform over the block, so every thread of a row group (and
  // of the block, for the barriers of TPR > 32) runs the same iterations
  for (size_t first = (size_t)blockIdx.x * RPB; first < (size_t)rows;
       first += (size_t)gridDim.x * RPB) {
    const size_t row = first + threadIdx.x / TPR;
    const bool live = row < (size_t)rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    uint4 raw[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {              // every load before any use;
      const int i = lane + j * TPR;            // x is read once: streaming
      raw[j] = (live && i < nvec) ? __ldcs(xr + i)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float f[N];
      Vec<T>::unpack(raw[j], f);
#pragma unroll
      for (int e = 0; e < N; ++e) ss += f[e] * f[e];
    }
#pragma unroll
    for (int off = (TPR < 32 ? TPR : 32) / 2; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if constexpr (TPR > 32) {
      __shared__ float part[THREADS / 32];
      if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
      __syncthreads();
      ss = 0.f;
      const int first_warp = (threadIdx.x / TPR) * (TPR / 32);
#pragma unroll
      for (int i = 0; i < TPR / 32; ++i) ss += part[first_warp + i];
      __syncthreads();                         // part is free again
    }
    const float inv = rsqrtf(ss / (float)d + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = lane + j * TPR;
      if (live && i < nvec) {
        float f[N], g[N];
        Vec<T>::unpack(raw[j], f);
        Vec<T>::unpack(wr[j], g);
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = f[e] * inv * (1.f + g[e]);
        __stcs(yr + i, Vec<T>::pack(f));
      }
    }
  }
}

template <typename T, int TPR, int V>
int launch(const void* x, const void* w, void* y, int rows, int d,
           float eps, cudaStream_t stream) {
  constexpr int RPB = THREADS / TPR;
  int grid = (rows + RPB - 1) / RPB;
  if constexpr (TPR < THREADS) {
    static const int wave = [] {               // blocks resident at once
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rmsnorm_kernel<T, TPR, V>, THREADS, 0);
      return sms * per_sm;
    }();
    if (wave > 0 && grid > wave) grid = wave;
  }
  rmsnorm_kernel<T, TPR, V><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const T*)w, (T*)y, rows, d, eps);
  return (int)cudaGetLastError();
}

#define RMS_CASE(V) \
  case V: return launch<T, TPR, V>(x, w, y, rows, d, eps, s);

// The instances that exist: V = 1 for TPR < 32; for TPR = 32 and 256, the
// V that kernel.py::launch_shape gives the registry's widths
// (configs/archs.py's d_model and the qk-norm's 128, float32 and
// bfloat16; kernel.py's V_SETS).
template <typename T, int TPR>
int launch_v(int v, const void* x, const void* w, void* y, int rows, int d,
             float eps, cudaStream_t s) {
  if constexpr (TPR < 32) {
    if (v == 1) return launch<T, TPR, 1>(x, w, y, rows, d, eps, s);
  } else if constexpr (TPR == 32) {
    switch (v) {
      RMS_CASE(1) RMS_CASE(4) RMS_CASE(7) RMS_CASE(8) RMS_CASE(10)
      RMS_CASE(12)
    }
  } else {
    switch (v) {
      RMS_CASE(1) RMS_CASE(2) RMS_CASE(3) RMS_CASE(4) RMS_CASE(6)
      RMS_CASE(7)
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_tpr(int tpr, int v, const void* x, const void* w, void* y,
               int rows, int d, float eps, cudaStream_t s) {
  if (tpr * v * Vec<T>::N < d || d % Vec<T>::N ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  switch (tpr) {
    case 1: return launch_v<T, 1>(v, x, w, y, rows, d, eps, s);
    case 2: return launch_v<T, 2>(v, x, w, y, rows, d, eps, s);
    case 4: return launch_v<T, 4>(v, x, w, y, rows, d, eps, s);
    case 8: return launch_v<T, 8>(v, x, w, y, rows, d, eps, s);
    case 16: return launch_v<T, 16>(v, x, w, y, rows, d, eps, s);
    case 32: return launch_v<T, 32>(v, x, w, y, rows, d, eps, s);
    case 256: return launch_v<T, 256>(v, x, w, y, rows, d, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (rows, d) contiguous; w: (d,);
// all three 16-byte aligned, d a multiple of 16 bytes.  tpr threads per
// row, v 16-byte vectors per thread, tpr * v covering the row.
int mcsa_rmsnorm_launch(const void* x, const void* w, void* y, int rows,
                        int d, float eps, int dtype, int tpr, int v,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_tpr<float>(tpr, v, x, w, y, rows, d, eps, s);
  if (dtype == 1)
    return launch_tpr<__nv_bfloat16>(tpr, v, x, w, y, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
