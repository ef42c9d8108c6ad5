// RMSNorm backward for Hopper (sm_90a): given x (rows, d), w (d,) and the
// output's gradient g (rows, d), both in float32 or both in bfloat16,
//   inv  = rsqrt(mean(x^2) + eps)                  (float32, per row)
//   dx   = inv * g*(1+w) - x * inv^3 * sum(g*(1+w)*x) / d
//   dw   = sum over rows of g * x * inv
// with every statistic and sum in float32; dx is stored in x's type and dw
// in w's.
//
// What it replaces: no Pallas kernel.  The JAX package's train step
// differentiates its jnp rms_norm (src/repro/models/layers.py:44) with XLA;
// its forward kernel is rmsnorm_tpu (src/repro/kernels/rmsnorm/kernel.py:
// 27).  The port's model reaches the forward through its CUDA kernel
// (csrc/rmsnorm.cu), so the backward of that call is this kernel.
//
// What bounds it: bytes.  x and g are read and dx written once (w read and
// dw written once more), with a few flops an element, far below the ~295
// flops a byte where the H100 stops being memory bound.  Reading each
// row twice, one element a thread at a time, ran at a quarter of that
// bound on the H100.  So a row is read once, as the one-pass forward
// does:
//   * a row is d / N 16-byte vectors (N = 8 bf16 or 4 f32); a group of TPR
//     threads owns it, thread `lane` vectors lane + j·TPR (j < V), loaded
//     with the streaming hint (__ldcs) and held in registers; TPR is the
//     fewest threads (a power of two) that hold the row in 4 vectors each,
//     up to 256 (then up to 7 each): 4 threads a row at the qk-norm's 128,
//     128 at starcoder2-3b's 3072 (backward.py::launch_shape);
//   * the next row's vectors are loaded before this row's are used, so two
//     rows a group are in flight (except for bf16 rows of 6 or 7 vectors
//     a thread, whose registers would spill).  On the H100 at 4096 x 3072
//     bf16, 4 vectors a thread and this prefetch beat 2 vectors and no
//     prefetch (0.041 against 0.042-0.048 ms; 2 vectors won at 131072 x
//     128 by 0.047 to 0.051, a shape [train] does not run);
//   * both row sums, sum(x^2) and sum(g(1+w)x), are reduced by xor
//     shuffles within the warp (and, for a group of several warps, through
//     shared memory);
//   * dx is written from the registers (__stcs), and each thread adds
//     g·x·inv of its own columns into float32 registers: no shared memory
//     and no atomics while the block walks its rows;
//   * w is loaded once a thread, before its first row.
// dw: the block's groups' registers are summed in group order into
// partial[block] (nblocks x d, through shared memory when a block holds
// several groups), then rmsnorm_bwd_dw_kernel sums the nblocks partials of
// a column, eight warps a 32-column block, in a fixed order (one thread a
// column, 264 rows each, left that stage on 12 SMs at d 3072 and took a
// fifth of the call on the H100).  The number of blocks is fixed by the
// wrapper (backward.py: at most 264, whatever the card), so two runs on
// the same inputs give the same bits.
// A row is 16-byte vectors only: d must be a multiple of 4 (f32) or 8
// (bf16), as the forward requires.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launches
// go on the caller's stream and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int V_GROUP = 4;     // vectors a thread below THREADS threads a row

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
  __device__ static float from_f(float v) { return v; }
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
  __device__ static __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Stage 1.  A block walks rows first, first + gridDim.x * RPB, ... (group
// r of the block takes row first + r); dynamic shared memory: RPB rows of
// d floats when RPB > 1 (the groups' dw partials), else none.
template <typename T, int TPR, int V>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ partial, int rows, int d,
                        float eps) {
  constexpr int N = Vec<T>::N;
  constexpr int RPB = THREADS / TPR;           // rows a block at a time
  // the next row's loads go out before this row is used, unless the
  // registers that takes (bf16 rows of 6 or 7 vectors a thread) spill
  constexpr bool PREFETCH = V * N <= 40;
  extern __shared__ float red_rows[];
  __shared__ float red[2][THREADS / 32];
  const int nvec = d / N;
  const int group = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  const size_t step = (size_t)gridDim.x * RPB;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  uint4 wr[V];                                 // w, loaded once
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = lane + j * TPR;
    wr[j] = i < nvec ? reinterpret_cast<const uint4*>(w)[i] : zero;
  }
  auto load = [&](size_t row, uint4 (&xv)[V], uint4 (&gv)[V]) {
    const bool live = row < (size_t)rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* gr = reinterpret_cast<const uint4*>(g + row * d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = lane + j * TPR;
      xv[j] = (live && i < nvec) ? __ldcs(xr + i) : zero;
      gv[j] = (live && i < nvec) ? __ldcs(gr + i) : zero;
    }
  };
  float acc[V][N];
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[j][e] = 0.f;

  uint4 xa[V], ga[V];
  size_t first = (size_t)blockIdx.x * RPB;
  load(first + group, xa, ga);
  // `first` is uniform over the block, so every thread runs the same
  // iterations (the shuffles and barriers below need all of them)
  for (; first < (size_t)rows; first += step) {
    const size_t row = first + group;
    uint4 xn[V], gn[V];                        // the next row, in flight
    if (PREFETCH) load(first + step + group, xn, gn);
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float xf[N], gf[N], wf[N];
      Vec<T>::unpack(xa[j], xf);
      Vec<T>::unpack(ga[j], gf);
      Vec<T>::unpack(wr[j], wf);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        ss = fmaf(xf[e], xf[e], ss);
        sgx = fmaf(gf[e] * (1.f + wf[e]), xf[e], sgx);
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
      __syncthreads();                         // red is free again
    }
    if (row < (size_t)rows) {
      const float inv = rsqrtf(ss / (float)d + eps);
      const float k = inv * inv * inv * (sgx / (float)d);
      uint4* dr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int i = lane + j * TPR;
        if (i < nvec) {
          float xf[N], gf[N], wf[N], out[N];
          Vec<T>::unpack(xa[j], xf);
          Vec<T>::unpack(ga[j], gf);
          Vec<T>::unpack(wr[j], wf);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            out[e] = inv * (gf[e] * (1.f + wf[e])) - k * xf[e];
            acc[j][e] = fmaf(gf[e], xf[e] * inv, acc[j][e]);
          }
          __stcs(dr + i, Vec<T>::pack(out));
        }
      }
    }
    if (PREFETCH) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        xa[j] = xn[j];
        ga[j] = gn[j];
      }
    } else {
      load(first + step + group, xa, ga);
    }
  }

  // the block's partial: its groups' sums in group order
  float* dst = partial + (size_t)blockIdx.x * d;
  if constexpr (RPB == 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = lane + j * TPR;
      if (i < nvec)
#pragma unroll
        for (int e = 0; e < N; ++e) dst[i * N + e] = acc[j][e];
    }
  } else {
    float* mine = red_rows + (size_t)group * d;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = lane + j * TPR;
      if (i < nvec)
#pragma unroll
        for (int e = 0; e < N; ++e) mine[i * N + e] = acc[j][e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += THREADS) {
      float s = 0.f;
      for (int r = 0; r < RPB; ++r) s += red_rows[(size_t)r * d + c];
      dst[c] = s;
    }
  }
}

// Stage 2: dw.  A block takes 32 columns: warp w sums partial rows w, w +
// 8, ... of them (coalesced 128-byte rows), then warp 0 adds the eight
// sums in warp order, so the order is fixed and the bits repeat.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_dw_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                      int nblocks, int d) {
  constexpr int SLICES = THREADS / 32;
  __shared__ float sums[SLICES][32];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d)
    for (int b = slice; b < nblocks; b += SLICES)
      s += partial[(size_t)b * d + c];
  sums[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < SLICES; ++i) t += sums[i][lane];
    dw[c] = Vec<T>::from_f(t);
  }
}

template <typename T, int TPR, int V>
int launch(const void* x, const void* w, const void* g, void* dx, void* dw,
           float* partial, int rows, int d, float eps, int nblocks,
           cudaStream_t s) {
  constexpr int RPB = THREADS / TPR;
  const size_t smem = RPB > 1 ? sizeof(float) * (size_t)RPB * d : 0;
  rmsnorm_bwd_rows_kernel<T, TPR, V><<<nblocks, THREADS, smem, s>>>(
      (const T*)x, (const T*)w, (const T*)g, (T*)dx, partial, rows, d, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_dw_kernel<T><<<(d + 31) / 32, THREADS, 0, s>>>(
      partial, (T*)dw, nblocks, d);
  return (int)cudaGetLastError();
}

#define RMS_BWD_TPR(TPR) \
  case TPR: return v == V_GROUP ? launch<T, TPR, V_GROUP>( \
      x, w, g, dx, dw, partial, rows, d, eps, nblocks, s) \
      : (int)cudaErrorInvalidValue;
#define RMS_BWD_WIDE(V) \
  case V: return launch<T, THREADS, V>(x, w, g, dx, dw, partial, rows, d, \
                                       eps, nblocks, s);

// The instances that exist (backward.py::launch_shape): V_GROUP vectors a
// thread below 256 threads a row, 3 to 7 at 256.
template <typename T>
int launch_shape(int tpr, int v, const void* x, const void* w, const void* g,
                 void* dx, void* dw, float* partial, int rows, int d,
                 float eps, int nblocks, cudaStream_t s) {
  if (tpr * v * Vec<T>::N < d || d % Vec<T>::N ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)g | (uintptr_t)dx) % 16)
    return (int)cudaErrorInvalidValue;
  switch (tpr) {
    RMS_BWD_TPR(1) RMS_BWD_TPR(2) RMS_BWD_TPR(4) RMS_BWD_TPR(8)
    RMS_BWD_TPR(16) RMS_BWD_TPR(32) RMS_BWD_TPR(64) RMS_BWD_TPR(128)
    case THREADS:
      switch (v) {
        RMS_BWD_WIDE(3) RMS_BWD_WIDE(4) RMS_BWD_WIDE(5) RMS_BWD_WIDE(6)
        RMS_BWD_WIDE(7)
      }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, g, dx, dw all of it).  x, g, dx:
// (rows, d) contiguous, 16-byte aligned, d a multiple of 16 bytes; w, dw:
// (d,); partial: (nblocks, d) float32 scratch.  tpr threads a row, v
// 16-byte vectors a thread, tpr * v covering the row; nblocks >= 1 blocks
// in stage 1.
int mcsa_rmsnorm_bwd_launch(const void* x, const void* w, const void* g,
                            void* dx, void* dw, float* partial, int rows,
                            int d, float eps, int dtype, int tpr, int v,
                            int nblocks, void* stream) {
  if (rows <= 0 || d <= 0 || nblocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_shape<float>(tpr, v, x, w, g, dx, dw, partial, rows, d,
                               eps, nblocks, s);
  if (dtype == 1)
    return launch_shape<__nv_bfloat16>(tpr, v, x, w, g, dx, dw, partial,
                                       rows, d, eps, nblocks, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
