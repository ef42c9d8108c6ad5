// RG-LRU scan backward for Hopper (sm_90a): the gradients of
//     h_t = a_t * h_{t-1} + b_t,   h_{-1} = 0
// (csrc/rglru_scan.cu) for an output gradient dh, a reverse scan
//     g_t = dh_t + a_{t+1} * g_{t+1}   (g past the end 0),
//     db_t = g_t,   da_t = g_t * h_{t-1},
// per (batch, channel), a, h, dh, da and db (B, S, C) float32, contiguous.
//
// What it replaces: no Pallas kernel.  The JAX package's train step
// differentiates its jnp rglru_scan (src/repro/models/rglru.py:80) with
// XLA; its forward kernel is rglru_scan_tpu
// (src/repro/kernels/rglru/kernel.py:59).  The port's model reaches the
// forward through its CUDA kernel, so the backward of that call is this
// file.
//
// Bound: bytes.  a, h and dh are read once and da and db written once, 20
// bytes per (b, t, c): at recurrentgemma-9b's training shape (B 2, S
// 2560, C 4096) 419 MB, 0.125 ms at 3.35 TB/s.  The design is the
// forward's mirrored in time: each thread owns one (batch, channel) and
// walks time backwards, neighbouring threads take neighbouring channels
// (a warp's loads and stores are 128-byte lines), and the loads of the
// next chunk of U steps are issued before the current chunk is computed,
// so only the FMA is on the serial chain.  h_{t-1} is the forward's own
// output one step earlier, read from h, never recomputed or divided out
// (a may be 0).
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int U = 16;          // time steps per chunk

// loads of step t (a_{t+1}, h_{t-1}, dh_t) into slot u, zeros past the ends
__device__ __forceinline__ void load_step(const float* ap, const float* hp,
                                          const float* gp, int t, int S,
                                          size_t C, float& an, float& hn,
                                          float& gn) {
  an = (t >= 0 && t + 1 < S) ? ap[(size_t)(t + 1) * C] : 0.f;
  hn = (t >= 1) ? hp[(size_t)(t - 1) * C] : 0.f;
  gn = (t >= 0) ? gp[(size_t)t * C] : 0.f;
}

__global__ void __launch_bounds__(THREADS)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ dh, float* __restrict__ da,
                      float* __restrict__ db, int S, int C) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const size_t base = (size_t)blockIdx.y * S * C + c;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = dh + base;
  float* dap = da + base;
  float* dbp = db + base;

  // slot u of a chunk is step t0 - u (the chunk walks t0, t0 - 1, ...)
  float an[U], hn[U], gn[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    load_step(ap, hp, gp, S - 1 - u, S, C, an[u], hn[u], gn[u]);
  float g = 0.f;
  for (int t0 = S - 1; t0 >= 0; t0 -= U) {
    float ac[U], hc[U], gc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = an[u];
      hc[u] = hn[u];
      gc[u] = gn[u];
    }
    const int t1 = t0 - U;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (t1 - u >= 0)
        load_step(ap, hp, gp, t1 - u, S, C, an[u], hn[u], gn[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        g = fmaf(ac[u], g, gc[u]);
        dbp[(size_t)t * C] = g;
        dap[(size_t)t * C] = g * hc[u];
      }
    }
  }
}

}  // namespace

extern "C" {

// a, h, dh, da, db: (B, S, C) float32, contiguous; da and db may not alias
// the inputs.
int mcsa_rglru_scan_bwd_launch(const void* a, const void* h, const void* dh,
                               void* da, void* db, int B, int S, int C,
                               void* stream) {
  if (B <= 0 || S < 0 || C <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  dim3 grid((C + THREADS - 1) / THREADS, B), block(THREADS);
  rglru_scan_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h, (const float*)dh, (float*)da,
      (float*)db, S, C);
  return (int)cudaGetLastError();
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
