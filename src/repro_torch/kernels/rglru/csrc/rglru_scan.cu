// RG-LRU linear recurrence for Hopper (sm_90a):
//     h_t = a_t * h_{t-1} + b_t,   h_{-1} = 0,
// per (batch, channel) over time, a, b and h (B, S, C) float32, contiguous.
// The model folds an initial state into b[:, 0].
//
// Replaces the JAX package's TPU kernel rglru_scan_tpu / _rglru_kernel
// (src/repro/kernels/rglru/kernel.py).  The TPU kernel walks time chunks
// as a sequential grid axis with the running state in VMEM and scans each
// chunk log-depth on the VPU; blocks of a CUDA grid run in no order, so
// here each thread owns one (batch, channel) and loops over time itself.
//
// Bound: bytes.  Each element of a and b is read once and each h written
// once, 12 bytes per (b, t, c) against 2 operations: at recurrentgemma-9b's
// prefill (B 4, S 2560, C 4096) that is 503 MB, 0.150 ms at 3.35 TB/s.
// Design for that bound in its simplest form: neighbouring threads take
// neighbouring channels, so every load and store of a warp is one 128-byte
// line; time runs in chunks of U steps, and the loads of chunk k+1 are
// issued before chunk k is computed, so only the FMA is on the serial
// chain and each thread keeps 2·U loads in flight.  Only B·C threads exist
// (16,384 at B 4), which caps the bytes in flight well below what the
// card's bandwidth needs; a form that splits time across blocks (the TPU
// kernel's chunks plus a carry pass) is later work.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int U = 16;          // time steps per chunk

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h_out, int S, int C) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const size_t base = (size_t)blockIdx.y * S * C + c;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h_out + base;

  float an[U], bn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    an[u] = u < S ? ap[(size_t)u * C] : 0.f;
    bn[u] = u < S ? bp[(size_t)u * C] : 0.f;
  }
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    float ac[U], bc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
    const int t1 = t0 + U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t1 + u < S) {
        an[u] = ap[(size_t)(t1 + u) * C];
        bn[u] = bp[(size_t)(t1 + u) * C];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        h = fmaf(ac[u], h, bc[u]);
        hp[(size_t)(t0 + u) * C] = h;
      }
    }
  }
}

}  // namespace

extern "C" {

// a, b, h: (B, S, C) float32, contiguous; h may not alias a or b.
int mcsa_rglru_scan_launch(const void* a, const void* b, void* h, int B,
                           int S, int C, void* stream) {
  if (B <= 0 || S < 0 || C <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  dim3 grid((C + THREADS - 1) / THREADS, B), block(THREADS);
  rglru_scan_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, S, C);
  return (int)cudaGetLastError();
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
