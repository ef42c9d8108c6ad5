// Single-split Li-GD steps for Hopper (sm_90a): `iters` projected-GD
// steps on x = (xB, xr) in [0, 1]^2 at one split point per user row, with
// the closed-form gradient of the utility, then U at the final point.
//
// Replaces: repro/kernels/ligd_step/kernel.py::ligd_steps_tpu (body
// _ligd_kernel, utility and gradient _utility_terms) of the JAX package.
// Plain version: ../ref.py::ligd_steps_ref, the autodiff oracle (autograd
// of core/costs.utility), as the JAX package tests its kernel.
//
// Layout, the TPU kernel's: feat (X, NF = 16) float32, one row per user
// (f_l, f_e, w, m, offloaded, c_dev, xi·c²·φ, p_tx, pαg, hops, k, t_ag,
// w_T, w_E, w_C, unused); x0 and x (X, 2); U (X,).  The edge server's
// constants are the same for every row of a launch and come as launch
// arguments (the TPU kernel's compile-time statics).
//
// What bounds it on this card: operations, not bytes.  A row is 84 bytes
// in and out (8.4 MB at X = 100k, 2.5 us at 3.35 TB/s), while each step
// issues 10 multi-function-unit instructions (5 divisions, 3 log2,
// 2 exp2; OPS in chip_smoke.py counts them) and each row runs all
// `iters` steps.  Design: one thread per row, all steps in registers; the
// x-independent groups of the gradient are computed once per row before
// the loop; pow(x, y) is exp2(y·log2 x), as in the sweep kernel.  Every
// lane runs the same number of steps, so warps do not diverge.
//
// Numerics: built without --use_fast_math, so divisions, exp2f and log2f
// are IEEE or within 2 ulp; FMA contraction is allowed (the plain version
// is autograd, not this expression, so bit equality is not the aim).
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int NF = 16;
constexpr int THREADS = 128;

struct Edge {
  float B_min, B_max, r_min, r_max, lam_a, c_min, rho_min, rho_B, gamma_B,
      B0, B_bh, N0;
};

// Python's math.log(2.0) rounded to float.
__device__ __forceinline__ float ln2f() {
  return static_cast<float>(0.6931471805599453);
}

__global__ void __launch_bounds__(THREADS)
ligd_steps_kernel(const float* __restrict__ feat,
                  const float* __restrict__ x0, float* __restrict__ x_out,
                  float* __restrict__ u_out, int X, int iters, float lr,
                  Edge ep) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= X) return;
  float f[NF];
  const float4* row = reinterpret_cast<const float4*>(feat + (size_t)i * NF);
#pragma unroll
  for (int j = 0; j < NF / 4; ++j) {
    const float4 v = row[j];
    f[4 * j] = v.x; f[4 * j + 1] = v.y; f[4 * j + 2] = v.z;
    f[4 * j + 3] = v.w;
  }
  const float f_l = f[0], f_e = f[1], wm = f[2] + f[3], offl = f[4];
  const float c_dev = f[5], epf = f[6], p_tx = f[7], c1 = f[8];
  const float hops = f[9], k = f[10], t_ag = f[11];
  const float wT = f[12], wE = f[13], wC = f[14];

  const float B_span = ep.B_max - ep.B_min;
  const float r_span = ep.r_max - ep.r_min;
  const float q = c1 / ep.N0;                        // pαg/N0
  const float inv_B0 = 1.0f / ep.B0;
  // x-independent groups of dU/dB and dU/dr
  const float cT = wT * offl * wm;                   // · (-1/B²)
  const float cE = wE * offl * p_tx * wm;            // · (-dτ/τ²)
  const float cC = wC * offl * ep.rho_B * ep.gamma_B;  // · pB/(B·k)
  const float cR = wT * offl * f_e / ep.c_min * (-ep.lam_a);  // · r^(-a-1)
  const float cR0 = wC * offl * ep.rho_min / k;
  const float a1 = -ep.lam_a - 1.0f;

  float xB = x0[2 * i], xr = x0[2 * i + 1];
  for (int it = 0; it < iters; ++it) {
    const float B = ep.B_min + xB * B_span;
    const float r = ep.r_min + xr * r_span;
    const float L = log2f(1.0f + q / B);             // log2(1 + q/B)
    const float tau = B * L;
    const float pB = exp2f(ep.gamma_B * log2f(B * inv_B0));   // (B/B0)^γ
    // dτ/dB = L - q / (ln2 · (B + q))
    const float dtau = L - q / (ln2f() * (B + q));
    const float dU_dB = cT * (-1.0f / (B * B))
                        + cE * (-dtau / (tau * tau))
                        + cC * pB / (B * k);
    const float dU_dr = cR * exp2f(a1 * log2f(r)) + cR0;
    xB = fminf(fmaxf(xB - lr * (dU_dB * B_span), 0.0f), 1.0f);
    xr = fminf(fmaxf(xr - lr * (dU_dr * r_span), 0.0f), 1.0f);
  }

  const float B = ep.B_min + xB * B_span;
  const float r = ep.r_min + xr * r_span;
  const float lam = exp2f(ep.lam_a * log2f(r));      // λ(r) = r^a
  const float tau = B * log2f(1.0f + q / B);
  const float gB = ep.rho_B * exp2f(ep.gamma_B * log2f(B * inv_B0));
  const float T = f_l / c_dev
                  + offl * (f_e / (lam * ep.c_min) + wm / B
                            + hops * wm / ep.B_bh)
                  + t_ag / k;
  const float E = epf * f_l + offl * p_tx * wm / tau;
  const float C = offl * (r * ep.rho_min + gB) / k;
  x_out[2 * i] = xB;
  x_out[2 * i + 1] = xr;
  u_out[i] = wT * T + wE * E + wC * C;
}

}  // namespace

extern "C" {

// feat (X, 16), x0 and x (X, 2), u (X,): float32, contiguous, 16-byte
// aligned feat.  Edge constants in the order of ref.py's EDGE_KEYS.
int mcsa_ligd_steps_launch(const void* feat, const void* x0, void* x,
                           void* u, int X, int iters, float lr, float B_min,
                           float B_max, float r_min, float r_max,
                           float lam_a, float c_min, float rho_min,
                           float rho_B, float gamma_B, float B0, float B_bh,
                           float N0, void* stream) {
  if (X < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (X == 0) return (int)cudaSuccess;
  const Edge ep{B_min, B_max, r_min, r_max, lam_a, c_min, rho_min,
                rho_B, gamma_B, B0, B_bh, N0};
  ligd_steps_kernel<<<(X + THREADS - 1) / THREADS, THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)x0, (float*)x, (float*)u, X, iters,
      lr, ep);
  return (int)cudaGetLastError();
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
