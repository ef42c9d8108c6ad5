// Single-split Li-GD steps for Hopper (sm_90a): `iters` projected-GD
// steps on x = (xB, xr) in [0, 1]^2 at one split point per user row, with
// the closed-form gradient of the utility, then U at the final point.
// One launch serves every edge server's group of users.
//
// Replaces: repro/kernels/ligd_step/kernel.py::ligd_steps_tpu (body
// _ligd_kernel, utility and gradient _utility_terms) of the JAX package.
// Plain version: ../ref.py::ligd_steps_ref, the autodiff oracle (autograd
// of core/costs.utility), as the JAX package tests its kernel; the body's
// algebra is ../ref.py::fast_math_steps_twin's.
//
// Layout, the TPU kernel's: feat (X, NF = 16) float32, one row per user
// (f_l, f_e, w, m, offloaded, c_dev, xi·c²·φ, p_tx, pαg, hops, k, t_ag,
// w_T, w_E, w_C, unused); x0 and x (X, 2); U (X,).  The rows of G groups
// are concatenated: group j holds rows start[j] .. start[j+1] - 1 and one
// edge server's constants (the TPU kernel's compile-time statics, one
// launch a server).  The launch carries the offsets and the groups'
// constants in its parameters (a __grid_constant__ struct, read from the
// constant bank), at most kMaxGroups groups, so a launch needs no device
// buffer and no copy besides the rows.
//
// What bounds it on this card: operations, not bytes.  A row is 84 bytes
// in and out (8.4 MB at X = 100k, 2.5 us at 3.35 TB/s), while each step
// issues 8 multi-function-unit instructions (3 reciprocals, 3 log2,
// 2 exp2; the fewest any body needs is 6, STEPS_OPS in chip_smoke.py)
// and each row runs all `iters` steps.
//
// Design:
// * One thread a row, all steps in registers; the grid covers all X rows
//   of all groups, so small groups do not each leave the card empty while
//   their chains run one after another.  A thread finds its group by a
//   binary search of the offsets (log2 G constant-bank reads, once):
//   groups of any size, no padding, and block edges need not meet group
//   edges.  Every lane runs the same number of steps: warps do not
//   diverge but for the search and where a warp spans two groups.
// * A short step: whatever does not depend on x is computed before the
//   loop (1/k, 1/c_dev, and the group's 1/c_min, 1/B0, 1/N0, 1/B_backhaul
//   and spans on the host, correctly rounded); one reciprocal of B a step
//   gives q/B, 1/B² and the rent term's quotient; 1/τ = (1/B)·(1/L);
//   q/(ln2·(B + q)) = (q/B)·(1/ln2)·(1/(1 + q/B)); r^(-a-1) (and r^-a for
//   the final utility) is exp2 of a multiple of one log2(r).
// * Approximate instructions: rcp/ex2/lg2.approx.ftz (MUFU), and FMA
//   contraction.  There is no stopping test on eps here, so no discrete
//   decision hangs on the last bits; ../ref.py::fast_math_steps_twin
//   rehearses this algebra on the CPU with every reciprocal, exp2 and log2
//   perturbed up to its PTX maximum error and meets the reference test's
//   tolerances (x 1e-5, U 1e-5 + 1e-4·|U|) against the JAX package's
//   autodiff oracle with a margin of about 9x
//   (tests/test_torch_ligd_steps.py).  Operands here are normal floats
//   (B >= B_min > 0, r >= r_min > 0, 1 + q/B >= 1), which ftz leaves
//   alone.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int NF = 16;
constexpr int kThreads = 128;
// The group cap comes from the build (steps.py passes ref.py's
// MAX_GROUPS), so Python and the kernel cannot disagree on it.
#ifndef MCSA_STEPS_MAX_GROUPS
#error "build with -DMCSA_STEPS_MAX_GROUPS=<n> (ref.py's MAX_GROUPS)"
#endif
constexpr int kMaxGroups = MCSA_STEPS_MAX_GROUPS;
constexpr int kEdgeKeys = 12;             // ../ref.py EDGE_KEYS

// One group's constants, derived on the host from its edge record.
struct Group {
  float B_min, B_span, r_min, r_span, inv_N0, inv_B0, gamma_B, lam_a,
      inv_cmin, inv_Bbh, rho_min, rho_B;
};

// The launch's groups: rows start[j] .. start[j+1] - 1 are group j's.
struct Groups {
  int n;
  int start[kMaxGroups + 1];
  Group g[kMaxGroups];
};
// A launch's parameters may take 4 KB; the kernel's others take 48 bytes.
static_assert(sizeof(Groups) + 64 <= 4096,
              "MCSA_STEPS_MAX_GROUPS too large for the launch's parameters");

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1/ln 2 from Python's 1.0 / math.log(2.0), rounded to float.
constexpr float kInvLn2 = static_cast<float>(1.0 / 0.6931471805599453);

// The terms of B that a step and the final utility share: 1/B, q/B,
// 1 + q/B, L = log2(1 + q/B), 1/τ and (B/B0)^γ.
struct BTerms {
  float inv_B, qB, one_qB, L, inv_tau, pw;
  __device__ __forceinline__ BTerms(float B, float q, const Group& e) {
    inv_B = rcp(B);
    qB = q * inv_B;
    one_qB = 1.0f + qB;
    L = lg2(one_qB);
    inv_tau = inv_B * rcp(L);
    pw = ex2(e.gamma_B * lg2(B * e.inv_B0));
  }
};

__global__ void __launch_bounds__(kThreads)
ligd_steps_kernel(const float4* __restrict__ feat,
                  const float* __restrict__ x0, float* __restrict__ x_out,
                  float* __restrict__ u_out, int X, int iters, float lr,
                  const __grid_constant__ Groups gs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= X) return;
  int lo = 0, hi = gs.n;                  // the last group starting <= i
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (gs.start[mid] <= i) lo = mid; else hi = mid;
  }
  const Group& e = gs.g[lo];

  float f[NF];
  const float4* row = feat + static_cast<size_t>(i) * (NF / 4);
#pragma unroll
  for (int j = 0; j < NF / 4; ++j) {
    const float4 v = row[j];
    f[4 * j] = v.x; f[4 * j + 1] = v.y; f[4 * j + 2] = v.z;
    f[4 * j + 3] = v.w;
  }
  const float f_l = f[0], f_e = f[1], wm = f[2] + f[3], offl = f[4];
  const float wT = f[12], wE = f[13], wC = f[14];

  // x-independent terms, as ref.py::_steps_consts
  const float inv_k = __frcp_rn(f[10]);
  const float ow = offl * wm;
  const float wCo_k = wC * offl * inv_k;
  const float cTs = wT * offl * f_e * e.inv_cmin;      // · r^-a
  const float cT = wT * ow;                            // · 1/B
  const float cE = wE * f[7] * ow;                     // · 1/τ
  const float cCr = wCo_k * e.rho_min;                 // · r
  const float cCB = wCo_k * e.rho_B;                   // · (B/B0)^γ
  const float cCg = cCB * e.gamma_B;                   // · (B/B0)^γ / B
  const float cR = cTs * -e.lam_a;                     // · r^(-a-1)
  const float a1 = -e.lam_a - 1.0f;
  const float q = f[8] * e.inv_N0;                     // pαg/N0
  const float u_const = fmaf(
      wE * f[6], f_l,
      wT * (f_l * __frcp_rn(f[5]) + ow * f[9] * e.inv_Bbh + f[11] * inv_k));
  const float lrBs = -lr * e.B_span;
  const float lrrs = -lr * e.r_span;

  float xB = x0[2 * i], xr = x0[2 * i + 1];
  for (int it = 0; it < iters; ++it) {
    const BTerms b(fmaf(xB, e.B_span, e.B_min), q, e);
    const float r = fmaf(xr, e.r_span, e.r_min);
    // dτ/dB = L - (q/B)·(1/ln2)·1/(1 + q/B)
    const float dtau = fmaf(-(b.qB * rcp(b.one_qB)), kInvLn2, b.L);
    float dB = fmaf(-(cE * dtau) * b.inv_tau, b.inv_tau,
                    -(cT * b.inv_B) * b.inv_B);
    dB = fmaf(cCg * b.pw, b.inv_B, dB);
    const float dr = fmaf(cR, ex2(a1 * lg2(r)), cCr);
    xB = __saturatef(fmaf(lrBs, dB, xB));
    xr = __saturatef(fmaf(lrrs, dr, xr));
  }

  const BTerms b(fmaf(xB, e.B_span, e.B_min), q, e);
  const float r = fmaf(xr, e.r_span, e.r_min);
  float U = fmaf(cTs, ex2(-e.lam_a * lg2(r)), u_const);
  U = fmaf(cT, b.inv_B, U);
  U = fmaf(cE, b.inv_tau, U);
  U = fmaf(cCr, r, U);
  U = fmaf(cCB, b.pw, U);
  x_out[2 * i] = xB;
  x_out[2 * i + 1] = xr;
  u_out[i] = U;
}

}  // namespace

extern "C" {

// feat (X, 16), x0 and x (X, 2), u (X,): float32, contiguous, on the
// device, 16-byte aligned feat.  `start` (n_groups + 1 ints) and `edges`
// (n_groups rows of the 12 edge constants in the order of ref.py's
// EDGE_KEYS) are host memory: start[0] = 0, non-decreasing, start[n] = X.
int mcsa_ligd_steps_launch(const void* feat, const void* x0, void* x,
                           void* u, int X, int iters, float lr,
                           int n_groups, const int* start,
                           const float* edges, void* stream) {
  if (X < 0 || iters < 0 || n_groups < 1 || n_groups > kMaxGroups ||
      start[0] != 0 || start[n_groups] != X)
    return static_cast<int>(cudaErrorInvalidValue);
  Groups gs{};                            // unused entries stay zero
  gs.n = n_groups;
  for (int j = 0; j <= n_groups; ++j) {
    if (j > 0 && start[j] < start[j - 1])
      return static_cast<int>(cudaErrorInvalidValue);
    gs.start[j] = start[j];
  }
  for (int j = 0; j < n_groups; ++j) {
    // EDGE_KEYS: B_min, B_max, r_min, r_max, lam_a, c_min, rho_min,
    // rho_B, gamma_B, B0, B_backhaul, N0
    const float* v = edges + j * kEdgeKeys;
    gs.g[j] = Group{v[0], v[1] - v[0], v[2], v[3] - v[2], 1.0f / v[11],
                    1.0f / v[9], v[8], v[4], 1.0f / v[5], 1.0f / v[10],
                    v[6], v[7]};
  }
  if (X == 0) return static_cast<int>(cudaSuccess);
  ligd_steps_kernel<<<(X + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feat), static_cast<const float*>(x0),
      static_cast<float*>(x), static_cast<float*>(u), X, iters, lr, gs);
  return static_cast<int>(cudaGetLastError());
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
