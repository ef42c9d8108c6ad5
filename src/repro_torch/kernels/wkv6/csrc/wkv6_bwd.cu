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
// Two bodies, picked by the wrapper (backward.py::body_for) exactly where
// the forward picks its own (kernel.py::body_for): chunked past one chunk
// (S > 64) at N 64, serial otherwise.
//
// Serial body (S <= 64, or N 32): one block per (batch, head), 2N
// threads.
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
//   the steps' vectors, 10 KB: one block an SM.  The serial chain of S
//   dependent steps a block sets its time, not the operations.
//
// Chunked body (S > 64 at N 64; prefill-length training sequences): the
// forward's chunks of L = 64 steps and sub-chunks of SUB = 16, in parallel
// over (batch·head, chunk), five launches:
//   (i)   chunk_state (wkv6_chunk.cuh), the forward's: each chunk's decay
//         P = prod w and dS, its state contribution from zero; and the
//         same product mirrored, dG = sum_t (r_t ⊙ prod_{start<=tau<t} w)
//         dy_t^T, the gradient before the chunk from a zero gradient
//         after it;
//   (ii)  chunk_scan twice, per state element: the start states S_c
//         forward from s0, and the gradients after each chunk Ĝ_c back
//         from ds (Ĝ_{c-1} = diag(P_c) Ĝ_c + dG_c), ds0 the last;
//   (iii) chunk_grad per (batch·head, chunk): the same split one level
//         down, with the states before each sub-chunk p (S_0 = S_c, S_{p+1}
//         = diag(g_p) S_p + sum_{s in p} (k_s ⊙ b_s) v_s^T) and the
//         gradients after it (G_3 = Ĝ_c, G_{p-1} = diag(g_p) G_p +
//         sum_{t in p} (r_t ⊙ a_t) dy_t^T), a_t and b_t the products of w
//         in p before and after t and g_p all of p's.  For step t of p,
//         with D(s, t) = prod_{s<tau<t} w, X1_t = S_p dy_t, X2_t = G_p v_t,
//         M[t][s] = dy_t·v_s, A[t][s] = r_t·(D(s, t) ⊙ k_s):
//           dr_t = a_t X1_t + sum_{s<t} M[t][s] D(s,t) k_s + u k_t M[t][t]
//           dk_t = b_t X2_t + sum_{s>t} M[s][t] D(t,s) r_s + u r_t M[t][t]
//           dv_t = G_p^T (b_t ⊙ k_t) + sum_{s>=t} A[s][t] dy_s
//           dw_t = a_t b_t rowsum(G_p ⊙ S_p) + a_t sum_{s>t} D(t,s) r_s X1_s
//                  + b_t sum_{s<t} D(s,t) k_s X2_s
//                  + sum_{s<t<s'} D(s,t) D(t,s') k_s r_s' M[s'][s]
//         (each D a running product of w from t outwards; the cross term's
//         product over (s, s') less t only as D(s,t) D(t,s'), never a
//         product divided by w_t), and du's partial sum_t r_t k_t M[t][t].
//         The N x N products (the sub-chunk states, X1, X2, G_p^T k^) are
//         register-tiled on the CUDA cores, 4 x 4 a thread, in float32
//         like the forward; a block takes 107 KB of shared memory and two
//         run on an SM.  kernels/wkv6/ref.py::wkv6_chunked_bwd_ref is this
//         arithmetic in plain PyTorch.
//   The workspace holds S_c and Ĝ_c, 2·B·H·ceil(S/64)·N^2 floats (84 MB at
//   rwkv6-3b's training shape, B 4, S 1024, H 40), and chunk_grad's
//   scratch of the states before sub-chunks 1-3, 3·B·H·ceil(S/64)·N^2
//   (126 MB there; the serial body's checkpoints take 335 MB), and du's
//   partials a chunk.
// No atomics in either body: each block owns its outputs and its partial
// of du, and the wrapper sums the partials in a fixed order, so two runs
// on the same inputs give the same bits.
//
// Bound: operations.  A step does about 8 operations a state element
// (the recompute's multiply-add, Ĝ's, and the four products over it:
// S·dy, Ĝ·v, Ĝᵀ·k, Ĝ ⊙ S), against the forward's 3; chip_smoke.py counts
// it so (WKV_BWD_OPS).  The chunked body does about that many
// multiply-adds a step (dS and dG, the sub-chunk states, X1, X2, X3) plus
// the sums inside each 16-step sub-chunk.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_chunk.cuh"   // chunk_state, chunk_scan (shared with the forward)

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


// ===========================================================================
// Chunked body (S > CHUNK at N 64)
// ===========================================================================
namespace bwd_chunked {

using namespace wkv6_chunk;  // L, SUB, NSUB, THREADS, chunk_state, chunk_scan

constexpr int N = 64;
constexpr int RP = N + 4;      // a staged row, step-major (bank spread)
constexpr int TP = SUB + 4;    // a staged row, column-major

// shared memory of chunk_grad, in floats: the sub-chunk's start state S_p
// transposed (ST[j][i]), the gradient after it G_p (GM[i][j]) and
// transposed (GT[j][i]); the sub-chunk's r,
// k, w, v, dy step-major, r^ = r ⊙ a (k^ = k ⊙ b in the S pass), k^, v,
// dy column-major; X1 = S_p dy, X2 = G_p v, X3 = G_p^T k^ (16 x N each);
// M[t][s] = dy_t·v_s and A (16 x 16 each); each sub-chunk's product g of
// w, rowsum(G_p ⊙ S_p) by warp and summed, u, du's partials.
struct Smem {
  static constexpr int ST = 0, GT = ST + N * N, GM = GT + N * N;
  static constexpr int RR = GM + N * N, KR = RR + SUB * RP,
                       WR = KR + SUB * RP, VR = WR + SUB * RP,
                       DYR = VR + SUB * RP, RH = DYR + SUB * RP;
  static constexpr int KHT = RH + SUB * RP, VT = KHT + N * TP,
                       DYT = VT + N * TP;
  static constexpr int X1 = DYT + N * TP, X2 = X1 + SUB * N,
                       X3 = X2 + SUB * N;
  static constexpr int MM = X3 + SUB * N, AA = MM + SUB * SUB;
  static constexpr int GS = AA + SUB * SUB, RHOP = GS + NSUB * N,
                       RHO = RHOP + 8 * N, US = RHO + N, DUP = US + N;
  static constexpr int FLOATS = DUP + 4 * N;
  static constexpr int BYTES = FLOATS * 4;
};
static_assert(THREADS == 256 && N * N == 16 * THREADS && L == N,
              "one 4 x 4 state tile a thread; 16 x 16 tiles of S_p");

// columns 4·sg .. 4·sg + 3 of step t of a (B, S, H, N) tensor, `fill`
// past S
template <typename TS>
__device__ __forceinline__ void fetch4(float (&o)[4], const TS* src, int b,
                                       int t, int h, int S, int H, int col,
                                       float fill) {
  if (t < S) {
    load4(o, src + row_off<N>(b, t, h, S, H) + col);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = fill;
  }
}

// what the sums inside a sub-chunk read: its staged steps, X1..X3, M, A,
// rowsum(G_p ⊙ S_p), u; the column, the sub-chunk's first step, and the
// tensor's coordinates
struct StepIn {
  const float *RR, *KR, *WR, *DYR, *X1, *X2, *X3, *MM, *AA, *RHO, *US;
  int ci, tp0, b, h, S, H;
};

// elements 0 .. LAST of row `row` of M (16 x 16), as float4 loads
template <int LAST>
__device__ __forceinline__ void m_row(float (&m)[SUB], const float* MM,
                                      int row) {
#pragma unroll
  for (int g = 0; g <= LAST / 4; ++g) {
    const float4 q = *reinterpret_cast<const float4*>(MM + row * SUB + 4 * g);
    m[4 * g] = q.x; m[4 * g + 1] = q.y; m[4 * g + 2] = q.z; m[4 * g + 3] = q.w;
  }
}

// step TAU of the sub-chunk, column in.ci: every loop bound a constant,
// D(s, TAU) k_s kept in registers for the cross term
template <int TAU, typename T>
__device__ __forceinline__ void step_sum(const StepIn& in, T* dr, T* dk,
                                         T* dv, float* dw, float& du_acc) {
  const int ci = in.ci;
  float mrow[SUB], c[SUB];
  m_row<TAU>(mrow, in.MM, TAU);
  // s < TAU: D(s, TAU) from s = TAU - 1 down
  float prod = 1.f, acc_r = 0.f, acc_w3 = 0.f;
#pragma unroll
  for (int s = TAU - 1; s >= 0; --s) {
    c[s] = prod * in.KR[s * RP + ci];
    acc_r = fmaf(mrow[s], c[s], acc_r);
    acc_w3 = fmaf(c[s], in.X2[s * N + ci], acc_w3);
    prod *= in.WR[s * RP + ci];
  }
  const float a_t = prod;
  // s' > TAU: D(TAU, s') from s' = TAU + 1 up; the cross term sums
  // D(s, TAU) D(TAU, s') k_s r_s' M[s'][s] over s < TAU < s'
  float acc_k = 0.f, acc_w2 = 0.f, cross = 0.f;
  prod = 1.f;
#pragma unroll
  for (int s2 = TAU + 1; s2 < SUB; ++s2) {
    float mr[SUB];
    m_row<TAU>(mr, in.MM, s2);
    const float d = prod * in.RR[s2 * RP + ci];
    acc_k = fmaf(mr[TAU], d, acc_k);
    acc_w2 = fmaf(d, in.X1[s2 * N + ci], acc_w2);
    float inner = 0.f;
#pragma unroll
    for (int s = TAU - 1; s >= 0; --s) inner = fmaf(c[s], mr[s], inner);
    cross = fmaf(d, inner, cross);
    prod *= in.WR[s2 * RP + ci];
  }
  const float b_t = prod;
  const float bonus = mrow[TAU];
  const float ri = in.RR[TAU * RP + ci], ki = in.KR[TAU * RP + ci];
  const float ui = in.US[ci];
  const int t = in.tp0 + TAU;
  if (t < in.S) {
    const size_t g = row_off<N>(in.b, t, in.h, in.S, in.H) + ci;
    dr[g] = from_f<T>(fmaf(a_t, in.X1[TAU * N + ci],
                           acc_r + ui * ki * bonus));
    dk[g] = from_f<T>(fmaf(b_t, in.X2[TAU * N + ci],
                           acc_k + ui * ri * bonus));
    dw[g] = a_t * b_t * in.RHO[ci] + a_t * acc_w2 + b_t * acc_w3 + cross;
    float acc_v = in.X3[TAU * N + ci];
#pragma unroll
    for (int s2 = TAU; s2 < SUB; ++s2)
      acc_v = fmaf(in.AA[s2 * SUB + TAU], in.DYR[s2 * RP + ci], acc_v);
    dv[g] = from_f<T>(acc_v);
  }
  du_acc = fmaf(ri * ki, bonus, du_acc);
}

// steps TQ, TQ + 4, TQ + 8, TQ + 12 of the sub-chunk, one after another
// (the fences keep the compiler from hoisting one step's loads into the
// previous one, which spills at two blocks an SM)
template <int TQ, typename T>
__device__ __forceinline__ void step_sums(const StepIn& in, T* dr, T* dk,
                                          T* dv, float* dw, float& du_acc) {
  step_sum<TQ>(in, dr, dk, dv, dw, du_acc);
  asm volatile("" ::: "memory");
  step_sum<TQ + 4>(in, dr, dk, dv, dw, du_acc);
  asm volatile("" ::: "memory");
  step_sum<TQ + 8>(in, dr, dk, dv, dw, du_acc);
  asm volatile("" ::: "memory");
  step_sum<TQ + 12>(in, dr, dk, dv, dw, du_acc);
}

// (iii) dr, dk, dv, dw of chunk blockIdx.x of (batch·head) blockIdx.y and
// its partial of du (du_part[bh][c]), from the chunk's start state
// wsS[bh][c] and the gradient after it wsG[bh][c].  Thread (oy, ox) owns
// rows 4·oy.. and columns 4·ox.. of S_p and G_p: a first pass over
// sub-chunks 0-2 forms S_1..S_3 (S_{p+1} = diag(g_p) S_p + sum_{s in p}
// (k_s ⊙ b_s) v_s^T) into a global scratch (kept in registers they would
// spill: the block runs two to an SM at 128 registers a thread), read
// back from L2 by the thread that wrote them; then sub-chunks 3..0 each
// take four
// phases: stage; a, b, g by column with r^ and k^ (and the tiles of S_p
// and G_p into shared memory with rowsum(G_p ⊙ S_p)); the products X1,
// X2, X3 on warps 0-5 beside M and A on warps 6-7; then the steps' sums
// inside the sub-chunk, four (step, column) tasks a thread for dr, dk,
// dw and four for dv, and G_{p-1} = diag(g_p) G_p + sum_{t in p}
// (r_t ⊙ a_t) dy_t^T.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
chunk_grad_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ dy,
                  const float* __restrict__ wsS,
                  const float* __restrict__ wsG, float* __restrict__ wsP,
                  T* __restrict__ dr,
                  T* __restrict__ dk, T* __restrict__ dv,
                  float* __restrict__ dw, float* __restrict__ du_part, int S,
                  int H) {
  using SM = Smem;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *ST = sm + SM::ST, *GT = sm + SM::GT, *GM = sm + SM::GM;
  float *RR = sm + SM::RR, *KR = sm + SM::KR, *WR = sm + SM::WR;
  float *VR = sm + SM::VR, *DYR = sm + SM::DYR, *RH = sm + SM::RH;
  float *KHT = sm + SM::KHT, *VT = sm + SM::VT, *DYT = sm + SM::DYT;
  float *X1 = sm + SM::X1, *X2 = sm + SM::X2, *X3 = sm + SM::X3;
  float *MM = sm + SM::MM, *AA = sm + SM::AA, *GS = sm + SM::GS;
  float *RHOP = sm + SM::RHOP, *RHO = sm + SM::RHO, *US = sm + SM::US;
  float* DUP = sm + SM::DUP;
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, t0 = c * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int oy = tid % 16, ox = tid / 16;     // the state tile's rows, cols
  const int sg = tid / 16, ss = tid % 16;     // staging: columns, step
  const size_t mat = ((size_t)bh * nc + c) * N * N;
  if (tid < N) US[tid] = u[h * N + tid];

  auto load_tile = [&](float (&m)[16], const float* src) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float x[4];
      ld<4>(x, src + (4 * oy + a) * N + 4 * ox);
#pragma unroll
      for (int q = 0; q < 4; ++q) m[4 * a + q] = x[q];
    }
  };

  // 1. S_1 .. S_3 (S_0 is the chunk's start state) into this chunk's
  // scratch wsP[bh][c][p - 1], row-major; each thread reads back only its
  // own tile
  float* sub_states = wsP + ((size_t)bh * nc + c) * (NSUB - 1) * N * N;
  auto store_tile = [&](float* dst, const float (&m)[16]) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float x[4] = {m[4 * a], m[4 * a + 1], m[4 * a + 2], m[4 * a + 3]};
      st<4>(dst + (4 * oy + a) * N + 4 * ox, x);
    }
  };
  {
    float cur[16];
    load_tile(cur, wsS + mat);
#pragma unroll
    for (int p = 0; p < NSUB - 1; ++p) {
      const int t = t0 + p * SUB + ss;
      float x[4];
      fetch4(x, w, b, t, h, S, H, 4 * sg, 1.f);
      st<4>(WR + ss * RP + 4 * sg, x);
      fetch4(x, k, b, t, h, S, H, 4 * sg, 0.f);
      st<4>(KR + ss * RP + 4 * sg, x);
      fetch4(x, v, b, t, h, S, H, 4 * sg, 0.f);
      st<4>(VR + ss * RP + 4 * sg, x);
      __syncthreads();
      if (tid < N) {                   // k^ = k ⊙ b (into RH), g_p
        float bb = 1.f;
#pragma unroll
        for (int s = SUB - 1; s >= 0; --s) {
          RH[s * RP + tid] = KR[s * RP + tid] * bb;
          bb *= WR[s * RP + tid];
        }
        GS[p * N + tid] = bb;
      }
      __syncthreads();
      float g4[4];
      ld<4>(g4, GS + p * N + 4 * oy);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) cur[4 * a + q] *= g4[a];
#pragma unroll 4
      for (int s = 0; s < SUB; ++s) {
        float x4[4], z[4];
        ld<4>(x4, RH + s * RP + 4 * oy);
        ld<4>(z, VR + s * RP + 4 * ox);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            cur[4 * a + q] = fmaf(x4[a], z[q], cur[4 * a + q]);
      }
      store_tile(sub_states + p * N * N, cur);
      __syncthreads();                 // before the next staging
    }
  }

  // 2. sub-chunks from the last, G from the gradient after the chunk
  float G[16];
  load_tile(G, wsG + mat);
  float du_acc = 0.f;
  const int ci = tid % N, tq = tid / N;       // (iii)'s column, step set
#pragma unroll 1
  for (int p = NSUB - 1; p >= 0; --p) {
    const int tp0 = t0 + p * SUB;
    {                                  // stage the sub-chunk
      const int t = tp0 + ss;
      float x[4];
      fetch4(x, w, b, t, h, S, H, 4 * sg, 1.f);
      st<4>(WR + ss * RP + 4 * sg, x);
      fetch4(x, r, b, t, h, S, H, 4 * sg, 0.f);
      st<4>(RR + ss * RP + 4 * sg, x);
      fetch4(x, k, b, t, h, S, H, 4 * sg, 0.f);
      st<4>(KR + ss * RP + 4 * sg, x);
      fetch4(x, v, b, t, h, S, H, 4 * sg, 0.f);
      st<4>(VR + ss * RP + 4 * sg, x);
#pragma unroll
      for (int q = 0; q < 4; ++q) VT[(4 * sg + q) * TP + ss] = x[q];
      fetch4(x, dy, b, t, h, S, H, 4 * sg, 0.f);
      st<4>(DYR + ss * RP + 4 * sg, x);
#pragma unroll
      for (int q = 0; q < 4; ++q) DYT[(4 * sg + q) * TP + ss] = x[q];
    }
    __syncthreads();
    if (tid < N) {                     // r^ = r ⊙ a, k^ = k ⊙ b, g_p
      float aa = 1.f;
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        RH[s * RP + tid] = RR[s * RP + tid] * aa;
        aa *= WR[s * RP + tid];
      }
      float bb = 1.f;
#pragma unroll
      for (int s = SUB - 1; s >= 0; --s) {
        KHT[tid * TP + s] = KR[s * RP + tid] * bb;
        bb *= WR[s * RP + tid];
      }
      GS[p * N + tid] = bb;
    }
    {                                  // S_p, G_p into shared memory
      float Sp[16];
      load_tile(Sp, p == 0 ? wsS + mat : sub_states + (p - 1) * N * N);
      float rp[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        rp[a] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          rp[a] = fmaf(G[4 * a + q], Sp[4 * a + q], rp[a]);
        rp[a] += __shfl_xor_sync(0xffffffffu, rp[a], 16);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float s4[4] = {Sp[q], Sp[4 + q], Sp[8 + q], Sp[12 + q]};
        const float g4[4] = {G[q], G[4 + q], G[8 + q], G[12 + q]};
        st<4>(ST + (4 * ox + q) * N + 4 * oy, s4);
        st<4>(GT + (4 * ox + q) * N + 4 * oy, g4);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float g4[4] = {G[4 * a], G[4 * a + 1], G[4 * a + 2],
                             G[4 * a + 3]};
        st<4>(GM + (4 * oy + a) * N + 4 * ox, g4);
      }
      if (lane < 16) st<4>(RHOP + warp * N + 4 * oy, rp);
    }
    __syncthreads();
    if (warp < 6) {
      // X1 = S_p dy (t, i), X2 = G_p v (t, i), X3 = G_p^T k^ (t, j): a
      // 4 x 4 tile a thread over the contraction index
      const int job = warp / 2, tp = tid % 64, tt = tp / 16, it = tp % 16;
      const float* A_ = job == 0 ? DYT : job == 1 ? VT : KHT;
      const float* B_ = job == 0 ? ST : job == 1 ? GT : GM;
      float* out = job == 0 ? X1 : job == 1 ? X2 : X3;
      float acc[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[e][q] = 0.f;
#pragma unroll 8
      for (int j = 0; j < N; ++j) {
        float x[4], z[4];
        ld<4>(x, A_ + j * TP + 4 * tt);
        ld<4>(z, B_ + j * N + 4 * it);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[e][q] = fmaf(x[e], z[q], acc[e][q]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) st<4>(out + (4 * tt + e) * N + 4 * it,
                                       acc[e]);
    } else {
      // rowsum(G_p ⊙ S_p); M[t][s] = dy_t·v_s (s <= t) and A[t][s] =
      // r_t·(D(s, t) ⊙ k_s) (s < t), A[t][t] = r_t·(u ⊙ k_t): 4 threads
      // a step t, each over columns part + 4·qq, meeting by shuffles
      const int tp = tid - 192, t = tp / 4, part = tp % 4;
      {
        float s_ = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < 8; ++w8) s_ += RHOP[w8 * N + tp];
        RHO[tp] = s_;
      }
      {
        float dyt[N / 4];
#pragma unroll
        for (int qq = 0; qq < N / 4; ++qq) dyt[qq] = DYR[t * RP + part + 4 * qq];
        for (int s = 0; s < SUB; ++s) {
          float m = 0.f;
#pragma unroll
          for (int qq = 0; qq < N / 4; ++qq)
            m = fmaf(dyt[qq], VR[s * RP + part + 4 * qq], m);
          m += __shfl_xor_sync(0xffffffffu, m, 1);
          m += __shfl_xor_sync(0xffffffffu, m, 2);
          if (s <= t && part == 0) MM[t * SUB + s] = m;
        }
      }
      float rt[N / 4], prod[N / 4];
      float bonus = 0.f;
#pragma unroll
      for (int qq = 0; qq < N / 4; ++qq) {
        const int col = part + 4 * qq;
        rt[qq] = RR[t * RP + col];
        prod[qq] = 1.f;
        bonus += rt[qq] * (US[col] * KR[t * RP + col]);
      }
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
      if (part == 0) AA[t * SUB + t] = bonus;
      for (int j = 1; j < SUB; ++j) {  // s = t - j, the same trip count
        const int s = t - j;           // for every lane (shuffles)
        const bool ok = s >= 0;
        const int sr = ok ? s : t;
        float a = 0.f;
#pragma unroll
        for (int qq = 0; qq < N / 4; ++qq) {
          const int col = part + 4 * qq;
          a += rt[qq] * (prod[qq] * KR[sr * RP + col]);
          prod[qq] *= WR[sr * RP + col];
        }
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        if (ok && part == 0) AA[t * SUB + s] = a;
      }
    }
    __syncthreads();
    // the sums inside the sub-chunk: tasks (tau, column ci), tau = tq +
    // 4m; tq is the same across a warp
    {
      const StepIn in{RR, KR, WR, DYR, X1, X2, X3, MM, AA, RHO, US,
                      ci, tp0, b, h, S, H};
      switch (tq) {
        case 0: step_sums<0>(in, dr, dk, dv, dw, du_acc); break;
        case 1: step_sums<1>(in, dr, dk, dv, dw, du_acc); break;
        case 2: step_sums<2>(in, dr, dk, dv, dw, du_acc); break;
        default: step_sums<3>(in, dr, dk, dv, dw, du_acc); break;
      }
    }
    if (p > 0) {                       // G_{p-1}, G_p from GT
      float g4[4];
      ld<4>(g4, GS + p * N + 4 * oy);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float x[4];
        ld<4>(x, GT + (4 * ox + q) * N + 4 * oy);
#pragma unroll
        for (int a = 0; a < 4; ++a) G[4 * a + q] = g4[a] * x[a];
      }
#pragma unroll 4
      for (int s = 0; s < SUB; ++s) {
        float x4[4], z[4];
        ld<4>(x4, RH + s * RP + 4 * oy);
        ld<4>(z, DYR + s * RP + 4 * ox);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            G[4 * a + q] = fmaf(x4[a], z[q], G[4 * a + q]);
      }
    }
    __syncthreads();
  }
  DUP[tq * N + ci] = du_acc;
  __syncthreads();
  if (tid < N)
    du_part[((size_t)bh * nc + c) * N + tid] =
        (DUP[tid] + DUP[N + tid]) + (DUP[2 * N + tid] + DUP[3 * N + tid]);
}

// (i) and (ii) of the backward, named apart from the forward's launches
template <typename T, bool REV, typename TV>
__global__ void __launch_bounds__(THREADS)
bwd_state_kernel(const T* __restrict__ k, const TV* __restrict__ v,
                 const float* __restrict__ w, float* __restrict__ ws,
                 float* __restrict__ pw, int S, int H) {
  chunk_state<T, N, REV, TV>(k, v, w, ws, pw, S, H);
}

template <bool REV>
__global__ void __launch_bounds__(THREADS)
bwd_scan_kernel(float* ws, const float* __restrict__ pw, const float* s0,
                float* s_final, int nc, int total) {
  chunk_scan<N, REV>(ws, pw, s0, s_final, nc, total);
}

// float32 workspace of the chunked body, in floats: the start states and
// the gradients after each chunk (B·H, nc, N, N) each, the chunks' decays
// P (B·H, nc, N), and the states before sub-chunks 1-3 (B·H, nc, 3, N, N),
// chunk_grad's scratch
size_t workspace_floats(int B, int S, int H) {
  const size_t bhn = (size_t)B * H, nc = (S + L - 1) / L;
  return 2 * bhn * nc * N * N + bhn * nc * N + bhn * nc * (NSUB - 1) * N * N;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, const float* dy, const float* ds,
           void* dr, void* dk, void* dv, float* dw, float* du_part,
           float* ds0, float* ws, int B, int S, int H, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunk_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  const size_t bhn = (size_t)B * H;
  const int nc = (S + L - 1) / L;
  float* wsS = ws;
  float* wsG = wsS + bhn * nc * N * N;
  float* pw = wsG + bhn * nc * N * N;
  float* wsP = pw + bhn * nc * N;
  const dim3 grid(nc, B * H);
  bwd_state_kernel<T, false, T><<<grid, THREADS, 0, st>>>(
      (const T*)k, (const T*)v, w, wsS, pw, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_state_kernel<T, true, float><<<grid, THREADS, 0, st>>>(
      (const T*)r, dy, w, wsG, nullptr, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = B * H * N * N;
  const int blocks = (total + THREADS - 1) / THREADS;
  bwd_scan_kernel<false><<<blocks, THREADS, 0, st>>>(wsS, pw, s0, nullptr,
                                                     nc, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_scan_kernel<true><<<blocks, THREADS, 0, st>>>(
      wsG, pw, ds, ds0, nc, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_grad_kernel<T><<<grid, THREADS, Smem::BYTES, st>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, dy, wsS, wsG, wsP,
      (T*)dr, (T*)dk, (T*)dv, dw, du_part, S, H);
  return (int)cudaGetLastError();
}

}  // namespace bwd_chunked

}  // namespace

extern "C" {

// dtype of r/k/v and dr/dk/dv: 0 = float32, 1 = bfloat16.  w, u, s0, dy,
// ds, dw, du_part, ds0 (B, H, n, n) and ws are float32; s0 and ds may be
// null (zeros) and ds0 null (not wanted).  All contiguous.  body 0
// (serial): n 32 or 64, du_part (B, H, n), ws the checkpoints (B·H,
// mcsa_wkv6_bwd_segments(S), n, n).  body 1 (chunked): n 64, B·H at most
// 65535, du_part (B, H, ceil(S / 64), n), ws
// mcsa_wkv6_bwd_workspace_floats(B, S, H, n, 1) floats.
int mcsa_wkv6_bwd_launch(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         const void* dy, const void* ds, void* dr, void* dk,
                         void* dv, void* dw, void* du_part, void* ds0,
                         void* ws, int B, int S, int H, int n, int dtype,
                         int body, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *wf = (const float*)w, *uf = (const float*)u;
  const float *s0f = (const float*)s0, *dyf = (const float*)dy;
  const float* dsf = (const float*)ds;
  float *dwf = (float*)dw, *duf = (float*)du_part, *ds0f = (float*)ds0;
  float* wsf = (float*)ws;
  if (body == 0 && dtype == 0)
    return launch<float>(r, k, v, wf, uf, s0f, dyf, dsf, dr, dk, dv, dwf,
                         duf, ds0f, wsf, B, S, H, n, st);
  if (body == 0 && dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, dyf, dsf, dr, dk, dv,
                                 dwf, duf, ds0f, wsf, B, S, H, n, st);
  if (body == 1 && n == 64 && dtype == 0)
    return bwd_chunked::launch<float>(r, k, v, wf, uf, s0f, dyf, dsf, dr, dk,
                                      dv, dwf, duf, ds0f, wsf, B, S, H, st);
  if (body == 1 && n == 64 && dtype == 1)
    return bwd_chunked::launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, dyf, dsf,
                                              dr, dk, dv, dwf, duf, ds0f, wsf,
                                              B, S, H, st);
  return (int)cudaErrorInvalidValue;
}

// Checkpoints the serial body's workspace holds for S steps: one every SEG
// steps.
int mcsa_wkv6_bwd_segments(int S) { return (S + SEG - 1) / SEG; }

// Floats of the float32 workspace a body takes (0 serial, 1 chunked).
long long mcsa_wkv6_bwd_workspace_floats(int B, int S, int H, int n,
                                         int body) {
  if (body == 1) return (long long)bwd_chunked::workspace_floats(B, S, H);
  return (long long)B * H * mcsa_wkv6_bwd_segments(S) * n * n;
}

// The chunked body's chunk length (steps).
int mcsa_wkv6_bwd_chunk() { return wkv6_chunk::L; }

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
