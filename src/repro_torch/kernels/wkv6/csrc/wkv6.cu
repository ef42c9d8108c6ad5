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
// here the chunks of the sequence become parallel blocks, and the state
// at each chunk's start comes from a short serial pass over chunks.
//
// Two bodies, picked by the wrapper (kernel.py::body_for) from S:
//
// * serial (S <= CHUNK, e.g. decode at S 1): one block owns one (batch,
//   head) and walks every step.  P = 4 neighbouring threads share a v
//   column j, each holding N/P rows of S[:, j] in registers.  Steps are
//   staged TC at a time: r_t, k_t, v_t, w_t of TC steps go to shared
//   memory (u·k premultiplied; rows padded one word per part so the P
//   parts read different banks), one barrier, then each thread runs the
//   TC steps from shared-memory broadcasts, and the P partial sums of
//   y_j and of the bonus meet by two warp shuffles.
// * chunked (S > CHUNK, prefill): the sequence is cut into chunks of
//   CHUNK = 64 steps, in three launches (kernel.py::wkv6_cuda); (i) and
//   (ii) live in wkv6_chunk.cuh, which the backward shares:
//     (i)   chunk_state: per (batch·head, chunk) in parallel, the chunk's
//           decay P = prod w and its contribution from a zero state,
//           dS = sum_s (k_s ⊙ prod_{s<tau<end} w_tau) v_s^T, a 64-step
//           product on the CUDA cores, into a float32 workspace;
//     (ii)  chunk_scan: per state element, serially over chunks,
//           S_{c+1} = diag(P_c) S_c + dS_c, writing each chunk's start
//           state over its dS (read first) and s_final last;
//     (iii) chunk_out: per (batch·head, chunk) in parallel,
//           y_t = (r_t ⊙ prod_{start<=tau<t} w)^T S_c
//                 + sum_{s<t} A[t,s] v_s + v_t (r_t·(u ⊙ k_t)),
//           as one product [r~ | A] · [S_c ; V] over the chunk.
//   A's blocks between sub-chunks of SUB = 16 steps are factored at the
//   boundary of t's sub-chunk: (r_t ⊙ a_t ⊙ prod_{q<m<p} g_m)·(k_s ⊙ b_s)
//   with a_t, b_s the products of w inside the sub-chunk before t and
//   after s and g_m a whole sub-chunk's product, every factor at most 1,
//   so nothing overflows; inside a sub-chunk A is summed with a running
//   product of w.  Every decay is a sequential product of w and never an
//   exp of cumulated log w: the model's w reaches 0 (exp(-e^10)) and 1
//   (exp(-e^-20)), where log w is -inf and differences of large sums
//   lose digits.  All arithmetic is float32 on the CUDA cores (TF32
//   keeps ~1e-3; the checks hold y to 1e-6 of its RMS).  In chunk_out,
//   rows of r, k and w are padded to N + 1 words so the lanes that read
//   one column of several rows hit distinct banks; r^ and k^ are then
//   transposed so the blocks of A between sub-chunks are register-tiled
//   vector products; v and the start state are loaded last, over buffers
//   dead by then, so a block takes 68 KB and three run on an SM (two an
//   SM were slower in a trial build).
//   kernels/wkv6/ref.py::wkv6_chunked_ref is this arithmetic in plain
//   PyTorch.
//
// Bound: every state element takes 3 operations a step (serial form);
// at rwkv6-3b's prefill (B 4, S 1024, H 40, N 64) they bind, slightly
// above the bytes.  The serial body runs B·H blocks (160 at B 4, 40 at
// an engine prefill, on 132 SMs), each a chain of S dependent steps, so
// latency sets its time (0.678 ms there).  The chunked body does about
// 3.3 N^2 multiply-adds a step (dS, r~·S_c, the off-diagonal A and A·V
// over the lower triangle), in register-tiled products over B·H·S/64
// blocks (2,560 at prefill), plus the workspace of start states (N^2
// floats a chunk, written twice and read twice).
//
// Aliasing: decode passes the cache's own state as s0 and as s_final.
// In both bodies each thread reads its state elements before writing
// the same elements, and those (and blocks) are disjoint, so that is
// safe; the two pointers are therefore not __restrict__.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; each
// launch goes on the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_chunk.cuh"   // chunk_state, chunk_scan (shared with the backward)

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

// ===========================================================================
// Chunked body
// ===========================================================================
namespace chunked {

using namespace wkv6_chunk;  // L, SUB, chunk_state, chunk_scan, helpers

// shared memory of chunk_out: r (then r^, then k^ transposed, then the
// start state), k (then k^, then v) and w (then r^ transposed), with rows
// padded to NP = N + 1 words so threads reading one column of several
// rows hit distinct banks; A transposed (At[s][t]), the sub-chunk
// products g and G_pre, u.  v and the start state are loaded only for
// the last product, into buffers dead by then, which keeps a block at 68
// KB and three blocks on an SM.
template <int N>
struct OutSmem {
  static constexpr int NP = N + 1;
  static constexpr int FLOATS = 3 * L * NP + L * L + 2 * NSUB * N + N;
  static constexpr int BYTES = FLOATS * 4;
};

// (iii) y of chunk blockIdx.x of (batch·head) blockIdx.y from its start
// state ws[bh][c].
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
chunk_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ ws,
                 float* __restrict__ y, int S, int H) {
  static_assert(N == L, "v and the start state share one loop");
  constexpr int NP = OutSmem<N>::NP;
  constexpr int TN = N / 16;           // columns j a thread (4 rows t)
  constexpr int NQ = N / 4;            // columns i a thread in step 1
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);     // [L][NP]
  float* ks = rs + L * NP;                         // [L][NP]
  float* wsh = ks + L * NP;                        // [L][NP], then rT
  float* At = wsh + L * NP;                        // [L][L], At[s][t]
  float* gs = At + L * L;                          // [NSUB][N]
  float* gp = gs + NSUB * N;                       // [NSUB][N]
  float* us = gp + NSUB * N;                       // [N]
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, t0 = c * L;
  const int tid = threadIdx.x;

  {
    constexpr int NG = L * N / 4 / THREADS;
    float rv[NG][4], kv[NG][4], wv[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int e = 4 * (tid + j * THREADS), t = e / N, i = e % N;
      if (t0 + t < S) {
        const size_t off = row_off<N>(b, t0 + t, h, S, H) + i;
        load4(rv[j], r + off);
        load4(kv[j], k + off);
        load4(wv[j], w + off);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          rv[j][q] = kv[j][q] = 0.f;
          wv[j][q] = 1.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int e = 4 * (tid + j * THREADS), t = e / N, i = e % N;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rs[t * NP + i + q] = rv[j][q];
        ks[t * NP + i + q] = kv[j][q];
        wsh[t * NP + i + q] = wv[j][q];
      }
    }
  }
  for (int e = tid; e < L * L; e += THREADS) At[e] = 0.f;
  if (tid < N) us[tid] = u[h * N + tid];
  __syncthreads();

  // 1. A inside each sub-chunk (s < t) and on its diagonal (the bonus):
  // 4 neighbouring threads split i for one t (part p takes i = 8p + q +
  // 32m, so the 32 lanes' rows and columns fall on distinct banks) and
  // meet by shuffles
  {
    const int t = tid / 4, part = tid % 4;
    const int ts = t - t % SUB;        // first step of t's sub-chunk
    auto col = [&](int qq) { return 8 * part + qq % 8 + 32 * (qq / 8); };
    float rt[NQ], prod[NQ];
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      rt[qq] = rs[t * NP + col(qq)];
      prod[qq] = 1.f;
    }
    float bonus = 0.f;
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
      bonus += rt[qq] * (us[col(qq)] * ks[t * NP + col(qq)]);
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
    if (part == 0) At[t * L + t] = bonus;
    for (int j = 1; j < SUB; ++j) {    // s = t - j, the same trip count
      const int s = t - j;             // for every lane (shuffles)
      const bool ok = s >= ts;
      const int sr = ok ? s : t;       // a row in range either way
      float a = 0.f;
#pragma unroll
      for (int qq = 0; qq < NQ; ++qq) {
        a += rt[qq] * (prod[qq] * ks[sr * NP + col(qq)]);
        prod[qq] *= wsh[sr * NP + col(qq)];
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (ok && part == 0) At[s * L + t] = a;
    }
  }
  __syncthreads();

  // 2. thread (p, i): r^ = r ⊙ a and k^ = k ⊙ b in place, and g_p
  {
    const int p = tid / N, i = tid % N;
    if (p < NSUB) {
      float a = 1.f;
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        const int t = p * SUB + s;
        rs[t * NP + i] *= a;
        a *= wsh[t * NP + i];
      }
      gs[p * N + i] = a;
      float bb = 1.f;
#pragma unroll
      for (int s = SUB - 1; s >= 0; --s) {
        const int t = p * SUB + s;
        ks[t * NP + i] *= bb;
        bb *= wsh[t * NP + i];
      }
    }
  }
  __syncthreads();

  // 3. r^ and k^ transposed to i-major (rT over w, kT over r), so the
  // products below read a few neighbouring steps of one column i as one
  // vector that the lanes share; and G_pre of each sub-chunk
  float* rT = wsh;                                 // [N][L]
  float* kT = rs;                                  // [N][L]
  {
    constexpr int PER = N * L / THREADS;
    float rv[PER], kv[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * THREADS, i = e / L, t = e % L;
      rv[j] = rs[t * NP + i];
      kv[j] = ks[t * NP + i];
    }
    if (tid < NSUB * N) {
      const int p = tid / N, i = tid % N;
      float gpre = 1.f;
      for (int q = 0; q < p; ++q) gpre *= gs[q * N + i];
      gp[tid] = gpre;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * THREADS;
      rT[e] = rv[j];
      kT[e] = kv[j];
    }
  }
  __syncthreads();
  // the blocks of A between sub-chunks: a task is 4 steps t of sub-chunk
  // p and 2 steps s of sub-chunk q < p; the 32 tasks of a pair (p, q)
  // fill one warp, so prod_{q<m<p} g_m is the same for its lanes
  constexpr int PAIRS = NSUB * (NSUB - 1) / 2;
  for (int task = tid; task < PAIRS * 32; task += THREADS) {
    const int pair = task / 32, tq = (task % 32) / 8, sp = task % 8;
    int p = 1, q = pair;
    while (q >= p) {
      q -= p;
      ++p;
    }
    const int ta = p * SUB + 4 * tq, sa = q * SUB + 2 * sp;
    float acc[4][2] = {};
#pragma unroll 8
    for (int i = 0; i < N; ++i) {
      float mid = 1.f;
      for (int m = p - 1; m > q; --m) mid *= gs[m * N + i];
      float x[4], z[2];
      ld<4>(x, rT + i * L + ta);
      ld<2>(z, kT + i * L + sa);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xm = x[e] * mid;
        acc[e][0] = fmaf(xm, z[0], acc[e][0]);
        acc[e][1] = fmaf(xm, z[1], acc[e][1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      At[sa * L + ta + e] = acc[e][0];
      At[(sa + 1) * L + ta + e] = acc[e][1];
    }
  }
  __syncthreads();

  // v (over k^) and the start state (over k^ transposed)
  float* vs = ks;                                  // [L][N]
  float* Ss = rs;                                  // [N][N]
  {
    constexpr int NG = L * N / 4 / THREADS;
    const float* s_c = ws + ((size_t)bh * nc + c) * N * N;
    float vv[NG][4], sv[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int e = 4 * (tid + j * THREADS), t = e / N, i = e % N;
      if (t0 + t < S) {
        load4(vv[j], v + row_off<N>(b, t0 + t, h, S, H) + i);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) vv[j][q] = 0.f;
      }
      ld<4>(sv[j], s_c + e);
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int e = 4 * (tid + j * THREADS);
      st<4>(vs + e, vv[j]);
      st<4>(Ss + e, sv[j]);
    }
  }
  __syncthreads();

  // 4. y[t][j] = sum_i r~[t][i] S[i][j] + sum_s At[s][t] v[s][j]: rows
  // 4ty..4ty+3, TN columns from tx·TN.  Warp w's rows end before 8w + 8,
  // so its steps s from there on are zero in A and skipped.
  const int ty = tid / 16, tx = tid % 16;
  const int s_end = 8 * (tid / 32) + 8;
  float acc[4][TN];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[a][q] = 0.f;
  const float* gpt = gp + (ty * 4 / SUB) * N;   // this thread's G_pre
#pragma unroll 4
  for (int ii = 0; ii < N; ++ii) {
    float x[4], z[TN];
    ld<4>(x, rT + ii * L + ty * 4);
    ld<TN>(z, Ss + ii * N + tx * TN);
    const float gpre = gpt[ii];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] *= gpre;       // r~ = r^ ⊙ G_pre
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < TN; ++q) acc[a][q] = fmaf(x[a], z[q], acc[a][q]);
  }
#pragma unroll 4
  for (int s = 0; s < s_end; ++s) {
    float x[4], z[TN];
    ld<4>(x, At + s * L + ty * 4);
    ld<TN>(z, vs + s * N + tx * TN);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < TN; ++q) acc[a][q] = fmaf(x[a], z[q], acc[a][q]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0 + ty * 4 + a;
    if (t < S) st<TN>(y + row_off<N>(b, t, h, S, H) + tx * TN, acc[a]);
  }
}

template <typename T, int N>
int launch_n(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* y, float* s_final,
             float* ws, float* pw, int B, int S, int H,
             cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunk_out_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      OutSmem<N>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int nc = (S + L - 1) / L;
  const dim3 grid(nc, B * H);
  chunk_state_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      (const T*)k, (const T*)v, w, ws, pw, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = B * H * N * N;
  chunk_scan_kernel<N><<<(total + THREADS - 1) / THREADS, THREADS, 0,
                         stream>>>(ws, pw, s0, s_final, nc, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_out_kernel<T, N><<<grid, THREADS, OutSmem<N>::BYTES, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, ws, y, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* s_final,
           float* ws, float* pw, int B, int S, int H, int n,
           cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535 || ws == nullptr ||
      pw == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 64)
    return launch_n<T, 64>(r, k, v, w, u, s0, y, s_final, ws, pw, B, S, H,
                           stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace chunked

}  // namespace

extern "C" {

// dtype of r/k/v: 0 = float32, 1 = bfloat16.  w, u, s0, y, s_final are
// float32; s0 may be null (zero state) and may equal s_final.  n is 32 or
// 64.  All contiguous.  body: 0 = serial, 1 = chunked; the chunked body
// needs float32 workspaces ws (B·H, nc, n, n) and pw (B·H, nc, n), with
// nc = ceil(S / 64) (mcsa_wkv6_chunk), and ignores them otherwise.
int mcsa_wkv6_launch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* y,
                     void* s_final, void* ws, void* pw, int B, int S, int H,
                     int n, int dtype, int body, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* wf = (const float*)w;
  const float* uf = (const float*)u;
  const float* s0f = (const float*)s0;
  float* yf = (float*)y;
  float* sf = (float*)s_final;
  float* wsf = (float*)ws;
  float* pwf = (float*)pw;
  if (body == 0 && dtype == 0)
    return launch<float>(r, k, v, wf, uf, s0f, yf, sf, B, S, H, n, st);
  if (body == 0 && dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, yf, sf, B, S, H, n,
                                 st);
  if (body == 1 && dtype == 0)
    return chunked::launch<float>(r, k, v, wf, uf, s0f, yf, sf, wsf, pwf, B,
                                  S, H, n, st);
  if (body == 1 && dtype == 1)
    return chunked::launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, yf, sf, wsf,
                                          pwf, B, S, H, n, st);
  return (int)cudaErrorInvalidValue;
}

// The chunked body's chunk length (steps).
int mcsa_wkv6_chunk() { return chunked::L; }

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
