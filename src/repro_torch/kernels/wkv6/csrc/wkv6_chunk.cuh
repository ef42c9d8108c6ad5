// The chunk-level passes of the chunked WKV6 bodies, shared by the forward
// (wkv6.cu) and the backward (wkv6_bwd.cu): the per-chunk product
// (chunk_state) and the serial pass over chunks (chunk_scan), each in the
// forward's direction and mirrored in time for the backward's gradients.
// Layout as in wkv6.cu: r, k, v, w (B, S, H, N), chunks of L = 64 steps
// cut into sub-chunks of SUB = 16; every decay a sequential product of w
// (never an exp of a cumulated log w: w reaches 0 and 1).
//
// kernels/_build.py hashes this header with every source that includes
// it, so an edit here rebuilds both libraries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv6_chunk {

constexpr int L = 64;                  // steps a chunk
constexpr int SUB = 16;                // steps a sub-chunk
constexpr int NSUB = L / SUB;
constexpr int THREADS = 256;

template <int W>
__device__ __forceinline__ void ld(float (&d)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x; d[1] = v.y;
  }
}

template <int W>
__device__ __forceinline__ void st(float* p, const float (&d)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
}

// offset of (b, step t, head h, column 0) in a (B, S, H, N) tensor
template <int N>
__device__ __forceinline__ size_t row_off(int b, int t, int h, int S,
                                          int H) {
  return (((size_t)b * S + t) * H + h) * N;
}

// 4 consecutive values at p (16-byte aligned for float, 8 for bf16) as
// float32
__device__ __forceinline__ void load4(float (&o)[4], const float* p) {
  ld<4>(o, p);
}
__device__ __forceinline__ void load4(float (&o)[4],
                                      const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// (i) of chunk blockIdx.x of (batch·head) blockIdx.y, into ws[bh][c]
// (N x N):
//   forward (REV false): dS = sum_s (k_s ⊙ prod_{s<tau<end} w) v_s^T, the
//     chunk's contribution to the state from a zero state, and its decay
//     P = prod w into pw[bh][c] (N);
//   backward (REV true, k = r, v = dy in TV): dG = sum_t (r_t ⊙
//     prod_{start<=tau<t} w) dy_t^T, the gradient before the chunk from a
//     zero gradient after it; pw is not written.
// Each factor is the product inside the step's sub-chunk times the whole
// sub-chunks' products after it (before it, mirrored), each at most 1.
// The body of a THREADS-thread block; each source launches it through a
// kernel of its own name (chunk_state_kernel here for the forward).
template <typename T, int N, bool REV = false, typename TV = T>
__device__ __forceinline__ void chunk_state(const T* __restrict__ k,
                                            const TV* __restrict__ v,
                                            const float* __restrict__ w,
                                            float* __restrict__ ws,
                                            float* __restrict__ pw, int S,
                                            int H) {
  constexpr int TM = N / 16;           // rows i and columns j a thread
  __shared__ __align__(16) float ks[L][N];
  __shared__ __align__(16) float vs[L][N];
  __shared__ float gs[NSUB][N];
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, t0 = c * L;
  const int tid = threadIdx.x;

  {
    constexpr int NG = L * N / 4 / THREADS;
    float kv[NG][4], vv[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int e = 4 * (tid + j * THREADS), t = e / N, i = e % N;
      if (t0 + t < S) {
        const size_t off = row_off<N>(b, t0 + t, h, S, H) + i;
        load4(kv[j], k + off);
        load4(vv[j], v + off);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) kv[j][q] = vv[j][q] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int e = 4 * (tid + j * THREADS), t = e / N, i = e % N;
      st<4>(&ks[t][i], kv[j]);
      st<4>(&vs[t][i], vv[j]);
    }
  }
  // thread (p, i): the products of w in sub-chunk p, column i
  const int p = tid / N, i = tid % N;
  float bsuf[SUB];                     // prod over (s, end of p), or
  if (p < NSUB) {                      // [start of p, s) when REV
    float wv[SUB];
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      const int t = t0 + p * SUB + s;
      wv[s] = t < S ? w[row_off<N>(b, t, h, S, H) + i] : 1.f;
    }
    float a = 1.f;                     // prod of w over the sub-chunk
#pragma unroll
    for (int s = 0; s < SUB; ++s) a *= wv[s];
    gs[p][i] = a;
    if constexpr (REV) {
      bsuf[0] = 1.f;
#pragma unroll
      for (int s = 1; s < SUB; ++s) bsuf[s] = bsuf[s - 1] * wv[s - 1];
    } else {
      bsuf[SUB - 1] = 1.f;
#pragma unroll
      for (int s = SUB - 2; s >= 0; --s) bsuf[s] = bsuf[s + 1] * wv[s + 1];
    }
  }
  __syncthreads();
  if (p < NSUB) {
    float gsuf = 1.f;
    if constexpr (REV) {
      for (int q = 0; q < p; ++q) gsuf *= gs[q][i];
    } else {
      for (int q = NSUB - 1; q > p; --q) gsuf *= gs[q][i];
    }
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      float* kp = &ks[p * SUB + s][i];
      *kp = (*kp * bsuf[s]) * gsuf;
    }
    if (!REV && p == 0) {
      float P = 1.f;
#pragma unroll
      for (int q = 0; q < NSUB; ++q) P *= gs[q][i];
      pw[((size_t)bh * nc + c) * N + i] = P;
    }
  }
  __syncthreads();
  // ws[i][j] = sum_s ks[s][i] vs[s][j]: a TM x TM tile a thread
  const int ty = tid / 16, tx = tid % 16;
  float acc[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int q = 0; q < TM; ++q) acc[a][q] = 0.f;
#pragma unroll 8
  for (int s = 0; s < L; ++s) {
    float x[TM], z[TM];
    ld<TM>(x, &ks[s][ty * TM]);
    ld<TM>(z, &vs[s][tx * TM]);
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int q = 0; q < TM; ++q) acc[a][q] = fmaf(x[a], z[q], acc[a][q]);
  }
  float* out = ws + ((size_t)bh * nc + c) * N * N;
#pragma unroll
  for (int a = 0; a < TM; ++a)
    st<TM>(out + (ty * TM + a) * N + tx * TM, acc[a]);
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ w, float* __restrict__ ws,
                   float* __restrict__ pw, int S, int H) {
  chunk_state<T, N>(k, v, w, ws, pw, S, H);
}

// (ii) per state element e of (batch·head, i, j), serially over chunks:
//   forward (REV false): in order from s0 (or zero), the start state of
//     chunk c replaces dS_c in ws and s_final gets the end state,
//     S_{c+1} = diag(P_c) S_c + dS_c;
//   backward (REV true): from the last chunk back, from s0 = the final
//     state's gradient (or zero), the gradient after chunk c replaces dG_c
//     and s_final gets the gradient before chunk 0,
//     Ĝ_{c-1} = diag(P_c) Ĝ_c + dG_c.
// s_final may be null (not wanted).  Each group's reads are issued before
// its writes.  The body of a THREADS-thread block (chunk_scan_kernel here
// for the forward).
template <int N, bool REV = false>
__device__ __forceinline__ void chunk_scan(float* ws,
                                           const float* __restrict__ pw,
                                           const float* s0, float* s_final,
                                           int nc, int total) {
  constexpr int G = 16;                // chunks read ahead
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int bh = e / (N * N), ij = e % (N * N), i = ij / N;
  float s = s0 ? s0[e] : 0.f;
  float* base = ws + (size_t)bh * nc * N * N + ij;
  const float* pb = pw + (size_t)bh * nc * N + i;
  for (int c0 = 0; c0 < nc; c0 += G) {
    float d[G], P[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = REV ? nc - 1 - (c0 + g) : c0 + g;
      d[g] = c0 + g < nc ? base[(size_t)c * N * N] : 0.f;
      P[g] = c0 + g < nc ? pb[(size_t)c * N] : 1.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (c0 + g < nc) {
        const int c = REV ? nc - 1 - (c0 + g) : c0 + g;
        base[(size_t)c * N * N] = s;
        s = P[g] * s + d[g];
      }
    }
  }
  if (s_final) s_final[e] = s;
}

template <int N>
__global__ void __launch_bounds__(THREADS)
chunk_scan_kernel(float* ws, const float* __restrict__ pw, const float* s0,
                  float* s_final, int nc, int total) {
  chunk_scan<N>(ws, pw, s0, s_final, nc, total);
}

}  // namespace wkv6_chunk
