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
// 2560, C 4096) 419 MB, 0.125 ms at 3.35 TB/s.  One thread a (batch,
// channel) walking all of time keeps too few bytes in flight for that
// (8,192 threads there), so time is split across blocks:
//   * a block owns 32 channels (a warp's lanes: each load and store of a
//     warp is one 128-byte line) and a chunk of CHUNK = 128 steps; warp w
//     holds steps 16w .. 16w + 15 of it in registers (a_t, dh_t, h_{t-1};
//     h_{t-1} is the forward's output, never recomputed or divided out:
//     a may be 0);
//   * each warp's reverse scan from a zero carry gives its aggregate: the
//     carry C = a_{t+1} g_{t+1} entering a stretch of steps from the later
//     ones leaves it as L + P C, with P = prod a over the stretch and L =
//     a_first g^loc_first; warp 0 composes the 8 warps' (P, L) from the
//     last, (P, L) <- (P_q P, L_q + P_q L), into the chunk's;
//   * the carry into the chunk comes from the later chunk (below); warp 0
//     then forms each warp's carry, C_{q-1} = L_q + P_q C_q, and every warp
//     re-runs the fmaf(a, g, dh) recurrence from its carry on the values
//     it holds, writing da and db;
//   * one pass, 20 bytes an element: blocks take their chunk by an atomic
//     ticket in reverse time order, and a chunk waits for the later
//     chunk's published carry (a flag, release and acquire at device
//     scope) and publishes its own, L + P C.  A block waits only on a
//     block with an earlier ticket, which is running or done, so the chain
//     cannot deadlock; the wait is bounded and traps rather than hangs.
//     No atomics touch any value, so two runs give the same bits.
// Steps past S (a = dh = 0) and channels past C are zeros and never
// stored.  kernels/rglru/ref.py::rglru_scan_bwd_chunked_ref is this
// arithmetic in plain PyTorch.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; each launch
// goes on the caller's stream and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SUB = 16;                // steps a warp
constexpr int CHUNK = SUB * WARPS;     // steps a block
constexpr long long SPIN_LIMIT = 1ll << 25;   // ~3 s of 100 ns sleeps

struct Block {
  int chunk, b, c;                     // chunk, batch, channel of the lane
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// This warp's steps of a, h_{t-1} and dh, zeros past S and past C; then
// its aggregate (P, L) into sP, sL; after a barrier, warp 0 composes the
// chunk's (P, L).
__device__ __forceinline__ void load_aggregate(
    const float* __restrict__ a, const float* __restrict__ h,
    const float* __restrict__ dh, const Block& blk, int S, int C,
    float (&av)[SUB], float (&hv)[SUB], float (&gv)[SUB], float (&sP)[WARPS][32],
    float (&sL)[WARPS][32], float& Pc, float& Lc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = blk.chunk * CHUNK + warp * SUB;
  const bool in_c = blk.c < C;
  const size_t base = (size_t)blk.b * S * C + blk.c;
#pragma unroll
  for (int u = 0; u < SUB; ++u) {
    const int t = t0 + u;
    const bool ok = in_c && t < S;
    av[u] = ok ? a[base + (size_t)t * C] : 0.f;
    gv[u] = ok ? dh[base + (size_t)t * C] : 0.f;
    hv[u] = (ok && t >= 1) ? h[base + (size_t)(t - 1) * C] : 0.f;
  }
  float g = gv[SUB - 1];               // the reverse scan from a zero carry
#pragma unroll
  for (int u = SUB - 2; u >= 0; --u) g = fmaf(av[u + 1], g, gv[u]);
  float P = av[0];
#pragma unroll
  for (int u = 1; u < SUB; ++u) P *= av[u];
  sP[warp][lane] = P;
  sL[warp][lane] = av[0] * g;
  __syncthreads();
  if (warp == 0) {
    Pc = 1.f;
    Lc = 0.f;
#pragma unroll
    for (int q = WARPS - 1; q >= 0; --q) {
      Lc = fmaf(sP[q][lane], Lc, sL[q][lane]);
      Pc = sP[q][lane] * Pc;
    }
  }
}

// Warp 0 spreads the chunk's carry `cin` into each warp's (sC); after a
// barrier every warp re-walks its steps from its carry and stores da, db.
__device__ __forceinline__ void walk(
    float cin, const float (&av)[SUB], const float (&hv)[SUB],
    const float (&gv)[SUB], float (&sP)[WARPS][32], float (&sL)[WARPS][32],
    float (&sC)[WARPS][32], const Block& blk, int S, int C,
    float* __restrict__ da, float* __restrict__ db) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    float x = cin;
#pragma unroll
    for (int q = WARPS - 1; q >= 0; --q) {
      sC[q][lane] = x;
      x = fmaf(sP[q][lane], x, sL[q][lane]);
    }
  }
  __syncthreads();
  const int t0 = blk.chunk * CHUNK + warp * SUB;
  const size_t base = (size_t)blk.b * S * C + blk.c;
  const bool in_c = blk.c < C;
  float g = gv[SUB - 1] + sC[warp][lane];
#pragma unroll
  for (int u = SUB - 1; u >= 0; --u) {
    if (u < SUB - 1) g = fmaf(av[u + 1], g, gv[u]);
    const int t = t0 + u;
    if (in_c && t < S) {
      db[base + (size_t)t * C] = g;
      da[base + (size_t)t * C] = g * hv[u];
    }
  }
}

// blockIdx.x is ignored; the ticket orders chunks from the last.
// carry[chunk][b][c] is the carry the chunk passes to the earlier one,
// flags[chunk][b][channel block] says it is there; both, and *ticket,
// start at zero.
__global__ void __launch_bounds__(THREADS)
rglru_bwd_chained(const float* __restrict__ a, const float* __restrict__ h,
                  const float* __restrict__ dh, float* __restrict__ da,
                  float* __restrict__ db, float* carry, unsigned* flags,
                  unsigned* ticket, int B, int S, int C) {
  __shared__ float sP[WARPS][32], sL[WARPS][32], sC[WARPS][32];
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const int ncb = (C + 31) / 32, nc = (S + CHUNK - 1) / CHUNK;
  const int per_chunk = B * ncb;
  const int tk = (int)s_ticket;
  const int rest = tk % per_chunk, cb = rest % ncb;
  const Block blk{nc - 1 - tk / per_chunk, rest / ncb,
                  cb * 32 + (int)(threadIdx.x % 32)};
  float av[SUB], hv[SUB], gv[SUB], Pc = 1.f, Lc = 0.f;
  load_aggregate(a, h, dh, blk, S, C, av, hv, gv, sP, sL, Pc, Lc);
  float cin = 0.f;
  if (threadIdx.x < 32) {
    const size_t slot = (size_t)blk.b * ncb + cb;
    if (blk.chunk + 1 < nc) {
      if (threadIdx.x == 0) {
        const unsigned* f = flags + (size_t)(blk.chunk + 1) * per_chunk + slot;
        long long spins = 0;
        while (ld_acquire(f) == 0u) {
          __nanosleep(100);
          if (++spins > SPIN_LIMIT) __trap();
        }
      }
      __syncwarp();
      if (blk.c < C)
        cin = __ldcg(carry + ((size_t)(blk.chunk + 1) * B + blk.b) * C +
                     blk.c);
    }
    if (blk.chunk > 0) {
      if (blk.c < C)
        carry[((size_t)blk.chunk * B + blk.b) * C + blk.c] =
            fmaf(Pc, cin, Lc);
      __syncwarp();
      if (threadIdx.x == 0) {
        __threadfence();
        st_release(flags + (size_t)blk.chunk * per_chunk + slot, 1u);
      }
    }
  }
  walk(cin, av, hv, gv, sP, sL, sC, blk, S, C, da, db);
}

}  // namespace

extern "C" {

// a, h, dh, da, db: (B, S, C) float32, contiguous; da and db may not alias
// the inputs.  ws holds ceil(S / 128)·B·C floats of carries, and flags
// (ceil(S / 128)·B·ceil(C / 32) + 1 unsigned ints, the last the ticket)
// must be zero.
int mcsa_rglru_scan_bwd_launch(const void* a, const void* h, const void* dh,
                               void* da, void* db, void* ws, void* flags,
                               int B, int S, int C, void* stream) {
  if (B <= 0 || S < 0 || C <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const int ncb = (C + 31) / 32, nc = (S + CHUNK - 1) / CHUNK;
  const long long blocks = (long long)nc * B * ncb;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  unsigned* fl = (unsigned*)flags;
  rglru_bwd_chained<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h, (const float*)dh, (float*)da,
      (float*)db, (float*)ws, fl, fl + (size_t)nc * B * ncb, B, S, C);
  return (int)cudaGetLastError();
}

// The time chunk (steps a block) and sub-chunk (steps a warp).
int mcsa_rglru_scan_bwd_chunk() { return CHUNK; }
int mcsa_rglru_scan_bwd_sub() { return SUB; }

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
