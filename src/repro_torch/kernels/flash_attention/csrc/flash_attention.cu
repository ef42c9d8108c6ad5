// Flash attention for Hopper (sm_90a): online-softmax GQA attention with
// causal and sliding-window masks, float32 accumulation, in the model
// layout q (B, Sq, Hq, HD), k/v (B, Skv, Hkv, HD), out (B, Sq, Hq, HD).
//
// Replaces the JAX package's TPU kernel flash_attention_tpu /
// _attn_kernel (src/repro/kernels/flash_attention/kernel.py).  The TPU
// kernel walks the kv blocks as a sequential grid axis and carries the
// softmax state (m, l, acc) in VMEM scratch; blocks of a CUDA grid run in
// no order, so here one block owns one (batch, q tile, q head) and walks
// its kv tiles in a loop, with the state in registers.
//
// Two bodies, chosen by the input type, never by a fallback:
//   * bfloat16 -> the tensor-core body (namespace tc): wgmma products,
//     TMA copies into a two-stage ring, tiles kept in bf16;
//   * float32  -> the CUDA-core body (namespace cc): fp32 FMAs, so the
//     exact checks (2e-5) keep full float32 products; TF32 wgmma would
//     keep about three digits.
// The wrapper (kernel.py) names the body in the launch and the launch
// refuses any other pairing of type and body.
//
// Semantics kept from the TPU kernel by both bodies, so both equal
// attention_ref:
//   * q row i sits at key position q_off + i (q_off 0 unless the caller
//     gives an offset: a rank's sequence shard of q against the gathered
//     keys, context-parallel attention; the caller refuses causal Sq !=
//     Skv without one); every mask, tile skip and band below reads the
//     shifted position, and q rows are still stored at their own row;
//   * masked scores are NEG_INF = -1e30, not -inf: a row with no valid key
//     in a visited tile gets p = exp(0) = 1 there, which the first tile
//     with a valid key wipes out through corr = exp(-1e30 - m) = 0;
//   * k/v rows past Skv are loaded as zeros (0 * garbage would still
//     poison p @ v);
//   * kv tiles wholly outside the causal / window band are skipped, and
//     only tiles that cross the diagonal, the window's edge or Skv are
//     masked;
//   * heavier causal q tiles are scheduled first;
//   * out = acc / max(l, 1e-30), with l summed from the float32 p, scale
//     applied to q.k before masking.
//
// Bound: at prefill shapes (S = 1024..2560, HD = 64..256) the causal or
// windowed FLOPs (4·B·Hq·HD per unmasked pair) over the card's bf16
// tensor-core rate bind, well above the bytes.
//
// Tensor-core body.  A block is two or three consumer warpgroups of 64 q
// rows each (three at HD 128, see Cfg) over kv tiles of 64 keys:
//   * Q, K and V stay bf16 in shared memory, in the 128-byte-swizzled
//     layout that wgmma descriptors read: HD/64 column blocks, each R rows
//     of 128 bytes, 16-byte chunk c of row r stored at chunk c ^ (r % 8).
//     HD 32 is padded to one 64-wide block whose other half reads zeros.
//   * Copies are TMA (cp.async.bulk.tensor with a 4-D tensor map over
//     (B, S, H, hd), mbarrier completion), issued by one thread: rows past
//     S and columns past hd come in as zeros.  K and V of a tile share a
//     stage of a two-stage ring; each warpgroup releases a stage when its
//     products on it are done, and the last to release it issues the copy
//     of tile kt+2 into it (an atomic counter per stage), so no warpgroup
//     waits for another and no thread is set aside as a producer.  With
//     no producer warp, setmaxnreg has nothing to rebalance.
//   * S = Q·Kᵀ is wgmma m64n64k16 with Q and K from shared memory (both
//     K-major).  The online softmax runs on the accumulator's registers:
//     a thread holds rows 16·(warp%4) + lane/4 and +8, so a row's max
//     takes two xor-shuffles within the quad, and l stays a per-thread
//     partial sum reduced once at the end.  Scores are scaled by
//     scale·log2(e) and exponentiated with ex2.approx.
//   * P feeds O += P·V as wgmma's register A operand (the accumulator's
//     layout is the A fragment's), with V from shared memory as a
//     transposed (MN-major) B operand.  P goes in as bf16 hi + lo (hi =
//     bf16(p), lo = bf16(p - hi)), two products per k step: P rounded to
//     bf16 alone puts the output's error RMS above the 1e-3 of its RMS
//     that the checks allow (tests/test_torch_kernels_lm.py simulates
//     both); hi + lo keeps ~16 bits.
//   * A warpgroup skips a kv tile that is wholly masked for its 64 rows
//     (exact: such a tile adds 0, or is wiped by corr = 0).
//   * Shared memory: Q 64·NWG·HDP·2 + 2 stages · 2 · 64·HDP·2 bytes (+1
//     KiB to align the swizzle atoms): 49 KiB at HD 64, 113 KiB at 128,
//     193 KiB at 256.
//   * A training forward (ops.py's autograd.Function, bf16) passes two more
//     outputs, null on the serving path, so serving launches and writes
//     what it did: each row's log-sum-exp in base 2, m + log2(l) (the
//     scores are exponentiated in base 2 here and in the backward), and
//     out_lo = bf16(o - out), what out's bf16 rounding left out, so that
//     out + out_lo carries ~16 bits of o.  out's bits do not change: the
//     epilogue stores out exactly as before and the residual after it.
//     The backward takes D = rowsum(dO ⊙ (out + out_lo)) from these
//     (flash_attention_bwd.cu says why D needs more than out's 8 bits).
//
// CUDA-core body (float32; the first design): 64 q rows x 32 keys a tile,
// 128 threads, each owning 4 q rows x 4 keys of the score tile and 4 rows
// x HD/8 columns of the output; tiles in shared memory as float32 (row
// pitch HD+4), read as float4; the 8 threads of a q row are neighbouring
// lanes, so row max and sum are three xor-shuffles.  At HD 256 a thread
// holds 128 float accumulators and a block 138.5 KiB of shared memory.
//
// Each template instance sets its shared-memory attribute once, not per
// launch.  Plain C interface (no PyTorch headers), loaded with ctypes; the
// launch goes on the caller's stream and returns cudaGetLastError().
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"   // wgmma products, bf16 packing, tensor maps

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------
// CUDA-core body, float32
// ---------------------------------------------------------------------
namespace cc {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 32;          // keys per tile
constexpr int THREADS = 128;    // 16 row groups x 8 lanes
constexpr int RPT = 4;          // q rows per thread
constexpr int KPT = 4;          // keys per thread (BK / 8)
constexpr int PS = BK + 4;      // pitch of the probability tile

// Copy `rows` rows of one head (HD contiguous floats each, `stride`
// floats apart) into shared memory with row pitch `pitch`; rows at or past
// `valid` are zeros.
template <int HD>
__device__ void load_tile(float* dst, int pitch, const float* src,
                          size_t stride, int rows, int valid) {
  constexpr int PER_ROW = HD / 4;
  for (int v = threadIdx.x; v < rows * PER_ROW; v += THREADS) {
    const int r = v / PER_ROW, c = (v % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = *reinterpret_cast<const float4*>(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * pitch + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Skv, int Hq,
                       int Hkv, float scale, int causal, int window,
                       int q_off) {
  constexpr int QP = HD + 4;           // pitch of the q and k tiles
  constexpr int NC = HD / 32;          // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* Ps = Vs + BK * HD;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blockIdx.x;          // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;

  const size_t q_stride = (size_t)Hq * HD, kv_stride = (size_t)Hkv * HD;
  load_tile<HD>(Qs, QP, q + (((size_t)b * Sq + q0) * Hq + h) * HD,
                   q_stride, BQ, Sq - q0);

  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_off + q_last + 1);
  if (window > 0) k_begin = max(0, q_off + q0 - window + 1);
  const int kt_begin = k_begin / BK, kt_end = (k_end + BK - 1) / BK;

  float m[RPT], l[RPT], acc[RPT][NC * 4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // previous tile fully consumed
    const size_t kv_off = (((size_t)b * Skv + k0) * Hkv + hk) * HD;
    load_tile<HD>(Ks, QP, k + kv_off, kv_stride, BK, Skv - k0);
    load_tile<HD>(Vs, HD, v + kv_off, kv_stride, BK, Skv - k0);
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (tr * RPT + i) * QP + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tc + 8 * j) * QP + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + tr * RPT + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = k0 + tc + 8 * j, qk = q_off + qpos;
        bool ok = kpos < Skv && qpos < Sq;
        if (causal) ok = ok && qk >= kpos;
        if (window > 0) ok = ok && (qk - kpos) < window;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(tr * RPT + i) * PS + tc + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (tr * RPT + i) * PS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (kk + e) * HD + 32 * c + 4 * tc);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y
                          : e == 2 ? p4[i].z : p4[i].w;
            acc[i][4 * c + 0] += p * vv.x;
            acc[i][4 * c + 1] += p * vv.y;
            acc[i][4 * c + 2] += p * vv.z;
            acc[i][4 * c + 3] += p * vv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + tr * RPT + i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* o = out + (((size_t)b * Sq + qpos) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = acc[i][4 * c + e] * inv;
      *reinterpret_cast<float4*>(o + 32 * c + 4 * tc) =
          make_float4(r[0], r[1], r[2], r[3]);
    }
    // the row's log-sum-exp in base 2, as the tensor-core body gives it
    if (lse != nullptr && tc == 0)
      lse[((size_t)b * Hq + h) * Sq + qpos] =
          (m[i] + logf(fmaxf(l[i], 1e-30f))) * 1.4426950408889634f;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, void* out_lo, int B, int Sq, int Skv, int Hq, int Hkv,
           float scale, int causal, int window, int q_off,
           cudaStream_t stream) {
  // its float32 output needs no residual; lse is the serving merge's (its
  // backward recomputes LSE)
  if (out_lo != nullptr) return (int)cudaErrorInvalidValue;
  constexpr int QP = HD + 4;
  constexpr size_t smem = sizeof(float) *
      (size_t)(BQ * QP + BK * QP + BK * HD + BQ * PS);
  auto kern = flash_attention_kernel<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B), block(THREADS);
  kern<<<grid, block, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
      Sq, Skv, Hq, Hkv, scale, causal, window, q_off);
  return (int)cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------------------------
// Tensor-core body, bfloat16
// ---------------------------------------------------------------------
namespace tc {

using namespace attn_tc;

constexpr int BK = 64;             // keys per kv tile

// Per head_dim: consumer warpgroups (64 q rows each) and K/V stages.  At
// HD 128 a thread needs about 160 registers, so three warpgroups fit one
// SM's 64 K registers; at HD 256 (about 220) two do, and two stages of
// 64 x 256 K and V fill the shared memory beside Q.  On the H100, three
// warpgroups beat two at HD 128 (starcoder2-3b's shape) and lost at HD 64
// (granite's); a third stage changed nothing measurable.
template <int HD>
struct Cfg {
  static constexpr int HDP = HD < 64 ? 64 : HD;    // padded width in smem
  static constexpr int NWG = HD == 128 ? 3 : 2;
  static constexpr int STAGES = 2;
  static constexpr int BQ = 64 * NWG;              // q rows per block
  static constexpr int THREADS = 128 * NWG;
  // shared memory: Q (BQ rows), then STAGES x (K, V) of BK rows, all
  // HDP/64 column blocks of 128-byte rows; then the mbarriers (Q, then
  // one per stage) and the stages' release counters
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;    // one K or V tile
  static constexpr int BAR = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BYTES = BAR + 8 * (1 + STAGES) + 4 * STAGES + 1024;
};

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmK,
                          const __grid_constant__ CUtensorMap tmV,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          bf16* __restrict__ out_lo, int Sq, int Skv, int Hq,
                          int Hkv, float scale_log2, int causal, int window,
                          int q_off) {
  using C = Cfg<HD>;
  constexpr int HDP = C::HDP, NCB = HDP / 64, BQ = C::BQ;
  constexpr int NWG = C::NWG, STAGES = C::STAGES;
  constexpr int NO = HDP / 2;                  // O accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms (8 rows x 128 bytes) must sit on 1024-byte boundaries
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t barQ = base + C::BAR;         // then full[0..STAGES)
  int* released = reinterpret_cast<int*>(smem_raw + (base - raw) + C::BAR +
                                         8 * (1 + STAGES));

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blockIdx.x;        // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  // the warpgroup index through a shuffle, so that ptxas sees it (and the
  // branches on it) as warp-uniform and keeps the wgmmas asynchronous
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int wq0 = q0 + 64 * wg;                // this warpgroup's rows
  const int wq_last = min(wq0 + 64, Sq) - 1;   // < wq0: no rows
  const int r0 = wq0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  const int c2 = 2 * (lane & 3);
  // key positions of this warpgroup's first and last rows and of this
  // thread's two rows
  const int wp0 = q_off + wq0, wp_last = q_off + wq_last;
  const int kq0 = q_off + r0, kq1 = q_off + r1;

  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_off + q_last + 1);
  if (window > 0) k_begin = max(0, q_off + q0 - window + 1);
  const int kt_begin = k_begin / BK, kt_end = (k_end + BK - 1) / BK;

  // tile kt sits in stage (kt - kt_begin) % STAGES: K, then V
  auto stage_of = [&](int kt) { return (kt - kt_begin) % STAGES; };
  auto sK_of = [&](int kt) {
    return base + C::Q_BYTES + 2 * stage_of(kt) * C::KV_BYTES;
  };
  auto full_of = [&](int kt) { return barQ + 8 + 8 * stage_of(kt); };
  auto load_kv = [&](int kt) {                 // one thread issues it
    const uint32_t sK = sK_of(kt), bar = full_of(kt);
    mbar_expect(bar, 2 * C::KV_BYTES);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load(sK + cb * BK * 128, &tmK, bar, 64 * cb, hk, kt * BK, b);
      tma_load(sK + C::KV_BYTES + cb * BK * 128, &tmV, bar, 64 * cb, hk,
               kt * BK, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(barQ + 8 * i, 1);
    for (int i = 0; i < STAGES; ++i) released[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(barQ, C::Q_BYTES);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      tma_load(sQ + cb * BQ * 128, &tmQ, barQ, 64 * cb, h, q0, b);
    for (int kt = kt_begin; kt < kt_end && kt < kt_begin + STAGES; ++kt)
      load_kv(kt);
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  mbar_wait(barQ, 0);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    // every warpgroup waits for every tile, active or not, so none can
    // release a stage a second time before the others released it once
    mbar_wait(full_of(kt), ((kt - kt_begin) / STAGES) & 1);
    const uint32_t sK = sK_of(kt), sV = sK + C::KV_BYTES;
    const int k0 = kt * BK;
    const bool active = wq_last >= wq0 && (!causal || k0 <= wp_last) &&
                        (window == 0 || k0 + BK - 1 > wp0 - window);
    if (active) {                    // uniform over the warpgroup
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t koff = (ks & 3) * 32;   // 16 columns = 32 bytes
        const uint64_t da = desc_sw128(
            sQ + (ks >> 2) * BQ * 128 + wg * 64 * 128 + koff, 16, 1024);
        const uint64_t db =
            desc_sw128(sK + (ks >> 2) * BK * 128 + koff, 16, 1024);
        wgmma_ss_n64(s, da, db, ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      const bool edge = (causal && k0 + BK - 1 > wp0) ||
                        (window > 0 && k0 <= wp_last - window) ||
                        k0 + BK > Skv;
      float mt0 = NEG_INF, mt1 = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s[4 * jj + e] * scale_log2;
          float x1 = s[4 * jj + 2 + e] * scale_log2;
          if (edge) {
            const int kp = k0 + 8 * jj + c2 + e;
            bool ok0 = kp < Skv, ok1 = kp < Skv;
            if (causal) { ok0 = ok0 && kq0 >= kp; ok1 = ok1 && kq1 >= kp; }
            if (window > 0) {
              ok0 = ok0 && (kq0 - kp) < window;
              ok1 = ok1 && (kq1 - kp) < window;
            }
            x0 = ok0 ? x0 : NEG_INF;
            x1 = ok1 ? x1 : NEG_INF;
          }
          s[4 * jj + e] = x0;
          s[4 * jj + 2 + e] = x1;
          mt0 = fmaxf(mt0, x0);
          mt1 = fmaxf(mt1, x1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
      }
      const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
      const float corr0 = fast_exp2(m0 - mn0), corr1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = fast_exp2(s[4 * jj + e] - mn0);
          const float p1 = fast_exp2(s[4 * jj + 2 + e] - mn1);
          s[4 * jj + e] = p0;
          s[4 * jj + 2 + e] = p1;
          rs0 += p0;
          rs1 += p1;
        }
      }
      l0 = l0 * corr0 + rs0;
      l1 = l1 * corr1 + rs1;
#pragma unroll
      for (int jj = 0; jj < NO / 4; ++jj) {
        o[4 * jj] *= corr0;
        o[4 * jj + 1] *= corr0;
        o[4 * jj + 2] *= corr1;
        o[4 * jj + 3] *= corr1;
      }
      // the score accumulator's layout is wgmma's A fragment: k step kb
      // takes accumulator groups 2kb (keys 2c, 2c+1) and 2kb+1 (+8)
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb) {
        const int g0 = 4 * (2 * kb), g1 = 4 * (2 * kb + 1);
        split_bf16(s[g0], s[g0 + 1], ph[kb][0], pl[kb][0]);
        split_bf16(s[g0 + 2], s[g0 + 3], ph[kb][1], pl[kb][1]);
        split_bf16(s[g1], s[g1 + 1], ph[kb][2], pl[kb][2]);
        split_bf16(s[g1 + 2], s[g1 + 3], ph[kb][3], pl[kb][3]);
      }
      wgmma_fence();
      fence_regs(o);
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb) {
        const uint64_t db = desc_sw128(sV + kb * 16 * 128, BK * 128, 1024);
        wgmma_pv<HDP>(o, ph[kb], db);
        wgmma_pv<HDP>(o, pl[kb], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
    }
    // release the stage: the last warpgroup done with it loads tile
    // kt + STAGES there
    warpgroup_sync(1 + wg);
    if (t == 0) {
      int* count = released + stage_of(kt);
      if (atomicAdd(count, 1) == NWG - 1) {
        *count = 0;
        if (kt + STAGES < kt_end) load_kv(kt + STAGES);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* o0 = out + (((size_t)b * Sq + r0) * Hq + h) * HD + c2;
  bf16* o1 = out + (((size_t)b * Sq + r1) * Hq + h) * HD + c2;
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj) {
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(o0 + 8 * jj) =
          pack_bf16(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(o1 + 8 * jj) =
          pack_bf16(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
  }
  if (out_lo == nullptr) return;               // serving: out alone
  // training: what out's bf16 rounding left out, and each row's
  // log-sum-exp in base 2 (the domain of x and of the backward's exp2)
  bf16* lo0 = out_lo + (((size_t)b * Sq + r0) * Hq + h) * HD + c2;
  bf16* lo1 = out_lo + (((size_t)b * Sq + r1) * Hq + h) * HD + c2;
  uint32_t hi, lo;
#pragma unroll
  for (int jj = 0; jj < HD / 8; ++jj) {
    if (r0 < Sq) {
      split_bf16(o[4 * jj] * inv0, o[4 * jj + 1] * inv0, hi, lo);
      *reinterpret_cast<uint32_t*>(lo0 + 8 * jj) = lo;
    }
    if (r1 < Sq) {
      split_bf16(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1, hi, lo);
      *reinterpret_cast<uint32_t*>(lo1 + 8 * jj) = lo;
    }
  }
  if ((lane & 3) == 0) {
    float* row = lse + ((size_t)b * Hq + h) * Sq;
    if (r0 < Sq) row[r0] = m0 + log2f(fmaxf(l0, 1e-30f));
    if (r1 < Sq) row[r1] = m1 + log2f(fmaxf(l1, 1e-30f));
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, void* out_lo, int B, int Sq, int Skv, int Hq, int Hkv,
           float scale, int causal, int window, int q_off,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  auto kern = flash_attention_tc_kernel<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, B, Sq, Hq, HD, C::BQ);
  if (!err) err = tensor_map(&tk, k, B, Skv, Hkv, HD, BK);
  if (!err) err = tensor_map(&tv, v, B, Skv, Hkv, HD, BK);
  if (err) return err;
  dim3 grid((Sq + C::BQ - 1) / C::BQ, Hq, B), block(C::THREADS);
  kern<<<grid, block, C::BYTES, stream>>>(tq, tk, tv, (bf16*)out, lse,
                                          (bf16*)out_lo, Sq, Skv, Hq, Hkv,
                                          scale * LOG2E, causal, window,
                                          q_off);
  return (int)cudaGetLastError();
}

}  // namespace tc

using LaunchFn = int (*)(const void*, const void*, const void*, void*,
                        float*, void*, int, int, int, int, int, float, int,
                        int, int, cudaStream_t);

// the instance of a body for head_dim hd in {32, 64, 128, 256}, else null
LaunchFn pick(int hd, const LaunchFn (&fns)[4]) {
  switch (hd) {
    case 32: return fns[0];
    case 64: return fns[1];
    case 128: return fns[2];
    case 256: return fns[3];
  }
  return nullptr;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; body: 0 = CUDA cores, 1 = tensor
// cores.  The only pairings taken are (float32, CUDA cores) and
// (bfloat16, tensor cores); anything else returns cudaErrorInvalidValue.
// All tensors contiguous in the model layout; Hq % Hkv == 0; hd in {32,
// 64, 128, 256}.  lse (B, Hq, Sq) float32 and out_lo (out's shape, bf16)
// are both null (serving) or both given (the tensor-core body of a
// training forward: base-2 log-sum-exp of each row's scaled scores, and
// bf16(o - out) of the float32 output o); the CUDA-core body takes lse
// alone (a serving merge over sharded keys) or neither.  q_off: query row
// i sits at key position q_off + i, q_off >= 0 (kernel.py holds a given
// offset to q_off + Sq <= Skv).
int mcsa_flash_attention_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, void* out_lo, int B,
                                int Sq, int Skv, int Hq, int Hkv, int hd,
                                float scale, int causal, int window,
                                int q_off, int dtype, int body,
                                void* stream) {
  if (body == 1 && (lse == nullptr) != (out_lo == nullptr))
    return (int)cudaErrorInvalidValue;
  if (q_off < 0) return (int)cudaErrorInvalidValue;
  static const LaunchFn cc_fns[4] = {cc::launch<32>, cc::launch<64>,
                                     cc::launch<128>, cc::launch<256>};
  static const LaunchFn tc_fns[4] = {tc::launch<32>, tc::launch<64>,
                                     tc::launch<128>, tc::launch<256>};
  LaunchFn fn = nullptr;
  if (dtype == 0 && body == 0) fn = pick(hd, cc_fns);
  if (dtype == 1 && body == 1) fn = pick(hd, tc_fns);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, out, lse, out_lo, B, Sq, Skv, Hq, Hkv, scale, causal,
            window, q_off, (cudaStream_t)stream);
}

// Dynamic shared memory a block of body `body` takes at head_dim hd
// (bytes), or -1 for a pair that has no instance.
int mcsa_flash_attention_smem(int hd, int body) {
  if (hd != 32 && hd != 64 && hd != 128 && hd != 256) return -1;
  if (body == 0) {
    const int qp = hd + 4;
    return (int)sizeof(float) * (cc::BQ * qp + cc::BK * qp + cc::BK * hd +
                                 cc::BQ * cc::PS);
  }
  if (body == 1) {
    switch (hd) {
      case 32: return tc::Cfg<32>::BYTES;
      case 64: return tc::Cfg<64>::BYTES;
      case 128: return tc::Cfg<128>::BYTES;
      case 256: return tc::Cfg<256>::BYTES;
    }
  }
  return -1;
}

const char* mcsa_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
