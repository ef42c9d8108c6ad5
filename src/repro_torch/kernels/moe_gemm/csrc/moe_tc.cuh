// Building blocks of the expert SwiGLU's wgmma + TMA bodies, shared by
// the forward (moe_swiglu.cu, namespace hopper_tc) and the backward
// (moe_swiglu_bwd.cu, namespace hopper_tc): the m64n256k16 and m64n128k16
// products on 128-byte-swizzled bf16 tiles with either operand K- or
// MN-major, bf16 packing, the stage ring of persistent blocks, their walk
// over tiles, and the 3-D tensor map.  sm_90a only.
//
// kernels/_build.py hashes this header with every source that includes
// it, so an edit here rebuilds both libraries.
#pragma once

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace moe_tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

// D (64 x 256, f32) (+)= A (64 x 16, smem) * B (16 x 256, smem), each
// operand K-major (T = 0) or MN-major (T = 1: wgmma's transpose)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 128, f32) (+)= A (64 x 16, smem) * B (16 x 128, smem), each
// operand K-major (T = 0) or MN-major (T = 1: wgmma's transpose)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The stage ring of a persistent block: step g sits in stage g % STAGES;
// one thread issues a stage's copies, every one of the NWG consumer
// warpgroups waits on its mbarrier, and the last warpgroup to release a
// stage issues the copy of step g + STAGES into it (no producer warp, no
// block barrier).  Shared memory: the stages from the first 1 KiB
// boundary, then an mbarrier and a release counter a stage.
template <int STAGES, int NWG>
struct Ring {
  uint32_t base, bars;
  int* released;

  __device__ Ring(uint8_t* raw, int stage_bytes) {
    const uint32_t a = smem_addr(raw);
    base = (a + 1023u) & ~1023u;
    bars = base + STAGES * stage_bytes;
    released = reinterpret_cast<int*>(raw + (bars - a) + 8 * STAGES);
  }
  __device__ uint32_t full(int kt) const { return bars + 8 * (kt % STAGES); }
  __device__ void init() {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bars + 8 * i, 1);
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __device__ void wait(int kt) const {
    mbar_wait(full(kt), (kt / STAGES) & 1);
  }
  // thread t of warpgroup wg is done with step kt: true for the one
  // thread that must issue the copy of step kt + STAGES
  __device__ bool release(int kt, int wg, int t) {
    warpgroup_sync(1 + wg);
    if (t != 0) return false;
    int* count = released + kt % STAGES;
    if (atomicAdd(count, 1) != NWG - 1) return false;
    *count = 0;
    return true;
  }
};

// dynamic shared memory of a ring: the stages, their mbarriers and release
// counters, and 1 KiB to align the swizzle atoms
constexpr int ring_bytes(int stage, int stages) {
  return stages * stage + 12 * stages + 1024;
}

// Tiles: (row tile m, column tile n, expert e) numbered with m fastest, so
// the blocks in flight together share an expert's weight tile in L2.  A
// block is persistent: it takes tiles blockIdx.x, + gridDim.x, ..., and
// its ring runs on across tiles (step g = local tile · KT + k step), so
// the next tile's first copies are in flight during this tile's last
// products and epilogue.
struct Tiles {
  int MT, NT, KT, count;
  __device__ Tiles(int mt, int nt, int kt, int E)
      : MT(mt), NT(nt), KT(kt), count(mt * nt * E) {}
  // this block's number of steps
  __device__ int steps() const {
    const int mine = (count - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x;
    return mine * KT;
  }
  // (m, n, e) of the tile that step g belongs to
  __device__ void coords(int g, int& m, int& n, int& e) const {
    const int tile = blockIdx.x + (g / KT) * gridDim.x;
    m = tile % MT;
    n = (tile / MT) % NT;
    e = tile / (MT * NT);
  }
};

// Tensor map of a bf16 tensor (outer, mid, inner) read in boxes of {64
// inner, rows mid, 1 outer} with the 128-byte swizzle; past either edge
// reads zeros.
inline int tensor_map(CUtensorMap* map, const void* base, int inner,
                      int mid, int outer, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)mid,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * mid * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace moe_tc
