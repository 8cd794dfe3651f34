// Hopper (sm_90a) primitives of the port's kernels, each a thin wrapper
// of one PTX instruction or one driver call:
//
//   mbarrier        init, arrive, arrive with an expected byte count, and
//                   the parity wait: the producer / consumer ring of
//                   shared-memory stages (a "full" barrier a stage that the
//                   copy completes, an "empty" one that the consumers
//                   arrive on once they have read it);
//   TMA             cp.async.bulk.tensor 3-D loads into shared memory that
//                   complete on an mbarrier, from a tensor map (CUtensorMap)
//                   encoded on the host (`encode_tile_map`) and passed to
//                   the kernel as a __grid_constant__ parameter;
//   wgmma           the fence, commit and wait of the asynchronous
//                   warpgroup products, the shared-memory matrix
//                   descriptor, m64nNk16 bf16 -> float32 and m64nNk8 tf32
//                   -> float32, each in two forms: A and B from shared
//                   memory (SS) and A from registers (RS), at N = 16, 32,
//                   64, 80, 96 and 128;
//   setmaxnreg      moving registers from a producer warpgroup to the
//                   consumer warpgroups.
//
// Only sm_90a has wgmma and setmaxnreg; TMA and mbarriers work on sm_90.
// The shared-memory layouts are the swizzled ones that TMA writes and
// wgmma reads: a tile of R rows is stored as column blocks of ``atom``
// elements (16, 32 or 64 bf16, 16 or 32 float32: 32, 64 or 128 bytes a
// row, the swizzle span), each block R rows of atom elements, 16-byte
// chunks of a row XOR-permuted by the row's position in its group of 8
// (chunk c of row r at chunk c ^ (r % 8) of 128-byte rows).  Both sides agree
// on the permutation when the swizzle mode of the map and of the
// descriptor match and every tile starts on a 1024-byte boundary.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)

#include "common.cuh"

namespace repro {
namespace sm90 {

// ---------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------
// A barrier completes its current phase once ``count`` arrivals and every
// expected transaction byte have arrived; its phase parity then flips.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Make initialised barriers visible to the other threads and to the
// asynchronous proxy (the TMA unit) before anyone uses them; a
// __syncthreads must follow.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also announces ``bytes`` of copies that will complete
// on this barrier in its current phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// True once the phase of parity ``parity`` has completed.  A fresh
// barrier is in phase 0: waiting on parity 1 returns at once (the phase
// "before" it counts as complete), waiting on parity 0 blocks until the
// first completion.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ---------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Copy the box of ``map`` at coordinates (c0, c1, c2), innermost first,
// into shared memory at ``dst``; its bytes complete on ``bar``.  Elements
// of the box outside the tensor are written as zeros and still count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Order this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (TMA, wgmma) on the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// named barriers (0 is __syncthreads'): ``threads`` arrivals complete one
// ---------------------------------------------------------------------
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------
// the cluster barrier in halves: every thread of the cluster arrives once
// (relaxed: no memory ordering), then waits for all to have arrived.  Past
// the wait every block of the cluster has started, so its shared memory
// may be written through distributed shared memory.
// ---------------------------------------------------------------------
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// setmaxnreg: all four warps of a warpgroup execute it together
// ---------------------------------------------------------------------
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------
// Before the first wgmma that reads registers (accumulators or an A
// operand) which other instructions wrote.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of these registers across
// a wgmma, its commit or its wait (the hardware writes them in between).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Swizzle span in bytes of a row of ``atom`` elements, and the
// descriptor's layout code for it (1: 128 B, 2: 64 B, 3: 32 B).
__host__ __device__ constexpr int layout_code(int span_bytes) {
  return span_bytes == 128 ? 1 : span_bytes == 64 ? 2 : 3;
}

// The 64-bit shared-memory matrix descriptor: start address, leading and
// stride byte offsets (all in 16-byte units), swizzle layout.  For the
// swizzled K-major layout (K contiguous) ``sbo`` is the step between
// groups of 8 rows and ``lbo`` is unused; for MN-major (M or N
// contiguous) ``lbo`` is the step between column blocks along M or N and
// ``sbo`` the step between groups of 8 along K.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              int span_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout_code(span_bytes)) << 62);
}

// The instruction's register lists: "%0, %1, ..., %(R-1)" and R float
// accumulators, built 8 at a time.
#define REPRO_WG_S8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define REPRO_WG_S16 REPRO_WG_S8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define REPRO_WG_S24 REPRO_WG_S16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define REPRO_WG_S32 REPRO_WG_S24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define REPRO_WG_S40 REPRO_WG_S32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define REPRO_WG_S48 REPRO_WG_S40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define REPRO_WG_S56 REPRO_WG_S48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define REPRO_WG_S64 REPRO_WG_S56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define REPRO_WG_C8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_WG_F8(d) REPRO_WG_C8(d, 0)
#define REPRO_WG_F16(d) REPRO_WG_F8(d), REPRO_WG_C8(d, 8)
#define REPRO_WG_F32(d) REPRO_WG_F16(d), REPRO_WG_C8(d, 16), REPRO_WG_C8(d, 24)
#define REPRO_WG_F40(d) REPRO_WG_F32(d), REPRO_WG_C8(d, 32)
#define REPRO_WG_F48(d) REPRO_WG_F40(d), REPRO_WG_C8(d, 40)
#define REPRO_WG_F64(d) REPRO_WG_F48(d), REPRO_WG_C8(d, 48), REPRO_WG_C8(d, 56)

// wgmma.mma_async m64nNk16, bf16 operands, float32 accumulators d (N / 2
// a thread; the fragment of warp w holds rows 16 w + lane / 4 (+ 8) and
// columns 8 j + 2 (lane % 4) (+ 1), as mma.sync's C fragment repeated over
// N / 8).  ``scale_d`` 0 overwrites d, 1 adds to it.
//   ss: A (64 x 16) and B (N x 16) from shared memory by descriptors,
//       TA / TB 1 where that operand is MN-major;
//   rs: A from registers (a[4], mma.sync's A fragment layout, the layout
//       of the ss accumulator rounded to bf16 pairs), B by descriptor.
template <int N>
struct Wgmma;

#define REPRO_WGMMA(N, R, A, B, S, T1, T2, RA0, RA1, RA2, RA3, RB, RS, RT)                  \
  template <>                                                                              \
  struct Wgmma<N> {                                                                        \
    static constexpr int kRegs = R;                                                        \
    template <int TA, int TB>                                                              \
    static __device__ __forceinline__ void ss(float (&d)[R], uint64_t a, uint64_t b,       \
                                              int scale_d) {                               \
      asm volatile(                                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #S ", 0;\n"                                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REPRO_WG_S##R       \
          "}, %" #A ", %" #B ", p, 1, 1, %" #T1 ", %" #T2 ";\n}\n"                         \
          : REPRO_WG_F##R(d)                                                               \
          : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));                               \
    }                                                                                      \
    template <int TB>                                                                      \
    static __device__ __forceinline__ void rs(float (&d)[R], const uint32_t (&a)[4],       \
                                              uint64_t b, int scale_d) {                   \
      asm volatile(                                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #RS ", 0;\n"                                \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REPRO_WG_S##R       \
          "}, {%" #RA0 ", %" #RA1 ", %" #RA2 ", %" #RA3 "}, %" #RB ", p, 1, 1, %" #RT      \
          ";\n}\n"                                                                         \
          : REPRO_WG_F##R(d)                                                               \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));    \
    }                                                                                      \
  };

// (N, registers, then the operand numbers that follow the R outputs:
// ss: a, b, scale_d, TA, TB; rs: a0..a3, b, scale_d, TB)
REPRO_WGMMA(16, 8, 8, 9, 10, 11, 12, 8, 9, 10, 11, 12, 13, 14)
REPRO_WGMMA(32, 16, 16, 17, 18, 19, 20, 16, 17, 18, 19, 20, 21, 22)
REPRO_WGMMA(64, 32, 32, 33, 34, 35, 36, 32, 33, 34, 35, 36, 37, 38)
REPRO_WGMMA(80, 40, 40, 41, 42, 43, 44, 40, 41, 42, 43, 44, 45, 46)
REPRO_WGMMA(96, 48, 48, 49, 50, 51, 52, 48, 49, 50, 51, 52, 53, 54)
REPRO_WGMMA(128, 64, 64, 65, 66, 67, 68, 64, 65, 66, 67, 68, 69, 70)

#undef REPRO_WGMMA

// wgmma.mma_async m64nNk8, tf32 operands (float32 registers or shared
// words whose low 13 mantissa bits are zero), float32 accumulators d in
// the layout of Wgmma<N>.  Both operands K-major only (the transpose
// immediates are the 16-bit types'): a row of A or B holds 8 consecutive
// k of one m or n, 32 bytes, as a k16 step of bf16 does.
//   ss: A (64 x 8) and B (N x 8) from shared memory by descriptors;
//   rs: A from registers, a[4] of warp w: rows 16 w + lane / 4 (a0, a2)
//       and + 8 (a1, a3), k = lane % 4 (a0, a1) and + 4 (a2, a3).
template <int N>
struct WgmmaTf32;

#define REPRO_WGMMA_TF32(N, R, A, B, S, RA0, RA1, RA2, RA3, RB, RS)                         \
  template <>                                                                              \
  struct WgmmaTf32<N> {                                                                    \
    static __device__ __forceinline__ void ss(float (&d)[R], uint64_t a, uint64_t b,       \
                                              int scale_d) {                               \
      asm volatile(                                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #S ", 0;\n"                                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REPRO_WG_S##R        \
          "}, %" #A ", %" #B ", p, 1, 1;\n}\n"                                              \
          : REPRO_WG_F##R(d)                                                               \
          : "l"(a), "l"(b), "r"(scale_d));                                                 \
    }                                                                                      \
    static __device__ __forceinline__ void rs(float (&d)[R], const uint32_t (&a)[4],       \
                                              uint64_t b, int scale_d) {                   \
      asm volatile(                                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #RS ", 0;\n"                                \
          "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REPRO_WG_S##R        \
          "}, {%" #RA0 ", %" #RA1 ", %" #RA2 ", %" #RA3 "}, %" #RB ", p, 1, 1;\n}\n"        \
          : REPRO_WG_F##R(d)                                                               \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));             \
    }                                                                                      \
  };

// (N, registers, then the operand numbers that follow the R outputs:
// ss: a, b, scale_d; rs: a0..a3, b, scale_d)
REPRO_WGMMA_TF32(16, 8, 8, 9, 10, 8, 9, 10, 11, 12, 13)
REPRO_WGMMA_TF32(32, 16, 16, 17, 18, 16, 17, 18, 19, 20, 21)
REPRO_WGMMA_TF32(64, 32, 32, 33, 34, 32, 33, 34, 35, 36, 37)
REPRO_WGMMA_TF32(80, 40, 40, 41, 42, 40, 41, 42, 43, 44, 45)
REPRO_WGMMA_TF32(96, 48, 48, 49, 50, 48, 49, 50, 51, 52, 53)
REPRO_WGMMA_TF32(128, 64, 64, 65, 66, 64, 65, 66, 67, 68, 69)

#undef REPRO_WGMMA_TF32

}  // namespace sm90

// ---------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------
// Encode the map of a row-major tensor of T (bf16 or float32) shaped
// (slabs, rows, D), read in boxes of (1, box_rows, box_cols) elements.
// With ``swizzle_bytes`` 32, 64 or 128 a row of the box is that many bytes
// (box_cols x sizeof(T)) and is stored swizzled; with 0 the box is stored
// as dense rows of box_cols elements (a multiple of 16 bytes, at most 256
// elements).  Boxes past ``rows`` read zeros.  cuTensorMapEncodeTiled is
// reached through the runtime's cudaGetDriverEntryPoint, so nothing links
// against libcuda.  Returns 0 or kStatusTensorMap.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t st = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t st =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return st == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

template <typename T>
inline int encode_tile_map(CUtensorMap* map, const void* base, int slabs, int rows, int D,
                           int box_rows, int box_cols, int swizzle_bytes) {
  static_assert(sizeof(T) == 2 || sizeof(T) == 4, "bf16 or float32 tiles");
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return kStatusTensorMap;
  if (swizzle_bytes != 0 && box_cols * static_cast<int>(sizeof(T)) != swizzle_bytes) {
    return kStatusTensorMap;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slabs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * sizeof(T),
                                 static_cast<cuuint64_t>(rows) * D * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                           : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kStatusTensorMap;
}

}  // namespace repro
