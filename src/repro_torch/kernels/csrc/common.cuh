// Shared helpers of the port's CUDA kernels: dtype conversion, warp
// reductions, asynchronous 16-byte copies, bf16 tensor-core fragments,
// and the launch-error
// convention (every launcher returns cudaGetLastError() as an int, 0 on
// success, or a status of its own such as kStatusBadHeadDim; the Python
// binding raises on anything but 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // masked-score sentinel (ref.NEG_INF)
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
// Launcher status for a head dimension no kernel was compiled for (beyond
// every cudaError_t value); repro_error_string names it.
constexpr int kStatusBadHeadDim = 100000;
// Launcher status for sizes the kernel was not given consistently.
constexpr int kStatusBadArgs = 100001;
// Launcher status for a TMA tensor map the driver refused to encode (or a
// driver without cuTensorMapEncodeTiled).
constexpr int kStatusTensorMap = 100002;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Asynchronous 16-byte copy from global to shared memory (cp.async, which
// bypasses L1 and the registers).  With ``pred`` false it reads nothing
// and fills the 16 shared bytes with zeros (``gmem`` must still be a valid
// address).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------
// bf16 tensor-core fragments (mma.sync m16n8k16), shared by the flash
// attention and SSD kernels: operands come from shared memory through
// ldmatrix (rows given by the lanes, 8 per 8x8 matrix), accumulators
// stay float32 in registers.
// ---------------------------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit alone (ex2.approx, denormal results
// flushed to 0): -inf gives exactly 0.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 (nearest even) in one register, lo first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Launch ``kernel`` needs ``smem`` bytes of dynamic shared memory: above
// the default 48 KB it must be allowed first.  Returns 0 or the error.
template <typename K>
inline int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// Add one to a counter in global memory with release and acquire semantics
// at device scope; returns the count before (the arrival of a split-K
// block or a replan slice: the last to arrive merges).
__device__ __forceinline__ int arrive_acq_rel(int* counter) {
  int prev;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
               : "=r"(prev)
               : "l"(counter)
               : "memory");
  return prev;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace repro
