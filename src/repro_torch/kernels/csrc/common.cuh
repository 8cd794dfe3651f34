// Shared helpers of the port's CUDA kernels: dtype conversion, warp and
// block reductions, and the launch-error convention (every launcher
// returns cudaGetLastError() as an int, 0 on success, or a status of its
// own such as kStatusBadHeadDim; the Python binding raises on anything
// but 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;  // masked-score sentinel (ref.NEG_INF)
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
// Launcher status for a head dimension no kernel was compiled for (beyond
// every cudaError_t value); repro_error_string names it.
constexpr int kStatusBadHeadDim = 100000;

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

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace repro
