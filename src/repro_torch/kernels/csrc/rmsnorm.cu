// Row RMSNorm for Hopper: out = x * rsqrt(mean(x^2) + eps) * scale, in
// float32, cast back to the input dtype.
//
// Replaces repro/kernels/rmsnorm.py::_rmsnorm_kernel (row-blocked Pallas,
// feature dim resident in VMEM).  Bound by bytes: each row is read and
// written once (448 x 4096 bf16 is 7.3 MB in and out), with 3 flops per
// element.  Design: one block per row; each thread strides over the row
// with coalesced loads, keeps its partial sum of squares in a register,
// and a warp-shuffle + shared-memory reduction gives the row's sum.  The
// second pass re-reads the row, which a 4096-wide row keeps in L1/L2.

#include "common.cuh"

namespace repro {

constexpr int kNormThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int D, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  T* orow = out + static_cast<size_t>(blockIdx.x) * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kNormThreads) {
    float v = to_f32(xr[i]);
    ss += v * v;
  }
  __shared__ float partial[kNormThreads / 32];
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kNormThreads / 32; ++w) total += partial[w];
  const float r = rsqrtf(total / static_cast<float>(D) + eps);
  for (int i = threadIdx.x; i < D; i += kNormThreads) {
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * scale[i]);
  }
}

}  // namespace repro

extern "C" int repro_rms_norm(const void* x, const void* scale, void* out,
                              int rows, int D, float eps, int dtype,
                              void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == kDtypeBF16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kNormThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sc,
        static_cast<__nv_bfloat16*>(out), D, eps);
  } else {
    rmsnorm_kernel<float><<<rows, kNormThreads, 0, s>>>(
        static_cast<const float*>(x), sc, static_cast<float*>(out), D, eps);
  }
  return launch_status();
}

// The message of a launcher's status code, for the Python binding.
extern "C" const char* repro_error_string(int code) {
  if (code == repro::kStatusBadHeadDim) {
    return "head dimension not compiled into the attention kernels "
           "(32, 64, 80, 128)";
  }
  if (code == repro::kStatusBadArgs) {
    return "inconsistent launch arguments (split, column slice or head chunk sizes)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
