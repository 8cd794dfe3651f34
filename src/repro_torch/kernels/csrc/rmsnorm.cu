// Row RMSNorm for Hopper: out = x * rsqrt(mean(x^2) + eps) * scale, in
// float32, cast back to the input dtype.
//
// Replaces repro/kernels/rmsnorm.py::_rmsnorm_kernel (row-blocked Pallas,
// feature dim resident in VMEM).  Bound by bytes: each row is read and
// written once (448 x 4096 bf16 is 7.3 MB in and out, 2.2 us at 3.35
// TB/s), with 3 flops per element.  At one row (every decode step) the
// 16 KB move in 0.01 us, so the launch's fixed cost and the latency of
// one pass set the time.
//
// Design: one block a row, sized from D so that each thread holds one
// 16-byte vector of the row (8 bf16 or 4 float32) in registers: D / 8
// threads rounded up to a warp, at most 1024 (2048 to 5120 bf16: 256 to
// 640 threads).  Each thread loads its vector once, reads its scale as
// float4, and the sum of squares reduces by warp shuffles and one
// shared-memory exchange of the warp sums; the outputs go out as 16-byte
// stores from the registers, with no second read of the row.  A row
// whose D is not a multiple of the vector, or whose pointers are not on
// 16-byte boundaries, takes elements one by one, V a thread in registers;
// a row too wide for the registers (float32 beyond 4096, or elements one
// by one beyond 4096) reads the rest in a strided loop and again to write.

#include "common.cuh"

namespace repro {

constexpr int kNormMaxThreads = 1024;

template <typename T, int W>
struct alignas(sizeof(T) * W) NormVec {
  T v[W];
};

// W scale values at p (16-byte aligned when W is a multiple of 4).
template <int W>
__device__ __forceinline__ void load_scale(const float* __restrict__ p, float (&s)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const float4 f = reinterpret_cast<const float4*>(p)[k];
      s[4 * k] = f.x;
      s[4 * k + 1] = f.y;
      s[4 * k + 2] = f.z;
      s[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) s[k] = p[k];
  }
}

template <typename T, int W>
__device__ __forceinline__ float norm_sumsq(const NormVec<T, W>& v) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float f = to_f32(v.v[k]);
    s += f * f;
  }
  return s;
}

template <typename T, int W>
__device__ __forceinline__ void norm_store(T* __restrict__ dst, const NormVec<T, W>& v,
                                           const float* __restrict__ scale, float r) {
  float s[W];
  load_scale<W>(scale, s);
  NormVec<T, W> o;
#pragma unroll
  for (int k = 0; k < W; ++k) o.v[k] = from_f32<T>(to_f32(v.v[k]) * r * s[k]);
  *reinterpret_cast<NormVec<T, W>*>(dst) = o;
}

// One row a block; each thread holds V vectors of W elements, vector j at
// index threadIdx.x + j * blockDim.x (coalesced); D % W == 0.
template <typename T, int W, int V>
__global__ void __launch_bounds__(kNormMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int D, float eps) {
  using Vec = NormVec<T, W>;
  const Vec* xr = reinterpret_cast<const Vec*>(x + static_cast<size_t>(blockIdx.x) * D);
  T* orow = out + static_cast<size_t>(blockIdx.x) * D;
  const int nvec = D / W, nt = blockDim.x, tid = threadIdx.x;
  Vec v[V];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = tid + j * nt;
    if (i < nvec) {
      v[j] = xr[i];
      ss += norm_sumsq(v[j]);
    }
  }
  for (int i = tid + V * nt; i < nvec; i += nt) ss += norm_sumsq(xr[i]);
  __shared__ float partial[kNormMaxThreads / 32];
  const int warp = tid / 32, lane = tid % 32;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  const float total = warp_sum(lane < nt / 32 ? partial[lane] : 0.f);
  const float r = rsqrtf(total / static_cast<float>(D) + eps);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = tid + j * nt;
    if (i < nvec) norm_store(orow + i * W, v[j], scale + i * W, r);
  }
  for (int i = tid + V * nt; i < nvec; i += nt) norm_store(orow + i * W, xr[i], scale + i * W, r);
}

// Threads for n vectors, V a thread: a whole number of warps, at most 1024.
inline int norm_threads(int n, int V) {
  const int per = (n + V - 1) / V;
  return per >= kNormMaxThreads ? kNormMaxThreads : (per + 31) / 32 * 32;
}

template <typename T>
int launch_rmsnorm(const void* x, const float* scale, void* out, int rows,
                   int D, float eps, cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (D % W == 0 && al(x) && al(scale) && al(out)) {
    rmsnorm_kernel<T, W, 1><<<rows, norm_threads(D / W, 1), 0, s>>>(xt, scale, ot, D, eps);
  } else {
    rmsnorm_kernel<T, 1, 4><<<rows, norm_threads(D, 4), 0, s>>>(xt, scale, ot, D, eps);
  }
  return launch_status();
}

}  // namespace repro

extern "C" int repro_rms_norm(const void* x, const void* scale, void* out,
                              int rows, int D, float eps, int dtype,
                              void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == kDtypeBF16) return launch_rmsnorm<__nv_bfloat16>(x, sc, out, rows, D, eps, s);
  return launch_rmsnorm<float>(x, sc, out, rows, D, eps, s);
}

// The message of a launcher's status code, for the Python binding.
extern "C" const char* repro_error_string(int code) {
  if (code == repro::kStatusBadHeadDim) {
    return "head dimension not compiled into the attention kernels "
           "(16, 32, 64, 80, 96, 128)";
  }
  if (code == repro::kStatusBadArgs) {
    return "inconsistent launch arguments (decode split, column slice or head "
           "chunk sizes; SSD channel slice or chunk runs; replan sizes, "
           "slices or lanes a block; flash forward or backward plan)";
  }
  if (code == repro::kStatusTensorMap) {
    return "the driver refused a TMA tensor map (operand not on a 16-byte "
           "boundary, or no cuTensorMapEncodeTiled)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
