// Causal / sliding-window GQA attention forward for Hopper.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (Pallas grid
// (B*H, q blocks, k blocks) with the online softmax carried in VMEM
// scratch across the sequential k axis).  GPU blocks run in no order, so
// here each block owns 16 query rows of one (batch, head) and loops over
// its key tiles itself, carrying (m, l, acc) in registers, and writes once.
// Only key tiles that some row of the block can see are visited: up to the
// causal limit, and from the window's start.  Ragged tails of the query
// and key axes are masked in the kernel, so any sequence length works
// (the Pallas version asserts Sq % block_q == 0).
//
// What bounds it: at the serving shapes (Sq = Sk = 448, H = 32, D = 128)
// the kernel does 4 * Sq * Sk / 2 * D * H ~ 1.6 GFLOP per layer over
// ~5 MB of q/k/v/o, so operations bound it.  This first version computes
// in float32 on the CUDA cores (no tensor cores, no TMA): four warps a
// block, four query rows a warp, one key per lane; see attention_tile.cuh.

#include "attention_tile.cuh"

namespace repro {

constexpr int kFlashWarps = 4;
constexpr int kFlashRows = 4;  // query rows per warp
constexpr int kFlashBlockQ = kFlashWarps * kFlashRows;
constexpr int kFlashThreads = kFlashWarps * 32;

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int KV,
             int Sq, int Sk, float scale, int causal, int window) {
  __shared__ float qs[kFlashBlockQ * D];
  __shared__ float ks[kTileKeys * (D + 1)];
  __shared__ float vs[kTileKeys * D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kFlashBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + static_cast<size_t>(bh) * Sq * D;
  const T* kb = k + static_cast<size_t>(b * KV + kvh) * Sk * D;
  const T* vb = v + static_cast<size_t>(b * KV + kvh) * Sk * D;
  T* ob = o + static_cast<size_t>(bh) * Sq * D;

  for (int i = threadIdx.x; i < kFlashBlockQ * D; i += kFlashThreads) {
    const int r = i / D, c = i - r * D;
    const int qi = q0 + r;
    qs[i] = qi < Sq ? to_f32(qb[static_cast<size_t>(qi) * D + c]) : 0.f;
  }

  int k_begin = 0, k_end = Sk;
  if (causal) {
    k_end = min(Sk, q0 + kFlashBlockQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }

  float m[kFlashRows], l[kFlashRows], acc[kFlashRows][head_cols(D)];
#pragma unroll
  for (int r = 0; r < kFlashRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < head_cols(D); ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kTileKeys) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    load_kv_tile<T, D>(kb, vb, k0, k_end, kFlashThreads, ks, vs);
    __syncthreads();
    float s[kFlashRows];
    tile_scores<D, kFlashRows>(qs + warp * kFlashRows * D, ks, lane, scale, s);
    const int kj = k0 + lane;
    bool ok[kFlashRows];
#pragma unroll
    for (int r = 0; r < kFlashRows; ++r) {
      const int qpos = q0 + warp * kFlashRows + r;
      bool valid = kj < k_end;
      if (causal) {
        valid = valid && kj <= qpos;
        if (window > 0) valid = valid && kj > qpos - window;
      }
      ok[r] = valid;
    }
    tile_update<D, kFlashRows>(s, ok, vs, lane, m, l, acc);
  }

#pragma unroll
  for (int r = 0; r < kFlashRows; ++r) {
    const int qi = q0 + warp * kFlashRows + r;
    if (qi >= Sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < head_cols(D); ++c) {
      const int col = lane + 32 * c;
      if (col < D) ob[static_cast<size_t>(qi) * D + col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int D>
void launch_flash(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int KV, int Sq, int Sk, float scale,
                  int causal, int window, cudaStream_t s) {
  dim3 grid(B * H, (Sq + kFlashBlockQ - 1) / kFlashBlockQ);
  flash_kernel<T, D><<<grid, kFlashThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Sk, scale,
      causal, window);
}

// Launch the instantiation for head dimension D; an unlisted D launches
// nothing and returns kStatusBadHeadDim.
template <typename T>
int dispatch_flash(int D, const void* q, const void* k, const void* v,
                   void* o, int B, int H, int KV, int Sq, int Sk,
                   float scale, int causal, int window, cudaStream_t s) {
  switch (D) {
    case 32: launch_flash<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal, window, s); break;
    case 64: launch_flash<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal, window, s); break;
    case 80: launch_flash<T, 80>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal, window, s); break;
    case 128: launch_flash<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal, window, s); break;
    default: return kStatusBadHeadDim;
  }
  return launch_status();
}

}  // namespace repro

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int KV, int Sq, int Sk, int D,
                                     float scale, int causal, int window,
                                     int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16) {
    return dispatch_flash<__nv_bfloat16>(D, q, k, v, o, B, H, KV, Sq, Sk, scale, causal, window, s);
  }
  return dispatch_flash<float>(D, q, k, v, o, B, H, KV, Sq, Sk, scale, causal, window, s);
}
