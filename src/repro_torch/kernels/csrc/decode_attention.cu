// One-token decode attention over a KV cache for Hopper.
//
// Replaces repro/kernels/decode_attention.py::_decode_kernel (Pallas grid
// (B, KV, k blocks), all G query heads of one kv head per program, online
// softmax in VMEM scratch across the sequential k axis).  Here one block
// owns one (batch, kv head) and loops over the valid cache slots itself:
// its G warps (one query head each) share every 32-slot K/V tile it stages
// in shared memory, so the cache is read once per kv head.  Sequence b
// sees slots [max(0, L - window), L) with L = lens[b] (window 0: [0, L)).
// Any cache length works (the Pallas version asserts S % block_k == 0, so
// its cache of prompt + 64 slots breaks at a 512-token prompt).
//
// What bounds it: bytes.  Each step reads L x D x 2 values per kv head
// (230 KB at L = 449 in bf16) for 4 flops a value.  With one block per
// (batch, kv head), a batch-1 Yi-9B step runs 4 blocks on 132 SMs; the
// split-K form that spreads one cache over many blocks is later work.

#include "attention_tile.cuh"

namespace repro {

constexpr int kMaxGroup = 16;  // query heads per kv head (warps a block)

template <typename T, int D>
__global__ void decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                              const T* __restrict__ vc,
                              const int* __restrict__ lens, T* __restrict__ o,
                              int H, int KV, int S, float scale, int window) {
  __shared__ float qs[kMaxGroup * D];
  __shared__ float ks[kTileKeys * (D + 1)];
  __shared__ float vs[kTileKeys * D];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int nthreads = G * 32;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + (static_cast<size_t>(b) * H + kvh * G) * D;
  const T* kb = kc + static_cast<size_t>(b * KV + kvh) * S * D;
  const T* vb = vc + static_cast<size_t>(b * KV + kvh) * S * D;
  T* ob = o + (static_cast<size_t>(b) * H + kvh * G) * D;

  for (int i = threadIdx.x; i < G * D; i += nthreads) qs[i] = to_f32(qb[i]);
  const int L = min(max(lens[b], 0), S);
  const int start = window > 0 ? max(0, L - window) : 0;

  float m[1] = {kNegInf}, l[1] = {0.f}, acc[1][head_cols(D)];
#pragma unroll
  for (int c = 0; c < head_cols(D); ++c) acc[0][c] = 0.f;

  for (int k0 = start; k0 < L; k0 += kTileKeys) {
    __syncthreads();
    load_kv_tile<T, D>(kb, vb, k0, L, nthreads, ks, vs);
    __syncthreads();
    float s[1];
    tile_scores<D, 1>(qs + g * D, ks, lane, scale, s);
    const bool ok[1] = {k0 + lane < L};
    tile_update<D, 1>(s, ok, vs, lane, m, l, acc);
  }

  const float denom = l[0] == 0.f ? 1.f : l[0];
#pragma unroll
  for (int c = 0; c < head_cols(D); ++c) {
    const int col = lane + 32 * c;
    if (col < D) ob[static_cast<size_t>(g) * D + col] = from_f32<T>(acc[0][c] / denom);
  }
}

template <typename T, int D>
void launch_decode(const void* q, const void* kc, const void* vc,
                   const int* lens, void* o, int B, int H, int KV, int S,
                   float scale, int window, cudaStream_t s) {
  dim3 grid(KV, B);
  decode_kernel<T, D><<<grid, (H / KV) * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lens, static_cast<T*>(o), H, KV, S, scale,
      window);
}

// Launch the instantiation for head dimension D; an unlisted D launches
// nothing and returns kStatusBadHeadDim.
template <typename T>
int dispatch_decode(int D, const void* q, const void* kc, const void* vc,
                    const int* lens, void* o, int B, int H, int KV, int S,
                    float scale, int window, cudaStream_t s) {
  switch (D) {
    case 32: launch_decode<T, 32>(q, kc, vc, lens, o, B, H, KV, S, scale, window, s); break;
    case 64: launch_decode<T, 64>(q, kc, vc, lens, o, B, H, KV, S, scale, window, s); break;
    case 80: launch_decode<T, 80>(q, kc, vc, lens, o, B, H, KV, S, scale, window, s); break;
    case 128: launch_decode<T, 128>(q, kc, vc, lens, o, B, H, KV, S, scale, window, s); break;
    default: return kStatusBadHeadDim;
  }
  return launch_status();
}

}  // namespace repro

extern "C" int repro_decode_attention(const void* q, const void* kc,
                                      const void* vc, const void* lens,
                                      void* o, int B, int H, int KV, int S,
                                      int D, float scale, int window,
                                      int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == kDtypeBF16) {
    return dispatch_decode<__nv_bfloat16>(D, q, kc, vc, ln, o, B, H, KV, S, scale, window, s);
  }
  return dispatch_decode<float>(D, q, kc, vc, ln, o, B, H, KV, S, scale, window, s);
}
