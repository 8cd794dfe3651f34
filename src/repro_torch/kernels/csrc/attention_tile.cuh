// One 32-key tile of online-softmax attention for a warp, used by the
// float32 prefill kernel (flash_attention.cu::flash_kernel); the bf16
// prefill and the decode kernel keep their tiles in the operands' dtype.
//
// The block stages a tile of 32 keys and values in shared memory as
// float32 (keys padded to D + 1 floats a row so that lane j reading key j
// hits 32 different banks).  Each warp owns ROWS query rows, kept in
// shared memory and read by broadcast.  Lane j scores key j against the
// warp's rows (ROWS dot products of length D), the warp takes the tile's
// max and sum by shuffles, and each lane accumulates head_cols(D) =
// ceil(D / 32) columns of the output rows: acc[r][c] holds output column
// lane + 32 c of row r, which exists only where lane + 32 c < D (D = 80
// gives three columns, the third for lanes 0-15).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kTileKeys = 32;

// Output columns a lane accumulates at head dimension D.
__host__ __device__ constexpr int head_cols(int D) { return (D + 31) / 32; }

template <int D, int ROWS>
__device__ __forceinline__ void tile_scores(const float* __restrict__ qrows,
                                            const float* __restrict__ ktile,
                                            int lane, float scale,
                                            float (&s)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
  const float* kr = ktile + lane * (D + 1);
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    const float kv = kr[c];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] += qrows[r * D + c] * kv;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r] *= scale;
}

// Merge the tile into the running (max m, sum l, acc) of each row.  A
// masked key (ok false) contributes exactly 0, so a row that has seen no
// valid key keeps l == 0 and its output is 0.
template <int D, int ROWS>
__device__ __forceinline__ void tile_update(const float (&s)[ROWS],
                                            const bool (&ok)[ROWS],
                                            const float* __restrict__ vtile,
                                            int lane, float (&m)[ROWS],
                                            float (&l)[ROWS],
                                            float (&acc)[ROWS][head_cols(D)]) {
  float p[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float tile_max = warp_max(ok[r] ? s[r] : kNegInf);
    const float m_new = fmaxf(m[r], tile_max);
    const float alpha = expf(m[r] - m_new);
    p[r] = ok[r] ? expf(s[r] - m_new) : 0.f;
    l[r] = alpha * l[r] + warp_sum(p[r]);
#pragma unroll
    for (int c = 0; c < head_cols(D); ++c) acc[r][c] *= alpha;
    m[r] = m_new;
  }
#pragma unroll 4
  for (int j = 0; j < kTileKeys; ++j) {
    float pj[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) pj[r] = __shfl_sync(0xffffffffu, p[r], j);
    const float* vr = vtile + j * D;
#pragma unroll
    for (int c = 0; c < head_cols(D); ++c) {
      const float vv = lane + 32 * c < D ? vr[lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r][c] += pj[r] * vv;
    }
  }
}

// Stage keys [k0, k0 + 32) of one (batch, kv head) slab into shared
// memory as float32; keys at or past `k_stop` are zero (and masked).
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(const T* __restrict__ kslab,
                                             const T* __restrict__ vslab,
                                             int k0, int k_stop, int nthreads,
                                             float* __restrict__ ktile,
                                             float* __restrict__ vtile) {
  for (int i = threadIdx.x; i < kTileKeys * D; i += nthreads) {
    const int r = i / D, c = i - r * D;
    const int kj = k0 + r;
    float kv = 0.f, vv = 0.f;
    if (kj < k_stop) {
      kv = to_f32(kslab[static_cast<size_t>(kj) * D + c]);
      vv = to_f32(vslab[static_cast<size_t>(kj) * D + c]);
    }
    ktile[r * (D + 1) + c] = kv;
    vtile[r * D + c] = vv;
  }
}

}  // namespace repro
