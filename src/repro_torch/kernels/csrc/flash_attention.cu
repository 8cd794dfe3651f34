// Causal / sliding-window GQA attention forward for Hopper.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (Pallas grid
// (B*H, q blocks, k blocks) with the online softmax carried in VMEM
// scratch across the sequential k axis).  GPU blocks run in no order, so
// here each block owns a block of query rows of one (batch, head), loops
// over its key tiles itself, carrying (m, l, acc) in registers, and writes
// once.  Only key tiles that some row of the block can see are visited: up
// to the causal limit, and from the window's start.  Ragged tails of the
// query and key axes are masked in the kernel, so any sequence length
// works (the Pallas version asserts Sq % block_q == 0).
//
// What bounds it: at a 448-token Yi-9B prefill (H = 32, D = 128) a layer
// does 4 x D x H x 100,576 causal pairs = 1.65 GFLOP, 1.7 us at the bf16
// tensor cores' 989 TFLOP/s, and moves ~8.3 MB of q, k, v and o, 2.5 us at
// 3.35 TB/s: bytes just above operations.  A kernel on the CUDA cores in
// float32 (67 TFLOP/s) is bound by operations instead, 25 us at best.
//
// bf16 operands take flash_kernel_mma: four warps own 64 query rows, 16 a
// warp, with Q's fragments in registers.  K and V tiles of 64 keys stay
// bf16 in shared memory, copied by cp.async in two stages so that the next
// tile's copy overlaps this tile's products; rows are padded by 16 bytes,
// which puts the eight rows of every ldmatrix phase in distinct banks at
// D = 128 (272-byte rows) and D = 80 (176-byte rows).  S = Q.K^T and
// O += P.V run on mma.sync m16n8k16 (bf16 in, float32 accumulate), K
// through ldmatrix and V through ldmatrix.trans; the online softmax works
// on the accumulator fragments (row max and sum by quad shuffles, exp2
// with the scale folded into log2 e), and P is rounded to bf16 in
// registers and reused as the A operand, as ref.attention rounds its
// probabilities to v.dtype.  Causal blocks visit only the tiles at or
// below their diagonal and mask only the diagonal tile, the ragged tail
// and the window's first tiles; the query blocks with the most tiles are
// launched first, so the causal triangle balances over the card.
//
// float32 operands take flash_kernel on the CUDA cores (four warps, four
// query rows a warp, one key a lane; attention_tile.cuh): TF32 products
// would miss the float32 tolerance of 2e-5, and no served path runs
// float32 on the card.  The C entry point chooses by dtype; a bf16 call
// never reaches the float32 kernel.

#include <type_traits>

#include "attention_tile.cuh"

namespace repro {

// ---------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------
constexpr int kFlashWarps = 4;
constexpr int kFlashRows = 4;  // query rows per warp
constexpr int kFlashBlockQ = kFlashWarps * kFlashRows;
constexpr int kFlashThreads = kFlashWarps * 32;

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int H, int KV, int Sq, int Sk,
             float scale, int causal, int window) {
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
    if (lse != nullptr && lane == 0) {
      lse[static_cast<size_t>(bh) * Sq + qi] = l[r] == 0.f ? kNegInf : m[r] + logf(l[r]);
    }
#pragma unroll
    for (int c = 0; c < head_cols(D); ++c) {
      const int col = lane + 32 * c;
      if (col < D) ob[static_cast<size_t>(qi) * D + col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------
constexpr int kMmaThreads = 128;  // four warps
constexpr int kMmaBlockQ = 64;    // query rows a block, 16 a warp
constexpr int kMmaBlockK = 64;    // keys a tile
constexpr int kMmaPad = 8;        // bf16 padding of a shared row (16 bytes)

template <int D>
constexpr size_t flash_mma_smem_bytes() {
  return static_cast<size_t>(kMmaBlockQ + 4 * kMmaBlockK) * (D + kMmaPad) * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                 float scale_log2, int causal, int window) {
  constexpr int P = D + kMmaPad;  // shared row pitch (elements)
  constexpr int KSTEPS = D / 16;  // k-steps of Q.K^T
  constexpr int NT = D / 8;       // n-tiles of the output
  constexpr int CH = D / 8;       // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][P]
  bf16* ks = qs + kMmaBlockQ * P;                // [2][64][P]
  bf16* vs = ks + 2 * kMmaBlockK * P;            // [2][64][P]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBlockQ;  // most tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const bf16* qg = q + static_cast<size_t>(bh) * Sq * D;
  const bf16* kg = k + static_cast<size_t>(b * KV + kvh) * Sk * D;
  const bf16* vg = v + static_cast<size_t>(b * KV + kvh) * Sk * D;
  bf16* og = o + static_cast<size_t>(bh) * Sq * D;

  int k_begin = 0, k_end = Sk;
  if (causal) {
    k_end = min(Sk, q0 + kMmaBlockQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  const int t_begin = k_begin / kMmaBlockK;
  const int ntiles = max(0, (k_end + kMmaBlockK - 1) / kMmaBlockK - t_begin);

  // Q, then the first K/V tile: two commit groups; rows past the end are
  // zero-filled (and never written back or seen unmasked)
  for (int i = tid; i < kMmaBlockQ * CH; i += kMmaThreads) {
    const int r = i / CH, c = i - r * CH, qi = q0 + r;
    cp_async16(qs + r * P + c * 8, qg + static_cast<size_t>(min(qi, Sq - 1)) * D + c * 8,
               qi < Sq);
  }
  cp_async_commit();
  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * kMmaBlockK;
    bf16* kd = ks + st * kMmaBlockK * P;
    bf16* vd = vs + st * kMmaBlockK * P;
    for (int i = tid; i < kMmaBlockK * CH; i += kMmaThreads) {
      const int r = i / CH, c = i - r * CH, kj = k0 + r;
      const size_t src = static_cast<size_t>(min(kj, Sk - 1)) * D + c * 8;
      cp_async16(kd + r * P + c * 8, kg + src, kj < Sk);
      cp_async16(vd + r * P + c * 8, vg + src, kj < Sk);
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  uint32_t qf[KSTEPS][4];
  const int row0 = q0 + warp * 16 + gr, row1 = row0 + 8;

  if (ntiles > 0) load_kv(t_begin, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int tile = t_begin + it, st = it & 1, k0 = tile * kMmaBlockK;
    if (it + 1 < ntiles) {
      load_kv(tile + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
      }
    }
    const bf16* kt = ks + st * kMmaBlockK * P;
    const bf16* vt = vs + st * kMmaBlockK * P;

    // S = Q.K^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale into log2 units; mask the diagonal tile, the ragged tail and
    // the window's edge with -inf (exp2 gives exactly 0)
    const bool need_mask = k0 + kMmaBlockK > Sk ||
                           (causal && (k0 + kMmaBlockK - 1 > q0 ||
                                       (window > 0 && k0 <= q0 + kMmaBlockQ - 1 - window)));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[j][e] * scale_log2;
        if (need_mask) {
          const int row = e < 2 ? row0 : row1;
          const int col = k0 + j * 8 + 2 * t4 + (e & 1);
          bool ok = col < Sk;
          if (causal) ok = ok && col <= row && (window <= 0 || col > row - window);
          if (!ok) s = __int_as_float(static_cast<int>(0xff800000u));  // -inf
        }
        sc[j][e] = s;
      }
    }

    // online softmax on the fragments: rows row0 (e 0, 1) and row1 (e 2, 3)
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha0 = exp2f(m_r[0] - mx[0]), alpha1 = exp2f(m_r[1] - mx[1]);
    m_r[0] = mx[0];
    m_r[1] = mx[1];
    l_r[0] *= alpha0;
    l_r[1] *= alpha1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }
    uint32_t pa[4][4];  // P as the A operand of four 16-key steps
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(sc[j][0] - mx[0]), p1 = exp2f(sc[j][1] - mx[0]);
      const float p2 = exp2f(sc[j][2] - mx[1]), p3 = exp2f(sc[j][3] - mx[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P.V: V rows are keys, read transposed as the B operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  if (ntiles == 0) cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  const float d0 = l_r[0] == 0.f ? 1.f : l_r[0], d1 = l_r[1] == 0.f ? 1.f : l_r[1];
  if (lse != nullptr && t4 == 0) {
    // natural log of the row sum of exp(q.k scale): m_r and the sum are
    // in log2 units, so log(l) + m ln 2 = (m + log2 l) ln 2
    constexpr float kLn2 = 0.6931471805599453f;
    float* lb = lse + static_cast<size_t>(bh) * Sq;
    if (row0 < Sq) lb[row0] = l_r[0] == 0.f ? kNegInf : (m_r[0] + log2f(l_r[0])) * kLn2;
    if (row1 < Sq) lb[row1] = l_r[1] == 0.f ? kNegInf : (m_r[1] + log2f(l_r[1])) * kLn2;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t4;
    if (row0 < Sq) {
      *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row0) * D + col) =
          pack_bf16(acc[j][0] / d0, acc[j][1] / d0);
    }
    if (row1 < Sq) {
      *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row1) * D + col) =
          pack_bf16(acc[j][2] / d1, acc[j][3] / d1);
    }
  }
}

template <int D>
int launch_flash_mma(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int H, int KV, int Sq, int Sk,
                     float scale, int causal, int window, cudaStream_t s) {
  constexpr size_t smem = flash_mma_smem_bytes<D>();
  const int st = allow_smem(flash_kernel_mma<D>, smem);
  if (st) return st;
  dim3 grid(B * H, (Sq + kMmaBlockQ - 1) / kMmaBlockQ);
  flash_kernel_mma<D><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, KV, Sq,
      Sk, scale * 1.4426950408889634f, causal, window);
  return launch_status();
}

// The kernel of dtype T at head dimension D: bf16 on the tensor cores,
// float32 on the CUDA cores.
template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int KV, int Sq, int Sk,
                 float scale, int causal, int window, cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_flash_mma<D>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
  } else {
    dim3 grid(B * H, (Sq + kFlashBlockQ - 1) / kFlashBlockQ);
    flash_kernel<float, D><<<grid, kFlashThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, KV, Sq,
        Sk, scale, causal, window);
    return launch_status();
  }
}

// Launch the instantiation for head dimension D; an unlisted D launches
// nothing and returns kStatusBadHeadDim.
template <typename T>
int dispatch_flash(int D, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int H, int KV, int Sq, int Sk,
                   float scale, int causal, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch_flash<T, 16>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    case 32: return launch_flash<T, 32>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    case 64: return launch_flash<T, 64>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    case 80: return launch_flash<T, 80>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    case 96: return launch_flash<T, 96>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    case 128: return launch_flash<T, 128>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    default: return kStatusBadHeadDim;
  }
}

}  // namespace repro

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int H, int KV, int Sq, int Sk,
                                     int D, float scale, int causal,
                                     int window, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kDtypeBF16) {
    return dispatch_flash<__nv_bfloat16>(D, q, k, v, o, l, B, H, KV, Sq, Sk, scale, causal, window, s);
  }
  return dispatch_flash<float>(D, q, k, v, o, l, B, H, KV, Sq, Sk, scale, causal, window, s);
}
