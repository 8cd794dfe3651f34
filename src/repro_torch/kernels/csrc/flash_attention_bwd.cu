// Flash-attention backward for Hopper: dQ, dK, dV of causal / sliding-window
// GQA attention from q, k, v, the forward's output o and per-row
// log-sum-exp, and the output gradient dO.
//
// Replaces repro/kernels/xla_flash.py::_flash_bwd_impl (the custom_vjp
// backward of flash_attention_xla): a lax.scan over query blocks whose
// inner scan over key blocks carries dK and dV of the whole sequence and
// adds each block's share with dynamic_update_slice.  GPU blocks run in no
// order, so that carry becomes ownership, and no sum goes through atomics.
// Each dtype has two kernels, launched in this order:
//
// - dq: a block owns 64 query rows of one (batch, head).  It forms
//   D = rowsum(dO o) of its rows where it is first needed (and writes it
//   for the second kernel), then walks the key tiles its rows can see,
//   recomputing S = q k^T and P = exp(S scale - lse), and accumulates
//   dQ += dS k with dS = P (dO v^T - D).  dQ is written once.
// - dkdv: a block owns 64 keys of one (batch, kv head).  It walks the
//   query tiles of each of the kv head's G query heads that can see its
//   keys, recomputes P and dS, and accumulates dV += P^T dO and
//   dK += dS^T q in registers over all G heads: the GQA sum happens inside
//   one block, in a fixed order, so every run gives the same bits.
//
// The masks are the forward's (causal, and a window that keeps keys
// qpos - window < kpos <= qpos); rows and keys past the ends of ragged
// tails are masked in the kernel; scale = D**-0.5; sums are float32.
//
// What bounds it: at the Yi-9B training shape, bf16 (2, 32, 2048, 128), 4
// kv heads, causal, the backward does five products over 2,098,176 causal
// pairs: 10 x pairs x 128 x 32 x 2 = 172 GFLOP, 0.174 ms at the bf16 tensor
// cores' 989 TFLOP/s, against ~151 MB of q, o, dO, dQ, k, v, dK and dV,
// 0.045 ms at 3.35 TB/s: it is bound by operations, so bf16 runs on the
// tensor cores.  The design does seven products, not five (S and dP are
// recomputed in both kernels), to keep every sum inside one block.
//
// bf16 (flash_bwd_dq_mma, flash_bwd_dkdv_mma): mma.sync m16n8k16 with the
// forward's fragment code, four warps a block.  In dq a warp owns 16 query
// rows, q in registers, dO, K and V read as fragments from shared memory
// (K and V tiles of 64 keys double buffered by cp.async); in dkdv a warp
// owns 16 keys, K and V resident in shared memory, and the query tiles of
// 32 rows (q, dO, their lse and D) double buffered.  S^T = K q^T puts the
// keys on the rows, so P^T and dS^T come out of the accumulators in the A
// layout of dV += P^T dO and dK += dS^T q, with no transpose through shared
// memory; P and dS are rounded to bf16 where they enter a product, as the
// forward rounds P.
//
// float32 (flash_bwd_dq, flash_bwd_dkdv; the zoo's models) on the CUDA
// cores: TF32 products would miss the float32 tolerance.  Tiles live in
// shared memory as float32 rows padded to D + 1 floats, so that the
// sixteen column groups of a warp read sixteen banks; each of 256 threads
// owns a 4 x 4 score tile (rows r + 16 a, keys c + 16 b) and 4 x D/16
// output elements, strided by 16 so that neighbouring threads read
// neighbouring words.

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kBwdThreads = 256;
constexpr int kBwdTile = 64;  // query rows and keys of a tile
constexpr int kBwdSub = 4;    // rows (and keys) a thread owns: 64 / 16

template <int D>
constexpr size_t bwd_dq_smem_bytes() {
  return (4ull * kBwdTile * (D + 1) + kBwdTile * (kBwdTile + 1) + 2 * kBwdTile) * sizeof(float);
}

template <int D>
constexpr size_t bwd_dkdv_smem_bytes() {
  return (4ull * kBwdTile * (D + 1) + 2 * kBwdTile * (kBwdTile + 1) + 2 * kBwdTile) *
         sizeof(float);
}

// Stage rows [r0, r0 + 64) of a (rows, D) slab into shared memory as
// float32 rows of pitch D + 1; rows at or past `n` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int r0, int n,
                                           float* __restrict__ dst) {
  for (int i = threadIdx.x; i < kBwdTile * D; i += kBwdThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * (D + 1) + c] = r0 + r < n ? to_f32(src[static_cast<size_t>(r0 + r) * D + c]) : 0.f;
  }
}

__device__ __forceinline__ bool bwd_visible(int qi, int kj, int Sq, int Sk, int causal,
                                            int window) {
  if (qi >= Sq || kj >= Sk) return false;
  if (!causal) return true;
  return kj <= qi && (window <= 0 || kj > qi - window);
}

// Whether every pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk)
// is visible: inside both ends, wholly below the diagonal, and wholly
// inside the window.
__device__ __forceinline__ bool tile_visible(int q0, int nq, int k0, int nk, int Sq, int Sk,
                                             int causal, int window) {
  if (q0 + nq > Sq || k0 + nk > Sk) return false;
  if (!causal) return true;
  return k0 + nk - 1 <= q0 && (window <= 0 || k0 > q0 + nq - 1 - window);
}

// S = q.k^T and dP = dO.v^T of the thread's 4 x 4 tile: rows tr + 16 a of
// the query tile, keys tc + 16 b of the key tile.
template <int D>
__device__ __forceinline__ void score_tiles(const float* __restrict__ qs,
                                            const float* __restrict__ dos,
                                            const float* __restrict__ ks,
                                            const float* __restrict__ vs, int tr, int tc,
                                            float (&s)[kBwdSub][kBwdSub],
                                            float (&dp)[kBwdSub][kBwdSub]) {
#pragma unroll
  for (int a = 0; a < kBwdSub; ++a) {
#pragma unroll
    for (int b = 0; b < kBwdSub; ++b) s[a][b] = dp[a][b] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[kBwdSub], oa[kBwdSub], kb[kBwdSub], vb[kBwdSub];
#pragma unroll
    for (int a = 0; a < kBwdSub; ++a) {
      qa[a] = qs[(tr + 16 * a) * (D + 1) + d];
      oa[a] = dos[(tr + 16 * a) * (D + 1) + d];
      kb[a] = ks[(tc + 16 * a) * (D + 1) + d];
      vb[a] = vs[(tc + 16 * a) * (D + 1) + d];
    }
#pragma unroll
    for (int a = 0; a < kBwdSub; ++a) {
#pragma unroll
      for (int b = 0; b < kBwdSub; ++b) {
        s[a][b] += qa[a] * kb[b];
        dp[a][b] += oa[a] * vb[b];
      }
    }
  }
}

// P = exp(S scale - lse) on the visible pairs (0 elsewhere) and
// dS = P (dP - D), written to shared rows of pitch 65 (P only if `ps`).
__device__ __forceinline__ void probs_tiles(const float (&s)[kBwdSub][kBwdSub],
                                            const float (&dp)[kBwdSub][kBwdSub],
                                            const float* __restrict__ lse_s,
                                            const float* __restrict__ delta_s, int q0, int k0,
                                            int tr, int tc, int Sq, int Sk, float scale,
                                            int causal, int window, float* __restrict__ ps,
                                            float* __restrict__ dss) {
#pragma unroll
  for (int a = 0; a < kBwdSub; ++a) {
    const int r = tr + 16 * a;
#pragma unroll
    for (int b = 0; b < kBwdSub; ++b) {
      const int c = tc + 16 * b;
      const float p =
          bwd_visible(q0 + r, k0 + c, Sq, Sk, causal, window) ? expf(s[a][b] * scale - lse_s[r]) : 0.f;
      if (ps != nullptr) ps[r * (kBwdTile + 1) + c] = p;
      dss[r * (kBwdTile + 1) + c] = p * (dp[a][b] - delta_s[r]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ o, const float* __restrict__ lse,
             const T* __restrict__ dout, float* __restrict__ delta, T* __restrict__ dq, int H,
             int KV, int Sq, int Sk, float scale, int causal, int window) {
  constexpr int kCols = D / 16;  // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [64][D + 1]
  float* dos = qs + kBwdTile * (D + 1);      // [64][D + 1]
  float* ks = dos + kBwdTile * (D + 1);      // [64][D + 1]
  float* vs = ks + kBwdTile * (D + 1);       // [64][D + 1]
  float* dss = vs + kBwdTile * (D + 1);      // [64][65]
  float* lse_s = dss + kBwdTile * (kBwdTile + 1);
  float* delta_s = lse_s + kBwdTile;

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBwdTile;  // most key tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tr = tid / 16, tc = tid % 16;
  const size_t qoff = static_cast<size_t>(bh) * Sq * D;
  const size_t koff = static_cast<size_t>(b * KV + kvh) * Sk * D;

  stage_rows<T, D>(q + qoff, q0, Sq, qs);
  stage_rows<T, D>(dout + qoff, q0, Sq, dos);
  // D = rowsum(dO o), a warp a row, written for flash_bwd_dkdv too
  for (int r = warp; r < kBwdTile; r += kBwdThreads / 32) {
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < Sq) {
      for (int c = lane; c < D; c += 32) {
        acc += to_f32(dout[qoff + static_cast<size_t>(qi) * D + c]) *
               to_f32(o[qoff + static_cast<size_t>(qi) * D + c]);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = qi < Sq ? lse[static_cast<size_t>(bh) * Sq + qi] : 0.f;
      if (qi < Sq) delta[static_cast<size_t>(bh) * Sq + qi] = acc;
    }
  }

  int k_begin = 0, k_end = Sk;
  if (causal) {
    k_end = min(Sk, q0 + kBwdTile);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  float acc[kBwdSub][kCols];
#pragma unroll
  for (int a = 0; a < kBwdSub; ++a) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[a][i] = 0.f;
  }
  for (int k0 = k_begin / kBwdTile * kBwdTile; k0 < k_end; k0 += kBwdTile) {
    __syncthreads();  // the previous tile is consumed (q, dO, D staged)
    stage_rows<T, D>(k + koff, k0, Sk, ks);
    stage_rows<T, D>(v + koff, k0, Sk, vs);
    __syncthreads();
    float s[kBwdSub][kBwdSub], dp[kBwdSub][kBwdSub];
    score_tiles<D>(qs, dos, ks, vs, tr, tc, s, dp);
    probs_tiles(s, dp, lse_s, delta_s, q0, k0, tr, tc, Sq, Sk, scale, causal, window, nullptr,
                dss);
    __syncthreads();
    // dQ += dS k: rows tr + 16 a, columns tc + 16 i
#pragma unroll 4
    for (int j = 0; j < kBwdTile; ++j) {
      float kr[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) kr[i] = ks[j * (D + 1) + tc + 16 * i];
#pragma unroll
      for (int a = 0; a < kBwdSub; ++a) {
        const float ds = dss[(tr + 16 * a) * (kBwdTile + 1) + j];
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[a][i] += ds * kr[i];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kBwdSub; ++a) {
    const int qi = q0 + tr + 16 * a;
    if (qi >= Sq) continue;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      dq[qoff + static_cast<size_t>(qi) * D + tc + 16 * i] = from_f32<T>(acc[a][i] * scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ lse, const T* __restrict__ dout,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
               int KV, int Sq, int Sk, float scale, int causal, int window) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [64][D + 1]
  float* dos = qs + kBwdTile * (D + 1);      // [64][D + 1]
  float* ks = dos + kBwdTile * (D + 1);      // [64][D + 1]
  float* vs = ks + kBwdTile * (D + 1);       // [64][D + 1]
  float* ps = vs + kBwdTile * (D + 1);       // [64][65]
  float* dss = ps + kBwdTile * (kBwdTile + 1);
  float* lse_s = dss + kBwdTile * (kBwdTile + 1);
  float* delta_s = lse_s + kBwdTile;

  const int bk = blockIdx.y, b = bk / KV, kvh = bk % KV, G = H / KV;
  const int k0 = blockIdx.x * kBwdTile;  // causal: the first keys have the most rows
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const size_t koff = static_cast<size_t>(bk) * Sk * D;

  stage_rows<T, D>(k + koff, k0, Sk, ks);
  stage_rows<T, D>(v + koff, k0, Sk, vs);
  // the query rows that can see some key of this tile
  int q_begin = 0, q_end = Sq;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(Sq, k0 + kBwdTile - 1 + window);
  }
  float adk[kBwdSub][kCols], adv[kBwdSub][kCols];
#pragma unroll
  for (int a = 0; a < kBwdSub; ++a) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) adk[a][i] = adv[a][i] = 0.f;
  }
  for (int g = 0; g < G; ++g) {
    const int bh = b * H + kvh * G + g;
    const size_t qoff = static_cast<size_t>(bh) * Sq * D;
    for (int q0 = q_begin / kBwdTile * kBwdTile; q0 < q_end; q0 += kBwdTile) {
      __syncthreads();  // the previous tile is consumed (k, v staged)
      stage_rows<T, D>(q + qoff, q0, Sq, qs);
      stage_rows<T, D>(dout + qoff, q0, Sq, dos);
      for (int r = tid; r < kBwdTile; r += kBwdThreads) {
        const int qi = q0 + r;
        lse_s[r] = qi < Sq ? lse[static_cast<size_t>(bh) * Sq + qi] : 0.f;
        delta_s[r] = qi < Sq ? delta[static_cast<size_t>(bh) * Sq + qi] : 0.f;
      }
      __syncthreads();
      float s[kBwdSub][kBwdSub], dp[kBwdSub][kBwdSub];
      score_tiles<D>(qs, dos, ks, vs, tr, tc, s, dp);
      probs_tiles(s, dp, lse_s, delta_s, q0, k0, tr, tc, Sq, Sk, scale, causal, window, ps,
                  dss);
      __syncthreads();
      // dV += P^T dO and dK += dS^T q: keys tr + 16 a, columns tc + 16 i
#pragma unroll 2
      for (int r = 0; r < kBwdTile; ++r) {
        float dor[kCols], qr[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          dor[i] = dos[r * (D + 1) + tc + 16 * i];
          qr[i] = qs[r * (D + 1) + tc + 16 * i];
        }
#pragma unroll
        for (int a = 0; a < kBwdSub; ++a) {
          const float p = ps[r * (kBwdTile + 1) + tr + 16 * a];
          const float ds = dss[r * (kBwdTile + 1) + tr + 16 * a];
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            adv[a][i] += p * dor[i];
            adk[a][i] += ds * qr[i];
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kBwdSub; ++a) {
    const int kj = k0 + tr + 16 * a;
    if (kj >= Sk) continue;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const size_t at = koff + static_cast<size_t>(kj) * D + tc + 16 * i;
      dk[at] = from_f32<T>(adk[a][i] * scale);
      dv[at] = from_f32<T>(adv[a][i]);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, float32 accumulators), the
// forward's fragment code (flash_attention.cu::flash_kernel_mma): every
// product of the backward is an A.B of bf16 tiles in shared memory or
// registers, P and dS rounded to bf16 where they enter a product.
// ---------------------------------------------------------------------
constexpr int kMmaBwdThreads = 128;  // four warps
constexpr int kMmaBwdTile = 64;      // dq: query rows a block, keys a tile;
                                     // dkdv: keys a block (16 a warp)
constexpr int kMmaBwdQTile = 32;     // dkdv: query rows a tile
constexpr int kMmaBwdPad = 8;        // bf16 padding of a shared row (16 bytes)
constexpr float kLog2e = 1.4426950408889634f;

// A fragment (16 x 16): rows m0.., columns k0.. of a [m][k] tile.
__device__ __forceinline__ void lds_a(uint32_t (&a)[4], const bf16* t, int P, int m0, int k0,
                                      int lane) {
  ldmatrix_x4(a, t + (m0 + (lane & 15)) * P + k0 + (lane >> 4) * 8);
}
// B fragments of the n-tiles n0.. and n0 + 8.. (regs 0-1, 2-3) over k0..
// k0 + 15, from a [n][k] tile.
__device__ __forceinline__ void lds_b_nk(uint32_t (&b)[4], const bf16* t, int P, int n0, int k0,
                                         int lane) {
  ldmatrix_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + k0 + ((lane >> 3) & 1) * 8);
}
// The same from a [k][n] tile (read transposed).
__device__ __forceinline__ void lds_b_kn(uint32_t (&b)[4], const bf16* t, int P, int k0, int n0,
                                         int lane) {
  ldmatrix_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + n0 + (lane >> 4) * 8);
}

// Accumulator n-tiles 2 kk and 2 kk + 1 as the A fragment of k-step kk.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

template <int D>
constexpr size_t bwd_dq_mma_smem_bytes() {
  return (6ull * kMmaBwdTile) * (D + kMmaBwdPad) * sizeof(bf16) + 2 * kMmaBwdTile * sizeof(float);
}

template <int D>
constexpr size_t bwd_dkdv_mma_smem_bytes() {
  return (2ull * kMmaBwdTile + 4 * kMmaBwdQTile) * (D + kMmaBwdPad) * sizeof(bf16) +
         4 * kMmaBwdQTile * sizeof(float);
}

// dQ of 64 query rows of one (batch, head): four warps of 16 rows, q in
// registers, dO from shared memory, K and V tiles of 64 keys double
// buffered by cp.async.
template <int D>
__global__ void __launch_bounds__(kMmaBwdThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const float* __restrict__ lse, const bf16* __restrict__ dout,
                 float* __restrict__ delta, bf16* __restrict__ dq, int H, int KV, int Sq,
                 int Sk, float scale, int causal, int window) {
  constexpr int P = D + kMmaBwdPad, KSTEPS = D / 16, NT = D / 8, CH = D / 8;
  constexpr int T = kMmaBwdTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][P]
  bf16* dos = qs + T * P;                        // [64][P]
  bf16* ks = dos + T * P;                        // [2][64][P]
  bf16* vs = ks + 2 * T * P;                     // [2][64][P]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * T * P);  // [64], log2 units
  float* delta_s = lse_s + T;                               // [64]

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T;  // most key tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, t4 = lane & 3;
  const size_t qoff = static_cast<size_t>(bh) * Sq * D;
  const bf16* kg = k + static_cast<size_t>(b * KV + kvh) * Sk * D;
  const bf16* vg = v + static_cast<size_t>(b * KV + kvh) * Sk * D;

  for (int i = tid; i < T * CH; i += kMmaBwdThreads) {
    const int r = i / CH, c = i - r * CH, qi = q0 + r;
    const size_t src = qoff + static_cast<size_t>(min(qi, Sq - 1)) * D + c * 8;
    cp_async16(qs + r * P + c * 8, q + src, qi < Sq);
    cp_async16(dos + r * P + c * 8, dout + src, qi < Sq);
  }
  cp_async_commit();
  // D = rowsum(dO o) where it is first needed, a warp a row; written for
  // flash_bwd_dkdv_mma
  for (int r = warp; r < T; r += kMmaBwdThreads / 32) {
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < Sq) {
      for (int c = lane; c < D; c += 32) {
        const size_t at = qoff + static_cast<size_t>(qi) * D + c;
        acc += __bfloat162float(dout[at]) * __bfloat162float(o[at]);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = qi < Sq ? lse[static_cast<size_t>(bh) * Sq + qi] * kLog2e : 0.f;
      if (qi < Sq) delta[static_cast<size_t>(bh) * Sq + qi] = acc;
    }
  }

  int k_begin = 0, k_end = Sk;
  if (causal) {
    k_end = min(Sk, q0 + T);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  const int t_begin = k_begin / T;
  const int ntiles = max(0, (k_end + T - 1) / T - t_begin);
  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * T;
    bf16* kd = ks + st * T * P;
    bf16* vd = vs + st * T * P;
    for (int i = tid; i < T * CH; i += kMmaBwdThreads) {
      const int r = i / CH, c = i - r * CH, kj = k0 + r;
      const size_t src = static_cast<size_t>(min(kj, Sk - 1)) * D + c * 8;
      cp_async16(kd + r * P + c * 8, kg + src, kj < Sk);
      cp_async16(vd + r * P + c * 8, vg + src, kj < Sk);
    }
    cp_async_commit();
  };

  const float scale_log2 = scale * kLog2e;
  const int row0 = q0 + warp * 16 + gr, row1 = row0 + 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[KSTEPS][4];
  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};

  if (ntiles > 0) load_kv(t_begin, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int tile = t_begin + it, st = it & 1, k0 = tile * T;
    if (it + 1 < ntiles) {
      load_kv(tile + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) lds_a(qf[kk], qs, P, warp * 16, kk * 16, lane);
      lse_r[0] = lse_s[warp * 16 + gr];
      lse_r[1] = lse_s[warp * 16 + gr + 8];
      del_r[0] = delta_s[warp * 16 + gr];
      del_r[1] = delta_s[warp * 16 + gr + 8];
    }
    const bf16* kt = ks + st * T * P;
    const bf16* vt = vs + st * T * P;

    // S = q k^T and dP = dO v^T: 16 rows x 64 keys a warp
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t da[4];
      lds_a(da, dos, P, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4], vb[4];
        lds_b_nk(kb, kt, P, np * 16, kk * 16, lane);
        mma_bf16(sc[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], kb[2], kb[3]);
        lds_b_nk(vb, vt, P, np * 16, kk * 16, lane);
        mma_bf16(dp[2 * np], da, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }
    // dS = P (dP - D), P = exp2(S scale log2 e - lse log2 e) where visible;
    // only tiles that cross the diagonal, an end or the window's edge check
    // each pair (as the forward)
    const bool need_mask = !tile_visible(q0, T, k0, T, Sq, Sk, causal, window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + j * 8 + 2 * t4 + (e & 1);
        const float p = !need_mask || bwd_visible(row, col, Sq, Sk, causal, window)
                            ? exp2f(sc[j][e] * scale_log2 - lse_r[e >> 1])
                            : 0.f;
        sc[j][e] = p * (dp[j][e] - del_r[e >> 1]);
      }
    }
    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(sa[kk], sc[2 * kk], sc[2 * kk + 1]);
    // dQ += dS k: k rows are keys, read transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t kb[4];
        lds_b_kn(kb, kt, P, kk * 16, dp2 * 16, lane);
        mma_bf16(acc[2 * dp2], sa[kk], kb[0], kb[1]);
        mma_bf16(acc[2 * dp2 + 1], sa[kk], kb[2], kb[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  if (ntiles == 0) cp_async_wait<0>();
  bf16* dqg = dq + qoff;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t4;
    if (row0 < Sq) {
      *reinterpret_cast<uint32_t*>(dqg + static_cast<size_t>(row0) * D + col) =
          pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    }
    if (row1 < Sq) {
      *reinterpret_cast<uint32_t*>(dqg + static_cast<size_t>(row1) * D + col) =
          pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
    }
  }
}

// dK and dV of 64 keys of one (batch, kv head): four warps of 16 keys, k
// and v resident in shared memory, the query tiles (32 rows of q and dO,
// their lse and D) of all G query heads double buffered by cp.async.
template <int D>
__global__ void __launch_bounds__(kMmaBwdThreads)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ lse,
                   const bf16* __restrict__ dout, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV, int Sq, int Sk,
                   float scale, int causal, int window) {
  constexpr int P = D + kMmaBwdPad, KSTEPS = D / 16, NT = D / 8, CH = D / 8;
  constexpr int T = kMmaBwdTile, QT = kMmaBwdQTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][P]
  bf16* vs = ks + T * P;                         // [64][P]
  bf16* qs = vs + T * P;                         // [2][32][P]
  bf16* dos = qs + 2 * QT * P;                   // [2][32][P]
  float* rowf = reinterpret_cast<float*>(dos + 2 * QT * P);  // [2][lse 32, D 32]

  const int bk = blockIdx.y, b = bk / KV, kvh = bk % KV, G = H / KV;
  const int k0 = blockIdx.x * T;  // causal: the first keys have the most rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, t4 = lane & 3;
  const size_t koff = static_cast<size_t>(bk) * Sk * D;

  for (int i = tid; i < T * CH; i += kMmaBwdThreads) {
    const int r = i / CH, c = i - r * CH, kj = k0 + r;
    const size_t src = koff + static_cast<size_t>(min(kj, Sk - 1)) * D + c * 8;
    cp_async16(ks + r * P + c * 8, k + src, kj < Sk);
    cp_async16(vs + r * P + c * 8, v + src, kj < Sk);
  }
  cp_async_commit();

  // the query rows that can see some key of this block, in tiles of 32
  int q_begin = 0, q_end = Sq;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(Sq, k0 + T - 1 + window);
  }
  const int t_begin = q_begin / QT;
  const int per_head = max(0, (q_end + QT - 1) / QT - t_begin);
  const int total = G * per_head;
  auto load_q = [&](int idx, int st) {
    const int g = idx / per_head, q0 = (t_begin + idx % per_head) * QT;
    const size_t bh = static_cast<size_t>(b) * H + kvh * G + g;
    const size_t qoff = bh * Sq * D;
    bf16* qd = qs + st * QT * P;
    bf16* dd = dos + st * QT * P;
    for (int i = tid; i < QT * CH; i += kMmaBwdThreads) {
      const int r = i / CH, c = i - r * CH, qi = q0 + r;
      const size_t src = qoff + static_cast<size_t>(min(qi, Sq - 1)) * D + c * 8;
      cp_async16(qd + r * P + c * 8, q + src, qi < Sq);
      cp_async16(dd + r * P + c * 8, dout + src, qi < Sq);
    }
    cp_async_commit();
    for (int r = tid; r < QT; r += kMmaBwdThreads) {
      const int qi = q0 + r;
      rowf[st * 2 * QT + r] = qi < Sq ? lse[bh * Sq + qi] * kLog2e : 0.f;
      rowf[st * 2 * QT + QT + r] = qi < Sq ? delta[bh * Sq + qi] : 0.f;
    }
  };

  const float scale_log2 = scale * kLog2e;
  const int key0 = k0 + warp * 16 + gr;  // this thread's keys: key0, key0 + 8
  float adk[NT][4], adv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;
  }
  if (total > 0) load_q(0, 0);
  for (int it = 0; it < total; ++it) {
    const int st = it & 1, q0 = (t_begin + it % per_head) * QT;
    if (it + 1 < total) {
      load_q(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + st * QT * P;
    const bf16* dt = dos + st * QT * P;
    const float* lf = rowf + st * 2 * QT;

    // S^T = k q^T and dP^T = v dO^T: 16 keys x 32 rows a warp
    float sT[4][4], dpT[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      lds_a(ka, ks, P, warp * 16, kk * 16, lane);
      lds_a(va, vs, P, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t qb[4], ob[4];
        lds_b_nk(qb, qt, P, np * 16, kk * 16, lane);
        mma_bf16(sT[2 * np], ka, qb[0], qb[1]);
        mma_bf16(sT[2 * np + 1], ka, qb[2], qb[3]);
        lds_b_nk(ob, dt, P, np * 16, kk * 16, lane);
        mma_bf16(dpT[2 * np], va, ob[0], ob[1]);
        mma_bf16(dpT[2 * np + 1], va, ob[2], ob[3]);
      }
    }
    // P^T and dS^T = P^T (dP^T - D) on the visible pairs
    const bool need_mask = !tile_visible(q0, QT, k0, T, Sq, Sk, causal, window);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + (e >> 1) * 8;
        const int r = j * 8 + 2 * t4 + (e & 1);
        const float p = !need_mask || bwd_visible(q0 + r, key, Sq, Sk, causal, window)
                            ? exp2f(sT[j][e] * scale_log2 - lf[r])
                            : 0.f;
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - lf[QT + r]);
      }
    }
    uint32_t pa[2][4], sa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      acc_to_a(pa[kk], sT[2 * kk], sT[2 * kk + 1]);
      acc_to_a(sa[kk], dpT[2 * kk], dpT[2 * kk + 1]);
    }
    // dV += P^T dO and dK += dS^T q: the tile's rows are the k-steps
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t ob[4], qb[4];
        lds_b_kn(ob, dt, P, kk * 16, dp2 * 16, lane);
        mma_bf16(adv[2 * dp2], pa[kk], ob[0], ob[1]);
        mma_bf16(adv[2 * dp2 + 1], pa[kk], ob[2], ob[3]);
        lds_b_kn(qb, qt, P, kk * 16, dp2 * 16, lane);
        mma_bf16(adk[2 * dp2], sa[kk], qb[0], qb[1]);
        mma_bf16(adk[2 * dp2 + 1], sa[kk], qb[2], qb[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  if (total == 0) cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kj = key0 + 8 * half;
      if (kj >= Sk) continue;
      const size_t at = koff + static_cast<size_t>(kj) * D + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(adk[j][2 * half] * scale, adk[j][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(adv[j][2 * half], adv[j][2 * half + 1]);
    }
  }
}

template <int D>
int launch_flash_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                         const float* lse, const void* dout, float* delta, void* dq, void* dk,
                         void* dv, int B, int H, int KV, int Sq, int Sk, float scale,
                         int causal, int window, cudaStream_t s) {
  constexpr size_t smem_dq = bwd_dq_mma_smem_bytes<D>();
  constexpr size_t smem_dkdv = bwd_dkdv_mma_smem_bytes<D>();
  int st = allow_smem(flash_bwd_dq_mma<D>, smem_dq);
  if (st) return st;
  st = allow_smem(flash_bwd_dkdv_mma<D>, smem_dkdv);
  if (st) return st;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  dim3 grid_dq((Sq + kMmaBwdTile - 1) / kMmaBwdTile, B * H);
  flash_bwd_dq_mma<D><<<grid_dq, kMmaBwdThreads, smem_dq, s>>>(
      qt, kt, vt, static_cast<const bf16*>(o), lse, dot, delta, static_cast<bf16*>(dq), H, KV,
      Sq, Sk, scale, causal, window);
  st = launch_status();
  if (st) return st;
  dim3 grid_kv((Sk + kMmaBwdTile - 1) / kMmaBwdTile, B * KV);
  flash_bwd_dkdv_mma<D><<<grid_kv, kMmaBwdThreads, smem_dkdv, s>>>(
      qt, kt, vt, lse, dot, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KV, Sq,
      Sk, scale, causal, window);
  return launch_status();
}

template <typename T, int D>
int launch_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                     const float* lse, const void* dout, float* delta, void* dq, void* dk,
                     void* dv, int B, int H, int KV, int Sq, int Sk, float scale, int causal,
                     int window, cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_flash_bwd_mma<D>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KV, Sq, Sk,
                                   scale, causal, window, s);
  } else {
    constexpr size_t smem_dq = bwd_dq_smem_bytes<D>();
    constexpr size_t smem_dkdv = bwd_dkdv_smem_bytes<D>();
    int st = allow_smem(flash_bwd_dq<T, D>, smem_dq);
    if (st) return st;
    st = allow_smem(flash_bwd_dkdv<T, D>, smem_dkdv);
    if (st) return st;
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* dot = static_cast<const T*>(dout);
    dim3 grid_dq((Sq + kBwdTile - 1) / kBwdTile, B * H);
    flash_bwd_dq<T, D><<<grid_dq, kBwdThreads, smem_dq, s>>>(
        qt, kt, vt, static_cast<const T*>(o), lse, dot, delta, static_cast<T*>(dq), H, KV, Sq,
        Sk, scale, causal, window);
    st = launch_status();
    if (st) return st;
    dim3 grid_kv((Sk + kBwdTile - 1) / kBwdTile, B * KV);
    flash_bwd_dkdv<T, D><<<grid_kv, kBwdThreads, smem_dkdv, s>>>(
        qt, kt, vt, lse, dot, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, KV, Sq, Sk,
        scale, causal, window);
    return launch_status();
  }
}

// Launch the instantiation for head dimension D; an unlisted D launches
// nothing and returns kStatusBadHeadDim.
template <typename T>
int dispatch_flash_bwd(int D, const void* q, const void* k, const void* v, const void* o,
                       const float* lse, const void* dout, float* delta, void* dq, void* dk,
                       void* dv, int B, int H, int KV, int Sq, int Sk, float scale, int causal,
                       int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch_flash_bwd<T, 16>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, s);
    case 32: return launch_flash_bwd<T, 32>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, s);
    case 64: return launch_flash_bwd<T, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, s);
    case 80: return launch_flash_bwd<T, 80>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, s);
    case 96: return launch_flash_bwd<T, 96>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, s);
    case 128: return launch_flash_bwd<T, 128>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, s);
    default: return kStatusBadHeadDim;
  }
}

}  // namespace repro

extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* delta, void* dq, void* dk, void* dv, int B,
                                         int H, int KV, int Sq, int Sk, int D, float scale,
                                         int causal, int window, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == kDtypeBF16) {
    return dispatch_flash_bwd<__nv_bfloat16>(D, q, k, v, o, l, dout, dl, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, s);
  }
  return dispatch_flash_bwd<float>(D, q, k, v, o, l, dout, dl, dq, dk, dv, B, H, KV, Sq, Sk, scale, causal, window, s);
}
