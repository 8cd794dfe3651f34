// Flash-attention backward for Hopper: dQ, dK, dV of causal / sliding-window
// / full GQA attention from q, k, v, the forward's output o and per-row
// log-sum-exp, and the output gradient dO.
//
// Replaces repro/kernels/xla_flash.py::_flash_bwd_impl (the custom_vjp
// backward of flash_attention_xla): a lax.scan over query blocks whose
// inner scan over key blocks carries dK and dV of the whole sequence and
// adds each block's share with dynamic_update_slice.  GPU blocks run in no
// order, so that carry becomes ownership, and no sum goes through atomics:
// every sum runs in a fixed order and two calls give the same bits.  One
// call launches three kernels, in this order, from the launch plan that
// flash_attention.py::bwd_plan computes from the shapes:
//
// - prep: D = rowsum(dO o) of every query row in float32, 16-byte loads,
//   each row summed in a fixed order.  dq and dkdv both read it, so they
//   no longer depend on each other.
// - dq: a block owns the query rows of one tile of one (batch, head) and
//   walks the key tiles its rows can see, recomputing S = q k^T and
//   P = exp(S scale - lse), and accumulates dQ += dS k with
//   dS = P (dO v^T - D).  dQ is written once.
// - dkdv: a block owns the keys of one tile and walks the query tiles that
//   can see them, recomputing P and dS, and accumulates dV += P^T dO and
//   dK += dS^T q.  In bf16 a block takes `heads` query heads of its kv
//   head (one, for every G <= 8) and the G / heads blocks of one (key tile,
//   kv head) form a thread block cluster: each puts its float32 partials
//   in its own shared memory, and after cluster.sync() rank r sums a
//   1 / cluster share of the rows over ranks 0.. in rank order through
//   distributed shared memory and writes them.  In float32 a block sums
//   all G heads of its kv head itself, in head order.
//
// S and dP are recomputed in both kernels (seven products, not five): the
// five-product form sums dQ across the dkdv blocks, which takes atomics
// (not deterministic) or ordered semaphores, left to the wgmma design.
//
// The masks are the forward's (causal, and a window that keeps keys
// qpos - window < kpos <= qpos); rows and keys past the ends of ragged
// tails are masked in the kernel; scale = D**-0.5; sums are float32.
//
// What bounds it.  At the Yi-9B training shape, bf16 (2, 32, 2048, 128), 4
// kv heads, causal, five products over 2,098,176 causal pairs are
// 10 x pairs x 128 x 32 x 2 = 172 GFLOP, 0.174 ms at the bf16 tensor cores'
// 989 TFLOP/s, against ~151 MB of q, o, dO, dQ, k, v, dK and dV, 0.045 ms
// at 3.35 TB/s: operations, so bf16 runs on the tensor cores.  What held
// the previous design back, and what this one does about it:
// 1. dK/dV of GQA ran one block per kv head, its G heads in series (256
//    blocks at Yi-9B, 40 at LLaVA's (1, 56, 320, 128) kv 8).  Here one
//    block per (key tile, query head) and a cluster sum: G times the
//    blocks, no device-memory traffic for the sum.
// 2. Heavy and light tiles were dispatched mixed.  Here the tile is the
//    slow grid axis, heaviest first: key tile 0 first in dkdv, the last
//    query tile first in dq (causal), so every head's heaviest tile starts
//    before any head's next one and the tail is one light block long.
// 3. dkdv warps held 16 keys x 32 query rows a step.  A causal plan takes
//    64 rows at D = 64-96, which halves the K and V fragment reads and the
//    barriers a row; at D = 128 that step needs more than 255 registers
//    a thread and spills, so there it stays 32.  Each warp step still
//    reads 80 ldmatrix.x4 for 128 mma (D = 128), and 241 registers a
//    thread leave two blocks, eight warps, an SM: mma.sync from
//    ldmatrix-fed registers is what bounds the bf16 path now, which the
//    wgmma design (B read from shared memory, accumulators spread over a
//    warpgroup) is for.
// 4. D was computed inside dq, a warp a row with 2-byte loads, so dkdv had
//    to wait for dq.  Here the prep pass.
// 5. float32 ran 64 x 64 tiles, 64 blocks at train-100m's (4, 8, 128, 64)
//    on 132 SMs, staging 4 bytes at a time and reading shared memory a
//    word per two FMAs.  Here the plan picks 16-, 32- or 64-row (key)
//    tiles so that a grid comes near two blocks an SM, tiles arrive by
//    cp.async 16 bytes a copy, all in flight at once, and every thread
//    owns a 4 x 4 score tile read as float4 along D (4 FMAs a loaded
//    word); exact float32 FMAs on the CUDA cores stay (TF32 would miss
//    the 2e-5 float32 tolerance).
//
// bf16 (flash_bwd_dq_mma, flash_bwd_dkdv_mma): mma.sync m16n8k16 with the
// forward's fragment code, four warps a block.  In dq a warp owns 16 query
// rows, q in registers, dO, K and V read as fragments from shared memory
// (K and V tiles of 64 keys double buffered by cp.async); in dkdv a warp
// owns 16 keys, K and V resident in shared memory, the query tiles (q, dO,
// their lse and D) double buffered.  S^T = K q^T puts the keys on the rows,
// so P^T and dS^T come out of the accumulators in the A layout of
// dV += P^T dO and dK += dS^T q, with no transpose through shared memory;
// P and dS are rounded to bf16 where they enter a product, as the forward
// rounds P.
//
// float32 (flash_bwd_dq_f32, flash_bwd_dkdv_f32; the zoo's and train-100m's
// models) on the CUDA cores: 4 T threads for a tile of T rows (keys), each
// owning a 4 x 4 score tile (its rows strided by T / 4, its keys by 16) and
// the output columns c + 16 i of its rows (keys).  Tiles live in shared
// memory as rows padded to D + 4 floats, so that the eight rows of a
// quarter warp's float4 reads fall in distinct 16-byte bank groups; dS
// (and in dkdv P, kept as [key][row]) is read four terms at a time as a
// broadcast float4.  __launch_bounds__(threads, 1) keeps ptxas from
// trading registers for stack (without it two instantiations spilled).

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

namespace cg = cooperative_groups;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxCluster = 8;  // portable thread block cluster size

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

// The key range [begin, end) that query rows [q0, q0 + nq) can see.
__device__ __forceinline__ void keys_seen(int q0, int nq, int Sk, int causal, int window,
                                          int& begin, int& end) {
  begin = 0;
  end = Sk;
  if (causal) {
    end = min(Sk, q0 + nq);
    if (window > 0) begin = max(0, q0 - window + 1);
  }
}

// The query range [begin, end) that can see some key of [k0, k0 + nk).
__device__ __forceinline__ void rows_seeing(int k0, int nk, int Sq, int causal, int window,
                                            int& begin, int& end) {
  begin = 0;
  end = Sq;
  if (causal) {
    begin = k0;
    if (window > 0) end = min(Sq, k0 + nk - 1 + window);
  }
}

// ---------------------------------------------------------------------
// prep: D = rowsum(dO o) over (rows, D) slabs, 64 rows a block
// ---------------------------------------------------------------------
constexpr int kPrepRows = 64;
constexpr int kPrepThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kPrepThreads)
flash_bwd_prep(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
               int rows) {
  constexpr int V = 16 / sizeof(T);  // elements of one 16-byte copy
  constexpr int CH = D / V;          // copies a row
  __shared__ float part[kPrepRows * CH];
  const int r0 = blockIdx.x * kPrepRows;
  for (int i = threadIdx.x; i < kPrepRows * CH; i += kPrepThreads) {
    const int r = i / CH, c = i - r * CH;
    float acc = 0.f;
    if (r0 + r < rows) {
      const size_t at = static_cast<size_t>(r0 + r) * D + c * V;
      const uint4 a = *reinterpret_cast<const uint4*>(o + at);
      const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
      const T* x = reinterpret_cast<const T*>(&a);
      const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int e = 0; e < V; ++e) acc += to_f32(y[e]) * to_f32(x[e]);
    }
    part[i] = acc;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kPrepRows; r += kPrepThreads) {
    if (r0 + r >= rows) continue;
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < CH; ++c) acc += part[r * CH + c];
    delta[r0 + r] = acc;
  }
}

// ---------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------
constexpr int kF32Walk = 64;  // dq: keys a step; dkdv: query rows a step
constexpr int kF32Sub = 4;    // rows and keys of a thread's score tile
constexpr int kF32Pad = 4;    // float padding of a shared row (16 bytes)

// Threads of a block that owns T query rows (dq) or keys (dkdv): 16
// column groups x T / 4 row groups, each thread a 4 x 4 score tile.
constexpr int f32_threads(int T) { return 4 * T; }

template <int D, int TQ>
constexpr size_t bwd_dq_f32_smem_bytes() {
  return ((2ull * TQ + 2 * kF32Walk) * (D + kF32Pad) + TQ * (kF32Walk + kF32Pad) + 2 * TQ) *
         sizeof(float);
}

template <int D, int TK>
constexpr size_t bwd_dkdv_f32_smem_bytes() {
  return ((2ull * TK + 2 * kF32Walk) * (D + kF32Pad) + 2 * TK * (kF32Walk + kF32Pad) +
          2 * kF32Walk) *
         sizeof(float);
}

// Start copying rows [r0, r0 + ROWS) of a (rows, D) float32 slab into
// shared memory rows of pitch D + 4 by cp.async, 16 bytes a copy, all in
// flight at once; rows at or past `n` are zero.  The caller commits and
// waits.
template <int ROWS, int D, int NTH>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src, int r0, int n,
                                          float* __restrict__ dst) {
  constexpr int C4 = D / 4, P = D + kF32Pad;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * C4; i += NTH) {
    const int r = i / C4, c = (i - r * C4) * 4;
    cp_async16(dst + r * P + c, src + static_cast<size_t>(min(r0 + r, n - 1)) * D + c,
               r0 + r < n);
  }
}

// lse and D of rows [r0, r0 + ROWS) of one (batch, head); 0 past `n`.
template <int ROWS, int NTH>
__device__ __forceinline__ void stage_row_floats(const float* __restrict__ lse,
                                                 const float* __restrict__ delta, int r0, int n,
                                                 float* __restrict__ lse_s,
                                                 float* __restrict__ delta_s) {
  for (int r = threadIdx.x; r < ROWS; r += NTH) {
    const bool in = r0 + r < n;
    lse_s[r] = in ? lse[r0 + r] : 0.f;
    delta_s[r] = in ? delta[r0 + r] : 0.f;
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at4(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// acc[a][c] += sum over the 4 elements of x[a] * y[c], in element order.
__device__ __forceinline__ void fma4(float (&acc)[kF32Sub][kF32Sub],
                                     const float4 (&x)[kF32Sub], const float4 (&y)[kF32Sub]) {
#pragma unroll
  for (int a = 0; a < kF32Sub; ++a) {
#pragma unroll
    for (int c = 0; c < kF32Sub; ++c) {
      acc[a][c] += x[a].x * y[c].x;
      acc[a][c] += x[a].y * y[c].y;
      acc[a][c] += x[a].z * y[c].z;
      acc[a][c] += x[a].w * y[c].w;
    }
  }
}

// The 4 x 4 score tiles S = A.B^T and dP = A'.B'^T of one thread over D:
// rows ra + R a of the [.][P] tiles a and a2, rows rb + 16 c of b and b2,
// read as float4 along D (the rows of a quarter warp's reads, pitch
// D + 4, fall in distinct 16-byte bank groups; a's rows are broadcast).
template <int D, int R>
__device__ __forceinline__ void score_tiles_f32(const float* a, const float* a2, const float* b,
                                                const float* b2, int ra, int rb,
                                                float (&s)[kF32Sub][kF32Sub],
                                                float (&dp)[kF32Sub][kF32Sub]) {
  constexpr int P = D + kF32Pad;
#pragma unroll
  for (int i = 0; i < kF32Sub; ++i) {
#pragma unroll
    for (int j = 0; j < kF32Sub; ++j) s[i][j] = dp[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[kF32Sub], y[kF32Sub];
#pragma unroll
    for (int i = 0; i < kF32Sub; ++i) {
      x[i] = lds4(a + (ra + R * i) * P + d);
      y[i] = lds4(b + (rb + 16 * i) * P + d);
    }
    fma4(s, x, y);
#pragma unroll
    for (int i = 0; i < kF32Sub; ++i) {
      x[i] = lds4(a2 + (ra + R * i) * P + d);
      y[i] = lds4(b2 + (rb + 16 * i) * P + d);
    }
    fma4(dp, x, y);
  }
}

// dQ of TQ query rows of one (batch, head), walking key tiles of 64, with
// 4 TQ threads.  Thread (tr, tc) owns score entries (rows tr + TQ / 4 a,
// keys tc + 16 b) and the output columns tc + 16 i of its rows.
template <int D, int TQ>
__global__ void __launch_bounds__(f32_threads(TQ), 1)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lse,
                 const float* __restrict__ dout, const float* __restrict__ delta,
                 float* __restrict__ dq, int H, int KV, int Sq, int Sk, float scale, int causal,
                 int window) {
  constexpr int NTH = f32_threads(TQ), TK = kF32Walk, R = TQ / kF32Sub, kCols = D / 16;
  constexpr int P = D + kF32Pad, PS = TK + kF32Pad;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [TQ][P]
  float* dos = qs + TQ * P;         // [TQ][P]
  float* ks = dos + TQ * P;         // [TK][P]
  float* vs = ks + TK * P;          // [TK][P]
  float* dss = vs + TK * P;         // [TQ][PS]
  float* lse_s = dss + TQ * PS;
  float* delta_s = lse_s + TQ;

  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int q0 = tile * TQ;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const size_t qoff = static_cast<size_t>(bh) * Sq * D;
  const size_t koff = static_cast<size_t>(b * KV + kvh) * Sk * D;

  stage_f32<TQ, D, NTH>(q + qoff, q0, Sq, qs);
  stage_f32<TQ, D, NTH>(dout + qoff, q0, Sq, dos);
  cp_async_commit();
  stage_row_floats<TQ, NTH>(lse + static_cast<size_t>(bh) * Sq,
                            delta + static_cast<size_t>(bh) * Sq, q0, Sq, lse_s, delta_s);
  int k_begin, k_end;
  keys_seen(q0, TQ, Sk, causal, window, k_begin, k_end);
  float acc[kF32Sub][kCols];
#pragma unroll
  for (int a = 0; a < kF32Sub; ++a) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[a][i] = 0.f;
  }
  for (int k0 = k_begin / TK * TK; k0 < k_end; k0 += TK) {
    __syncthreads();  // the previous tile is consumed
    stage_f32<TK, D, NTH>(k + koff, k0, Sk, ks);
    stage_f32<TK, D, NTH>(v + koff, k0, Sk, vs);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[kF32Sub][kF32Sub], dp[kF32Sub][kF32Sub];
    score_tiles_f32<D, R>(qs, dos, ks, vs, tr, tc, s, dp);
    // dS = P (dP - D), P = exp(S scale - lse) on the visible pairs
#pragma unroll
    for (int a = 0; a < kF32Sub; ++a) {
      const int r = tr + R * a;
#pragma unroll
      for (int c = 0; c < kF32Sub; ++c) {
        const int j = tc + 16 * c;
        const float p = bwd_visible(q0 + r, k0 + j, Sq, Sk, causal, window)
                            ? expf(s[a][c] * scale - lse_s[r])
                            : 0.f;
        dss[r * PS + j] = p * (dp[a][c] - delta_s[r]);
      }
    }
    __syncthreads();
    // dQ += dS k, four keys at a time (dS read as float4, broadcast)
#pragma unroll 1
    for (int j = 0; j < TK; j += 4) {
      float4 ds[kF32Sub];
#pragma unroll
      for (int a = 0; a < kF32Sub; ++a) ds[a] = lds4(dss + (tr + R * a) * PS + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kr[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) kr[i] = ks[(j + e) * P + tc + 16 * i];
#pragma unroll
        for (int a = 0; a < kF32Sub; ++a) {
          const float w = at4(ds[a], e);
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[a][i] += w * kr[i];
        }
      }
    }
  }
  cp_async_wait<0>();  // with no key tile, q and dO are still in flight
#pragma unroll
  for (int a = 0; a < kF32Sub; ++a) {
    const int qi = q0 + tr + R * a;
    if (qi >= Sq) continue;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      dq[qoff + static_cast<size_t>(qi) * D + tc + 16 * i] = acc[a][i] * scale;
    }
  }
}

// dK and dV of TK keys of one (batch, kv head), walking query tiles of 64
// rows of each of its G query heads in head order, with 4 TK threads.
// Thread (tr, tc) owns score entries (keys tr + TK / 4 a, rows tc + 16 b)
// and the output columns tc + 16 i of its keys.  P and dS are kept as
// [key][row], so that a thread reads four rows of its key as one float4.
template <int D, int TK>
__global__ void __launch_bounds__(f32_threads(TK), 1)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ lse,
                   const float* __restrict__ dout, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int H, int KV, int Sq, int Sk,
                   float scale, int causal, int window) {
  constexpr int NTH = f32_threads(TK), TQ = kF32Walk, R = TK / kF32Sub, kCols = D / 16;
  constexpr int P = D + kF32Pad, PS = TQ + kF32Pad;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [TK][P]
  float* vs = ks + TK * P;          // [TK][P]
  float* qs = vs + TK * P;          // [TQ][P]
  float* dos = qs + TQ * P;         // [TQ][P]
  float* ps = dos + TQ * P;         // [TK][PS]
  float* dss = ps + TK * PS;        // [TK][PS]
  float* lse_s = dss + TK * PS;
  float* delta_s = lse_s + TQ;

  const int bk = blockIdx.x, b = bk / KV, kvh = bk % KV, G = H / KV;
  const int k0 = blockIdx.y * TK;  // causal: the first keys have the most rows
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const size_t koff = static_cast<size_t>(bk) * Sk * D;

  stage_f32<TK, D, NTH>(k + koff, k0, Sk, ks);
  stage_f32<TK, D, NTH>(v + koff, k0, Sk, vs);
  cp_async_commit();
  int q_begin, q_end;
  rows_seeing(k0, TK, Sq, causal, window, q_begin, q_end);
  float adk[kF32Sub][kCols], adv[kF32Sub][kCols];
#pragma unroll
  for (int a = 0; a < kF32Sub; ++a) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) adk[a][i] = adv[a][i] = 0.f;
  }
  for (int g = 0; g < G; ++g) {
    const size_t bh = static_cast<size_t>(b) * H + kvh * G + g;
    const size_t qoff = bh * Sq * D;
    for (int q0 = q_begin / TQ * TQ; q0 < q_end; q0 += TQ) {
      __syncthreads();  // the previous tile is consumed
      stage_f32<TQ, D, NTH>(q + qoff, q0, Sq, qs);
      stage_f32<TQ, D, NTH>(dout + qoff, q0, Sq, dos);
      cp_async_commit();
      stage_row_floats<TQ, NTH>(lse + bh * Sq, delta + bh * Sq, q0, Sq, lse_s, delta_s);
      cp_async_wait<0>();
      __syncthreads();
      float s[kF32Sub][kF32Sub], dp[kF32Sub][kF32Sub];
      score_tiles_f32<D, R>(ks, vs, qs, dos, tr, tc, s, dp);
      // P and dS = P (dP - D) on the visible pairs, as [key][row]
#pragma unroll
      for (int a = 0; a < kF32Sub; ++a) {
        const int j = tr + R * a;
#pragma unroll
        for (int c = 0; c < kF32Sub; ++c) {
          const int r = tc + 16 * c;
          const float p = bwd_visible(q0 + r, k0 + j, Sq, Sk, causal, window)
                              ? expf(s[a][c] * scale - lse_s[r])
                              : 0.f;
          ps[j * PS + r] = p;
          dss[j * PS + r] = p * (dp[a][c] - delta_s[r]);
        }
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T q, four rows at a time
#pragma unroll 1
      for (int r = 0; r < TQ; r += 4) {
        float4 pv[kF32Sub], dv4[kF32Sub];
#pragma unroll
        for (int a = 0; a < kF32Sub; ++a) {
          pv[a] = lds4(ps + (tr + R * a) * PS + r);
          dv4[a] = lds4(dss + (tr + R * a) * PS + r);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dor[kCols], qr[kCols];
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            dor[i] = dos[(r + e) * P + tc + 16 * i];
            qr[i] = qs[(r + e) * P + tc + 16 * i];
          }
#pragma unroll
          for (int a = 0; a < kF32Sub; ++a) {
            const float p = at4(pv[a], e), ds = at4(dv4[a], e);
#pragma unroll
            for (int i = 0; i < kCols; ++i) {
              adv[a][i] += p * dor[i];
              adk[a][i] += ds * qr[i];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // with no query tile, k and v are still in flight
#pragma unroll
  for (int a = 0; a < kF32Sub; ++a) {
    const int kj = k0 + tr + R * a;
    if (kj >= Sk) continue;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const size_t at = koff + static_cast<size_t>(kj) * D + tc + 16 * i;
      dk[at] = adk[a][i] * scale;
      dv[at] = adv[a][i];
    }
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, float32 accumulators, the
// fragments of common.cuh): every product of the backward is an A.B of
// bf16 tiles in shared memory or registers, P and dS rounded to bf16
// where they enter a product.
// ---------------------------------------------------------------------
constexpr int kMmaBwdThreads = 128;  // four warps
constexpr int kMmaBwdTile = 64;      // dq: query rows a block, keys a step;
                                     // dkdv: keys a block (16 a warp)
constexpr int kMmaBwdPad = 8;        // bf16 padding of a shared row (16 bytes)
constexpr int kPartPad = 4;          // float padding of a partial's row
// Head dims with a dkdv step of 64 query rows (ptxas, sm_90a: at 128 it
// needs more than 255 registers a thread and spills, at 32 it leaves a
// stack frame, and no training shape has 16); elsewhere the step is 32.
template <int D>
constexpr bool kMmaRows64 = D >= 64 && D <= 96;

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
  return (6ull * kMmaBwdTile) * (D + kMmaBwdPad) * sizeof(bf16);
}

template <int D, int QT>
constexpr size_t bwd_dkdv_mma_smem_bytes() {
  constexpr size_t ring = (2ull * kMmaBwdTile + 4 * QT) * (D + kMmaBwdPad) * sizeof(bf16) +
                          4 * QT * sizeof(float);
  constexpr size_t parts = 2ull * kMmaBwdTile * (D + kPartPad) * sizeof(float);
  return ring > parts ? ring : parts;
}

// dQ of 64 query rows of one (batch, head): four warps of 16 rows, q in
// registers, dO from shared memory, K and V tiles of 64 keys double
// buffered by cp.async.
template <int D>
__global__ void __launch_bounds__(kMmaBwdThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ lse,
                 const bf16* __restrict__ dout, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int H, int KV, int Sq, int Sk, float scale, int causal,
                 int window) {
  constexpr int P = D + kMmaBwdPad, KSTEPS = D / 16, NT = D / 8, CH = D / 8;
  constexpr int T = kMmaBwdTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][P]
  bf16* dos = qs + T * P;                        // [64][P]
  bf16* ks = dos + T * P;                        // [2][64][P]
  bf16* vs = ks + 2 * T * P;                     // [2][64][P]

  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int q0 = tile * T;
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

  int k_begin, k_end;
  keys_seen(q0, T, Sk, causal, window, k_begin, k_end);
  const int t_begin = k_begin / T;
  const int ntiles = max(0, (k_end + T - 1) / T - t_begin);
  auto load_kv = [&](int tile_k, int st) {
    const int k0 = tile_k * T;
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
  // this thread's two rows' lse (log2 units) and D, straight from memory
  float lse_r[2], del_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = e ? row1 : row0;
    const size_t at = static_cast<size_t>(bh) * Sq + min(row, Sq - 1);
    lse_r[e] = row < Sq ? lse[at] * kLog2e : 0.f;
    del_r[e] = row < Sq ? delta[at] : 0.f;
  }
  if (ntiles > 0) {
    load_kv(t_begin, 0);
    cp_async_wait<1>();  // q and dO have landed
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) lds_a(qf[kk], qs, P, warp * 16, kk * 16, lane);
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, k0 = (t_begin + it) * T;
    if (it + 1 < ntiles) {
      load_kv(t_begin + it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
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

// dK and dV of 64 keys of one (batch, kv head) over `heads` of its query
// heads: four warps of 16 keys, k and v resident in shared memory, the
// query tiles (QT rows of q and dO, their lse and D) double buffered by
// cp.async.  With cluster > 1 the block is rank blockIdx.x % cluster of the
// cluster that shares its key tile and kv head; rank r takes query heads
// r heads .. (r + 1) heads - 1, and the cluster sums its partials in rank
// order before one rank a share of the rows writes them.
template <int D, int QT>
__global__ void __launch_bounds__(kMmaBwdThreads)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ lse,
                   const bf16* __restrict__ dout, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV, int Sq, int Sk,
                   float scale, int causal, int window, int heads, int cluster) {
  constexpr int P = D + kMmaBwdPad, KSTEPS = D / 16, NT = D / 8, CH = D / 8;
  constexpr int T = kMmaBwdTile, NQ = QT / 8, KQ = QT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][P]
  bf16* vs = ks + T * P;                         // [64][P]
  bf16* qs = vs + T * P;                         // [2][QT][P]
  bf16* dos = qs + 2 * QT * P;                   // [2][QT][P]
  float* rowf = reinterpret_cast<float*>(dos + 2 * QT * P);  // [2][lse QT, D QT]

  const int G = H / KV, bk = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const int b = bk / KV, kvh = bk % KV;
  const int k0 = blockIdx.y * T;  // causal: the first keys have the most rows
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

  // the query rows that can see some key of this block, in tiles of QT
  int q_begin, q_end;
  rows_seeing(k0, T, Sq, causal, window, q_begin, q_end);
  const int t_begin = q_begin / QT;
  const int per_head = max(0, (q_end + QT - 1) / QT - t_begin);
  const int total = heads * per_head;
  const int g0 = rank * heads;
  auto load_q = [&](int idx, int st) {
    const int g = g0 + idx / per_head, q0 = (t_begin + idx % per_head) * QT;
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

    // S^T = k q^T and dP^T = v dO^T: 16 keys x QT rows a warp
    float sT[NQ][4], dpT[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      lds_a(ka, ks, P, warp * 16, kk * 16, lane);
      lds_a(va, vs, P, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < KQ; ++np) {
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
    for (int j = 0; j < NQ; ++j) {
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
    // dV += P^T dO and dK += dS^T q: the tile's rows are the k-steps
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, sT[2 * kk], sT[2 * kk + 1]);
      acc_to_a(sa, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t ob[4], qb[4];
        lds_b_kn(ob, dt, P, kk * 16, dp2 * 16, lane);
        mma_bf16(adv[2 * dp2], pa, ob[0], ob[1]);
        mma_bf16(adv[2 * dp2 + 1], pa, ob[2], ob[3]);
        lds_b_kn(qb, qt, P, kk * 16, dp2 * 16, lane);
        mma_bf16(adk[2 * dp2], sa, qb[0], qb[1]);
        mma_bf16(adk[2 * dp2 + 1], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  if (total == 0) cp_async_wait<0>();

  if (cluster == 1) {
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
    return;
  }

  // The cluster's sum.  Each block's float32 partials go over its ring
  // ([64][D + 4] of dK, then of dV); rank r then sums rows
  // [64 r / cluster, 64 (r + 1) / cluster) of both over ranks 0.. in rank
  // order, reading its peers' shared memory, and writes them.
  constexpr int PD = D + kPartPad;
  float* pk = reinterpret_cast<float*>(smem_raw);
  float* pv = pk + T * PD;
  __syncthreads();  // every warp is done with the ring (total == 0 included)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + gr + 8 * half;
      *reinterpret_cast<float2*>(pk + r * PD + col) =
          make_float2(adk[j][2 * half], adk[j][2 * half + 1]);
      *reinterpret_cast<float2*>(pv + r * PD + col) =
          make_float2(adv[j][2 * half], adv[j][2 * half + 1]);
    }
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every rank's partials are in place
  const int r_begin = T * rank / cluster, r_end = T * (rank + 1) / cluster;
  constexpr int C4 = D / 4;
  for (int i = tid; i < (r_end - r_begin) * C4; i += kMmaBwdThreads) {
    const int r = r_begin + i / C4, c = (i % C4) * 4;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int s = 0; s < cluster; ++s) {
      const float4 xk = *reinterpret_cast<const float4*>(cl.map_shared_rank(pk, s) + r * PD + c);
      const float4 xv = *reinterpret_cast<const float4*>(cl.map_shared_rank(pv, s) + r * PD + c);
      sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
      sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
    }
    const int kj = k0 + r;
    if (kj >= Sk) continue;
    const size_t at = koff + static_cast<size_t>(kj) * D + c;
    *reinterpret_cast<uint2*>(dk + at) =
        make_uint2(pack_bf16(sk.x * scale, sk.y * scale), pack_bf16(sk.z * scale, sk.w * scale));
    *reinterpret_cast<uint2*>(dv + at) =
        make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  }
  cl.sync();  // no block leaves while a peer still reads its partials
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const float* lse;
  const void* dout;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, KV, Sq, Sk;
  float scale;
  int causal, window;
  int dq_rows, kv_keys, kv_rows, heads, cluster, parts;
  cudaStream_t s;
};

constexpr int kPartPrep = 1, kPartDq = 2, kPartDkdv = 4;

template <typename T, int D>
int launch_prep(const BwdArgs& a) {
  const int rows = a.B * a.H * a.Sq;
  flash_bwd_prep<T, D><<<(rows + kPrepRows - 1) / kPrepRows, kPrepThreads, 0, a.s>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, rows);
  return launch_status();
}

template <int D, int QT>
int launch_dkdv_mma(const BwdArgs& a) {
  constexpr size_t smem = bwd_dkdv_mma_smem_bytes<D, QT>();
  auto kernel = flash_bwd_dkdv_mma<D, QT>;
  int st = allow_smem(kernel, smem);
  if (st) return st;
  const dim3 grid(a.B * a.KV * a.cluster, (a.Sk + kMmaBwdTile - 1) / kMmaBwdTile);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
  if (a.cluster == 1) {
    kernel<<<grid, kMmaBwdThreads, smem, a.s>>>(q, k, v, a.lse, dout, a.delta, dk, dv, a.H,
                                                a.KV, a.Sq, a.Sk, a.scale, a.causal, a.window,
                                                a.heads, 1);
    return launch_status();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kMmaBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  st = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, q, k, v, a.lse, dout,
                                           static_cast<const float*>(a.delta), dk, dv, a.H,
                                           a.KV, a.Sq, a.Sk, a.scale, a.causal, a.window,
                                           a.heads, a.cluster));
  return st ? st : launch_status();
}

template <int D>
int launch_flash_bwd_mma(const BwdArgs& a) {
  const int G = a.H / a.KV;
  const bool rows_ok = a.kv_rows == 32 || (a.kv_rows == 64 && kMmaRows64<D>);
  if (a.dq_rows != kMmaBwdTile || a.kv_keys != kMmaBwdTile || !rows_ok || a.cluster < 1 ||
      a.cluster > kMaxCluster || a.heads * a.cluster != G) {
    return kStatusBadArgs;
  }
  int st = 0;
  if (a.parts & kPartPrep) {
    st = launch_prep<bf16, D>(a);
    if (st) return st;
  }
  if (a.parts & kPartDq) {
    constexpr size_t smem = bwd_dq_mma_smem_bytes<D>();
    st = allow_smem(flash_bwd_dq_mma<D>, smem);
    if (st) return st;
    const dim3 grid(a.B * a.H, (a.Sq + kMmaBwdTile - 1) / kMmaBwdTile);
    flash_bwd_dq_mma<D><<<grid, kMmaBwdThreads, smem, a.s>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), a.lse, static_cast<const bf16*>(a.dout), a.delta,
        static_cast<bf16*>(a.dq), a.H, a.KV, a.Sq, a.Sk, a.scale, a.causal, a.window);
    st = launch_status();
    if (st) return st;
  }
  if (a.parts & kPartDkdv) {
    if constexpr (kMmaRows64<D>) {
      if (a.kv_rows == 64) return launch_dkdv_mma<D, 64>(a);
    }
    return launch_dkdv_mma<D, 32>(a);
  }
  return 0;
}

template <int D, int TQ>
int launch_dq_f32(const BwdArgs& a) {
  constexpr size_t smem = bwd_dq_f32_smem_bytes<D, TQ>();
  int st = allow_smem(flash_bwd_dq_f32<D, TQ>, smem);
  if (st) return st;
  const dim3 grid(a.B * a.H, (a.Sq + TQ - 1) / TQ);
  flash_bwd_dq_f32<D, TQ><<<grid, f32_threads(TQ), smem, a.s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.lse, static_cast<const float*>(a.dout), a.delta,
      static_cast<float*>(a.dq), a.H, a.KV, a.Sq, a.Sk, a.scale, a.causal, a.window);
  return launch_status();
}

template <int D, int TK>
int launch_dkdv_f32(const BwdArgs& a) {
  constexpr size_t smem = bwd_dkdv_f32_smem_bytes<D, TK>();
  int st = allow_smem(flash_bwd_dkdv_f32<D, TK>, smem);
  if (st) return st;
  const dim3 grid(a.B * a.KV, (a.Sk + TK - 1) / TK);
  flash_bwd_dkdv_f32<D, TK><<<grid, f32_threads(TK), smem, a.s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.lse, static_cast<const float*>(a.dout), a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.KV, a.Sq, a.Sk, a.scale,
      a.causal, a.window);
  return launch_status();
}

template <int D>
int launch_flash_bwd_f32(const BwdArgs& a) {
  auto tile_ok = [](int t) { return t == 16 || t == 32 || t == 64; };
  if (!tile_ok(a.dq_rows) || !tile_ok(a.kv_keys) || a.kv_rows != kF32Walk || a.cluster != 1 ||
      a.heads != a.H / a.KV) {
    return kStatusBadArgs;
  }
  int st = 0;
  if (a.parts & kPartPrep) {
    st = launch_prep<float, D>(a);
    if (st) return st;
  }
  if (a.parts & kPartDq) {
    st = a.dq_rows == 16   ? launch_dq_f32<D, 16>(a)
         : a.dq_rows == 32 ? launch_dq_f32<D, 32>(a)
                           : launch_dq_f32<D, 64>(a);
    if (st) return st;
  }
  if (a.parts & kPartDkdv) {
    st = a.kv_keys == 16   ? launch_dkdv_f32<D, 16>(a)
         : a.kv_keys == 32 ? launch_dkdv_f32<D, 32>(a)
                           : launch_dkdv_f32<D, 64>(a);
  }
  return st;
}

template <typename T, int D>
int launch_flash_bwd(const BwdArgs& a) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_flash_bwd_mma<D>(a);
  } else {
    return launch_flash_bwd_f32<D>(a);
  }
}

// Launch the instantiation for head dimension D; an unlisted D launches
// nothing and returns kStatusBadHeadDim.
template <typename T>
int dispatch_flash_bwd(int D, const BwdArgs& a) {
  switch (D) {
    case 16: return launch_flash_bwd<T, 16>(a);
    case 32: return launch_flash_bwd<T, 32>(a);
    case 64: return launch_flash_bwd<T, 64>(a);
    case 80: return launch_flash_bwd<T, 80>(a);
    case 96: return launch_flash_bwd<T, 96>(a);
    case 128: return launch_flash_bwd<T, 128>(a);
    default: return kStatusBadHeadDim;
  }
}

}  // namespace repro

// parts: 1 prep, 2 dq, 4 dkdv (7 for the whole backward; dq and dkdv read
// the D that prep writes into `delta`).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* delta, void* dq, void* dk, void* dv, int B,
                                         int H, int KV, int Sq, int Sk, int D, float scale,
                                         int causal, int window, int dtype, int dq_rows,
                                         int kv_keys, int kv_rows, int heads, int cluster,
                                         int parts, void* stream) {
  using namespace repro;
  if (KV <= 0 || H % KV != 0) return kStatusBadArgs;
  const BwdArgs a{q,  k,  v,  o,  static_cast<const float*>(lse), dout, static_cast<float*>(delta),
                  dq, dk, dv, B,  H, KV, Sq, Sk, scale, causal, window, dq_rows, kv_keys,
                  kv_rows, heads, cluster, parts, static_cast<cudaStream_t>(stream)};
  if (dtype == kDtypeBF16) return dispatch_flash_bwd<__nv_bfloat16>(D, a);
  return dispatch_flash_bwd<float>(D, a);
}
