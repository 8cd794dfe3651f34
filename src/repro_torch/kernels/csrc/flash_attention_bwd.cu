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
//   1 / cluster share of the keys over ranks 0.. in rank order through
//   distributed shared memory and writes them.  In float32 a block sums
//   all G heads of its kv head itself, in head order.
//
// S and dP are recomputed in both kernels (seven products, not five): the
// five-product form sums dQ across the dkdv blocks, which takes atomics
// (not deterministic) or ordered semaphores, left to a later design.
//
// The masks are the forward's (causal, and a window that keeps keys
// qpos - window < kpos <= qpos); rows and keys past the ends of ragged
// tails are masked in the kernel; scale = D**-0.5; sums are float32.
//
// What bounds it.  At the Yi-9B training shape, bf16 (2, 32, 2048, 128), 4
// kv heads, causal, five products over 2,098,176 causal pairs are
// 10 x pairs x 128 x 32 x 2 = 172 GFLOP, 0.174 ms at the bf16 tensor cores'
// 989 TFLOP/s, against ~151 MB of q, o, dO, dQ, k, v, dK and dV, 0.045 ms
// at 3.35 TB/s: operations, so bf16 runs on the tensor cores.  dkdv does
// four of the seven products (S^T, dP^T, dV, dK: 137.5 GFLOP at Yi-9B,
// 0.139 ms at that rate), dq three (S, dP, dQ: 103.1 GFLOP, 0.104 ms; at
// Zamba2's (1, 32, 2048, 80) 0.0326 ms), prep reads o and dO (0.0202 ms of
// bytes at Yi-9B).  On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6)
// dq reads 0.231-0.234 ms at Yi-9B, 0.45 of the tensor cores'
// rate (the mma.sync dq read 0.40), dkdv 0.43-0.44 (0.32), the whole
// backward 0.69-0.70 ms against SDPA's 0.50; at Zamba2 dq 0.108 (0.30).  At D = 64 a step's latency bounds dq more than its products:
// Whisper's non-causal encoder (2, 8, 1500, 64) reads 0.19 of the rate,
// its 24-step blocks in 1.45 waves at one or two an SM.
//
// bf16 dkdv (flash_bwd_dkdv_wgmma, on Hopper's units, sm90.cuh):
//  - warp specialisation, as the bf16 forward: warpgroup 0 is the
//    producer, brought down to 24 registers (setmaxnreg); its thread 0
//    issues every copy by TMA (K and V of the block's key tile once, then
//    q and dO of each query step into a ring of 2-4 stages with "full" and
//    "empty" mbarriers), its warp 1 stores each step's lse and D rows
//    beside them; one or two consumer warpgroups own 64 keys each (a
//    64- or 128-key tile) and take the registers it gave up;
//  - a step of QR (32 or 64) query rows in a consumer: S^T = K q^T and
//    dP^T = V dO^T on wgmma m64n{QR}k16, both operands K-major from their
//    swizzled tiles, issued together; P^T = 2^(S^T scale log2 e -
//    lse log2 e) while dP^T runs, rounded to bf16 into the A fragment of
//    dV += P^T dO (the S^T accumulator's layout is that fragment, as the
//    forward's P); dS^T = P^T (dP^T - D) while dV runs, then dK += dS^T q,
//    both on wgmma m64n{D}k16 with A from registers and dO, q read
//    MN-major; the stage goes back to the producer once both are done.
//    The 64-row step at D = 128 computes P^T and dS^T after both scores,
//    which needs fewer registers (kTogether), and is built with two
//    consumers only: with one, its 232 registers a thread spill;
//  - dK and dV stay in registers across the walk (D / 2 floats each a
//    thread); with G > 1 the cluster's sum goes through the freed ring.
// The old design (mma.sync m16n8k16 fed by ldmatrix, four warps of 16
// keys, two-stage cp.async) held 128 float32 accumulators a thread at D =
// 128 (241 registers, two blocks an SM) and issued 80 ldmatrix.x4 for 128
// mma a warp step: its 64-row step needed more than 255 registers there.
// wgmma reads B straight from shared memory and spreads each 64-key
// accumulator over a warpgroup.
//
// What held the previous designs back, and what this one does about it:
// 1. dK/dV of GQA ran one block per kv head, its G heads in series (256
//    blocks at Yi-9B, 40 at LLaVA's (1, 56, 320, 128) kv 8).  Here one
//    block per (key tile, query head) and a cluster sum: G times the
//    blocks, no device-memory traffic for the sum.
// 2. Heavy and light tiles were dispatched mixed.  Here the tile is the
//    slow grid axis, heaviest first: key tile 0 first in dkdv, the last
//    query tile first in dq (causal), so every head's heaviest tile starts
//    before any head's next one and the tail is one light block long.
// 3. D was computed inside dq, a warp a row with 2-byte loads, so dkdv had
//    to wait for dq.  Here the prep pass.
// 4. float32 ran 64 x 64 tiles, 64 blocks at train-100m's (4, 8, 128, 64)
//    on 132 SMs, staging 4 bytes at a time and reading shared memory a
//    word per two FMAs.  Here the plan picks 16-, 32- or 64-row (key)
//    tiles so that a grid comes near two blocks an SM, tiles arrive by
//    cp.async 16 bytes a copy, all in flight at once, and every thread
//    owns a 4 x 4 score tile read as float4 along D (4 FMAs a loaded
//    word); exact float32 FMAs on the CUDA cores stay (TF32 would miss
//    the 2e-5 float32 tolerance).
//
// bf16 dq (flash_bwd_dq_wgmma, on the same units; a forward pass in shape:
// S = q K^T as the forward's scores, dP = dO V^T the same form with V in
// K's place, dQ += dS K the forward's P.V with K in V's place):
//  - warpgroup 0 is the producer, down to 24 registers; its thread 0
//    issues every copy by TMA: q and dO of the block's 64 NC query rows
//    once, then K and V of each 64-key step into a ring of 2-4 stages
//    (as many as the block's share of the SM holds) with "full" and
//    "empty" mbarriers; one or two consumer warpgroups own 64 query rows
//    each (one block an SM with two, two with one, three at D <= 64);
//  - a consumer's step: S and dP on wgmma m64n64k16, both operands
//    K-major from their swizzled tiles, issued together; P = 2^(S scale
//    log2 e - lse log2 e) while dP runs (each thread's two rows' lse and D
//    read once before the walk); dS = P (dP - D) rounded to bf16 into the
//    A fragment (the S accumulator's layout, as the forward's P) of
//    dQ += dS K on m64n{D}k16, K read MN-major.  Where the ring holds
//    three stages, step i's scores are issued with step i - 1's dQ
//    product, so that the exponentials and dS overlap it (the forward's
//    order); at D = 128 with one consumer (two stages) and at three
//    blocks an SM each step waits for its own product.  A thread holds
//    dQ (D / 2 floats), S and dP (32 each) and dS's fragment (16
//    registers): 144 at D = 128, inside the 232-240 setmaxnreg gives a
//    consumer of one or two blocks an SM; in the serial order dS's
//    fragment follows S and dP, 96 at D = 64, inside the 136 of three;
//  - a warpgroup hands back unread the steps none of its rows see (the
//    diagonal's far side, the window's near side, rows past Sq);
//  - dQ is written once, scaled, by the warpgroup that owns its rows.
// The old dq (mma.sync m16n8k16 fed by ldmatrix, four warps of 16 rows
// that all copied K and V by cp.async into two stages, then multiplied,
// then computed P and dS between two __syncthreads a step) read 0.39-0.40
// ms at Yi-9B, 0.26 of the tensor cores' rate: every warp waited for the
// copies and for the slowest warp each step, and its products and
// exponentials never overlapped.  P and dS are rounded to bf16 where they
// enter a product, in dq and dkdv alike, as the forward rounds P.
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

#include "sm90.cuh"

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
// bf16 on Hopper's units (wgmma, TMA, a producer warpgroup): every
// product of the backward is an A.B of bf16 tiles in shared memory or
// registers, P and dS rounded to bf16 where they enter a product.
// ---------------------------------------------------------------------
constexpr int kPartPad = 4;  // float padding of a partial's row

// The tiles of flash_bwd_dq_wgmma<D, NC>: NC consumer warpgroups of 64
// query rows each (a block of 64 NC rows) behind one producer warpgroup,
// walking 64 keys a step.  A tile is stored as BwdTiles' below: D / kAtom
// column blocks of rows x kAtom bf16, swizzled.  Shared memory, from a
// 1024-byte boundary: q and dO of the block's rows, once; a ring of
// kStages steps (as many as fit, up to 4), each K and V of 64 keys (TMA);
// the mbarriers past both.  One block an SM with two consumers (kBudget:
// all 227 KB), two with one, three with one at D <= 64, where its serial
// order fits the 136 registers a consumer then gets (kBlocks; the
// launch's registers a thread, 168, 128 or 80, are moved from the
// producer by setmaxnreg).
template <int D, int NC>
struct DqTiles {
  static constexpr int kAtom = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kSpan = 2 * kAtom;  // bytes of a swizzled row
  static constexpr int kColBlocks = D / kAtom;
  static constexpr int kRows = 64 * NC;
  static constexpr int kKeys = 64;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kQBytes = 2 * kRows * D * 2;     // q and dO
  static constexpr int kStepBytes = 2 * kKeys * D * 2;  // K and V of a step
  static constexpr int kBlocks = NC == 2 ? 1 : D <= 64 ? 3 : 2;
  static constexpr int kBudget = 233472 / kBlocks - 1024;
  static constexpr int kBarBytes = 128;
  static constexpr int kFit = (kBudget - 1024 - kBarBytes - kQBytes) / kStepBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStepBytes + kBarBytes;
  // registers a thread: the launch's, then after setmaxnreg the producer's
  // and the consumers' (multiples of 8)
  static constexpr int kLaunchRegs = 65536 / (kThreads * kBlocks) / 8 * 8;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads - kProducerRegs * 128) / (128 * NC) / 8 * 8;
  static_assert(kStages >= 2 && kSmem <= kBudget, "the K/V ring does not fit");
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * NC <= kLaunchRegs * kThreads,
                "the warpgroups' registers exceed the launch's");
};

// A dq consumer's order of a step.  Where the ring holds three stages or
// more, step i's scores are issued together with step i - 1's dQ product
// (the forward's order: S_i and P_{i-1} V), so that the exponentials and
// dS overlap that product; a consumer then holds two stages at a time
// and 16 more registers (dS's fragment beside the next S and dP).  With
// two stages (D = 128, one consumer) or three blocks an SM (their
// consumers' 136 registers) each step waits for its own dQ product: the
// producer fills another stage, and the other blocks use the tensor
// cores, meanwhile.

// dQ of 64 NC query rows of one (batch, head), 64 keys a step.
//  - producer (warpgroup 0, down to kProducerRegs): thread 0 issues every
//    TMA copy: q and dO of the block's rows once, then K and V of each
//    step into the ring once its "empty" barrier says the consumers have
//    read the stage; keys past Sk and rows past Sq read as zeros.  Every
//    consumer waits for q and dO, also in a block with no step (a causal
//    window's rows past the last key tile), so that no copy into the
//    block's shared memory is in flight when it exits;
//  - consumer warpgroup w (rows 64 w.. of the block, 16 a warp), a step:
//    S = q K^T and dP = dO V^T on wgmma m64n64k16, both operands K-major
//    from their tiles, issued together; P = 2^(S scale log2 e - lse
//    log2 e) (0 where hidden) while dP runs; dS = P (dP - D), rounded to
//    bf16 into the A fragment (the S accumulator's layout) of dQ += dS K
//    on m64n{D}k16, K read MN-major (its rows are the k); the stage goes
//    back to the producer once that product is done.  The steps of the
//    block's walk that no row of this warpgroup sees (its rows past Sq,
//    the diagonal's far side, the window's near side) are handed back
//    unread, each after its "full" barrier, so that no warpgroup's
//    arrivals run a round ahead of the other's;
//  - dQ stays in registers (D / 2 floats a thread) and is written once,
//    scaled, by the warpgroup that owns its rows: no atomic.
template <int D, int NC>
__global__ void __launch_bounds__(DqTiles<D, NC>::kThreads, DqTiles<D, NC>::kBlocks)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq, int H, int KV,
                   int Sq, int Sk, float scale, float scale_log2, int causal, int window) {
  using T = DqTiles<D, NC>;
  using namespace sm90;
  constexpr int A = T::kAtom, R = T::kRows, KT = T::kKeys, SP = T::kSpan, NS = T::kStages;
  constexpr bool kDefer = NS >= 3 && T::kBlocks < 3;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(base);  // [col block][R][A]
  bf16* dos = qs + R * D;                     // [col block][R][A]
  bf16* ring = dos + R * D;                   // [stage][K, V][col block][KT][A]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + T::kQBytes + NS * T::kStepBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int q0 = tile * R;
  int k_begin, k_end;
  keys_seen(q0, R, Sk, causal, window, k_begin, k_end);
  const int t_begin = k_begin / KT;
  const int ntiles = max(0, (k_end + KT - 1) / KT - t_begin);
  // warp-uniform as the compiler sees it (its warps' shuffles)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NC);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_do);
      mbar_arrive_expect_tx(qbar, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kColBlocks; ++c) {
        tma_load_3d(qs + c * R * A, &tm_q, qbar, c * A, q0, bh);
        tma_load_3d(dos + c * R * A, &tm_do, qbar, c * A, q0, bh);
      }
      const int slab = b * KV + h / (H / KV);
      for (int it = 0, s = 0, ph = 0; it < ntiles; ++it) {
        mbar_wait(empty + s, ph ^ 1);
        mbar_arrive_expect_tx(full + s, T::kStepBytes);
        bf16* kd = ring + s * 2 * KT * D;
        bf16* vd = kd + KT * D;
        const int k0 = (t_begin + it) * KT;
#pragma unroll
        for (int c = 0; c < T::kColBlocks; ++c) {
          tma_load_3d(kd + c * KT * A, &tm_k, full + s, c * A, k0, slab);
          tma_load_3d(vd + c * KT * A, &tm_v, full + s, c * A, k0, slab);
        }
        if (++s == NS) s = 0, ph ^= 1;
      }
    }
    return;
  }

  regs_inc<T::kConsumerRegs>();
  const int wgi = wg - 1, t = threadIdx.x - 128 * wg;
  const int warp = t / 32, lane = t % 32;
  const int gr = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int wq0 = q0 + 64 * wgi;            // this warpgroup's rows
  const int row0 = wq0 + warp * 16 + gr, row1 = row0 + 8;  // this thread's
  // this thread's two rows' lse (log2 units) and D, straight from memory
  float lse_r[2], del_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = e ? row1 : row0;
    const size_t at = static_cast<size_t>(bh) * Sq + min(row, Sq - 1);
    lse_r[e] = row < Sq ? lse[at] * kLog2e : 0.f;
    del_r[e] = row < Sq ? delta[at] : 0.f;
  }
  // the steps [w_begin, w_end) of the block's walk this warpgroup's rows see
  int w_begin = 0, w_end = 0;
  if (wq0 < Sq) {
    int kb, ke;
    keys_seen(wq0, min(64, Sq - wq0), Sk, causal, window, kb, ke);
    w_begin = min(ntiles, max(0, kb / KT - t_begin));
    w_end = max(w_begin, min(ntiles, (ke + KT - 1) / KT - t_begin));
  }
  // q's and dO's descriptors; each step adds a k-step's offset to its own
  // copy, so that ptxas does not hold the 2 D / 16 loop-invariant
  // descriptors (64 bits each) in registers across the walk
  const uint64_t qdesc = smem_desc(qs + 64 * wgi * A, 16, 8 * SP, SP);
  const uint64_t odesc = smem_desc(dos + 64 * wgi * A, 16, 8 * SP, SP);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[KT / 2], dp[KT / 2];  // S then P; dP then dS
  uint32_t da[KT / 16][4];       // dS: the A operand of KT / 16 key steps

  // S = q K^T, then dP = dO V^T: D / 16 steps each, issued as two groups
  // (descriptor offsets in 16-byte units)
  auto issue_scores = [&](const bf16* kt) {
    uint64_t qd = qdesc, od = odesc;
    asm volatile("" : "+l"(qd), "+l"(od));
    const uint64_t kd = smem_desc(kt, 16, 8 * SP, SP), vd = smem_desc(kt + KT * D, 16, 8 * SP, SP);
    // The first k-step overwrites S and dP: the previous step's values end
    // at their last use (the products' "+f" operands would keep them alive).
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) asm volatile("" : "=f"(sc[i]), "=f"(dp[i]));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / A, off = kk * 16 % A;
      Wgmma<KT>::template ss<0, 0>(sc, qd + (c * R * A + off) / 8, kd + (c * KT * A + off) / 8,
                                   kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / A, off = kk * 16 % A;
      Wgmma<KT>::template ss<0, 0>(dp, od + (c * R * A + off) / 8, vd + (c * KT * A + off) / 8,
                                   kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS K on the stage's K: KT / 16 steps, A from registers, K read
  // MN-major (its rows are the k); issued as one group
  auto issue_dq = [&](const bf16* kt) {
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) fence_regs(da[kk]);
    const uint64_t kmn = smem_desc(kt, KT * SP, 8 * SP, SP);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) Wgmma<D>::template rs<1>(acc, da[kk], kmn + 2 * kk * A, 1);
    wgmma_commit();
  };
  // P where visible (only steps that cross the diagonal, an end or the
  // window's edge check each pair; keys past Sk read as zero rows, whose
  // P must be 0, not 2^-lse)
  auto p_of = [&](int k0) {
    const bool need_mask = !tile_visible(wq0, 64, k0, KT, Sq, Sk, causal, window);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + 8 * j + 2 * t4 + (e & 1);
        const bool ok = !need_mask || bwd_visible(row, col, Sq, Sk, causal, window);
        sc[4 * j + e] = ok ? ex2_approx(fmaf(sc[4 * j + e], scale_log2, -lse_r[e >> 1])) : 0.f;
      }
    }
  };
  auto ds_of = [&]() {
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) dp[i] = sc[i] * (dp[i] - del_r[(i >> 1) & 1]);
  };
  // dS rounded to bf16 pairs into the A fragments: accumulator columns
  // 8 j.. are key step j / 2's a0, a1 (j even) or a2, a3 (j odd)
  auto pack_ds = [&]() {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      da[j / 2][(j & 1) * 2] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
      da[j / 2][(j & 1) * 2 + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
    }
  };
  auto done_dq = [&]() {  // the dQ product in flight has completed
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) fence_regs(da[kk]);  // read until here
  };
  // once the scores are issued (and `pending` dQ products after them):
  // P while dP runs, then dS in dp
  auto finish_scores = [&](int k0, auto pending) {
    constexpr int N = decltype(pending)::value;
    wgmma_wait<N + 1>();  // S is done; dP (and the dQ product) run on
    fence_regs(sc);
    p_of(k0);
    wgmma_wait<N>();
    fence_regs(dp);
    ds_of();
  };
  int s = 0, ph = 0;
  auto stage = [&](int st) { return ring + st * 2 * KT * D; };
  auto advance = [&]() {
    if (++s == NS) s = 0, ph ^= 1;
  };
  auto release = [&](int st) {  // the stage is free
    if (lane == 0) mbar_arrive(empty + st);
  };
  auto pass = [&](int n) {  // hand back n steps unread, each once it is full
    for (int i = 0; i < n; ++i, advance()) {
      mbar_wait(full + s, ph);
      release(s);
    }
  };
  constexpr std::integral_constant<int, 0> none{};
  constexpr std::integral_constant<int, 1> one{};

  pass(w_begin);
  mbar_wait(qbar, 0);  // also with no step of its own: the copies end here
  // The first step alone, then the steady state: no product is issued
  // or waited for under a condition inside the loop (ptxas serialises
  // wgmma whose waits it cannot match up along every path).
  if (w_end > w_begin) {
    int sp = s;  // deferred: the stage of the dQ product to issue next
    mbar_wait(full + s, ph);
    issue_scores(stage(s));
    finish_scores((t_begin + w_begin) * KT, none);
    pack_ds();
    if constexpr (!kDefer) {
      issue_dq(stage(s));
      done_dq();
      release(s);
    }
    advance();
    for (int it = w_begin + 1; it < w_end; ++it, advance()) {
      const int k0 = (t_begin + it) * KT;
      mbar_wait(full + s, ph);
      issue_scores(stage(s));
      if constexpr (kDefer) {
        issue_dq(stage(sp));
        finish_scores(k0, one);
        done_dq();
        release(sp);
        pack_ds();
        sp = s;
      } else {
        finish_scores(k0, none);
        pack_ds();
        issue_dq(stage(s));
        done_dq();
        release(s);
      }
    }
    if constexpr (kDefer) {
      issue_dq(stage(sp));
      done_dq();
      release(sp);
    }
  }
  pass(ntiles - w_end);

  bf16* dqg = dq + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t4;
    if (row0 < Sq) {
      *reinterpret_cast<uint32_t*>(dqg + static_cast<size_t>(row0) * D + col) =
          pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    }
    if (row1 < Sq) {
      *reinterpret_cast<uint32_t*>(dqg + static_cast<size_t>(row1) * D + col) =
          pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 dK/dV on Hopper's units: wgmma, TMA, a producer warpgroup
// ---------------------------------------------------------------------
// The tiles of flash_bwd_dkdv_wgmma<D, NC, QR>: NC consumer warpgroups of
// 64 keys each (a key tile of 64 NC keys) behind one producer warpgroup,
// walking QR query rows a step.  A tile of R rows is stored as D / kAtom
// column blocks of R x kAtom bf16, swizzled (sm90.cuh; kAtom the widest of
// 64, 32, 16 dividing D, as FwdTiles).  Shared memory, from a 1024-byte
// boundary: K and V of the key tile, once; a ring of `stages` steps, each
// q and dO of QR rows (TMA) and their lse (log2 units) and D (QR floats
// each, stored by the producer's second warp); after the walk, the
// float32 partials of dK and dV ([keys][D + 4] each) over the ring for
// the cluster's sum; the mbarriers past both.  One block an SM with two
// consumers (kBudget: all 227 KB), two with one.
template <int D, int NC, int QR>
struct BwdTiles {
  static constexpr int kAtom = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kSpan = 2 * kAtom;  // bytes of a swizzled row
  static constexpr int kColBlocks = D / kAtom;
  static constexpr int kKeys = 64 * NC;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kKVBytes = 2 * kKeys * D * 2;  // K and V
  static constexpr int kStepBytes = 2 * QR * D * 2;   // q and dO of a step
  static constexpr int kRowBytes = 2 * QR * 4;        // lse and D of a step
  static constexpr int kPartBytes = 2 * kKeys * (D + kPartPad) * 4;
  static constexpr int kBudget = NC == 2 ? 232448 : 115712;
  static constexpr int kBarBytes = 128;
  static constexpr int kFit = (kBudget - 1024 - kBarBytes - kKVBytes) / (kStepBytes + kRowBytes);
  static constexpr int kMaxStages = kFit < 4 ? kFit : 4;
  // registers a thread after setmaxnreg: producer, consumers (the
  // launch's 168 or 128 a thread, moved from the producer)
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = NC == 2 ? 240 : 232;
  __host__ __device__ static constexpr int ring_bytes(int stages) {
    return kKVBytes + stages * (kStepBytes + kRowBytes);
  }
  __host__ __device__ static constexpr int bar_offset(int stages) {
    return ring_bytes(stages) > kPartBytes ? ring_bytes(stages) : kPartBytes;
  }
  __host__ __device__ static constexpr int smem(int stages) {
    return 1024 + bar_offset(stages) + kBarBytes;
  }
  static_assert(QR == 32 || QR == 64, "32 or 64 query rows a step");
  static_assert(kMaxStages >= 2 && smem(kMaxStages) <= kBudget, "the q / dO ring does not fit");
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * NC <=
                    (NC == 2 ? 168 * 384 : 128 * 256),
                "the warpgroups' registers exceed the launch's");
};

// Whether no pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) is
// visible: past an end, wholly above the diagonal, or wholly past the
// window.
__device__ __forceinline__ bool tile_hidden(int q0, int nq, int k0, int nk, int Sq, int Sk,
                                            int causal, int window) {
  if (q0 >= Sq || k0 >= Sk) return true;
  if (!causal) return false;
  return q0 + nq - 1 < k0 || (window > 0 && q0 >= k0 + nk - 1 + window);
}

// A consumer's order of a step.  By default P^T is computed while dP^T
// runs and dS^T while dV runs.  "Together" waits for both scores, then
// computes P^T and dS^T column by column and issues dV and dK at once:
// each column's S^T and dP^T registers free as its bf16 pairs fill, about
// 16 fewer live at the peak, but the exponentials overlap no product of
// this warpgroup (2-12% slower at D = 64-96, NVIDIA H100 80GB HBM3, 700 W;
// tools/flash_bwd_times.py).  The 64-row step at D = 128 takes it: the
// default spills there (ptxas).  A timing copy built with
// -DDKDV_TOGETHER=1 takes it everywhere.
#ifndef DKDV_TOGETHER
#define DKDV_TOGETHER 0
#endif

// dK and dV of 64 NC keys of one (batch, kv head) over `heads` of its
// query heads, in head order, QR query rows a step.  With cluster > 1 the
// block is rank blockIdx.x % cluster of the cluster that shares its key
// tile and kv head; rank r takes query heads r heads .. (r + 1) heads - 1,
// and the cluster sums its partials in rank order before one rank a
// share of the keys writes them.
//  - producer (warpgroup 0, down to kProducerRegs): thread 0 issues every
//    TMA copy (K and V once, then q and dO of each step into the ring
//    once its "empty" barrier says the consumers have read the stage);
//    warp 1 stores each step's lse and D rows beside them (rows past Sq
//    0, as their q and dO rows, which TMA reads as zeros); the stage's
//    "full" barrier completes on the copy's bytes and 33 arrivals;
//  - consumer warpgroup w (keys 64 w.. of the tile, 16 a warp), a step:
//    S^T = K q^T and dP^T = V dO^T on wgmma m64n{QR}k16, both operands
//    K-major from their tiles, issued together; P^T = 2^(S^T scale log2 e
//    - lse log2 e) (0 where hidden) while dP^T runs, rounded to bf16 into
//    the A fragment (the S^T accumulator's layout) of dV += P^T dO on
//    m64n{D}k16, dO read MN-major; dS^T = P^T (dP^T - D) while dV runs,
//    rounded the same way, then dK += dS^T q (the 64-row step at D = 128
//    computes both after the two scores: kTogether above); the stage is
//    released once both products are done.  A step none of whose pairs
//    this warpgroup's keys see is skipped.

template <int D, int NC, int QR>
__global__ void __launch_bounds__(BwdTiles<D, NC, QR>::kThreads, NC == 1 ? 2 : 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int KV, int Sq, int Sk, float scale,
                     float scale_log2, int causal, int window, int heads, int cluster,
                     int stages) {
  using T = BwdTiles<D, NC, QR>;
  using namespace sm90;
  constexpr int A = T::kAtom, KT = T::kKeys, SP = T::kSpan;
  constexpr bool kTogether = DKDV_TOGETHER != 0 || (D == 128 && QR == 64);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* ks = reinterpret_cast<bf16*>(base);  // [col block][KT][A]
  bf16* vs = ks + KT * D;                     // [col block][KT][A]
  bf16* ring = vs + KT * D;                   // [stage][q, dO][col block][QR][A]
  float* rowf = reinterpret_cast<float*>(base + T::kKVBytes + stages * T::kStepBytes);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(base + T::bar_offset(stages));
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + T::kMaxStages;

  const int G = H / KV, bk = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const int b = bk / KV, kvh = bk % KV;
  const int k0 = blockIdx.y * KT;  // causal: the first keys have the most rows
  int q_begin, q_end;
  rows_seeing(k0, KT, Sq, causal, window, q_begin, q_end);
  const int t_begin = q_begin / QR;
  const int per_head = max(0, (q_end + QR - 1) / QR - t_begin);
  const int total = heads * per_head;
  const int h0 = b * H + kvh * G + rank * heads;  // (batch, head) of step 0
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 33);      // the copy's thread and warp 1's lanes
      mbar_init(empty + s, 4 * NC);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  cg::cluster_group cl = cg::this_cluster();

  if (wg == 0) {
    regs_dec<T::kProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_do);
      mbar_arrive_expect_tx(kvbar, T::kKVBytes);
#pragma unroll
      for (int c = 0; c < T::kColBlocks; ++c) {
        tma_load_3d(ks + c * KT * A, &tm_k, kvbar, c * A, k0, bk);
        tma_load_3d(vs + c * KT * A, &tm_v, kvbar, c * A, k0, bk);
      }
      for (int it = 0, s = 0, ph = 0; it < total; ++it) {
        mbar_wait(empty + s, ph ^ 1);
        mbar_arrive_expect_tx(full + s, T::kStepBytes);
        bf16* qd = ring + s * 2 * QR * D;
        bf16* dd = qd + QR * D;
        const int bh = h0 + it / per_head, q0 = (t_begin + it % per_head) * QR;
#pragma unroll
        for (int c = 0; c < T::kColBlocks; ++c) {
          tma_load_3d(qd + c * QR * A, &tm_q, full + s, c * A, q0, bh);
          tma_load_3d(dd + c * QR * A, &tm_do, full + s, c * A, q0, bh);
        }
        if (++s == stages) s = 0, ph ^= 1;
      }
    } else if (warp == 1) {
      for (int it = 0, s = 0, ph = 0; it < total; ++it) {
        const size_t at = static_cast<size_t>(h0 + it / per_head) * Sq;
        const int q0 = (t_begin + it % per_head) * QR;
        mbar_wait(empty + s, ph ^ 1);
        float* rf = rowf + s * 2 * QR;
        for (int r = lane; r < QR; r += 32) {
          const bool in = q0 + r < Sq;
          rf[r] = in ? lse[at + q0 + r] * kLog2e : 0.f;
          rf[QR + r] = in ? delta[at + q0 + r] : 0.f;
        }
        mbar_arrive(full + s);
        if (++s == stages) s = 0, ph ^= 1;
      }
    }
    if (cluster > 1) {  // the consumers' two cluster barriers
      __syncwarp();
      cl.sync();
      cl.sync();
    }
    return;
  }

  regs_inc<T::kConsumerRegs>();
  const int wgi = wg - 1, t = threadIdx.x - 128 * wg;
  const int warp = t / 32, lane = t % 32;
  const int gr = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int kw0 = k0 + 64 * wgi;            // this warpgroup's keys
  const int key0 = kw0 + warp * 16 + gr;    // this thread's: key0, key0 + 8
  const bf16* kw = ks + wgi * 64 * A;
  const bf16* vw = vs + wgi * 64 * A;
  // K's and V's descriptors; each step adds a k-step's offset to its own
  // copy, so that ptxas does not hold the 2 D / 16 loop-invariant
  // descriptors (64 bits each) in registers across the walk
  const uint64_t kdesc = smem_desc(kw, 16, 8 * SP, SP), vdesc = smem_desc(vw, 16, 8 * SP, SP);

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  float sT[QR / 2], dpT[QR / 2];     // S^T then P^T; dP^T then dS^T
  uint32_t pa[QR / 16][4], sa[QR / 16][4];  // P^T, dS^T: A operands of QR / 16 steps

  mbar_wait(kvbar, 0);
  for (int it = 0, s = 0, ph = 0, tq = 0; it < total; ++it) {
    const int q0 = (t_begin + tq) * QR;
    if (++tq == per_head) tq = 0;
    mbar_wait(full + s, ph);
    if (!tile_hidden(q0, QR, kw0, 64, Sq, Sk, causal, window)) {
      const bf16* qt = ring + s * 2 * QR * D;
      const bf16* dt = qt + QR * D;
      const float* lf = rowf + s * 2 * QR;
      uint64_t kd = kdesc, vd = vdesc;
      asm volatile("" : "+l"(kd), "+l"(vd));
      const uint64_t qd = smem_desc(qt, 16, 8 * SP, SP), od = smem_desc(dt, 16, 8 * SP, SP);
      // The first k-step overwrites S^T and dP^T: the previous step's values
      // end at their last use, so that their registers can hold P^T and
      // dS^T meanwhile (the products' "+f" operands would keep them alive).
#pragma unroll
      for (int i = 0; i < QR / 2; ++i) asm volatile("" : "=f"(sT[i]), "=f"(dpT[i]));
      // S^T = K q^T, then dP^T = V dO^T: D / 16 steps each, issued together
      // (descriptor offsets in 16-byte units)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / A, off = kk * 16 % A;
        Wgmma<QR>::template ss<0, 0>(sT, kd + (c * KT * A + off) / 8, qd + (c * QR * A + off) / 8,
                                     kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / A, off = kk * 16 % A;
        Wgmma<QR>::template ss<0, 0>(dpT, vd + (c * KT * A + off) / 8,
                                     od + (c * QR * A + off) / 8, kk > 0);
      }
      wgmma_commit();
      // P^T where visible (only tiles that cross the diagonal, an end or the
      // window's edge check each pair), and dS^T = P^T (dP^T - D), of the
      // accumulator columns 8 j.. (query rows), each pair rounded to bf16
      // into the A fragments
      const bool need_mask = !tile_visible(q0, QR, kw0, 64, Sq, Sk, causal, window);
      auto p_of = [&](int j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lf + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t4 + (e & 1);
          const bool ok =
              !need_mask || bwd_visible(q0 + r, key0 + 8 * (e >> 1), Sq, Sk, causal, window);
          sT[4 * j + e] =
              ok ? ex2_approx(fmaf(sT[4 * j + e], scale_log2, (e & 1) ? -l2.y : -l2.x)) : 0.f;
        }
        pa[j / 2][(j & 1) * 2] = pack_bf16(sT[4 * j], sT[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(sT[4 * j + 2], sT[4 * j + 3]);
      };
      auto ds_of = [&](int j) {
        const float2 d2 = *reinterpret_cast<const float2*>(lf + QR + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dpT[4 * j + e] = sT[4 * j + e] * (dpT[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
        sa[j / 2][(j & 1) * 2] = pack_bf16(dpT[4 * j], dpT[4 * j + 1]);
        sa[j / 2][(j & 1) * 2 + 1] = pack_bf16(dpT[4 * j + 2], dpT[4 * j + 3]);
      };
      // dV += P^T dO and dK += dS^T q: QR / 16 steps each, A from
      // registers, dO and q read MN-major (their rows are the k)
      auto issue_dv = [&]() {
        fence_regs(adv);
#pragma unroll
        for (int kk = 0; kk < QR / 16; ++kk) fence_regs(pa[kk]);
        const uint64_t omn = smem_desc(dt, QR * SP, 8 * SP, SP);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QR / 16; ++kk) {
          Wgmma<D>::template rs<1>(adv, pa[kk], omn + 2 * kk * A, 1);
        }
      };
      auto issue_dk = [&]() {
        fence_regs(adk);
#pragma unroll
        for (int kk = 0; kk < QR / 16; ++kk) fence_regs(sa[kk]);
        const uint64_t qmn = smem_desc(qt, QR * SP, 8 * SP, SP);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QR / 16; ++kk) {
          Wgmma<D>::template rs<1>(adk, sa[kk], qmn + 2 * kk * A, 1);
        }
      };
      if constexpr (kTogether) {
        // both scores first, then P^T and dS^T column by column (each
        // column's S^T and dP^T registers free as its A pairs fill), then
        // both products
        wgmma_wait<0>();
        fence_regs(sT);
        fence_regs(dpT);
#pragma unroll
        for (int j = 0; j < QR / 8; ++j) {
          p_of(j);
          ds_of(j);
        }
        issue_dv();
        issue_dk();
        wgmma_commit();
      } else {
        // P^T while dP^T runs, dS^T while dV runs
        wgmma_wait<1>();
        fence_regs(sT);
#pragma unroll
        for (int j = 0; j < QR / 8; ++j) p_of(j);
        issue_dv();
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is done; dV runs on
        fence_regs(dpT);
#pragma unroll
        for (int j = 0; j < QR / 8; ++j) ds_of(j);
        issue_dk();
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(adv);
      fence_regs(adk);
#pragma unroll
      for (int kk = 0; kk < QR / 16; ++kk) {  // read by the products until here
        fence_regs(pa[kk]);
        fence_regs(sa[kk]);
      }
    }
    if (lane == 0) mbar_arrive(empty + s);  // the stage is free
    if (++s == stages) s = 0, ph ^= 1;
  }

  const size_t koff = static_cast<size_t>(bk) * Sk * D;
  if (cluster == 1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kj = key0 + 8 * half;
        if (kj >= Sk) continue;
        const size_t at = koff + static_cast<size_t>(kj) * D + col;
        *reinterpret_cast<uint32_t*>(dk + at) =
            pack_bf16(adk[4 * j + 2 * half] * scale, adk[4 * j + 2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at) =
            pack_bf16(adv[4 * j + 2 * half], adv[4 * j + 2 * half + 1]);
      }
    }
    return;
  }

  // The cluster's sum.  Each block's float32 partials go over its ring
  // ([KT][D + 4] of dK, then of dV); rank r then sums keys
  // [KT r / cluster, KT (r + 1) / cluster) of both over ranks 0.. in rank
  // order, reading its peers' shared memory, and writes them.
  constexpr int PD = D + kPartPad;
  float* pk = reinterpret_cast<float*>(base);
  float* pv = pk + KT * PD;
  named_sync(1, 128 * NC);  // every consumer warp is done with the ring
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 64 * wgi + warp * 16 + gr + 8 * half;
      *reinterpret_cast<float2*>(pk + r * PD + col) =
          make_float2(adk[4 * j + 2 * half], adk[4 * j + 2 * half + 1]);
      *reinterpret_cast<float2*>(pv + r * PD + col) =
          make_float2(adv[4 * j + 2 * half], adv[4 * j + 2 * half + 1]);
    }
  }
  cl.sync();  // every rank's partials are in place
  const int r_begin = KT * rank / cluster, r_end = KT * (rank + 1) / cluster;
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x - 128; i < (r_end - r_begin) * C4; i += 128 * NC) {
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
  int dq_rows, kv_keys, kv_rows, heads, cluster, stages, parts;
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

// A compiled flash_bwd_dkdv_wgmma<D, NC, QR>, as a type.
template <int D, int NC, int QR>
struct Dkdv {
  using Tiles = BwdTiles<D, NC, QR>;
  static constexpr int kD = D, kNC = NC, kQR = QR;
};

// Call f(Dkdv<D, NC, QR>{}) for the variant of ``keys`` keys a block and
// ``rows`` query rows a step; kStatusBadArgs for any other.  One consumer
// of 64-row steps at D = 128 is not built: its 232 registers a thread
// spill in either order (ptxas, sm_90a).
template <int D, typename F>
int with_dkdv(int keys, int rows, F&& f) {
  if (keys == 128 && rows == 64) return f(Dkdv<D, 2, 64>{});
  if (keys == 128 && rows == 32) return f(Dkdv<D, 2, 32>{});
  if constexpr (D != 128) {
    if (keys == 64 && rows == 64) return f(Dkdv<D, 1, 64>{});
  }
  if (keys == 64 && rows == 32) return f(Dkdv<D, 1, 32>{});
  return kStatusBadArgs;
}

template <typename V>
int prepare_dkdv(int stages, int cluster) {
  using T = typename V::Tiles;
  if (stages < 2 || stages > T::kMaxStages || cluster < 1 || cluster > kMaxCluster) {
    return kStatusBadArgs;
  }
  return allow_smem(flash_bwd_dkdv_wgmma<V::kD, V::kNC, V::kQR>, T::smem(stages));
}

template <typename V>
cudaLaunchConfig_t dkdv_config(dim3 grid, int stages, cudaStream_t s, cudaLaunchAttribute* attr,
                               int cluster) {
  using T = typename V::Tiles;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::smem(stages);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D, typename V>
int launch_dkdv_wgmma(const BwdArgs& a) {
  using T = typename V::Tiles;
  CUtensorMap maps[4];  // q, k, v, dO
  const int A = T::kAtom, SP = T::kSpan;
  int st = encode_tile_map<bf16>(maps, a.q, a.B * a.H, a.Sq, D, a.kv_rows, A, SP);
  if (!st) st = encode_tile_map<bf16>(maps + 1, a.k, a.B * a.KV, a.Sk, D, T::kKeys, A, SP);
  if (!st) st = encode_tile_map<bf16>(maps + 2, a.v, a.B * a.KV, a.Sk, D, T::kKeys, A, SP);
  if (!st) st = encode_tile_map<bf16>(maps + 3, a.dout, a.B * a.H, a.Sq, D, a.kv_rows, A, SP);
  if (!st) st = prepare_dkdv<V>(a.stages, a.cluster);
  if (st) return st;
  auto kernel = flash_bwd_dkdv_wgmma<D, V::kNC, V::kQR>;
  const dim3 grid(a.B * a.KV * a.cluster, (a.Sk + T::kKeys - 1) / T::kKeys);
  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
  if (a.cluster == 1) {
    kernel<<<grid, T::kThreads, T::smem(a.stages), a.s>>>(
        maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, dk, dv, a.H, a.KV, a.Sq, a.Sk,
        a.scale, a.scale * kLog2e, a.causal, a.window, a.heads, 1, a.stages);
    return launch_status();
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = dkdv_config<V>(grid, a.stages, a.s, attr, a.cluster);
  st = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3],
                                           a.lse, static_cast<const float*>(a.delta), dk, dv,
                                           a.H, a.KV, a.Sq, a.Sk, a.scale, a.scale * kLog2e,
                                           a.causal, a.window, a.heads, a.cluster, a.stages));
  return st ? st : launch_status();
}

template <int D, int NC>
int prepare_dq() {
  return allow_smem(flash_bwd_dq_wgmma<D, NC>, DqTiles<D, NC>::kSmem);
}

template <int D, int NC>
int launch_dq_wgmma(const BwdArgs& a) {
  using T = DqTiles<D, NC>;
  CUtensorMap maps[4];  // q, k, v, dO
  const int A = T::kAtom, SP = T::kSpan;
  int st = encode_tile_map<bf16>(maps, a.q, a.B * a.H, a.Sq, D, T::kRows, A, SP);
  if (!st) st = encode_tile_map<bf16>(maps + 1, a.k, a.B * a.KV, a.Sk, D, T::kKeys, A, SP);
  if (!st) st = encode_tile_map<bf16>(maps + 2, a.v, a.B * a.KV, a.Sk, D, T::kKeys, A, SP);
  if (!st) st = encode_tile_map<bf16>(maps + 3, a.dout, a.B * a.H, a.Sq, D, T::kRows, A, SP);
  if (!st) st = prepare_dq<D, NC>();
  if (st) return st;
  const dim3 grid(a.B * a.H, (a.Sq + T::kRows - 1) / T::kRows);
  flash_bwd_dq_wgmma<D, NC><<<grid, T::kThreads, T::kSmem, a.s>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, static_cast<bf16*>(a.dq), a.H, a.KV,
      a.Sq, a.Sk, a.scale, a.scale * kLog2e, a.causal, a.window);
  return launch_status();
}

// Call f(std::integral_constant<int, NC>{}) for the dq variant of ``rows``
// query rows a block (NC = rows / 64 consumers); kStatusBadArgs for any
// other.
template <typename F>
int with_dq(int rows, F&& f) {
  if (rows == 128) return f(std::integral_constant<int, 2>{});
  if (rows == 64) return f(std::integral_constant<int, 1>{});
  return kStatusBadArgs;
}

template <int D>
int launch_flash_bwd_bf16(const BwdArgs& a) {
  const int G = a.H / a.KV;
  if (a.cluster < 1 || a.cluster > kMaxCluster || a.heads * a.cluster != G) {
    return kStatusBadArgs;
  }
  int st = 0;
  if (a.parts & kPartPrep) {
    st = launch_prep<bf16, D>(a);
    if (st) return st;
  }
  if (a.parts & kPartDq) {
    st = with_dq(a.dq_rows, [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      return launch_dq_wgmma<D, NC>(a);
    });
    if (st) return st;
  }
  if (a.parts & kPartDkdv) {
    return with_dkdv<D>(a.kv_keys, a.kv_rows,
                        [&](auto v) { return launch_dkdv_wgmma<D, decltype(v)>(a); });
  }
  return 0;
}

// How many dq blocks of ``rows`` query rows one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out.
template <int D>
int dq_max_blocks(int rows, int* out) {
  return with_dq(rows, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    int st = prepare_dq<D, NC>();
    if (st) return st;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, flash_bwd_dq_wgmma<D, NC>, DqTiles<D, NC>::kThreads, DqTiles<D, NC>::kSmem));
  });
}

// How many clusters of ``cluster`` dkdv blocks of this variant the card
// holds at once (cudaOccupancyMaxActiveClusters), into *out.
template <int D>
int dkdv_max_clusters(int keys, int rows, int stages, int cluster, int* out) {
  return with_dkdv<D>(keys, rows, [&](auto v) {
    using V = decltype(v);
    int st = prepare_dkdv<V>(stages, cluster);
    if (st) return st;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = dkdv_config<V>(dim3(cluster), stages, 0, attr, cluster);
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(out, flash_bwd_dkdv_wgmma<D, V::kNC, V::kQR>, &cfg));
  });
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
    return launch_flash_bwd_bf16<D>(a);
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
                                         int stages, int parts, void* stream) {
  using namespace repro;
  if (KV <= 0 || H % KV != 0) return kStatusBadArgs;
  const BwdArgs a{q,  k,  v,  o,  static_cast<const float*>(lse), dout, static_cast<float*>(delta),
                  dq, dk, dv, B,  H, KV, Sq, Sk, scale, causal, window, dq_rows, kv_keys,
                  kv_rows, heads, cluster, stages, parts,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == kDtypeBF16) return dispatch_flash_bwd<__nv_bfloat16>(D, a);
  return dispatch_flash_bwd<float>(D, a);
}

// Clusters of ``cluster`` bf16 dkdv blocks (``keys`` keys a block,
// ``rows`` query rows a step, ``stages`` ring stages) the card holds at
// once, into *out.
extern "C" int repro_flash_bwd_max_clusters(int D, int keys, int rows, int stages, int cluster,
                                            int* out) {
  using namespace repro;
  switch (D) {
    case 16: return dkdv_max_clusters<16>(keys, rows, stages, cluster, out);
    case 32: return dkdv_max_clusters<32>(keys, rows, stages, cluster, out);
    case 64: return dkdv_max_clusters<64>(keys, rows, stages, cluster, out);
    case 80: return dkdv_max_clusters<80>(keys, rows, stages, cluster, out);
    case 96: return dkdv_max_clusters<96>(keys, rows, stages, cluster, out);
    case 128: return dkdv_max_clusters<128>(keys, rows, stages, cluster, out);
    default: return kStatusBadHeadDim;
  }
}

// bf16 dq blocks of ``rows`` query rows a block one SM holds at once, into
// *out.
extern "C" int repro_flash_bwd_dq_blocks(int D, int rows, int* out) {
  using namespace repro;
  switch (D) {
    case 16: return dq_max_blocks<16>(rows, out);
    case 32: return dq_max_blocks<32>(rows, out);
    case 64: return dq_max_blocks<64>(rows, out);
    case 80: return dq_max_blocks<80>(rows, out);
    case 96: return dq_max_blocks<96>(rows, out);
    case 128: return dq_max_blocks<128>(rows, out);
    default: return kStatusBadHeadDim;
  }
}
