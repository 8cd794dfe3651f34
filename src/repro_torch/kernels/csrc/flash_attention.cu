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
// What bounds it: the products.  Yi-9B's training form (2, 32, 2048, 128)
// and LLaVA's image prefill (1, 56, 3328, 128) do 70 and 161 us of bf16
// tensor-core work at 989 TFLOP/s against 23 and 33 us of bytes at 3.35
// TB/s.  A served 448-token prefill (Yi-9B: 1.65 GFLOP, 8.3 MB) is 2.5 us
// of bytes, and its 32 heads x 4 query tiles fill one wave of 132 SMs at
// most: latency, not rate, bounds it there.  On the Ampere instruction set
// (mma.sync fed by ldmatrix and two-stage cp.async, four warps that all
// copy, then multiply, then run the softmax between two __syncthreads)
// the training forms reached 0.19-0.20 of that bound.
//
// bf16 operands take flash_kernel_wgmma, built on Hopper's asynchronous
// units (sm90.cuh):
//  - warp specialisation: warpgroup 0 is the producer, one thread of it
//    issuing every copy, brought down to 24 registers (setmaxnreg); one or
//    two consumer warpgroups own 64 query rows each and take the
//    registers it gave up (240 or 232 a thread);
//  - copies by TMA: Q's tile once, K and V tiles through a ring of 2-4
//    stages, each with a "full" mbarrier the copy completes and an "empty"
//    one the consumers' warps arrive on when their products have read it,
//    so the next tiles load while this one is multiplied.  The tensor maps
//    are rank 3, (B*H, Sq, D) and (B*KV, Sk, D): a box past Sq or Sk reads
//    zeros, never the next head's rows.  Tiles are stored with the widest
//    swizzle whose row divides D (128 B at D = 64 and 128, 64 B at 32 and
//    96, 32 B at 16 and 80), the layout wgmma reads without bank
//    conflicts;
//  - S = Q.K^T on wgmma m64n{keys}k16 with both operands in shared memory;
//    O += P.V on wgmma m64n{D}k16 with P from registers (the accumulator
//    fragment of S, rounded to bf16, is already the A fragment, as
//    ref.attention rounds its probabilities to v.dtype) and V read
//    MN-major from its tile;
//  - the softmax overlaps the products: a consumer issues tile i's
//    Q.K^T together with tile i-1's P.V, runs tile i's online softmax
//    (row max and sum by quad shuffles, one fma and ex2 a score, the
//    scale folded into log2 e) while P.V runs, and rescales O once it is
//    done; two consumers take turns issuing their products (a pair of
//    named barriers), so one's softmax also overlaps the other's
//    products (a softmax run between the two products left the tensor
//    cores idle for much of the kernel's time);
//  - -inf masks only on the diagonal tile, the ragged tail and the
//    window's first tiles; the query blocks with the most tiles are
//    launched first, so the causal triangle balances over the card.
// Two consumer warpgroups (128 rows, 128-key tiles, one block an SM) for
// long query axes, one (64 rows, 64-key tiles, two blocks an SM) for the
// served prefills: flash_attention.fwd_plan chooses by shape.
//
// float32 operands take flash_kernel on the CUDA cores (four warps, four
// query rows a warp, one key a lane; attention_tile.cuh): TF32 products
// would miss the float32 tolerance of 2e-5, and no served path runs
// float32 on the card.  The C entry point chooses by dtype; a bf16 call
// never reaches the float32 kernel.

#include <chrono>
#include <type_traits>

#include "attention_tile.cuh"
#include "sm90.cuh"

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
// bf16 on Hopper's tensor cores: wgmma, TMA, a producer warpgroup
// ---------------------------------------------------------------------
// Timing copies only: `chip_smoke.py --phases parts` builds the kernels
// with -DFLASH_VARIANT=<bits>, each bit taking one part out of the bf16
// kernel (whose outputs are then wrong).  The served build leaves it 0.
#ifndef FLASH_VARIANT
#define FLASH_VARIANT 0
#endif
enum FlashVariant : int {
  kFlashNoSoftmax = 1 << 0,  // P = S rounded to bf16: no mask, max, exp or rescale
  kFlashNoPV = 1 << 1,       // no O += P.V products
  kFlashNoQK = 1 << 2,       // no S = Q.K^T products (S = 0)
  kFlashNoPingPong = 1 << 3, // two consumers issue their products in any order
};
__host__ __device__ constexpr bool flash_has(int bit) { return (FLASH_VARIANT & bit) != 0; }

// The tiles of flash_kernel_wgmma<D, NWG>: NWG consumer warpgroups of 64
// query rows each (128 or 64 rows a block) behind one producer warpgroup;
// key tiles of 128 keys with two consumers, 64 with one, so that a block
// of one consumer fits two to an SM.  A tile of R rows is stored as D /
// kAtom column blocks of R x kAtom bf16 (swizzled, sm90.cuh): kAtom is the
// widest of 64, 32, 16 that divides D (128-, 64- or 32-byte rows).  The
// ring has as many K/V stages, up to 4, as the shared memory of one block
// an SM (two consumers) or of two (one consumer) holds; kSmem adds 1024
// bytes to align the tiles and 128 for the barriers.
template <int D, int NWG>
struct FwdTiles {
  static constexpr int kAtom = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kSpan = 2 * kAtom;  // bytes of a swizzled row
  static constexpr int kColBlocks = D / kAtom;
  static constexpr int kRows = 64 * NWG;
  static constexpr int kKeys = NWG == 2 ? 128 : 64;
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;  // K or V of one stage
  static constexpr int kBudget = NWG == 2 ? 232448 : 115712;
  static constexpr int kFit = (kBudget - 1024 - 128 - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kTileBytes + 128;
  // registers a thread after setmaxnreg: producer, consumers (the
  // launch's 168 or 128 a thread, moved from the producer)
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = NWG == 2 ? 240 : 232;
  static_assert(kStages >= 2 && kSmem <= kBudget, "the K/V ring does not fit");
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * NWG <=
                    (NWG == 2 ? 168 * 384 : 128 * 256),
                "the warpgroups' registers exceed the launch's");
};

template <int D, int NWG>
__global__ void __launch_bounds__(FwdTiles<D, NWG>::kThreads, NWG == 1 ? 2 : 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                   float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                   float scale_log2, int causal, int window) {
  using T = FwdTiles<D, NWG>;
  using namespace sm90;
  constexpr int BK = T::kKeys, A = T::kAtom, ST = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(base);  // [col block][kRows][A]
  bf16* kvs = reinterpret_cast<bf16*>(base + T::kQBytes);  // [stage][K, V][col block][BK][A]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + T::kQBytes + ST * 2 * T::kTileBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kRows;  // most tiles first
  int k_begin = 0, k_end = Sk;
  if (causal) {
    k_end = min(Sk, q0 + T::kRows);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  const int t_begin = k_begin / BK;
  const int ntiles = max(0, (k_end + BK - 1) / BK - t_begin);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread issues every copy, the others leave
    regs_dec<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(qbar, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kColBlocks; ++c) {
        tma_load_3d(qs + c * T::kRows * A, &tm_q, qbar, c * A, q0, bh);
      }
      const int slab = b * KV + kvh;
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, 2 * T::kTileBytes);
        bf16* kd = kvs + s * 2 * BK * D;
        bf16* vd = kd + BK * D;
        const int k0 = (t_begin + it) * BK;
#pragma unroll
        for (int c = 0; c < T::kColBlocks; ++c) {
          tma_load_3d(kd + c * BK * A, &tm_k, full + s, c * A, k0, slab);
          tma_load_3d(vd + c * BK * A, &tm_v, full + s, c * A, k0, slab);
        }
      }
    }
  } else {
    // a consumer: 64 query rows, 16 a warp
    regs_inc<T::kConsumerRegs>();
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32, lane = t % 32;
    const int gr = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
    const int r0 = 64 * (wg - 1);             // the warpgroup's rows in the block
    const int wq0 = q0 + r0;
    const int row0 = wq0 + warp * 16 + gr, row1 = row0 + 8;
    const bf16* qw = qs + r0 * A;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f}, alpha[2];
    float sc[BK / 2];         // S, then P in float32, of one key tile
    uint32_t pa[BK / 16][4];  // P in bf16: the A operand of BK / 16 key steps

    // S = Q.K^T on stage s: D / 16 steps of m64n{BK}k16, both operands
    // K-major; issued and committed, not waited for
    auto issue_qk = [&](int s) {
      const bf16* kt = kvs + s * 2 * BK * D;
      if constexpr (flash_has(kFlashNoQK)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk * 16 / A, off = kk * 16 % A;
          const uint64_t da = smem_desc(qw + c * T::kRows * A + off, 16, 8 * T::kSpan, T::kSpan);
          const uint64_t db = smem_desc(kt + c * BK * A + off, 16, 8 * T::kSpan, T::kSpan);
          Wgmma<BK>::template ss<0, 0>(sc, da, db, kk > 0);
        }
      }
      wgmma_commit();
    };
    // O += P.V on stage s: BK / 16 steps of m64n{D}k16, P from registers,
    // V read MN-major (its rows are keys, D contiguous); issued, not waited
    auto issue_pv = [&](int s) {
      const bf16* vt = kvs + s * 2 * BK * D + BK * D;
      if constexpr (flash_has(kFlashNoPV)) {
        acc[0] += __uint_as_float(pa[0][0]);  // keep P alive
      } else {
        fence_regs(acc);  // the rescaled accumulators and P are written
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = smem_desc(vt + kk * 16 * A, BK * T::kSpan, 8 * T::kSpan, T::kSpan);
          Wgmma<D>::template rs<1>(acc, pa[kk], dv, 1);
        }
      }
      wgmma_commit();
    };
    // the online softmax of the tile of keys from k0 in sc: mask the
    // diagonal tile, the ragged tail and the window's edge with -inf; the
    // new row max m in log2 units (scores times scale_log2) from quad
    // shuffles, alpha = 2^(m_old - m), p = 2^(s scale_log2 - m) by one fma
    // and ex2 (exactly 0 where masked) left in sc, l = alpha l + row sum
    // of p.  Rows row0 (e 0, 1), row1 (e 2, 3).
    auto softmax = [&](int k0) {
      if constexpr (flash_has(kFlashNoSoftmax)) {
        alpha[0] = alpha[1] = 1.f;
        return;
      }
      const float kInf = __int_as_float(0x7f800000);
      const bool need_mask =
          k0 + BK > Sk ||
          (causal && (k0 + BK - 1 > wq0 || (window > 0 && k0 <= wq0 + 63 - window)));
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? row0 : row1;
            const int col = k0 + j * 8 + 2 * t4 + (e & 1);
            bool ok = col < Sk;
            if (causal) ok = ok && col <= row && (window <= 0 || col > row - window);
            if (!ok) sc[4 * j + e] = -kInf;
          }
        }
      }
      float mx[2] = {-kInf, -kInf};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mx[i] = fmaxf(m_r[i], mx[i] * scale_log2);
        alpha[i] = ex2_approx(m_r[i] - mx[i]);
        m_r[i] = mx[i];
        l_r[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = ex2_approx(fmaf(sc[4 * j + e], scale_log2, -mx[e >> 1]));
        }
        l_r[0] += sc[4 * j] + sc[4 * j + 1];
        l_r[1] += sc[4 * j + 2] + sc[4 * j + 3];
      }
    };
    // once the product with the previous P is done: O *= alpha, and the
    // new P rounded to bf16 pairs into the A fragment
    auto rescale_pack = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        pa[j / 2][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };

    // Tile i's scores are multiplied while tile i - 1's P.V runs: S_i and
    // P_{i-1}.V_{i-1} are issued together, the softmax of S_i overlaps
    // the second product, and O is rescaled by alpha_i once it is done
    // (the sums are those of rescaling first, then adding, tile by tile).
    // With two consumers a named barrier pair takes turns issuing the
    // products (bar 1: warpgroup 1's turn, bar 2: warpgroup 2's), so that
    // one's softmax overlaps the other's products.
    constexpr bool kPingPong = NWG == 2 && !flash_has(kFlashNoPingPong);
    const int wgi = wg - 1;
    if constexpr (kPingPong) {
      if (wgi == 1) named_arrive(1, 256);  // warpgroup 1 issues first
    }
    mbar_wait(qbar, 0);
    if (ntiles > 0) {
      mbar_wait(full, 0);
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(t_begin * BK);
      rescale_pack();
    }
    for (int it = 1; it < ntiles; ++it) {
      const int s = it % ST, sp = (it - 1) % ST;
      mbar_wait(full + s, (it / ST) & 1);
      if constexpr (kPingPong) named_sync(1 + wgi, 256);
      issue_qk(s);
      issue_pv(sp);
      if constexpr (kPingPong) named_arrive(2 - wgi, 256);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax((t_begin + it) * BK);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + sp);  // stage sp is free
      rescale_pack();
    }
    if (ntiles > 0) {
      const int sp = (ntiles - 1) % ST;
      issue_pv(sp);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + sp);
    }
    if constexpr (kPingPong) {
      if (wgi == 0) named_sync(1, 256);  // warpgroup 2's last turn
    }

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
    bf16* og = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t4;
      if (row0 < Sq) {
        *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row0) * D + col) =
            pack_bf16(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      }
      if (row1 < Sq) {
        *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row1) * D + col) =
            pack_bf16(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
      }
    }
  }
}

// The three tensor maps of a launch: Q (B H, Sq, D) in boxes of the
// block's rows, K and V (B KV, Sk, D) in boxes of a key tile.
template <int D, int NWG>
int encode_flash_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, int B,
                      int H, int KV, int Sq, int Sk) {
  using T = FwdTiles<D, NWG>;
  int st = encode_tile_map<bf16>(maps, q, B * H, Sq, D, T::kRows, T::kAtom, T::kSpan);
  if (!st) st = encode_tile_map<bf16>(maps + 1, k, B * KV, Sk, D, T::kKeys, T::kAtom, T::kSpan);
  if (!st) st = encode_tile_map<bf16>(maps + 2, v, B * KV, Sk, D, T::kKeys, T::kAtom, T::kSpan);
  return st;
}

template <int D, int NWG>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int KV, int Sq, int Sk, float scale, int causal,
                       int window, cudaStream_t s) {
  using T = FwdTiles<D, NWG>;
  CUtensorMap maps[3];
  int st = encode_flash_maps<D, NWG>(maps, q, k, v, B, H, KV, Sq, Sk);
  if (!st) st = allow_smem(flash_kernel_wgmma<D, NWG>, T::kSmem);
  if (st) return st;
  dim3 grid(B * H, (Sq + T::kRows - 1) / T::kRows);
  flash_kernel_wgmma<D, NWG><<<grid, T::kThreads, T::kSmem, s>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, H, KV, Sq, Sk,
      scale * 1.4426950408889634f, causal, window);
  return launch_status();
}

// The kernel of dtype T at head dimension D: bf16 on the tensor cores
// with ``rows`` (64 or 128) query rows a block, float32 on the CUDA cores.
template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int KV, int Sq, int Sk,
                 float scale, int causal, int window, int rows, cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (rows == 128) {
      return launch_flash_wgmma<D, 2>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    }
    if (rows == 64) {
      return launch_flash_wgmma<D, 1>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    }
    return kStatusBadArgs;
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
                   float scale, int causal, int window, int rows, cudaStream_t s) {
  switch (D) {
    case 16: return launch_flash<T, 16>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, s);
    case 32: return launch_flash<T, 32>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, s);
    case 64: return launch_flash<T, 64>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, s);
    case 80: return launch_flash<T, 80>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, s);
    case 96: return launch_flash<T, 96>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, s);
    case 128: return launch_flash<T, 128>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, s);
    default: return kStatusBadHeadDim;
  }
}

// Nanoseconds of host time a bf16 launch spends encoding its three tensor
// maps, the mean of ``reps`` encodings (chip_smoke.py reads it).
template <int D>
double encode_ns(const void* q, const void* k, const void* v, int B, int H, int KV, int Sq,
                 int Sk, int rows, int reps) {
  CUtensorMap maps[3];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const int st = rows == 128 ? encode_flash_maps<D, 2>(maps, q, k, v, B, H, KV, Sq, Sk)
                               : encode_flash_maps<D, 1>(maps, q, k, v, B, H, KV, Sq, Sk);
    if (st) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / (reps > 0 ? reps : 1);
}

}  // namespace repro

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int H, int KV, int Sq, int Sk,
                                     int D, float scale, int causal,
                                     int window, int dtype, int rows, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kDtypeBF16) {
    return dispatch_flash<__nv_bfloat16>(D, q, k, v, o, l, B, H, KV, Sq, Sk, scale, causal, window, rows, s);
  }
  return dispatch_flash<float>(D, q, k, v, o, l, B, H, KV, Sq, Sk, scale, causal, window, rows, s);
}

extern "C" double repro_flash_encode_ns(const void* q, const void* k, const void* v, int B,
                                        int H, int KV, int Sq, int Sk, int D, int rows,
                                        int reps) {
  using namespace repro;
  switch (D) {
    case 64: return encode_ns<64>(q, k, v, B, H, KV, Sq, Sk, rows, reps);
    case 80: return encode_ns<80>(q, k, v, B, H, KV, Sq, Sk, rows, reps);
    case 96: return encode_ns<96>(q, k, v, B, H, KV, Sq, Sk, rows, reps);
    case 128: return encode_ns<128>(q, k, v, B, H, KV, Sq, Sk, rows, reps);
    default: return -1.0;
  }
}
