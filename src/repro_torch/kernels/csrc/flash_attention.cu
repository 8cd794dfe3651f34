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
// float32 operands take flash_kernel_tf32, on the same units.  Its
// yardstick is SDPA's float32 route, which runs on the tensor cores too
// (mma m16n8k8 with CUTLASS's OpMultiplyAddFastF32: each float32 operand
// split into a TF32 hi and lo, three products, float32 sums).  The zoo of
// the end-to-end example (serve_workflow) trains and serves in float32,
// so every zoo prefill and training step runs this kernel, as does
// train-100m; its shapes are small (S = 16-128, D = 16-64: 0.0002-0.0013
// ms of bytes at 3.35 TB/s), so the latency of each step bounds it, not
// the card's rate: a block walks its key tiles one after another.  The
// design:
//  - products on wgmma m64nNk8 .tf32 with float32 accumulators, every
//    operand x split into hi = tf32(x) and lo = tf32(x - hi) (tf32(): the
//    low 13 mantissa bits rounded away, ties away from zero; ref.tf32 is
//    the same rounding bit for bit), a product the sum of lo.hi, hi.lo and
//    hi.hi: about 22 bits of each operand, which holds the float32
//    tolerance of 2e-5 where one TF32 product does not;
//  - .tf32 operands are K-major only, so V (keys x D) is transposed: a
//    splitter warpgroup turns each K/V tile, as it lands, into K's hi (in
//    place) and lo and V^T's hi and lo, in the swizzled layout wgmma
//    reads, while the consumer multiplies the previous tile; the consumer
//    splits Q the same way, once, while the first tile is split, and
//    keeps Q's hi in registers (two of S's three products read A from
//    there: 44% fewer shared-memory bytes for S).  V^T stores
//    the keys of each group of 8 in the order 0 2 4 6 1 3 5 7, so that
//    the S accumulator fragment (keys 2t, 2t + 1 of a thread) is already
//    the .tf32 A fragment of P (k = t, t + 4): P is split in registers
//    with no shuffle;
//  - one thread of the splitter issues every copy by TMA (Q's tile, then
//    K and V through a ring of 2-4 stages with "full", "ready" and
//    "empty" mbarriers); K lands swizzled, V dense.  Two warpgroups, not
//    a ninth producer warp: 9 warps put 3 on one of the SM's 4 register
//    files and cap a thread at 168 registers, and Q's hi needs D / 2;
//  - one consumer warpgroup owns 64 query rows: S_i and P_{i-1}.V issued
//    together, the online softmax of S_i (log2 units, the scale folded, P
//    kept in float32 until its split) while P.V runs, then O rescaled;
//  - -inf masks only on the diagonal tile, the ragged tail and the
//    window's first tiles; the query blocks with the most tiles launch
//    first.  32-key tiles (flash_attention.fwd_plan; 64-key tiles, where
//    two stages fit, are built and timed as the plan it passes over).
// The C entry point chooses by dtype; a bf16 call never reaches the
// float32 kernel.

#include <chrono>
#include <type_traits>

#include "sm90.cuh"

namespace repro {

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

// ---------------------------------------------------------------------
// float32 on the tensor cores: split-TF32 wgmma behind a TMA ring
// ---------------------------------------------------------------------
// K/V stages of the float32 kernel's ring at head dimension D and BK-key
// tiles: as many, up to 4, as fit one block's 232,448 bytes after 1024
// bytes to align the tiles, 128 for the barriers and Q's hi and lo (64
// rows each), a stage holding five tiles (K, hi in place; K's lo; V; V^T's
// hi and lo).  The consumer overlaps tile i's S with tile i - 1's P.V, so
// a ring needs 2.
__host__ __device__ constexpr int tf32_stages(int D, int BK) {
  const int fit = (232448 - 1024 - 128 - 2 * 64 * D * 4) / (5 * BK * D * 4);
  return fit < 4 ? fit : 4;
}

// The tiles of flash_kernel_tf32<D, BK>: 64 query rows, BK (32 or 64)
// keys a tile.  Q and K tiles are stored as D / kAtom column blocks of
// rows x kAtom floats, swizzled (kAtom 32 where it divides D: 128-byte
// rows; else 16: 64-byte rows); V lands dense (keys x D); V^T is BK / 32
// column blocks of D rows x 32 keys (128-byte rows, swizzled).  Threads:
// the splitter warpgroup (0-127, its thread 0 also issues the copies) and
// the consumer warpgroup (128-255).
template <int D, int BK>
struct Tf32Tiles {
  static constexpr int kAtom = D % 32 == 0 ? 32 : 16;
  static constexpr int kSpan = 4 * kAtom;  // bytes of a swizzled row
  static constexpr int kColBlocks = D / kAtom;
  static constexpr int kRows = 64;
  static constexpr int kThreads = 256;
  static constexpr int kQBytes = kRows * D * 4;  // Q's hi, or its lo
  static constexpr int kTile = BK * D;           // floats of one tile
  static constexpr int kStages = tf32_stages(D, BK);
  static constexpr int kSmem = 1024 + 2 * kQBytes + kStages * 5 * kTile * 4 + 128;
  static_assert(BK == 32 || BK == 64, "V^T rows are blocks of 32 keys");
  static_assert(kStages >= 2 && kSmem <= 232448, "two K/V stages do not fit");
};

// x with its low 13 mantissa bits rounded away, to nearest with ties away
// from zero: the TF32 value the tensor cores read (ref.tf32, bit for bit)
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// hi = tf32(x), lo = tf32(x - hi) (x - hi is exact)
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

__device__ __forceinline__ void tf32_split4(float4 x, float4& hi, float4& lo) {
  tf32_split(x.x, hi.x, lo.x);
  tf32_split(x.y, hi.y, lo.y);
  tf32_split(x.z, hi.z, lo.z);
  tf32_split(x.w, hi.w, lo.w);
}

// N floats at x split by the 128 threads of a warpgroup, 16 bytes a
// thread a step: hi in place, lo at the same offset from ``lo``
template <int N>
__device__ __forceinline__ void split_tile(float* x, float* lo, int t) {
  float4* x4 = reinterpret_cast<float4*>(x);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll 4
  for (int i = t; i < N / 4; i += 128) {
    float4 h, l;
    tf32_split4(x4[i], h, l);
    x4[i] = h;
    l4[i] = l;
  }
}

// V (BK keys x D, dense) into V^T's hi and lo: BK / 32 column blocks of D
// rows x 32 key positions, 16-byte chunk c of row n at chunk c ^ (n % 8)
// (the 128-byte swizzle).  Positions 0-7 of each group of 8 hold keys
// 0 2 4 6 1 3 5 7: a thread's S fragment holds keys 2t and 2t + 1, and
// the .tf32 A fragment k = t and t + 4.  A thread writes one chunk of hi
// and of lo a step; lanes take consecutive columns of V.
template <int D, int BK>
__device__ __forceinline__ void split_vt(const float* v, float* hi, float* lo, int t) {
#pragma unroll 2
  for (int i = t; i < D * BK / 4; i += 128) {
    const int n = i % D, c = i / D;             // row of V^T, chunk of 4 positions
    const int key = (c >> 1) * 8 + (c & 1);     // its first key
    const float4 x = make_float4(v[key * D + n], v[(key + 2) * D + n], v[(key + 4) * D + n],
                                 v[(key + 6) * D + n]);
    float4 h, l;
    tf32_split4(x, h, l);
    const int off = (c / 8) * D * 32 + n * 32 + (((c % 8) ^ (n % 8)) * 4);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// The float offset of (row, col) in a tile of R rows that TMA stored as
// column blocks of A floats, swizzled: 16-byte chunk c of a 128-byte row
// at c ^ (row % 8), of a 64-byte row at c ^ (row / 2 % 4)
template <int A, int R>
__device__ __forceinline__ int swizzled(int row, int col) {
  const int cc = col % A;
  const int chunk = (cc / 4) ^ (A == 32 ? row % 8 : row / 2 % 4);
  return (col / A) * R * A + row * A + chunk * 4 + cc % 4;
}

template <int D, int BK>
__global__ void __launch_bounds__(Tf32Tiles<D, BK>::kThreads, 1)
flash_kernel_tf32(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                  float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                  float scale_log2, int causal, int window) {
  using T = Tf32Tiles<D, BK>;
  using namespace sm90;
  constexpr int A = T::kAtom, ST = T::kStages, TL = T::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* qh = reinterpret_cast<float*>(base);  // Q's hi: [col block][64][A]
  float* ql = qh + T::kRows * D;               // Q's lo, the same layout
  float* ring = ql + T::kRows * D;             // [stage][K, K lo, V, V^T hi, V^T lo][TL]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + ST * 5 * TL);
  uint64_t* full = qbar + 1;
  uint64_t* ready = full + ST;
  uint64_t* empty = ready + ST;

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
      mbar_init(ready + s, 128);
      mbar_init(empty + s, 4);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // the splitter: each K/V tile as it lands.  Its thread 0 issues every
    // copy: Q's tile and the first ST tiles at once, then, once tile j is
    // split, the tile that takes the stage of tile j - 1 as soon as the
    // consumer frees it (during its tile j, which this split readied)
    const int t = threadIdx.x;
    const int slab = b * KV + kvh;
    auto load_kv = [&](int it) {
      const int s = it % ST;
      mbar_arrive_expect_tx(full + s, 2 * TL * 4);
      float* kd = ring + s * 5 * TL;
      const int k0 = (t_begin + it) * BK;
#pragma unroll
      for (int c = 0; c < T::kColBlocks; ++c) {
        tma_load_3d(kd + c * BK * A, &tm_k, full + s, c * A, k0, slab);
      }
      tma_load_3d(kd + 2 * TL, &tm_v, full + s, 0, k0, slab);
    };
    if (t == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(qbar, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kColBlocks; ++c) {
        tma_load_3d(qh + c * T::kRows * A, &tm_q, qbar, c * A, q0, bh);
      }
      for (int it = 0; it < min(ST, ntiles); ++it) load_kv(it);
    }
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % ST;
      float* kt = ring + s * 5 * TL;
      mbar_wait(full + s, (it / ST) & 1);
      split_tile<TL>(kt, kt + TL, t);
      split_vt<D, BK>(kt + 2 * TL, kt + 3 * TL, kt + 4 * TL, t);
      fence_proxy_async();  // the generic writes, before wgmma reads them
      mbar_arrive(ready + s);
      const int next = it - 1 + ST;  // into the stage of tile it - 1
      if (t == 0 && it >= 1 && next < ntiles) {
        mbar_wait(empty + next % ST, ((it - 1) / ST) & 1);
        load_kv(next);
      }
    }
  } else {
    // the consumer: 64 query rows, 16 a warp
    const int t = threadIdx.x - 128;
    const int warp = t / 32, lane = t % 32;
    const int gr = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
    const int row0 = q0 + warp * 16 + gr, row1 = row0 + 8;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f}, alpha[2];
    float sc[BK / 2];                        // S, then P, of one key tile
    uint32_t ph[BK / 8][4], pl[BK / 8][4];  // P's hi and lo: the A operand of BK / 8 steps
    uint32_t qf[D / 8][4];                  // Q's hi: the A operand of D / 8 steps

    // S = Q.K^T on stage s: three passes of D / 8 steps of m64n{BK}k8, the
    // small terms first (Q hi . K lo, Q lo . K hi, then Q hi . K hi); Q's
    // hi from registers, its lo from shared memory (an A read from shared
    // memory is 2 KB a step, more than the step's 16 cycles of tensor
    // work move at 128 bytes a cycle)
    auto issue_qk = [&](int s) {
      const float* kh = ring + s * 5 * TL;
      const float* kl = kh + TL;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) fence_regs(qf[kk]);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 3; ++part) {
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const int c = kk * 8 / A, off = kk * 8 % A;
          const uint64_t db = smem_desc((part == 0 ? kl : kh) + c * BK * A + off, 16,
                                        8 * T::kSpan, T::kSpan);
          if (part == 1) {
            const uint64_t da = smem_desc(ql + c * T::kRows * A + off, 16, 8 * T::kSpan,
                                          T::kSpan);
            WgmmaTf32<BK>::ss(sc, da, db, 1);
          } else {
            WgmmaTf32<BK>::rs(sc, qf[kk], db, part > 0 || kk > 0);
          }
        }
      }
      wgmma_commit();
    };
    // O += P.V on stage s: three passes of BK / 8 steps of m64n{D}k8, P
    // from registers (P lo . V hi, P hi . V lo, P hi . V hi), V^T by
    // descriptor
    auto issue_pv = [&](int s) {
      const float* vh = ring + s * 5 * TL + 3 * TL;
      const float* vl = vh + TL;
      fence_regs(acc);  // the rescaled accumulators and P are written
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int off = (kk / 4) * D * 32 + (kk % 4) * 8;
        WgmmaTf32<D>::rs(acc, pl[kk], smem_desc(vh + off, 16, 8 * 128, 128), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int off = (kk / 4) * D * 32 + (kk % 4) * 8;
        WgmmaTf32<D>::rs(acc, ph[kk], smem_desc(vl + off, 16, 8 * 128, 128), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int off = (kk / 4) * D * 32 + (kk % 4) * 8;
        WgmmaTf32<D>::rs(acc, ph[kk], smem_desc(vh + off, 16, 8 * 128, 128), 1);
      }
      wgmma_commit();
    };
    // the online softmax of the tile of keys from k0 in sc, as the bf16
    // kernel's: -inf masks where the tile needs them, the row max m in
    // log2 units, alpha = 2^(m_old - m), p = 2^(s scale_log2 - m) left in
    // sc, l = alpha l + row sum of p.  Rows row0 (e 0, 1), row1 (e 2, 3).
    auto softmax = [&](int k0) {
      const float kInf = __int_as_float(0x7f800000);
      const bool need_mask =
          k0 + BK > Sk ||
          (causal && (k0 + BK - 1 > q0 || (window > 0 && k0 <= q0 + 63 - window)));
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
    // new P split into the A fragments (k = t: key 2t, k = t + 4: key
    // 2t + 1, as V^T orders them)
    auto rescale_split = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float hi, lo;
          tf32_split(sc[4 * j + (r >> 1) + 2 * (r & 1)], hi, lo);  // e 0, 2, 1, 3
          ph[j][r] = __float_as_uint(hi);
          pl[j][r] = __float_as_uint(lo);
        }
      }
    };

    // Q split by the consumer itself, while the splitter takes the first
    // K/V tile; then, as the bf16 kernel's one consumer: S_i issued with
    // P_{i-1}.V, the softmax of S_i while P.V runs, O rescaled once it is
    // done
    mbar_wait(qbar, 0);
    split_tile<T::kRows * D>(qh, ql, t);
    fence_proxy_async();
    named_sync(1, 128);  // the consumer warpgroup's split of Q is written
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // rows 16 warp + gr (+ 8), k = t4 (+ 4)
        const int row = warp * 16 + gr + 8 * (r & 1), col = kk * 8 + t4 + 4 * (r >> 1);
        qf[kk][r] = __float_as_uint(qh[swizzled<A, T::kRows>(row, col)]);
      }
    }
    if (ntiles > 0) {
      mbar_wait(ready, 0);
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(t_begin * BK);
      rescale_split();
    }
    for (int it = 1; it < ntiles; ++it) {
      const int s = it % ST, sp = (it - 1) % ST;
      mbar_wait(ready + s, (it / ST) & 1);
      issue_qk(s);
      issue_pv(sp);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax((t_begin + it) * BK);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + sp);  // stage sp is free
      rescale_split();
    }
    if (ntiles > 0) {
      const int sp = (ntiles - 1) % ST;
      issue_pv(sp);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + sp);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    }
    const float d0 = l_r[0] == 0.f ? 1.f : l_r[0], d1 = l_r[1] == 0.f ? 1.f : l_r[1];
    if (lse != nullptr && t4 == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      float* lb = lse + static_cast<size_t>(bh) * Sq;
      if (row0 < Sq) lb[row0] = l_r[0] == 0.f ? kNegInf : (m_r[0] + log2f(l_r[0])) * kLn2;
      if (row1 < Sq) lb[row1] = l_r[1] == 0.f ? kNegInf : (m_r[1] + log2f(l_r[1])) * kLn2;
    }
    float* og = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t4;
      if (row0 < Sq) {
        *reinterpret_cast<float2*>(og + static_cast<size_t>(row0) * D + col) =
            make_float2(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      }
      if (row1 < Sq) {
        *reinterpret_cast<float2*>(og + static_cast<size_t>(row1) * D + col) =
            make_float2(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
      }
    }
  }
}

template <int D, int BK>
int launch_flash_tf32(const void* q, const void* k, const void* v, void* o, float* lse,
                      int B, int H, int KV, int Sq, int Sk, float scale, int causal,
                      int window, cudaStream_t s) {
  using T = Tf32Tiles<D, BK>;
  CUtensorMap maps[3];
  int st = encode_tile_map<float>(maps, q, B * H, Sq, D, T::kRows, T::kAtom, T::kSpan);
  if (!st) st = encode_tile_map<float>(maps + 1, k, B * KV, Sk, D, BK, T::kAtom, T::kSpan);
  if (!st) st = encode_tile_map<float>(maps + 2, v, B * KV, Sk, D, BK, D, 0);
  if (!st) st = allow_smem(flash_kernel_tf32<D, BK>, T::kSmem);
  if (st) return st;
  dim3 grid(B * H, (Sq + T::kRows - 1) / T::kRows);
  flash_kernel_tf32<D, BK><<<grid, T::kThreads, T::kSmem, s>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(o), lse, H, KV, Sq, Sk,
      scale * 1.4426950408889634f, causal, window);
  return launch_status();
}

// The kernel of dtype T at head dimension D: bf16 with ``rows`` (64 or
// 128) query rows a block (its key tile follows), float32 with 64 rows
// and ``keys`` (32, or 64 where two stages of 64 keys fit) a tile.
template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int KV, int Sq, int Sk,
                 float scale, int causal, int window, int rows, int keys, cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (rows == 128) {
      return launch_flash_wgmma<D, 2>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    }
    if (rows == 64) {
      return launch_flash_wgmma<D, 1>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    }
    return kStatusBadArgs;
  } else {
    if (rows != 64) return kStatusBadArgs;
    if (keys == 32) {
      return launch_flash_tf32<D, 32>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
    }
    if constexpr (tf32_stages(D, 64) >= 2) {
      if (keys == 64) {
        return launch_flash_tf32<D, 64>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, s);
      }
    }
    return kStatusBadArgs;
  }
}

// Launch the instantiation for head dimension D; an unlisted D launches
// nothing and returns kStatusBadHeadDim.
template <typename T>
int dispatch_flash(int D, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int H, int KV, int Sq, int Sk,
                   float scale, int causal, int window, int rows, int keys,
                   cudaStream_t s) {
  switch (D) {
    case 16: return launch_flash<T, 16>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, keys, s);
    case 32: return launch_flash<T, 32>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, keys, s);
    case 64: return launch_flash<T, 64>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, keys, s);
    case 80: return launch_flash<T, 80>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, keys, s);
    case 96: return launch_flash<T, 96>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, keys, s);
    case 128: return launch_flash<T, 128>(q, k, v, o, lse, B, H, KV, Sq, Sk, scale, causal, window, rows, keys, s);
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
                                     int window, int dtype, int rows, int keys,
                                     void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kDtypeBF16) {
    return dispatch_flash<__nv_bfloat16>(D, q, k, v, o, l, B, H, KV, Sq, Sk, scale, causal, window,
                                         rows, keys, s);
  }
  return dispatch_flash<float>(D, q, k, v, o, l, B, H, KV, Sq, Sk, scale, causal, window, rows,
                               keys, s);
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
