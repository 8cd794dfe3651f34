// One-token decode attention over a KV cache for Hopper: the valid slots
// of a sequence are cut over the blocks of a thread block cluster, each
// block streams its share by TMA through a ring of shared-memory stages,
// and the cluster merges its partials in distributed shared memory.
//
// Replaces repro/kernels/decode_attention.py::_decode_kernel (Pallas grid
// (B, KV, k blocks), all G query heads of one kv head per program, online
// softmax in VMEM scratch across the sequential k axis).  Sequence b sees
// slots [max(0, L - window), L) with L = lens[b] (window 0: [0, L)); any
// cache length works (the Pallas version asserts S % block_k == 0).
//
// What bounds it: bytes, and the latency of a short chain.  A step reads
// L x D x 2 values per kv head (13.6 MB at LLaVA's image cache, 4.1 us at
// 3.35 TB/s) and does about G operations a byte of K and V (7 at LLaVA, 1
// at Zamba2 and Whisper), far below the ~295 at which the tensor cores
// would become the limit.  One kv head's cache is too small a job for one
// block and too large for one DRAM round trip, and a short cache is a
// chain of dependent steps: the length, the tiles, the merge.
//
// The design:
// - The grid is (cluster x column slices, KV x head chunks, B); the
//   ``cluster`` blocks of one (batch, kv head, head chunk, column slice)
//   form a thread block cluster.  Rank r owns tiles [r T / C, (r + 1) T /
//   C) of the T tiles of 128 bytes a column (64 bf16 or 32 float32 keys)
//   that cover the sequence's valid slots [start, L), cut on the device
//   from lens[b] and the window: whatever S is, no rank holds two tiles
//   more than another.  A block takes up to 8 query heads of its kv head
//   (kDecodeHeads; a larger G is cut into head chunks), so every key it
//   loads serves all of them, as in repro's kernel; column slice c owns
//   1 / slices of the output columns and loads only those of V.  The
//   wrapper picks the plan (cluster, slices, head chunk, ring depth) from
//   the shapes and the card, never from the lengths, which lie on the
//   device (decode_attention.decode_plans).
// - Warp 0 sets the mbarriers up and puts every tile of the block's share,
//   up to the ring's depth, in flight at once by TMA, a box a lane, from
//   tensor maps over the caches as (D, S, B KV), before the block's first
//   barrier: a block pays the DRAM latency once, not once a tile.  Each
//   stage has a "full" mbarrier the copy's bytes complete and an "empty"
//   one on which every warp arrives when done with it; thread 0 refills a
//   stage, once empty, with the tile a ring's depth ahead.
// - bf16 (every served path): the products run on the tensor cores
//   (mma.sync m16n8k16, bf16 x bf16 exact, float32 sums).  A first form of
//   this kernel kept them float32 on the CUDA cores, where every product
//   needs a shared-memory load, a conversion and a share of a cross-lane
//   sum; on an H100 it was slower than the kernel it replaced at every
//   timed shape.  Warp w takes keys 16 (w % 4) .. + 15 of every tile and
//   the output columns of half w / 4 of the slice.  S = Q.K^T has the
//   block's heads as rows 0..7 of the A operand (q in registers), K by
//   ldmatrix from tiles TMA writes swizzled (the 16-byte chunk's index
//   XORed by the row's place in a group of 8 lines, so 8 rows at one chunk
//   fall in 8 bank groups; at D = 80 one dense box a tile, 2-way
//   conflicts, where 32-byte blocks would take 5 boxes).  Each warp keeps
//   its own online softmax over its keys (float32, log2 units).  P enters
//   O += P.V as two bf16 parts in the A operand (the accumulator fragment
//   of S is the A fragment, as in the flash forward): its rounding in rows
//   0..7 and the rounding of the remainder in rows 8..15, which are free
//   in an m16 product of 8 heads.  So P keeps about 16 bits, close to the
//   float32 P of repro's kernel, at no extra product.  V by
//   ldmatrix.trans.  Slots past L in a partial tile are zeroed in V (P is
//   0 there, and 0 x NaN is not 0).
// - float32 (the zoo's engines): the products stay on the CUDA cores in
//   float32 (TF32 would miss float32's tolerance), exact to float32
//   rounding.  A warp's lanes split a key's row into 8-element chunks for
//   the 4 heads of its half, with q in registers, and sum them across the
//   lanes by a scatter of shuffles; each warp keeps its own online softmax
//   and P.V accumulators over its keys.
// - The warps' partials merge in the block by their log-sum-exp weights
//   in warp order (decode_block_merge, both paths).  A cluster of one
//   writes its output.  Otherwise every block writes its partial of each
//   (head, 4 columns) item, and its m and l, into the shared memory of the
//   rank whose 1 / cluster share holds the item (cluster.map_shared_rank):
//   each thread arrives on the cluster barrier at the kernel's entry and
//   waits on it before its first such write, so no rank is written before
//   it has started (the tile loop hides the wait).  After the cluster
//   barrier that follows the writes, each rank weighs the ranks of a head
//   by their log-sum-exp (an empty rank: weight exactly 0, its words never
//   multiplied) and sums its share over ranks 0.. in rank order.  Pushing
//   the partials, not pulling them, spares a remote round trip.  No
//   workspace, counter or atomic: every launch, CUDA graph replays
//   included, does the same work in the same order.
//
// DECODE_VARIANT (timing copies built by chip_smoke.py's `parts` phase;
// no wrapper launches them): bit 0 keeps the copies and barriers and
// takes the scores, softmax and P.V out; bit 1 takes the cluster merge
// out (every rank writes its own partial as a cluster of one would).

#include <cooperative_groups.h>

#include <type_traits>

#include "sm90.cuh"

#ifndef DECODE_VARIANT
#define DECODE_VARIANT 0
#endif

namespace cg = cooperative_groups;

namespace repro {

constexpr int kDecodeThreads = 256;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeHeads = 8;        // query heads a block (a head chunk)
constexpr int kDecodeMaxCluster = 16;  // 8 portable, 16 with the opt-in
constexpr int kDecodeMaxStages = 8;    // stages of a block's ring at most
// Bytes a block receives from its cluster's ranks: their partials of
// its share of the (head, 4 columns) items (at most 8 x 128 / 4 items
// over the ranks, plus a rank's rounding), then every rank's m and l of
// every head.
constexpr int kDecodeRx =
    16 * (kDecodeHeads * 32 + kDecodeMaxCluster) + 2 * 4 * kDecodeHeads * kDecodeMaxCluster;
constexpr bool kDecodeNoMath = DECODE_VARIANT & 1;
constexpr bool kDecodeNoMerge = DECODE_VARIANT & 2;

// Keys of one tile: 128 bytes a column (64 bf16, 32 float32).
template <typename T> __host__ __device__ constexpr int decode_tile_keys() {
  return 128 / static_cast<int>(sizeof(T));
}

// Lanes a key in the score phase: one a chunk of 8 elements of a row of
// K, rounded up to a power of two (16 at D = 80, six of them idle).
template <int D> __host__ __device__ constexpr int decode_key_lanes() {
  return D / 8 <= 2 ? 2 : D / 8 <= 4 ? 4 : D / 8 <= 8 ? 8 : 16;
}

// Byte offsets of the shared-memory regions from the 1024-aligned base,
// and the bytes the launch asks for (the base's alignment included).  The
// base holds the ring of ``stages`` stages (K's tile, then V's slice);
// after the tile loop, the warps' accumulators (at most 32 floats a
// thread), then the ranks' merge weights.  Mirrored by
// decode_attention.smem_bytes.
struct DecodeLayout {
  size_t sw, wst, stats, rx, bars, bytes;
};

template <typename T, int D>
__host__ __device__ inline DecodeLayout decode_layout(int dc, int stages) {
  constexpr int tk = decode_tile_keys<T>();
  const size_t ring = static_cast<size_t>(stages) * tk * (D + dc) * sizeof(T);
  const size_t red = sizeof(float) * 32 * kDecodeThreads;
  DecodeLayout l;
  l.sw = ring > red ? ring : red;                          // [warp][16 keys][4 heads]
  l.wst = l.sw + sizeof(float) * kDecodeWarps * 16 * 4;    // [warp][8] m, then l
  l.stats = l.wst + sizeof(float) * 2 * kDecodeWarps * kDecodeHeads;  // the block's m, l
  l.rx = l.stats + sizeof(float) * 2 * kDecodeHeads;       // the ranks' pushes
  l.bars = l.rx + kDecodeRx;                               // full, empty [stages]
  l.bytes = 1024 + l.bars + 2 * sizeof(uint64_t) * stages;
  return l;
}

// Bytes of a swizzled row of a bf16 tile of ``cols`` columns: 128 where
// they divide a row (2 column blocks at 128 columns), else the row itself
// at 32 or 64 bytes; 0 for 80 columns (160 bytes): one dense box, whose
// 8-row ldmatrix reads then meet 2-way bank conflicts, where 32-byte
// blocks would take 5 boxes a tile.
__host__ __device__ constexpr int decode_span(int cols) {
  return (cols * 2) % 128 == 0 ? 128 : cols * 2 <= 64 ? cols * 2 : 0;
}

// Element offset of 16-byte chunk c of row r in a bf16 tile of TK rows
// and ``cols`` columns: dense rows for span 0, else column blocks of span
// bytes a row in TMA's swizzled layout (the chunk's index in its 128-byte
// line XORed by the row's place in a group of 8 lines), so that 8
// consecutive rows at one chunk fall in 8 distinct bank groups.
template <int TK>
__device__ __forceinline__ int swz(int r, int c, int span, int cols) {
  if (span == 0) return r * cols + c * 8;
  const int per = span / 16;  // chunks a row of a block
  return (c / per) * TK * (span / 2) + r * (span / 2) +
         ((c % per) ^ (((r * span) >> 7) & (per - 1))) * 8;
}

// Eight (bf16) or four (f32) elements of one 16-byte load.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// The parity wait of sm90::mbar_wait, bounded: a copy that never lands
// (a refused tensor map) traps, an error the launch reports, instead of
// holding the card.
__device__ __forceinline__ void decode_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0; !sm90::mbar_try_wait(bar, parity); ++polls) {
    if (polls == (1u << 22)) __trap();
  }
}

// Sum V values over the L lanes (aligned, a power of two) that hold one
// key group's partial dot products, scattering them: while a lane holds
// more than one value, each step keeps half and trades the other half
// with its partner; the remaining steps add whole.  Returns the first
// value's index: a lane then holds the sums of values base .. base +
// max(1, V / L) - 1, the same in every lane of a group of max(1, L / V).
template <int V, int L>
__device__ __forceinline__ int reduce_scatter(float (&v)[V], int lane) {
  int base = 0, n = V;
#pragma unroll
  for (int off = L / 2; off >= 1; off /= 2) {
    const bool hi = lane & off;
    if (n > 1) {
      const int half = n / 2;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < half) {
          const float send = hi ? v[i] : v[i + half];
          const float keep = hi ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      base += hi ? half : 0;
      n = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
  return base;
}

// What a block's tile loop works with: its ring and share, q and the
// output of its first head, and where its partial goes.
template <typename T>
struct DecodeBlock {
  unsigned char* base;  // the ring, then the warps' accumulators
  uint64_t* full;
  uint64_t* empty;
  float* wm;    // [warp][8 heads]: the warps' m, then their weights
  float* wl;    // [warp][8 heads]: the warps' l
  float* m_s;   // [8]: the block's m
  float* l_s;   // [8]: the block's l
  float4* rx;   // [item of this rank's share][rank]: the ranks' partials
  float* sw;    // [warp][16 keys][4 heads]: scores, then P (float32 path)
  const T* qg;  // q of the block's first head
  T* ob;        // the output of the block's first head
  int gn, dc, c0, stages, ntiles, first, L;  // first: the share's first slot
  int rank, cluster;
  float scale;
  bool direct;  // write the output (a cluster of one), not a partial

  // The ranks' m and l of head g, after the items: rm[g][rank], rl[g][rank].
  __device__ float* rm() const {
    return reinterpret_cast<float*>(rx + kDecodeHeads * 32 + kDecodeMaxCluster);
  }
  __device__ float* rl() const { return rm() + kDecodeHeads * kDecodeMaxCluster; }
  // First item of rank r's share of n items.
  __device__ int item_lo(int n, int r) const { return n * r / cluster; }
  // This block's partial of (head, 4 columns) item i of n, written into
  // the shared memory of the rank whose share holds it.
  __device__ void push(int i, int n, float4 a) const {
    const int r = owner(i, n);
    cg::this_cluster().map_shared_rank(rx, r)[(i - item_lo(n, r)) * cluster + rank] = a;
  }
  // The rank whose share of n items holds item i.
  __device__ int owner(int i, int n) const {
    int r = i * cluster / n;
    while (r + 1 < cluster && i >= item_lo(n, r + 1)) ++r;
    while (r > 0 && i < item_lo(n, r)) --r;
    return r;
  }
  // This block's m and l of every head, into every rank, a (head, rank)
  // a thread (after the barrier that follows their writes).
  __device__ void push_stats() const {
    for (int p = threadIdx.x; p < gn * cluster; p += kDecodeThreads) {
      const int g = p / cluster, r = p % cluster;
      cg::this_cluster().map_shared_rank(rm(), r)[g * kDecodeMaxCluster + rank] = m_s[g];
      cg::this_cluster().map_shared_rank(rl(), r)[g * kDecodeMaxCluster + rank] = l_s[g];
    }
  }
};

// Wait for tile t's stage, run ``math(kt, vt, nk)`` on it, release it, and
// refill it with the tile a ring's depth ahead.
template <typename T, int D, typename Math, typename Issue>
__device__ __forceinline__ void decode_tiles(const DecodeBlock<T>& k, Math math, Issue issue) {
  constexpr int TK = decode_tile_keys<T>();
  const int stage_elems = TK * (D + k.dc);
  for (int t = 0; t < k.ntiles; ++t) {
    const int s = t % k.stages;
    const int nk = min(TK, k.L - (k.first + t * TK));
    decode_wait(k.full + s, (t / k.stages) & 1);
    const T* kt = reinterpret_cast<const T*>(k.base) + s * stage_elems;
    if constexpr (!kDecodeNoMath) math(kt, kt + TK * D, nk);
    if (threadIdx.x % 32 == 0) sm90::mbar_arrive(k.empty + s);  // this warp is done with it
    if (threadIdx.x == 0 && t + k.stages < k.ntiles) {
      decode_wait(k.empty + s, (t / k.stages) & 1);
      issue(t + k.stages);
    }
  }
}

// Head g's warps in the block merge: warps w0 .. w0 + n - 1, whose stats
// of the head sit at index ``slot`` of their rows of wm and wl.
struct DecodeWarps {
  int w0, n, slot;
};

// The block's merge of its warps' partials, after the barrier that
// publishes their m and l (in log2 units where kLog2, else natural ones):
// each head's weights over its warps (``warps(g)``), exp(m - M) for a warp
// with l > 0 and exactly 0 otherwise, in place of the warps' m; the
// block's m and l; then each (head, 4 columns) item, the warps' partials
// (``part(w, g, col)``) summed in warp order by their weights, written
// as the output (a cluster of one) or pushed to the rank whose share
// holds it, once every rank of the cluster has started.
template <int D, bool kLog2, typename T, typename Warps, typename Part>
__device__ __forceinline__ void decode_block_merge(const DecodeBlock<T>& k, Warps warps,
                                                   Part part) {
  if (threadIdx.x < k.gn) {
    const int g = threadIdx.x;
    const DecodeWarps hw = warps(g);
    float M = kNegInf, tot = 0.f;
    for (int w = hw.w0; w < hw.w0 + hw.n; ++w) {
      if (k.wl[w * kDecodeHeads + hw.slot] > 0.f) M = fmaxf(M, k.wm[w * kDecodeHeads + hw.slot]);
    }
    for (int w = hw.w0; w < hw.w0 + hw.n; ++w) {
      const float lw = k.wl[w * kDecodeHeads + hw.slot];
      const float d = k.wm[w * kDecodeHeads + hw.slot] - M;
      const float x = lw > 0.f ? (kLog2 ? exp2f(d) : expf(d)) : 0.f;
      k.wm[w * kDecodeHeads + hw.slot] = x;
      tot += x * lw;
    }
    k.m_s[g] = kLog2 ? M * 0.6931471805599453f : M;  // natural units, as the ranks' merge takes them
    k.l_s[g] = tot;
  }
  __syncthreads();
  if (!k.direct) sm90::cluster_wait();  // the arrival is at the kernel's entry
  const int quads = k.dc / 4;
  for (int p = threadIdx.x; p < k.gn * quads; p += kDecodeThreads) {
    const int g = p / quads, col = (p % quads) * 4;
    const DecodeWarps hw = warps(g);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = hw.w0; w < hw.w0 + hw.n; ++w) {
      const float x = k.wm[w * kDecodeHeads + hw.slot];
      if (x == 0.f) continue;  // a warp without keys: never multiplied
      const float4 r = part(w, g, col);
      a.x += x * r.x; a.y += x * r.y; a.z += x * r.z; a.w += x * r.w;
    }
    if (k.direct) {
      const float denom = k.l_s[g] == 0.f ? 1.f : k.l_s[g];
      store4(k.ob + g * D + k.c0 + col,
             make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
    } else {
      k.push(p, k.gn * quads, a);
    }
  }
}

// The bf16 path, on the tensor cores (mma.sync m16n8k16, float32
// accumulators).  Warp w takes keys 16 (w % 4) .. + 15 of every tile and
// output columns of half w / 4 of the slice: S = Q.K^T with the block's
// (up to) 8 heads as rows 0..7 of the A operand (q in registers), K by
// ldmatrix from its swizzled tile; the warp's online softmax over its 16
// keys in float32 (a head's row in the 4 lanes of a quad); P as a bf16
// rounding and its bf16 remainder, rows 0..7 and 8..15 of the A operand
// of O += P.V (the accumulator fragment of S is the A fragment, as in the
// flash forward), V by ldmatrix.trans.  The bf16 x bf16 products are
// exact and every sum is float32.
template <int D, typename Issue>
__device__ __forceinline__ void decode_mma(const DecodeBlock<bf16>& k, Issue issue) {
  constexpr int TK = decode_tile_keys<bf16>();
  constexpr int kSpanK = decode_span(D);
  constexpr int kNvt = D / 16;  // n-tiles of 8 columns a warp at most
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kgp = warp % 4, ch = warp / 4;
  const int gr = lane / 4, t4 = lane % 4;
  const int dc = k.dc, half = dc / 2, nvt = half / 8;
  const int span_v = decode_span(dc);
  const int r0 = 16 * kgp;  // the warp's first key in a tile
  uint32_t qa[D / 16][2];   // A fragments of q: row gr, columns 2 t4 (+ 8)
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* qr = k.qg + gr * D + 16 * ks + 2 * t4;
    qa[ks][0] = gr < k.gn ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
    qa[ks][1] = gr < k.gn ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
  }
  __syncthreads();  // the barriers are initialised
  float o[kNvt][4];
#pragma unroll
  for (int j = 0; j < kNvt; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run = kNegInf, l_run = 0.f;  // head gr's, over the warp's keys, in log2 units
  const float scale_log2 = k.scale * 1.4426950408889634f;
  // the lane's ldmatrix rows (K's for S, V's for P.V) and, V's swizzle
  // span being the launch's, V's addresses in a stage
  const int mi = lane / 8;
  const int rr = r0 + 8 * (mi / 2) + lane % 8, vr = r0 + 8 * (mi % 2) + lane % 8;
  int vofs[(kNvt + 1) / 2];
#pragma unroll
  for (int j = 0; j < kNvt; j += 2) vofs[j / 2] = swz<TK>(vr, (ch * half + 8 * j) / 8 + mi / 2, span_v, dc);

  decode_tiles<bf16, D>(k, [&](const bf16* kt, const bf16* vt, int nk) {
    // S for the warp's two n-tiles of 8 keys
    // (odd k-steps into a second pair of accumulators: two chains of
    // dependent products, not one)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float sd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t b[4];
      ldmatrix_x4(b, kt + swz<TK>(rr, 2 * ks + mi % 2, kSpanK, D));
      const uint32_t a[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
      mma_bf16(ks % 2 ? sd[0] : sc[0], a, b[0], b[1]);
      mma_bf16(ks % 2 ? sd[1] : sc[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[0][i] += sd[0][i];
      sc[1][i] += sd[1][i];
    }
    // the warp's online softmax of head gr over its 16 keys
    float s4[4], mx = kNegInf;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = r0 + 8 * (i / 2) + 2 * t4 + i % 2;
      s4[i] = key < nk && gr < k.gn ? sc[i / 2][i % 2] * scale_log2 : kNegInf;
      mx = fmaxf(mx, s4[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s4[i] = s4[i] > kNegInf ? exp2f(s4[i] - m_new) : 0.f;
      ps += s4[i];
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    const float alpha = exp2f(m_run - m_new);
    l_run = alpha * l_run + ps;
    m_run = m_new;
    // P as two bf16 parts: its rounding in rows 0..7 of A (the heads) and
    // the rounding of what that leaves in rows 8..15, which would
    // otherwise be zero; rows gr and gr + 8 of O then sum to P.V at about
    // 16 bits of P, for no extra mma
    const uint32_t p01 = pack_bf16(s4[0], s4[1]), p23 = pack_bf16(s4[2], s4[3]);
    const float2 h01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p01));
    const float2 h23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p23));
    const uint32_t pa[4] = {p01, pack_bf16(s4[0] - h01.x, s4[1] - h01.y), p23,
                            pack_bf16(s4[2] - h23.x, s4[3] - h23.y)};
    // slots of the warp's keys past the valid ones may hold anything: P is
    // 0 there, so zero V's rows too (0 x NaN would not be 0)
    if (r0 + 16 > nk) {
      const int nch = half / 8;
      for (int i = lane; i < 16 * nch; i += 32) {
        const int r = r0 + i / nch;
        if (r >= nk) {
          *reinterpret_cast<uint4*>(const_cast<bf16*>(vt) +
                                    swz<TK>(r, ch * nch + i % nch, span_v, dc)) = make_uint4(0, 0, 0, 0);
        }
      }
      sm90::fence_proxy_async();  // before the stage's next TMA write
      __syncwarp();
    }
    // O += P.V over the warp's column half, two n-tiles an ldmatrix
#pragma unroll
    for (int j = 0; j < kNvt; j += 2) {
      if (j < nvt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[j][i] *= alpha;
          if (j + 1 < kNvt) o[j + 1][i] *= alpha;
        }
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + vofs[j / 2]);
        mma_bf16(o[j], pa, b[0], b[1]);
        if (j + 1 < nvt && j + 1 < kNvt) mma_bf16(o[j + 1], pa, b[2], b[3]);
      }
    }
  }, issue);

  // the warps' stats and accumulators: red[warp][head][column of the half]
  if (t4 == 0) {
    k.wm[warp * kDecodeHeads + gr] = m_run;
    k.wl[warp * kDecodeHeads + gr] = l_run;
  }
  __syncthreads();  // the ring is free, the warps' stats are in
  // the warps' accumulators, the two parts of P's rows summed:
  // red[warp][head][column of the half]
  float* red = reinterpret_cast<float*>(k.base);
  if (gr < k.gn) {
#pragma unroll
    for (int j = 0; j < kNvt; ++j) {
      if (j < nvt) {
        *reinterpret_cast<float2*>(red + (warp * kDecodeHeads + gr) * half + 8 * j + 2 * t4) =
            make_float2(o[j][0] + o[j][2], o[j][1] + o[j][3]);
      }
    }
  }
  // a head's weights are over the 4 key groups, which the two column
  // halves share; warp w of the item's half holds key group w
  decode_block_merge<D, true>(
      k, [](int g) { return DecodeWarps{0, 4, g}; },
      [&](int w, int g, int col) {
        return *reinterpret_cast<const float4*>(
            red + (((col / half) * 4 + w) * kDecodeHeads + g) * half + col % half);
      });
}

// The float32 path, on the CUDA cores in float32 (the tensor cores' TF32
// would miss float32's tolerance).  HH: halves of 4 heads (1 for at most
// 4 heads, else 2); the warps of a half split every tile's keys between
// them, each keeping its own online softmax and accumulators.
template <typename T, int D, int HH, typename Issue>
__device__ __forceinline__ void decode_simt(const DecodeBlock<T>& k, Issue issue) {
  constexpr int TK = decode_tile_keys<T>();
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int kLoads = 8 / kVec;      // 16-byte loads a chunk of 8 elements
  constexpr int kNch = D / 8;           // chunks a row of K
  constexpr int kL = decode_key_lanes<D>();
  constexpr int kWarpsH = kDecodeWarps / HH;  // warps a head half
  constexpr int KW = TK / kWarpsH;            // keys a warp a tile (4 to 16)
  constexpr int kNgr = 32 / kL;               // key groups a warp in the score phase
  constexpr int KPG = KW > kNgr ? KW / kNgr : 1;  // keys a group
  constexpr int KB = KPG < 4 ? KPG : 4;           // keys a group scores at once
  constexpr int kV = 4 * KB;                      // values a lane then sums
  constexpr int kKeep = kV > kL ? kV / kL : 1;    // values a lane holds after
  constexpr int kShare = kV < kL ? kL / kV : 1;   // lanes holding the same values
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hh = warp / kWarpsH, kw0 = (warp % kWarpsH) * KW;  // head half, first key
  const int dc = k.dc, nchv = dc / 8;
  float* sw = k.sw + warp * 16 * 4;
  // The score phase: lane kc of a key's kL lanes takes 16-byte chunks kc
  // (and kc + D / 8) of the key's row for the 4 heads of the warp's half;
  // q of those stays in registers.
  const int kc = lane % kL, grp = lane / kL;
  float qv[4][8];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int g = hh * 4 + h;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      float f[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
      if (g < k.gn && kc < kNch) load16(k.qg + g * D + (kc + i * kNch) * kVec, f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) qv[h][i * kVec + e] = f[e];
    }
  }
  __syncthreads();  // the barriers are initialised
  // The P.V phase: lane (vc, kg) owns 8 columns (16-byte chunks vc and
  // vc + dc / 8 of the slice) of the half's 4 heads over key group kg of
  // the warp's keys.
  const int kgs = 32 / nchv;  // key groups
  const int vc = lane % nchv, kg = lane / nchv;
  float acc[4][8];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;
  }
  const int sh = lane % 4, skk = lane / 4;  // softmax lane: head, key slot
  const bool head_on = hh * 4 + sh < k.gn;
  float m_run = kNegInf, l_run = 0.f;

  decode_tiles<T, D>(k, [&](const T* kt, const T* vt, int nk) {
    // scores of the warp's keys, scaled, into sw[key][head]
#pragma unroll
    for (int k0 = 0; k0 < KPG; k0 += KB) {
      float sv[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) sv[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const int kl = grp * KPG + k0 + kk;  // the key in the warp's share
        if (kl < KW && kw0 + kl < nk && kc < kNch) {
#pragma unroll
          for (int i = 0; i < kLoads; ++i) {
            float kf[kVec];
            load16(kt + (kw0 + kl) * D + (kc + i * kNch) * kVec, kf);
#pragma unroll
            for (int h = 0; h < 4; ++h) {
#pragma unroll
              for (int e = 0; e < kVec; ++e) sv[kk * 4 + h] += qv[h][i * kVec + e] * kf[e];
            }
          }
        }
      }
      const int vb = reduce_scatter<kV, kL>(sv, kc);
      if (kc % kShare == 0) {
#pragma unroll
        for (int i = 0; i < kKeep; ++i) {
          const int f = vb + i, kl = grp * KPG + k0 + f / 4;
          if (kl < KW) sw[kl * 4 + f % 4] = sv[i] * k.scale;
        }
      }
    }
    __syncwarp();

    // the warp's online softmax: lane (sh, skk) takes keys skk, skk + 8 of
    // head sh
    float sc[(KW + 7) / 8], mx = kNegInf;
#pragma unroll
    for (int m = 0; m < (KW + 7) / 8; ++m) {
      const int kl = skk + 8 * m;
      const bool on = head_on && kl < KW && kw0 + kl < nk;
      sc[m] = on ? sw[kl * 4 + sh] : kNegInf;
      mx = fmaxf(mx, sc[m]);
    }
#pragma unroll
    for (int off = 4; off < 32; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);
    float ps = 0.f;
#pragma unroll
    for (int m = 0; m < (KW + 7) / 8; ++m) {
      const int kl = skk + 8 * m;
      if (kl < KW) {
        const float p = sc[m] > kNegInf ? expf(sc[m] - m_new) : 0.f;
        sw[kl * 4 + sh] = p;
        ps += p;
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off *= 2) ps += __shfl_xor_sync(0xffffffffu, ps, off);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + ps;
    m_run = m_new;
    float al[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) al[h] = __shfl_sync(0xffffffffu, alpha, h);
    __syncwarp();

    // acc = alpha acc + P.V over the lane's key group
#pragma unroll
    for (int h = 0; h < 4; ++h) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[h][e] *= al[h];
    }
    if (kg < kgs) {
      for (int kl = kg; kl < KW && kw0 + kl < nk; kl += kgs) {
        const float4 p4 = *reinterpret_cast<const float4*>(sw + kl * 4);
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          float vf[kVec];
          load16(vt + (kw0 + kl) * dc + (vc + i * nchv) * kVec, vf);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[0][i * kVec + e] += p4.x * vf[e];
            acc[1][i * kVec + e] += p4.y * vf[e];
            acc[2][i * kVec + e] += p4.z * vf[e];
            acc[3][i * kVec + e] += p4.w * vf[e];
          }
        }
      }
    }
    __syncwarp();  // sw is read
  }, issue);

  if (skk == 0) {
    k.wm[warp * kDecodeHeads + sh] = m_run;
    k.wl[warp * kDecodeHeads + sh] = l_run;
  }
  __syncthreads();  // the ring is free, the warps' stats are in
  // the warps' accumulators: red[warp][lane][head * 8 + column]
  float* red = reinterpret_cast<float*>(k.base);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      *reinterpret_cast<float4*>(red + (warp * 32 + lane) * 32 + h * 8 + e) =
          make_float4(acc[h][e], acc[h][e + 1], acc[h][e + 2], acc[h][e + 3]);
    }
  }
  // a head's weights are over the warps of its half; a warp's partial of
  // 4 columns is its key groups' summed in order
  decode_block_merge<D, false>(
      k, [&](int g) { return DecodeWarps{(g / 4) * kWarpsH, kWarpsH, g % 4}; },
      [&](int w, int g, int col) {
        const int ci = col / kVec;  // the columns' 16-byte chunk in the slice
        const int cvc = ci % nchv, e = (ci / nchv) * kVec + col % kVec;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int kk = 0; kk < kgs; ++kk) {
          const float4 r = *reinterpret_cast<const float4*>(
              red + (w * 32 + kk * nchv + cvc) * 32 + (g % 4) * 8 + e);
          a.x += r.x; a.y += r.y; a.z += r.z; a.w += r.w;
        }
        return a;
      });
}

// HH: the float32 path's halves of 4 heads (1 in bf16).
template <typename T, int D, int HH>
__global__ void __launch_bounds__(kDecodeThreads, 2)
decode_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const T* __restrict__ q, const int* __restrict__ lens, T* __restrict__ o, int H,
              int KV, int S, int cluster, int ncs, int hc, int nchunk, int stages, float scale,
              int window) {
  using namespace sm90;
  constexpr bool kMma = std::is_same_v<T, bf16>;
  constexpr int TK = decode_tile_keys<T>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = blockIdx.x % cluster, cs = blockIdx.x / cluster;
  const int dc = D / ncs, c0 = cs * dc;  // this block's output columns
  const int kvh = blockIdx.y / nchunk, gc = blockIdx.y % nchunk;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int g0 = gc * hc, gn = min(hc, G - g0);
  const DecodeLayout ly = decode_layout<T, D>(dc, stages);
  T* ring = reinterpret_cast<T*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ly.bars);
  uint64_t* empty_bar = full + stages;
  const int stage_elems = TK * (D + dc);
  const size_t qo = (static_cast<size_t>(b) * H + kvh * G + g0) * D;

  if (tid == 0) {
    tma_prefetch_map(&tm_k);
    tma_prefetch_map(&tm_v);
  }
  // this rank's share of the tiles over the valid slots [start, L)
  const int L = min(max(lens[b], 0), S);
  const int start = window > 0 ? max(0, L - window) : 0;
  const int T_all = (L - start + TK - 1) / TK;
  const int t_lo = T_all * rank / cluster;
  const int ntiles = T_all * (rank + 1) / cluster - t_lo;
  const int slab = b * KV + kvh;
  // a tile is copied in boxes: bf16 as swizzled column blocks (K's
  // blocks, then V's), float32 as dense rows (K, then V)
  constexpr int kAtomK = kMma && decode_span(D) ? decode_span(D) / 2 : D;
  const int atom_v = kMma && decode_span(dc) ? decode_span(dc) / 2 : dc;
  const int nbox = D / kAtomK + dc / atom_v;
  const uint32_t tile_bytes = stage_elems * static_cast<uint32_t>(sizeof(T));
  // box bx of tile t of the share into stage t % stages
  auto box = [&](int t, int bx) {
    const int s = t % stages;
    T* kd = ring + s * stage_elems;
    const int row = start + (t_lo + t) * TK;
    if (bx < D / kAtomK) {
      tma_load_3d(kd + bx * TK * kAtomK, &tm_k, full + s, bx * kAtomK, row, slab);
    } else {
      const int cb = bx - D / kAtomK;
      tma_load_3d(kd + TK * D + cb * TK * atom_v, &tm_v, full + s, c0 + cb * atom_v, row, slab);
    }
  };
  // tile t whole, by the one thread that refills the ring
  auto issue = [&](int t) {
    mbar_arrive_expect_tx(full + t % stages, tile_bytes);
    for (int bx = 0; bx < nbox; ++bx) box(t, bx);
  };
  // warp 0 sets the barriers up and puts the share's first tiles in
  // flight at once, a box a lane, before the block's first barrier
  if (warp == 0) {
    const int n0 = min(stages, ntiles);
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty_bar + s, kDecodeWarps);  // lane 0 of every warp
      }
      mbar_init_fence();
      for (int t = 0; t < n0; ++t) mbar_arrive_expect_tx(full + t, tile_bytes);
    }
    __syncwarp();
    for (int i = lane; i < n0 * nbox; i += 32) box(i / nbox, i % nbox);
  }
  // a block may write a rank's shared memory only once that rank has
  // started: every thread arrives here, and waits before its first push
  // (decode_block_merge)
  const bool direct = cluster == 1 || kDecodeNoMerge;
  if (!direct) cluster_arrive_relaxed();

  const DecodeBlock<T> blk{base,
                           full,
                           empty_bar,
                           reinterpret_cast<float*>(base + ly.wst),
                           reinterpret_cast<float*>(base + ly.wst) + kDecodeWarps * kDecodeHeads,
                           reinterpret_cast<float*>(base + ly.stats),
                           reinterpret_cast<float*>(base + ly.stats) + kDecodeHeads,
                           reinterpret_cast<float4*>(base + ly.rx),
                           reinterpret_cast<float*>(base + ly.sw),
                           q + qo,
                           o + qo,
                           gn,
                           dc,
                           c0,
                           stages,
                           ntiles,
                           start + t_lo * TK,
                           L,
                           rank,
                           cluster,
                           scale,
                           direct};
  if constexpr (kMma) {
    decode_mma<D>(blk, issue);
  } else {
    decode_simt<T, D, HH>(blk, issue);
  }
  if (blk.direct) return;
  blk.push_stats();

  // every rank has pushed its partials of this rank's share and its
  // stats into this block's shared memory: the one cluster barrier
  cg::this_cluster().sync();

  // every head's weights over the ranks, a warp a head: exp(m - M) for a
  // rank with l > 0, exactly 0 for an empty one
  const int quads = dc / 4, n_items = gn * quads;
  const int i_lo = blk.item_lo(n_items, rank);
  const int nr = blk.item_lo(n_items, rank + 1) - i_lo;
  float* cw = reinterpret_cast<float*>(base);  // [head][rank]
  float* ctot = cw + kDecodeHeads * cluster;   // [head]
  const int g_lo = i_lo / quads, g_hi = nr > 0 ? (i_lo + nr - 1) / quads : g_lo - 1;
  for (int g = g_lo + warp; g <= g_hi; g += kDecodeWarps) {
    float m = kNegInf, l = 0.f;
    if (lane < cluster) {
      m = blk.rm()[g * kDecodeMaxCluster + lane];
      l = blk.rl()[g * kDecodeMaxCluster + lane];
    }
    const float M = warp_max(l > 0.f ? m : kNegInf);
    const float w = l > 0.f ? expf(m - M) : 0.f;
    const float tot = warp_sum(w * l);
    if (lane < cluster) cw[g * cluster + lane] = w;
    if (lane == 0) ctot[g] = tot;
  }
  __syncthreads();
  // this rank's share of the items, summed over ranks 0.. in rank order
  for (int li = tid; li < nr; li += kDecodeThreads) {
    const int item = i_lo + li, g = item / quads;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sr = 0; sr < cluster; ++sr) {
      // an empty rank's partial is never multiplied
      const float w = cw[g * cluster + sr];
      if (w == 0.f) continue;
      const float4 x = blk.rx[li * cluster + sr];
      a.x += w * x.x; a.y += w * x.y; a.z += w * x.z; a.w += w * x.w;
    }
    const float denom = ctot[g] == 0.f ? 1.f : ctot[g];
    store4(blk.ob + g * D + c0 + (item % quads) * 4,
           make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
  }
}

// The K and V maps of a launch, (B KV, S, D) in boxes of a tile: K's whole
// rows and V's column slice, bf16 as swizzled column blocks (ldmatrix
// reads 8 rows at a chunk), float32 as dense rows (its lanes read along a
// row).
template <typename T, int D>
int encode_decode_maps(CUtensorMap* maps, const void* kc, const void* vc, int B, int KV, int S,
                       int dc) {
  constexpr int TK = decode_tile_keys<T>();
  if constexpr (std::is_same_v<T, bf16>) {
    const int sk = decode_span(D), sv = decode_span(dc);
    int st = encode_tile_map<T>(maps, kc, B * KV, S, D, TK, sk ? sk / 2 : D, sk);
    if (!st) st = encode_tile_map<T>(maps + 1, vc, B * KV, S, D, TK, sv ? sv / 2 : dc, sv);
    return st;
  } else {
    int st = encode_tile_map<T>(maps, kc, B * KV, S, D, TK, D, 0);
    if (!st) st = encode_tile_map<T>(maps + 1, vc, B * KV, S, D, TK, dc, 0);
    return st;
  }
}

template <typename T, int D>
using DecodeKernel = decltype(&decode_kernel<T, D, 1>);

// The instantiation for a head chunk of hc heads: bf16 takes up to 8 on
// the tensor cores; float32 one half of 4, or two.
template <typename T, int D>
DecodeKernel<T, D> decode_kernel_for(int hc) {
  if constexpr (std::is_same_v<T, bf16>) {
    return decode_kernel<T, D, 1>;
  } else {
    return hc > 4 ? decode_kernel<T, D, 2> : decode_kernel<T, D, 1>;
  }
}

// The kernel with its shared memory allowed (and, past 8, the non-portable
// cluster size); 0 or the error.
template <typename K>
int prepare_decode(K kernel, size_t smem, int cluster) {
  int st = allow_smem(kernel, smem);
  if (!st && cluster > 8) {
    st = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  }
  return st;
}

template <typename T, int D>
bool decode_args_ok(int G, int cluster, int ncs, int hc, int stages) {
  const int nchunk = hc < 1 ? 0 : (G + hc - 1) / hc;
  return cluster >= 1 && cluster <= kDecodeMaxCluster && stages >= 1 &&
         stages <= kDecodeMaxStages && hc >= 1 && hc <= kDecodeHeads &&
         (nchunk - 1) * hc < G && ncs >= 1 && D % ncs == 0 &&
         (D / ncs) % (std::is_same_v<T, bf16> ? 16 : 8) == 0;
}

template <typename T, int D>
int launch_decode(const void* q, const void* kc, const void* vc, const int* lens, void* o,
                  int B, int H, int KV, int S, int cluster, int ncs, int hc, int stages,
                  float scale, int window, cudaStream_t s) {
  const int G = H / KV;
  if (!decode_args_ok<T, D>(G, cluster, ncs, hc, stages)) return kStatusBadArgs;
  const int nchunk = (G + hc - 1) / hc;
  const int dc = D / ncs;
  CUtensorMap maps[2];
  int st = encode_decode_maps<T, D>(maps, kc, vc, B, KV, S, dc);
  const size_t smem = decode_layout<T, D>(dc, stages).bytes;
  const auto kernel = decode_kernel_for<T, D>(hc);
  if (!st) st = prepare_decode(kernel, smem, cluster);
  if (st) return st;
  const dim3 grid(cluster * ncs, KV * nchunk, B);
  const T* qp = static_cast<const T*>(q);
  T* op = static_cast<T*>(o);
  if (cluster == 1) {
    kernel<<<grid, kDecodeThreads, smem, s>>>(maps[0], maps[1], qp, lens, op, H, KV, S, 1, ncs,
                                               hc, nchunk, stages, scale, window);
    return launch_status();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  st = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], qp, lens, op, H, KV,
                                           S, cluster, ncs, hc, nchunk, stages, scale, window));
  return st ? st : launch_status();
}

// How many clusters of ``cluster`` blocks of this plan the card holds at
// once (cudaOccupancyMaxActiveClusters), into *out.
template <typename T, int D>
int decode_max_clusters(int G, int cluster, int ncs, int hc, int stages, int* out) {
  if (!decode_args_ok<T, D>(G, cluster, ncs, hc, stages)) return kStatusBadArgs;
  const size_t smem = decode_layout<T, D>(D / ncs, stages).bytes;
  const auto kernel = decode_kernel_for<T, D>(hc);
  int st = prepare_decode(kernel, smem, cluster);
  if (st) return st;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

// Launch the instantiation for head dimension D; an unlisted D launches
// nothing and returns kStatusBadHeadDim.
template <typename T>
int dispatch_decode(int D, const void* q, const void* kc, const void* vc, const int* lens,
                    void* o, int B, int H, int KV, int S, int cluster, int ncs, int hc,
                    int stages, float scale, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch_decode<T, 16>(q, kc, vc, lens, o, B, H, KV, S, cluster, ncs, hc, stages, scale, window, s);
    case 32: return launch_decode<T, 32>(q, kc, vc, lens, o, B, H, KV, S, cluster, ncs, hc, stages, scale, window, s);
    case 64: return launch_decode<T, 64>(q, kc, vc, lens, o, B, H, KV, S, cluster, ncs, hc, stages, scale, window, s);
    case 80: return launch_decode<T, 80>(q, kc, vc, lens, o, B, H, KV, S, cluster, ncs, hc, stages, scale, window, s);
    case 128: return launch_decode<T, 128>(q, kc, vc, lens, o, B, H, KV, S, cluster, ncs, hc, stages, scale, window, s);
    default: return kStatusBadHeadDim;
  }
}

template <typename T>
int occupancy_by_dim(int D, int G, int cluster, int ncs, int hc, int stages, int* out) {
  switch (D) {
    case 16: return decode_max_clusters<T, 16>(G, cluster, ncs, hc, stages, out);
    case 32: return decode_max_clusters<T, 32>(G, cluster, ncs, hc, stages, out);
    case 64: return decode_max_clusters<T, 64>(G, cluster, ncs, hc, stages, out);
    case 80: return decode_max_clusters<T, 80>(G, cluster, ncs, hc, stages, out);
    case 128: return decode_max_clusters<T, 128>(G, cluster, ncs, hc, stages, out);
    default: return kStatusBadHeadDim;
  }
}

}  // namespace repro

extern "C" int repro_decode_attention(const void* q, const void* kc, const void* vc,
                                      const void* lens, void* o, int B, int H, int KV, int S,
                                      int D, int cluster, int ncs, int hc, int stages,
                                      float scale, int window, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == kDtypeBF16) {
    return dispatch_decode<__nv_bfloat16>(D, q, kc, vc, ln, o, B, H, KV, S, cluster, ncs, hc, stages, scale, window, s);
  }
  return dispatch_decode<float>(D, q, kc, vc, ln, o, B, H, KV, S, cluster, ncs, hc, stages, scale, window, s);
}

// Clusters of a plan the card holds at once, for the plan rule; G is the
// query heads a kv head.
extern "C" int repro_decode_max_clusters(int D, int G, int cluster, int ncs, int hc,
                                         int stages, int dtype, int* out) {
  using namespace repro;
  if (dtype == kDtypeBF16) {
    return occupancy_by_dim<__nv_bfloat16>(D, G, cluster, ncs, hc, stages, out);
  }
  return occupancy_by_dim<float>(D, G, cluster, ncs, hc, stages, out);
}
