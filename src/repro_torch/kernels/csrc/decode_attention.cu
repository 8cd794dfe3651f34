// One-token decode attention over a KV cache for Hopper: split-K
// flash-decode, merged in the same launch.
//
// Replaces repro/kernels/decode_attention.py::_decode_kernel (Pallas grid
// (B, KV, k blocks), all G query heads of one kv head per program, online
// softmax in VMEM scratch across the sequential k axis).  Sequence b sees
// slots [max(0, L - window), L) with L = lens[b] (window 0: [0, L)); any
// cache length works (the Pallas version asserts S % block_k == 0).
//
// What bounds it: bytes.  A step reads L x D x 2 values per kv head (230
// KB at L = 449, D = 128 in bf16) and does about G operations a byte of K
// and V (8 for Yi-9B, 1 for Zamba2) against the ~295 at which the tensor
// cores would become the limit, so the products stay on the CUDA cores in
// float32.  At batch 1 the cache of one kv head is too small a job for one
// block: one block per (batch, kv head) ran 4 blocks (Yi-9B) or 32 blocks of
// one warp (Zamba2) on 132 SMs.
//
// The design spreads the cache over the card instead:
// - The grid is (splits x column slices, KV x head chunks, B).  Split i
//   owns the slots [i span, (i + 1) span); column slice c owns 1/slices of
//   the output columns.  A block takes the G query heads of its kv head (at
//   most kDecodeHeads; a larger G is cut into head chunks), so every key it
//   loads serves all of them, as in repro's kernel.  The wrapper picks the
//   plan from the shapes and the number of SMs (never from the lengths,
//   which lie on the device): spans of one staged tile, and the most
//   column slices that keep the grid within one wave (Yi-9B at batch 1: 8
//   splits x 4 slices x 4 kv heads = 128 blocks; Zamba2: 8 splits x 32 kv
//   heads, no slices).  Slices cost each block the scores of its whole
//   span again, and buy smaller merges that run side by side.  On an H100
//   at Yi-9B's shape the plans of 144 and 256 blocks read about 1.5 us
//   slower than those of 64-136 blocks (chip_smoke.py times every plan
//   the rule weighs).
// - A block stages its keys (and its slice of the values) in tiles by
//   cp.async, 16 bytes a thread with neighbouring threads on neighbouring
//   addresses, double buffered, in the cache's own dtype (rows padded by
//   16 bytes: no bank conflicts).  All eight warps share each tile for every
//   G, G = 1 included: scores are spread over (head, key) pairs, the
//   softmax over a warp per head, and P.V over (head, 4 columns) items and,
//   when those are fewer than the threads, over key groups too.
// - Each split writes its partial (m, l, acc[G, columns]) in float32 to a
//   workspace; a split outside [max(0, L - window), L) writes m = kNegInf,
//   l = 0 and no acc.  The last block of a (batch, kv head, head chunk,
//   slice) to arrive (a barrier, then an acquire-release atomicAdd on a
//   counter) merges the partials by their log-sum-exp weights, an empty
//   split with weight exactly 0, writes the output and resets the counter
//   to 0 for the next launch (CUDA-graph replays included).  A second merge
//   kernel would cost a launch a layer a step on a path whose pace the
//   host sets.
//
// Float32 caches take the same kernel: every product and sum is float32
// either way, so the float32 path is exact to float32 rounding.

#include <algorithm>

#include "common.cuh"

namespace repro {

constexpr int kDecodeThreads = 256;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeHeads = 32;      // query heads a block (a head chunk)
constexpr int kDecodeMaxSplits = 64;  // splits of the cache axis at most
constexpr int kMergeBatch = 16;       // splits a merging thread loads at once

// Floats of one split's partial: m and l of each head (padded to 16
// bytes), then acc[head][columns of the slice].
__host__ __device__ inline int decode_header(int hc) { return (2 * hc + 3) / 4 * 4; }
__host__ __device__ inline int decode_partial(int hc, int D) {
  return decode_header(hc) + hc * D;
}

// Keys of one staged tile at most: 128 bytes a column (64 bf16, 32 f32).
template <typename T> __host__ __device__ constexpr int decode_tile_keys() {
  return 128 / static_cast<int>(sizeof(T));
}

// Bytes at the start of shared memory, a multiple of 16: the K/V double
// buffer, reused after the tile loop for the key groups' sums and the
// merge's weights.
template <typename T, int D>
__host__ __device__ inline size_t decode_region_bytes(int tk, int hc, int nsplit) {
  constexpr int kPitch = D + 16 / sizeof(T);
  const size_t kv = 4ull * tk * kPitch * sizeof(T);
  const size_t merge = (2ull * hc * nsplit + hc) * sizeof(float);
  const size_t red = kDecodeThreads * 4 * sizeof(float);
  const size_t most = kv > merge ? (kv > red ? kv : red) : (merge > red ? merge : red);
  return (most + 15) / 16 * 16;
}

template <typename T, int D>
size_t decode_smem_bytes(int tk, int hc, int nsplit) {
  return decode_region_bytes<T, D>(tk, hc, nsplit) +
         (static_cast<size_t>(hc) * D + hc * tk + 3 * hc) * sizeof(float);
}

// Eight (bf16) or four (f32) elements of one 16-byte shared-memory load.
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

// Four consecutive elements as float32.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel_split(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ lens,
                    T* __restrict__ o, float* __restrict__ ws,
                    int* __restrict__ counters, int H, int KV, int S, int span,
                    int nsplit, int ncs, int tk, int hc, int nchunk,
                    float scale, int window) {
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int kPitch = D + kVec;      // padded shared row
  constexpr int kChunks = D / kVec;     // 16-byte copies a row
  constexpr int kItems = (kDecodeHeads * (D / 4) + kDecodeThreads - 1) / kDecodeThreads;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kbuf = reinterpret_cast<T*>(smem_raw);  // [2][tk][kPitch]
  T* vbuf = kbuf + 2 * tk * kPitch;          // [2][tk][kPitch]
  float* region = reinterpret_cast<float*>(smem_raw);
  float* qs = reinterpret_cast<float*>(
      smem_raw + decode_region_bytes<T, D>(tk, hc, nsplit));  // [hc][D]
  float* ss = qs + hc * D;     // [hc][tk] scores, then probabilities
  float* m_s = ss + hc * tk;   // [hc] running max
  float* l_s = m_s + hc;       // [hc] running sum
  float* a_s = l_s + hc;       // [hc] this tile's rescale factor
  __shared__ int last_block;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x / ncs, cs = blockIdx.x % ncs;
  const int dc = D / ncs, c0 = cs * dc;  // this block's output columns
  const int quads = dc / 4;              // 4-column items of a head's row
  const int kvh = blockIdx.y / nchunk, gc = blockIdx.y % nchunk;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int g0 = gc * hc, gn = min(hc, G - g0);
  const int slot = ((b * KV + kvh) * nchunk + gc) * ncs + cs;
  // q's 16-byte chunks into registers first: their latency overlaps the
  // lengths' and, below, the first tile's copies
  constexpr int kQRegs = (kDecodeHeads * kChunks + kDecodeThreads - 1) / kDecodeThreads;
  const size_t qo = (static_cast<size_t>(b) * H + kvh * G + g0) * D;
  uint4 qraw[kQRegs];
#pragma unroll
  for (int r = 0; r < kQRegs; ++r) {
    const int i = tid + r * kDecodeThreads;
    if (i < gn * kChunks) qraw[r] = *reinterpret_cast<const uint4*>(q + qo + i * kVec);
  }
  const int L = min(max(lens[b], 0), S);
  const int start = window > 0 ? max(0, L - window) : 0;
  const int k_lo = max(start, split * span);
  const int k_hi = min(L, split * span + span);
  const bool empty = k_lo >= k_hi;
  const T* kb = kc + static_cast<size_t>(b * KV + kvh) * S * D;
  const T* vb = vc + static_cast<size_t>(b * KV + kvh) * S * D;
  const int pf = decode_partial(hc, dc), hdr = decode_header(hc);
  float* part = ws + (static_cast<size_t>(slot) * nsplit + split) * pf;

  // P.V items (head, 4 of the block's columns); fewer items than threads
  // share the keys out over kg key groups, summed after the tile loop.
  const int n_items = gn * quads;
  const int kg = n_items >= kDecodeThreads ? 1 : kDecodeThreads / n_items;
  const int my_group = kg == 1 ? 0 : tid / n_items;
  float acc[kItems][4];
#pragma unroll
  for (int r = 0; r < kItems; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int g = tid; g < gn; g += kDecodeThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  auto load_tile = [&](int k0, int stage) {
    const int nk = min(tk, k_hi - k0);
    T* kd = kbuf + stage * tk * kPitch;
    T* vd = vbuf + stage * tk * kPitch;
    for (int i = tid; i < nk * kChunks; i += kDecodeThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      cp_async16(kd + r * kPitch + c * kVec, kb + static_cast<size_t>(k0 + r) * D + c * kVec);
    }
    const int vchunks = dc / kVec;
    for (int i = tid; i < nk * vchunks; i += kDecodeThreads) {
      const int r = i / vchunks, c = i - r * vchunks;
      cp_async16(vd + r * kPitch + c * kVec,
                 vb + static_cast<size_t>(k0 + r) * D + c0 + c * kVec);
    }
    cp_async_commit();
  };

  const int ntiles = empty ? 0 : (k_hi - k_lo + tk - 1) / tk;
  if (ntiles > 0) {
    load_tile(k_lo, 0);
#pragma unroll
    for (int r = 0; r < kQRegs; ++r) {
      const int i = tid + r * kDecodeThreads;
      if (i >= gn * kChunks) continue;
      float f[kVec];
      load16(reinterpret_cast<const T*>(&qraw[r]), f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) qs[i * kVec + e] = f[e];
    }
  }
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_lo + t * tk, nk = min(tk, k_hi - k0), st = t & 1;
    if (t + 1 < ntiles) {
      load_tile(k0 + tk, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and, at t = 0, q and the stats) is in
    const T* kt = kbuf + st * tk * kPitch;
    const T* vt = vbuf + st * tk * kPitch;

    // scores of every (head, key) pair of the tile
    for (int p = tid; p < gn * nk; p += kDecodeThreads) {
      const int g = p / nk, j = p - g * nk;
      const float* qr = qs + g * D;
      const T* kr = kt + j * kPitch;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);  // four chains, not one
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float kf[kVec];
        load16(kr + c * kVec, kf);
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + c * kVec + e);
          s.x += qv.x * kf[e];
          s.y += qv.y * kf[e + 1];
          s.z += qv.z * kf[e + 2];
          s.w += qv.w * kf[e + 3];
        }
      }
      ss[g * tk + j] = ((s.x + s.y) + (s.z + s.w)) * scale;
    }
    __syncthreads();

    // online softmax, a warp per head
    for (int g = warp; g < gn; g += kDecodeWarps) {
      float* sr = ss + g * tk;
      float tmax = kNegInf;
      for (int j = lane; j < nk; j += 32) tmax = fmaxf(tmax, sr[j]);
      tmax = warp_max(tmax);
      const float m_old = m_s[g], m_new = fmaxf(m_old, tmax);
      float psum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha acc + P.V over this thread's key group
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int item = kg == 1 ? tid + r * kDecodeThreads : tid % n_items;
      if (item >= n_items || my_group >= kg || (kg > 1 && r > 0)) continue;
      const int g = item / quads, d = (item - g * quads) * 4;
      const float alpha = a_s[g];
      float4 a = make_float4(acc[r][0] * alpha, acc[r][1] * alpha,
                             acc[r][2] * alpha, acc[r][3] * alpha);
      const float* pr = ss + g * tk;
#pragma unroll 4
      for (int j = my_group; j < nk; j += kg) {
        const float p = pr[j];
        const float4 v = load4(vt + j * kPitch + d);
        a.x += p * v.x; a.y += p * v.y; a.z += p * v.z; a.w += p * v.w;
      }
      acc[r][0] = a.x; acc[r][1] = a.y; acc[r][2] = a.z; acc[r][3] = a.w;
    }
    __syncthreads();  // the tile's buffers and probabilities are free
  }

  // sum the key groups: item i ends with thread i (acc[0])
  if (kg > 1 && !empty) {
    if (my_group < kg) {
      float4* red = reinterpret_cast<float4*>(region);
      red[my_group * n_items + tid % n_items] =
          make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    }
    __syncthreads();
    if (tid < n_items) {
      const float4* red = reinterpret_cast<const float4*>(region);
      float4 a = red[tid];
      for (int grp = 1; grp < kg; ++grp) {
        const float4 x = red[grp * n_items + tid];
        a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      }
      acc[0][0] = a.x; acc[0][1] = a.y; acc[0][2] = a.z; acc[0][3] = a.w;
    }
  }
  __syncthreads();  // stats final; region free

  if (nsplit == 1) {  // the whole cache in one block: no partials
    T* ob = o + qo;
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int item = tid + r * kDecodeThreads;
      if (item >= n_items) continue;
      const int g = item / quads, d = c0 + (item - g * quads) * 4;
      const float denom = l_s[g] == 0.f ? 1.f : l_s[g];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ob[g * D + d + e] = from_f32<T>(empty ? 0.f : acc[r][e] / denom);
      }
    }
    return;
  }

  for (int g = tid; g < gn; g += kDecodeThreads) {
    part[g] = m_s[g];
    part[hc + g] = l_s[g];
  }
  if (!empty) {
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int item = tid + r * kDecodeThreads;
      if (item < n_items) {
        reinterpret_cast<float4*>(part + hdr)[item] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
  }
  // arrive: the barrier orders the block's writes before thread 0's
  // release, and its acquire (with the barrier after it) orders every
  // other split's partial before the last block's reads
  __syncthreads();
  if (tid == 0) last_block = arrive_acq_rel(counters + slot) == nsplit - 1;
  __syncthreads();
  if (!last_block) return;

  // the last block merges every split by its log-sum-exp weight: the
  // weights once per (head, split) in shared memory, then per output item
  // loads and FMAs only, kMergeBatch splits' loads in flight at once
  const float* base = ws + static_cast<size_t>(slot) * nsplit * pf;
  float* mw = region;                // [hc][nsplit]: m, then the weight
  float* lw = region + hc * nsplit;  // [hc][nsplit]: l
  float* ltot = lw + hc * nsplit;    // [hc]
  for (int p = tid; p < gn * nsplit; p += kDecodeThreads) {
    const int g = p / nsplit, s = p - g * nsplit;
    mw[p] = __ldcg(base + static_cast<size_t>(s) * pf + g);
    lw[p] = __ldcg(base + static_cast<size_t>(s) * pf + hc + g);
  }
  __syncthreads();
  for (int g = warp; g < gn; g += kDecodeWarps) {
    float M = kNegInf;
    for (int s = lane; s < nsplit; s += 32) {
      if (lw[g * nsplit + s] > 0.f) M = fmaxf(M, mw[g * nsplit + s]);
    }
    M = warp_max(M);
    float tot = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float l = lw[g * nsplit + s];
      const float w = l > 0.f ? expf(mw[g * nsplit + s] - M) : 0.f;
      mw[g * nsplit + s] = w;  // an empty split: exactly 0
      tot += w * l;
    }
    tot = warp_sum(tot);
    if (lane == 0) ltot[g] = tot;
  }
  __syncthreads();
  T* ob = o + qo;
#pragma unroll 1
  for (int r = 0; r < kItems; ++r) {
    const int item = tid + r * kDecodeThreads;
    if (item >= n_items) continue;
    const int g = item / quads, d = c0 + (item - g * quads) * 4;
    const float* wg = mw + g * nsplit;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int s0 = 0; s0 < nsplit; s0 += kMergeBatch) {
      float4 xv[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        xv[u] = s0 + u < nsplit
                    ? __ldcg(reinterpret_cast<const float4*>(
                                 base + static_cast<size_t>(s0 + u) * pf + hdr) + item)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        // an empty split wrote no acc: its words are selected away, never
        // multiplied (they may hold anything)
        const float w = s0 + u < nsplit ? wg[s0 + u] : 0.f;
        a.x += w != 0.f ? w * xv[u].x : 0.f;
        a.y += w != 0.f ? w * xv[u].y : 0.f;
        a.z += w != 0.f ? w * xv[u].z : 0.f;
        a.w += w != 0.f ? w * xv[u].w : 0.f;
      }
    }
    const float denom = ltot[g] == 0.f ? 1.f : ltot[g];
    ob[g * D + d] = from_f32<T>(a.x / denom);
    ob[g * D + d + 1] = from_f32<T>(a.y / denom);
    ob[g * D + d + 2] = from_f32<T>(a.z / denom);
    ob[g * D + d + 3] = from_f32<T>(a.w / denom);
  }
  if (tid == 0) counters[slot] = 0;  // ready for the next launch
}

template <typename T, int D>
int launch_decode(const void* q, const void* kc, const void* vc,
                  const int* lens, void* o, void* ws, void* counters, int B,
                  int H, int KV, int S, int span, int nsplit, int ncs, int hc,
                  float scale, int window, cudaStream_t s) {
  const int G = H / KV;
  const int nchunk = (G + hc - 1) / hc;
  if (span < 1 || nsplit < 1 || nsplit > kDecodeMaxSplits ||
      static_cast<long long>(span) * nsplit < S ||
      static_cast<long long>(span) * (nsplit - 1) >= S || hc < 1 ||
      hc > kDecodeHeads || (nchunk - 1) * hc >= G || ncs < 1 || D % ncs ||
      (D / ncs) % (16 / sizeof(T))) {
    return kStatusBadArgs;
  }
  const int tk = std::min(decode_tile_keys<T>(), span);
  const size_t smem = decode_smem_bytes<T, D>(tk, hc, nsplit);
  const int st = allow_smem(decode_kernel_split<T, D>, smem);
  if (st) return st;
  dim3 grid(nsplit * ncs, KV * nchunk, B);
  decode_kernel_split<T, D><<<grid, kDecodeThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lens, static_cast<T*>(o),
      static_cast<float*>(ws), static_cast<int*>(counters), H, KV, S, span,
      nsplit, ncs, tk, hc, nchunk, scale, window);
  return launch_status();
}

// Launch the instantiation for head dimension D; an unlisted D launches
// nothing and returns kStatusBadHeadDim.
template <typename T>
int dispatch_decode(int D, const void* q, const void* kc, const void* vc,
                    const int* lens, void* o, void* ws, void* cnt, int B,
                    int H, int KV, int S, int span, int nsplit, int ncs,
                    int hc, float scale, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch_decode<T, 16>(q, kc, vc, lens, o, ws, cnt, B, H, KV, S, span, nsplit, ncs, hc, scale, window, s);
    case 32: return launch_decode<T, 32>(q, kc, vc, lens, o, ws, cnt, B, H, KV, S, span, nsplit, ncs, hc, scale, window, s);
    case 64: return launch_decode<T, 64>(q, kc, vc, lens, o, ws, cnt, B, H, KV, S, span, nsplit, ncs, hc, scale, window, s);
    case 80: return launch_decode<T, 80>(q, kc, vc, lens, o, ws, cnt, B, H, KV, S, span, nsplit, ncs, hc, scale, window, s);
    case 128: return launch_decode<T, 128>(q, kc, vc, lens, o, ws, cnt, B, H, KV, S, span, nsplit, ncs, hc, scale, window, s);
    default: return kStatusBadHeadDim;
  }
}

}  // namespace repro

extern "C" int repro_decode_attention(const void* q, const void* kc,
                                      const void* vc, const void* lens,
                                      void* o, void* ws, void* counters,
                                      int B, int H, int KV, int S, int D,
                                      int span, int nsplit, int ncs, int hc,
                                      float scale, int window, int dtype,
                                      void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == kDtypeBF16) {
    return dispatch_decode<__nv_bfloat16>(D, q, kc, vc, ln, o, ws, counters, B, H, KV, S, span, nsplit, ncs, hc, scale, window, s);
  }
  return dispatch_decode<float>(D, q, kc, vc, ln, o, ws, counters, B, H, KV, S, span, nsplit, ncs, hc, scale, window, s);
}
