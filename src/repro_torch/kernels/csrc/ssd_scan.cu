// Mamba2 SSD (state-space duality) chunked scan for Hopper.
//
// Replaces repro/kernels/ssd_scan.py::_ssd_kernel (Pallas grid (B, Hn,
// chunks) with the (P, N) state carried in VMEM scratch across the
// sequential chunk axis).  Per chunk of Q steps, with L_t = cumsum(A dt)
// inside the chunk:
//
//   y_t   = sum_{s<=t} exp(L_t - L_s) dt_s (C_t . B_s) x_s + exp(L_t) C_t . h
//   h    <- exp(L_Q) h + sum_s exp(L_Q - L_s) dt_s x_s (outer) B_s
//
// Decays are always exp of a difference of log decays, never a ratio of
// exps: L falls to the thousands within a chunk and exp(L) underflows to
// 0.  Any S works: the ragged last chunk is masked here (the Pallas kernel
// asserts S % chunk == 0).  Padded steps take dt = 0 and x = B = C = 0, so
// they neither decay nor update the state, and L_Q is the last valid
// step's.  An optional initial state is read and the final state written
// (both (B, Hn, P, N) float32), so one kernel covers every form of repro's
// ops.ssd_scan.  N is a multiple of 4 up to kSsdMaxState; any P.
//
// What bounds it: bytes.  At the Mamba2-1.3B prefill shape (S 448, 64
// heads, P 64, N 128, chunk 256) the scan moves 9.8 MB (x, B, C, dt in; y
// and the final state out): 2.9 us at 3.35 TB/s.  Its 1.39 GFLOP (C.B once
// per chunk for all heads, per head M.x and the two state terms) take 1.4
// us on the bf16 tensor cores.  Zamba2-2.7B's shape (80 heads, N 64):
// 10.7 MB, 3.2 us.
//
// bf16 operands take ssd_kernel_mma.  A block owns one (batch, head), a
// slice of 64 head channels and a run of chunks; it walks the chunks
// before its run for their state updates alone, so no block waits on
// another (grid (B * Hn, P / 64, runs), the runs chosen by the wrapper).
// Per chunk, 16-byte cp.async copies stage B and x once, bf16 as they
// are, zero-padded to whole key tiles, N to NS (64 or 128) columns and P
// to the slice, in rows padded by 16 bytes so that every ldmatrix phase hits
// distinct banks; L_t (in log2 units) and the update weights w_s =
// exp(L_Q - L_s) dt_s are formed while the copies fly.  C, which only the
// outputs read, is copied during the previous chunk's update.  Eight
// warps take the chunk's 16-row output tiles from the last (the longest)
// in a snake, so the causal triangle balances.  A warp keeps its rows of
// C as A fragments and runs C.B over 32-key tiles on mma.sync m16n8k16
// (bf16 in, float32 accumulate); M = exp(L_t - L_s) dt_s (C_t . B_s) is
// formed on the accumulator fragment, masked causally, rounded to bf16
// and reused as the A operand of M.x (x through ldmatrix.trans), as flash
// attention reuses P.  The carried term C.h runs on the same C fragments
// against h rounded to bf16 in shared memory (y's tolerance is 2e-2).  The
// warp stages its y tile in its own rows of C, which no other warp reads,
// and stores whole rows of 16 bytes.  The float32 state stays in the
// warps' accumulator registers across chunks; its update x^T.(w o B)
// takes w o x split into bf16 hi + lo parts, two chains of products
// summed at the chunk's end, which keeps the state within 2e-3 (w o x
// rounded once to bf16 would miss it; tests/test_torch_ssd_tiled.py
// emulates both).  What holds it near 0.024 ms rather than its bound is
// latency, not bytes or products: each SM runs 8 warps of short
// dependent mma chains, and every block stages its own copy of C and B
// (`chip_smoke.py --phases parts` times copies with parts taken out).
//
// float32 operands take ssd_kernel on the CUDA cores (below): bf16
// operands would miss the float32 tolerance of 1e-3, and no served path
// runs float32 on the card.  A block owns 32 head channels of one (batch,
// head) and walks all its chunks; lane j forms C_t . B_j with float4
// reads of shared memory, the decay weights are broadcast by shuffles,
// and the update keeps a 4 x 4 tile of the state in each thread.

#include "common.cuh"

namespace repro {

// ---------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------
constexpr int kSsdThreads = 256;
constexpr int kSsdWarps = kSsdThreads / 32;
constexpr int kSsdSub = 32;                        // rows / keys of a sub-block
constexpr int kSsdRows = kSsdSub / kSsdWarps;      // output rows per warp
constexpr int kSsdPTile = 32;                      // head channels per block
// The update splits the 32 x N state tile into 2N tiles of 4 x 4, one a
// thread, so N is at most half the block.
constexpr int kSsdMaxState = kSsdThreads / 2;

// Row pitch of the N-wide shared arrays: N + 4 keeps float4 rows aligned
// and spreads 8 rows read at once over distinct banks.
__host__ __device__ inline int ssd_pitch(int N) { return N + 4; }

// Shared floats of one block: L and dt of a chunk (Q rounded up to the
// sub-block), C rows, B keys, x keys (32 x 32) and the state tile.
inline size_t ssd_smem_floats(int Q, int N) {
  const int Qp = (Q + kSsdSub - 1) / kSsdSub * kSsdSub;
  return 2 * static_cast<size_t>(Qp) + 3 * kSsdSub * ssd_pitch(N) +
         kSsdSub * kSsdPTile;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stage rows [r0, r0 + 32) of the chunk's (n, N) matrix M into dst
// (pitch N + 4); rows at or past `nq` are zero.
template <typename T>
__device__ __forceinline__ void ssd_stage_rows(const T* __restrict__ M,
                                               int r0, int nq, int N,
                                               float* __restrict__ dst) {
  const int np = ssd_pitch(N);
  for (int i = threadIdx.x; i < kSsdSub * N; i += kSsdThreads) {
    const int r = i / N, n = i - r * N;
    dst[r * np + n] =
        r0 + r < nq ? to_f32(M[static_cast<size_t>(r0 + r) * N + n]) : 0.f;
  }
}

// Stage keys [k0, k0 + 32) of the block's 32 channels of x into xs[s][p],
// each key scaled by w(s) (1 for the outputs, exp(L_Q - L_s) dt_s for the
// state update).  Keys at or past `nq` and channels at or past `pw` are 0.
template <typename T, typename W>
__device__ __forceinline__ void ssd_stage_x(const T* __restrict__ xc,
                                            size_t xrow, int k0, int nq,
                                            int pw, W w,
                                            float* __restrict__ xs) {
  for (int i = threadIdx.x; i < kSsdSub * kSsdPTile; i += kSsdThreads) {
    const int r = i / kSsdPTile, p = i - r * kSsdPTile;
    const int s = k0 + r;
    xs[i] = (s < nq && p < pw)
                ? to_f32(xc[static_cast<size_t>(s) * xrow + p]) * w(s)
                : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ hout, int S, int Hn, int P,
           int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int Qp = (Q + kSsdSub - 1) / kSsdSub * kSsdSub;
  const int np = ssd_pitch(N);
  float* sL = smem;                                // Qp   log decay L_t
  float* sdt = sL + Qp;                            // Qp   dt_t
  float* sC = sdt + Qp;                            // 32 x np  C rows
  float* sB = sC + kSsdSub * np;                   // 32 x np  B keys
  float* sH = sB + kSsdSub * np;                   // 32 x np  state tile
  float* sX = sH + kSsdSub * np;                   // 32 x 32  x keys
  __shared__ float warp_tot[kSsdWarps];

  const int bh = blockIdx.x;
  const int b = bh / Hn, h = bh - b * Hn;
  const int p0 = blockIdx.y * kSsdPTile;
  const int pw = min(kSsdPTile, P - p0);           // valid channels here
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float a = A[h];
  const size_t xrow = static_cast<size_t>(Hn) * P;
  const T* xb = x + static_cast<size_t>(b) * S * xrow + static_cast<size_t>(h) * P + p0;
  T* yb = y + static_cast<size_t>(b) * S * xrow + static_cast<size_t>(h) * P + p0;
  const float* dtb = dt + static_cast<size_t>(b) * S * Hn + h;
  const T* Bb = Bm + static_cast<size_t>(b) * S * N;
  const T* Cb = Cm + static_cast<size_t>(b) * S * N;
  const size_t hbase = (static_cast<size_t>(bh) * P + p0) * N;
  // this thread's 4 x 4 tile of the state in the update (threads >= 2N
  // own none): channels up0 .. up0 + 3, states un0 .. un0 + 3
  const int nq4 = N / 4;
  const bool owns = threadIdx.x < 8 * nq4;
  const int up0 = 4 * (threadIdx.x / nq4), un0 = 4 * (threadIdx.x % nq4);

  for (int i = threadIdx.x; i < kSsdPTile * N; i += kSsdThreads) {
    const int p = i / N, n = i - p * N;
    sH[p * np + n] = (h0 != nullptr && p < pw) ? h0[hbase + i] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int nq = min(Q, S - c0);
    const T* xc = xb + static_cast<size_t>(c0) * xrow;
    const T* Bc = Bb + static_cast<size_t>(c0) * N;
    const T* Cc = Cb + static_cast<size_t>(c0) * N;

    // 1. L_t = cumsum(a dt_t) over the chunk: a warp scan per 32 steps,
    //    then the totals of the warps before; padded steps add 0.
    float carry = 0.f;
    for (int base = 0; base < Qp; base += kSsdThreads) {
      const int t = base + threadIdx.x;
      const float d = t < nq ? dtb[static_cast<size_t>(c0 + t) * Hn] : 0.f;
      float v = a * d;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) warp_tot[warp] = v;
      __syncthreads();
      float pre = carry, tot = 0.f;
#pragma unroll
      for (int w = 0; w < kSsdWarps; ++w) {
        if (w < warp) pre += warp_tot[w];
        tot += warp_tot[w];
      }
      if (t < Qp) {
        sL[t] = pre + v;
        sdt[t] = d;
      }
      carry += tot;
      __syncthreads();
    }
    const float L_last = sL[nq - 1];

    // 2. outputs, 32 rows at a time: the carried-state term, then the
    //    intra-chunk term over the key sub-blocks at or below the rows.
    for (int t0 = 0; t0 < nq; t0 += kSsdSub) {
      __syncthreads();  // the previous sub-block is done with sC
      ssd_stage_rows<T>(Cc, t0, nq, N, sC);
      __syncthreads();
      float acc[kSsdRows];
#pragma unroll
      for (int k = 0; k < kSsdRows; ++k) acc[k] = 0.f;
      const float* hrow = sH + lane * np;          // state row of channel p
      for (int n = 0; n < N; n += 4) {
        const float4 hv = ld4(hrow + n);
#pragma unroll
        for (int k = 0; k < kSsdRows; ++k)
          acc[k] += dot4(ld4(sC + (warp + kSsdWarps * k) * np + n), hv);
      }
#pragma unroll
      for (int k = 0; k < kSsdRows; ++k)
        acc[k] *= expf(sL[t0 + warp + kSsdWarps * k]);
      for (int k0 = 0; k0 <= t0; k0 += kSsdSub) {
        __syncthreads();  // the previous keys are consumed
        ssd_stage_rows<T>(Bc, k0, nq, N, sB);
        ssd_stage_x<T>(xc, xrow, k0, nq, pw, [](int) { return 1.f; }, sX);
        __syncthreads();
        const int s = k0 + lane;                   // this lane's key
        const float Ls = sL[s], dts = sdt[s];
        float g[kSsdRows];
#pragma unroll
        for (int k = 0; k < kSsdRows; ++k) g[k] = 0.f;
        const float* brow = sB + lane * np;
#pragma unroll 4
        for (int n = 0; n < N; n += 4) {
          const float4 bv = ld4(brow + n);
#pragma unroll
          for (int k = 0; k < kSsdRows; ++k)
            g[k] += dot4(ld4(sC + (warp + kSsdWarps * k) * np + n), bv);
        }
        float m[kSsdRows];
#pragma unroll
        for (int k = 0; k < kSsdRows; ++k) {
          const int t = t0 + warp + kSsdWarps * k;
          m[k] = s <= t ? expf(sL[t] - Ls) * dts * g[k] : 0.f;
        }
#pragma unroll 4
        for (int j = 0; j < kSsdSub; ++j) {
          const float xv = sX[j * kSsdPTile + lane];
#pragma unroll
          for (int k = 0; k < kSsdRows; ++k)
            acc[k] += __shfl_sync(0xffffffffu, m[k], j) * xv;
        }
      }
      if (lane < pw) {
#pragma unroll
        for (int k = 0; k < kSsdRows; ++k) {
          const int t = t0 + warp + kSsdWarps * k;
          if (t < nq)
            yb[static_cast<size_t>(c0 + t) * xrow + lane] = from_f32<T>(acc[k]);
        }
      }
    }

    // 3. state update: h <- exp(L_Q) h + sum_s exp(L_Q - L_s) dt_s x_s B_s,
    //    with x staged already scaled by its weight.
    __syncthreads();  // every output row has read the chunk's input state
    const float decay = expf(L_last);
    float hv[4][4];
    if (owns) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 r = ld4(sH + (up0 + i) * np + un0);
        hv[i][0] = decay * r.x; hv[i][1] = decay * r.y;
        hv[i][2] = decay * r.z; hv[i][3] = decay * r.w;
      }
    }
    const float* sLc = sL;
    const float* sdtc = sdt;
    for (int k0 = 0; k0 < nq; k0 += kSsdSub) {
      __syncthreads();
      ssd_stage_rows<T>(Bc, k0, nq, N, sB);
      ssd_stage_x<T>(xc, xrow, k0, nq, pw,
                     [=](int s) { return expf(L_last - sLc[s]) * sdtc[s]; },
                     sX);
      __syncthreads();
      if (owns) {
#pragma unroll 4
        for (int j = 0; j < kSsdSub; ++j) {
          const float4 bv = ld4(sB + j * np + un0);
          const float4 xv = ld4(sX + j * kSsdPTile + up0);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hv[i][0] += xs[i] * bv.x; hv[i][1] += xs[i] * bv.y;
            hv[i][2] += xs[i] * bv.z; hv[i][3] += xs[i] * bv.w;
          }
        }
      }
    }
    if (owns) {  // only this thread reads its tile until the next chunk
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(sH + (up0 + i) * np + un0) =
            make_float4(hv[i][0], hv[i][1], hv[i][2], hv[i][3]);
      }
    }
    __syncthreads();  // the next chunk reads the updated state
  }

  if (hout != nullptr) {
    for (int i = threadIdx.x; i < kSsdPTile * N; i += kSsdThreads) {
      const int p = i / N, n = i - p * N;
      if (p < pw) hout[hbase + i] = sH[p * np + n];
    }
  }
}

template <typename T>
int launch_ssd(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, const float* h0, void* y, float* hout, int B,
               int S, int Hn, int P, int N, int Q, cudaStream_t s) {
  const size_t smem = ssd_smem_floats(Q, N) * sizeof(float);
  // Raise the block's dynamic shared-memory cap once per size (above 48 KB
  // it must be asked for), so that launches captured in a CUDA graph make
  // no attribute call.
  static size_t cap = 48 * 1024;
  if (smem > cap) {
    const cudaError_t attr = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    cap = smem;
  }
  dim3 grid(B * Hn, (P + kSsdPTile - 1) / kSsdPTile);
  ssd_kernel<T><<<grid, kSsdThreads, smem, s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, static_cast<T*>(y), hout, S, Hn, P, N,
      Q);
  return launch_status();
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------
constexpr int kSsdMmaThreads = 256;
constexpr int kSsdMmaWarps = kSsdMmaThreads / 32;
constexpr int kSsdPad = 8;     // bf16 padding of a shared row (16 bytes)
constexpr int kSsdSlice = 64;  // head channels a block takes

// Timing copies only: `chip_smoke.py --phases parts` builds the kernels
// with -DSSD_VARIANT=<bits>, each bit taking one part out of the bf16
// kernel (whose outputs are then wrong) or putting in the alternative a
// design choice was weighed against, and with -DSSD_KEYS for the key tile.
// The served build leaves both at their defaults.
#ifndef SSD_VARIANT
#define SSD_VARIANT 0
#endif
#ifndef SSD_KEYS
#define SSD_KEYS 32
#endif
enum SsdVariant : int {
  kSsdNoWork = 1 << 0,      // nothing after the launch
  kSsdNoOutputs = 1 << 1,   // no y: C.h, the key tiles and the store
  kSsdNoUpdate = 1 << 2,    // no state update
  kSsdNoCh = 1 << 3,        // no carried term C.h
  kSsdNoKeyTiles = 1 << 4,  // no key tiles: C.B, M and M.x
  kSsdNoCbMma = 1 << 5,     // no C.B products
  kSsdNoExp = 1 << 6,       // M without its exps
  kSsdNoMxMma = 1 << 7,     // no M.x products (M still formed)
  kSsdNoYStore = 1 << 8,    // y not stored
  kSsdQuarterCB = 1 << 9,   // C and B staged a quarter of their rows
  kSsdCWithBX = 1 << 10,    // C staged with B and x, not during the update
  kSsdYDirect = 1 << 11,    // y stored from the fragments, 4 bytes a store
};
__host__ __device__ constexpr bool ssd_has(int bit) { return (SSD_VARIANT & bit) != 0; }

constexpr int kSsdKeys = SSD_KEYS;  // keys of a C.B tile

__host__ __device__ inline int ssd_round(int n, int m) { return (n + m - 1) / m * m; }

// Shared bytes of one block at chunk Q and padded state NS: C and B (Qp x
// (NS + 8)), x (Qp x 72) and the bf16 state (64 x (NS + 8)), then L, dt
// and the update weights (Qp floats each).
inline size_t ssd_mma_smem_bytes(int Q, int NS) {
  const size_t Qp = ssd_round(Q, kSsdKeys);
  return (2 * Qp * (NS + kSsdPad) + Qp * (kSsdSlice + kSsdPad) +
          static_cast<size_t>(kSsdSlice) * (NS + kSsdPad)) * sizeof(bf16) +
         3 * Qp * sizeof(float);
}

// Stage source rows [0, nrows) (row stride ld, W valid columns) into rows
// [0, R) of a shared tile of pitch `pitch` and WP columns; the other rows
// and columns are zeros.  With `vec` by 16-byte cp.async (the caller
// commits and waits), else element by element.
template <int WP>
__device__ __forceinline__ void ssd_stage(bf16* __restrict__ dst, int pitch,
                                          const bf16* __restrict__ src,
                                          size_t ld, int R, int nrows, int W,
                                          bool vec) {
  if (vec) {
    constexpr int CH = WP / 8;
    for (int i = threadIdx.x; i < R * CH; i += kSsdMmaThreads) {
      const int r = i / CH, c = i % CH;
      const bool ok = r < nrows && c * 8 < W;
      cp_async16(dst + r * pitch + c * 8, ok ? src + r * ld + c * 8 : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * WP; i += kSsdMmaThreads) {
      const int r = i / WP, c = i % WP;
      dst[r * pitch + c] =
          r < nrows && c < W ? src[r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// Two bf16 of x (lo first) times (w0, w1) in float32, split into bf16
// parts hi + lo that sum to the product within ~2^-16 of it.
__device__ __forceinline__ void ssd_split(uint32_t xv, float w0, float w1,
                                          uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
  const float v0 = f.x * w0, v1 = f.y * w1;
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

template <int NS>
__global__ void __launch_bounds__(kSsdMmaThreads)
ssd_kernel_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, const float* __restrict__ h0,
               bf16* __restrict__ y, float* __restrict__ hout, int S, int Hn,
               int P, int N, int Q, int run_chunks, int vec) {
  if (ssd_has(kSsdNoWork) && S > 0) return;
  constexpr int PB = kSsdSlice;
  constexpr int CB = ssd_has(kSsdQuarterCB) ? 4 : 1;  // C and B rows / CB
  constexpr int NP = NS + kSsdPad;  // pitch of C, B and state rows
  constexpr int XP = PB + kSsdPad;  // pitch of x rows
  constexpr int KS = NS / 16;       // k-steps over the state
  constexpr int PT = PB / 16;       // 16-channel tiles of the slice
  constexpr int TW = NS * PT / 64;  // 8-wide state tiles a warp updates
  constexpr int KT = kSsdKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Qp = ssd_round(Q, kSsdKeys);
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);      // [Qp][NP]
  bf16* sB = sC + Qp * NP;                           // [Qp][NP]
  bf16* sX = sB + Qp * NP;                           // [Qp][XP]
  bf16* sH = sX + Qp * XP;                           // [PB][NP] state, bf16
  float* sL = reinterpret_cast<float*>(sH + PB * NP);  // L_t log2(e)
  float* sdt = sL + Qp;
  float* sW = sdt + Qp;                              // exp(L_Q - L_s) dt_s
  __shared__ float warp_tot[kSsdMmaWarps];

  const int bh = blockIdx.x, b = bh / Hn, h = bh - b * Hn;
  const int p0 = blockIdx.y * PB, pw = min(PB, P - p0);
  const int nchunks = (S + Q - 1) / Q;
  const int c_begin = blockIdx.z * run_chunks;
  const int c_end = min(nchunks, c_begin + run_chunks);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const float a = A[h] * 1.4426950408889634f;
  const size_t xrow = static_cast<size_t>(Hn) * P;
  const size_t xoff = static_cast<size_t>(b) * S * xrow + static_cast<size_t>(h) * P + p0;
  const bf16* xb = x + xoff;
  bf16* yb = y + xoff;
  const float* dtb = dt + static_cast<size_t>(b) * S * Hn + h;
  const bf16* Bb = Bm + static_cast<size_t>(b) * S * N;
  const bf16* Cb = Cm + static_cast<size_t>(b) * S * N;
  const size_t hbase = (static_cast<size_t>(bh) * P + p0) * N;

  // The state: this warp's tiles hs[j] hold channels pt * 16 + gr (+ 8)
  // and states (nt0 + j) * 8 + 2 t4 (+ 1), in the update's accumulator
  // layout; padded channels and states stay 0.
  const int pt = warp % PT, nt0 = (warp / PT) * TW;
  bool has_state = h0 != nullptr;
  float hs[TW][4];
#pragma unroll
  for (int j = 0; j < TW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pt * 16 + gr + (e & 2) * 4, n = (nt0 + j) * 8 + 2 * t4 + (e & 1);
      hs[j][e] = has_state && p < pw && n < N ? h0[hbase + static_cast<size_t>(p) * N + n] : 0.f;
    }
  }

  for (int ci = 0; ci < c_end; ++ci) {
    const int c0 = ci * Q, nq = min(Q, S - c0), nqp = ssd_round(nq, 16);
    const int nqk = ssd_round(nq, KT);  // rows staged: whole key tiles
    const bool own = ci >= c_begin;  // outputs of this chunk are this block's
    const bool update = ci + 1 < c_end || (hout != nullptr && ci + 1 == nchunks);
    __syncthreads();  // the previous chunk is done with shared memory

    // 1. stage B and x once (C was issued during the update before, or
    //    here for a block's first chunk); they fly while L, dt and the
    //    weights are formed
    ssd_stage<NS>(sB, NP, Bb + static_cast<size_t>(c0) * N, N, nqk / CB, nq / CB, N, vec);
    ssd_stage<PB>(sX, XP, xb + static_cast<size_t>(c0) * xrow, xrow, nqk, nq, pw, vec);
    if ((ci == 0 || ssd_has(kSsdCWithBX)) && own)
      ssd_stage<NS>(sC, NP, Cb + static_cast<size_t>(c0) * N, N, nqp / CB, nq / CB, N, vec);
    cp_async_commit();

    // L_t = cumsum(a dt_t) in log2 units: a warp scan per 32 steps, then
    // the totals of the warps before; padded steps add 0
    float carry = 0.f;
    for (int base = 0; base < nqk; base += kSsdMmaThreads) {
      const int t = base + tid;
      const float d = t < nq ? dtb[static_cast<size_t>(c0 + t) * Hn] : 0.f;
      float v = a * d;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) warp_tot[warp] = v;
      __syncthreads();
      float pre = carry, tot = 0.f;
#pragma unroll
      for (int w = 0; w < kSsdMmaWarps; ++w) {
        if (w < warp) pre += warp_tot[w];
        tot += warp_tot[w];
      }
      if (t < nqk) {
        sL[t] = pre + v;
        sdt[t] = d;
      }
      carry += tot;
      __syncthreads();
    }
    const float L_last = sL[nq - 1];
    for (int t = tid; t < nqp; t += kSsdMmaThreads) sW[t] = exp2f(L_last - sL[t]) * sdt[t];
    if (own && has_state) {  // the entering state, rounded to bf16 for C.h
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        bf16* dst = sH + (pt * 16 + gr) * NP + (nt0 + j) * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(hs[j][0], hs[j][1]);
        *reinterpret_cast<uint32_t*>(dst + 8 * NP) = pack_bf16(hs[j][2], hs[j][3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // 2. outputs: 16-row tiles from the chunk's last, in a snake over the
    //    warps (tile R - 1 - j goes to warp j, then back)
    const int R = nqp / 16;
    for (int j0 = 0; own && !ssd_has(kSsdNoOutputs) && j0 < R; j0 += kSsdMmaWarps) {
      const int j = j0 + (((j0 / kSsdMmaWarps) & 1) ? kSsdMmaWarps - 1 - warp : warp);
      if (j >= R) continue;
      const int ti = R - 1 - j;
      const int row0 = ti * 16 + gr, row1 = row0 + 8;
      uint32_t cf[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(cf[kk], sC + (ti * 16 + (lane & 15)) * NP + kk * 16 + (lane >> 4) * 8);
      float acc[PB / 8][4];
#pragma unroll
      for (int jj = 0; jj < PB / 8; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
      const float L0 = sL[row0], L1 = sL[row1];
      if (has_state && !ssd_has(kSsdNoCh)) {  // exp(L_t) C_t . h
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int np = 0; np < PT; ++np) {
            uint32_t hb[4];
            ldmatrix_x4(hb, sH + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * NP + kk * 16 +
                                ((lane >> 3) & 1) * 8);
            mma_bf16(acc[2 * np], cf[kk], hb[0], hb[1]);
            mma_bf16(acc[2 * np + 1], cf[kk], hb[2], hb[3]);
          }
        }
        const float e0 = exp2f(L0), e1 = exp2f(L1);
#pragma unroll
        for (int jj = 0; jj < PB / 8; ++jj) {
          acc[jj][0] *= e0;
          acc[jj][1] *= e0;
          acc[jj][2] *= e1;
          acc[jj][3] *= e1;
        }
      }
      // key tiles of KT keys covering the keys at or below the rows (the
      // last one masked)
      const int nkt = ssd_has(kSsdNoKeyTiles) ? 0 : (ti * 16 + 15) / KT + 1;
      for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * KT;
        float sc[KT / 8][4];
#pragma unroll
        for (int jn = 0; jn < KT / 8; ++jn) sc[jn][0] = sc[jn][1] = sc[jn][2] = sc[jn][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int q = 0; q < KT / 16; ++q) {
            uint32_t kb[4];
            if (ssd_has(kSsdNoCbMma)) continue;
            ldmatrix_x4(kb, sB + (k0 + q * 16 + (lane & 7) + ((lane >> 4) << 3)) * NP + kk * 16 +
                                ((lane >> 3) & 1) * 8);
            mma_bf16(sc[2 * q], cf[kk], kb[0], kb[1]);
            mma_bf16(sc[2 * q + 1], cf[kk], kb[2], kb[3]);
          }
        }
        // M on the fragment: rows row0 (e 0, 1) and row1 (e 2, 3), keys
        // s and s + 1; above the diagonal exactly 0
        auto decay = [](float d) { return ssd_has(kSsdNoExp) ? d : exp2f(d); };
        uint32_t pa[KT / 16][4];
#pragma unroll
        for (int jn = 0; jn < KT / 8; ++jn) {
          const int s = k0 + jn * 8 + 2 * t4;
          const float Ls0 = sL[s], Ls1 = sL[s + 1], d0 = sdt[s], d1 = sdt[s + 1];
          const float m0 = s <= row0 ? decay(L0 - Ls0) * d0 * sc[jn][0] : 0.f;
          const float m1 = s + 1 <= row0 ? decay(L0 - Ls1) * d1 * sc[jn][1] : 0.f;
          const float m2 = s <= row1 ? decay(L1 - Ls0) * d0 * sc[jn][2] : 0.f;
          const float m3 = s + 1 <= row1 ? decay(L1 - Ls1) * d1 * sc[jn][3] : 0.f;
          pa[jn / 2][(jn & 1) * 2] = pack_bf16(m0, m1);
          pa[jn / 2][(jn & 1) * 2 + 1] = pack_bf16(m2, m3);
        }
#pragma unroll
        for (int q = 0; q < KT / 16; ++q) {
          if (ssd_has(kSsdNoMxMma)) {  // keep M live without its products
            asm volatile("" ::"r"(pa[q][0]), "r"(pa[q][1]), "r"(pa[q][2]), "r"(pa[q][3]));
            continue;
          }
#pragma unroll
          for (int dp = 0; dp < PT; ++dp) {  // y += M . x
            uint32_t xv[4];
            ldmatrix_x4_trans(xv, sX + (k0 + q * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XP +
                                      dp * 16 + (lane >> 4) * 8);
            mma_bf16(acc[2 * dp], pa[q], xv[0], xv[1]);
            mma_bf16(acc[2 * dp + 1], pa[q], xv[2], xv[3]);
          }
        }
      }
      if (ssd_has(kSsdNoYStore)) continue;
      if (ssd_has(kSsdYDirect)) {  // the alternative: 4-byte stores
#pragma unroll
        for (int jj = 0; jj < PB / 8; ++jj) {
          const int col = jj * 8 + 2 * t4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = (half ? row1 : row0);
            if (row >= nq) continue;
            bf16* dst = yb + static_cast<size_t>(c0 + row) * xrow + col;
            const float v0 = acc[jj][2 * half], v1 = acc[jj][2 * half + 1];
            if (col + 1 < pw)
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
            else if (col < pw)
              dst[0] = __float2bfloat16(v0);
          }
        }
        continue;
      }
      // y leaves through this warp's own 16 rows of sC (no other warp
      // reads them): whole rows as 16-byte stores
      bf16* ys = sC + ti * 16 * NP;
#pragma unroll
      for (int jj = 0; jj < PB / 8; ++jj) {
        const int col = jj * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(ys + gr * NP + col) = pack_bf16(acc[jj][0], acc[jj][1]);
        *reinterpret_cast<uint32_t*>(ys + (gr + 8) * NP + col) = pack_bf16(acc[jj][2], acc[jj][3]);
      }
      __syncwarp();
      for (int i = lane; i < 16 * (PB / 8); i += 32) {
        const int r = i / (PB / 8), c = i % (PB / 8) * 8, row = ti * 16 + r;
        if (row >= nq || c >= pw) continue;
        bf16* dst = yb + static_cast<size_t>(c0 + row) * xrow + c;
        const bf16* src = ys + r * NP + c;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && c + e < pw; ++e) dst[e] = src[e];
        }
      }
    }

    // C of the next chunk, if its outputs are this block's, flies during
    // the update (which reads no C)
    if (!ssd_has(kSsdCWithBX) && ci + 1 < c_end && ci + 1 >= c_begin) {
      if (own) __syncthreads();  // every output tile is done with sC
      const int c1 = c0 + Q;
      ssd_stage<NS>(sC, NP, Cb + static_cast<size_t>(c1) * N, N,
                    ssd_round(min(Q, S - c1), 16) / CB, min(Q, S - c1) / CB, N, vec);
      cp_async_commit();
    }

    // 3. state update h <- exp(L_Q) h + x^T (w o B), from the same tiles
    //    (outputs and update only read shared memory): w o x in bf16 hi +
    //    lo parts as the A operand, B through ldmatrix.trans
    if (update && !ssd_has(kSsdNoUpdate)) {
      if (has_state) {
        const float decay = exp2f(L_last);
#pragma unroll
        for (int j = 0; j < TW; ++j) {
          hs[j][0] *= decay;
          hs[j][1] *= decay;
          hs[j][2] *= decay;
          hs[j][3] *= decay;
        }
      }
      float hl[TW][4];  // the lo parts' sum: a second chain of products
#pragma unroll
      for (int j = 0; j < TW; ++j) hl[j][0] = hl[j][1] = hl[j][2] = hl[j][3] = 0.f;
      for (int ks = 0; ks < R; ++ks) {
        uint32_t xa[4], hi[4], lo[4];
        ldmatrix_x4_trans(xa, sX + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * XP + pt * 16 +
                                  ((lane >> 3) & 1) * 8);
        const int s = ks * 16 + 2 * t4;
        const float w0 = sW[s], w1 = sW[s + 1], w8 = sW[s + 8], w9 = sW[s + 9];
        ssd_split(xa[0], w0, w1, hi[0], lo[0]);
        ssd_split(xa[1], w0, w1, hi[1], lo[1]);
        ssd_split(xa[2], w8, w9, hi[2], lo[2]);
        ssd_split(xa[3], w8, w9, hi[3], lo[3]);
#pragma unroll
        for (int q = 0; q < TW / 2; ++q) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sB + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * NP +
                                    (nt0 + 2 * q) * 8 + (lane >> 4) * 8);
          mma_bf16(hs[2 * q], hi, bv[0], bv[1]);
          mma_bf16(hl[2 * q], lo, bv[0], bv[1]);
          mma_bf16(hs[2 * q + 1], hi, bv[2], bv[3]);
          mma_bf16(hl[2 * q + 1], lo, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        hs[j][0] += hl[j][0];
        hs[j][1] += hl[j][1];
        hs[j][2] += hl[j][2];
        hs[j][3] += hl[j][3];
      }
      has_state = true;
    }
  }

  if (hout != nullptr && c_end == nchunks) {
#pragma unroll
    for (int j = 0; j < TW; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = pt * 16 + gr + 8 * half, n = (nt0 + j) * 8 + 2 * t4;
        if (p < pw && n < N) {
          *reinterpret_cast<float2*>(hout + hbase + static_cast<size_t>(p) * N + n) =
              make_float2(hs[j][2 * half], hs[j][2 * half + 1]);
        }
      }
    }
  }
}

template <int NS>
int launch_ssd_mma(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* h0, void* y,
                   float* hout, int B, int S, int Hn, int P, int N, int Q,
                   int runs, bool vec, cudaStream_t s) {
  const size_t smem = ssd_mma_smem_bytes(Q, NS);
  const int st = allow_smem(ssd_kernel_mma<NS>, smem);
  if (st) return st;
  const int nchunks = (S + Q - 1) / Q;
  const int run_chunks = (nchunks + runs - 1) / runs;
  dim3 grid(B * Hn, (P + kSsdSlice - 1) / kSsdSlice, (nchunks + run_chunks - 1) / run_chunks);
  ssd_kernel_mma<NS><<<grid, kSsdMmaThreads, smem, s>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), h0, static_cast<bf16*>(y), hout, S, Hn, P,
      N, Q, run_chunks, vec ? 1 : 0);
  return launch_status();
}

// The padded state width of N: 64 or 128.
inline int ssd_state_pad(int N) { return N <= 64 ? 64 : 128; }

}  // namespace repro

// Shared-memory bytes one block of the scan needs at chunk Q and state N:
// the float32 kernel's, or the bf16 tensor-core kernel's (the wrapper
// refuses shapes beyond the card's 227 KB).
extern "C" int repro_ssd_smem_bytes(int Q, int N, int dtype) {
  using namespace repro;
  const size_t bytes = dtype == kDtypeBF16
                           ? ssd_mma_smem_bytes(Q, ssd_state_pad(N))
                           : ssd_smem_floats(Q, N) * sizeof(float);
  return static_cast<int>(bytes);
}

// bf16 launches split the chunks into `runs` runs, a block each;
// float32 launches ignore it.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* y, void* hout, int B, int S, int Hn,
                              int P, int N, int Q, int dtype, int runs,
                              void* stream) {
  using namespace repro;
  if (N % 4 != 0 || N > kSsdMaxState || Q < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* houtf = static_cast<float*>(hout);
  if (dtype != kDtypeBF16) {
    return launch_ssd<float>(x, dtf, Af, Bm, Cm, h0f, y, houtf, B, S, Hn, P,
                             N, Q, s);
  }
  if (runs < 1) return kStatusBadArgs;
  // 16-byte copies need 16-byte rows and bases; otherwise the kernel
  // stages element by element
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = N % 8 == 0 && P % 8 == 0 && al(x) && al(Bm) && al(Cm) && al(y);
  return ssd_state_pad(N) == 128
             ? launch_ssd_mma<128>(x, dtf, Af, Bm, Cm, h0f, y, houtf, B, S, Hn, P, N, Q, runs, vec, s)
             : launch_ssd_mma<64>(x, dtf, Af, Bm, Cm, h0f, y, houtf, B, S, Hn, P, N, Q, runs, vec, s);
}
