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
// GPU blocks run in no order, so one block walks the chunks of its
// (batch, head) in a loop and writes the state once.  The state's rows are
// independent (y[t, p] needs only row p of h and column p of x), so the
// block owns 32 of the P head channels: the grid is (B * Hn, P / 32) and
// needs no reduction across blocks.  The Q x Q term is tiled like
// attention (attention_tile.cuh): a sub-block of 32 output rows (C) meets
// the key sub-blocks (B, x) at or below it; lane j forms C_t . B_j for
// the warp's 4 rows with float4 reads of shared memory, and each lane
// accumulates its channel of those rows with the decay weights broadcast
// by shuffles.  The state update keeps a 4 x 4 tile of the state in each
// thread's registers over the chunk's keys.  Decays are always exp of a
// difference of log decays, never a ratio of exps: L falls to the
// thousands within a chunk and exp(L) underflows to 0.
//
// Any S works: the ragged last chunk is masked here (the Pallas kernel
// asserts S % chunk == 0).  Padded steps take dt = 0 and x = B = C = 0, so
// they neither decay nor update the state, and L_Q is the last valid
// step's.  An optional initial state is read and the final state written
// (both (B, Hn, P, N) float32), so one kernel covers every form of
// repro's ops.ssd_scan.  N is a multiple of 4 up to kSsdMaxState.
//
// What bounds it: operations.  At the Mamba2-1.3B prefill shape (S 448,
// 64 heads, P 64, N 128, chunk 256) the scan needs ~1.4 GFLOP (C.B once
// per chunk for all heads, M.x and the two state terms per head) over
// ~10 MB of operands; this kernel forms C.B again in each of its 128
// blocks.  This first version computes in float32 on the CUDA cores (no
// wgmma, no TMA).

#include "common.cuh"

namespace repro {

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
  if (N % 4 != 0 || N > kSsdMaxState || Q < 1) return cudaErrorInvalidValue;
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

}  // namespace repro

// Shared-memory bytes one block of the scan needs at chunk Q and state N
// (the wrapper refuses shapes beyond the card's 227 KB).
extern "C" int repro_ssd_smem_bytes(int Q, int N) {
  return static_cast<int>(repro::ssd_smem_floats(Q, N) * sizeof(float));
}

extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* y, void* hout, int B, int S, int Hn,
                              int P, int N, int Q, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* houtf = static_cast<float*>(hout);
  if (dtype == kDtypeBF16) {
    return launch_ssd<__nv_bfloat16>(x, dtf, Af, Bm, Cm, h0f, y, houtf, B, S,
                                     Hn, P, N, Q, s);
  }
  return launch_ssd<float>(x, dtf, Af, Bm, Cm, h0f, y, houtf, B, S, Hn, P, N,
                           Q, s);
}
