// Fused fleet replan for Hopper: one exact constrained trie search per
// request lane, emitting (target node, next model).
//
// Replaces repro/kernels/trie_plan.py::_trie_plan_kernel.  The Pallas
// kernel walks (node tiles x lane blocks) with node tiles OUTER, carries
// each lane's running lexicographic minima in VMEM scratch across the node
// axis and rewrites its output on every node tile: it relies on the TPU
// running the grid in order.  Here the preorder trie puts every candidate
// of prefix u in [u, u + subtree[u]), and a lane scans that interval only.
//
// What bounds it on this card.  Neither bytes nor flops: a served round
// (16 lanes, a trie of 31 nodes) is the launch and a chain of dependent
// loads (prefix -> prefix row -> node columns -> reduction -> output); a
// round whose lanes start at the root of a deep trie (5461 nodes) is one
// lane's serial scan; at fleet scale (256 lanes) it is the loads and the
// instructions of every lane's strides.  The design:
//
// - A warp, not a block, per (lane, slice): no __syncthreads and no
//   shared memory.  The warp loads the lane's operands and the per-model
//   delays (every thread the same addresses, one broadcast each), then
//   the prefix row, then every node column of 128 nodes (four strides of
//   32) at once, before any mask (indices clamped into the trie, the
//   interval applied after), and the first step path_models[v, depth[u]]
//   of every node with them, so no load waits on the reduction.  Shuffles alone reduce
//   the warp; the winner's first step comes from the thread that scanned
//   it.  A lane's first slice starts at u, so its first nodes' loads do
//   not wait for subtree[u].  Counts rows are read as 8- or 16-byte
//   vectors (pool widths 2, 4, 8): one or two loads a node, not M, each
//   touching the same L1 lines the M scalar loads would each touch.
// - Slices for wide lanes.  The host picks `splits` from (lanes, nodes)
//   alone (kernels/trie_plan.py split_plan; it never reads the device).
//   A lane whose interval holds L nodes takes min(splits, ceil(L / 128))
//   contiguous slices, each one warp of the grid's y axis; the warps of
//   the other slices return at once.  A lane of one slice writes its
//   plan; otherwise each warp writes its partial (k1, k2, k3, idx, first
//   step) and the last warp of the lane to arrive, on an acquire-release
//   arrival counter, merges them in the same launch and resets the
//   counter (every launch leaves the counters at 0, so a CUDA graph
//   replays right).
// - Lanes share node reads through L1: a block holds `lanes_per_block`
//   consecutive lanes at the same slice index, so lanes at one prefix
//   (a fleet's first round: all at the root) read the same node lines.
//
// Exactness (the plain versions in kernels/trie_plan.py agree bit for bit):
// - keys (-acc, d_cost, d_lat, idx) for max_acc, (d_cost, d_lat, depth,
//   idx) for min_cost, compared exactly in float32, the full tuple at
//   every step (a thread's scan, the shuffles, the merge of slices), so
//   ties go to the lowest node index whatever the slices;
// - every product and sum of the delay and budget arithmetic is written
//   __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot contract it into an
//   FMA, the delay summed over m = 0..M-1 left to right; no tensor cores;
// - keys stay floats and are compared as floats: k1 = -acc[v] is -0.0
//   where acc is 0, which compares equal to +0.0 and leaves the next key
//   to decide, as in the plain versions (an integer packing of the keys
//   would have to map -0.0 to +0.0 first);
// - a lane whose prefix is not a node of the trie returns -1.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro {

constexpr int kMinCost = 0;
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLanesPerBlock = 8;  // warps of a block
constexpr int kMaxSplits = 64;        // slices of a lane at most
constexpr int kSliceNodes = 128;      // nodes a slice at least

struct PlanArgs {
  const float *terminal, *depth, *acc, *cost, *lat;
  const float* blocked;  // null: no column blocked
  const int* subtree;
  const float* counts;
  const int *path_models, *engine_of_model, *prefixes;
  const float *elapsed_lat, *delays;
  int N, M, Dmax, E, B, kind, splits;
  float floor_eff, cap_eff, lat_cap;
  int4* partial;     // [B][splits] (k1, k2, k3, idx) as bits; splits > 1
  int* partial_nxt;  // [B][splits] the first step of each partial
  int* counters;     // [B] arrival counters, 0 between launches
  int *tgt, *nxt;
};

struct Key {
  float k1, k2, k3;
  int idx;
};

// What the scan needs of the lane's prefix u: its depth, latency, cost
// and delay, the first-step column min(depth[u], Dmax - 1), and the
// remaining-latency threshold.
struct Prefix {
  float depth, lat, cost, delay, thr;
  int dcol;
};

__device__ __forceinline__ bool lex_less(const Key& a, const Key& b) {
  if (a.k1 != b.k1) return a.k1 < b.k1;
  if (a.k2 != b.k2) return a.k2 < b.k2;
  if (a.k3 != b.k3) return a.k3 < b.k3;
  return a.idx < b.idx;
}

__device__ __forceinline__ Key shfl_xor_key(const Key& k, int o) {
  return {__shfl_xor_sync(kFull, k.k1, o), __shfl_xor_sync(kFull, k.k2, o),
          __shfl_xor_sync(kFull, k.k3, o), __shfl_xor_sync(kFull, k.idx, o)};
}

// The delay of one node: the sum over models, left to right, of
// counts[m] * pmd[m], each operation rounded on its own.  With kM > 0 the
// M delays sit in every thread's registers (pmd); else thread m % 32
// holds model m's (pmd_lo for m < 32, pmd_hi above) and a shuffle
// broadcasts it (every thread of the warp must call this).
// With kM 2, 4 or 8 the counts row is read in 8- or 16-byte vectors (the
// launcher takes kM = 0 for a counts array not aligned to them).
template <int kM>
__device__ __forceinline__ float node_delay(const float* __restrict__ row,
                                            const float (&pmd)[kM > 0 ? kM : 1],
                                            float pmd_lo, float pmd_hi, int M) {
  float d = 0.f;
  if constexpr (kM > 0) {
    static_assert(kM == 2 || kM % 4 == 0, "counts rows are read as vectors");
    float c[kM];
    if constexpr (kM == 2) {
      const float2 x = *reinterpret_cast<const float2*>(row);
      c[0] = x.x;
      c[1] = x.y;
    } else {
#pragma unroll
      for (int m = 0; m < kM; m += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + m);
        c[m] = x.x;
        c[m + 1] = x.y;
        c[m + 2] = x.z;
        c[m + 3] = x.w;
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) d = __fadd_rn(d, __fmul_rn(c[m], pmd[m]));
  } else {
    for (int m = 0; m < M; ++m) {
      const float x = __shfl_sync(kFull, m < 32 ? pmd_lo : pmd_hi, m & 31);
      d = __fadd_rn(d, __fmul_rn(row[m], x));
    }
  }
  return d;
}

__device__ __forceinline__ void write_plan(const PlanArgs& p, int b, int u,
                                           int idx, int first) {
  p.tgt[b] = idx == INT_MAX ? -1 : idx;
  p.nxt[b] = idx == INT_MAX || idx == u ? -1 : first;
}

// A warp's scan of nodes [lo, hi): thread t takes lo + t, lo + t + 32, ...
// and keeps its lexicographic best and that node's first step, kStrides
// strides of 32 nodes an iteration.  Every column of an iteration is
// loaded before any mask, at indices clamped into the trie; the first
// iteration's loads need lo only, not hi.
constexpr int kStrides = 4;  // strides an iteration: 4 read faster than 1 or 2

template <int kM>
__device__ __forceinline__ void scan_slice(const PlanArgs& p, int lo, int hi, int lane,
                                           const float (&pmd)[kM > 0 ? kM : 1],
                                           float pmd_lo, float pmd_hi, int M,
                                           const Prefix& x, Key& best,
                                           int& best_first) {
  int base = lo;
  do {
    float term[kStrides], blk[kStrides], cv[kStrides], lv[kStrides], av[kStrides];
    float dv[kStrides], delay[kStrides];
    int first[kStrides];
#pragma unroll
    for (int i = 0; i < kStrides; ++i) {
      const int vc = min(base + 32 * i + lane, p.N - 1);
      term[i] = p.terminal[vc];
      blk[i] = p.blocked ? p.blocked[vc] : 0.f;
      cv[i] = p.cost[vc];
      lv[i] = p.lat[vc];
      av[i] = p.acc[vc];
      dv[i] = p.depth[vc];
      first[i] = p.path_models[static_cast<size_t>(vc) * p.Dmax + x.dcol];
      delay[i] = node_delay<kM>(p.counts + static_cast<size_t>(vc) * M, pmd, pmd_lo,
                                pmd_hi, M);
    }
#pragma unroll
    for (int i = 0; i < kStrides; ++i) {
      const int v = base + 32 * i + lane;
      const float d_lat = __fadd_rn(__fsub_rn(lv[i], x.lat), __fsub_rn(delay[i], x.delay));
      const float d_cost = __fsub_rn(cv[i], x.cost);
      bool feas = v < hi && term[i] > 0.5f && blk[i] <= x.depth && cv[i] <= p.cap_eff &&
                  d_lat <= x.thr;
      Key cand;
      if (p.kind == kMinCost) {
        feas = feas && av[i] >= p.floor_eff;
        cand = {d_cost, d_lat, dv[i], v};
      } else {
        cand = {-av[i], d_cost, d_lat, v};
      }
      if (feas && lex_less(cand, best)) {
        best = cand;
        best_first = first[i];
      }
    }
    base += 32 * kStrides;
  } while (base < hi);
}

template <int kM, bool kSplit>
__global__ void __launch_bounds__(kMaxLanesPerBlock * 32)
trie_plan_kernel(const PlanArgs p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= p.B) return;
  const int s = kSplit ? static_cast<int>(blockIdx.y) : 0;
  const int M = kM > 0 ? kM : p.M;

  // the lane's operands and its per-model delays: independent loads
  const int u = p.prefixes[b];
  const float el = p.elapsed_lat[b];
  const float* drow = p.delays + static_cast<size_t>(b) * p.E;
  float pmd[kM > 0 ? kM : 1];
  float pmd_lo = 0.f, pmd_hi = 0.f;
  if constexpr (kM > 0) {
#pragma unroll
    for (int m = 0; m < kM; ++m) pmd[m] = drow[p.engine_of_model[m]];
  } else {
    if (lane < M) pmd_lo = drow[p.engine_of_model[lane]];
    if (lane + 32 < M) pmd_hi = drow[p.engine_of_model[lane + 32]];
  }
  if (u < 0 || u >= p.N) {  // not a node of this trie: no plan
    if (s == 0 && lane == 0) p.tgt[b] = p.nxt[b] = -1;
    return;
  }

  // the prefix row
  const int size = p.subtree[u];
  Prefix x;
  x.depth = p.depth[u];
  x.lat = p.lat[u];
  x.cost = p.cost[u];
  x.delay = node_delay<kM>(p.counts + static_cast<size_t>(u) * M, pmd, pmd_lo, pmd_hi, M);
  x.dcol = min(static_cast<int>(x.depth), p.Dmax - 1);
  x.thr = __fadd_rn(__fsub_rn(p.lat_cap, el), 1e-6f);

  // this warp's slice [lo, hi) of the lane's interval: slice 0 starts at
  // u, so its first loads need not wait for subtree[u]
  Key best = {kBig, kBig, kBig, INT_MAX};
  int best_first = -1;
  int lo = u, nslices = 1;
  if constexpr (kSplit) {
    nslices = min(p.splits, (size + kSliceNodes - 1) / kSliceNodes);
    if (s == 0) {
      scan_slice<kM>(p, u, u + size / nslices, lane, pmd, pmd_lo, pmd_hi, M, x, best,
                     best_first);
    } else {
      if (s >= nslices) return;  // a narrow lane: fewer slices
      lo = u + static_cast<int>(static_cast<long long>(size) * s / nslices);
      const int hi = u + static_cast<int>(static_cast<long long>(size) * (s + 1) / nslices);
      scan_slice<kM>(p, lo, hi, lane, pmd, pmd_lo, pmd_hi, M, x, best, best_first);
    }
  } else {
    scan_slice<kM>(p, u, u + size, lane, pmd, pmd_lo, pmd_hi, M, x, best, best_first);
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Key other = shfl_xor_key(best, o);
    if (lex_less(other, best)) best = other;
  }
  // node v was scanned by thread (v - lo) % 32: the winner's first step
  const int first = __shfl_sync(kFull, best_first, (best.idx - lo) & 31);
  if (nslices == 1) {
    if (lane == 0) write_plan(p, b, u, best.idx, first);
    return;
  }

  // one of several slices: publish the partial, and the last to arrive
  // merges.  Thread 0 writes the partial and arrives (its release orders
  // the write first); its acquire and the warp barrier after it order
  // every other slice's partial before this warp's reads.
  const size_t row = static_cast<size_t>(b) * p.splits;
  int last = 0;
  if (lane == 0) {
    p.partial[row + s] = make_int4(__float_as_int(best.k1), __float_as_int(best.k2),
                                   __float_as_int(best.k3), best.idx);
    p.partial_nxt[row + s] = first;
    last = arrive_acq_rel(p.counters + b) == nslices - 1;
  }
  if (!__shfl_sync(kFull, last, 0)) return;
  __syncwarp();
  Key m = {kBig, kBig, kBig, INT_MAX};
  int m_first = -1;
  for (int j = lane; j < nslices; j += 32) {
    const int4 q = __ldcg(p.partial + row + j);
    const Key k = {__int_as_float(q.x), __int_as_float(q.y), __int_as_float(q.z), q.w};
    const int f = __ldcg(p.partial_nxt + row + j);
    if (lex_less(k, m)) {
      m = k;
      m_first = f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Key other = shfl_xor_key(m, o);
    const int other_first = __shfl_xor_sync(kFull, m_first, o);
    if (lex_less(other, m)) {
      m = other;
      m_first = other_first;
    }
  }
  if (lane == 0) {
    write_plan(p, b, u, m.idx, m_first);
    p.counters[b] = 0;  // ready for the next launch
  }
}

template <int kM>
void launch_plan(const PlanArgs& p, int lanes_per_block, cudaStream_t stream) {
  const dim3 grid((p.B + lanes_per_block - 1) / lanes_per_block, p.splits);
  const int threads = 32 * lanes_per_block;
  if (p.splits > 1) {
    trie_plan_kernel<kM, true><<<grid, threads, 0, stream>>>(p);
  } else {
    trie_plan_kernel<kM, false><<<grid, threads, 0, stream>>>(p);
  }
}

}  // namespace repro

extern "C" int repro_trie_plan(const void* terminal, const void* depth,
                               const void* acc, const void* cost,
                               const void* lat, const void* blocked,
                               const void* subtree, const void* counts,
                               const void* path_models,
                               const void* engine_of_model,
                               const void* prefixes, const void* elapsed_lat,
                               const void* delays, int N, int M, int Dmax,
                               int E, int B, float floor_eff, float cap_eff,
                               float lat_cap, int kind, int splits,
                               int lanes_per_block, void* ws, void* counters,
                               void* tgt, void* nxt, void* stream) {
  using namespace repro;
  if (B <= 0 || N <= 0 || M <= 0 || M > 64 || splits < 1 || splits > kMaxSplits ||
      lanes_per_block < 1 || lanes_per_block > kMaxLanesPerBlock ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return kStatusBadArgs;
  }
  PlanArgs p;
  p.terminal = static_cast<const float*>(terminal);
  p.depth = static_cast<const float*>(depth);
  p.acc = static_cast<const float*>(acc);
  p.cost = static_cast<const float*>(cost);
  p.lat = static_cast<const float*>(lat);
  p.blocked = static_cast<const float*>(blocked);
  p.subtree = static_cast<const int*>(subtree);
  p.counts = static_cast<const float*>(counts);
  p.path_models = static_cast<const int*>(path_models);
  p.engine_of_model = static_cast<const int*>(engine_of_model);
  p.prefixes = static_cast<const int*>(prefixes);
  p.elapsed_lat = static_cast<const float*>(elapsed_lat);
  p.delays = static_cast<const float*>(delays);
  p.N = N;
  p.M = M;
  p.Dmax = Dmax;
  p.E = E;
  p.B = B;
  p.kind = kind;
  p.splits = splits;
  p.floor_eff = floor_eff;
  p.cap_eff = cap_eff;
  p.lat_cap = lat_cap;
  p.partial = static_cast<int4*>(ws);
  p.partial_nxt = ws ? reinterpret_cast<int*>(p.partial + static_cast<size_t>(B) * splits)
                     : nullptr;
  p.counters = static_cast<int*>(counters);
  p.tgt = static_cast<int*>(tgt);
  p.nxt = static_cast<int*>(nxt);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // pool widths 2, 4 and 8 (the paper's presets) read counts rows as
  // vectors, which needs the array aligned to them
  const int vec = M == 2 ? 8 : 16;
  switch (reinterpret_cast<uintptr_t>(counts) % vec == 0 ? M : 0) {
    case 2: launch_plan<2>(p, lanes_per_block, s); break;
    case 4: launch_plan<4>(p, lanes_per_block, s); break;
    case 8: launch_plan<8>(p, lanes_per_block, s); break;
    default: launch_plan<0>(p, lanes_per_block, s); break;
  }
  return launch_status();
}
