// Fused fleet replan for Hopper: one exact constrained trie search per
// request lane, emitting (target node, next model).
//
// Replaces repro/kernels/trie_plan.py::_trie_plan_kernel.  The Pallas
// kernel walks (node tiles x lane blocks) with node tiles OUTER, carries
// each lane's running lexicographic minima in VMEM scratch across the node
// axis, and rewrites its output on every node tile: it relies on the TPU
// running the grid in order.  GPU blocks run at once and in no order, so
// none of that structure carries over.  Here one block owns one lane: the
// preorder trie puts every candidate of prefix u in [u, u + subtree[u]),
// so the block's threads stride over that interval only, each keeps a
// lexicographic best (k1, k2, k3, idx), and one block reduction on the
// same total order gives the winner.  Its first step is a direct read of
// path_models[target, depth[u]] (no one-hot contraction).
//
// Keys: (-acc, d_cost, d_lat, idx) for max_acc, (d_cost, d_lat, depth,
// idx) for min_cost, compared exactly in float32, ties to the lowest node
// index.  Every product and sum of the delay and budget arithmetic is
// written with __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot contract
// it into an FMA: the plain version (kernels/trie_plan.py) rounds each
// operation on its own, and the two agree bit for bit.
//
// What bounds it: neither bytes nor flops, but launch latency and the
// serial interval scan of the deepest lane.  A mathqa_4 root lane scans
// 5461 nodes (~43 per thread); a nl2sql_2 trie has 31 nodes in all.

#include <climits>

#include "common.cuh"

namespace repro {

constexpr int kPlanThreads = 128;
constexpr int kMaxModels = 64;
constexpr int kMinCost = 0;
constexpr float kBig = 1e30f;

struct Best {
  float k1, k2, k3;
  int idx;
};

__device__ __forceinline__ bool lex_less(const Best& a, const Best& b) {
  if (a.k1 != b.k1) return a.k1 < b.k1;
  if (a.k2 != b.k2) return a.k2 < b.k2;
  if (a.k3 != b.k3) return a.k3 < b.k3;
  return a.idx < b.idx;
}

// sum over models, left to right, of counts[m] * pmd[m], each operation
// rounded on its own
__device__ __forceinline__ float path_delay(const float* __restrict__ counts,
                                            const float* pmd, int M) {
  float d = 0.f;
  for (int m = 0; m < M; ++m) d = __fadd_rn(d, __fmul_rn(counts[m], pmd[m]));
  return d;
}

__global__ void __launch_bounds__(kPlanThreads)
trie_plan_kernel(const float* __restrict__ terminal,
                 const float* __restrict__ depth,
                 const float* __restrict__ acc, const float* __restrict__ cost,
                 const float* __restrict__ lat,
                 const float* __restrict__ blocked,
                 const int* __restrict__ subtree,
                 const float* __restrict__ counts,
                 const int* __restrict__ path_models,
                 const int* __restrict__ engine_of_model,
                 const int* __restrict__ prefixes,
                 const float* __restrict__ elapsed_lat,
                 const float* __restrict__ delays, int N, int M, int Dmax,
                 int E, float floor_eff, float cap_eff, float lat_cap,
                 int kind, int* __restrict__ tgt, int* __restrict__ nxt) {
  __shared__ float pmd[kMaxModels];
  __shared__ Best warp_best[kPlanThreads / 32];
  const int b = blockIdx.x;
  const int u = prefixes[b];
  if (u < 0 || u >= N) {  // not a node of this trie: no plan
    if (threadIdx.x == 0) tgt[b] = nxt[b] = -1;
    return;
  }
  for (int m = threadIdx.x; m < M; m += kPlanThreads) {
    pmd[m] = delays[static_cast<size_t>(b) * E + engine_of_model[m]];
  }
  __syncthreads();

  const int lo = u, hi = u + subtree[u];
  const int du = static_cast<int>(depth[u]);
  const float du_f = static_cast<float>(du);
  const float lat_u = lat[u], cost_u = cost[u];
  const float delay_u = path_delay(counts + static_cast<size_t>(u) * M, pmd, M);
  const float thr = __fadd_rn(__fsub_rn(lat_cap, elapsed_lat[b]), 1e-6f);

  Best best = {kBig, kBig, kBig, INT_MAX};
  for (int v = lo + threadIdx.x; v < hi; v += kPlanThreads) {
    if (!(terminal[v] > 0.5f) || !(blocked[v] <= du_f)) continue;
    const float cv = cost[v];
    if (!(cv <= cap_eff)) continue;
    const float dv = path_delay(counts + static_cast<size_t>(v) * M, pmd, M);
    const float d_lat = __fadd_rn(__fsub_rn(lat[v], lat_u), __fsub_rn(dv, delay_u));
    if (!(d_lat <= thr)) continue;
    const float d_cost = __fsub_rn(cv, cost_u);
    Best cand;
    if (kind == kMinCost) {
      if (!(acc[v] >= floor_eff)) continue;
      cand = {d_cost, d_lat, depth[v], v};
    } else {
      cand = {-acc[v], d_cost, d_lat, v};
    }
    if (lex_less(cand, best)) best = cand;
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Best other;
    other.k1 = __shfl_xor_sync(0xffffffffu, best.k1, o);
    other.k2 = __shfl_xor_sync(0xffffffffu, best.k2, o);
    other.k3 = __shfl_xor_sync(0xffffffffu, best.k3, o);
    other.idx = __shfl_xor_sync(0xffffffffu, best.idx, o);
    if (lex_less(other, best)) best = other;
  }
  if (threadIdx.x % 32 == 0) warp_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    Best r = warp_best[0];
    for (int w = 1; w < kPlanThreads / 32; ++w) {
      if (lex_less(warp_best[w], r)) r = warp_best[w];
    }
    if (r.idx == INT_MAX) {
      tgt[b] = nxt[b] = -1;
    } else {
      tgt[b] = r.idx;
      nxt[b] = r.idx == lo ? -1
                           : path_models[static_cast<size_t>(r.idx) * Dmax + min(du, Dmax - 1)];
    }
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
                               float lat_cap, int kind, void* tgt, void* nxt,
                               void* stream) {
  using namespace repro;
  trie_plan_kernel<<<B, kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(terminal), static_cast<const float*>(depth),
      static_cast<const float*>(acc), static_cast<const float*>(cost),
      static_cast<const float*>(lat), static_cast<const float*>(blocked),
      static_cast<const int*>(subtree), static_cast<const float*>(counts),
      static_cast<const int*>(path_models),
      static_cast<const int*>(engine_of_model),
      static_cast<const int*>(prefixes), static_cast<const float*>(elapsed_lat),
      static_cast<const float*>(delays), N, M, Dmax, E, floor_eff, cap_eff,
      lat_cap, kind, static_cast<int*>(tgt), static_cast<int*>(nxt));
  return launch_status();
}
