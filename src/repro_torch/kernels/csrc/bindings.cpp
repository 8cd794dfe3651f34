// Python bindings of the port's CUDA kernels (pybind11 only: no PyTorch
// headers, so this file builds in seconds).  Each function takes raw
// device pointers, sizes and the CUDA stream as integers from the Python
// wrappers in repro_torch/kernels/, which check devices, dtypes, shapes
// and contiguity first.  A launch the runtime refuses raises RuntimeError.

#include <pybind11/pybind11.h>

#include <cstdint>
#include <stdexcept>
#include <string>

extern "C" {
int repro_trie_plan(const void*, const void*, const void*, const void*,
                    const void*, const void*, const void*, const void*,
                    const void*, const void*, const void*, const void*,
                    const void*, int, int, int, int, int, float, float, float,
                    int, int, int, void*, void*, void*, void*, void*);
int repro_flash_attention(const void*, const void*, const void*, void*, void*,
                          int, int, int, int, int, int, float, int, int, int,
                          int, int, void*);
double repro_flash_encode_ns(const void*, const void*, const void*, int, int,
                             int, int, int, int, int, int);
int repro_flash_attention_bwd(const void*, const void*, const void*,
                              const void*, const void*, const void*, void*,
                              void*, void*, void*, int, int, int, int, int,
                              int, float, int, int, int, int, int, int, int,
                              int, int, int, void*);
int repro_flash_bwd_max_clusters(int, int, int, int, int, int*);
int repro_flash_bwd_dq_blocks(int, int, int*);
int repro_decode_attention(const void*, const void*, const void*, const void*,
                           void*, int, int, int, int, int, int, int, int, int,
                           float, int, int, void*);
int repro_decode_max_clusters(int, int, int, int, int, int, int, int*);
int repro_rms_norm(const void*, const void*, void*, int, int, float, int,
                   void*);
int repro_ssd_scan(const void*, const void*, const void*, const void*,
                   const void*, const void*, void*, void*, int, int, int, int,
                   int, int, int, int, void*);
int repro_ssd_smem_bytes(int, int, int);
const char* repro_error_string(int);
}

namespace {

using ptr = std::uintptr_t;

void* P(ptr p) { return reinterpret_cast<void*>(p); }

void check(int status, const char* kernel) {
  if (status != 0) {
    throw std::runtime_error(std::string(kernel) + " launch failed: " +
                             repro_error_string(status));
  }
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("trie_plan",
        [](ptr terminal, ptr depth, ptr acc, ptr cost, ptr lat, ptr blocked,
           ptr subtree, ptr counts, ptr path_models, ptr eom, ptr prefixes,
           ptr elapsed_lat, ptr delays, int N, int M, int Dmax, int E, int B,
           float floor_eff, float cap_eff, float lat_cap, int kind,
           int splits, int lanes_per_block, ptr ws, ptr counters, ptr tgt,
           ptr nxt, ptr stream) {
          check(repro_trie_plan(P(terminal), P(depth), P(acc), P(cost), P(lat),
                                blocked ? P(blocked) : nullptr, P(subtree),
                                P(counts), P(path_models), P(eom),
                                P(prefixes), P(elapsed_lat), P(delays), N, M,
                                Dmax, E, B, floor_eff, cap_eff, lat_cap, kind,
                                splits, lanes_per_block,
                                ws ? P(ws) : nullptr,
                                counters ? P(counters) : nullptr, P(tgt),
                                P(nxt), P(stream)),
                "trie_plan");
        });
  m.def("flash_attention",
        [](ptr q, ptr k, ptr v, ptr o, ptr lse, int B, int H, int KV, int Sq,
           int Sk, int D, float scale, int causal, int window, int dtype,
           int rows, int keys, ptr stream) {
          check(repro_flash_attention(P(q), P(k), P(v), P(o),
                                      lse ? P(lse) : nullptr, B, H, KV, Sq,
                                      Sk, D, scale, causal, window, dtype,
                                      rows, keys, P(stream)),
                "flash_attention");
        });
  m.def("flash_encode_ns",
        [](ptr q, ptr k, ptr v, int B, int H, int KV, int Sq, int Sk, int D,
           int rows, int reps) {
          return repro_flash_encode_ns(P(q), P(k), P(v), B, H, KV, Sq, Sk, D,
                                       rows, reps);
        });
  m.def("flash_attention_bwd",
        [](ptr q, ptr k, ptr v, ptr o, ptr lse, ptr dout, ptr delta, ptr dq,
           ptr dk, ptr dv, int B, int H, int KV, int Sq, int Sk, int D,
           float scale, int causal, int window, int dtype, int dq_rows,
           int kv_keys, int kv_rows, int heads, int cluster, int stages,
           int parts, ptr stream) {
          check(repro_flash_attention_bwd(P(q), P(k), P(v), P(o), P(lse),
                                          P(dout), P(delta), P(dq), P(dk),
                                          P(dv), B, H, KV, Sq, Sk, D, scale,
                                          causal, window, dtype, dq_rows,
                                          kv_keys, kv_rows, heads, cluster,
                                          stages, parts, P(stream)),
                "flash_attention_bwd");
        });
  m.def("flash_bwd_dq_blocks", [](int D, int rows) {
    int n = 0;
    check(repro_flash_bwd_dq_blocks(D, rows, &n),
          "flash_bwd_dq_blocks");
    return n;
  });
  m.def("flash_bwd_max_clusters",
        [](int D, int keys, int rows, int stages, int cluster) {
          int n = 0;
          check(repro_flash_bwd_max_clusters(D, keys, rows, stages, cluster,
                                             &n),
                "flash_bwd_max_clusters");
          return n;
        });
  m.def("decode_attention",
        [](ptr q, ptr kc, ptr vc, ptr lens, ptr o, int B, int H, int KV,
           int S, int D, int cluster, int slices, int hc, int stages,
           float scale, int window, int dtype, ptr stream) {
          check(repro_decode_attention(P(q), P(kc), P(vc), P(lens), P(o), B,
                                       H, KV, S, D, cluster, slices, hc,
                                       stages, scale, window, dtype,
                                       P(stream)),
                "decode_attention");
        });
  m.def("decode_max_clusters",
        [](int D, int G, int cluster, int slices, int hc, int stages,
           int dtype) {
          int n = 0;
          check(repro_decode_max_clusters(D, G, cluster, slices, hc, stages,
                                          dtype, &n),
                "decode_max_clusters");
          return n;
        });
  m.def("rms_norm",
        [](ptr x, ptr scale, ptr out, int rows, int D, float eps, int dtype,
           ptr stream) {
          check(repro_rms_norm(P(x), P(scale), P(out), rows, D, eps, dtype,
                               P(stream)),
                "rms_norm");
        });
  m.def("ssd_scan",
        [](ptr x, ptr dt, ptr A, ptr Bm, ptr Cm, ptr h0, ptr y, ptr hout,
           int B, int S, int Hn, int hd, int N, int Q, int dtype, int runs,
           ptr stream) {
          check(repro_ssd_scan(P(x), P(dt), P(A), P(Bm), P(Cm),
                               h0 ? P(h0) : nullptr, P(y),
                               hout ? P(hout) : nullptr, B, S, Hn, hd, N, Q,
                               dtype, runs, P(stream)),
                "ssd_scan");
        });
  m.def("ssd_smem_bytes", &repro_ssd_smem_bytes);
}
