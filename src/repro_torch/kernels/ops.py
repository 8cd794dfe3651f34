"""Kernel dispatch on the device of the operands (`repro.kernels.ops`).

A CUDA tensor goes to the hand-written CUDA kernel; a CPU tensor, which
exists only because the caller asked for the CPU, goes to the plain
PyTorch version.  A kernel that fails to build or launch raises: nothing
here catches it and switches to the plain version.  Inference only.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as _cuda_decode
from repro_torch.kernels.flash_attention import flash_attention as _cuda_flash
from repro_torch.kernels.rmsnorm import rms_norm as _cuda_rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan as _cuda_ssd
from repro_torch.kernels.trie_plan import bind as _bind_cuda_plan
from repro_torch.kernels.trie_plan import fleet_plan_blocked, trie_plan_cuda


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """(B,H,Sq,D) x (B,KV,Sk,D)^2 -> (B,H,Sq,D) grouped-query attention."""
    if q.is_cuda:
        return _cuda_flash(q, k, v, causal=causal, window=window)
    return ref.attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """(B,H,D) x (B,KV,S,D)^2 with (B,) int32 lengths -> (B,H,D)."""
    if q.is_cuda:
        return _cuda_decode(q, k_cache, v_cache, cache_len, window=window)
    return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                window=window)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis, computed in float32."""
    if x.is_cuda:
        return _cuda_rmsnorm(x, scale, eps)
    return ref.rms_norm(x, scale, eps)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
             return_state: bool = False):
    """Mamba2 SSD chunked scan: x (B,S,Hn,P), dt (B,S,Hn), A (Hn,), Bm/Cm
    (B,S,N), optional ``init_state`` (B,Hn,P,N) -> y [, final state].

    `repro` runs its Pallas kernel only for the stateless form and falls
    to XLA otherwise; here every form takes the kernel on the card."""
    fn = _cuda_ssd if x.is_cuda else ref.ssd_scan_chunked
    return fn(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state,
              return_state=return_state)


def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """One-token SSD update -> (y, new state).  Plain PyTorch on every
    device: `repro` has no kernel for it either."""
    return ref.ssd_decode_step(x, dt, A, Bm, Cm, state)


TRIE_PLAN_VARIANTS = ("dense", "fused", "cuda")


def default_plan_variant(device) -> str:
    """The kernel on a CUDA device, the plain blocked version on the CPU."""
    return "cuda" if device.type == "cuda" else "fused"


def trie_plan(terminal, depth, acc, cost, lat, subtree_size, path_models,
              path_counts, engine_of_model, prefixes, elapsed_lat,
              elapsed_cost, engine_delays, acc_floor, cost_cap, lat_cap,
              *, kind: str, variant: str | None = None, blocked_depth=None):
    """Fused fleet replan -> (targets, next_models), both (B,) int32.

    ``variant``: "cuda" — the kernel (`csrc/trie_plan.cu`), CUDA tensors
    only; "fused" — the plain blocked version (`trie_plan.fleet_plan_
    blocked`); "dense" — the plain dense oracle (`ref.fleet_plan`).  All
    three pick the identical node.  ``None`` picks by device (see
    `default_plan_variant`).  The plain variants run on whatever device
    their operands lie on."""
    if variant is None:
        variant = default_plan_variant(prefixes.device)
    if variant == "cuda":
        if not prefixes.is_cuda:
            raise ValueError("trie_plan variant 'cuda' needs CUDA tensors; "
                             "use 'fused' or 'dense' on the CPU")
        fn = trie_plan_cuda
    elif variant == "fused":
        fn = fleet_plan_blocked
    elif variant == "dense":
        return ref.fleet_plan(
            terminal, depth, acc, cost, lat, subtree_size, path_models,
            engine_of_model, prefixes, elapsed_lat, elapsed_cost,
            engine_delays, acc_floor, cost_cap, lat_cap, kind=kind,
            blocked_depth=blocked_depth)
    else:
        raise ValueError(f"unknown trie_plan variant {variant!r}: "
                         f"{TRIE_PLAN_VARIANTS}")
    return fn(terminal, depth, acc, cost, lat, subtree_size, path_models,
              path_counts, engine_of_model, prefixes, elapsed_lat,
              elapsed_cost, engine_delays, acc_floor, cost_cap, lat_cap,
              kind=kind, blocked_depth=blocked_depth)


def bind_trie_plan(terminal, depth, acc, cost, lat, subtree_size,
                   path_models, path_counts, engine_of_model, prefixes,
                   elapsed_lat, engine_delays, acc_floor, cost_cap, lat_cap,
                   *, kind: str, variant: str | None = None,
                   blocked_depth=None):
    """`trie_plan` bound to its operands: returns ``launch(out)``, which
    runs the replan on the operands' contents at call time and writes
    (targets, next_models) into the rows of ``out``, a (2, B) int32
    tensor on their device.  "cuda" checks the operands once, here
    (`trie_plan.bind`), so a caller that rewrites them in place launches
    again without a check; the plain variants compute and copy."""
    if variant is None:
        variant = default_plan_variant(prefixes.device)
    if variant == "cuda":
        if not prefixes.is_cuda:
            raise ValueError("trie_plan variant 'cuda' needs CUDA tensors; "
                             "use 'fused' or 'dense' on the CPU")
        return _bind_cuda_plan(
            terminal, depth, acc, cost, lat, subtree_size, path_models,
            path_counts, engine_of_model, prefixes, elapsed_lat,
            engine_delays, acc_floor, cost_cap, lat_cap, kind=kind,
            blocked_depth=blocked_depth)
    if variant not in TRIE_PLAN_VARIANTS:
        raise ValueError(f"unknown trie_plan variant {variant!r}: "
                         f"{TRIE_PLAN_VARIANTS}")

    def launch(out):
        tgt, nxt = trie_plan(
            terminal, depth, acc, cost, lat, subtree_size, path_models,
            path_counts, engine_of_model, prefixes, elapsed_lat, None,
            engine_delays, acc_floor, cost_cap, lat_cap, kind=kind,
            variant=variant, blocked_depth=blocked_depth)
        out[0].copy_(tgt)
        out[1].copy_(nxt)

    return launch
