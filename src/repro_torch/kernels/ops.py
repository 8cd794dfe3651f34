"""Kernel dispatch on the device of the operands (`repro.kernels.ops`).

A CUDA tensor goes to the hand-written CUDA kernel; a CPU tensor, which
exists only because the caller asked for the CPU, goes to the plain
PyTorch version.  A kernel that fails to build or launch raises: nothing
here catches it and switches to the plain version.

`attention`, `rms_norm` and `ssd_scan` carry gradients on both devices,
each a `torch.autograd.Function` (`repro` wraps its Pallas forwards in
`jax.custom_vjp` the same way).  Attention saves its output and per-row
log-sum-exp and runs the flash backward: the CUDA kernel
(`flash_attention_bwd`) on the card, `ref.attention_bwd` on the CPU.
RMSNorm and the SSD scan have no backward kernel, in `repro` either: their
backward recomputes the plain version and takes its vector-Jacobian
product.  `decode_attention` and the replan are inference only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as _cuda_decode
from repro_torch.kernels.flash_attention import flash_attention as _cuda_flash
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd as _cuda_flash_bwd
from repro_torch.kernels.rmsnorm import rms_norm as _cuda_rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan as _cuda_ssd
from repro_torch.kernels.trie_plan import bind as _bind_cuda_plan
from repro_torch.kernels.trie_plan import fleet_plan_blocked, trie_plan_cuda


class _Attention(torch.autograd.Function):
    """Flash attention whose backward is the flash backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.is_cuda:
            o, lse = _cuda_flash(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        else:
            o, lse = ref.attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _cuda_flash_bwd if q.is_cuda else ref.attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """(B,H,Sq,D) x (B,KV,Sk,D)^2 -> (B,H,Sq,D) grouped-query attention.
    Without gradients to take, the forward alone runs (no log-sum-exp)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window)
    if q.is_cuda:
        return _cuda_flash(q, k, v, causal=causal, window=window)
    return ref.attention(q, k, v, causal=causal, window=window)


def _vjp(fn, inputs, needs, grads):
    """The gradients of ``fn(*inputs)`` (a tensor or a tuple of them) for
    the output gradients ``grads``, by autograd through ``fn`` recomputed
    here; None for the inputs whose ``needs`` flag is False."""
    with torch.enable_grad():
        live = [x.detach().requires_grad_(n) if x is not None else None
                for x, n in zip(inputs, needs)]
        outs = fn(*live)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], [x for x, n in zip(live, needs) if n],
            [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if n else None for n in needs)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm whose backward recomputes `ref.rms_norm`."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return (_cuda_rmsnorm if x.is_cuda else ref.rms_norm)(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds = _vjp(lambda a, b: ref.rms_norm(a, b, ctx.eps), (x, scale),
                      ctx.needs_input_grad[:2], (g,))
        return dx, ds, None


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis, computed in float32."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    if x.is_cuda:
        return _cuda_rmsnorm(x, scale, eps)
    return ref.rms_norm(x, scale, eps)


# `repro.kernels.ops._NAIVE_SSD_LEN`: up to this length `repro`'s plain
# path is the sequential scan, beyond it the chunked one
NAIVE_SSD_LEN = 256


class _SSDScan(torch.autograd.Function):
    """The SSD scan whose backward recomputes a plain version: the
    sequential `ref.ssd_scan` up to ``NAIVE_SSD_LEN`` steps (what `repro`'s
    backward recomputes), `ref.ssd_scan_chunked` beyond (`repro`'s plain
    path there; a loop over thousands of steps would launch per step)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk, return_state):
        fn = _cuda_ssd if x.is_cuda else ref.ssd_scan_chunked
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk, ctx.return_state = chunk, return_state
        return fn(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state,
                  return_state=return_state)

    @staticmethod
    def backward(ctx, *grads):
        x, dt, A, Bm, Cm, h0 = ctx.saved_tensors

        def plain(x, dt, A, Bm, Cm, h0):
            if x.shape[1] <= NAIVE_SSD_LEN:
                return ref.ssd_scan(x, dt, A, Bm, Cm, init_state=h0,
                                    return_state=ctx.return_state)
            return ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=ctx.chunk,
                                        init_state=h0,
                                        return_state=ctx.return_state)

        return _vjp(plain, (x, dt, A, Bm, Cm, h0), ctx.needs_input_grad[:6],
                    grads) + (None, None)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """(B,H,D) x (B,KV,S,D)^2 with (B,) int32 lengths -> (B,H,D)."""
    if q.is_cuda:
        return _cuda_decode(q, k_cache, v_cache, cache_len, window=window)
    return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                window=window)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
             return_state: bool = False):
    """Mamba2 SSD chunked scan: x (B,S,Hn,P), dt (B,S,Hn), A (Hn,), Bm/Cm
    (B,S,N), optional ``init_state`` (B,Hn,P,N) -> y [, final state].

    `repro` runs its Pallas kernel only for the stateless form and falls
    to XLA otherwise; here every form takes the kernel on the card."""
    operands = (x, dt, A, Bm, Cm, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        return _SSDScan.apply(x, dt, A, Bm, Cm, init_state, chunk,
                              return_state)
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
