"""Bindings of `csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`:
causal / sliding-window GQA attention forward with an online softmax
(`repro.kernels.flash_attention` counterpart; the plain versions are
`ref.attention` and `ref.attention_fwd`) and its backward
(`repro.kernels.xla_flash._flash_bwd_impl` counterpart; the plain version
is `ref.attention_bwd`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# head dimensions compiled into csrc/flash_attention.cu and
# flash_attention_bwd.cu (96: MLA's 64 + 32 query/key dims)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(name, q, k, v):
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS or k.shape != (B, KV, Sk, D) or v.shape != k.shape \
            or H % KV:
        raise ValueError(f"{name}: unsupported shapes q {q.shape}, k "
                         f"{k.shape}, v {v.shape} (head dim in {HEAD_DIMS},"
                         f" H a multiple of KV)")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """(B,H,Sq,D) x (B,KV,Sk,D)^2 -> (B,H,Sq,D) on the card, with scale
    ``D**-0.5``; query head ``h`` reads kv head ``h // (H // KV)``.  Any
    sequence length works: the kernel masks ragged tiles itself.  With
    ``return_lse`` also the float32 (B,H,Sq) log-sum-exp of each row's
    scaled scores (the flash backward's residual); without it the kernel
    writes none."""
    _build.check_cuda("flash_attention", q, k, v)
    _check("flash_attention", q, k, v)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel():
        _build.extension().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(), B, H, KV, Sq, Sk, D,
            D ** -0.5, int(causal), int(window), DTYPES[q.dtype],
            _build.stream_of(q))
        _build.count_launch("flash_attention")
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """The flash backward on the card: from the operands, the forward's
    output ``o`` and float32 ``lse`` (B,H,Sq), and the output gradient
    ``do`` -> (dq, dk, dv) in the operands' dtype, every sum in float32.
    Deterministic: dK and dV of a kv head sum its query heads inside one
    block, and dQ is written by the block that owns its rows.  One call is
    one counted launch (two kernels: dQ, then dK and dV)."""
    _build.check_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    _check("flash_attention_bwd", q, k, v)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or \
            do.dtype != q.dtype or lse.shape != (B, H, Sq) or \
            lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: o {o.shape}/{o.dtype}, do "
                         f"{do.shape}/{do.dtype}, lse {lse.shape}/"
                         f"{lse.dtype} do not fit q {q.shape}/{q.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    _build.extension().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, KV, Sq, Sk, D, D ** -0.5,
        int(causal), int(window), DTYPES[q.dtype], _build.stream_of(q))
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv
