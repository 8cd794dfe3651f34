"""Binding of `csrc/flash_attention.cu`: causal / sliding-window GQA
attention forward with an online softmax (`repro.kernels.flash_attention`
counterpart; the plain version is `ref.attention`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# head dimensions compiled into csrc/flash_attention.cu and decode_attention.cu
HEAD_DIMS = (32, 64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """(B,H,Sq,D) x (B,KV,Sk,D)^2 -> (B,H,Sq,D) on the card, with scale
    ``D**-0.5``; query head ``h`` reads kv head ``h // (H // KV)``.  Any
    sequence length works: the kernel masks ragged tiles itself."""
    _build.check_cuda("flash_attention", q, k, v)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if D not in HEAD_DIMS or k.shape != (B, KV, Sk, D) or v.shape != k.shape \
            or H % KV:
        raise ValueError(f"flash_attention: unsupported shapes q {q.shape},"
                         f" k {k.shape}, v {v.shape} (head dim in "
                         f"{HEAD_DIMS}, H a multiple of KV)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    _build.extension().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        Sq, Sk, D, D ** -0.5, int(causal), int(window), DTYPES[q.dtype],
        _build.stream_of(q))
    _build.count_launch("flash_attention")
    return out
