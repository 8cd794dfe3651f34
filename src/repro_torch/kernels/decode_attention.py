"""Binding of `csrc/decode_attention.cu`: one-token attention over a KV
cache with a per-sequence valid length and an optional window
(`repro.kernels.decode_attention` counterpart; the plain version is
`ref.decode_attention`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

MAX_GROUP = 16  # query heads per kv head: one warp each in a block


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """(B,H,D) x (B,KV,S,D)^2 with ``cache_len`` (B,) int32 -> (B,H,D) on
    the card: sequence ``b`` attends to cache slots ``[max(0, L - window),
    L)`` with ``L = cache_len[b]`` (``window = 0``: all of ``[0, L)``).
    Any cache length ``S`` works."""
    _build.check_cuda("decode_attention", q, k_cache, v_cache, cache_len)
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype or cache_len.dtype != torch.int32:
        raise TypeError("decode_attention takes float32 or bfloat16 q and "
                        "caches of one dtype and int32 lengths")
    if D not in HEAD_DIMS or k_cache.shape != (B, KV, S, D) or \
            v_cache.shape != k_cache.shape or H % KV or \
            H // KV > MAX_GROUP or cache_len.shape != (B,):
        raise ValueError(f"decode_attention: unsupported shapes q "
                         f"{q.shape}, cache {k_cache.shape}, lens "
                         f"{cache_len.shape}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    _build.extension().decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), B, H, KV, S, D, D ** -0.5,
        int(window), DTYPES[q.dtype], _build.stream_of(q))
    _build.count_launch("decode_attention")
    return out
