"""Binding of `csrc/decode_attention.cu`: one-token attention over a KV
cache with a per-sequence valid length and an optional window
(`repro.kernels.decode_attention` counterpart; the plain versions are
`ref.decode_attention` and, split the way the kernel splits the cache,
`ref.decode_attention_split`)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

# head dimensions compiled into csrc/decode_attention.cu: its own list, not
# the flash kernels' (MLA decodes in the absorbed form, with no kernel)
HEAD_DIMS = (16, 32, 64, 80, 128)
MAX_SPLITS = 64   # csrc kDecodeMaxSplits: splits of the cache axis at most
HEAD_CHUNK = 32   # csrc kDecodeHeads: query heads a block at most
MIN_COLS = 16     # output columns a block at least


class Plan(NamedTuple):
    """How a launch cuts the work: the cache axis into ``splits`` spans of
    ``span`` slots, the G query heads of a kv head into chunks of ``hc``,
    and the output columns into ``slices``; grid (splits x slices, KV x
    head chunks, B)."""
    span: int
    splits: int
    hc: int
    slices: int


def column_slices(D: int, itemsize: int) -> list[int]:
    """The column slice counts the kernel takes at head dimension ``D``,
    fewest first: slices of at least ``MIN_COLS`` columns and whole
    16-byte copies."""
    vec = 16 // itemsize
    return [c for c in range(1, max(1, D // MIN_COLS) + 1)
            if D % c == 0 and (D // c) % vec == 0]


def split_plan(B: int, KV: int, G: int, S: int, D: int, sms: int,
               itemsize: int = 2) -> Plan:
    """The launch plan for these shapes on ``sms`` SMs: spans of one
    staged tile (csrc `decode_tile_keys`: 128 bytes a column, 64 bf16 or 32
    float32 keys; longer where that would pass ``MAX_SPLITS``), and the most
    column slices that keep the grid within one wave.  Shapes only: the
    lengths lie on the device."""
    nchunk = -(-G // HEAD_CHUNK)
    hc = -(-G // nchunk)
    span = max(128 // itemsize, -(-S // MAX_SPLITS))
    splits = -(-S // span)
    blocks = splits * B * KV * nchunk
    fit = [c for c in column_slices(D, itemsize) if blocks * c <= sms]
    return Plan(span, splits, hc, fit[-1] if fit else 1)


def partial_floats(hc: int, D: int) -> int:
    """Floats of one split's partial in the workspace: m and l of each
    head padded to 16 bytes, then the (hc, D) accumulator."""
    return -(-2 * hc // 4) * 4 + hc * D


def check_operands(q, k_cache, v_cache, cache_len) -> None:
    """Raise unless the kernel takes these dtypes and shapes: one float32
    or bfloat16 dtype, int32 lengths, a head dim in ``HEAD_DIMS`` and H a
    multiple of KV."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype or cache_len.dtype != torch.int32:
        raise TypeError("decode_attention takes float32 or bfloat16 q and "
                        "caches of one dtype and int32 lengths")
    if D not in HEAD_DIMS or k_cache.shape != (B, KV, S, D) or \
            v_cache.shape != k_cache.shape or H % KV or \
            cache_len.shape != (B,):
        raise ValueError(f"decode_attention: unsupported shapes q "
                         f"{q.shape}, cache {k_cache.shape}, lens "
                         f"{cache_len.shape} (head dim in {HEAD_DIMS}, H a "
                         f"multiple of KV)")


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """(B,H,D) x (B,KV,S,D)^2 with ``cache_len`` (B,) int32 -> (B,H,D) on
    the card: sequence ``b`` attends to cache slots ``[max(0, L - window),
    L)`` with ``L = cache_len[b]`` (``window = 0``: all of ``[0, L)``).
    Any cache length ``S`` and any number of query heads per kv head."""
    _build.check_cuda("decode_attention", q, k_cache, v_cache, cache_len)
    check_operands(q, k_cache, v_cache, cache_len)
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: q and the caches must start on "
                         "16-byte boundaries (the kernel copies 16 bytes)")
    if q.numel() == 0 or S == 0:
        return torch.zeros_like(q)
    plan = split_plan(B, KV, H // KV, S, D, _build.sm_count(q.device.index),
                      itemsize=q.element_size())
    return _launch(q, k_cache, v_cache, cache_len, window, plan)


def _launch(q, k_cache, v_cache, cache_len, window: int, plan: Plan):
    """Launch the kernel on checked operands with ``plan``."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    groups = B * KV * -(-(H // KV) // plan.hc) * plan.slices
    if plan.splits > 1:
        ws = torch.empty(groups * plan.splits *
                         partial_floats(plan.hc, D // plan.slices),
                         dtype=torch.float32, device=q.device)
        ws_ptr = ws.data_ptr()
        cnt_ptr = _build.counters("decode_attention", q.device,
                                   groups).data_ptr()
    else:
        ws_ptr = cnt_ptr = 0
    _build.extension().decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), ws_ptr, cnt_ptr, B, H, KV, S, D,
        plan.span, plan.splits, plan.slices, plan.hc, D ** -0.5, int(window),
        DTYPES[q.dtype], _build.stream_of(q))
    _build.count_launch("decode_attention")
    return out
