"""Binding of `csrc/decode_attention.cu`: one-token attention over a KV
cache with a per-sequence valid length and an optional window
(`repro.kernels.decode_attention` counterpart; the plain versions are
`ref.decode_attention` and, cut over a cluster's ranks the way the kernel
cuts the valid slots, `ref.decode_attention_cluster`)."""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

# head dimensions compiled into csrc/decode_attention.cu: its own list, not
# the flash kernels' (MLA decodes in the absorbed form, with no kernel)
HEAD_DIMS = (16, 32, 64, 80, 128)
HEAD_CHUNK = 8          # csrc kDecodeHeads: query heads a block at most
MIN_COLS = 16           # output columns a block at least
CLUSTERS = (1, 2, 4, 8, 16)  # cluster sizes the rule weighs
PORTABLE_CLUSTER = 8    # larger clusters need the non-portable opt-in
MAX_STAGES = 8          # csrc kDecodeMaxStages: a block's ring at most
THREADS = 256           # csrc kDecodeThreads
# dynamic shared memory a block where two share an SM (the SM's 228 KB
# less 1 KB reserved a block, halved): a cluster then finds room beside
# another, and the card holds every cluster of a wave at once
SMEM_TWO = 115712
# csrc kDecodeRx: a block's receive buffer for its share of the ranks'
# partials (16 bytes an item of 4 columns) and their m and l
RX_BYTES = 16 * (HEAD_CHUNK * 32 + 16) + 2 * 4 * HEAD_CHUNK * 16
# a cluster's merge costs about what a few tiles do: a full cache of at
# most this many tiles is not cut over a cluster
MIN_SPLIT_TILES = 4


class Plan(NamedTuple):
    """How a launch cuts the work: ``cluster`` blocks of one thread block
    cluster share the valid tiles of a (batch, kv head, head chunk,
    column slice), the G query heads of a kv head go in chunks of ``hc``,
    the output columns into ``slices``, and a block's ring holds
    ``stages`` tiles; grid (cluster x slices, KV x head chunks, B)."""
    cluster: int
    slices: int
    hc: int
    stages: int


def tile_keys(itemsize: int) -> int:
    """Keys of one tile: 128 bytes a column (csrc `decode_tile_keys`)."""
    return 128 // itemsize


def column_slices(D: int, itemsize: int) -> list[int]:
    """The column slice counts the kernel takes at head dimension ``D``,
    fewest first: slices of at least ``MIN_COLS`` columns, in chunks of
    16 in bf16 (two n-tiles of 8, a swizzled row of 32 bytes or more) and
    of 8 in float32 (a P.V thread's columns)."""
    unit = 16 if itemsize == 2 else 8
    return [c for c in range(1, max(1, D // MIN_COLS) + 1)
            if D % c == 0 and (D // c) % unit == 0]


def smem_bytes(D: int, itemsize: int, slices: int, stages: int) -> int:
    """Dynamic shared memory of one block (csrc `decode_layout`): the ring
    (or, if larger, the warps' accumulators after it, 32 floats a thread),
    each warp's scores for 16 keys of 4 heads, the warps' and the block's
    stats, what the ranks push (``RX_BYTES``), a full and an empty barrier
    a stage, and 1024 bytes to align the ring."""
    tk, dc = tile_keys(itemsize), D // slices
    ring = max(stages * tk * (D + dc) * itemsize, 4 * 32 * THREADS)
    return (1024 + ring + 4 * 8 * 16 * 4 + 4 * 2 * 8 * HEAD_CHUNK
            + 4 * 2 * HEAD_CHUNK + RX_BYTES + 16 * stages)


def decode_plans(B: int, KV: int, G: int, S: int, D: int, sms: int,
                 itemsize: int = 2,
                 max_clusters: Callable[[Plan], int] | None = None
                 ) -> list[Plan]:
    """Every plan the rule weighs for these shapes on ``sms`` SMs, the
    chosen one first.  Shapes and the card only: the lengths lie on the
    device.

    For each cluster size C of ``CLUSTERS`` up to the tiles that cover the
    cache (so that every block holds a tile of a full cache), while the
    slabs x C blocks stay within one wave of the SMs, and only where a
    full cache has more than ``MIN_SPLIT_TILES`` tiles (C = 1 always): the
    most column slices that keep the grid within the wave, and a ring as
    deep as a block's share of a full cache, at most ``MAX_STAGES`` and
    what the shared memory of two blocks an SM holds.
    C = 16 is weighed only where ``max_clusters(plan)`` (the card's
    `cudaOccupancyMaxActiveClusters`) holds all its clusters at once.  The
    chosen plan is the largest C weighed: the valid slots spread over the
    most SMs, the column slices re-read K only to fill the rest."""
    nchunk = -(-G // HEAD_CHUNK)
    hc = -(-G // nchunk)
    tiles = -(-S // tile_keys(itemsize))
    slabs = B * KV * nchunk
    plans = []
    for C in CLUSTERS:
        if C > 1 and (C > tiles or tiles <= MIN_SPLIT_TILES or
                      slabs * C > sms):
            break
        fit = [c for c in column_slices(D, itemsize) if slabs * C * c <= sms]
        plan = _with_ring(C, fit[-1] if fit else 1, hc, tiles, D, itemsize)
        if C > PORTABLE_CLUSTER and (
                max_clusters is None or
                max_clusters(plan) < slabs * plan.slices):
            continue
        plans.append(plan)
    return plans[::-1]


def _with_ring(C: int, slices: int, hc: int, tiles: int, D: int,
               itemsize: int) -> Plan:
    stages = min(MAX_STAGES, max(1, -(-tiles // C)))
    while stages > 1 and smem_bytes(D, itemsize, slices, stages) > SMEM_TWO:
        stages -= 1
    return Plan(C, slices, hc, stages)


def decode_plan(B: int, KV: int, G: int, S: int, D: int, sms: int,
                itemsize: int = 2,
                max_clusters: Callable[[Plan], int] | None = None) -> Plan:
    """The plan the wrapper launches: the first of `decode_plans`."""
    return decode_plans(B, KV, G, S, D, sms, itemsize, max_clusters)[0]


@functools.lru_cache(maxsize=None)
def max_clusters(index: int, D: int, G: int, dtype: torch.dtype,
                 plan: Plan) -> int:
    """Clusters of ``plan`` card ``index`` holds at once, by
    `cudaOccupancyMaxActiveClusters`."""
    with torch.cuda.device(index):
        return _build.extension().decode_max_clusters(
            D, G, plan.cluster, plan.slices, plan.hc, plan.stages,
            DTYPES[dtype])


@functools.lru_cache(maxsize=None)
def _plan_for(index: int, B: int, KV: int, G: int, S: int, D: int,
              dtype: torch.dtype, itemsize: int) -> Plan:
    return decode_plan(B, KV, G, S, D, _build.sm_count(index), itemsize,
                       lambda p: max_clusters(index, D, G, dtype, p))


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
    _build.check_aligned("decode_attention", q, k_cache, v_cache)
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    if q.numel() == 0 or S == 0:
        return torch.zeros_like(q)
    plan = _plan_for(q.device.index, B, KV, H // KV, S, D, q.dtype,
                     q.element_size())
    return _launch(q, k_cache, v_cache, cache_len, window, plan)


def _launch(q, k_cache, v_cache, cache_len, window: int, plan: Plan):
    """Launch the kernel on checked operands with ``plan``."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    _build.extension().decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), B, H, KV, S, D, plan.cluster,
        plan.slices, plan.hc, plan.stages, D ** -0.5, int(window),
        DTYPES[q.dtype], _build.stream_of(q))
    _build.count_launch("decode_attention")
    return out
