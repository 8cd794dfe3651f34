"""Bindings of `csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`:
causal / sliding-window GQA attention forward with an online softmax
(`repro.kernels.flash_attention` counterpart; the plain versions are
`ref.attention` and `ref.attention_fwd`) and its backward
(`repro.kernels.xla_flash._flash_bwd_impl` counterpart; the plain version
is `ref.attention_bwd` and, summed the way the kernels sum,
`ref.attention_bwd_tiled`), with the backward's launch plan `bwd_plan`."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# head dimensions compiled into csrc/flash_attention.cu and
# flash_attention_bwd.cu (96: MLA's 64 + 32 query/key dims)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's tiles compiled into csrc/flash_attention_bwd.cu
BWD_F32_TILES = (64, 32, 16)  # float32: dq query rows, dkdv keys a block
BWD_F32_WALK = 64             # float32: dq keys, dkdv query rows a step
BWD_MMA_TILE = 64             # bf16: dq query rows and keys a step, dkdv keys
BWD_MMA_ROWS = (32, 64)       # bf16: dkdv query rows a step
BWD_MMA_ROWS64_DIMS = (64, 80, 96)  # csrc kMmaRows64: head dims with 64
MAX_CLUSTER = 8               # csrc kMaxCluster: blocks of a cluster at most
PARTS = {"prep": 1, "dq": 2, "dkdv": 4}  # csrc kPart*: kernels of a call


class BwdPlan(NamedTuple):
    """How a backward launch cuts the work.  dq: blocks of ``dq_rows``
    query rows of one (batch, head), walking ``dq_keys`` keys a step, grid
    ``dq_grid`` = (B H, query tiles); dkdv: blocks of ``kv_keys`` keys,
    walking ``kv_rows`` query rows a step of ``heads`` query heads, summed
    in head order; the ``cluster`` blocks of one (key tile, kv head) sum
    their partials in rank order, grid ``kv_grid`` = (B KV cluster, key
    tiles).  The tile is the slow grid axis: dkdv dispatches key tile 0
    first, a causal dq the last query tile first, every head's heaviest
    tile before any head's next."""
    dq_rows: int
    dq_keys: int
    kv_keys: int
    kv_rows: int
    heads: int
    cluster: int
    dq_grid: tuple
    kv_grid: tuple


def cluster_heads(G: int) -> int:
    """Query heads a bf16 dkdv block takes: the least divisor of ``G`` that
    leaves at most ``MAX_CLUSTER`` blocks to a kv head (1 for every G <= 8;
    ceil(G / 8) where that divides G, as at G = 12 and 64)."""
    return next(d for d in range(-(-G // MAX_CLUSTER), G + 1) if G % d == 0)


def _fill_tile(slabs: int, S: int, sms: int) -> int:
    """The largest float32 tile whose grid gives two blocks an SM, else the
    smallest (the most blocks the shape has)."""
    return next((t for t in BWD_F32_TILES if slabs * -(-S // t) >= 2 * sms),
                BWD_F32_TILES[-1])


def bwd_plan(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
             causal: bool, itemsize: int, sms: int) -> BwdPlan:
    """The backward's launch plan for these shapes on ``sms`` SMs.

    bf16 (``itemsize`` 2): tiles of 64; one query head a dkdv block and a
    cluster of G blocks (`cluster_heads` past G = 8); a causal dkdv walks
    64 query rows a step where the kernel has that step
    (`BWD_MMA_ROWS64_DIMS`), else 32.  The 64-row step takes more
    registers (two blocks an SM where 32 rows fit three at D = 64), which
    costs a non-causal grid of equal blocks a partial wave, while a causal
    grid dispatched heaviest first hides it (NVIDIA H100 80GB HBM3, 700 W:
    Zamba2's causal (1, 32, 2048, 80) 0.3749 ms at 64 rows against 0.4319
    at 32, Whisper's non-causal encoder (2, 8, 1500, 64) 0.2166 against
    0.1742).  float32: 16-, 32- or 64-row dq tiles and key dkdv tiles,
    the largest that give each grid two blocks an SM (`_fill_tile`), the
    G heads of a kv head in one block.  Shapes only."""
    G = H // KV
    if itemsize == 2:
        rows = 64 if causal and D in BWD_MMA_ROWS64_DIMS else 32
        heads = cluster_heads(G)
        dq_rows = dq_keys = kv_keys = BWD_MMA_TILE
        cluster = G // heads
    else:
        dq_rows, kv_keys = _fill_tile(B * H, Sq, sms), _fill_tile(B * KV, Sk,
                                                                 sms)
        dq_keys = rows = BWD_F32_WALK
        heads, cluster = G, 1
    return BwdPlan(dq_rows, dq_keys, kv_keys, rows, heads, cluster,
                   (B * H, -(-Sq // dq_rows)),
                   (B * KV * cluster, -(-Sk // kv_keys)))


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
    Deterministic: dK and dV of a kv head sum its query heads in a fixed
    order (in registers, then across a thread block cluster in rank
    order), and dQ is written by the block that owns its rows.  One call
    is one counted launch of three kernels (D = rowsum(dO o), dQ, then dK
    and dV) from `bwd_plan`."""
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
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd: q, k, v, o and do must start "
                         "on 16-byte boundaries (the kernels copy 16 bytes)")
    plan = bwd_plan(B, H, KV, Sq, Sk, D, causal, q.element_size(),
                    _build.sm_count(q.device.index))
    return _launch_bwd(q, k, v, o, lse, do, causal, window, plan)[:3]


def _launch_bwd(q, k, v, o, lse, do, causal: bool, window: int,
                plan: BwdPlan, parts: int = 7, delta=None):
    """Launch the backward's kernels named by ``parts`` (`PARTS` bits; 7:
    all three) on checked operands with ``plan``; -> (dq, dk, dv, delta).
    A part left out leaves its outputs unwritten; without the prep pass dq
    and dkdv read ``delta`` (float32 (B,H,Sq), from an earlier call)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if delta is None:
        delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    _build.extension().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, KV, Sq, Sk, D, D ** -0.5,
        int(causal), int(window), DTYPES[q.dtype], plan.dq_rows,
        plan.kv_keys, plan.kv_rows, plan.heads, plan.cluster, parts,
        _build.stream_of(q))
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv, delta
