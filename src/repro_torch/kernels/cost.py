"""Each kernel's work as a function of its shapes: the bytes it must move
(each input read once, each output written once) and the operations it
does.

One count serves two readers: `chip_smoke.py` divides it by the card's
memory rate and peak to print each kernel's bound, and the kernels' shape
routes (`kernels.ops`) add it into a dry run's record
(`repro_torch.launch.dryrun`).  Every function returns ``(bytes,
operations)`` as floats.  Where the work depends on the data, the
functions take what the data decides (the replan's lanes, a decode's
valid length) as arguments.
"""
from __future__ import annotations

import numpy as np


def attn_pairs(Sq: int, Sk: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs attention scores: every pair, or with ``causal``
    the keys ``k <= q`` (and ``k > q - window`` with a window), query ``q``
    and key ``k`` counted from 0 on both axes."""
    if not causal:
        return int(Sq) * int(Sk)
    q = np.arange(int(Sq), dtype=np.int64)
    hi = np.minimum(q, int(Sk) - 1)
    lo = np.maximum(q - int(window) + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
               itemsize: int, causal: bool, window: int = 0,
               lse: bool = False):
    """The flash forward: q, k, v read and o written (with ``lse`` the
    float32 log-sum-exp written too); QK^T and PV, 4 D operations a scored
    pair and query head."""
    nbytes = itemsize * (2 * B * H * Sq * D + 2 * B * KV * Sk * D)
    if lse:
        nbytes += 4 * B * H * Sq
    return float(nbytes), 4.0 * D * H * B * attn_pairs(Sq, Sk, causal, window)


def flash_bwd_work(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
                   itemsize: int, causal: bool, window: int = 0):
    """The flash backward: q, o, dO read and dQ written, k, v read and dK,
    dV written, the log-sum-exp read; five products of 2 D operations a
    scored pair and query head (QK^T again, dP, dV, dQ, dK)."""
    nbytes = itemsize * (4 * B * H * Sq * D + 4 * B * KV * Sk * D) \
        + 4 * B * H * Sq
    return float(nbytes), 10.0 * attn_pairs(Sq, Sk, causal, window) * D * H * B


def decode_work(B: int, H: int, KV: int, D: int, length: int, itemsize: int):
    """One-token attention over ``length`` valid cache slots: q read and o
    written, ``length`` slots of k and v read, the int32 lengths read; 4 D
    operations a slot and query head."""
    nbytes = itemsize * (2 * B * H * D + 2 * B * KV * length * D) + 4 * B
    return float(nbytes), 4.0 * B * H * D * length


def rms_norm_work(rows: int, D: int, itemsize: int):
    """Row RMSNorm: x read and out written, the float32 scale read; about 4
    operations an element (square, sum, scale, cast)."""
    return float(2 * itemsize * rows * D + 4 * D), 4.0 * rows * D


def ssd_work(S: int, Hn: int, P: int, N: int, Q: int, final: bool = True,
             B: int = 1, itemsize: int = 2):
    """The SSD scan of ``B`` sequences: x, dt, A, B, C read and y (and,
    with ``final``, the float32 final state) written once; per chunk of n
    steps, C.B once for all heads (ngroups = 1) over the n(n+1)/2 causal
    pairs, and per head the decay weights (~4 operations a pair), M.x (2P
    a pair) and the two state terms (C.h and the update, 2PN a step
    each)."""
    nbytes = B * (itemsize * (2 * S * Hn * P + 2 * S * N) + 4 * (
        S * Hn + (Hn * P * N if final else 0))) + 4 * Hn
    full, rest = divmod(int(S), int(Q))
    ops = 0.0
    for n, times in ((int(Q), full), (rest, 1 if rest else 0)):
        pairs = n * (n + 1) / 2
        ops += times * (pairs * 2 * N + Hn * (pairs * (2 * P + 4)
                                              + 4 * n * P * N))
    return float(nbytes), B * ops


def plan_work(subtree_size, roots, n_models: int, n_engines: int):
    """The fused replan of one lane a root: the node columns of the union
    of the lanes' intervals ``[root, root + subtree_size[root])`` (6 float
    columns and the path-counts row), the lane operands and outputs, and
    per (lane, node in its interval) 2M operations of delay plus about 12
    of masks and compares."""
    sizes = np.asarray(subtree_size)
    lo = np.asarray(roots).astype(np.int64)
    hi = lo + sizes[lo]
    seen = np.zeros(len(sizes), bool)
    for a, b in zip(lo, hi):
        seen[a:b] = True
    M, B = int(n_models), len(lo)
    nbytes = seen.sum() * (6 * 4 + M * 4) \
        + B * (4 + 4 + 4 * n_engines + 4 + 4 * 2) + M * 4
    return float(nbytes), float((hi - lo).sum()) * (2 * M + 12)
