"""Fused trie replan: the plain blocked version and the CUDA kernel's binding.

`repro.kernels.trie_plan` fuses the VineLM fleet replan into one Pallas
kernel.  For each request lane at prefix ``u`` it scans the terminal nodes
``v`` of the preorder interval ``[u, u + subtree_size[u])`` that pass every
budget mask, takes the exact lexicographic argmin of
(-acc, d_cost, d_lat, idx) for ``max_acc`` or (d_cost, d_lat, depth, idx)
for ``min_cost``, and emits ``(target, path_models[target, depth[u]])``,
or -1.

This module holds the same computation three times:

- `fleet_plan_blocked`: plain PyTorch, node tiles merged into per-lane
  running minima (`request_stats`, `_tile_lexmin_update`, `finalize` —
  the JAX helpers' counterparts);
- `fleet_plan_split`: plain PyTorch cut the way the kernel cuts the work
  (lanes in groups of ``lanes_per_block``, each lane's interval in up to
  ``splits`` contiguous slices, the slices' partial minima merged on the
  full key tuple);
- `trie_plan_cuda`: the binding of `csrc/trie_plan.cu`, one warp per
  (lane, slice) with `split_plan`'s launch plan (see the note there).

All three compute the cumulative engine delay of a node as the sum over models
``m = 0..M-1``, left to right, of ``path_counts[v, m] * pmd[b, m]`` with
every product and sum rounded on its own (no fused multiply-add), so the
kernel and its plain version agree bit for bit; `repro`'s matmul form
groups the same float32 terms and agrees with both, as with the host
`select_path`, up to the last ulp at an exact feasibility boundary.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import effective_scalars

BIG = 1e30         # infeasible key sentinel
BIG_CUT = 1e29     # "no feasible node survived" detection threshold
BIG_IDX = 2 ** 30  # infeasible node-index sentinel

DEFAULT_BLOCK_NODES = 512
MAX_MODELS = 64    # model-pool width the CUDA kernel takes
MIN_COST, MAX_ACC = 0, 1

MAX_SPLITS = 64      # csrc kMaxSplits: slices of a lane at most
SLICE_NODES = 128    # csrc kSliceNodes: nodes a slice at least
MAX_LANES_PER_BLOCK = 8  # csrc kMaxLanesPerBlock
WARPS_PER_SM = 32    # warps a launch puts on each SM at most


class Plan(NamedTuple):
    """How a launch cuts the work: each lane's interval into at most
    ``splits`` slices (one warp each), ``lanes_per_block`` lanes at one
    slice index a block; grid (lane groups, splits)."""
    splits: int
    lanes_per_block: int


def split_plan(B: int, N: int, sms: int) -> Plan:
    """The launch plan for B lanes over a trie of N nodes on ``sms`` SMs,
    a function of these alone (never of the prefixes, which lie on the
    device, so the wrapper never synchronises): as many slices as a root
    lane's N nodes fill at ``SLICE_NODES`` a slice, within ``MAX_SPLITS``
    and ``WARPS_PER_SM`` warps an SM; then as many lanes a block, up to
    ``MAX_LANES_PER_BLOCK``, as keep a block on every SM."""
    b = max(B, 1)
    splits = max(1, min(MAX_SPLITS, -(-N // SLICE_NODES),
                        sms * WARPS_PER_SM // b))
    lanes = max(1, min(MAX_LANES_PER_BLOCK, b * splits // sms))
    return Plan(splits, lanes)


def path_delay(counts, pmd):
    """(B, T) cumulative engine delay of T nodes for B lanes: the sum over
    models, left to right, of ``counts[t, m] * pmd[b, m]``."""
    out = torch.zeros(pmd.shape[0], counts.shape[0], dtype=torch.float32,
                      device=pmd.device)
    for m in range(counts.shape[1]):
        out = out + counts[None, :, m] * pmd[:, m, None]
    return out


def request_stats(depth, cost, lat, subtree_size, path_counts,
                  engine_of_model, prefixes, elapsed_lat, engine_delays,
                  lat_cap, cost_cap, acc_floor):
    """Per-lane prefix statistics and effective budgets.

    Returns (lo, hi, du, lat_u, cost_u, delay_u, thr, pmd, cap_eff,
    floor_eff): the interval bounds and prefix annotations of each lane,
    the remaining-latency threshold ``(lat_cap - elapsed) + 1e-6``, the
    (B, M) per-model delay rows, and the slack-adjusted scalars."""
    u = prefixes.long()
    lo = prefixes.to(torch.int32)
    hi = (prefixes + subtree_size[u]).to(torch.int32)
    du = depth[u].to(torch.int32)
    pmd = engine_delays[:, engine_of_model.long()].float()          # (B, M)
    counts_u = path_counts[u]                                       # (B, M)
    delay_u = torch.zeros_like(elapsed_lat)
    for m in range(counts_u.shape[1]):
        delay_u = delay_u + counts_u[:, m] * pmd[:, m]
    thr = (float(np.float32(lat_cap)) - elapsed_lat) + 1e-6
    floor_eff, cap_eff = effective_scalars(acc_floor, cost_cap)
    return (lo, hi, du, lat[u], cost[u], delay_u, thr, pmd, cap_eff,
            floor_eff)


def _tile_lexmin_update(carry, idx0, term_t, depth_t, acc_t, cost_t, lat_t,
                        counts_t, pm_t, bd_t, lo, hi, du, lat_u, cost_u,
                        delay_u, thr, pmd, cap_eff, floor_eff, *, kind):
    """Merge one node tile into the per-lane running lexicographic minima.

    ``carry`` = (bk1, bk2, bk3, bidx, bnxt), each (B,): the best key
    triple so far, its node index, and its first-step model.  Earlier
    tiles win exact ties, which keeps the lowest-node-index tie-break."""
    bk1, bk2, bk3, bidx, bnxt = carry
    tile = term_t.shape[0]
    gidx = idx0 + torch.arange(tile, dtype=torch.int32,
                               device=term_t.device)[None, :]       # (1, T)
    delay_bt = path_delay(counts_t, pmd)                            # (B, T)
    d_lat = (lat_t[None, :] - lat_u[:, None]) + (delay_bt - delay_u[:, None])
    d_cost = cost_t[None, :] - cost_u[:, None]
    feas = term_t[None, :] > 0.5
    feas = feas & (gidx >= lo[:, None]) & (gidx < hi[:, None])
    feas = feas & (bd_t[None, :] <= du[:, None].float())
    feas = feas & (d_lat <= thr[:, None])
    feas = feas & (cost_t[None, :] <= cap_eff)
    if kind == "min_cost":
        feas = feas & (acc_t[None, :] >= floor_eff)
        k1v, k2v, k3v = d_cost, d_lat, depth_t[None, :].expand_as(d_lat)
    else:
        k1v, k2v, k3v = -acc_t[None, :].expand_as(d_lat), d_cost, d_lat

    k1 = torch.where(feas, k1v, BIG)
    m1 = k1.min(dim=1).values
    c2 = feas & (k1 <= m1[:, None])
    k2 = torch.where(c2, k2v, BIG)
    m2 = k2.min(dim=1).values
    c3 = c2 & (k2 <= m2[:, None])
    k3 = torch.where(c3, k3v, BIG)
    m3 = k3.min(dim=1).values
    c4 = c3 & (k3 <= m3[:, None])
    li = torch.where(c4, gidx, BIG_IDX).min(dim=1).values.to(torch.int32)

    # first step of the tile winner: a direct read of its path_models row
    row = (li - idx0).clamp(0, tile - 1).long()
    col = du.long().clamp(max=pm_t.shape[1] - 1)
    nxt_t = pm_t[row, col]

    return _merge(carry, (m1, m2, m3, li, nxt_t))


def _merge(carry, cand):
    """Per lane, the lexicographically smaller of two running minima
    (k1, k2, k3, idx, first step), compared on the full key tuple: the
    lower node index wins an exact tie of the keys."""
    bk1, bk2, bk3, bidx, bnxt = carry
    m1, m2, m3, li, nxt = cand
    better = (m1 < bk1) | ((m1 == bk1) & ((m2 < bk2) | ((m2 == bk2) & (
        (m3 < bk3) | ((m3 == bk3) & (li < bidx))))))
    return (torch.where(better, m1, bk1), torch.where(better, m2, bk2),
            torch.where(better, m3, bk3), torch.where(better, li, bidx),
            torch.where(better, nxt, bnxt))


def finalize(carry, lo):
    """(targets, next_models) from the final running minima."""
    bk1, _, _, bidx, bnxt = carry
    tgt = torch.where(bk1 >= BIG_CUT, -1, bidx).to(torch.int32)
    nxt = torch.where((tgt < 0) | (tgt == lo), -1, bnxt).to(torch.int32)
    return tgt, nxt


def _empty_carry(bsz: int, dev):
    """Running minima of ``bsz`` lanes before any node: every key BIG."""
    return (torch.full((bsz,), BIG, device=dev),
            torch.full((bsz,), BIG, device=dev),
            torch.full((bsz,), BIG, device=dev),
            torch.full((bsz,), BIG_IDX, dtype=torch.int32, device=dev),
            torch.full((bsz,), -1, dtype=torch.int32, device=dev))


def fleet_plan_blocked(terminal, depth, acc, cost, lat, subtree_size,
                       path_models, path_counts, engine_of_model, prefixes,
                       elapsed_lat, elapsed_cost, engine_delays, acc_floor,
                       cost_cap, lat_cap, *, kind: str, blocked_depth=None,
                       block_nodes: int = DEFAULT_BLOCK_NODES):
    """Fused fleet replan in plain PyTorch: (targets, next_models), both
    (B,) int32 — the same contract as `ref.fleet_plan`, computed tile by
    tile with per-lane running minima (no (B, N) key array)."""
    del elapsed_cost  # cost budgets are expectation-based (select_path)
    if blocked_depth is None:
        blocked_depth = torch.zeros_like(terminal)
    n = terminal.shape[0]
    if n <= 4 * block_nodes:  # small tries are one tile
        block_nodes = n
    stats = request_stats(depth, cost, lat, subtree_size, path_counts,
                          engine_of_model, prefixes, elapsed_lat,
                          engine_delays, lat_cap, cost_cap, acc_floor)
    carry = _empty_carry(prefixes.shape[0], terminal.device)
    for s in range(0, n, block_nodes):
        t = slice(s, min(s + block_nodes, n))
        carry = _tile_lexmin_update(
            carry, s, terminal[t], depth[t], acc[t], cost[t], lat[t],
            path_counts[t], path_models[t], blocked_depth[t], *stats,
            kind=kind)
    return finalize(carry, stats[0])


def fleet_plan_split(terminal, depth, acc, cost, lat, subtree_size,
                     path_models, path_counts, engine_of_model, prefixes,
                     elapsed_lat, elapsed_cost, engine_delays, acc_floor,
                     cost_cap, lat_cap, *, kind: str, blocked_depth=None,
                     splits: int = 1, lanes_per_block: int = 1,
                     slice_nodes: int = SLICE_NODES):
    """The kernel's decomposition in plain PyTorch: (targets,
    next_models), the contract of `fleet_plan_blocked`.

    Lanes go in groups of ``lanes_per_block`` (a block).  A lane whose
    interval holds L nodes takes ``n = min(splits, ceil(L / slice_nodes))``
    contiguous slices ``[lo + L*s // n, lo + L*(s+1) // n)``; each slice's
    partial minimum and its first step (a warp's) merge into the lane's
    result on the full key tuple, slice 0 first, as `csrc/trie_plan.cu`
    merges them (in any order: the tuple's order is total).
    ``slice_nodes`` is the kernel's ``SLICE_NODES``; a smaller one cuts
    small tries into many slices."""
    del elapsed_cost
    if blocked_depth is None:
        blocked_depth = torch.zeros_like(terminal)
    if splits < 1 or lanes_per_block < 1:
        raise ValueError("fleet_plan_split: splits and lanes_per_block must "
                         "be at least 1")
    bsz, dev = prefixes.shape[0], terminal.device
    tgt = torch.empty(bsz, dtype=torch.int32, device=dev)
    nxt = torch.empty_like(tgt)
    for g in range(0, bsz, lanes_per_block):
        lanes = slice(g, min(g + lanes_per_block, bsz))
        stats = request_stats(depth, cost, lat, subtree_size, path_counts,
                              engine_of_model, prefixes[lanes],
                              elapsed_lat[lanes], engine_delays[lanes],
                              lat_cap, cost_cap, acc_floor)
        lo, size = stats[0].long(), (stats[1] - stats[0]).long()
        n = torch.clamp(-(-size // slice_nodes), max=splits)  # csrc nslices
        carry = _empty_carry(lo.shape[0], dev)
        for s in range(splits):
            a = lo + size * s // n
            e = torch.where(s < n, lo + size * (s + 1) // n, a)
            part = _tile_lexmin_update(
                _empty_carry(lo.shape[0], dev), 0, terminal, depth, acc,
                cost, lat, path_counts, path_models, blocked_depth,
                a.to(torch.int32), e.to(torch.int32), *stats[2:], kind=kind)
            carry = _merge(carry, part)
        tgt[lanes], nxt[lanes] = finalize(carry, stats[0])
    return tgt, nxt


def trie_plan_cuda(terminal, depth, acc, cost, lat, subtree_size,
                   path_models, path_counts, engine_of_model, prefixes,
                   elapsed_lat, elapsed_cost, engine_delays, acc_floor,
                   cost_cap, lat_cap, *, kind: str, blocked_depth=None):
    """Fused fleet replan on the card: one launch of `csrc/trie_plan.cu`.

    Same contract as `fleet_plan_blocked`; every operand must be a
    contiguous CUDA tensor (float32 node columns, int32 ``subtree_size``/
    ``path_models``/``engine_of_model``/``prefixes``), and every prefix a
    node of the trie (lanes with an out-of-range prefix come back -1).
    ``blocked_depth=None`` reads as a zero column, with nothing filled.
    The two outputs are the rows of one (2, B) tensor."""
    del elapsed_cost
    launch = bind(terminal, depth, acc, cost, lat, subtree_size,
                  path_models, path_counts, engine_of_model, prefixes,
                  elapsed_lat, engine_delays, acc_floor, cost_cap, lat_cap,
                  kind=kind, blocked_depth=blocked_depth)
    out = torch.empty((2, prefixes.shape[0]), dtype=torch.int32,
                      device=prefixes.device)
    launch(out)
    return out[0], out[1]


def bind(terminal, depth, acc, cost, lat, subtree_size, path_models,
         path_counts, engine_of_model, prefixes, elapsed_lat, engine_delays,
         acc_floor, cost_cap, lat_cap, *, kind: str, blocked_depth=None,
         plan: Plan | None = None):
    """Check the replan's operands once (`trie_plan_cuda`'s rules) and
    return ``launch(out)``, which launches the kernel on them with
    ``plan`` (default `split_plan`'s) and writes (targets, next_models)
    into the rows of ``out``, a contiguous (2, B) int32 tensor on their
    device.  The operands are read at each launch, not at binding: a
    caller that rewrites them in place (the planner's lane buffer) launches
    again without a check."""
    cols = (terminal, depth, acc, cost, lat, path_counts, elapsed_lat,
            engine_delays) + (() if blocked_depth is None else
                              (blocked_depth,))
    ints = (subtree_size, path_models, engine_of_model, prefixes)
    _build.check_cuda("trie_plan", *cols, *ints)
    if any(t.dtype != torch.float32 for t in cols) or any(
            t.dtype != torch.int32 for t in ints):
        raise TypeError("trie_plan: node columns, path counts, elapsed "
                        "latency and delays must be float32; subtree sizes,"
                        " path models, engine map and prefixes int32")
    n, m = path_counts.shape
    bsz, e = engine_delays.shape
    if m > MAX_MODELS:
        raise ValueError(f"trie_plan: {m} models exceed the kernel's "
                         f"{MAX_MODELS}")
    if path_models.shape[0] != n or prefixes.shape != (bsz,) or \
            elapsed_lat.shape != (bsz,) or engine_of_model.shape != (m,) or \
            any(t.shape != (n,) for t in (terminal, depth, acc, cost, lat,
                                          subtree_size)) or \
            (blocked_depth is not None and blocked_depth.shape != (n,)):
        raise ValueError("trie_plan: inconsistent operand shapes")
    if kind not in ("min_cost", "max_acc"):
        raise ValueError(f"unknown objective kind {kind!r}")
    if not bsz or not n:
        return lambda out: None
    dev = prefixes.device
    if plan is None:
        plan = split_plan(bsz, n, _build.sm_count(dev.index))
    ws = cnt = None
    if plan.splits > 1:  # partials: (k1, k2, k3, idx) and the first step
        ws = torch.empty(5 * bsz * plan.splits, dtype=torch.int32,
                         device=dev)
        cnt = _build.counters("trie_plan", dev, bsz)
    ext = _build.extension()
    args = (terminal.data_ptr(), depth.data_ptr(), acc.data_ptr(),
            cost.data_ptr(), lat.data_ptr(),
            0 if blocked_depth is None else blocked_depth.data_ptr(),
            subtree_size.data_ptr(), path_counts.data_ptr(),
            path_models.data_ptr(), engine_of_model.data_ptr(),
            prefixes.data_ptr(), elapsed_lat.data_ptr(),
            engine_delays.data_ptr(), n, m, path_models.shape[1], e, bsz,
            *effective_scalars(acc_floor, cost_cap),
            float(np.float32(lat_cap)),
            MIN_COST if kind == "min_cost" else MAX_ACC, plan.splits,
            plan.lanes_per_block, 0 if ws is None else ws.data_ptr(),
            0 if cnt is None else cnt.data_ptr())

    def launch(out):
        o = out.data_ptr()
        ext.trie_plan(*args, o, o + 4 * bsz, _build.stream_of(prefixes))
        _build.count_launch("trie_plan")

    # the operands and the workspace live as long as the launch can run
    launch.operands = (cols, ints, ws)
    return launch
