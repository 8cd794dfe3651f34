"""Fused trie replan: the plain blocked version and the CUDA kernel's binding.

`repro.kernels.trie_plan` fuses the VineLM fleet replan into one Pallas
kernel.  For each request lane at prefix ``u`` it scans the terminal nodes
``v`` of the preorder interval ``[u, u + subtree_size[u])`` that pass every
budget mask, takes the exact lexicographic argmin of
(-acc, d_cost, d_lat, idx) for ``max_acc`` or (d_cost, d_lat, depth, idx)
for ``min_cost``, and emits ``(target, path_models[target, depth[u]])``,
or -1.

This module holds the same computation twice:

- `fleet_plan_blocked`: plain PyTorch, node tiles merged into per-lane
  running minima (`request_stats`, `_tile_lexmin_update`, `finalize` —
  the JAX helpers' counterparts);
- `trie_plan_cuda`: the binding of `csrc/trie_plan.cu`, one thread block
  per lane (see the note there).

Both compute the cumulative engine delay of a node as the sum over models
``m = 0..M-1``, left to right, of ``path_counts[v, m] * pmd[b, m]`` with
every product and sum rounded on its own (no fused multiply-add), so the
kernel and its plain version agree bit for bit; `repro`'s matmul form
groups the same float32 terms and agrees with both, as with the host
`select_path`, up to the last ulp at an exact feasibility boundary.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import effective_scalars

BIG = 1e30         # infeasible key sentinel
BIG_CUT = 1e29     # "no feasible node survived" detection threshold
BIG_IDX = 2 ** 30  # infeasible node-index sentinel

DEFAULT_BLOCK_NODES = 512
MAX_MODELS = 64    # model-pool width the CUDA kernel keeps in shared memory
MIN_COST, MAX_ACC = 0, 1


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

    better = (m1 < bk1) | ((m1 == bk1) & ((m2 < bk2) | ((m2 == bk2) & (
        (m3 < bk3) | ((m3 == bk3) & (li < bidx))))))
    return (torch.where(better, m1, bk1), torch.where(better, m2, bk2),
            torch.where(better, m3, bk3), torch.where(better, li, bidx),
            torch.where(better, nxt_t, bnxt))


def finalize(carry, lo):
    """(targets, next_models) from the final running minima."""
    bk1, _, _, bidx, bnxt = carry
    tgt = torch.where(bk1 >= BIG_CUT, -1, bidx).to(torch.int32)
    nxt = torch.where((tgt < 0) | (tgt == lo), -1, bnxt).to(torch.int32)
    return tgt, nxt


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
    bsz = prefixes.shape[0]
    if n <= 4 * block_nodes:  # small tries are one tile
        block_nodes = n
    stats = request_stats(depth, cost, lat, subtree_size, path_counts,
                          engine_of_model, prefixes, elapsed_lat,
                          engine_delays, lat_cap, cost_cap, acc_floor)
    dev = terminal.device
    carry = (torch.full((bsz,), BIG, device=dev),
             torch.full((bsz,), BIG, device=dev),
             torch.full((bsz,), BIG, device=dev),
             torch.full((bsz,), BIG_IDX, dtype=torch.int32, device=dev),
             torch.full((bsz,), -1, dtype=torch.int32, device=dev))
    for s in range(0, n, block_nodes):
        t = slice(s, min(s + block_nodes, n))
        carry = _tile_lexmin_update(
            carry, s, terminal[t], depth[t], acc[t], cost[t], lat[t],
            path_counts[t], path_models[t], blocked_depth[t], *stats,
            kind=kind)
    return finalize(carry, stats[0])


def trie_plan_cuda(terminal, depth, acc, cost, lat, subtree_size,
                   path_models, path_counts, engine_of_model, prefixes,
                   elapsed_lat, elapsed_cost, engine_delays, acc_floor,
                   cost_cap, lat_cap, *, kind: str, blocked_depth=None):
    """Fused fleet replan on the card: one launch of `csrc/trie_plan.cu`.

    Same contract as `fleet_plan_blocked`; every operand must be a
    contiguous CUDA tensor (float32 node columns, int32 ``subtree_size``/
    ``path_models``/``engine_of_model``/``prefixes``), and every prefix a
    node of the trie (lanes with an out-of-range prefix come back -1)."""
    del elapsed_cost
    if blocked_depth is None:
        blocked_depth = torch.zeros_like(terminal)
    cols = (terminal, depth, acc, cost, lat, blocked_depth, path_counts,
            elapsed_lat, engine_delays)
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
            elapsed_lat.shape != (bsz,) or engine_of_model.shape != (m,):
        raise ValueError("trie_plan: inconsistent operand shapes")
    if kind not in ("min_cost", "max_acc"):
        raise ValueError(f"unknown objective kind {kind!r}")
    floor_eff, cap_eff = effective_scalars(acc_floor, cost_cap)
    tgt = torch.empty(bsz, dtype=torch.int32, device=prefixes.device)
    nxt = torch.empty_like(tgt)
    if bsz == 0:
        return tgt, nxt
    _build.extension().trie_plan(
        terminal.data_ptr(), depth.data_ptr(), acc.data_ptr(),
        cost.data_ptr(), lat.data_ptr(), blocked_depth.data_ptr(),
        subtree_size.data_ptr(), path_counts.data_ptr(),
        path_models.data_ptr(), engine_of_model.data_ptr(),
        prefixes.data_ptr(), elapsed_lat.data_ptr(),
        engine_delays.data_ptr(), n, m, path_models.shape[1], e, bsz,
        floor_eff, cap_eff, float(np.float32(lat_cap)),
        MIN_COST if kind == "min_cost" else MAX_ACC,
        tgt.data_ptr(), nxt.data_ptr(), _build.stream_of(prefixes))
    _build.count_launch("trie_plan")
    return tgt, nxt
