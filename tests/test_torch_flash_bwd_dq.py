"""The bf16 dQ kernel of the flash backward (`flash_bwd_dq_wgmma` in
`csrc/flash_attention_bwd.cu`) on the CPU: its launch rule in
`flash_attention.bwd_plan` and the plans `bwd_plans` weighs, its tiles
`bwd_dq_tiles` against the card's shared memory and registers and against
the source's `DqTiles`, the key steps each consumer warpgroup walks (a
mirror of the kernel's loop bounds) against every visible pair, and a
scan of the source: every bf16 head dim launches it, its products are
`wgmma`, its tiles TMA copies, and it has no atomic.

Its sums are `ref.attention_bwd_tiled`'s (dQ over key tiles of
``plan.dq_keys`` in order), held against `repro`'s vjp under every plan
in tests/test_torch_flash_bwd_plan.py.
"""
import pathlib
import re

import numpy as np
import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (BWD_F32_TILES,
                                                 BWD_F32_WALK, DQ_KEYS,
                                                 DQ_LONG, DQ_MAX_STAGES,
                                                 DQ_ROWS, DQ_SMALL_D,
                                                 HEAD_DIMS, SM_SHARED,
                                                 bwd_dq_tiles, bwd_plan,
                                                 bwd_plans, dq_blocks_per_sm)

SMS = 132  # the H100's SMs
SM_REGS = 65536  # 32-bit registers an SM

# (B, H, KV, Sq, Sk, D, causal) -> the bf16 dq's (query rows a block,
# consumer warpgroups, ring stages, grid): the eight bf16 training shapes
# of `chip_smoke.BWD_SHAPES`, then its small cases (`BWD_SMALL` and
# `BWD_SMALL_BF16`, B = 2)
DQ_RULE = [
    ((2, 32, 4, 2048, 2048, 128, True), (128, 2, 4, (64, 16))),  # Yi-9B
    ((1, 32, 32, 2048, 2048, 80, True), (128, 2, 4, (32, 16))),  # Zamba2
    ((1, 40, 40, 2048, 2048, 96, True), (128, 2, 4, (40, 16))),  # MiniCPM3
    ((1, 16, 8, 2048, 2048, 64, True), (64, 1, 3, (16, 32))),    # Granite
    ((1, 56, 8, 192, 192, 128, True), (64, 1, 2, (56, 3))),      # LLaVA
    ((2, 8, 8, 1500, 1500, 64, False), (64, 1, 3, (16, 24))),    # Whisper enc
    ((2, 8, 8, 448, 1500, 64, False), (64, 1, 3, (16, 7))),      # cross
    ((2, 8, 8, 448, 448, 64, True), (64, 1, 3, (16, 7))),        # decoder
    ((2, 8, 2, 100, 100, 64, True), (64, 1, 3, (16, 2))),
    ((2, 4, 1, 130, 130, 128, True), (64, 1, 2, (8, 3))),
    ((2, 4, 4, 77, 77, 80, True), (64, 1, 4, (8, 2))),
    ((2, 4, 4, 77, 77, 96, True), (64, 1, 3, (8, 2))),
    ((2, 2, 2, 40, 40, 16, True), (64, 1, 4, (4, 1))),
    ((2, 4, 2, 33, 33, 32, True), (64, 1, 4, (8, 1))),
    ((2, 8, 8, 37, 150, 64, False), (64, 1, 3, (16, 1))),
    ((2, 8, 2, 150, 37, 64, False), (64, 1, 3, (16, 3))),
    ((2, 4, 4, 100, 100, 128, False), (64, 1, 2, (8, 2))),
    ((2, 7, 1, 70, 70, 64, True), (64, 1, 3, (14, 2))),
    ((2, 14, 2, 90, 90, 128, True), (64, 1, 2, (28, 2))),
    ((2, 7, 1, 130, 50, 96, False), (64, 1, 3, (14, 3))),
    ((2, 8, 1, 100, 100, 80, True), (64, 1, 4, (16, 2))),
    ((2, 16, 2, 75, 75, 64, True), (64, 1, 3, (32, 2))),
    ((2, 8, 1, 50, 130, 32, False), (64, 1, 4, (16, 1))),
    ((2, 4, 2, 300, 50, 64, True), (64, 1, 3, (8, 5))),
]


def _source(name):
    return (pathlib.Path(_build.CSRC) / name).read_text()


def _dq_regs(D, consumers):
    """(launch, producer, consumer) registers a thread of the dq kernel:
    the launch's (the SM's over its threads and blocks an SM, a multiple
    of 8), then after setmaxnreg the producer's 24 and what the consumers
    get of the rest, as DqTiles computes them."""
    threads = 128 * (consumers + 1)
    launch = SM_REGS // (threads * dq_blocks_per_sm(D, consumers)) // 8 * 8
    consumer = (launch * threads - 24 * 128) // (128 * consumers) // 8 * 8
    return launch, 24, consumer


@pytest.mark.parametrize("shape, want", DQ_RULE, ids=str)
def test_bf16_dq_rule(shape, want):
    """Two consumer warpgroups (128 query rows a block) from `DQ_LONG`
    query rows on at D > `DQ_SMALL_D`, else one (64 rows, three blocks an
    SM at D <= `DQ_SMALL_D`), 64 keys a step, the most ring stages the
    block's share of the SM holds, and a grid of (B H, query tiles)."""
    B, H, KV, Sq, Sk, D, causal = shape
    plan = bwd_plan(B, H, KV, Sq, Sk, D, causal, 2, SMS)
    rows, consumers, stages, grid = want
    assert (plan.dq_rows, plan.dq_rows // 64,
            bwd_dq_tiles(D, plan.dq_rows // 64)[1], plan.dq_grid) == want
    assert consumers == (2 if Sq >= DQ_LONG and D > DQ_SMALL_D else 1)
    assert rows == DQ_ROWS[consumers] and plan.dq_keys == DQ_KEYS
    assert grid == (B * H, -(-Sq // rows))
    f32 = bwd_plan(B, H, KV, Sq, Sk, D, causal, 4, SMS)
    assert f32.dq_rows in BWD_F32_TILES and f32.dq_keys == BWD_F32_WALK


@pytest.mark.parametrize("shape", [s for s, _ in DQ_RULE], ids=str)
def test_bwd_plans_weigh_every_dq_variant_once(shape):
    """Beside the chosen plan's dkdv part, `bwd_plans` lists each compiled
    dq variant (every number of consumers in `DQ_ROWS`) exactly once, and
    no plan twice."""
    B, H, KV, Sq, Sk, D, causal = shape
    plans = bwd_plans(B, H, KV, Sq, Sk, D, causal, 2, SMS)
    chosen = plans[0]
    assert len(set(plans)) == len(plans)
    dkdv = (chosen.kv_keys, chosen.kv_rows, chosen.stages, chosen.kv_grid)
    dq = [(p.dq_rows, p.dq_grid) for p in plans
          if (p.kv_keys, p.kv_rows, p.stages, p.kv_grid) == dkdv]
    want = [(DQ_ROWS[nc], (B * H, -(-Sq // DQ_ROWS[nc])))
            for nc in sorted(DQ_ROWS, reverse=True)]
    assert sorted(dq) == sorted(want)
    # every other plan keeps the chosen dq part
    assert all((p.dq_rows, p.dq_grid) == (chosen.dq_rows, chosen.dq_grid)
               for p in plans
               if (p.kv_keys, p.kv_rows, p.stages, p.kv_grid) != dkdv)


@pytest.mark.parametrize("D, consumers", [
    (D, nc) for D in HEAD_DIMS for nc in sorted(DQ_ROWS)])
def test_bwd_dq_tiles_fit_the_card(D, consumers):
    """Every compiled dq variant at every bf16 head dim: two to
    `DQ_MAX_STAGES` ring stages, the most within the block's share of the
    SM's shared memory (one block an SM with two consumers, two with
    one, three with one at D <= `DQ_SMALL_D`); every tile on a boundary
    of its swizzle's 8-row pattern; the warpgroups' registers within the
    launch's, and the consumer's dQ, S and dP (and in the overlapped
    order, dS's bf16 fragments beside them) within its."""
    atom, most, smem = bwd_dq_tiles(D, consumers)
    rows, blocks = DQ_ROWS[consumers], dq_blocks_per_sm(D, consumers)
    assert blocks == (1 if consumers == 2 else 3 if D <= DQ_SMALL_D else 2)
    assert D % atom == 0 and 2 * atom in (32, 64, 128)
    assert 2 <= most <= DQ_MAX_STAGES
    step = 2 * DQ_KEYS * D * 2
    budget = SM_SHARED // blocks - 1024
    assert smem == 1024 + 2 * rows * D * 2 + most * step + 128
    assert smem <= budget <= 232448
    assert blocks * (smem + 1024) <= SM_SHARED
    if most < DQ_MAX_STAGES:  # one more stage would not fit
        assert smem + step > budget
    pattern = 8 * 2 * atom
    for tile_bytes in (rows * D * 2, DQ_KEYS * D * 2, rows * atom * 2,
                       DQ_KEYS * atom * 2):
        assert tile_bytes % pattern == 0
    threads = 128 * (consumers + 1)
    launch, producer, consumer = _dq_regs(D, consumers)
    assert (launch, producer, consumer) == {
        1: (168, 24, 240), 2: (128, 24, 232), 3: (80, 24, 136)}[blocks]
    assert 128 * (producer + consumers * consumer) <= launch * threads
    assert blocks * launch * threads <= SM_REGS
    overlapped = most >= 3 and blocks < 3
    assert D // 2 + 2 * (DQ_KEYS // 2) + overlapped * DQ_KEYS // 4 <= consumer


def test_bwd_dq_tiles_mirror_the_kernel():
    """`bwd_dq_tiles`', `_dq_regs`' and `dq_blocks_per_sm`'s constants and
    `DQ_ROWS` are `csrc/flash_attention_bwd.cu` DqTiles'."""
    text = _source("flash_attention_bwd.cu")
    tiles = re.search(r"struct DqTiles \{.*?\n\};", text, re.S).group(0)
    assert "kRows = 64 * NC;" in tiles
    assert {nc: 64 * nc for nc in DQ_ROWS} == DQ_ROWS
    assert f"kKeys = {DQ_KEYS};" in tiles
    assert "kQBytes = 2 * kRows * D * 2;" in tiles
    assert "kStepBytes = 2 * kKeys * D * 2;" in tiles
    assert f"kBlocks = NC == 2 ? 1 : D <= {DQ_SMALL_D} ? 3 : 2;" in tiles
    assert f"kBudget = {SM_SHARED} / kBlocks - 1024;" in tiles
    assert "kBarBytes = 128;" in tiles
    assert "kFit = (kBudget - 1024 - kBarBytes - kQBytes) / kStepBytes;" \
        in tiles
    assert f"kStages = kFit < {DQ_MAX_STAGES} ? kFit : " \
        f"{DQ_MAX_STAGES};" in tiles
    assert "kSmem = 1024 + kQBytes + kStages * kStepBytes + kBarBytes;" \
        in tiles
    assert f"kLaunchRegs = {SM_REGS} / (kThreads * kBlocks) / 8 * 8;" in tiles
    assert "kProducerRegs = 24;" in tiles
    assert ("(kLaunchRegs * kThreads - kProducerRegs * 128) / (128 * NC) "
            "/ 8 * 8;") in tiles
    assert "kAtom = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;" in tiles
    for D in HEAD_DIMS:
        assert bwd_dq_tiles(D, 1)[0] == (64 if D % 64 == 0 else
                                         32 if D % 32 == 0 else 16)
    kernel = text[text.index("flash_bwd_dq_wgmma(const __grid_constant__"):]
    # the ring's stages are the tiles' own, known when the order is chosen
    assert "NS = T::kStages;" in kernel
    assert "constexpr bool kDefer = NS >= 3 && T::kBlocks < 3;" in kernel
    assert "int stages" not in kernel[:kernel.index("{")]
    assert ("__launch_bounds__(DqTiles<D, NC>::kThreads, "
            "DqTiles<D, NC>::kBlocks)") in text


def test_source_runs_the_wgmma_dq_for_every_bf16_head_dim():
    """Every dispatched head dim's bf16 backward launches
    flash_bwd_dq_wgmma with one or two consumers (64 or 128 query rows a
    block); the mma.sync dq and its helpers are gone; the dq kernel's
    scores (S and dP) are wgmma SS products and dQ an RS product, its
    tiles TMA copies through four tensor maps, its producer gives up
    registers, and nothing in it is atomic."""
    text = _source("flash_attention_bwd.cu")
    for gone in ("flash_bwd_dq_mma", "kMmaBwd", "launch_flash_bwd_mma",
                 "lds_a(", "lds_b_nk", "acc_to_a", "BWD_MMA_TILE"):
        assert gone not in text
    body = re.search(r"int dispatch_flash_bwd\(.*?\n}", text, re.S).group(0)
    dims = tuple(int(d) for d in re.findall(
        r"case (\d+): return launch_flash_bwd<T, \1>", body))
    assert dims == HEAD_DIMS
    assert "return launch_flash_bwd_bf16<D>(a);" in text
    bf16 = re.search(r"int launch_flash_bwd_bf16\(.*?\n}", text, re.S).group(0)
    assert "with_dq(a.dq_rows" in bf16 and "launch_dq_wgmma<D, NC>(a)" in bf16
    pick = re.search(r"int with_dq\(.*?\n}", text, re.S).group(0)
    for nc, rows in DQ_ROWS.items():
        assert (f"if (rows == {rows}) return "
                f"f(std::integral_constant<int, {nc}>{{}});") in pick
    launch = re.search(r"int launch_dq_wgmma\(.*?\n}", text, re.S).group(0)
    assert "flash_bwd_dq_wgmma<D, NC><<<" in launch
    assert launch.count("encode_tile_map<bf16>") == 4
    kernel = re.search(r"flash_bwd_dq_wgmma\(const __grid_constant__.*?\n}\n",
                       text, re.S).group(0)
    assert kernel.count("Wgmma<KT>::template ss<0, 0>") == 2
    assert "Wgmma<D>::template rs<1>" in kernel
    assert "tma_load_3d" in kernel and "regs_dec" in kernel
    assert "regs_inc" in kernel
    for absent in ("atomic", "mma_bf16", "ldmatrix", "cp_async"):
        assert absent not in kernel
    assert 'extern "C" int repro_flash_bwd_dq_blocks' in text
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in text


# ----------------------------------------------------------------------
# the consumer warpgroups' walks, as the kernel bounds them
# ----------------------------------------------------------------------
def _keys_seen(q0, nq, Sk, causal, window):
    """`keys_seen` of the source: the keys [begin, end) rows [q0, q0 + nq)
    can see."""
    begin, end = 0, Sk
    if causal:
        end = min(Sk, q0 + nq)
        if window > 0:
            begin = max(0, q0 - window + 1)
    return begin, end


def _walks(rows, Sq, Sk, causal, window, q0):
    """The block of ``rows`` query rows from ``q0``: its ring's steps (the
    first keys of each) and, per consumer warpgroup, the first row and
    the steps it computes (the kernel's t_begin, ntiles, w_begin, w_end);
    the others it hands back unread."""
    kb, ke = _keys_seen(q0, rows, Sk, causal, window)
    t_begin = kb // DQ_KEYS
    ntiles = max(0, -(-ke // DQ_KEYS) - t_begin)
    ring = [(t_begin + i) * DQ_KEYS for i in range(ntiles)]
    walks = []
    for w in range(rows // 64):
        wq0 = q0 + 64 * w
        wb = we = 0
        if wq0 < Sq:
            b, e = _keys_seen(wq0, min(64, Sq - wq0), Sk, causal, window)
            wb = min(ntiles, max(0, b // DQ_KEYS - t_begin))
            we = max(wb, min(ntiles, -(-e // DQ_KEYS) - t_begin))
        assert 0 <= wb <= we <= ntiles  # it waits for no step never loaded
        walks.append((wq0, ring[wb:we]))
    return ring, walks


WALK_CASES = [  # (Sq, Sk, causal, window)
    (100, 100, True, 0), (100, 100, True, 48), (130, 130, True, 0),
    (77, 77, True, 16), (40, 40, True, 0), (33, 33, True, 8),
    (37, 150, False, 0), (150, 37, False, 0), (90, 90, True, 24),
    (130, 50, False, 0), (75, 75, True, 32), (300, 300, True, 70),
    (300, 300, True, 64), (256, 256, True, 0), (200, 120, True, 0),
    (120, 200, True, 0), (260, 260, True, 130), (448, 1500, False, 0),
    (300, 50, True, 10), (300, 70, True, 0), (200, 64, True, 20),
]


@pytest.mark.parametrize("rows", sorted(DQ_ROWS.values()))
@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_dq_walks_cover_every_visible_pair(case, rows):
    """Each consumer warpgroup computes every key step that holds a pair
    its rows see, in the ring's order and within the block's ring, and
    the steps it hands back hold none of its pairs: no visible term of dQ
    is dropped, whichever warpgroup skips the diagonal's far side or the
    window's near side."""
    Sq, Sk, causal, window = case
    qi = np.arange(Sq)[:, None]
    kj = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis = kj <= qi
        if window > 0:
            vis &= kj > qi - window
    for q0 in range(0, Sq, rows):
        ring, walks = _walks(rows, Sq, Sk, causal, window, q0)
        assert ring == sorted(ring) and all(k0 < Sk for k0 in ring)
        for wq0, steps in walks:
            assert set(steps) <= set(ring)
            block = vis[wq0:wq0 + 64]
            need = {k0 for k0 in range(0, Sk, DQ_KEYS)
                    if block[:, k0:k0 + DQ_KEYS].any()}
            assert need <= set(steps)
            assert steps == ring[ring.index(steps[0]):][:len(steps)] \
                if steps else True
