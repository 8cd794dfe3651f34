"""The design of the flash backward (`csrc/flash_attention_bwd.cu`) on the
CPU: its launch plan `flash_attention.bwd_plan`, and its sums as an
algorithm.

`ref.attention_bwd_tiled` computes the backward the way the kernels sum
under a plan: float32 partials of dK and dV per (key tile, query head),
summed in head order inside a dkdv block and over a thread block cluster
in rank order, dQ over its key tiles in order, P and dS rounded to bf16
where they enter a product.  The same numpy inputs go through `jax.vjp` of
`repro.kernels.xla_flash.flash_attention_xla` (its `_flash_bwd_impl`) and
through `ref.attention_bwd`: float32 within 1e-5, bf16 within 2e-2 (the
tolerances of tests/test_torch_flash_bwd.py and tests/test_kernels.py).
G = 1, 2, 7 and 8 (clusters of 7 and 8), causal, windowed and non-causal
with Sq != Sk, ragged lengths.

The plan is checked against the grids the kernels launch, without a
card: every (key tile, query head) and (query tile, head) in exactly one
block, the cluster size, the heaviest tiles dispatched first, and the
float32 grids filling 132 SMs.  The block mapping below mirrors the
kernels' (`flash_bwd_dq_*`, `flash_bwd_dkdv_*`).
"""
import collections
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.xla_flash import flash_attention_xla
from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (BWD_KEYS, BWD_LONG,
                                                 BWD_MAX_STAGES, BWD_REGS,
                                                 BWD_ROWS, BWD_SPILLS,
                                                 BWD_STAGES, FWD_BUDGET,
                                                 FWD_LAUNCH_REGS, HEAD_DIMS,
                                                 MAX_CLUSTER, bwd_plan,
                                                 bwd_plans, bwd_tiles,
                                                 bwd_variants, cluster_heads)

SMS = 132  # the H100's SMs
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# (B, H, KV, Sq, Sk, D, causal, window): 70, 77, 90, 100 and 37 are
# ragged against every tile
CASES = [
    (2, 4, 4, 64, 64, 16, True, 0),      # G = 1
    (1, 4, 2, 77, 77, 32, True, 0),      # G = 2, ragged
    (1, 7, 1, 70, 70, 16, True, 0),      # G = 7, a cluster of 7
    (1, 14, 2, 90, 90, 32, True, 24),    # G = 7, windowed
    (1, 8, 1, 100, 100, 16, True, 0),    # G = 8, a cluster of 8
    (1, 16, 2, 64, 64, 32, True, 16),    # G = 8, windowed
    (1, 8, 1, 37, 150, 16, False, 0),    # G = 8, non-causal, Sq < Sk
    (2, 4, 2, 150, 37, 32, False, 0),    # G = 2, non-causal, Sq > Sk
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which parallel test workers
    sharing the cores do not make wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(case, dtype):
    """(q, k, v, do) as numpy float32 holding ``dtype`` values."""
    B, H, KV, Sq, Sk, D, _, _ = case
    rng = np.random.default_rng(Sq * 1000 + Sk + H)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, KV, Sk, D), (B, KV, Sk, D),
                      (B, H, Sq, D))]
    return [torch.from_numpy(a).to(TDT[dtype]).float().numpy() for a in arrs]


def _tiled(case, dtype, arrs):
    B, H, KV, Sq, Sk, D, causal, window = case
    q, k, v, do = (torch.from_numpy(a).to(TDT[dtype]) for a in arrs)
    plan = bwd_plan(B, H, KV, Sq, Sk, D, causal,
                    torch.tensor([], dtype=TDT[dtype]).element_size(), SMS)
    o, lse = ref.attention_fwd(q, k, v, causal=causal, window=window)
    got = ref.attention_bwd_tiled(q, k, v, o, lse, do, causal=causal,
                                  window=window, plan=plan)
    want = ref.attention_bwd(q, k, v, o, lse, do, causal=causal,
                             window=window)
    return plan, got, want


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("case", CASES)
def test_tiled_backward_matches_repro_vjp(case, dtype):
    B, H, KV, Sq, Sk, D, causal, window = case
    arrs = _inputs(case, dtype)
    plan, got, want = _tiled(case, dtype, arrs)
    assert plan.heads * plan.cluster == H // KV
    jq, jk, jv, jdo = (jnp.asarray(a, JDT[dtype]) for a in arrs)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_xla(
        a, b, c, causal, window, Sq, Sk), jq, jk, jv)
    for g, w in zip(got, vjp(jdo)):
        assert g.dtype == TDT[dtype]
        _close(g.float().numpy(), np.asarray(w, np.float32), dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("case", CASES)
def test_tiled_backward_matches_plain_backward(case, dtype):
    _, got, want = _tiled(case, dtype, _inputs(case, dtype))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g.float().numpy(), w.float().numpy(), dtype)


def test_cluster_sum_is_one_fold_in_head_order():
    """bf16 at G = 8: a cluster of 8 one-head blocks summed in rank order
    is one left fold over the heads in head order, the same sum as one
    block taking all 8 heads: equal bit for bit."""
    case = (1, 8, 1, 48, 48, 16, True, 0)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(case, "bfloat16"))
    plan = bwd_plan(1, 8, 1, 48, 48, 16, True, 2, SMS)
    assert (plan.heads, plan.cluster) == (1, 8)
    o, lse = ref.attention_fwd(q, k, v)
    got = ref.attention_bwd_tiled(q, k, v, o, lse, do, plan=plan)
    one = ref.attention_bwd_tiled(q, k, v, o, lse, do,
                                  plan=plan._replace(heads=8, cluster=1))
    for a, b in zip(got, one):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the launch plan
# ----------------------------------------------------------------------
def _dq_blocks(plan, H, causal=True):
    """(batch, head, first query row) of each dq block in the order of the
    linear block index (x fastest): tile y, causal the last first."""
    nx, ny = plan.dq_grid
    for y in range(ny):
        tile = ny - 1 - y if causal else y
        for x in range(nx):
            yield x // H, x % H, tile * plan.dq_rows


def _kv_blocks(plan, KV):
    """(batch, kv head, its query heads, first key) of each dkdv block in
    linear order: rank r of a cluster takes heads r heads ..
    (r + 1) heads - 1 of its kv head."""
    nx, ny = plan.kv_grid
    for y in range(ny):
        for x in range(nx):
            bk, rank = divmod(x, plan.cluster)
            yield (bk // KV, bk % KV,
                   range(rank * plan.heads, (rank + 1) * plan.heads),
                   y * plan.kv_keys)


def _dq_walk(plan, q0, Sk):
    """Key steps a causal dq block walks (the kernel's loop bounds)."""
    return -(-min(Sk, q0 + plan.dq_rows) // plan.dq_keys)


def _kv_walk(plan, k0, Sq):
    """Query steps a causal dkdv block walks for each of its heads."""
    return max(0, -(-Sq // plan.kv_rows) - k0 // plan.kv_rows)


PLAN_SHAPES = [  # (B, H, KV, Sq, Sk, D)
    (2, 32, 4, 2048, 2048, 128),   # Yi-9B, G = 8
    (1, 56, 8, 320, 320, 128),     # LLaVA's copy, G = 7
    (1, 16, 8, 2048, 2048, 64),    # Granite, G = 2
    (1, 32, 32, 2048, 2048, 80),   # Zamba2, G = 1
    (2, 8, 8, 448, 1500, 64),      # Whisper's cross attention
    (1, 24, 2, 100, 100, 64),      # G = 12
    (1, 64, 1, 70, 70, 32),        # G = 64
    (4, 8, 8, 128, 128, 64),       # train-100m
    (16, 2, 2, 32, 32, 16),        # zoo-s
    (2, 4, 4, 100, 100, 96),       # MLA float32
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_tile_once(shape, itemsize, causal):
    B, H, KV, Sq, Sk, D = shape
    plan = bwd_plan(B, H, KV, Sq, Sk, D, causal, itemsize, SMS)
    G = H // KV
    dq = collections.Counter(_dq_blocks(plan, H, causal))
    want = {(b, h, t) for b in range(B) for h in range(H)
            for t in range(0, Sq, plan.dq_rows)}
    assert set(dq) == want and set(dq.values()) == {1}
    kv = collections.Counter((b, kvh, g, k0) for b, kvh, heads, k0 in
                             _kv_blocks(plan, KV) for g in heads)
    want = {(b, kvh, g, k0) for b in range(B) for kvh in range(KV)
            for g in range(G) for k0 in range(0, Sk, plan.kv_keys)}
    assert set(kv) == want and set(kv.values()) == {1}
    assert plan.dq_grid[0] * plan.dq_grid[1] == len(dq)
    assert plan.kv_grid[1] * plan.kv_grid[0] * plan.heads == len(kv)


@pytest.mark.parametrize("G, heads, cluster", [
    (1, 1, 1), (2, 1, 2), (4, 1, 4), (7, 1, 7), (8, 1, 8), (12, 2, 6),
    (16, 2, 8), (64, 8, 8)])
def test_cluster_size(G, heads, cluster):
    plan = bwd_plan(1, G, 1, 256, 256, 128, True, 2, SMS)
    assert (plan.heads, plan.cluster) == (heads, cluster)
    assert cluster_heads(G) == heads and cluster <= MAX_CLUSTER
    f32 = bwd_plan(1, G, 1, 256, 256, 64, True, 4, SMS)
    assert (f32.heads, f32.cluster) == (G, 1)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_heaviest_tiles_first(shape, itemsize):
    """Causal: the work of a block (the steps its loop takes) never rises
    along the linear block index, in dq and in dkdv."""
    B, H, KV, Sq, Sk, D = shape
    plan = bwd_plan(B, H, KV, Sq, Sk, D, True, itemsize, SMS)
    work = [_dq_walk(plan, q0, Sk)
            for _, _, q0 in _dq_blocks(plan, H)]
    assert work == sorted(work, reverse=True)
    work = [_kv_walk(plan, k0, Sq) * len(heads)
            for _, _, heads, k0 in _kv_blocks(plan, KV)]
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("shape, blocks, tile", [
    ((4, 8, 8, 128, 128, 64), 256, 16),     # train-100m: 64 blocks before
    ((16, 2, 2, 32, 32, 16), 64, 16),       # zoo-s: 32 before
    ((16, 4, 4, 32, 32, 32), 128, 16),      # zoo-l: 64 before
    ((2, 4, 4, 100, 100, 96), 56, 16),      # MLA: 16 before
    ((1, 32, 32, 2048, 2048, 64), 1024, 64),  # two blocks an SM at 64
])
def test_float32_grids_fill_the_card(shape, blocks, tile):
    """At train-100m's shape each float32 grid has at least 256 blocks;
    at the zoo's, the most that 16-row tiles give; a shape whose 64-row
    tiles already give two blocks an SM keeps them."""
    B, H, KV, Sq, Sk, D = shape
    plan = bwd_plan(B, H, KV, Sq, Sk, D, True, 4, SMS)
    assert (plan.dq_rows, plan.kv_keys) == (tile, tile)
    for grid in (plan.dq_grid, plan.kv_grid):
        assert grid[0] * grid[1] >= blocks


# (B, H, KV, Sq, Sk, D, causal) -> the bf16 dkdv's (keys a block, query
# rows a step, ring stages)
DKDV_RULE = [
    ((2, 32, 4, 2048, 2048, 128, True), (128, 64, 2)),   # Yi-9B
    ((1, 32, 32, 2048, 2048, 80, True), (128, 64, 2)),   # Zamba2
    ((1, 40, 40, 2048, 2048, 96, True), (128, 64, 2)),   # MiniCPM3
    ((1, 16, 8, 2048, 2048, 64, True), (128, 64, 2)),    # Granite
    ((2, 8, 8, 1500, 1500, 64, False), (128, 64, 2)),    # Whisper encoder
    ((1, 56, 8, 192, 192, 128, True), (64, 32, 2)),      # LLaVA's copy
    ((2, 8, 8, 448, 1500, 64, False), (128, 64, 2)),     # Whisper cross
    ((2, 8, 8, 448, 448, 64, True), (64, 64, 2)),        # Whisper decoder
    ((2, 8, 1, 100, 100, 16, True), (64, 64, 2)),        # G = 8, D = 16
    ((2, 4, 2, 33, 33, 32, True), (64, 64, 2)),          # D = 32
]


@pytest.mark.parametrize("shape, want", DKDV_RULE, ids=str)
def test_bf16_dkdv_step(shape, want):
    """The bf16 dkdv takes two consumer warpgroups (128-key blocks) from
    `BWD_LONG` keys on, else one (64 keys), 64 query rows a step where
    that variant is compiled (else 32) and `BWD_STAGES` ring stages; its
    grid covers the keys in tiles of its block, G / heads blocks of one
    key tile and kv head a cluster; `bwd_plans` weighs every compiled
    variant and the ring's most stages."""
    B, H, KV, Sq, Sk, D, causal = shape
    plan = bwd_plan(B, H, KV, Sq, Sk, D, causal, 2, SMS)
    assert (plan.kv_keys, plan.kv_rows, plan.stages) == want
    nc = plan.kv_keys // 64
    assert plan.kv_keys == BWD_KEYS[2 if Sk >= BWD_LONG else 1]
    assert (nc, plan.kv_rows) in bwd_variants(D)
    assert plan.kv_rows == 64 or (D, nc, 64) in BWD_SPILLS
    assert plan.stages == BWD_STAGES
    assert plan.kv_grid == (B * KV * plan.cluster, -(-Sk // plan.kv_keys))
    plans = bwd_plans(B, H, KV, Sq, Sk, D, causal, 2, SMS)
    assert plans[0] == plan and len(set(plans)) == len(plans)
    assert {(p.kv_keys // 64, p.kv_rows) for p in plans} == \
        set(bwd_variants(D))
    assert {p.stages for p in plans if p[:4] == plan[:4]} == {
        BWD_STAGES, bwd_tiles(D, nc, plan.kv_rows)[1]}


# ----------------------------------------------------------------------
# the bf16 dK/dV kernel's tiles and source
# ----------------------------------------------------------------------
SM_SHARED = 233472  # bytes of shared memory an SM, 1024 of it reserved a block


def _source(name):
    return (pathlib.Path(_build.CSRC) / name).read_text()


@pytest.mark.parametrize("D, consumers, rows", [
    (D, nc, rows) for D in HEAD_DIMS for nc, rows in bwd_variants(D)])
def test_bwd_tiles_fit_the_card(D, consumers, rows):
    """Every compiled dkdv variant at every bf16 head dim: two to
    `BWD_MAX_STAGES` ring stages, each within the block's share of the
    SM's shared memory (one block an SM with two consumers, two with
    one), the float32 partials of the cluster's sum included; the
    warpgroups' registers within the launch's, the consumer's
    accumulators (dK and dV, S^T and dP^T, P^T and dS^T in bf16) within
    its; and at every cluster size each key of the tile summed by one
    rank."""
    atom, most, smem = bwd_tiles(D, consumers, rows)
    keys = BWD_KEYS[consumers]
    assert D % atom == 0 and 2 * atom in (32, 64, 128)
    assert 2 <= most <= BWD_MAX_STAGES
    blocks = 3 - consumers
    for stages in range(2, most + 1):
        smem = bwd_tiles(D, consumers, rows, stages)[2]
        assert smem <= FWD_BUDGET[consumers] <= 232448
        assert blocks * (smem + 1024) <= SM_SHARED
        assert smem - 1024 - 128 >= 2 * keys * (D + 4) * 4  # the partials
    if most < BWD_MAX_STAGES:  # one more stage would not fit
        step = 2 * rows * D * 2 + 2 * rows * 4
        assert smem + step > FWD_BUDGET[consumers]
    producer, consumer = BWD_REGS[consumers]
    regs = 128 * (producer + consumers * consumer)
    assert regs <= FWD_LAUNCH_REGS[consumers] * 128 * (consumers + 1)
    assert blocks * regs <= 65536
    assert D + rows + rows // 2 <= consumer
    for cluster in range(1, MAX_CLUSTER + 1):
        cover = [r for rank in range(cluster)
                 for r in range(keys * rank // cluster,
                                keys * (rank + 1) // cluster)]
        assert cover == list(range(keys))


def test_bwd_tiles_mirror_the_kernel():
    """`bwd_tiles`' constants are `csrc/flash_attention_bwd.cu`
    BwdTiles'."""
    text = _source("flash_attention_bwd.cu")
    tiles = re.search(r"struct BwdTiles \{.*?\n\};", text, re.S).group(0)
    assert "kKeys = 64 * NC;" in tiles
    assert {nc: 64 * nc for nc in BWD_KEYS} == BWD_KEYS
    assert (f"kBudget = NC == 2 ? {FWD_BUDGET[2]} : {FWD_BUDGET[1]};"
            in tiles)
    assert f"kProducerRegs = {BWD_REGS[2][0]};" in tiles
    assert BWD_REGS[1][0] == BWD_REGS[2][0]
    assert (f"kConsumerRegs = NC == 2 ? {BWD_REGS[2][1]} : "
            f"{BWD_REGS[1][1]};") in tiles
    assert (f"(NC == 2 ? {FWD_LAUNCH_REGS[2]} * 384 : "
            f"{FWD_LAUNCH_REGS[1]} * 256)") in tiles
    assert f"kMaxStages = kFit < {BWD_MAX_STAGES} ? kFit : " \
        f"{BWD_MAX_STAGES};" in tiles
    assert "kBarBytes = 128;" in tiles
    assert "kPartBytes = 2 * kKeys * (D + kPartPad) * 4;" in tiles
    assert "constexpr int kPartPad = 4;" in text
    assert "QR == 32 || QR == 64" in tiles and set(BWD_ROWS) == {32, 64}


def test_source_runs_the_wgmma_dkdv_for_every_bf16_head_dim():
    """Every dispatched head dim's bf16 backward launches
    flash_bwd_dkdv_wgmma in each compiled variant (consumers, query rows
    a step); the mma.sync dkdv is gone; the dkdv kernel's products are
    wgmma, its tiles TMA copies, it has no atomic, and it reads a peer's
    shared memory only after a cluster barrier that follows its own
    partials' stores, and leaves only after another."""
    text = _source("flash_attention_bwd.cu")
    for gone in ("flash_bwd_dkdv_mma", "kMmaRows64", "launch_dkdv_mma"):
        assert gone not in text
    body = re.search(r"int dispatch_flash_bwd\(.*?\n}", text, re.S).group(0)
    dims = tuple(int(d) for d in re.findall(
        r"case (\d+): return launch_flash_bwd<T, \1>", body))
    assert dims == HEAD_DIMS
    assert "return launch_flash_bwd_bf16<D>(a);" in text
    bf16 = re.search(r"int launch_flash_bwd_bf16\(.*?\n}", text, re.S).group(0)
    assert "with_dkdv<D>(a.kv_keys, a.kv_rows" in bf16
    assert "launch_dkdv_wgmma<D, decltype(v)>(a)" in bf16
    pick = re.search(r"int with_dkdv\(.*?\n}", text, re.S).group(0)
    for nc, keys in BWD_KEYS.items():
        for rows in BWD_ROWS:
            assert (f"keys == {keys} && rows == {rows}) return "
                    f"f(Dkdv<D, {nc}, {rows}>{{}});") in pick
    assert BWD_SPILLS == {(128, 1, 64)}
    guarded = pick[pick.index("if constexpr (D != 128) {"):]
    assert guarded.index("f(Dkdv<D, 1, 64>{})") < guarded.index("}")
    launch = re.search(r"int launch_dkdv_wgmma\(.*?\n}", text, re.S).group(0)
    assert "flash_bwd_dkdv_wgmma<D, V::kNC, V::kQR>" in launch
    assert launch.count("encode_tile_map<bf16>") == 4
    kernel = re.search(r"flash_bwd_dkdv_wgmma\(const __grid_constant__.*?\n}",
                       text, re.S).group(0)
    assert "atom" not in kernel.replace("kAtom", "")
    assert "Wgmma<QR>::template ss<0, 0>" in kernel
    assert "Wgmma<D>::template rs<1>" in kernel
    assert "tma_load_3d" in kernel and "regs_dec" in kernel
    first_read = kernel.index("map_shared_rank")
    last_store = kernel.rindex("pk + r * PD + col", 0, first_read)
    assert "cl.sync();" in kernel[last_store:first_read]
    assert "cl.sync();" in kernel[kernel.rindex("map_shared_rank"):]
    hdr = _source("sm90.cuh")
    forms = {int(n) for n in re.findall(r"^REPRO_WGMMA\((\d+),", hdr, re.M)}
    assert set(HEAD_DIMS) | set(BWD_ROWS) <= forms
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor.3d"):
        assert ptx in hdr
