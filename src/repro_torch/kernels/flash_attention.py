"""Bindings of `csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`:
causal / sliding-window GQA attention forward with an online softmax
(`repro.kernels.flash_attention` counterpart; the plain versions are
`ref.attention` and `ref.attention_fwd`) and its backward
(`repro.kernels.xla_flash._flash_bwd_impl` counterpart; the plain version
is `ref.attention_bwd` and, summed the way the kernels sum,
`ref.attention_bwd_tiled`), with the launch plans `fwd_plan` and
`bwd_plan`."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

# head dimensions compiled into csrc/flash_attention.cu and
# flash_attention_bwd.cu (96: MLA's 64 + 32 query/key dims)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's tiles compiled into csrc/flash_attention_bwd.cu
BWD_F32_TILES = (64, 32, 16)  # float32: dq query rows, dkdv keys a block
BWD_F32_WALK = 64             # float32: dq keys, dkdv query rows a step
MAX_CLUSTER = 8               # csrc kMaxCluster: blocks of a cluster at most
PARTS = {"prep": 1, "dq": 2, "dkdv": 4}  # csrc kPart*: kernels of a call


# the bf16 forward's tiles (csrc FwdTiles<D, NWG>), by its consumer
# warpgroups: query rows, keys a tile, the shared bytes its blocks of one
# SM may use (one block an SM with two consumers, two with one), and the
# registers a thread after setmaxnreg (producer, consumer) against the
# launch's (__launch_bounds__: 384 threads at 1 block, 256 at 2 blocks)
SM_SHARED = 233472  # bytes of shared memory an SM, 1024 of it reserved a block
FWD_ROWS = {2: 128, 1: 64}
FWD_KEYS = {2: 128, 1: 64}
FWD_BUDGET = {2: SM_SHARED - 1024, 1: SM_SHARED // 2 - 1024}
FWD_REGS = {2: (24, 240), 1: (24, 232)}
FWD_LAUNCH_REGS = {2: 168, 1: 128}
FWD_MAX_STAGES = 4
# query rows from which the bf16 forward takes two consumer warpgroups
FWD_LONG = 1024
# the bf16 dK/dV kernel's tiles (csrc BwdTiles<D, NC, QR>), by its
# consumer warpgroups of 64 keys: keys a block, query rows a step (every
# pair compiled at every head dim but `BWD_SPILLS`), the shared bytes and
# registers as the forward's (one block an SM with two consumers, two
# with one)
BWD_KEYS = {2: 128, 1: 64}
BWD_ROWS = (64, 32)
BWD_REGS = {2: (24, 240), 1: (24, 232)}
BWD_MAX_STAGES = 4
# (D, consumers, rows) not compiled: its registers spill (ptxas)
BWD_SPILLS = {(128, 1, 64)}
# keys from which a bf16 dkdv block takes two consumer warpgroups, and
# the ring stages the rule takes
BWD_LONG = 1024
BWD_STAGES = 2
# the bf16 dQ kernel's tiles (csrc DqTiles<D, NC>), by its consumer
# warpgroups of 64 query rows: query rows a block (both compiled at every
# head dim), keys a step, the ring's K/V stages at most; blocks an SM
# (`dq_blocks_per_sm`: one with two consumers, two with one, three with
# one at D <= DQ_SMALL_D) share an SM's shared memory and registers
DQ_ROWS = {2: 128, 1: 64}
DQ_KEYS = 64
DQ_MAX_STAGES = 4
DQ_SMALL_D = 64
# query rows from which a bf16 dq block takes two consumer warpgroups
DQ_LONG = 1024
# the float32 forward's tiles (csrc Tf32Tiles<D, BK>): 64 query rows a
# block, key tiles of 32 or 64; Q's hi and lo beside a ring of stages of
# five tiles (K with its hi in place, K's lo, V, V^T's hi and lo), as
# many as fit one block an SM up to FWD_MAX_STAGES, two at least
FWD_F32_ROWS = 64
FWD_F32_KEYS = (32, 64)
FWD_F32_BUDGET = 232448


class FwdPlan(NamedTuple):
    """How a forward launch cuts the work.  ``kernel`` is
    ``flash_kernel_wgmma`` (bf16) or ``flash_kernel_tf32`` (float32); a
    block owns ``rows`` query rows of one (batch, head) and walks its keys
    ``keys`` at a time through a ring of ``stages`` K/V stages (Q and K
    stored with a ``swizzle``-byte swizzle), with ``consumers`` warpgroups
    of 64 rows behind a producer (bf16: a warpgroup; float32: one thread
    of the warpgroup that splits each tile); grid ``grid`` = (B H, query
    tiles), the last query tile dispatched first.  ``smem``: dynamic
    shared bytes of a block; ``regs``: registers of its threads after
    setmaxnreg (0 for the float32 kernel, which sets none)."""
    kernel: str
    rows: int
    keys: int
    stages: int
    swizzle: int
    consumers: int
    grid: tuple
    smem: int
    regs: int


def fwd_tiles(D: int, consumers: int):
    """(atom, stages, smem) of the bf16 forward at head dim ``D``: the
    swizzled row's elements (the widest of 64, 32, 16 dividing D), the
    ring's K/V stages (up to `FWD_MAX_STAGES` that fit `FWD_BUDGET`), and
    the dynamic shared bytes with 1024 to align the tiles and 128 for the
    mbarriers, as `csrc/flash_attention.cu` FwdTiles computes them."""
    atom = 64 if D % 64 == 0 else 32 if D % 32 == 0 else 16
    q_bytes = FWD_ROWS[consumers] * D * 2
    tile = FWD_KEYS[consumers] * D * 2
    stages = min(FWD_MAX_STAGES,
                 (FWD_BUDGET[consumers] - 1024 - 128 - q_bytes) // (2 * tile))
    return atom, stages, 1024 + q_bytes + stages * 2 * tile + 128


def fwd_f32_tiles(D: int, keys: int):
    """(atom, stages, smem) of the float32 forward at head dim ``D`` and
    ``keys``-key tiles: the floats of a swizzled row of Q and K (32 where
    they divide D, else 16), the ring's stages (up to `FWD_MAX_STAGES`
    that fit `FWD_F32_BUDGET`; the kernel takes two at least), and the
    dynamic shared bytes with 1024 to align the tiles and 128 for the
    mbarriers, as `csrc/flash_attention.cu` tf32_stages and Tf32Tiles
    compute them."""
    atom = 32 if D % 32 == 0 else 16
    q_bytes = 2 * FWD_F32_ROWS * D * 4
    stage = 5 * keys * D * 4
    stages = min(FWD_MAX_STAGES,
                 (FWD_F32_BUDGET - 1024 - 128 - q_bytes) // stage)
    return atom, stages, 1024 + q_bytes + stages * stage + 128


def fwd_f32_keys(D: int) -> tuple:
    """The key tiles the float32 forward is compiled for at head dim
    ``D``: those whose ring holds two stages."""
    return tuple(n for n in FWD_F32_KEYS if fwd_f32_tiles(D, n)[1] >= 2)


def fwd_plan(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
             causal: bool, itemsize: int, sms: int) -> FwdPlan:
    """The forward's launch plan for these shapes on ``sms`` SMs.

    bf16 (``itemsize`` 2): two consumer warpgroups (128 rows, 128-key
    tiles, one block an SM) from `FWD_LONG` query rows on, else one (64
    rows, 64-key tiles, two blocks an SM).  `chip_smoke.py`'s kernels
    phase times both at every served and training shape (NVIDIA H100 80GB
    HBM3, 700 W): from 1,500 rows 128 ran 1.02-1.62x faster (Zamba2's
    (1, 32, 2048, 80) 0.0749 ms against 0.1211, LLaVA's 3328-row image
    prefill 0.3172 against 0.3929), below 1,024 rows 64 ran 1.05-1.33x
    faster (Qwen2's (1, 64, 448, 128) 0.0200 against 0.0233), save
    Zamba2's (1, 32, 448, 80), 0.0131 against 0.0130.

    float32 (``itemsize`` 4): `flash_kernel_tf32`, 64 rows a block and
    32-key tiles.  The kernels phase times 64-key tiles too where two
    stages of them fit (D <= 64): never faster (NVIDIA H100 80GB HBM3,
    700 W: train-100m's (4, 8, 128, 64) 0.0092 ms against 0.0092; the
    zoo's 0.0041-0.0055 against 0.0036-0.0047): the shapes on the float32
    paths hold 16-128 keys, so a longer tile only adds masked keys or
    halves the ring.  Shapes only."""
    if itemsize != 2:
        return _tf32_plan(B * H, Sq, D, FWD_F32_KEYS[0])
    return _wgmma_plan(B * H, Sq, D, 2 if Sq >= FWD_LONG else 1)


def _wgmma_plan(slabs: int, Sq: int, D: int, nwg: int) -> FwdPlan:
    """The bf16 kernel's plan with ``nwg`` consumer warpgroups."""
    atom, stages, smem = fwd_tiles(D, nwg)
    producer, consumer = FWD_REGS[nwg]
    return FwdPlan("flash_kernel_wgmma", FWD_ROWS[nwg], FWD_KEYS[nwg],
                   stages, 2 * atom, nwg, (slabs, -(-Sq // FWD_ROWS[nwg])),
                   smem, 128 * (producer + nwg * consumer))


def _tf32_plan(slabs: int, Sq: int, D: int, keys: int) -> FwdPlan:
    """The float32 kernel's plan with ``keys``-key tiles."""
    atom, stages, smem = fwd_f32_tiles(D, keys)
    return FwdPlan("flash_kernel_tf32", FWD_F32_ROWS, keys, stages,
                   4 * atom, 1, (slabs, -(-Sq // FWD_F32_ROWS)), smem, 0)


def fwd_plans(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
              causal: bool, itemsize: int, sms: int) -> list:
    """The plan `fwd_plan` picks, then the ones its rule passes over
    (bf16: the other number of consumer warpgroups; float32: the other
    key tile, where it is compiled)."""
    chosen = fwd_plan(B, H, KV, Sq, Sk, D, causal, itemsize, sms)
    if itemsize != 2:
        return [chosen] + [_tf32_plan(B * H, Sq, D, n)
                           for n in fwd_f32_keys(D) if n != chosen.keys]
    return [chosen, _wgmma_plan(B * H, Sq, D, 3 - chosen.consumers)]


class BwdPlan(NamedTuple):
    """How a backward launch cuts the work.  dq: blocks of ``dq_rows``
    query rows of one (batch, head), walking ``dq_keys`` keys a step, grid
    ``dq_grid`` = (B H, query tiles); dkdv: blocks of ``kv_keys`` keys,
    walking ``kv_rows`` query rows a step of ``heads`` query heads, summed
    in head order; the ``cluster`` blocks of one (key tile, kv head) sum
    their partials in rank order, grid ``kv_grid`` = (B KV cluster, key
    tiles).  In bf16 the dkdv block is ``flash_bwd_dkdv_wgmma``:
    ``kv_keys`` / 64 consumer warpgroups behind a producer, q and dO
    through a ring of ``stages`` stages (0 in float32, which has no
    ring).  In bf16 the dq block is ``flash_bwd_dq_wgmma``: ``dq_rows`` /
    64 consumer warpgroups behind a producer, K and V through a ring of
    as many stages as fit (`bwd_dq_tiles`).  The tile is the slow grid axis:
    dkdv dispatches key tile 0 first, a causal dq the last query tile
    first, every head's heaviest tile before any head's next."""
    dq_rows: int
    dq_keys: int
    kv_keys: int
    kv_rows: int
    heads: int
    cluster: int
    stages: int
    dq_grid: tuple
    kv_grid: tuple


def bwd_tiles(D: int, consumers: int, rows: int, stages: int = 0):
    """(atom, stages, smem) of the bf16 dK/dV kernel at head dim ``D``
    with ``consumers`` warpgroups of 64 keys and ``rows`` query rows a
    step: the swizzled row's elements (as `fwd_tiles`), the ring's stages
    (``stages``, or the most up to `BWD_MAX_STAGES` that fit
    `FWD_BUDGET`), and the dynamic shared bytes: 1024 to align the tiles,
    K and V of the key tile, a stage's q and dO tiles and lse and D rows,
    or the float32 partials of dK and dV ([keys][D + 4] each) where they
    are larger, and 128 for the mbarriers, as `csrc/flash_attention_bwd.cu`
    BwdTiles computes them."""
    atom = 64 if D % 64 == 0 else 32 if D % 32 == 0 else 16
    keys = BWD_KEYS[consumers]
    kv, step, row = 2 * keys * D * 2, 2 * rows * D * 2, 2 * rows * 4
    fit = min(BWD_MAX_STAGES,
              (FWD_BUDGET[consumers] - 1024 - 128 - kv) // (step + row))
    stages = stages or fit
    parts = 2 * keys * (D + 4) * 4
    return atom, stages, 1024 + max(kv + stages * (step + row), parts) + 128


def dq_blocks_per_sm(D: int, consumers: int) -> int:
    """Blocks an SM the bf16 dQ kernel is built for (its launch bounds)."""
    return 1 if consumers == 2 else 3 if D <= DQ_SMALL_D else 2


def bwd_dq_tiles(D: int, consumers: int):
    """(atom, stages, smem) of the bf16 dQ kernel at head dim ``D`` with
    ``consumers`` warpgroups of 64 query rows: the swizzled row's elements
    (as `fwd_tiles`), the ring's K/V stages (the most up to
    `DQ_MAX_STAGES` that fit a block's share of the SM), and the dynamic
    shared bytes: 1024 to align the tiles, q and dO of the block's rows,
    the ring, and 128 for the mbarriers, as `csrc/flash_attention_bwd.cu`
    DqTiles computes them."""
    atom = 64 if D % 64 == 0 else 32 if D % 32 == 0 else 16
    budget = SM_SHARED // dq_blocks_per_sm(D, consumers) - 1024
    q, step = 2 * DQ_ROWS[consumers] * D * 2, 2 * DQ_KEYS * D * 2
    stages = min(DQ_MAX_STAGES, (budget - 1024 - 128 - q) // step)
    return atom, stages, 1024 + q + stages * step + 128


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


def bwd_variants(D: int) -> tuple:
    """The (consumers, rows a step) the bf16 dK/dV kernel is compiled for
    at head dim ``D``: every pair but `BWD_SPILLS`'."""
    return tuple((nc, rows) for nc in sorted(BWD_KEYS, reverse=True)
                 for rows in BWD_ROWS if (D, nc, rows) not in BWD_SPILLS)


def bwd_plan(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
             causal: bool, itemsize: int, sms: int) -> BwdPlan:
    """The backward's launch plan for these shapes on ``sms`` SMs.

    bf16 (``itemsize`` 2): dq blocks of two consumer warpgroups (128 query
    rows) from `DQ_LONG` query rows on at D > `DQ_SMALL_D`, else one (64
    rows; three blocks an SM at D <= `DQ_SMALL_D`), each with the most
    K/V stages its ring holds (`bwd_dq_tiles`); dkdv blocks of two
    consumer warpgroups (128 keys) from `BWD_LONG` keys on, else one (64
    keys); 64 query rows a step where that variant is compiled (not one
    consumer at D = 128, `BWD_SPILLS`), else 32; `BWD_STAGES` ring
    stages; one query head a dkdv block and a cluster of G blocks
    (`cluster_heads` past G = 8).  `tools/flash_bwd_times.py --plans`
    times every variant at the bf16 training shapes (NVIDIA H100 80GB
    HBM3, 700 W; PERF.md §6): 64 rows took 10-17% less dkdv time than 32
    wherever both are built; 128 keys 1% less than 64 at Zamba2's and
    MiniCPM3's 2,048 keys, 2-4% more at Granite's and Whisper's
    1,500-2,048, and 18-56% more below 1,024 keys (Whisper's decoder,
    LLaVA's 192); 2 stages within 3.5% of 4 either way.  With two blocks
    an SM for one dq consumer, two consumers took 2-15% less dq time than
    one at 2,048 query rows and D = 80-128 (Yi-9B 0.2358 ms against
    0.2468, Zamba2 0.1091 against 0.1290), were within 4% either way at
    D = 64 (Granite's 2,048, Whisper's 1,500 and 448), and 2-5% slower
    at LLaVA's 192 and Whisper's cross attention; there, at D = 64, a
    step's latency bounded dq and Whisper's encoder's blocks filled 1.45
    waves at either size, so at D <= 64 one consumer is built for three
    blocks an SM (PERF.md §6 has both forms' times).  float32: 16-, 32-
    or 64-row dq
    tiles and key dkdv tiles, the largest that give each grid two blocks
    an SM (`_fill_tile`), the G heads of a kv head in one block.  Shapes
    only."""
    G = H // KV
    if itemsize == 2:
        nc = 2 if Sk >= BWD_LONG else 1
        rows = next(r for n, r in bwd_variants(D) if n == nc)
        return _wgmma_bwd_plan(B, H, KV, Sq, Sk, D, nc, rows, BWD_STAGES,
                               2 if Sq >= DQ_LONG and D > DQ_SMALL_D else 1)
    dq_rows, kv_keys = _fill_tile(B * H, Sq, sms), _fill_tile(B * KV, Sk, sms)
    return BwdPlan(dq_rows, BWD_F32_WALK, kv_keys, BWD_F32_WALK, G, 1, 0,
                   (B * H, -(-Sq // dq_rows)), (B * KV, -(-Sk // kv_keys)))


def _wgmma_bwd_plan(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
                    consumers: int, rows: int, stages: int = 0,
                    dq_consumers: int = 1) -> BwdPlan:
    """The bf16 plan with ``consumers`` dkdv warpgroups, ``rows`` query
    rows a step and ``stages`` ring stages (0: the most that fit), and
    ``dq_consumers`` dq warpgroups."""
    heads = cluster_heads(H // KV)
    cluster = H // KV // heads
    keys = BWD_KEYS[consumers]
    stages = bwd_tiles(D, consumers, rows, stages)[1]
    dq_rows = DQ_ROWS[dq_consumers]
    return BwdPlan(dq_rows, DQ_KEYS, keys, rows, heads, cluster, stages,
                   (B * H, -(-Sq // dq_rows)),
                   (B * KV * cluster, -(-Sk // keys)))


def bwd_plans(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
              causal: bool, itemsize: int, sms: int) -> list:
    """The plan `bwd_plan` picks, then the ones its rule passes over
    (bf16: every other compiled dkdv variant, consumers and query rows a
    step (`bwd_variants`), at `BWD_STAGES`, the chosen one at the ring's
    most stages, and every other dq variant (`DQ_ROWS`), each beside the
    chosen plan's other part; float32: every
    other tile, dq rows and dkdv keys alike)."""
    chosen = bwd_plan(B, H, KV, Sq, Sk, D, causal, itemsize, sms)
    plans = [chosen]
    if itemsize == 2:
        dq_nc = chosen.dq_rows // 64
        alts = [_wgmma_bwd_plan(B, H, KV, Sq, Sk, D, nc, rows, BWD_STAGES,
                                dq_nc) for nc, rows in bwd_variants(D)]
        alts.append(_wgmma_bwd_plan(B, H, KV, Sq, Sk, D,
                                    chosen.kv_keys // 64, chosen.kv_rows, 0,
                                    dq_nc))
        alts += [_wgmma_bwd_plan(B, H, KV, Sq, Sk, D, chosen.kv_keys // 64,
                                 chosen.kv_rows, chosen.stages, nc)
                 for nc in sorted(DQ_ROWS, reverse=True)]
    else:
        alts = [chosen._replace(dq_rows=t, kv_keys=t,
                                dq_grid=(B * H, -(-Sq // t)),
                                kv_grid=(B * KV, -(-Sk // t)))
                for t in BWD_F32_TILES]
    for p in alts:
        if p not in plans:
            plans.append(p)
    return plans


@functools.lru_cache(maxsize=None)
def bwd_max_clusters(index: int, D: int, plan: BwdPlan) -> int:
    """Clusters of ``plan``'s bf16 dkdv blocks card ``index`` holds at
    once, by `cudaOccupancyMaxActiveClusters`."""
    with torch.cuda.device(index):
        return _build.extension().flash_bwd_max_clusters(
            D, plan.kv_keys, plan.kv_rows, plan.stages, plan.cluster)


@functools.lru_cache(maxsize=None)
def bwd_dq_blocks(index: int, D: int, rows: int) -> int:
    """bf16 dq blocks of ``rows`` query rows one SM of card ``index``
    holds at once, by `cudaOccupancyMaxActiveBlocksPerMultiprocessor`."""
    with torch.cuda.device(index):
        return _build.extension().flash_bwd_dq_blocks(D, rows)


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
    writes none.  One call is one counted launch, cut by `fwd_plan`; no
    key at all (Sk = 0) launches nothing and gives zeros (lse ``NEG_INF``,
    as the kernel writes for a row that sees no key)."""
    _build.check_cuda("flash_attention", q, k, v)
    _check("flash_attention", q, k, v)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() and not Sk:
        out.zero_()
        if lse is not None:
            lse.fill_(ref.NEG_INF)
    elif q.numel():
        _build.check_aligned("flash_attention", q, k, v)
        plan = fwd_plan(B, H, KV, Sq, Sk, D, causal, q.element_size(),
                        _build.sm_count(q.device.index))
        _launch_fwd(q, k, v, out, lse, causal, window, plan)
    return (out, lse) if return_lse else out


def _launch_fwd(q, k, v, out, lse, causal: bool, window: int,
                plan: FwdPlan) -> None:
    """Launch the forward on checked operands with ``plan``, writing
    ``out`` (and ``lse`` unless None)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    _build.extension().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(), B, H, KV, Sq, Sk, D,
        D ** -0.5, int(causal), int(window), DTYPES[q.dtype], plan.rows,
        plan.keys, _build.stream_of(q))
    _build.count_launch("flash_attention")


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
    _build.check_aligned("flash_attention_bwd", q, k, v, o, do)
    plan = bwd_plan(B, H, KV, Sq, Sk, D, causal, q.element_size(),
                    _build.sm_count(q.device.index))
    return _launch_bwd(q, k, v, o, lse, do, causal, window, plan)[:3]


def _launch_bwd(q, k, v, o, lse, do, causal: bool, window: int,
                plan: BwdPlan, parts: int = 7, delta=None, ext=None):
    """Launch the backward's kernels named by ``parts`` (`PARTS` bits; 7:
    all three) on checked operands with ``plan``; -> (dq, dk, dv, delta).
    A part left out leaves its outputs unwritten; without the prep pass dq
    and dkdv read ``delta`` (float32 (B,H,Sq), from an earlier call).
    ``ext``: a timing copy of the kernels (`_build.extension(defines=)`)
    to launch instead of the build the wrapper uses."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if delta is None:
        delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    (ext or _build.extension()).flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, KV, Sq, Sk, D, D ** -0.5,
        int(causal), int(window), DTYPES[q.dtype], plan.dq_rows,
        plan.kv_keys, plan.kv_rows, plan.heads, plan.cluster, plan.stages,
        parts, _build.stream_of(q))
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv, delta
