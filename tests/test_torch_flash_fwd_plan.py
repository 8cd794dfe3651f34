"""The design of the bf16 flash forward (`csrc/flash_attention.cu`'s
`flash_kernel_wgmma`) on the CPU: its order of work as an algorithm, and
its launch plan `flash_attention.fwd_plan`.

`ref.attention_fwd_tiled` walks the keys a tile at a time as the kernel
does: an online softmax in float32 in log2 units, the probabilities
rounded to the operands' dtype where they enter the product with V,
ragged tails and masks as the kernel sets them.  The same numpy inputs go
through `repro`'s Pallas `flash_attention` in interpret mode (whose
blocks must divide the lengths) and through `ref.attention_fwd`: float32
within 2e-5 (summation order only) and bf16 within 2e-2 (the kernel, and
the tiled version, round P to bf16 before the product, `repro`'s Pallas
kernel and `ref.attention_fwd` round the normalised probabilities or none:
a few bf16 ulps of the output), the tolerances of tests/test_kernels.py.
Ragged lengths are held against `ref.attention_fwd` alone.

The plan is checked at every shape `chip_smoke.py` times: the kernel, the
query rows and key tile, the ring's stages, the swizzle and the grid, the
shared bytes within the SM's and the warpgroups' registers within its
65,536; and the source is checked to instantiate the new kernel, with the
plan's constants, for exactly `HEAD_DIMS` in bf16.
"""
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (FWD_BUDGET, FWD_F32_ROWS,
                                                 FWD_KEYS, FWD_LAUNCH_REGS,
                                                 FWD_LONG, FWD_REGS,
                                                 FWD_ROWS, HEAD_DIMS,
                                                 fwd_f32_keys, fwd_f32_tiles,
                                                 fwd_plan, fwd_plans,
                                                 fwd_tiles)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMS = 132  # the H100's SMs
SM_SHARED = 233472  # bytes of shared memory an SM, 1024 of it reserved a block
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# (B, H, KV, Sq, Sk, D, causal, window), lengths multiples of the Pallas
# kernel's 64-row blocks; no row sees no key (the kernel writes 0 there,
# the plain versions the mean of V)
CASES = [
    (1, 4, 4, 128, 128, 16, True, 0),      # G = 1
    (1, 8, 2, 128, 128, 64, True, 32),     # G = 4, windowed
    (1, 4, 4, 128, 128, 64, True, 32),     # G = 1, windowed
    (2, 4, 1, 64, 192, 80, False, 0),      # G = 4, Sq < Sk, non-causal
    (1, 4, 4, 128, 128, 96, True, 0),      # MLA's head dim
    (1, 8, 2, 128, 128, 128, False, 0),    # G = 4, non-causal
    (1, 4, 1, 192, 128, 128, True, 0),     # G = 4, Sq > Sk, causal
]
# ragged against every tile: 100, 77, 37, 150, 130, 1
RAGGED = [
    (2, 8, 2, 100, 100, 64, True, 0),
    (1, 4, 4, 77, 77, 80, True, 16),
    (2, 4, 1, 37, 150, 96, False, 0),
    (1, 4, 4, 150, 37, 16, False, 0),
    (1, 8, 2, 130, 130, 128, True, 48),
    (1, 4, 1, 1, 77, 32, False, 0),
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
    """(q, k, v) as CPU tensors of ``dtype`` from a seeded numpy draw."""
    B, H, KV, Sq, Sk, D, _, _ = case
    rng = np.random.default_rng(Sq * 1000 + Sk + H + D)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(TDT[dtype])
            for s in ((B, H, Sq, D), (B, KV, Sk, D), (B, KV, Sk, D))]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("keys", sorted(set(FWD_KEYS.values())))
@pytest.mark.parametrize("dtype", sorted(TDT))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_tiled_forward_matches_pallas_flash(case, dtype, keys):
    _, _, _, _, _, _, causal, window = case
    q, k, v = _inputs(case, dtype)
    o, lse = ref.attention_fwd_tiled(q, k, v, causal=causal, window=window,
                                     keys=keys)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    exp = pallas_flash(*(jnp.asarray(t.float().numpy(), JDT[dtype])
                         for t in (q, k, v)),
                       causal=causal, window=window, block_q=64, block_k=64,
                       interpret=True)
    _close(o, torch.from_numpy(np.asarray(exp, np.float32)), TOL[dtype])
    want_o, want_lse = ref.attention_fwd(q, k, v, causal=causal,
                                         window=window)
    _close(o, want_o, TOL[dtype])
    _close(lse, want_lse, TOL["float32"])


@pytest.mark.parametrize("keys", sorted(set(FWD_KEYS.values())))
@pytest.mark.parametrize("dtype", sorted(TDT))
@pytest.mark.parametrize("case", RAGGED, ids=str)
def test_tiled_forward_ragged_matches_attention_fwd(case, dtype, keys):
    _, _, _, _, _, _, causal, window = case
    q, k, v = _inputs(case, dtype)
    o, lse = ref.attention_fwd_tiled(q, k, v, causal=causal, window=window,
                                     keys=keys)
    want_o, want_lse = ref.attention_fwd(q, k, v, causal=causal,
                                         window=window)
    _close(o, want_o, TOL[dtype])
    _close(lse, want_lse, TOL["float32"])


def test_tiled_forward_rounds_p_where_the_kernel_does():
    """In bf16 the tiled version differs from one without P's rounding
    (the kernel's P fragment is bf16), and in float32 it does not round."""
    case = (1, 4, 4, 128, 128, 64, True, 0)
    q, k, v = _inputs(case, "bfloat16")
    o, _ = ref.attention_fwd_tiled(q, k, v, causal=True, keys=64)
    o32, _ = ref.attention_fwd_tiled(q.float(), k.float(), v.float(),
                                     causal=True, keys=64)
    assert not torch.equal(o.float(), o32.to(torch.bfloat16).float())
    _close(o, o32, TOL["bfloat16"])


def test_tiled_forward_row_without_keys_is_zero():
    """A row that sees no key (Sq > Sk under a window) gives 0 and the lse
    sentinel, as the kernel writes it."""
    q, k, v = _inputs((1, 2, 2, 40, 8, 16, True, 4), "float32")
    o, lse = ref.attention_fwd_tiled(q, k, v, causal=True, window=4,
                                     keys=64)
    assert torch.equal(o[:, :, 12:], torch.zeros_like(o[:, :, 12:]))
    assert bool((lse[:, :, 12:] == ref.NEG_INF).all())
    assert bool((lse[:, :, :11] > ref.NEG_INF).all())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed_shapes():
    """(label, B, H, KV, Sq, Sk, D, causal, itemsize) of every forward
    `chip_smoke.py` times."""
    cs = _chip_smoke()
    out = [(arch, 1, H, KV, cs.PROMPT, cs.PROMPT, D, True, 2)
           for arch, (H, KV, D, _) in cs.ATTN_SHAPES.items()]
    arch, H, D, _ = cs.MLA_ATTN
    out.append((f"{arch} MLA", 1, H, H, cs.PROMPT, cs.PROMPT, D, True, 2))
    out += [(label, B, H, KV, Sq, Sk, D, causal, 2)
            for label, B, H, KV, Sq, Sk, D, causal in cs.MEDIA_FLASH]
    out += [(label, B, H, KV, Sq, Sk, D, causal,
             2 if dt == "bfloat16" else 4)
            for label, dt, B, H, KV, Sq, Sk, D, causal in cs.BWD_SHAPES
            if not label.startswith("zoo")]
    out += [(label, B, H, H, S, S, D, True, 4)
            for label, B, H, S, D, _ in cs.ZOO_FLASH]
    return out


# the plan at the served and training shapes of the kernel's table:
# (consumers, stages, swizzle bytes, grid)
EXPECTED = {
    "yi-9b": (1, 2, 128, (32, 7)),
    "zamba2-2.7b": (1, 4, 32, (32, 7)),
    "granite-moe-1b-a400m": (1, 4, 128, (16, 7)),
    "arctic-480b": (1, 2, 128, (56, 7)),
    "minicpm3-4b MLA": (1, 4, 64, (40, 7)),
    "llava-next-34b image prefill": (2, 3, 128, (56, 26)),
    "yi-9b train": (2, 3, 128, (64, 16)),
    "minicpm3-4b train": (2, 4, 64, (40, 16)),
    "zamba2-2.7b train": (2, 4, 32, (32, 16)),
    "whisper-base cross prefill": (1, 4, 128, (32, 1)),
}


@pytest.mark.parametrize("shape", _timed_shapes(), ids=lambda s: s[0])
def test_fwd_plan_at_every_timed_shape(shape):
    label, B, H, KV, Sq, Sk, D, causal, itemsize = shape
    plan = fwd_plan(B, H, KV, Sq, Sk, D, causal, itemsize, SMS)
    assert plan.grid == (B * H, -(-Sq // plan.rows))
    if itemsize == 4:
        assert plan.kernel == "flash_kernel_tf32" and plan.regs == 0
        assert (plan.rows, plan.consumers) == (FWD_F32_ROWS, 1)
        assert plan.keys in fwd_f32_keys(D)
        atom, stages, smem = fwd_f32_tiles(D, plan.keys)
        assert (plan.swizzle, plan.stages, plan.smem) == (4 * atom, stages,
                                                          smem)
        assert 2 <= plan.stages <= 4 and plan.smem <= 232448
        return
    assert plan.kernel == "flash_kernel_wgmma"
    nwg = plan.consumers
    assert (plan.rows, plan.keys) == (FWD_ROWS[nwg], FWD_KEYS[nwg])
    # two consumers for long query axes, else one
    assert (nwg == 2) == (Sq >= FWD_LONG)
    atom = plan.swizzle // 2
    assert D % atom == 0 and atom in (16, 32, 64)
    assert all(D % a for a in (64, 32) if a > atom)  # the widest that divides
    assert 2 <= plan.stages <= 4
    assert plan.smem == fwd_tiles(D, nwg)[2] <= FWD_BUDGET[nwg] <= 232448
    blocks = 3 - nwg  # blocks an SM: one with two consumers, two with one
    assert blocks * (plan.smem + 1024) <= SM_SHARED
    producer, consumer = FWD_REGS[nwg]
    assert plan.regs == 128 * (producer + nwg * consumer)
    assert blocks * plan.regs <= 65536
    assert plan.regs <= FWD_LAUNCH_REGS[nwg] * 128 * (nwg + 1)
    if label in EXPECTED:
        assert (nwg, plan.stages, plan.swizzle, plan.grid) == EXPECTED[label]


def test_fwd_plans_weigh_both_warpgroup_counts():
    """`fwd_plans` lists the chosen plan first, then the other number of
    consumer warpgroups at the same shape (bf16), and in float32 the
    other key tile where two stages of it fit."""
    for Sq, first in ((448, 1), (2048, 2)):
        plans = fwd_plans(1, 32, 4, Sq, Sq, 128, True, 2, SMS)
        assert [p.consumers for p in plans] == [first, 3 - first]
        assert plans[0] == fwd_plan(1, 32, 4, Sq, Sq, 128, True, 2, SMS)
        assert plans[1].grid == (32, -(-Sq // plans[1].rows))
    assert [p.keys for p in fwd_plans(4, 8, 8, 128, 128, 64, True, 4,
                                      SMS)] == [32, 64]
    assert [p.keys for p in fwd_plans(2, 4, 4, 100, 100, 96, True, 4,
                                      SMS)] == [32]


def _source(name):
    return (pathlib.Path(_build.CSRC) / name).read_text()


def test_source_runs_the_wgmma_kernel_for_every_bf16_head_dim():
    """The bf16 branch of every dispatched head dim launches
    flash_kernel_wgmma with one or two consumer warpgroups by the plan's
    rows; the Ampere kernel is gone; the tiles' constants are the plan's;
    sm90.cuh has a wgmma form for every N the kernel issues."""
    text = _source("flash_attention.cu")
    assert "flash_kernel_mma" not in text and "mma_bf16" not in text
    body = re.search(r"int dispatch_flash\(.*?\n}", text, re.S).group(0)
    dims = tuple(int(d) for d in re.findall(r"case (\d+): return "
                                            r"launch_flash<T, \1>", body))
    assert dims == HEAD_DIMS
    launch = re.search(r"int launch_flash\(.*?\n}", text, re.S).group(0)
    bf16 = launch[:launch.index("} else {")]
    assert "std::is_same_v<T, bf16>" in bf16
    for nwg, rows in FWD_ROWS.items():
        assert re.search(rf"rows == {rows}\) {{\s*return launch_flash_wgmma"
                         rf"<D, {nwg}>", bf16)
    assert "flash_kernel_wgmma<D, NWG><<<" in text
    tiles = re.search(r"struct FwdTiles \{.*?\n\};", text, re.S).group(0)
    assert "kRows = 64 * NWG;" in tiles
    assert (f"kKeys = NWG == 2 ? {FWD_KEYS[2]} : {FWD_KEYS[1]};") in tiles
    assert (f"kBudget = NWG == 2 ? {FWD_BUDGET[2]} : {FWD_BUDGET[1]};") \
        in tiles
    assert f"kProducerRegs = {FWD_REGS[2][0]};" in tiles
    assert FWD_REGS[1][0] == FWD_REGS[2][0]
    assert (f"kConsumerRegs = NWG == 2 ? {FWD_REGS[2][1]} : "
            f"{FWD_REGS[1][1]};") in tiles
    assert (f"(NWG == 2 ? {FWD_LAUNCH_REGS[2]} * 384 : "
            f"{FWD_LAUNCH_REGS[1]} * 256)") in tiles
    assert "kStages = kFit < 4 ? kFit : 4;" in tiles
    hdr = _source("sm90.cuh")
    forms = {int(n) for n in re.findall(r"^REPRO_WGMMA\((\d+),", hdr, re.M)}
    assert set(HEAD_DIMS) | set(FWD_KEYS.values()) <= forms
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor.3d",
                "mbarrier.try_wait.parity", "setmaxnreg.inc",
                "setmaxnreg.dec", "fence.proxy.async", "wgmma.fence",
                "wgmma.commit_group", "wgmma.wait_group"):
        assert ptx in hdr


def test_check_aligned_refuses_an_offset_view():
    """Both flash wrappers refuse an operand that does not start on a
    16-byte boundary (TMA takes no other base address)."""
    base = torch.zeros(64, dtype=torch.bfloat16)
    _build.check_aligned("flash_attention", base, base[8:])
    for off in (1, 2, 4, 7):
        with pytest.raises(ValueError, match="16-byte"):
            _build.check_aligned("flash_attention", base, base[off:])
    src = (ROOT / "src/repro_torch/kernels/flash_attention.py").read_text()
    assert src.count("_build.check_aligned(") == 2
