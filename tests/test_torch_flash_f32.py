"""The float32 flash forward (`csrc/flash_attention.cu`'s
`flash_kernel_tf32`) on the CPU: its TF32 split, its order of work as an
algorithm, its launch plan and its source.

The kernel feeds the tensor cores every float32 operand x as hi = tf32(x)
and lo = tf32(x - hi) and sums lo.hi + hi.lo + hi.hi; `ref.tf32` is its
rounding bit for bit (the low 13 mantissa bits rounded away, ties away
from zero), and `ref.attention_fwd_tiled` multiplies as the kernel does.
The same numpy inputs go through `repro`'s Pallas `flash_attention` in
interpret mode and `repro`'s blocked forward (`xla_flash._flash_fwd_impl`,
whose residual is the log-sum-exp the flash backward reads): the split
version holds both within the float32 tolerance of 2e-5 at every head
dim, causal, windowed and non-causal, GQA and ragged Sq != Sk, and one
TF32 product (hi.hi alone) misses it.  The card holds the kernel against
the same plain version (`chip_smoke.py`).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.xla_flash import _flash_fwd_impl
from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (FWD_F32_BUDGET, FWD_F32_KEYS,
                                                 FWD_F32_ROWS, HEAD_DIMS,
                                                 fwd_f32_keys, fwd_f32_tiles,
                                                 fwd_plan, fwd_plans)

TOL = 2e-5  # chip_smoke.F32_TOL, tests/test_torch_kernels.py's float32
SMS = 132
# (B, H, KV, Sq, Sk, causal, window) at every head dim: causal G = 1 on
# whole tiles; windowed, G = 4, ragged; non-causal, G = 2, Sq < Sk, ragged;
# causal, G = 4, Sq > Sk (every row sees a key)
CASES = [
    (1, 4, 4, 128, 128, True, 0),
    (1, 8, 2, 100, 100, True, 24),
    (2, 4, 2, 37, 150, False, 0),
    (1, 4, 1, 130, 96, True, 0),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which parallel test workers
    sharing the cores do not make wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(case, D):
    """(q, k, v) float32 numpy arrays from a seeded draw."""
    B, H, KV, Sq, Sk, _, _ = case
    rng = np.random.default_rng(Sq * 1000 + Sk + H + D)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, KV, Sk, D), (B, KV, Sk, D))]


def _block(S):
    return 64 if S % 64 == 0 else S


def _repro(case, q, k, v):
    """`repro`'s Pallas output and its blocked forward's log-sum-exp."""
    B, H, _, Sq, Sk, causal, window = case
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o = pallas_flash(jq, jk, jv, causal=causal, window=window,
                     block_q=_block(Sq), block_k=_block(Sk), interpret=True)
    _, lse = _flash_fwd_impl(jq, jk, jv, causal, window, q.shape[-1] ** -0.5,
                             _block(Sq), _block(Sk))
    return np.asarray(o), np.asarray(lse).reshape(B, H, Sq)


def _ratio(got, want):
    """The worst |got - want| / (TOL (1 + |want|)): at most 1 within TOL."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (TOL * (1 + np.abs(want)))).max())


# ----------------------------------------------------------------------
# the TF32 split
# ----------------------------------------------------------------------
def _spread(n, seed=0):
    """float32 values over many binades, both signs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    return x.astype(np.float32)


def _tf32_np(x):
    """tf32(x) for normal float32 x by arithmetic, not bits: |x| rounded
    to 11 significant bits, halves away from zero (float64 is exact)."""
    x = x.astype(np.float64)
    _, e = np.frexp(np.abs(x))            # |x| = m 2^e, m in [0.5, 1)
    step = np.exp2(e - 11)
    return (np.sign(x) * np.floor(np.abs(x) / step + 0.5) * step).astype(
        np.float32)


def test_tf32_clears_the_low_13_bits_and_rounds_to_nearest():
    x = _spread(20000)
    hi, lo = ref.tf32_split(torch.from_numpy(x))
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    np.testing.assert_array_equal(hi.numpy(), _tf32_np(x))
    nz = lo.numpy() != 0
    np.testing.assert_array_equal(lo.numpy()[nz],
                                  _tf32_np((x - hi.numpy())[nz]))


def test_tf32_split_reconstructs_within_2_to_the_minus_21():
    x = _spread(20000, seed=1)
    hi, lo = ref.tf32_split(torch.from_numpy(x))
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - x)
    assert float((err / np.abs(x.astype(np.float64))).max()) <= 2.0 ** -21
    # hi alone keeps 11 bits: its error reaches 2^-12 of |x|
    assert float((np.abs(hi.numpy() - x.astype(np.float64)) /
                  np.abs(x)).max()) > 2.0 ** -13


@pytest.mark.parametrize("sign", [1, -1])
def test_tf32_ties_round_away_from_zero(sign):
    """Low bits 0x1000 (a tie) round the magnitude up, 0x0fff down, 0x1001
    up, the same for negatives; a carry moves into the exponent."""
    base = np.array([0x3F800000, 0x3F802000, 0x40490000, 0x3F7FE000],
                    np.uint32)  # 1, 1 + 2^-10, ~3.14, just under 1
    low = np.array([0x1000, 0x0FFF, 0x1001], np.uint32)
    bits = (base[:, None] | low[None, :]).reshape(-1)
    if sign < 0:
        bits = bits | np.uint32(0x80000000)
    x = torch.from_numpy(bits.view(np.float32).copy())
    got = ref.tf32(x).numpy().view(np.uint32).reshape(4, 3)
    up = (base + np.uint32(0x2000)) | np.uint32(0x80000000 if sign < 0
                                                else 0)
    down = base | np.uint32(0x80000000 if sign < 0 else 0)
    np.testing.assert_array_equal(got[:, 0], up)    # tie: away from zero
    np.testing.assert_array_equal(got[:, 1], down)
    np.testing.assert_array_equal(got[:, 2], up)
    assert got[3, 0] & 0x7FFFFFFF == 0x3F800000      # 1 - 2^-11 + tie -> 1


# ----------------------------------------------------------------------
# the algorithm against repro
# ----------------------------------------------------------------------
def _params():
    out = []
    for D in HEAD_DIMS:
        for keys in fwd_f32_keys(D):
            for case in CASES:
                out.append(pytest.param(case, D, keys,
                                        id=f"D{D}-keys{keys}-{case}"))
    return out


_REPRO = {}


@pytest.mark.parametrize("case,D,keys", _params())
def test_split_forward_matches_repro_at_2e5(case, D, keys):
    q, k, v = _inputs(case, D)
    if (case, D) not in _REPRO:
        _REPRO[(case, D)] = _repro(case, q, k, v)
    want_o, want_lse = _REPRO[(case, D)]
    _, _, _, _, _, causal, window = case
    o, lse = ref.attention_fwd_tiled(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, window=window, keys=keys)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert _ratio(o.numpy(), want_o) <= 1.0
    assert _ratio(lse.numpy(), want_lse) <= 1.0
    full_o, full_lse = ref.attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                         causal=causal, window=window)
    assert _ratio(o.numpy(), full_o.numpy()) <= 1.0
    assert _ratio(lse.numpy(), full_lse.numpy()) <= 1.0


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_one_tf32_product_misses_2e5(D):
    """hi.hi alone (11 bits of each operand) misses the tolerance that the
    three products hold, on the same inputs: the tolerance tells them
    apart."""
    case = CASES[1]
    q, k, v = map(torch.from_numpy, _inputs(case, D))
    want, _ = ref.attention_fwd(q, k, v, causal=True, window=case[6])
    three, _ = ref.attention_fwd_tiled(q, k, v, causal=True,
                                       window=case[6], keys=32)
    one, _ = ref.attention_fwd_tiled(q, k, v, causal=True, window=case[6],
                                     keys=32, products=1)
    assert _ratio(three.numpy(), want.numpy()) <= 1.0
    assert _ratio(one.numpy(), want.numpy()) > 1.0
    with pytest.raises(ValueError):
        ref.attention_fwd_tiled(q, k, v, keys=32, products=2)


# ----------------------------------------------------------------------
# the plan and the source
# ----------------------------------------------------------------------
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_f32_plan_fits_and_matches_the_kernel(D):
    """Every compiled key tile holds two stages or more within the block's
    232,448 bytes; the bytes are the kernel's (Q's hi and lo, five tiles a
    stage, 1024 to align, 128 for the barriers); 64-key tiles only where
    two stages fit (D <= 64)."""
    keys = fwd_f32_keys(D)
    assert 32 in keys and (64 in keys) == (D <= 64)
    for n in FWD_F32_KEYS:
        atom, stages, smem = fwd_f32_tiles(D, n)
        assert atom == (32 if D % 32 == 0 else 16) and D % atom == 0
        assert stages == min(4, (FWD_F32_BUDGET - 1152 - 512 * D) //
                             (20 * n * D))
        assert smem == 1024 + 512 * D + stages * 20 * n * D + 128
        if n in keys:
            assert 2 <= stages <= 4 and smem <= FWD_F32_BUDGET == 232448


# the float32 forwards chip_smoke.py times: (B, H, Sq, Sk, D) -> the key
# tile the rule picks
TIMED = {
    (4, 8, 128, 128, 64): 32,   # train-100m's microbatch
    (16, 2, 32, 32, 16): 32,    # zoo-s training
    (16, 4, 32, 32, 16): 32,    # zoo-m training
    (16, 4, 32, 32, 32): 32,    # zoo-l training
    (1, 2, 16, 16, 16): 32,     # zoo-s serving prefill
    (1, 4, 16, 16, 16): 32,     # zoo-m
    (1, 4, 16, 16, 32): 32,     # zoo-l
    (2, 4, 100, 100, 96): 32,   # MLA's head dim
}


@pytest.mark.parametrize("shape", sorted(TIMED), ids=str)
def test_f32_plan_at_every_timed_shape(shape):
    B, H, Sq, Sk, D = shape
    plans = fwd_plans(B, H, H, Sq, Sk, D, True, 4, SMS)
    assert plans[0] == fwd_plan(B, H, H, Sq, Sk, D, True, 4, SMS)
    assert plans[0].keys == TIMED[shape]
    assert sorted(p.keys for p in plans) == list(fwd_f32_keys(D))
    for p in plans:
        assert p.kernel == "flash_kernel_tf32" and p.rows == FWD_F32_ROWS
        assert p.consumers == 1 and p.regs == 0
        assert p.grid == (B * H, -(-Sq // 64))
        assert (p.stages, p.smem) == fwd_f32_tiles(D, p.keys)[1:]
        assert p.swizzle == 4 * fwd_f32_tiles(D, p.keys)[0]


def _source(name):
    return (pathlib.Path(_build.CSRC) / name).read_text()


def test_source_runs_the_tf32_kernel_for_every_f32_head_dim():
    """The float32 branch of every dispatched head dim launches
    flash_kernel_tf32 with 32-key tiles, and 64 where two stages fit; the
    CUDA-core kernel and its tile header are gone; the kernel's rounding,
    stage count and shared bytes are the plan's; sm90.cuh has a .tf32
    wgmma form for every N the kernel issues."""
    text = _source("flash_attention.cu")
    assert not (pathlib.Path(_build.CSRC) / "attention_tile.cuh").exists()
    assert "attention_tile" not in text and "flash_kernel<" not in text
    body = re.search(r"int dispatch_flash\(.*?\n}", text, re.S).group(0)
    dims = tuple(int(d) for d in re.findall(r"case (\d+): return "
                                            r"launch_flash<T, \1>", body))
    assert dims == HEAD_DIMS
    launch = re.search(r"int launch_flash\(.*?\n}", text, re.S).group(0)
    f32 = launch[launch.index("} else {"):]
    assert "if (rows != 64) return kStatusBadArgs;" in f32
    assert re.search(r"keys == 32\) \{\s*return launch_flash_tf32<D, 32>",
                     f32)
    assert re.search(r"if constexpr \(tf32_stages\(D, 64\) >= 2\) \{\s*"
                     r"if \(keys == 64\) \{\s*return launch_flash_tf32<D, "
                     r"64>", f32)
    assert "flash_kernel_tf32<D, BK><<<" in text
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in text
    assert ("fit = (232448 - 1024 - 128 - 2 * 64 * D * 4) / "
            "(5 * BK * D * 4);") in text
    tiles = re.search(r"struct Tf32Tiles \{.*?\n\};", text, re.S).group(0)
    assert "kRows = 64;" in tiles and "kAtom = D % 32 == 0 ? 32 : 16;" in tiles
    assert ("kSmem = 1024 + 2 * kQBytes + kStages * 5 * kTile * 4 + 128;"
            in tiles)
    hdr = _source("sm90.cuh")
    forms = {int(n) for n in re.findall(r"^REPRO_WGMMA_TF32\((\d+),", hdr,
                                        re.M)}
    assert set(HEAD_DIMS) | set(FWD_F32_KEYS) <= forms
    assert "k8.f32.tf32.tf32" in hdr
