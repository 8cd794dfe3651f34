"""The bf16 SSD kernel's algorithm on the CPU: `ref.ssd_scan_tiled`.

`csrc/ssd_scan.cu` runs its bf16 products on the tensor cores: M and the
entering state are rounded to bf16, and the state update takes w o x as
bf16 hi + lo parts.  `ref.ssd_scan_tiled` computes the scan chunk by chunk
as the kernel does, with that rounding optional.  Unrounded, it agrees
with `repro`'s Pallas SSD kernel in interpret mode (1e-3) and with its
sequential oracle from an initial state at ragged lengths (2e-3).
Rounded, at both serving widths (Mamba2-1.3B: 64 heads, P 64, N 128;
Zamba2-2.7B: 80 heads, P 64, N 64; chunk 256) and on `chip_smoke.py`'s
inputs, it stays within the card's tolerances of the unrounded version:
2e-2 on y and 2e-3 on the final state (atol + rtol), which shows the
precision choice before the card is asked.  Rounding w o x once instead
of splitting it would miss the state's tolerance.  The wrapper's rule for
the number of chunk runs is checked here too (shapes only, no card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as smod

BF16_TOL, SSD_STATE_TOL = 2e-2, 2e-3   # chip_smoke.py's
SERVING = {"mamba2-1.3b": (64, 64, 128), "zamba2-2.7b": (80, 64, 64)}


def _inputs(B, S, Hn, P, N, seed, state=False):
    """As `tests/test_torch_ssd.py` draws them: dt through softplus, A < 0."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, Hn, P)) * 0.5,
            np.logaddexp(rng.standard_normal((B, S, Hn)), 0.0),
            -np.exp(rng.standard_normal(Hn) * 0.3),
            rng.standard_normal((B, S, N)) * 0.5,
            rng.standard_normal((B, S, N)) * 0.5]
    if state:
        arrs.append(rng.standard_normal((B, Hn, P, N)) * 0.2)
    return [a.astype(np.float32) for a in arrs]


def _serving_inputs(S, Hn, P, N, seed, state):
    """`chip_smoke._ssd_inputs` drawn with numpy: x, B, C bf16 at scale
    0.5, dt = softplus of a unit normal, A = -linspace(1, 16)."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    x = torch.from_numpy(0.5 * rng.standard_normal((1, S, Hn, P))).to(bf)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((1, S, Hn)).astype(np.float32)))
    A = -torch.linspace(1.0, 16.0, Hn)
    Bm = torch.from_numpy(0.5 * rng.standard_normal((1, S, N))).to(bf)
    Cm = torch.from_numpy(0.5 * rng.standard_normal((1, S, N))).to(bf)
    h0 = (torch.from_numpy(0.2 * rng.standard_normal((1, Hn, P, N)))
          .float() if state else None)
    return x, dt, A, Bm, Cm, h0


def _within(out, want, tol):
    """max |out - want| / (tol + tol |want|): at most 1 is within tol."""
    d = (out.float() - want.float()).abs()
    return float((d / (tol + tol * want.float().abs())).max())


@pytest.mark.parametrize("B,S,Hn,P,N,chunk", [
    (2, 256, 4, 64, 64, 64), (1, 128, 2, 32, 16, 32), (2, 128, 3, 16, 8, 64),
])
def test_tiled_matches_pallas_ssd(B, S, Hn, P, N, chunk):
    arrs = _inputs(B, S, Hn, P, N, seed=S + Hn)
    exp = pallas_ssd(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                     interpret=True)
    out = ref.ssd_scan_tiled(*(torch.from_numpy(a) for a in arrs),
                             chunk=chunk)
    assert out.shape == (B, S, Hn, P) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("S,chunk", [(100, 32), (7, 256), (1, 4)])
def test_tiled_with_state_matches_sequential(S, chunk):
    B, Hn, P, N = 2, 4, 32, 16
    *ins, h0 = _inputs(B, S, Hn, P, N, seed=S, state=True)
    y_exp, s_exp = jref.ssd_scan(*(jnp.asarray(a) for a in ins),
                                 init_state=jnp.asarray(h0),
                                 return_state=True)
    y, s = ref.ssd_scan_tiled(*(torch.from_numpy(a) for a in ins),
                              chunk=chunk, init_state=torch.from_numpy(h0),
                              return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_exp), atol=2e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_exp), atol=2e-3)


@pytest.mark.parametrize("arch", sorted(SERVING))
@pytest.mark.parametrize("S,state", [(448, False), (448, True), (7, True),
                                     (1, True)])
def test_rounded_tiled_within_chip_tolerances(arch, S, state):
    """The kernel's rounding at the serving widths: y within BF16_TOL and
    the final state within SSD_STATE_TOL of the unrounded float32 scan, as
    `chip_smoke.check_ssd_scan` holds the kernel."""
    Hn, P, N = SERVING[arch]
    x, dt, A, Bm, Cm, h0 = _serving_inputs(S, Hn, P, N, seed=S + Hn, state=state)
    y, s = ref.ssd_scan_tiled(x, dt, A, Bm, Cm, chunk=256, init_state=h0,
                              return_state=True, rounded=True)
    yw, sw = ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=256, init_state=h0,
                                  return_state=True)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all())
    assert _within(y, yw, BF16_TOL) <= 1.0
    assert _within(s, sw, SSD_STATE_TOL) <= 1.0


def test_single_bf16_update_would_miss_the_state_tolerance():
    """Why the update splits w o x into hi + lo: one chunk's update with
    w o x rounded once to bf16 misses SSD_STATE_TOL at Mamba2's widths."""
    Hn, P, N = SERVING["mamba2-1.3b"]
    x, dt, A, Bm, Cm, _ = _serving_inputs(256, Hn, P, N, seed=3, state=False)
    L = torch.cumsum(A * dt, dim=1)
    v = (torch.exp(L[:, -1:] - L) * dt)[..., None] * x.float()
    exact = torch.einsum("bshp,bsn->bhpn", v, Bm.float())
    once = torch.einsum("bshp,bsn->bhpn", v.to(torch.bfloat16).float(),
                        Bm.float())
    _, split = ref.ssd_scan_tiled(x, dt, A, Bm, Cm, chunk=256,
                                  return_state=True, rounded=True)
    assert _within(once, exact, SSD_STATE_TOL) > 1.0
    assert _within(split, exact, SSD_STATE_TOL) <= 1.0


def test_tiled_ragged_chunks_equal_one_chunk():
    """Chunks of 16 over a ragged S give the state of one whole chunk."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _inputs(1, 45, 2, 8, 8, seed=9))
    y1, s1 = ref.ssd_scan_tiled(x, dt, A, Bm, Cm, chunk=16, return_state=True)
    y2, s2 = ref.ssd_scan_tiled(x, dt, A, Bm, Cm, chunk=64, return_state=True)
    torch.testing.assert_close(y1, y2, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(s1, s2, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("Hn,sms,want", [
    (64, 132, 2), (80, 132, 1), (64, 64, 1), (16, 132, 2),
])
def test_scan_plan_takes_the_most_blocks_within_a_wave(Hn, sms, want):
    runs = smod.scan_runs(1, Hn, 64, 2, sms)
    assert runs == want
    assert smod.blocks(1, Hn, 64, runs) <= max(sms, Hn)


def test_plans_list_every_slice_and_run_the_kernel_takes():
    """One block per 64 head channels and chunk run; one run a chunk at
    most, and one when a single block already fills the wave."""
    assert smod.blocks(1, 64, 64, 2) == 128
    assert smod.blocks(2, 3, 130, 1) == 18
    assert smod.scan_runs(1, 8, 16, 1, 132) == 1
    assert smod.scan_runs(1, 3, 20, 4, 132) == 4
    assert smod.scan_runs(1, 200, 64, 4, 132) == 1
