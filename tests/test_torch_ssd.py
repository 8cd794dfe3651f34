"""The port's SSD scan against `repro`'s.

On the CPU `kernels.ops.ssd_scan` runs the plain chunked version
(`ref.ssd_scan_chunked`), the plain version of `csrc/ssd_scan.cu`.  The
same numpy inputs go through `repro`'s Pallas kernel in interpret mode
(atol/rtol 1e-3, the tolerance of `test_pallas_ssd_sweep`) and through its
sequential oracle with an initial and a final state at a ragged length
(2e-3, as `test_xla_ssd_matches_sequential_with_state`); the one-token
decode step agrees with `repro`'s to 1e-6.  The kernel's wrapper refuses
CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan as cuda_ssd


def _inputs(B, S, Hn, P, N, seed, state=False):
    """x, dt, A, B, C (and an initial state) as float32 numpy arrays, drawn
    as `tests/test_kernels.py` draws them: dt through softplus, A < 0."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, Hn, P)) * 0.5,
            np.logaddexp(rng.standard_normal((B, S, Hn)), 0.0),
            -np.exp(rng.standard_normal(Hn) * 0.3),
            rng.standard_normal((B, S, N)) * 0.5,
            rng.standard_normal((B, S, N)) * 0.5]
    if state:
        arrs.append(rng.standard_normal((B, Hn, P, N)) * 0.2)
    return [a.astype(np.float32) for a in arrs]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("B,S,Hn,P,N,chunk", [
    (2, 256, 4, 64, 64, 64), (1, 128, 2, 32, 16, 32), (2, 128, 3, 16, 8, 64),
])
def test_chunked_plain_matches_pallas_ssd(B, S, Hn, P, N, chunk):
    arrs = _inputs(B, S, Hn, P, N, seed=S + Hn)
    exp = pallas_ssd(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                     interpret=True)
    out = ops.ssd_scan(*_torch(arrs), chunk=chunk)
    assert out.shape == (B, S, Hn, P) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("S,chunk", [(100, 32), (64, 32), (7, 256)])
def test_chunked_plain_with_state_matches_sequential(S, chunk):
    """Ragged S (100 = 3 x 32 + 4) and S < chunk: y and the final state
    from an initial state, against `repro`'s sequential oracle."""
    B, Hn, P, N = 2, 4, 32, 16
    arrs = _inputs(B, S, Hn, P, N, seed=S, state=True)
    *ins, h0 = arrs
    y_exp, s_exp = jref.ssd_scan(*(jnp.asarray(a) for a in ins),
                                 init_state=jnp.asarray(h0),
                                 return_state=True)
    y, s = ops.ssd_scan(*_torch(ins), chunk=chunk,
                        init_state=torch.from_numpy(h0), return_state=True)
    assert s.shape == (B, Hn, P, N) and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_exp), atol=2e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_exp), atol=2e-3)


def test_port_sequential_oracle_matches_repro():
    """The port's own sequential `ref.ssd_scan` is `repro`'s, to 1e-5."""
    arrs = _inputs(1, 50, 3, 8, 8, seed=5, state=True)
    *ins, h0 = arrs
    y_exp, s_exp = jref.ssd_scan(*(jnp.asarray(a) for a in ins),
                                 init_state=jnp.asarray(h0),
                                 return_state=True)
    y, s = ref.ssd_scan(*_torch(ins), init_state=torch.from_numpy(h0),
                        return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_exp), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_exp), atol=1e-5)


def test_ragged_tail_leaves_the_state_of_the_last_step():
    """Padding the last chunk with dt = 0 steps changes nothing: the state
    after S steps in chunks of 32 equals the state of one whole chunk."""
    x, dt, A, Bm, Cm = _torch(_inputs(1, 45, 2, 8, 8, seed=9))
    y1, s1 = ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=32,
                                  return_state=True)
    y2, s2 = ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=64,
                                  return_state=True)
    torch.testing.assert_close(y1, y2, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(s1, s2, atol=2e-5, rtol=2e-5)


def test_chunked_plain_survives_deep_log_decay():
    """With A in [-16, -1] (Mamba's ``-exp(A_log)``) and large dt, L falls
    to the thousands inside a chunk; the decays are taken as exp of
    differences, so nothing is NaN and the sequential oracle agrees."""
    B, S, Hn, P, N = 1, 300, 4, 8, 8
    x, dt, _, Bm, Cm = _inputs(B, S, Hn, P, N, seed=11)
    dt = dt * 8.0
    A = -np.linspace(1.0, 16.0, Hn).astype(np.float32)
    y, s = ops.ssd_scan(*_torch([x, dt, A, Bm, Cm]), chunk=256,
                        return_state=True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    y_exp, s_exp = jref.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                                 return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_exp), atol=2e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_exp), atol=2e-3)


def test_decode_step_matches_repro():
    B, Hn, P, N = 3, 4, 16, 8
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, Hn, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, Hn)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(Hn) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, N)).astype(np.float32)
    Cm = rng.standard_normal((B, N)).astype(np.float32)
    st = rng.standard_normal((B, Hn, P, N)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, st)
    y_exp, s_exp = jref.ssd_decode_step(*(jnp.asarray(a) for a in args))
    y, s = ops.ssd_decode_step(*_torch(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_exp), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_exp), atol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, dt, A, Bm, Cm = _torch(_inputs(1, 8, 2, 8, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ssd(x, dt, A, Bm, Cm)
    assert _build._EXT is None and _build.LAUNCHES["ssd_scan"] == 0
    assert torch.equal(ops.ssd_scan(x, dt, A, Bm, Cm, chunk=4),
                       ref.ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=4))
