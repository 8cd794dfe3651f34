"""The plain flash backward of the port against `repro`'s, on the CPU.

`ref.attention_fwd`'s log-sum-exp is held against the residual of
`repro.kernels.xla_flash`'s blocked forward, and `ref.attention_bwd`
(given that forward's output and log-sum-exp) against `jax.vjp` of
`flash_attention_xla` at small blocks (its own flash backward,
`_flash_bwd_impl`) and of `repro.kernels.ops.attention(use_pallas=True)`
(the Pallas forward in interpret mode, the reference recomputed in the
backward): G = 1, 2 and 4; causal, windowed and full; head dims 16 and
32; ragged lengths.  Float32, tolerance 1e-5.  The CUDA kernel is held
against `ref.attention_bwd` on the card (`chip_smoke.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.xla_flash import _flash_fwd_impl, flash_attention_xla
from repro_torch.kernels import ops, ref

TOL = 1e-5
# (B, H, KV, S, D, causal, window); S = 40, 77 and 100 are ragged against
# every block of 16 (the blocked forward then takes one block of S)
CASES = [
    (2, 4, 4, 32, 16, True, 0),     # G = 1
    (2, 4, 2, 48, 32, True, 0),     # G = 2
    (1, 8, 2, 64, 16, True, 0),     # G = 4
    (2, 4, 2, 64, 32, True, 8),     # windowed
    (1, 4, 1, 48, 16, True, 24),    # windowed, G = 4
    (2, 4, 2, 32, 32, False, 0),    # full
    (1, 4, 4, 77, 16, True, 0),     # ragged
    (2, 4, 1, 100, 32, True, 16),   # ragged, windowed, G = 4
    (1, 2, 2, 40, 32, False, 0),    # ragged, full
]


def _block(S):
    return 16 if S % 16 == 0 else S


def _inputs(case, seed):
    B, H, KV, S, D, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D), (B, H, S, D))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_lse_matches_the_blocked_forward_residual(case):
    B, H, KV, S, D, causal, window = case
    q, k, v, _ = _inputs(case, 1)
    o, lse = ref.attention_fwd(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window)
    jo, jlse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal, window, D ** -0.5, _block(S), _block(S))
    _close(lse.numpy(), np.asarray(jlse).reshape(B, H, S))
    _close(o.numpy(), jo)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_repro_vjps(case):
    B, H, KV, S, D, causal, window = case
    q, k, v, do = _inputs(case, 2)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.attention_fwd(tq, tk, tv, causal=causal, window=window)
    got = ref.attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                            window=window)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    blk = _block(S)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_xla(
        a, b, c, causal, window, blk, blk), *args)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        _close(g.numpy(), w)
    _, vjp = jax.vjp(lambda a, b, c: jax_ops.attention(
        a, b, c, causal=causal, window=window, use_pallas=True), *args)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        _close(g.numpy(), w)


@pytest.mark.parametrize("case", CASES[:4])
def test_autograd_function_is_the_flash_backward(case):
    """`ops.attention` with gradients on: its backward equals
    `ref.attention_bwd` and autograd through the plain `ref.attention`."""
    _, _, _, _, _, causal, window = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, 3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.attention(*leaves, causal=causal, window=window).backward(do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref.attention(*plain, causal=causal, window=window).backward(do)
    o, lse = ref.attention_fwd(q, k, v, causal=causal, window=window)
    want = ref.attention_bwd(q, k, v, o, lse, do, causal=causal,
                             window=window)
    for a, b, c in zip(leaves, plain, want):
        torch.testing.assert_close(a.grad, c, rtol=0, atol=0)
        torch.testing.assert_close(a.grad, b.grad, rtol=TOL, atol=TOL)


def test_no_gradient_no_lse():
    """Without gradients to take (serving), `ops.attention` runs the
    forward alone: the result carries no autograd node."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(CASES[0], 4))
    with torch.no_grad():
        out = ops.attention(q.requires_grad_(True), k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, ref.attention(q.detach(), k, v))
