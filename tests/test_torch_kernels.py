"""The port's model kernels against `repro`'s Pallas kernels.

On the CPU `kernels.ops` runs each kernel's plain PyTorch version; here
those run on the same numpy inputs as `repro`'s Pallas kernels in
interpret mode, in float32 and bfloat16, at the tolerances of
tests/test_kernels.py (2e-2 for bfloat16, 2e-5 for float32); decode
attention also at H / KV = 32, which the split-K kernel takes like any
group size.  A CUDA tensor takes the kernel instead: the last tests pin that dispatch and its
refusals without a card.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rms_norm as pallas_rmsnorm
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.decode_attention import decode_attention as cuda_decode
from repro_torch.kernels.decode_attention import HEAD_DIMS as DECODE_HEAD_DIMS
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
from repro_torch.kernels.rmsnorm import rms_norm as cuda_rmsnorm

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a, dtype):
    """The same values as a jax array and a CPU torch tensor of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    t = torch.from_numpy(np.array(j, np.float32)).to(tdt)
    return j, t


def _close(t, j, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,KV,S,D", [(1, 4, 4, 128, 32), (2, 8, 2, 128, 64),
                                        (1, 4, 1, 64, 128), (1, 4, 4, 128, 80)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32)])
def test_attention_matches_pallas_flash(B, H, KV, S, D, dtype, causal, window):
    rng = np.random.default_rng(S + D)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape, np.float32), dtype)
        for shape in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D)))
    exp = pallas_flash(qj, kj, vj, causal=causal, window=window, block_q=64,
                       block_k=64, interpret=True)
    out = ops.attention(qt, kt, vt, causal=causal, window=window)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, exp, dtype)


@pytest.mark.parametrize("B,H,KV,S,D", [(2, 8, 2, 256, 64), (3, 4, 4, 128, 32),
                                        (2, 8, 1, 128, 128), (2, 4, 4, 128, 80),
                                        (2, 32, 1, 128, 64)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [0, 48])
def test_decode_attention_matches_pallas_decode(B, H, KV, S, D, dtype, window):
    rng = np.random.default_rng(S + D + B)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape, np.float32), dtype)
        for shape in ((B, H, D), (B, KV, S, D), (B, KV, S, D)))
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    exp = pallas_decode(qj, kj, vj, jnp.asarray(lens), window=window,
                        block_k=64, interpret=True)
    out = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens),
                               window=window)
    _close(out, exp, dtype)


@pytest.mark.parametrize("rows,D", [(8, 64), (37, 256), (1, 4096)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rms_norm_matches_pallas_rmsnorm(rows, D, dtype):
    rng = np.random.default_rng(rows)
    xj, xt = _pair(rng.standard_normal((rows, D), np.float32) * 3, dtype)
    scale = rng.uniform(0.5, 1.5, D).astype(np.float32)
    exp = pallas_rmsnorm(xj, jnp.asarray(scale), interpret=True)
    out = ops.rms_norm(xt, torch.from_numpy(scale))
    assert out.dtype == xt.dtype
    _close(out, exp, dtype)


def test_bf16_inputs_agree_bitwise_between_frameworks():
    """bf16 -> float32 widening is exact in both frameworks, so the two
    sides of every comparison above start from identical values."""
    a = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    j, t = _pair(a, "bfloat16")
    np.testing.assert_array_equal(
        np.asarray(j).view(np.uint16),
        t.view(torch.int16).numpy().view(np.uint16))


def test_wrappers_refuse_cpu_tensors_and_never_build_here():
    """A kernel wrapper takes CUDA tensors only: a CPU tensor is an error
    raised before any build, so the plain version is reached only through
    `ops`, and only for tensors the caller put on the CPU."""
    q = torch.zeros(1, 4, 16, 32)
    k = torch.zeros(1, 4, 16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_decode(q[:, :, 0], k, k, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rmsnorm(q, torch.ones(32))
    assert _build._EXT is None
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_ops_reach_plain_versions_on_cpu():
    """On CPU tensors `ops` returns exactly the plain version's result."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 64), np.float32))
    s = torch.ones(64)
    assert torch.equal(ops.rms_norm(x, s), ref.rms_norm(x, s))


# each source's dispatch against its wrapper's list: the flash kernels
# take MLA's 96, decode attention does not (MLA decodes without a kernel)
SOURCE_HEAD_DIMS = {"flash_attention.cu": HEAD_DIMS,
                    "decode_attention.cu": DECODE_HEAD_DIMS,
                    "flash_attention_bwd.cu": HEAD_DIMS}


@pytest.mark.parametrize("source", list(SOURCE_HEAD_DIMS))
def test_attention_dispatch_lists_head_dims_and_refuses_others(source):
    """Every dispatch function of the C entry points instantiates exactly
    its wrapper's ``HEAD_DIMS`` (80 among them, for zamba2's shared
    attention), and an unlisted head dimension returns an error status
    (which the binding raises) instead of launching another instantiation.
    The entry point reaches a dispatch for both dtypes."""
    text = (pathlib.Path(_build.CSRC) / source).read_text()
    bodies = re.findall(r"int dispatch_\w+\(.*?\n}", text, re.S)
    assert bodies
    for body in bodies:
        pairs = re.findall(r"case (\d+): (?:return )?launch_\w+<T, (\d+)>",
                           body)
        assert all(case == dim for case, dim in pairs)
        assert tuple(int(case) for case, _ in pairs) == \
            SOURCE_HEAD_DIMS[source]
        assert "default: return kStatusBadHeadDim;" in body
    entry = text[text.index('extern "C"'):]
    assert re.search(r"dispatch_\w+<__nv_bfloat16>", entry)
    assert re.search(r"dispatch_\w+<float>", entry)
    assert 80 in SOURCE_HEAD_DIMS[source]
    assert (96 in SOURCE_HEAD_DIMS[source]) == (source != "decode_attention.cu")
