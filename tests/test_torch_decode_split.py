"""The split-K decode attention of `csrc/decode_attention.cu`, as an
algorithm, against `repro`'s Pallas decode kernel.

`ref.decode_attention_split` computes decode attention the way the CUDA
kernel does: per span of ``split`` cache slots a partial (m, l, acc), empty
spans included, merged by log-sum-exp weights.  The same numpy inputs go
through `repro`'s Pallas `decode_attention` in interpret mode, at the
tolerances of tests/test_kernels.py (2e-5 float32, 2e-2 bfloat16).  The
lengths 1, 96 and 128 of one batch put the end of the valid slots at a
span boundary of every split (96 = 6 x 16 = 3 x 32 = 2 x 48) and at the
end of the cache (128, which 48 does not divide), so most sequences have
empty spans.  The wrapper's launch plan is checked against the card's
grid without a card.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (HEAD_CHUNK, MAX_SPLITS,
                                                  column_slices, split_plan)

KV, S, D = 2, 128, 32
LENS = (1, 96, 128)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@functools.lru_cache(maxsize=None)
def _case(G, window, dtype):
    """(q, k, v, lens) as CPU tensors of ``dtype`` and the Pallas result,
    from one numpy draw per (G, window, dtype)."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(G * 1000 + window)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((len(LENS), G * KV, D), (len(LENS), KV, S, D),
                          (len(LENS), KV, S, D))]
    jarrs = [jnp.asarray(a, jdt) for a in arrs]
    lens = np.array(LENS, np.int32)
    exp = pallas_decode(*jarrs, jnp.asarray(lens), window=window,
                        block_k=64, interpret=True)
    tarrs = [torch.from_numpy(np.array(j, np.float32)).to(tdt) for j in jarrs]
    return (*tarrs, torch.from_numpy(lens)), np.asarray(exp, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G", [1, 8, 32])
@pytest.mark.parametrize("window", [0, 48, 1000])
@pytest.mark.parametrize("split", [16, 32, 48])
def test_split_decode_matches_pallas_decode(split, window, G, dtype):
    (q, k, v, lens), exp = _case(G, window, dtype)
    out = ref.decode_attention_split(q, k, v, lens, window=window,
                                     split=split)
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(), exp, atol=tol, rtol=tol)


@pytest.mark.parametrize("split", [16, 32, 48])
def test_one_full_span_equals_the_unsplit_plain_version(split):
    """Lengths inside the first span: every other span is empty and must
    merge with weight exactly 0, so the split result is the unsplit one."""
    rng = np.random.default_rng(split)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((3, 8 * KV, D), (3, KV, S, D), (3, KV, S, D)))
    lens = torch.tensor([1, split // 2, split], dtype=torch.int32)
    for window in (0, 5):
        out = ref.decode_attention_split(q, k, v, lens, window=window,
                                         split=split)
        want = ref.decode_attention(q, k, v, lens, window=window)
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_no_valid_slot_gives_zero():
    q = torch.ones(2, 4, D)
    k = torch.ones(2, 2, S, D)
    out = ref.decode_attention_split(q, k, k, torch.tensor([0, 0]),
                                     split=16)
    assert torch.equal(out, torch.zeros_like(q))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("KV_,G,D_", [(4, 8, 128), (32, 1, 80)])
def test_split_plan_takes_most_slices_within_a_wave(KV_, G, D_, itemsize):
    """The serving shapes (Yi-9B: kv 4, G 8, D 128; Zamba2: kv 32, G 1,
    D 80; cache 512), bf16 and float32: spans of one staged tile, and the
    most column slices whose batch-1 grid stays within one wave of the
    H100's 132 SMs (one slice where even that passes a wave)."""
    p = split_plan(1, KV_, G, 512, D_, 132, itemsize=itemsize)
    assert p.span == 128 // itemsize
    blocks = p.splits * KV_ * -(-G // p.hc)
    more = [c for c in column_slices(D_, itemsize) if c > p.slices]
    assert blocks * p.slices <= 132 or p.slices == 1
    assert not more or blocks * more[0] > 132
    _check_plan(p, G, 512, D_, itemsize)


@pytest.mark.parametrize("B,KV_,G,S_,D_", [
    (1, 1, 1, 1, 32), (1, 1, 100, 7, 64), (64, 8, 4, 4096, 128),
    (3, 2, 33, 1000, 80), (1, 1, 32, 512, 128), (1, 4, 8, 4096, 128)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_split_plan_stays_in_kernel_limits(B, KV_, G, S_, D_, itemsize):
    _check_plan(split_plan(B, KV_, G, S_, D_, 132, itemsize=itemsize), G,
                S_, D_, itemsize)


def _check_plan(p, G, S_, D_, itemsize):
    """At most MAX_SPLITS spans covering the cache, head chunks of at most
    HEAD_CHUNK heads that cover G with none empty, and column slices of
    whole 16-byte copies (the launcher refuses anything else)."""
    assert 1 <= p.splits <= MAX_SPLITS
    assert p.span * p.splits >= S_ > p.span * (p.splits - 1)
    assert 1 <= p.hc <= HEAD_CHUNK and (-(-G // p.hc) - 1) * p.hc < G
    assert D_ % p.slices == 0 and (D_ // p.slices) % (16 // itemsize) == 0
