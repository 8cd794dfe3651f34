"""The port's SSM and hybrid models against `repro`'s, on carried weights.

`repro`'s `Model.init` draws the mamba2-1.3b and zamba2-2.7b SMOKE weights
(3 Mamba layers; 4 Mamba layers with the shared attention block after
every 2, window 64); `params_from_jax` carries them into the port on the
CPU.  In float32, with `repro` on its Pallas path (interpret mode), the
last-position prefill logits agree to 1e-4, eight greedy decode tokens
are identical, and so are the full-sequence hidden states.  The prompts
are ragged against the chunk of 32 (40 tokens), and for the hybrid also
longer than its window (80 tokens), so the windowed prefill and the
window-capped cache are exercised.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import Model as JaxModel
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import Model, SSMCache
from repro_torch.serving.engine import ServingEngine

TOL = 1e-4
N_DECODE = 8
ARCHS = ("mamba2-1.3b", "zamba2-2.7b")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = dataclasses.replace(jax_get_config(request.param, smoke=True),
                               dtype="float32", use_pallas=True)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(request.param, smoke=True),
                              dtype="float32")
    tm = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _prompt(vocab, B=2, S=40):
    return np.random.default_rng(S).integers(0, vocab, size=(B, S),
                                             dtype=np.int32)


def _cache_keys(tcache):
    keys = ["conv", "ssm"]
    if tcache.attn_k is not None:
        keys += ["attn_k", "attn_v"]
    return keys


@pytest.mark.parametrize("S", [40, 80])
def test_prefill_logits_and_greedy_decode_match_repro(models, S):
    jm, params, tm = models
    toks = _prompt(jm.cfg.vocab, S=S)
    jlog, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    tlog, tcache = tm.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=TOL, rtol=TOL)
    assert isinstance(tcache, SSMCache)
    assert (tcache.len, tcache.pos) == (int(jcache["len"]), int(jcache["pos"]))
    for k in _cache_keys(tcache):
        assert tuple(getattr(tcache, k).shape) == jcache[k].shape, k

    jdec = jax.jit(jm.decode_step)
    jcur = jnp.argmax(jlog, -1).astype(jnp.int32)
    tcur = tlog.argmax(-1)
    jtoks, ttoks = [], []
    for _ in range(N_DECODE):
        jtoks.append(np.asarray(jcur))
        ttoks.append(tcur.numpy())
        jlog, jcache = jdec(params, jcache, jcur)
        tlog, tcache = tm.decode_step(tcache, tcur)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=TOL, rtol=TOL)
        jcur = jnp.argmax(jlog, -1).astype(jnp.int32)
        tcur = tlog.argmax(-1)
    np.testing.assert_array_equal(np.stack(ttoks, 1), np.stack(jtoks, 1))
    assert (tcache.len, tcache.pos) == (int(jcache["len"]), int(jcache["pos"]))
    for k in _cache_keys(tcache):
        np.testing.assert_allclose(getattr(tcache, k).numpy(),
                                   np.asarray(jcache[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)


def test_forward_hidden_states_match_repro(models):
    """64 tokens (two whole chunks, so `repro` takes its Pallas kernel)."""
    jm, params, tm = models
    toks = _prompt(jm.cfg.vocab, S=64)
    jx, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    tx = tm.forward(torch.from_numpy(toks).long())
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=TOL, rtol=TOL)


def test_serving_engine_greedy_tokens_match_repro(models):
    """`ServingEngine.generate` on the port emits `repro`'s greedy tokens."""
    jm, params, tm = models
    toks = _prompt(jm.cfg.vocab, B=1)
    jout, _, _ = JaxEngine("ref", jm, params).generate(toks, max_new=N_DECODE)
    eng = ServingEngine("port", tm, price_per_1k=2.0, device="cpu")
    out, ttft, dec = eng.generate(toks, max_new=N_DECODE)
    np.testing.assert_array_equal(out, jout)
    assert ttft > 0 and dec > 0 and eng.inflight == 0


def test_short_prompt_pads_the_conv_state():
    """A prompt shorter than the convolution (W - 1 = 3) leaves a zero-
    padded conv state, so decoding continues exactly as from the longer
    prompt that starts with it: prefill of 2 tokens then a decode step
    gives the logits of a 3-token prefill."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                              dtype="float32")
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    toks = torch.tensor([[5, 17, 99]])
    _, cache = m.prefill(toks[:, :2])
    assert tuple(cache.conv.shape[2:]) == (cfg.ssm.conv_width - 1,
                                           m.layers[0].mamba.conv_ch)
    step, _ = m.decode_step(cache, toks[:, 2])
    full, _ = m.prefill(toks)
    torch.testing.assert_close(step, full, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_keeps_repro_dtypes_and_distributions(arch):
    """In bfloat16, ``A_log``, ``dt_bias`` and the norm scales stay float32
    and the matrices take the compute dtype; `Model.init` on a seeded
    generator draws `repro`'s distributions, the same weights per seed."""
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")

    def draw(seed):
        return Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(seed))

    a, b = draw(3), draw(3)
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    m = a.layers[0].mamba
    for p in (m.A_log, m.dt_bias, m.norm, a.layers[0].norm):
        assert p.dtype == torch.float32
    for p in (m.in_proj, m.conv_w, m.conv_b, m.D, m.out_proj):
        assert p.dtype == torch.bfloat16
    torch.testing.assert_close(-torch.exp(m.A_log)[[0, -1]],
                               torch.tensor([-1.0, -16.0]))
    assert (a.shared_attn is not None) == (cfg.family == "hybrid")
