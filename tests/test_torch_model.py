"""The port's dense decoder against `repro`'s, on carried weights.

`repro`'s `Model.init` draws the yi-9b SMOKE weights (2 layers, d 64,
4 heads, 1 kv head); `params_from_jax` carries them into the port on the
CPU.  In float32, with `repro` on its Pallas path (interpret mode), the
last-position prefill logits agree to 1e-4 and eight greedy decode tokens
are identical.
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
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import ServingEngine

TOL = 1e-4
N_DECODE = 8


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("yi-9b", smoke=True),
                               dtype="float32", use_pallas=True)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="float32")
    tm = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _prompt(vocab, B=2, S=16):
    return np.random.default_rng(0).integers(0, vocab, size=(B, S),
                                             dtype=np.int32)


def test_prefill_logits_and_greedy_decode_match_repro(models):
    jm, params, tm = models
    toks = _prompt(jm.cfg.vocab)
    jlog, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    tlog, tcache = tm.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=TOL, rtol=TOL)
    assert tcache.len == tcache.pos == toks.shape[1]
    assert tuple(tcache.k.shape) == jcache["k"].shape

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
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache["k"]),
                               atol=TOL, rtol=TOL)


def test_serving_engine_greedy_tokens_match_repro(models):
    """`ServingEngine.generate` on the port emits `repro`'s greedy tokens."""
    jm, params, tm = models
    toks = _prompt(jm.cfg.vocab, B=1)
    jout, _, _ = JaxEngine("ref", jm, params).generate(toks, max_new=N_DECODE)
    eng = ServingEngine("port", tm, price_per_1k=2.0, device="cpu")
    out, ttft, dec = eng.generate(toks, max_new=N_DECODE)
    np.testing.assert_array_equal(out, jout)
    assert ttft > 0 and dec > 0 and eng.inflight == 0
    assert eng.cost_of(16, 8) == pytest.approx((0.5 * 16 + 2.0 * 8) / 1000)


def test_init_draws_repro_distributions():
    """`Model.init` on a seeded generator: 0.02 N(0,1) embedding,
    N(0,1)/sqrt(fan_in) matrices, unit norms; the same seed gives the
    same weights."""
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="float32", d_model=256, d_ff=512,
                              vocab=512)

    def draw(seed):
        return Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(seed))

    a, b = draw(3), draw(3)
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    assert a.embed.std().item() == pytest.approx(0.02, rel=0.05)
    w1 = a.layers[0].mlp.w1
    assert w1.std().item() == pytest.approx(256 ** -0.5, rel=0.05)
    w2 = a.layers[0].mlp.w2
    assert w2.std().item() == pytest.approx(512 ** -0.5, rel=0.05)
    assert torch.equal(a.final_norm, torch.ones(256))
