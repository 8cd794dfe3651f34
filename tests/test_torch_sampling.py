"""`ServingEngine.generate`'s sampling path on the CPU.

`repro` samples with `jax.random.categorical` when ``greedy=False``; its
PRNG stream cannot be matched, so the port is held to what does not depend
on the stream: the greedy default is the argmax loop it was, a seeded draw
repeats, the drawn frequencies follow ``softmax(logits)`` (a chi-square
test), and a generator on another device than the engine's is refused.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import ServingEngine

# chi-square critical value at 7 degrees of freedom (8 tokens), p = 0.001
CHI2_CRIT_7 = 24.322


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _engine(vocab=256, spread=1.0):
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="float32", vocab=vocab)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.unembed.mul_(spread)
    return ServingEngine("e", model, device="cpu")


def _prompt(B=1, S=12, vocab=256):
    return np.random.default_rng(0).integers(0, vocab, (B, S), np.int32)


def test_greedy_default_is_the_argmax_loop():
    eng = _engine()
    toks = _prompt(B=2)
    out, _, _ = eng.generate(toks, max_new=6)
    out2, _, _ = eng.generate(toks, max_new=6, greedy=True)
    logits, cache = eng.model.prefill(torch.from_numpy(toks).long())
    cur, want = logits.argmax(-1), []
    for _ in range(6):
        want.append(cur)
        logits, cache = eng.model.decode_step(cache, cur)
        cur = logits.argmax(-1)
    want = torch.stack(want, 1).numpy()
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out2, want)


def test_seeded_draw_repeats_and_first_token_is_greedy():
    eng = _engine()
    toks = _prompt(B=3)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return eng.generate(toks, max_new=10, greedy=False, generator=g)[0]

    a, b, c = draw(5), draw(5), draw(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    greedy = eng.generate(toks, max_new=10)[0]
    np.testing.assert_array_equal(a[:, 0], greedy[:, 0])
    assert not np.array_equal(a, greedy)
    # no generator: one seeded with 0, so the call repeats too
    np.testing.assert_array_equal(
        eng.generate(toks, max_new=10, greedy=False)[0], draw(0))


def test_drawn_frequencies_follow_softmax():
    """4000 rows of one prompt share the first decode step's logits; their
    second tokens are 4000 draws from its softmax over 8 tokens (chi-square
    statistic under its p = 0.001 critical value)."""
    V, N = 8, 4000
    eng = _engine(vocab=V, spread=0.5)
    toks = np.repeat(_prompt(vocab=V), N, axis=0)
    out, _, _ = eng.generate(toks, max_new=2, greedy=False,
                             generator=torch.Generator().manual_seed(1))
    logits, cache = eng.model.prefill(torch.from_numpy(toks[:1]).long())
    assert (out[:, 0] == int(logits.argmax(-1))).all()
    logits, _ = eng.model.decode_step(cache, logits.argmax(-1))
    p = torch.softmax(logits[0].double(), -1).numpy()
    assert p.max() < 0.5 and p.min() > 0.02  # a spread to test
    counts = np.bincount(out[:, 1], minlength=V)
    chi2 = float(((counts - N * p) ** 2 / (N * p)).sum())
    assert chi2 < CHI2_CRIT_7, (chi2, counts, N * p)


def test_generator_on_another_device_is_refused():
    eng = _engine()
    other = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="generator on cuda"):
        eng.generate(_prompt(), max_new=2, greedy=False, generator=other)
    assert eng.inflight == 0
    # greedy decoding draws nothing: the generator is not looked at
    eng.generate(_prompt(), max_new=2, generator=other)
