"""The port's training path against `repro`'s, on the CPU.

The same numpy inputs go through both packages: the Markov data source
(bitwise), the schedule and the int8 quantisers, the three optimizers on
stacked leaves, one train step of each SMOKE model in float32 from
`params_from_jax` (loss and grad norm to rtol 1e-5, every gradient leaf to
1e-5 relative L2), gradient accumulation, error-feedback compression and
the chunked cross-entropy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import MarkovLMData as JaxMarkovLMData
from repro.models import build_model
from repro.models.transformer import _xent_chunked as jax_xent_chunked
from repro.train import OptConfig as JaxOptConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, MarkovLMData
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import _xent_chunked, _xent_full
from repro_torch.train import OptConfig, TrainConfig, make_train_step
from repro_torch.train import optimizer as topt
from repro_torch.train.step import value_and_grad

ARCHS = ("yi-9b", "mamba2-1.3b", "zamba2-2.7b", "mistral-nemo-12b",
         "qwen2-72b", "minicpm3-4b", "granite-moe-1b-a400m", "arctic-480b")
STEP_TOL = 1e-5   # loss, grad norm (rtol) and gradient leaves (rel L2)
OPT_TOL = 1e-6    # optimizer leaves: max |a - b| <= OPT_TOL max |b|


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which parallel test workers
    sharing the cores do not make wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=""):
    """`repro`'s nested tree as {"a@b": numpy leaf}, keys sorted."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}@"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _leaf_close(got, want, tol=OPT_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(scale, 1e-30))


def _rel_l2(a, b) -> float:
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------------------
# data, schedule, quantisers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kgram,host", [(1, 0), (2, 0), (2, 1)])
def test_markov_batches_bitwise_equal(kgram, host):
    kw = dict(vocab=32, seq_len=24, batch=4, seed=3, kgram=kgram)
    ours = MarkovLMData(DataConfig(**kw), host_id=host, num_hosts=2)
    theirs = JaxMarkovLMData(JaxDataConfig(**kw), host_id=host, num_hosts=2)
    np.testing.assert_array_equal(ours.trans, theirs.trans)
    for _ in range(3):
        a, b = ours.next_batch(), theirs.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    assert ours.checkpoint_state() == theirs.checkpoint_state()
    ours.restore_state({"step": 7})
    theirs.restore_state({"step": 7})
    np.testing.assert_array_equal(ours.next_batch()["tokens"],
                                  theirs.next_batch()["tokens"])


def test_cosine_lr_matches_repro():
    for kw in (dict(peak_lr=1.0, warmup_steps=10, total_steps=100),
               dict(peak_lr=5e-3, warmup_steps=0, total_steps=7),
               dict(peak_lr=3e-4, warmup_steps=1, total_steps=4)):
        for step in (0, 1, 3, 10, 55, 100, 250):
            want = float(jopt.cosine_lr(JaxOptConfig(**kw), step))
            got = float(topt.cosine_lr(OptConfig(**kw), step))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (kw, step)


@pytest.mark.parametrize("n,block", [(1000, 256), (40, 16), (256, 256)])
def test_quantisers_match_repro(n, block):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    q, s = topt._quant(torch.from_numpy(x), block)
    jq, js = jopt._quant(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    y = topt._dequant(q, s, x.shape, block).numpy()
    np.testing.assert_array_equal(y, np.asarray(jopt._dequant(jq, js, x.shape,
                                                              block)))
    assert np.abs(x - y).max() < np.abs(x).max() / 100
    v = x * x
    q, s = topt._quant_log(torch.from_numpy(v), block)
    jq, js = jopt._quant_log(jnp.asarray(v), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    w = topt._dequant_log(q, s, v.shape, block).numpy()
    _leaf_close(torch.from_numpy(w), jopt._dequant_log(jq, js, v.shape, block))
    assert np.all(np.abs(w - v) <= 0.25 * v + 1e-12)


# ----------------------------------------------------------------------
# optimizers on repro's stacked leaves
# ----------------------------------------------------------------------
# stacked leaves where repro's leaf rules differ from per-layer ones: a
# (L, d) norm scale is decayed and factored (final_norm (d,) is not), the
# int8 blocks run over the flattened (L, d) leaf (each layer's 8 values
# alone would stay float32), one update-RMS clip per stacked matrix
SHAPES = {"embed": (40, 8), "final_norm": (8,),
          "layers": {"attn_norm": (3, 8), "attn": {"wq": (3, 8, 24)},
                     "tiny": (3, 5)}}
OPT_CASES = {"adamw": {}, "adamw-int8": dict(quantize_moments=True,
                                              quant_block=16),
             "adafactor": dict(kind="adafactor")}


@pytest.mark.parametrize("case", list(OPT_CASES))
@pytest.mark.parametrize("updates", [1, 3])
def test_optimizers_match_repro_leaf_for_leaf(case, updates):
    rng = np.random.default_rng(1)

    def tree():
        return jax.tree.map(
            lambda s: rng.standard_normal(s).astype(np.float32), SHAPES,
            is_leaf=lambda x: isinstance(x, tuple))

    params, grads = tree(), [tree() for _ in range(updates)]
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10,
              **OPT_CASES[case])
    j_init, j_update = jopt.make_optimizer(JaxOptConfig(**kw))
    t_init, t_update = topt.make_optimizer(OptConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    js = j_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
    ts = t_init(tp)
    for g in grads:
        jp, js, jm = j_update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = t_update({k: torch.from_numpy(v)
                               for k, v in _flat(g).items()}, ts, tp)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    for k, want in _flat(jax.tree.map(np.asarray, jp)).items():
        _leaf_close(tp[k], want)
    jstate = _flat(jax.tree.map(np.asarray, {k: v for k, v in js.items()
                                             if k != "step"}))
    tstate = _flat({k: v for k, v in ts.items() if k != "step"})
    assert set(jstate) == set(tstate)
    for k, want in jstate.items():
        if want.dtype == np.int8:  # the quantised moments, code for code
            np.testing.assert_array_equal(tstate[k], want)
        else:
            _leaf_close(tstate[k], want)
    assert int(ts["step"]) == int(js["step"]) == updates


# ----------------------------------------------------------------------
# one train step of each SMOKE model
# ----------------------------------------------------------------------
def _models(arch, **over):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype="float32", **over)
    jm = build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              **over)
    tm = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu",
                         train=True)
    return jm, params, tm


def _batch(vocab, B=4, S=24, kgram=1):
    return JaxMarkovLMData(JaxDataConfig(vocab=vocab, seq_len=S, batch=B,
                                         kgram=kgram)).next_batch()


def _delta(new, old) -> float:
    return sum(float(np.sum((np.asarray(a, np.float64) - b) ** 2))
               for a, b in zip(jax.tree.leaves(new), jax.tree.leaves(old)))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_repro(arch):
    jm, params, tm = _models(arch)
    batch = _batch(jm.cfg.vocab)
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    j_init, j_step = jax_make_train_step(jm, JaxTrainConfig(
        opt=JaxOptConfig(**opt)))

    @jax.jit
    def reference(p, b):  # one compile: the gradients and the step
        return (jax.value_and_grad(jm.loss, has_aux=True)(p, b),
                j_step(p, j_init(p), b))

    ((jloss, jaux), jgrads), (jp2, _, jmet) = reference(
        params, jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = value_and_grad(tm, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=STEP_TOL)
    for k, want in _flat(jax.tree.map(np.asarray, jgrads)).items():
        err = _rel_l2(grads[k].numpy(), want)
        assert err <= STEP_TOL, (k, err)
    # the MoE layers' summed load-balancing loss (0 for the others), which
    # the loss carries at 0.01 and whose gradient reaches the routers
    assert float(metrics["aux"]) == pytest.approx(float(jaux["aux"]),
                                                  rel=STEP_TOL, abs=1e-7)
    assert (float(metrics["aux"]) > 0) == (tm.cfg.moe is not None)

    t_init, t_step = make_train_step(tm, TrainConfig(opt=OptConfig(**opt)))
    before = params_to_numpy(tm)
    tp2, tstate, tmet = t_step(tm.params(), t_init(tm.params()), batch)
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=STEP_TOL)
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=STEP_TOL)
    after = params_to_numpy(tm)
    np.testing.assert_allclose(_delta(after, before), _delta(jp2, params),
                               rtol=0.05)
    assert int(tstate["opt"]["step"]) == 1


def test_remat_full_gives_the_same_gradients():
    """``remat="full"`` (checkpoint per layer, and per group with the
    hybrid's shared block) changes no value: the same loss and gradients."""
    for arch in ("yi-9b", "zamba2-2.7b"):
        _, params, tm = _models(arch)
        _, _, tr = _models(arch, remat="full")
        batch = _batch(tm.cfg.vocab, B=2, S=16)
        l0, _, g0 = value_and_grad(tm, batch)
        l1, _, g1 = value_and_grad(tr, batch)
        assert float(l0) == float(l1)
        for k in g0:
            torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0)


def test_grad_accumulation_matches_large_batch():
    """Accumulated microbatch gradients give the full batch's loss, grad
    norm and parameter change (as `tests/test_train.py` holds `repro`)."""
    _, params, _ = _models("yi-9b")
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="float32")
    batch = MarkovLMData(DataConfig(vocab=cfg.vocab, seq_len=16, batch=8,
                                    kgram=1)).next_batch()
    outs = []
    for accum in (1, 4):
        tm = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                             device="cpu", train=True)
        init_state, step = make_train_step(tm, TrainConfig(
            accum_steps=accum, opt=OptConfig(peak_lr=1e-3, warmup_steps=0,
                                             total_steps=10)))
        before = params_to_numpy(tm)
        _, _, m = step(tm.params(), init_state(tm.params()), batch)
        outs.append((float(m["loss"]), float(m["grad_norm"]),
                     _delta(params_to_numpy(tm), before)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-4)
    np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=0.05)


def test_error_feedback_compression_matches_repro_and_learns():
    jm, params, tm = _models("yi-9b")
    data = MarkovLMData(DataConfig(vocab=tm.cfg.vocab, seq_len=32, batch=8,
                                   kgram=1))
    opt = dict(peak_lr=3e-3, warmup_steps=5, total_steps=40)
    batch = data.next_batch()
    j_init, j_step = jax_make_train_step(jm, JaxTrainConfig(
        compress_grads=True, opt=JaxOptConfig(**opt)))
    _, jstate, _ = jax.jit(j_step)(params, j_init(params),
                                   jax.tree.map(jnp.asarray, batch))
    init_state, step = make_train_step(tm, TrainConfig(
        compress_grads=True, opt=OptConfig(**opt)))
    state = init_state(tm.params())
    _, state, _ = step(tm.params(), state, batch)
    # the residuals (g + e minus its int8 round trip) agree except where
    # the two gradients, equal to 1e-6, straddle a rounding boundary of
    # the quantiser: there one code differs by one step, which moves the
    # residual by one step (twice its largest magnitude)
    for k, want in _flat(jax.tree.map(np.asarray, jstate["ef_err"])).items():
        scale = max(float(np.abs(want).max()), 1e-12)
        diff = np.abs(state["ef_err"][k].numpy() - want)
        assert (diff > 1e-3 * scale).mean() <= 1e-3, k
        assert diff.max() <= 2.01 * scale, k
    losses = []
    for _ in range(24):
        _, state, m = step(tm.params(), state, data.next_batch())
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2


# ----------------------------------------------------------------------
# cross-entropy
# ----------------------------------------------------------------------
@pytest.mark.parametrize("chunk,valid", [(16, 0), (24, 50), (64, 64)])
def test_chunked_xent_matches_full_and_repro(chunk, valid):
    rng = np.random.default_rng(chunk)
    B, S, d, V = 2, 5, 8, 64
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = rng.standard_normal((d, V)).astype(np.float32)
    labels = rng.integers(0, valid or V, (B, S))
    labels[0, 1] = -1
    mask = (labels >= 0).astype(np.float32)
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    lab, msk = torch.from_numpy(labels), torch.from_numpy(mask)
    loss = _xent_chunked(tx, tw, lab, msk, chunk, valid)
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    fx, fw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    full = _xent_full(fx, fw, lab, msk, valid or V)
    hx, hw = torch.autograd.grad(full, (fx, fw))
    assert float(loss) == pytest.approx(float(full), rel=1e-6)
    torch.testing.assert_close(gx, hx, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(gw, hw, rtol=1e-5, atol=1e-7)
    jloss, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: jax_xent_chunked(a, b, jnp.asarray(labels),
                                      jnp.asarray(mask), chunk, valid),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-7)


def test_chunked_xent_in_the_model_loss():
    """``logit_chunk_vocab`` routes the model's loss through the chunked
    cross-entropy: the same loss and gradients as the full one."""
    _, params, tm = _models("yi-9b")
    _, _, tc = _models("yi-9b", logit_chunk_vocab=96)
    batch = _batch(tm.cfg.vocab, B=2, S=12)
    l0, _, g0 = value_and_grad(tm, batch)
    l1, _, g1 = value_and_grad(tc, batch)
    assert float(l1) == pytest.approx(float(l0), rel=1e-6)
    for k in g0:
        assert _rel_l2(g1[k].numpy(), g0[k].numpy()) <= 1e-5, k
