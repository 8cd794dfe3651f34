"""The encoder-decoder (`whisper-base`) of the port against `repro`, on the
CPU.

`repro`'s `EncDecModel.init` draws the SMOKE model's weights, the norm
scales (``enc_norm`` and the three of each decoder layer included) are
moved off their init values, and `params_from_jax` carries them into the
port.  In float32, with `repro` on its Pallas path (interpret mode: the
non-causal encoder, the cross attention with Sq != Sk, and decode over
a cross cache of every length equal to its capacity), the encoder's
output, the prefill logits, eight greedy decode tokens at B = 2, the
caches ``k``, ``v``, ``xk``, ``xv``, the loss and one train step's
gradients agree.  The plain attention and its backward, non-causal with
Sq != Sk (the kernels' yardsticks on the card), agree with `repro`'s
`ref.attention` and its `jax.vjp`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.models.transformer import EncDecModel as JaxEncDecModel
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import config as tconf
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import (EncDecCache, EncDecModel, Model,
                                            TrainEncDecModel)
from repro_torch.train.step import value_and_grad

ARCH = "whisper-base"
TOL = 1e-4
STEP_TOL = 1e-5   # loss (rtol) and gradient leaves (relative L2)
N_DECODE = 8
CACHES = ("k", "v", "xk", "xv")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which parallel test workers
    sharing the cores do not make wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_cfg(jcfg):
    """`repro`'s ArchConfig rebuilt from the port's dataclasses."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tconf, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tconf.ArchConfig(**kw)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}@"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _rel_l2(a, b) -> float:
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(b), 1e-30))


_MODELS = {}


def _models():
    """(repro model, its params with the norms moved, as jax arrays and as
    numpy, the port's serving model carried from them), built once."""
    if not _MODELS:
        jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                                   dtype="float32", use_pallas=True)
        jm = JaxEncDecModel(jcfg)
        rng = np.random.default_rng(1)

        def move(path, a):
            a = np.asarray(a)
            if str(path[-1].key).endswith("norm"):
                return (1 + 0.2 * rng.standard_normal(a.shape)).astype(
                    np.float32)
            return a

        params = jax.tree_util.tree_map_with_path(
            move, jm.init(jax.random.PRNGKey(0)))
        cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                                  dtype="float32")
        tm = params_from_jax(cfg, params, device="cpu")
        _MODELS.update(jm=jm, jparams=jax.tree.map(jnp.asarray, params),
                       params=params, tm=tm)
    return _MODELS


def _inputs(B=2, S=10, seed=0):
    cfg = _models()["jm"].cfg
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal(
        (B, cfg.encdec.encoder_len, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    return frames, toks


def test_config_is_repros():
    for smoke in (False, True):
        assert get_config(ARCH, smoke=smoke) == _port_cfg(
            jax_get_config(ARCH, smoke=smoke))
    full = get_config(ARCH)
    assert (full.encdec.encoder_len, full.vocab) == (1500, 51865)
    # the unpadded vocabulary, even where the config pads the decoders'
    padded = dataclasses.replace(get_config(ARCH, smoke=True),
                                 vocab_pad_to=100)
    assert padded.padded_vocab == 300
    for model in (EncDecModel(padded, device="cpu"),
                  TrainEncDecModel(padded, device="cpu")):
        embed = dict(model.named_parameters())[
            "masters.embed" if hasattr(model, "masters") else "embed"]
        assert embed.shape == (256, 64)


def test_model_takes_no_encdec_config():
    with pytest.raises(ValueError, match="EncDecModel"):
        Model(get_config(ARCH, smoke=True), device="cpu")
    with pytest.raises(ValueError, match="no encoder"):
        EncDecModel(get_config("yi-9b", smoke=True), device="cpu")


def test_encode_matches_repro():
    m = _models()
    frames, _ = _inputs()
    want = jax.jit(m["jm"].encode)(m["jparams"], jnp.asarray(frames))
    got = m["tm"].encode(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_prefill_and_greedy_decode_match_repro():
    m = _models()
    jm, jparams, tm = m["jm"], m["jparams"], m["tm"]
    frames, toks = _inputs()
    jlog, jcache = jax.jit(jm.prefill)(jparams, {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    tlog, tcache = tm.prefill(torch.from_numpy(frames),
                              torch.from_numpy(toks).long())
    assert tlog.shape == (2, tm.cfg.vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    assert isinstance(tcache, EncDecCache)
    for n in CACHES:
        assert tuple(getattr(tcache, n).shape) == jcache[n].shape
        np.testing.assert_allclose(getattr(tcache, n).numpy(),
                                   np.asarray(jcache[n]), atol=TOL, rtol=TOL)

    jdec = jax.jit(jm.decode_step)
    jcur = jnp.argmax(jlog, -1).astype(jnp.int32)
    tcur = tlog.argmax(-1)
    jtoks, ttoks = [], []
    for _ in range(N_DECODE):
        jtoks.append(np.asarray(jcur))
        ttoks.append(tcur.numpy())
        jlog, jcache = jdec(jparams, jcache, jcur)
        tlog, tcache = tm.decode_step(tcache, tcur)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                                   rtol=TOL)
        jcur = jnp.argmax(jlog, -1).astype(jnp.int32)
        tcur = tlog.argmax(-1)
    np.testing.assert_array_equal(np.stack(ttoks, 1), np.stack(jtoks, 1))
    assert tcache.len == int(jcache["len"]) and \
        tcache.pos == int(jcache["pos"])
    for n in CACHES:
        np.testing.assert_allclose(getattr(tcache, n).numpy(),
                                   np.asarray(jcache[n]), atol=TOL, rtol=TOL)


def test_forward_matches_repro():
    m = _models()
    frames, toks = _inputs(seed=4)
    want, _ = jax.jit(m["jm"].forward)(m["jparams"], {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    got = m["tm"].forward(torch.from_numpy(frames),
                          torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_params_to_numpy_round_trips_the_tree():
    """Both forms give `repro`'s tree back, leaf for leaf, the three
    decoder norms, both attentions and the unpadded embeddings included."""
    m = _models()
    params, tm = m["params"], m["tm"]
    want = _flat(params)
    cfg = tm.cfg
    assert want["embed"].shape == (cfg.vocab, cfg.d_model)
    assert want["unembed"].shape == (cfg.d_model, cfg.vocab)
    assert {"dec_layers@self_norm", "dec_layers@cross_norm",
            "dec_layers@cross_attn@wk", "enc_norm"} <= set(want)
    train = params_from_jax(cfg, params, device="cpu", train=True)
    assert isinstance(train, TrainEncDecModel)
    for model in (tm, train):
        got = _flat(params_to_numpy(model))
        assert set(got) == set(want)
        for k, a in want.items():
            np.testing.assert_array_equal(got[k], a, err_msg=k)


def _train_batch(seed=3):
    frames, toks = _inputs(B=2, S=12, seed=seed)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"frames": frames, "tokens": toks, "labels": labels}


def test_loss_and_train_step_gradients_match_repro():
    m = _models()
    jm, params = m["jm"], m["params"]
    tm = params_from_jax(m["tm"].cfg, params, device="cpu", train=True)
    batch = _train_batch()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = value_and_grad(tm, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=STEP_TOL)
    assert float(metrics["aux"]) == 0.0
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for k, w in want.items():
        err = _rel_l2(grads[k].numpy(), w)
        assert err <= STEP_TOL, (k, err)


def test_remat_full_gives_the_same_gradients():
    """``remat="full"`` checkpoints each encoder and decoder layer (the
    cross keys and values recomputed inside) and changes no value."""
    params = _models()["params"]
    cfg = _models()["tm"].cfg
    batch = _train_batch(seed=5)
    outs = []
    for remat in ("none", "full"):
        tm = params_from_jax(dataclasses.replace(cfg, remat=remat), params,
                             device="cpu", train=True)
        outs.append(value_and_grad(tm, batch))
    assert float(outs[0][0]) == float(outs[1][0])
    for k, g in outs[0][2].items():
        torch.testing.assert_close(outs[1][2][k], g, rtol=0, atol=0)


@pytest.mark.parametrize("Sq,Sk,G", [(12, 40, 1), (7, 33, 2), (40, 40, 4)])
def test_plain_noncausal_attention_and_backward_match_repro(Sq, Sk, G):
    """The plain forward and backward non-causal, Sq != Sk (the encoder's
    and the cross attention's case) against `repro`'s `ref.attention` and
    its vjp; the autograd `Function` of `ops.attention` (the CPU path) takes
    the same gradients."""
    rng = np.random.default_rng(Sq + Sk + G)
    B, KV, D = 2, 2, 16
    H = KV * G
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, KV, Sk, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=False),
                        *(jnp.asarray(a) for a in (q, k, v)))
    wgrads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.attention_fwd(tq, tk, tv, causal=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(
        ref.attention(tq, tk, tv, causal=False).numpy(), np.asarray(want),
        atol=2e-5, rtol=2e-5)
    got = ref.attention_bwd(tq, tk, tv, o, lse, tdo, causal=False)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    ops.attention(*leaves, causal=False).backward(tdo)
    for g, a, w in zip(got, leaves, wgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)
