"""The VLM backbone (`llava-next-34b`) of the port against `repro`, on the
CPU.

`repro`'s `Model.init` draws the SMOKE model's weights (``patch_proj``
included), the norm scales are moved off their init values, and
`params_from_jax` carries them into the port.  In float32, with `repro`
on its Pallas path (interpret mode), a prefill with patch embeddings
gives the same last-position logits (to 1e-4), eight greedy decode tokens
are identical and so are the caches; a text-only prefill is `repro`'s
without patches; the loss (ignore-labels over the patches) and one train
step's gradients agree leaf for leaf, as `tests/test_torch_train.py`
holds the other families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import config as tconf
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import KVCache, Model
from repro_torch.train.step import value_and_grad

ARCH = "llava-next-34b"
TOL = 1e-4
STEP_TOL = 1e-5   # loss (rtol) and gradient leaves (relative L2)
N_DECODE = 8


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
        jm = JaxModel(jcfg)
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


def _inputs(B=2, S=16, seed=0):
    jm = _models()["jm"]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jm.cfg.vocab, (B, S), dtype=np.int32)
    v = jm.cfg.vlm
    patches = rng.standard_normal((B, v.n_patches, v.patch_dim)).astype(
        np.float32)
    return toks, patches


def test_config_is_repros():
    for smoke in (False, True):
        assert get_config(ARCH, smoke=smoke) == _port_cfg(
            jax_get_config(ARCH, smoke=smoke))
    full = get_config(ARCH)
    assert (full.vlm.n_patches, full.vlm.patch_dim) == (2880, 1152)


def test_prefill_with_patches_and_greedy_decode_match_repro():
    m = _models()
    jm, jparams, tm = m["jm"], m["jparams"], m["tm"]
    toks, patches = _inputs()
    jlog, jcache = jax.jit(jm.prefill)(jparams, {
        "tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)})
    tlog, tcache = tm.prefill(torch.from_numpy(toks).long(),
                              torch.from_numpy(patches))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    P, S = patches.shape[1], toks.shape[1]
    assert isinstance(tcache, KVCache)
    assert tcache.len == tcache.pos == int(jcache["len"]) == P + S
    for n in ("k", "v"):
        assert tuple(getattr(tcache, n).shape) == jcache[n].shape

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
    for n in ("k", "v"):
        np.testing.assert_allclose(getattr(tcache, n).numpy(),
                                   np.asarray(jcache[n]), atol=TOL, rtol=TOL)


def test_text_only_prefill_is_the_dense_path():
    """Without patches the VLM is a dense decoder: `repro`'s prefill of
    the tokens alone (what its serving engine passes), and the port's
    forward's last row gives the same logits."""
    m = _models()
    jm, jparams, tm = m["jm"], m["jparams"], m["tm"]
    toks, _ = _inputs(seed=2)
    jlog, jcache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    tlog, tcache = tm.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    assert tcache.len == toks.shape[1] == int(jcache["len"])
    hid = tm.forward(torch.from_numpy(toks).long())
    np.testing.assert_allclose((hid[:, -1] @ tm.unembed_matrix()).numpy(),
                               np.asarray(jlog), atol=TOL, rtol=TOL)


def test_patches_need_a_vlm():
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="float32")
    model = Model(cfg, device="cpu")
    with pytest.raises(ValueError, match="patch"):
        model.prefill(torch.zeros(1, 4, dtype=torch.long),
                      torch.zeros(1, 2, 8))


def test_params_to_numpy_round_trips_patch_proj():
    m = _models()
    params, tm = m["params"], m["tm"]
    want = _flat(params)
    assert want["patch_proj"].shape == (32, 64)
    train = params_from_jax(tm.cfg, params, device="cpu", train=True)
    for model in (tm, train):
        got = _flat(params_to_numpy(model))
        assert set(got) == set(want)
        for k, a in want.items():
            np.testing.assert_array_equal(got[k], a, err_msg=k)


@pytest.mark.parametrize("with_patches", [True, False])
def test_loss_and_train_step_gradients_match_repro(with_patches):
    """`repro`'s loss prepends an ignore-label for every patch position;
    the port's does too, and every gradient leaf (``patch_proj``'s only
    with patches) agrees."""
    m = _models()
    jm, params = m["jm"], m["params"]
    tm = params_from_jax(m["tm"].cfg, params, device="cpu", train=True)
    toks, patches = _inputs(B=2, S=12, seed=3)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    if with_patches:
        batch["patch_embeds"] = patches
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = value_and_grad(tm, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=STEP_TOL)
    assert float(metrics["nll"]) == pytest.approx(float(jaux["nll"]),
                                                  rel=STEP_TOL)
    for k, want in _flat(jax.tree.map(np.asarray, jgrads)).items():
        if k == "patch_proj" and not with_patches:
            assert grads[k] is None and not np.any(want)
            continue
        err = _rel_l2(grads[k].numpy(), want)
        assert err <= STEP_TOL, (k, err)
