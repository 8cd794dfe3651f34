"""The three dense families the port adds, against `repro`, on the CPU.

`mistral-nemo-12b` (GQA; also with ``head_dim=32``, so that H * hd != d as
at full width, 32 x 128 against 5120), `qwen2-72b` (GQA with a QKV bias)
and `minicpm3-4b` (multi-head latent attention).  `repro`'s `Model.init`
draws each SMOKE model's weights, the biases and the norm scales are then
moved off their init values (zeros and ones would not show a leaf loaded
into the wrong place), and `params_from_jax` carries them into the port.
In float32, with `repro` on its Pallas path (interpret mode: its flash
kernel takes every SMOKE shape here, MLA's qk head dim of 24 included;
MLA decode has no kernel in `repro` and runs its einsums), the
last-position prefill logits agree to 1e-4, eight greedy decode tokens
are identical, and so are the decode caches.  Also: `params_to_numpy`
gives the carried tree back, the MoE family is registered and builds (its
parity is `tests/test_torch_moe.py`'s), every one of `repro`'s ids builds
in both forms, tied embeddings (a tied SMOKE dense config) give
`repro`'s logits and ``embed`` gradient, decode attention refuses MLA's
head dim of 96, and the flash kernel's plain version at qk dim 96 with v
padded (MLA's prefill) matches `repro`'s attention.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.models.transformer import EncDecModel as JaxEncDecModel
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import ops
from repro_torch.models import config as tconf
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models import build_model
from repro_torch.models.transformer import (EncDecModel, MLACache, Model,
                                            TrainEncDecModel, TrainModel)
from repro_torch.train.step import value_and_grad

TOL = 1e-4
N_DECODE = 8
# case -> (arch, SMOKE overrides)
CASES = {"mistral-nemo-12b": ("mistral-nemo-12b", {}),
         "mistral-nemo-12b hd32": ("mistral-nemo-12b", {"head_dim": 32}),
         "qwen2-72b": ("qwen2-72b", {}),
         "minicpm3-4b": ("minicpm3-4b", {})}
MOE = ("granite-moe-1b-a400m", "arctic-480b")


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


_MODELS = {}


def _models(case):
    """(repro model, its params with biases and norms moved, the port's
    serving model carried from them), built once a case."""
    if case not in _MODELS:
        arch, over = CASES[case]
        jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                   dtype="float32", use_pallas=True, **over)
        jm = JaxModel(jcfg)
        rng = np.random.default_rng(1)

        def move(path, a):
            name = str(path[-1].key)
            a = np.asarray(a)
            if name.startswith("b") and name[1:] in ("q", "k", "v"):
                return (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
            if name.endswith("norm"):
                return (1 + 0.2 * rng.standard_normal(a.shape)).astype(
                    np.float32)
            return a

        params = jax.tree_util.tree_map_with_path(
            move, jm.init(jax.random.PRNGKey(0)))
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32", **over)
        tm = params_from_jax(cfg, params, device="cpu")
        _MODELS[case] = (jm, jax.tree.map(jnp.asarray, params), params, tm)
    return _MODELS[case]


@pytest.mark.parametrize("arch", sorted({a for a, _ in CASES.values()}))
def test_configs_are_repros(arch):
    """The port's CONFIG and SMOKE are `repro`'s, field for field."""
    for smoke in (False, True):
        assert get_config(arch, smoke=smoke) == _port_cfg(
            jax_get_config(arch, smoke=smoke))
    if arch == "mistral-nemo-12b":  # the first config with H hd != d
        full = get_config(arch)
        assert (full.n_heads * full.head_dim, full.d_model) == (4096, 5120)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_logits_and_greedy_decode_match_repro(case):
    jm, jparams, _, tm = _models(case)
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab, (2, 16),
                                             dtype=np.int32)
    jlog, jcache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    tlog, tcache = tm.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    mla = isinstance(tcache, MLACache)
    assert mla == (tm.cfg.attn_kind == "mla")
    names = ("c", "r") if mla else ("k", "v")
    for n in names:
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
    for n in names:
        np.testing.assert_allclose(getattr(tcache, n).numpy(),
                                   np.asarray(jcache[n]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_params_to_numpy_round_trips_the_new_leaves(case):
    """Both forms give `repro`'s tree back, leaf for leaf: the QKV biases
    and MLA's leaves under `repro`'s keys."""
    _, _, params, tm = _models(case)
    want = _flat(params)
    if tm.cfg.qkv_bias:
        assert {"layers@attn@bq", "layers@attn@bk", "layers@attn@bv"} <= \
            set(want)
    if tm.cfg.attn_kind == "mla":
        assert {"layers@attn@" + n for n in (
            "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b",
            "wo")} == {k for k in want if k.startswith("layers@attn@")}
    train = params_from_jax(tm.cfg, params, device="cpu", train=True)
    for model in (tm, train):
        got = _flat(params_to_numpy(model))
        assert set(got) == set(want)
        for k, a in want.items():
            np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert set(train.masters) == set(want)


@pytest.mark.parametrize("arch", MOE)
def test_moe_family_is_registered_and_builds(arch):
    """The MoE family is ported: the registry holds its configs, equal to
    `repro`'s, and `Model` and `TrainModel` build them with a `MoE` in
    every layer."""
    cfg = get_config(arch, smoke=True)
    assert cfg == _port_cfg(jax_get_config(arch, smoke=True))
    model = Model(cfg, device="cpu")
    assert all(blk.moe for blk in model.layers)
    train = TrainModel(cfg, device="cpu")
    assert "layers@mlp@router" in train.masters


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_every_arch_builds_in_both_forms(arch):
    """The registry holds every one of `repro`'s ids, its configs equal to
    `repro`'s, and `build_model` builds each in the serving and the
    training form (`EncDecModel` / `TrainEncDecModel` for the
    encoder-decoder), the training form with `repro`'s leaves."""
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    cfg = get_config(arch, smoke=True)
    assert cfg == _port_cfg(jax_get_config(arch, smoke=True))
    encdec = cfg.encdec is not None
    model = build_model(cfg, device="cpu")
    assert isinstance(model, EncDecModel if encdec else Model)
    train = build_model(cfg, device="cpu", train=True)
    assert isinstance(train, TrainEncDecModel if encdec else TrainModel)
    jparams = jax.eval_shape(
        (JaxEncDecModel if encdec else JaxModel)(jax_get_config(
            arch, smoke=True)).init, jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in _flat(jax.tree.map(
        lambda a: np.zeros((), np.int8), jparams)).items()}
    assert set(train.masters) == set(want)


def test_arch_ids_in_repro_order():
    """The registry lists `repro`'s ids in `repro`'s order: a driver that
    takes its choices from the list, or iterates it, sees the same ids
    in the same order in both packages."""
    assert ARCH_IDS == JAX_ARCH_IDS


def test_tied_embeddings_match_repro():
    """A tied SMOKE dense config: no ``unembed`` leaf in either package,
    the logits unembedded by ``embed.T``, and the train step's ``embed``
    gradient summing both uses, leaf for leaf."""
    jcfg = dataclasses.replace(jax_get_config("yi-9b", smoke=True),
                               dtype="float32", use_pallas=True,
                               tie_embeddings=True)
    jm = JaxModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    assert "unembed" not in params
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="float32", tie_embeddings=True)
    tm = params_from_jax(cfg, params, device="cpu")
    assert not hasattr(tm, "unembed")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12),
                                             dtype=np.int32)
    jlog, _ = jax.jit(jm.prefill)(jax.tree.map(jnp.asarray, params),
                                  {"tokens": jnp.asarray(toks)})
    tlog, _ = tm.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    assert set(_flat(params_to_numpy(tm))) == set(_flat(params))

    train = params_from_jax(cfg, params, device="cpu", train=True)
    assert "unembed" not in train.masters
    labels = np.roll(toks, -1, axis=1)
    batch = {"tokens": toks, "labels": labels}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    loss, _, grads = value_and_grad(train, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = np.asarray(jgrads["embed"], np.float64)
    got = grads["embed"].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_decode_attention_refuses_mla_head_dim():
    """Decode attention's head dims are its own: 96 (MLA's qk dim, which
    both flash kernels take) is refused, since MLA decodes without it."""
    assert 96 in fmod.HEAD_DIMS and 96 not in dmod.HEAD_DIMS

    def operands(D):
        q = torch.zeros(1, 4, D, dtype=torch.bfloat16)
        kc = torch.zeros(1, 4, 8, D, dtype=torch.bfloat16)
        return q, kc, kc.clone(), torch.full((1,), 8, dtype=torch.int32)

    with pytest.raises(ValueError, match="head dim in"):
        dmod.check_operands(*operands(96))
    dmod.check_operands(*operands(128))
    q, kc, _, _ = operands(96)
    fmod._check("flash_attention", q[:, :, None], kc, kc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_at_qk96_with_padded_v_matches_repro(dtype):
    """MLA's prefill attention at full width: q and k at head dim 64 + 32,
    v padded from 64 to 96, the first 64 output columns kept.  The port's
    plain version (what `ops.attention` runs on a CPU tensor, and the
    kernel's yardstick on the card) against `repro`'s Pallas kernel
    (interpret mode) and its XLA path on the same numpy inputs."""
    rng = np.random.default_rng(3)
    B, H, S, dqk, dv = 1, 4, 40, 96, 64
    q, k = (rng.standard_normal((B, H, S, dqk)).astype(np.float32)
            for _ in range(2))
    v = np.zeros((B, H, S, dqk), np.float32)
    v[..., :dv] = rng.standard_normal((B, H, S, dv))
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, 2e-5),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dtype]
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = ops.attention(tq, tk, tv, causal=True)[..., :dv].float().numpy()
    for use_pallas in (True, False):
        want = jops.attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              causal=True, use_pallas=use_pallas)
        want = np.asarray(want[..., :dv], np.float32)
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
