"""The MoE families the port adds, against `repro`, on the CPU.

`granite-moe-1b-a400m` (32 experts, top 8 at full size) and `arctic-480b`
(128 experts, top 2, a dense residual MLP) at their SMOKE sizes, in
float32.  `repro`'s own ``moe_forward`` runs eagerly on the same numpy
inputs while its ``jax.lax.top_k`` and ``jnp.einsum`` calls are recorded,
so the port's `layers.route` is held to `repro`'s own intermediates: the
top-k experts, the dense (G, E, C) dispatch (which slots each row keeps)
and the combine weights (to 1e-6).  The cases: T not a multiple of the
group (B 2, S 40: 80 rows padded to 128), a capacity factor that drops, no
drops (decode), and exact ties (zero rows, whose gates are uniform, choose
experts 0..K-1; a router with repeated columns makes every row tie, and
the port chooses as ``jax.lax.top_k`` does).  The layer's output agrees to
1e-5 and its aux loss to 1e-6, with and without the dense residual; on
weights carried by `params_from_jax`, the prefill logits agree to 1e-4 and
eight greedy tokens are equal; `params_to_numpy` round-trips the new
leaves; `init` draws an expert with fan-in d.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jL
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import config as tconf
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import Model, TrainModel

ARCHS = ("granite-moe-1b-a400m", "arctic-480b")
ROUTE_TOL = 1e-6   # combine weights and aux
LAYER_TOL = 1e-5   # the layer's output
TOL = 1e-4         # prefill and decode logits
N_DECODE = 8
# route case -> (B, S, no_drop, MoEConfig overrides)
ROUTE_CASES = {"pad": (2, 40, False, {}),
               "drop": (2, 40, False, {"capacity_factor": 0.5}),
               "no_drop": (2, 40, True, {}),
               "ties": (2, 40, False, {})}


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


def _cfgs(arch, **moe_over):
    """(repro's SMOKE config, the port's), float32, MoE fields replaced."""
    jcfg = jax_get_config(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, dtype="float32", moe=dataclasses.replace(
        jcfg.moe, **moe_over))
    return jcfg, _port_cfg(jcfg)


def _layer(arch, case="pad", **moe_over):
    """(repro's config, its MoE params as numpy, the port's `MoE` holding
    them, the input x (B, S, d), no_drop) of a route case."""
    B, S, no_drop, over = ROUTE_CASES[case]
    jcfg, cfg = _cfgs(arch, **{**over, **moe_over})
    p = jax.tree.map(np.asarray, jL.init_moe(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if case == "ties":
        # two distinct router columns repeated: every row's gates tie in
        # two runs, and the zero rows below tie across all experts
        cols = p["router"][:, :2]
        p["router"] = np.tile(cols, (1, cfg.moe.n_experts // 2)).copy()
        x[0, :6] = 0.0
    mod = L.MoE(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, t in mod.named_parameters():
            t.copy_(torch.from_numpy(np.array(_flat(p)[name.replace(
                ".", "@")])))
    return jcfg, p, mod, x, no_drop


def _repro_moe(jcfg, p, x, no_drop, monkeypatch):
    """`repro`'s ``moe_forward`` run eagerly: (y, aux, raw top-k (values,
    indices), dispatch (nG, G, E, C), combine (nG, G, E, C)) as its own
    calls made them."""
    seen = {"top_k": [], "einsum": []}
    top_k, einsum = jax.lax.top_k, jnp.einsum

    def rec_top_k(*a, **kw):
        out = top_k(*a, **kw)
        seen["top_k"].append(out)
        return out

    def rec_einsum(spec, *ops, **kw):
        seen["einsum"].append((spec, ops))
        return einsum(spec, *ops, **kw)

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", rec_top_k)
        m.setattr(jnp, "einsum", rec_einsum)
        y, aux = jL.moe_forward(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), jcfg, no_drop=no_drop)
    (topv, topi), = seen["top_k"]
    ops = dict(seen["einsum"])
    dispatch = ops["gtec,gtd->gecd"][0]
    combine = ops["gtec,gecd->gtd"][0]
    return (np.asarray(y), float(aux), (np.asarray(topv), np.asarray(topi)),
            np.asarray(dispatch), np.asarray(combine))


def _dense_dispatch(r: L.Routing):
    """The port's routing as `repro`'s dense (nG, G, E, C) dispatch and
    combine."""
    nG, G, _ = r.topi.shape
    E = r.gates.shape[-1]
    disp = np.zeros((nG, G, E, r.C), np.float32)
    comb = np.zeros((nG, G, E, r.C), np.float32)
    topi, pos, keep = (t.numpy() for t in (r.topi, r.pos, r.keep))
    topv = r.topv.detach().numpy()
    for g, t, j in zip(*np.nonzero(keep)):
        disp[g, t, topi[g, t, j], pos[g, t, j]] = 1.0
        comb[g, t, topi[g, t, j], pos[g, t, j]] += topv[g, t, j]
    return disp, comb


@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_repros_intermediates(arch, case, monkeypatch):
    jcfg, p, mod, x, no_drop = _layer(arch, case)
    _, aux, (_, topi), dispatch, combine = _repro_moe(jcfg, p, x, no_drop,
                                                     monkeypatch)
    with torch.no_grad():
        r = mod.route(torch.from_numpy(x), no_drop)
    K, E = jcfg.moe.top_k, jcfg.moe.n_experts
    G, nG, C = L.moe_groups(x.shape[0] * x.shape[1], jcfg.moe, no_drop)
    assert (G, nG, C) == dispatch.shape[1:2] + dispatch.shape[:1] + \
        dispatch.shape[3:]
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    disp, comb = _dense_dispatch(r)
    np.testing.assert_array_equal(disp, dispatch)
    np.testing.assert_allclose(comb, combine, rtol=0, atol=ROUTE_TOL)
    assert float(r.aux) == pytest.approx(aux, abs=ROUTE_TOL)
    kept = int(disp.sum())
    if case == "no_drop":
        assert kept == nG * G * K
    if case == "drop":  # the capacity really drops choices here
        assert kept < nG * G * K
    if case == "pad":
        assert nG * G > x.shape[0] * x.shape[1]
        # the pad rows are zeros: uniform gates, experts 0..K-1, taking
        # capacity like any row
        np.testing.assert_array_equal(r.topi.numpy()[-1, -1], np.arange(K))
    if case == "ties":
        flat_topi = r.topi.numpy().reshape(-1, K)
        np.testing.assert_array_equal(flat_topi[:6], np.tile(np.arange(K),
                                                             (6, 1)))
        # a row of the repeated router: its gates tie in two runs of E / 2
        gates = r.gates.reshape(-1, E)[10]
        assert len(set(gates.tolist())) <= 2
        want = jax.lax.top_k(jnp.asarray(gates.numpy()), K)[1]
        np.testing.assert_array_equal(flat_topi[10], np.asarray(want))


def test_route_breaks_ties_as_jax_top_k():
    """`route`'s tie order on hand-made gates, against ``jax.lax.top_k``:
    equal gates everywhere, and the issue's five-gate row."""
    rows = [np.full(32, 1 / 32, np.float32),
            np.array([0.1, 0.3, 0.3, 0.2, 0.3] + [0.0] * 27, np.float32)]
    for gates, K in ((rows[0], 8), (rows[1], 2), (rows[1], 3)):
        r = L.route(torch.from_numpy(gates)[None, None], K, C=4)
        want = np.asarray(jax.lax.top_k(jnp.asarray(gates), K)[1])
        np.testing.assert_array_equal(r.topi[0, 0].numpy(), want)
    assert L.route(torch.from_numpy(rows[1])[None, None], 2,
                   C=4).topi[0, 0].tolist() == [1, 2]


@pytest.mark.parametrize("no_drop", [False, True])
@pytest.mark.parametrize("case", ["granite-moe-1b-a400m", "arctic-480b",
                                  "arctic-480b no residual"])
def test_layer_output_and_aux_match_repro(case, no_drop, monkeypatch):
    arch = case.split()[0]
    over = {"dense_residual": False} if "no residual" in case else {}
    jcfg, p, mod, x, _ = _layer(arch, **over)
    assert (mod.dense is not None) == jcfg.moe.dense_residual
    y, aux, *_ = _repro_moe(jcfg, p, x, no_drop, monkeypatch)
    with torch.no_grad():
        got, got_aux = mod(torch.from_numpy(x), no_drop=no_drop)
    np.testing.assert_allclose(got.numpy(), y, rtol=LAYER_TOL, atol=LAYER_TOL)
    assert float(got_aux) == pytest.approx(aux, abs=ROUTE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_paths_agree(arch):
    """The two index forms of the expert products (by slot, where the
    rows' choices are at least E; by choice, where they are fewer) give
    the same (R, K, d) outputs for every kept choice."""
    _, _, mod, x, _ = _layer(arch, "no_drop")
    with torch.no_grad():
        xt, (G, nG, C) = mod._rows(torch.from_numpy(x), True)
        r = mod._route_rows(xt, G, nG, C)
        R, K = xt.shape[0], mod.cfg.moe.top_k
        args = (mod.w1, mod.w3, mod.w2)
        a = L._experts_by_choice(xt, r.topi.reshape(R, K), *args)
        b = L._experts_by_slot(xt, r.topi.reshape(R, K), r.pos.reshape(R, K),
                               r.keep.reshape(R, K), nG, C, *args)
    assert bool(r.keep.all())
    torch.testing.assert_close(a, b, rtol=LAYER_TOL, atol=LAYER_TOL)


_MODELS = {}


def _models(arch):
    """(repro model, its params as jax arrays, as numpy, the port's serving
    model carried from them), built once an arch."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                   dtype="float32", use_pallas=True)
        jm = JaxModel(jcfg)
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        tm = params_from_jax(cfg, params, device="cpu")
        _MODELS[arch] = (jm, jax.tree.map(jnp.asarray, params), params, tm)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_repros(arch):
    """The port's CONFIG and SMOKE are `repro`'s, field for field."""
    for smoke in (False, True):
        assert get_config(arch, smoke=smoke) == _port_cfg(
            jax_get_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_greedy_decode_match_repro(arch):
    """Prefill (capacity routing over 2 x 40 tokens: 80 rows padded to 128)
    and eight decode steps of the batch of 2 (no drops; granite's 2 rows x
    2 choices reach its 4 experts by slot, arctic's fewer than its 8 by
    choice) on carried weights."""
    jm, jparams, _, tm = _models(arch)
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab, (2, 40),
                                             dtype=np.int32)
    jlog, jcache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    tlog, tcache = tm.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
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
    for n in ("k", "v"):
        np.testing.assert_allclose(getattr(tcache, n).numpy(),
                                   np.asarray(jcache[n]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_round_trips_the_moe_leaves(arch):
    """Both forms give `repro`'s tree back, leaf for leaf: the router, the
    stacked experts and the dense residual under `repro`'s keys."""
    _, _, params, tm = _models(arch)
    want = _flat(params)
    moe = {"router", "w1", "w3", "w2"}
    if tm.cfg.moe.dense_residual:
        moe |= {"dense@w1", "dense@w3", "dense@w2"}
    assert {"layers@mlp@" + n for n in moe} == \
        {k for k in want if k.startswith("layers@mlp@")}
    L_, E = tm.cfg.n_layers, tm.cfg.moe.n_experts
    assert want["layers@mlp@w1"].shape == (L_, E, tm.cfg.d_model,
                                           tm.cfg.d_ff)
    train = params_from_jax(tm.cfg, params, device="cpu", train=True)
    for model in (tm, train):
        got = _flat(params_to_numpy(model))
        assert set(got) == set(want)
        for k, a in want.items():
            np.testing.assert_array_equal(got[k], a, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_experts_with_fan_in_d(arch):
    """`init` draws each expert matrix as ``N(0, 1) / sqrt(fan_in)`` with
    the fan-in its input axis (d for ``w1``/``w3`` and the router, f for
    ``w2``), never the expert axis; the training form's leaves too."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              d_model=256, d_ff=128)
    d, f = cfg.d_model, cfg.d_ff
    want = {"router": d, "w1": d, "w3": d, "w2": f}
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    train = TrainModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    for name, fan_in in want.items():
        for w in (getattr(model.layers[0].mlp, name),
                  train.masters[f"layers@mlp@{name}"]):
            assert float(w.std()) == pytest.approx(fan_in ** -0.5, rel=0.05)
    # a stacked leaf is drawn one expert at a time: the same draws as
    # each (d, f) matrix in turn
    gen = torch.Generator().manual_seed(1)
    stacked = torch.empty(3, d, f)
    L._dense_(stacked, gen)
    gen = torch.Generator().manual_seed(1)
    for m in stacked:
        one = torch.empty(d, f)
        L._dense_(one, gen)
        torch.testing.assert_close(m, one, rtol=0, atol=0)
