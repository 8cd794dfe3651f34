"""The traced calendar mirrors of `repro_torch.serving.loadsim`.

`traced_engine_rates`, `traced_token_rates`, `traced_job_rates` and
`traced_advance` are the compiled event engine's image of the
`FleetEngineSim` drain arithmetic.  On seeded float64 inputs each must
equal, bit for bit, both `repro`'s jnp mirror (under
``jax.enable_x64(True)``) and the port's own numpy method it mirrors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.loadsim as rl
from repro_torch.serving.loadsim import (
    EngineLoadModel,
    EngineTokenModel,
    FleetEngineSim,
    traced_advance,
    traced_engine_rates,
    traced_job_rates,
    traced_token_rates,
)

SEEDS = range(8)


def _draw(seed):
    """A fleet calendar: E engines, C slots, some idle, weights from the
    priority-class convention or arbitrary (the port's bucketed adds run
    in index order on the CPU, as numpy's and XLA's do, so any weights
    give the same sums)."""
    rng = np.random.default_rng(seed)
    E, C = int(rng.integers(1, 5)), int(rng.integers(1, 12))
    je = rng.integers(-1, E, C)
    if seed % 3 == 0:
        w = rng.uniform(0.3, 5.0, C)          # arbitrary weights
    else:
        w = rng.choice([1.0, 2.0, 4.0], C)    # class weights
    rem = rng.exponential(1.5, C)
    conc = rng.integers(1, 4, E).astype(np.float64)
    if seed % 4 == 1:
        conc[0] = np.inf                      # an engine with no model
    tok = (rng.uniform(0.01, 0.05, E), rng.uniform(1e-4, 2e-3, E),
           rng.uniform(1e-4, 3e-3, E), rng.integers(1, 6, E).astype(float))
    tok1 = np.maximum(tok[0] + tok[1], tok[2])
    return dict(E=E, C=C, je=je, w=w, rem=rem, conc=conc, tok=tok, tok1=tok1,
                t_last=float(rng.uniform(0, 2)), dt=float(rng.uniform(0, 1)))


def _sim(d, tokens=False, weighted=True):
    names = [f"e{e}" for e in range(d["E"])]
    if tokens:
        tw, tkv, tf, cap = d["tok"]
        sim = FleetEngineSim(names, d["C"], token_models={
            n: EngineTokenModel(n, t_weights_s=tw[e], t_kv_s=tkv[e],
                                t_flop_s=tf[e], kv_capacity=cap[e],
                                prefill_tok_s=1e-4)
            for e, n in enumerate(names)})
    else:
        models = [EngineLoadModel(n, concurrency=c, jitter=0.0)
                  for n, c in zip(names, d["conc"])]
        sim = FleetEngineSim(names, d["C"], slowdown=lambda e, n:
                             models[e].slowdown(float(n)))
    sim.job_engine[:] = d["je"]
    sim._weight[:] = np.where(d["je"] >= 0, d["w"], 1.0)
    sim._weighted = weighted
    sim._remaining[:] = np.where(d["je"] >= 0, d["rem"], np.inf)
    sim._t_last = d["t_last"]
    return sim


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _occ(d):
    act = d["je"] >= 0
    return np.bincount(d["je"][act], minlength=d["E"]).astype(np.float64)


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_and_token_rates_match(seed):
    d = _draw(seed)
    occ = _occ(d)
    with jax.enable_x64(True):
        r_ps = np.asarray(rl.traced_engine_rates(jnp.asarray(occ),
                                                 jnp.asarray(d["conc"])))
        r_tok = np.asarray(rl.traced_token_rates(
            jnp.asarray(occ), *map(jnp.asarray, d["tok"]),
            jnp.asarray(d["tok1"])))
    p_ps = traced_engine_rates(_t(occ), _t(d["conc"])).numpy()
    p_tok = traced_token_rates(_t(occ), *map(_t, d["tok"]),
                               _t(d["tok1"])).numpy()
    assert p_ps.tobytes() == r_ps.tobytes()
    assert p_tok.tobytes() == r_tok.tobytes()
    busy = occ > 0  # the host leaves idle engines at 1.0, as both mirrors
    assert np.array_equal(_sim(d)._rates(occ)[busy], p_ps[busy])
    assert np.array_equal(_sim(d, tokens=True)._rates(occ)[busy],
                          p_tok[busy])
    assert np.all(p_ps[~busy] == 1.0) and np.all(p_tok[~busy] == 1.0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_job_rates_match(seed, weighted):
    d = _draw(seed)
    act = d["je"] >= 0
    rates = _sim(d)._rates(_occ(d))
    w = np.where(act, d["w"], 1.0)
    p = traced_job_rates(_t(d["je"], torch.int64), _t(w), _t(act, torch.bool),
                         _t(rates), torch.tensor(weighted)).numpy()
    host = _sim(d, weighted=weighted)._job_rates(act, rates)
    assert np.array_equal(p[act], host) and np.all(p[~act] == 0.0)
    with jax.enable_x64(True):
        r = np.asarray(rl.traced_job_rates(
            jnp.asarray(d["je"].astype(np.int32)), jnp.asarray(w),
            jnp.asarray(act), jnp.asarray(rates), jnp.asarray(weighted)))
    assert p.tobytes() == r.tobytes()


@pytest.mark.parametrize("tokens", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_advance_matches(seed, tokens):
    d = _draw(seed)
    act = d["je"] >= 0
    weighted = seed % 2 == 0
    w = np.where(act, d["w"], 1.0)
    rem = np.where(act, d["rem"], np.inf)
    t = d["t_last"] + d["dt"]
    tok = (*d["tok"], d["tok1"]) if tokens else None
    p_rem, p_tl = traced_advance(
        _t(rem), _t(d["t_last"]), _t(t), _t(d["je"], torch.int64), _t(w),
        _t(act, torch.bool), _t(d["conc"]), torch.tensor(weighted),
        tok=None if tok is None else tuple(map(_t, tok)))
    sim = _sim(d, tokens=tokens, weighted=weighted)
    sim._advance(t)
    assert np.array_equal(p_rem.numpy(), sim._remaining)
    assert float(p_tl) == sim._t_last
    with jax.enable_x64(True):
        r_rem, r_tl = rl.traced_advance(
            jnp.asarray(rem), jnp.asarray(d["t_last"]), jnp.asarray(t),
            jnp.asarray(d["je"].astype(np.int32)), jnp.asarray(w),
            jnp.asarray(act), jnp.asarray(d["conc"]),
            jnp.asarray(weighted),
            tok=None if tok is None else tuple(map(jnp.asarray, tok)))
    assert p_rem.numpy().tobytes() == np.asarray(r_rem).tobytes()
    assert float(p_tl) == float(r_tl)


def test_advance_holds_without_positive_dt():
    """No drain at dt <= 0 or with every slot idle (the host's guard)."""
    d = _draw(1)
    act = d["je"] >= 0
    rem = _t(np.where(act, d["rem"], np.inf))
    args = (_t(d["je"], torch.int64), _t(d["w"]), _t(act, torch.bool),
            _t(d["conc"]), torch.tensor(False))
    out, tl = traced_advance(rem, _t(1.0), _t(0.5), *args)
    assert torch.equal(out, rem) and float(tl) == 1.0
    idle = torch.zeros(d["C"], dtype=torch.bool)
    out, _ = traced_advance(rem, _t(0.0), _t(2.0), args[0], args[1], idle,
                            args[3], args[4])
    assert torch.equal(out, rem)
