"""The port's GPipe pipeline (`repro_torch.dist.pipeline`) against
`repro`'s and against sequential execution.

The toy case is `repro`'s own (`tests/test_pipeline.py`): the layer
``tanh(x @ w + b)`` over L 8, d 16, microbatches of (2, 4, 16), loss
``sum(out ** 2)``, its inputs drawn with numpy from a seed, at (stages x
microbatches) 4 x 6, 2 x 1, 4 x 2 and 1 x 3.  The port runs in spawned
gloo groups of 4, 2 and 1 ranks on the CPU (`run_pipe_cases`, started at
once in the background), `repro` in one subprocess at 4 virtual devices
(``XLA_FLAGS`` set before jax is imported; its ``jax.grad`` under
``jax.set_mesh``, without which jax 0.9 refuses the gradient).  The
forward is held to the port's own sequential run and to `repro`'s at
atol 1e-5, the gradients of the stages and of ``x`` to `repro`'s
``jax.grad`` at atol 1e-4 (`test_pipeline`'s tolerances).

The SMOKE case pipes Yi-9B's SMOKE model, cut to 4 layers in 2 stages,
float32, remat, through the 2-rank group: its loss and every master's
gradient against the port's sequential `TrainModel` on the same batch.
Every rank must agree, and each pass must issue exactly the collectives
and bytes `pass_collectives` / `pass_bytes` predict.
"""
import concurrent.futures
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist import spawn, train_mesh
from repro_torch.dist.pipeline import (pass_bytes, pass_collectives,
                                       pipeline_forward, split_stages,
                                       stage_block)
from repro_torch.dist.pipeline_runs import (load_dump, run_pipe_cases,
                                            sequential, tanh_stage)
from repro_torch.models import build_model
from repro_torch.train.step import value_and_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, D, MB, S = 8, 16, 2, 4
CASES = ((4, 6), (2, 1), (4, 2), (1, 3))  # (stages, microbatches)
PASSES = 2
SMOKE = dict(stages=2, layers=4, n_micro=2, batch=4, seq=16, key=5)
DEADLINE_S = 240.0

# `repro`'s pipeline at 4 virtual devices on the inputs in argv[1]
_REPRO = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.dist.pipeline import pipeline_forward, split_stages

def stage_body(p_stage, x):
    def f(x, p):
        wl, bl = p
        return jnp.tanh(x @ wl + bl), ()
    return jax.lax.scan(f, x, p_stage)[0]

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
w, b = jnp.asarray(inp["w"]), jnp.asarray(inp["b"])
out = {}
for (n, nm), x in inp["x"].items():
    mesh = jax.make_mesh((n,), ("pipe",), devices=jax.devices()[:n])
    stages, x = split_stages((w, b), n), jnp.asarray(x)

    def loss(stages, x):
        return (pipeline_forward(stages, x, stage_body, mesh=mesh,
                                 axis="pipe") ** 2).sum()

    fwd = pipeline_forward(stages, x, stage_body, mesh=mesh, axis="pipe")
    with jax.set_mesh(mesh):
        (gw, gb), gx = jax.grad(loss, argnums=(0, 1))(stages, x)
    out[n, nm] = {k: np.asarray(v) for k, v in dict(
        out=fwd, w=gw.reshape(w.shape), b=gb.reshape(b.shape), x=gx).items()}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _inputs():
    """The toy's w, b and every case's x, from one numpy seed."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    xs = {c: rng.standard_normal((c[1], MB, S, D)).astype(np.float32)
          for c in CASES}
    return w, b, xs


def _smoke_cfg():
    return dataclasses.replace(get_config("yi-9b", smoke=True),
                               dtype="float32", n_layers=SMOKE["layers"],
                               remat="full")


def _smoke_batch():
    rng = np.random.default_rng(11)
    shape = (SMOKE["batch"], SMOKE["seq"])
    return {"tokens": rng.integers(0, _smoke_cfg().vocab, shape),
            "labels": rng.integers(0, _smoke_cfg().vocab, shape)}


_TMP = tempfile.TemporaryDirectory(prefix="repro_torch_test_pipe_")


def _dump_dir(name) -> str:
    d = os.path.join(_TMP.name, name)
    os.makedirs(d, exist_ok=True)
    return d


@pytest.fixture(scope="module")
def runs():
    """{case: (the group's result, its record index)}, the dumps under
    `_dump_dir`, and `repro`'s outputs: the groups and `repro`'s
    subprocess all run at once."""
    w, b, xs = _inputs()
    inp = os.path.join(_TMP.name, "inputs.pkl")
    ref_path = os.path.join(_TMP.name, "repro.pkl")
    with open(inp, "wb") as f:
        pickle.dump({"w": w, "b": b, "x": xs}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REPRO, inp, ref_path],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        groups: dict = {}
        for c in CASES:
            groups.setdefault(c[0], []).append(dict(
                kind="toy", mesh=((c[0],), ("pipe",)), w=w, b=b, x=xs[c],
                passes=PASSES, dump=_dump_dir(f"toy_{c[0]}x{c[1]}")))
        groups[SMOKE["stages"]].append(dict(
            kind="model", mesh=((SMOKE["stages"],), ("pipe",)),
            cfg=_smoke_cfg(), key=SMOKE["key"], batch=_smoke_batch(),
            n_micro=SMOKE["n_micro"], passes=PASSES,
            dump=_dump_dir("smoke")))
        with concurrent.futures.ThreadPoolExecutor(len(groups)) as pool:
            futs = {n: pool.submit(spawn, run_pipe_cases, n, device="cpu",
                                   args=(cases,), deadline_s=DEADLINE_S)
                    for n, cases in groups.items()}
            results = {n: f.result() for n, f in futs.items()}
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    index = {}
    for n, cases in groups.items():
        for i, c in enumerate(cases):
            key = (n, c["x"].shape[0]) if c["kind"] == "toy" else "smoke"
            index[key] = (results[n], i)
    return index, ref


def _sequential(c):
    """The port's sequential run of a toy case: (out, grads of w, b, x)."""
    w, b, xs = _inputs()
    tw, tb, tx = (torch.from_numpy(a).clone().requires_grad_()
                  for a in (w, b, xs[c]))
    out = sequential((tw, tb), tx, tanh_stage)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "w": tw.grad.numpy(),
            "b": tb.grad.numpy(), "x": tx.grad.numpy()}


def _toy(c):
    return load_dump(_dump_dir(f"toy_{c[0]}x{c[1]}"), c[0])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_toy_forward_matches_sequential_and_repro(runs, case):
    _, ref = runs
    got = _toy(case)
    np.testing.assert_allclose(got["out"], _sequential(case)["out"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["out"], ref[case]["out"], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_toy_gradients_match_repro(runs, case):
    """The stages' and ``x``'s gradients against `repro`'s ``jax.grad``
    (and against the port's sequential run)."""
    _, ref = runs
    got, seq = _toy(case), _sequential(case)
    for k in ("w", "b", "x"):
        np.testing.assert_allclose(got[k], ref[case][k], atol=1e-4, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], seq[k], atol=1e-4, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_toy_ranks_agree_and_collectives_exact(runs, case):
    """Every rank's losses and output digest equal; each pass issues on
    every rank exactly the predicted collectives and bytes."""
    index, _ = runs
    res, i = index[case]
    n, nm = case
    assert len(res["digests"]) == n and len(set(res["digests"])) == 1
    assert len(set(res["records"][i]["losses"])) == 1
    want_bytes = pass_bytes(n, nm, MB * S * D * 4)
    for measures in res["measures"]:
        for p in measures[i]["passes"]:
            assert p["collectives"] == pass_collectives(n, nm)
            assert p["bytes"] == want_bytes


def test_smoke_model_matches_sequential_train_model(runs):
    """Yi-9B SMOKE, 4 layers in 2 stages: the pipelined loss and every
    master's gradient (each stage's layer blocks, the embedding through
    ``x``, the head) against the port's sequential `TrainModel.loss` on
    the whole batch, leaf for leaf."""
    index, _ = runs
    res, i = index["smoke"]
    cfg = _smoke_cfg()
    model = build_model(cfg, device="cpu", train=True).init(
        torch.Generator().manual_seed(SMOKE["key"]))
    loss, _, grads = value_and_grad(model, _smoke_batch())
    got = load_dump(_dump_dir("smoke"), SMOKE["stages"])
    losses = res["records"][i]["losses"]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-6)
    assert set(grads) <= set(got)
    for k, g in grads.items():
        np.testing.assert_allclose(got[k], g.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    hidden = got["hidden"]
    assert hidden.shape == (SMOKE["n_micro"],
                            SMOKE["batch"] // SMOKE["n_micro"],
                            SMOKE["seq"], cfg.d_model)


def test_smoke_model_ranks_agree_and_collectives_exact(runs):
    index, _ = runs
    res, i = index["smoke"]
    n, nm = SMOKE["stages"], SMOKE["n_micro"]
    assert len(set(res["digests"])) == 1
    micro = SMOKE["batch"] // nm * SMOKE["seq"] * _smoke_cfg().d_model * 4
    for measures in res["measures"]:
        for p in measures[i]["passes"]:
            assert p["collectives"] == pass_collectives(n, nm)
            assert p["bytes"] == pass_bytes(n, nm, micro)


@pytest.mark.parametrize("tree", ["tuple", "list", "dict"])
def test_split_stages_views_every_container(tree):
    w = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
    b = np.arange(8.0)
    params = {"tuple": (w, b), "list": [w, b], "dict": {"w": w, "b": b}}[
        tree]
    out = split_stages(params, 4)
    ow, ob = (out["w"], out["b"]) if tree == "dict" else out
    assert type(out) is type(params)
    assert ow.shape == (4, 2, 3) and ob.shape == (4, 2)
    assert ow.data_ptr() == w.data_ptr()  # a view
    assert torch.equal(ow[1], w[2:4]) and np.array_equal(ob[3], b[6:])


def _fake_mesh(n, s):
    return types.SimpleNamespace(axis_names=("pipe",), shape={"pipe": n},
                                 coords={"pipe": s})


def test_stage_block_takes_this_ranks_slice():
    w = torch.arange(8.0).view(8, 1)
    blocks = [stage_block(split_stages({"w": w}, 4), _fake_mesh(4, s))["w"]
              for s in range(4)]
    assert [tuple(x.shape) for x in blocks] == [(1, 2, 1)] * 4
    assert torch.equal(torch.cat(blocks).flatten(), w.flatten())


def test_split_stages_refuses_an_indivisible_leaf():
    with pytest.raises(ValueError, match=r"'\[1\]'.*into 3 stages"):
        split_stages((torch.zeros(6, 2), torch.zeros(8, 2)), 3)


def test_pipeline_refuses_a_leaf_of_another_leading_extent():
    stages = {"w": torch.zeros(1, 2, 4, 4), "b": torch.zeros(2, 2, 4)}
    with pytest.raises(ValueError, match="leaf 'b'.*leading extent 1"):
        pipeline_forward(stages, torch.zeros(3, 1, 4), tanh_stage,
                         mesh=_fake_mesh(2, 0))
    with pytest.raises(ValueError, match="axis 'stage'"):
        pipeline_forward({"w": torch.zeros(1, 2, 4, 4)},
                         torch.zeros(3, 1, 4), tanh_stage,
                         mesh=_fake_mesh(2, 0), axis="stage")


def test_train_mesh_refuses_an_unknown_axis():
    with pytest.raises(ValueError, match=r"axes \('stage',\)"):
        train_mesh((2,), ("stage",), device="cpu")


def test_pass_formulas():
    assert pass_collectives(1, 3) == 2
    assert pass_collectives(2, 4) == 2 * 4 + 2
    assert pass_collectives(4, 6, x_grad=False) == 2 * 8 + 1
    assert pass_bytes(2, 4, 10) == {"gathered": 0, "permuted": 80,
                                    "reduced": 80}
