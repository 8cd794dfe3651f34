"""``train(mesh=)``'s checkpoints and the elastic restore, and the loop's
``key=`` / ``params=``, on the CPU.

- A checkpoint of a sharded run is the files and manifest of an
  unsharded one (leaves gathered, written by rank 0), so Mamba2 SMOKE
  (float32, AdamW, sequence 32, batch 8; the SMOKE model whose leaves
  3 ranks shard: 9 of 12 over the data axis) trained 2 steps on 2 gloo
  ranks restores onto 3 ranks ((3, 1): 8 rows do not split over 3), onto
  1 rank and onto no mesh, every leaf equal bit for bit once the shards
  are gathered; and an unsharded run's checkpoint restores onto 3 ranks.
- Runs resumed from the 2-rank checkpoint, on 3 ranks and on no mesh,
  continue an uninterrupted single-device run: their losses equal its
  steps 3 and 4 within the step tolerance (2e-4), as the 2-rank run's
  equal its steps 1 and 2.
- ``train(key=)`` draws the masters as ``TrainModel.init`` does from a
  generator seeded ``key``; ``train(params=)`` from `repro`'s
  ``init(PRNGKey(0))`` gives `repro`'s ``train(params=)`` first loss
  within 2e-4.
"""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import MarkovLMData as JaxMarkovLMData
from repro.models import build_model as jax_build_model
from repro.train import LoopConfig as JaxLoopConfig
from repro.train import OptConfig as JaxOptConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import train as jax_train
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, MarkovLMData
from repro_torch.dist import lane_mesh, one_rank_group, spawn
from repro_torch.dist.train_runs import leaf_digests, run_train_cases
from repro_torch.models import build_model, param_shapes
from repro_torch.train import (CheckpointManager, LoopConfig, OptConfig,
                               TrainConfig, train)
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import value_and_grad

STEP_TOL = 2e-4
OPT = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
ARCH = "mamba2-1.3b"
CFG = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
DATA = DataConfig(vocab=CFG.vocab, seq_len=32, batch=8, kgram=1)
TCFG = TrainConfig(opt=OptConfig(**OPT))
SEED = 11
MESH2 = ((2,), ("data",))
MESH3 = ((3, 1), ("data", "model"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lcfg(d, total):
    return LoopConfig(total_steps=total, ckpt_every=2, ckpt_dir=str(d),
                      keep=3, async_ckpt=False, log_every=100)


def _single(d, total=4):
    """The uninterrupted single-device run from the masters drawn from
    SEED, checkpointing every 2 steps into ``d``."""
    model = build_model(CFG, device="cpu", train=True)
    return train(model, MarkovLMData(DATA), TCFG, _lcfg(d, total),
                 device="cpu", key=SEED, log=lambda s: None)


def _loop(mesh, d, total):
    return dict(kind="loop", mesh=mesh, cfg=CFG, key=SEED, tcfg=TCFG,
                lcfg=_lcfg(d, total), data=DATA)


def _restore(mesh, d, step=2):
    return dict(kind="restore", mesh=mesh, cfg=CFG, tcfg=TCFG, data=DATA,
                dir=str(d), step=step)


def _host_leaves(tree):
    """``tree``'s structure with a numpy placeholder at every leaf, so the
    restore returns every leaf as a numpy array."""
    if isinstance(tree, dict):
        return {k: _host_leaves(v) for k, v in tree.items()}
    return np.empty(0)


def _unsharded_digests(d, step=2):
    """Every leaf of the checkpoint restored onto no mesh."""
    meta = {k: torch.empty(s, device="meta")
            for k, s in param_shapes(CFG).items()}
    target = {"params": _host_leaves(meta),
              "state": {"opt": _host_leaves(make_optimizer(TCFG.opt)[0](
                  meta))},
              "data": MarkovLMData(DATA).checkpoint_state()}
    return leaf_digests(CheckpointManager(str(d)).restore(step, target))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted run, the 2-rank run, and on 3 ranks the restores
    of both checkpoints and the resumed run; on 1 rank the restore."""
    root = tmp_path_factory.mktemp("elastic")
    single = _single(root / "single")
    two = spawn(run_train_cases, 2, device="cpu",
                args=([_loop(MESH2, root / "two", 2)],), timeout_s=60.0,
                deadline_s=180.0)
    shutil.copytree(root / "two", root / "resume3")
    shutil.copytree(root / "two", root / "resume0")
    three = spawn(run_train_cases, 3, device="cpu",
                  args=([_restore(MESH3, root / "two"),
                         _restore(MESH3, root / "single"),
                         _loop(MESH3, root / "resume3", 4)],),
                  timeout_s=60.0, deadline_s=180.0)
    with one_rank_group("gloo"):
        one = run_train_cases(lane_mesh(1, device="cpu"),
                              [_restore(((1,), ("data",)), root / "two")])
    resumed0 = train(build_model(CFG, device="cpu", train=True),
                     MarkovLMData(DATA), TCFG, _lcfg(root / "resume0", 4),
                     device="cpu", log=lambda s: None)
    for out in (two, three, one):
        assert len(set(out["digests"])) == 1, out["digests"]
    return dict(root=root, single=single, two=two["records"][0],
                three=three["records"], one=one["records"][0],
                resumed0=resumed0)


def test_two_rank_run_matches_the_single_device_run(runs):
    assert runs["two"]["losses"] == pytest.approx(
        runs["single"]["losses"][:2], rel=STEP_TOL)
    for m in runs["two"]["metrics"]:
        assert m["loss"] in runs["two"]["losses"]


def test_two_rank_checkpoint_restores_bit_for_bit_anywhere(runs):
    want = _unsharded_digests(runs["root"] / "two")
    assert runs["three"][0]["digests"] == want  # onto 3 ranks
    assert runs["one"]["digests"] == want       # onto 1 rank
    shapes = param_shapes(CFG)
    # the 3 ranks held shards: blocks of 1/3 where a dimension divides
    assert any(runs["three"][0]["shard_shapes"][k] != tuple(s)
               for k, s in shapes.items())
    assert runs["one"]["shard_shapes"] == {k: tuple(s)
                                           for k, s in shapes.items()}


def test_unsharded_checkpoint_restores_onto_three_ranks(runs):
    assert runs["three"][1]["digests"] == \
        _unsharded_digests(runs["root"] / "single")


@pytest.mark.parametrize("where", ["three ranks", "no mesh"])
def test_resumed_runs_continue_the_uninterrupted_run(runs, where):
    got = runs["three"][2]["losses"] if where == "three ranks" \
        else runs["resumed0"]["losses"]
    assert got == pytest.approx(runs["single"]["losses"][2:], rel=STEP_TOL)


def test_train_key_draws_the_masters(tmp_path):
    model = build_model(CFG, device="cpu", train=True).init(
        torch.Generator().manual_seed(SEED))
    want = float(value_and_grad(model, MarkovLMData(DATA).next_batch())[0])
    out = train(build_model(CFG, device="cpu", train=True),
                MarkovLMData(DATA), TCFG,
                LoopConfig(total_steps=1, ckpt_dir=str(tmp_path),
                           log_every=100), device="cpu", key=SEED,
                log=lambda s: None)
    assert out["losses"][0] == want


def test_train_params_gives_repros_first_loss(tmp_path):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype="float32")
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    lc = dict(total_steps=2, ckpt_every=100, log_every=100, async_ckpt=False)
    want = jax_train(jm, JaxMarkovLMData(JaxDataConfig(
        vocab=CFG.vocab, seq_len=32, batch=8, kgram=1)),
        JaxTrainConfig(opt=JaxOptConfig(**OPT)),
        JaxLoopConfig(ckpt_dir=str(tmp_path / "jax"), **lc), params=params,
        log=lambda s: None)["losses"]
    flat = {}

    def put(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(v, f"{prefix}{k}@")
            else:
                flat[prefix + k] = np.asarray(v)

    put(jax.tree.map(np.asarray, params))
    got = train(build_model(CFG, device="cpu", train=True),
                MarkovLMData(DATA), TCFG,
                LoopConfig(ckpt_dir=str(tmp_path / "port"), **lc),
                device="cpu", params=flat, log=lambda s: None)["losses"]
    assert got == pytest.approx(want, rel=STEP_TOL)
    with pytest.raises(ValueError, match="master keys"):
        train(build_model(CFG, device="cpu", train=True),
              MarkovLMData(DATA), TCFG,
              LoopConfig(ckpt_dir=str(tmp_path / "bad"), **lc),
              device="cpu", params={"embed": flat["embed"]})
