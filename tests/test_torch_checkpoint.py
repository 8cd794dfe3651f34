"""The port's checkpoints: `repro`'s cases against the port's manager, and
the on-disk format shared with `repro` (a checkpoint `repro` writes
restores into the port and the next step matches; the port's files are
the ones `repro` writes).
"""
import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model
from repro.train import CheckpointManager as JaxCheckpointManager
from repro.train import OptConfig as JaxOptConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, MarkovLMData
from repro_torch.models.convert import params_from_jax
from repro_torch.train import (CheckpointManager, LoopConfig, OptConfig,
                               TrainConfig, make_train_step, train)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which parallel test workers
    sharing the cores do not make wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_checkpoint_atomic_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones(3, 4)}}
    for s in (1, 2, 3):
        mgr.save(s, {"a": tree["a"] * s, "b": {"c": tree["b"]["c"] * s}})
    assert mgr.list_steps() == [2, 3]  # gc keeps newest 2
    restored = mgr.restore(3, tree)
    torch.testing.assert_close(restored["a"], torch.arange(10.0) * 3)
    torch.testing.assert_close(restored["b"]["c"], torch.full((3, 4), 3.0))
    assert not glob.glob(os.path.join(str(tmp_path), "tmp.*"))


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(8, dtype=torch.float32)}
    path = mgr.save(1, tree)
    fn = glob.glob(os.path.join(path, "*.npy"))[0]
    arr = np.load(fn)
    arr[0] += 1
    np.save(fn, arr)
    with pytest.raises(IOError):
        mgr.restore(1, tree)


def test_bf16_leaf_round_trips(tmp_path):
    """A bfloat16 leaf is stored as its 16-bit pattern under "bfloat16"
    (numpy has no bfloat16): bit for bit back, in `repro`'s bytes."""
    x = torch.randn(5, 7).to(torch.bfloat16)
    tree = {"w": x, "n": {"step": torch.tensor(3, dtype=torch.int32)}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    back = mgr.restore(1, tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), x.view(torch.int16))
    assert int(back["n"]["step"]) == 3
    with open(os.path.join(str(tmp_path), "step_00000001",
                           "manifest.json")) as f:
        meta = json.load(f)["leaves"]
    assert meta["w"]["dtype"] == "bfloat16"
    # repro's manager restores the same bytes as its bfloat16 array
    jback = JaxCheckpointManager(str(tmp_path)).restore(
        1, {"w": jnp.zeros((5, 7), jnp.bfloat16), "n": {"step": 0}})
    np.testing.assert_array_equal(
        np.asarray(jback["w"]).view(np.int16), x.view(torch.int16).numpy())


def test_repro_bf16_checkpoint_restores_into_the_port(tmp_path):
    w = jnp.asarray(np.random.default_rng(0).standard_normal((4, 6)),
                    jnp.bfloat16)
    JaxCheckpointManager(str(tmp_path)).save(2, {"w": w})
    back = CheckpointManager(str(tmp_path)).restore(
        2, {"w": torch.zeros(4, 6, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(back["w"].view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))


def _yi_smoke():
    jcfg = dataclasses.replace(jax_get_config("yi-9b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="float32")
    return jcfg, cfg


@pytest.mark.parametrize("quantize", [False, True])
def test_repro_checkpoint_restores_and_next_step_matches(tmp_path, quantize):
    """`repro` trains two steps and checkpoints params and AdamW state; the
    port restores them by `repro`'s keys and takes the third step, which
    matches `repro`'s third step."""
    jcfg, cfg = _yi_smoke()
    jm = build_model(jcfg)
    opt = dict(peak_lr=3e-3, warmup_steps=1, total_steps=10,
               quantize_moments=quantize)
    j_init, j_step = jax_make_train_step(jm, JaxTrainConfig(
        opt=JaxOptConfig(**opt)))
    j_step = jax.jit(j_step)
    data = MarkovLMData(DataConfig(vocab=cfg.vocab, seq_len=16, batch=4,
                                   kgram=1))
    batches = [data.next_batch() for _ in range(3)]
    params = jm.init(jax.random.PRNGKey(0))
    state = j_init(params)
    for b in batches[:2]:
        params, state, _ = j_step(params, state, jax.tree.map(jnp.asarray, b))
    JaxCheckpointManager(str(tmp_path)).save(
        2, {"params": params, "state": state})
    jp3, _, jmet = j_step(params, state, jax.tree.map(jnp.asarray,
                                                      batches[2]))

    tm = params_from_jax(cfg, jax.tree.map(np.zeros_like, jax.tree.map(
        np.asarray, params)), device="cpu", train=True)
    t_init, t_step = make_train_step(tm, TrainConfig(opt=OptConfig(**opt)))
    target = {"params": tm.params(), "state": t_init(tm.params())}
    restored = CheckpointManager(str(tmp_path)).restore(2, target)
    with torch.no_grad():
        for k, p in tm.params().items():
            p.copy_(restored["params"][k])
    assert int(restored["state"]["opt"]["step"]) == 2
    _, _, tmet = t_step(tm.params(), restored["state"], batches[2])
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-5)
    flat = {}

    def walk(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}@")
            else:
                flat[pre + k] = np.asarray(v)

    walk(jax.tree.map(np.asarray, jp3))
    delta = sum(float(np.sum((tm.params()[k].detach().numpy() - v) ** 2))
                for k, v in flat.items())
    moved = sum(float(np.sum((np.asarray(a) - np.asarray(b)) ** 2))
                for a, b in zip(jax.tree.leaves(jp3),
                                jax.tree.leaves(params)))
    assert delta <= 1e-6 * moved


def test_async_checkpoint_and_resume(tmp_path):
    """`repro`'s resume case on the port's loop: an async run of 12 steps,
    then a run to 18 that restores step 12 and continues the data stream."""
    _, cfg = _yi_smoke()
    from repro_torch.models.transformer import TrainModel

    model = TrainModel(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tcfg = TrainConfig(opt=OptConfig(peak_lr=3e-3, warmup_steps=5,
                                     total_steps=40))
    data = MarkovLMData(DataConfig(vocab=cfg.vocab, seq_len=32, batch=8,
                                   kgram=1))
    out = train(model, data, tcfg,
                LoopConfig(total_steps=12, ckpt_every=6, ckpt_dir=str(tmp_path),
                           log_every=100, async_ckpt=True),
                device="cpu", log=lambda *_: None)
    assert out["manager"].latest_step() == 12
    assert len(out["losses"]) == 12
    data2 = MarkovLMData(DataConfig(vocab=cfg.vocab, seq_len=32, batch=8,
                                    kgram=1))
    out2 = train(model, data2, tcfg,
                 LoopConfig(total_steps=18, ckpt_every=6,
                            ckpt_dir=str(tmp_path), log_every=100),
                 device="cpu", log=lambda *_: None)
    assert data2.state["step"] == 18
    assert len(out2["losses"]) == 6  # only steps 12..18 ran
    assert int(out2["state"]["opt"]["step"]) == 18
    assert out2["manager"].list_steps() == [12, 18]
