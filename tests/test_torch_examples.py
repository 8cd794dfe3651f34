"""The port's example drivers against `repro`'s.

`quickstart` and `mathqa_loadaware` must print `repro`'s lines, the
wall-clock replan milliseconds masked.  `train_100m`'s run function, at a
small config and data source and on weights carried from `repro` by
`params_from_jax`, must give `repro` `train`'s losses at
`test_torch_train.py`'s tolerance, and its checkpoints must restore the
parameters it ends with.
"""
import contextlib
import importlib.util
import io
import pathlib
import re
import signal

import jax
import numpy as np
import pytest
import torch

from repro_torch.data import DataConfig, MarkovLMData
from repro_torch.examples import mathqa_loadaware, quickstart, train_100m
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.train import CheckpointManager

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_TOL = 1e-5  # test_torch_train.py's loss tolerance (rtol)
TRAIN_STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def keep_signals():
    """The drivers install a preemption handler; put the test process's
    own back afterwards."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def _repro_lines(name):
    """Run `repro`'s ``examples/<name>.py`` and return its printed lines."""
    spec = importlib.util.spec_from_file_location(
        f"repro_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue().splitlines()


def _mask(lines):
    return [re.sub(r"replan=[0-9.]+ms", "replan=<wall>ms", s) for s in lines]


@pytest.mark.parametrize("name,mod", [("quickstart", quickstart),
                                      ("mathqa_loadaware", mathqa_loadaware)])
def test_host_driver_prints_repros_lines(name, mod, capsys):
    got = mod.main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == got
    want = _repro_lines(name)
    assert len(got) == len(want) == (6 if name == "quickstart" else 5)
    assert _mask(got) == _mask(want)


def _tiny():
    return ArchConfig(name="dense-tiny", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                      vocab=128, head_dim=16, remat="none", dtype="float32")


def test_config_100m_is_repros():
    spec = importlib.util.spec_from_file_location(
        "repro_example_train_100m", ROOT / "examples" / "train_100m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref = mod.config_100m()
    cfg = train_100m.config_100m()
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "remat", "dtype"):
        assert getattr(cfg, f) == getattr(ref, f), f


def test_train_100m_matches_repro_and_restores(tmp_path, keep_signals):
    from repro.data import DataConfig as RDataConfig
    from repro.data import MarkovLMData as RMarkovLMData
    from repro.models import build_model as r_build
    from repro.models.config import ArchConfig as RArchConfig
    from repro.train import LoopConfig as RLoop
    from repro.train import OptConfig as ROpt
    from repro.train import TrainConfig as RTrain
    from repro.train import train as r_train

    cfg = _tiny()
    rcfg = RArchConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab", "head_dim", "remat", "dtype")})
    rmodel = r_build(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    dc = dict(vocab=cfg.vocab, seq_len=16, batch=8, kgram=1)
    steps = TRAIN_STEPS
    ref = r_train(
        rmodel, RMarkovLMData(RDataConfig(**dc)),
        RTrain(accum_steps=2, opt=ROpt(peak_lr=3e-4, warmup_steps=5,
                                       total_steps=steps)),
        RLoop(total_steps=steps, ckpt_every=10,
              ckpt_dir=str(tmp_path / "repro"), log_every=5,
              async_ckpt=True),
        params=jax.tree.map(np.asarray, params), log=lambda *_: None)

    model = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                            device="cpu", train=True)
    out = train_100m.train_100m(cfg, MarkovLMData(DataConfig(**dc)), steps,
                                device="cpu", ckpt_dir=str(tmp_path / "port"),
                                model=model, log=lambda *_: None)
    assert out["tcfg"].accum_steps == 2
    assert np.allclose(out["losses"], ref["losses"], rtol=STEP_TOL, atol=0)
    # the last checkpoint restores the parameters the run ended with
    mgr = CheckpointManager(out["ckpt_dir"])
    assert mgr.list_steps() == [steps]
    target = {"params": {k: torch.zeros_like(v)
                         for k, v in out["params"].items()},
              "state": out["state"], "data": {"step": 0}}
    back = mgr.restore(steps, target)
    for k, v in out["params"].items():
        assert torch.equal(back["params"][k], v.detach()), k
    assert int(back["data"]["step"]) == steps
