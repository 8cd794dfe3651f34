"""The port's shape cells and module entry points against `repro`'s.

`repro_torch.configs` re-exports `SHAPES` / `ShapeCell` and has
`shape_cells_for`, equal to `repro.configs`' for all ten architectures
(32 cells; `long_500k` only for the two sub-quadratic ones, as
`tests/test_dryrun_unit.py` counts).  ``python -m
repro_torch.launch.train --device cpu`` prints `repro`'s lines (the
learning rate of every logged step equal, the losses from other initial
weights) and keeps the checkpoints `repro`'s ``LoopConfig`` arithmetic
gives; both launchers run as subprocesses at once.  `launch.serve` hands
its command line to the end-to-end example's ``main``, checked with a
stub in place of the zoo's training.
"""
import dataclasses
import os
import re
import subprocess
import sys

import pytest

import repro.configs as jax_configs
import repro_torch.serving.zoo as zoo
from repro_torch import configs
from repro_torch.launch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_ARGS = ["--steps", "24", "--batch", "2", "--seq", "16"]
STEP_LINE = re.compile(r"^step (\d+): loss=(\d+\.\d{4}) lr=(\S+) \d+ms$")
FINAL_LINE = re.compile(r"^final loss (\d+\.\d{4}); checkpoints: (\[.*\])$")


def test_shapes_equal_repros_field_for_field():
    assert list(configs.SHAPES) == list(jax_configs.SHAPES)
    for k, cell in configs.SHAPES.items():
        assert isinstance(cell, configs.ShapeCell)
        assert dataclasses.asdict(cell) == dataclasses.asdict(
            jax_configs.SHAPES[k])


def test_shape_cells_for_equal_repros():
    ours = {a: configs.shape_cells_for(a) for a in configs.ARCH_IDS}
    assert list(ours) == list(jax_configs.ARCH_IDS)
    assert ours == {a: jax_configs.shape_cells_for(a)
                    for a in jax_configs.ARCH_IDS}
    assert sum(len(c) for c in ours.values()) == 32
    assert sorted(a for a, c in ours.items() if "long_500k" not in c) == \
        sorted(a for a in ours if a not in ("mamba2-1.3b", "zamba2-2.7b"))
    assert all(set(c) <= set(configs.SHAPES) for c in ours.values())


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The stdout of `repro`'s and the port's train launchers on the same
    flags, each checkpointing into a directory of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    procs = {}
    for name, mod, extra in (("repro", "repro.launch.train", []),
                             ("port", "repro_torch.launch.train",
                              ["--device", "cpu"])):
        ckpt = tmp_path_factory.mktemp(f"ckpt_{name}")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", mod, *TRAIN_ARGS, *extra, "--ckpt-dir",
             str(ckpt)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, (name, stderr[-3000:])
            out[name] = stdout.strip().splitlines()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


def _logged(lines):
    """The step lines; the loop's watchdog lines, which both print when a
    step takes 3x the median on a busy host, left out."""
    return [s for s in lines[:-1] if not s.startswith("[watchdog]")]


def test_train_launcher_prints_repros_lines(train_runs):
    port, ref = train_runs["port"], train_runs["repro"]
    assert FINAL_LINE.match(port[-1]) and FINAL_LINE.match(ref[-1])
    steps = [STEP_LINE.match(s) for s in _logged(port)]
    want = [STEP_LINE.match(s) for s in _logged(ref)]
    assert all(steps) and all(want) and len(steps) == len(want) == 2
    for got, ref_m in zip(steps, want):
        assert got.group(1) == ref_m.group(1)      # steps 10 and 20
        assert got.group(3) == ref_m.group(3)      # the schedule's lr
        assert 0.0 < float(got.group(2)) < 10.0


def test_train_launcher_keeps_repros_checkpoints(train_runs):
    """24 steps checkpoint every max(24 // 2, 10) = 12: steps 12 and 24."""
    got = FINAL_LINE.match(train_runs["port"][-1]).group(2)
    assert got == FINAL_LINE.match(train_runs["repro"][-1]).group(2)
    assert got == "[12, 24]"


class _Stop(Exception):
    pass


def test_serve_launcher_hands_its_argv_to_the_example(monkeypatch, capsys):
    seen = {}

    def stub(**kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(zoo, "build_zoo", stub)
    argv = list(sys.argv)
    with pytest.raises(_Stop):
        serve.main(["--device", "cpu", "--requests", "3"])
    assert sys.argv == argv
    assert seen["device"] == "cpu" and seen["seed"] == 0
    assert "(real PyTorch models on cpu)" in capsys.readouterr().out


def test_serve_launcher_help_names_the_examples_flags(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    assert all(f in text for f in ("--device", "--requests",
                                   "--profile-runs", "--arrival-rate"))


def test_serve_launcher_refuses_the_examples_bad_flags(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", "--explore", "0.1"])
    assert e.value.code == 2
    assert "--explore requires --arrival-rate" in capsys.readouterr().err


def test_launchers_refuse_the_cpu_unasked(monkeypatch):
    """Both launchers default to ``--device cuda``: without a card they
    raise before training or serving anything."""
    import torch

    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])
