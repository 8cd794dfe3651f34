"""The zoo, the scheduler and the end-to-end example of the port, on the CPU.

A two-rung ladder of a few steps trains and serves on ``device="cpu"``;
`tests/test_serving.py`'s scheduler cases run against the port's engine;
the example's ``main`` runs at tiny sizes through `run_fleet` and
`run_events`, its stage invocations counted.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, MarkovLMData
from repro_torch.examples import serve_workflow
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import Model, TrainModel
from repro_torch.serving import ServingEngine, ServingScheduler
from repro_torch.serving.zoo import _LADDER, build_zoo, sequence_accuracy

LADDER = [("zoo-s", 1, 32, 2, 6, 0.2), ("zoo-m", 2, 64, 4, 8, 1.0)]
TINY = ["--device", "cpu", "--requests", "6", "--profile-runs", "12"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which parallel test workers
    sharing the cores do not make wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def zoo():
    return build_zoo(vocab=64, seq_len=32, seed=0, ladder=LADDER,
                     device="cpu")


@pytest.fixture(scope="module")
def engine():
    cfg = get_config("yi-9b", smoke=True)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return ServingEngine("test", model, price_per_1k=1.0, device="cpu")


def test_ladder_is_repros():
    assert _LADDER == [("zoo-s", 1, 32, 2, 80, 0.2),
                       ("zoo-m", 2, 64, 4, 200, 1.0),
                       ("zoo-l", 3, 128, 4, 500, 5.0)]


def test_zoo_trains_and_serves(zoo):
    assert list(zoo) == ["zoo-s", "zoo-m"]
    for (name, layers, d, heads, _, price), eng in zip(LADDER, zoo.values()):
        cfg = eng.model.cfg
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads) == (layers, d, heads)
        assert cfg.head_dim == d // heads and cfg.dtype == "float32"
        assert eng.price_per_1k == price and eng.device.type == "cpu"
        out, ttft, dec = eng.generate(np.zeros((1, 16), np.int64), max_new=8)
        assert out.shape == (1, 8) and ttft > 0 and dec > 0
        assert 0 <= out.min() and out.max() < 64
        data = MarkovLMData(DataConfig(vocab=64, seq_len=32, batch=32,
                                       kgram=2))
        acc = sequence_accuracy(eng, data)
        assert 0.0 <= acc <= 1.0


def test_zoo_training_lowers_the_loss():
    """Each rung's training: the loss falls over its steps."""
    from repro_torch.serving.zoo import _cfg
    from repro_torch.train import OptConfig, TrainConfig, make_train_step

    cfg = _cfg(1, 32, 2, 64)
    model = TrainModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    data = MarkovLMData(DataConfig(vocab=64, seq_len=32, batch=16, kgram=2))
    init_state, step = make_train_step(model, TrainConfig(opt=OptConfig(
        peak_lr=5e-3, warmup_steps=10, total_steps=40)))
    state = init_state(model.params())
    losses = []
    for _ in range(40):
        _, state, m = step(model.params(), state, data.next_batch())
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < losses[0] - 0.3


def test_served_model_equals_the_trained_one():
    """The zoo serves what it trained: the serving `Model` built from the
    masters gives the training form's logits."""
    from repro_torch.serving.zoo import _cfg

    cfg = _cfg(2, 64, 4, 64)
    tm = TrainModel(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    served = params_from_jax(cfg, params_to_numpy(tm), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 9)))
    with torch.no_grad():
        want = tm.logits(toks)
    got = served.forward(toks) @ served.unembed_matrix()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_scheduler_and_backpressure(engine):
    sched = ServingScheduler(engine, hedge_after_s=1e9, max_queue=2)
    rec = sched.submit(np.zeros((1, 8), np.int32), max_new=2)
    assert rec.tokens_out == 2 and not rec.hedged
    sched._queue.extend([None, None])
    with pytest.raises(RuntimeError):
        sched.submit(np.zeros((1, 8), np.int32))


def test_hedging_triggers_on_slow_request(engine):
    sched = ServingScheduler(engine, hedge_after_s=0.0)  # everything hedges
    rec = sched.submit(np.zeros((1, 8), np.int32), max_new=2)
    assert rec.hedged


def test_example_through_run_fleet(zoo, capsys):
    out = serve_workflow.main(TINY, zoo=zoo)
    text = capsys.readouterr().out
    assert "VineLM fleet" in text and "Murakkab" in text
    for key in ("vine", "murakkab"):
        assert 0.0 <= out[key]["accuracy"] <= 1.0
        assert out[key]["mean_cost"] > 0
    assert out["rounds"] >= 1 and out["replans"] == out["rounds"]
    # profiling and both cohorts ran real invocations on both engines
    assert set(out["invocations"]) == {"zoo-s", "zoo-m"}
    assert sum(out["invocations"].values()) >= 12


@pytest.mark.parametrize("extra", [
    [],
    ["--slo", "5", "--classes", "0.5", "--admission", "feasibility",
     "--refresh", "1.0", "--explore", "0.2"]])
def test_example_through_run_events(zoo, extra):
    out = serve_workflow.main(TINY + ["--arrival-rate", "2.0"] + extra,
                              zoo=zoo)
    assert 0.0 <= out["vine"]["accuracy"] <= 1.0
    assert out["replans"] >= 1 and out["events"] >= out["replans"]


def test_example_trains_its_own_ladder(capsys):
    out = serve_workflow.main(TINY, ladder=LADDER[:1])
    assert out["zoo"] == ["zoo-s"]
    assert "training the model zoo" in capsys.readouterr().out


def test_example_flags_checked():
    with pytest.raises(SystemExit):
        serve_workflow.main(TINY + ["--refresh", "1.0"], zoo={})
    with pytest.raises(SystemExit):
        serve_workflow.main(TINY + ["--arrival-rate", "1", "--classes", "2",
                                    "--slo", "3"], zoo={})


def test_entry_points_refuse_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        build_zoo(ladder=LADDER[:1])
    with pytest.raises(RuntimeError):
        TrainModel(dataclasses.replace(get_config("yi-9b", smoke=True)))
