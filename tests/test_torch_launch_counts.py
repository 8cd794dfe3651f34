"""`chip_smoke.py`'s launch arithmetic against the port's own calls.

On the card each kernel wrapper counts its launches, and `chip_smoke.py`
requires them to equal `_expected_launches` (a served stage invocation)
and `_train_launches` (a loss-and-gradient).  On the CPU the same model
code reaches the same `kernels.ops` entry points, each of which launches
one kernel on a CUDA tensor; the flash backward is one launch a call of
the attention `Function`'s backward.  Counting those calls here on the
SMOKE models checks the arithmetic of every family the port carries
before a card runs it: MLA's extra norms and its decode without a kernel,
and the hybrid's checkpointed layers inside checkpointed groups.  Every
call must also pass contiguous operands, which the kernels require.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models.transformer import Model, TrainModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.train.step import value_and_grad

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("yi-9b", "mistral-nemo-12b", "qwen2-72b", "minicpm3-4b",
         "granite-moe-1b-a400m", "arctic-480b", "mamba2-1.3b", "zamba2-2.7b")
# the ops entry point (or plain backward) behind each kernel's launches
SITES = {"flash_attention": (ops, "attention"),
         "decode_attention": (ops, "decode_attention"),
         "rms_norm": (ops, "rms_norm"),
         "ssd_scan": (ops, "ssd_scan"),
         "flash_attention_bwd": (ref, "attention_bwd")}


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def counts(monkeypatch):
    """Calls of each kernel's site, counted from here on."""
    seen = {k: 0 for k in SITES}
    for name, (mod, attr) in SITES.items():
        real = getattr(mod, attr)

        def counted(*a, _real=real, _name=name, **kw):
            seen[_name] += 1
            # the kernels take contiguous operands only (and raise on the
            # card otherwise); the plain versions on the CPU do not mind
            assert all(t.is_contiguous() for t in a
                       if isinstance(t, torch.Tensor)), _name
            return _real(*a, **kw)

        monkeypatch.setattr(mod, attr, counted)
    return seen


def _nonzero(d):
    return {k: v for k, v in d.items() if v and k != "trie_plan"}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_launches_match_the_calls(chip_smoke, counts, arch, remat):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              remat=remat)
    model = TrainModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)),
             "labels": rng.integers(0, cfg.vocab, (2, 16))}
    value_and_grad(model, batch)
    assert _nonzero(counts) == _nonzero(chip_smoke._train_launches(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launches_match_the_calls(chip_smoke, counts, arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine("e", model, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (1, 12))
    for k in counts:
        counts[k] = 0
    eng.generate(prompt, max_new=5)
    assert _nonzero(counts) == _nonzero(
        chip_smoke._expected_launches(cfg, 1, max_new=5))


@pytest.mark.parametrize("arch", ARCHS)
def test_step_flops_take_every_family(chip_smoke, arch):
    """The train paths' model-FLOP count: 6 an active matrix parameter a
    token (a MoE layer's top-K experts of E), plus the causal attention of
    each attention application."""
    cfg = get_config(arch, smoke=True)
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0}.get(
        cfg.family)
    if attn is None:
        attn = cfg.n_layers // cfg.hybrid.attn_every
    n_mat = 10 ** 6
    if cfg.moe is not None:
        n_mat -= cfg.n_layers * (cfg.moe.n_experts - cfg.moe.top_k) * 3 * \
            cfg.d_model * cfg.d_ff
    want = 6.0 * n_mat * 2 * 8 + 12.0 * 36 * cfg.head_dim * cfg.n_heads * \
        attn * 2
    assert chip_smoke._step_flops(cfg, 10 ** 6, 2, 8) == want
