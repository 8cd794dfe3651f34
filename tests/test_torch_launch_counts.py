"""`chip_smoke.py`'s launch arithmetic against the port's own calls.

On the card each kernel wrapper counts its launches, and `chip_smoke.py`
requires them to equal `_expected_launches` (a served stage invocation)
and `_train_launches` (a loss-and-gradient).  On the CPU the same model
code reaches the same `kernels.ops` entry points, each of which launches
one kernel on a CUDA tensor; the flash backward is one launch a call of
the attention `Function`'s backward.  Counting those calls here on the
SMOKE models checks the arithmetic of every family the port carries
before a card runs it: MLA's extra norms and its decode without a kernel,
the hybrid's checkpointed layers inside checkpointed groups, the VLM's
patches (which add rows, not launches), and the encoder-decoder's
encoder, cross attention and cross decode.  Every call must also pass
contiguous operands, which the kernels require.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.train.step import value_and_grad

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("yi-9b", "mistral-nemo-12b", "qwen2-72b", "minicpm3-4b",
         "granite-moe-1b-a400m", "arctic-480b", "mamba2-1.3b", "zamba2-2.7b",
         "llava-next-34b", "whisper-base")
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
    model = build_model(cfg, device="cpu", train=True).init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)),
             "labels": rng.integers(0, cfg.vocab, (2, 16))}
    if cfg.vlm is not None:
        batch["patch_embeds"] = rng.standard_normal(
            (2, cfg.vlm.n_patches, cfg.vlm.patch_dim)).astype(np.float32)
    if cfg.encdec is not None:
        batch["frames"] = rng.standard_normal(
            (2, cfg.encdec.encoder_len, cfg.d_model)).astype(np.float32)
    value_and_grad(model, batch)
    assert _nonzero(counts) == _nonzero(chip_smoke._train_launches(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launches_match_the_calls(chip_smoke, counts, arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (2, 12))  # B = 2: rows stay whole
    for k in counts:
        counts[k] = 0
    if cfg.encdec is None:
        ServingEngine("e", model, device="cpu").generate(prompt, max_new=5)
    else:  # no engine serves it: encode, prefill and decode steps directly
        frames = torch.randn(2, cfg.encdec.encoder_len, cfg.d_model)
        logits, cache = model.prefill(frames, torch.from_numpy(prompt))
        for _ in range(5):
            logits, cache = model.decode_step(cache, logits.argmax(-1))
    assert _nonzero(counts) == _nonzero(
        chip_smoke._expected_launches(cfg, 1, max_new=5))


def test_image_request_launches_match_the_calls(chip_smoke, counts):
    """A VLM prefill with patch embeddings launches what a text prefill
    does: the patches add rows to each kernel call, not calls."""
    cfg = dataclasses.replace(get_config("llava-next-34b", smoke=True),
                              dtype="float32")
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    patches = torch.randn(2, cfg.vlm.n_patches, cfg.vlm.patch_dim)
    logits, cache = model.prefill(torch.zeros(2, 12, dtype=torch.long),
                                  patches)
    for _ in range(5):
        logits, cache = model.decode_step(cache, logits.argmax(-1))
    assert cache.len == cfg.vlm.n_patches + 12 + 5
    assert _nonzero(counts) == _nonzero(
        chip_smoke._expected_launches(cfg, 1, max_new=5))


@pytest.mark.parametrize("arch", ARCHS[:-1])
def test_step_flops_take_every_family(chip_smoke, arch):
    """The train paths' model-FLOP count: 6 an active matrix parameter a
    token (a MoE layer's top-K experts of E), plus the causal attention of
    each attention application."""
    cfg = get_config(arch, smoke=True)
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers,
            "ssm": 0}.get(cfg.family)
    if attn is None:
        attn = cfg.n_layers // cfg.hybrid.attn_every
    n_mat = 10 ** 6
    if cfg.moe is not None:
        n_mat -= cfg.n_layers * (cfg.moe.n_experts - cfg.moe.top_k) * 3 * \
            cfg.d_model * cfg.d_ff
    want = 6.0 * n_mat * 2 * 8 + 12.0 * 36 * cfg.head_dim * cfg.n_heads * \
        attn * 2
    assert chip_smoke._step_flops(cfg, 10 ** 6, 2, 8) == want


def test_step_flops_of_the_encoder_decoder(chip_smoke):
    """Whisper's SMOKE model (d 64, 4 heads of 16, d_ff 128, 2 + 2 layers,
    16 frames): the encoder's matrices over B T frames, the cross keys and
    values over them too, every other matrix over B S tokens; attention
    non-causal in the encoder (T^2) and the cross attention (S T), causal
    in the decoder."""
    cfg = get_config("whisper-base", smoke=True)
    B, S, T = 2, 8, 16
    attn_w = 4 * 64 * 64
    enc_mat = 2 * (attn_w + 3 * 64 * 128)
    cross_kv = 2 * 2 * 64 * 64
    n_mat = 10 ** 6
    want = 6.0 * ((enc_mat + cross_kv) * B * T +
                  (n_mat - enc_mat - cross_kv) * B * S) + \
        12.0 * 16 * 4 * B * (2 * T * T + 2 * (36 + S * T))
    assert chip_smoke._step_flops(cfg, n_mat, B, S) == want


def _fake_pipe_mesh(n, s):
    import types
    return types.SimpleNamespace(axis_names=("pipe",), shape={"pipe": n},
                                 coords={"pipe": s}, device=torch.device(
                                     "cpu"))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("n_stages", [1, 2, 4])
@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-1.3b"])
def test_pipe_launches_match_the_calls(chip_smoke, counts, monkeypatch, arch,
                                       n_stages, remat):
    """Every stage's calls in one pipelined loss-and-gradient
    (`dist.pipeline_runs`: the embedding, `pipeline_forward`, the final
    norm and the loss) against `_pipe_launches`.  The collectives are
    replaced by copies (the launches do not depend on what a hop
    carries), so each rank of a group runs here alone."""
    from repro_torch.dist import pipeline, pipeline_runs

    monkeypatch.setattr(pipeline, "permute",
                        lambda t, shift, axis, mesh: t.detach().clone())
    monkeypatch.setattr(pipeline, "all_reduce_sum",
                        lambda t, mesh, axes=None: t.detach().clone())
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              n_layers=4, remat=remat)
    n_micro = 3
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (6, 8)),
             "labels": rng.integers(0, cfg.vocab, (6, 8))}
    for s in range(n_stages):
        mesh = _fake_pipe_mesh(n_stages, s)
        model = pipeline_runs.staged_model(cfg, n_stages, s, 0, "cpu")
        body = pipeline_runs.layer_stage(model)
        block = {k: p[None] for k, p in
                 pipeline_runs.stage_leaves(model).items()}
        for k in counts:
            counts[k] = 0
        loss, _ = pipeline_runs.pipe_loss(
            model, batch, n_micro,
            lambda x: pipeline.pipeline_forward(block, x, body, mesh=mesh))
        loss.backward()
        assert _nonzero(counts) == _nonzero(
            chip_smoke._pipe_launches(cfg, n_stages, n_micro, s)), s
