"""Tiny real-model zoo for the end-to-end example (`repro.serving.zoo`
counterpart).

Builds a ladder of small decoder LMs of increasing width and depth,
trains each briefly on the same Markov source, and wraps them in serving
engines.  Bigger members are genuinely more accurate and genuinely slower
and pricier, so the VineLM trie is profiled and controlled against real
model behaviour.  The ladder (layers, widths, heads, steps, prices) is
`repro`'s; the weights are drawn from a `torch.Generator`, so they and the
trained models differ from `repro`'s.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data import DataConfig, MarkovLMData
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import TrainModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.train import OptConfig, TrainConfig, make_train_step

_LADDER = [
    # name, layers, d_model, heads, steps, price ($/1k tok)
    ("zoo-s", 1, 32, 2, 80, 0.2),
    ("zoo-m", 2, 64, 4, 200, 1.0),
    ("zoo-l", 3, 128, 4, 500, 5.0),
]


def _cfg(layers, d, heads, vocab) -> ArchConfig:
    return ArchConfig(
        name=f"zoo-{layers}x{d}", family="dense", n_layers=layers,
        d_model=d, n_heads=heads, n_kv_heads=heads, d_ff=4 * d,
        vocab=vocab, head_dim=d // heads, remat="none", dtype="float32")


def build_zoo(vocab: int = 64, seq_len: int = 32, seed: int = 0,
              ladder=_LADDER, kgram: int = 2, *,
              device: str | torch.device = "cuda") -> dict[str, ServingEngine]:
    """Train the ladder on ``device`` ("cuda" unless the caller asks for
    "cpu") and return name -> `ServingEngine`."""
    dev = resolve_device(device)
    engines: dict[str, ServingEngine] = {}
    for name, layers, d, heads, steps, price in ladder:
        cfg = _cfg(layers, d, heads, vocab)
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = TrainModel(cfg, device=dev).init(gen)
        data = MarkovLMData(DataConfig(vocab=vocab, seq_len=seq_len,
                                       batch=16, seed=seed, kgram=kgram))
        init_state, step_fn = make_train_step(
            model, TrainConfig(opt=OptConfig(peak_lr=5e-3, warmup_steps=10,
                                             total_steps=steps)))
        params = model.params()
        state = init_state(params)
        for _ in range(steps):
            params, state, _ = step_fn(params, state, data.next_batch())
        served = params_from_jax(cfg, params_to_numpy(model), device=dev)
        engines[name] = ServingEngine(name, served, price_per_1k=price,
                                      device=dev)
    return engines


def sequence_accuracy(engine: ServingEngine, data: MarkovLMData,
                      n: int = 32, horizon: int = 8) -> float:
    """Teacher-forced next-token top-1 accuracy over ``n`` fresh sequences
    -- the ground-truth metric the end-to-end workflow's stages are scored
    on."""
    batch = data.next_batch()
    toks = batch["tokens"][:n]
    labels = batch["labels"][:n]
    model = engine.model
    x = model.forward(torch.as_tensor(toks, device=model.device).long())
    pred = (x @ model.unembed_matrix()).argmax(-1).cpu().numpy()
    return float((pred == labels).mean())
