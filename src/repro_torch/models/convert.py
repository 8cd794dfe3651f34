"""Carry model weights between `repro` and the port.

`params_from_jax` takes the pytree of `repro`'s ``build_model(cfg).init``
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``: no
JAX type crosses over) and loads it into the port's model of ``cfg``
(`build_model`): a serving `Model` / `EncDecModel`, or with ``train`` a
`TrainModel` / `TrainEncDecModel`.  `repro` stacks each per-layer weight
on a leading layer axis (``layers``; the encoder-decoder's
``enc_layers`` and ``dec_layers``).  A serving model holds one module
per layer, so layer ``i`` takes slice ``i`` of every stacked array, leaf
by leaf under the module's own parameter names, which are `repro`'s keys
(``attn@wq``, ``mlp@dense@w1``, ``mamba@A_log``, ``self_attn@wq``,
``cross_norm``, ...); the hybrid's ``shared_attn`` is unstacked, and the
top-level leaves (``embed``, ``final_norm``, ``unembed`` unless the
embeddings are tied, the VLM's ``patch_proj``, the encoder's
``enc_norm``) are the model's own.  A training form keeps `repro`'s
stacked leaves as its float32 masters.

`params_to_numpy` goes back: any form to `repro`'s stacked tree of
float32 numpy arrays, under `repro`'s keys.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import build_model

STACKS = ("layers", "enc_layers", "dec_layers")


def _load(dst: torch.Tensor, src) -> None:
    a = np.asarray(src)
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"weight of shape {a.shape} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))


def _leaf(tree: dict, key: str):
    for part in key.split("@"):
        tree = tree[part]
    return tree


def _stacks(model):
    """(name, module list) of each stack of layers ``model`` holds."""
    return [(s, getattr(model, s)) for s in STACKS if hasattr(model, s)]


@torch.no_grad()
def params_from_jax(cfg: ArchConfig, params: dict, *,
                    device: str | torch.device = "cuda",
                    train: bool = False):
    """The port's model of ``cfg`` on ``device`` (with ``train``, its
    training form) holding ``params``.  The serving form keeps each weight
    in its own dtype (see `Model`); the training form keeps every leaf in
    float32, as `repro` does."""
    model = build_model(cfg, device=device, train=train)
    if train:
        for key, p in model.masters.items():
            _load(p, _leaf(params, key))
        return model
    for name, p in model.named_parameters(recurse=False):
        _load(p, params[name])
    for stack, blocks in _stacks(model):
        for i, blk in enumerate(blocks):
            for name, p in blk.named_parameters():
                _load(p, _leaf(params[stack], name.replace(".", "@"))[i])
    if getattr(model, "shared_attn", None) is not None:
        for name, p in model.shared_attn.named_parameters():
            _load(p, _leaf(params["shared_attn"], name.replace(".", "@")))
    return model


def _numpy(t: torch.Tensor) -> np.ndarray:
    return np.array(t.detach().float().cpu())  # a copy, not a view


def params_to_numpy(model) -> dict:
    """``model``'s weights (any form) as `repro`'s parameter tree: nested
    dicts of float32 numpy arrays, each per-layer weight stacked on a
    leading layer axis."""
    tree: dict = {}

    def put(key: str, a: np.ndarray) -> None:
        node = tree
        *path, last = key.split("@")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = a

    if hasattr(model, "masters"):
        for key, p in model.masters.items():
            put(key, _numpy(p))
        return tree
    for name, p in model.named_parameters(recurse=False):
        put(name, _numpy(p))
    for stack, blocks in _stacks(model):
        for name, _ in blocks[0].named_parameters():
            put(stack + "@" + name.replace(".", "@"), np.stack(
                [_numpy(blk.get_parameter(name)) for blk in blocks]))
    if getattr(model, "shared_attn", None) is not None:
        for name, p in model.shared_attn.named_parameters():
            put("shared_attn@" + name.replace(".", "@"), _numpy(p))
    return tree
