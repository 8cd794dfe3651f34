"""Carry model weights between `repro` and the port.

`params_from_jax` takes the pytree of `repro.models.transformer.Model.init`
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``: no
JAX type crosses over) and loads it into a port `Model` (serving) or
`TrainModel` (training).  `repro` stacks each per-layer weight on a
leading layer axis.  The serving `Model` holds one module per layer, so
layer ``i`` takes slice ``i`` of every stacked array; the `TrainModel`
keeps `repro`'s stacked leaves as its float32 masters.  Attention leaves
keep `repro`'s names (``wq`` ... ``wo``, ``bq``/``bk``/``bv`` with a QKV
bias, MLA's ``wq_a`` ... ``wo``), and so do the MoE's under ``mlp``
(``router``, the stacked (L, E, d, f) / (L, E, f, d) experts ``w1``,
``w3``, ``w2`` and the dense residual's ``dense.w1`` ...).  The SSM and hybrid trees carry
``layers.norm`` and ``layers.mamba.*``, and the hybrid's ``shared_attn``
(``norm``, ``attn``, ``mlp_norm``, ``mlp``).

`params_to_numpy` goes back: either form to `repro`'s stacked tree of
float32 numpy arrays, under `repro`'s keys.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import (Model, TrainModel,
                                            attention_decoder)


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


@torch.no_grad()
def params_from_jax(cfg: ArchConfig, params: dict, *,
                    device: str | torch.device = "cuda",
                    train: bool = False) -> Model | TrainModel:
    """A `Model` (or, with ``train``, a `TrainModel`) on ``device``
    holding ``params`` (embed, final_norm, unembed, the stacked ``layers``
    and, for the hybrid, ``shared_attn``).  The serving form keeps each
    weight in its own dtype (see `Model`); the training form keeps every
    leaf in float32, as `repro` does."""
    if train:
        model = TrainModel(cfg, device=device)
        for key, p in model.masters.items():
            _load(p, _leaf(params, key))
        return model
    model = Model(cfg, device=device)
    _load(model.embed, params["embed"])
    _load(model.final_norm, params["final_norm"])
    _load(model.unembed, params["unembed"])
    lp = params["layers"]
    for i, blk in enumerate(model.layers):
        if attention_decoder(cfg):
            _load(blk.attn_norm, lp["attn_norm"][i])
            _load(blk.mlp_norm, lp["mlp_norm"][i])
            _load_attn_mlp(blk, lp["attn"], lp["mlp"], i)
            continue
        _load(blk.norm, lp["norm"][i])
        for name, p in blk.mamba.named_parameters():
            _load(p, lp["mamba"][name][i])
    if model.shared_attn is not None:
        sa = params["shared_attn"]
        _load(model.shared_attn.norm, sa["norm"])
        _load(model.shared_attn.mlp_norm, sa["mlp_norm"])
        _load_attn_mlp(model.shared_attn, sa["attn"], sa["mlp"], None)
    return model


def _load_attn_mlp(blk, attn: dict, mlp: dict, i: int | None) -> None:
    """Load ``blk.attn`` (GQA, its QKV biases included, or MLA) and
    ``blk.mlp`` (the MLP, or the MoE with its nested ``dense``) from
    `repro`'s dicts, leaf by leaf under the module's own names, taking
    slice ``i`` of each stacked array (``None``: the arrays are
    unstacked)."""
    for src, mod in ((attn, blk.attn), (mlp, blk.mlp)):
        for name, p in mod.named_parameters():
            a = _leaf(src, name.replace(".", "@"))
            _load(p, a if i is None else a[i])


def _numpy(t: torch.Tensor) -> np.ndarray:
    return np.array(t.detach().float().cpu())  # a copy, not a view


def params_to_numpy(model: Model | TrainModel) -> dict:
    """``model``'s weights as `repro`'s parameter tree: nested dicts of
    float32 numpy arrays, each per-layer weight stacked on a leading layer
    axis."""
    tree: dict = {}

    def put(key: str, a: np.ndarray) -> None:
        node = tree
        *path, last = key.split("@")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = a

    if isinstance(model, TrainModel):
        for key, p in model.masters.items():
            put(key, _numpy(p))
        return tree
    for key in ("embed", "final_norm", "unembed"):
        put(key, _numpy(getattr(model, key)))
    for name, _ in model.layers[0].named_parameters():
        put("layers@" + name.replace(".", "@"), np.stack(
            [_numpy(blk.get_parameter(name)) for blk in model.layers]))
    if model.shared_attn is not None:
        for name, p in model.shared_attn.named_parameters():
            put("shared_attn@" + name.replace(".", "@"), _numpy(p))
    return tree
