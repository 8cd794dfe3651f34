"""Carry `repro`'s model weights into the port.

`params_from_jax` takes the pytree of `repro.models.transformer.Model.init`
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``: no
JAX type crosses over) and loads it into a port `Model`.  `repro` stacks
each per-layer weight on a leading layer axis; the port holds one module
per layer, so layer ``i`` takes slice ``i`` of every stacked array.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import Model


def _load(dst: torch.Tensor, src) -> None:
    a = np.asarray(src)
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"weight of shape {a.shape} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))


@torch.no_grad()
def params_from_jax(cfg: ArchConfig, params: dict, *,
                    device: str | torch.device = "cuda") -> Model:
    """A `Model` on ``device`` holding ``params`` (embed, final_norm,
    unembed and the stacked ``layers``), cast to the config's compute
    dtype (the norm scales stay float32)."""
    model = Model(cfg, device=device)
    _load(model.embed, params["embed"])
    _load(model.final_norm, params["final_norm"])
    _load(model.unembed, params["unembed"])
    lp = params["layers"]
    for i, blk in enumerate(model.layers):
        _load(blk.attn_norm, lp["attn_norm"][i])
        _load(blk.mlp_norm, lp["mlp_norm"][i])
        for name in ("wq", "wk", "wv", "wo"):
            _load(getattr(blk.attn, name), lp["attn"][name][i])
        for name in ("w1", "w3", "w2"):
            _load(getattr(blk.mlp, name), lp["mlp"][name][i])
    return model
