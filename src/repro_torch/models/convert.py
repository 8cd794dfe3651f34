"""Carry `repro`'s model weights into the port.

`params_from_jax` takes the pytree of `repro.models.transformer.Model.init`
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``: no
JAX type crosses over) and loads it into a port `Model`.  `repro` stacks
each per-layer weight on a leading layer axis; the port holds one module
per layer, so layer ``i`` takes slice ``i`` of every stacked array.  The
SSM and hybrid trees carry ``layers.norm`` and ``layers.mamba.*``, and the
hybrid's ``shared_attn`` (``norm``, ``attn``, ``mlp_norm``, ``mlp``).
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
    unembed, the stacked ``layers`` and, for the hybrid, ``shared_attn``),
    each weight in the dtype the port keeps it in (see `Model`)."""
    model = Model(cfg, device=device)
    _load(model.embed, params["embed"])
    _load(model.final_norm, params["final_norm"])
    _load(model.unembed, params["unembed"])
    lp = params["layers"]
    for i, blk in enumerate(model.layers):
        if cfg.family == "dense":
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
    """Load ``blk.attn`` and ``blk.mlp`` from `repro`'s dicts, taking slice
    ``i`` of each stacked array (``None``: the arrays are unstacked)."""
    for src, mod, names in ((attn, blk.attn, ("wq", "wk", "wv", "wo")),
                            (mlp, blk.mlp, ("w1", "w3", "w2"))):
        for name in names:
            a = src[name] if i is None else src[name][i]
            _load(getattr(mod, name), a)
