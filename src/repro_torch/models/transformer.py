"""Dense decoder model of the port (`repro.models.transformer.Model`).

Only the dense GQA family for now (`yi-9b`).  `repro` keeps stacked
parameters and scans over the layer axis; the port holds one
`nn.Module` per layer and loops over them, since PyTorch runs eagerly.
The weights live in the config's compute dtype (bfloat16 for `yi-9b`),
cast once when they are drawn or loaded where `repro` casts them at every
use; the norm scales stay float32, as `repro` keeps them.

- ``forward``      : full-sequence hidden states
- ``prefill``      : last-position logits and the decode cache
- ``decode_step``  : one token per sequence against the cache
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """The dtype activations and weights are kept in."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass
class KVCache:
    """Decode cache: ``k``/``v`` (L, B, KV, S, hd) and the number of filled
    slots (``len``) and the next token's position (``pos``) as host ints."""

    k: torch.Tensor
    v: torch.Tensor
    len: int
    pos: int


class Block(nn.Module):
    """Pre-norm decoder layer: attention, then the SwiGLU MLP."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = nn.Parameter(
            torch.ones(d, device=device), requires_grad=False)
        self.mlp_norm = nn.Parameter(
            torch.ones(d, device=device), requires_grad=False)
        self.attn = L.Attention(cfg, device=device, dtype=dtype)
        self.mlp = L.MLP(d, cfg.d_ff, device=device, dtype=dtype)


class Model(nn.Module):
    """Dense decoder-only transformer on ``device`` ("cuda" unless the
    caller asks for "cpu").  Construction allocates the weights; `init`
    draws them, `models.convert.params_from_jax` loads `repro`'s."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.family != "dense" or cfg.attn_kind != "gqa" or cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: the port carries the dense GQA family only")
        if cfg.tie_embeddings:
            raise NotImplementedError("tied embeddings are not ported yet")
        self.cfg = cfg
        dev = resolve_device(device)
        dt = compute_dtype(cfg)
        d, Vp = cfg.d_model, cfg.padded_vocab
        self.embed = nn.Parameter(torch.empty(Vp, d, device=dev, dtype=dt),
                                  requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones(d, device=dev),
                                       requires_grad=False)
        self.unembed = nn.Parameter(torch.empty(d, Vp, device=dev, dtype=dt),
                                    requires_grad=False)
        self.layers = nn.ModuleList(
            Block(cfg, device=dev, dtype=dt) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        """The device the weights lie on."""
        return self.embed.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw the weights from ``generator`` (a `torch.Generator` on the
        model's device) with `repro`'s distributions: ``0.02 N(0, 1)`` for
        the embedding, ``N(0, 1) / sqrt(fan_in)`` for every matrix, ones for
        the norms.  The draws differ from `repro`'s (another generator)."""
        self.embed.copy_(0.02 * torch.randn(
            self.embed.shape, generator=generator, device=self.device))
        L._dense_(self.unembed, generator)
        for blk in self.layers:
            blk.attn_norm.fill_(1.0)
            blk.mlp_norm.fill_(1.0)
            blk.attn.init(generator)
            blk.mlp.init(generator)
        self.final_norm.fill_(1.0)
        return self

    def unembed_matrix(self) -> torch.Tensor:
        """(d, V) output projection."""
        return self.unembed

    def _mask_pad(self, logits):
        V = self.cfg.vocab
        if logits.shape[-1] == V:
            return logits
        col = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(col < V, logits, torch.tensor(
            -1e30, dtype=logits.dtype, device=logits.device))

    def _layers_fwd(self, x, cache: KVCache | None = None):
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for i, blk in enumerate(self.layers):
            a, (k, v) = blk.attn(L.rms_norm(x, blk.attn_norm), positions)
            if cache is not None:
                cache.k[i, :, :, : k.shape[2]] = k
                cache.v[i, :, :, : v.shape[2]] = v
            x = x + a
            x = x + blk.mlp(L.rms_norm(x, blk.mlp_norm))
        return x

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final-normed hidden states (B, S, d)."""
        x = self.embed[tokens]
        return L.rms_norm(self._layers_fwd(x), self.final_norm)

    def init_cache(self, batch_size: int, max_len: int) -> KVCache:
        """An empty decode cache of ``max_len`` slots."""
        c = self.cfg
        shape = (c.n_layers, batch_size, c.n_kv_heads, max_len, c.head_dim)
        dt = compute_dtype(c)
        return KVCache(k=torch.zeros(shape, device=self.device, dtype=dt),
                       v=torch.zeros(shape, device=self.device, dtype=dt),
                       len=0, pos=0)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, headroom: int = 64):
        """tokens (B, S) -> (last-position logits (B, V), cache).

        Each layer's keys and values are written straight into a cache of
        ``S + headroom`` slots, where `repro` stacks them and pads."""
        B, S = tokens.shape
        cache = self.init_cache(B, S + headroom)
        x = self._layers_fwd(self.embed[tokens], cache)
        cache.len = cache.pos = S
        x = L.rms_norm(x[:, -1], self.final_norm)
        return self._mask_pad(x @ self.unembed_matrix()), cache

    @torch.inference_mode()
    def decode_step(self, cache: KVCache, tokens: torch.Tensor):
        """tokens (B,) -> (logits (B, V), cache), the cache updated in place."""
        x = self.embed[tokens]                                   # (B, d)
        for i, blk in enumerate(self.layers):
            x = x + blk.attn.decode(L.rms_norm(x, blk.attn_norm), cache.k[i],
                                    cache.v[i], cache.len, cache.pos)
            x = x + blk.mlp(L.rms_norm(x, blk.mlp_norm))
        cache.len = min(cache.len + 1, cache.k.shape[3])
        cache.pos += 1
        x = L.rms_norm(x, self.final_norm)
        return self._mask_pad(x @ self.unembed_matrix()), cache
