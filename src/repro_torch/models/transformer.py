"""Decoder models of the port (`repro.models.transformer.Model`).

The dense GQA family (`yi-9b`), the SSM family (`mamba2-1.3b`: a stack of
pre-norm Mamba2 blocks) and the hybrid family (`zamba2-2.7b`: Mamba2
blocks with one weight-shared attention block applied after every
``attn_every`` of them).  `repro` keeps stacked parameters and scans over
the layer axis; the port holds one `nn.Module` per layer and loops over
them, since PyTorch runs eagerly.  The weights live in the config's
compute dtype (bfloat16 for the full configs), cast once when they are
drawn or loaded where `repro` casts them at every use; the norm scales
(and Mamba's ``A_log``, ``dt_bias``) stay float32, as `repro` keeps them.

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


@dataclasses.dataclass
class SSMCache:
    """Decode cache of the SSM and hybrid families: per Mamba layer the
    conv state ``conv`` (L, B, W-1, C) in the compute dtype and the SSD
    state ``ssm`` (L, B, nh, P, N) in float32; for the hybrid, the shared
    attention's keys and values per application, ``attn_k``/``attn_v``
    (L / attn_every, B, KV, slots, hd).  ``len`` (filled attention slots)
    and ``pos`` (the next token's position) are host ints."""

    conv: torch.Tensor
    ssm: torch.Tensor
    attn_k: torch.Tensor | None
    attn_v: torch.Tensor | None
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

    def init(self, generator: torch.Generator) -> None:
        """Unit norms; the attention, then the MLP, drawn from
        ``generator``."""
        self.attn_norm.fill_(1.0)
        self.mlp_norm.fill_(1.0)
        self.attn.init(generator)
        self.mlp.init(generator)


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 layer: ``x + mamba(rms_norm(x, norm))``."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        self.norm = nn.Parameter(torch.ones(cfg.d_model, device=device),
                                 requires_grad=False)
        self.mamba = L.Mamba(cfg, device=device, dtype=dtype)

    def init(self, generator: torch.Generator) -> None:
        """A unit norm; the Mamba block drawn from ``generator``."""
        self.norm.fill_(1.0)
        self.mamba.init(generator)


class SharedAttnBlock(nn.Module):
    """The hybrid's weight-shared attention block (`repro`'s
    ``shared_attn``): pre-norm attention, then the SwiGLU MLP."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.norm = nn.Parameter(torch.ones(d, device=device),
                                 requires_grad=False)
        self.attn = L.Attention(cfg, device=device, dtype=dtype)
        self.mlp_norm = nn.Parameter(torch.ones(d, device=device),
                                     requires_grad=False)
        self.mlp = L.MLP(d, cfg.d_ff, device=device, dtype=dtype)

    def init(self, generator: torch.Generator) -> None:
        """Unit norms; the attention, then the MLP, drawn from
        ``generator``."""
        self.norm.fill_(1.0)
        self.mlp_norm.fill_(1.0)
        self.attn.init(generator)
        self.mlp.init(generator)

    def forward(self, x, positions, *, window: int):
        """x (B, S, d) -> (x (B, S, d), (k, v) (B, KV, S, hd))."""
        a, kv = self.attn(L.rms_norm(x, self.norm), positions, window=window)
        x = x + a
        return x + self.mlp(L.rms_norm(x, self.mlp_norm)), kv

    def decode(self, x, cache_k, cache_v, valid_len: int, pos: int, *,
               window: int):
        """x (B, d) against one application's cache views -> x (B, d)."""
        x = x + self.attn.decode(L.rms_norm(x, self.norm), cache_k, cache_v,
                                 valid_len, pos, window=window)
        return x + self.mlp(L.rms_norm(x, self.mlp_norm))


class Model(nn.Module):
    """Decoder-only model of the dense GQA, SSM or hybrid family on
    ``device`` ("cuda" unless the caller asks for "cpu").  Construction
    allocates the weights; `init` draws them,
    `models.convert.params_from_jax` loads `repro`'s."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.family not in ("dense", "ssm", "hybrid") or \
                cfg.attn_kind != "gqa" or cfg.moe is not None or \
                cfg.vlm is not None or cfg.encdec is not None:
            raise NotImplementedError(
                f"{cfg.name}: the port carries the dense GQA, SSM and hybrid "
                f"families only")
        if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid.attn_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not group"
                             f" by attn_every {cfg.hybrid.attn_every}")
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
        layer = Block if cfg.family == "dense" else MambaBlock
        self.layers = nn.ModuleList(
            layer(cfg, device=dev, dtype=dt) for _ in range(cfg.n_layers))
        self.shared_attn = (SharedAttnBlock(cfg, device=dev, dtype=dt)
                            if cfg.family == "hybrid" else None)

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
            blk.init(generator)
        if self.shared_attn is not None:
            self.shared_attn.init(generator)
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

    def _layers_fwd(self, x, cache: KVCache | SSMCache | None = None):
        if self.cfg.family != "dense":
            return self._ssm_layers_fwd(x, cache)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for i, blk in enumerate(self.layers):
            a, (k, v) = blk.attn(L.rms_norm(x, blk.attn_norm), positions)
            if cache is not None:
                cache.k[i, :, :, : k.shape[2]] = k
                cache.v[i, :, :, : v.shape[2]] = v
            x = x + a
            x = x + blk.mlp(L.rms_norm(x, blk.mlp_norm))
        return x

    def _ssm_layers_fwd(self, x, cache: SSMCache | None):
        """The Mamba stack over x (B, S, d), with the hybrid's shared block
        after every ``attn_every`` layers, windowed as `repro` windows it
        (``window`` only when S exceeds it).  With a cache, each layer's
        conv and SSD states and each application's last ``cache.len`` keys
        and values are written into it."""
        cfg = self.cfg
        S = x.shape[1]
        every = cfg.hybrid.attn_every if cfg.family == "hybrid" else 0
        window = cfg.hybrid.window if every and S > cfg.hybrid.window else 0
        positions = torch.arange(S, device=x.device)[None, :]
        for i, blk in enumerate(self.layers):
            h = L.rms_norm(x, blk.norm)
            if cache is None:
                x = x + blk.mamba(h)
            else:
                y, (conv, ssm) = blk.mamba(h, return_state=True)
                cache.conv[i] = conv
                cache.ssm[i] = ssm
                x = x + y
            if every and (i + 1) % every == 0:
                x, (k, v) = self.shared_attn(x, positions, window=window)
                if cache is not None:
                    kept = cache.len
                    cache.attn_k[i // every, :, :, :kept] = k[:, :, S - kept:]
                    cache.attn_v[i // every, :, :, :kept] = v[:, :, S - kept:]
        return x

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final-normed hidden states (B, S, d)."""
        x = self.embed[tokens]
        return L.rms_norm(self._layers_fwd(x), self.final_norm)

    def init_cache(self, batch_size: int, max_len: int) -> KVCache | SSMCache:
        """An empty decode cache of ``max_len`` attention slots (for the
        SSM family, which has no attention, only the recurrent states)."""
        c = self.cfg
        dt = compute_dtype(c)
        dev = self.device
        if c.family == "dense":
            shape = (c.n_layers, batch_size, c.n_kv_heads, max_len, c.head_dim)
            return KVCache(k=torch.zeros(shape, device=dev, dtype=dt),
                           v=torch.zeros(shape, device=dev, dtype=dt),
                           len=0, pos=0)
        m = self.layers[0].mamba
        conv = torch.zeros(c.n_layers, batch_size, c.ssm.conv_width - 1,
                           m.conv_ch, device=dev, dtype=dt)
        ssm = torch.zeros(c.n_layers, batch_size, m.nh, c.ssm.head_dim, m.N,
                          device=dev, dtype=torch.float32)
        ak = av = None
        if c.family == "hybrid":
            shape = (c.n_layers // c.hybrid.attn_every, batch_size,
                     c.n_kv_heads, max_len, c.head_dim)
            ak = torch.zeros(shape, device=dev, dtype=dt)
            av = torch.zeros(shape, device=dev, dtype=dt)
        return SSMCache(conv=conv, ssm=ssm, attn_k=ak, attn_v=av, len=0, pos=0)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, headroom: int = 64):
        """tokens (B, S) -> (last-position logits (B, V), cache).

        Each layer's keys and values are written straight into a cache of
        ``S + headroom`` slots, where `repro` stacks them and pads.  The
        hybrid keeps its shared block's last ``min(S, window)`` keys and
        values (plus ``headroom`` slots); the SSM and hybrid caches carry
        every Mamba layer's final conv and SSD states."""
        B, S = tokens.shape
        cfg = self.cfg
        kept = min(S, cfg.hybrid.window) if cfg.family == "hybrid" else S
        cache = self.init_cache(B, kept + headroom)
        cache.len = kept
        x = self._layers_fwd(self.embed[tokens], cache)
        cache.pos = S
        x = L.rms_norm(x[:, -1], self.final_norm)
        return self._mask_pad(x @ self.unembed_matrix()), cache

    @torch.inference_mode()
    def decode_step(self, cache: KVCache | SSMCache, tokens: torch.Tensor):
        """tokens (B,) -> (logits (B, V), cache), the cache updated in place."""
        x = self.embed[tokens]                                   # (B, d)
        if isinstance(cache, SSMCache):
            x = self._ssm_decode(cache, x)
        else:
            for i, blk in enumerate(self.layers):
                x = x + blk.attn.decode(L.rms_norm(x, blk.attn_norm),
                                        cache.k[i], cache.v[i], cache.len,
                                        cache.pos)
                x = x + blk.mlp(L.rms_norm(x, blk.mlp_norm))
            cache.len = min(cache.len + 1, cache.k.shape[3])
        cache.pos += 1
        x = L.rms_norm(x, self.final_norm)
        return self._mask_pad(x @ self.unembed_matrix()), cache

    def _ssm_decode(self, cache: SSMCache, x):
        """One token through the Mamba stack (and the hybrid's shared block,
        always windowed at decode, as in `repro`); advances ``cache.len``."""
        cfg = self.cfg
        every = cfg.hybrid.attn_every if cfg.family == "hybrid" else 0
        for i, blk in enumerate(self.layers):
            y, conv, ssm = blk.mamba.decode(L.rms_norm(x, blk.norm),
                                            cache.conv[i], cache.ssm[i])
            cache.conv[i] = conv
            cache.ssm[i] = ssm
            x = x + y
            if every and (i + 1) % every == 0:
                g = i // every
                x = self.shared_attn.decode(
                    x, cache.attn_k[g], cache.attn_v[g], cache.len, cache.pos,
                    window=cfg.hybrid.window)
        if every:
            cache.len = min(cache.len + 1, cache.attn_k.shape[3])
        else:
            cache.len += 1
        return x
