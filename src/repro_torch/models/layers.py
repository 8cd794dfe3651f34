"""Dense decoder blocks of the port (`repro.models.layers` counterpart).

The dense subset only: RMSNorm, rotary embeddings, GQA attention (full
sequence and one-token decode against a KV cache) and the SwiGLU MLP.
Weights keep `repro`'s layout, ``(in, out)`` matrices applied as
``x @ w``, so `models.convert` copies them without transposes.  The
attention cores and every RMSNorm go through `kernels.ops`, which runs the
CUDA kernels on a CUDA tensor and the plain versions on a CPU tensor; the
projections, rope and SiLU stay torch ops, as `repro` left them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm over the last axis (float32 math, cast back to ``x``'s dtype)."""
    return ops.rms_norm(x, scale)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` (..., S, H, D) at ``positions`` (..., S),
    computed in float32 and cast back (half-split layout, as `repro`)."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs         # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _dense_(w: torch.Tensor, generator: torch.Generator) -> None:
    """``N(0, 1) / sqrt(fan_in)`` in float32, as `repro`'s ``_dense_init``."""
    draw = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                       device=w.device)
    w.copy_(draw / w.shape[0] ** 0.5)


class Attention(nn.Module):
    """GQA self-attention: ``wq`` (d, H*hd), ``wk``/``wv`` (d, KV*hd),
    ``wo`` (H*hd, d)."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        if cfg.qkv_bias:
            raise NotImplementedError("qkv_bias belongs to a later family")
        self.cfg = cfg
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

        def w(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.wq, self.wk, self.wv = w(d, H * hd), w(d, KV * hd), w(d, KV * hd)
        self.wo = w(H * hd, d)

    def init(self, generator: torch.Generator) -> None:
        """Draw every projection from ``generator``."""
        for p in (self.wq, self.wk, self.wv, self.wo):
            _dense_(p, generator)

    def _qkv(self, x):
        B, S, _ = x.shape
        c = self.cfg
        q = (x @ self.wq).view(B, S, c.n_heads, c.head_dim)
        k = (x @ self.wk).view(B, S, c.n_kv_heads, c.head_dim)
        v = (x @ self.wv).view(B, S, c.n_kv_heads, c.head_dim)
        return q, k, v

    def forward(self, x, positions, *, window: int = 0):
        """Causal attention over ``x`` (B, S, d) at ``positions`` (1, S).
        Returns (y (B, S, d), (k, v)) with k/v in (B, KV, S, hd) layout."""
        B, S, _ = x.shape
        q, k, v = self._qkv(x)
        q = rope(q, positions, self.cfg.rope_theta).transpose(1, 2)
        k = rope(k, positions, self.cfg.rope_theta).transpose(1, 2)
        q, k, v = q.contiguous(), k.contiguous(), v.transpose(1, 2).contiguous()
        y = ops.attention(q, k, v, causal=True, window=window)
        y = y.transpose(1, 2).reshape(B, S, -1)
        return y @ self.wo, (k, v)

    def decode(self, x_tok, cache_k, cache_v, valid_len: int, pos: int,
               *, window: int = 0):
        """One token per sequence, ``x_tok`` (B, d), against the cache views
        ``cache_k``/``cache_v`` (B, KV, S, hd) of ``valid_len`` filled slots.

        Writes the new key and value in place at slot
        ``min(valid_len, S - 1)`` (the port updates the cache in place
        where `repro` returns a new one) and returns y (B, d)."""
        B = x_tok.shape[0]
        S = cache_k.shape[2]
        q, k, v = self._qkv(x_tok[:, None, :])
        p = torch.full((B, 1), pos, dtype=torch.int32, device=x_tok.device)
        q = rope(q, p, self.cfg.rope_theta)[:, 0]          # (B, H, hd)
        k = rope(k, p, self.cfg.rope_theta)[:, 0]          # (B, KV, hd)
        slot = min(valid_len, S - 1)
        cache_k[:, :, slot] = k
        cache_v[:, :, slot] = v[:, 0]
        lens = torch.full((B,), min(valid_len + 1, S), dtype=torch.int32,
                          device=x_tok.device)
        y = ops.decode_attention(q.contiguous(), cache_k, cache_v, lens,
                                 window=window)
        return y.reshape(B, -1) @ self.wo


class MLP(nn.Module):
    """SwiGLU: ``(silu(x @ w1) * (x @ w3)) @ w2``."""

    def __init__(self, d: int, f: int, *, device, dtype):
        super().__init__()

        def w(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.w1, self.w3, self.w2 = w(d, f), w(d, f), w(f, d)

    def init(self, generator: torch.Generator) -> None:
        """Draw every matrix from ``generator``."""
        for p in (self.w1, self.w3, self.w2):
            _dense_(p, generator)

    def forward(self, x):
        """x (..., d) -> (..., d)."""
        return (F.silu(x @ self.w1) * (x @ self.w3)) @ self.w2
