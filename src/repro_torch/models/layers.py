"""Model blocks of the port (`repro.models.layers` counterpart).

RMSNorm, rotary embeddings, GQA attention with an optional QKV bias (full
sequence, causal or not, self or cross, and one-token decode against a KV
cache or an encoder's keys and values), multi-head latent
attention (MLA: the flash kernel at prefill, `repro`'s absorbed form in
plain PyTorch at decode), the SwiGLU MLP, the token-choice MoE (`route`,
`MoE`) and the Mamba2 (SSD) block.
The activations carry `repro`'s logical sharding sites
(`dist.act_sharding.constrain`, ``x`` itself unless a dry run maps them)
where `repro` puts them, in its order.
Weights keep `repro`'s layout, ``(in, out)`` matrices applied as
``x @ w``, so `models.convert` copies them without transposes.  The
attention cores, the SSD scan and every RMSNorm go through `kernels.ops`,
which runs the CUDA kernels on a CUDA tensor and the plain versions on a
CPU tensor; the projections, rope, the MoE's routing and expert products,
the depthwise convolution and SiLU stay torch ops, as `repro` left them to
XLA.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.act_sharding import constrain
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
    """``N(0, 1) / sqrt(fan_in)`` in float32, as `repro`'s ``_dense_init``,
    for ``w`` of shape (..., in, out): the fan-in is the input axis, never
    a leading stack axis (the MoE's (E, d, f) experts divide by d, as
    ``in_axis=1`` does in `repro`), and a stacked ``w`` is drawn one
    (in, out) matrix at a time, so no float32 temporary is larger than
    one of them."""
    if w.dim() > 2:
        for m in w:
            _dense_(m, generator)
        return
    draw = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                       device=w.device)
    w.copy_(draw / w.shape[0] ** 0.5)


def _weight(device, dtype):
    """A maker of frozen, uninitialised weights of ``dtype`` on ``device``."""

    def w(*shape, dt=dtype):
        return nn.Parameter(torch.empty(shape, device=device, dtype=dt),
                            requires_grad=False)

    return w


class Attention(nn.Module):
    """GQA attention, self or cross: ``wq`` (d, H*hd), ``wk``/``wv`` (d,
    KV*hd), ``wo`` (H*hd, d), and with ``cfg.qkv_bias`` the biases ``bq``
    (H*hd,), ``bk``/``bv`` (KV*hd,), zero at init and added after the
    projections in the compute dtype, as `repro`'s ``_qkv`` adds them."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        w = _weight(device, dtype)
        self.wq, self.wk, self.wv = w(d, H * hd), w(d, KV * hd), w(d, KV * hd)
        self.wo = w(H * hd, d)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = w(H * hd), w(KV * hd), w(KV * hd)

    def init(self, generator: torch.Generator) -> None:
        """Draw every projection from ``generator``; zero biases."""
        for p in (self.wq, self.wk, self.wv, self.wo):
            _dense_(p, generator)
        if self.cfg.qkv_bias:
            for p in (self.bq, self.bk, self.bv):
                p.zero_()

    def _proj(self, x, name: str, heads: int):
        """``x`` (B, S, d) through ``w<name>`` (and its bias) -> (B, S,
        heads, hd)."""
        B, S, _ = x.shape
        y = x @ getattr(self, "w" + name)
        if self.cfg.qkv_bias:
            y = y + getattr(self, "b" + name)
        return y.view(B, S, heads, self.cfg.head_dim)

    def _qkv(self, x):
        c = self.cfg
        return (constrain(self._proj(x, "q", c.n_heads), "dp", None, "tp",
                          None),
                constrain(self._proj(x, "k", c.n_kv_heads), "dp", None, "tp",
                          None),
                constrain(self._proj(x, "v", c.n_kv_heads), "dp", None, "tp",
                          None))

    def forward(self, x, positions, *, causal: bool = True, window: int = 0,
                kv_override=None):
        """Attention over ``x`` (B, S, d) at ``positions`` (1, S), causal
        unless ``causal`` is False.  ``kv_override=(k, v)``, each (B, KV, T,
        hd), is cross attention: those keys and values (precomputed, no
        rope) in place of ``x``'s, and no rope on q either.  Returns (y (B,
        S, d), (k, v)) with k/v in (B, KV, S, hd) layout."""
        B, S, _ = x.shape
        if kv_override is not None:
            k, v = kv_override
            q = constrain(self._proj(x, "q", self.cfg.n_heads), "dp", None,
                          "tp", None).transpose(1, 2)
        else:
            q, k, v = self._qkv(x)
            q = rope(q, positions, self.cfg.rope_theta).transpose(1, 2)
            k = rope(k, positions, self.cfg.rope_theta).transpose(1, 2)
            k, v = k.contiguous(), v.transpose(1, 2).contiguous()
        y = ops.attention(q.contiguous(), k, v, causal=causal, window=window)
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

    def decode_cross(self, x_tok, xk, xv):
        """One token per sequence, ``x_tok`` (B, d), attending to all of
        the encoder's keys and values ``xk``/``xv`` (B, KV, T, hd): every
        length is T, the cache's capacity.  The query takes no rope and no
        bias, as in `repro`'s ``EncDecModel.decode_step``.  Returns y (B,
        d)."""
        B = x_tok.shape[0]
        q = (x_tok @ self.wq).view(B, self.cfg.n_heads, self.cfg.head_dim)
        lens = torch.full((B,), xk.shape[2], dtype=torch.int32,
                          device=x_tok.device)
        return ops.decode_attention(q, xk, xv, lens).reshape(B, -1) @ self.wo


class MLA(nn.Module):
    """Multi-head latent attention (`repro`'s ``init_mla``, ``mla_forward``,
    ``mla_decode``), with `repro`'s leaves: ``wq_a`` (d, q_lora_rank),
    ``q_norm`` (q_lora_rank,), ``wq_b`` (q_lora_rank, H (dn + dr)),
    ``wkv_a`` (d, kv_lora_rank + dr), ``kv_norm`` (kv_lora_rank,),
    ``wkv_b`` (kv_lora_rank, H (dn + dv)), ``wo`` (H dv, d), where dn, dr
    and dv are the no-rope and rope query/key head dims and the value head
    dim.  The norm scales stay float32, like the port's other norms.

    The prefill runs the flash kernel at head dim dn + dr with v padded
    from dv to dn + dr and keeps the first dv columns, as `repro` pads it.
    Decode is `repro`'s absorbed form: ``W_uk`` folded into the query and
    ``W_uv`` into the output, scores against the latent cache in float32.
    `repro` has no kernel there, so it stays plain PyTorch on every
    device."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
        self.dn, self.dr, self.dv = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                                     m.v_head_dim)
        self.kvr = m.kv_lora_rank
        w = _weight(device, dtype)
        f32 = torch.float32
        self.wq_a = w(d, m.q_lora_rank)
        self.q_norm = w(m.q_lora_rank, dt=f32)
        self.wq_b = w(m.q_lora_rank, H * (self.dn + self.dr))
        self.wkv_a = w(d, self.kvr + self.dr)
        self.kv_norm = w(self.kvr, dt=f32)
        self.wkv_b = w(self.kvr, H * (self.dn + self.dv))
        self.wo = w(H * self.dv, d)

    def init(self, generator: torch.Generator) -> None:
        """Unit norms; every matrix drawn from ``generator``."""
        self.q_norm.fill_(1.0)
        self.kv_norm.fill_(1.0)
        for p in (self.wq_a, self.wq_b, self.wkv_a, self.wkv_b, self.wo):
            _dense_(p, generator)

    def _q(self, x, positions, site: bool = False):
        """(q_nope (B, S, H, dn), roped q_rope (B, S, H, dr)); ``site``:
        the full-sequence form, with `repro`'s sharding site on q."""
        B, S, _ = x.shape
        q = rms_norm(x @ self.wq_a, self.q_norm) @ self.wq_b
        q = q.view(B, S, self.cfg.n_heads, self.dn + self.dr)
        if site:
            q = constrain(q, "dp", None, "tp", None)
        return q[..., :self.dn], rope(q[..., self.dn:], positions,
                                      self.cfg.rope_theta)

    def _latent(self, x, positions, site: bool = False):
        """(normed latent c (B, S, kvr), roped shared key r (B, S, dr));
        ``site`` as in `_q`."""
        kv_a = x @ self.wkv_a
        if site:
            kv_a = constrain(kv_a, "dp", None, None)
        c = rms_norm(kv_a[..., :self.kvr].contiguous(), self.kv_norm)
        r = rope(kv_a[..., self.kvr:][:, :, None, :], positions,
                 self.cfg.rope_theta)[:, :, 0]
        return c, r

    def forward(self, x, positions):
        """Causal MLA over ``x`` (B, S, d) at ``positions`` (1, S).
        Returns (y (B, S, d), (c (B, S, kvr), r (B, S, dr))) for the latent
        cache."""
        B, S, _ = x.shape
        H, dn, dr, dv = self.cfg.n_heads, self.dn, self.dr, self.dv
        q_nope, q_rope = self._q(x, positions, site=True)
        c, r = self._latent(x, positions, site=True)
        kv = constrain((c @ self.wkv_b).view(B, S, H, dn + dv), "dp", None,
                       "tp", None)
        k = torch.cat([kv[..., :dn], r[:, :, None, :].expand(B, S, H, dr)],
                      dim=-1)
        v = F.pad(kv[..., dn:], (0, dn + dr - dv))
        q = torch.cat([q_nope, q_rope], dim=-1)
        y = ops.attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(),
                          causal=True)[..., :dv]
        y = y.transpose(1, 2).reshape(B, S, H * dv)
        return y @ self.wo, (c, r)

    def decode(self, x_tok, cache_c, cache_r, valid_len: int, pos: int):
        """One token per sequence, ``x_tok`` (B, d), against the latent
        cache views ``cache_c`` (B, S, kvr) and ``cache_r`` (B, S, dr) of
        ``valid_len`` filled slots: writes the new entries in place at slot
        ``min(valid_len, S - 1)`` and returns y (B, d)."""
        B = x_tok.shape[0]
        S = cache_c.shape[1]
        H, dn, dv = self.cfg.n_heads, self.dn, self.dv
        p = torch.full((B, 1), pos, dtype=torch.int32, device=x_tok.device)
        q_nope, q_rope = self._q(x_tok[:, None, :], p)
        c_new, r_new = self._latent(x_tok[:, None, :], p)
        slot = min(valid_len, S - 1)
        cache_c[:, slot] = c_new[:, 0]
        cache_r[:, slot] = r_new[:, 0]
        wkv_b = self.wkv_b.view(self.kvr, H, dn + dv)
        w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
        q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
        cf = cache_c.float()
        scores = torch.einsum("bhr,btr->bht", q_c.float(), cf)
        scores = scores + torch.einsum("bhd,btd->bht", q_rope[:, 0].float(),
                                       cache_r.float())
        n = min(valid_len + 1, S)
        valid = torch.arange(S, device=x_tok.device) < n
        scores = torch.where(valid, scores * (dn + self.dr) ** -0.5, -1e30)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bht,btr->bhr", probs, cf).to(x_tok.dtype)
        y = torch.einsum("bhr,rhd->bhd", ctx, w_uv)
        return y.reshape(B, H * dv) @ self.wo


class MLP(nn.Module):
    """SwiGLU: ``(silu(x @ w1) * (x @ w3)) @ w2``."""

    def __init__(self, d: int, f: int, *, device, dtype):
        super().__init__()
        w = _weight(device, dtype)
        self.w1, self.w3, self.w2 = w(d, f), w(d, f), w(f, d)

    def init(self, generator: torch.Generator) -> None:
        """Draw every matrix from ``generator``."""
        for p in (self.w1, self.w3, self.w2):
            _dense_(p, generator)

    def forward(self, x):
        """x (..., d) -> (..., d)."""
        h = F.silu(x @ self.w1) * (x @ self.w3)
        h = constrain(h, *(("dp",) + (None,) * (h.ndim - 2) + ("tp",)))
        return h @ self.w2


@dataclasses.dataclass
class Routing:
    """One MoE layer's routing of R = nG G rows (T tokens padded with zero
    rows to whole groups of G): ``gates`` (nG, G, E) float32, the top-K
    experts ``topi`` (nG, G, K) (ties to the lowest index) with their
    weights ``topv`` (nG, G, K) renormalised over the K, each choice's
    capacity slot ``pos`` (nG, G, K) in its group and expert, ``keep`` =
    ``pos < C``, and the layer's load-balancing ``aux`` loss."""

    gates: torch.Tensor
    topi: torch.Tensor
    topv: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    C: int
    aux: torch.Tensor


def moe_groups(T: int, moe, no_drop: bool) -> tuple[int, int, int]:
    """(G, nG, C) of `repro`'s ``moe_forward`` for T tokens: groups of G =
    min(expert_group, T) rows, T padded to nG G, and C slots an expert a
    group (G with ``no_drop``, else ceil(G / E K capacity_factor), at
    least 1)."""
    G = min(moe.expert_group, T)
    nG = -(-T // G)
    C = G if no_drop else max(1, int(math.ceil(
        G / moe.n_experts * moe.top_k * moe.capacity_factor)))
    return G, nG, C


def route(gates: torch.Tensor, K: int, C: int) -> Routing:
    """`repro`'s routing of ``gates`` (nG, G, E) float32, step by step: the
    K largest gates of each row, ties to the lowest expert index (a stable
    descending sort; ``jax.lax.top_k``'s order, which ``torch.topk`` does
    not promise), renormalised by their sum (floored at 1e-9); capacity
    slots assigned rank-major (every first choice in row order, then every
    second, ...), each expert's count growing by every row that chose it,
    kept or not; and the Switch aux loss ``E sum(mean gates * mean
    one_hot(top-1))`` over every row, pad rows included.  Nothing in it is
    random or depends on launch order, so a recomputation routes as the
    first pass did."""
    nG, G, E = gates.shape
    topi = torch.sort(gates.detach(), dim=-1, descending=True,
                      stable=True).indices[..., :K]
    topv = gates.gather(-1, topi)
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    # rank-major: the choices in the order (rank, row), so one running
    # count an expert gives each choice the slots every earlier choice took
    order = topi.transpose(1, 2).reshape(nG, K * G, 1)
    oh = F.one_hot(order[..., 0], E)                        # (nG, K G, E)
    pos = (oh.cumsum(1) - oh).gather(-1, order).view(nG, K, G).transpose(1, 2)
    load = F.one_hot(topi[..., 0], E).float().mean((0, 1))
    aux = E * (gates.mean((0, 1)) * load).sum()
    return Routing(gates, topi, topv, pos, pos < C, C, aux)


class MoE(nn.Module):
    """Token-choice top-K mixture of SwiGLU experts with per-group
    capacity (`repro`'s ``init_moe`` / ``moe_forward``), with `repro`'s
    leaves: ``router`` (d, E), ``w1``/``w3`` (E, d, f), ``w2`` (E, f, d)
    and, with ``dense_residual``, a ``dense`` `MLP` of width
    ``dense_d_ff`` added on the layer's input.

    `repro` dispatches through dense (G, E, C) one-hot einsums; the port
    computes the same sums from indices.  Where the rows' K choices are at
    least E (a prefill, a training batch), each expert's C slots of a
    group gather their rows into an (E, nG C, d) batch for `torch.bmm` and
    each kept choice gathers its slot's output; where they are fewer (a
    decode step), each choice's row meets its expert's weights, gathered,
    so a step reads only the K routed experts where `repro`'s einsum reads
    all E (the others' terms are exact zeros).  The combine weights are
    rounded to the compute dtype, as ``combine.astype(xg.dtype)`` rounds
    them, and the K terms of a row summed in float32."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        mo = cfg.moe
        self.cfg = cfg
        d, f, E = cfg.d_model, cfg.d_ff, mo.n_experts
        w = _weight(device, dtype)
        self.router = w(d, E)
        self.w1, self.w3, self.w2 = w(E, d, f), w(E, d, f), w(E, f, d)
        self.dense = (MLP(d, mo.dense_d_ff or f, device=device, dtype=dtype)
                      if mo.dense_residual else None)

    def init(self, generator: torch.Generator) -> None:
        """Draw the router, each expert (fan-in d for ``w1``/``w3``, f for
        ``w2``, one expert at a time) and the dense residual from
        ``generator``."""
        for p in (self.router, self.w1, self.w3, self.w2):
            _dense_(p, generator)
        if self.dense is not None:
            self.dense.init(generator)

    def _rows(self, x: torch.Tensor, no_drop: bool):
        """(x as R = nG G rows, zero-padded, (G, nG, C))."""
        xt = x.reshape(-1, x.shape[-1])
        T = xt.shape[0]
        G, nG, C = moe_groups(T, self.cfg.moe, no_drop)
        if nG * G > T:
            xt = F.pad(xt, (0, 0, 0, nG * G - T))
        return xt, (G, nG, C)

    def route(self, x: torch.Tensor, no_drop: bool = False) -> Routing:
        """The routing of ``x`` (..., d), its leading axes flattened to T
        tokens."""
        xt, (G, nG, C) = self._rows(x, no_drop)
        return self._route_rows(xt, G, nG, C)

    def _route_rows(self, xt, G, nG, C) -> Routing:
        """Gates a float32 softmax of the router logits, which are computed
        in the compute dtype and then cast, as in `repro`."""
        logits = (xt @ self.router).float().view(nG, G, -1)
        return route(torch.softmax(logits, dim=-1), self.cfg.moe.top_k, C)

    def forward(self, x: torch.Tensor, no_drop: bool = False):
        """x (..., d) -> (y (..., d), aux): ``no_drop`` (decode) gives every
        expert a group's G slots, so no choice is dropped."""
        xt, (G, nG, C) = self._rows(x, no_drop)
        r = self._route_rows(xt, G, nG, C)
        E, K = self.cfg.moe.n_experts, self.cfg.moe.top_k
        R = xt.shape[0]
        expert = r.topi.reshape(R, K)
        if R * K < E:
            eo = _experts_by_choice(xt, expert, self.w1, self.w3, self.w2)
        else:
            eo = _experts_by_slot(xt, expert, r.pos.reshape(R, K),
                                  r.keep.reshape(R, K), nG, C,
                                  self.w1, self.w3, self.w2)
        wgt = torch.where(r.keep, r.topv, 0.0).reshape(R, K)
        y = (wgt.to(xt.dtype).float()[..., None] * eo.float()).sum(1)
        y = y.to(x.dtype)[:math.prod(x.shape[:-1])].view(x.shape)
        if self.dense is not None:
            y = y + self.dense(x)
        return y, r.aux


def _swiglu(x, w1, w3, w2):
    return torch.bmm(F.silu(torch.bmm(x, w1)) * torch.bmm(x, w3), w2)


def _experts_by_choice(xt, expert, w1, w3, w2):
    """(R, K, d): each row's K choices through their experts, one
    (1, d) row against its expert's gathered weights a choice."""
    R, K = expert.shape
    idx = expert.reshape(-1)
    x = xt.repeat_interleave(K, 0)[:, None, :]
    return _swiglu(x, w1[idx], w3[idx], w2[idx]).view(R, K, -1)


def _experts_by_slot(xt, expert, pos, keep, nG, C, w1, w3, w2):
    """(R, K, d): every expert's nG C slots as one (E, nG C, d) batch (an
    empty slot takes row 0; its output is never read), then each choice's
    slot output (a dropped choice reads slot 0 of its expert and is
    weighted 0)."""
    R, K = expert.shape
    E = w1.shape[0]
    G = R // nG
    cap = nG * C
    group = (torch.arange(R, device=xt.device) // G)[:, None]
    flat = expert * cap + group * C + torch.where(keep, pos, 0)
    # each kept choice writes its row into its own slot; a dropped one
    # into one spare slot past the end, cut off (no mask-selected index:
    # the shapes stay those of the inputs, as a trace needs)
    rows = torch.zeros(E * cap + 1, dtype=torch.long, device=xt.device)
    row_ids = torch.arange(R, device=xt.device)[:, None].expand(R, K)
    rows.scatter_(0, torch.where(keep, flat, E * cap).reshape(-1),
                  row_ids.reshape(-1))
    out = _swiglu(xt[rows[:E * cap]].view(E, cap, -1), w1, w3, w2)
    return out.view(E * cap, -1)[flat]


class Mamba(nn.Module):
    """Mamba2 block with the SSD scan (`repro`'s ``init_mamba``,
    ``mamba_forward``, ``mamba_decode``), with `repro`'s parameter names and
    layouts: ``in_proj`` (d, 2 d_in + 2N + nh) splits into z, xBC and dt;
    ``conv_w`` (W, C) / ``conv_b`` (C,) is the causal depthwise convolution
    over xBC (C = d_in + 2N); ``A_log``, ``D``, ``dt_bias`` (nh,); ``norm``
    (d_in,) scales the gated RMSNorm; ``out_proj`` (d_in, d).

    ``A_log`` and ``dt_bias`` stay float32 (they enter float32 math), as
    does ``norm``, like the port's other norm scales; the rest is held in
    the compute dtype, where `repro` casts it at use."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        s = cfg.ssm
        self.cfg = cfg
        d = cfg.d_model
        self.d_in = s.expand * d
        self.nh = self.d_in // s.head_dim
        self.N = s.state_dim
        self.conv_ch = self.d_in + 2 * self.N
        w = _weight(device, dtype)
        f32 = torch.float32
        self.in_proj = w(d, 2 * self.d_in + 2 * self.N + self.nh)
        self.conv_w = w(s.conv_width, self.conv_ch)
        self.conv_b = w(self.conv_ch)
        self.A_log = w(self.nh, dt=f32)
        self.D = w(self.nh)
        self.dt_bias = w(self.nh, dt=f32)
        self.norm = w(self.d_in, dt=f32)
        self.out_proj = w(self.d_in, d)

    def init(self, generator: torch.Generator) -> None:
        """`repro`'s ``init_mamba`` distributions from ``generator``."""
        _dense_(self.in_proj, generator)
        self.conv_w.copy_(0.1 * torch.randn(
            self.conv_w.shape, generator=generator, device=self.conv_w.device))
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(
            1.0, 16.0, self.nh, device=self.A_log.device)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.fill_(1.0)
        _dense_(self.out_proj, generator)

    def _split(self, zxbcdt):
        d_in, N = self.d_in, self.N
        return (zxbcdt[..., :d_in], zxbcdt[..., d_in: 2 * d_in + 2 * N],
                zxbcdt[..., 2 * d_in + 2 * N:])

    def _ssm_inputs(self, xBC, dt_raw):
        """(x (..., nh, P), B, C, dt float32, A float32) from the activated
        convolution output and the raw step sizes."""
        d_in, N = self.d_in, self.N
        x = xBC[..., :d_in].unflatten(-1, (self.nh, self.cfg.ssm.head_dim))
        dt = F.softplus(dt_raw.float() + self.dt_bias)
        return (x, xBC[..., d_in: d_in + N], xBC[..., d_in + N:], dt,
                -torch.exp(self.A_log))

    def _gate_out(self, y, x, z):
        y = (y + x * self.D[:, None]).flatten(-2)
        return ops.rms_norm(y * F.silu(z), self.norm) @ self.out_proj

    def forward(self, u, *, return_state: bool = False):
        """u (B, S, d) -> y (B, S, d) [, (conv state (B, W-1, C), SSM state
        (B, nh, P, N) float32)].  The conv state is the last W-1
        pre-convolution inputs, zero-padded on the left for S < W-1."""
        B, S, _ = u.shape
        W = self.conv_w.shape[0]
        zxbcdt = u @ self.in_proj
        z, pre, dt_raw = self._split(zxbcdt)
        xp = F.pad(pre, (0, 0, W - 1, 0))
        conv = torch.zeros_like(pre)
        for i in range(W):     # repro's order: taps summed, then the bias
            conv = conv + xp[:, i: i + S] * self.conv_w[i]
        xBC = F.silu(conv + self.conv_b)
        x, Bm, Cm, dt, A = self._ssm_inputs(xBC, dt_raw)
        x = constrain(x, "dp", None, "tp", None)
        Bm = constrain(Bm, "dp", None, None)
        Cm = constrain(Cm, "dp", None, None)
        dt = constrain(dt, "dp", None, "tp")
        res = ops.ssd_scan(x.contiguous(), dt.contiguous(), A,
                           Bm.contiguous(), Cm.contiguous(),
                           chunk=self.cfg.ssm.chunk,
                           return_state=return_state)
        y = self._gate_out(res[0] if return_state else res, x, z)
        if not return_state:
            return y
        return y, (xp[:, S:], res[1])

    def decode(self, u_tok, conv_state, ssm_state):
        """One token per sequence, ``u_tok`` (B, d), against the conv state
        (B, W-1, C) and SSM state (B, nh, P, N) -> (y (B, d), new conv state,
        new SSM state); the caller stores the states."""
        zxbcdt = u_tok @ self.in_proj
        z, new, dt_raw = self._split(zxbcdt)
        window = torch.cat([conv_state, new[:, None, :]], dim=1)
        xBC = F.silu((window * self.conv_w[None]).sum(dim=1) + self.conv_b)
        x, Bm, Cm, dt, A = self._ssm_inputs(xBC, dt_raw)
        y, ssm_state = ops.ssd_decode_step(x, dt, A, Bm, Cm, ssm_state)
        return self._gate_out(y, x, z), window[:, 1:], ssm_state
