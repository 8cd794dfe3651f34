"""Models of the port (`repro.models.transformer`: `Model`, `EncDecModel`).

The dense family (`yi-9b`, `mistral-nemo-12b`: GQA; `qwen2-72b`: GQA with
a QKV bias; `minicpm3-4b`: multi-head latent attention), the MoE family
(`granite-moe-1b-a400m`, `arctic-480b` with its dense residual: GQA
decoders whose MLP is `layers.MoE`, routed with capacity at prefill and
in training and without drops at decode, as `repro` routes), the SSM family
(`mamba2-1.3b`: a stack of pre-norm Mamba2 blocks) and the hybrid family
(`zamba2-2.7b`: Mamba2 blocks with one weight-shared attention block
applied after every ``attn_every`` of them), the VLM backbone
(`llava-next-34b`: a dense GQA decoder that projects precomputed patch
embeddings by ``patch_proj`` and prepends them to the text) and, in
`EncDecModel`, the encoder-decoder (`whisper-base`: a non-causal encoder
over precomputed audio frames, a decoder with causal self attention and
cross attention to the encoder, an unpadded vocabulary).  Tied
embeddings unembed by ``embed.T``.  `repro` keeps stacked
parameters and scans over the layer axis; the port holds one `nn.Module`
per layer and loops over them, since PyTorch runs eagerly.  The weights
live in the config's compute dtype (bfloat16 for the full configs), cast
once when they are drawn or loaded where `repro` casts them at every use;
the norm scales (and Mamba's ``A_log``, ``dt_bias``) stay float32, as
`repro` keeps them.

- ``forward``      : full-sequence hidden states
- ``prefill``      : last-position logits and the decode cache
- ``decode_step``  : one token per sequence against the cache

`TrainModel` and `TrainEncDecModel` are the training forms: float32
masters kept as `repro`'s stacked leaves, cast to the compute dtype at
each use, with ``loss`` (the chunked cross-entropy included; the MoE
layers' aux losses summed, weighted 0.01; ignore-labels over a VLM's
patches) and ``remat="full"`` as `torch.utils.checkpoint` per layer (and
per group for the hybrid).  `build_model` picks the class for a config.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.act_sharding import constrain
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
class MLACache:
    """Decode cache of the MLA family: the normed latent ``c`` (L, B, S,
    kv_lora_rank) and the roped shared key ``r`` (L, B, S,
    qk_rope_head_dim), as `repro`'s ``init_cache`` keeps them, with
    ``len`` and ``pos`` as host ints."""

    c: torch.Tensor
    r: torch.Tensor
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


@dataclasses.dataclass
class EncDecCache:
    """Decode cache of the encoder-decoder: the decoder's self-attention
    ``k``/``v`` (L, B, KV, S, hd) and the encoder's keys and values for
    each decoder layer's cross attention, ``xk``/``xv`` (L, B, KV, T, hd),
    with ``len`` (filled self-attention slots) and ``pos`` as host ints."""

    k: torch.Tensor
    v: torch.Tensor
    xk: torch.Tensor
    xv: torch.Tensor
    len: int
    pos: int


class Block(nn.Module):
    """Pre-norm decoder layer: attention (GQA, or MLA where the config
    says so), then the SwiGLU MLP, or the MoE where the config has one.
    The encoder-decoder's encoder layers are Blocks too, run non-causal."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = nn.Parameter(
            torch.ones(d, device=device), requires_grad=False)
        self.mlp_norm = nn.Parameter(
            torch.ones(d, device=device), requires_grad=False)
        attn = L.MLA if cfg.attn_kind == "mla" else L.Attention
        self.attn = attn(cfg, device=device, dtype=dtype)
        self.moe = cfg.moe is not None
        self.mlp = (L.MoE(cfg, device=device, dtype=dtype) if self.moe else
                    L.MLP(d, cfg.d_ff, device=device, dtype=dtype))

    def init(self, generator: torch.Generator) -> None:
        """Unit norms; the attention, then the MLP, drawn from
        ``generator``."""
        self.attn_norm.fill_(1.0)
        self.mlp_norm.fill_(1.0)
        self.attn.init(generator)
        self.mlp.init(generator)

    def ffn(self, h, *, no_drop: bool = False):
        """(the MLP's or the MoE's output for ``h``, the MoE's aux loss or
        None)."""
        if self.moe:
            return self.mlp(h, no_drop=no_drop)
        return self.mlp(h), None

    def forward(self, x, positions, *, causal: bool = True):
        """x (B, S, d) -> (x (B, S, d), what the cache keeps: (k, v) (B,
        KV, S, hd), or MLA's latent (c, r); the MoE's aux loss or None).
        The MoE routes with capacity here (prefill, training)."""
        h = L.rms_norm(x, self.attn_norm)
        a, kv = (self.attn(h, positions) if causal else
                 self.attn(h, positions, causal=False))
        x = x + a
        m, aux = self.ffn(L.rms_norm(x, self.mlp_norm))
        return x + m, kv, aux


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

    def forward(self, x, positions=None):
        """x (B, S, d) -> x (B, S, d) (``positions`` unused: no rope)."""
        return x + self.mamba(L.rms_norm(x, self.norm))


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


class DecoderBlock(nn.Module):
    """The encoder-decoder's decoder layer (`repro`'s ``_init_dec_layer``):
    pre-norm causal self attention, cross attention to the encoder's
    output, then the SwiGLU MLP."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        for norm in ("self_norm", "cross_norm", "mlp_norm"):
            setattr(self, norm, nn.Parameter(torch.ones(d, device=device),
                                             requires_grad=False))
        self.self_attn = L.Attention(cfg, device=device, dtype=dtype)
        self.cross_attn = L.Attention(cfg, device=device, dtype=dtype)
        self.mlp = L.MLP(d, cfg.d_ff, device=device, dtype=dtype)

    def init(self, generator: torch.Generator) -> None:
        """Unit norms; self attention, cross attention and the MLP drawn
        from ``generator``."""
        for norm in (self.self_norm, self.cross_norm, self.mlp_norm):
            norm.fill_(1.0)
        self.self_attn.init(generator)
        self.cross_attn.init(generator)
        self.mlp.init(generator)

    def cross_kv(self, enc):
        """The cross attention's keys and values of the encoder output
        ``enc`` (B, T, d): (xk, xv), each (B, KV, T, hd), no rope and no
        bias (`repro`'s ``_cross_kv``)."""
        B, T, _ = enc.shape
        c = self.cross_attn.cfg

        def proj(w):
            return (enc @ w).view(B, T, c.n_kv_heads, c.head_dim) \
                .transpose(1, 2).contiguous()

        return proj(self.cross_attn.wk), proj(self.cross_attn.wv)

    def forward(self, x, positions, enc):
        """x (B, S, d) with the encoder output ``enc`` (B, T, d) -> (x (B,
        S, d), the self attention's (k, v) (B, KV, S, hd), the cross
        attention's (xk, xv) (B, KV, T, hd))."""
        xkv = self.cross_kv(enc)
        a, kv = self.self_attn(L.rms_norm(x, self.self_norm), positions)
        x = x + a
        a, _ = self.cross_attn(L.rms_norm(x, self.cross_norm), positions,
                               causal=False, kv_override=xkv)
        x = x + a
        return x + self.mlp(L.rms_norm(x, self.mlp_norm)), kv, xkv

    def decode(self, x, cache_k, cache_v, xk, xv, valid_len: int, pos: int):
        """x (B, d) against this layer's self-attention cache views and the
        encoder's keys and values -> x (B, d)."""
        x = x + self.self_attn.decode(L.rms_norm(x, self.self_norm), cache_k,
                                      cache_v, valid_len, pos)
        x = x + self.cross_attn.decode_cross(
            L.rms_norm(x, self.cross_norm), xk, xv)
        return x + self.mlp(L.rms_norm(x, self.mlp_norm))


def _mask_pad(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """``logits`` with the columns past ``vocab`` (vocabulary padding) at
    -1e30."""
    if logits.shape[-1] == vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < vocab, logits, torch.tensor(
        -1e30, dtype=logits.dtype, device=logits.device))


def _family(cfg: ArchConfig) -> str:
    """``cfg``'s family, a MoE, VLM or encoder-decoder option counting as
    its family."""
    if cfg.moe is not None:
        return "moe"
    if cfg.vlm is not None:
        return "vlm"
    if cfg.encdec is not None:
        return "audio"
    return cfg.family


def attention_decoder(cfg: ArchConfig) -> bool:
    """Whether ``cfg`` is a decoder-only model of attention `Block`s (the
    dense, MoE and VLM families), not of Mamba layers (SSM, hybrid), nor
    an encoder-decoder."""
    return _family(cfg) in ("dense", "moe", "vlm")


def _check_ported(cfg: ArchConfig, *, encdec: bool = False) -> None:
    """Raise ValueError unless ``cfg``'s family and options fit together
    as `repro`'s do, and ``cfg`` has an encoder exactly when ``encdec``
    (the class being built is an encoder-decoder)."""
    if (cfg.encdec is not None) != encdec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: build it with EncDecModel or"
            f" build_model" if cfg.encdec is not None else
            f"{cfg.name} has no encoder: build it with Model or build_model")
    family = _family(cfg)
    if family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio") or \
            cfg.attn_kind not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: unknown family {family!r} or "
                         f"attention kind {cfg.attn_kind!r}")
    if cfg.attn_kind == "mla" and (cfg.mla is None or family != "dense"):
        raise ValueError(f"{cfg.name}: MLA needs an MLAConfig and the dense "
                         f"family")
    if family == "moe" and (cfg.moe is None or cfg.family not in
                            ("dense", "moe")):
        raise ValueError(f"{cfg.name}: the MoE family needs a MoEConfig and "
                         f"attention layers (family {cfg.family!r})")
    for fam, opt, name in (("vlm", cfg.vlm, "a VLMConfig"),
                           ("audio", cfg.encdec, "an EncDecConfig")):
        if cfg.family == fam and opt is None:
            raise ValueError(f"{cfg.name}: the {fam} family needs {name}")
    if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not group"
                         f" by attn_every {cfg.hybrid.attn_every}")


class Model(nn.Module):
    """Decoder-only model of the dense, MoE, SSM, hybrid or VLM family on
    ``device`` ("cuda" unless the caller asks for "cpu").  Construction
    allocates the weights (no ``unembed`` with tied embeddings; the VLM's
    ``patch_proj`` (patch_dim, d)); `init` draws them,
    `models.convert.params_from_jax` loads `repro`'s."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda"):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        dt = compute_dtype(cfg)
        d, Vp = cfg.d_model, cfg.padded_vocab
        w = L._weight(dev, dt)
        self.embed = w(Vp, d)
        self.final_norm = nn.Parameter(torch.ones(d, device=dev),
                                       requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = w(d, Vp)
        if cfg.vlm is not None:
            self.patch_proj = w(cfg.vlm.patch_dim, d)
        layer = Block if attention_decoder(cfg) else MambaBlock
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
        if not self.cfg.tie_embeddings:
            L._dense_(self.unembed, generator)
        if self.cfg.vlm is not None:
            L._dense_(self.patch_proj, generator)
        for blk in self.layers:
            blk.init(generator)
        if self.shared_attn is not None:
            self.shared_attn.init(generator)
        self.final_norm.fill_(1.0)
        return self

    def unembed_matrix(self) -> torch.Tensor:
        """(d, V) output projection: ``embed.T`` with tied embeddings."""
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def _mask_pad(self, logits):
        return _mask_pad(logits, self.cfg.vocab)

    def _embed(self, tokens, patch_embeds=None):
        """tokens (B, S) -> (B, S, d); with ``patch_embeds`` (B, P,
        patch_dim), a VLM's projected patches first: (B, P + S, d)."""
        x = self.embed[tokens]
        if patch_embeds is None:
            return x
        if self.cfg.vlm is None:
            raise ValueError(f"{self.cfg.name} takes no patch embeddings")
        patches = patch_embeds.to(device=x.device, dtype=x.dtype) @ \
            self.patch_proj
        return torch.cat([patches, x], dim=1)

    def _layers_fwd(self, x, cache: KVCache | MLACache | SSMCache | None =
                    None):
        if not attention_decoder(self.cfg):
            return self._ssm_layers_fwd(x, cache)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        for i, blk in enumerate(self.layers):
            x, (a, b), _ = blk(x, positions)
            if isinstance(cache, MLACache):
                cache.c[i, :, :S] = a
                cache.r[i, :, :S] = b
            elif cache is not None:
                cache.k[i, :, :, :S] = a
                cache.v[i, :, :, :S] = b
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
    def forward(self, tokens: torch.Tensor, patch_embeds=None
                ) -> torch.Tensor:
        """tokens (B, S) (and a VLM's optional ``patch_embeds`` (B, P,
        patch_dim)) -> final-normed hidden states (B, P + S, d)."""
        x = self._embed(tokens, patch_embeds)
        return L.rms_norm(self._layers_fwd(x), self.final_norm)

    def init_cache(self, batch_size: int, max_len: int
                   ) -> KVCache | MLACache | SSMCache:
        """An empty decode cache of ``max_len`` attention slots (for the
        SSM family, which has no attention, only the recurrent states)."""
        c = self.cfg
        dt = compute_dtype(c)
        dev = self.device
        if c.attn_kind == "mla":
            def latent(width):
                return torch.zeros(c.n_layers, batch_size, max_len, width,
                                   device=dev, dtype=dt)

            return MLACache(c=latent(c.mla.kv_lora_rank),
                            r=latent(c.mla.qk_rope_head_dim), len=0, pos=0)
        if attention_decoder(c):
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
    def prefill(self, tokens: torch.Tensor, patch_embeds=None,
                headroom: int = 64):
        """tokens (B, S) -> (last-position logits (B, V), cache).

        A VLM's ``patch_embeds`` (B, P, patch_dim) are projected and put
        before the text, so positions and the cache run over P + S slots;
        without them the VLM is the dense path.  Each layer's keys and
        values (MLA: its latent ``c`` and ``r``) are written straight into
        a cache of ``S + headroom`` slots (P + S with patches), where
        `repro` stacks them and pads.  The hybrid keeps its shared block's
        last ``min(S, window)`` keys and values (plus ``headroom`` slots);
        the SSM and hybrid caches carry every Mamba layer's final conv and
        SSD states."""
        x = self._embed(tokens, patch_embeds)
        B, S = x.shape[:2]
        cfg = self.cfg
        kept = min(S, cfg.hybrid.window) if cfg.family == "hybrid" else S
        cache = self.init_cache(B, kept + headroom)
        cache.len = kept
        x = self._layers_fwd(x, cache)
        cache.pos = S
        x = L.rms_norm(x[:, -1].contiguous(), self.final_norm)
        return self._mask_pad(x @ self.unembed_matrix()), cache

    @torch.inference_mode()
    def decode_step(self, cache: KVCache | MLACache | SSMCache,
                    tokens: torch.Tensor):
        """tokens (B,) -> (logits (B, V), cache), the cache updated in place."""
        x = self.embed[tokens]                                   # (B, d)
        if isinstance(cache, SSMCache):
            x = self._ssm_decode(cache, x)
        elif isinstance(cache, MLACache):
            for i, blk in enumerate(self.layers):
                x = x + blk.attn.decode(L.rms_norm(x, blk.attn_norm),
                                        cache.c[i], cache.r[i], cache.len,
                                        cache.pos)
                x = x + blk.ffn(L.rms_norm(x, blk.mlp_norm))[0]
            cache.len = min(cache.len + 1, cache.c.shape[2])
        else:
            for i, blk in enumerate(self.layers):
                x = x + blk.attn.decode(L.rms_norm(x, blk.attn_norm),
                                        cache.k[i], cache.v[i], cache.len,
                                        cache.pos)
                # the MoE routes each token without drops, as `repro`'s
                # decode does
                x = x + blk.ffn(L.rms_norm(x, blk.mlp_norm), no_drop=True)[0]
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


class EncDecModel(nn.Module):
    """The encoder-decoder (`repro`'s ``EncDecModel``: Whisper's backbone,
    its conv frontend a stub that hands in precomputed frame embeddings)
    on ``device`` ("cuda" unless the caller asks for "cpu"): encoder
    `Block`s run non-causal with rope over the frames, then ``enc_norm``;
    `DecoderBlock`s; an unpadded ``embed`` (V, d) and ``unembed`` (d, V),
    so no pad mask."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda"):
        super().__init__()
        _check_ported(cfg, encdec=True)
        self.cfg = cfg
        dev = resolve_device(device)
        dt = compute_dtype(cfg)
        d, V = cfg.d_model, cfg.vocab
        w = L._weight(dev, dt)
        self.embed, self.unembed = w(V, d), w(d, V)
        self.enc_norm = nn.Parameter(torch.ones(d, device=dev),
                                     requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones(d, device=dev),
                                       requires_grad=False)
        self.enc_layers = nn.ModuleList(
            Block(cfg, device=dev, dtype=dt)
            for _ in range(cfg.encdec.n_encoder_layers))
        self.dec_layers = nn.ModuleList(
            DecoderBlock(cfg, device=dev, dtype=dt)
            for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        """The device the weights lie on."""
        return self.embed.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDecModel":
        """Draw the weights from ``generator`` with `repro`'s distributions
        (see `Model.init`)."""
        self.embed.copy_(0.02 * torch.randn(
            self.embed.shape, generator=generator, device=self.device))
        L._dense_(self.unembed, generator)
        for blk in (*self.enc_layers, *self.dec_layers):
            blk.init(generator)
        self.enc_norm.fill_(1.0)
        self.final_norm.fill_(1.0)
        return self

    @torch.inference_mode()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, T, d) -> the encoder's output (B, T, d)."""
        x = frames.to(device=self.device, dtype=self.embed.dtype)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for blk in self.enc_layers:
            x = blk(x, positions, causal=False)[0]
        return L.rms_norm(x, self.enc_norm)

    def _decode_layers(self, enc, tokens, cache: EncDecCache | None = None):
        """The decoder over tokens (B, S) against ``enc``; with a cache,
        each layer's self-attention keys and values and its cross keys and
        values are written into it."""
        x = self.embed[tokens]
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        for i, blk in enumerate(self.dec_layers):
            x, (k, v), (xk, xv) = blk(x, positions, enc)
            if cache is not None:
                cache.k[i, :, :, :S] = k
                cache.v[i, :, :, :S] = v
                cache.xk[i] = xk
                cache.xv[i] = xv
        return x

    @torch.inference_mode()
    def forward(self, frames: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        """frames (B, T, d), tokens (B, S) -> final-normed decoder hidden
        states (B, S, d)."""
        x = self._decode_layers(self.encode(frames), tokens)
        return L.rms_norm(x, self.final_norm)

    def init_cache(self, batch_size: int, max_len: int, enc_len: int
                   ) -> EncDecCache:
        """An empty cache of ``max_len`` self-attention slots and
        ``enc_len`` encoder slots."""
        c = self.cfg

        def zeros(n):
            return torch.zeros(c.n_layers, batch_size, c.n_kv_heads, n,
                               c.head_dim, device=self.device,
                               dtype=self.embed.dtype)

        return EncDecCache(k=zeros(max_len), v=zeros(max_len),
                           xk=zeros(enc_len), xv=zeros(enc_len), len=0, pos=0)

    @torch.inference_mode()
    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor,
                headroom: int = 64):
        """Encode ``frames`` (B, T, d) and run the prompt ``tokens`` (B, S)
        -> (last-position logits (B, V), a cache of S + headroom
        self-attention slots and the T cross slots of every layer)."""
        enc = self.encode(frames)
        B, S = tokens.shape
        cache = self.init_cache(B, S + headroom, enc.shape[1])
        x = self._decode_layers(enc, tokens, cache)
        cache.len = cache.pos = S
        x = L.rms_norm(x[:, -1].contiguous(), self.final_norm)
        return x @ self.unembed, cache

    @torch.inference_mode()
    def decode_step(self, cache: EncDecCache, tokens: torch.Tensor):
        """tokens (B,) -> (logits (B, V), cache), the cache updated in
        place: self attention over the filled slots, cross attention over
        all T encoder slots of every sequence."""
        x = self.embed[tokens]
        for i, blk in enumerate(self.dec_layers):
            x = blk.decode(x, cache.k[i], cache.v[i], cache.xk[i],
                           cache.xv[i], cache.len, cache.pos)
        cache.len = min(cache.len + 1, cache.k.shape[3])
        cache.pos += 1
        return L.rms_norm(x, self.final_norm) @ self.unembed, cache


# ----------------------------------------------------------------------
# cross-entropy (repro.models.transformer._xent_full / _xent_chunked)
# ----------------------------------------------------------------------
NEG_INF = -1e30


def _xent_full(x, w_out, labels, mask, valid_v=None):
    """Mean next-token NLL over ``mask`` from the full (B, S, V) float32
    logits, columns at or past ``valid_v`` masked out."""
    logits = (x @ w_out).float()
    if valid_v is not None and valid_v < w_out.shape[1]:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < valid_v, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (lse - lab) * mask
    return nll.sum() / mask.sum().clamp(min=1.0)


def _xent_stats(x, wp, labels, V, chunk, n):
    """Streaming (log-sum-exp, label logit) over ``n`` vocabulary chunks of
    the padded ``wp``: three (B, S) running stats, never a (B, S, V)
    buffer."""
    labc = labels.clamp(min=0)
    B, S = labels.shape
    m = torch.full((B, S), NEG_INF, device=x.device)
    l = torch.zeros(B, S, device=x.device)
    lab = torch.zeros(B, S, device=x.device)
    for i in range(n):
        lg = (x @ wp[:, i * chunk:(i + 1) * chunk]).float()
        gidx = torch.arange(chunk, device=x.device) + i * chunk
        lg = torch.where(gidx < V, lg, NEG_INF)
        m_new = torch.maximum(m, lg.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
        m = m_new
        lab = lab + torch.where(gidx == labc[..., None], lg, 0.0).sum(-1)
    return m + torch.log(l.clamp(min=1e-30)), lab


class _XentChunked(torch.autograd.Function):
    """Memory-lean streaming cross-entropy whose backward is `repro`'s
    analytic chunk loop: d logits = softmax - onehot, applied chunk by
    chunk, so no (B, S, V) buffer is kept for it."""

    @staticmethod
    def forward(ctx, x, w_out, labels, mask, chunk, valid_v):
        V = valid_v or w_out.shape[1]
        n = -(-w_out.shape[1] // chunk)
        wp = torch.nn.functional.pad(w_out, (0, n * chunk - w_out.shape[1]))
        lse, lab = _xent_stats(x, wp, labels, V, chunk, n)
        ctx.save_for_backward(x, wp, labels, mask, lse)
        ctx.chunk, ctx.V, ctx.n, ctx.width = chunk, V, n, w_out.shape[1]
        return ((lse - lab) * mask).sum() / mask.sum().clamp(min=1.0)

    @staticmethod
    def backward(ctx, g):
        x, wp, labels, mask, lse = ctx.saved_tensors
        chunk = ctx.chunk
        labc = labels.clamp(min=0)
        scale = g * mask / mask.sum().clamp(min=1.0)           # (B, S)
        dx = torch.zeros_like(x)
        dw = torch.zeros_like(wp)
        for i in range(ctx.n):
            wchunk = wp[:, i * chunk:(i + 1) * chunk]
            lg = (x @ wchunk).float()
            gidx = torch.arange(chunk, device=x.device) + i * chunk
            p = torch.where(gidx < ctx.V, torch.exp(lg - lse[..., None]), 0.0)
            p = p - (gidx == labc[..., None]).float()
            dlg = (p * scale[..., None]).to(x.dtype)           # (B, S, chunk)
            dx = dx + dlg @ wchunk.T
            dw[:, i * chunk:(i + 1) * chunk] = torch.einsum(
                "bsd,bsc->dc", x, dlg).to(dw.dtype)
        return dx, dw[:, :ctx.width], None, None, None, None


def _xent_chunked(x, w_out, labels, mask, chunk: int, valid_v: int = 0):
    """`_XentChunked` over vocabulary chunks of ``chunk`` columns."""
    return _XentChunked.apply(x, w_out, labels, mask, chunk, valid_v)


# ----------------------------------------------------------------------
# the training form
# ----------------------------------------------------------------------
def _init_leaf(key: str, shape, generator, device) -> torch.Tensor:
    """A float32 leaf drawn as `repro`'s ``Model.init`` draws it (another
    generator, so other values): ``0.02 N(0, 1)`` for the embedding, unit
    norms (MLA's ``q_norm`` and ``kv_norm`` and the encoder-decoder's too)
    and ``D``, zero ``dt_bias``, ``conv_b`` and QKV biases,
    ``log(linspace(1, 16))`` for ``A_log``, ``0.1 N(0, 1)`` for ``conv_w``
    and ``N(0, 1) / sqrt(fan_in)`` for every other matrix, the fan-in its
    input axis (``shape[-2]``: d for the MoE's stacked (L, E, d, f)
    experts, never a stack axis)."""
    name = key.split("@")[-1]

    def randn():
        return torch.randn(shape, generator=generator, device=device)

    if key == "embed":
        return 0.02 * randn()
    if name in ("norm", "attn_norm", "mlp_norm", "final_norm", "D",
                "q_norm", "kv_norm", "self_norm", "cross_norm", "enc_norm"):
        return torch.ones(shape, device=device)
    if name in ("dt_bias", "conv_b", "bq", "bk", "bv"):
        return torch.zeros(shape, device=device)
    if name == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                        device=device)).expand(shape).clone()
    if name == "conv_w":
        return 0.1 * randn()
    return randn() / shape[-2] ** 0.5


class _TrainForm(nn.Module):
    """What the training forms share: float32 masters, one `nn.Parameter`
    per leaf of `repro`'s parameter tree under `repro`'s keys joined by
    ``@`` (``"embed"``, ``"layers@attn@wq"`` of shape (L, d, H hd), ...),
    stacked on the layer axis as `repro` stacks them, so that the
    optimizers apply `repro`'s leaf rules to the same leaves.  Each use
    casts its slice to the dtype the serving model keeps that weight in
    (the compute dtype, or float32 for the norm scales, ``A_log`` and
    ``dt_bias``), as `repro` casts ``p.astype(x.dtype)``; the gradients
    reach the masters in float32.  A stack of layers runs through one
    weightless template (on the meta device) called with each layer's
    slices (`torch.func.functional_call`), so the serving code is the
    training code."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.cfg = cfg
        # None: the leaves' specs only, no masters (`param_shapes`)
        self._dev = None if device is None else resolve_device(device)
        self._dt = compute_dtype(cfg)
        self._specs: dict = {}

    def _template(self, cls, prefix: str, n: int | None):
        """A weightless ``cls`` kept out of the module tree, its parameters
        added to the specs under ``prefix@name``, stacked ``n`` deep
        (``None``: unstacked) -> (template, [(name, key)])."""
        tpl = cls(self.cfg, device="meta", dtype=self._dt)
        names = []
        for name, p in tpl.named_parameters():
            key = prefix + "@" + name.replace(".", "@")
            shape = tuple(p.shape) if n is None else (n,) + tuple(p.shape)
            self._specs[key] = (shape, p.dtype)
            names.append((name, key))
        return tpl, names

    def _make_masters(self) -> None:
        """Allocate a zero master for every leaf of the specs (none when
        the form was built for its shapes alone)."""
        self.use_dtype = {k: t for k, (_, t) in self._specs.items()}
        if self._dev is None:
            return
        self.masters = nn.ParameterDict({
            k: nn.Parameter(torch.zeros(self._specs[k][0], device=self._dev))
            for k in sorted(self._specs)})

    @property
    def device(self) -> torch.device:
        """The device the masters lie on."""
        return self.masters["embed"].device

    def params(self) -> dict[str, torch.Tensor]:
        """The masters by `repro`'s keys, in `repro`'s leaf order."""
        return dict(self.masters.items())

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Draw every master from ``generator`` (see `_init_leaf`)."""
        for k, p in self.masters.items():
            p.copy_(_init_leaf(k, p.shape, generator, p.device))
        return self

    def _use(self, key: str) -> torch.Tensor:
        """Master ``key`` (unstacked) in the dtype it is used in."""
        return self.masters[key].to(self.use_dtype[key])

    def _call(self, tpl, names, slices, *args, **kwargs):
        """``tpl`` run on ``slices``, its views of the masters (in
        ``names`` order), each cast to the dtype it is used in."""
        w = {n: t.to(self.use_dtype[k]) for (n, k), t in zip(names, slices)}
        return functional_call(tpl, w, args, kwargs)

    def _slices(self, names) -> list[tuple]:
        """Per layer, its views of every stacked master in ``names``.  One
        `unbind` a leaf: its backward stacks the L layer gradients once,
        where indexing layer by layer would add a zero-filled (L, ...)
        gradient into the leaf's for every layer."""
        per_leaf = [self.masters[k].unbind(0) for _, k in names]
        return list(zip(*per_leaf))

    def _remat(self, fn, *args):
        if self.cfg.remat == "full":
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)


class TrainModel(_TrainForm):
    """The training form of `Model` on ``device`` ("cuda" unless the
    caller asks for "cpu"), its masters as `_TrainForm` keeps them (no
    ``unembed`` with tied embeddings, the VLM's ``patch_proj``).
    `forward` records the graph for autograd; serve a trained model through
    `models.convert` (``params_from_jax(cfg, params_to_numpy(model))``).
    ``device=None`` builds the leaves' specs alone, with no masters
    (`param_shapes`)."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        _check_ported(cfg)
        dt = self._dt
        d, Vp = cfg.d_model, cfg.padded_vocab
        self._specs.update(embed=((Vp, d), dt), final_norm=((d,),
                                                           torch.float32))
        if not cfg.tie_embeddings:
            self._specs["unembed"] = ((d, Vp), dt)
        if cfg.vlm is not None:
            self._specs["patch_proj"] = ((cfg.vlm.patch_dim, d), dt)
        layer = Block if attention_decoder(cfg) else MambaBlock
        tpl, self._layer_names = self._template(layer, "layers", cfg.n_layers)
        self.__dict__["_block"] = tpl
        self.__dict__["_shared"], self._shared_names = (
            self._template(SharedAttnBlock, "shared_attn", None)
            if cfg.family == "hybrid" else (None, []))
        self._make_masters()

    def _layer(self, x, positions, *slices):
        """One layer on ``slices`` -> (x, the MoE's aux loss or None)."""
        out = self._call(self._block, self._layer_names, slices, x, positions)
        return (out[0], out[2]) if isinstance(out, tuple) else (out, None)

    def _shared_block(self, x, positions, window: int):
        ws = [self.masters[k] for _, k in self._shared_names]
        return self._call(self._shared, self._shared_names, ws, x, positions,
                          window=window)[0]

    def forward(self, tokens: torch.Tensor, patch_embeds=None
                ) -> torch.Tensor:
        """tokens (B, S) (and a VLM's optional ``patch_embeds`` (B, P,
        patch_dim)) -> final-normed hidden states (B, P + S, d), with the
        graph for autograd."""
        return self._hidden(tokens, patch_embeds)[0]

    def _hidden(self, tokens: torch.Tensor, patch_embeds=None):
        """(final-normed hidden states (B, S, d), the sum of the MoE layers'
        aux losses (0 without them)).  Each layer's aux leaves its
        checkpoint beside x, so the recompute in the backward routes the
        same rows as the forward did."""
        cfg = self.cfg
        x = self._use("embed")[tokens]
        if patch_embeds is not None:
            patches = patch_embeds.to(x.dtype) @ self._use("patch_proj")
            x = torch.cat([patches, x], dim=1)
        x = constrain(x, "dp", None, None)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        slices = self._slices(self._layer_names)
        aux = torch.zeros((), device=x.device)
        if cfg.family != "hybrid":
            for ws in slices:
                x, a = self._remat(self._layer, x, positions, *ws)
                x = constrain(x, "dp", None, None)
                if a is not None:
                    aux = aux + a
        else:
            every = cfg.hybrid.attn_every
            window = cfg.hybrid.window if S > cfg.hybrid.window else 0

            def group(x, *flat):
                n = len(self._layer_names)
                for j in range(every):
                    x = constrain(self._remat(
                        self._layer, x, positions,
                        *flat[j * n:(j + 1) * n])[0], "dp", None, None)
                return self._shared_block(x, positions, window)

            for g in range(cfg.n_layers // every):
                x = self._remat(group, x, *[t for ws in slices[
                    g * every:(g + 1) * every] for t in ws])
        return L.rms_norm(x, self.masters["final_norm"]), aux

    def unembed_matrix(self) -> torch.Tensor:
        """(d, V) output projection in the compute dtype: ``embed.T`` with
        tied embeddings, so the embedding's gradient sums both uses."""
        if self.cfg.tie_embeddings:
            return self._use("embed").T
        return self._use("unembed")

    def logits(self, tokens: torch.Tensor, patch_embeds=None) -> torch.Tensor:
        """tokens (B, S) -> (B, P + S, V) logits, padded columns at -1e30."""
        return _mask_pad(self.forward(tokens, patch_embeds) @
                         self.unembed_matrix(), self.cfg.vocab)

    def loss(self, batch: dict):
        """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"}
        (B, S), numpy or tensors; labels < 0 are ignored; a VLM's optional
        "patch_embeds" (B, P, patch_dim), whose P positions take
        ignore-labels) plus 0.01 ``aux`` -> (loss, {"nll", "aux"}), chunked
        over the vocabulary when ``cfg.logit_chunk_vocab`` is set.  ``aux``
        is the sum over the MoE layers of their load-balancing losses, as
        `repro` sums it (0 for the other families); its gradient reaches
        each router through the gates' means."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        patches = batch.get("patch_embeds") if cfg.vlm is not None else None
        if patches is not None:
            patches = torch.as_tensor(patches, device=self.device)
            labels = torch.cat([labels.new_full(patches.shape[:2], -1),
                                labels], dim=1)
        x, aux = self._hidden(tokens, patches)
        mask = (labels >= 0).float()
        w_out = self.unembed_matrix()
        if cfg.logit_chunk_vocab > 0:
            nll = _xent_chunked(x, w_out, labels, mask, cfg.logit_chunk_vocab,
                                cfg.vocab)
        else:
            nll = _xent_full(x, w_out, labels, mask, cfg.vocab)
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}


class TrainEncDecModel(_TrainForm):
    """The training form of `EncDecModel` on ``device`` ("cuda" unless
    the caller asks for "cpu"): masters ``embed`` (V, d), ``unembed`` (d,
    V), ``enc_norm``, ``final_norm`` and the stacked ``enc_layers@...``
    and ``dec_layers@...`` leaves; ``remat="full"`` checkpoints each
    encoder and each decoder layer (the decoder layer's cross keys and
    values recomputed inside it).  ``device=None``: specs alone, as
    `TrainModel`."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        _check_ported(cfg, encdec=True)
        dt, d, V = self._dt, cfg.d_model, cfg.vocab
        f32 = torch.float32
        self._specs.update(embed=((V, d), dt), unembed=((d, V), dt),
                           enc_norm=((d,), f32), final_norm=((d,), f32))
        enc, self._enc_names = self._template(
            Block, "enc_layers", cfg.encdec.n_encoder_layers)
        dec, self._dec_names = self._template(DecoderBlock, "dec_layers",
                                              cfg.n_layers)
        self.__dict__.update(_enc=enc, _dec=dec)
        self._make_masters()

    def _enc_layer(self, x, positions, *slices):
        return self._call(self._enc, self._enc_names, slices, x, positions,
                          causal=False)[0]

    def _dec_layer(self, x, positions, enc, *slices):
        return self._call(self._dec, self._dec_names, slices, x, positions,
                          enc)[0]

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        """frames (B, T, d), tokens (B, S) -> final-normed decoder hidden
        states (B, S, d), with the graph for autograd."""
        x = frames.to(self._dt)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for ws in self._slices(self._enc_names):
            x = self._remat(self._enc_layer, x, positions, *ws)
        enc = L.rms_norm(x, self.masters["enc_norm"])
        x = self._use("embed")[tokens]
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for ws in self._slices(self._dec_names):
            x = self._remat(self._dec_layer, x, positions, enc, *ws)
        return L.rms_norm(x, self.masters["final_norm"])

    def unembed_matrix(self) -> torch.Tensor:
        """(d, V) output projection in the compute dtype."""
        return self._use("unembed")

    def loss(self, batch: dict):
        """Mean next-token cross-entropy of ``batch`` ({"frames" (B, T, d),
        "tokens", "labels" (B, S)}, numpy or tensors; labels < 0 are
        ignored) over the full logits of the unpadded vocabulary, as
        `repro`'s ``EncDecModel.loss`` -> (loss, {"nll", "aux": 0})."""
        frames = torch.as_tensor(batch["frames"], device=self.device)
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        x = self.forward(frames, tokens)
        nll = _xent_full(x, self.unembed_matrix(), labels,
                         (labels >= 0).float())
        return nll, {"nll": nll, "aux": torch.zeros((), device=x.device)}


def param_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """The training form's master keys and shapes for ``cfg`` (`TrainModel`
    or `TrainEncDecModel`, in `repro`'s leaf order), from the same specs
    the form allocates its masters from, without allocating: any config,
    Arctic-480B's full one included."""
    cls = TrainEncDecModel if cfg.encdec is not None else TrainModel
    form = cls(cfg, device=None)
    return {k: form._specs[k][0] for k in sorted(form._specs)}


def build_model(cfg: ArchConfig, *, device: str | torch.device = "cuda",
                train: bool = False):
    """The port's model of ``cfg`` on ``device`` (`repro.models.
    build_model`): `EncDecModel` for an encoder-decoder config, else
    `Model`; with ``train``, their training forms `TrainEncDecModel` and
    `TrainModel`.  Weights are allocated, not drawn (``init``)."""
    if cfg.encdec is not None:
        cls = TrainEncDecModel if train else EncDecModel
    else:
        cls = TrainModel if train else Model
    return cls(cfg, device=device)
