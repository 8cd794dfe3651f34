"""Unified architecture configuration for the assigned model families.

One ``ArchConfig`` describes any of the 10 assigned architectures; family-
specific extensions live in optional sub-configs.  ``reduced()`` produces
the CPU-smoke-test variant of the same family (same code paths, tiny dims).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 style; minicpm3)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 32
    top_k: int = 8
    capacity_factor: float = 1.25
    expert_group: int = 512      # tokens per dispatch group (memory knob)
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    dense_d_ff: int = 0           # width of the dense residual MLP


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD (state-space duality) block parameters."""

    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone + one weight-shared attention
    block applied every ``attn_every`` layers."""

    attn_every: int = 6
    window: int = 4096  # sliding window for the shared attention at long ctx


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 6
    encoder_len: int = 1500  # precomputed audio-frame embeddings (stub)


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 2880     # anyres patch embeddings (stub frontend)
    patch_dim: int = 1152     # frontend embedding dim before projection


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    attn_kind: str = "gqa"    # gqa | mla
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    # execution knobs
    dtype: str = "bfloat16"
    remat: str = "full"       # none | full
    scan_layers: bool = True
    use_pallas: bool = False  # TPU kernel path (validated via interpret=True)
    logit_chunk_vocab: int = 0  # >0: chunked xent to avoid full-logit buffer
    vocab_pad_to: int = 0     # >0: pad embedding tables to a multiple (TP)

    def __post_init__(self):
        if self.head_dim is None and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_to <= 0:
            return self.vocab
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (ssm / hybrid-window)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are (or contain) decoders

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            N = s.state_dim
            conv_ch = d_in + 2 * N
            # mirrors layers.init_mamba: in_proj (z,x,B,C,dt), depthwise
            # conv, A_log/D/dt_bias, gated norm, out_proj (+ layer norm)
            per_layer = (
                d * (2 * d_in + 2 * N + nheads)
                + (s.conv_width + 1) * conv_ch
                + 3 * nheads + d_in + d_in * d + d
            )
            ssm_total = L * per_layer
            attn_total = 0
            if self.family == "hybrid":
                hd = self.head_dim
                # one weight-shared attention + MLP block
                attn_total = (
                    d * hd * (self.n_heads + 2 * self.n_kv_heads)
                    + self.n_heads * hd * d + 3 * d * f + 2 * d
                )
            return emb + ssm_total + attn_total
        if self.attn_kind == "mla":
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (
                d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        else:
            hd = self.head_dim
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe is not None:
            mlp = self.moe.n_experts * 3 * d * f
            if self.moe.dense_residual:
                mlp += 3 * d * self.moe.dense_d_ff
            mlp += d * self.moe.n_experts  # router
        else:
            mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        total = emb + L * per_layer
        if self.encdec is not None:
            total += self.encdec.n_encoder_layers * (attn + 3 * d * f + 2 * d)
            total += L * attn  # decoder cross-attention blocks
        if self.vlm is not None:
            total += self.vlm.patch_dim * d  # frontend projection
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        inactive = L * (self.moe.n_experts - self.moe.top_k) * 3 * d * f
        return int(self.param_count() - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
