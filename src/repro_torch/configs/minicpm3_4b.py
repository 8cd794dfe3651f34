"""minicpm3-4b — dense with Multi-head Latent Attention [hf:openbmb/MiniCPM3-4B].

62 layers, d_model=2560, 40 heads, d_ff=6400, vocab=73448.  MLA compresses
the KV cache to (kv_lora_rank + rope_dim) per token; decode uses the
absorbed-matmul path (DESIGN.md TPU adaptation).
"""
from repro_torch.models.config import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    head_dim=64,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
)

SMOKE = ArchConfig(
    name="minicpm3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    head_dim=16,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    remat="none",
)
