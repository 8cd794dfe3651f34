"""qwen2-72b — dense GQA with QKV bias [arXiv:2407.10671].

80 layers, d_model=8192, 64 heads (kv=8), d_ff=29568, vocab=152064.
The 152k vocabulary makes the unembed/xent buffer a first-order memory
term; ``logit_chunk_vocab`` enables the streaming cross-entropy path.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
)

SMOKE = ArchConfig(
    name="qwen2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    qkv_bias=True,
    remat="none",
)
