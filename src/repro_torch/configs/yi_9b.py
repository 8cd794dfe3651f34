"""yi-9b — llama-arch dense GQA [arXiv:2403.04652].

48 layers, d_model=4096, 32 heads (kv=4), d_ff=11008, vocab=64000.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    head_dim=128,
)

SMOKE = ArchConfig(
    name="yi-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=256,
    head_dim=16,
    remat="none",
)
