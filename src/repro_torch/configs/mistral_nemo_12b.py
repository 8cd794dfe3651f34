"""mistral-nemo-12b — dense GQA, 128k context [hf:mistralai/Mistral-Nemo-Base-2407].

40 layers, d_model=5120, 32 heads (kv=8, head_dim=128), d_ff=14336,
vocab=131072, rope_theta=1e6 for long context.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="nemo-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    rope_theta=1e6,
    remat="none",
)
