"""mamba2-1.3b — pure SSD state-space model [arXiv:2405.21060].

48 layers, d_model=2048 (d_inner=4096, head_dim=64 -> 64 SSD heads),
ssm_state=128, vocab=50280, attention-free.
"""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256),
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=256,
    head_dim=16,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=32),
    remat="none",
)
