"""zamba2-2.7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers, d_model=2560, one weight-shared GQA attention block
(32 heads, kv=32) applied every 6 layers, d_ff=10240, vocab=32000,
ssm_state=64.
"""
from repro_torch.models.config import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
    hybrid=HybridConfig(attn_every=6, window=4096),
)

SMOKE = ArchConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    head_dim=16,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=32),
    hybrid=HybridConfig(attn_every=2, window=64),
    remat="none",
)
