"""arctic-480b — MoE 128e top-2 + dense residual [hf:Snowflake/snowflake-arctic].

35 layers, d_model=7168, 56 heads (kv=8), 128 experts (d_ff=4864), top-2
routing with a dense residual MLP in parallel, vocab=32000.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    head_dim=128,
    moe=MoEConfig(n_experts=128, top_k=2, capacity_factor=1.25,
                  expert_group=1024, dense_residual=True, dense_d_ff=4864),
)

SMOKE = ArchConfig(
    name="arctic-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=256,
    head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.5,
                  expert_group=64, dense_residual=True, dense_d_ff=32),
    remat="none",
)
