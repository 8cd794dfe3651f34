"""granite-moe-1b-a400m — fine-grained MoE [hf:ibm-granite/granite-3.0-1b-a400m].

24 layers, d_model=1024, 16 heads (kv=8), 32 experts (d_ff=512 each),
top-8 routing, vocab=49155.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    moe=MoEConfig(n_experts=32, top_k=8, capacity_factor=1.25,
                  expert_group=512),
)

SMOKE = ArchConfig(
    name="granite-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=256,
    head_dim=16,
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.5,
                  expert_group=64),
    remat="none",
)
