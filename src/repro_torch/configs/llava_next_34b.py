"""llava-next-34b — VLM backbone [hf:llava-hf/llava-v1.6; anyres tiling].

60-layer dense GQA decoder (56 heads, kv=8), d_model=7168, d_ff=20480,
vocab=64000.  The anyres vision frontend is a STUB per the assignment:
``input_specs()`` feeds precomputed patch embeddings which the model
projects and prepends to the text tokens.
"""
from repro_torch.models.config import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    vlm=VLMConfig(n_patches=2880, patch_dim=1152),
)

SMOKE = ArchConfig(
    name="llava-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    vlm=VLMConfig(n_patches=8, patch_dim=32),
    remat="none",
)
