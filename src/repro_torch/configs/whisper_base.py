"""whisper-base — encoder-decoder audio backbone [arXiv:2212.04356].

6 encoder + 6 decoder layers, d_model=512, 8 heads, d_ff=2048,
vocab=51865.  The conv audio frontend is a STUB per the assignment:
``input_specs()`` feeds precomputed 1500-frame embeddings.
"""
from repro_torch.models.config import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    head_dim=64,
    encdec=EncDecConfig(n_encoder_layers=6, encoder_len=1500),
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    head_dim=16,
    encdec=EncDecConfig(n_encoder_layers=2, encoder_len=16),
    remat="none",
)
