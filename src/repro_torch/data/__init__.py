"""Data pipeline: deterministic, checkpointable synthetic LM sources."""
from repro_torch.data.pipeline import DataConfig, MarkovLMData

__all__ = ["DataConfig", "MarkovLMData"]
