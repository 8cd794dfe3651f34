"""Model stack of the port (`repro.models` counterpart)."""
from repro_torch.models.transformer import build_model, param_shapes  # noqa: F401
