"""Dense decoder model stack of the port (`repro.models` counterpart)."""
