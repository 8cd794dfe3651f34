"""Serving engines of the port (`repro.serving` counterpart)."""
