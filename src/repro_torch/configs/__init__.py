"""Architecture config registry: ``get_config("<arch-id>", smoke=...)``.

The port registers every architecture of `repro.configs`, under the same
ids and in the same order, and re-exports the shape cells (`SHAPES`,
`ShapeCell`) with `shape_cells_for`, as `repro.configs` does.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import SHAPES, ArchConfig, ShapeCell  # noqa: F401

_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "llava-next-34b": "llava_next_34b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "yi-9b": "yi_9b",
    "qwen2-72b": "qwen2_72b",
    "minicpm3-4b": "minicpm3_4b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "arctic-480b": "arctic_480b",
    "mamba2-1.3b": "mamba2_1p3b",
    "whisper-base": "whisper_base",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False, **overrides) -> ArchConfig:
    """The registered CONFIG (or its reduced SMOKE variant) of ``arch_id``,
    with ``overrides`` applied as dataclass fields."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}: the port registers "
                       f"{ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def shape_cells_for(arch_id: str) -> list[str]:
    """The shape cells (`SHAPES` keys) ``arch_id`` runs; the rest are
    documented skips.  ``long_500k`` needs sub-quadratic attention, so
    only the SSM and hybrid families run it; every architecture has a
    decoder, so the decode cell applies to all."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if get_config(arch_id).sub_quadratic:
        cells.append("long_500k")
    return cells
