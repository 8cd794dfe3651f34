"""Serving engines and the load simulator of the port (`repro.serving`
counterpart); names resolve on first access, as in `repro_torch.core`."""
import importlib

_EXPORTS = {
    "ServingEngine": "engine",
    "EngineLoadModel": "loadsim", "EngineSim": "loadsim",
    "FleetEngineSim": "loadsim", "FleetLoadModel": "loadsim",
    "LoadTrace": "loadsim", "fit_slowdown_curve": "loadsim",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
