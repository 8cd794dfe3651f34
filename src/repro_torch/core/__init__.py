"""VineLM core, ported: the same modules as `repro.core`.

Submodules are imported on demand; unlike `repro.core`, this package
imports nothing at load time, so the copies of the framework-free modules
(`workflow`, `trie`, `presets`, `workload`, `controller`) stay usable
without touching torch's device state.
"""
