"""VineLM core, ported: the same modules as `repro.core`.

- `workflow`         — workflow-template DSL (stages, loops, model pools)
- `trie`             — execution trie in SoA/preorder layout + annotations
- `workload`         — calibrated synthetic ground-truth generator
- `profiler`         — cascade sampling, checkpointing, subtree fill-in
- `estimators`       — column-mean estimators, online posteriors, and the
                       versioned annotation publisher
- `controller`       — oracle search + online re-rooted receding-horizon
- `controller_torch` — the batched replanner on the device (CUDA kernel)
- `murakkab`         — coarse workflow-level control baseline
- `runtime`          — request execution loop (policy x executor)
- `fleet`            — lockstep cohort runtime: one batched replan per round
- `events`           — open-arrival event-driven runtime (virtual clock)
- `admission`, `faults`, `monitor`, `streaming`, `presets`

Unlike `repro.core`, this package imports nothing at load time: the names
below resolve on first access, so the copies of the framework-free modules
stay usable without touching torch's device state.
"""
import importlib

_EXPORTS = {
    "Objective": "controller", "OnlineController": "controller",
    "select_path": "controller", "select_path_dfs": "controller",
    "ESTIMATORS": "estimators", "annotate": "estimators",
    "estimate_accuracy": "estimators",
    "EventStats": "events", "run_events": "events",
    "FleetStats": "fleet", "run_fleet": "fleet",
    "DriftMonitor": "monitor", "DriftReport": "monitor",
    "murakkab_nodes": "murakkab",
    "exhaustive_cost": "profiler", "profile_cascade": "profiler",
    "make_workload_executor": "runtime", "run_cohort": "runtime",
    "run_request": "runtime", "summarize": "runtime",
    "Trie": "trie", "TrieAnnotations": "trie",
    "ModelSpec": "workflow", "ToolStage": "workflow",
    "WorkflowTemplate": "workflow",
    "make_refinement_workflow": "workflow",
    "make_reflection_workflow": "workflow",
    "Workload": "workload", "generate_workload": "workload",
    "poisson_arrivals": "workload", "trace_arrivals": "workload",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
