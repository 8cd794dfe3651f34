"""Workflow runtime: executes requests under a control policy (paper §4.3).

The runtime owns the typed workflow state (realized prefix node, elapsed
latency/cost, retry position, transcript) and interleaves execution and
control: invoke stage -> observe outcome -> advance prefix -> replan.

Stage execution is pluggable: the synthetic executor reads the workload's
ground-truth stage tables (optionally inflated by a live load model); a
real executor drives `repro_torch.serving.ServingEngine`s.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.admission import FAILED, OUTCOMES, REJECTED, SHED
from repro_torch.core.controller import Objective, OnlineController
from repro_torch.core.trie import Trie, TrieAnnotations
from repro_torch.device import resolve_device

__all__ = ["ExecutionResult", "OUTCOMES", "StageExecutor",
           "make_workload_executor", "run_request", "run_cohort",
           "summarize", "summarize_by_class"]


@dataclasses.dataclass
class ExecutionResult:
    """Per-request outcome of any runtime (`run_request`, `run_fleet`,
    `run_events`): realized success/cost/latency, the executed model
    sequence, replanning overhead attributed to the request, and the
    SLO/admission disposition."""

    success: bool
    total_cost: float
    total_lat: float
    models: list[int]
    n_stages: int
    replan_overhead_s: float
    slo_violated: bool
    # admission disposition (repro.core.admission): "served" on every
    # closed-cohort path; the event-driven runtime reports requests its
    # admission policy turned away ("rejected") or aborted mid-flight
    # ("shed")
    outcome: str = "served"


# executor(q, depth, model, t_now) -> (success, cost, latency)
StageExecutor = Callable[[int, int, int, float], tuple[bool, float, float]]


@dataclasses.dataclass(frozen=True, eq=False)
class WorkloadExecutor:
    """`make_workload_executor`'s executor: an object, so that it pickles
    to the ranks of a spawned group whenever ``slowdown_fn`` does."""

    workload: object
    slowdown_fn: Callable | None = None

    def __call__(self, q: int, depth: int, model: int, t_now: float):
        s, c, lat = self.workload.execute_stage(q, depth, model)
        if self.slowdown_fn is not None:
            engine = self.workload.template.models[model].engine
            lat = lat * float(self.slowdown_fn(engine, t_now))
        return s, c, lat


def make_workload_executor(workload, slowdown_fn=None) -> StageExecutor:
    """Executor backed by the synthetic workload tables.  ``slowdown_fn``
    maps (engine, t_now) -> multiplicative latency slowdown, modelling
    transient backend load (paper §5.4's utilization-conditioned curve)."""
    return WorkloadExecutor(workload, slowdown_fn)


def run_request(
    trie: Trie,
    ann: TrieAnnotations,
    obj: Objective,
    q: int,
    executor: StageExecutor,
    *,
    policy: str = "dynamic",
    restrict_nodes: np.ndarray | None = None,
    load_probe: Callable[[float], dict[str, float]] | None = None,
    t_start: float = 0.0,
) -> ExecutionResult:
    """Serve one request under the given objective and control policy."""
    ctl = OnlineController(trie, ann, obj, policy=policy,
                           restrict_nodes=restrict_nodes)
    u = 0
    elapsed_lat = 0.0
    elapsed_cost = 0.0
    overhead = 0.0
    models: list[int] = []
    success = False
    while True:
        delays = load_probe(t_start + elapsed_lat) if load_probe else None
        step = ctl.plan(u, elapsed_lat, elapsed_cost, engine_delays=delays)
        overhead += step.replan_time_s
        if step.next_model < 0:
            break
        d = int(trie.depth[u])  # 0-based invocation position of next stage
        s, c, lat = executor(q, d, step.next_model, t_start + elapsed_lat)
        elapsed_cost += c
        elapsed_lat += lat
        models.append(step.next_model)
        u = int(trie.child[u, step.next_model])
        if s:
            success = True
            break
        if int(trie.depth[u]) >= trie.template.max_depth:
            break
    slo = obj.lat_cap is not None and elapsed_lat > obj.lat_cap + 1e-9
    return ExecutionResult(
        success=success,
        total_cost=elapsed_cost,
        total_lat=elapsed_lat,
        models=models,
        n_stages=len(models),
        replan_overhead_s=overhead,
        slo_violated=bool(slo),
    )


_FLEET_MIN_BATCH = 8


def run_cohort(
    trie: Trie,
    ann: TrieAnnotations,
    obj: Objective,
    requests: np.ndarray,
    executor: StageExecutor,
    *,
    engine: str = "auto",
    device: str | torch.device = "cuda",
    **kw,
) -> list[ExecutionResult]:
    """Serve a cohort of requests on ``device`` ("cuda" unless the caller
    asks for "cpu"; it holds the fleet planner's trie columns).

    ``engine`` selects the control plane:
      "scalar" — the paper's sequential loop: one host replan per request
                 per stage (also what the synchronous real-model executor
                 in `examples/serve_workflow.py` uses for small cohorts).
      "fleet"  — `core.fleet.run_fleet`: the whole cohort replans in
                 lockstep with one batched device planner call per round.
      "events" — `core.events.run_events`: open-arrival event-driven
                 serving on a virtual clock (``arrivals=``/``capacity=``);
                 SLO latency is measured from each request's arrival,
                 ``admission=`` selects an admission-control/load-shedding
                 policy ("always", "feasibility", "predictive",
                 "cost_aware", or an `core.admission.AdmissionPolicy`
                 instance), and ``class_specs=``/``classes=``/``preempt=``
                 enable priority-class serving (per-class deadlines and
                 weights, weighted processor sharing, preemption).
      "auto"   — events whenever ``arrivals``/``capacity``/``admission``/
                 ``class_specs`` is given, else fleet for dynamic policies
                 on cohorts of at least 8 requests (where the batched
                 planner amortizes its call overhead), scalar otherwise.
                 The "static" policy plans once per request, so there is
                 nothing to batch.
    The scalar, fleet, and (closed-cohort, full-capacity) events paths
    produce identical per-request results for dynamic policies; they
    differ only in how `replan_overhead_s` is spent and, for open
    arrivals, in queueing delay.
    """
    dev = resolve_device(device)
    if engine not in ("auto", "fleet", "scalar", "events"):
        raise ValueError(f"unknown engine {engine!r}: "
                         "expected 'auto', 'fleet', 'scalar', or 'events'")
    policy = kw.get("policy", "dynamic")
    _events_kw = ("arrivals", "capacity", "admission", "classes",
                  "class_specs", "preempt")
    if engine == "auto":
        if any(k in kw for k in _events_kw):
            engine = "events"
        else:
            use_fleet = policy != "static" and (
                len(requests) >= _FLEET_MIN_BATCH or "fleet_load" in kw)
            engine = "fleet" if use_fleet else "scalar"
    if engine == "events":
        from repro_torch.core.events import run_events

        results, _ = run_events(trie, ann, obj, requests, executor,
                                device=dev, **kw)
        return results
    for k in _events_kw:
        if k in kw:
            raise ValueError(
                f"{k!r} models open-arrival admission — it requires the "
                "events engine, not the closed-cohort paths")
    if engine == "fleet":
        from repro_torch.core.fleet import run_fleet

        results, _ = run_fleet(trie, ann, obj, requests, executor,
                               device=dev, **kw)
        return results
    if "fleet_load" in kw:
        raise ValueError(
            "fleet_load models the cohort's own concurrency — it requires "
            "the fleet or events engine (dynamic policy), not the scalar "
            "path")
    return [run_request(trie, ann, obj, int(q), executor, **kw) for q in requests]


_SUMMARY_KEYS = ("accuracy", "goodput", "mean_cost", "mean_lat", "p99_lat",
                 "slo_violation_rate", "mean_replan_overhead_s", "mean_stages",
                 "reject_rate", "shed_rate", "failed_rate")


def summarize(results: list[ExecutionResult]) -> dict:
    """Cohort-level aggregates over `ExecutionResult` rows — the fixed
    `_SUMMARY_KEYS` schema every benchmark reports (all 0.0 for an empty
    cohort)."""
    n = len(results)
    if n == 0:
        # empty cohort: every aggregate is defined as 0.0 (np.mean and
        # np.percentile both raise/warn on empty inputs)
        return {k: 0.0 for k in _SUMMARY_KEYS}
    lats = [r.total_lat for r in results]
    return {
        "accuracy": sum(r.success for r in results) / n,
        # goodput: correct AND within SLO — the metric that matters when
        # latency caps are hard constraints
        "goodput": sum(r.success and not r.slo_violated for r in results) / n,
        "mean_cost": float(np.mean([r.total_cost for r in results])),
        "mean_lat": float(np.mean(lats)),
        "p99_lat": float(np.percentile(lats, 99)),
        "slo_violation_rate": sum(r.slo_violated for r in results) / n,
        "mean_replan_overhead_s": float(np.mean([r.replan_overhead_s for r in results])),
        "mean_stages": float(np.mean([r.n_stages for r in results])),
        # admission/fault dispositions (always 0.0 on closed-cohort paths)
        "reject_rate": sum(r.outcome == REJECTED for r in results) / n,
        "shed_rate": sum(r.outcome == SHED for r in results) / n,
        "failed_rate": sum(r.outcome == FAILED for r in results) / n,
    }


def summarize_by_class(results: list[ExecutionResult], classes,
                       class_specs) -> dict:
    """Per-SLO-class partition of `summarize` for priority serving runs.

    ``classes`` is the per-request class-index array the run was served
    with (`EventStats.class_of`), ``class_specs`` the matching SLOClass
    table.  Returns {class name: summarize(subset) + "n"}; classes with no
    requests report the all-zero empty summary."""
    classes = np.asarray(classes)
    if classes.shape != (len(results),):
        raise ValueError(f"classes shape {classes.shape} != "
                         f"({len(results)},)")
    out = {}
    for k, spec in enumerate(class_specs):
        sub = [r for r, c in zip(results, classes) if c == k]
        s = summarize(sub)
        s["n"] = len(sub)
        out[spec.name] = s
    return out
