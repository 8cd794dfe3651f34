"""Fleet runtime: batched cross-request replanning (beyond-paper).

`run_cohort` serves requests one at a time, re-solving the trie search on
the host after every stage invocation — the paper's setting (§4.3,
Table 3).  At fleet scale that control loop itself becomes the bottleneck:
N in-flight requests pay N host DFS/argmin solves per round, and no request
can see the load the others are about to place on shared engines.

`run_fleet` executes a whole cohort in lockstep *rounds*:

- per-request control state (realized prefix node, elapsed latency/cost,
  done flags) lives in arrays, not Python objects;
- each round issues ONE batched planner call (`make_fleet_planner`: on a
  CUDA device one copy of the packed lane state in, one launch of the
  trie-replan kernel, one copy of the (2, B) plan out) that
  re-roots and re-solves the constrained search for every in-flight
  request AND gathers each request's next model from the device-side
  first-step table — no per-request host search, no `ancestors()` walks;
- per-round per-engine occupancy is aggregated into the delay vectors the
  *next* round plans with, so concurrent requests inflate each other's
  latency estimates (the cross-request coupling a sequential per-request
  loop cannot express — cf. Aragog's just-in-time routing across in-flight
  requests);
- stage execution stays pluggable and host-side (the executor hides real
  engines or the synthetic workload tables).

Requests advance on their own wall-clock timelines (latencies differ), so
a lockstep "round" is a control-plane synchronization point, not a claim
that stages start simultaneously.  Without load coupling the semantics are
*identical* to the sequential loop — `tests/test_fleet.py` asserts plan-
and metric-level equivalence against `run_cohort` — because the device
planner tie-breaks exactly like the host search.

Load coupling is duck-typed (`fleet_load` needs `.delays(inflight)` and
`.slowdown(engine, n_others)`) so `core` does not depend on `serving`;
the standard implementation is `serving.loadsim.FleetLoadModel`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.controller import Objective
from repro_torch.core.controller_torch import (
    TrieDevice,
    make_fleet_planner,
    trie_engines,
)
from repro_torch.core.runtime import ExecutionResult, StageExecutor
from repro_torch.core.trie import Trie, TrieAnnotations
from repro_torch.device import resolve_device


@dataclasses.dataclass
class FleetStats:
    """Control-plane telemetry for one `run_fleet` call."""

    rounds: int = 0
    replan_s_per_round: list = dataclasses.field(default_factory=list)
    active_per_round: list = dataclasses.field(default_factory=list)
    inflight_per_round: list = dataclasses.field(default_factory=list)

    @property
    def total_replan_s(self) -> float:
        """Total wall time spent in batched replans over the run."""
        return float(sum(self.replan_s_per_round))

    @property
    def replan_s_per_request_round(self) -> float:
        """Mean per-request share of a round's batched replan."""
        shares = [
            s / a for s, a in
            zip(self.replan_s_per_round, self.active_per_round) if a > 0
        ]
        return float(np.mean(shares)) if shares else 0.0


def run_fleet(
    trie: Trie,
    ann: TrieAnnotations,
    obj: Objective,
    requests: np.ndarray,
    executor: StageExecutor,
    *,
    policy: str = "dynamic",
    restrict_nodes: np.ndarray | None = None,
    load_probe: Callable[[float], dict[str, float]] | None = None,
    fleet_load=None,
    t_start: float = 0.0,
    plan_variant: str | None = None,
    device: str | torch.device = "cuda",
) -> tuple[list[ExecutionResult], FleetStats]:
    """Serve ``requests`` in lockstep with one batched replan per round.

    ``device`` holds the trie columns and runs the replan ("cuda" unless
    the caller asks for "cpu").  ``plan_variant`` picks the planner
    dispatch path ("cuda", "fused", "dense"; None = the kernel on a CUDA
    device, the plain blocked version on the CPU).
    ``policy`` is "dynamic" or "dynamic_load_aware" (the "static" baseline
    plans once per request — there is nothing to batch; `run_cohort` keeps
    it on the scalar path).  Under "dynamic_load_aware" the planner's
    delta_e(t) terms come from ``fleet_load`` (aggregate in-flight counts
    per engine, fleet-coupled) or, failing that, from ``load_probe``
    evaluated on each request's own timeline (background-trace load, the
    sequential loop's semantics).  ``fleet_load`` also inflates *realized*
    stage latency by the engine's processor-sharing slowdown under this
    round's occupancy.
    """
    if policy not in ("dynamic", "dynamic_load_aware"):
        raise ValueError(f"unsupported fleet policy {policy!r}: the static "
                         "baseline plans once per request (nothing to batch)"
                         " — use run_cohort's scalar path")
    dev = resolve_device(device)
    requests = np.asarray(requests)
    B = int(requests.shape[0])
    if B == 0:
        # empty cohort: nothing to plan — skip the device-table build
        # entirely (FleetStats stays all-zero/empty, and its aggregate
        # properties are defined to be 0.0 in that state)
        return [], FleetStats()
    td = TrieDevice.build(trie, ann, restrict_nodes, device=dev)
    plan_step = make_fleet_planner(td, obj, variant=plan_variant)
    engines = trie_engines(trie.template)  # same ordering TrieDevice uses
    E = len(engines)
    engine_of_model = td.engine_of_model.cpu().numpy().astype(np.int64)
    max_depth = trie.template.max_depth
    load_aware = policy == "dynamic_load_aware"

    # per-request control state; elapsed time/cost accumulate in float64 on
    # the host (same addition order as the sequential loop) and are cast to
    # float32 only at the planner boundary
    u = np.zeros(B, dtype=np.int32)
    elapsed_lat = np.zeros(B, dtype=np.float64)
    elapsed_cost = np.zeros(B, dtype=np.float64)
    active = np.ones(B, dtype=bool)
    success = np.zeros(B, dtype=bool)
    overhead = np.zeros(B, dtype=np.float64)
    models: list[list[int]] = [[] for _ in range(B)]

    stats = FleetStats()
    inflight = np.zeros(E, dtype=np.int64)  # previous round's occupancy

    while active.any():
        delays = np.zeros((B, E), dtype=np.float32)
        if load_aware:
            if fleet_load is not None:
                d = fleet_load.delays(
                    {e: int(inflight[j]) for j, e in enumerate(engines)})
                delays[:] = np.array(
                    [d.get(e, 0.0) for e in engines], dtype=np.float32)
            elif load_probe is not None:
                for i in np.nonzero(active)[0]:
                    d = load_probe(t_start + elapsed_lat[i])
                    delays[i] = [d.get(e, 0.0) for e in engines]

        t0 = time.perf_counter()
        plan = plan_step(u, elapsed_lat.astype(np.float32), elapsed_cost,
                         delays)
        # one copy of the (2, B) plan; waits until the round is done on the
        # device
        _, nxts = plan.cpu().numpy()
        replan_s = time.perf_counter() - t0

        n_active = int(active.sum())
        overhead[active] += replan_s / n_active
        stats.rounds += 1
        stats.replan_s_per_round.append(replan_s)
        stats.active_per_round.append(n_active)

        # this round's per-engine occupancy (requests actually invoking)
        stepping = active & (nxts >= 0)
        counts = np.bincount(
            engine_of_model[nxts[stepping]], minlength=E).astype(np.int64)
        stats.inflight_per_round.append(
            {e: int(counts[j]) for j, e in enumerate(engines)})

        for i in np.nonzero(active)[0]:
            m = int(nxts[i])
            if m < 0:
                active[i] = False  # no feasible continuation: stop here
                continue
            d = int(trie.depth[u[i]])
            s, c, lat = executor(
                int(requests[i]), d, m, t_start + elapsed_lat[i])
            if fleet_load is not None:
                ei = int(engine_of_model[m])
                lat = lat * float(
                    fleet_load.slowdown(engines[ei], int(counts[ei]) - 1))
            elapsed_cost[i] += c
            elapsed_lat[i] += lat
            models[i].append(m)
            u[i] = trie.child[u[i], m]
            if s:
                success[i] = True
                active[i] = False
            elif int(trie.depth[u[i]]) >= max_depth:
                active[i] = False
        inflight = counts

    results = []
    for i in range(B):
        slo = obj.lat_cap is not None and elapsed_lat[i] > obj.lat_cap + 1e-9
        results.append(ExecutionResult(
            success=bool(success[i]),
            total_cost=float(elapsed_cost[i]),
            total_lat=float(elapsed_lat[i]),
            models=models[i],
            n_stages=len(models[i]),
            replan_overhead_s=float(overhead[i]),
            slo_violated=bool(slo),
        ))
    return results, stats
