"""What a rank of a spawned group runs to drive the sharded control plane.

`run_cases` is the function `repro_torch.dist.spawn` hands the ranks: it
runs each case through the port's sharded entry points on every rank and
returns this rank's records with every rank's digest of them.  A case is
a dict of picklable inputs:

- ``{"kind": "planner", "trie", "ann", "obj", "capacity", "steps"}``
  builds a `ResidentPlanner` with ``mesh=`` over the trie and runs the
  steps in order: ``("update", slots, u, el, ec)``, ``("loads", slots,
  engines, weights)``, ``("replan", row, blocked)`` and ``("coupled",
  conc, ms, hasm, blocked)``;
- ``{"kind": "events", "args": (trie, ann, obj, requests, executor),
  "kw": {...}}`` calls ``run_events(*args, devices=<group size>, **kw)``
  (``compiled=True`` in ``kw`` runs the compiled engine);
- ``{"kind": "merge", "lanes", "calls"}`` times the plan merge alone.

Each record holds what the single-device run must reproduce bit for bit
(`planner_record`'s plans, `events_record`) and, under ``"measure"``,
what this rank counted and timed: collectives, host reads, trie_plan
launches and wall time.  The digests cover everything but the measures.
"""
from __future__ import annotations

import hashlib
import pickle
import time

import numpy as np
import torch

from repro_torch.core.controller_torch import TrieDevice, make_resident_planner
from repro_torch.core.events import run_events
from repro_torch.device import host_reads
from repro_torch.dist.sharding import (
    LaneMesh,
    collectives,
    gather_objects,
    lane_block,
    merge_plans,
)
from repro_torch.kernels import _build

COUNTS = ("events", "replans", "admitted", "rejected", "shed", "downgraded",
          "preemptions", "resumed", "explored", "annotation_swaps",
          "engine_outages", "engine_recoveries", "checkpointed",
          "stage_failures", "timeouts", "fault_retries", "failed")


def events_record(out) -> dict:
    """Everything two runs of the event runtime must share bit for bit:
    every `ExecutionResult` field but the wall-clock
    ``replan_overhead_s``, the timelines, outcomes, preemption counts,
    peak occupancy, annotation versions and the `EventStats` counts, or,
    for a ``stream=True`` run, the summary whole."""
    res, stats = out
    rec = {"counts": {k: int(getattr(stats, k)) for k in COUNTS},
           "peak": {e: int(v) for e, v in stats.peak_occupancy.items()},
           "stage_versions": [[int(x) for x in v]
                              for v in stats.stage_versions],
           "planned_per_replan": [int(x) for x in stats.planned_per_replan]}
    if isinstance(res, dict):
        rec["summary"] = res
        return rec
    rec.update(
        results=[(bool(r.success), float(r.total_cost), float(r.total_lat),
                  [int(m) for m in r.models], int(r.n_stages),
                  bool(r.slo_violated), str(r.outcome)) for r in res],
        done_t=[float(x) for x in stats.done_t],
        admit_t=[float(x) for x in stats.admit_t],
        preempt_count=[int(x) for x in stats.preempt_count],
        outcome=[str(o) for o in stats.outcome])
    return rec


def planner_record(plans) -> list:
    """A planner's outputs as lists: ``(targets, next_models)`` of each
    replan, with the delay row after them for a coupled one."""
    return [[np.asarray(a).tolist() for a in p] for p in plans]


def digest(records) -> str:
    """sha256 of the records without their measures."""
    bare = [{k: v for k, v in r.items() if k != "measure"} for r in records]
    return hashlib.sha256(pickle.dumps(bare, protocol=4)).hexdigest()


class _Meter:
    """Collectives, host reads and trie_plan launches made, and wall time
    taken, since it was made (synchronizing the device first and last)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._sync()
        self.c0, self.r0 = collectives(), host_reads()
        self.l0 = _build.LAUNCHES["trie_plan"]
        self.t0 = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def read(self) -> dict:
        self._sync()
        return {"s": time.perf_counter() - self.t0,
                "collectives": collectives() - self.c0,
                "host_reads": host_reads() - self.r0,
                "launches": _build.LAUNCHES["trie_plan"] - self.l0}


def _planner_case(mesh: LaneMesh, case: dict) -> dict:
    td = TrieDevice.build(case["trie"], case["ann"], device=mesh.device)
    p = make_resident_planner(td, case["obj"], case["capacity"], mesh=mesh)
    plans, per_call = [], []
    for kind, *a in case["steps"]:
        if kind == "update":
            p.update(*a)
        elif kind == "loads":
            p.update_loads(*a)
        else:
            m = _Meter(mesh.device)
            plans.append(p.replan(*a) if kind == "replan"
                         else p.replan_coupled(*a))
            per_call.append(dict(m.read(), kind=kind))
    return {"plans": planner_record(plans), "measure": {"calls": per_call}}


def _events_case(mesh: LaneMesh, case: dict) -> dict:
    m = _Meter(mesh.device)
    out = run_events(*case["args"], devices=mesh.size,
                     device=mesh.device.type, **case["kw"])
    measure = m.read()
    measure["replan_s"] = [float(x) for x in out[1].replan_s]
    return dict(events_record(out), measure=measure)


def _merge_case(mesh: LaneMesh, case: dict) -> dict:
    """The plan merge alone: ``calls`` merges of a (2, lanes) int32 plan
    tensor on this rank's device, this rank owning its block of lanes,
    each timed (device copies included)."""
    n = case["lanes"]
    base, per = lane_block(n, mesh)
    plans = torch.arange(2 * n, dtype=torch.int32,
                         device=mesh.device).view(2, n)
    owned = torch.zeros(n, dtype=torch.bool, device=mesh.device)
    owned[base:base + per] = True
    us = []
    for _ in range(case["calls"]):
        m = _Meter(mesh.device)
        out = merge_plans(plans, owned, mesh).cpu()
        us.append(m.read()["s"] * 1e6)
    return {"merged": out.tolist(), "measure": {"us": us}}


_RUNNERS = {"planner": _planner_case, "events": _events_case,
            "merge": _merge_case}


def run_cases(mesh: LaneMesh, cases: list, t_spawn: float | None = None
              ) -> dict:
    """Run ``cases`` in order on this rank (see the module docstring);
    returns ``{"rank", "records", "digests", "measures", "times"}``: this
    rank's records, and every rank's digest of its records, its measures
    and its times, in rank order (one collective).  ``times`` holds the
    seconds from ``t_spawn`` (the parent's `time.time()` when it called
    `spawn`, if given) to this rank's first case, and the seconds the
    cases took."""
    t0 = time.time()
    records = [_RUNNERS[c["kind"]](mesh, c) for c in cases]
    times = {"start_s": None if t_spawn is None else t0 - t_spawn,
             "cases_s": time.time() - t0}
    ranks = gather_objects((digest(records),
                            [r["measure"] for r in records], times), mesh)
    return {"rank": mesh.rank, "records": records,
            "digests": [d for d, _, _ in ranks],
            "measures": [m for _, m, _ in ranks],
            "times": [t for _, _, t in ranks]}
