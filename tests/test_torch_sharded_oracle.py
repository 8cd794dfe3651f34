"""The oracle's scenarios through the port's sharded compiled engine.

`tests/test_sharded.py` re-runs `oracle_sim`'s random, chaos and drift
sweeps through `repro`'s compiled engine on a lane mesh.  Here two seeds
of each (the first two of `repro`'s sweep seeds that draw no token
calendar, capacities 1 to 3, so at 2 ranks one rank may own no lane at
all) run through `run_events_compiled(devices=2)` in one spawned gloo
group of 2 ranks on the CPU, and each run must equal, with no tolerance,
the port's single-device run (which must match the oracle, as
`test_torch_oracle.py` holds it), `repro`'s single-device compiled run
(under the ``x64`` shim of `test_torch_events_compiled.py`) and `repro`'s
compiled run at 4 virtual devices (one subprocess that sets
``XLA_FLAGS`` and the shim before it imports jax).  The stage executor is
`shardlib.ScenarioExecutor` over the scenario's tables, so it pickles to
the ranks.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import torch
from oracle_sim import (
    BACKOFF_BASE,
    BACKOFF_CAP,
    BACKOFF_FACTOR,
    CLASS_WEIGHTS,
    FAULT_MAX_RETRIES,
    random_chaos_scenario,
    random_drift_scenario,
    random_scenario,
    run_subject,
)
from shardlib import ScenarioExecutor
from test_torch_oracle import _assert_matches_oracle, _chain_ann, _chain_setup

from repro_torch.core.controller import Objective
from repro_torch.core.events_compiled import run_events_compiled
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.workload import SLOClass
from repro_torch.dist import spawn
from repro_torch.dist.runs import events_record, run_cases
from repro_torch.serving.loadsim import EngineLoadModel, FleetLoadModel

WORLD = 2
DEADLINE_S = 300.0  # a group's whole run; collectives time out at 60 s
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = {"random": (random_scenario, (0, 35)),
             "chaos": (random_chaos_scenario, (12, 18)),
             "drift": (random_drift_scenario, (0, 8))}
NAMES = tuple(f"{k}_{s}" for k, (_, seeds) in SCENARIOS.items()
              for s in seeds)

_REPRO_SHARDED = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = ["src", "tests"]
import jax, jax.experimental
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
assert len(jax.devices()) == 4
from oracle_sim import run_subject
from repro_torch.dist.runs import events_record
import test_torch_sharded_oracle as T
out = {n: events_record(run_subject(T.scenario(n), "compiled", devices=4))
       for n in T.NAMES}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def scenario(name):
    kind, seed = name.rsplit("_", 1)
    return SCENARIOS[kind][0](int(seed))


def port_inputs(sc):
    """`test_torch_oracle._run_port`'s compiled run as picklable inputs:
    ``(args, kw)`` of `run_events_compiled`."""
    trie, ann = _chain_setup(sc)
    kw = {}
    if sc.concurrency is not None:
        engines = {f"e{e}": EngineLoadModel(f"e{e}",
                                            concurrency=sc.concurrency,
                                            jitter=0.0)
                   for e in range(sc.n_engines)}
        kw = dict(policy="dynamic_load_aware", fleet_load=FleetLoadModel(
            engines=engines, mean_service_s={e: 1.0 for e in engines}))
    if sc.outages or sc.failure_table is not None:
        kw["faults"] = FaultSchedule(
            outages=sc.outages, failure_table=sc.failure_table,
            max_retries=FAULT_MAX_RETRIES, backoff_base=BACKOFF_BASE,
            backoff_factor=BACKOFF_FACTOR, backoff_cap=BACKOFF_CAP)
    specs = None if sc.classes is None else (
        SLOClass("interactive", deadline_s=sc.class_caps[0],
                 weight=CLASS_WEIGHTS[0]),
        SLOClass("batch", deadline_s=sc.class_caps[1],
                 weight=CLASS_WEIGHTS[1]))
    sched = [(float(ts), _chain_ann(trie, step)) for ts, step in sc.drift] \
        or None
    kw.update(arrivals=sc.arrivals, capacity=sc.capacity,
              admission=sc.admission, classes=sc.classes, class_specs=specs,
              preempt=sc.preempt, annotation_schedule=sched)
    args = (trie, ann, Objective("max_acc", lat_cap=sc.lat_cap),
            np.arange(sc.n_requests),
            ScenarioExecutor(sc.succ, sc.cost, sc.work))
    return args, kw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_path = tmp_path_factory.mktemp("repro_sharded") / "records.pkl"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", _REPRO_SHARDED,
                             str(out_path)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        inputs = {n: port_inputs(scenario(n)) for n in NAMES}
        group = spawn(run_cases, WORLD, device="cpu", args=(
            [{"kind": "events", "args": inputs[n][0],
              "kw": dict(inputs[n][1], compiled=True)} for n in NAMES],),
            deadline_s=DEADLINE_S)
        single = {n: events_record(run_events_compiled(
            *inputs[n][0], device="cpu", **inputs[n][1])) for n in NAMES}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.experimental, "enable_x64",
                       lambda: jax.enable_x64(True), raising=False)
            ref = {n: events_record(run_subject(scenario(n), "compiled"))
                   for n in NAMES}
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    with open(out_path, "rb") as f:
        ref4 = pickle.load(f)
    return dict(group=group, sharded=dict(zip(NAMES, group["records"])),
                single=single, ref=ref, ref4=ref4)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_scenario_matches_single_device_and_repro(runs, name):
    got = {k: v for k, v in runs["sharded"][name].items() if k != "measure"}
    assert got == runs["single"][name]
    assert got == runs["ref"][name]
    assert got == runs["ref4"][name]


@pytest.mark.parametrize("name", NAMES)
def test_single_device_scenario_matches_oracle(name):
    """The single-device run the sharded one is held to matches the
    oracle (`test_torch_oracle`'s check, its own executor)."""
    _assert_matches_oracle(scenario(name), compiled=True)


@pytest.mark.parametrize("name", NAMES)
def test_scenario_one_collective_per_replan_round(runs, name):
    rec = runs["sharded"][name]
    assert rec["measure"]["collectives"] == rec["counts"]["replans"] > 0


def test_scenarios_reach_their_paths(runs):
    c = {n: runs["single"][n]["counts"] for n in NAMES}
    assert all(c[f"drift_{s}"]["annotation_swaps"] > 0 for s in (0, 8))
    assert sum(c[f"chaos_{s}"]["engine_outages"] for s in (12, 18)) > 0
    assert sum(c[f"chaos_{s}"]["stage_failures"] for s in (12, 18)) > 0
    assert min(scenario(n).capacity for n in NAMES) < WORLD


def test_every_rank_agrees(runs):
    g = runs["group"]
    assert g["rank"] == 0 and len(g["digests"]) == WORLD
    assert len(set(g["digests"])) == 1
