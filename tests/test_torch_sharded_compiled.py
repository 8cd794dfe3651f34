"""The port's sharded compiled event engine against `repro`'s.

`run_events_compiled(devices=N)` keeps the whole engine state on every
rank and plans each replan round's lanes of residue class ``lane % N ==
rank``, merging the plans in one collective.  Here it runs in spawned
gloo groups of 2 and 3 ranks on the CPU (`repro_torch.dist.spawn`, every
case in turn through `repro_torch.dist.runs.run_cases`), on the cases of
`tests/test_sharded.py`:

- seed 3, load-aware under the predictive gate (capacity 6, and 7);
- seed 7, two priority classes with preemption under the cost-aware gate;
- seed 11 with ``stream=True``: the summary, sketch bin for bin;
- seed 9 split into two halves, each drained with ``stream=True``: the
  halves' sketches merge exactly (`merge_stream_summaries`);
- and `test_admission.py`'s cost-aware overload, whose rounds plan
  downgraded lanes (the downgrade plan runs on each rank's own lanes
  before the merge, so a round still makes one collective).

Every record must equal, with no tolerance, the port's single-device
run, `repro`'s single-device run (in process, under the ``x64`` shim of
`test_torch_events_compiled.py`) and `repro`'s sharded run at 4 virtual
devices, which runs in one subprocess that sets ``XLA_FLAGS`` and the
same shim before it imports jax.  `collectives` must count exactly one
per replan round (``stats.replans``), and the ranks' host reads must
equal the single-device run's.
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
from test_torch_events_compiled import _load, _port_random_setup

from repro_torch.core.controller import Objective
from repro_torch.core.events_compiled import (
    merge_stream_summaries,
    run_events_compiled,
)
from repro_torch.core.runtime import make_workload_executor
from repro_torch.core.workload import SLOClass
from repro_torch.device import host_reads
from repro_torch.dist import spawn
from repro_torch.dist.runs import events_record, run_cases
from repro_torch.serving import loadsim as pl

WORLDS = (2, 3)
DEADLINE_S = 300.0  # a group's whole run; collectives time out at 60 s
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = {"load_aware_3": 3, "load_aware_3_c7": 3, "priorities_7": 7,
         "stream_11": 11, "split_9_a": 9, "split_9_b": 9}
NAMES = tuple(SEEDS) + ("downgrade",)

# `repro`'s sharded runs: the same cases at 4 virtual devices
_REPRO_SHARDED = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = ["src", "tests"]
import jax, jax.experimental
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
assert len(jax.devices()) == 4
from repro.core.events_compiled import run_events_compiled
from repro_torch.dist.runs import events_record
import test_torch_sharded_compiled as T
out = {}
for name in T.NAMES:
    c = T.case_inputs(name)
    out[name] = events_record(run_events_compiled(*c["rargs"], devices=4,
                                                  **c["rkw"]))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _downgrade_inputs():
    """`test_admission.test_cost_aware_overload_shed_and_downgrade`'s
    overload in both packages: NL2SQL-2, 48 requests at 12 rps into 24
    slots under ``CostAwareShed(max_occupancy=3)``, so replan rounds plan
    downgraded lanes min-cost."""
    import repro.core.admission as ra
    import repro.core.presets as rp
    import repro.core.runtime as rr
    import repro.core.trie as rt
    import repro.core.workload as rw
    import repro.serving.loadsim as rl
    from repro.core.controller import Objective as RObjective

    from repro_torch.core import presets
    from repro_torch.core.admission import CostAwareShed
    from repro_torch.core.trie import Trie
    from repro_torch.core.workload import generate_workload

    out = {}
    for pkg, (P, T, W, R, L, A, O) in {
            "": (presets, Trie, generate_workload, make_workload_executor,
                 pl, CostAwareShed, Objective),
            "r": (rp, rt.Trie, rw.generate_workload,
                  rr.make_workload_executor, rl, ra.CostAwareShed,
                  RObjective)}.items():
        tpl = P.nl2sql_2()
        trie = T.build(tpl)
        wl = W(tpl, 200, seed=3)
        ann = wl.exact_annotations(trie)
        engines = sorted({m.engine for m in tpl.models})
        obj = O("max_acc",
                cost_cap=float(np.quantile(ann.cost[trie.terminal], 0.6)),
                lat_cap=float(np.quantile(ann.lat[trie.terminal], 0.9)))
        out[pkg + "args"] = (trie, ann, obj, np.arange(48), R(wl))
        out[pkg + "kw"] = dict(
            arrivals=rw.poisson_arrivals(48, rate=12.0, seed=5),
            capacity=24, policy="dynamic_load_aware",
            fleet_load=_load(L, engines, 2),
            admission=A(max_occupancy=3))
    return out


def case_inputs(name):
    """One case in both packages: `test_sharded._run_pair`'s serving
    setup (`test_events_compiled._serving_setup`) and knobs."""
    import repro.core.workload as rwm
    from repro.core.controller import Objective as RObjective
    from test_events_compiled import _serving_setup

    if name == "downgrade":
        return _downgrade_inputs()
    seed = SEEDS[name]
    n, rate = (32, 4.0) if name.startswith("split") else (24, 3.0)
    rtrie, rann, rexec, rload, reqs, arrivals, lat_q = _serving_setup(
        seed, n=n, rate=rate)
    trie, wl, ann = _port_random_setup(seed)
    engines = sorted({m.engine for m in trie.template.models})
    if name == "priorities_7":
        obj = dict(lat_cap=lat_q)
        kw = dict(arrivals=arrivals, capacity=5, admission="cost_aware",
                  classes=np.arange(len(reqs)) % 2, preempt=True)
        rkw = dict(kw, class_specs=(
            rwm.SLOClass("hi", deadline_s=lat_q * 0.75, weight=4.0),
            rwm.SLOClass("lo", deadline_s=None, weight=1.0)))
        pkw = dict(kw, class_specs=(
            SLOClass("hi", deadline_s=lat_q * 0.75, weight=4.0),
            SLOClass("lo", deadline_s=None, weight=1.0)))
    else:
        obj = dict(cost_cap=np.inf, lat_cap=lat_q)
        kw = dict(arrivals=arrivals, capacity=6, policy="dynamic_load_aware",
                  admission="predictive")
        if name == "load_aware_3_c7":
            kw["capacity"] = 7
        if name == "stream_11":
            kw["stream"] = True
        if name.startswith("split"):
            part = slice(0, 16) if name.endswith("a") else slice(16, 32)
            arr = arrivals[part]
            reqs = reqs[part]
            kw.update(arrivals=arr - arr.min(), capacity=4,
                      admission="feasibility", stream=True)
        rkw = dict(kw, fleet_load=rload)
        pkw = dict(kw, fleet_load=_load(pl, engines, 2))
    return dict(
        args=(trie, ann, Objective("max_acc", **obj), reqs,
              make_workload_executor(wl)), kw=pkw,
        rargs=(rtrie, rann, RObjective("max_acc", **obj), reqs, rexec),
        rkw=rkw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases through spawned groups of 2 and 3 ranks, the port on one
    device, `repro` on one device and `repro` at 4 virtual devices."""
    from repro.core.events_compiled import run_events_compiled as r_comp

    out_path = tmp_path_factory.mktemp("repro_sharded") / "records.pkl"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", _REPRO_SHARDED,
                             str(out_path)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        cases = {n: case_inputs(n) for n in NAMES}
        port_cases = [{"kind": "events", "args": cases[n]["args"],
                       "kw": dict(cases[n]["kw"], compiled=True)}
                      for n in NAMES]
        groups = {w: spawn(run_cases, w, device="cpu", args=(port_cases,),
                        deadline_s=DEADLINE_S)
                  for w in WORLDS}
        single, reads = {}, {}
        for n in NAMES:
            r0 = host_reads()
            single[n] = events_record(run_events_compiled(
                *cases[n]["args"], device="cpu", **cases[n]["kw"]))
            reads[n] = host_reads() - r0
        ref = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.experimental, "enable_x64",
                       lambda: jax.enable_x64(True), raising=False)
            for n in NAMES:
                ref[n] = events_record(r_comp(*cases[n]["rargs"],
                                              **cases[n]["rkw"]))
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    with open(out_path, "rb") as f:
        ref4 = pickle.load(f)
    return dict(groups=groups, single=single, reads=reads, ref=ref,
                ref4=ref4,
                sharded={w: dict(zip(NAMES, g["records"]))
                         for w, g in groups.items()})


def _bare(rec):
    return {k: v for k, v in rec.items() if k != "measure"}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_engine_bitwise_identical(runs, world, name):
    """Every disposition, timestamp, count and summary of the sharded
    engine equals the single-device run, the port's and `repro`'s."""
    got = _bare(runs["sharded"][world][name])
    assert got == runs["single"][name]
    assert got == runs["ref"][name]
    assert got["counts"]["replans"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_port_equals_repro_sharded_at_4_devices(runs, name):
    assert runs["single"][name] == runs["ref4"][name]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_one_collective_per_replan_round(runs, world, name):
    """Exactly one collective per replan round, and the single-device
    engine's host reads."""
    rec = runs["sharded"][world][name]
    assert rec["measure"]["collectives"] == rec["counts"]["replans"]
    assert rec["measure"]["host_reads"] == runs["reads"][name]


def test_cases_reach_their_paths(runs):
    one = runs["single"]
    assert one["priorities_7"]["counts"]["preemptions"] > 0
    assert one["load_aware_3"]["counts"]["rejected"] + \
        one["load_aware_3"]["counts"]["shed"] > 0
    assert one["stream_11"]["summary"]["n_requests"] == 24
    assert one["downgrade"]["counts"]["downgraded"] > 0
    assert "results" not in one["stream_11"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stream_summary_exactly_single_device(runs, world):
    """The summary, its full sketch state included, bin for bin."""
    got = runs["sharded"][world]["stream_11"]["summary"]
    want = runs["single"]["stream_11"]["summary"]
    assert got == want
    assert got["sketch"]["counts"] == want["sketch"]["counts"]
    assert sum(got["sketch"]["counts"]) == got["latency"]["count"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_merged_shard_sketches_equal_union_sketch(runs, world):
    """Drains of a split trace merge exactly: counts add bin for bin, and
    the merge of the sharded halves is the merge of the single-device
    halves and of `repro`'s."""
    halves = [runs["sharded"][world][f"split_9_{h}"]["summary"]
              for h in "ab"]
    merged = merge_stream_summaries(*halves)
    assert merged["n_requests"] == 32
    total = np.array(merged["sketch"]["counts"])
    parts = [np.array(h["sketch"]["counts"]) for h in halves]
    np.testing.assert_array_equal(total, parts[0] + parts[1])
    assert merged["latency"]["count"] == sum(h["latency"]["count"]
                                             for h in halves)
    one = merge_stream_summaries(*(runs["single"][f"split_9_{h}"]["summary"]
                                   for h in "ab"))
    assert merged == one
    ref = [runs["ref"][f"split_9_{h}"]["summary"] for h in "ab"]
    assert merged["sketch"] == merge_stream_summaries(*ref)["sketch"]


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_agrees(runs, world):
    g = runs["groups"][world]
    assert g["rank"] == 0 and len(g["digests"]) == world
    assert len(set(g["digests"])) == 1
