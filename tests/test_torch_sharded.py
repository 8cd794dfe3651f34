"""The port's lane-sharded planner and host loop against `repro`'s.

`repro`'s contract (`tests/test_sharded.py`): at any device count every
plan, disposition and timestamp equals the single-device run bit for
bit.  Here the port's sharded control plane runs on `torch.distributed`
over gloo, in spawned groups of 2 and 3 ranks on the CPU
(`repro_torch.dist.spawn`), each group running every case in turn
(`repro_torch.dist.runs.run_cases`) and returning rank 0's records with
every rank's digest.  The cases are those of `tests/test_sharded.py`:

- the lane helpers and the refusals (`lane_counts`, `lane_mesh`, the
  unsharded planner's load-coupled calls, `spawn`'s own);
- the sharded `ResidentPlanner`'s ``replan`` over three random rounds and
  ``replan_coupled`` with its expected delay row, at capacities 6 and 7
  (7 pads its lanes at both group sizes);
- the host loop (`run_events(devices=N)`) at seed 5, capacities 6 and 7.

Each is held, with no tolerance, against the port's single-device run
and `repro`'s single-device run on the same numpy inputs
(``replan_overhead_s``, wall time, is not compared).  `collectives`
must count exactly one per ``replan``, two per ``replan_coupled`` and one
per replan of the host loop.  The compiled engine's cases are in
`test_torch_sharded_compiled.py` and `test_torch_sharded_oracle.py`.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from fleetlib import random_setup
from test_torch_events_compiled import _load, _port_random_setup

from repro_torch.core.controller import Objective
from repro_torch.core.controller_torch import (
    TrieDevice,
    make_resident_planner,
    trie_engines,
)
from repro_torch.core.events import run_events
from repro_torch.core.runtime import make_workload_executor
from repro_torch.dist import (
    LANE_AXIS,
    lane_block,
    lane_counts,
    lane_mesh,
    one_rank_group,
    spawn,
)
from repro_torch.dist.runs import events_record, planner_record, run_cases
from repro_torch.serving import loadsim as pl

WORLDS = (2, 3)
DEADLINE_S = 300.0  # a group's whole run; collectives time out at 60 s
CAPACITIES = (6, 7)
HOST_SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ----------------------------------------------------------------------
# the cases, on numpy inputs shared by both packages
# ----------------------------------------------------------------------
def _planner_inputs(capacity, seed=1):
    """`test_sharded._planner_pair`'s trie and objective in both
    packages, and three rounds of random lane updates and delay rows
    drawn for ``capacity`` lanes, then a coupled replan over every lane
    (integer weights, so the float row is exact in any order)."""
    from repro.core.controller import Objective as RObjective

    _, rtrie, _, rann = random_setup(seed)
    trie, _, ann = _port_random_setup(seed)
    cap = float(np.quantile(ann.lat[trie.terminal], 0.7))
    E = len(trie_engines(trie.template))
    rng = np.random.default_rng(capacity)
    steps = []
    for _ in range(3):
        k = int(rng.integers(1, capacity + 1))
        slots = rng.choice(capacity, size=k, replace=False)
        steps.append(("update", slots,
                      rng.integers(0, trie.n_nodes, k).astype(np.int32),
                      rng.random(k, dtype=np.float32),
                      rng.random(k, dtype=np.float32)))
        steps.append(("replan", rng.random(E).astype(np.float32), None))
    slots = np.arange(capacity)
    steps.append(("update", slots,
                  rng.integers(0, trie.n_nodes, capacity).astype(np.int32),
                  rng.random(capacity, dtype=np.float32),
                  rng.random(capacity, dtype=np.float32)))
    park = np.array([(0, 1 % E, -1)[i % 3] for i in slots], np.int32)
    w = np.array([(1, 1, 0, 2, 1, 0, 3)[i % 7] for i in slots], np.float32)
    steps.append(("loads", slots, park, w))
    conc, ms, hasm = np.full(E, 2.0), np.ones(E), np.ones(E, bool)
    steps.append(("coupled", conc, ms, hasm, None))
    return dict(trie=trie, ann=ann, obj=Objective("max_acc", lat_cap=cap),
                capacity=capacity, steps=steps, rtrie=rtrie, rann=rann,
                robj=RObjective("max_acc", lat_cap=cap))


def _expected_row(case):
    """The coupled replan's delay row from the host side: occupancy
    summed per engine, the slowdown in float32, as `repro`'s test
    computes it."""
    _, slots, park, w = next(s for s in case["steps"] if s[0] == "loads")
    _, conc, ms, hasm, _ = case["steps"][-1]
    occ = np.zeros(len(conc), np.float32)
    for e, wv in zip(park, w):
        if e >= 0:
            occ[e] += wv
    return np.where(hasm, (np.maximum(1.0, (occ + 1.0) / conc) - 1.0) * ms,
                    0.0).astype(np.float32)


def _single_plans(make, case):
    """The steps through an unsharded planner; the coupled replan becomes
    a plain replan against the expected row."""
    p = make()
    plans = []
    for kind, *a in case["steps"]:
        if kind == "update":
            p.update(*a)
        elif kind == "replan":
            plans.append(p.replan(*a))
        elif kind == "coupled":
            row = _expected_row(case)
            plans.append((*p.replan(row), row))
    return planner_record(plans)


def _host_inputs(capacity, seed=HOST_SEED):
    """`test_sharded.test_sharded_host_loop_matches_single_device`'s run
    (`test_events_compiled._serving_setup`) in both packages."""
    from repro.core.controller import Objective as RObjective
    from test_events_compiled import _serving_setup

    rtrie, rann, rexec, rload, reqs, arrivals, lat_q = _serving_setup(seed)
    trie, wl, ann = _port_random_setup(seed)
    engines = sorted({m.engine for m in trie.template.models})
    kw = dict(arrivals=arrivals, capacity=capacity,
              policy="dynamic_load_aware", admission="predictive")
    return dict(
        args=(trie, ann, Objective("max_acc", cost_cap=np.inf, lat_cap=lat_q),
              reqs, make_workload_executor(wl)),
        kw=dict(kw, fleet_load=_load(pl, engines, 2)),
        rargs=(rtrie, rann, RObjective("max_acc", cost_cap=np.inf,
                                       lat_cap=lat_q), reqs, rexec),
        rkw=dict(kw, fleet_load=rload))


def _cases():
    out = {}
    for c in CAPACITIES:
        out[f"planner_c{c}"] = _planner_inputs(c)
        out[f"host_c{c}"] = _host_inputs(c)
    return out


def _port_case(case):
    if "steps" in case:
        return {"kind": "planner",
                **{k: case[k] for k in ("trie", "ann", "obj", "capacity",
                                        "steps")}}
    return {"kind": "events", "args": case["args"], "kw": case["kw"]}


@pytest.fixture(scope="module")
def runs():
    """The cases through spawned groups of 2 and 3 ranks, the port on one
    device and `repro` on one device."""
    from repro.core import controller_jax as jc
    from repro.core.events import run_events as r_run

    cases = _cases()
    names = sorted(cases)
    groups = {w: spawn(run_cases, w, device="cpu",
                       args=([_port_case(cases[n]) for n in names],),
                       deadline_s=DEADLINE_S)
              for w in WORLDS}
    sharded = {w: dict(zip(names, g["records"])) for w, g in groups.items()}
    single, ref = {}, {}
    for n in names:
        c = cases[n]
        if "steps" in c:
            td = TrieDevice.build(c["trie"], c["ann"], device="cpu")
            single[n] = {"plans": _single_plans(
                lambda: make_resident_planner(td, c["obj"], c["capacity"]),
                c)}
            jtd = jc.TrieDevice.build(c["rtrie"], c["rann"])
            ref[n] = {"plans": _single_plans(
                lambda: jc.make_resident_planner(jtd, c["robj"],
                                                 c["capacity"]), c)}
        else:
            single[n] = events_record(run_events(*c["args"], device="cpu",
                                                 **c["kw"]))
            ref[n] = events_record(r_run(*c["rargs"], **c["rkw"]))
    return dict(cases=cases, groups=groups, sharded=sharded, single=single,
                ref=ref)


def _bare(rec):
    return {k: v for k, v in rec.items() if k != "measure"}


# ----------------------------------------------------------------------
# the lane helpers and the refusals
# ----------------------------------------------------------------------
def test_lane_counts_pads_to_device_multiple():
    class M:
        shape = {LANE_AXIS: 4}

    assert lane_counts(8, M()) == (8, 2)
    assert lane_counts(6, M()) == (8, 2)
    assert lane_counts(1, M()) == (4, 1)


def test_lane_mesh_error_names_the_recipe():
    with pytest.raises(ValueError, match="repro_torch.dist.spawn"):
        lane_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="nproc-per-node 3"):
        lane_mesh(3, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        lane_mesh(0, device="cpu")


def test_lane_mesh_of_a_one_rank_group():
    """In a group of one rank: a mesh of 2 is refused naming the group's
    size, a mesh of 1 owns every lane and plans as the unsharded planner
    does, with one collective a replan."""
    from repro_torch.dist import collectives

    case = _planner_inputs(7)
    with one_rank_group("gloo"):
        with pytest.raises(ValueError, match="holds 1"):
            lane_mesh(2, device="cpu")
        mesh = lane_mesh(1, device="cpu")
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        assert lane_block(7, mesh) == (0, 7)
        td = TrieDevice.build(case["trie"], case["ann"], device="cpu")
        c0 = collectives()
        got = _single_plans(lambda: make_resident_planner(
            td, case["obj"], 7, mesh=mesh), case)
        assert collectives() - c0 == 4
    assert not dist.is_initialized()
    want = _single_plans(lambda: make_resident_planner(td, case["obj"], 7),
                         case)
    assert got == want


def test_unsharded_planner_rejects_load_coupling():
    case = _planner_inputs(4)
    td = TrieDevice.build(case["trie"], case["ann"], device="cpu")
    p = make_resident_planner(td, case["obj"], 4)
    with pytest.raises(RuntimeError, match="mesh"):
        p.update_loads([0], [0], [1.0])
    with pytest.raises(RuntimeError, match="mesh"):
        p.replan_coupled([2.0], [1.0], [True])
    with pytest.raises(TypeError, match="LaneMesh"):
        make_resident_planner(td, case["obj"], 4, mesh="lanes")


def test_spawn_refusals():
    with pytest.raises(ValueError, match="world"):
        spawn(run_cases, 0, device="cpu", args=([],))
    with pytest.raises(ValueError, match="nccl"):
        spawn(run_cases, 2, device="cpu", backend="nccl", args=([],))
    with pytest.raises(ValueError, match="timeout_s"):
        spawn(run_cases, 2, device="cpu", args=([],), timeout_s=600)


def test_a_failing_rank_fails_the_group():
    """A case that raises in its ranks raises in the parent; a group past
    its deadline raises and leaves no rank running."""
    import torch.multiprocessing as mp

    with pytest.raises(mp.ProcessRaisedException, match="KeyError"):
        spawn(run_cases, 2, device="cpu", args=([{"kind": "nope"}],))
    with pytest.raises(TimeoutError, match="within"):
        spawn(run_cases, 2, device="cpu", args=([],), deadline_s=0.0)
    assert not mp.active_children()


# ----------------------------------------------------------------------
# the sharded planner and host loop, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_sharded_planner_replan_bitwise(runs, world, capacity):
    name = f"planner_c{capacity}"
    got = runs["sharded"][world][name]["plans"]
    assert got == runs["single"][name]["plans"]
    assert got == runs["ref"][name]["plans"]
    case = runs["cases"][name]
    assert lane_counts(capacity, type("M", (), {"shape": {LANE_AXIS: world}})
                       ) == (-(-capacity // world) * world,
                             -(-capacity // world))
    assert len(got) == sum(s[0] in ("replan", "coupled")
                           for s in case["steps"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_sharded_planner_coupled_row_exact(runs, world, capacity):
    """`replan_coupled` derives the expected float32 delay row from the
    occupancy columns and plans as a plain replan against it."""
    name = f"planner_c{capacity}"
    tgt, nxt, row = runs["sharded"][world][name]["plans"][-1]
    exp = _expected_row(runs["cases"][name])
    assert np.array_equal(np.asarray(row, np.float32), exp)
    assert np.asarray(row, np.float32).tobytes() == exp.tobytes()
    assert exp.any()  # the occupancy reached the row
    assert [tgt, nxt] == runs["ref"][name]["plans"][-1][:2]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_sharded_planner_collectives(runs, world, capacity):
    """Exactly one collective per ``replan`` (the plan merge) and two per
    ``replan_coupled`` (the occupancy row, then the merge)."""
    calls = runs["sharded"][world][f"planner_c{capacity}"]["measure"][
        "calls"]
    assert [c["collectives"] for c in calls] == [
        1 if c["kind"] == "replan" else 2 for c in calls]
    assert [c["kind"] for c in calls] == ["replan"] * 3 + ["coupled"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_sharded_host_loop_matches_single_device(runs, world, capacity):
    """The host event loop over the lane-sharded planner: every result
    but the wall-clock replan time, the timelines and counts equal the
    port's single-device loop and `repro`'s."""
    name = f"host_c{capacity}"
    got = _bare(runs["sharded"][world][name])
    assert got == runs["single"][name]
    assert got == runs["ref"][name]
    assert got["counts"]["replans"] > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_sharded_host_loop_one_collective_per_replan(runs, world, capacity):
    rec = runs["sharded"][world][f"host_c{capacity}"]
    assert rec["measure"]["collectives"] == rec["counts"]["replans"]
    assert rec["measure"]["host_reads"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_agrees(runs, world):
    g = runs["groups"][world]
    assert g["rank"] == 0 and len(g["digests"]) == world
    assert len(set(g["digests"])) == 1
