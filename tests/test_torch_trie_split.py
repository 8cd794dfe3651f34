"""The replan kernel's decomposition and the packed launch path.

`trie_plan.fleet_plan_split` cuts the replan the way `csrc/trie_plan.cu`
does (lanes in blocks, each lane's interval in contiguous slices whose
partial minima merge on the full key tuple).  It must pick exactly the
same ``(target, next_model)`` as `repro`'s "dense", "fused" and "pallas"
(interpret mode) variants and, where every engine is up, as the host
float64 `select_path`, at any split count and lanes per block: tolerance
0, the answers are node indices.  `controller_torch.LanePlanner` packs the
lane operands into one buffer; it must plan as the unpacked call does and
leave the fleet runtime's results and `FleetStats` as they were.
"""
import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

from repro.core import presets as jpresets
from repro.core.controller import Objective as JObjective
from repro.core.controller_jax import TrieDevice as JTrieDevice
from repro.core.controller_jax import make_fleet_planner as jmake_fleet_planner
from repro.core.faults import blocked_depth_table
from repro.core.trie import Trie as JTrie
from repro.core.workload import generate_workload as jgenerate
from repro_torch.core import fleet as fleet_mod
from repro_torch.core import presets
from repro_torch.core.controller import Objective, select_path
from repro_torch.core.controller_torch import (
    LanePlanner,
    TrieDevice,
    _objective_scalars,
    make_fleet_planner,
    next_model_for,
    trie_engines,
)
from repro_torch.core.runtime import make_workload_executor
from repro_torch.core.trie import Trie
from repro_torch.core.workload import generate_workload
from repro_torch.kernels import ops
from repro_torch.kernels import trie_plan as tmod
from test_torch_fleet import _port_serve
from test_torch_trie_plan import _SIZES, _lanes, _objectives

_JAX_VARIANTS = ("dense", "fused", "pallas")


@functools.lru_cache(maxsize=None)
def _case(name):
    """(repro trie, annotations, device trie; port trie, annotations,
    CPU trie) of preset ``name``."""
    jtpl, tpl = jpresets.PRESETS[name](), presets.PRESETS[name]()
    jtrie, trie = JTrie.build(jtpl), Trie.build(tpl)
    jann = jgenerate(jtpl, _SIZES[name], seed=0).exact_annotations(jtrie)
    ann = generate_workload(tpl, _SIZES[name], seed=0).exact_annotations(trie)
    return (jtrie, jann, JTrieDevice.build(jtrie, jann), trie, ann,
            TrieDevice.build(trie, ann, device="cpu"))


def _blocked(td):
    """The blocked column when the engine of the last model is down."""
    down = np.zeros(td.n_engines, bool)
    down[int(td.engine_of_model[-1])] = True
    bd = blocked_depth_table(td.path_models.numpy(),
                             td.engine_of_model.numpy(), down)
    assert bd.max() > 0
    return bd


def _repro_plan(jtd, jobj, lanes, bd):
    """`repro`'s three variants, held equal; their (targets, next models)."""
    want = None
    for v in _JAX_VARIANTS:
        got = tuple(np.asarray(x) for x in jmake_fleet_planner(
            jtd, jobj, variant=v)(*lanes, bd))
        if want is None:
            want = got
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"repro {v}")
    return want


@functools.lru_cache(maxsize=None)
def _repro_cached(name, roots_mode, blocked):
    jtrie, jann, jtd, trie, ann, td = _case(name)
    lanes = _case_lanes(name, roots_mode)
    bd = _blocked(td) if blocked else None
    return [_repro_plan(jtd, jobj, lanes, bd)
            for _, jobj in _objectives(trie, ann)]


def _case_lanes(name, roots_mode):
    """`test_torch_trie_plan`'s lanes (random prefixes, infeasible and stop
    lanes), or the same lanes all at the root."""
    trie, ann = _case(name)[3:5]
    roots, el, ec, delays = _lanes(trie, ann, len(trie_engines(
        trie.template)), seed=len(name))
    if roots_mode == "root":
        roots = np.zeros_like(roots)
    return roots, el, ec, delays


def _split(td, obj, lanes, bd, **plan):
    roots, el, ec, delays = lanes
    t = torch.from_numpy
    return tmod.fleet_plan_split(
        td.terminal, td.depth, td.acc, td.cost, td.lat, td.subtree_size,
        td.path_models, td.path_counts, td.engine_of_model,
        t(np.ascontiguousarray(roots, np.int32)), t(el), t(ec), t(delays),
        *_objective_scalars(obj), kind=obj.kind,
        blocked_depth=None if bd is None else t(bd), **plan)


def _host(trie, ann, obj, lanes):
    roots, el, _, delays = lanes
    engines = trie_engines(trie.template)
    tgt = np.array([
        select_path(trie, ann, obj, root=int(roots[i]),
                    elapsed_lat=float(el[i]),
                    engine_delays={e: float(delays[i, j])
                                   for j, e in enumerate(engines)})
        for i in range(len(roots))])
    nxt = np.array([next_model_for(trie, int(roots[i]), int(tgt[i]))
                    for i in range(len(roots))])
    return tgt, nxt


def _assert_plan(got, want, msg):
    assert got[0].dtype == got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg=msg)
    np.testing.assert_array_equal(got[1].numpy(), want[1], err_msg=msg)


@pytest.mark.parametrize("name", sorted(_SIZES))
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("lanes_per_block", [1, 4, 32])
@pytest.mark.parametrize("blocked", [False, True])
def test_split_decomposition_matches_repro_and_host(name, splits,
                                                    lanes_per_block, blocked):
    """Random prefixes cut into slices of at least 4 nodes (the kernel
    takes 128; 4 cuts every trie here), every block size."""
    _, _, _, trie, ann, td = _case(name)
    lanes = _case_lanes(name, "random")
    bd = _blocked(td) if blocked else None
    for (obj, _), want in zip(_objectives(trie, ann),
                              _repro_cached(name, "random", blocked)):
        got = _split(td, obj, lanes, bd, splits=splits,
                     lanes_per_block=lanes_per_block, slice_nodes=4)
        _assert_plan(got, want, f"{name} {obj.kind} splits={splits}")
        if not blocked:
            _assert_plan(got, _host(trie, ann, obj, lanes), "host")


@pytest.mark.parametrize("name", sorted(_SIZES))
@pytest.mark.parametrize("splits", [1, 2, 3, 7, tmod.MAX_SPLITS])
def test_split_all_root_lanes(name, splits):
    """Every lane at the root (a fleet's first round) at the kernel's own
    slice size, and at 1 node a slice (as many slices as ``splits``)."""
    _, _, _, trie, ann, td = _case(name)
    lanes = _case_lanes(name, "root")
    for (obj, _), want in zip(_objectives(trie, ann),
                              _repro_cached(name, "root", False)):
        host = _host(trie, ann, obj, lanes)
        np.testing.assert_array_equal(want[0], host[0])
        for slice_nodes in (tmod.SLICE_NODES, 1):
            got = _split(td, obj, lanes, None, splits=splits,
                         lanes_per_block=8, slice_nodes=slice_nodes)
            _assert_plan(got, want, f"{name} {obj.kind} root "
                                    f"splits={splits} {slice_nodes}")


def _tied(name, kind, edit):
    """Annotations of preset ``name`` with ``edit(acc, cost, lat, v1, v2)``
    applied to copies in both packages, for the first and the last
    terminal node v1 < v2 of the deepest level (equal depth, in different
    slices of 7 at 1 node a slice at least); lanes all at the root with no
    delay or elapsed latency.  Returns what the tests compare."""
    jtrie, jann, _, trie, ann, _ = _case(name)
    term = np.nonzero(trie.terminal & (trie.depth == trie.depth.max()))[0]
    v1, v2 = int(term[0]), int(term[-1])
    n = trie.n_nodes
    assert v1 * 7 // n != v2 * 7 // n  # slices [n*s // 7, n*(s+1) // 7)
    arrays = [np.array(a, dtype=np.float64) for a in
              (ann.acc, ann.cost, ann.lat)]
    edit(*arrays, v1, v2)
    ann2 = dataclasses.replace(ann, acc=arrays[0], cost=arrays[1],
                               lat=arrays[2])
    jann2 = dataclasses.replace(jann, acc=arrays[0], cost=arrays[1],
                                lat=arrays[2])
    B = 3
    lanes = (np.zeros(B, np.int32), np.zeros(B, np.float32),
             np.zeros(B, np.float32),
             np.zeros((B, len(trie_engines(trie.template))), np.float32))
    obj = Objective(kind, acc_floor=-1.0 if kind == "min_cost" else None)
    jobj = JObjective(kind, acc_floor=obj.acc_floor)
    want = _repro_plan(JTrieDevice.build(jtrie, jann2), jobj, lanes, None)
    td = TrieDevice.build(trie, ann2, device="cpu")
    host = _host(trie, ann2, obj, lanes)
    np.testing.assert_array_equal(want[0], host[0])
    got = [_split(td, obj, lanes, None, splits=s, lanes_per_block=2,
                  slice_nodes=1) for s in (1, 2, 7)]
    return v1, v2, want, got


@pytest.mark.parametrize("name", ["nl2sql_2", "mathqa_4"])
@pytest.mark.parametrize("kind", ["max_acc", "min_cost"])
def test_split_boundary_tie_goes_to_lower_index(name, kind):
    """Two nodes with equal keys on either side of a slice boundary: the
    lower index wins, as in every `repro` variant and the host."""

    def edit(acc, cost, lat, v1, v2):
        acc[:], cost[:], lat[:] = 0.5, 2.0, 1.0
        acc[[v1, v2]], cost[[v1, v2]], lat[[v1, v2]] = 0.9, 1.0, 0.5

    v1, v2, want, got = _tied(name, kind, edit)
    assert (want[0] == v1).all()
    for g in got:
        _assert_plan(g, want, f"{name} {kind} tie")


@pytest.mark.parametrize("name", ["nl2sql_2", "mathqa_4"])
@pytest.mark.parametrize("cheaper", [False, True])
def test_negative_zero_key(name, cheaper):
    """k1 = -acc is -0.0 where acc is +0.0 and +0.0 where acc is -0.0: the
    two compare equal, so d_cost (``cheaper``: v2 costs less) and then the
    index decide, never the sign of zero."""

    def edit(acc, cost, lat, v1, v2):
        acc[:], cost[:], lat[:] = -1.0, 2.0, 1.0
        acc[v1], acc[v2] = 0.0, -0.0
        cost[[v1, v2]], lat[[v1, v2]] = 1.0, 0.5
        if cheaper:
            cost[v2] = 0.5

    v1, v2, want, got = _tied(name, "max_acc", edit)
    assert (want[0] == (v2 if cheaper else v1)).all()
    for g in got:
        _assert_plan(g, want, f"{name} -0.0 cheaper={cheaper}")


@pytest.mark.parametrize("B", [0, 1])
def test_split_zero_and_one_lane(B):
    name = "nl2sql_8"
    _, _, jtd, trie, ann, td = _case(name)
    lanes = tuple(a[:B] for a in _case_lanes(name, "root"))
    for obj, jobj in _objectives(trie, ann):
        got = _split(td, obj, lanes, None, splits=3, lanes_per_block=4,
                     slice_nodes=16)
        assert got[0].shape == got[1].shape == (B,)
        if B:
            _assert_plan(got, _repro_plan(jtd, jobj, lanes, None), "B=1")
        out = make_fleet_planner(td, obj)(*lanes)
        assert out.shape == (2, B) and out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), torch.stack(got).numpy())


def test_split_plan_is_a_function_of_shape():
    """The launch plan reads (lanes, nodes, SMs) and nothing of the lanes'
    prefixes: the wrapper never reads the device to pick it."""
    assert list(inspect.signature(tmod.split_plan).parameters) == \
        ["B", "N", "sms"]
    P = tmod.Plan
    # the shapes the chip run times, on 132 SMs
    assert tmod.split_plan(16, 31, 132) == P(1, 1)
    assert tmod.split_plan(64, 5461, 132) == P(43, 8)
    assert tmod.split_plan(16, 5461, 132) == P(43, 5)
    assert tmod.split_plan(256, 585, 132) == P(5, 8)
    assert tmod.split_plan(256, 5461, 132) == P(16, 8)
    for B in (0, 1, 7, 16, 64, 256, 1000, 10 ** 5):
        for N in (1, 31, 128, 129, 585, 5461, 10 ** 6):
            p = tmod.split_plan(B, N, 132)
            assert p == tmod.split_plan(B, N, 132)
            assert 1 <= p.splits <= min(tmod.MAX_SPLITS,
                                        max(1, -(-N // tmod.SLICE_NODES)))
            assert 1 <= p.lanes_per_block <= tmod.MAX_LANES_PER_BLOCK
            if p.splits > 1:
                assert B * p.splits <= 132 * tmod.WARPS_PER_SM
    # equal shapes, other prefixes: the same plan serves both
    name = "mathqa_4"
    _, _, _, trie, ann, td = _case(name)
    obj = _objectives(trie, ann)[0][0]
    plan = tmod.split_plan(21, trie.n_nodes, 132)._asdict()
    for mode in ("random", "root"):
        lanes = _case_lanes(name, mode)
        _assert_plan(_split(td, obj, lanes, None, **plan),
                     _repro_cached(name, mode, False)[0], mode)


def _unpacked_step(td, obj, variant):
    """The replan as a round made it before the lane state was packed:
    each lane operand its own tensor, the outputs stacked."""
    scalars = _objective_scalars(obj)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))

    def step(prefixes, el, ec, delays, blocked=None):
        return torch.stack(ops.trie_plan(
            td.terminal, td.depth, td.acc, td.cost, td.lat, td.subtree_size,
            td.path_models, td.path_counts, td.engine_of_model,
            t(prefixes, np.int32), t(el, np.float32), t(ec, np.float32),
            t(delays, np.float32), *scalars, kind=obj.kind, variant=variant,
            blocked_depth=None if blocked is None else t(blocked, np.float32)))

    return step


@pytest.mark.parametrize("name", sorted(_SIZES))
@pytest.mark.parametrize("variant", ["dense", "fused"])
def test_packed_launch_path_plans_as_unpacked(name, variant):
    """One reused buffer across calls of other batch sizes, with and
    without a blocked column, plans as separate operands do."""
    _, _, _, trie, ann, td = _case(name)
    roots, el, ec, delays = _case_lanes(name, "random")
    bd = _blocked(td)
    for obj, _ in _objectives(trie, ann):
        planner = LanePlanner(td, obj, variant)
        unpacked = _unpacked_step(td, obj, variant)
        for b, blocked in ((21, None), (5, bd), (21, bd), (1, None)):
            lanes = (roots[:b], el[:b], ec[:b], delays[:b])
            got = planner(*lanes, blocked)
            want = unpacked(*lanes, blocked)
            assert got.shape == (2, b) and got.dtype == torch.int32
            assert torch.equal(got, want), (name, obj.kind, b)


def test_fleet_stats_unchanged_by_the_packed_path(monkeypatch):
    """The fleet runtime on the packed path and on the unpacked one: the
    same plans, metrics and round telemetry."""
    tpl, trie, wl, ann, obj, reqs = _port_serve("nl2sql_2")
    execu = make_workload_executor(wl)
    res, stats = fleet_mod.run_fleet(trie, ann, obj, reqs, execu,
                                     device="cpu")
    monkeypatch.setattr(fleet_mod, "make_fleet_planner",
                        lambda td, o, variant=None: _unpacked_step(
                            td, o, variant or "fused"))
    res0, stats0 = fleet_mod.run_fleet(trie, ann, obj, reqs, execu,
                                       device="cpu")
    keys = ("success", "total_cost", "total_lat", "models", "n_stages",
            "slo_violated")
    assert [[getattr(r, k) for k in keys] for r in res] == \
        [[getattr(r, k) for k in keys] for r in res0]
    assert stats.rounds == stats0.rounds >= 2
    assert stats.active_per_round == stats0.active_per_round
    assert stats.inflight_per_round == stats0.inflight_per_round
    assert len(stats.replan_s_per_round) == stats.rounds
