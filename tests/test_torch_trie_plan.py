"""The port's planner against `repro`'s three replan variants and the host.

The port's plain versions of the fused fleet replan ("dense", the oracle,
and "fused", the blocked form the CUDA kernel mirrors) must pick exactly
the same ``(target, next_model)`` as `repro`'s "dense", "fused" and
"pallas" (interpret mode) variants and, where every engine is up, as the
host float64 `select_path`: on the three paper presets, both objective
kinds, random prefixes, elapsed budgets and live delays, a blocked-depth
column, infeasible and stop lanes, and a lane count that is not a
multiple of 8.
"""
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
from repro_torch.core import presets
from repro_torch.core.controller import Objective, select_path
from repro_torch.core.controller_torch import (
    TrieDevice,
    make_batched_planner,
    make_fleet_planner,
    next_model_for,
    trie_engines,
)
from repro_torch.core.trie import Trie
from repro_torch.core.workload import generate_workload
from repro_torch.kernels import ops

_SIZES = {"nl2sql_8": 300, "nl2sql_2": 300, "mathqa_4": 120}
_JAX_VARIANTS = ("dense", "fused", "pallas")
_PORT_VARIANTS = ("dense", "fused")
B = 21  # lanes: not a multiple of 8


def _objectives(trie, ann):
    term = trie.terminal
    caps = [
        ("max_acc", dict(cost_cap=float(np.quantile(ann.cost[term], 0.5)),
                         lat_cap=float(np.quantile(ann.lat[term], 0.8)))),
        ("min_cost", dict(acc_floor=float(np.quantile(ann.acc[term], 0.4)),
                          lat_cap=float(np.quantile(ann.lat[term], 0.9)))),
    ]
    return [(Objective(k, **c), JObjective(k, **c)) for k, c in caps]


def _lanes(trie, ann, n_engines, seed):
    """Random lanes plus two infeasible lanes (elapsed far past any cap)
    and two stop lanes (prefix at a terminal leaf inside both objectives'
    cost and accuracy bounds: the plan is u itself)."""
    rng = np.random.default_rng(seed)
    roots = rng.integers(0, trie.n_nodes, size=B).astype(np.int32)
    el = rng.uniform(0, 1.5, size=B).astype(np.float32)
    delays = rng.uniform(0, 0.5, size=(B, n_engines)).astype(np.float32)
    el[:2] = 1e4
    term = trie.terminal
    leaves = np.nonzero(
        term & (trie.subtree_size == 1)
        & (ann.cost <= np.quantile(ann.cost[term], 0.5))
        & (ann.acc >= np.quantile(ann.acc[term], 0.4)))[0]
    roots[2:4] = rng.choice(leaves, size=2)
    el[2:4] = 0.0
    return roots, el, np.zeros(B, np.float32), delays


@pytest.fixture(scope="module", params=sorted(_SIZES))
def preset(request):
    name = request.param
    jtpl, tpl = jpresets.PRESETS[name](), presets.PRESETS[name]()
    jtrie, trie = JTrie.build(jtpl), Trie.build(tpl)
    jann = jgenerate(jtpl, _SIZES[name], seed=0).exact_annotations(jtrie)
    ann = generate_workload(tpl, _SIZES[name], seed=0).exact_annotations(trie)
    return (name, jtrie, jann, trie, ann,
            JTrieDevice.build(jtrie, jann),
            TrieDevice.build(trie, ann, device="cpu"))


@pytest.mark.parametrize("blocked", [False, True])
def test_port_variants_match_repro_variants_and_host(preset, blocked):
    name, jtrie, jann, trie, ann, jtd, td = preset
    engines = trie_engines(trie.template)
    roots, el, ec, delays = _lanes(trie, ann, len(engines), seed=len(name))
    bd = None
    if blocked:  # the engine of the deepest-reaching model is down
        down = np.zeros(len(engines), bool)
        down[int(td.engine_of_model[-1])] = True
        bd = blocked_depth_table(td.path_models.numpy(),
                                 td.engine_of_model.numpy(), down)
        assert bd.max() > 0
    for obj, jobj in _objectives(trie, ann):
        ref = None
        for v in _JAX_VARIANTS:
            tgt, nxt = jmake_fleet_planner(jtd, jobj, variant=v)(
                roots, el, ec, delays, bd)
            got = (np.asarray(tgt), np.asarray(nxt))
            if ref is None:
                ref = got
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b, err_msg=f"repro {v}")
        assert (ref[0][:2] == -1).all() and (ref[1][:2] == -1).all()
        assert (ref[0] >= 0).sum() >= B // 3
        for v in _PORT_VARIANTS:
            tgt, nxt = make_fleet_planner(td, obj, variant=v)(
                roots, el, ec, delays, bd)
            assert tgt.dtype == nxt.dtype == torch.int32
            np.testing.assert_array_equal(tgt.numpy(), ref[0],
                                          err_msg=f"{name} {obj.kind} {v}")
            np.testing.assert_array_equal(nxt.numpy(), ref[1],
                                          err_msg=f"{name} {obj.kind} {v}")
        if blocked:
            continue
        host = np.array([
            select_path(trie, ann, obj, root=int(roots[i]),
                        elapsed_lat=float(el[i]),
                        engine_delays={e: float(delays[i, j])
                                       for j, e in enumerate(engines)})
            for i in range(B)])
        np.testing.assert_array_equal(ref[0], host)
        np.testing.assert_array_equal(ref[1], [
            next_model_for(trie, int(roots[i]), int(host[i]))
            for i in range(B)])


def test_stop_lanes_and_batched_planner(preset):
    """A lane whose best plan is its own prefix stops (next model -1); the
    batched planner's shared delay row gives the fleet planner's targets."""
    name, _, _, trie, ann, _, td = preset
    engines = trie_engines(trie.template)
    roots, el, ec, delays = _lanes(trie, ann, len(engines), seed=1)
    obj = _objectives(trie, ann)[0][0]
    tgt, nxt = make_fleet_planner(td, obj, variant="fused")(
        roots, el, ec, delays)
    stop = tgt.numpy() == roots
    assert stop[2:4].all() and (nxt.numpy()[stop] == -1).all()
    row = delays[0]
    shared = make_batched_planner(td, obj, variant="fused")(
        roots, el, ec, row)
    tgt2, _ = make_fleet_planner(td, obj, variant="dense")(
        roots, el, ec, np.broadcast_to(row, delays.shape))
    assert torch.equal(shared, tgt2)


def test_cuda_variant_needs_a_cuda_trie_device(preset):
    """The kernel variant is refused for CPU columns: the CPU runs the plain
    versions only because the caller asked for the CPU."""
    *_, td = preset
    obj = Objective("max_acc")
    with pytest.raises(ValueError, match="CUDA"):
        make_fleet_planner(td, obj, variant="cuda")
    assert ops.default_plan_variant(torch.device("cpu")) == "fused"
    assert ops.default_plan_variant(torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="unknown"):
        make_fleet_planner(td, obj, variant="pallas")
