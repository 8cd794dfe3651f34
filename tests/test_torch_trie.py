"""The port's copies of the framework-free core against `repro`.

`repro_torch.core.{workflow,trie,presets,workload,controller}` are copies
of `repro.core`'s modules with only their imports changed, so on the three
paper presets every output must be bitwise equal: the trie's SoA columns,
the exact annotations, the host `select_path`, and the columns
`TrieDevice.build` stages for the planner.
"""
import numpy as np
import pytest

from repro.core import presets as jpresets
from repro.core.controller import Objective as JObjective
from repro.core.controller import select_path as jselect
from repro.core.controller_jax import TrieDevice as JTrieDevice
from repro.core.trie import Trie as JTrie
from repro.core.workload import generate_workload as jgenerate
from repro_torch.core import presets
from repro_torch.core.controller import Objective, select_path
from repro_torch.core.controller_torch import TrieDevice, trie_engines
from repro_torch.core.trie import Trie
from repro_torch.core.workload import generate_workload

_SIZES = {"nl2sql_8": 300, "nl2sql_2": 300, "mathqa_4": 120}
_COLUMNS = ("parent", "depth", "model", "subtree_size", "terminal", "child")


def _both(name):
    jtpl = jpresets.PRESETS[name]()
    tpl = presets.PRESETS[name]()
    jtrie, trie = JTrie.build(jtpl), Trie.build(tpl)
    jwl = jgenerate(jtpl, _SIZES[name], seed=0)
    wl = generate_workload(tpl, _SIZES[name], seed=0)
    return (jtrie, jwl, jwl.exact_annotations(jtrie)), \
        (trie, wl, wl.exact_annotations(trie))


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module", params=sorted(_SIZES))
def pair(request):
    return request.param, _both(request.param)


def test_trie_workload_and_annotations_bitwise(pair):
    _, ((jtrie, jwl, jann), (trie, wl, ann)) = pair
    assert trie.template == jtrie.template or \
        repr(trie.template) == repr(jtrie.template)
    for col in _COLUMNS:
        _equal(getattr(trie, col), getattr(jtrie, col))
    for tbl in ("S", "cost", "lat"):
        _equal(getattr(wl, tbl), getattr(jwl, tbl))
    for col in ("acc", "cost", "lat"):
        _equal(getattr(ann, col), getattr(jann, col))


def test_select_path_bitwise_at_sampled_nodes(pair):
    name, ((jtrie, _, jann), (trie, _, ann)) = pair
    term = trie.terminal
    engines = trie_engines(trie.template)
    rng = np.random.default_rng(5)
    nodes = rng.choice(trie.n_nodes, size=min(40, trie.n_nodes),
                       replace=False)
    for kind in ("max_acc", "min_cost"):
        caps = dict(lat_cap=float(np.quantile(ann.lat[term], 0.8)))
        if kind == "max_acc":
            caps["cost_cap"] = float(np.quantile(ann.cost[term], 0.5))
        else:
            caps["acc_floor"] = float(np.quantile(ann.acc[term], 0.4))
        obj, jobj = Objective(kind, **caps), JObjective(kind, **caps)
        for u in nodes:
            el = float(rng.uniform(0, 2))
            delays = {e: float(rng.uniform(0, 0.5)) for e in engines}
            assert select_path(trie, ann, obj, root=int(u), elapsed_lat=el,
                               engine_delays=delays) == \
                jselect(jtrie, jann, jobj, root=int(u), elapsed_lat=el,
                        engine_delays=delays), (name, kind, u)


def test_trie_device_columns_bitwise(pair):
    _, ((jtrie, _, jann), (trie, _, ann)) = pair
    restrict = np.nonzero(trie.terminal)[0][::2]
    for nodes in (None, restrict):
        jtd = JTrieDevice.build(jtrie, jann, nodes)
        td = TrieDevice.build(trie, ann, nodes, device="cpu")
        for col in ("terminal", "depth", "acc", "cost", "lat",
                    "subtree_size", "path_models", "path_counts",
                    "engine_of_model"):
            _equal(getattr(td, col).numpy(), getattr(jtd, col))
        assert td.n_engines == jtd.n_engines
