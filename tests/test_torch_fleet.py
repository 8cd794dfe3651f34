"""The port's fleet runtime reproduces `repro`'s golden plans and metrics.

The pins and the serving recipe come from tests/test_golden.py: the same
workload, objective and request subset, served by the port's
`run_cohort(engine="fleet", device="cpu")`.
"""
import numpy as np
import pytest

from repro_torch.core import presets
from repro_torch.core.controller import Objective
from repro_torch.core.fleet import run_fleet
from repro_torch.core.runtime import make_workload_executor, run_cohort, summarize
from repro_torch.core.trie import Trie
from repro_torch.core.workload import generate_workload
from test_golden import _SEED, _SIZES, GOLDEN, _serve


def _port_serve(name):
    """`test_golden._serve`'s recipe on the port's own modules."""
    jtpl, _, _, _, jobj, reqs = _serve(name)
    tpl = presets.PRESETS[name]()
    trie = Trie.build(tpl)
    wl = generate_workload(tpl, _SIZES[name], seed=_SEED)
    ann = wl.exact_annotations(trie)
    obj = Objective(jobj.kind, cost_cap=jobj.cost_cap, lat_cap=jobj.lat_cap)
    return tpl, trie, wl, ann, obj, reqs


@pytest.mark.parametrize("name", sorted(GOLDEN))
@pytest.mark.parametrize("engine", ["fleet", "scalar"])
def test_port_reproduces_golden_plans_and_metrics(name, engine):
    g = GOLDEN[name]
    tpl, trie, wl, ann, obj, reqs = _port_serve(name)
    assert obj.cost_cap == pytest.approx(g["cost_cap"], rel=1e-12)
    assert obj.lat_cap == pytest.approx(g["lat_cap"], rel=1e-12)
    res = run_cohort(trie, ann, obj, reqs, make_workload_executor(wl),
                     engine=engine, device="cpu")
    assert [[tpl.models[m].name for m in r.models] for r in res] == \
        g["models"]
    s = summarize(res)
    for k, v in g["metrics"].items():
        assert s[k] == pytest.approx(v, abs=1e-9), k


@pytest.mark.parametrize("variant", ["dense", "fused"])
def test_fleet_stats_and_plan_variants(variant):
    """One replan per lockstep round, every variant gives the same plans,
    and an empty cohort plans nothing."""
    tpl, trie, wl, ann, obj, reqs = _port_serve("nl2sql_2")
    execu = make_workload_executor(wl)
    res, stats = run_fleet(trie, ann, obj, reqs, execu, plan_variant=variant,
                           device="cpu")
    assert [[tpl.models[m].name for m in r.models] for r in res] == \
        GOLDEN["nl2sql_2"]["models"]
    # a last round may find only stops (no feasible continuation)
    deepest = max(r.n_stages for r in res)
    assert stats.rounds in (deepest, deepest + 1)
    assert len(stats.replan_s_per_round) == stats.rounds
    assert stats.active_per_round[0] == len(reqs)
    empty, st0 = run_fleet(trie, ann, obj, np.array([], int), execu,
                           device="cpu")
    assert empty == [] and st0.rounds == 0


def test_events_engine_waits_for_its_slice():
    tpl, trie, wl, ann, obj, reqs = _port_serve("nl2sql_2")
    with pytest.raises(NotImplementedError, match="events"):
        run_cohort(trie, ann, obj, reqs, make_workload_executor(wl),
                   engine="events", device="cpu")
