"""The port's open-arrival event runtime reproduces `repro`'s goldens.

The recipes come from tests/test_golden.py: the same workload, objective,
request subset, arrivals and load model, served by the port's
`run_events(device="cpu")` on its own modules.  Admission, priority-class
and drift (annotation swaps + exploration) runs must hit the pins request
for request; the chaos runs hit the host half of `GOLDEN_CHAOS` and equal
`repro`'s host loop on the same inputs.
"""
import numpy as np
import pytest
import test_golden as G

from repro_torch.core import presets
from repro_torch.core.controller import Objective
from repro_torch.core.controller_torch import planner_builds
from repro_torch.core.events import run_events
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.fleet import run_fleet
from repro_torch.core.runtime import (
    make_workload_executor,
    run_cohort,
    summarize,
    summarize_by_class,
)
from repro_torch.core.trie import Trie
from repro_torch.core.workload import (
    generate_workload,
    interactive_batch_classes,
    poisson_arrivals,
    sample_classes,
)
from repro_torch.serving.loadsim import EngineLoadModel, FleetLoadModel


def _setup(name):
    """`test_golden._serve`'s recipe on the port's own modules."""
    tpl = presets.PRESETS[name]()
    trie = Trie.build(tpl)
    wl = generate_workload(tpl, G._SIZES[name], seed=G._SEED)
    ann = wl.exact_annotations(trie)
    term = trie.terminal
    obj = Objective("max_acc",
                    cost_cap=float(np.quantile(ann.cost[term], 0.5)),
                    lat_cap=float(np.quantile(ann.lat[term], 0.8)))
    reqs = np.random.default_rng(G._REQ_SEED).choice(
        G._SIZES[name], G._N_REQS, replace=False)
    return tpl, trie, wl, ann, obj, reqs


def _overload_kw(tpl, rate=G._ADM_RATE):
    """The goldens' overload setup: 8 rps into 4 slots, concurrency-1
    processor sharing, the feasibility gate."""
    engines = sorted({m.engine for m in tpl.models})
    load = FleetLoadModel(
        engines={e: EngineLoadModel(e, concurrency=G._ADM_CONCURRENCY,
                                    jitter=0.0) for e in engines},
        mean_service_s={e: 1.0 for e in engines})
    return dict(arrivals=poisson_arrivals(G._N_REQS, rate=rate,
                                          seed=G._ADM_ARR_SEED),
                capacity=G._ADM_CAPACITY, policy="dynamic_load_aware",
                fleet_load=load, admission="feasibility", device="cpu")


def _serve_drift(name):
    tpl, trie, wl, ann, obj, reqs = _setup(name)
    sched = [(ts, ann.scaled(**kw)) for ts, kw in G._DRIFT_SWAPS]
    return tpl, run_events(trie, ann, obj, reqs, make_workload_executor(wl),
                           annotation_schedule=sched,
                           explore=dict(G._DRIFT_EXPLORE),
                           **_overload_kw(tpl))


def _chaos_faults(tpl, schedule_cls):
    engines = sorted({m.engine for m in tpl.models})
    return schedule_cls(
        outages=tuple((e % len(engines), td, tu)
                      for e, td, tu in G._CHAOS_OUTAGES),
        stage_failure_rate=G._CHAOS_RATE, seed=G._CHAOS_SEED,
        max_retries=G._CHAOS_MAX_RETRIES, backoff_base=0.25,
        backoff_factor=2.0, backoff_cap=2.0)


def _metrics_match(res, pinned):
    s = summarize(res)
    for k, v in pinned.items():
        assert s[k] == pytest.approx(v, abs=1e-9), k


@pytest.mark.parametrize("name", sorted(G.GOLDEN_ADMISSION))
def test_port_admission_goldens(name):
    g = G.GOLDEN_ADMISSION[name]
    tpl, trie, wl, ann, obj, reqs = _setup(name)
    res, stats = run_events(trie, ann, obj, reqs, make_workload_executor(wl),
                            **_overload_kw(tpl))
    assert [r.outcome for r in res] == g["outcome"]
    assert (stats.admitted, stats.rejected, stats.shed) == \
        (g["admitted"], g["rejected"], g["shed"])
    _metrics_match(res, g["metrics"])


@pytest.mark.parametrize("name", sorted(G.GOLDEN_PRIORITY))
def test_port_priority_goldens(name):
    g = G.GOLDEN_PRIORITY[name]
    tpl, trie, wl, ann, obj, reqs = _setup(name)
    specs = interactive_batch_classes(
        float(np.quantile(ann.lat[trie.terminal], 0.6)))
    cls = sample_classes(G._N_REQS, (0.5, 0.5), seed=G._PRI_CLS_SEED)
    res, stats = run_events(trie, ann, obj, reqs, make_workload_executor(wl),
                            classes=cls, class_specs=specs, preempt=True,
                            **_overload_kw(tpl, G._PRI_RATE))
    assert stats.class_of.tolist() == g["classes"]
    assert [r.outcome for r in res] == g["outcome"]
    assert (stats.admitted, stats.rejected, stats.shed) == \
        (g["admitted"], g["rejected"], g["shed"])
    assert (stats.preemptions, stats.resumed) == \
        (g["preemptions"], g["resumed"])
    assert stats.preempt_count.tolist() == g["preempt_count"]
    by = summarize_by_class(res, stats.class_of, specs)
    for cname, pinned in g["per_class"].items():
        for k, v in pinned.items():
            assert by[cname][k] == pytest.approx(v, abs=1e-9), (cname, k)


@pytest.mark.parametrize("name", sorted(G.GOLDEN_DRIFT))
def test_port_drift_goldens(name):
    g = G.GOLDEN_DRIFT[name]
    tpl, (res, stats) = _serve_drift(name)
    assert stats.annotation_swaps == g["annotation_swaps"]
    assert stats.explored == g["explored"]
    assert [r.outcome for r in res] == g["outcome"]
    assert (stats.admitted, stats.rejected, stats.shed) == \
        (g["admitted"], g["rejected"], g["shed"])
    assert [[tpl.models[m].name for m in r.models] for r in res] == \
        g["models"]
    assert [list(map(int, v)) for v in stats.stage_versions] == \
        g["stage_versions"]
    _metrics_match(res, g["metrics"])


def _planners_made(monkeypatch):
    """Record `planner_builds()` just after each resident planner the
    event runtime makes; returns the list it appends to."""
    import repro_torch.core.events as ev

    made = []
    real = ev.make_resident_planner

    def make(*args, **kwargs):
        planner = real(*args, **kwargs)
        made.append(planner_builds())
        return planner

    monkeypatch.setattr(ev, "make_resident_planner", make)
    return made


def test_port_drift_swaps_make_no_new_binding(monkeypatch):
    """Three annotation swaps per preset bind nothing new: every binding
    of a drift run is made with its planner, before the first replan."""
    made = _planners_made(monkeypatch)
    for name in sorted(G.GOLDEN_DRIFT):
        _, (_, stats) = _serve_drift(name)
        assert stats.annotation_swaps == len(G._DRIFT_SWAPS)
        assert len(made) == 1 and planner_builds() == made.pop()


def test_port_arrival_rate_sweep_binds_once_a_run(monkeypatch):
    """A sweep of arrival rates at one capacity binds the same layouts
    once a run, when the planner is made, whatever the rate and the
    number of replans (the port's form of `repro`'s no-retrace pin)."""
    tpl, trie, wl, ann, obj, reqs = _setup("nl2sql_8")
    execu = make_workload_executor(wl)
    made = _planners_made(monkeypatch)
    per_run = set()
    for rate in (0.5, 2.0, 8.0, 32.0):
        kw = _overload_kw(tpl, rate)
        kw["admission"] = "always"
        before = planner_builds()
        res, stats = run_events(trie, ann, obj, reqs, execu, **kw)
        assert len(res) == len(reqs) and stats.replans > 0
        assert len(made) == 1 and planner_builds() == made.pop()
        per_run.add(planner_builds() - before)
    assert per_run == {2}


@pytest.mark.parametrize("name", sorted(G.GOLDEN_CHAOS))
def test_port_chaos_host_goldens(name):
    """`GOLDEN_CHAOS`'s host pins, and the same dispositions, completion
    times and fault counters as `repro`'s host loop on the same inputs."""
    g = G.GOLDEN_CHAOS[name]
    tpl, trie, wl, ann, obj, reqs = _setup(name)
    res, stats = run_events(trie, ann, obj, reqs, make_workload_executor(wl),
                            faults=_chaos_faults(tpl, FaultSchedule),
                            **_overload_kw(tpl))
    assert [r.outcome for r in res] == g["outcome"]
    assert (stats.admitted, stats.rejected, stats.shed, stats.failed) == \
        (g["admitted"], g["rejected"], g["shed"], g["failed"])
    assert (stats.engine_outages, stats.engine_recoveries,
            stats.checkpointed) == (g["engine_outages"],
                                    g["engine_recoveries"],
                                    g["checkpointed"])
    assert (stats.stage_failures, stats.fault_retries) == \
        (g["stage_failures"], g["fault_retries"])
    assert stats.done_t.tolist() == pytest.approx(g["done_t"], abs=1e-9)
    _metrics_match(res, g["metrics"])
    jres, jstats = G._serve_chaos(name)
    assert [r.outcome for r in res] == [r.outcome for r in jres]
    assert [r.models for r in res] == [r.models for r in jres]
    assert stats.done_t.tolist() == jstats.done_t.tolist()
    assert stats.stage_versions == jstats.stage_versions
    for k in ("replans", "timeouts", "fault_retries", "checkpointed"):
        assert getattr(stats, k) == getattr(jstats, k), k


@pytest.mark.parametrize("name", sorted(G.GOLDEN))
def test_port_fleet_and_events_reproduce(name):
    """Both batched control planes of the port reproduce the pinned host
    plans."""
    g = G.GOLDEN[name]
    tpl, trie, wl, ann, obj, reqs = _setup(name)
    execu = make_workload_executor(wl)
    flt, _ = run_fleet(trie, ann, obj, reqs, execu, device="cpu")
    evt, _ = run_events(trie, ann, obj, reqs, execu, capacity=len(reqs),
                        device="cpu")
    for res in (flt, evt):
        assert [[tpl.models[m].name for m in r.models] for r in res] == \
            g["models"]
        _metrics_match(res, g["metrics"])


def test_port_events_rejects_bad_arguments():
    tpl, trie, wl, ann, obj, reqs = _setup("nl2sql_2")
    execu = make_workload_executor(wl)
    obj = Objective("max_acc")
    three = np.arange(3)
    with pytest.raises(ValueError, match="policy"):
        run_events(trie, ann, obj, three, execu, policy="static",
                   device="cpu")
    with pytest.raises(ValueError, match="arrivals shape"):
        run_events(trie, ann, obj, three, execu, arrivals=np.zeros(5),
                   device="cpu")
    with pytest.raises(ValueError, match="finite and non-negative"):
        run_events(trie, ann, obj, three, execu,
                   arrivals=np.array([0.0, -1.0, 2.0]), device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        run_events(trie, ann, obj, three, execu, capacity=0, device="cpu")
    with pytest.raises(ValueError, match="events engine"):
        run_cohort(trie, ann, obj, three, execu, engine="scalar",
                   arrivals=np.zeros(3), device="cpu")


def test_port_events_refuses_unported_engines():
    """``compiled=True`` runs the compiled engine, with the host loop's
    results; ``devices=2`` without a process group of size 2 raises on
    both engines, naming the recipe that starts one."""
    tpl, trie, wl, ann, obj, reqs = _setup("nl2sql_2")
    execu = make_workload_executor(wl)
    kw = _overload_kw(tpl)
    host, hstats = run_events(trie, ann, obj, reqs, execu, **kw)
    comp, cstats = run_events(trie, ann, obj, reqs, execu, compiled=True,
                              epoch=3, **kw)
    assert [(r.outcome, r.models, r.total_cost, r.total_lat) for r in host] \
        == [(r.outcome, r.models, r.total_cost, r.total_lat) for r in comp]
    assert (hstats.events, hstats.replans, hstats.shed) == \
        (cstats.events, cstats.replans, cstats.shed)
    with pytest.raises(ValueError, match="repro_torch.dist.spawn"):
        run_events(trie, ann, obj, reqs, execu, devices=2, device="cpu")
    with pytest.raises(ValueError, match="repro_torch.dist.spawn"):
        run_events(trie, ann, obj, reqs, execu, compiled=True, devices=2,
                   device="cpu")
    res, _ = run_events(trie, ann, obj, reqs, execu, devices=1,
                        device="cpu")
    assert len(res) == len(reqs)
