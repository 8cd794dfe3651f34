"""The port's compiled event engine against `repro`'s compiled engine.

Every case builds the same serving setup twice, once from `repro`'s
modules and once from the port's, runs `repro.core.events_compiled
.run_events_compiled` and the port's `run_events_compiled(device="cpu")`
on the same numpy inputs, and holds the two bit for bit: every
`ExecutionResult` field except the wall-clock ``replan_overhead_s``, the
per-request timelines and the `EventStats` counts.  The port's host loop
must give the same run.  Stream moments are compared at `repro`'s own
tolerances (rel 1e-12 for means, 1e-9 for deviations).

`repro`'s compiled engine imports ``jax.experimental.enable_x64``, which
this jax release no longer has; the ``x64`` fixture points that name at
``jax.enable_x64(True)`` for the duration of one test, and nothing in
`repro` changes.
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import test_golden as G
import torch
from fleetlib import random_setup
from oracle_sim import random_chaos_scenario, random_token_scenario, \
    run_subject
from test_torch_oracle import _run_port

from repro_torch.core import presets
from repro_torch.core.admission import AdmissionPolicy
from repro_torch.core.controller import Objective
from repro_torch.core.estimators import OnlineEstimators, RefreshConfig
from repro_torch.core.events import run_events
from repro_torch.core.events_compiled import (
    compiled_engine_cache_size,
    host_reads,
    merge_stream_summaries,
    run_events_compiled,
)
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.runtime import make_workload_executor
from repro_torch.core.trie import Trie
from repro_torch.core.workflow import ModelSpec, make_refinement_workflow
from repro_torch.core.workload import (
    SLOClass,
    generate_workload,
    poisson_arrivals,
    sample_classes,
)

COUNTS = ("events", "replans", "admitted", "rejected", "shed", "downgraded",
          "preemptions", "resumed", "explored", "annotation_swaps",
          "engine_outages", "engine_recoveries", "checkpointed",
          "stage_failures", "fault_retries", "failed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def x64(monkeypatch):
    """`repro`'s compiled engine enters ``jax.experimental.enable_x64()``;
    give it the current ``jax.enable_x64(True)`` for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _port_random_setup(seed: int, n_requests: int = 120):
    """`fleetlib.random_setup` on the port's modules."""
    rng = np.random.default_rng(seed)
    n_models = int(rng.integers(2, 6))
    engines = [f"e{j}" for j in range(int(rng.integers(1, 4)))]
    specs = [ModelSpec(name=f"m{j}", price=float(rng.uniform(0.001, 0.02)),
                       base_latency=float(rng.uniform(0.2, 1.0)),
                       per_token_latency=float(rng.uniform(0.001, 0.003)),
                       power=float(rng.uniform(0.4, 0.9)),
                       engine=str(rng.choice(engines)))
             for j in range(n_models)]
    tpl = make_refinement_workflow(f"rand{seed}", specs,
                                   max_repairs=int(rng.integers(1, 4)))
    trie = Trie.build(tpl)
    wl = generate_workload(tpl, n_requests, seed=seed)
    return trie, wl, wl.exact_annotations(trie)


def _load(mod, engines, conc):
    return mod.FleetLoadModel(
        engines={e: mod.EngineLoadModel(e, concurrency=conc, jitter=0.0)
                 for e in engines},
        mean_service_s={e: 1.0 for e in engines})


def _random_case(seed, n=24, load=True, **extra):
    """`test_events_compiled._serving_setup` in both packages: a branching
    workflow, Poisson arrivals, load-coupled concurrency-2 engines."""
    import repro.serving.loadsim as rl
    from repro.core.controller import Objective as RObjective
    from repro.core.runtime import make_workload_executor as r_exec
    from repro_torch.serving import loadsim as pl

    rng, rtrie, rwl, rann = random_setup(seed)
    trie, wl, ann = _port_random_setup(seed)
    engines = sorted({m.engine for m in trie.template.models})
    reqs = rng.choice(wl.n_requests, n, replace=False)
    lat_q = float(np.quantile(ann.lat[trie.terminal], 0.7))
    kw = dict(arrivals=poisson_arrivals(n, rate=3.0, seed=seed),
              capacity=4, admission="feasibility")
    kw.update(extra)
    rkw, pkw = dict(kw), dict(kw)
    if load:
        rkw.update(policy="dynamic_load_aware",
                   fleet_load=_load(rl, engines, 2))
        pkw.update(policy="dynamic_load_aware",
                   fleet_load=_load(pl, engines, 2))
    return ((rtrie, rann, RObjective("max_acc", lat_cap=lat_q), reqs,
             r_exec(rwl), rkw),
            (trie, ann, Objective("max_acc", lat_cap=lat_q), reqs,
             make_workload_executor(wl), pkw), lat_q)


def _preset_case(name, *, swaps=False, explore=False, faults=False,
                 admission="feasibility", classes=False):
    """`test_golden`'s overload recipe (8 rps into 4 slots, concurrency-1
    processor sharing) on one preset, in both packages, with the drift
    swaps and exploration lane, the chaos fault schedule, or two priority
    classes added."""
    import repro.core.faults as rf
    import repro.core.workload as rwm
    import repro.serving.loadsim as rl
    from repro.core.runtime import make_workload_executor as r_exec
    from repro_torch.serving import loadsim as pl

    r_tpl, r_trie, r_wl, r_ann, r_obj, reqs = G._serve(name)
    tpl = presets.PRESETS[name]()
    trie = Trie.build(tpl)
    wl = generate_workload(tpl, G._SIZES[name], seed=G._SEED)
    ann = wl.exact_annotations(trie)
    obj = Objective(r_obj.kind, cost_cap=r_obj.cost_cap,
                    lat_cap=r_obj.lat_cap)
    engines = sorted({m.engine for m in tpl.models})
    kw = dict(arrivals=poisson_arrivals(G._N_REQS, rate=G._ADM_RATE,
                                        seed=G._ADM_ARR_SEED),
              capacity=G._ADM_CAPACITY, policy="dynamic_load_aware",
              admission=admission)
    rkw = dict(kw, fleet_load=_load(rl, engines, G._ADM_CONCURRENCY))
    pkw = dict(kw, fleet_load=_load(pl, engines, G._ADM_CONCURRENCY))
    if swaps:
        rkw["annotation_schedule"] = [(ts, r_ann.scaled(**s))
                                      for ts, s in G._DRIFT_SWAPS]
        pkw["annotation_schedule"] = [(ts, ann.scaled(**s))
                                      for ts, s in G._DRIFT_SWAPS]
    if explore:
        rkw["explore"] = pkw["explore"] = dict(G._DRIFT_EXPLORE)
    if faults:
        fk = dict(outages=tuple((e % len(engines), td, tu)
                                for e, td, tu in G._CHAOS_OUTAGES),
                  stage_failure_rate=G._CHAOS_RATE, seed=G._CHAOS_SEED,
                  max_retries=G._CHAOS_MAX_RETRIES, backoff_base=0.25,
                  backoff_factor=2.0, backoff_cap=2.0)
        rkw["faults"] = rf.FaultSchedule(**fk)
        pkw["faults"] = FaultSchedule(**fk)
    if classes:
        cap = float(np.quantile(ann.lat[trie.terminal], 0.6))
        cls = sample_classes(G._N_REQS, (0.5, 0.5), seed=G._PRI_CLS_SEED)
        rkw.update(classes=cls, class_specs=(
            rwm.SLOClass("interactive", deadline_s=cap, weight=2.0),
            rwm.SLOClass("batch", deadline_s=None, weight=1.0)))
        pkw.update(classes=cls, class_specs=(
            SLOClass("interactive", deadline_s=cap, weight=2.0),
            SLOClass("batch", deadline_s=None, weight=1.0)))
    return ((r_trie, r_ann, r_obj, reqs, r_exec(r_wl), rkw),
            (trie, ann, obj, reqs, make_workload_executor(wl), pkw))


def _repro_compiled(case, **kw):
    from repro.core.events_compiled import run_events_compiled as r_comp
    trie, ann, obj, reqs, execu, rkw = case
    return r_comp(trie, ann, obj, reqs, execu, **rkw, **kw)


def _port(case, compiled=True, **kw):
    trie, ann, obj, reqs, execu, pkw = case
    if compiled:
        return run_events_compiled(trie, ann, obj, reqs, execu,
                                   device="cpu", **pkw, **kw)
    return run_events(trie, ann, obj, reqs, execu, device="cpu", **pkw)


def _record(run):
    """Everything a run must reproduce, replan wall time excepted."""
    res, stats = run
    return dict(
        results=[(r.success, r.total_cost, r.total_lat, r.models,
                  r.n_stages, r.slo_violated, r.outcome) for r in res],
        done_t=stats.done_t.tolist(), admit_t=stats.admit_t.tolist(),
        preempt_count=stats.preempt_count.tolist(),
        outcome=list(stats.outcome), peak=dict(stats.peak_occupancy),
        counts={k: getattr(stats, k) for k in COUNTS})


def _assert_same(a, b):
    ra, rb = _record(a), _record(b)
    for k in ra:
        assert ra[k] == rb[k], k


def _cases():
    return {
        "unit_calendar": lambda: _random_case(19, load=False)[:2],
        "load_aware_3": lambda: _random_case(3)[:2],
        "drift_swaps_explore": lambda: _preset_case(
            "nl2sql_2", swaps=True, explore=True),
        "chaos_nl2sql": lambda: _preset_case("nl2sql_2", faults=True,
                                             swaps=True, explore=True),
        "cost_aware": lambda: _preset_case("mathqa_4",
                                           admission="cost_aware"),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_port_compiled_matches_repro_compiled(name, x64):
    r_case, p_case = _cases()[name]()
    port = _port(p_case)
    _assert_same(_repro_compiled(r_case), port)
    _assert_same(_port(p_case, compiled=False), port)


def test_port_compiled_priority_preempt_predictive(x64):
    """`repro`'s priority case: two classes with preemption under the
    predictive gate (forecast scan, backlog anchor, paused buffer)."""
    import repro.core.workload as rwm
    r_case, p_case, lat_q = _random_case(7, capacity=3,
                                         admission="predictive",
                                         preempt=True)
    cls = sample_classes(24, (0.4, 0.6), seed=7)
    r_case[5].update(classes=cls, class_specs=(
        rwm.SLOClass("hi", deadline_s=lat_q * 0.75, weight=4.0),
        rwm.SLOClass("lo", deadline_s=None, weight=1.0)))
    p_case[5].update(classes=cls, class_specs=(
        SLOClass("hi", deadline_s=lat_q * 0.75, weight=4.0),
        SLOClass("lo", deadline_s=None, weight=1.0)))
    port = _port(p_case)
    assert port[1].preemptions > 0
    _assert_same(_repro_compiled(r_case), port)
    _assert_same(_port(p_case, compiled=False), port)


@pytest.mark.parametrize("seed", range(2))
def test_port_compiled_token_and_chaos_scenarios_match_repro(seed, x64):
    """The oracle's token-calendar and chaos scenarios (seeded failure
    tables, outages, classes) through both compiled engines."""
    for sc in (random_token_scenario(seed), random_chaos_scenario(seed)):
        _assert_same(run_subject(sc, "compiled"), _run_port(sc, True))


@pytest.mark.parametrize("epoch", [1, 2, 4096])
def test_port_epoch_widths_identical(epoch):
    """Epoch width is a host-read knob, not math: 1, 2, n and 4096
    arrivals a step give one run, and no new engine step is built."""
    _, p_case = _preset_case("nl2sql_2", swaps=True, explore=True,
                             classes=True)
    base = _port(p_case, epoch=G._N_REQS)
    size = compiled_engine_cache_size()
    _assert_same(_port(p_case, epoch=epoch), base)
    assert compiled_engine_cache_size() == size
    assert base[1].annotation_swaps > 0 and base[1].explored > 0


def test_port_stream_summary_matches_materialized_and_repro(x64):
    from repro.core.events_compiled import run_events_compiled as r_comp

    r_case, p_case, _ = _random_case(5)
    res, stats = _port(p_case)
    summary, sstats = _port(p_case, stream=True)
    rsum, _ = r_comp(*r_case[:5], stream=True, **r_case[5])
    served = [r for r in res if r.outcome == "served"]
    assert summary["n_requests"] == len(res)
    assert summary["served"] == len(served)
    assert summary["succeeded"] == sum(r.success for r in res)
    assert (summary["rejected"], summary["shed"]) == \
        (stats.rejected, stats.shed)
    assert summary["slo_violations"] == sum(r.slo_violated for r in res)
    lats = np.array([r.total_lat for r in served])
    costs = np.array([r.total_cost for r in served])
    assert summary["latency"]["count"] == len(served)
    assert summary["latency"]["mean"] == pytest.approx(lats.mean(),
                                                       rel=1e-12)
    assert summary["latency"]["std"] == pytest.approx(lats.std(), rel=1e-9)
    assert summary["cost"]["mean"] == pytest.approx(costs.mean(), rel=1e-12)
    for q, key in ((0.5, "latency_p50"), (0.95, "latency_p95"),
                   (0.99, "latency_p99")):
        exact = float(np.quantile(lats, q, method="inverted_cdf"))
        assert exact - 1e-9 <= summary[key] <= max(exact * 1.04, 1.1e-3)
    assert sstats.outcome == [] and sstats.preempt_count.size == 0
    # `repro`'s summary of the same run
    for k, v in rsum.items():
        if k in ("latency", "cost"):
            for m in ("count", "mean"):
                assert summary[k][m] == pytest.approx(v[m], rel=1e-12)
            assert summary[k]["std"] == pytest.approx(v["std"], rel=1e-9)
        elif k == "sketch":
            assert np.array_equal(summary[k]["counts"], v["counts"])
            assert np.array_equal(summary[k]["edges"], v["edges"])
        else:
            assert summary[k] == v, k


def test_port_merge_stream_summaries_matches_repro(x64):
    from repro.core.events_compiled import \
        merge_stream_summaries as r_merge

    shards, all_res = [], []
    r_case, p_case, _ = _random_case(9)
    rng = np.random.default_rng(9)
    for shard_seed in (1, 2):
        reqs = rng.choice(100, 16, replace=False)
        kw = dict(p_case[5], arrivals=poisson_arrivals(16, rate=3.0,
                                                       seed=shard_seed),
                  capacity=3)
        case = p_case[:3] + (reqs, p_case[4], kw)
        shards.append(_port(case, stream=True)[0])
        all_res.extend(_port(case)[0])
    merged = merge_stream_summaries(shards[0], shards[1])
    served = [r for r in all_res if r.outcome == "served"]
    assert merged["n_requests"] == 32 and merged["served"] == len(served)
    lats = np.array([r.total_lat for r in served])
    assert merged["latency"]["mean"] == pytest.approx(lats.mean(),
                                                      rel=1e-12)
    assert merged["latency"]["std"] == pytest.approx(lats.std(), rel=1e-9)
    ref = r_merge(shards[0], shards[1])
    for k, v in ref.items():
        if k == "sketch":
            assert np.array_equal(merged[k]["counts"], v["counts"])
        else:
            assert merged[k] == v, k
    other = dict(shards[1])
    other.pop("sketch")
    with pytest.raises(ValueError, match="sketch"):
        merge_stream_summaries(shards[0], other)


def test_port_empty_cohort_stream_summary():
    _, p_case, _ = _random_case(13, n=4)
    trie, ann, _, _, execu, _ = p_case
    summary, stats = run_events_compiled(
        trie, ann, Objective("max_acc"), np.zeros(0, dtype=np.int64),
        execu, arrivals=np.zeros(0), capacity=2, stream=True, device="cpu")
    assert summary["n_requests"] == 0 and summary["served"] == 0
    assert np.isnan(summary["latency_p99"])


def test_port_compiled_counts_host_reads():
    """Every loop test is one counted host read; a run makes at least
    one per event."""
    _, p_case, _ = _random_case(3)
    before = host_reads()
    _, stats = _port(p_case)
    assert host_reads() - before >= stats.events


def test_port_compiled_refuses_host_only_features():
    """`tests/test_events_compiled.py`'s fence, through the port's
    `run_events(compiled=True)`, and ``devices > 1``."""
    _, p_case, _ = _random_case(3, n=4)
    trie, ann, _, reqs, execu, kw = p_case
    obj = Objective("max_acc")
    arrivals = kw["arrivals"]
    with pytest.raises(TypeError, match="compiled=True"):
        run_events(trie, ann, obj, reqs, execu, arrivals=arrivals,
                   epoch=64, device="cpu")

    class MyPolicy(AdmissionPolicy):
        """Custom subclass: host-only."""
        name = "mine"

    def comp(**k):
        return run_events(trie, ann, obj, reqs, execu, arrivals=arrivals,
                          compiled=True, device="cpu", **k)

    with pytest.raises(NotImplementedError):
        comp(admission=MyPolicy())
    with pytest.raises(NotImplementedError):
        comp(load_probe=lambda t: {})

    class DuckLoad:
        """Duck-typed load model: host-only."""
        engines = {}

        def delays(self, inflight):
            return {}

        def slowdown(self, engine, n):
            return 1.0

    with pytest.raises(NotImplementedError):
        comp(policy="dynamic_load_aware", fleet_load=DuckLoad())
    D, M = trie.template.max_depth, trie.template.n_models
    est = OnlineEstimators.from_tables(
        np.full((D, M), 0.5), np.full((D, M), 0.01), np.ones((D, M)))
    with pytest.raises(NotImplementedError, match="refresh"):
        comp(refresh=RefreshConfig(est))
    with pytest.raises(NotImplementedError, match="timeout_k"):
        comp(faults=FaultSchedule(outages=((0, 0.5, 1.0),), timeout_k=2.0))
    with pytest.raises(NotImplementedError, match="checkpoint"):
        comp(faults=FaultSchedule(outages=((0, 0.5, 1.0),),
                                  recovery="restart"))
    with pytest.raises(NotImplementedError, match="fault injection"):
        comp(faults=FaultSchedule(outages=((0, 0.5, 1.0),)),
             admission="predictive")
    with pytest.raises(ValueError, match="repro_torch.dist.spawn"):
        comp(devices=2)
    with pytest.raises(ValueError, match="devices"):
        comp(devices=0)
    with pytest.raises(ValueError, match="policy"):
        comp(policy="static")


def test_port_compiled_engine_reuses_steps_across_traces():
    """New traces, deadlines and objective scalars through a known
    configuration reuse its step."""
    _, p_case, _ = _random_case(3)
    _port(p_case)
    size = compiled_engine_cache_size()
    trie, ann, obj, reqs, execu, kw = p_case
    kw = dict(kw, arrivals=poisson_arrivals(len(reqs), rate=5.0, seed=1))
    run_events_compiled(trie, ann, dataclasses.replace(obj, lat_cap=2.0),
                        reqs, execu, device="cpu", **kw)
    assert compiled_engine_cache_size() == size
