"""The port's event runtime against the independent reference simulator.

`oracle_sim` draws small serving scenarios (chain workflows on a binary
time grid) and replays them through `run_oracle`, a pure-Python
per-request reference.  Here each scenario goes through the port's
`run_events(device="cpu")` on a chain trie built from the port's own
modules, and the two must agree field for field, as the host lane of
`test_oracle_differential.py` holds `repro`'s loop to the same oracle.
"""
import dataclasses

import numpy as np
import pytest
from oracle_sim import (
    BACKOFF_BASE,
    BACKOFF_CAP,
    BACKOFF_FACTOR,
    CLASS_WEIGHTS,
    FAULT_MAX_RETRIES,
    Scenario,
    random_chaos_scenario,
    random_drift_scenario,
    random_scenario,
    run_oracle,
)

from repro_torch.core.controller import Objective
from repro_torch.core.events import run_events
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.trie import Trie, TrieAnnotations
from repro_torch.core.workflow import DecisionPoint, ModelSpec, WorkflowTemplate
from repro_torch.core.workload import SLOClass
from repro_torch.serving.loadsim import (
    EngineLoadModel,
    EngineTokenModel,
    FleetLoadModel,
    TokenWorkModel,
)


def _chain_ann(trie, steps):
    cum = np.concatenate([[0.0], np.cumsum(np.asarray(steps))])
    return TrieAnnotations(acc=trie.depth.astype(np.float64) * 0.125,
                           cost=np.zeros(trie.n_nodes),
                           lat=cum[trie.depth.astype(np.int64)])


def _chain_setup(sc: Scenario):
    """`oracle_sim._chain_setup` on the port's modules."""
    models = tuple(
        ModelSpec(f"m{e}", price=0.001, base_latency=1.0,
                  per_token_latency=0.0, power=0.5, engine=f"e{e}")
        for e in range(sc.n_engines))
    decisions = tuple(
        DecisionPoint(f"s{d}", d, (int(sc.engine_of_depth[d]),))
        for d in range(sc.depth))
    tpl = WorkflowTemplate(f"chain{sc.depth}", models, decisions,
                           min_depth=1)
    trie = Trie.build(tpl)
    assert trie.n_nodes == sc.depth + 1
    return trie, _chain_ann(trie, sc.ann_step)


def _run_port(sc: Scenario):
    """`oracle_sim.run_subject`'s host lane on the port."""
    trie, ann = _chain_setup(sc)

    def executor(q, d, m, t):
        return bool(sc.succ[q, d]), float(sc.cost[q, d]), float(sc.work[q, d])

    kw = {}
    if sc.ptok is not None:
        tms = {f"e{e}": EngineTokenModel(
            name=f"e{e}", t_weights_s=sc.tok_w[e], t_kv_s=sc.tok_kv[e],
            t_flop_s=sc.tok_f[e], kv_capacity=sc.tok_cap[e],
            prefill_tok_s=sc.prefill_s[e]) for e in range(sc.n_engines)}
        kw = dict(policy="dynamic_load_aware", work_model=TokenWorkModel(
            engines=tms, mean_service_s={e: 1.0 for e in tms},
            stage_tokens=lambda q, d, m: (float(sc.ptok[q, d]),
                                          float(sc.dtok[q, d]))))
    elif sc.concurrency is not None:
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
    return run_events(
        trie, ann, Objective("max_acc", lat_cap=sc.lat_cap),
        np.arange(sc.n_requests), executor, arrivals=sc.arrivals,
        capacity=sc.capacity, admission=sc.admission, classes=sc.classes,
        class_specs=specs, preempt=sc.preempt, annotation_schedule=sched,
        device="cpu", **kw)


def _assert_matches_oracle(sc: Scenario) -> None:
    """`oracle_sim.assert_scenario_matches` with the port as the subject."""
    res, stats = _run_port(sc)
    ref = run_oracle(sc)
    assert stats.annotation_swaps == len(sc.drift)
    assert stats.engine_outages == len(sc.outages)
    assert stats.engine_recoveries == len(sc.outages)
    assert stats.failed == sum(o["outcome"] == "failed" for o in ref)
    n = sc.n_requests
    assert sorted(range(n), key=lambda i: (round(stats.done_t[i], 6), i)) \
        == sorted(range(n), key=lambda i: (round(ref[i]["done_t"], 6), i)), \
        "completion order diverged"
    for i, (r, o) in enumerate(zip(res, ref)):
        ctx = f"request {i}"
        assert r.outcome == o["outcome"], (ctx, r.outcome, o["outcome"])
        assert r.success == o["success"], ctx
        assert r.n_stages == o["stages"], ctx
        assert abs(r.total_cost - o["cost"]) < 1e-12, ctx
        assert abs(stats.done_t[i] - o["done_t"]) < 1e-9, ctx
        assert r.slo_violated == o["slo"], ctx
        assert stats.preempt_count[i] == o["preempts"], ctx
    assert stats.preemptions == sum(o["preempts"] for o in ref)


@pytest.mark.parametrize("seed", range(40))
def test_port_random_scenarios_match_oracle(seed):
    _assert_matches_oracle(random_scenario(seed))


@pytest.mark.parametrize("seed", range(40, 60))
def test_port_random_scenarios_match_oracle_preempt_toggled(seed):
    sc = random_scenario(seed)
    for pre in (False, True):
        _assert_matches_oracle(dataclasses.replace(sc, preempt=pre))


@pytest.mark.parametrize("seed", range(20))
def test_port_drift_scenarios_match_oracle(seed):
    _assert_matches_oracle(random_drift_scenario(seed))


@pytest.mark.parametrize("seed", range(30))
def test_port_chaos_scenarios_match_oracle(seed):
    _assert_matches_oracle(random_chaos_scenario(seed))


def test_port_handcrafted_preemption_scenario():
    """One slot: a batch request in service is preempted by an
    interactive arrival and resumes with its remaining work intact."""
    sc = Scenario(
        n_requests=2, depth=1, n_engines=1,
        engine_of_depth=np.array([0]), capacity=1,
        arrivals=np.array([0.0, 0.5]), work=np.array([[2.0], [1.0]]),
        succ=np.array([[True], [True]]), cost=np.array([[0.125], [0.25]]),
        ann_step=np.array([1.0]), lat_cap=None, admission="always",
        concurrency=None, classes=np.array([1, 0]),
        class_caps=(None, None), preempt=True)
    _assert_matches_oracle(sc)
    _, stats = _run_port(sc)
    assert (stats.preemptions, stats.resumed) == (1, 1)
    assert stats.done_t.tolist() == [3.0, 1.5]


def test_port_chaos_sweep_is_not_trivial():
    """The chaos seeds above exercise outages, checkpoints, stage
    failures, retries and terminal failures on the port too."""
    seen = dict.fromkeys(("engine_outages", "checkpointed", "stage_failures",
                          "fault_retries", "failed"), 0)
    for seed in range(30):
        _, stats = _run_port(random_chaos_scenario(seed))
        for k in seen:
            seen[k] += getattr(stats, k)
    assert all(v > 0 for v in seen.values()), seen
