"""The port's estimators, profiler, monitor and streaming statistics
against `repro`'s, and its estimator refresh loop against `repro`'s.

Each case of tests/test_{estimators,profiler,monitor,streaming}.py runs
on the same numpy inputs through both packages (the property-based cases
at fixed seeds); the results must be identical, and the case's own
assertions hold on the port.  The refresh run serves the drift
benchmark's recipe (`benchmarks/drift.py`, engine-slowdown schedule),
shrunk to 12 requests, through both packages' host event loops.
"""
import json
import types

import numpy as np
import pytest

import repro.core.controller as j_controller
import repro.core.estimators as j_estimators
import repro.core.events as j_events
import repro.core.monitor as j_monitor
import repro.core.presets as j_presets
import repro.core.profiler as j_profiler
import repro.core.runtime as j_runtime
import repro.core.streaming as j_streaming
import repro.core.trie as j_trie
import repro.core.workflow as j_workflow
import repro.core.workload as j_workload
import repro.serving.loadsim as j_loadsim
import repro_torch.core.controller as t_controller
import repro_torch.core.estimators as t_estimators
import repro_torch.core.events as t_events
import repro_torch.core.monitor as t_monitor
import repro_torch.core.presets as t_presets
import repro_torch.core.profiler as t_profiler
import repro_torch.core.runtime as t_runtime
import repro_torch.core.streaming as t_streaming
import repro_torch.core.trie as t_trie
import repro_torch.core.workflow as t_workflow
import repro_torch.core.workload as t_workload
import repro_torch.serving.loadsim as t_loadsim


def _ns(controller, estimators, events, monitor, presets, profiler, runtime,
        streaming, trie, workflow, workload, loadsim):
    return types.SimpleNamespace(**locals())


REPRO = _ns(j_controller, j_estimators, j_events, j_monitor, j_presets,
            j_profiler, j_runtime, j_streaming, j_trie, j_workflow,
            j_workload, j_loadsim)
PORT = _ns(t_controller, t_estimators, t_events, t_monitor, t_presets,
           t_profiler, t_runtime, t_streaming, t_trie, t_workflow,
           t_workload, t_loadsim)


def both(case, *args):
    """Run ``case(package, *args)`` on `repro` and on the port; the
    results must be identical (numpy arrays compared exactly)."""
    a, b = case(REPRO, *args), case(PORT, *args)
    _same(a, b)
    return b


def _same(a, b, path="result"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, path


def _setup(p, n_models=4, repairs=2, n_q=400, seed=0, lo=0.3, span=0.5):
    models = [p.workflow.ModelSpec(f"m{i}", 0.001 * (i + 1), 0.1, 0.001,
                                   lo + span * i / max(n_models - 1, 1))
              for i in range(n_models)]
    tpl = p.workflow.make_refinement_workflow("t", models,
                                              max_repairs=repairs)
    trie = p.trie.Trie.build(tpl)
    return trie, p.workload.generate_workload(tpl, n_q, seed=seed)


def _profile_fields(prof):
    return {k: getattr(prof, k) for k in
            ("obs", "fill", "spent", "runs", "checkpoint_hits",
             "calibration_rows")}


# ---------------------------------------------------------------- estimators
def _decomposition(p):
    trie, wl = _setup(p, n_models=3, n_q=200)
    A, _, reached = wl.node_tables(trie)
    q = np.zeros(trie.n_nodes)
    for u in range(1, trie.n_nodes):
        r = reached[:, u].astype(bool)
        if r.any():
            q[u] = A[r, u].mean()
    covered = reached.any(axis=0)
    return p.estimators._compose(trie, q), A.mean(0), covered


def test_decomposition_identity():
    mu, truth, covered = both(_decomposition)
    assert np.abs(mu[covered] - truth[covered]).max() < 1e-9


def _all_estimators(p, seed, coverage=0.03, n_models=4, n_q=500, calib=0.0):
    trie, wl = _setup(p, n_models=n_models, seed=seed % 3, n_q=n_q)
    prof = p.profiler.profile_cascade(wl, trie, coverage, seed=seed,
                                      calibration_fraction=calib)
    est = {k: f(trie, prof) for k, f in p.estimators.ESTIMATORS.items()}
    return est, wl.node_tables(trie)[0].mean(0), trie.depth


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_bias_signs(seed):
    est, truth, depth = both(_all_estimators, seed)
    deep = depth >= 2
    assert (est["direct_average"] - truth)[deep].mean() < -0.02
    assert (est["prefix_avg"] - truth)[deep].mean() > 0.02
    assert abs((est["vinelm_lite"] - truth)[deep].mean()) < 0.05


def test_table1_ordering():
    est, truth, depth = both(_all_estimators, 1, 0.02, 6, 800, 0.15)
    d = depth > 0
    mae = {k: np.abs(v[d] - truth[d]).mean() for k, v in est.items()}
    assert mae["vinelm"] <= mae["vinelm_lite"] * 1.05
    assert mae["vinelm_lite"] < mae["prefix_avg"]
    assert mae["vinelm"] < mae["prefix_impute"]
    assert mae["prefix_avg"] < mae["direct_average"]


def _vinelm_annotations(p):
    trie, wl = _setup(p)
    ann = p.estimators.annotate(
        trie, p.profiler.profile_cascade(wl, trie, 0.03, seed=2), "vinelm")
    return ann.acc, ann.cost, ann.lat, ann.check_monotone(trie)


def test_vinelm_monotone_annotations():
    acc, _, _, monotone = both(_vinelm_annotations)
    assert monotone and np.all(acc >= 0) and np.all(acc <= 1)


def _posterior_merges(p, seed):
    rng = np.random.default_rng(seed)
    prior, strength = rng.uniform(0.05, 0.95), rng.uniform(0.5, 16.0)
    flips = list(rng.random(int(rng.integers(0, 31))) < 0.5)
    vals = list(rng.random(int(rng.integers(0, 31))) * 8.0)
    cf, cv = int(rng.integers(0, len(flips) + 1)), \
        int(rng.integers(0, len(vals) + 1))
    out = []
    for cls, xs, cut in ((p.estimators.BetaPosterior, flips, cf),
                         (p.estimators.GaussianPosterior, vals, cv)):
        a, b = cls(prior, strength), cls(prior, strength)
        for x in xs[:cut]:
            a.observe(x)
        for x in xs[cut:]:
            b.observe(x)
        out.append((a.merge(b).state(), b.merge(a).state(),
                    a.merge(b).mean(), b.merge(a).mean()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_posterior_merge_order_insensitive(seed):
    for ab, ba, mab, mba in both(_posterior_merges, seed):
        assert ab == ba and mab == mba


def test_posterior_merge_rejects_different_priors():
    for p in (REPRO, PORT):
        with pytest.raises(ValueError, match="prior"):
            p.estimators.BetaPosterior(0.5, 4.0).merge(
                p.estimators.BetaPosterior(0.6, 4.0))
        with pytest.raises(ValueError, match="prior"):
            p.estimators.GaussianPosterior(1.0, 4.0).merge(
                p.estimators.GaussianPosterior(1.0, 2.0))


def _decay_gaps(p, seed):
    rng = np.random.default_rng(seed)
    prior, strength = rng.uniform(0.05, 0.95), rng.uniform(0.5, 16.0)
    flips = list(rng.random(int(rng.integers(1, 31))) < 0.5)
    vals = list(rng.random(int(rng.integers(1, 31))) * 8.0)
    gammas = sorted(rng.random(int(rng.integers(2, 7))), reverse=True)
    out = []
    for post, obs in ((p.estimators.BetaPosterior(prior, strength), flips),
                      (p.estimators.GaussianPosterior(prior, strength),
                       vals)):
        for x in obs:
            post.observe(x)
        gaps = []
        for g in gammas:
            fresh = type(post).from_state(post.state())
            fresh.decay(g)
            gaps.append(abs(fresh.mean() - prior))
        dead = type(post).from_state(post.state())
        dead.decay(0.0)
        with pytest.raises(ValueError, match="decay"):
            post.decay(1.5)
        out.append((gaps, dead.mean(), prior))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_decay_moves_posterior_monotonically_toward_prior(seed):
    for gaps, dead, prior in both(_decay_gaps, seed):
        assert all(a >= b - 1e-15 for a, b in zip(gaps, gaps[1:]))
        assert dead == prior


def _zero_observation(p):
    trie, wl = _setup(p, n_models=3, n_q=200)
    est = p.estimators.OnlineEstimators.from_profile(
        trie, p.profiler.profile_cascade(wl, trie, 0.05, seed=3))
    means = [(c.mean(), c.prior) for tab in (est.acc, est.cost, est.lat)
             for row in tab for c in row]
    ann = p.estimators.TrieAnnotator(trie, est).annotations()
    return est.shape, means, ann.acc, ann.lat, ann.check_monotone(trie)


def test_zero_observation_posterior_is_offline_prior_bitwise():
    shape, means, acc, _, monotone = both(_zero_observation)
    assert all(m == pr for m, pr in means)
    assert monotone and np.all(acc >= 0) and np.all(acc <= 1)


def _round_trip(p, seed):
    rng = np.random.default_rng(seed)
    trie, wl = _setup(p, n_models=3, n_q=120, seed=seed % 5)
    est = p.estimators.OnlineEstimators.from_profile(
        trie, p.profiler.profile_cascade(wl, trie, 0.05, seed=seed % 7))
    D, M = est.shape
    for _ in range(int(rng.integers(0, 40))):
        est.observe(int(rng.integers(0, D)), int(rng.integers(0, M)),
                    bool(rng.random() < 0.5), float(rng.random()),
                    float(rng.random() * 4))
    if rng.random() < 0.5:
        est.decay_all(float(rng.uniform(0.2, 1.0)))
    back = p.estimators.OnlineEstimators.from_state(
        json.loads(json.dumps(est.state())))
    assert back.state() == est.state()
    assert back.observations == est.observations
    return est.state(), back.q_table(), back.cost_table(), back.lat_table()


@pytest.mark.parametrize("seed", [0, 11, 4242])
def test_estimator_state_round_trips_exactly(seed):
    both(_round_trip, seed)


def _observations_shift(p):
    trie, wl = _setup(p, n_models=3, n_q=200)
    est = p.estimators.OnlineEstimators.from_profile(
        trie, p.profiler.profile_cascade(wl, trie, 0.05, seed=4))
    q0, l0 = est.q_table(), est.lat_table()
    for _ in range(50):
        est.observe(0, 1, False, 0.01, l0[0, 1] * 4.0 + 1.0)
    return est.observations, q0, l0, est.q_table(), est.lat_table()


def test_observations_shift_posterior_tables():
    n, q0, l0, q1, l1 = both(_observations_shift)
    assert n == 50 and q1[0, 1] < q0[0, 1] and l1[0, 1] > l0[0, 1]
    assert q1[0, 0] == q0[0, 0] and q1[-1, -1] == q0[-1, -1]


def test_annotator_publishes_versioned_devices_and_supersedes():
    trie, wl = _setup(PORT, n_models=3, n_q=200)
    prof = PORT.profiler.profile_cascade(wl, trie, 0.05, seed=5)
    annot = PORT.estimators.TrieAnnotator(
        trie, PORT.estimators.OnlineEstimators.from_profile(trie, prof),
        device="cpu")
    td1 = annot.publish()
    assert td1.version == 1 and td1.device.type == "cpu"
    td1.check_live()
    annot.estimators.observe(0, 0, False, 0.1, 2.0)
    td2 = annot.publish()
    assert td2.version == 2 and td2.superseded_by is None
    assert td1.superseded_by == 2
    with pytest.raises(RuntimeError, match="version"):
        td1.check_live()
    td2.check_live()
    assert [(c.shape, c.dtype) for c in td1.columns()] == \
        [(c.shape, c.dtype) for c in td2.columns()]
    np.testing.assert_array_equal(
        td2.lat.numpy(), annot.current_ann.lat.astype(np.float32))
    # the published columns are `repro`'s, on the same inputs
    jtrie, jwl = _setup(REPRO, n_models=3, n_q=200)
    jann = REPRO.estimators.TrieAnnotator(
        jtrie, REPRO.estimators.OnlineEstimators.from_profile(
            jtrie, REPRO.profiler.profile_cascade(jwl, jtrie, 0.05, seed=5)))
    jann.estimators.observe(0, 0, False, 0.1, 2.0)
    np.testing.assert_array_equal(jann.annotations().acc,
                                  annot.current_ann.acc)


def test_annotator_rejects_mismatched_table_shape():
    for p in (REPRO, PORT):
        trie, _ = _setup(p, n_models=3, n_q=120)
        bad = p.estimators.OnlineEstimators.from_tables(
            np.full((2, 2), 0.5), np.zeros((2, 2)), np.ones((2, 2)))
        with pytest.raises(ValueError, match="shape"):
            p.estimators.TrieAnnotator(trie, bad)


# ------------------------------------------------------------------ profiler
def _prof_setup(p, n_models=3, repairs=2, n_q=60, seed=0):
    return _setup(p, n_models, repairs, n_q, seed, lo=0.35, span=0.4)


def _budget(p):
    trie, wl = _prof_setup(p)
    full = p.profiler.exhaustive_cost(wl, trie, checkpointed=False)
    return full, _profile_fields(
        p.profiler.profile_cascade(wl, trie, 0.05, seed=1))


def test_budget_respected():
    full, prof = both(_budget)
    assert prof["spent"] <= 0.05 * full * 1.3


def _regimes(p):
    trie, wl = _prof_setup(p, repairs=3)
    return (p.profiler.exhaustive_cost(wl, trie, checkpointed=False),
            p.profiler.exhaustive_cost(wl, trie, checkpointed=True),
            p.profiler.profile_cascade(wl, trie, 0.02, seed=0).spent)


def test_cost_regimes_ordering():
    full, chk, spent = both(_regimes)
    assert spent < chk < full and full / chk > 1.5


def _fillin(p, seed):
    trie, wl = _prof_setup(p, seed=seed % 5)
    prof = p.profiler.profile_cascade(wl, trie, 0.05, seed=seed)
    A, _, reached = wl.node_tables(trie)
    return _profile_fields(prof), A, reached


@pytest.mark.parametrize("seed", [0, 3, 77, 150])
def test_fillin_and_direct_consistency(seed):
    prof, A, reached = both(_fillin, seed)
    obs = prof["obs"] >= 0
    assert np.array_equal(prof["obs"][obs], A[obs])
    assert np.all(A[prof["fill"] == 1] == 1)
    assert np.all(reached[obs] == 1)


def _checkpointing(p):
    trie, wl = _prof_setup(p)
    return [_profile_fields(p.profiler.profile_cascade(
        wl, trie, 0.05, seed=3, checkpointing=ck)) for ck in (True, False)]


def test_checkpointing_saves_money():
    ck, no = both(_checkpointing)
    assert ck["checkpoint_hits"] > 0 and ck["runs"] >= no["runs"]


def _calibration(p):
    trie, wl = _prof_setup(p, n_q=40)
    prof = p.profiler.profile_cascade(wl, trie, 0.2, seed=0,
                                      calibration_fraction=0.3)
    return list(prof.calibration_rows), prof.observed_filled()


def test_calibration_rows_complete():
    rows, filled = both(_calibration)
    assert len(rows) >= 1
    assert all(np.all(filled[q, 1:] >= 0) for q in rows)


# ------------------------------------------------------------------- monitor
def _mon_setup(p, shift=False):
    trie, wl = _setup(p, n_models=3, n_q=500, lo=0.35, span=0.4)
    if shift:
        keep = np.random.default_rng(7).random(wl.S[:, :, 2].shape) < 0.15
        wl.S[:, :, 2] = wl.S[:, :, 2] * keep
    return trie, wl


def _feed(monitor, trie, wl, n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        q = int(rng.integers(wl.n_requests))
        models, lats, u, d, success = [], [], 0, 0, False
        while d < trie.template.max_depth:
            kids = trie.child[u][trie.child[u] >= 0]
            v = int(rng.choice(kids))
            m = int(trie.model[v])
            s, _, lat = wl.execute_stage(q, d, m)
            models.append(m)
            lats.append(lat)
            if s:
                success = True
                break
            u, d = v, d + 1
        monitor.record_run(models, success, lats)


def _report(rep):
    return (rep.drift_detected, list(map(int, rep.drifted_nodes)),
            rep.latency_ratio)


def _monitor_case(p, shift, n, min_obs=30):
    trie, wl0 = _mon_setup(p)
    ann = wl0.exact_annotations(trie)
    live = _mon_setup(p, shift=True)[1] if shift else wl0
    mon = p.monitor.DriftMonitor(trie, ann, min_obs=min_obs)
    _feed(mon, trie, live, n)
    recal = mon.recalibrate()
    out = {"report": _report(mon.check()), "recal": recal.acc,
           "monotone": recal.check_monotone(trie),
           "models": trie.model, "ann": ann.acc}
    if shift:
        truth = live.exact_annotations(trie)
        obj = p.controller.Objective(
            "max_acc",
            cost_cap=float(np.quantile(ann.cost[trie.terminal], 0.5)))
        out["truth"] = truth.acc
        out["depth"] = trie.depth
        out["nodes"] = (p.controller.select_path(trie, ann, obj),
                        p.controller.select_path(trie, recal, obj))
    return out


def test_no_false_alarm_in_distribution():
    out = both(_monitor_case, False, 600)
    assert not out["report"][0], out["report"]


def test_detects_model_degradation():
    out = both(_monitor_case, True, 800)
    detected, nodes, _ = out["report"]
    assert detected and 2 in {int(out["models"][u]) for u in nodes}


def test_recalibration_improves_decisions():
    out = both(_monitor_case, True, 1200)
    d = out["depth"] > 0
    truth = out["truth"]
    err_stale = np.abs(out["ann"][d] - truth[d]).mean()
    err_recal = np.abs(out["recal"][d] - truth[d]).mean()
    assert err_recal < err_stale * 0.6
    stale, recal = out["nodes"]
    assert truth[recal] >= truth[stale] - 1e-9


def test_recalibration_monotone():
    assert both(_monitor_case, False, 300, 20)["monotone"]


# ----------------------------------------------------------------- streaming
def _quantiles(p, samples, qs, grid=None):
    sk = p.streaming.QuantileSketch.log_spaced(**(grid or {}))
    sk.add(samples)
    return [sk.quantile(q) for q in qs], sk.edges, sk.counts


@pytest.mark.parametrize("samples,qs,grid", [
    ([5.0, 7.0, 9.0], (0.0, 1e-9), dict(lo=1e-3, hi=1e3, bins=64)),
    ([0.01, 0.01, 100.0, 100.0], (0.49, 0.5), dict(lo=1e-3, hi=1e3, bins=64)),
    ([0.5, 2.0, 40.0], (1.0,), dict(lo=1e-3, hi=1e3, bins=64)),
    ([0.1, 100.0], (0.0, 1.0), dict(lo=1.0, hi=10.0, bins=8)),
    ([], (0.5,), dict(bins=8)),
])
def test_quantile_boundary_ranks(samples, qs, grid):
    got, edges, _ = both(_quantiles, samples, qs, grid)
    if samples == [5.0, 7.0, 9.0]:
        assert 5.0 <= got[0] < 10.5
    elif samples == [0.01, 0.01, 100.0, 100.0]:
        assert 0.01 <= got[0] < 100.0 <= got[1]
    elif samples == [0.5, 2.0, 40.0]:
        assert 40.0 <= got[0] < 1e3
    elif samples == [0.1, 100.0]:
        assert got == [edges[0], edges[-1]]
    else:
        assert np.isnan(got[0])


def test_quantile_never_underestimates_inverted_cdf():
    samples = np.sort(np.random.default_rng(7).lognormal(0.0, 2.0, 500))
    qs = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)
    got, _, _ = both(_quantiles, samples, qs)
    rel = (1e4 / 1e-3) ** (1 / 512) - 1
    for q, g in zip(qs, got):
        exact = float(np.quantile(samples, q, method="inverted_cdf"))
        covered = samples[min(int(np.floor(q * 500)), 499)]
        assert exact - 1e-12 <= g <= covered * (1 + rel) * (1 + 1e-9)


def _merges(p):
    qs = p.streaming.QuantileSketch
    xs, ys = np.array([0.02, 0.5, 3.0, 3.0, 700.0]), \
        np.array([0.01, 0.5, 9000.0])
    a, b, u = qs.log_spaced(), qs.log_spaced(), qs.log_spaced()
    a.add(xs)
    b.add(ys)
    u.add(np.concatenate([xs, ys]))
    a.merge(b)
    for bad in (qs.log_spaced(lo=1e-2, hi=1e5, bins=64),
                qs.log_spaced(bins=128)):
        bad.add([1.0])
        with pytest.raises(ValueError):
            qs.log_spaced(lo=1e-3, hi=1e4, bins=64).merge(bad)
    with pytest.raises(ValueError, match="incompatible sketch binning"):
        qs.log_spaced(lo=1e-3, hi=1e4, bins=64).merge_counts(
            bad.counts[:65], edges=qs.log_spaced(lo=1e-2, hi=1e5,
                                                 bins=64).edges)
    with pytest.raises(TypeError):
        a.merge(u.counts)
    back = qs.from_state(a.state())
    return (a.counts, u.counts, [a.quantile(q) for q in (0, 0.5, 0.95, 1)],
            [u.quantile(q) for q in (0, 0.5, 0.95, 1)], back.counts,
            back.edges)


def test_sketch_merge_and_state_round_trip():
    merged, union, qm, qu, back, _ = both(_merges)
    np.testing.assert_array_equal(merged, union)
    np.testing.assert_array_equal(back, merged)
    assert qm == qu


def _welford(p):
    s = p.streaming
    rng = np.random.default_rng(3)
    xs, ys = rng.random(100), rng.random(57)
    wa, wb, wu = s.welford_init(), s.welford_init(), s.welford_init()
    for x in xs:
        wa, wu = s.welford_update(wa, x), s.welford_update(wu, x)
    for y in ys:
        wb, wu = s.welford_update(wb, y), s.welford_update(wu, y)
    assert s.welford_merge(wa, s.welford_init()) == wa
    assert s.welford_merge(s.welford_init(), wb) == wb
    return s.welford_finalize(s.welford_merge(wa, wb)), s.welford_finalize(wu)


def test_welford_merge_matches_single_stream():
    merged, ref = both(_welford)
    assert merged["count"] == ref["count"]
    assert merged["mean"] == pytest.approx(ref["mean"], rel=1e-12)
    assert merged["var"] == pytest.approx(ref["var"], rel=1e-9)


# ------------------------------------------------- refresh in the event loop
def _drift_refresh(p, device):
    """`benchmarks/drift.py`'s engine-slowdown lane with refresh, at 12
    requests on NL2SQL-2 (its --tiny workflow)."""
    tpl = p.presets.nl2sql_2()
    trie = p.trie.Trie.build(tpl)
    wl = p.workload.generate_workload(tpl, 300, seed=0)
    prof = p.profiler.profile_cascade(wl, trie, 0.2, seed=0,
                                      calibration_fraction=0.15)
    est = p.estimators.OnlineEstimators.from_profile(
        trie, prof, prior_strength=8.0, count_weight=0.0)
    ann0 = p.estimators.TrieAnnotator(trie, est).annotations()
    obj = p.controller.Objective(
        "max_acc", lat_cap=float(np.quantile(ann0.lat[trie.terminal], 0.9)))
    engines = sorted({m.engine for m in tpl.models})
    load = p.loadsim.FleetLoadModel(
        engines={e: p.loadsim.EngineLoadModel(e, concurrency=4, jitter=0.0)
                 for e in engines},
        mean_service_s={e: float(np.mean(wl.lat[:, :, [
            j for j, m in enumerate(tpl.models) if m.engine == e]]))
            for e in engines})
    n = 12
    reqs = np.random.default_rng(0).choice(wl.n_requests, n, replace=True)
    arr = p.workload.poisson_arrivals(n, 2.0, seed=1)
    hot = engines[0]
    execu = p.runtime.make_workload_executor(
        wl, p.loadsim.step_slowdown(float(arr[n // 2]), 4.0, engine=hot))
    kw = {} if device is None else {"device": device}
    res, stats = p.events.run_events(
        trie, ann0, obj, reqs, execu, arrivals=arr, capacity=16,
        policy="dynamic_load_aware", fleet_load=load,
        admission="feasibility",
        refresh=p.estimators.RefreshConfig(est, interval=1.0, decay=0.8),
        **kw)
    return ([(r.outcome, r.models, r.total_cost, r.total_lat)
             for r in res],
            [list(map(int, v)) for v in stats.stage_versions],
            {k: getattr(stats, k) for k in ("refreshes", "replans",
                                            "admitted", "rejected", "shed")},
            stats.done_t, est.state())


def test_refresh_run_matches_repro_host_loop():
    jout = _drift_refresh(REPRO, None)
    tout = _drift_refresh(PORT, "cpu")
    _same(jout, tout)
    assert tout[2]["refreshes"] >= 1
    assert max(max(v, default=0) for v in tout[1]) >= 1


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-1.3b", "zamba2-2.7b"])
def test_roofline_engine_model_matches_repro(arch):
    """`EngineTokenModel.from_roofline` with `repro`'s own roofline
    numbers passed in gives the same decode-step curve, field for field;
    the port has no default roofline and refuses a call without one."""
    import dataclasses

    import repro.configs as j_configs
    import repro_torch.configs as t_configs

    kw = dict(context_len=1024, kv_budget_bytes=4 << 30)
    want = j_loadsim.EngineTokenModel.from_roofline(
        "e", j_configs.get_config(arch), **kw)
    cfg = t_configs.get_config(arch)
    got = t_loadsim.EngineTokenModel.from_roofline(
        "e", cfg, peak_flops=j_loadsim.PEAK_FLOPS, hbm_bw=j_loadsim.HBM_BW,
        **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert not hasattr(t_loadsim, "PEAK_FLOPS")
    assert not hasattr(t_loadsim, "HBM_BW")
    with pytest.raises(TypeError, match="peak_flops"):
        t_loadsim.EngineTokenModel.from_roofline("e", cfg, hbm_bw=1e12)
    with pytest.raises(TypeError, match="hbm_bw"):
        t_loadsim.EngineTokenModel.from_roofline("e", cfg, peak_flops=1e15)
