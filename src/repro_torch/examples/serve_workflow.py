"""End-to-end example: VineLM controlling a *real* served model zoo
(`examples/serve_workflow.py` of `repro`, ported; same flags, plus
``--device``).

This is the paper's full loop with real invocations end to end:
 1. train a ladder of small LMs of increasing capacity (the "model pool" --
    bigger members are genuinely more accurate, slower, and pricier);
 2. wrap each in a serving engine with real token/latency telemetry;
 3. define a generate-and-repair workflow over a sequence-continuation
    task: an invocation succeeds when the model reproduces the source
    continuation above a match threshold; on failure the workflow retries
    (possibly with a different model -- that is the fine-grained control);
 4. cascade-profile request-path pairs with REAL stage executions
    (real $ cost from token counts, real measured wall-clock latency),
    apply subtree fill-in + cascade decomposition, annotate the trie;
 5. serve fresh requests THROUGH THE FLEET RUNTIME: the whole cohort
    replans in lockstep -- one batched device planner call per round --
    while stage execution drives the real engines; compare against the
    best Murakkab-style static config (scalar path: it plans once).

With ``--arrival-rate`` the closed cohort becomes an open Poisson stream
served by the event-driven runtime (`repro_torch.core.events`), with
``--capacity``, ``--admission``, ``--slo``, ``--classes``, ``--refresh``
and ``--explore`` as in `repro`'s example.  ``--device`` ("cuda" unless
the caller asks for "cpu") trains and serves the zoo and runs the
replans.

    python -m repro_torch.examples.serve_workflow [--requests 60]
    python -m repro_torch.examples.serve_workflow --device cpu \\
        --requests 24 --profile-runs 80
    python -m repro_torch.examples.serve_workflow --arrival-rate 4.0 \\
        --admission feasibility --slo 20

`main` returns what it printed as a dict, with the stage invocations per
engine (``invocations``) and the replans (``replans``), so a caller can
count the kernel launches they made.
"""
import argparse
import time

import numpy as np

from repro_torch.core.controller import Objective
from repro_torch.core.estimators import (
    OnlineEstimators,
    RefreshConfig,
    annotate,
)
from repro_torch.core.events import run_events
from repro_torch.core.fleet import run_fleet
from repro_torch.core.murakkab import murakkab_nodes
from repro_torch.core.profiler import ProfileResult
from repro_torch.core.runtime import run_cohort, summarize, summarize_by_class
from repro_torch.core.trie import Trie
from repro_torch.core.workflow import ModelSpec, make_refinement_workflow
from repro_torch.core.workload import (
    interactive_batch_classes,
    poisson_arrivals,
    sample_classes,
)
from repro_torch.data import DataConfig, MarkovLMData
from repro_torch.serving.zoo import build_zoo

VOCAB, SEQ, PROMPT, HORIZON = 64, 32, 16, 8
MATCH_THRESHOLD = 0.5  # fraction of continuation tokens that must match


def make_real_executor(engines, data_batches, invocations=None):
    """Stage executor backed by real engine.generate calls; each call is
    counted in ``invocations`` (engine name -> calls) when given."""
    names = list(engines)

    def executor(q, depth, model_idx, t_now=0.0):
        eng = engines[names[model_idx]]
        if invocations is not None:
            invocations[eng.name] = invocations.get(eng.name, 0) + 1
        toks, truth = data_batches[q]
        t0 = time.perf_counter()
        out, ttft, dec = eng.generate(toks[None, :PROMPT],
                                      max_new=HORIZON)
        latency = time.perf_counter() - t0
        match = float((out[0] == truth[:HORIZON]).mean())
        success = match >= MATCH_THRESHOLD
        cost = eng.cost_of(PROMPT, HORIZON)
        return success, cost, latency

    return executor


def cascade_profile_real(trie, executor, n_requests, coverage_runs, seed=0):
    """Cascade sampling against the real executor (paper §4.2)."""
    rng = np.random.default_rng(seed)
    D = trie.template.max_depth
    M = trie.template.n_models
    obs = np.full((n_requests, trie.n_nodes), -1, dtype=np.int8)
    fill = np.zeros((n_requests, trie.n_nodes), dtype=np.uint8)
    sc, sl = np.zeros((D, M)), np.zeros((D, M))
    cnt = np.zeros((D, M), dtype=np.int64)
    spent = 0.0
    seen = {}
    for run in range(coverage_runs):
        q = int(rng.integers(n_requests))
        u, d = 0, 0
        while d < D:
            kids = trie.child[u][trie.child[u] >= 0]
            v = int(rng.choice(kids))
            m = int(trie.model[v])
            if (q, v) in seen:  # checkpoint reuse — prefix already executed
                success, c, lat = seen[(q, v)]
            else:
                success, c, lat = executor(q, d, m)
                seen[(q, v)] = (success, c, lat)
                spent += c
                sc[d, m] += c
                sl[d, m] += lat
                cnt[d, m] += 1
            obs[q, v] = int(success)
            if success:
                lo, hi = trie.descendants_interval(v)
                fill[q, lo:hi] = 1
                break
            u, d = v, d + 1
    return ProfileResult(obs=obs, fill=fill, stage_cost_sum=sc,
                         stage_lat_sum=sl, stage_count=cnt, spent=spent,
                         runs=coverage_runs, checkpoint_hits=0)


def main(argv=None, *, zoo=None, ladder=None) -> dict:
    """Run the example with ``argv`` (the command line when None) on an
    already trained ``zoo`` (name -> `ServingEngine`), or on one trained
    here from ``ladder`` (`serving.zoo`'s by default)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device that trains and serves the zoo and runs "
                         "the replans (cuda, or cpu to run the plain "
                         "PyTorch versions)")
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--profile-runs", type=int, default=150)
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="serve an open Poisson stream at this rate "
                         "(requests/second on the virtual clock) through "
                         "the event-driven runtime")
    ap.add_argument("--capacity", type=int, default=16,
                    help="admission slots for --arrival-rate mode")
    ap.add_argument("--admission", default="always",
                    choices=("always", "feasibility", "predictive",
                             "cost_aware"),
                    help="admission/load-shedding policy for "
                         "--arrival-rate mode (repro_torch.core.admission)")
    ap.add_argument("--slo", type=float, default=None,
                    help="latency SLO in seconds (from arrival) for "
                         "--arrival-rate mode; required for the shedding "
                         "policies to have a deadline to act on")
    ap.add_argument("--classes", type=float, default=None, metavar="FRAC",
                    help="priority classes for --arrival-rate mode: FRAC "
                         "of requests are 'interactive' (deadline = "
                         "--slo/2, weight 4, may preempt), the rest "
                         "'batch' (deadline = --slo, weight 1)")
    ap.add_argument("--refresh", type=float, default=None, metavar="SECS",
                    help="online estimator refresh for --arrival-rate "
                         "mode: republish the trie annotations from the "
                         "streaming posteriors every SECS virtual seconds "
                         "(zero-retrace version swaps)")
    ap.add_argument("--explore", type=float, default=None, metavar="EPS",
                    help="epsilon-greedy exploration lane for "
                         "--arrival-rate mode: EPS of requests dispatch "
                         "one off-plan model to keep the posteriors fed")
    args = ap.parse_args(argv)
    for flag in ("refresh", "explore"):
        if getattr(args, flag) is not None and args.arrival_rate is None:
            ap.error(f"--{flag} requires --arrival-rate "
                     "(open-arrival mode)")
    if args.classes is not None and not 0.0 < args.classes < 1.0:
        ap.error("--classes FRAC must be in (0, 1)")
    if args.classes is not None and args.arrival_rate is None:
        ap.error("--classes requires --arrival-rate (open-arrival mode)")
    if args.classes is not None and args.slo is None:
        ap.error("--classes requires --slo (the interactive deadline is "
                 "derived from it)")

    dev = args.device
    print(f"== 1. training the model zoo (real PyTorch models on {dev}) ==")
    if zoo is None:
        kw = {} if ladder is None else {"ladder": ladder}
        zoo = build_zoo(vocab=VOCAB, seq_len=SEQ, seed=0, device=dev, **kw)
    specs = [ModelSpec(n, e.price_per_1k, 0.1, 0.001, 0.5)
             for n, e in zoo.items()]
    print("   zoo:", ", ".join(zoo))

    print("== 2. workflow template + trie ==")
    tpl = make_refinement_workflow("continuation", specs, max_repairs=2)
    trie = Trie.build(tpl)
    print(f"   {trie.n_nodes} nodes, {int(trie.terminal.sum())} plans")

    print("== 3. drawing tasks + real executor ==")
    data = MarkovLMData(DataConfig(vocab=VOCAB, seq_len=SEQ, batch=1,
                                   seed=0, kgram=2))
    data.state["step"] = 50_000  # fresh (held-out) region of the stream
    tasks = []
    n_total = args.requests * 2
    for _ in range(n_total):
        b = data.next_batch()
        toks = b["tokens"][0]
        truth = b["labels"][0][PROMPT - 1: PROMPT - 1 + HORIZON]
        tasks.append((toks, truth))
    invocations = {name: 0 for name in zoo}
    executor = make_real_executor(zoo, tasks, invocations)
    out = {"zoo": list(zoo), "invocations": invocations}

    print("== 4. cascade profiling with real invocations ==")
    t0 = time.perf_counter()
    profile = cascade_profile_real(trie, executor, args.requests,
                                   args.profile_runs)
    ann = annotate(trie, profile, "vinelm")
    print(f"   {profile.runs} runs, ${profile.spent:.4f}, "
          f"{time.perf_counter() - t0:.1f}s")
    for d1 in trie.nodes_at_depth(1):
        print(f"   depth-1 {tpl.models[trie.model[d1]].name}: "
              f"est acc={ann.acc[d1]:.2f} cost=${ann.cost[d1]:.4f} "
              f"lat={ann.lat[d1]:.2f}s")

    print("== 5. serving fresh requests under a cost budget ==")
    cap = float(np.quantile(ann.cost[trie.terminal], 0.45))
    obj = Objective("max_acc", cost_cap=cap)
    mk = murakkab_nodes(trie)
    fresh = np.arange(args.requests, args.requests * 2)
    if args.arrival_rate is not None:
        # open-arrival mode: Poisson stream through the event-driven
        # runtime — admission queueing + overlap-aware engine occupancy,
        # with the selected admission-control/load-shedding policy
        if args.slo is not None:
            obj = Objective("max_acc", cost_cap=cap, lat_cap=args.slo)
        arr = poisson_arrivals(len(fresh), args.arrival_rate, seed=1)
        kw = {}
        specs = None
        if args.classes is not None:
            specs = interactive_batch_classes(args.slo / 2.0)
            kw = dict(class_specs=specs,
                      classes=sample_classes(
                          len(fresh),
                          (args.classes, 1.0 - args.classes), seed=2))
        if args.refresh is not None:
            # the profile that built `ann` also seeds the posteriors, so
            # an idle refresh loop republishes the same annotations
            est = OnlineEstimators.from_profile(trie, profile)
            kw["refresh"] = RefreshConfig(est, interval=args.refresh)
        if args.explore is not None:
            kw["explore"] = {"epsilon": args.explore, "seed": 3}
        res, stats = run_events(trie, ann, obj, fresh, executor,
                                arrivals=arr, capacity=args.capacity,
                                admission=args.admission, device=dev, **kw)
        s = summarize(res)
        print(f"   budget=${cap:.4f}  rate={args.arrival_rate:.2f}/s "
              f"capacity={args.capacity}  admission={stats.policy}"
              + (f"  slo={args.slo:.1f}s" if args.slo is not None else ""))
        print(f"   VineLM open-arrival: acc={s['accuracy']:.3f} "
              f"goodput={s['goodput']:.3f} cost=${s['mean_cost']:.4f} "
              f"p99={s['p99_lat']:.2f}s (from arrival)")
        print(f"   {stats.events} events, {stats.replans} batched replans, "
              f"mean queue wait {stats.mean_queue_wait_s:.2f}s, "
              f"peak in-flight {max(stats.peak_occupancy.values())}")
        print(f"   admitted={stats.admitted} rejected={stats.rejected} "
              f"shed={stats.shed} downgraded={stats.downgraded}")
        if args.refresh is not None or args.explore is not None:
            print(f"   annotation republishes={stats.refreshes} "
                  f"explored={stats.explored}")
        if specs is not None:
            print(f"   preemptions={stats.preemptions} "
                  f"resumed={stats.resumed}")
            for name, cs in summarize_by_class(res, stats.class_of,
                                               specs).items():
                print(f"   class {name:11s}: n={cs['n']:3d} "
                      f"goodput={cs['goodput']:.3f} "
                      f"p99={cs['p99_lat']:.2f}s "
                      f"shed={cs['shed_rate']:.3f}")
        out.update(vine=s, replans=stats.replans, events=stats.events)
        return out
    # VineLM: the fleet runtime serves the whole cohort in lockstep — one
    # batched replan per round against the live engines
    vine_res, stats = run_fleet(trie, ann, obj, fresh, executor, device=dev)
    vine = summarize(vine_res)
    # Murakkab baseline: static plan committed at admission (scalar path)
    mura = summarize(run_cohort(trie, ann, obj, fresh, executor,
                                policy="static", restrict_nodes=mk,
                                device=dev))
    va, vc = vine["accuracy"], vine["mean_cost"]
    ma, mc = mura["accuracy"], mura["mean_cost"]
    print(f"   budget=${cap:.4f}")
    print(f"   VineLM fleet : acc={va:.3f} cost=${vc:.4f}  "
          f"({stats.rounds} lockstep rounds, "
          f"{stats.replan_s_per_request_round * 1e6:.1f}us/req/round replan)")
    print(f"   Murakkab     : acc={ma:.3f} cost=${mc:.4f}")
    print(f"   delta        : {(va - ma) * 100:+.1f}pp at "
          f"{(vc - mc) / max(mc, 1e-9) * 100:+.0f}% cost")
    out.update(vine=vine, murakkab=mura, replans=stats.rounds,
               rounds=stats.rounds)
    return out


if __name__ == "__main__":
    main()
