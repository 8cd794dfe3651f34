"""Quickstart: build a trie, sparse-profile it, and control requests
(`examples/quickstart.py` of `repro`, ported; plus ``--device``).

    python -m repro_torch.examples.quickstart [--device cpu]

``--device`` ("cuda" unless the caller asks for "cpu") holds the fleet
planner's trie columns and runs its replans.  `main` returns the printed
lines.
"""
import argparse

import numpy as np

from repro_torch.core import (Objective, Trie, annotate, generate_workload,
                              make_workload_executor, murakkab_nodes,
                              profile_cascade, run_cohort, summarize)
from repro_torch.core.presets import nl2sql_8


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the planner (cuda, or cpu to run the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    lines = []

    def say(s):
        print(s)
        lines.append(s)

    # 1. workflow template -> execution trie (584 feasible plans)
    template = nl2sql_8()
    trie = Trie.build(template)
    say(f"workflow={template.name}: {trie.n_nodes} nodes, "
        f"{int(trie.terminal.sum())} plans, "
        f"{len(murakkab_nodes(trie))} Murakkab configs")

    # 2. representative offline dataset (synthetic ground truth here)
    workload = generate_workload(template, 800, seed=0)

    # 3. sparse cascade profiling at 2% of exhaustive cost + annotation
    profile = profile_cascade(workload, trie, coverage=0.02, seed=1)
    ann = annotate(trie, profile, "vinelm")
    say(f"profiled: {profile.runs} cascade runs, ${profile.spent:.2f}, "
        f"{profile.checkpoint_hits} checkpoint hits")

    # 4. serve requests under per-request objectives
    executor = make_workload_executor(workload)
    requests = np.arange(200)
    cap = float(np.quantile(ann.cost[trie.terminal], 0.4))
    obj = Objective("max_acc", cost_cap=cap)

    vine = summarize(run_cohort(trie, ann, obj, requests, executor,
                                policy="dynamic", device=args.device))
    mkb = summarize(run_cohort(trie, ann, obj, requests, executor,
                               policy="static",
                               restrict_nodes=murakkab_nodes(trie),
                               device=args.device))
    say(f"objective: max accuracy s.t. cost <= ${cap:.4f}")
    say(f"  VineLM   : acc={vine['accuracy']:.3f} "
        f"cost=${vine['mean_cost']:.4f} "
        f"replan={vine['mean_replan_overhead_s'] * 1e3:.2f}ms")
    say(f"  Murakkab : acc={mkb['accuracy']:.3f} "
        f"cost=${mkb['mean_cost']:.4f}")
    say(f"  delta    : {(vine['accuracy'] - mkb['accuracy']) * 100:+.1f}pp")
    return lines


if __name__ == "__main__":
    main()
