"""MathQA-style reflection workflow under latency SLOs with live load:
static commitment vs dynamic replanning vs load-aware replanning
(paper §5.4 / Fig. 10 in miniature; `examples/mathqa_loadaware.py` of
`repro`, ported; plus ``--device``).

    python -m repro_torch.examples.mathqa_loadaware [--device cpu]

``--device`` ("cuda" unless the caller asks for "cpu") holds the
planner's trie columns and runs its replans.  `main` returns the printed
lines.
"""
import argparse

import numpy as np

from repro_torch.core.controller import Objective
from repro_torch.core.presets import mathqa_4
from repro_torch.core.runtime import (make_workload_executor, run_cohort,
                                      summarize)
from repro_torch.core.trie import Trie
from repro_torch.core.workload import generate_workload
from repro_torch.serving.loadsim import EngineLoadModel, LoadTrace


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

    tpl = mathqa_4()
    trie = Trie.build(tpl)
    wl = generate_workload(tpl, 300, seed=0)
    ann = wl.exact_annotations(trie)
    say(f"{tpl.name}: {int(trie.terminal.sum())} plans "
        f"(Murakkab sees {4 * 6})")

    engines = sorted({m.engine for m in tpl.models})
    load = LoadTrace({e: EngineLoadModel(e, concurrency=4) for e in engines},
                     period_s=12.0, max_load=16, seed=5)
    probe = load.delay_probe({e: 1.5 for e in engines})
    execu = make_workload_executor(
        wl, slowdown_fn=lambda e, t: load.slowdown_at(e, t))

    slo = float(np.quantile(ann.lat[trie.terminal], 0.5))
    obj = Objective("max_acc", lat_cap=slo)
    reqs = np.random.default_rng(0).choice(wl.n_requests, 150, replace=False)

    say(f"latency SLO = {slo:.1f}s, engines under rotating load")
    for policy, kw in (
        ("static (Murakkab-style)", dict(policy="static")),
        ("dynamic", dict(policy="dynamic")),
        ("dynamic + load-aware", dict(policy="dynamic_load_aware",
                                      load_probe=probe)),
    ):
        out = []
        for i, q in enumerate(reqs):
            out.extend(run_cohort(trie, ann, obj, [q], execu,
                                  t_start=float(i * 1.1),
                                  device=args.device, **kw))
        s = summarize(out)
        say(f"  {policy:26s}: violations={s['slo_violation_rate']:.3f} "
            f"acc={s['accuracy']:.3f} p99={s['p99_lat']:.1f}s")
    return lines


if __name__ == "__main__":
    main()
