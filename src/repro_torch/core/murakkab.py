"""Murakkab-style coarse workflow-level control baseline (paper §2, §5.1).

Murakkab profiles full workflow *configurations*: one model bound to each
configurable stage **template** plus a loop horizon, fixed at admission.
For a generation+repair workflow that is (g, r, h): generation model g,
repair model r reused on every loop iteration, up to h repairs
(NL2SQL-8: 8 + 8*8 + 8*8 = 136 configs vs 584 trie plans; NL2SQL-2:
2 + 4 + 4 + 4 = 14 vs 30).  For a single repeated-stage workflow
(MathQA) it is (m, rounds): 4 * 6 = 24 configs vs 5460 plans.

Each configuration corresponds to exactly one trie node — the coarse space
is a *subset* of the trie's plan set, so both controllers share annotations
and the comparison isolates decision granularity (the paper's point).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.trie import Trie


def murakkab_nodes(trie: Trie) -> np.ndarray:
    """Trie nodes reachable by workflow-level configurations.

    A node qualifies iff every decision after the first uses the same model
    (stage templates bind one model; generation may differ from repair).
    For single-stage reflection workflows this degenerates to one model for
    the whole workflow — exactly the paper's MathQA remark.
    """
    tpl = trie.template
    stages = [d.stage for d in tpl.decisions]
    single_stage = len(set(stages)) == 1
    out = []
    for u in range(1, trie.n_nodes):
        if not trie.terminal[u]:
            continue
        path = trie.path(u)
        if single_stage:
            ok = all(m == path[0] for m in path)
        else:
            # first decision = generation; the rest share the repair model
            ok = len(path) <= 1 or all(m == path[1] for m in path[1:])
        if ok:
            out.append(u)
    return np.asarray(out, dtype=np.int64)
