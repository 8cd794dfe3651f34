"""Oracle path selection and online re-rooted control (paper §3.4, §4.3).

Two interchangeable implementations of the constrained trie search:

- ``select_path``      — vectorized masked argmin/argmax over the SoA trie
  (the TPU-native form; `controller_jax` jit/vmaps the same math);
- ``select_path_dfs``  — the paper's recursive DFS with monotone pruning
  (incumbent bounds; prune-on-satisfied-accuracy for min-cost objectives).

Both return the same optimum; property tests assert equivalence.

Online control is receding-horizon (§4.3): after each stage invocation the
controller re-roots at the realized prefix u, replaces latency budgets with
``cap - elapsed``, optionally inflates suffix latencies with live per-engine
delays delta_e(t), and re-solves the same search over descendants of u.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.trie import Trie, TrieAnnotations


@dataclasses.dataclass(frozen=True)
class Objective:
    """o = (f, C): optimize ``kind`` subject to the non-None constraints.

    ``acc_margin`` guards the accuracy floor against the optimizer's curse
    when planning on *estimated* annotations: the argmin over hundreds of
    noisy columns systematically selects over-estimated plans right at the
    boundary (beyond-paper extension; see fig9 benchmark).
    """

    kind: str  # "min_cost" | "max_acc"
    acc_floor: float | None = None
    cost_cap: float | None = None
    lat_cap: float | None = None
    acc_margin: float = 0.0

    def __post_init__(self):
        assert self.kind in ("min_cost", "max_acc")
        if self.kind == "min_cost":
            assert self.acc_floor is not None, "min_cost requires an accuracy floor"


def engine_delay_per_node(
    trie: Trie, engine_delays: dict[str, float] | None
) -> np.ndarray:
    """Cumulative live-load latency inflation along each root->node path:
    delay(u) = sum over stages on the path of delta_engine(model).  (§4.3)"""
    n = trie.n_nodes
    out = np.zeros(n)
    if not engine_delays:
        return out
    per_model = np.array(
        [engine_delays.get(m.engine, 0.0) for m in trie.template.models]
    )
    for u in range(1, n):
        out[u] = out[trie.parent[u]] + per_model[trie.model[u]]
    return out


def select_path(
    trie: Trie,
    ann: TrieAnnotations,
    obj: Objective,
    *,
    root: int = 0,
    elapsed_lat: float = 0.0,
    elapsed_cost: float = 0.0,
    engine_delays: dict[str, float] | None = None,
) -> int:
    """Best terminating plan among descendants of ``root``; -1 if none.

    Latency is a *per-request* budget (paper §3.3/§4.3): feasibility uses the
    incremental estimate dT_u(v) = T(v) - T(u) (+ live engine delays on the
    suffix) against the remaining wall-clock cap (lat_cap - elapsed_lat).
    Cost is *expectation-based* (paper §3.3): feasibility uses the absolute
    plan annotation C(v) <= cost_cap and is NOT re-conditioned on realized
    spend — exactly the paper's "only latency changes online" semantics
    (``elapsed_cost`` is kept for reporting/extensions, default-unused).
    """
    lo, hi = trie.descendants_interval(root)
    idx = np.arange(trie.n_nodes)
    feas = trie.terminal & (idx >= lo) & (idx < hi)

    delay = engine_delay_per_node(trie, engine_delays)
    d_lat = (ann.lat - ann.lat[root]) + (delay - delay[root])
    d_cost = ann.cost - ann.cost[root]

    if obj.lat_cap is not None:
        feas &= d_lat <= (obj.lat_cap - elapsed_lat) + 1e-12
    if obj.cost_cap is not None:
        feas &= ann.cost <= obj.cost_cap + 1e-12
    if obj.kind == "min_cost":
        feas &= ann.acc >= obj.acc_floor + obj.acc_margin - 1e-12
        if not feas.any():
            return -1
        # argmin cost, tie-break lower latency then shallower
        key = np.stack([d_cost, d_lat, trie.depth.astype(np.float64)])
        cand = np.nonzero(feas)[0]
        order = np.lexsort((key[2, cand], key[1, cand], key[0, cand]))
        return int(cand[order[0]])
    # max_acc: argmax accuracy, tie-break lower cost then lower latency
    if not feas.any():
        return -1
    cand = np.nonzero(feas)[0]
    order = np.lexsort((d_lat[cand], d_cost[cand], -ann.acc[cand]))
    return int(cand[order[0]])


def select_path_dfs(
    trie: Trie,
    ann: TrieAnnotations,
    obj: Objective,
    *,
    root: int = 0,
    elapsed_lat: float = 0.0,
    elapsed_cost: float = 0.0,
    engine_delays: dict[str, float] | None = None,
) -> int:
    """Reference recursive DFS with the paper's monotone pruning rules.

    min_cost: once a node satisfies the accuracy floor, descendants cannot
    improve the branch (weakly higher cost/latency) -> stop descending; the
    first feasible objective value becomes an incumbent bound and any prefix
    whose cost or latency already exceeds it is discarded.
    max_acc:  pruning is budget-driven only — prefixes over budget are cut
    (their descendants are monotonically worse); internal accuracy never
    justifies pruning (§4.3).
    """
    delay = engine_delay_per_node(trie, engine_delays)
    lat_budget = None if obj.lat_cap is None else obj.lat_cap - elapsed_lat
    cost_budget = None if obj.cost_cap is None else obj.cost_cap - elapsed_cost

    best: list[int] = [-1]
    best_key: list[tuple] = [()]

    def d_lat(v):
        return (ann.lat[v] - ann.lat[root]) + (delay[v] - delay[root])

    def d_cost(v):
        return ann.cost[v] - ann.cost[root]

    def over_budget(v):
        if lat_budget is not None and d_lat(v) > lat_budget + 1e-12:
            return True
        if cost_budget is not None and ann.cost[v] > obj.cost_cap + 1e-12:
            return True
        return False

    def visit(v: int):
        if over_budget(v):
            return  # monotone: all descendants also over budget
        if obj.kind == "min_cost":
            # incumbent bound: descendants have weakly higher cost, so any
            # prefix already strictly costlier than the incumbent is dead
            if best[0] >= 0 and d_cost(v) > best_key[0][0] + 1e-12:
                return
            if trie.terminal[v] and ann.acc[v] >= (obj.acc_floor
                                                   + obj.acc_margin) - 1e-12:
                key = (d_cost(v), d_lat(v), float(trie.depth[v]))
                if best[0] < 0 or key < best_key[0]:
                    best[0], best_key[0] = v, key
                return  # satisfied: descendants cannot improve this branch
        else:
            if trie.terminal[v]:
                key = (-ann.acc[v], d_cost(v), d_lat(v))
                if best[0] < 0 or key < best_key[0]:
                    best[0], best_key[0] = v, key
        for m in range(trie.n_models):
            c = trie.child[v, m]
            if c >= 0:
                visit(int(c))

    visit(root)
    return best[0]


# ----------------------------------------------------------------------
# online receding-horizon controller
# ----------------------------------------------------------------------
@dataclasses.dataclass
class PlanStep:
    """One receding-horizon replan decision: the terminal node the
    controller currently aims for, the model to invoke next on the way
    there (-1 = stop at the realized prefix), and the wall time the
    replanning step itself cost."""

    node: int            # planned terminating node (this replan's target)
    next_model: int      # model to invoke next; -1 => stop now
    replan_time_s: float # wall time of this replanning step


class OnlineController:
    """Per-invocation model selection with trie re-rooting (paper §4.3).

    ``policy``:
      "static"             — plan once at the root, then follow the path
                              (Murakkab-style commitment; used as baseline).
      "dynamic"            — re-root + replan after every stage invocation.
      "dynamic_load_aware" — dynamic + per-engine latency inflation.
    """

    def __init__(
        self,
        trie: Trie,
        ann: TrieAnnotations,
        obj: Objective,
        policy: str = "dynamic",
        restrict_nodes: np.ndarray | None = None,
    ):
        assert policy in ("static", "dynamic", "dynamic_load_aware")
        self.trie, self.ann, self.obj, self.policy = trie, ann, obj, policy
        self._static_path: list[int] | None = None
        if restrict_nodes is not None:
            # coarse-control baselines search a subset of plans (murakkab)
            self.ann = TrieAnnotations(
                acc=ann.acc.copy(), cost=ann.cost.copy(), lat=ann.lat.copy()
            )
            keep = np.zeros(trie.n_nodes, dtype=bool)
            keep[restrict_nodes] = True
            self._feas_override = keep
        else:
            self._feas_override = None

    def _select(self, root, elapsed_lat, elapsed_cost, engine_delays):
        if self._feas_override is None:
            return select_path(
                self.trie, self.ann, self.obj,
                root=root, elapsed_lat=elapsed_lat, elapsed_cost=elapsed_cost,
                engine_delays=engine_delays,
            )
        # restricted plan subset: mask by overriding terminal flags
        saved = self.trie.terminal
        try:
            self.trie.terminal = saved & self._feas_override
            return select_path(
                self.trie, self.ann, self.obj,
                root=root, elapsed_lat=elapsed_lat, elapsed_cost=elapsed_cost,
                engine_delays=engine_delays,
            )
        finally:
            self.trie.terminal = saved

    def plan(
        self,
        prefix_node: int,
        elapsed_lat: float,
        elapsed_cost: float = 0.0,
        engine_delays: dict[str, float] | None = None,
    ) -> PlanStep:
        """One receding-horizon step from the realized ``prefix_node``:
        re-root the trie, re-select under the remaining budget (elapsed
        latency/cost already burned, live ``engine_delays`` added per
        stage), and return the target node + next model as a `PlanStep`
        (``next_model=-1`` = stop here; under the static policy the
        t=0 plan is replayed without re-selection)."""
        import time

        t0 = time.perf_counter()
        if self.policy == "static":
            if self._static_path is None:
                tgt = self._select(0, 0.0, 0.0, None)
                self._static_path = (
                    self.trie.ancestors(tgt)[1:] if tgt >= 0 else []
                )
            # follow the committed path
            nxt = -1
            for v in self._static_path:
                if v == prefix_node:
                    i = self._static_path.index(v)
                    if i + 1 < len(self._static_path):
                        nxt = int(self.trie.model[self._static_path[i + 1]])
                    break
            else:
                if prefix_node == 0 and self._static_path:
                    nxt = int(self.trie.model[self._static_path[0]])
            return PlanStep(
                node=self._static_path[-1] if self._static_path else -1,
                next_model=nxt,
                replan_time_s=time.perf_counter() - t0,
            )
        delays = engine_delays if self.policy == "dynamic_load_aware" else None
        tgt = self._select(prefix_node, elapsed_lat, elapsed_cost, delays)
        if tgt < 0 or tgt == prefix_node:
            return PlanStep(node=tgt, next_model=-1,
                            replan_time_s=time.perf_counter() - t0)
        # first step from prefix_node toward tgt
        chain = self.trie.ancestors(tgt)
        i = chain.index(prefix_node)
        nxt = int(self.trie.model[chain[i + 1]])
        return PlanStep(node=tgt, next_model=nxt,
                        replan_time_s=time.perf_counter() - t0)
