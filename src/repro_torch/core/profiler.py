"""Offline cascade profiler (paper §4.2).

Implements:
- **cascade sampling** — per sampled request, pick a random depth-1 model;
  on failure continue to a random depth-2 extension; and so on until success
  or the path is exhausted;
- **checkpointing** — a ``CheckpointStore`` keyed by (request, trie node)
  lets later runs resume from a shared prefix without re-executing (and
  without re-paying) it;
- **subtree fill-in** — a success at node u marks every descendant of u as
  successful at no extra cost (path semantics are prefix-closed);
- **budget accounting in dollars** — coverage is the fraction of the *full
  exhaustive* profiling cost spent, matching the paper's Table 2 regimes
  (VineLM sparse vs checkpointed-exhaustive vs naive-exhaustive).

The profiler only touches the workload through ``execute_stage`` — it never
reads the ground-truth tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.trie import Trie
from repro_torch.core.workload import Workload


@dataclasses.dataclass
class ProfileResult:
    """Sparse observations gathered by the profiler.

    obs      (n_q, n_nodes) int8: -1 missing, else the *direct* path-level
             outcome A(q, u) observed by a cascade run that reached u.
             Because a run reaches u only when u's prefix failed, the direct
             column mean of obs estimates the **conditional** success
             probability q(last(u) | prefix(u) fails)  (paper eq. (3)).
    fill     (n_q, n_nodes) uint8: 1 where subtree fill-in implies A(q,u)=1.
    stage_cost_sum / stage_lat_sum / stage_count  (D, M): telemetry of
             executed stages, for reconstructing cost/latency annotations.
    spent    dollars spent; runs: number of cascade runs.
    checkpoint_hits: prefix re-executions avoided by the checkpoint store.
    """

    obs: np.ndarray
    fill: np.ndarray
    stage_cost_sum: np.ndarray
    stage_lat_sum: np.ndarray
    stage_count: np.ndarray
    spent: float
    runs: int
    checkpoint_hits: int
    calibration_rows: np.ndarray = None  # requests profiled exhaustively

    def observed_filled(self) -> np.ndarray:
        """Combined view used by fill-in estimators: -1 missing, 0/1 value."""
        out = self.obs.copy()
        out[(self.fill == 1) & (out < 0)] = 1
        return out

    def stage_cost_mean(self) -> np.ndarray:
        """Per-node mean observed stage cost (0 where never executed)."""
        c = self.stage_count.copy().astype(np.float64)
        c[c == 0] = 1.0
        return self.stage_cost_sum / c

    def stage_lat_mean(self) -> np.ndarray:
        """Per-node mean observed stage latency (0 where never
        executed)."""
        c = self.stage_count.copy().astype(np.float64)
        c[c == 0] = 1.0
        return self.stage_lat_sum / c

    def stage_success_stats(self, trie) -> tuple[np.ndarray, np.ndarray]:
        """(D, M) conditional success mean and direct-observation count,
        aggregated from the per-node ``obs`` columns by (invocation
        depth, model) group.

        This is the prior table for the online accuracy posteriors
        (`repro.core.estimators.OnlineEstimators.from_profile`): each
        cell averages the direct conditional outcomes of every trie node
        invoking model m at position d.  Cells with no observations fall
        back to the depth mean, then the global mean, then 0.5 — the
        same fallback ladder the offline estimators use per node."""
        D = int(trie.template.max_depth)
        M = int(trie.template.n_models)
        succ = np.zeros((D, M))
        cnt = np.zeros((D, M))
        mask = self.obs >= 0
        col_cnt = mask.sum(axis=0)
        col_succ = np.where(mask, self.obs, 0).sum(axis=0)
        for u in range(1, trie.n_nodes):
            d = int(trie.depth[u]) - 1
            m = int(trie.model[u])
            succ[d, m] += col_succ[u]
            cnt[d, m] += col_cnt[u]
        mean = np.divide(succ, np.maximum(cnt, 1.0))
        have = cnt > 0
        g = mean[have].mean() if have.any() else 0.5
        for d in range(D):
            row_have = have[d]
            d_mean = mean[d, row_have].mean() if row_have.any() else g
            mean[d, ~row_have] = d_mean
        return mean, cnt


class CheckpointStore:
    """(request, node) -> executed stage outcome, with hit statistics.

    In the paper, checkpoints serialize real workflow state so deeper
    profiling workers resume from a shared prefix (§4.4).  Here the stage
    executor is pure, so the checkpoint payload is the stage outcome record;
    the *accounting* (prefix executions avoided and dollars saved) is what
    Table 2 measures.  A bounded capacity with FIFO eviction models the
    paper's storage-constrained ordering remark.
    """

    def __init__(self, capacity: int | None = None):
        self._store: dict[tuple[int, int], tuple[bool, float, float]] = {}
        self._order: list[tuple[int, int]] = []
        self.capacity = capacity
        self.hits = 0
        self.misses = 0

    def get(self, q: int, node: int):
        """Checkpointed stage record for (request, node), or None —
        counted as a hit or miss either way."""
        rec = self._store.get((q, node))
        if rec is not None:
            self.hits += 1
        else:
            self.misses += 1
        return rec

    def put(self, q: int, node: int, rec: tuple[bool, float, float]) -> None:
        """Store a stage record, FIFO-evicting past ``capacity``; an
        existing key is kept (first execution wins)."""
        key = (q, node)
        if key in self._store:
            return
        if self.capacity is not None and len(self._store) >= self.capacity:
            old = self._order.pop(0)
            self._store.pop(old, None)
        self._store[key] = rec
        self._order.append(key)


def profile_cascade(
    workload: Workload,
    trie: Trie,
    coverage: float,
    *,
    seed: int = 0,
    checkpointing: bool = True,
    checkpoint_capacity: int | None = None,
    calibration_fraction: float = 0.0,
) -> ProfileResult:
    """Run cascade sampling until ``coverage`` x full-exhaustive dollars.

    ``calibration_fraction`` optionally spends that share of the budget
    exhaustively profiling a few requests on *all* paths (checkpointed),
    producing complete observation rows.  Direct entries stay conditional-
    consistent (a node gets a direct entry only when its prefix failed), so
    the cascade-decomposition estimators are unaffected; feature/completion
    baselines (GBT, soft-impute) benefit from unbiased complete rows.
    """
    rng = np.random.default_rng(seed)
    n_q = workload.n_requests
    D, M = workload.template.max_depth, workload.template.n_models
    budget = coverage * exhaustive_cost(workload, trie, checkpointed=False)

    obs = np.full((n_q, trie.n_nodes), -1, dtype=np.int8)
    fill = np.zeros((n_q, trie.n_nodes), dtype=np.uint8)
    sc = np.zeros((D, M))
    sl = np.zeros((D, M))
    cnt = np.zeros((D, M), dtype=np.int64)
    store = CheckpointStore(checkpoint_capacity) if checkpointing else None

    spent = 0.0
    runs = 0
    calib_rows: list[int] = []
    if calibration_fraction > 0:
        calib_budget = calibration_fraction * budget
        for q in rng.permutation(n_q):
            if spent >= calib_budget:
                break
            q = int(q)
            calib_rows.append(q)
            # exhaustive DFS over the trie: execute every reached node once
            stack = [int(c) for c in trie.child[0][trie.child[0] >= 0]]
            while stack:
                v = stack.pop()
                d = int(trie.depth[v]) - 1
                m = int(trie.model[v])
                success, c, lat = workload.execute_stage(q, d, m)
                spent += c
                sc[d, m] += c
                sl[d, m] += lat
                cnt[d, m] += 1
                obs[q, v] = 1 if success else 0
                if success:
                    lo, hi = trie.descendants_interval(v)
                    fill[q, lo:hi] = 1
                else:
                    stack.extend(int(c2) for c2 in trie.child[v][trie.child[v] >= 0])
    # round-robin over requests so shallow columns approach full coverage,
    # matching the paper's "repeatedly pick a random node per query".
    order = rng.permutation(n_q)
    qi = 0
    while spent < budget:
        q = int(order[qi % n_q])
        qi += 1
        runs += 1
        u = 0
        d = 0
        while d < D:
            kids = trie.child[u][trie.child[u] >= 0]
            if kids.size == 0:
                break
            v = int(rng.choice(kids))
            m = int(trie.model[v])
            rec = store.get(q, v) if store is not None else None
            if rec is None:
                success, c, lat = workload.execute_stage(q, d, m)
                spent += c
                sc[d, m] += c
                sl[d, m] += lat
                cnt[d, m] += 1
                if store is not None:
                    store.put(q, v, (success, c, lat))
            else:
                success, c, lat = rec
            obs[q, v] = 1 if success else 0
            if success:
                lo, hi = trie.descendants_interval(v)
                fill[q, lo:hi] = 1
                break
            u, d = v, d + 1
    return ProfileResult(
        obs=obs,
        fill=fill,
        stage_cost_sum=sc,
        stage_lat_sum=sl,
        stage_count=cnt,
        spent=spent,
        runs=runs,
        checkpoint_hits=store.hits if store is not None else 0,
        calibration_rows=np.asarray(calib_rows, dtype=np.int64),
    )


# ----------------------------------------------------------------------
# Table-2 cost regimes (computed exactly from the workload's tables)
# ----------------------------------------------------------------------
def exhaustive_cost(workload: Workload, trie: Trie, *, checkpointed: bool) -> float:
    """Dollar cost of exhaustively profiling every (request, leaf path).

    checkpointed=True : every distinct reached (q, node) stage runs once
                        (shared prefixes reused via checkpoints).
    checkpointed=False: every leaf path re-runs from the root (stages up to
                        the first success re-executed per leaf).
    """
    _, _, reached = workload.node_tables(trie)
    n = trie.n_nodes
    stage_cost = np.zeros(n)
    for u in range(1, n):
        d = int(trie.depth[u]) - 1
        m = int(trie.model[u])
        tc, _ = workload.template.tool_cost_latency(d)
        stage_cost[u] = np.mean(
            (workload.cost[:, d, m] + tc) * reached[:, u]
        ) * workload.n_requests
    if checkpointed:
        return float(stage_cost.sum())
    # naive: each leaf replays its whole root->leaf chain
    total = 0.0
    # count, for each node u, how many leaves have u on their path: =
    # number of leaves in u's subtree.
    n_leaves_below = np.zeros(n, dtype=np.int64)
    leaves = trie.leaves()
    is_leaf = np.zeros(n, dtype=bool)
    is_leaf[leaves] = True
    for u in range(n - 1, -1, -1):
        lo, hi = trie.descendants_interval(u)
        n_leaves_below[u] = int(is_leaf[lo:hi].sum())
    for u in range(1, n):
        total += stage_cost[u] * n_leaves_below[u]
    return float(total)
