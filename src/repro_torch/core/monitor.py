"""Drift monitoring + trie recalibration (paper §4.5 "Distribution
mismatch", implemented as a first-class feature).

The trie doubles as a monitoring abstraction: every served request yields
online observations of exactly the quantities the offline trie estimates —
conditional success at the reached prefixes and per-stage latency.  The
monitor aggregates these, flags prefixes whose live statistics drift
beyond a binomial/Gaussian confidence band of the offline annotation, and
produces a *recalibrated* annotation set by blending live conditionals
into the cascade decomposition (the same eq. (7)-(9) recursion — drift
handling reuses the paper's estimator machinery rather than a separate
model).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.estimators import _compose
from repro_torch.core.trie import Trie, TrieAnnotations


@dataclasses.dataclass
class DriftReport:
    """Outcome of one `DriftMonitor.check`: which trie nodes' live
    conditional accuracies left the offline band, with z-scores and the
    per-model live/offline latency ratios that triggered (or not) the
    drift flag."""

    drifted_nodes: np.ndarray       # node ids whose live stats left the band
    z_scores: np.ndarray            # per-node drift z-scores (nan = no data)
    latency_ratio: dict[int, float] # per-model live/offline latency ratio
    drift_detected: bool


class DriftMonitor:
    """Accumulates live per-invocation outcomes and checks them against the
    offline trie annotations."""

    def __init__(self, trie: Trie, ann: TrieAnnotations,
                 offline_q: np.ndarray | None = None,
                 z_threshold: float = 3.0, min_obs: int = 20):
        self.trie = trie
        self.ann = ann
        self.z_threshold = z_threshold
        self.min_obs = min_obs
        n = trie.n_nodes
        self.succ = np.zeros(n, dtype=np.int64)
        self.count = np.zeros(n, dtype=np.int64)
        self.lat_sum = np.zeros(trie.n_models)
        self.lat_count = np.zeros(trie.n_models, dtype=np.int64)
        # offline conditional success per node (derived from annotations if
        # not supplied): q(u) = (acc(u) - acc(parent)) / (1 - acc(parent))
        if offline_q is None:
            offline_q = np.zeros(n)
            for u in range(1, n):
                p = trie.parent[u]
                denom = max(1.0 - ann.acc[p], 1e-9)
                offline_q[u] = np.clip((ann.acc[u] - ann.acc[p]) / denom,
                                       0.0, 1.0)
        self.offline_q = offline_q

    # ------------------------------------------------------------------
    def record(self, node: int, success: bool, latency: float) -> None:
        """One stage invocation that *reached* trie node ``node``."""
        self.succ[node] += int(success)
        self.count[node] += 1
        m = int(self.trie.model[node])
        if m >= 0:
            self.lat_sum[m] += latency
            self.lat_count[m] += 1

    def record_run(self, models: list[int], success: bool,
                   stage_lats: list[float]) -> None:
        """A whole workflow run: stages 0..k-1 failed, stage k's outcome is
        ``success`` (cascade semantics — every recorded stage was reached)."""
        u = 0
        for i, m in enumerate(models):
            u = int(self.trie.child[u, m])
            is_last = i == len(models) - 1
            self.record(u, success if is_last else False, stage_lats[i])

    # ------------------------------------------------------------------
    def check(self) -> DriftReport:
        """Compare accumulated live stats against the offline annotations:
        per-node success-rate z-test (nodes with >= ``min_obs`` samples)
        plus per-model latency-ratio drift; see `DriftReport`."""
        n = self.trie.n_nodes
        z = np.full(n, np.nan)
        enough = self.count >= self.min_obs
        p0 = self.offline_q
        with np.errstate(divide="ignore", invalid="ignore"):
            phat = np.where(self.count > 0, self.succ / np.maximum(self.count, 1), 0)
            se = np.sqrt(np.maximum(p0 * (1 - p0), 1e-4) /
                         np.maximum(self.count, 1))
            z[enough] = ((phat - p0) / se)[enough]
        drifted = np.nonzero(enough & (np.abs(z) > self.z_threshold))[0]
        lat_ratio = {}
        for m in range(self.trie.n_models):
            if self.lat_count[m] >= self.min_obs:
                d1 = int(self.trie.child[0, m])
                offline = max(self.ann.lat[d1], 1e-9) if d1 >= 0 else 1.0
                lat_ratio[m] = float(
                    (self.lat_sum[m] / self.lat_count[m]) / offline)
        return DriftReport(
            drifted_nodes=drifted, z_scores=z, latency_ratio=lat_ratio,
            drift_detected=bool(len(drifted) > 0
                                or any(abs(r - 1) > 0.5
                                       for r in lat_ratio.values())))

    # ------------------------------------------------------------------
    def recalibrate(self, blend_strength: float = 25.0) -> TrieAnnotations:
        """Blend live conditional observations into the offline trie via the
        cascade decomposition: per node, a Beta-style shrinkage
        q' = (n_live*q_live + s*q_offline) / (n_live + s), then recompose
        mu via eq. (7)-(9).  Latency annotations scale by the per-model
        live/offline ratio.  This is the paper's "refresh or recalibrate
        the trie using newer requests" made concrete."""
        n = self.trie.n_nodes
        q = self.offline_q.copy()
        live = self.count > 0
        phat = np.where(live, self.succ / np.maximum(self.count, 1), 0.0)
        w = self.count / (self.count + blend_strength)
        q = np.where(live, w * phat + (1 - w) * q, q)
        acc = _compose(self.trie, np.clip(q, 0.0, 1.0))
        # latency: rescale each node's incremental latency by its model's ratio
        rep = self.check()
        lat = np.zeros(n)
        for u in range(1, n):
            p = self.trie.parent[u]
            inc = self.ann.lat[u] - self.ann.lat[p]
            ratio = rep.latency_ratio.get(int(self.trie.model[u]), 1.0)
            lat[u] = lat[p] + inc * ratio
        return TrieAnnotations(acc=acc, cost=self.ann.cost.copy(), lat=lat)
