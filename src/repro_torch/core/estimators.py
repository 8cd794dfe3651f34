"""Trie annotation estimators (paper §4.2, §5.3, Appendix A).

Six estimators of the per-path expected accuracy (column means of the
request-path table A), in the paper's order:

1. ``direct_average``   — raw mean of direct cascade observations.  Badly
   pessimistic for deep paths: those columns are observed only on the hard
   subpopulation where every earlier stage failed (MNAR, eq. (3)).
2. ``prefix_avg``       — prefix-success closure (subtree fill-in) then
   column average.  Optimistic: fill-in injects the easy successes but the
   observed failures still come from the hard subpopulation.
3. ``prefix_impute``    — fill-in, then low-rank soft-impute matrix
   completion, then column means.
4. ``prefix_gbt``       — fill-in, then gradient-boosted stumps on
   hand-designed path/observation features (in-repo replacement for the
   paper's XGBoost baseline).
5. ``vinelm_lite``      — cascade decomposition (eq. (7)-(9)): treat direct
   column means as *conditional* accuracies and reconstruct path means via
   mu(u) = mu(parent) + (1 - mu(parent)) * q(last | prefix fails).
6. ``vinelm``           — cascade decomposition + rank-1 SVD smoothing of
   the sparse deep conditional blocks (§A.4).

All return a vector ``mu`` over trie nodes with ``mu[0] = 0``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.profiler import ProfileResult
from repro_torch.core.streaming import welford_merge, welford_update
from repro_torch.core.trie import Trie, TrieAnnotations


# ----------------------------------------------------------------------
# shared helpers
# ----------------------------------------------------------------------
def _col_stats(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Column means & counts of an int8 matrix with -1 = missing."""
    mask = values >= 0
    cnt = mask.sum(axis=0)
    s = np.where(mask, values, 0).sum(axis=0)
    mean = np.divide(s, np.maximum(cnt, 1), dtype=np.float64)
    return mean, cnt


def _fallback_by_depth_model(
    trie: Trie, est: np.ndarray, have: np.ndarray
) -> np.ndarray:
    """Fill missing per-node values with (depth, model)-group means, then
    depth means, then the global mean."""
    out = est.copy()
    depth = trie.depth
    model = trie.model
    global_mean = est[have].mean() if have.any() else 0.5
    for d in np.unique(depth[depth > 0]):
        sel_d = depth == d
        d_have = sel_d & have
        d_mean = est[d_have].mean() if d_have.any() else global_mean
        for m in np.unique(model[sel_d]):
            sel = sel_d & (model == m)
            g_have = sel & have
            g_mean = est[g_have].mean() if g_have.any() else d_mean
            out[sel & ~have] = g_mean
    return out


def _monotone_floor(trie: Trie, mu: np.ndarray) -> np.ndarray:
    """Clip to [0,1]; used by baselines (no monotonicity enforcement —
    the paper's baselines are biased and that is the point)."""
    return np.clip(mu, 0.0, 1.0)


# ----------------------------------------------------------------------
# 1-2: averaging estimators
# ----------------------------------------------------------------------
def direct_average(trie: Trie, profile: ProfileResult) -> np.ndarray:
    """Estimator 1: per-node mean over *observed* outcomes only, with
    depth/model fallback for unobserved nodes and a monotone floor."""
    mean, cnt = _col_stats(profile.obs)
    mu = _fallback_by_depth_model(trie, mean, cnt > 0)
    mu[0] = 0.0
    return _monotone_floor(trie, mu)


def prefix_avg(trie: Trie, profile: ProfileResult) -> np.ndarray:
    """Estimator 2: per-node mean over prefix-filled outcomes (a success
    observed at a node implies success at every ancestor), same fallback
    and monotone floor as `direct_average`."""
    mean, cnt = _col_stats(profile.observed_filled())
    mu = _fallback_by_depth_model(trie, mean, cnt > 0)
    mu[0] = 0.0
    return _monotone_floor(trie, mu)


# ----------------------------------------------------------------------
# 3: fill-in + low-rank soft-impute
# ----------------------------------------------------------------------
def _truncated_svd(X: np.ndarray, r: int, seed: int = 0):
    """Randomized truncated SVD (no scipy in this container)."""
    rng = np.random.default_rng(seed)
    n, m = X.shape
    k = min(r + 6, min(n, m))
    Omega = rng.standard_normal((m, k))
    Y = X @ Omega
    for _ in range(2):  # power iterations for accuracy
        Y = X @ (X.T @ Y)
    Q, _ = np.linalg.qr(Y)
    B = Q.T @ X
    Ub, s, Vt = np.linalg.svd(B, full_matrices=False)
    U = Q @ Ub
    return U[:, :r], s[:r], Vt[:r]


def prefix_impute(
    trie: Trie,
    profile: ProfileResult,
    *,
    rank: int = 4,
    iters: int = 15,
    ridge: float = 2.0,
) -> np.ndarray:
    """Low-rank matrix completion with row/column biases, fit on observed
    entries by alternating ridge least squares (standard recommender-style
    completion; the strongest fair version of the paper's baseline)."""
    filled = profile.observed_filled().astype(np.float64)
    mask = filled >= 0
    n_q, n = filled.shape
    rng = np.random.default_rng(0)
    g = filled[mask].mean() if mask.any() else 0.5
    br = np.zeros(n_q)
    bc = np.zeros(n)
    U = 0.01 * rng.standard_normal((n_q, rank))
    V = 0.01 * rng.standard_normal((n, rank))
    W = mask.astype(np.float64)
    Y = np.where(mask, filled, 0.0)
    for _ in range(iters):
        # biases (closed form given factors)
        resid = Y - (g + bc[None, :] + (U @ V.T)) * W
        br = (resid * W).sum(1) / (W.sum(1) + ridge)
        resid = Y - (g + br[:, None] + (U @ V.T)) * W
        bc = (resid * W).sum(0) / (W.sum(0) + ridge)
        R = Y - (g + br[:, None] + bc[None, :]) * W
        # ALS: per-row then per-col ridge solves
        for i in range(n_q):
            m = mask[i]
            if not m.any():
                continue
            Vm = V[m]
            A = Vm.T @ Vm + ridge * np.eye(rank)
            U[i] = np.linalg.solve(A, Vm.T @ R[i, m])
        for j in range(n):
            m = mask[:, j]
            if not m.any():
                continue
            Um = U[m]
            A = Um.T @ Um + ridge * np.eye(rank)
            V[j] = np.linalg.solve(A, Um.T @ R[m, j])
    X = np.clip(g + br[:, None] + bc[None, :] + U @ V.T, 0.0, 1.0)
    X = np.where(mask, filled, X)
    mu = X.mean(axis=0)
    mu[0] = 0.0
    return _monotone_floor(trie, mu)


# ----------------------------------------------------------------------
# 4: fill-in + gradient-boosted stumps (XGBoost stand-in)
# ----------------------------------------------------------------------
class _GBTStumps:
    """Tiny gradient-boosted regression stumps, squared loss."""

    def __init__(self, rounds: int = 200, lr: float = 0.08, n_thresh: int = 16):
        self.rounds, self.lr, self.n_thresh = rounds, lr, n_thresh
        self.stumps: list[tuple[int, float, float, float]] = []
        self.base = 0.0

    def fit(self, F: np.ndarray, y: np.ndarray) -> "_GBTStumps":
        self.base = float(y.mean())
        pred = np.full_like(y, self.base)
        for _ in range(self.rounds):
            resid = y - pred
            best = None  # (sse, j, t, left, right)
            for j in range(F.shape[1]):
                col = F[:, j]
                qs = np.quantile(col, np.linspace(0.05, 0.95, self.n_thresh))
                for t in np.unique(qs):
                    m = col <= t
                    if m.all() or not m.any():
                        continue
                    l, r = resid[m].mean(), resid[~m].mean()
                    sse = ((resid[m] - l) ** 2).sum() + ((resid[~m] - r) ** 2).sum()
                    if best is None or sse < best[0]:
                        best = (sse, j, float(t), float(l), float(r))
            if best is None:
                break
            _, j, t, l, r = best
            self.stumps.append((j, t, l, r))
            pred = pred + self.lr * np.where(F[:, j] <= t, l, r)
        return self

    def predict(self, F: np.ndarray) -> np.ndarray:
        pred = np.full(F.shape[0], self.base)
        for j, t, l, r in self.stumps:
            pred = pred + self.lr * np.where(F[:, j] <= t, l, r)
        return pred


def _column_features(trie: Trie, profile: ProfileResult) -> np.ndarray:
    """Hand-designed features per trie node (paper §5.3: depth, observation
    counts, column means, prefix values, sibling statistics, model power)."""
    filled = profile.observed_filled()
    fmean, fcnt = _col_stats(filled)
    dmean, dcnt = _col_stats(profile.obs)
    fmean = _fallback_by_depth_model(trie, fmean, fcnt > 0)
    n = trie.n_nodes
    par = trie.parent.copy()
    par[0] = 0
    parent_est = fmean[par]
    # model power proxy: depth-1 filled mean of the same model
    d1 = trie.nodes_at_depth(1)
    power = np.zeros(trie.n_models)
    for u in d1:
        power[trie.model[u]] = fmean[u]
    power_f = np.where(trie.model >= 0, power[np.maximum(trie.model, 0)], 0.0)
    # sibling mean
    sib = np.zeros(n)
    for u in range(n):
        kids = trie.child[u][trie.child[u] >= 0]
        if kids.size:
            sib[kids] = fmean[kids].mean()
    # observed-row hardness: mean success of the rows observed in the column
    obs = profile.obs
    row_succ = np.where(obs >= 0, obs, 0).sum(axis=1) / np.maximum(
        (obs >= 0).sum(axis=1), 1
    )
    hardness = np.zeros(n)
    for u in range(n):
        rows = obs[:, u] >= 0
        hardness[u] = row_succ[rows].mean() if rows.any() else row_succ.mean()
    F = np.stack(
        [
            trie.depth.astype(np.float64),
            dcnt.astype(np.float64),
            fcnt.astype(np.float64),
            fmean,
            parent_est,
            power_f,
            sib,
            hardness,
            np.where(dcnt > 0, dmean, -1.0),
        ],
        axis=1,
    )
    return F


def prefix_gbt(trie: Trie, profile: ProfileResult, *, rounds: int = 200) -> np.ndarray:
    """Estimator 4: gradient-boosted stumps over per-node features,
    trained on the least-biased target columns available (calibration
    rows when provided, else near-fully-observed columns)."""
    F = _column_features(trie, profile)
    filled = profile.observed_filled()
    fmean, fcnt = _col_stats(filled)
    n_q = filled.shape[0]
    calib = profile.calibration_rows
    if calib is not None and len(calib) >= 8:
        # calibration rows are exhaustively profiled, so their column means
        # are unbiased (high-variance) targets across *all* depths
        sub = filled[calib]
        tgt_mean, tgt_cnt = _col_stats(sub)
        train = (tgt_cnt >= max(4, int(0.8 * len(calib)))) & (trie.depth > 0)
        targets = tgt_mean
    else:
        # no calibration: train on near-fully-observed columns, whose filled
        # means are unbiased irrespective of the MNAR pattern
        train = (fcnt >= 0.85 * n_q) & (trie.depth > 0)
        targets = fmean
    if train.sum() < 6:
        train = (fcnt >= np.quantile(fcnt[trie.depth > 0], 0.8)) & (trie.depth > 0)
        targets = fmean
    model = _GBTStumps(rounds=rounds).fit(F[train], targets[train])
    mu = model.predict(F)
    mu[0] = 0.0
    return _monotone_floor(trie, mu)


# ----------------------------------------------------------------------
# 5-6: cascade decomposition (VineLM-Lite) and + rank-1 smoothing (VineLM)
# ----------------------------------------------------------------------
def _conditional_means(trie: Trie, profile: ProfileResult):
    """Direct column means = unbiased conditional accuracies (eq. (3))."""
    return _col_stats(profile.obs)


def _compose(trie: Trie, q_hat: np.ndarray) -> np.ndarray:
    """mu(u) = mu(parent) + (1 - mu(parent)) * q_hat(u)   (eq. (7)-(9))."""
    mu = np.zeros(trie.n_nodes)
    for u in range(1, trie.n_nodes):
        p = trie.parent[u]
        mu[u] = mu[p] + (1.0 - mu[p]) * q_hat[u]
    return mu


def vinelm_lite(trie: Trie, profile: ProfileResult) -> np.ndarray:
    """Estimator 5: cascade decomposition — estimate per-node conditional
    accuracies (unbiased under MNAR prefix observation) and compose them
    down the trie (paper eq. (3), (7)-(9))."""
    q_mean, q_cnt = _conditional_means(trie, profile)
    q_hat = _fallback_by_depth_model(trie, q_mean, q_cnt > 0)
    q_hat = np.clip(q_hat, 0.0, 1.0)
    q_hat[0] = 0.0
    return _compose(trie, q_hat)


def vinelm(
    trie: Trie,
    profile: ProfileResult,
    *,
    smooth_min_obs: int = 30,
    rank: int = 1,
) -> np.ndarray:
    """Cascade decomposition with rank-1 smoothing of sparse depth blocks.

    For each depth d whose median per-column direct-observation count is
    below ``smooth_min_obs`` (paper: the depth-3 block at 5% coverage has
    ~20-80 observations per column), assemble the conditional matrix
    Q_d[prefix, model], initialize unobserved entries with column means, and
    project onto the rank-1 manifold (§A.4, eq. (10)).  Well-observed blocks
    keep their raw conditional means to avoid introducing bias.
    """
    q_mean, q_cnt = _conditional_means(trie, profile)
    q_hat = _fallback_by_depth_model(trie, q_mean, q_cnt > 0)
    q_hat = np.clip(q_hat, 0.0, 1.0)
    q_hat[0] = 0.0

    max_depth = int(trie.depth.max())
    for d in range(2, max_depth + 1):
        nodes_d = trie.nodes_at_depth(d)
        med = np.median(q_cnt[nodes_d]) if nodes_d.size else np.inf
        if med >= smooth_min_obs:
            continue
        prefixes = trie.nodes_at_depth(d - 1)
        M = trie.n_models
        pidx = {int(u): i for i, u in enumerate(prefixes)}
        Q = np.full((len(prefixes), M), np.nan)
        W = np.zeros((len(prefixes), M))
        for v in nodes_d:
            i = pidx[int(trie.parent[v])]
            m = int(trie.model[v])
            if q_cnt[v] > 0:
                Q[i, m] = q_mean[v]
                W[i, m] = q_cnt[v]
        # column-mean initialization for unobserved entries
        col = np.nanmean(np.where(np.isnan(Q), np.nan, Q), axis=0)
        col = np.where(np.isnan(col), np.nanmean(col) if not np.all(np.isnan(col)) else 0.5, col)
        Qf = np.where(np.isnan(Q), col[None, :], Q)
        # rank-r projection (paper: rank-1)
        U, s, Vt = np.linalg.svd(Qf, full_matrices=False)
        Qs = (U[:, :rank] * s[:rank]) @ Vt[:rank]
        Qs = np.clip(Qs, 0.0, 1.0)
        for v in nodes_d:
            i = pidx[int(trie.parent[v])]
            q_hat[v] = Qs[i, int(trie.model[v])]
    return _compose(trie, q_hat)


# ----------------------------------------------------------------------
# registry + full annotation (accuracy + reconstructed cost & latency)
# ----------------------------------------------------------------------
ESTIMATORS = {
    "direct_average": direct_average,
    "prefix_avg": prefix_avg,
    "prefix_impute": prefix_impute,
    "prefix_gbt": prefix_gbt,
    "vinelm_lite": vinelm_lite,
    "vinelm": vinelm,
}


def estimate_accuracy(name: str, trie: Trie, profile: ProfileResult, **kw) -> np.ndarray:
    """Dispatch to a named estimator in `ESTIMATORS` (paper §5 table)."""
    return ESTIMATORS[name](trie, profile, **kw)


def _stage_means_filled(trie: Trie, profile: ProfileResult):
    """(D, M) cost/latency means with model-mean then global fallbacks."""
    cm, lm = profile.stage_cost_mean(), profile.stage_lat_mean()
    cnt = profile.stage_count
    out_c, out_l = cm.copy(), lm.copy()
    have = cnt > 0
    for arr_src, arr_out in ((cm, out_c), (lm, out_l)):
        g = arr_src[have].mean() if have.any() else 0.0
        for m in range(arr_src.shape[1]):
            col_have = have[:, m]
            col_mean = arr_src[col_have, m].mean() if col_have.any() else g
            arr_out[~col_have, m] = col_mean
    return out_c, out_l


def annotate(
    trie: Trie, profile: ProfileResult, name: str = "vinelm", **kw
) -> TrieAnnotations:
    """Full trie annotation from a sparse profile.

    Accuracy via the chosen estimator; cost reconstructed as
    C(u) = C(parent) + (1 - mu(parent)) * c(d, m)   (early-stop discounted);
    latency as T(u) = T(parent) + tau(d, m)         (conditional, undiscounted)
    — the paper's §3.3 semantics, with (d, m) means from profiler telemetry.
    """
    mu = estimate_accuracy(name, trie, profile, **kw)
    cmean, lmean = _stage_means_filled(trie, profile)
    n = trie.n_nodes
    cost = np.zeros(n)
    lat = np.zeros(n)
    tpl = trie.template
    for u in range(1, n):
        p = int(trie.parent[u])
        d = int(trie.depth[u]) - 1
        m = int(trie.model[u])
        tc, tl = tpl.tool_cost_latency(d)
        cost[u] = cost[p] + (1.0 - mu[p]) * (cmean[d, m] + tc)
        lat[u] = lat[p] + lmean[d, m] + tl
    return TrieAnnotations(acc=mu, cost=cost, lat=lat)


# ----------------------------------------------------------------------
# online estimator refresh (ISSUE 8): streaming posteriors over the
# per-(invocation depth, model) stage statistics, seeded from the offline
# cascade profile as priors, with exponential forgetting so drift
# (engines slowing down, model-quality regressions) is tracked instead of
# averaged away.  `TrieAnnotator` re-derives the trie annotation tables
# from the current posteriors and publishes them as versioned
# `controller_jax.TrieDevice` columns that swap into the running control
# plane with zero new compiled programs.
# ----------------------------------------------------------------------
@dataclasses.dataclass
class BetaPosterior:
    """Streaming Beta posterior over a stage success probability.

    The offline profile contributes the prior (``prior`` mean backed by
    ``strength`` pseudo-observations); online executions accumulate into
    the decayed sufficient statistics ``weight`` (observation count) and
    ``successes``.  `mean` is written as *prior plus correction* —
    ``prior + (successes - weight*prior) / (strength + weight)`` — which
    is algebraically the Beta posterior mean
    ``(strength*prior + successes) / (strength + weight)`` but evaluates
    to the offline prior BITWISE when there are zero online observations
    (the correction term is exactly ±0.0), so an idle refresh loop can
    never perturb the offline annotations.
    """

    prior: float
    strength: float
    weight: float = 0.0
    successes: float = 0.0

    def observe(self, success: bool, weight: float = 1.0) -> None:
        """Fold one realized stage outcome into the posterior."""
        self.weight += weight
        if success:
            self.successes += weight

    def decay(self, gamma: float) -> None:
        """Exponential forgetting: scale the online evidence by ``gamma``
        in [0, 1].  The posterior mean moves monotonically toward the
        offline prior as ``gamma`` shrinks (the evidence weight
        ``gamma*weight / (strength + gamma*weight)`` is increasing in
        ``gamma``)."""
        if not 0.0 <= gamma <= 1.0:
            raise ValueError(f"decay factor must be in [0, 1], got {gamma}")
        self.weight *= gamma
        self.successes *= gamma

    def mean(self) -> float:
        """Posterior mean; exactly ``prior`` at zero observations."""
        return self.prior + (self.successes - self.weight * self.prior) / (
            self.strength + self.weight)

    def ucb(self, c: float = 1.0) -> float:
        """Optimistic upper bound ``mean + c / sqrt(strength + weight)``
        for UCB-style exploration scoring."""
        return self.mean() + c / np.sqrt(self.strength + self.weight)

    def merge(self, other: "BetaPosterior") -> "BetaPosterior":
        """Combine evidence from two streams over the same prior.  Sums
        of sufficient statistics, so merge is exactly commutative."""
        if (other.prior, other.strength) != (self.prior, self.strength):
            raise ValueError("cannot merge BetaPosteriors with different "
                             "priors")
        return BetaPosterior(self.prior, self.strength,
                             self.weight + other.weight,
                             self.successes + other.successes)

    def state(self) -> dict:
        """JSON-able snapshot; `from_state` round-trips it exactly."""
        return {"prior": self.prior, "strength": self.strength,
                "weight": self.weight, "successes": self.successes}

    @classmethod
    def from_state(cls, state: dict) -> "BetaPosterior":
        """Rebuild from a `state()` snapshot."""
        return cls(**state)


@dataclasses.dataclass
class GaussianPosterior:
    """Streaming posterior over a stage cost/latency mean.

    Online evidence lives in a `repro.core.streaming` Welford triple
    ``(count, mean, M2)``; `decay` scales ``count`` and ``M2`` (standard
    exponential-forgetting Welford), and `mean` shrinks the evidence mean
    toward the offline prior by ``count / (strength + count)`` — the
    normal-inverse-gamma posterior mean under a prior worth ``strength``
    observations.  Like `BetaPosterior`, the prior-plus-correction form
    makes the zero-observation posterior bitwise equal to the prior.
    """

    prior: float
    strength: float
    welford: tuple = (0.0, 0.0, 0.0)

    def observe(self, x: float) -> None:
        """Fold one realized value into the Welford triple."""
        self.welford = welford_update(self.welford, float(x))

    def decay(self, gamma: float) -> None:
        """Exponential forgetting: scale the evidence count and spread."""
        if not 0.0 <= gamma <= 1.0:
            raise ValueError(f"decay factor must be in [0, 1], got {gamma}")
        n, m, m2 = self.welford
        self.welford = (n * gamma, m, m2 * gamma)

    def mean(self) -> float:
        """Posterior mean; exactly ``prior`` at zero observations."""
        n, m, _ = self.welford
        return self.prior + n * (m - self.prior) / (self.strength + n)

    def merge(self, other: "GaussianPosterior") -> "GaussianPosterior":
        """Combine evidence via Chan's parallel Welford merge.  The two
        operands are put in canonical order first, so merge is exactly
        commutative (Chan's mean update is not symmetric in floats)."""
        if (other.prior, other.strength) != (self.prior, self.strength):
            raise ValueError("cannot merge GaussianPosteriors with "
                             "different priors")
        a, b = self.welford, other.welford
        if tuple(b) < tuple(a):
            a, b = b, a
        return GaussianPosterior(self.prior, self.strength,
                                 tuple(welford_merge(a, b)))

    def state(self) -> dict:
        """JSON-able snapshot; `from_state` round-trips it exactly."""
        return {"prior": self.prior, "strength": self.strength,
                "welford": list(self.welford)}

    @classmethod
    def from_state(cls, state: dict) -> "GaussianPosterior":
        """Rebuild from a `state()` snapshot."""
        return cls(state["prior"], state["strength"],
                   tuple(state["welford"]))


class OnlineEstimators:
    """Per-(invocation depth, model) streaming posteriors for stage
    accuracy, cost, and latency.

    The container the serving loop feeds realized executions into
    (`observe`) and the `TrieAnnotator` reads tables out of.  Seed it
    from an offline cascade profile (`from_profile`) so the posteriors
    start at the profiler's estimates with evidence-proportional
    strength, or from explicit prior tables (`from_tables`).
    """

    def __init__(self, acc, cost, lat):
        self.acc = acc      # (D, M) nested lists of BetaPosterior
        self.cost = cost    # (D, M) nested lists of GaussianPosterior
        self.lat = lat      # (D, M) nested lists of GaussianPosterior
        # per-token latency posteriors (token work model, ISSUE 10):
        # created lazily on the first `observe(..., tokens=)` so legacy
        # scalar-work runs carry no extra state and their snapshots /
        # merges stay bitwise identical
        self.lat_tok = None  # (D, M) nested lists of GaussianPosterior
        self.observations = 0

    def _ensure_lat_tok(self) -> None:
        if self.lat_tok is None:
            D, M = self.shape
            self.lat_tok = [[GaussianPosterior(0.0, 1.0)
                             for _ in range(M)] for _ in range(D)]

    @property
    def shape(self) -> tuple[int, int]:
        """(max invocation depth, model count) of the posterior tables."""
        return (len(self.acc), len(self.acc[0]) if self.acc else 0)

    @classmethod
    def from_tables(cls, acc_prior: np.ndarray, cost_prior: np.ndarray,
                    lat_prior: np.ndarray, *,
                    strength=4.0) -> "OnlineEstimators":
        """Build from explicit (D, M) prior-mean tables.  ``strength``
        is scalar or a (D, M) per-cell pseudo-observation count."""
        acc_prior = np.asarray(acc_prior, dtype=np.float64)
        D, M = acc_prior.shape
        s = np.broadcast_to(np.asarray(strength, dtype=np.float64), (D, M))
        acc = [[BetaPosterior(float(acc_prior[d, m]), float(s[d, m]))
                for m in range(M)] for d in range(D)]
        cost = [[GaussianPosterior(float(cost_prior[d, m]), float(s[d, m]))
                 for m in range(M)] for d in range(D)]
        lat = [[GaussianPosterior(float(lat_prior[d, m]), float(s[d, m]))
                for m in range(M)] for d in range(D)]
        return cls(acc, cost, lat)

    @classmethod
    def from_profile(cls, trie: Trie, profile: ProfileResult, *,
                     prior_strength: float = 4.0,
                     count_weight: float = 1.0) -> "OnlineEstimators":
        """Seed the posteriors from an offline cascade profile: accuracy
        priors are the profile's per-(depth, model) conditional success
        stats (`ProfileResult.stage_success_stats`), cost/latency priors
        the filled stage means, each backed by ``prior_strength`` plus
        ``count_weight`` times the profile's actual per-cell observation
        count.  Lower ``count_weight`` (0 = flat ``prior_strength``
        everywhere) to keep a heavily-profiled prior from drowning out
        online evidence — the responsiveness knob drift-tracking
        deployments (`benchmarks/drift.py`) turn down."""
        smean, scnt = profile.stage_success_stats(trie)
        cmean, lmean = _stage_means_filled(trie, profile)
        cnt = profile.stage_count.astype(np.float64)
        acc = cls.from_tables(smean, cmean, lmean,
                              strength=prior_strength + count_weight * scnt)
        # cost/lat strength follows the telemetry count, not the outcome
        # observation count (checkpoint reuse makes them differ)
        strength = prior_strength + count_weight * cnt
        D, M = smean.shape
        for d in range(D):
            for m in range(M):
                acc.cost[d][m].strength = float(strength[d, m])
                acc.lat[d][m].strength = float(strength[d, m])
        return acc

    def observe(self, depth: int, model: int, success: bool,
                cost: float, lat: float, tokens: float | None = None) -> None:
        """Fold one realized stage execution into all three posteriors.

        ``tokens`` (token work model) additionally folds ``lat /
        tokens`` — seconds of unloaded service per token — into the
        per-token latency posterior, so drift refresh under
        ``work_model="tokens"`` distinguishes throughput drift (the
        engine got slower per token) from stage-size drift (stages got
        longer).  The stage-latency posterior is fed either way, so the
        `lat_table` the annotator publishes is unaffected."""
        self.acc[depth][model].observe(bool(success))
        self.cost[depth][model].observe(float(cost))
        self.lat[depth][model].observe(float(lat))
        if tokens is not None and tokens > 0.0:
            self._ensure_lat_tok()
            self.lat_tok[depth][model].observe(float(lat) / float(tokens))
        self.observations += 1

    def decay_all(self, gamma: float) -> None:
        """Apply exponential forgetting to every posterior cell."""
        tables = (self.acc, self.cost, self.lat) if self.lat_tok is None \
            else (self.acc, self.cost, self.lat, self.lat_tok)
        for table in tables:
            for row in table:
                for p in row:
                    p.decay(gamma)

    def merge(self, other: "OnlineEstimators") -> "OnlineEstimators":
        """Cell-wise posterior merge (e.g. shard-local evidence streams);
        commutative exactly, like the underlying posterior merges."""
        if self.shape != other.shape:
            raise ValueError(f"shape mismatch: {self.shape} vs "
                             f"{other.shape}")
        D, M = self.shape
        out = OnlineEstimators(
            [[self.acc[d][m].merge(other.acc[d][m]) for m in range(M)]
             for d in range(D)],
            [[self.cost[d][m].merge(other.cost[d][m]) for m in range(M)]
             for d in range(D)],
            [[self.lat[d][m].merge(other.lat[d][m]) for m in range(M)]
             for d in range(D)])
        if self.lat_tok is not None or other.lat_tok is not None:
            a, b = self, other
            if a.lat_tok is None or b.lat_tok is None:
                src = a.lat_tok if a.lat_tok is not None else b.lat_tok
                out.lat_tok = [[dataclasses.replace(p) for p in row]
                               for row in src]
            else:
                out.lat_tok = [[a.lat_tok[d][m].merge(b.lat_tok[d][m])
                                for m in range(M)] for d in range(D)]
        out.observations = self.observations + other.observations
        return out

    def q_table(self) -> np.ndarray:
        """(D, M) posterior conditional-accuracy means, clipped to
        [0, 1]."""
        return np.clip([[p.mean() for p in row] for row in self.acc],
                       0.0, 1.0)

    def cost_table(self) -> np.ndarray:
        """(D, M) posterior stage-cost means, floored at 0."""
        return np.maximum([[p.mean() for p in row] for row in self.cost],
                          0.0)

    def lat_table(self) -> np.ndarray:
        """(D, M) posterior stage-latency means, floored at 0."""
        return np.maximum([[p.mean() for p in row] for row in self.lat],
                          0.0)

    def lat_per_token_table(self) -> np.ndarray | None:
        """(D, M) posterior seconds-per-token means, floored at 0 — or
        None when no token-mode observation ever arrived."""
        if self.lat_tok is None:
            return None
        return np.maximum([[p.mean() for p in row] for row in self.lat_tok],
                          0.0)

    def state(self) -> dict:
        """JSON-able snapshot of every posterior cell; `from_state`
        round-trips it exactly.  The per-token table appears only when
        token-mode observations exist, so legacy snapshots are
        byte-identical to pre-token versions."""
        out = {
            "observations": self.observations,
            "acc": [[p.state() for p in row] for row in self.acc],
            "cost": [[p.state() for p in row] for row in self.cost],
            "lat": [[p.state() for p in row] for row in self.lat],
        }
        if self.lat_tok is not None:
            out["lat_tok"] = [[p.state() for p in row]
                              for row in self.lat_tok]
        return out

    @classmethod
    def from_state(cls, state: dict) -> "OnlineEstimators":
        """Rebuild from a `state()` snapshot."""
        out = cls(
            [[BetaPosterior.from_state(s) for s in row]
             for row in state["acc"]],
            [[GaussianPosterior.from_state(s) for s in row]
             for row in state["cost"]],
            [[GaussianPosterior.from_state(s) for s in row]
             for row in state["lat"]])
        if "lat_tok" in state:
            out.lat_tok = [[GaussianPosterior.from_state(s) for s in row]
                           for row in state["lat_tok"]]
        out.observations = state["observations"]
        return out


class TrieAnnotator:
    """Re-derives the trie annotation tables from the current posteriors
    and publishes them as **versioned** device tables.

    `annotations` composes the posterior conditional accuracies down the
    trie (eq. (7)-(9), same recursion as `annotate`) and rebuilds the
    cost/latency path sums from the posterior stage means.  `publish`
    wraps the result in a fresh `controller_torch.TrieDevice` with a
    bumped ``version`` and *supersedes* the previous one: the old device
    is marked superseded (`TrieDevice.supersede`; torch has no buffer
    donation, so its columns stay allocated), and any stale reader fails
    loudly through `TrieDevice.check_live` instead of silently planning
    on old annotations.  Every published device has identical array
    shapes/dtypes, so swapping it into a resident planner copies its
    columns and binds nothing new (`controller_torch.planner_builds`).
    """

    def __init__(self, trie: Trie, estimators: OnlineEstimators,
                 restrict_nodes: np.ndarray | None = None, *,
                 device="cuda"):
        if estimators.shape != (trie.template.max_depth,
                                trie.template.n_models):
            raise ValueError(
                f"estimator table shape {estimators.shape} does not match "
                f"the trie's (max_depth, n_models) = "
                f"({trie.template.max_depth}, {trie.template.n_models})")
        self.trie = trie
        self.estimators = estimators
        self.restrict_nodes = restrict_nodes
        self.device = device
        self.version = 0
        self.current = None
        self.current_ann = None

    def annotations(self) -> TrieAnnotations:
        """Current posterior-derived trie annotations (same §3.3 path
        recursion as `annotate`, with posterior stage means)."""
        trie = self.trie
        q = self.estimators.q_table()
        cmean = self.estimators.cost_table()
        lmean = self.estimators.lat_table()
        n = trie.n_nodes
        q_hat = np.zeros(n)
        for u in range(1, n):
            q_hat[u] = q[int(trie.depth[u]) - 1, int(trie.model[u])]
        mu = _compose(trie, q_hat)
        cost = np.zeros(n)
        lat = np.zeros(n)
        tpl = trie.template
        for u in range(1, n):
            p = int(trie.parent[u])
            d = int(trie.depth[u]) - 1
            m = int(trie.model[u])
            tc, tl = tpl.tool_cost_latency(d)
            cost[u] = cost[p] + (1.0 - mu[p]) * (cmean[d, m] + tc)
            lat[u] = lat[p] + lmean[d, m] + tl
        return TrieAnnotations(acc=mu, cost=cost, lat=lat)

    def publish(self):
        """Build a new versioned `TrieDevice` from the current posteriors
        and mark the superseded version (`TrieDevice.supersede`).  Returns
        the new device; feed it to `ResidentPlanner.swap_device`.  The
        float64
        annotations the device was built from stay readable as
        ``self.current_ann`` (host-side consumers like the downgrade
        re-router need them alongside the float32 device columns)."""
        from repro_torch.core.controller_torch import TrieDevice

        ann = self.annotations()
        td = TrieDevice.build(self.trie, ann, self.restrict_nodes,
                              device=self.device)
        self.version += 1
        td.version = self.version
        if self.current is not None:
            self.current.supersede(self.version)
        self.current = td
        self.current_ann = ann
        return td


@dataclasses.dataclass
class RefreshConfig:
    """How the event loop drives the online estimator refresh:
    ``estimators`` accumulate realized executions, and every
    ``interval`` virtual seconds the loop decays them by ``decay`` and
    publishes a re-annotated `TrieDevice` (provided at least
    ``min_observations`` new executions arrived since the last
    publish)."""

    estimators: OnlineEstimators
    interval: float = 4.0
    decay: float = 1.0
    min_observations: int = 1
