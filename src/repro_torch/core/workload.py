"""Calibrated synthetic workload generator.

The paper profiles real LLM endpoints (Bedrock/SGLang).  Offline, we
reproduce the *statistical structure* its estimators rely on (§3.5, §A):

- per-request latent difficulty ``z_q`` and per-model power scores, combined
  multiplicatively so the depth-d conditional-accuracy matrix
  ``Q[prefix, m] = q(m | prefix fails)`` is approximately **rank-1** (§A.4),
  plus a controlled non-rank-1 perturbation so smoothing helps but is not
  trivially exact;
- success indicators ``S[q, d, m]`` drawn once per (request, invocation
  position, model): path success is *prefix-closed by construction* —
  A(q, p) = 1 iff any stage on p succeeds — which is exactly the paper's
  path semantics (§4.2 "subtree fill-in");
- log-normal output-token counts driving per-stage dollar cost
  (price/1k-tok) and latency (base + per-token), the paper's §4.4 telemetry
  model;
- monotone annotations: cost discounted by early termination, latency
  conditional and undiscounted (§3.3).

Everything is deterministic given ``seed``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.trie import Trie, TrieAnnotations
from repro_torch.core.workflow import WorkflowTemplate


@dataclasses.dataclass
class Workload:
    """Ground-truth stage-level tables for one workflow template.

    S      (n_q, D, M) uint8   success of model m at invocation position d
    cost   (n_q, D, M) float   realized $ cost of that stage invocation
    lat    (n_q, D, M) float   realized seconds of that stage invocation
    """

    template: WorkflowTemplate
    S: np.ndarray
    cost: np.ndarray
    lat: np.ndarray
    difficulty: np.ndarray  # (n_q,) latent difficulty (diagnostics only)
    # per-request SLO-class indices (None unless generated with class_mix=);
    # indices into whatever SLOClass table the serving layer is given
    classes: np.ndarray | None = None
    # (n_q, D, M) realized output-token counts behind `cost`/`lat` — the
    # decode-token source for the token-level engine calendar (ISSUE 10).
    # Optional so hand-built workloads (tests) stay valid; generate_workload
    # always fills it.
    tokens: np.ndarray | None = None

    def stage_tokens_fn(self, prompt_tokens: float = 256.0):
        """(request, depth, model) -> (prefill, decode) token counts for a
        `TokenWorkModel` — decode tokens come from the realized table, the
        prompt is a fixed prefill footprint (the generator does not model
        per-request prompts)."""
        if self.tokens is None:
            raise ValueError("workload has no token table; regenerate with "
                             "generate_workload or set Workload.tokens")
        tok = self.tokens

        def stage_tokens(q: int, depth: int, model: int):
            return float(prompt_tokens), float(tok[q, depth, model])
        return stage_tokens

    @property
    def n_requests(self) -> int:
        """Number of requests in the generated workload."""
        return int(self.S.shape[0])

    # ------------------------------------------------------------------
    # stage-level execution API (what the profiler/runtime is allowed to see)
    # ------------------------------------------------------------------
    def execute_stage(self, q: int, depth: int, model: int):
        """Invoke model ``model`` at invocation position ``depth`` (0-based)
        for request ``q``.  Returns (success, cost, latency) including the
        fixed tool stages that follow the invocation."""
        tc, tl = self.template.tool_cost_latency(depth)
        return (
            bool(self.S[q, depth, model]),
            float(self.cost[q, depth, model] + tc),
            float(self.lat[q, depth, model] + tl),
        )

    # ------------------------------------------------------------------
    # exact ground-truth tables over trie nodes (the oracle view)
    # ------------------------------------------------------------------
    def node_tables(self, trie: Trie):
        """Return (A, C, reached) tables of shape (n_q, n_nodes).

        A[q, u]      1 iff plan u succeeds on q (prefix-closed).
        C[q, u]      realized cost of plan u on q (early-termination aware).
        reached[q,u] 1 iff the *last* stage of u is reached (all ancestors'
                     stages failed); R_k(q, p) in the paper.
        """
        n_q, n = self.n_requests, trie.n_nodes
        A = np.zeros((n_q, n), dtype=np.uint8)
        C = np.zeros((n_q, n), dtype=np.float64)
        reached = np.zeros((n_q, n), dtype=np.uint8)
        failall = np.ones((n_q, n), dtype=np.float64)  # prod of stage failures
        for u in range(1, n):
            p = int(trie.parent[u])
            d = int(trie.depth[u]) - 1
            m = int(trie.model[u])
            tc, _ = self.template.tool_cost_latency(d)
            s = self.S[:, d, m].astype(np.float64)
            reached[:, u] = failall[:, p] > 0.5
            failall[:, u] = failall[:, p] * (1.0 - s)
            C[:, u] = C[:, p] + failall[:, p] * (self.cost[:, d, m] + tc)
            A[:, u] = (1.0 - failall[:, u]) > 0.5
        return A, C, reached

    def exact_annotations(self, trie: Trie) -> TrieAnnotations:
        """Exact Ā, C̄, T̄ per node (paper §3.3 definitions)."""
        A, C, reached = self.node_tables(trie)
        acc = A.mean(axis=0)
        cost = C.mean(axis=0)
        lat = np.zeros(trie.n_nodes, dtype=np.float64)
        for u in range(1, trie.n_nodes):
            p = int(trie.parent[u])
            d = int(trie.depth[u]) - 1
            m = int(trie.model[u])
            _, tl = self.template.tool_cost_latency(d)
            r = reached[:, u].astype(bool)
            # conditional per-stage latency: E[tau | stage reached]
            stage_lat = self.lat[r, d, m].mean() if r.any() else self.lat[:, d, m].mean()
            lat[u] = lat[p] + stage_lat + tl
        return TrieAnnotations(acc=acc, cost=cost, lat=lat)

    def conditional_matrix(self, trie: Trie, depth: int):
        """Exact conditional-accuracy block at ``depth``: rows = depth-1
        prefixes, cols = models; Q[p, m] = Pr[m succeeds | prefix p fails].
        (§A.4's Q matrix; used to verify approximate rank-1 structure.)"""
        prefixes = trie.nodes_at_depth(depth - 1)
        M = trie.n_models
        _, _, reached = self.node_tables(trie)
        Q = np.full((len(prefixes), M), np.nan)
        for i, u in enumerate(prefixes):
            for m in range(M):
                v = int(trie.child[u, m])
                if v < 0:
                    continue
                r = reached[:, v].astype(bool)
                if r.any():
                    Q[i, m] = self.S[r, depth - 1, m].mean()
        return prefixes, Q


# ----------------------------------------------------------------------
# SLO / priority classes (open-arrival serving, `repro.core.events`)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One per-request service class for priority-aware open-arrival serving.

    ``deadline_s`` is the class's latency SLO measured from *arrival*
    (None: fall back to the objective's ``lat_cap``; if that is also None
    the class is deadline-free).  ``weight`` is the class's share in
    weighted processor sharing on a contended engine AND its rank for
    preemption: a queued request may preempt an in-flight request of a
    strictly lower-weight class.  Powers of two keep the single-class
    degenerate case bit-identical to unweighted sharing (the share factor
    ``occupancy * w / sum(w)`` reduces to exactly 1.0).
    """

    name: str
    deadline_s: float | None = None
    weight: float = 1.0

    def __post_init__(self):
        if not self.weight > 0:
            raise ValueError(f"class {self.name!r}: weight must be > 0")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(f"class {self.name!r}: deadline_s must be > 0")


def interactive_batch_classes(
    interactive_deadline_s: float,
    *,
    batch_deadline_s: float | None = None,
    interactive_weight: float = 4.0,
) -> tuple[SLOClass, SLOClass]:
    """The canonical two-class mix: a tight-deadline, high-weight
    ``interactive`` class (index 0) and a deadline-relaxed, weight-1
    ``batch`` class (index 1)."""
    return (
        SLOClass("interactive", deadline_s=interactive_deadline_s,
                 weight=interactive_weight),
        SLOClass("batch", deadline_s=batch_deadline_s, weight=1.0),
    )


def _validated_mix(mix) -> np.ndarray:
    """Normalized class probabilities from a user-supplied mix."""
    p = np.asarray(mix, dtype=np.float64)
    if p.ndim != 1 or p.size == 0:
        raise ValueError(f"mix must be a non-empty 1-d sequence, got {mix!r}")
    if np.any(p < 0) or not p.sum() > 0:
        raise ValueError("mix must be non-negative with a positive sum")
    return p / p.sum()


def sample_classes(n: int, mix, seed: int = 0) -> np.ndarray:
    """(n,) iid class indices drawn from ``mix`` (per-class probabilities,
    normalized; e.g. ``(0.25, 0.75)`` = 25% class 0).  Deterministic given
    ``seed``."""
    if n < 0:
        raise ValueError("n must be >= 0")
    p = _validated_mix(mix)
    return np.random.default_rng(seed).choice(p.size, size=n, p=p)


# ----------------------------------------------------------------------
# arrival processes (open-arrival serving, `repro.core.events`)
# ----------------------------------------------------------------------
def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Arrival times of ``n`` requests from a homogeneous Poisson process
    with ``rate`` requests/second: cumulative sums of iid exponential
    inter-arrival gaps.  Deterministic given ``seed``; strictly increasing
    (exponential draws are almost surely positive)."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if not rate > 0:
        raise ValueError("rate must be > 0 requests/second")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def trace_arrivals(times, n: int | None = None,
                   rate_scale: float = 1.0, seed: int = 0) -> np.ndarray:
    """Trace-replay arrival process: a 1-d sequence of finite, non-negative
    arrival offsets (seconds), sorted ascending (stable) — the form
    `run_events` consumes.

    ``n`` selects the first n arrivals of the (sorted) trace for a cohort
    of n requests.  When ``n`` *exceeds* the trace length, the trace is
    extended past its last arrival by bootstrap-resampling its own
    empirical inter-arrival gaps with a `numpy` generator seeded by
    ``seed`` — the extension replays the trace's arrival-rate statistics
    instead of clamping the cohort (the old behavior) or deterministically
    repeating the tail.  The result always has exactly ``n`` entries and
    is deterministic given ``(times, n, rate_scale, seed)``; extending an
    *empty* trace is a ``ValueError`` (there is no gap distribution to
    resample).

    ``rate_scale`` replays the trace at a scaled arrival rate: timestamps
    are divided by it, so 2.0 compresses the trace to double the offered
    load and 0.5 stretches it to half — the standard knob for overload
    sweeps over a recorded production trace.  Scaling is applied before
    extension, so resampled gaps are drawn from the *scaled* gap
    distribution and the offered load stays consistent across the splice.
    """
    t = np.asarray(times, dtype=np.float64)
    if t.ndim != 1:
        raise ValueError(f"arrival trace must be 1-d, got shape {t.shape}")
    if t.size and (not np.all(np.isfinite(t)) or t.min() < 0):
        raise ValueError("arrival trace must be finite and non-negative")
    if not rate_scale > 0:
        raise ValueError("rate_scale must be > 0")
    t = np.sort(t, kind="stable") / rate_scale
    if n is None:
        return t
    if n < 0:
        raise ValueError("n must be >= 0")
    if n > t.size:
        if t.size == 0:
            raise ValueError(f"cannot draw {n} arrivals from an empty "
                             "trace: no inter-arrival distribution to "
                             "resample")
        # bootstrap the empirical gaps (including the initial offset from
        # the virtual-clock origin, so 1-entry traces still extend)
        gaps = np.diff(t, prepend=0.0)
        rng = np.random.default_rng(seed)
        extra = rng.choice(gaps, size=n - t.size, replace=True)
        t = np.concatenate([t, t[-1] + np.cumsum(extra)])
    return t[:n]


def sinusoidal_arrivals(n: int, mean_rate: float, *, amplitude: float = 0.8,
                        period_s: float = 60.0, seed: int = 0) -> np.ndarray:
    """Arrival times of ``n`` requests from a non-stationary (diurnal)
    Poisson process with sinusoidal intensity

        rate(t) = mean_rate * (1 + amplitude * sin(2*pi*t / period_s)),

    sampled exactly by Lewis-Shedler thinning against the peak rate
    ``mean_rate * (1 + amplitude)``.  ``amplitude`` in [0, 1) keeps the
    intensity strictly positive; ``period_s`` is the diurnal cycle on the
    virtual clock.  Deterministic given ``seed``; strictly increasing."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if not mean_rate > 0:
        raise ValueError("mean_rate must be > 0 requests/second")
    if not 0.0 <= amplitude < 1.0:
        raise ValueError("amplitude must be in [0, 1)")
    if not period_s > 0:
        raise ValueError("period_s must be > 0 seconds")
    rng = np.random.default_rng(seed)
    peak = mean_rate * (1.0 + amplitude)
    out = np.empty(n, dtype=np.float64)
    t, k = 0.0, 0
    while k < n:
        t += rng.exponential(1.0 / peak)
        rate_t = mean_rate * (1.0 + amplitude * np.sin(2.0 * np.pi * t
                                                       / period_s))
        if rng.random() * peak < rate_t:
            out[k] = t
            k += 1
    return out


# ----------------------------------------------------------------------
# generator
# ----------------------------------------------------------------------
def generate_workload(
    template: WorkflowTemplate,
    n_requests: int,
    seed: int = 0,
    *,
    interaction: float = 0.06,
    depth_decay: float = 0.92,
    class_mix=None,
) -> Workload:
    """Draw a ground-truth workload for ``template``.

    success prob:  pi(q, d, m) = clip(power_m * decay^d * (1 - z_q) + eps_qm)
    where eps_qm is a small request-model interaction (breaks exact rank-1).
    cost/latency:  lognormal output tokens -> price & token-latency models.

    ``class_mix`` optionally attaches per-request SLO-class indices
    (``Workload.classes``) drawn iid from the given probabilities — the
    request-level counterpart of an `SLOClass` table handed to the
    priority-aware open-arrival runtime.  Drawn *after* every other table,
    so S/cost/lat are bit-identical with and without a mix.
    """
    rng = np.random.default_rng(seed)
    D, M = template.max_depth, template.n_models
    z = rng.beta(1.8, 2.6, size=n_requests)  # difficulty in (0,1)
    power = np.array([m.power for m in template.models])
    price = np.array([m.price for m in template.models])
    base_lat = np.array([m.base_latency for m in template.models])
    tok_lat = np.array([m.per_token_latency for m in template.models])

    # request-model interaction, zero-mean, breaks exact rank-1 structure
    eps = interaction * rng.standard_normal((n_requests, M))
    decay = depth_decay ** np.arange(D)
    # pi: (n_q, D, M)
    pi = (
        power[None, None, :]
        * decay[None, :, None]
        * (1.0 - z[:, None, None])
        + eps[:, None, :]
    )
    pi = np.clip(pi, 0.005, 0.97)
    S = (rng.random((n_requests, D, M)) < pi).astype(np.uint8)

    # output tokens: lognormal, mildly model- and difficulty-dependent
    mu_tok = np.log(260.0) + 0.35 * z[:, None, None] + 0.1 * (1 - power)[None, None, :]
    tokens = rng.lognormal(mean=mu_tok, sigma=0.45, size=(n_requests, D, M))
    cost = price[None, None, :] * tokens / 1000.0
    lat = (
        base_lat[None, None, :]
        + tok_lat[None, None, :] * tokens
        + rng.gamma(2.0, 0.05, size=(n_requests, D, M))
    )
    classes = None
    if class_mix is not None:
        try:
            p = _validated_mix(class_mix)
        except ValueError as e:
            raise ValueError(f"class_mix: {e}") from None
        classes = rng.choice(p.size, size=n_requests, p=p)
    return Workload(
        template=template,
        S=S,
        cost=cost,
        lat=lat.astype(np.float64),
        difficulty=z,
        classes=classes,
        tokens=tokens,
    )
