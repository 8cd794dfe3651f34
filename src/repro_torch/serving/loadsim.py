"""Queueing/load simulator + utilization-conditioned slowdown model.

Mirrors the paper's §5.4 methodology: they injected N in {0,1,2,4,8,16,32}
higher-priority dummy requests against an SGLang backend, measured target-
request slowdown at each load level, and fit a utilization-conditioned
slowdown curve used to inflate latency estimates during evaluation.

Here the "backend" is a processor-sharing queue: with N active requests on
an engine with concurrency c, service rate per request degrades as
    slowdown(N) = max(1, (N + 1) / c) * (1 + jitter)
`fit_slowdown_curve` replays the same N-sweep on the queue and fits the
curve; `LoadTrace` produces time-varying per-engine background load for the
Fig-10 experiment; `delay_probe` converts live queue depth into the
controller's delta_e(t) terms (§4.3).

The traced calendar mirrors at the end (`traced_engine_rates`,
`traced_token_rates`, `traced_job_rates`, `traced_advance`) are the
compiled event engine's image of `FleetEngineSim`'s drain arithmetic, as
float64 tensor functions on the caller's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EngineLoadModel:
    """Processor-sharing slowdown: service time multiplies by
    max(1, occupancy / concurrency)."""

    name: str
    concurrency: int = 4
    jitter: float = 0.05

    def slowdown(self, n_active: float, rng=None) -> float:
        base = max(1.0, (n_active + 1.0) / self.concurrency)
        if rng is not None:
            # zero-mean measurement noise: abs() here would make every
            # draw >= the noiseless curve and bias `fit_slowdown_curve`
            # means up by jitter * E|z| ~ +4% at the default jitter
            base *= max(1.0 + self.jitter * float(rng.standard_normal()),
                        1e-6)
        return float(base)


def fit_slowdown_curve(model: EngineLoadModel,
                       levels=(0, 1, 2, 4, 8, 16, 32),
                       reps: int = 50, seed: int = 0):
    """Replay the paper's N-dummy-request experiment; fit slowdown ~ a + b*N
    (piecewise-linear beyond the knee).  Returns (levels, means, (a, b))."""
    rng = np.random.default_rng(seed)
    means = []
    for n in levels:
        s = [model.slowdown(n, rng) for _ in range(reps)]
        means.append(float(np.mean(s)))
    lv = np.asarray(levels, dtype=np.float64)
    mu = np.asarray(means)
    # fit on the saturated region (where queueing actually bites)
    sat = lv >= model.concurrency - 1
    if sat.sum() >= 2:
        b, a = np.polyfit(lv[sat], mu[sat], 1)
    else:
        b, a = np.polyfit(lv, mu, 1)
    return lv, mu, (float(a), float(b))


def step_slowdown(at_t: float, factor: float, engine: str | None = None):
    """Piecewise-constant drift schedule for
    `repro.core.runtime.make_workload_executor`: stage latency on
    ``engine`` (every engine when None) multiplies by ``factor`` from
    virtual time ``at_t`` onward.  The canonical engine-slowdown drift
    scenario (`benchmarks/drift.py`, the online-estimator refresh tests)
    — a step the offline annotations cannot see but the latency
    posteriors track."""
    if factor <= 0:
        raise ValueError(f"slowdown factor must be positive, got {factor}")

    def fn(e: str, t_now: float) -> float:
        return factor if t_now >= at_t and (engine is None or e == engine) \
            else 1.0

    return fn


@dataclasses.dataclass
class LoadTrace:
    """Time-varying background load per engine: piecewise-constant number
    of active background requests, regime-switching every ``period_s``."""

    engines: dict[str, EngineLoadModel]
    period_s: float = 20.0
    max_load: int = 24
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sorted: set/dict iteration order is hash-randomized across
        # processes — engine->trace assignment must be reproducible
        self._regimes = {
            e: rng.integers(0, self.max_load + 1, size=512)
            for e in sorted(self.engines)
        }

    def load_at(self, engine: str, t: float) -> int:
        idx = int(t / self.period_s) % 512
        return int(self._regimes[engine][idx])

    def slowdown_at(self, engine: str, t: float, rng=None) -> float:
        return self.engines[engine].slowdown(self.load_at(engine, t), rng)

    def delay_probe(self, mean_service_s: dict[str, float]):
        """Controller-facing probe: delta_e(t) = (slowdown - 1) x mean
        service time of engine e — the expected extra latency a new stage
        invocation on e would experience (paper §4.3)."""

        def probe(t: float) -> dict[str, float]:
            return {
                e: (self.engines[e].slowdown(self.load_at(e, t)) - 1.0)
                * mean_service_s.get(e, 1.0)
                for e in self.engines
            }

        return probe


# ----------------------------------------------------------------------
# token-level engine model (continuous batching + KV-cache pressure)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EngineTokenModel:
    """Continuous-batching decode physics for ONE engine.

    A decode step over a batch of ``b`` sequences emits one token per
    sequence and costs

        step(b) = max(t_weights_s + t_kv_s * b,  t_flop_s * b)

    — the roofline maximum of the memory stream (weights are read once
    per step regardless of batch; each sequence adds its own KV-cache
    read) and the compute stream (FLOPs scale with batch).  Weight reads
    amortize across the batch, so engine throughput ``b / step(b)``
    rises with ``b`` until the KV/compute terms dominate, then saturates
    — the familiar continuous-batching throughput curve.

    ``kv_capacity`` is the KV-cache occupancy cap: at most that many
    sequences hold KV residency concurrently.  With ``n > kv_capacity``
    sequences assigned, the engine runs saturated batches of
    ``kv_capacity`` and the sequences timeshare the saturated
    throughput (`slowdown` folds both effects into one factor).

    Prefill is compute-bound: ``prefill_tok_s`` seconds per prompt
    token, independent of decode batching (chunked-prefill engines
    interleave it; the calendar charges it up front as part of the
    stage's unloaded work).
    """

    name: str
    t_weights_s: float    # weight-stream seconds per decode step
    t_kv_s: float         # per-sequence KV-read seconds per decode step
    t_flop_s: float       # per-sequence compute seconds per decode step
    kv_capacity: float    # max sequences concurrently KV-resident
    prefill_tok_s: float  # seconds per prefill (prompt) token

    def __post_init__(self):
        if self.kv_capacity < 1:
            raise ValueError(
                f"{self.name}: kv_capacity must be >= 1, got "
                f"{self.kv_capacity} — an engine that cannot hold one "
                f"sequence cannot serve")
        if self.decode_step_s(1.0) <= 0.0:
            raise ValueError(
                f"{self.name}: decode step time must be positive")

    @classmethod
    def from_roofline(cls, name: str, arch, *, context_len: int = 2048,
                      kv_budget_bytes: float = 8 << 30,
                      bytes_per_param: float = 2.0,
                      peak_flops: float,
                      hbm_bw: float) -> "EngineTokenModel":
        """Derive the decode-step curve from an `ArchConfig` and the
        chip roofline the caller gives (``peak_flops``, FLOP/s, and
        ``hbm_bw``, bytes/s, both required):
        weight stream = active params x bytes / HBM bandwidth, KV stream
        = 2 x layers x kv_heads x head_dim x bytes per token x context
        length, compute = 2 x active params FLOPs per token, and the KV
        cap = how many ``context_len`` sequences fit the KV budget."""
        p = float(arch.active_param_count())
        kv_per_tok = max(2.0 * arch.n_layers * arch.n_kv_heads
                         * arch.head_dim * bytes_per_param, 1.0)
        cap = float(int(kv_budget_bytes // (kv_per_tok * context_len)))
        return cls(name,
                   t_weights_s=p * bytes_per_param / hbm_bw,
                   t_kv_s=kv_per_tok * context_len / hbm_bw,
                   t_flop_s=2.0 * p / peak_flops,
                   kv_capacity=max(cap, 1.0),
                   prefill_tok_s=2.0 * p / peak_flops)

    def decode_step_s(self, batch: float) -> float:
        """Seconds per decode step over a batch of ``batch`` sequences."""
        return max(self.t_weights_s + self.t_kv_s * batch,
                   self.t_flop_s * batch)

    def decode_tok_s(self, batch: float) -> float:
        """Engine decode throughput (tokens/sec) with ``batch`` sequences
        assigned: rises while weight reads amortize, saturates at the
        KV cap."""
        b = min(max(float(batch), 1.0), float(self.kv_capacity))
        return b / self.decode_step_s(b)

    def slowdown(self, n_active: float) -> float:
        """Per-sequence service slowdown with ``n_active`` OTHER
        sequences on the engine (the `EngineLoadModel.slowdown`
        convention, so the planner's delta_e row and `fit_slowdown_curve`
        work unchanged): batching ``b = min(n, kv_capacity)`` sequences
        stretches the step to ``step(b)/step(1)``, and sequences beyond
        the cap timeshare (factor ``n / b``)."""
        n = float(max(n_active, 0.0)) + 1.0
        b = min(n, float(self.kv_capacity))
        sb = max(self.t_weights_s + self.t_kv_s * b, self.t_flop_s * b)
        s1 = max(self.t_weights_s + self.t_kv_s, self.t_flop_s)
        return float((n / b) * (sb / s1))


@dataclasses.dataclass
class TokenWorkModel:
    """`run_events(..., work_model=)` input: the fleet's token-level
    work model.  Each stage invocation is ``(prefill_tokens,
    decode_tokens)`` (from `stage_tokens`); its *unloaded* work is the
    batch-1 service time

        work = prefill_tokens * prefill_tok_s
             + decode_tokens  * decode_step_s(1)

    and the engine calendar drains it at the token rate — the
    continuous-batching throughput curve divided across resident
    sequences — instead of the abstract processor-sharing rate.
    `delays`/`slowdown` duck-type `FleetLoadModel`, so the planner's
    delta_e(t) row is the same (slowdown - 1) x mean-service product,
    now grounded in tokens/sec.

    ``stage_tokens(request, depth, model) -> (prefill, decode)`` must be
    a pure function of its arguments (same contract as the stage
    executor): the compiled engine tabulates it over the cohort once."""

    engines: dict[str, EngineTokenModel]
    mean_service_s: dict[str, float]
    stage_tokens: object = None

    def work_of(self, engine: str, prefill_tokens: float,
                decode_tokens: float) -> float:
        """Unloaded (batch-1) seconds of service for one stage."""
        m = self.engines[engine]
        s1 = max(m.t_weights_s + m.t_kv_s, m.t_flop_s)
        return float(prefill_tokens) * m.prefill_tok_s \
            + float(decode_tokens) * s1

    def delays(self, inflight: dict[str, float]) -> dict[str, float]:
        """Planner-facing delta_e per engine: the extra latency a NEW
        invocation would see, from the token throughput curve."""
        return {
            e: (m.slowdown(float(inflight.get(e, 0))) - 1.0)
            * self.mean_service_s.get(e, 1.0)
            for e, m in self.engines.items()
        }

    def slowdown(self, engine: str, n_others: int) -> float:
        m = self.engines.get(engine)
        return m.slowdown(float(max(n_others, 0))) if m is not None \
            else 1.0


class EngineSim:
    """Event-granularity processor-sharing simulation of ONE engine.

    The fleet runtime applies a single slowdown factor per lockstep round;
    the event-driven runtime (`repro.core.events`) instead tracks stages as
    *jobs with remaining work* whose service rate changes every time the
    engine's occupancy changes — the paper's §5.4 slowdown curve applied at
    event granularity rather than round granularity.

    Units and contract (shared with the `run_events` virtual clock):

    - every ``t`` is **virtual time in seconds** on the event loop's clock
      (not wall clock — `time.perf_counter` never appears here), and
      ``work`` is seconds of *unloaded* service: the stage latency the
      executor reported, before any load inflation;
    - the caller drives time forward: methods taking ``t`` must be called
      with non-decreasing values (the event loop guarantees this); state
      between two consecutive calls is linear drain at the current rate;
    - jobs are identified by an arbitrary hashable key (`run_events` uses
      the slot index); one key may be in service at most once per engine.

    ``slowdown(n_others) -> factor`` defines the processor-sharing rate:
    with k jobs in service every job drains work at ``1 / slowdown(k - 1)``
    per unit of virtual time.  With ``slowdown=None`` the engine is
    unloaded (unit rate): completion times are stored exactly as
    ``start + work`` and the realized duration returned by `pop_completed`
    is the nominal ``work`` bit-for-bit — the property the open-arrival
    runtime's degenerate-case equivalence with `run_fleet` relies on.
    """

    _DONE_TOL = 1e-9  # remaining-work tolerance (seconds of unloaded service)

    def __init__(self, name: str, slowdown=None):
        self.name = name
        self._slowdown = slowdown
        self._t_last = 0.0
        # unit-rate: job -> (t_complete, work); PS: job -> [remaining, t_start]
        self._jobs: dict = {}

    @property
    def occupancy(self) -> int:
        return len(self._jobs)

    def _rate(self) -> float:
        if self._slowdown is None or not self._jobs:
            return 1.0
        return 1.0 / float(self._slowdown(len(self._jobs) - 1))

    def _advance(self, t: float) -> None:
        """Drain work at the current shared rate up to virtual time ``t``."""
        dt = t - self._t_last
        if dt > 0.0 and self._slowdown is not None and self._jobs:
            r = self._rate()
            for rec in self._jobs.values():
                rec[0] -= dt * r
        self._t_last = max(self._t_last, t)

    def start(self, job, work: float, t: float) -> None:
        """Admit ``job`` with ``work`` seconds of unloaded service at ``t``."""
        if self._slowdown is None:
            self._jobs[job] = (t + work, work)
        else:
            self._advance(t)
            self._jobs[job] = [work, t]

    def remaining_work(self, job, t: float) -> float:
        """Seconds of *unloaded* service ``job`` still needs at time ``t``.

        Since the processor-sharing rate never exceeds 1, ``t +
        remaining_work(job, t)`` is a certain lower bound on the job's
        completion time — the admission layer sheds a request the moment
        this bound crosses its deadline, well before the deadline itself
        when the engine is saturated.  +inf when the job is not in service.
        """
        if job not in self._jobs:
            return float("inf")
        if self._slowdown is None:
            tc, _ = self._jobs[job]
            return max(tc - t, 0.0)
        self._advance(t)
        return max(float(self._jobs[job][0]), 0.0)

    def cancel(self, job, t: float) -> bool:
        """Abort ``job`` at virtual time ``t`` without completing it.

        The admission/load-shedding layer (`repro.core.admission`) calls
        this when a request is shed mid-stage: surviving jobs first drain
        at the pre-cancel shared rate up to ``t``, then the job's share is
        released — from ``t`` onward the engine's occupancy (and therefore
        every survivor's service rate) no longer includes it.  Returns
        False when ``job`` is not in service (already completed/canceled).
        """
        if job not in self._jobs:
            return False
        if self._slowdown is not None:
            self._advance(t)
        del self._jobs[job]
        return True

    def next_completion(self) -> float:
        """Virtual time of the next job completion (+inf when idle)."""
        if not self._jobs:
            return float("inf")
        if self._slowdown is None:
            return min(tc for tc, _ in self._jobs.values())
        rem = min(rec[0] for rec in self._jobs.values())
        return self._t_last + max(rem, 0.0) / self._rate()

    def pop_completed(self, t: float) -> list:
        """Remove jobs finished by ``t``; returns [(job, realized_s), ...]
        in admission order (deterministic)."""
        out = []
        if self._slowdown is None:
            for job, (tc, work) in list(self._jobs.items()):
                if tc <= t:
                    del self._jobs[job]
                    out.append((job, work))
            return out
        self._advance(t)
        for job, (rem, t0) in list(self._jobs.items()):
            if rem <= self._DONE_TOL:
                del self._jobs[job]
                out.append((job, t - t0))
        return out


class FleetEngineSim:
    """Vectorized structure-of-arrays event calendar for a whole engine
    fleet (every engine x every slot), replacing the per-engine dict of
    `EngineSim` objects in the event-driven runtime.

    Jobs are keyed by slot index; state is numpy columns over slots —
    completion-time/nominal-work columns for unit-rate engines,
    remaining-work/start-time columns under processor sharing — so every
    per-event operation (drain, completion scan, deadline bound) is one
    vectorized pass instead of a Python loop over slots and engines.

    Semantics are identical to one `EngineSim` per engine (the equivalence
    and golden suites pin this):

    - all times are virtual seconds, driven monotonically by the caller;
    - ``slowdown(engine_idx, n_others)`` defines the shared service rate;
      with ``slowdown=None`` engines are unit-rate and completion times /
      realized durations are exact (``start + work`` bit-for-bit);
    - the event loop calls `pop_completed` at every event timestamp, so
      the single fleet-wide drain clock advances exactly when each
      per-engine `EngineSim` clock would (same dt sequence, same float64
      arithmetic);
    - completions are reported in (canonical engine order, admission
      order) — the order the per-engine dict loop produced.

    **Weighted processor sharing + preemption** (priority-class serving):
    `start` takes an optional per-job ``weight``; each engine's total
    service rate is split among its jobs as a *work-conserving bounded
    fair share* — proportional to weight, capped at unit rate per job
    (so ``t + remaining(t)`` stays a certain completion lower bound; the
    deadline-shed certainty test relies on it), with capped jobs' excess
    redistributed to the rest (see `_job_rates`).  With every weight
    equal the share factor is exactly 1.0 and the drain arithmetic is
    bit-identical to the unweighted form.
    `preempt` pauses a job mid-stage, returning its remaining *unloaded*
    work so the caller can later resume it via ``start(slot, engine,
    remaining, t)`` — work is conserved: nothing is lost or re-executed.
    """

    _DONE_TOL = 1e-9  # remaining-work tolerance (matches EngineSim)

    def __init__(self, engines: list[str], capacity: int, slowdown=None,
                 token_models: dict[str, EngineTokenModel] | None = None):
        self.engines = list(engines)
        self._slowdown = slowdown
        self._tokens = token_models is not None
        # _ps: remaining-work calendar (shared-rate drains) vs absolute
        # completion times — token engines always drain at a shared rate
        self._ps = self._tokens or slowdown is not None
        if self._tokens:
            if slowdown is not None:
                raise ValueError(
                    "token_models and slowdown are mutually exclusive — "
                    "the token calendar defines its own rate curve")
            E = len(self.engines)
            self._tok_w = np.zeros(E)
            self._tok_kv = np.zeros(E)
            self._tok_f = np.zeros(E)
            self._tok_cap = np.ones(E)
            self._tok_1 = np.ones(E)   # decode_step_s(1), precomputed
            for j, e in enumerate(self.engines):
                m = token_models.get(e)
                if m is None:
                    raise ValueError(
                        f"token_models has no entry for engine {e!r}")
                self._tok_w[j] = m.t_weights_s
                self._tok_kv[j] = m.t_kv_s
                self._tok_f[j] = m.t_flop_s
                self._tok_cap[j] = m.kv_capacity
                self._tok_1[j] = max(m.t_weights_s + m.t_kv_s, m.t_flop_s)
        c = int(capacity)
        self.job_engine = np.full(c, -1, dtype=np.int64)   # -1 = idle slot
        self._seq = np.zeros(c, dtype=np.int64)            # admission order
        self._next_seq = 0
        self._t_complete = np.full(c, np.inf)              # unit-rate
        self._work = np.zeros(c)
        self._remaining = np.full(c, np.inf)               # processor sharing
        self._t_start = np.zeros(c)
        self._t_last = 0.0
        self._weight = np.ones(c)                          # weighted PS share
        self._weighted = False  # any non-unit weight ever seen

    @property
    def n_engines(self) -> int:
        return len(self.engines)

    def occupancies(self) -> np.ndarray:
        """(E,) active-job counts per engine."""
        act = self.job_engine >= 0
        return np.bincount(self.job_engine[act], minlength=self.n_engines)

    def weighted_occupancies(self) -> np.ndarray:
        """(E,) sums of active-job weights per engine — the load-model
        input under priority classes (a weight-4 interactive job presses
        on the engine like four weight-1 jobs).  Equals `occupancies` as
        float when every job has unit weight."""
        act = self.job_engine >= 0
        return np.bincount(self.job_engine[act], weights=self._weight[act],
                           minlength=self.n_engines)

    def _job_rates(self, act: np.ndarray, rates: np.ndarray) -> np.ndarray:
        """Per-job drain rates for the active mask.

        Weighted PS is a *work-conserving bounded fair share*: each
        engine's total service rate (``occupancy x shared rate``) is
        split by weight, every job's rate is capped at 1.0 (a job never
        drains faster than an unloaded engine would serve it, preserving
        the ``t + remaining`` completion lower bound), and a capped job's
        excess is redistributed among the uncapped jobs (water-filling) —
        a heavy job sharing an under-loaded engine must not throttle the
        light jobs below capacity the engine still has."""
        base = rates[self.job_engine[act]]
        if not self._weighted:
            return base
        je = self.job_engine[act]
        w = self._weight[act]
        E = self.n_engines
        occ = np.bincount(je, minlength=E).astype(np.float64)
        remaining = occ * rates          # per-engine rate left to hand out
        r = np.zeros(w.shape)
        fixed = np.zeros(w.shape, dtype=bool)
        while True:                      # each pass caps >= 1 job or ends
            free = ~fixed
            if not free.any():
                break
            sumw = np.bincount(je[free], weights=w[free], minlength=E)
            share = np.zeros(w.shape)
            share[free] = (remaining[je[free]] * w[free]
                           / sumw[je[free]])
            newly = free & (share >= 1.0)
            if not newly.any():
                r[free] = share[free]
                break
            r[newly] = 1.0
            fixed |= newly
            remaining = remaining - np.bincount(je[newly], minlength=E)
        return r

    def _rates(self, occ: np.ndarray) -> np.ndarray:
        """(E,) shared service rate per engine at the given occupancies.

        Token mode computes the rate *directly* as ``(b / occ) *
        (step(1) / step(b))`` — batching stretch plus beyond-KV-cap
        timesharing — rather than via ``1 / slowdown``: the reciprocal
        of a product rounds differently from the product of quotients,
        and `traced_token_rates` mirrors this exact op order so the
        compiled calendar stays bit-compatible.  The rate is always in
        (0, 1] (exactly 1.0 at occupancy <= 1), so ``t + remaining``
        stays a certain completion lower bound under tokens too."""
        rates = np.ones(self.n_engines)
        if self._tokens:
            for e in range(self.n_engines):
                if occ[e] > 0:
                    occ_s = max(float(occ[e]), 1.0)
                    b = min(occ_s, float(self._tok_cap[e]))
                    sb = max(float(self._tok_w[e])
                             + float(self._tok_kv[e]) * b,
                             float(self._tok_f[e]) * b)
                    rates[e] = (b / occ_s) * (float(self._tok_1[e]) / sb)
            return rates
        for e in range(self.n_engines):
            if occ[e] > 0:
                rates[e] = 1.0 / float(self._slowdown(e, int(occ[e]) - 1))
        return rates

    def _advance(self, t: float) -> None:
        """Drain all engines at their current shared rates up to ``t``."""
        dt = t - self._t_last
        act = self.job_engine >= 0
        if dt > 0.0 and self._ps and act.any():
            rates = self._rates(self.occupancies())
            self._remaining[act] -= dt * self._job_rates(act, rates)
        self._t_last = max(self._t_last, t)

    def start(self, slot: int, engine_idx: int, work: float,
              t: float, weight: float = 1.0) -> None:
        """Admit ``slot`` with ``work`` seconds of unloaded service at t.

        ``weight`` is the job's weighted-PS share (priority classes);
        resuming a preempted stage is the same call with ``work`` set to
        the remainder `preempt` returned."""
        if not self._ps:
            self._t_complete[slot] = t + work
            self._work[slot] = work
        else:
            self._advance(t)
            self._remaining[slot] = work
            self._t_start[slot] = t
        self.job_engine[slot] = engine_idx
        self._weight[slot] = weight
        if weight != 1.0:
            self._weighted = True
        self._seq[slot] = self._next_seq
        self._next_seq += 1

    def next_completion(self) -> float:
        """Virtual time of the next completion fleet-wide (+inf if idle)."""
        act = self.job_engine >= 0
        if not act.any():
            return float("inf")
        if not self._ps:
            return float(self._t_complete[act].min())
        occ = self.occupancies()
        rates = self._rates(occ)
        if self._weighted:
            jr = self._job_rates(act, rates)
            rem = np.maximum(self._remaining[act], 0.0)
            return float(self._t_last + (rem / jr).min())
        out = float("inf")
        for e in range(self.n_engines):
            m = act & (self.job_engine == e)
            if m.any():
                rem = max(float(self._remaining[m].min()), 0.0)
                out = min(out, self._t_last + rem / rates[e])
        return out

    def pop_completed(self, t: float) -> list:
        """Remove jobs finished by ``t``; [(slot, realized_s), ...] in
        (canonical engine order, admission order)."""
        if not self._ps:
            done = (self.job_engine >= 0) & (self._t_complete <= t)
        else:
            self._advance(t)
            done = (self.job_engine >= 0) & (self._remaining <= self._DONE_TOL)
        slots = np.nonzero(done)[0]
        order = np.lexsort((self._seq[slots], self.job_engine[slots]))
        out = []
        for slot in slots[order]:
            realized = (self._work[slot] if not self._ps
                        else t - self._t_start[slot])
            out.append((int(slot), float(realized)))
            self._clear(int(slot))
        return out

    def _require_in_service(self, slot: int, op: str) -> None:
        """Double-cancel/preempt guard: an idle slot here means the stage
        already completed, was cancelled, or was preempted — acting on it
        again would silently corrupt a *different* request's calendar row
        once the slot is reused, so it is a caller bookkeeping bug, not a
        no-op."""
        if self.job_engine[slot] < 0:
            raise ValueError(
                f"{op}(slot={slot}): slot is idle — its stage already "
                f"completed, was cancelled, or was preempted; a second "
                f"{op} indicates stale slot bookkeeping in the caller")

    def cancel(self, slot: int, t: float) -> bool:
        """Abort ``slot`` at ``t``: survivors first drain at the pre-cancel
        shared rate, then its engine share is released.  Raises
        ``ValueError`` when the slot is idle (see `_require_in_service`)."""
        self._require_in_service(slot, "cancel")
        if self._ps:
            self._advance(t)
        self._clear(slot)
        return True

    def preempt(self, slot: int, t: float) -> float:
        """Pause ``slot``'s in-service stage at ``t`` and release its
        engine share (survivors first drain at the pre-preemption rates).

        Returns the stage's remaining *unloaded* work — the caller resumes
        the checkpointed stage later with ``start(slot', engine,
        remaining, t')``, so preempted work is conserved exactly: the sum
        of drained and remaining work always equals the work injected.
        Raises ``ValueError`` when the slot is idle (already completed /
        cancelled / paused — see `_require_in_service`)."""
        self._require_in_service(slot, "preempt")
        if not self._ps:
            rem = max(float(self._t_complete[slot]) - t, 0.0)
        else:
            self._advance(t)
            rem = max(float(self._remaining[slot]), 0.0)
        self._clear(slot)
        return rem

    def backlog_drain_times(self, t: float) -> np.ndarray:
        """(E,) expected seconds for each engine to drain its current
        backlog: remaining unloaded work summed per engine over the
        engine's total effective service rate (sum of its jobs' drain
        rates).  Zero for idle engines.  The predictive admission policy
        folds this into the planner's delta_e row so freed headroom after
        a shed is not handed back to the planner as optimism."""
        out = np.zeros(self.n_engines)
        act = self.job_engine >= 0
        if not act.any():
            return out
        if not self._ps:
            rem = np.maximum(self._t_complete - t, 0.0)[act]
            jr = np.ones(rem.shape)
        else:
            self._advance(t)
            rem = np.maximum(self._remaining, 0.0)[act]
            jr = self._job_rates(act, self._rates(self.occupancies()))
        je = self.job_engine[act]
        backlog = np.bincount(je, weights=rem, minlength=self.n_engines)
        rate = np.bincount(je, weights=jr, minlength=self.n_engines)
        busy = rate > 0
        out[busy] = backlog[busy] / rate[busy]
        return out

    def projected_completions(self, t: float) -> np.ndarray:
        """Ascending projected completion times of every in-service job,
        assuming per-engine occupancies and rates stay frozen at their
        current values: the remaining-work column over the effective
        per-job service rate (per-engine backlog / service rate, job by
        job).  This is the *forecast* input of predictive admission —
        unlike `next_completion` it projects every job, and unlike the
        certainty bound it is an expectation, not a lower bound."""
        act = self.job_engine >= 0
        if not act.any():
            return np.zeros(0)
        if not self._ps:
            return np.sort(self._t_complete[act])
        self._advance(t)
        rates = self._rates(self.occupancies())
        jr = self._job_rates(act, rates)
        tc = self._t_last + np.maximum(self._remaining[act], 0.0) / jr
        return np.sort(tc)

    def remaining(self, t: float) -> np.ndarray:
        """(C,) seconds of *unloaded* service each slot still needs at
        ``t`` (+inf for idle slots).  The processor-sharing rate never
        exceeds 1, so ``t + remaining(t)`` lower-bounds every completion —
        the deadline-shed certainty test is one vectorized comparison."""
        act = self.job_engine >= 0
        if not self._ps:
            return np.where(act, np.maximum(self._t_complete - t, 0.0),
                            np.inf)
        self._advance(t)
        return np.where(act, np.maximum(self._remaining, 0.0), np.inf)

    def _clear(self, slot: int) -> None:
        self.job_engine[slot] = -1
        self._t_complete[slot] = np.inf
        self._work[slot] = 0.0
        self._remaining[slot] = np.inf
        self._weight[slot] = 1.0


# ----------------------------------------------------------------------
# traced calendar math (compiled event engine)
# ----------------------------------------------------------------------
# Tensor mirrors of the FleetEngineSim drain arithmetic, for the epoch
# step of `repro_torch.core.events_compiled`.  Each function is the IEEE
# image of the numpy method it mirrors: float64 tensors on the caller's
# device, the same op order, one eager op per rounding (no fused form such
# as addcmul or lerp, no torch.compile), so the compiled engine's virtual
# clock equals the host calendar bit for bit.  torch is imported inside
# each function: this module stays importable numpy-only.


def bucket_add(n: int, idx, vals):
    """(n,) sums of ``vals`` by bucket ``idx`` (ints in [0, n)).  On the
    CPU the adds run in index order, numpy's `bincount` order; on a CUDA
    device a fixed-order reduction over a one-hot table (``index_add_``
    there adds by atomics in no fixed order).  Sums of integer-valued
    floats are exact in any order."""
    import torch

    if vals.device.type == "cpu":
        return torch.zeros(n, dtype=vals.dtype).index_add_(0, idx.long(),
                                                           vals)
    hot = idx.long()[None, :] == torch.arange(n, device=vals.device)[:, None]
    return torch.where(hot, vals[None, :], 0.0).sum(dim=1)


def traced_engine_rates(occ, conc):
    """(E,) shared processor-sharing rate per engine — the image of
    `FleetEngineSim._rates` under the standard `EngineLoadModel` slowdown
    ``max(1, occupancy / concurrency)``; idle engines come out at 1.0
    like the host's (whose loop skips them).  The reciprocal is its own
    rounding, as on the host."""
    import torch

    s = torch.clamp(occ / conc, min=1.0)
    return torch.ones_like(s) / s


def traced_token_rates(occ, tkw, tkv, tkf, tkc, tk1):
    """(E,) shared token-calendar rate per engine — the image of
    `FleetEngineSim._rates` in token mode: ``(b / occ) * (step(1) /
    step(b))`` with effective batch ``b = min(occ, kv_capacity)``.
    ``tk1`` is ``decode_step_s(1)`` computed on the host and passed in;
    idle engines come out at exactly 1.0.  ``tkv * b`` and each quotient
    are separate ops, so each takes its own rounding as on the host."""
    import torch

    occ_s = torch.clamp(occ, min=1.0)
    b = torch.minimum(occ_s, tkc)
    prod = tkv * b
    sb = torch.maximum(tkw + prod, tkf * b)
    q1 = b / occ_s
    q2 = tk1 / sb
    return q1 * q2


def traced_job_rates(job_engine, weight, active, rates, weighted):
    """(C,) per-job drain rates — the image of `FleetEngineSim._job_rates`
    (work-conserving bounded fair share with water-filling).
    ``job_engine``/``weight``/``active`` are the (C,) slot columns,
    ``rates`` the (E,) shared engine rates, ``weighted`` a one-element
    bool tensor mirroring the host's ``_weighted`` latch.  Idle lanes
    return 0.  The water-filling loop runs only when ``weighted`` holds
    (the host returns the plain share otherwise), each pass deciding on
    one host read (`repro_torch.device.host_read`)."""
    import torch

    from repro_torch.device import host_read

    E = rates.shape[0]
    je_safe = torch.clamp(job_engine, 0, E - 1).long()
    je_park = torch.where(active, je_safe, E)  # park idle lanes off-engine
    base = torch.where(active, rates[je_safe], 0.0)
    if not host_read(weighted):
        return base
    occ = bucket_add(E + 1, je_park, torch.where(active, 1.0, 0.0).to(
        base.dtype))[:E]
    remaining = occ * rates
    r = torch.zeros_like(base)
    fixed = torch.zeros_like(active)
    while True:
        free = active & ~fixed
        freef = torch.where(free, 1.0, 0.0).to(base.dtype)
        sumw = bucket_add(E + 1, je_park, weight * freef)[:E]
        sumw_safe = torch.where(sumw > 0.0, sumw, 1.0)
        share = torch.where(free,
                            remaining[je_safe] * weight / sumw_safe[je_safe],
                            0.0)
        newly = free & (share >= 1.0)
        any_free = free.any()
        any_new = newly.any()
        r = torch.where(newly, 1.0, r)
        r = torch.where(any_free & ~any_new & free, share, r)
        fixed = fixed | newly
        remaining = remaining - bucket_add(
            E + 1, je_park, torch.where(newly, 1.0, 0.0).to(base.dtype))[:E]
        if host_read(~any_free | ~any_new):
            return r


def traced_advance(remaining, t_last, t, job_engine, weight, active,
                   conc, weighted, tok=None):
    """Drain the (C,) remaining-work column to virtual time ``t`` — the
    image of `FleetEngineSim._advance` for processor-sharing engines.
    Returns ``(remaining, t_last)``; same guard as the host (positive dt
    and at least one active job), same single ``remaining -= dt *
    job_rate`` update (``dt * jr`` and the subtraction are two ops, two
    roundings; the max with 0 is the identity under the guard, and idle
    lanes subtract an exact 0.0).

    ``tok`` switches the engine rate curve to the token calendar: a
    ``(tkw, tkv, tkf, tkc, tk1)`` tuple of (E,) decode-step coefficient
    tensors (see `traced_token_rates`); ``conc`` is then only a shape
    source."""
    import torch

    E = conc.shape[0]
    dt = t - t_last
    park = torch.where(active, torch.clamp(job_engine, 0, E - 1).long(), E)
    occ = bucket_add(E + 1, park,
                     torch.where(active, 1.0, 0.0).to(remaining.dtype))[:E]
    rates = (traced_token_rates(occ, *tok) if tok is not None
             else traced_engine_rates(occ, conc))
    jr = traced_job_rates(job_engine, weight, active, rates, weighted)
    do = (dt > 0.0) & active.any()
    drained = torch.where(do & active, torch.clamp(dt * jr, min=0.0), 0.0)
    return remaining - drained, torch.maximum(t_last, t)


@dataclasses.dataclass
class FleetLoadModel:
    """Self-induced load coupling for the fleet runtime.

    `LoadTrace` models *background* traffic on each engine; this models the
    cohort's own footprint: the fleet aggregates per-round in-flight counts
    per engine and (a) feeds them back into the next round's planner delays
    — so every request plans against the congestion its peers are about to
    create — and (b) inflates realized stage latency by the processor-
    sharing slowdown under this round's occupancy.  A sequential
    per-request loop cannot express either effect: it serves one request at
    a time, so engines never see concurrent cohort traffic.
    """

    engines: dict[str, EngineLoadModel]
    mean_service_s: dict[str, float]

    def delays(self, inflight: dict[str, int]) -> dict[str, float]:
        """Planner-facing delta_e per engine given in-flight counts: the
        extra latency a NEW invocation would see on top of the annotation's
        unloaded estimate (paper §4.3's delta_e(t), sourced from the fleet
        itself instead of a background trace)."""
        return {
            e: (m.slowdown(float(inflight.get(e, 0))) - 1.0)
            * self.mean_service_s.get(e, 1.0)
            for e, m in self.engines.items()
        }

    def slowdown(self, engine: str, n_others: int) -> float:
        """Realized multiplicative slowdown for a stage sharing its engine
        with ``n_others`` concurrent cohort requests this round."""
        m = self.engines.get(engine)
        return m.slowdown(float(max(n_others, 0))) if m is not None else 1.0
