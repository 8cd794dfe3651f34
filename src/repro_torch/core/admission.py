"""Deadline-aware admission control and load shedding (beyond-paper).

Under open arrivals the event-driven runtime (`repro.core.events`) admits
every request FIFO: queue wait silently burns each request's latency budget
until the planner finds no feasible path and the work already spent on it is
wasted — while the doomed request's in-service stage keeps inflating every
peer's processor-sharing slowdown.  Serving-side decisions (admit, shed,
downgrade) must be co-designed with the per-stage router (cf. Aragog's
just-in-time routing and the workflow-aware serving layer in PAPERS.md);
this module supplies them as pluggable *policies* consulted by `run_events`
at each arrival and each stage-completion event:

- **reject on arrival**: a request whose remaining budget cannot cover any
  feasible path — per the *batched planner's own feasibility output* under
  the live per-engine delays — is turned away before it occupies an engine;
- **mid-flight shed**: a request whose realized prefix has become
  infeasible (planner returns no continuation after >=1 executed stage), or
  whose deadline passes while a stage is still in service, is aborted and
  its engine share released immediately (`EngineSim.cancel`);
- **cost-aware shedding / downgrade**: under engine overload, in-service
  requests are ranked by a goodput-per-token score (attainable success
  probability per dollar of remaining spend) and the worst are downgraded
  to the cheapest feasible path — or shed outright — until occupancy drops
  back under the target;
- **predictive gating**: queued requests are charged their *forecast*
  remaining queue wait (projected completion times from the engine
  calendar's remaining-work columns) against their deadline, so work that
  is expected to die before a slot frees never enters service — fixing
  the NL2SQL-8 mid-load anomaly where realized-burn shedding handed
  always-admit's self-regulating congestion back to the planner as
  optimism.

Every decision is host-side numpy or reuses the SAME capacity-shaped jitted
fleet-step program (free planner lanes double as admission probes), so
admission control adds ZERO compiled specializations — the no-retrace
invariant `controller_jax.fleet_planner_cache_size` guards extends to the
admission path (asserted by `benchmarks/admission.py`).

Policies are selected by name via ``run_cohort(admission=...)`` /
``run_events(admission=...)``: ``"always"`` (the PR-2 FIFO behavior,
result-identical to passing nothing), ``"feasibility"``
(`FeasibilityGate`), ``"predictive"`` (`PredictiveGate`), ``"cost_aware"``
(`CostAwareShed`), or any `AdmissionPolicy` instance.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.controller import Objective, select_path
from repro_torch.core.trie import Trie, TrieAnnotations

#: per-request terminal outcomes reported via ``ExecutionResult.outcome``
SERVED = "served"      # ran to success / exhausted depth / planner stop
REJECTED = "rejected"  # turned away before any stage executed
SHED = "shed"          # aborted mid-flight (>=1 stage executed or in service)
FAILED = "failed"      # killed by the fault model (retries exhausted, or a
#                        fault-touched request whose budget then died)

#: the closed set of ``ExecutionResult.outcome`` values — every runtime
#: emits members of this tuple and `repro.core.runtime.summarize` keys its
#: disposition rates off it (tests assert membership)
OUTCOMES = (SERVED, REJECTED, SHED, FAILED)


def _subtree_reductions(trie: Trie, ann: TrieAnnotations,
                        terminal_mask: np.ndarray):
    """(best_acc, min_cost) over the *terminal* descendants of every node.

    One reverse-preorder sweep: children fold into parents, so
    ``best_acc[u]`` is the highest attainable plan accuracy and
    ``min_cost[u]`` the cheapest attainable absolute plan cost anywhere in
    u's remaining subtrie (-inf / +inf where no terminal is reachable)."""
    best_acc = np.where(terminal_mask, ann.acc, -np.inf)
    min_cost = np.where(terminal_mask, ann.cost, np.inf)
    for v in range(trie.n_nodes - 1, 0, -1):
        p = int(trie.parent[v])
        if best_acc[v] > best_acc[p]:
            best_acc[p] = best_acc[v]
        if min_cost[v] < min_cost[p]:
            min_cost[p] = min_cost[v]
    return best_acc, min_cost


class AdmissionPolicy:
    """Base policy: always admit — bit-identical to the PR-2 FIFO runtime.

    Subclasses override the hooks below; `run_events` consults them at
    well-defined points of each virtual-clock event (all times are seconds
    of virtual time, elapsed budgets are measured from *arrival*):

    ``queue_reject(elapsed, lat_cap=None, wait_forecast=0.0)``
        called for every request still waiting in the admission queue;
        return True to reject it without ever assigning a slot.
        ``lat_cap`` is the request's own deadline budget when it differs
        from the objective's (per-class SLOs; None falls back to
        ``obj.lat_cap``); ``wait_forecast`` is the runtime's forecast of
        this request's remaining queue wait (only populated for policies
        with ``wants_forecast = True``).
    ``classify_infeasible(n_executed_stages)``
        called when the batched planner returns no feasible path for a
        request; returns the outcome label (`SERVED` keeps the PR-2
        accounting, `REJECTED`/`SHED` record an admission decision).
    ``overload_actions(engine, jobs, downgraded)``
        called after dispatch for each engine whose occupancy exceeds
        ``max_occupancy`` (when set); ``jobs`` is one tuple per in-service
        request on that engine — ``(slot, prefix_node, elapsed_cost,
        elapsed_lat)`` with elapsed measured from arrival, so policies can
        triage on spend, remaining subtrie, or burned deadline; returns
        [(slot, "shed"|"downgrade")].

    ``shed_on_deadline`` (class attr): when True and the objective carries a
    latency cap, `run_events` schedules a shed event at each admitted
    request's ``arrival + lat_cap`` and aborts it (releasing its engine
    share) if it is still in flight at that instant.
    """

    name = "always"
    shed_on_deadline = False
    max_occupancy: int | None = None
    # True: `run_events` computes a queue-wait forecast from the engine
    # calendar and passes it to queue_reject (predictive admission)
    wants_forecast = False

    def bind(self, trie: Trie, ann: TrieAnnotations, obj: Objective,
             terminal_mask: np.ndarray) -> None:
        """Precompute per-run lookups; called once per `run_events`."""
        self.obj = obj

    def queue_reject(self, elapsed: float, lat_cap: float | None = None,
                     wait_forecast: float = 0.0) -> bool:
        """Whether to reject a queued request before it claims a slot.

        ``elapsed`` is the budget already burned waiting (seconds since
        arrival), ``lat_cap`` the request's own deadline (None = the
        objective's), ``wait_forecast`` the projected further wait
        (nonzero only for `wants_forecast` policies).  Always-admit
        never rejects."""
        return False

    def forecast_delay_row(self, delay_row: np.ndarray, sim,
                           t: float) -> np.ndarray:
        """Hook for predictive policies to fold an engine-backlog forecast
        into the planner's delta_e row (load-aware serving only; called
        once per replan).  The default is a no-op.

        The backlog read off ``sim`` is calendar-native: scalar work
        under the PS model, batch-1 seconds under the token calendar
        (ISSUE 10) — the drain-time quotient ``backlog / rate`` stays
        correct in both because the sim's job rates are in the same
        unit."""
        return delay_row

    def note_displaced(self, work: float) -> None:
        """Fault-model hook: the event loop reports unloaded work knocked
        off an engine calendar by an outage (positive when checkpointed
        stages are requeued, negative once they redispatch or terminate).
        Displaced work is load the calendar no longer carries but that is
        still owed — predictive gating folds it into the planner anchor
        (`PredictiveGate.note_displaced`); the base policy ignores it."""

    def classify_infeasible(self, n_executed_stages: int) -> str:
        """Outcome label for a request the planner finds infeasible at
        dispatch (no path fits the remaining budget).  The base policy
        serves the realized prefix as-is; gates reclassify it as shed
        (work already spent) or rejected (nothing executed yet)."""
        return SERVED

    def overload_actions(self, engine: str,
                         jobs: list[tuple[int, int, float, float]],
                         downgraded: np.ndarray
                         ) -> list[tuple[int, str]]:
        """Triage decisions after a dispatch pushes ``engine`` past
        ``max_occupancy`` — see the class docstring for the ``jobs``
        tuple layout.  Returns [(slot, "shed"|"downgrade")]; the base
        policy (no occupancy cap) never intervenes."""
        return []

    def observe_service(self, projected_s: float, realized_s: float) -> None:
        """Telemetry hook: the host event loop reports each completed
        stage's (nominal unloaded work, realized wall time) when an
        online estimator refresh is active (``run_events(refresh=...)``).
        Policies fitting a service-time forecast override this
        (`PredictiveGate` feeds its `WaitForecaster`); the base policy
        ignores it."""


class WaitForecaster:
    """Online calibration of the queue-wait projection (ISSUE 8).

    `PredictiveGate`'s queue-side forecast comes from the engine
    calendar's *frozen-rate* projected completions — exact if service
    rates never changed, optimistic the moment an engine slows down
    (drift).  This forecaster fits the realized/projected service-time
    ratio with the same posterior machinery the trie annotators use
    (`repro.core.estimators.GaussianPosterior`, prior 1.0 = the
    frozen-rate assumption) and multiplies the runtime's forecast by the
    posterior-mean ratio.

    With **zero observations the factor is exactly 1.0** (the posterior
    mean is the prior bitwise), so a gate carrying an unfed forecaster
    is bit-identical to the legacy frozen-rate gate.  ``decay`` < 1
    exponentially forgets old ratios so the factor tracks drift.
    """

    def __init__(self, strength: float = 8.0, decay: float = 1.0):
        from repro_torch.core.estimators import GaussianPosterior
        if not 0.0 <= decay <= 1.0:
            raise ValueError(f"decay must be in [0, 1], got {decay}")
        self._post = GaussianPosterior(prior=1.0, strength=float(strength))
        self.decay = float(decay)

    @property
    def observations(self) -> float:
        """Effective (decayed) number of observed service ratios."""
        return float(self._post.welford[0])

    def observe(self, projected_s: float, realized_s: float) -> None:
        """Fold one completed stage's realized/projected ratio in."""
        if projected_s <= 0.0 or not np.isfinite(realized_s):
            return
        if self.decay != 1.0:
            self._post.decay(self.decay)
        self._post.observe(float(realized_s) / float(projected_s))

    def factor(self) -> float:
        """Posterior-mean slowdown ratio (>= 0; exactly 1.0 unfed)."""
        return max(float(self._post.mean()), 0.0)


class FeasibilityGate(AdmissionPolicy):
    """Reject infeasible work at the gate; shed it when the deadline dies.

    - Arrival/queue: a queued request is rejected as soon as its burned
      budget provably rules out every path — ``elapsed > lat_cap -
      min_path_lat + margin`` uses the *unloaded* minimum remaining path
      latency as a conservative lower bound (live delays only add), so the
      host never rejects anything the float32 device planner would accept.
      Requests that survive the bound are probed with the batched planner
      itself at slot-assignment time (free lanes are planned anyway) and
      rejected if it returns no feasible path under the live delays.
    - Mid-flight: planner infeasibility after >=1 executed stage is
      recorded as a shed, and — the part FIFO cannot do — a request whose
      deadline passes *while a stage is in service* is aborted on the spot,
      releasing its processor-sharing share so surviving requests speed up.
    """

    name = "feasibility"
    shed_on_deadline = True

    def __init__(self, margin: float = 1e-4):
        # slack protecting the host float64 bound against the device
        # planner's float32 arithmetic (+1e-6 absolute feasibility slack)
        self.margin = float(margin)

    def bind(self, trie, ann, obj, terminal_mask):
        """Cache the unloaded minimum remaining path latency the
        queue-reject bound subtracts from the deadline."""
        super().bind(trie, ann, obj, terminal_mask)
        if terminal_mask.any():
            self._min_path_lat = float(
                np.min(ann.lat[terminal_mask]) - ann.lat[0])
        else:
            self._min_path_lat = 0.0  # no plans: let the planner say -1

    def _cap(self, lat_cap: float | None) -> float | None:
        cap = lat_cap if lat_cap is not None else self.obj.lat_cap
        if cap is None or not np.isfinite(cap):
            return None  # deadline-free request: nothing to gate on
        return cap

    def queue_reject(self, elapsed: float, lat_cap: float | None = None,
                     wait_forecast: float = 0.0) -> bool:
        """Certainty bound: reject once the burned wait provably rules
        out even the fastest unloaded path (see class docstring)."""
        cap = self._cap(lat_cap)
        if cap is None:
            return False
        return elapsed > cap - self._min_path_lat + self.margin

    def classify_infeasible(self, n_executed_stages: int) -> str:
        """Planner infeasibility is a shed after >=1 executed stage
        (work was wasted) and a rejection before any work started."""
        return SHED if n_executed_stages > 0 else REJECTED


class PredictiveGate(FeasibilityGate):
    """Feasibility gate that gates on *forecast* queue wait, not just
    realized deadline burn.

    `FeasibilityGate.queue_reject` only fires once a request's budget has
    already provably died — by which point the request occupied the queue
    (and, once admitted, an engine) while doomed.  Worse, on workloads
    where always-admit's zombie congestion self-regulates the load-aware
    planner (the NL2SQL-8 mid-load anomaly documented in
    `benchmarks/admission.py`), shedding realized-dead work hands the
    freed headroom back to the planner as *optimism*: delta_e(t) drops,
    the planner picks slower paths, and the gate underperforms FIFO.

    The predictive gate instead forecasts from the SoA calendar's
    remaining-work columns, on two channels:

    - **queue side**: `run_events` projects every in-service job's
      completion time (per-engine backlog / effective service rate,
      `FleetEngineSim.projected_completions`), hands the k-th queued
      request the k-th projected completion as ``wait_forecast``, and the
      gate rejects when

          elapsed + discount * wait_forecast
              > lat_cap - min_path_lat + margin

      — i.e. when the request's budget is *expected* (not yet certain) to
      be dead by the time a slot frees, so doomed work is turned away at
      its arrival event instead of rotting in the queue until the
      realized-burn bound fires;
    - **planner side** (`forecast_delay_row`): each engine's delta_e is
      floored at ``backlog_delay`` x its backlog-drain time, so the
      planner keeps pricing the work actually outstanding instead of the
      post-shed instantaneous occupancy.  This is the channel that fixes
      the anomaly: queue-side rejection alone is outcome-neutral (queued
      work holds no engine share), but an optimism-anchored planner stops
      over-committing the headroom sheds free up.  Near the knee the
      anchor costs a little goodput (it is deliberately pessimistic);
      past ~4x the knee it wins it back several times over
      (`benchmarks/admission.py --workflow nl2sql_8`).

    ``discount`` de-rates the queue-side forecast (rates change as jobs
    finish, so the frozen-rate projection is pessimistic under draining
    load); 1.0 uses it as-is.  ``backlog_delay=0`` disables the planner
    anchor, reducing the policy to queue-side gating only.
    """

    name = "predictive"
    wants_forecast = True

    def __init__(self, margin: float = 1e-4, discount: float = 1.0,
                 backlog_delay: float = 0.5,
                 forecaster: WaitForecaster | None = None):
        super().__init__(margin=margin)
        if not discount >= 0:
            raise ValueError("discount must be >= 0")
        if not backlog_delay >= 0:
            raise ValueError("backlog_delay must be >= 0")
        self.discount = float(discount)
        self.backlog_delay = float(backlog_delay)
        # unloaded work outages knocked off the calendar and not yet
        # redispatched (repro.core.faults): owed load the drain forecast
        # cannot see — folded into forecast_delay_row below
        self._displaced = 0.0
        # optional online calibration of the frozen-rate projection: the
        # runtime's wait forecast is scaled by the posterior-mean
        # realized/projected service ratio (exactly 1.0 until fed, so a
        # fresh forecaster changes nothing bitwise); host loop only —
        # `traced_admission` rejects a gate carrying one
        self.forecaster = forecaster

    def observe_service(self, projected_s: float, realized_s: float) -> None:
        """Feed a completed stage's (nominal, realized) service pair to
        the wait forecaster, when one is attached."""
        if self.forecaster is not None:
            self.forecaster.observe(projected_s, realized_s)

    def queue_reject(self, elapsed: float, lat_cap: float | None = None,
                     wait_forecast: float = 0.0) -> bool:
        """Forecast-gated rejection: the feasibility bound applied to
        burned wait *plus* the discounted projected further wait (see
        class docstring for the forecast's derivation), with the
        projection rescaled by the fitted slowdown ratio when a
        `WaitForecaster` is attached."""
        cap = self._cap(lat_cap)
        if cap is None:
            return False
        if self.forecaster is not None:
            wait_forecast = self.forecaster.factor() * wait_forecast
        return (elapsed + self.discount * wait_forecast
                > cap - self._min_path_lat + self.margin)

    def forecast_delay_row(self, delay_row: np.ndarray, sim,
                           t: float) -> np.ndarray:
        """Fold the engine calendar's backlog-drain forecast into the
        planner's delta_e row (load-aware serving only).

        The occupancy-derived delta_e is *instantaneous*: the moment the
        gate sheds a doomed request, occupancy (and delta_e) drops and
        the planner plans new work against headroom that arrival pressure
        is about to reclaim — the anomaly this policy exists to fix.
        Charging each engine at least its backlog-drain time (remaining
        work / effective service rate, `FleetEngineSim
        .backlog_drain_times`) keeps the planner's delay perception
        anchored to the work actually outstanding rather than to the
        post-shed instant."""
        if self.backlog_delay == 0.0:
            return delay_row
        drain = sim.backlog_drain_times(t)
        row = np.maximum(delay_row, self.backlog_delay * drain)
        if self._displaced > 0.0 and row.size:
            # outage-displaced work is off the calendar but still owed;
            # until it redispatches it presses on the whole fleet — spread
            # it evenly so the planner keeps pricing the failure-inflated
            # load instead of the post-outage instantaneous occupancy
            row = row + self.backlog_delay * self._displaced / row.size
        return row.astype(delay_row.dtype)

    def note_displaced(self, work: float) -> None:
        """Track outage-displaced unloaded work (see base docstring)."""
        self._displaced = max(self._displaced + float(work), 0.0)


class CostAwareShed(FeasibilityGate):
    """Feasibility gate + goodput-per-token triage under engine overload.

    Whenever an engine's occupancy exceeds ``max_occupancy`` after a
    dispatch, in-service requests on it are ranked by

        score = best attainable remaining accuracy
                / (dollars spent + cheapest remaining plan dollars)

    — expected goodput per token paid, with plan cost standing in for
    tokens (cost IS price x tokens in this workload).  The lowest-scoring
    excess requests are *downgraded* first (their remaining stages re-route
    to the cheapest feasible path via the host float64 search — no extra
    device programs) and shed outright only if a previous overload already
    downgraded them or no cheaper path exists.
    """

    name = "cost_aware"

    def __init__(self, max_occupancy: int = 8, margin: float = 1e-4,
                 downgrade: bool = True):
        super().__init__(margin=margin)
        if max_occupancy < 1:
            raise ValueError("max_occupancy must be >= 1")
        self.max_occupancy = int(max_occupancy)
        self.downgrade = bool(downgrade)

    def bind(self, trie, ann, obj, terminal_mask):
        """Precompute per-node best-attainable accuracy and cheapest
        remaining plan cost — the two subtree reductions `score` reads."""
        super().bind(trie, ann, obj, terminal_mask)
        self._best_acc, self._min_cost = _subtree_reductions(
            trie, ann, terminal_mask)

    def score(self, u: int, elapsed_cost: float) -> float:
        """Goodput-per-token triage score of a request re-rooted at u."""
        acc = self._best_acc[u]
        if not np.isfinite(acc):
            return -np.inf  # no reachable plan: shed first
        remaining = max(self._min_cost[u] - float(elapsed_cost), 0.0)
        return float(max(acc, 0.0) / (elapsed_cost + remaining + 1e-9))

    def overload_actions(self, engine, jobs, downgraded):
        """Rank ``engine``'s in-service jobs by goodput-per-token and
        downgrade (first offense) or shed the lowest-scoring excess
        beyond ``max_occupancy``; ties break on slot index."""
        excess = len(jobs) - self.max_occupancy
        if excess <= 0:
            return []
        ranked = sorted(jobs, key=lambda j: (self.score(j[1], j[2]), j[0]))
        out = []
        for slot, u, ecost, elapsed in ranked[:excess]:
            if self.downgrade and not downgraded[slot]:
                out.append((slot, "downgrade"))
            else:
                out.append((slot, "shed"))
        return out


def cheapest_feasible_target(trie: Trie, ann: TrieAnnotations,
                             obj: Objective, u: int, elapsed_lat: float,
                             engine_delays: dict[str, float] | None,
                             terminal_mask: np.ndarray | None = None) -> int:
    """Cheapest plan still feasible from prefix ``u`` (host float64 search).

    The downgrade target: same latency/cost caps as ``obj`` but the
    objective flips to min-cost with a vacuous accuracy floor — "finish as
    cheaply as the budget allows".  Runs entirely on the host, so repeated
    downgrade replans add no device programs."""
    down = Objective("min_cost", acc_floor=-1.0,
                     cost_cap=obj.cost_cap, lat_cap=obj.lat_cap)
    if terminal_mask is None:
        return select_path(trie, ann, down, root=u, elapsed_lat=elapsed_lat,
                           engine_delays=engine_delays)
    saved = trie.terminal
    try:
        trie.terminal = saved & terminal_mask
        return select_path(trie, ann, down, root=u, elapsed_lat=elapsed_lat,
                           engine_delays=engine_delays)
    finally:
        trie.terminal = saved


@dataclasses.dataclass(frozen=True)
class TracedAdmission:
    """Trace-safe image of a bound admission policy: static scalars only.

    The compiled event engine (`repro.core.events_compiled`) specializes
    its jitted step on this object — it is hashable, so it doubles as part
    of the compilation-cache key, and every field is a python scalar the
    traced code can close over.  The four stock policies all reduce to
    this shape; the behavioural hooks map as:

    - ``gates``: queue-side rejection is active (everything but
      "always"); the traced predicate is
      ``elapsed + discount * wait_forecast > cap - min_path_lat + margin``
      with ``discount`` fixed at 0 for non-predictive gates (whose
      `queue_reject` ignores the forecast).
    - ``shed_on_deadline`` / ``wants_forecast`` / ``max_occupancy`` /
      ``downgrade``: same meaning as on `AdmissionPolicy`.
    - ``min_path_lat``: the bound `FeasibilityGate._min_path_lat`
      (unloaded minimum remaining path latency), baked at setup.

    `classify_infeasible` stays host-side semantics: gating policies turn
    a planner-infeasible request into SHED after >=1 executed stage and
    REJECTED otherwise; "always" records SERVED.  The traced dispatch
    encodes exactly that rule from ``gates``.
    """

    name: str
    gates: bool
    shed_on_deadline: bool
    wants_forecast: bool
    margin: float
    discount: float
    backlog_delay: float
    min_path_lat: float
    max_occupancy: int | None
    downgrade: bool


def traced_admission(pol: AdmissionPolicy) -> TracedAdmission:
    """Distill a *bound* stock policy into its `TracedAdmission` image.

    Only the four stock policy classes are supported: a custom
    `AdmissionPolicy` subclass carries arbitrary python in its hooks,
    which cannot be traced — the compiled engine raises
    ``NotImplementedError`` for those (run the host loop instead)."""
    if type(pol) not in (AdmissionPolicy, FeasibilityGate, PredictiveGate,
                         CostAwareShed):
        raise NotImplementedError(
            f"compiled event engine supports only the stock admission "
            f"policies, not {type(pol).__name__}; use the host loop "
            f"(compiled=False) for custom policies")
    if getattr(pol, "forecaster", None) is not None:
        raise NotImplementedError(
            "compiled event engine cannot feed a PredictiveGate's "
            "WaitForecaster (service observations are host-side); use "
            "the host loop (compiled=False) for calibrated gating")
    gates = isinstance(pol, FeasibilityGate)
    return TracedAdmission(
        name=pol.name,
        gates=gates,
        shed_on_deadline=bool(pol.shed_on_deadline),
        wants_forecast=bool(pol.wants_forecast),
        margin=float(getattr(pol, "margin", 0.0)),
        discount=float(getattr(pol, "discount", 0.0))
        if pol.wants_forecast else 0.0,
        backlog_delay=float(getattr(pol, "backlog_delay", 0.0))
        if pol.wants_forecast else 0.0,
        min_path_lat=float(getattr(pol, "_min_path_lat", 0.0)),
        max_occupancy=pol.max_occupancy,
        downgrade=bool(getattr(pol, "downgrade", False)),
    )


_BY_NAME = {
    "always": AdmissionPolicy,
    "feasibility": FeasibilityGate,
    "predictive": PredictiveGate,
    "cost_aware": CostAwareShed,
}


def get_policy(spec) -> AdmissionPolicy:
    """Resolve ``admission=`` the way `run_events` does: None or a name from
    {"always", "feasibility", "predictive", "cost_aware"}, or a policy
    instance."""
    if spec is None:
        return AdmissionPolicy()
    if isinstance(spec, AdmissionPolicy):
        return spec
    if isinstance(spec, str):
        cls = _BY_NAME.get(spec)
        if cls is None:
            raise ValueError(
                f"unknown admission policy {spec!r}: expected one of "
                f"{sorted(_BY_NAME)} or an AdmissionPolicy instance")
        return cls()
    raise TypeError(f"admission must be a policy name, AdmissionPolicy "
                    f"instance, or None — got {type(spec).__name__}")
