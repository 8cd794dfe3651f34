"""Event-driven open-arrival fleet runtime (beyond-paper).

`run_fleet` serves a *closed* cohort: every request exists at round 0 and
the whole batch replans in lockstep rounds.  The paper's actual serving
setting (§4.3) is open: requests arrive continuously, and VineLM re-roots
each one's trie against the load its in-flight peers impose at that moment.
`run_events` models exactly that with a virtual-clock event loop:

- three event kinds — request **arrival**, **stage completion**, and (under
  a shedding admission policy) **deadline shed** — drive the clock; nothing
  happens between events, so the loop is O(events), not O(time);
- per-request control state lives in **fixed-capacity slot arrays**, and
  the planner keeps a host mirror of that state
  (`controller_torch.make_resident_planner`): the lanes an event touched
  are written into it, and each batched replan is one round of the
  trie-replan kernel over all capacity lanes (one copy in, one launch,
  one copy out).  The planner batch is always the capacity, so its bound
  launch is **never rebuilt** as the number of in-flight requests
  fluctuates (its layouts are bound once, when the planner is made —
  `controller_torch.planner_builds` exposes the counter the tests assert
  on);
- arrivals that find every slot busy wait in a FIFO **admission queue**;
  requests admitted mid-flight join the next batched replan alongside the
  requests already in service; free slots, replan lanes and deadline
  events are all boolean-mask/array bookkeeping — no per-event O(C)
  Python scans;
- per-engine occupancy is computed from **overlapping wall-clock stage
  intervals** (a vectorized processor-sharing calendar across all engines,
  `repro.serving.loadsim.FleetEngineSim`), not lockstep rounds: a stage's
  service rate changes every time its engine's occupancy changes, and the
  planner's delta_e(t) delay terms come from the occupancy at the instant
  of each replan;
- elapsed latency — both the planner's remaining-deadline input and the
  reported `total_lat` — is measured **from each request's arrival time**,
  so queueing delay counts against the SLO exactly as it would in a real
  deployment;
- an **admission-control / load-shedding policy** (`repro.core.admission`,
  selected via ``admission=``) is consulted at each arrival and each
  stage-completion event: it can reject requests whose remaining budget
  admits no feasible path (per the batched planner's own feasibility
  output under the live delays), drop hopeless requests from the queue
  (under ``"predictive"`` gating on *forecast* queue wait projected from
  the engine calendar, not just realized deadline burn), abort in-service
  stages at the deadline (`FleetEngineSim.cancel` releases the engine
  share so survivors speed up), and under overload downgrade or shed
  in-flight requests by a goodput-per-token score.  The default
  (``admission=None`` == ``"always"``) keeps the pure FIFO behavior;
- requests optionally carry a per-request **SLO class** (``class_specs=``
  a table of `repro.core.workload.SLOClass`, ``classes=`` per-request
  indices): the admission queue becomes a (class weight, arrival) priority
  queue, contended engines serve jobs by **weighted processor sharing**,
  each class's deadline replaces the objective's ``lat_cap`` for that
  request (fed to the device planner through per-lane elapsed-latency
  shifts against the single largest-cap scalar — zero new compiled
  programs), and with ``preempt=True`` a queued higher-class request may
  **preempt** the lowest-value in-flight stage: the victim is paused with
  its remaining work intact, checkpointed at its realized trie node (the
  realized prefix is kept, per the paper's re-rooting model), re-queued at
  its class priority, and later resumes the same stage — no work is lost,
  re-executed, or double-charged.  A single class with weight 1 and no
  deadline override is bit-identical to running without classes.

Event-loop contract (what an executor/policy author may rely on): events
are processed in virtual-time order; at one timestamp the order is (1)
stage completions, (2) deadline sheds (in-service and paused), (3)
arrivals joining the queue, (4) queue rejections, then a preempt → admit/
resume → batched-replan → dispatch cycle that repeats within the event
while freed or preemptable slots can absorb queued arrivals (overload
shedding runs after each dispatch).  All times are seconds of virtual
time; the only wall-clock measurement is the planner-call duration
recorded in `EventStats.replan_s`.

Degenerate case: with all arrivals at t=0, slot capacity >= cohort size and
no load coupling, every stage runs back-to-back on its request's own
timeline and every replan sees the same (prefix, elapsed, delays) inputs as
the lockstep fleet — the results are bit-identical to `run_fleet` and to
the scalar `run_request` loop (property-tested in tests/test_events*.py).

Like `run_fleet`, load coupling is duck-typed: ``fleet_load`` needs
`.delays(inflight)` and `.slowdown(engine, n_others)`; the standard
implementation is `repro.serving.loadsim.FleetLoadModel`.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
import warnings
from typing import Callable

import numpy as np

import torch

from repro_torch.core.admission import (
    FAILED,
    REJECTED,
    SERVED,
    SHED,
    cheapest_feasible_target,
    get_policy,
)
from repro_torch.core.controller import Objective
from repro_torch.core.controller_torch import (
    TrieDevice,
    make_resident_planner,
    next_model_for,
    trie_engines,
)
from repro_torch.core.faults import (
    FaultSchedule,
    blocked_depth_table,
    validate_increasing,
)
from repro_torch.core.runtime import ExecutionResult, StageExecutor
from repro_torch.core.trie import Trie, TrieAnnotations
from repro_torch.device import resolve_device

_DEFAULT_CAPACITY = 64


@dataclasses.dataclass
class EventStats:
    """Control-plane telemetry for one `run_events` call."""

    capacity: int = 0
    policy: str = "always"          # admission policy name
    events: int = 0                 # distinct virtual-clock timestamps processed
    replans: int = 0                # batched planner calls (shape = capacity)
    admitted: int = 0               # requests the policy accepted for service
    rejected: int = 0               # turned away before any stage executed
    shed: int = 0                   # aborted mid-flight (incl. deadline sheds)
    downgraded: int = 0             # re-routed to the cheapest feasible path
    preemptions: int = 0            # in-flight stages paused for a higher class
    resumed: int = 0                # paused stages restored into a slot
    explored: int = 0               # exploration-lane dispatch overrides
    annotation_swaps: int = 0       # scheduled annotation-version swaps
    refreshes: int = 0              # online-estimator republish+swap events
    # fault-injection telemetry (repro.core.faults; all zero without one)
    engine_outages: int = 0         # engine-down transitions applied
    engine_recoveries: int = 0      # engine-up transitions applied
    checkpointed: int = 0           # in-service stages checkpointed by outages
    stage_failures: int = 0         # injected stage-failure draws that hit
    timeouts: int = 0               # stages aborted by the timeout model
    fault_retries: int = 0          # backoff retries scheduled after aborts
    failed: int = 0                 # requests terminally failed ("failed")
    replan_s: list = dataclasses.field(default_factory=list)
    planned_per_replan: list = dataclasses.field(default_factory=list)
    peak_occupancy: dict = dataclasses.field(default_factory=dict)
    # per-request outcome labels + timelines, aligned with ``requests``
    outcome: list = dataclasses.field(default_factory=list)
    # per-request SLO-class indices (None when serving without classes)
    class_of: np.ndarray | None = None
    # per-request preemption counts (zeros when serving without classes)
    preempt_count: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    # per-request annotation version active at each dispatched stage
    # (prefix-aligned with ``ExecutionResult.models``; a request shed
    # mid-stage keeps one trailing entry for the aborted dispatch; host
    # loop only — the compiled engine leaves this empty)
    stage_versions: list = dataclasses.field(default_factory=list)
    arrival_t: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    admit_t: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    done_t: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    @property
    def total_replan_s(self) -> float:
        """Total wall time spent in batched replans over the run."""
        return float(sum(self.replan_s))

    @property
    def queue_wait_s(self) -> np.ndarray:
        """Per-request admission-queue wait (0 when a slot was free)."""
        return self.admit_t - self.arrival_t

    @property
    def mean_queue_wait_s(self) -> float:
        """Mean admission-queue wait across all requests (seconds)."""
        w = self.queue_wait_s
        return float(np.mean(w)) if w.size else 0.0

    @property
    def replan_s_per_planned_request(self) -> float:
        """Mean per-request share of a batched replan (only requests that
        were actually planned in that call share its cost)."""
        shares = [s / k for s, k in
                  zip(self.replan_s, self.planned_per_replan) if k > 0]
        return float(np.mean(shares)) if shares else 0.0


def _explore_tables(trie: Trie, term_mask: np.ndarray, n_requests: int,
                    explore) -> np.ndarray | None:
    """Precompute the per-request exploration draws (epsilon-greedy).

    ``explore`` is an epsilon in [0, 1] or a dict ``{"epsilon":, "seed":}``.
    Returns an (n_requests,) int32 array: the root-stage model to explore
    for each request, or -1 (not drawn / epsilon 0 / no explorable model).
    Only models whose root child leads to at least one effective terminal
    are explorable — exploration must never strand a request on a subtree
    with no terminating plan.  The draws are a pure function of (seed,
    epsilon, trie) made BEFORE the event loop runs, so the host and
    compiled engines apply bit-identical overrides in any event order.
    """
    if explore is None:
        return None
    if isinstance(explore, dict):
        unknown = set(explore) - {"epsilon", "seed"}
        if unknown:
            raise ValueError(f"unknown explore keys {sorted(unknown)} "
                             "(expected epsilon=/seed=)")
        eps = float(explore.get("epsilon", 0.0))
        seed = int(explore.get("seed", 0))
    else:
        eps = float(explore)
        seed = 0
    if not 0.0 <= eps <= 1.0:
        raise ValueError(f"explore epsilon must be in [0, 1], got {eps}")
    if eps == 0.0 or n_requests == 0:
        return None
    valid = []
    for m in range(trie.template.n_models):
        v = int(trie.child[0, m])
        if v < 0:
            continue
        lo, hi = trie.descendants_interval(v)
        if term_mask[lo:hi].any():
            valid.append(m)
    if not valid:
        return None
    rng = np.random.default_rng(seed)
    drawn = rng.random(n_requests) < eps
    picks = np.asarray(valid, dtype=np.int32)[
        rng.integers(0, len(valid), n_requests)]
    return np.where(drawn, picks, np.int32(-1)).astype(np.int32)


def run_events(
    trie: Trie,
    ann: TrieAnnotations,
    obj: Objective,
    requests: np.ndarray,
    executor: StageExecutor,
    *,
    arrivals: np.ndarray | None = None,
    capacity: int | None = None,
    policy: str = "dynamic",
    admission=None,
    classes: np.ndarray | None = None,
    class_specs=None,
    preempt: bool = True,
    restrict_nodes: np.ndarray | None = None,
    load_probe: Callable[[float], dict[str, float]] | None = None,
    fleet_load=None,
    work_model=None,
    t_start: float = 0.0,
    plan_variant: str | None = None,
    annotation_schedule=None,
    refresh=None,
    explore=None,
    faults: FaultSchedule | None = None,
    compiled: bool = False,
    devices: int | None = None,
    device: str | torch.device = "cuda",
    **compiled_kwargs,
) -> tuple[list[ExecutionResult], EventStats]:
    """Serve an open-arrival stream of ``requests`` event-by-event.

    ``arrivals`` gives each request's arrival time on the virtual clock
    (seconds, relative to ``t_start``); ``None`` means everything arrives
    at t=0 (the closed-cohort degenerate case).  ``capacity`` fixes the
    slot-array size and therefore the planner's batch shape; it defaults
    to the cohort size for closed cohorts (guaranteeing `run_fleet`
    equivalence) and to ``min(len(requests), 64)`` for open arrivals.
    ``admission`` selects the admission-control / load-shedding policy:
    None or ``"always"`` (FIFO, admit everything — the default),
    ``"feasibility"``, ``"predictive"``, ``"cost_aware"``, or any
    `repro.core.admission.AdmissionPolicy` instance; rejected and shed
    requests are reported with ``ExecutionResult.outcome`` set to
    ``"rejected"`` / ``"shed"`` and counted in `EventStats`.
    ``class_specs`` + ``classes`` enable priority-class serving: a table
    of `repro.core.workload.SLOClass` entries and per-request indices into
    it (``classes=None`` puts everything in class 0).  Class weights drive
    the admission priority queue and weighted processor sharing; class
    deadlines replace ``obj.lat_cap`` per request; ``preempt`` (default
    True) lets a queued higher-weight request pause the lowest-value
    in-flight stage, which is checkpointed at its realized trie node and
    resumed later with its remaining work intact.
    ``plan_variant`` picks the planner dispatch path
    (`controller_torch.PLAN_VARIANTS`; None = the kernel on a CUDA
    device, the plain blocked version on the CPU).  ``device`` holds the
    planner's trie columns and runs the replan ("cuda" unless the caller
    asks for "cpu").

    **Online annotations** (ISSUE 8): three knobs close the loop between
    realized executions and the planner's annotation tables.
    ``annotation_schedule`` is a sequence of ``(t_swap, TrieAnnotations)``
    pairs: when the virtual clock first strictly exceeds ``t_swap`` the
    planner's `TrieDevice` is rebuilt from the new annotations and
    swapped in via `ResidentPlanner.swap_device` — the annotation columns
    are traced operands, so every swap is a pure buffer substitution with
    ZERO new compiled programs; events at ``t <= t_swap`` run under the
    old version (both engines apply this rule identically, so host and
    compiled stay bit-compatible across mid-run swaps).
    ``refresh`` takes a `repro.core.estimators.RefreshConfig`: realized
    stage outcomes feed its `OnlineEstimators` posteriors at each
    completion, and every ``interval`` virtual seconds (given
    ``min_observations`` new observations) the estimators are decayed,
    re-annotated through `TrieAnnotator.publish`, and swapped in — host
    loop only (the compiled engine raises ``NotImplementedError``).
    ``explore`` (an epsilon or ``dict(epsilon=, seed=)``) enables the
    epsilon-greedy exploration lane: a pre-drawn fraction of requests
    override the planner's root-stage pick with a random explorable model
    (guarded by a float32 budget-feasibility check against the live
    annotation version), keeping rarely-chosen paths' posteriors fresh;
    the explored stage is charged against the request's budget like any
    other.  Admission-policy feasibility bounds stay bound to the
    *initial* annotations across swaps (they are frozen scalars in the
    compiled engine's static config — see docs/EVENT_ENGINE.md).

    **Fault injection** (ISSUE 9): ``faults`` takes a
    `repro.core.faults.FaultSchedule` — a deterministic, replayable fault
    model.  Engine *outages* checkpoint every in-service stage on the
    dead engine at its realized trie node (the preemption pause buffer),
    requeue the victims at their class priority, and mask the engine out
    of the planner through a traced blocked-depth operand (a pure buffer
    substitution, zero new compiled programs); recovery flips the mask
    back.  Seeded *stage failures* (a pure function of the seed, drawn
    before the loop runs like the exploration lane) and *timeouts*
    (``timeout_k`` x the annotation latency forecast) abort the stage and
    retry under capped exponential backoff charged against the request's
    latency budget — the re-root replan naturally routes the retry
    through whatever model/engine the planner now prefers.  A request
    that exhausts ``max_retries`` at one stage, or whose deadline dies
    after any fault touched it, reports ``outcome="failed"``.
    ``recovery="restart"`` is the naive baseline: outage victims restart
    from the trie root instead of their checkpoint (host loop only;
    `benchmarks/chaos.py` measures the goodput gap).
    Results are returned in ``requests`` order; `total_lat` and the SLO
    check (against each request's own class deadline, when classes are
    given) are measured from each request's *arrival*, so admission-queue
    wait counts against the deadline.

    ``compiled=True`` (the epoch-batched compiled engine) and
    ``devices > 1`` (the lane-sharded control plane) are not ported yet
    and raise ``NotImplementedError`` (ROADMAP.md queue 1 items 5 and 6).

    **Token-level engine model** (ISSUE 10): ``work_model`` takes a
    `repro.serving.loadsim.TokenWorkModel` — each dispatched stage's
    unloaded work becomes ``prefill_tokens x prefill_tok_s +
    decode_tokens x decode_step_s(1)`` (from ``work_model.stage_tokens``,
    a pure function like the executor), and the engine calendar drains
    it at the continuous-batching token rate (weight-read amortization,
    per-sequence KV reads, KV-capacity cap) instead of the abstract
    processor-sharing rate.  The planner's delta_e row, the predictive
    gate's wait forecasts, the deadline certainty bound, and preemption
    checkpoints all account remaining work through the same token
    calendar.  Mutually exclusive with ``fleet_load`` (the scalar lane,
    ``work_model="scalar"`` in the docs' terms, is unchanged — all
    existing golden pins hold).  The executor's latency return is
    ignored for calendar purposes under tokens (realized wall time comes
    from the clock); its success/cost returns are used as ever.
    """
    dev = resolve_device(device)
    if policy not in ("dynamic", "dynamic_load_aware"):
        raise ValueError(f"unsupported events policy {policy!r}: the static "
                         "baseline plans once per request — use run_cohort's "
                         "scalar path")
    if annotation_schedule is not None:
        # swap epochs are applied in sequence order: a misordered schedule
        # is a caller bug, not something to silently re-sort
        validate_increasing([float(ts) for ts, _ in annotation_schedule],
                            "annotation_schedule swap times")
    if faults is not None and not isinstance(faults, FaultSchedule):
        raise TypeError("faults must be a repro_torch.core.faults."
                        "FaultSchedule, "
                        f"got {type(faults).__name__}")
    if work_model is not None:
        if fleet_load is not None:
            raise ValueError("work_model and fleet_load are mutually "
                             "exclusive: the token calendar replaces the "
                             "scalar slowdown model")
        if load_probe is not None:
            raise ValueError("work_model and load_probe are mutually "
                             "exclusive: delta_e comes from the token "
                             "calendar's own occupancy")
        if getattr(work_model, "stage_tokens", None) is None:
            raise ValueError("work_model.stage_tokens must be set: the "
                             "token calendar needs per-stage "
                             "(prefill, decode) token counts")
    if compiled:
        raise NotImplementedError(
            "the compiled event engine (compiled=True) is not ported yet: "
            "ROADMAP.md queue 1 item 5")
    if compiled_kwargs:
        raise TypeError(f"unexpected keyword arguments for the host event "
                        f"loop: {sorted(compiled_kwargs)} (compiled=True "
                        "accepts epoch=/stream=)")
    pol = get_policy(admission)
    requests = np.asarray(requests)
    B = int(requests.shape[0])
    if arrivals is None:
        arrivals = np.zeros(B, dtype=np.float64)
    else:
        arrivals = np.asarray(arrivals, dtype=np.float64)
        if arrivals.shape != (B,):
            raise ValueError(f"arrivals shape {arrivals.shape} != ({B},)")
        if B and (not np.all(np.isfinite(arrivals)) or arrivals.min() < 0):
            raise ValueError("arrivals must be finite and non-negative")
    if capacity is None:
        capacity = B if arrivals.size == 0 or arrivals.max() == 0.0 \
            else min(B, _DEFAULT_CAPACITY)
    C = int(capacity)
    if B and C < 1:
        raise ValueError("capacity must be >= 1")
    mesh_kw = {}
    if devices is not None:
        if int(devices) < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if int(devices) > 1:
            raise NotImplementedError(
                "the lane-sharded control plane (devices > 1) is not "
                "ported yet: ROADMAP.md queue 1 item 6")

    # ---- priority classes -------------------------------------------
    priorities = class_specs is not None
    if not priorities and classes is not None:
        raise ValueError("classes requires class_specs (the SLOClass table "
                         "the indices point into)")
    base_cap = obj.lat_cap if obj.lat_cap is not None else np.inf
    if priorities:
        specs = tuple(class_specs)
        if not specs:
            raise ValueError("class_specs must be a non-empty sequence of "
                             "SLO classes")
        cls_idx = (np.zeros(B, dtype=np.int64) if classes is None
                   else np.asarray(classes, dtype=np.int64))
        if cls_idx.shape != (B,):
            raise ValueError(f"classes shape {cls_idx.shape} != ({B},)")
        if B and (cls_idx.min() < 0 or cls_idx.max() >= len(specs)):
            raise ValueError(
                f"classes must index the {len(specs)} class_specs entries")
        cap_cls = np.array([c.deadline_s if c.deadline_s is not None
                            else base_cap for c in specs], dtype=np.float64)
        w_cls = np.array([c.weight for c in specs], dtype=np.float64)
        cap_req = cap_cls[cls_idx]      # per-request deadline budget (inf ok)
        weight_req = w_cls[cls_idx]     # per-request weighted-PS share
    else:
        cls_idx = None
        cap_req = np.full(B, base_cap)
        weight_req = np.ones(B)

    stats = EventStats(capacity=C,
                       policy=pol.name,
                       outcome=[SERVED] * B,
                       arrival_t=arrivals.copy(),
                       admit_t=np.zeros(B, dtype=np.float64),
                       done_t=np.zeros(B, dtype=np.float64),
                       class_of=None if cls_idx is None else cls_idx.copy(),
                       preempt_count=np.zeros(B, dtype=np.int64))
    if B == 0:
        return [], stats

    td = TrieDevice.build(trie, ann, restrict_nodes, device=dev)
    # per-class deadlines ride the existing planner lanes: the single
    # traced lat-cap scalar becomes the LARGEST finite class cap and each
    # lane's elapsed latency is shifted by (eff_cap - its own cap), so the
    # kernel's `d_lat <= lat_cap - elapsed` test checks every lane against
    # its own deadline — zero new compiled programs (see ResidentPlanner)
    lat_shift = np.zeros(B)
    if priorities:
        finite = cap_req[np.isfinite(cap_req)]
        eff_cap = float(finite.max()) if finite.size else None
        if eff_cap is not None:
            lat_shift = np.where(np.isfinite(cap_req),
                                 eff_cap - cap_req, -np.inf)
            # shifted elapsed values live near eff_cap in float32, whose
            # resolution there bounds how finely the planner can see a
            # tight class's burned budget — warn when deadline spread
            # makes that quantization material vs the tightest deadline
            step = float(np.spacing(np.float32(eff_cap)))
            if step > 1e-3 * float(finite.min()):
                warnings.warn(
                    f"class deadline spread ({finite.min():.3g}s .. "
                    f"{eff_cap:.3g}s) exceeds float32 elapsed-shift "
                    f"resolution ({step:.3g}s at the largest cap): the "
                    "planner's feasibility may lag the host deadline "
                    "bookkeeping by up to that much for tight classes",
                    stacklevel=2)
        planner = make_resident_planner(td, obj, C, variant=plan_variant,
                                        lat_cap=eff_cap, **mesh_kw)
    else:
        planner = make_resident_planner(td, obj, C, variant=plan_variant,
                                        **mesh_kw)
    engines = trie_engines(trie.template)
    E = len(engines)
    engine_of_model = td.engine_of_model.cpu().numpy().astype(np.int64)
    max_depth = trie.template.max_depth
    load_aware = policy == "dynamic_load_aware"

    def obj_for(i: int) -> Objective:
        """The request's own objective: its class deadline as lat_cap."""
        if not priorities or cap_req[i] == base_cap:
            return obj
        cap = float(cap_req[i]) if np.isfinite(cap_req[i]) else None
        return dataclasses.replace(obj, lat_cap=cap)

    # effective terminal mask (restrict_nodes applied) — the policy's
    # feasibility bounds must see exactly what the device planner sees
    term_mask = trie.terminal.copy()
    if restrict_nodes is not None:
        keep = np.zeros(trie.n_nodes, dtype=bool)
        keep[restrict_nodes] = True
        term_mask &= keep
    pol.bind(trie, ann, obj, term_mask)
    deadline_sheds = pol.shed_on_deadline and bool(
        np.isfinite(cap_req).any())

    # ---- fault injection (ISSUE 9) ----------------------------------
    fs = faults
    fault_events: list[tuple[float, int, bool]] = []
    fe_ptr = 0
    avail = np.ones(E, dtype=bool)        # per-engine availability
    bd_col: np.ndarray | None = None      # planner blocked-depth operand
    fdraws = None                         # (B, D, A) seeded failure draws
    attempts = faulted = displaced_w = None
    lat32f = None                         # float32 latency col (timeouts)
    path_models_host = None
    if fs is not None:
        fault_events = fs.events(engines)
        path_models_host = td.path_models.cpu().numpy()
        if fs.stage_failure_rate > 0.0 or fs.failure_table is not None:
            fdraws = fs.failure_draws(B, max_depth)
        attempts = np.zeros((B, max_depth), dtype=np.int64)
        faulted = np.zeros(B, dtype=bool)
        displaced_w = np.zeros(B, dtype=np.float64)
        if fs.timeout_k is not None:
            lat32f = td.lat.cpu().numpy().copy()

    # ---- online annotations: swaps / refresh / exploration ----------
    sched: list[tuple[float, TrieAnnotations]] = \
        [] if annotation_schedule is None else \
        [(float(ts), a) for ts, a in annotation_schedule]
    for ts, _ in sched:
        if not np.isfinite(ts) or ts < 0:
            raise ValueError("annotation_schedule swap times must be "
                             f"finite and non-negative, got {ts}")
    annotator = None
    if refresh is not None:
        from repro_torch.core.estimators import TrieAnnotator
        est = refresh.estimators
        annotator = TrieAnnotator(trie, est, restrict_nodes, device=dev)
        refresh_t = float(refresh.interval)
        obs_mark = est.observations
    explore_model = _explore_tables(trie, term_mask, B, explore)
    # the downgrade re-router and the explore guard must read the LIVE
    # annotation version (mirroring the compiled engine, whose downgrade
    # and explore lanes read the swapped-in cn["td"] columns); the
    # admission policy's bound feasibility scalars stay frozen at v0
    active_ann = ann
    cost32 = lat32 = None
    if explore_model is not None:
        # float32 host copies of the device annotation columns + the
        # planner's traced cap scalars: the guard below reproduces the
        # compiled engine's float32 arithmetic bit-for-bit
        cost32 = td.cost.cpu().numpy().copy()
        lat32 = td.lat.cpu().numpy().copy()
        sc_cost32 = np.float32(planner.scalars[1])
        sc_lat32 = np.float32(planner.scalars[2])

    def apply_device(new_td, new_ann) -> None:
        """Swap a re-annotated device into the planner (zero retrace)."""
        nonlocal active_ann, cost32, lat32, lat32f
        planner.swap_device(new_td)
        active_ann = new_ann
        if explore_model is not None:
            cost32 = new_td.cost.cpu().numpy().copy()
            lat32 = new_td.lat.cpu().numpy().copy()
        if lat32f is not None:
            # timeout forecasts track the live annotation version
            lat32f = new_td.lat.cpu().numpy().copy()

    # vectorized processor-sharing calendar across all engines; numpy-only
    # module, but imported lazily so `repro.core` stays importable without
    # the serving package's model stack
    from repro_torch.serving.loadsim import FleetEngineSim
    sim = FleetEngineSim(
        engines, C,
        slowdown=(lambda ei, n: fleet_load.slowdown(engines[ei], n))
        if (load_aware and fleet_load is not None) else None,
        token_models=(dict(work_model.engines)
                      if work_model is not None else None),
    )
    stats.peak_occupancy = {e: 0 for e in engines}

    # fixed-capacity slot arrays — the authoritative host mirror of the
    # control state (policies and the executor read it); the planner's
    # device-resident copy is refreshed lane-by-lane at each replan
    slot_owner = np.full(C, -1, dtype=np.int64)    # request position, -1 free
    u = np.zeros(C, dtype=np.int32)                # realized prefix node
    elapsed_lat = np.zeros(C, dtype=np.float64)    # t - arrival at last replan
    elapsed_cost = np.zeros(C, dtype=np.float64)
    stage_model = np.full(C, -1, dtype=np.int64)   # in-service stage, -1 idle
    stage_success = np.zeros(C, dtype=bool)
    downgraded = np.zeros(C, dtype=bool)           # cost-aware re-route flag
    free_mask = np.ones(C, dtype=bool)             # free slots
    need_mask = np.zeros(C, dtype=bool)            # lanes to replan this event
    deadline = np.full(C, np.inf)                  # scheduled shed, inf = none
    stage_depth = np.full(C, -1, dtype=np.int64)   # dispatched stage's depth
    stage_cost_last = np.zeros(C)                  # dispatched stage's cost
    stage_work = np.zeros(C)                       # nominal (unloaded) work
    stage_tok = np.zeros(C)         # stage tokens (prefill + decode)
    retry_t = np.full(C, np.inf)    # backoff-hold release time (faults)
    timeout_t = np.full(C, np.inf)  # in-service stage timeout (faults)

    # per-request outputs (aligned with ``requests``)
    success = np.zeros(B, dtype=bool)
    total_cost = np.zeros(B, dtype=np.float64)
    overhead = np.zeros(B, dtype=np.float64)
    models: list[list[int]] = [[] for _ in range(B)]
    stats.stage_versions = [[] for _ in range(B)]

    # arrivals in time order (stable: ties keep ``requests`` order); the
    # admission queue is a (class weight desc, arrival order) priority
    # heap — with one class (or none) the weights tie and the heap is
    # exactly the old FIFO deque
    order = np.argsort(arrivals, kind="stable")
    seq_of = np.empty(B, dtype=np.int64)
    seq_of[order] = np.arange(B)
    arr_ptr = 0
    pending: list[tuple[float, int, int]] = []  # (-weight, arrival seq, i)

    def push_pending(i: int) -> None:
        heapq.heappush(pending, (-float(weight_req[i]), int(seq_of[i]), i))

    # preempted requests checkpointed at their realized trie node:
    # (prefix u, stage model, stage success, remaining unloaded work,
    # elapsed cost, downgraded flag, stage depth, stage cost, nominal
    # stage work, stage tokens) — restored verbatim on resume.  Under
    # the token model the paused record's remaining work carries the
    # stage's undecoded-token balance (in batch-1 seconds): the victim's
    # KV reservation is released with its engine share at preempt time
    # and re-acquired on resume, and no decoded token is ever re-charged
    paused: dict[int, tuple] = {}

    def release_slot(slot: int) -> None:
        """Reset a slot to the free state (every per-slot column)."""
        slot_owner[slot] = -1
        u[slot] = 0
        elapsed_lat[slot] = 0.0
        elapsed_cost[slot] = 0.0
        stage_model[slot] = -1
        downgraded[slot] = False
        deadline[slot] = np.inf
        retry_t[slot] = np.inf
        timeout_t[slot] = np.inf
        free_mask[slot] = True

    def clear_displaced(i: int) -> None:
        """Hand displaced-work credit back to the admission policy once
        the checkpointed request redispatches or terminates."""
        if fs is not None and displaced_w[i] > 0.0:
            pol.note_displaced(-float(displaced_w[i]))
            displaced_w[i] = 0.0

    def finish(i: int, slot: int, t: float) -> None:
        stats.done_t[i] = t
        total_cost[i] = elapsed_cost[slot]
        clear_displaced(i)
        release_slot(slot)

    def shed(i: int, slot: int, t: float) -> None:
        """Abort a request mid-flight; its engine share frees immediately.
        A request any fault already touched reports "failed", not "shed":
        the serving system, not the request's budget, is what gave out."""
        if stage_model[slot] >= 0:
            sim.cancel(slot, t)
        if fs is not None and faulted[i]:
            stats.outcome[i] = FAILED
            stats.failed += 1
        else:
            stats.outcome[i] = SHED
            stats.shed += 1
        finish(i, slot, t)

    def shed_paused(i: int, t: float) -> None:
        """Shed a preempted request straight from the queue (its deadline
        died while paused); keeps the cost of its executed stages."""
        rec = paused.pop(i)
        if fs is not None and faulted[i]:
            stats.outcome[i] = FAILED
            stats.failed += 1
        else:
            stats.outcome[i] = SHED
            stats.shed += 1
        stats.done_t[i] = t
        total_cost[i] = rec[4]
        clear_displaced(i)

    def fault_abort(i: int, slot: int, d: int, t: float) -> None:
        """Charge one failed attempt at stage depth ``d``: hold the slot
        for a backoff retry (the release rejoins the replan set, so the
        re-root routes the retry wherever the planner now prefers) or
        terminally fail the request once the retry budget is spent."""
        faulted[i] = True
        attempts[i, d] += 1
        a = int(attempts[i, d])
        if a > fs.max_retries:
            stats.outcome[i] = FAILED
            stats.failed += 1
            finish(i, slot, t)
        else:
            stats.fault_retries += 1
            retry_t[slot] = t + fs.backoff(a - 1)

    def suspend(i: int, slot: int, t: float) -> None:
        """Preempt: pause the slot's in-service stage keeping its
        remaining work, checkpoint the realized prefix, release the slot
        and engine share, and re-queue at the request's class priority."""
        remw = sim.preempt(slot, t)
        paused[i] = (int(u[slot]), int(stage_model[slot]),
                     bool(stage_success[slot]), float(remw),
                     float(elapsed_cost[slot]), bool(downgraded[slot]),
                     int(stage_depth[slot]), float(stage_cost_last[slot]),
                     float(stage_work[slot]), float(stage_tok[slot]))
        stats.preemptions += 1
        stats.preempt_count[i] += 1
        release_slot(slot)
        push_pending(i)

    def resume(i: int, slot: int, t: float) -> None:
        """Restore a preempted request into ``slot`` and resume its paused
        stage with exactly the remaining work `preempt` captured — no
        replan, no re-execution, no double-charged cost."""
        pu, pm, psucc, remw, pec, pdg, pd, psc, pw, ptk = paused.pop(i)
        u[slot] = pu
        elapsed_lat[slot] = t - arrivals[i]
        elapsed_cost[slot] = pec
        downgraded[slot] = pdg
        if deadline_sheds:
            t_d = arrivals[i] + cap_req[i]
            if np.isfinite(t_d) and t_d > t:
                deadline[slot] = t_d
        if pm < 0:
            # fault checkpoint (engine outage): there is no paused
            # calendar entry to restore — the request joins this event's
            # batched replan from its realized node, and the availability
            # mask routes it around the dead engine
            need_mask[slot] = True
            return
        stage_model[slot] = pm
        stage_success[slot] = psucc
        stage_depth[slot] = pd
        stage_cost_last[slot] = psc
        stage_work[slot] = pw
        stage_tok[slot] = ptk
        sim.start(slot, int(engine_of_model[pm]), remw, t,
                  weight=float(weight_req[i]))
        stats.resumed += 1
        occ_now = sim.occupancies()
        for j, e in enumerate(engines):
            stats.peak_occupancy[e] = max(stats.peak_occupancy[e],
                                          int(occ_now[j]))

    def preemptable() -> bool:
        """A queued request outranks some in-flight stage (strictly): the
        preempt pass can still make progress with zero free slots."""
        if not (priorities and preempt and pending):
            return False
        insvc = (slot_owner >= 0) & (stage_model >= 0)
        lows = np.nonzero(insvc)[0]
        return bool(lows.size and (weight_req[slot_owner[lows]]
                                   < -pending[0][0]).any())

    while True:
        t_arr = arrivals[order[arr_ptr]] if arr_ptr < B else np.inf
        t = min(t_arr, sim.next_completion(), float(deadline.min()))
        if fs is not None:
            # fault transitions, backoff releases and timeouts are
            # scheduled events: they force their own clock ticks
            if fe_ptr < len(fault_events):
                t = min(t, fault_events[fe_ptr][0])
            t = min(t, float(retry_t.min()), float(timeout_t.min()))
        if deadline_sheds and paused:
            # a preempted request's deadline must be a scheduled event too:
            # paused work sits in the queue, not the deadline column
            t = min(t, min(arrivals[i] + cap_req[i] for i in paused))
        if not np.isfinite(t):
            assert not pending and np.all(slot_owner < 0), \
                "event loop stalled with work outstanding"
            break
        # scheduled annotation swaps: events at t <= t_swap ran under the
        # old version; the first event strictly past it sees the new one
        # (the compiled engine splits its epoch loop at the same
        # boundaries, so both engines apply this rule bit-identically)
        while sched and t > sched[0][0]:
            new_ann = sched.pop(0)[1]
            new_td = TrieDevice.build(trie, new_ann, restrict_nodes,
                                      device=dev)
            new_td.version = planner.device_version + 1
            apply_device(new_td, new_ann)
            stats.annotation_swaps += 1
        # estimator refresh: once per interval, as soon as enough new
        # observations arrived — decay, republish, swap (host loop only)
        if annotator is not None and t > refresh_t and \
                est.observations - obs_mark >= refresh.min_observations:
            if refresh.decay != 1.0:
                est.decay_all(refresh.decay)
            apply_device(annotator.publish(), annotator.current_ann)
            stats.refreshes += 1
            obs_mark = est.observations
            refresh_t = t + float(refresh.interval)
        stats.events += 1
        need_mask[:] = False

        # 1. stage completions at exactly t (canonical engine order, then
        #    admission order — FleetEngineSim reports them pre-sorted)
        for slot, realized_s in sim.pop_completed(t):
            i = int(slot_owner[slot])
            m = int(stage_model[slot])
            stage_model[slot] = -1
            timeout_t[slot] = np.inf  # completion beats timeout at the tie
            if annotator is not None:
                # realized outcome -> posteriors; the latency posterior
                # tracks the UNLOADED stage work (the executor's nominal
                # time, same quantity the offline annotation estimates —
                # engine slowdowns inflate it), NOT the loaded wall time:
                # queueing delay is the load-aware delta terms' job, and
                # feeding it here would double-count load and over-shed
                if work_model is not None:
                    # token mode additionally feeds the per-token latency
                    # posterior (seconds of unloaded work per token), so
                    # drift refresh tracks throughput drift, not just
                    # stage-size drift
                    est.observe(int(stage_depth[slot]), m,
                                bool(stage_success[slot]),
                                float(stage_cost_last[slot]),
                                float(stage_work[slot]),
                                tokens=float(stage_tok[slot]))
                else:
                    est.observe(int(stage_depth[slot]), m,
                                bool(stage_success[slot]),
                                float(stage_cost_last[slot]),
                                float(stage_work[slot]))
                pol.observe_service(float(stage_work[slot]),
                                    float(realized_s))
            models[i].append(m)
            u[slot] = trie.child[u[slot], m]
            if stage_success[slot]:
                success[i] = True
                finish(i, slot, t)
            elif int(trie.depth[u[slot]]) >= max_depth:
                finish(i, slot, t)
            else:
                need_mask[slot] = True

        # 1t. timeout aborts: a stage still in service past its forecast-
        #     derived budget (dispatch t + k x the annotation latency
        #     forecast) is cancelled — the dispatch cost stays charged —
        #     and retried under the backoff schedule.  Completions at the
        #     same instant (step 1) win the tie.
        if fs is not None and fs.timeout_k is not None:
            for slot in np.nonzero(timeout_t <= t)[0]:
                if stage_model[slot] < 0:
                    timeout_t[slot] = np.inf
                    continue
                i = int(slot_owner[slot])
                sim.cancel(int(slot), t)
                stage_model[slot] = -1
                timeout_t[slot] = np.inf
                stats.timeouts += 1
                fault_abort(i, int(slot), int(stage_depth[slot]), t)

        # 1f. engine fault transitions at exactly t (downs before ups at
        #     one instant — `FaultSchedule.events` orders them).  An
        #     outage checkpoints every in-service stage on the dead
        #     engine at its realized trie node into the preemption pause
        #     buffer (stage model -1 = "replan on admit"), charges one
        #     attempt, requeues the victim at its class priority, and
        #     rebuilds the planner's blocked-depth operand; recovery
        #     flips the mask back.  Fault times force their own clock
        #     events, so transitions apply at t == fault time (unlike
        #     annotation swaps' strictly-past rule).
        if fs is not None:
            while fe_ptr < len(fault_events) and \
                    fault_events[fe_ptr][0] <= t:
                _, ei, up = fault_events[fe_ptr]
                fe_ptr += 1
                avail[ei] = up
                if up:
                    stats.engine_recoveries += 1
                else:
                    stats.engine_outages += 1
                    insvc = (slot_owner >= 0) & (stage_model >= 0)
                    hit = insvc.copy()
                    hit[insvc] = engine_of_model[stage_model[insvc]] == ei
                    for slot in np.nonzero(hit)[0]:
                        i = int(slot_owner[slot])
                        remw = sim.preempt(int(slot), t)
                        stats.checkpointed += 1
                        faulted[i] = True
                        d = int(stage_depth[slot])
                        attempts[i, d] += 1
                        if int(attempts[i, d]) > fs.max_retries:
                            stats.outcome[i] = FAILED
                            stats.failed += 1
                            finish(i, int(slot), t)
                            continue
                        pu = 0 if fs.recovery == "restart" else int(u[slot])
                        paused[i] = (pu, -1, False, 0.0,
                                     float(elapsed_cost[slot]),
                                     bool(downgraded[slot]), -1, 0.0, 0.0,
                                     0.0)
                        displaced_w[i] = float(remw)
                        pol.note_displaced(float(remw))
                        release_slot(int(slot))
                        push_pending(i)
                    # preempted stages paused on the dead engine lose
                    # their calendar resume too: charge an attempt and
                    # convert the record to replan-on-admit
                    for i, rec in list(paused.items()):
                        if rec[1] < 0 or engine_of_model[rec[1]] != ei:
                            continue
                        faulted[i] = True
                        attempts[i, int(rec[6])] += 1
                        pu = 0 if fs.recovery == "restart" else int(rec[0])
                        paused[i] = (pu, -1, False, 0.0, rec[4], rec[5],
                                     -1, 0.0, 0.0, 0.0)
                down = ~avail
                bd_col = (blocked_depth_table(
                    path_models_host, engine_of_model, down)
                    if down.any() else None)

        # 1b. deadline sheds.  (i) Certainty test: the processor-sharing
        #     rate never exceeds 1, so ``t + remaining unloaded work`` lower-
        #     bounds an in-service stage's completion; the moment that bound
        #     overruns the deadline the request can never make its SLO and
        #     is shed immediately — under saturation this fires well before
        #     the deadline itself.  One vectorized comparison over the
        #     calendar's remaining-work column.  (ii) Backstop: the deadline
        #     is also a scheduled event (the ``deadline`` column feeds the
        #     clock), so a doomed request never outlives its cap waiting for
        #     an unrelated event.  Completions at the same instant (step 1)
        #     win the tie.
        if deadline_sheds:
            insvc = (slot_owner >= 0) & (stage_model >= 0)
            if insvc.any():
                rem = sim.remaining(t)
                slots = np.nonzero(insvc)[0]
                ddl = arrivals[slot_owner[slots]] + cap_req[slot_owner[slots]]
                doomed = (t >= ddl) | (t + rem[slots] > ddl + 1e-9)
                for slot in slots[doomed]:
                    shed(int(slot_owner[slot]), int(slot), t)
            for slot in np.nonzero(deadline <= t)[0]:
                need_mask[slot] = False
                shed(int(slot_owner[slot]), int(slot), t)

        # 2. arrivals at exactly t join the admission queue (priority
        #    heap; pure FIFO when every weight ties)
        while arr_ptr < B and arrivals[order[arr_ptr]] <= t:
            push_pending(int(order[arr_ptr]))
            arr_ptr += 1

        # 2b. queue rejections: requests whose burned budget provably rules
        #     out every path never take a slot (policy-dependent; the
        #     default always-admit policy keeps everything).  Predictive
        #     policies additionally see a forecast of each queued
        #     request's remaining wait: the k-th kept request behind the
        #     free slots is handed the k-th projected completion time from
        #     the engine calendar.  Preempted (paused) requests carry
        #     realized work, so the only way they die here is their
        #     deadline — shed, not reject, mirroring the in-service
        #     certainty bound on their remaining stage work.
        if pending:
            proj = (sim.projected_completions(t) if pol.wants_forecast
                    else None)
            n_free = int(free_mask.sum())
            kept: list[tuple[float, int, int]] = []
            pos = 0
            # queue-priority order only matters when positions feed the
            # wait forecast — reject/shed decisions here are position-
            # independent — so skip the O(n log n) sort on the common path
            scan = sorted(pending) if proj is not None else pending
            for key in scan:
                i = key[2]
                if i in paused:
                    ddl = arrivals[i] + cap_req[i]
                    if deadline_sheds and np.isfinite(ddl) and (
                            t >= ddl or t + paused[i][3] > ddl + 1e-9):
                        shed_paused(i, t)
                    else:
                        kept.append(key)
                        pos += 1
                    continue
                wf = 0.0
                if proj is not None and proj.size:
                    j = pos - n_free
                    if j >= 0:
                        # positions beyond the in-service backlog wait for
                        # later service generations: extrapolate by whole
                        # drain rounds instead of clamping to the last
                        # projected completion
                        g, rix = divmod(j, proj.size)
                        wf = max(0.0, float(proj[rix]) - t
                                 + g * (float(proj[-1]) - t))
                if priorities or proj is not None:
                    reject = pol.queue_reject(
                        t - arrivals[i],
                        lat_cap=float(cap_req[i]) if priorities else None,
                        wait_forecast=wf)
                else:
                    # positional call: pre-ISSUE-5 AdmissionPolicy
                    # subclasses with a one-argument queue_reject keep
                    # working on class-free runs
                    reject = pol.queue_reject(t - arrivals[i])
                if reject:
                    stats.outcome[i] = REJECTED
                    stats.rejected += 1
                    stats.admit_t[i] = t
                    stats.done_t[i] = t
                else:
                    kept.append(key)
                    pos += 1
            pending = kept
            heapq.heapify(pending)

        # 1r. backoff releases: held slots whose retry backoff expired
        #     rejoin the replan set — the re-root naturally routes the
        #     retry through whatever model/engine the planner now prefers
        if fs is not None:
            for slot in np.nonzero(retry_t <= t)[0]:
                retry_t[slot] = np.inf
                need_mask[slot] = True

        # 3-5. preempt / admit / replan / dispatch — repeated within this
        # event because a dispatch-time-infeasible request frees its slot
        # immediately, and arrivals still queued at this instant must be
        # admitted into it rather than stranded (or, worse, left pending
        # with no future event to drain them)
        while True:
            # 3a. preemption: with every slot busy, the highest-priority
            #     queued request may pause the lowest-value in-flight
            #     stage — strictly lower class weight only, ranked by
            #     (weight, most remaining work, slot).  The victim is
            #     checkpointed (suspend) and re-queued; each preemption
            #     strictly shrinks the set of lower-weight in-service
            #     stages, so this cannot livelock.
            if priorities and preempt:
                while pending and not free_mask.any():
                    head_w = -pending[0][0]
                    insvc = (slot_owner >= 0) & (stage_model >= 0)
                    cand = np.nonzero(insvc)[0]
                    cand = cand[weight_req[slot_owner[cand]] < head_w]
                    if cand.size == 0:
                        break
                    rem = sim.remaining(t)
                    victim = min(
                        (int(s) for s in cand),
                        key=lambda s: (weight_req[slot_owner[s]],
                                       -rem[s], s))
                    suspend(int(slot_owner[victim]), victim, t)

            # 3b. admissions: free slots (lowest index first) serve the
            #     queue in (class weight, arrival) order; preempted
            #     requests resume their paused stage without a replan
            while free_mask.any() and pending:
                slot = int(np.argmax(free_mask))
                free_mask[slot] = False
                i = heapq.heappop(pending)[2]
                slot_owner[slot] = i
                if i in paused:
                    resume(i, slot, t)
                    continue
                u[slot] = 0
                elapsed_cost[slot] = 0.0
                stats.admit_t[i] = t
                stats.admitted += 1
                if deadline_sheds:
                    t_d = arrivals[i] + cap_req[i]
                    if np.isfinite(t_d) and t_d > t:
                        deadline[slot] = t_d
                need_mask[slot] = True

            need = np.nonzero(need_mask)[0]
            if need.size == 0:
                # resumes set no replan lanes; if the queue still holds a
                # request that outranks an in-flight stage, the preempt
                # pass must run again within this same event
                if preemptable():
                    continue
                break

            # 4. refresh deadline-elapsed (queue wait burns the budget) for
            #    the lanes being planned, mirror exactly those lanes into
            #    the device-resident slot state, then ONE batched replan
            #    over the full fixed-capacity arrays — free/mid-stage lanes
            #    are computed but masked out on the host.  This same call
            #    is the admission probe: a newly admitted request whose
            #    lane comes back -1 had no feasible path at its admission
            #    instant.
            elapsed_lat[need] = t - arrivals[slot_owner[need]]
            delay_row = np.zeros(E, dtype=np.float32)
            delay_dict: dict[str, float] | None = None
            if load_aware:
                if work_model is not None:
                    # token mode: the KV/batch physics depends on how many
                    # SEQUENCES hold residency, not on their PS weights —
                    # plain occupancy counts feed delta_e even under
                    # priority classes
                    occ_l = sim.occupancies()
                    occ_map = {e: float(occ_l[j])
                               for j, e in enumerate(engines)}
                elif priorities:
                    # weighted occupancy: a weight-4 job loads its engine
                    # like four weight-1 jobs (equals the plain count when
                    # every weight is 1)
                    occ_l = sim.weighted_occupancies()
                    occ_map = {e: float(occ_l[j])
                               for j, e in enumerate(engines)}
                else:
                    occ_l = sim.occupancies()
                    occ_map = {e: int(occ_l[j])
                               for j, e in enumerate(engines)}
                if work_model is not None:
                    delay_dict = work_model.delays(occ_map)
                    delay_row[:] = [delay_dict.get(e, 0.0) for e in engines]
                elif fleet_load is not None:
                    delay_dict = fleet_load.delays(occ_map)
                    delay_row[:] = [delay_dict.get(e, 0.0) for e in engines]
                elif load_probe is not None:
                    delay_dict = load_probe(t_start + t)
                    delay_row[:] = [delay_dict.get(e, 0.0) for e in engines]
                if pol.wants_forecast:
                    # predictive policies anchor delta_e to the calendar's
                    # outstanding backlog, so a shed's freed headroom is
                    # not handed back to the planner as optimism
                    delay_row = pol.forecast_delay_row(delay_row, sim, t)
                    delay_dict = {e: float(delay_row[j])
                                  for j, e in enumerate(engines)}
            t0 = time.perf_counter()
            el_planner = elapsed_lat[need]
            if priorities:
                # per-class deadlines enter the planner's feasibility
                # lanes as elapsed shifts against the largest-cap scalar
                # (-inf shift = deadline-free lane); see ResidentPlanner
                el_planner = el_planner + lat_shift[slot_owner[need]]
            el32_arr = el_planner.astype(np.float32)
            ec32_arr = elapsed_cost[need].astype(np.float32)
            planner.update(need, u[need], el32_arr, ec32_arr)
            # the blocked kwarg rides only on fault runs: duck-typed
            # planner wrappers keep the one-argument replan signature
            tgts, nxts = (planner.replan(delay_row) if bd_col is None
                          else planner.replan(delay_row, blocked=bd_col))
            replan_s = time.perf_counter() - t0
            stats.replans += 1
            stats.replan_s.append(replan_s)
            stats.planned_per_replan.append(int(need.size))
            share = replan_s / need.size

            # 4b. downgraded slots re-route to the cheapest feasible path
            #     (host float64 search, zero extra device programs); the
            #     batched lane is computed anyway and simply overridden
            if downgraded.any():
                nxts, tgts = nxts.copy(), tgts.copy()
                for slot in need:
                    if not downgraded[slot]:
                        continue
                    if bd_col is not None:
                        # during an outage the planner's availability-
                        # masked lane already excludes the dead engine;
                        # the host min-cost search cannot, so the
                        # downgrade override resumes on recovery
                        continue
                    tgt = cheapest_feasible_target(
                        trie, active_ann, obj_for(int(slot_owner[slot])),
                        int(u[slot]),
                        float(elapsed_lat[slot]), delay_dict, term_mask)
                    tgts[slot] = tgt
                    nxts[slot] = (next_model_for(trie, int(u[slot]), tgt)
                                  if tgt >= 0 else -1)

            # 4c. exploration lane: a pre-drawn request overrides the
            #     planner's ROOT-stage pick with its explore model iff
            #     the float32 budget guard passes against the LIVE
            #     annotation version — the exact arithmetic the compiled
            #     engine's traced guard does (optimistic: annotation path
            #     sums only, no delta_e terms).  Applied after the
            #     downgrade override; the explored stage is charged
            #     against the request's budget like any other.  A root
            #     replan happens at most once per request, so each
            #     request explores at most one stage.
            if explore_model is not None:
                nxts = np.array(nxts)
                for k, slot in enumerate(need):
                    if int(u[slot]) != 0 or int(nxts[slot]) < 0:
                        continue
                    em = int(explore_model[int(slot_owner[slot])])
                    if em < 0:
                        continue
                    if fs is not None and not avail[engine_of_model[em]]:
                        continue  # never explore onto a dead engine
                    v = int(trie.child[0, em])
                    if (el32_arr[k] + (lat32[v] - lat32[0]) <= sc_lat32
                            and ec32_arr[k] + (cost32[v] - cost32[0])
                            <= sc_cost32):
                        nxts[slot] = em
                        stats.explored += 1

            # 5. dispatch: start the chosen stage of every planned slot
            for slot in need:
                i = int(slot_owner[slot])
                overhead[i] += share
                m = int(nxts[slot])
                if m < 0:
                    # next_model < 0 covers two distinct verdicts, told
                    # apart by the target lane: target >= 0 means the
                    # realized prefix is itself the best terminating plan
                    # ("stop here" — a served disposition under every
                    # policy), target < 0 means NO feasible path remains.
                    # Only the latter is an admission decision: a gated
                    # request that never executed a stage was rejected at
                    # admission; one with realized work was shed mid-flight.
                    if int(tgts[slot]) < 0:
                        label = pol.classify_infeasible(len(models[i]))
                        if fs is not None and faulted[i] and \
                                label in (REJECTED, SHED):
                            # a fault consumed the budget, not the request
                            label = FAILED
                        if label == REJECTED:
                            stats.outcome[i] = REJECTED
                            stats.rejected += 1
                            stats.admitted -= 1
                        elif label == SHED:
                            stats.outcome[i] = SHED
                            stats.shed += 1
                        elif label == FAILED:
                            stats.outcome[i] = FAILED
                            stats.failed += 1
                    finish(i, slot, t)
                    continue
                d = int(trie.depth[u[slot]])
                if fdraws is not None:
                    a = int(attempts[i, d])
                    if fdraws[i, d, min(a, fs.max_retries)]:
                        # injected stage failure, detected at dispatch —
                        # no cost is charged; hold for backoff or fail out
                        stats.stage_failures += 1
                        fault_abort(i, int(slot), d, t)
                        continue
                s, c, lat = executor(int(requests[i]), d, m, t_start + t)
                if work_model is not None:
                    # the stage's unloaded work is its token footprint in
                    # batch-1 seconds; the executor's latency return is
                    # superseded by the calendar (wall time = clock)
                    ptok, dtok = work_model.stage_tokens(
                        int(requests[i]), d, m)
                    lat = work_model.work_of(
                        engines[int(engine_of_model[m])], ptok, dtok)
                    stage_tok[slot] = float(ptok) + float(dtok)
                elapsed_cost[slot] += c
                stage_model[slot] = m
                stage_success[slot] = bool(s)
                stage_depth[slot] = d
                stage_cost_last[slot] = c
                stage_work[slot] = lat
                if lat32f is not None:
                    # timeout budget = k x the live posterior latency
                    # forecast for this edge (float32 annotation delta,
                    # widened to the f64 clock)
                    v = int(trie.child[u[slot], m])
                    fc = float(lat32f[v]) - float(lat32f[u[slot]])
                    if fc > 0.0:
                        timeout_t[slot] = t + fs.timeout_k * fc
                clear_displaced(i)
                stats.stage_versions[i].append(planner.device_version)
                if priorities:
                    sim.start(int(slot), int(engine_of_model[m]), lat, t,
                              weight=float(weight_req[i]))
                else:  # duck-typed sims need not accept weight=
                    sim.start(int(slot), int(engine_of_model[m]), lat, t)
            occ = sim.occupancies()
            for j, e in enumerate(engines):
                stats.peak_occupancy[e] = max(stats.peak_occupancy[e],
                                              int(occ[j]))
            need_mask[:] = False

            # 5b. overload shedding/downgrading: the policy ranks in-service
            #     requests on any engine past its occupancy target by
            #     goodput-per-token and trims the excess; freed slots can
            #     absorb queued arrivals in the next pass of this loop
            if pol.max_occupancy is not None:
                for j, e in enumerate(engines):
                    if occ[j] <= pol.max_occupancy:
                        continue
                    # recompute per engine: a shed on an earlier engine
                    # freed its slot (slot_owner/stage_model reset), and a
                    # stale mask would resurrect it into this engine's jobs
                    insvc = (slot_owner >= 0) & (stage_model >= 0)
                    on_e = insvc.copy()
                    on_e[insvc] = engine_of_model[stage_model[insvc]] == j
                    jobs = [
                        (int(slot), int(u[slot]), float(elapsed_cost[slot]),
                         t - arrivals[slot_owner[slot]])
                        for slot in np.nonzero(on_e)[0]
                    ]
                    for slot, action in pol.overload_actions(
                            e, jobs, downgraded):
                        if action == "downgrade":
                            if not downgraded[slot]:
                                downgraded[slot] = True
                                stats.downgraded += 1
                        else:
                            shed(int(slot_owner[slot]), slot, t)

            if free_mask.any() and pending:
                continue
            # preemption can still make progress with zero free slots: a
            # queued higher-class request vs a lower-weight in-flight stage
            if preemptable():
                continue
            break

    results = []
    for i in range(B):
        lat = float(stats.done_t[i] - stats.arrival_t[i])
        slo = bool(np.isfinite(cap_req[i])) and lat > cap_req[i] + 1e-9
        results.append(ExecutionResult(
            success=bool(success[i]),
            total_cost=float(total_cost[i]),
            total_lat=lat,
            models=models[i],
            n_stages=len(models[i]),
            replan_overhead_s=float(overhead[i]),
            slo_violated=bool(slo),
            outcome=stats.outcome[i],
        ))
    return results, stats
