"""Fault injection and recovery for the serving runtimes (beyond-paper).

Real agentic-serving fleets lose engines (deploys, spot reclamation,
OOM-kills) and individual stage invocations (backend 5xx, timeouts).  The
paper's controller assumes a permanently healthy fleet; this module makes
the failure model a first-class, *deterministic and replayable* input to
both event engines (`repro.core.events` and its compiled twin), so the
differential-oracle methodology extends to chaos runs bit-for-bit:

- **engine outages** are scheduled ``(engine, t_down, t_up)`` intervals.
  While an engine is down the planner must not route NEW stages onto it —
  rendered as the ``blocked_depth`` node column (`blocked_depth_table`), a
  traced operand of every planner program (`kernels.ops.trie_plan`), so
  masking an engine in/out compiles ZERO new programs (the same operand-
  substitution trick as annotation swaps).  Stages in flight on the dead
  engine are checkpointed at their realized trie node (the preemption
  pause buffer) and requeued; recovery flips the mask back.
- **stage failures** are seeded per-(request, depth, attempt) coin flips
  (`failure_draws`): a pure function of ``seed``, precomputed as a table,
  so the host and compiled engines — and the oracle — consult the *same*
  draw for the same dispatch (the PR-8 exploration-lane trick).  Failed
  attempts retry with capped exponential backoff (`backoff`) charged
  against the request's latency budget; the re-root replan naturally
  routes the retry around the failure.
- **timeouts** (``timeout_k``) cancel a stage still in service at
  ``k x`` the live posterior latency forecast for that stage — the
  annotation columns already carry the forecast, so no new estimator.

A request whose retries exhaust ``max_retries``, or whose certainty bound
dies after a fault touched it, sheds with the dedicated ``"failed"``
outcome (`repro.core.admission.FAILED`) so chaos goodput accounting can
separate fault kills from ordinary load sheds.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def validate_increasing(times, what: str) -> None:
    """Raise ``ValueError`` naming the offending entries unless ``times``
    is sorted strictly increasing.

    Shared by `FaultSchedule` validation and ``run_events``'s
    ``annotation_schedule`` check: a silently misordered schedule would
    reorder swap/fault epochs and corrupt every downstream comparison."""
    ts = [float(t) for t in times]
    for a, b in zip(ts, ts[1:]):
        if not b > a:
            raise ValueError(
                f"{what} must be sorted strictly increasing: "
                f"entry {b!r} follows {a!r}")


def blocked_depth_table(path_models: np.ndarray,
                        engine_of_model: np.ndarray,
                        down_mask: np.ndarray) -> np.ndarray:
    """(N,) float32 availability mask as a node column.

    ``blocked_depth[v]`` = 1 + the deepest stage position on v's root
    path whose engine is down under ``down_mask`` ((E,) bool), 0 when
    every stage on the path runs on a live engine.  The planner admits a
    candidate ``v`` from prefix ``u`` only when ``blocked_depth[v] <=
    depth[u]`` — stages at or before the realized prefix already
    happened (checkpointed recovery keeps them), only *new* stages are
    constrained to live engines.  Values are small integers stored in
    float32, so the device compare is exact."""
    pm = np.asarray(path_models)
    eom = np.asarray(engine_of_model)
    down = np.asarray(down_mask, dtype=bool)
    valid = pm >= 0
    dead = valid & down[eom[np.maximum(pm, 0)]]
    pos = np.arange(pm.shape[1], dtype=np.int64)[None, :]
    bd = np.max(np.where(dead, pos + 1, 0), axis=1, initial=0)
    return bd.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Deterministic, replayable fault plan for one serving run.

    ``outages``
        tuple of ``(engine, t_down, t_up)`` — engine by canonical index
        or name (resolved against the trie's engine list at run start).
        Per engine the intervals must be sorted, strictly increasing and
        non-overlapping (validated at construction, offenders named).
    ``stage_failure_rate``
        per-dispatch transient-failure probability; draws are a pure
        function of ``seed`` via `failure_draws`, so every engine
        (host, compiled, oracle) sees identical failures.
    ``failure_table``
        explicit override of the seeded draws — either an
        ``(n, depth)`` integer array (entry = number of leading failed
        attempts for that (request, stage position)) or a full
        ``(n, depth, max_retries + 1)`` bool table.  The chaos
        differential lanes use this to force exact failure patterns.
    ``max_retries`` / ``backoff_base`` / ``backoff_factor`` /
    ``backoff_cap``
        a failed or timed-out attempt retries after
        ``min(base * factor**attempt, cap)`` seconds of virtual time
        (charged against the request's latency budget) until
        ``max_retries`` retries are spent; exhaustion sheds the request
        with ``outcome="failed"``.  The defaults are exact binary-grid
        values so backoff arithmetic stays on the differential oracle's
        dyadic clock.
    ``timeout_k``
        when set, a dispatched stage still in service at ``k x`` its
        live posterior latency forecast is cancelled and treated as a
        failed attempt (host loop only; the compiled engine fences it).
    ``recovery``
        ``"checkpoint"`` (default) resumes outage victims from their
        realized trie node with elapsed budgets intact;
        ``"restart"`` is the naive baseline — victims requeue from the
        trie root, keeping only their spent cost (for the chaos
        benchmark's differential; host loop only).
    """

    outages: tuple = ()
    stage_failure_rate: float = 0.0
    seed: int = 0
    max_retries: int = 2
    backoff_base: float = 0.25
    backoff_factor: float = 2.0
    backoff_cap: float = 2.0
    timeout_k: float | None = None
    recovery: str = "checkpoint"
    failure_table: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "outages",
                           tuple(tuple(o) for o in self.outages))
        for o in self.outages:
            if len(o) != 3:
                raise ValueError(
                    f"outage entries are (engine, t_down, t_up): got {o!r}")
            _, td, tu = o
            td, tu = float(td), float(tu)
            if not (np.isfinite(td) and td >= 0.0):
                raise ValueError(
                    f"outage down time must be finite and non-negative: "
                    f"got {o!r}")
            if not (tu > td):
                raise ValueError(
                    f"outage recovery must come strictly after the down "
                    f"time: got {o!r}")
            if not np.isfinite(tu):
                raise ValueError(f"outage recovery time must be finite: "
                                 f"got {o!r}")
        per_engine: dict = {}
        for o in self.outages:
            per_engine.setdefault(o[0], []).append(o)
        for e, entries in per_engine.items():
            for a, b in zip(entries, entries[1:]):
                if not float(b[1]) > float(a[2]):
                    raise ValueError(
                        f"outages for engine {e!r} must be sorted and "
                        f"non-overlapping: {b!r} follows {a!r}")
            validate_increasing((o[1] for o in entries),
                                f"outage down times for engine {e!r}")
        if not 0.0 <= float(self.stage_failure_rate) <= 1.0:
            raise ValueError(
                f"stage_failure_rate must be in [0, 1], got "
                f"{self.stage_failure_rate}")
        if int(self.max_retries) < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        for nm in ("backoff_base", "backoff_factor", "backoff_cap"):
            v = float(getattr(self, nm))
            if not (np.isfinite(v) and v >= 0.0):
                raise ValueError(
                    f"{nm} must be finite and non-negative, got {v}")
        if self.timeout_k is not None and not float(self.timeout_k) > 0.0:
            raise ValueError(
                f"timeout_k must be positive, got {self.timeout_k}")
        if self.recovery not in ("checkpoint", "restart"):
            raise ValueError(
                f"recovery must be 'checkpoint' or 'restart', got "
                f"{self.recovery!r}")
        if self.failure_table is not None:
            ft = np.asarray(self.failure_table)
            if ft.ndim not in (2, 3):
                raise ValueError(
                    f"failure_table must be (n, depth) counts or "
                    f"(n, depth, attempts) bool, got shape {ft.shape}")
            object.__setattr__(self, "failure_table", ft)

    @property
    def injects(self) -> bool:
        """Whether this schedule can inject any fault at all."""
        return bool(self.outages) or self.stage_failure_rate > 0.0 \
            or self.failure_table is not None or self.timeout_k is not None

    def events(self, engines: list) -> list:
        """Resolved fault transitions: ``[(t, engine_idx, up), ...]``
        sorted by ``(t, engine_idx, up)`` — at one timestamp downs
        process before ups, deterministically.  Engine specs given by
        name are resolved against ``engines`` (the trie's canonical
        engine order); unknown names/indices raise ``ValueError``."""
        out = []
        for e, td, tu in self.outages:
            if isinstance(e, str):
                if e not in engines:
                    raise ValueError(
                        f"outage engine {e!r} not in fleet {list(engines)}")
                ei = engines.index(e)
            else:
                ei = int(e)
                if not 0 <= ei < len(engines):
                    raise ValueError(
                        f"outage engine index {ei} out of range for "
                        f"{len(engines)} engines")
            out.append((float(td), ei, False))
            out.append((float(tu), ei, True))
        out.sort(key=lambda ev: (ev[0], ev[1], ev[2]))
        return out

    def failure_draws(self, n: int, depth: int) -> np.ndarray:
        """(n, depth, max_retries + 1) bool: whether attempt ``a`` of the
        stage at position ``d`` of request ``i`` fails at dispatch.

        A pure function of ``(seed, n, depth, max_retries)`` — every
        engine replays the identical table.  ``failure_table`` overrides
        the seeded draws (int counts mean "first c attempts fail")."""
        A = int(self.max_retries) + 1
        if self.failure_table is not None:
            ft = self.failure_table
            if ft.ndim == 3:
                if ft.shape != (n, depth, A):
                    raise ValueError(
                        f"failure_table shape {ft.shape} != "
                        f"({n}, {depth}, {A})")
                return ft.astype(bool)
            if ft.shape != (n, depth):
                raise ValueError(
                    f"failure_table shape {ft.shape} != ({n}, {depth})")
            a = np.arange(A)[None, None, :]
            return a < ft.astype(np.int64)[:, :, None]
        if self.stage_failure_rate <= 0.0:
            return np.zeros((n, depth, A), dtype=bool)
        rng = np.random.default_rng(self.seed)
        return rng.random((n, depth, A)) < float(self.stage_failure_rate)

    def backoff(self, attempt: int) -> float:
        """Virtual seconds to hold a retry after ``attempt`` aborts."""
        return float(min(self.backoff_base
                         * self.backoff_factor ** int(attempt),
                         self.backoff_cap))

    def to_state(self) -> dict:
        """JSON-safe round-trippable snapshot (`from_state` inverts)."""
        st = {
            "outages": [list(o) for o in self.outages],
            "stage_failure_rate": float(self.stage_failure_rate),
            "seed": int(self.seed),
            "max_retries": int(self.max_retries),
            "backoff_base": float(self.backoff_base),
            "backoff_factor": float(self.backoff_factor),
            "backoff_cap": float(self.backoff_cap),
            "timeout_k": None if self.timeout_k is None
            else float(self.timeout_k),
            "recovery": self.recovery,
        }
        if self.failure_table is not None:
            st["failure_table"] = self.failure_table.astype(
                np.int64 if self.failure_table.ndim == 2 else bool).tolist()
        return st

    @classmethod
    def from_state(cls, state: dict) -> "FaultSchedule":
        """Rebuild a schedule from `to_state`'s JSON-safe dict (exact
        round-trip, including the failure-table override)."""
        kw = dict(state)
        kw["outages"] = tuple(tuple(o) for o in kw.get("outages", ()))
        if kw.get("failure_table") is not None:
            kw["failure_table"] = np.asarray(kw["failure_table"])
        return cls(**kw)
