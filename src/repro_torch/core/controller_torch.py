"""Batched trie controller on the device (`repro.core.controller_jax`).

The re-rooted constrained search runs for a whole batch of requests in one
`kernels.ops.trie_plan` call over the structure-of-arrays trie:

- descendants of the realized prefix ``u`` are the preorder interval
  ``[u, u + subtree_size[u])``;
- budget feasibility and the accuracy floor are elementwise masks;
- ties are broken by an exact lexicographic argmin (no epsilon-weighted
  composite key), so the device planner picks the *same* node as the host
  `select_path` — the property `core.fleet` relies on;
- ``path_models`` doubles as the first-step table: the next model on the
  path ``u -> target`` is ``path_models[target, depth[u]]``.

The replan variant is an argument, never an environment variable: "cuda"
(the kernel, the default on a CUDA device), "fused" (the plain blocked
version, the default on the CPU) or "dense" (the plain oracle).  All pick
the identical node.

The event-driven runtime plans through `ResidentPlanner`, a host mirror
of its slot state whose every replan is one `LanePlanner` round over all
capacity lanes.  A replan is bound to its operands once (`planner_builds`
counts the bindings): a resident planner binds when it is made, and an
annotation swap copies columns into its own instead of binding anew.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.controller import Objective
from repro_torch.core.trie import Trie, TrieAnnotations
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops

_BIG = 1e30

PLAN_VARIANTS = kernel_ops.TRIE_PLAN_VARIANTS


def _resolve_variant(variant: str | None, device: torch.device) -> str:
    if variant is None:
        return kernel_ops.default_plan_variant(device)
    if variant not in PLAN_VARIANTS:
        raise ValueError(f"unknown plan variant {variant!r}: {PLAN_VARIANTS}")
    if variant == "cuda" and device.type != "cuda":
        raise ValueError("plan variant 'cuda' needs a TrieDevice on a CUDA "
                         "device")
    return variant


def trie_engines(template) -> list[str]:
    """Canonical (sorted) engine order used for delay vectors everywhere a
    dense per-engine array stands in for the controller's delta_e dict."""
    return sorted({m.engine for m in template.models})


@dataclasses.dataclass
class TrieDevice:
    """Trie + annotations as device tensors (immutable during serving).

    ``path_counts[u, m]`` is the multiplicity of model m on the root->u
    path: the planner's cumulative engine delay of a node is its counts
    row against the per-model delays.  ``n_engines`` is a plain int, so
    reading it never syncs the device."""

    terminal: torch.Tensor         # (N,) float32 0/1
    depth: torch.Tensor            # (N,) float32
    acc: torch.Tensor              # (N,) float32
    cost: torch.Tensor             # (N,) float32
    lat: torch.Tensor              # (N,) float32
    subtree_size: torch.Tensor     # (N,) int32
    path_models: torch.Tensor      # (N, Dmax) int32, -1 padded
    path_counts: torch.Tensor      # (N, M) float32 path multiplicities
    engine_of_model: torch.Tensor  # (M,) int32
    n_engines: int = 0

    # annotation-version bookkeeping (online estimator refresh): plain
    # class attributes, not dataclass fields, which instances published by
    # `TrieAnnotator.publish` override per object
    version = 0           # 0 = unversioned (built outside the annotator)
    superseded_by = None  # version that replaced this device's annotations

    @property
    def device(self) -> torch.device:
        """The device every column lies on."""
        return self.terminal.device

    def columns(self) -> tuple:
        """The nine device columns, in `TrieDevice` field order."""
        return (self.terminal, self.depth, self.acc, self.cost, self.lat,
                self.subtree_size, self.path_models, self.path_counts,
                self.engine_of_model)

    def check_live(self) -> None:
        """Raise a descriptive error once a newer published version has
        superseded this device's annotations (`supersede`), so a stale
        holder fails with the version API spelled out instead of planning
        on old annotations."""
        if self.superseded_by is not None:
            raise RuntimeError(
                f"TrieDevice annotation columns (version {self.version}) "
                f"were superseded by version {self.superseded_by} when "
                "the online annotator published a refresh.  Use the "
                "TrieDevice returned by TrieAnnotator.publish() — and "
                "hand it to ResidentPlanner.swap_device(new_td) — "
                "instead of a superseded version.")

    def supersede(self, new_version: int) -> None:
        """Mark this device's annotations as replaced by ``new_version``:
        every later `check_live` raises.  The columns themselves stay
        allocated (torch has no buffer donation); the structural columns
        are shared across versions."""
        self.superseded_by = new_version

    @staticmethod
    def build(trie: Trie, ann: TrieAnnotations,
              restrict_nodes: np.ndarray | None = None, *,
              device: str | torch.device = "cuda") -> "TrieDevice":
        """Stage the trie + annotations into float32 device columns,
        optionally restricting the terminal set to ``restrict_nodes`` — one
        upload reused by every plan."""
        dev = resolve_device(device)
        terminal = trie.terminal.copy()
        if restrict_nodes is not None:
            keep = np.zeros(trie.n_nodes, dtype=bool)
            keep[restrict_nodes] = True
            terminal &= keep
        engines = trie_engines(trie.template)
        eidx = {e: i for i, e in enumerate(engines)}
        eom = np.array([eidx[m.engine] for m in trie.template.models],
                       dtype=np.int32)
        n = trie.n_nodes
        dmax = trie.template.max_depth
        # parent-pointer fill, one vectorized pass per depth level: each
        # level copies its parents' path prefixes/counts and appends its own
        # edge
        pm = np.full((n, dmax), -1, dtype=np.int32)
        counts = np.zeros((n, trie.template.n_models), dtype=np.float32)
        for d in range(1, int(trie.depth.max()) + 1):
            nodes = np.nonzero(trie.depth == d)[0]
            par = trie.parent[nodes]
            if d > 1:
                pm[nodes, : d - 1] = pm[par, : d - 1]
                counts[nodes] = counts[par]
            pm[nodes, d - 1] = trie.model[nodes]
            counts[nodes, trie.model[nodes]] += 1.0

        def col(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

        return TrieDevice(
            terminal=col(terminal, np.float32),
            depth=col(trie.depth, np.float32),
            acc=col(ann.acc, np.float32),
            cost=col(ann.cost, np.float32),
            lat=col(ann.lat, np.float32),
            subtree_size=col(trie.subtree_size, np.int32),
            path_models=col(pm, np.int32),
            path_counts=col(counts, np.float32),
            engine_of_model=col(eom, np.int32),
            n_engines=int(eom.max()) + 1,
        )


def _objective_scalars(obj: Objective):
    """(acc_floor + margin, cost_cap, lat_cap) rounded to float32; absent
    caps become the planner's BIG sentinel."""
    f = np.float32
    acc_floor = f((obj.acc_floor if obj.acc_floor is not None else -1.0)
                  + obj.acc_margin)
    cost_cap = f(obj.cost_cap if obj.cost_cap is not None else _BIG)
    lat_cap = f(obj.lat_cap if obj.lat_cap is not None else _BIG)
    return float(acc_floor), float(cost_cap), float(lat_cap)


_BUILDS = 0  # LanePlanner bindings made in this process


def planner_builds() -> int:
    """Bound replans made in this process, over every `LanePlanner`.

    A binding checks the operands and fixes the launch plan once for a
    (lanes, engines, blocked or not) shape; every later round of that
    shape reuses it.  The event-driven runtime's planner
    (`ResidentPlanner`) binds both of its layouts when it is made and
    swaps annotations by copying columns, so within a run, annotation
    swaps and refreshes included, this count stays flat."""
    return _BUILDS


class LanePlanner:
    """The launch path of one replan: host lane state in, (2, B) plan out.

    A call packs the lane operands into one reused host buffer (pinned
    when the trie lies on a CUDA device) as contiguous column blocks:
    prefixes int32, elapsed latency float32, the (B, E) delays float32
    and, when given, the blocked column.  One copy takes the buffer to one
    device buffer whose slices the replan reads, and the replan writes
    (targets, next_models) into the rows of one (2, B) int32 tensor, so a
    fleet round costs one copy in, the kernel and one copy out.  The copy
    in returns when it is done, so the next call may refill the host
    buffer at once (a non-blocking one would need an event to guard the
    buffer, for a copy of a few hundred bytes).  Elapsed cost is accepted
    and not uploaded (the cost budget is expectation-based: no variant
    reads it), and "no blocked column" is a null column, not a fill.  The
    slices and the bound replan (`ops.bind_trie_plan`) are made once for
    each (B, E, blocked or not) and reused, so a round runs few host
    calls."""

    def __init__(self, td: TrieDevice, obj: Objective,
                 variant: str | None = None):
        self.td = td
        self.kind = obj.kind
        self.scalars = _objective_scalars(obj)
        self.variant = _resolve_variant(variant, td.device)
        self._pinned = td.device.type == "cuda"
        self._host = self._dev = None
        self._layouts: dict = {}

    def _layout(self, b: int, e: int, blocked: bool):
        """(host words as numpy, host slice, device slice, the bound
        replan) for this shape."""
        global _BUILDS
        key = (b, e, blocked)
        if key in self._layouts:
            return self._layouts[key]
        _BUILDS += 1
        n = self.td.terminal.shape[0]
        words = b * (2 + e) + (n if blocked else 0)
        if self._host is None or self._host.numel() < words:
            cap = max(words, 4096)
            self._host = torch.empty(cap, dtype=torch.int32,
                                     pin_memory=self._pinned)
            self._dev = torch.empty(cap, dtype=torch.int32,
                                    device=self.td.device) \
                if self._pinned else self._host
            self._layouts.clear()
        f = self._dev[b:words].view(torch.float32)
        td = self.td
        launch = kernel_ops.bind_trie_plan(
            td.terminal, td.depth, td.acc, td.cost, td.lat, td.subtree_size,
            td.path_models, td.path_counts, td.engine_of_model,
            self._dev[:b], f[:b], f[b:b * (1 + e)].view(b, e), *self.scalars,
            kind=self.kind, variant=self.variant,
            blocked_depth=f[b * (1 + e):] if blocked else None)
        lay = (self._host.numpy()[:words], self._host[:words],
               self._dev[:words], launch)
        self._layouts[key] = lay
        return lay

    def __call__(self, prefixes, elapsed_lat, elapsed_cost, delays,
                 blocked=None):
        """(2, B) int32 tensor on the trie's device whose rows are the
        targets and the next models (it unpacks as that pair) of B lanes
        at ``prefixes`` with ``elapsed_lat`` spent and live ``delays``,
        (B, E) or one (E,) row every lane shares; ``blocked``, a node
        column, masks nodes whose path meets a down engine."""
        del elapsed_cost  # cost budgets are expectation-based
        n = self.td.terminal.shape[0]
        prefixes = np.asarray(prefixes)
        delays = np.asarray(delays)
        b = prefixes.shape[0]
        if prefixes.ndim != 1 or delays.shape[:-1] not in ((b,), ()) or \
                (b and (prefixes.min() < 0 or prefixes.max() >= n)):
            raise ValueError(f"prefix nodes must lie in [0, {n}), one a lane")
        return self.round(prefixes, elapsed_lat, delays, blocked)

    def round(self, prefixes, elapsed_lat, delays, blocked=None):
        """`__call__` without its checks, for a caller that keeps its
        lanes valid (`ResidentPlanner`)."""
        b, e = prefixes.shape[0], delays.shape[-1]
        h, host, dev, launch = self._layout(b, e, blocked is not None)
        f = h.view(np.float32)
        h[:b] = prefixes
        f[b:2 * b] = elapsed_lat
        f[2 * b:b * (2 + e)].reshape(b, e)[:] = delays
        if blocked is not None:
            f[b * (2 + e):] = blocked
        if self._pinned:
            dev.copy_(host)
        out = torch.empty((2, b), dtype=torch.int32, device=self.td.device)
        launch(out)
        return out


def make_batched_planner(td: TrieDevice, obj: Objective,
                         variant: str | None = None):
    """Returns plan(prefixes, elapsed_lat, elapsed_cost, engine_delays) ->
    best terminating node per request ((B,) int32 tensor on the device, -1
    infeasible), with one shared (E,) engine-delay vector."""
    planner = LanePlanner(td, obj, variant)

    def plan(prefixes, elapsed_lat, elapsed_cost, engine_delays,
             blocked=None):
        return planner(prefixes, elapsed_lat, elapsed_cost, engine_delays,
                       blocked)[0]

    return plan


def make_fleet_planner(td: TrieDevice, obj: Objective,
                       variant: str | None = None) -> LanePlanner:
    """The fleet runtime's one-call-per-round replanner: step(prefixes,
    elapsed_lat, elapsed_cost, engine_delays) -> one (2, B) int32 tensor
    on the device whose rows are the targets and the next models
    (`LanePlanner`): it unpacks as the pair and comes back in one copy.
    ``engine_delays`` has shape (B, E), one live delay vector per request;
    inputs are host arrays.  ``elapsed_cost`` is accepted and not read."""
    return LanePlanner(td, obj, variant)


def make_admission_probe(td: TrieDevice, obj: Objective,
                         variant: str | None = None):
    """Batched admission-feasibility probe for the load-shedding layer.

    Returns feasible(prefixes, elapsed_lat, elapsed_cost, engine_delays,
    blocked=None) -> (B,) bool numpy array: True where at least one
    terminating plan in the request's remaining subtrie fits its
    remaining budgets under the live (B, E) per-engine delays.  This is
    ``targets >= 0`` of one `LanePlanner` round, the fleet planner's own
    launch path; the event-driven runtime gets the same answer from its
    resident planner's lanes, and this wrapper serves external gates."""
    planner = LanePlanner(td, obj, variant)

    def feasible(prefixes, elapsed_lat, elapsed_cost, engine_delays,
                 blocked=None):
        if blocked is not None:
            blocked = np.asarray(blocked, dtype=np.float32)
        tgt = planner(np.asarray(prefixes, dtype=np.int32),
                      np.asarray(elapsed_lat, dtype=np.float32),
                      elapsed_cost,
                      np.asarray(engine_delays, dtype=np.float32),
                      blocked)[0]
        return tgt.cpu().numpy() >= 0

    return feasible


class ResidentPlanner:
    """Fleet replanner of the event-driven runtime (`core.events`).

    The event loop holds the authoritative per-slot control state on the
    host and mirrors the lanes each event touches into this planner with
    `update`; `replan` then plans every capacity lane at once.  The slot
    state (prefix int32, elapsed latency and cost float32, ``capacity``
    lanes) is a host mirror, so a replan is one `LanePlanner` round: the
    C lanes and the delay row, broadcast on the host, go to the device in
    one copy, the replan runs once, and the (2, C) plan comes back in one
    copy.  Lanes not updated since their last replan keep their old
    values; the loop reads only lanes it just updated, so that is never
    observable, and the lanes it reads hold exactly what `repro`'s
    scattered device buffers hold, since both receive the same updates.

    Per-slot deadlines (priority classes) ride on the lanes: ``lat_cap``
    overrides the objective's latency cap with the *largest* class
    deadline, and the caller shifts each lane's elapsed latency by
    ``lat_cap - class_deadline`` (``-inf`` for deadline-free classes), so
    the replan's ``d_lat <= lat_cap - elapsed`` test holds every lane to
    its own deadline.

    The planner owns copies of the acc, cost and lat columns and binds its
    two layouts (with and without the blocked column) to them when it is
    made, so no replan binds.  `swap_device` copies a re-annotated
    device's acc/cost/lat into those columns, so a swap binds nothing
    either (`planner_builds`).
    ``mesh`` (lane-sharded planning across devices) is not ported yet.
    """

    def __init__(self, td: TrieDevice, obj: Objective, capacity: int,
                 variant: str | None = None, lat_cap: float | None = None,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "lane-sharded resident planning (mesh=) is not ported yet: "
                "ROADMAP.md queue 1 item 6")
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if lat_cap is not None:
            obj = dataclasses.replace(obj, lat_cap=float(lat_cap))
        self._td = td
        own = dataclasses.replace(td, acc=td.acc.clone(),
                                  cost=td.cost.clone(), lat=td.lat.clone())
        self._lanes = LanePlanner(own, obj, variant)
        # the blocked layout first: it sizes the shared lane buffer, so
        # binding the unblocked one after it never reallocates
        self._lanes._layout(self.capacity, td.n_engines, True)
        self._lanes._layout(self.capacity, td.n_engines, False)
        self.variant = self._lanes.variant
        self._scalars = self._lanes.scalars
        self._n_engines = td.n_engines
        self._n = td.terminal.shape[0]
        self._materialize()

    def _materialize(self) -> None:
        c = self.capacity
        self._u = np.zeros(c, dtype=np.int32)
        self._el = np.zeros(c, dtype=np.float32)
        self._ec = np.zeros(c, dtype=np.float32)

    def _check_live(self) -> None:
        self._td.check_live()  # superseded annotation versions fail loudly

    def reset(self) -> None:
        """Zero every slot lane (the loop re-mirrors each lane it reads
        before reading it, so serving resumes correctly)."""
        self._materialize()

    @property
    def device_version(self) -> int:
        """Annotation version of the trie device currently planned
        against (0 when the device was built outside the annotator)."""
        return self._td.version

    @property
    def scalars(self):
        """The objective scalars ``(acc_floor, cost_cap, lat_cap)``
        (float32 values) every replan is fed — under per-class deadline
        serving ``lat_cap`` is the largest finite class cap.  Host-side
        guards (the exploration lane's float32 feasibility check in
        `core.events`) read these to reproduce the device arithmetic."""
        return self._scalars

    def swap_device(self, td: TrieDevice) -> TrieDevice:
        """Swap in a re-annotated `TrieDevice` (online estimator refresh).

        The new device must have the identical column structure (same
        trie, annotations only: shapes, dtypes, device); its acc, cost
        and lat are copied into the columns the bound launch reads, so
        the swap binds nothing new.  Returns the device swapped out."""
        old_sig = [(tuple(c.shape), c.dtype, c.device)
                   for c in self._td.columns()]
        new_sig = [(tuple(c.shape), c.dtype, c.device) for c in td.columns()]
        if old_sig != new_sig or td.n_engines != self._td.n_engines:
            raise ValueError(
                "swap_device requires a TrieDevice with the identical "
                "column structure (same trie, annotations only) — a "
                f"structure change would need a new binding. got {new_sig} "
                f"/ {td.n_engines} engines, expected {old_sig} / "
                f"{self._td.n_engines} engines")
        td.check_live()
        old = self._td
        self._td = td
        own = self._lanes.td
        own.acc.copy_(td.acc)
        own.cost.copy_(td.cost)
        own.lat.copy_(td.lat)
        return old

    def update(self, slots, u_vals, el_vals, ec_vals) -> None:
        """Mirror host-side state for ``slots`` into the slot lanes."""
        self._check_live()
        slots, u_vals = np.asarray(slots), np.asarray(u_vals)
        if slots.size and (slots.min() < 0 or slots.max() >= self.capacity
                           or u_vals.min() < 0 or u_vals.max() >= self._n):
            raise ValueError(f"slots must lie in [0, {self.capacity}) and "
                             f"prefixes in [0, {self._n})")
        self._u[slots] = u_vals
        self._el[slots] = el_vals
        self._ec[slots] = ec_vals

    def update_loads(self, slots, engine_ids, weights) -> None:
        """Lane-to-engine occupancy columns of the sharded planner."""
        raise NotImplementedError(
            "update_loads needs the lane-sharded planner (mesh=), which "
            "is not ported yet: ROADMAP.md queue 1 item 6")

    def replan(self, delay_row,
               blocked=None) -> tuple[np.ndarray, np.ndarray]:
        """One replan over all capacity lanes; returns host (targets,
        next_models), each (C,) int32.  ``delay_row`` is the (E,) shared
        delta_e vector for this instant; ``blocked`` is the (N,)
        ``blocked_depth`` availability column (None = every engine up)."""
        self._check_live()
        row = np.asarray(delay_row, dtype=np.float32)
        if row.shape != (self._n_engines,):
            raise ValueError(f"delay_row shape {row.shape} != "
                             f"({self._n_engines},)")
        if blocked is not None:
            blocked = np.asarray(blocked, dtype=np.float32)
        tgt, nxt = self._lanes.round(self._u, self._el, row,
                                     blocked).cpu().numpy()
        return tgt, nxt

    def replan_coupled(self, conc, ms, hasm, blocked=None):
        """Load-coupled replan of the sharded planner."""
        raise NotImplementedError(
            "replan_coupled needs the lane-sharded planner (mesh=), which "
            "is not ported yet: ROADMAP.md queue 1 item 6")


def make_resident_planner(td: TrieDevice, obj: Objective, capacity: int,
                          variant: str | None = None,
                          lat_cap: float | None = None,
                          mesh=None) -> ResidentPlanner:
    """Resident fleet replanner for the event-driven runtime.

    ``lat_cap`` overrides the objective's latency cap with the effective
    (largest) per-class deadline so priority classes can express per-slot
    deadlines through elapsed-latency shifts — see `ResidentPlanner`.
    ``mesh`` raises: lane-sharded planning is not ported yet."""
    return ResidentPlanner(td, obj, capacity, variant, lat_cap, mesh)


def next_model_for(trie: Trie, u: int, target: int) -> int:
    """First model on the path u -> target (host-side, O(depth))."""
    if target < 0 or target == u:
        return -1
    chain = trie.ancestors(target)
    i = chain.index(u)
    return int(trie.model[chain[i + 1]])
