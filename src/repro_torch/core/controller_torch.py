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

`ResidentPlanner`, the admission probe and annotation versioning arrive
with the event-driven runtime.
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

    @property
    def device(self) -> torch.device:
        """The device every column lies on."""
        return self.terminal.device

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
        key = (b, e, blocked)
        if key in self._layouts:
            return self._layouts[key]
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
        at ``prefixes`` with ``elapsed_lat`` spent and (B, E) live
        ``delays``; ``blocked``, a node column, masks nodes whose path
        meets a down engine."""
        del elapsed_cost  # cost budgets are expectation-based
        n = self.td.terminal.shape[0]
        prefixes = np.asarray(prefixes)
        delays = np.asarray(delays)
        b, e = delays.shape
        if prefixes.shape != (b,) or (b and (prefixes.min() < 0 or
                                             prefixes.max() >= n)):
            raise ValueError(f"prefix nodes must lie in [0, {n}), one a lane")
        h, host, dev, launch = self._layout(b, e, blocked is not None)
        f = h.view(np.float32)
        h[:b] = prefixes
        f[b:2 * b] = elapsed_lat
        f[2 * b:b * (2 + e)] = delays.reshape(-1)
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
        b = np.asarray(prefixes).shape[0]
        row = np.asarray(engine_delays, dtype=np.float32)
        return planner(prefixes, elapsed_lat, elapsed_cost,
                       np.broadcast_to(row[None, :], (b, row.shape[0])),
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


def next_model_for(trie: Trie, u: int, target: int) -> int:
    """First model on the path u -> target (host-side, O(depth))."""
    if target < 0 or target == u:
        return -1
    chain = trie.ancestors(target)
    i = chain.index(u)
    return int(trie.model[chain[i + 1]])
