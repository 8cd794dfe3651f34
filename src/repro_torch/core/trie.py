"""Execution trie (paper §3.2) in a TPU-friendly structure-of-arrays layout.

Nodes are numbered in **DFS preorder**, so the descendants of node ``u`` are
exactly the contiguous index interval ``[u, u + subtree_size[u])``.  That
single property turns the paper's "re-root at the realized prefix and search
the remaining subtrie" (§4.3) into a pair of vectorized interval comparisons
— no pointer chasing — which is what makes the controller jit/vmap-able
(DESIGN.md §2.1).

Node 0 is the root (empty prefix).  Every node at depth >= template.min_depth
is a feasible *terminating* plan p in the paper's \\mathcal{P}; internal
nodes double as partial execution prefixes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.workflow import WorkflowTemplate


@dataclasses.dataclass
class Trie:
    """Preorder structure-of-arrays workflow trie (paper §4.1): every
    node is a realized model-sequence prefix, stored so that a subtree is
    a contiguous index interval and all per-node attributes are flat
    numpy columns."""

    template: WorkflowTemplate
    # --- structure-of-arrays, all shape (n_nodes,) ---
    parent: np.ndarray          # int32, parent index; -1 for root
    depth: np.ndarray           # int32, 0 for root
    model: np.ndarray           # int32, model chosen at this node's last step; -1 for root
    subtree_size: np.ndarray    # int32, size of subtree rooted here (incl. self)
    terminal: np.ndarray        # bool, node is a feasible terminating plan
    # child lookup: children of u are contiguous in preorder but interleaved
    # with grandchildren, so we keep an explicit (n_nodes, n_models) table.
    child: np.ndarray           # int32 (n_nodes, n_models); -1 if absent

    @property
    def n_nodes(self) -> int:
        """Number of trie nodes (prefixes), root included."""
        return int(self.parent.shape[0])

    @property
    def n_models(self) -> int:
        """Number of models in the underlying workflow template."""
        return self.template.n_models

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def build(template: WorkflowTemplate) -> "Trie":
        """Enumerate the template's admissible prefixes depth-first into
        preorder SoA columns (children of a node appear in model-index
        order; a subtree is the contiguous interval
        ``[u, u + subtree_size[u])``)."""
        parent: list[int] = [-1]
        depth: list[int] = [0]
        model: list[int] = [-1]
        subtree: list[int] = [0]
        # iterative DFS preorder
        stack: list[tuple[int, int]] = [(0, 0)]  # (node, depth)
        order: list[int] = []
        max_depth = template.max_depth
        while stack:
            node, d = stack.pop()
            order.append(node)
            if d >= max_depth:
                continue
            kids = []
            for m in template.admissible(d):
                parent.append(node)
                depth.append(d + 1)
                model.append(m)
                subtree.append(0)
                kids.append((len(parent) - 1, d + 1))
            # push in reverse so children visit in model order
            stack.extend(reversed(kids))
        n = len(parent)
        parent_a = np.asarray(parent, dtype=np.int32)
        depth_a = np.asarray(depth, dtype=np.int32)
        model_a = np.asarray(model, dtype=np.int32)
        # nodes were appended in preorder already (stack DFS appends children
        # immediately after the parent is popped — but interleaving with the
        # stack means indices ARE preorder: we assign indices on *creation*,
        # which follows the parent's pop and precedes any deeper node that is
        # popped later only if it was created later. Verify + fix by
        # renumbering below to be safe.
        pre = _preorder_renumber(parent_a)
        parent_a = _apply_perm(parent_a, pre, is_index=True)
        depth_a = depth_a[np.argsort(pre)]
        model_a = model_a[np.argsort(pre)]
        # subtree sizes: reverse preorder accumulation
        size = np.ones(n, dtype=np.int32)
        for i in range(n - 1, 0, -1):
            size[parent_a[i]] += size[i]
        terminal = depth_a >= template.min_depth
        # child table
        child = np.full((n, template.n_models), -1, dtype=np.int32)
        for i in range(1, n):
            child[parent_a[i], model_a[i]] = i
        return Trie(
            template=template,
            parent=parent_a,
            depth=depth_a,
            model=model_a,
            subtree_size=size,
            terminal=terminal,
            child=child,
        )

    # ------------------------------------------------------------------
    # navigation
    # ------------------------------------------------------------------
    def node_of(self, prefix: tuple[int, ...] | list[int]) -> int:
        """Node index of a model-choice prefix (root = ())."""
        u = 0
        for m in prefix:
            u = int(self.child[u, m])
            if u < 0:
                raise KeyError(f"prefix {tuple(prefix)} not in trie")
        return u

    def path(self, node: int) -> list[int]:
        """Model ids along root -> node."""
        out: list[int] = []
        u = int(node)
        while u != 0:
            out.append(int(self.model[u]))
            u = int(self.parent[u])
        return out[::-1]

    def descendants_interval(self, u: int) -> tuple[int, int]:
        """Descendants of u (inclusive of u) = [u, u + subtree_size[u])."""
        return int(u), int(u) + int(self.subtree_size[u])

    def descendants_mask(self, u: int) -> np.ndarray:
        """Boolean (n_nodes,) mask of u's subtree (u included)."""
        lo, hi = self.descendants_interval(u)
        idx = np.arange(self.n_nodes)
        return (idx >= lo) & (idx < hi)

    def ancestors(self, node: int) -> list[int]:
        """Ancestor chain root..node inclusive (node itself last)."""
        chain = [int(node)]
        u = int(node)
        while u != 0:
            u = int(self.parent[u])
            chain.append(u)
        return chain[::-1]

    def nodes_at_depth(self, d: int) -> np.ndarray:
        """Node ids at exactly depth ``d`` (ascending)."""
        return np.nonzero(self.depth == d)[0]

    def leaves(self) -> np.ndarray:
        """Node ids with no children (subtree of size 1)."""
        return np.nonzero(self.subtree_size == 1)[0]

    # ------------------------------------------------------------------
    # sanity
    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Assert the preorder/SoA invariants (root at 0, parents before
        children, contiguous subtrees, consistent child table); raises
        AssertionError on violation — test/debug helper."""
        assert self.parent[0] == -1 and self.depth[0] == 0
        # preorder property: parent < child, descendants contiguous
        assert np.all(self.parent[1:] < np.arange(1, self.n_nodes))
        for u in range(self.n_nodes):
            lo, hi = self.descendants_interval(u)
            inside = (np.arange(self.n_nodes) >= lo) & (np.arange(self.n_nodes) < hi)
            # every node in the interval has its ancestor chain passing u
            for v in np.nonzero(inside)[0][:50]:
                assert u in self.ancestors(int(v))


def _preorder_renumber(parent: np.ndarray) -> np.ndarray:
    """Return perm[i] = preorder rank of node i (children in creation order)."""
    n = parent.shape[0]
    kids: list[list[int]] = [[] for _ in range(n)]
    for i in range(1, n):
        kids[parent[i]].append(i)
    perm = np.empty(n, dtype=np.int64)
    counter = 0
    stack = [0]
    while stack:
        u = stack.pop()
        perm[u] = counter
        counter += 1
        stack.extend(reversed(kids[u]))
    return perm


def _apply_perm(parent: np.ndarray, perm: np.ndarray, is_index: bool) -> np.ndarray:
    """Renumber a parent-pointer array under ``perm`` (old->new)."""
    n = parent.shape[0]
    inv = np.argsort(perm)
    out = np.empty_like(parent)
    for new_i in range(n):
        old_i = inv[new_i]
        p = parent[old_i]
        out[new_i] = -1 if p < 0 else perm[p]
    return out


def annotation_arrays(trie: Trie, acc: np.ndarray, cost: np.ndarray, lat: np.ndarray):
    """Bundle per-node annotations; see `TrieAnnotations`."""
    return TrieAnnotations(
        acc=np.asarray(acc, np.float64),
        cost=np.asarray(cost, np.float64),
        lat=np.asarray(lat, np.float64),
    )


@dataclasses.dataclass
class TrieAnnotations:
    """Per-node expected metrics (paper §3.3): Ā(p), C̄(p), T̄(p).

    ``acc[u]``  — expected accuracy if execution terminates at plan u.
    ``cost[u]`` — expected cumulative dollar cost (early-termination aware).
    ``lat[u]``  — conservative cumulative latency: sum over the prefix of
                  conditional per-stage latencies, *not* discounted by early
                  stopping (paper's T̄ definition).
    All three are monotone non-decreasing along root->leaf paths.
    """

    acc: np.ndarray
    cost: np.ndarray
    lat: np.ndarray

    def scaled(self, acc: float = 1.0, cost: float = 1.0,
               lat: float = 1.0) -> "TrieAnnotations":
        """A copy with each column multiplied by the given factor — the
        standard way tests and benchmarks synthesize drifted annotation
        versions for ``annotation_schedule`` swaps.  Positive factors
        preserve root->leaf monotonicity; keep the ``acc`` factor <= 1 so
        accuracies stay probabilities."""
        return TrieAnnotations(acc=self.acc * acc, cost=self.cost * cost,
                               lat=self.lat * lat)

    def check_monotone(self, trie: Trie, atol: float = 1e-9) -> bool:
        """True when acc/cost/lat are monotone non-decreasing along every
        root->node edge (within ``atol``) — the property the planner's
        pruning relies on."""
        p = trie.parent.copy()
        p[0] = 0
        ok = (
            np.all(self.acc >= self.acc[p] - atol)
            and np.all(self.cost >= self.cost[p] - atol)
            and np.all(self.lat >= self.lat[p] - atol)
        )
        return bool(ok)
