"""Constant-memory streaming statistics for million-request trace replay.

The compiled event engine (`repro.core.events_compiled`) serves arbitrarily
long request streams without materializing per-request result lists on the
host: every terminal disposition folds its latency/cost sample into a small
set of device-resident accumulators inside the traced step, and the host
drains only O(1) scalars per epoch.  Two primitives cover the summary the
benchmarks report:

- **Welford moments** (`welford_init` / `welford_update` /
  `welford_merge` / `welford_finalize`): numerically stable running
  count/mean/M2, usable both inside a traced jax computation (the update
  is pure arithmetic on three scalars) and on the host when merging
  per-epoch drains.  Mean and variance come out exact-to-rounding
  regardless of stream length — no catastrophic cancellation from the
  naive sum-of-squares form.
- **Fixed-bin quantile sketch** (`QuantileSketch`): counts over
  log-spaced latency bins chosen once up front.  The traced update is one
  `searchsorted` + scatter-add per sample; quantiles are recovered on the
  host by walking the cumulative histogram.  Accuracy is the bin
  resolution (relative error ``~ (hi/lo)**(1/bins) - 1`` inside the
  covered range, e.g. <2% for the default 512 bins over 1e-3..1e4 s),
  while memory stays a fixed ``(bins + 2,)`` vector no matter how many
  samples stream through — the property `benchmarks/trace_replay.py`
  asserts at the million-request scale.

Everything here is dependency-light numpy/jnp arithmetic; nothing imports
the serving stack.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def welford_init():
    """Zero Welford state ``(count, mean, M2)`` as plain floats."""
    return 0.0, 0.0, 0.0


def welford_update(state, x):
    """Fold one sample into Welford state; pure arithmetic, so it works
    identically on python floats, numpy scalars, and traced jax values
    (guard the update with ``jnp.where`` masks when streaming inside a
    traced step — see `repro.core.events_compiled`)."""
    count, mean, m2 = state
    count = count + 1.0
    delta = x - mean
    mean = mean + delta / count
    m2 = m2 + delta * (x - mean)
    return count, mean, m2


def welford_merge(a, b):
    """Combine two Welford states (Chan et al. parallel update): the merge
    the host uses to fold per-epoch drains into the run total."""
    ca, ma, sa = a
    cb, mb, sb = b
    if cb == 0.0:
        return a
    if ca == 0.0:
        return b
    count = ca + cb
    delta = mb - ma
    mean = ma + delta * cb / count
    m2 = sa + sb + delta * delta * ca * cb / count
    return count, mean, m2


def welford_finalize(state) -> dict:
    """``{count, mean, var, std}`` from Welford state (population var)."""
    count, mean, m2 = state
    n = float(count)
    var = float(m2) / n if n > 0 else 0.0
    return {"count": n, "mean": float(mean) if n > 0 else 0.0,
            "var": var, "std": float(np.sqrt(max(var, 0.0)))}


@dataclasses.dataclass
class QuantileSketch:
    """Log-spaced fixed-bin histogram with host-side quantile recovery.

    ``edges`` are the interior bin boundaries (ascending); counts has
    ``len(edges) + 1`` entries — sample x lands in the first bin whose
    upper edge exceeds it (``searchsorted(edges, x, side='right')``), with
    underflow in bin 0 and overflow in the last bin.  `update_indices`
    exposes the same binning for traced scatter-adds; `quantile` walks the
    cumulative counts and returns the upper edge of the bin containing the
    rank-``floor(q * total) + 1`` order statistic (a conservative — never
    underestimating — quantile within one bin of resolution).

    Sketches merge EXACTLY (`merge` / `merge_counts`) — histogram addition
    loses nothing — but only when both sides share the identical binning:
    merging counts binned over different ``lo``/``hi``/``bins`` would
    silently mis-assign every sample, so the merge path compares edges
    bit-for-bit and raises on any mismatch.
    """

    edges: np.ndarray
    counts: np.ndarray = None

    @staticmethod
    def log_spaced(lo: float = 1e-3, hi: float = 1e4,
                   bins: int = 512) -> "QuantileSketch":
        """Sketch with ``bins`` log-spaced bins over [lo, hi] seconds."""
        if not (lo > 0 and hi > lo and bins >= 2):
            raise ValueError("need 0 < lo < hi and bins >= 2")
        edges = np.logspace(np.log10(lo), np.log10(hi), bins + 1)
        return QuantileSketch(edges=edges)

    def __post_init__(self):
        self.edges = np.asarray(self.edges, dtype=np.float64)
        if self.edges.ndim != 1 or self.edges.size < 2:
            raise ValueError("edges must be a 1-d array of >= 2 boundaries")
        if np.any(np.diff(self.edges) <= 0):
            raise ValueError("edges must be strictly increasing")
        if self.counts is None:
            self.counts = np.zeros(self.edges.size + 1, dtype=np.int64)
        self.counts = np.asarray(self.counts, dtype=np.int64)
        if self.counts.shape != (self.edges.size + 1,):
            raise ValueError(f"counts shape {self.counts.shape} != "
                             f"({self.edges.size + 1},)")

    @property
    def n_bins(self) -> int:
        """Histogram length including underflow and overflow bins."""
        return int(self.counts.size)

    @property
    def total(self) -> int:
        """Total samples folded into the sketch so far."""
        return int(self.counts.sum())

    def update_indices(self, x):
        """Bin index per sample — pure ``searchsorted``, so traced jax
        callers can scatter-add with ``counts.at[idx].add(1)``."""
        return np.searchsorted(self.edges, x, side="right")

    def add(self, x) -> None:
        """Host-side fold of a batch of samples into the counts."""
        idx = self.update_indices(np.asarray(x, dtype=np.float64).ravel())
        np.add.at(self.counts, idx, 1)

    def merge_counts(self, counts, edges=None) -> None:
        """Fold a drained device histogram into this one.

        ``edges``, when provided, is the binning the drained counts were
        accumulated under and must equal this sketch's edges EXACTLY
        (bitwise) — counts binned over a different ``lo``/``hi``/``bins``
        grid cannot be re-binned and would silently corrupt every
        quantile, so a mismatch raises instead of merging."""
        counts = np.asarray(counts, dtype=np.int64)
        if edges is not None:
            edges = np.asarray(edges, dtype=np.float64)
            if edges.shape != self.edges.shape or \
                    not np.array_equal(edges, self.edges):
                raise ValueError(
                    "incompatible sketch binning: merged counts were "
                    f"accumulated over edges {_edges_desc(edges)} but this "
                    f"sketch bins over {_edges_desc(self.edges)}; sketches "
                    "only merge exactly when built with identical "
                    "lo/hi/bins")
        if counts.shape != self.counts.shape:
            raise ValueError(f"histogram shape {counts.shape} != "
                             f"{self.counts.shape}")
        self.counts = self.counts + counts

    def merge(self, other: "QuantileSketch") -> None:
        """Exact in-place merge of another sketch (identical edges only —
        raises ``ValueError`` on any binning mismatch)."""
        if not isinstance(other, QuantileSketch):
            raise TypeError(f"expected QuantileSketch, got {type(other)}")
        self.merge_counts(other.counts, edges=other.edges)

    def state(self) -> dict:
        """JSON-serializable ``{edges, counts}`` snapshot — the form the
        streaming summaries carry so per-shard drains can be re-hydrated
        with `from_state` and merged exactly."""
        return {"edges": self.edges.tolist(),
                "counts": self.counts.tolist()}

    @staticmethod
    def from_state(state: dict) -> "QuantileSketch":
        """Rebuild a sketch from a `state` snapshot."""
        return QuantileSketch(edges=np.asarray(state["edges"]),
                              counts=np.asarray(state["counts"]))

    def quantile(self, q: float) -> float:
        """Upper edge of the bin holding the q-quantile (0 <= q <= 1);
        NaN when the sketch is empty.  Overflow-bin hits return the last
        edge (the sketch's covered range was exceeded).

        The rank convention is the right-continuous inverse CDF clamped
        to the sample range: the returned edge covers order statistic
        ``min(floor(q * total) + 1, total)``.  Concretely the walk finds
        the first bin whose cumulative count strictly exceeds
        ``q * total`` (for ``q == 1``, the last non-empty bin).  This
        keeps the documented never-underestimates guarantee at the
        boundaries: ``quantile(0.0)`` is the (upper bin edge of the)
        minimum sample even when bin 0 is empty, exact-boundary ranks
        (e.g. q=0.5 over an even count) resolve to the *later* of the two
        straddling order statistics, and ``quantile(1.0)`` is the bin of
        the maximum sample."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        total = self.total
        if total == 0:
            return float("nan")
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, q * total, side="right"))
        if b >= cum.size:  # q * total == total: bin of the max sample
            b = int(np.searchsorted(cum, total, side="left"))
        return float(self.edges[min(b, self.edges.size - 1)])


def _edges_desc(edges: np.ndarray) -> str:
    """Compact human-readable description of a bin-edge vector."""
    return (f"[{edges[0]:.6g} .. {edges[-1]:.6g}] "
            f"({edges.size - 1} bins)")
