"""DDSketch-style streaming quantile sketch with bounded relative error.

A :class:`QuantileSketch` ingests a stream of floats and answers
``quantile(q)`` with a *relative-error* guarantee: the returned estimate is
within ``relative_accuracy`` of the exact value at the target rank, for any
value distribution and any stream order.  That property (unlike the fixed
log-buckets of :class:`~repro_torch.obs.metrics.Histogram`, whose decade buckets
can be off by 10x inside a bucket) is what makes windowed p50/p95/p99
latency series trustworthy.

Implementation is the classic logarithmic bucketing (Masson et al.,
"DDSketch: a fast and fully-mergeable quantile sketch with relative-error
guarantees", VLDB 2019): values map to bucket ``ceil(log_gamma(v))`` with
``gamma = (1+a)/(1-a)``; every value in bucket ``k`` lies in
``(gamma^(k-1), gamma^k]`` and the bucket's representative
``2*gamma^k/(gamma+1)`` is within ``a`` (relatively) of all of them.
Buckets are a sparse dict, so memory is O(distinct magnitudes) — about
``log(vmax/vmin)/log(gamma)`` entries regardless of stream length.  Zeros
and negatives get their own stores (negatives are sketched on ``-v``), so
arbitrary float streams are safe.

Sketches with the same accuracy merge losslessly (:meth:`merge`), which the
sliding-window aggregator uses to answer "p99 over the last minute" from
per-window sketches without re-ingesting anything.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

__all__ = ["QuantileSketch"]


class QuantileSketch:
    """Relative-error streaming quantiles (DDSketch bucketing, sparse)."""

    __slots__ = ("relative_accuracy", "_gamma", "_log_gamma", "_pos",
                 "_neg", "_zeros", "count", "total", "vmin", "vmax")

    def __init__(self, relative_accuracy: float = 0.01):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError("relative_accuracy must be in (0, 1), got "
                             f"{relative_accuracy}")
        self.relative_accuracy = relative_accuracy
        self._gamma = (1.0 + relative_accuracy) / (1.0 - relative_accuracy)
        self._log_gamma = math.log(self._gamma)
        self._pos: Dict[int, int] = {}     # bucket key -> count (v > 0)
        self._neg: Dict[int, int] = {}     # bucket key of -v      (v < 0)
        self._zeros = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # --------------------------------------------------------------- ingest
    def _key(self, v: float) -> int:
        return math.ceil(math.log(v) / self._log_gamma)

    def _rep(self, key: int) -> float:
        # geometric "middle" of (gamma^(k-1), gamma^k]: within
        # relative_accuracy of every value the bucket can hold
        return 2.0 * self._gamma ** key / (self._gamma + 1.0)

    def add(self, v: float, n: int = 1) -> None:
        if n <= 0 or v != v:                       # drop NaN, keep the
            return                                 # stream un-poisoned
        self.count += n
        self.total += v * n
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v > 0.0:
            k = self._key(v)
            self._pos[k] = self._pos.get(k, 0) + n
        elif v < 0.0:
            k = self._key(-v)
            self._neg[k] = self._neg.get(k, 0) + n
        else:
            self._zeros += n

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into this sketch (exact: same-bucket counts add).
        Both sketches must share one ``relative_accuracy``."""
        if other.relative_accuracy != self.relative_accuracy:
            raise ValueError(
                "cannot merge sketches with different accuracies "
                f"({self.relative_accuracy} vs {other.relative_accuracy})")
        for k, c in other._pos.items():
            self._pos[k] = self._pos.get(k, 0) + c
        for k, c in other._neg.items():
            self._neg[k] = self._neg.get(k, 0) + c
        self._zeros += other._zeros
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    # ---------------------------------------------------------------- query
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> Optional[float]:
        """Value estimate at quantile ``q`` in [0, 1], or ``None`` when
        empty.  The estimate is within ``relative_accuracy`` (relatively)
        of the exact order statistic ``sorted(xs)[floor(q * (n - 1))]``."""
        if self.count == 0:
            return None
        q = min(1.0, max(0.0, q))
        rank = q * (self.count - 1)
        cum = 0
        # negatives first, most negative first (descending magnitude key)
        for k in sorted(self._neg, reverse=True):
            cum += self._neg[k]
            if cum > rank:
                return max(-self._rep(k), self.vmin)
        cum += self._zeros
        if self._zeros and cum > rank:
            return 0.0
        for k in sorted(self._pos):
            cum += self._pos[k]
            if cum > rank:
                # clamp into the observed range: exact extremes beat the
                # bucket representative at the edges
                return min(max(self._rep(k), self.vmin), self.vmax)
        return self.vmax                   # fp rounding on rank: top bucket

    def quantiles(self, qs=(0.5, 0.95, 0.99)) -> Dict[str, Optional[float]]:
        """The standard latency cut: ``{"p50": ..., "p95": ..., "p99": ...}``
        (keys derived from ``qs``)."""
        return {f"p{100 * q:g}": self.quantile(q) for q in qs}

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "count": self.count, "sum": self.total, "mean": self.mean,
            "min": None if self.count == 0 else self.vmin,
            "max": None if self.count == 0 else self.vmax,
        }
        out.update(self.quantiles())
        return out

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"QuantileSketch(a={self.relative_accuracy}, n={self.count}, "
                f"buckets={len(self._pos) + len(self._neg)})")
