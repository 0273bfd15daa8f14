"""Process-wide metrics registry: counters, gauges, histograms with labels.

One :class:`MetricsRegistry` holds every metric of a subsystem (the module
global :data:`REGISTRY` is the process-wide default; each
:class:`~repro_torch.engine.engine.Engine` owns its own so per-engine counters
stay isolated and testable).  Metrics are keyed by ``(name, labels)`` —
``registry.counter("cache_hits", cache="plan")`` returns the same
:class:`Counter` object on every call, so hot paths can either hold the
object or go through the registry.

``snapshot()`` takes an *atomic* point-in-time copy under the registry
lock — the fix for torn reads when concurrent streams finalize while other
queries mutate shared counters (see ``EngineStats``).  Exporters
(Prometheus text, JSON) live in :mod:`repro_torch.obs.export`.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "REGISTRY", "get_registry", "metric_key", "escape_label_value"]

LabelItems = Tuple[Tuple[str, str], ...]


def escape_label_value(v: str) -> str:
    """Prometheus text-exposition escaping for label values: backslash,
    double-quote and newline must be escaped or the series line is
    unparseable (canonical query keys can contain any of them)."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def metric_key(name: str, labels: LabelItems) -> str:
    """Prometheus-style series key: ``name{k="v",...}`` (no braces when
    unlabeled); label values are exposition-escaped."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically-increasing counter (``value`` is writable only through
    the engine's backward-compatible dict view)."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: LabelItems = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def key(self) -> str:
        return metric_key(self.name, self.labels)


class Gauge:
    """Point-in-time value (set/add)."""

    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: LabelItems = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def add(self, v: float) -> None:
        self.value += v

    def key(self) -> str:
        return metric_key(self.name, self.labels)


# Default histogram buckets: log-spaced, wide enough for both sub-ms phase
# timings (seconds) and RIG/result sizes (counts).
_DEFAULT_BUCKETS = tuple(10.0 ** e for e in range(-6, 7))


class Histogram:
    """Cumulative-bucket histogram (le-style, like Prometheus)."""

    __slots__ = ("name", "labels", "buckets", "bucket_counts", "count",
                 "total", "vmin", "vmax")
    kind = "histogram"

    def __init__(self, name: str, labels: LabelItems = (),
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.labels = labels
        self.buckets = tuple(buckets) if buckets else _DEFAULT_BUCKETS
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +inf overflow
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def key(self) -> str:
        return metric_key(self.name, self.labels)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (``None`` when empty).

        Linear interpolation inside the winning cumulative bucket, with
        both bucket edges clamped to the *observed* ``[vmin, vmax]`` — so
        a single-sample histogram reports the sample itself, and the
        decade-wide default buckets can't report a value outside the data.
        For guaranteed relative error use
        :class:`repro_torch.obs.sketch.QuantileSketch`; this estimate's error is
        bounded by the bucket width."""
        if self.count == 0:
            return None
        q = min(1.0, max(0.0, q))
        rank = q * self.count
        cum = 0
        lower = self.vmin
        for i, b in enumerate(self.buckets):
            c = self.bucket_counts[i]
            if c and cum + c >= rank:
                lo = max(lower, self.vmin)
                hi = min(b, self.vmax)
                if hi < lo:
                    hi = lo
                return lo + (hi - lo) * ((rank - cum) / c)
            cum += c
            lower = b
        return self.vmax                       # +Inf overflow bucket

    def summary(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": None if self.count == 0 else self.vmin,
                "max": None if self.count == 0 else self.vmax,
                "p50": self.quantile(0.5), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Get-or-create registry of labeled metrics with atomic snapshots."""

    def __init__(self) -> None:
        self._metrics: "Dict[Tuple[str, LabelItems], Any]" = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- factories
    def _get_or_create(self, cls, name: str, labels: Dict[str, Any],
                       **kw) -> Any:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1], **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {key[0]!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels: Any) -> Histogram:
        return self._get_or_create(Histogram, name, labels, buckets=buckets)

    # ------------------------------------------------------------- inspection
    def __iter__(self) -> Iterator[Any]:
        return iter(list(self._metrics.values()))

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, Any]:
        """Atomic point-in-time copy: series key -> scalar (counter/gauge)
        or summary dict (histogram).  Taken under the registry lock, so a
        caller sees one consistent cut even while other threads mutate."""
        with self._lock:
            metrics: List[Any] = [m for m in self._metrics.values()
                                  if prefix is None
                                  or m.name.startswith(prefix)]
            out: Dict[str, Any] = {}
            for m in metrics:
                out[m.key()] = (m.summary() if isinstance(m, Histogram)
                                else m.value)
        return out

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return REGISTRY
