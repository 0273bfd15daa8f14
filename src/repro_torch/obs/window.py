"""Rotating sliding-window aggregation for serving telemetry.

A :class:`WindowedAggregator` turns the per-request phase timings the
engine already measures into *time-local* series: every observation lands
in the current fixed-width window (aligned to ``window_s`` boundaries of
the injected clock), and each window keeps one
:class:`~repro_torch.obs.sketch.QuantileSketch` per series plus request/error
counts.  ``summary()`` reports per-window QPS, error rate and p50/p95/p99
for every series, and a merged cut over everything retained — the merged
quantiles come from sketch merges, not re-ingestion, so they carry the
same relative-error guarantee as the per-window ones.

Unlike the cumulative :class:`~repro_torch.obs.metrics.Histogram` series
(which answer "since process start"), windows answer the serving
questions: what is p99 *right now*, did the error rate spike *this
window*.  The clock is injectable (same pattern as
:class:`repro_torch.robust.breaker.CircuitBreaker`), so rotation boundaries are
unit-testable without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

from .sketch import QuantileSketch

__all__ = ["WindowedAggregator"]


class _Window:
    """One fixed-width time slot: per-series sketches + request counts."""

    __slots__ = ("t0", "requests", "errors", "series")

    def __init__(self, t0: float):
        self.t0 = t0
        self.requests = 0
        self.errors = 0
        self.series: Dict[str, QuantileSketch] = {}


class WindowedAggregator:
    """Fixed-width rotating windows of per-series quantile sketches.

    ``observe(phases, error=...)`` records one request: each
    ``series -> seconds`` entry lands in that series' sketch of the
    current window.  Windows rotate lazily on observation/summary (no
    timer thread); at most ``n_windows`` closed windows are retained
    besides the current one.
    """

    def __init__(self, window_s: float = 10.0, n_windows: int = 6,
                 relative_accuracy: float = 0.01,
                 clock: Callable[[], float] = time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.window_s = float(window_s)
        self.n_windows = int(n_windows)
        self.relative_accuracy = relative_accuracy
        self.clock = clock
        self._lock = threading.Lock()
        self._current: Optional[_Window] = None
        self._closed: List[_Window] = []
        self.total_requests = 0            # lifetime, across rotations

    # ------------------------------------------------------------- rotation
    def _aligned(self, now: float) -> float:
        return (now // self.window_s) * self.window_s

    def _advance(self, now: float) -> _Window:
        """Rotate (under the caller's lock) so the current window covers
        ``now``.  A clock jump over several widths closes the old window
        and opens one aligned at ``now`` — intervening empty windows are
        not materialized (each window records its own ``t0``, so gaps stay
        visible in the summary)."""
        t0 = self._aligned(now)
        cur = self._current
        if cur is None:
            self._current = cur = _Window(t0)
        elif t0 > cur.t0:
            self._closed.append(cur)
            if len(self._closed) > self.n_windows:
                del self._closed[:len(self._closed) - self.n_windows]
            self._current = cur = _Window(t0)
        return cur

    # ------------------------------------------------------------ recording
    def observe(self, phases: Mapping[str, float],
                error: bool = False) -> None:
        """Record one request: ``phases`` maps series name (``"total"``,
        ``"exec"``, ...) to its measured seconds."""
        now = self.clock()
        with self._lock:
            win = self._advance(now)
            win.requests += 1
            self.total_requests += 1
            if error:
                win.errors += 1
            for name, v in phases.items():
                sk = win.series.get(name)
                if sk is None:
                    sk = win.series[name] = QuantileSketch(
                        self.relative_accuracy)
                sk.add(v)

    # -------------------------------------------------------------- summary
    def _window_dict(self, win: _Window, span_s: float) -> Dict[str, Any]:
        span_s = max(span_s, 1e-9)
        return {
            "t0": win.t0,
            "requests": win.requests,
            "errors": win.errors,
            "qps": win.requests / span_s,
            "error_rate": (win.errors / win.requests if win.requests
                           else 0.0),
            "series": {name: sk.summary()
                       for name, sk in sorted(win.series.items())},
        }

    def summary(self) -> Dict[str, Any]:
        """Per-window cuts (oldest -> newest, current window last) plus a
        ``merged`` view over everything retained.  The current window's
        QPS uses its elapsed fraction, not the full width, so a summary
        taken mid-window is not biased low."""
        now = self.clock()
        with self._lock:
            cur = self._advance(now)
            windows = [self._window_dict(w, self.window_s)
                       for w in self._closed]
            windows.append(self._window_dict(cur, now - cur.t0))
            merged_series: Dict[str, QuantileSketch] = {}
            requests = errors = 0
            for w in self._closed + [cur]:
                requests += w.requests
                errors += w.errors
                for name, sk in w.series.items():
                    tgt = merged_series.get(name)
                    if tgt is None:
                        merged_series[name] = tgt = QuantileSketch(
                            self.relative_accuracy)
                    tgt.merge(sk)
            oldest_t0 = (self._closed[0].t0 if self._closed else cur.t0)
            elapsed = max(now - oldest_t0, 1e-9)
        return {
            "window_s": self.window_s,
            "windows": windows,
            "merged": {
                "elapsed_s": elapsed,
                "requests": requests,
                "errors": errors,
                "qps": requests / elapsed,
                "error_rate": errors / requests if requests else 0.0,
                "series": {name: sk.summary()
                           for name, sk in sorted(merged_series.items())},
            },
        }

    def summary_line(self, series: str = "total") -> str:
        """One compact human line for periodic printing (the server's
        ``--stats-interval``):

            qps=42.1 err=0.0% total p50=1.1ms p95=3.0ms p99=7.2ms (n=421, 2 windows)
        """
        s = self.summary()
        m = s["merged"]
        sk = m["series"].get(series) or {}

        def ms(v: Optional[float]) -> str:
            return "-" if v is None else f"{v * 1e3:.1f}ms"

        return (f"qps={m['qps']:.1f} err={m['error_rate'] * 100:.1f}% "
                f"{series} p50={ms(sk.get('p50'))} p95={ms(sk.get('p95'))} "
                f"p99={ms(sk.get('p99'))} (n={m['requests']}, "
                f"{len(s['windows'])} windows)")

    # ------------------------------------------------------------ inspection
    def window_count(self) -> int:
        """Retained windows (closed + current, 0 before any observation)."""
        with self._lock:
            return len(self._closed) + (1 if self._current is not None
                                        else 0)

    def clear(self) -> None:
        with self._lock:
            self._current = None
            self._closed = []
            self.total_requests = 0
