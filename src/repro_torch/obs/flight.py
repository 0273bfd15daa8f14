"""Bounded ring-buffer flight recorder with tail-based exemplar sampling.

A :class:`FlightRecorder` keeps the last ``capacity`` structured event
records (:mod:`repro_torch.obs.events`) in a lock-guarded ring buffer — cheap
enough to stay armed on every request — and dumps them as JSONL on demand
(:meth:`dump_jsonl`) or automatically when something goes wrong:

* **breaker open** — the engine's :class:`~repro_torch.robust.breaker
  .CircuitBreaker` is bound to the recorder; a transition to ``open``
  triggers an auto-dump (the records *leading up to* the incident are
  exactly what a ring buffer preserves);
* **deadline-rate spike** — the recorder tracks the deadline-exceeded
  fraction over the most recent ``rate_window`` query events; crossing
  ``deadline_rate_threshold`` triggers an auto-dump.  Dumps are debounced
  (``min_dump_interval_s``) so a sustained incident produces one file, not
  one per request.

**Tail-based exemplar sampling** keeps *rich* traces for exactly the
requests worth keeping: the slowest ``exemplar_k`` queries (a min-heap on
``total_s``) and every failed query (bounded separately).  The span tree is
materialized lazily — the trace provider callback runs only when an event
actually qualifies — so the common fast+successful request never pays for
trace serialization and ``profile=True`` stays opt-in.
"""

from __future__ import annotations

import heapq
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .events import EVENT_SCHEMA_VERSION, event_dict

__all__ = ["FlightRecorder"]

TraceProvider = Callable[[], Optional[Dict[str, Any]]]


class FlightRecorder:
    """Always-on bounded recorder of structured per-request events."""

    def __init__(self, capacity: int = 2048, exemplar_k: int = 8,
                 max_failed_exemplars: int = 32,
                 deadline_rate_threshold: float = 0.5,
                 rate_window: int = 32, rate_min_events: int = 16,
                 min_dump_interval_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = capacity
        self.exemplar_k = exemplar_k
        self.deadline_rate_threshold = deadline_rate_threshold
        self.rate_min_events = rate_min_events
        self.min_dump_interval_s = min_dump_interval_s
        self.clock = clock
        self._buf: "deque[Any]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        # slowest-k exemplars: min-heap of (total_s, seq, event, trace)
        self._slow: List[tuple] = []
        self._failed: "deque[tuple]" = deque(maxlen=max_failed_exemplars)
        self._recent: "deque[int]" = deque(maxlen=rate_window)
        self._recent_deadlines = 0
        self._autodump_path: Optional[str] = None
        self._last_dump_at: Optional[float] = None
        self.recorded = 0                   # lifetime events (ring overwrites)
        self.autodumps = 0
        self.last_dump_reason: Optional[str] = None

    # ------------------------------------------------------------ recording
    def record(self, event: Any) -> None:
        """Append one event (a dataclass from :mod:`repro_torch.obs.events` or a
        plain dict) to the ring buffer."""
        with self._lock:
            self._buf.append(event)
            self.recorded += 1

    def record_query(self, event: Any,
                     trace_provider: Optional[TraceProvider] = None) -> None:
        """Append one query event, apply tail-based exemplar sampling, and
        run the deadline-rate spike detector.

        ``trace_provider`` is invoked *only* when the event qualifies as an
        exemplar (slowest-k admit, or failed), so the warm path never pays
        for span-tree serialization."""
        total_s = float(getattr(event, "total_s", 0.0))
        status = getattr(event, "status", "ok")
        failed = status != "ok"
        spike = False
        with self._lock:
            self._buf.append(event)
            self.recorded += 1
            self._seq += 1
            # deadline-rate tracker: O(1) running fraction over the last
            # rate_window query events
            flag = 1 if getattr(event, "deadline_exceeded", False) else 0
            if len(self._recent) == self._recent.maxlen:
                self._recent_deadlines -= self._recent[0]
            self._recent.append(flag)
            self._recent_deadlines += flag
            if (flag and len(self._recent) >= self.rate_min_events
                    and self._recent_deadlines
                    >= self.deadline_rate_threshold * len(self._recent)):
                spike = True
            # tail-based exemplars
            if failed:
                trace = trace_provider() if trace_provider else None
                self._failed.append((total_s, self._seq, event, trace))
            elif (len(self._slow) < self.exemplar_k
                    or total_s > self._slow[0][0]):
                trace = trace_provider() if trace_provider else None
                heapq.heappush(self._slow,
                               (total_s, self._seq, event, trace))
                if len(self._slow) > self.exemplar_k:
                    heapq.heappop(self._slow)
        if spike:
            self.maybe_autodump("deadline_rate_spike")

    # ------------------------------------------------------------ inspection
    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the buffered events as dicts (oldest first)."""
        with self._lock:
            return [event_dict(e) for e in self._buf]

    def exemplars(self) -> Dict[str, List[Dict[str, Any]]]:
        """Current exemplars: ``slowest`` (descending ``total_s``) and
        ``failed`` (arrival order), each with its retained span tree."""
        with self._lock:
            slow = sorted(self._slow, key=lambda t: -t[0])
            failed = list(self._failed)
        return {
            "slowest": [{"total_s": t, "event": event_dict(e),
                         "trace": tr} for t, _, e, tr in slow],
            "failed": [{"total_s": t, "event": event_dict(e),
                        "trace": tr} for t, _, e, tr in failed],
        }

    def deadline_rate(self) -> float:
        """Deadline-exceeded fraction over the recent-events window."""
        with self._lock:
            return (self._recent_deadlines / len(self._recent)
                    if self._recent else 0.0)

    # -------------------------------------------------------------- dumping
    def dump_jsonl(self, path: str, reason: str = "manual") -> int:
        """Write a JSONL dump: one meta line, then one line per buffered
        event, then one line per exemplar.  Returns lines written."""
        events = self.events()
        ex = self.exemplars()
        with self._lock:
            meta = {
                "kind": "meta", "schema_version": EVENT_SCHEMA_VERSION,
                "reason": reason, "dumped_at": time.time(),
                "events": len(events), "recorded": self.recorded,
                "capacity": self.capacity, "autodumps": self.autodumps,
            }
            self.last_dump_reason = reason
        lines = 1 + len(events)
        with open(path, "w") as f:
            f.write(json.dumps(meta, sort_keys=True) + "\n")
            for e in events:
                f.write(json.dumps(e, sort_keys=True) + "\n")
            for group in ("slowest", "failed"):
                for item in ex[group]:
                    rec = {"kind": "exemplar", "class": group}
                    rec.update(item)
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
                    lines += 1
        return lines

    def arm_autodump(self, path: str) -> "FlightRecorder":
        """Arm incident auto-dumps to ``path`` (breaker-open transitions
        and deadline-rate spikes both write there, debounced)."""
        self._autodump_path = path
        return self

    def maybe_autodump(self, reason: str) -> bool:
        """Dump to the armed path unless within the debounce interval.
        A no-op (returns False) when no path is armed."""
        path = self._autodump_path
        if path is None:
            return False
        now = self.clock()
        with self._lock:
            if (self._last_dump_at is not None
                    and now - self._last_dump_at < self.min_dump_interval_s):
                return False
            self._last_dump_at = now
            self.autodumps += 1
        self.dump_jsonl(path, reason=reason)
        return True
