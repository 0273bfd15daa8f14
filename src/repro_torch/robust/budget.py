"""Per-query execution budget: deadline, memory caps, attempt bound.

A :class:`Budget` is a declarative *template* (safe to share, e.g. one per
server); :meth:`Budget.start` arms a private copy against the monotonic
clock for one query.  The armed copy travels with the query through
``Engine.execute`` / ``execute_stream`` / ``execute_many`` into the MJoin
generator loops and the RIG expansion, which check it **cooperatively** at
slab / level / edge boundaries:

* **deadline** — ``deadline_s`` relative seconds, armed via
  ``time.monotonic()`` (never wall clock: an NTP step must not expire or
  resurrect a query).  Enumeration loops that notice expiry stop cleanly
  and mark the partial prefix (``status="deadline_exceeded"``); phases
  with no partial result (label build, RIG expansion) raise
  :class:`~repro_torch.robust.errors.DeadlineExceeded`.  A blown deadline is
  noticed within one slab / block of work, so total latency is bounded by
  ``deadline + one slab``.
* **memory** — ``max_rig_bytes`` caps the materialized RIG adjacency
  (blown → :class:`ResourceExhausted`: the RIG is required, nothing can
  degrade).  ``max_frontier_rows`` tightens the frontier enumerator's
  level-width bound and ``max_slab_bytes`` its per-slab gather transient —
  both *degrade* (smaller slabs, then backtracking) rather than fail.
* **attempts** — ``max_attempts`` bounds recompute retries on
  :class:`TransientError` (recovery is always recompute, never state
  repair — the RIG is runtime state).

``raise_on_error=True`` switches partial-result statuses into raised typed
errors (servers usually prefer statuses; tests and strict callers the
exceptions).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .errors import DeadlineExceeded, ResourceExhausted

__all__ = ["Budget"]


@dataclass
class Budget:
    deadline_s: Optional[float] = None      # relative; armed by start()
    max_rig_bytes: Optional[int] = None     # RIG adjacency cap (hard)
    max_frontier_rows: Optional[int] = None  # frontier level cap (degrades)
    max_slab_bytes: Optional[int] = None    # per-slab gather cap (degrades)
    max_attempts: int = 1                   # transient-failure recomputes
    raise_on_error: bool = False            # typed raise vs partial status

    # --- armed runtime state (not part of the template's identity) ------
    _deadline_at: Optional[float] = field(default=None, repr=False,
                                          compare=False)
    _clock: Callable[[], float] = field(default=time.monotonic, repr=False,
                                        compare=False)
    _rig_bytes: int = field(default=0, repr=False, compare=False)

    # ------------------------------------------------------------- arming
    def start(self, clock: Optional[Callable[[], float]] = None) -> "Budget":
        """Arm a fresh copy for one query.  The template itself is never
        mutated, so one ``Budget`` can govern a whole server's traffic."""
        clk = clock or time.monotonic
        armed = Budget(deadline_s=self.deadline_s,
                       max_rig_bytes=self.max_rig_bytes,
                       max_frontier_rows=self.max_frontier_rows,
                       max_slab_bytes=self.max_slab_bytes,
                       max_attempts=self.max_attempts,
                       raise_on_error=self.raise_on_error)
        armed._clock = clk
        if self.deadline_s is not None:
            armed._deadline_at = clk() + self.deadline_s
        return armed

    @property
    def armed(self) -> bool:
        return self._deadline_at is not None

    # ------------------------------------------------------------ deadline
    def remaining_s(self) -> Optional[float]:
        """Seconds until the deadline (None when no deadline armed)."""
        if self._deadline_at is None:
            return None
        return self._deadline_at - self._clock()

    def expired(self) -> bool:
        """Cheap cooperative check: one monotonic read + compare."""
        return (self._deadline_at is not None
                and self._clock() >= self._deadline_at)

    def check_deadline(self, site: str = "") -> None:
        """Raise :class:`DeadlineExceeded` when expired — for phases that
        cannot produce a partial result (label build, RIG expansion)."""
        if self.expired():
            raise DeadlineExceeded(
                f"budget deadline ({self.deadline_s:.4g}s) exceeded"
                + (f" at {site}" if site else ""))

    # -------------------------------------------------------------- memory
    def charge_rig(self, nbytes: int, site: str = "rig") -> None:
        """Account RIG adjacency memory; raise :class:`ResourceExhausted`
        the moment the cumulative total would exceed the cap."""
        self._rig_bytes += int(nbytes)
        if (self.max_rig_bytes is not None
                and self._rig_bytes > self.max_rig_bytes):
            raise ResourceExhausted(
                f"{site}: {self._rig_bytes} bytes exceeds budget "
                f"max_rig_bytes={self.max_rig_bytes}")

    def frontier_cap(self, default: int) -> int:
        """Effective frontier level-width bound (budget tightens only)."""
        if self.max_frontier_rows is None:
            return default
        return min(default, self.max_frontier_rows)

    def slab_cap_rows(self, bytes_per_row: int) -> Optional[int]:
        """Max frontier slab rows under ``max_slab_bytes`` (None = no cap)."""
        if self.max_slab_bytes is None:
            return None
        return max(1, self.max_slab_bytes // max(1, bytes_per_row))
