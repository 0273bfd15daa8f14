"""Device circuit breaker: retry with backoff, then route host-only.

Wraps every governed device dispatch (the whole-graph ``TorchGM`` matcher
and its ``bitmm`` kernel, the ``intersect`` and resident
``gather_intersect`` / ``expand_pairs`` CUDA kernel calls) behind one
:class:`CircuitBreaker`.  Only :class:`TransientError` exceptions (injected faults)
are retried and counted as failures; any other exception, such as a CUDA
error, propagates unchanged, so no device fault is hidden by the host
fallback.

* **closed** — dispatches flow through.  A failing call is retried in
  place with capped exponential backoff plus deterministic jitter (seeded
  RNG, so tests replay); after the in-call retries are spent the call
  raises :class:`DeviceFailure` and the caller recomputes on the host.
* **open** — after ``failure_threshold`` *consecutive* failed calls the
  breaker refuses dispatches outright (:class:`BreakerOpen`, raised before
  the device is touched), so a wedged or crashing device stops costing
  timeouts.  Callers treat it exactly like ``DeviceFailure``: host
  fallback.
* **half-open** — once ``reset_after_s`` (monotonic) has passed, exactly
  one probe call is let through.  Success closes the breaker; failure
  re-opens it and restarts the window.

The breaker is cross-query state: one per :class:`Engine` (bound to its
metrics registry as the ``engine_breaker_state`` gauge — 0 closed,
1 half-open, 2 open — and the ``engine_device_retries`` counter).  The
clock and sleep are injectable so chaos tests drive state transitions
without real waiting.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

from . import faults
from .errors import BreakerOpen, DeviceFailure, TransientError

__all__ = ["CircuitBreaker", "CLOSED", "HALF_OPEN", "OPEN", "STATE_VALUES"]

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"
# gauge encoding (engine_breaker_state)
STATE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(self, *, failure_threshold: int = 3,
                 reset_after_s: float = 30.0, max_retries: int = 2,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 jitter: float = 0.25, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.jitter = jitter
        self.clock = clock
        self.sleep = sleep
        self._rng = random.Random(seed)
        self.state = CLOSED
        self.consecutive_failures = 0
        self.retries = 0                  # total in-call retry attempts
        self.opened = 0                   # open transitions (observability)
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        self._gauge = None
        self._retry_counter = None
        self._recorder = None

    # -------------------------------------------------------------- metrics
    def bind_metrics(self, registry, prefix: str = "engine_"
                     ) -> "CircuitBreaker":
        """Mirror state/retries into ``<prefix>breaker_state`` (gauge) and
        ``<prefix>device_retries`` (counter) of ``registry``."""
        self._gauge = registry.gauge(prefix + "breaker_state")
        self._gauge.set(STATE_VALUES[self.state])
        self._retry_counter = registry.counter(prefix + "device_retries")
        return self

    def bind_recorder(self, recorder) -> "CircuitBreaker":
        """Land every state transition in a flight recorder
        (:class:`repro_torch.obs.flight.FlightRecorder`) as a
        ``BreakerEvent``; a transition to ``open`` additionally triggers
        the recorder's armed incident auto-dump — the ring buffer at that
        moment holds exactly the requests that led up to the trip."""
        self._recorder = recorder
        return self

    def _set_state(self, state: str) -> None:
        old = self.state
        self.state = state
        if self._gauge is not None:
            self._gauge.set(STATE_VALUES[state])
        if self._recorder is not None and old != state:
            from ..obs.events import BreakerEvent
            self._recorder.record(BreakerEvent(
                old_state=old, new_state=state,
                consecutive_failures=self.consecutive_failures))
            if state == OPEN:
                self._recorder.maybe_autodump("breaker_open")

    # ------------------------------------------------------------ state API
    def allow(self) -> bool:
        """Would a dispatch be admitted right now?  Transitions
        open -> half-open when the reset window has passed (the next
        :meth:`call` becomes the probe)."""
        if self.state == OPEN:
            if (self._opened_at is not None
                    and self.clock() - self._opened_at >= self.reset_after_s):
                self._set_state(HALF_OPEN)
                self._probe_inflight = False
            else:
                return False
        if self.state == HALF_OPEN and self._probe_inflight:
            return False
        return True

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._probe_inflight = False
        if self.state != CLOSED:
            self._set_state(CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        probe_failed = self.state == HALF_OPEN
        self._probe_inflight = False
        if (probe_failed
                or self.consecutive_failures >= self.failure_threshold):
            if self.state != OPEN:
                self.opened += 1
            self._set_state(OPEN)
            self._opened_at = self.clock()

    # ------------------------------------------------------------- dispatch
    def _backoff_s(self, attempt: int) -> float:
        base = min(self.backoff_cap_s, self.backoff_base_s * (2 ** attempt))
        return base * (1.0 + self.jitter * self._rng.random())

    def call(self, fn: Callable[[], object], *,
             site: str = "device_dispatch", budget=None):
        """Run one governed device dispatch.

        Raises :class:`BreakerOpen` without touching the device when the
        breaker is open (and no probe is due); otherwise runs ``fn`` with
        up to ``max_retries`` in-place retries (capped exponential backoff
        + jitter, never sleeping past the budget's deadline) and raises
        :class:`DeviceFailure` when all attempts fail.  The named fault
        site fires once per attempt, so injected faults exercise exactly
        this retry/breaker path.
        """
        if not self.allow():
            raise BreakerOpen(
                f"device breaker open ({self.consecutive_failures} "
                f"consecutive failures); host-only until a probe succeeds")
        if self.state == HALF_OPEN:
            self._probe_inflight = True
        attempts = 1 if self.state == HALF_OPEN else 1 + self.max_retries
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            if attempt > 0:
                self.retries += 1
                if self._retry_counter is not None:
                    self._retry_counter.inc()
                delay = self._backoff_s(attempt - 1)
                if budget is not None:
                    rem = budget.remaining_s()
                    if rem is not None:
                        if rem <= 0:
                            break             # deadline gone: stop retrying
                        delay = min(delay, rem)
                self.sleep(delay)
            try:
                faults.maybe_fail(site)
                out = fn()
            except TransientError as e:       # retryable failures only: a
                last = e                      # CUDA error propagates as-is
                self.record_failure()
                if self.state == OPEN:
                    break
                continue
            self.record_success()
            return out
        raise DeviceFailure(
            f"device dispatch failed after {attempts} attempt(s): "
            f"{type(last).__name__}: {last}") from last
