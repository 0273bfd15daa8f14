"""Typed error taxonomy for resource-governed execution.

Every failure mode the engine can surface has one exception class with a
stable ``status`` string, so callers (and the serving layer) branch on
semantics, not on message text:

===================  ====================  =====================================
class                status                meaning / recovery
===================  ====================  =====================================
DeadlineExceeded     deadline_exceeded     budget deadline hit; the partial
                                           prefix already enumerated is valid
ResourceExhausted    resource_exhausted    a memory cap was blown before any
                                           degradation could absorb it
DeviceFailure        device_failure        device dispatch failed after
                                           retries; recompute on host
BreakerOpen          breaker_open          circuit breaker is open — the
                                           device is not even attempted
InjectedFault        injected_fault        deterministic chaos-test fault
                                           (``repro_torch.robust.faults``)
AdmissionError       rejected              refused at submit (admission
                                           control / backpressure)
===================  ====================  =====================================

``TransientError`` marks the retryable subset: recovery is *recompute* (the
RIG is runtime state, never persisted — the paper's key property), so a
bounded re-attempt is always safe.  ``DeadlineExceeded`` and
``ResourceExhausted`` are deliberately **not** transient: retrying cannot
beat the same deadline or fit the same cap.
"""

from __future__ import annotations

__all__ = ["QueryError", "DeadlineExceeded", "ResourceExhausted",
           "TransientError", "DeviceFailure", "BreakerOpen",
           "InjectedFault", "AdmissionError"]


class QueryError(Exception):
    """Base of every typed execution error; ``status`` is the stable
    machine-readable discriminator mirrored into ``EngineStats.status``."""

    status = "error"


class DeadlineExceeded(QueryError):
    """The budget's monotonic deadline passed.  Raised only in
    ``raise_on_error`` mode; otherwise execution stops cooperatively and
    the partial result carries this status."""

    status = "deadline_exceeded"


class ResourceExhausted(QueryError):
    """A hard memory cap (e.g. ``Budget.max_rig_bytes``) was exceeded where
    no degradation step could absorb it."""

    status = "resource_exhausted"


class TransientError(QueryError):
    """Retryable failure: a bounded recompute (``Budget.max_attempts``)
    is the correct recovery."""

    status = "transient"


class DeviceFailure(TransientError):
    """A device dispatch failed after the breaker's in-call retries; the
    caller falls back to the host path."""

    status = "device_failure"


class BreakerOpen(QueryError):
    """The device circuit breaker is open: the dispatch was refused without
    touching the device (host-only routing until a half-open probe
    succeeds).  Not transient — retrying immediately would hit the same
    open breaker."""

    status = "breaker_open"


class InjectedFault(TransientError):
    """Deterministic fault fired by :mod:`repro_torch.robust.faults` at a named
    injection site."""

    status = "injected_fault"

    def __init__(self, site: str, call_no: int = 0):
        super().__init__(f"injected fault at site {site!r} (call #{call_no})")
        self.site = site
        self.call_no = call_no


class AdmissionError(QueryError):
    """Request refused at submission (queue backpressure, malformed query,
    or an already-expired budget)."""

    status = "rejected"
