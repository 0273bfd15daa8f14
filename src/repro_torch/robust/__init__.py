# Resource-governed execution: per-query budgets (deadline / memory /
# attempts), a typed error taxonomy, a device circuit breaker with
# retry+backoff, and a deterministic fault-injection harness.  The RIG is
# runtime state (never persisted), so every recovery here is *recompute* —
# cancel, degrade, or retry — never state repair.
from . import faults
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .budget import Budget
from .errors import (AdmissionError, BreakerOpen, DeadlineExceeded,
                     DeviceFailure, InjectedFault, QueryError,
                     ResourceExhausted, TransientError)

__all__ = [
    "Budget", "CircuitBreaker", "CLOSED", "HALF_OPEN", "OPEN",
    "QueryError", "DeadlineExceeded", "ResourceExhausted", "TransientError",
    "DeviceFailure", "BreakerOpen", "InjectedFault", "AdmissionError",
    "faults",
]
