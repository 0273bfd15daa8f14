# Observability for the port's slice: hierarchical span tracing (trace), a
# metrics registry with counters / gauges / histograms (metrics) and the
# device memory & transfer ledger (ledger) that every device executor
# charges.  The tracer has a zero-allocation no-op path (NULL_TRACER), so
# instrumented hot paths cost nothing when profiling is off.
from .ledger import (LEDGER, Ledger, ResidentLedger, TransferLedger,
                     get_ledger)
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Span", "Tracer", "NullTracer", "NULL_TRACER",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "get_registry",
    "TransferLedger", "ResidentLedger", "Ledger", "LEDGER", "get_ledger",
]
