# Observability subsystem: hierarchical query-lifecycle span tracing
# (trace), a process-wide metrics registry with counters / gauges /
# histograms (metrics), DDSketch-style relative-error quantile sketches
# (sketch) feeding a rotating sliding-window aggregator with per-window
# QPS / error-rate / p50-p95-p99 (window), a bounded ring-buffer flight
# recorder of structured per-request events with tail-based exemplar
# sampling and incident auto-dumps (events + flight), and exporters —
# JSON trace dumps, Prometheus-style text, and a compact terminal trace
# tree (export).  The tracer has a zero-allocation no-op path
# (NULL_TRACER) so instrumented hot paths cost nothing when profiling is
# off, and the always-on telemetry (events + windows) is bounded-memory
# by construction.
from .events import BreakerEvent, QueryEvent, ServerEvent
from .export import prometheus_text, render_trace, trace_to_json
from .flight import FlightRecorder
from .ledger import (LEDGER, Ledger, ResidentLedger, TransferLedger,
                     get_ledger)
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .sketch import QuantileSketch
from .trace import NULL_TRACER, NullTracer, Span, Tracer
from .window import WindowedAggregator

__all__ = [
    "Span", "Tracer", "NullTracer", "NULL_TRACER",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "get_registry",
    "QuantileSketch", "WindowedAggregator",
    "QueryEvent", "BreakerEvent", "ServerEvent", "FlightRecorder",
    "trace_to_json", "render_trace", "prometheus_text",
    "TransferLedger", "ResidentLedger", "Ledger", "LEDGER", "get_ledger",
]
