# The query-facing engine subsystem in front of the RIG/MJoin core: a
# textual hybrid-pattern query language (parser + pretty-printer), a
# statistics-driven planner choosing backend / simulation algorithm / check
# method per query, and an Engine facade with cross-query caches (per-graph
# reachability/interval labels, LRU plan + RIG-stats cache), batched
# execution, and observability (per-query span traces via
# ``execute(..., profile=True)``, a per-engine metrics registry, and
# ``explain()`` plan trees — see ``repro_torch.obs``).
from ..obs import (MetricsRegistry, Span, Tracer, prometheus_text,
                   render_trace)
from .cache import GraphContext, LRUCache
from .canonical import canonical_form, canonical_key
from .engine import (Engine, EngineOptions, EngineResult, EngineStats,
                     EngineStream)
from .language import QueryParseError, Vocab, fmt, parse
from .planner import DeviceCaps, Plan, Planner
from .stats import GraphStats, RigStats
from ..robust import (AdmissionError, BreakerOpen, Budget, CircuitBreaker,
                      DeadlineExceeded, DeviceFailure, InjectedFault,
                      QueryError, ResourceExhausted, TransientError)

__all__ = [
    "Engine", "EngineOptions", "EngineResult", "EngineStats", "EngineStream",
    "Vocab", "QueryParseError", "parse", "fmt",
    "canonical_form", "canonical_key",
    "Plan", "Planner", "DeviceCaps",
    "GraphStats", "RigStats", "GraphContext", "LRUCache",
    "Span", "Tracer", "MetricsRegistry",
    "render_trace", "prometheus_text",
    "Budget", "CircuitBreaker",
    "QueryError", "DeadlineExceeded", "ResourceExhausted", "TransientError",
    "DeviceFailure", "BreakerOpen", "InjectedFault", "AdmissionError",
]
