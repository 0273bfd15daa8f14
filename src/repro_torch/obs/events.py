"""Structured per-request event records for the flight recorder.

One :class:`QueryEvent` per executed request — the durable, queryable
sibling of the transient ``EngineStats`` object: canonical query key, plan
backend / enum method, phase timings, degradation-ladder steps,
budget/breaker outcomes and the typed status, all JSON-safe scalars.  The
engine emits one for every request on *all three* execution modes
(one-shot, streamed, batched), whether or not the query was profiled.

:class:`BreakerEvent` records circuit-breaker state transitions (the
recorder auto-dumps when one lands on ``open``), and :class:`ServerEvent`
records ``QueryServer`` lifecycle actions that never reach the engine —
admission rejections, journal re-dispatches, terminal give-ups.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, List

__all__ = ["EVENT_SCHEMA_VERSION", "QueryEvent", "BreakerEvent",
           "ServerEvent", "event_dict"]

EVENT_SCHEMA_VERSION = 2    # v2: ledger byte tags on QueryEvent


def event_dict(event: Any) -> Dict[str, Any]:
    """Normalize anything recordable (an event dataclass or a plain dict)
    into a JSON-ready dict with a ``kind`` discriminator."""
    if isinstance(event, dict):
        return event
    return event.to_dict()


@dataclass
class QueryEvent:
    """One executed request, as the flight recorder stores it."""

    kind: ClassVar[str] = "query"

    ts: float = field(default_factory=time.time)   # wall clock (JSONL reads)
    query_id: int = 0
    key: str = ""                  # canonical query key
    backend: str = ""              # host | device
    enum_method: str = ""
    status: str = "ok"             # stable taxonomy string
    error_type: str = ""           # exception class when status != ok
    count: int = 0
    partial: bool = False
    deadline_exceeded: bool = False
    truncated: bool = False
    overflow_fallback: bool = False
    degradations: List[str] = field(default_factory=list)
    attempts: int = 1
    streamed: bool = False
    chunks: int = 0
    shared_exec: bool = False
    plan_cache_hit: bool = False
    label_cache_hit: bool = False
    rig_nodes: int = 0
    rig_edges: int = 0
    # transfer ledger: bytes this request moved host<->device and
    # the device-resident RIG footprint it executed against (0 off-device)
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    resident_bytes: int = 0
    parse_s: float = 0.0
    plan_s: float = 0.0
    exec_s: float = 0.0
    total_s: float = 0.0

    @classmethod
    def from_stats(cls, stats: Any, key: str, count: int) -> "QueryEvent":
        """Build from one finished query's ``EngineStats``."""
        return cls(
            query_id=stats.query_id, key=key, backend=stats.backend,
            enum_method=stats.enum_method, status=stats.status,
            error_type=getattr(stats, "error_type", ""), count=count,
            partial=stats.partial, deadline_exceeded=stats.deadline_exceeded,
            truncated=stats.truncated,
            overflow_fallback=stats.overflow_fallback,
            degradations=list(stats.degradations), attempts=stats.attempts,
            streamed=stats.streamed, chunks=stats.chunks,
            shared_exec=stats.shared_exec,
            plan_cache_hit=stats.plan_cache_hit,
            label_cache_hit=stats.label_cache_hit,
            rig_nodes=stats.rig_nodes, rig_edges=stats.rig_edges,
            h2d_bytes=getattr(stats, "h2d_bytes", 0),
            d2h_bytes=getattr(stats, "d2h_bytes", 0),
            resident_bytes=getattr(stats, "resident_bytes", 0),
            parse_s=stats.parse_s, plan_s=stats.plan_s,
            exec_s=stats.exec_s, total_s=stats.total_s)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind, "ts": self.ts, "query_id": self.query_id,
            "key": self.key, "backend": self.backend,
            "enum_method": self.enum_method, "status": self.status,
            "error_type": self.error_type, "count": self.count,
            "partial": self.partial,
            "deadline_exceeded": self.deadline_exceeded,
            "truncated": self.truncated,
            "overflow_fallback": self.overflow_fallback,
            "degradations": list(self.degradations),
            "attempts": self.attempts, "streamed": self.streamed,
            "chunks": self.chunks, "shared_exec": self.shared_exec,
            "plan_cache_hit": self.plan_cache_hit,
            "label_cache_hit": self.label_cache_hit,
            "rig_nodes": self.rig_nodes, "rig_edges": self.rig_edges,
            "h2d_bytes": self.h2d_bytes, "d2h_bytes": self.d2h_bytes,
            "resident_bytes": self.resident_bytes,
            "parse_s": self.parse_s, "plan_s": self.plan_s,
            "exec_s": self.exec_s, "total_s": self.total_s,
        }


@dataclass
class BreakerEvent:
    """One circuit-breaker state transition."""

    kind: ClassVar[str] = "breaker"

    old_state: str = ""
    new_state: str = ""
    consecutive_failures: int = 0
    ts: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "ts": self.ts,
                "old_state": self.old_state, "new_state": self.new_state,
                "consecutive_failures": self.consecutive_failures}


@dataclass
class ServerEvent:
    """One ``QueryServer`` lifecycle action that bypassed the engine."""

    kind: ClassVar[str] = "server"

    action: str = ""               # reject | redispatch | failed
    rid: int = -1
    attempts: int = 0
    detail: str = ""
    ts: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "ts": self.ts, "action": self.action,
                "rid": self.rid, "attempts": self.attempts,
                "detail": self.detail}
