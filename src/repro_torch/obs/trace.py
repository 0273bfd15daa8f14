"""Hierarchical span tracing for the query lifecycle.

A :class:`Tracer` records a tree of :class:`Span`s — named, wall-clock
timed, arbitrarily nested, with structured attributes — mirroring one
query's pipeline (parse → canonicalize → plan → labels → rig → enumerate
→ materialize).  The engine creates one tracer per profiled query and the
core layers (``repro_torch.core``) accept a ``trace=`` argument so their
phases land as child spans with *measured* timestamps, not
reconstructed ones.

Two tracer flavours share one calling convention:

* :class:`Tracer` — records spans.  ``with trace.span("plan") as sp:``
  opens a child of the innermost open span; ``sp.set(backend="host")``
  attaches attributes; ``trace.add(name, duration_s=...)`` records a
  phase whose work happened elsewhere (a fused batch dispatch's per-query
  share, a lazily-finalized stream).
* :data:`NULL_TRACER` — the disabled path.  ``span()`` returns one shared
  immutable :class:`_NullSpan` singleton: no span objects, no attribute
  dicts, no timestamps are ever allocated, so un-profiled queries pay a
  few no-op method calls and nothing else.  ``Tracer.enabled`` lets hot
  loops skip even attribute construction (``if trace.enabled: ...``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER"]


class Span:
    """One timed, named node of a trace tree."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "_tracer",
                 "_duration")

    def __init__(self, name: str, tracer: Optional["Tracer"] = None,
                 t0: Optional[float] = None, t1: Optional[float] = None,
                 duration_s: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self._tracer = tracer
        self.t0 = t0
        self.t1 = t1
        self._duration = duration_s
        self.attrs: Dict[str, Any] = attrs or {}
        self.children: List["Span"] = []

    # ------------------------------------------------------- context manager
    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        if self._tracer is not None:
            self._tracer._push(self)
        return self

    def __exit__(self, exc_type=None, exc=None, tb=None) -> bool:
        self.t1 = time.perf_counter()
        if exc_type is not None:
            # a span terminated by an exception carries its cause: the
            # class name plus — for the typed QueryError taxonomy — the
            # stable status string, so failed-request exemplars and
            # error-tagged traces explain themselves
            self.attrs["error"] = exc_type.__name__
            status = getattr(exc, "status", None)
            if isinstance(status, str):
                self.attrs["status"] = status
        if self._tracer is not None:
            self._tracer._pop(self)
        return False

    # --------------------------------------------------------------- content
    @property
    def duration_s(self) -> float:
        if self._duration is not None:
            return self._duration
        if self.t0 is None:
            return 0.0
        t1 = self.t1 if self.t1 is not None else time.perf_counter()
        return t1 - self.t0

    def set(self, **attrs: Any) -> "Span":
        """Attach structured attributes; returns self for chaining."""
        self.attrs.update(attrs)
        return self

    # ------------------------------------------------------------- traversal
    def iter(self) -> Iterator["Span"]:
        """Pre-order traversal of this span and all descendants."""
        yield self
        for c in self.children:
            yield from c.iter()

    def find(self, name: str) -> Optional["Span"]:
        """First span named ``name`` in pre-order (self included)."""
        for s in self.iter():
            if s.name == name:
                return s
        return None

    def find_all(self, name: str) -> List["Span"]:
        return [s for s in self.iter() if s.name == name]

    def phase_names(self) -> List[str]:
        return [s.name for s in self.iter()]

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name,
                             "duration_s": self.duration_s}
        if self.attrs:
            d["attrs"] = {k: _jsonable(v) for k, v in self.attrs.items()}
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.2f}ms, "
                f"{len(self.children)} children)")


def _jsonable(v: Any) -> Any:
    """Coerce numpy scalars/arrays and tuples into JSON-friendly values."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class Tracer:
    """Span recorder for one traced operation (typically one query).

    Spans opened with ``with tracer.span(name):`` nest under the innermost
    open span; the first span opened becomes ``root``.  ``finish()``
    force-closes anything still open (used by lazily-finalized streams)
    and returns the root.
    """

    enabled = True

    def __init__(self, root_name: Optional[str] = None):
        self.root: Optional[Span] = None
        self._stack: List[Span] = []
        if root_name is not None:
            self.span(root_name).__enter__()

    # ------------------------------------------------------------- recording
    def span(self, name: str, **attrs: Any) -> Span:
        return Span(name, tracer=self, attrs=attrs or None)

    def add(self, name: str, duration_s: float = 0.0, **attrs: Any) -> Span:
        """Record an already-completed phase as a child of the innermost
        open span (or as a root-level child)."""
        now = time.perf_counter()
        sp = Span(name, t0=now - duration_s, t1=now, duration_s=duration_s,
                  attrs=attrs or None)
        self._attach(sp)
        return sp

    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def finish(self) -> Optional[Span]:
        """Close all open spans (innermost first) and return the root."""
        while self._stack:
            self._stack[-1].__exit__(None, None, None)
        return self.root

    # ------------------------------------------------------------- internals
    def _attach(self, sp: Span) -> None:
        if self._stack:
            self._stack[-1].children.append(sp)
        elif self.root is None:
            self.root = sp
        elif self.root is not None:
            self.root.children.append(sp)

    def _push(self, sp: Span) -> None:
        self._attach(sp)
        self._stack.append(sp)

    def _pop(self, sp: Span) -> None:
        # tolerate out-of-order exits (generator finalization): pop through
        while self._stack:
            top = self._stack.pop()
            if top is sp:
                break


class _NullSpan:
    """The shared do-nothing span.  Immutable; every :data:`NULL_TRACER`
    call returns this same object, so the disabled path never allocates."""

    __slots__ = ()
    name = ""
    attrs: Dict[str, Any] = {}
    children: tuple = ()
    t0 = t1 = None
    duration_s = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def iter(self):
        return iter(())

    def find(self, name: str) -> None:
        return None

    def find_all(self, name: str) -> list:
        return []

    def to_dict(self) -> dict:
        return {}


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: a singleton that hands out :data:`_NULL_SPAN`."""

    enabled = False
    root = None

    def span(self, name: str, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def add(self, name: str, duration_s: float = 0.0,
            **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def current(self) -> None:
        return None

    def finish(self) -> None:
        return None


NULL_TRACER = NullTracer()
