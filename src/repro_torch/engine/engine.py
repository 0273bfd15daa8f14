"""``Engine`` — the query-facing facade over the RIG/MJoin core.

Pipeline per query::

    text ──parse──▶ PatternQuery ──TR+canonicalize──▶ key
         ──plan-cache──▶ Plan (backend, sim algo, check method, ordering,
                               enum method, streaming chunk size)
         ──label-cache──▶ resident reachability/adjacency/interval labels
         ──execute──▶ host GM  or  device TorchGM
         ──execute_stream──▶ chunked lazy enumeration (host or
                             device-resident data path)
         ──execute_many──▶ per-graph groups, canonical-form dedup, one
                           batched device dispatch + one micro-batched
                           frontier scheduler per group

Cross-query state (everything the paper's per-query pipeline would
otherwise recompute):

* **label cache** — one :class:`GraphContext` per resident graph holds the
  reachability labeling, packed adjacency and DFS interval labels; built
  once, shared by every subsequent query on that graph;
* **plan / RIG-stats cache** — an LRU keyed by the canonical form of the
  transitively-reduced query; repeat queries skip planning and are
  re-planned against *observed* RIG sizes (tiny RIG -> host enumeration).

The RIG itself remains runtime state, rebuilt per query — the paper's
defining property; the engine only hoists the graph-side indexes and the
per-query *decisions* out of the hot path.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.graph import DataGraph
from ..core.matcher import GM, MatchResult, MatchStream
from ..core.mjoin import DEFAULT_LIMIT, device_intersector
from ..core.query import PatternQuery
from ..obs.events import QueryEvent
from ..obs.export import prometheus_text, render_trace
from ..obs.flight import FlightRecorder
from ..obs.ledger import get_ledger
from ..obs.metrics import MetricsRegistry
from ..obs.trace import NULL_TRACER, Span, Tracer
from ..obs.window import WindowedAggregator
from ..robust import Budget, CircuitBreaker
from ..robust.errors import (BreakerOpen, DeadlineExceeded, DeviceFailure,
                             QueryError, TransientError)
from .cache import GraphContext, LRUCache
from .canonical import canonical_key
from .language import Vocab, fmt, parse
from .planner import DEVICE, HOST, DeviceCaps, Plan, Planner
from .stats import (ESTIMATE_QUANTITIES, Calibration, EstimateRecord,
                    RigStats)

__all__ = ["EngineOptions", "EngineStats", "EngineResult", "EngineStream",
           "Engine"]

QueryLike = Union[str, PatternQuery]
RequestLike = Union[QueryLike, Tuple[QueryLike, DataGraph]]

_UNSET = object()


def _cuda_resolved() -> bool:
    """Is the device the executors resolve a CUDA card?  ``False`` on
    the tests' CPU pin; without CUDA and without a pin, resolution
    raises — nothing drops silently to the CPU."""
    from ..torchgm.frontier import resolve
    return resolve().type == "cuda"


@dataclass
class EngineOptions:
    # device matcher caps (see DeviceCaps)
    max_q: int = 8
    max_e: int = 16
    capacity: int = 4096
    device_min_nodes: int = 512
    exact_sim: bool = True             # device sim to fixpoint (host-equal)
    # engine knobs
    plan_cache_size: int = 256
    max_resident_graphs: int = 8
    force_backend: Optional[str] = None   # "host" | "device" | None
    force_enum: Optional[str] = None      # fixed enum_method | None (planned)
    # route the frontier enumerator's AND+popcount through the CUDA
    # intersect kernel: None = auto (when the resolved device is a card;
    # on the CPU pin the plain version is slower than numpy)
    frontier_device: Optional[bool] = None
    # device-memory budget for resident RIG uploads: a frontier-device
    # query whose estimated packed adjacency fits is planned as
    # frontier-device-resident (index stays on device, host ships only
    # per-level index vectors)
    resident_max_bytes: int = 1 << 30
    limit: Optional[int] = DEFAULT_LIMIT
    materialize: bool = True
    # resource governance: the default per-query Budget *template*
    # (armed per execution; None = ungoverned) and the engine's device
    # circuit breaker (None = a default CircuitBreaker; shared by every
    # device dispatch this engine issues)
    budget: Optional[Budget] = None
    breaker: Optional[CircuitBreaker] = None
    # serving telemetry: always-on per-request event records in a
    # bounded flight recorder plus windowed QPS/error-rate/quantile series.
    # ``telemetry=False`` disables recording entirely (the A/B lever for
    # the profile-smoke overhead gate; the recorder objects still exist).
    telemetry: bool = True
    flight_capacity: int = 2048
    exemplar_k: int = 8              # slowest-k full-trace exemplars
    window_s: float = 10.0           # sliding-window width (seconds)
    n_windows: int = 6               # closed windows retained

    def caps(self) -> DeviceCaps:
        fd = self.frontier_device
        if fd is None:
            fd = _cuda_resolved()
        return DeviceCaps(max_q=self.max_q, max_e=self.max_e,
                          capacity=self.capacity,
                          min_graph_nodes=self.device_min_nodes,
                          frontier_device=fd,
                          resident_max_bytes=self.resident_max_bytes)


@dataclass
class EngineStats:
    """Per-query execution record.

    ``sim_passes`` is the measured pass count on the host backend, the
    fixed pass budget on the truncated device path, and 0 (not tracked) on
    the exact-sim device path.
    """

    backend: str = HOST
    count: int = 0
    parse_s: float = 0.0
    plan_s: float = 0.0
    exec_s: float = 0.0
    total_s: float = 0.0
    plan_cache_hit: bool = False
    label_cache_hit: bool = False
    overflow_fallback: bool = False
    sim_passes: int = 0
    rig_nodes: int = 0
    rig_edges: int = 0
    truncated: bool = False
    enum_method: str = "backtrack"   # strategy that ran (device: torchgm's)
    # transfer ledger: bytes this query moved host<->device and the
    # device-resident RIG footprint it executed against (0 off-device)
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    resident_bytes: int = 0
    # resource governance: ``status`` is the stable outcome string
    # ("ok", or the error taxonomy's status — "deadline_exceeded",
    # "resource_exhausted", "transient", ...); ``partial`` marks a
    # correctly-truncated prefix result; ``degradations`` the ladder steps
    # taken (host-intersect / chunked-slabs / backtrack / host) in order;
    # ``attempts`` counts executions including transient-failure retries.
    status: str = "ok"
    error_type: str = ""             # exception class when status != "ok"
    partial: bool = False
    deadline_exceeded: bool = False
    degradations: List[str] = field(default_factory=list)
    attempts: int = 1
    # streaming (execute_stream)
    streamed: bool = False
    chunks: int = 0                  # result chunks yielded
    chunk_size: int = 0              # planned/requested chunk rows
    # batching (execute_many)
    shared_exec: bool = False        # answered by a duplicate in the batch
    # engine-wide plan-cache counters, snapshotted atomically at *prepare*
    # time — i.e. right after this query's own cache access, not when it
    # finished.  Concurrent streams finalizing out of order therefore see
    # their own consistent cut instead of whatever the cache holds later.
    query_id: int = 0
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    plan_cache_evictions: int = 0


@dataclass
class EngineResult:
    count: int
    tuples: Optional[np.ndarray]
    query: PatternQuery            # the executed (transitively-reduced) query
    plan: Plan
    stats: EngineStats
    key: str
    trace: Optional[Span] = None   # span tree when profile=True, else None


class EngineStream:
    """Lazy result stream returned by :meth:`Engine.execute_stream`.

    Iterate for ``(chunk, q.n)`` int64 ndarray chunks (global node ids,
    query-node order) in the same lexicographic order as one-shot
    ``execute``; every chunk except the last has exactly ``chunk_size``
    rows.  Enumeration advances only as chunks are consumed — stopping
    early (``close()``, or just abandoning the iterator after a ``break``)
    never visits the tail, and hitting ``limit`` cuts the final chunk at
    exactly ``limit`` rows with ``stats.truncated`` set.

    ``stats`` and ``count`` are live during iteration; when the stream is
    exhausted (or closed) the engine records timings, plan-cache counters
    and — only on natural completion — the observed RIG statistics that
    feed re-planning.
    """

    def __init__(self, engine: "Engine", entry: "_PlanEntry",
                 match: MatchStream, stats: "EngineStats",
                 query: PatternQuery, key: str, tracer=None):
        self.engine = engine
        self.match = match
        self.query = query
        self.plan = entry.plan
        self.key = key
        self.stats = stats
        self.trace: Optional[Span] = None   # set on finalize when profiled
        self._entry = entry
        self._tracer = tracer
        self._it = iter(match)
        self._finalized = False

    def __iter__(self) -> "EngineStream":
        return self

    def __next__(self):
        try:
            chunk = next(self._it)
        except StopIteration:
            self._finalize(completed=True)
            raise
        except BaseException:
            # a mid-iteration failure — an injected
            # fault, a raise-mode DeadlineExceeded, a consumer-driven
            # GeneratorExit — must still close the suspended MJoin state
            # and record stats/metrics exactly once before propagating
            self.match.close()
            self._finalize(completed=False)
            raise
        self.stats.chunks += 1
        return chunk

    def __enter__(self) -> "EngineStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop early: drops the suspended enumeration state and records
        stats for the consumed prefix (no RIG-stats observation — a
        partial count must not feed re-planning)."""
        self.match.close()
        self._finalize(completed=False)

    @property
    def count(self) -> int:
        return self.match.count

    def _finalize(self, completed: bool) -> None:
        if self._finalized:
            return
        self._finalized = True
        m = self.match
        # an early-closed stream's partial count must not feed re-planning
        self.engine._observe_host(self._entry, self.stats, m,
                                  observe=completed)
        self.stats.exec_s = m.matching_s + m.enumerate_s
        self.engine.counters["stream_queries"] += 1
        self.engine._finish(self.stats, m.count)
        tr = self._tracer
        if tr is not None and tr.enabled:
            # enumeration ran lazily across the consumer's iteration — the
            # span is synthesized from the stream's accumulated timings
            tr.add("enumerate", duration_s=m.enumerate_s,
                   method=self.stats.enum_method, results=m.count,
                   chunks=self.stats.chunks, completed=completed,
                   truncated=self.stats.truncated)
            tr.add("materialize", streamed=True, chunks=self.stats.chunks,
                   chunk_size=self.stats.chunk_size)
            self.trace = tr.finish()
        self.engine._record_event(self.stats, self.key, m.count,
                                  trace_root=self.trace)


@dataclass
class _PlanEntry:
    """One cached plan plus everything warm repeats of the query reuse:
    observed RIG statistics (re-planning), the planner's committed
    estimates with their observed reconciliation (EXPLAIN ANALYZE), the
    per-graph calibration the ratios feed, and — for resident-planned
    queries — the uploaded device executor, so repeats skip the re-upload.
    The plan cache's ``on_evict`` closes ``resident`` (crediting the
    ledger) the moment the entry leaves the cache."""

    plan: Plan
    rig: RigStats = field(default_factory=RigStats)
    est: EstimateRecord = field(default_factory=EstimateRecord)
    cal: Optional[Calibration] = None
    resident: Optional[object] = field(default=None, repr=False)


_RESIDENT_EPOCH = itertools.count()


class _Resident:
    """A registered graph: context + lazily-created matchers.

    ``epoch`` is a process-unique token used in plan-cache keys instead of
    ``id(graph)`` — a new graph allocated at a recycled address must not
    inherit an evicted graph's plans or RIG statistics.
    """

    def __init__(self, graph: DataGraph, options: EngineOptions,
                 label_names=None):
        self.ctx = GraphContext(graph)
        self.epoch = next(_RESIDENT_EPOCH)
        self.options = options
        self.vocab = Vocab.for_graph(graph, names=label_names)
        self.planner = Planner(self.ctx.stats, caps=options.caps(),
                               force_backend=options.force_backend,
                               force_enum=options.force_enum)
        self._gm: Optional[GM] = None
        self._jgm = None

    def gm(self) -> GM:
        if self._gm is None:
            self.ctx.ensure_labels()
            self._gm = GM(self.ctx.graph)
            self._gm.oracle = self.ctx.oracle     # share the label cache
            self._gm.intervals = self.ctx.intervals   # §5.5 interval path
        return self._gm

    def jgm(self):
        """The whole-graph device matcher, built on first use.  A
        construction error (no CUDA and no CPU pin, a failed kernel build,
        a CUDA error) propagates: the device is never silently replaced
        by the host."""
        if self._jgm is None:
            from ..torchgm import TorchGM
            o = self.options
            self._jgm = TorchGM(self.ctx.graph, max_q=o.max_q,
                                max_e=o.max_e, capacity=o.capacity,
                                exact_sim=o.exact_sim,
                                use_transitive_reduction=False)
        return self._jgm


_ENGINE_COUNTERS = (
    "queries", "host_exec", "device_exec", "overflow_fallbacks",
    "label_builds", "stream_queries", "shared_exec",
    "frontier_batches", "frontier_batch_dispatches",
    # resource governance; engine_device_retries and the
    # engine_breaker_state gauge are bound by the CircuitBreaker itself
    "deadline_exceeded", "budget_degradations", "transient_retries",
    # resident enumerator: uploads (cache misses), fused
    # gather+AND+popcount dispatches, and sub-threshold slabs kept on host
    "resident_uploads", "resident_dispatches", "small_frontier_host_routed",
)


class _CounterView:
    """Dict-compatible facade over the engine's registry-backed counters.

    ``Engine.counters`` predates the metrics registry; existing callers do
    ``eng.counters["queries"] += 1`` and read it like a dict.  The values
    now live in :class:`~repro_torch.obs.metrics.Counter` objects (series
    ``engine_<name>``), so registry snapshots and the Prometheus exporter
    see them — this view keeps the old surface working on top.
    """

    def __init__(self, registry: MetricsRegistry, names=_ENGINE_COUNTERS,
                 prefix: str = "engine_"):
        self._registry = registry
        self._prefix = prefix
        self._c = {n: registry.counter(prefix + n) for n in names}

    def _counter(self, key: str):
        c = self._c.get(key)
        if c is None:
            c = self._c[key] = self._registry.counter(self._prefix + key)
        return c

    def __getitem__(self, key: str) -> int:
        return self._c[key].value

    def __setitem__(self, key: str, value: int) -> None:
        self._counter(key).value = int(value)

    def __contains__(self, key) -> bool:
        return key in self._c

    def __iter__(self):
        return iter(self._c)

    def __len__(self) -> int:
        return len(self._c)

    def keys(self):
        return self._c.keys()

    def values(self):
        return [c.value for c in self._c.values()]

    def items(self):
        return [(k, c.value) for k, c in self._c.items()]

    def get(self, key: str, default=None):
        c = self._c.get(key)
        return default if c is None else c.value

    def copy(self) -> Dict[str, int]:
        return dict(self.items())

    def __eq__(self, other) -> bool:
        if isinstance(other, dict):
            return dict(self.items()) == other
        return NotImplemented

    def __repr__(self) -> str:
        return repr(dict(self.items()))


class Engine:
    """Query engine bound to one (or a few) resident data graphs."""

    def __init__(self, graph: Optional[DataGraph] = None, *,
                 options: Optional[EngineOptions] = None,
                 label_names=None):
        self.options = options or EngineOptions()
        self._residents: "OrderedDict[int, _Resident]" = OrderedDict()
        # per-engine metrics registry: counters/caches/histograms below all
        # live here, so snapshot()/metrics_text() is one consistent view
        self.metrics = MetricsRegistry()
        # memory & transfer ledger: the process-wide ledger is
        # published into this registry at snapshot/exposition time; the
        # plan cache's eviction hook credits it when a cached resident
        # executor is torn down
        self.ledger = get_ledger()
        self._plan_cache = LRUCache(self.options.plan_cache_size,
                                    on_evict=self._evict_plan_entry)
        self._plan_cache.bind_metrics(self.metrics, "plan")
        # memo: reduced-query structure -> canonical key, so the exact
        # (up to n! permutations) canonicalization runs once per distinct
        # query structure, not on every plan-cache hit
        self._canon_memo = LRUCache(4 * self.options.plan_cache_size)
        self._canon_memo.bind_metrics(self.metrics, "canon")
        self.default_graph = graph
        self.counters = _CounterView(self.metrics)
        # serving telemetry: one bounded flight recorder + one
        # sliding-window aggregator per engine, armed on every request in
        # all three execution modes.  ``telemetry`` is a live toggle (the
        # profile-smoke overhead gate flips it for same-process A/B).
        self.telemetry = self.options.telemetry
        self.flight = FlightRecorder(capacity=self.options.flight_capacity,
                                     exemplar_k=self.options.exemplar_k)
        self.windows = WindowedAggregator(window_s=self.options.window_s,
                                          n_windows=self.options.n_windows)
        # one breaker per engine, shared by every device dispatch and
        # mirrored into engine_breaker_state / engine_device_retries;
        # state transitions also land in the flight recorder (a transition
        # to open triggers the armed auto-dump)
        self.breaker = (self.options.breaker or CircuitBreaker())
        self.breaker.bind_metrics(self.metrics)
        self.breaker.bind_recorder(self.flight)
        self._qid = itertools.count(1)
        # histogram objects held directly: the hot path must not pay a
        # registry lookup per observation
        h = self.metrics.histogram
        self._h_parse = h("query_phase_seconds", phase="parse")
        self._h_plan = h("query_phase_seconds", phase="plan")
        self._h_exec = h("query_phase_seconds", phase="exec")
        self._h_total = h("query_phase_seconds", phase="total")
        self._h_rig_nodes = h("rig_nodes")
        self._h_rig_edges = h("rig_edges")
        self._h_sim_passes = h("sim_passes")
        self._h_results = h("result_count")
        # resident-RIG upload footprint (observed once per fresh upload)
        self._h_resident_bytes = h("resident_bytes")
        # planner accountability: observed/estimated ratio per
        # quantity (1.0 = the planner was exactly right), fed on every
        # observed execution; plus the bytes freed by plan-cache evictions
        # tearing down cached resident executors
        self._h_misest = {q: h("planner_misestimation_ratio", quantity=q)
                          for q in ESTIMATE_QUANTITIES}
        self._c_resident_evicted = self.metrics.counter(
            "cache_resident_evicted_bytes")
        if graph is not None:
            self.register(graph, label_names=label_names)

    def _evict_plan_entry(self, key, entry) -> None:
        """Plan-cache teardown: an entry leaving the cache (capacity
        eviction, resident-graph eviction, clear) releases the device
        executor it cached — the ledger is credited by ``close()`` and the
        freed bytes land on ``cache_resident_evicted_bytes``."""
        ex = getattr(entry, "resident", None)
        if ex is None:
            return
        entry.resident = None
        try:
            freed = ex.close()
        except Exception:
            return
        if freed:
            self._c_resident_evicted.inc(freed)

    # ------------------------------------------------------------ residency
    def register(self, graph: DataGraph, label_names=None) -> GraphContext:
        """Make ``graph`` resident (idempotent).  Returns its context."""
        key = id(graph)
        if key not in self._residents:
            self._residents[key] = _Resident(graph, self.options,
                                             label_names=label_names)
            # ledger attribution key: every transfer/allocation this graph
            # causes is charged under it.  Callers (e.g. the server's
            # per-tenant rollups) may pre-stamp their own key; the epoch
            # default only fills the gap.
            if not getattr(graph, "graph_key", None):
                graph.graph_key = f"g{self._residents[key].epoch}"
            while len(self._residents) > self.options.max_resident_graphs:
                _, dead = self._residents.popitem(last=False)
                # epochs are never reused, so the evicted graph's plan
                # entries are unreachable — free their cache slots
                self._plan_cache.drop_where(lambda k: k[0] == dead.epoch)
        elif label_names is not None:
            self._residents[key].vocab = Vocab.for_graph(graph,
                                                         names=label_names)
        self._residents.move_to_end(key)
        if self.default_graph is None:
            self.default_graph = graph
        return self._residents[key].ctx

    def _resident(self, graph: Optional[DataGraph]) -> _Resident:
        g = graph if graph is not None else self.default_graph
        if g is None:
            raise ValueError("no resident graph: pass graph= or construct "
                             "Engine(graph)")
        self.register(g)
        return self._residents[id(g)]

    def context(self, graph: Optional[DataGraph] = None) -> GraphContext:
        return self._resident(graph).ctx

    # ------------------------------------------------------------- language
    @property
    def vocab(self) -> Vocab:
        """The default graph's label vocabulary (each resident graph keeps
        its own; ``parse``/``format`` accept ``graph=`` to select it)."""
        if self.default_graph is not None:
            return self._resident(None).vocab
        return Vocab()

    def parse(self, text: str, name: str = "",
              graph: Optional[DataGraph] = None) -> PatternQuery:
        vocab = (self._resident(graph).vocab
                 if (graph is not None or self.default_graph is not None)
                 else Vocab())
        return parse(text, vocab=vocab, name=name)

    def format(self, q: PatternQuery,
               graph: Optional[DataGraph] = None) -> str:
        vocab = (self._resident(graph).vocab
                 if (graph is not None or self.default_graph is not None)
                 else Vocab())
        return fmt(q, vocab=vocab)

    # ------------------------------------------------------------- planning
    def _prepare(self, query: QueryLike, res: _Resident,
                 stats: EngineStats, trace=NULL_TRACER):
        """parse (if text) + TR + canonical key + plan-cache lookup."""
        stats.query_id = next(self._qid)
        t0 = time.perf_counter()
        with trace.span("parse") as psp:
            q = (parse(query, vocab=res.vocab) if isinstance(query, str)
                 else query)
            if trace.enabled:
                psp.set(text=isinstance(query, str), n=q.n,
                        edges=len(q.edges))
        stats.parse_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        with trace.span("canonicalize") as csp:
            qr = q.transitive_reduction()
            raw = (tuple(qr.labels),
                   tuple((e.src, e.dst, e.kind) for e in qr.edges))
            ckey = self._canon_memo.get(raw)
            memo_hit = ckey is not None
            if ckey is None:
                ckey = canonical_key(qr, reduce=False)
                self._canon_memo.put(raw, ckey)
            if trace.enabled:
                csp.set(key=ckey, memo_hit=memo_hit,
                        reduced_edges=len(qr.edges))
        with trace.span("plan") as sp:
            key = (res.epoch, ckey)
            entry: Optional[_PlanEntry] = self._plan_cache.get(key)
            if entry is None:
                plan = res.planner.plan(qr)
                entry = _PlanEntry(plan=plan,
                                   est=EstimateRecord(est=plan.estimates()),
                                   cal=res.planner.calibration)
                self._plan_cache.put(key, entry)
            else:
                stats.plan_cache_hit = True
                entry.plan = res.planner.refine(entry.plan, qr, entry.rig)
                # the refined plan's estimates are the committed ones this
                # execution is accountable to
                entry.est.est = entry.plan.estimates()
            if trace.enabled:
                p = entry.plan
                sp.set(cached=stats.plan_cache_hit, backend=p.backend,
                       enum_method=p.enum_method, ordering=p.ordering,
                       sim_algo=p.sim_algo, est_cost=p.est_cost,
                       est_card=p.est_card, reasons=list(p.reasons))
        stats.plan_s = time.perf_counter() - t0
        # snapshot the engine-wide plan-cache counters *now*,
        # right after this query's own cache access — streams finalizing
        # later must not see other queries' interleaved accesses
        stats.plan_cache_hits = self._plan_cache.hits
        stats.plan_cache_misses = self._plan_cache.misses
        stats.plan_cache_evictions = self._plan_cache.evictions
        return qr, key[1], entry

    def explain(self, query: QueryLike,
                graph: Optional[DataGraph] = None) -> str:
        """The plan the engine would run, as a static lifecycle tree (does
        not execute).  Output is stable across repeat calls once the plan
        is cached (the first call may plan fresh; later calls refine
        against the same observed statistics and print identically)."""
        res = self._resident(graph)
        stats = EngineStats()
        qr, key, entry = self._prepare(query, res, stats)
        p = entry.plan
        cached = "cached" if stats.plan_cache_hit else "fresh"
        lines = [
            f"query {key}  [{cached} plan]",
            f"├─ parse        nodes={qr.n} edges={len(qr.edges)}",
            f"├─ plan         backend={p.backend} enum={p.enum_method} "
            f"ordering={p.ordering} sim={p.sim_algo}"
            f"(passes={p.sim_passes}) check={p.check_method} "
            f"chunk={p.chunk_size}",
        ]
        for r in p.reasons:
            lines.append(f"│     · {r}")
        lines.append("├─ labels       "
                     + ("resident" if res.ctx.labels_ready
                        else "cold (built on first execute)"))
        rig_line = (f"├─ rig          est_cost={p.est_cost:.4g} "
                    f"est_card={p.est_card:.4g}")
        if entry.rig.observations:
            rig_line += (f"  observed: nodes={entry.rig.rig_nodes} "
                         f"edges={entry.rig.rig_edges} "
                         f"count={entry.rig.count}")
        lines.append(rig_line)
        lines.append(f"└─ enumerate    method={p.enum_method} "
                     f"limit={self.options.limit}")
        return "\n".join(lines)

    def explain_analyze(self, query: QueryLike,
                        graph: Optional[DataGraph] = None,
                        materialize: Optional[bool] = None,
                        budget=_UNSET) -> str:
        """EXPLAIN ANALYZE: *execute* the query, then render the plan with
        its committed estimates reconciled against what the execution
        observed — per-quantity estimate/observed/ratio rows, which planner
        decisions would flip under the observed statistics, and the bytes
        the execution moved (per-query plus the graph's ledger rollup)."""
        res = self._resident(graph)
        result = self.execute(query, graph=graph, materialize=materialize,
                              budget=budget)
        # re-prepare (a guaranteed plan-cache hit) to fetch the entry the
        # execution just reconciled
        qr, key, entry = self._prepare(query, res, EngineStats())
        p, st = entry.plan, result.stats
        cached = "warm" if st.plan_cache_hit else "cold"
        lines = [
            f"query {key}  [analyzed: {cached} plan, backend={st.backend} "
            f"enum={st.enum_method} count={result.count} "
            f"status={st.status}]",
            f"├─ plan         backend={p.backend} enum={p.enum_method} "
            f"ordering={p.ordering} sim={p.sim_algo} chunk={p.chunk_size}",
        ]
        for r in p.reasons:
            lines.append(f"│     · {r}")
        lines.append("├─ estimates    (observed / estimated; "
                     "x1 = planner exactly right)")
        for quantity, est, obs, ratio in entry.est.rows():
            obs_s = "-" if obs is None else f"{obs:.6g}"
            ratio_s = "-" if ratio is None else f"x{ratio:.3g}"
            lines.append(f"│     {quantity:<15} est={est:<12.6g} "
                         f"obs={obs_s:<12} {ratio_s}")
        decisions = res.planner.analyze(p, qr, entry.est)
        if decisions:
            lines.append("├─ decisions")
            for name, planned, observed, flips in decisions:
                mark = "WOULD FLIP" if flips else "holds"
                lines.append(f"│     {name:<22} planned: {planned}  "
                             f"observed: {observed}  [{mark}]")
        lines.append(f"├─ transfers    h2d={st.h2d_bytes} B  "
                     f"d2h={st.d2h_bytes} B  "
                     f"resident={st.resident_bytes} B")
        roll = self.ledger.rollup(getattr(res.ctx.graph, "graph_key", "-"))
        lines.append(f"└─ graph ledger h2d={roll['h2d_bytes']} B  "
                     f"d2h={roll['d2h_bytes']} B  "
                     f"resident_live={roll['resident_live_bytes']} B  "
                     f"watermark={roll['resident_watermark_bytes']} B")
        return "\n".join(lines)

    # ------------------------------------------------------------ execution
    def _arm_budget(self, budget) -> Optional[Budget]:
        """Resolve a per-call ``budget=`` argument: ``_UNSET`` falls back to
        the engine-wide template, ``None`` disables governance, anything
        else is armed fresh (the template itself is never mutated)."""
        if budget is _UNSET:
            budget = self.options.budget
        return None if budget is None else budget.start()

    def _governance(self, stats: EngineStats, m, observe: bool) -> bool:
        """Fold one match's governance outcome (deadline flag, degradation
        ladder steps) into per-query stats and the engine counters; returns
        the possibly-downgraded ``observe`` (a deadline partial must not
        feed RIG-stats re-planning)."""
        degr = list(getattr(m, "degradations", ()) or ())
        for d in degr:
            if d not in stats.degradations:
                stats.degradations.append(d)
                self.counters["budget_degradations"] += 1
        if getattr(m, "deadline_exceeded", False):
            stats.deadline_exceeded = True
            stats.partial = True
            stats.status = "deadline_exceeded"
            self.counters["deadline_exceeded"] += 1
            return False
        return observe

    def _account_estimates(self, entry: _PlanEntry, **observed) -> None:
        """Reconcile one observed execution against the plan's committed
        estimates: per-quantity obs/est ratios land in the entry's
        :class:`EstimateRecord` (EXPLAIN ANALYZE), the registry's
        misestimation histograms, and the graph's :class:`Calibration`
        (which scales this graph's future fresh estimates)."""
        ratios = entry.est.record(**observed)
        for quantity, r in ratios.items():
            hist = self._h_misest.get(quantity)
            if hist is not None:
                hist.observe(r)
        if entry.cal is not None and ratios:
            entry.cal.record(ratios)

    def _harvest_resident(self, entry: _PlanEntry, m) -> None:
        """Move a match's device-resident RIG executor (if the resident
        enumerator ran) from the throwaway RIG onto the plan-cache entry,
        so the next execution of the same canonical query skips the
        re-upload.  A replaced executor is closed (ledger credited)."""
        rig = getattr(m, "rig", None)
        ex = getattr(rig, "resident", None) if rig is not None else None
        if ex is None or getattr(ex, "closed", False):
            return
        rig.resident = None
        old = entry.resident
        if old is not None and old is not ex:
            try:
                old.close()
            except Exception:
                pass
        entry.resident = ex

    def _observe_host(self, entry: _PlanEntry, stats: EngineStats,
                      m, observe: bool = True) -> None:
        """Record one host execution (one-shot, streamed, or batched) into
        per-query stats and — unless ``observe=False`` (e.g. an early-closed
        stream) — the plan entry's observed RIG statistics."""
        stats.backend = HOST
        stats.sim_passes = m.sim_passes
        stats.rig_nodes = m.rig_nodes
        stats.rig_edges = m.rig_edges
        stats.truncated = m.truncated
        stats.enum_method = m.enum_method
        stats.h2d_bytes = getattr(m, "h2d_bytes", 0)
        stats.d2h_bytes = getattr(m, "d2h_bytes", 0)
        self._harvest_resident(entry, m)
        uploads = getattr(m, "resident_uploads", 0)
        if uploads:
            self.counters["resident_uploads"] += uploads
            self._h_resident_bytes.observe(getattr(m, "resident_bytes", 0))
        dispatches = getattr(m, "resident_dispatches", 0)
        if dispatches:
            self.counters["resident_dispatches"] += dispatches
        routed = getattr(m, "small_frontier_host_routed", 0)
        if routed:
            self.counters["small_frontier_host_routed"] += routed
        # the resident footprint this query executed against: the fresh
        # upload when it paid one, else the warm executor it reused
        rb = getattr(m, "resident_bytes", 0)
        if not rb and stats.enum_method == "frontier-device-resident":
            rb = getattr(entry.resident, "nbytes", 0) or 0
        stats.resident_bytes = rb
        observe = self._governance(stats, m, observe)
        if observe:
            entry.rig.observe(rig_nodes=m.rig_nodes, rig_edges=m.rig_edges,
                              sim_passes=m.sim_passes,
                              matching_s=m.matching_s,
                              enumerate_s=m.enumerate_s, count=m.count)
            self._h_rig_nodes.observe(m.rig_nodes)
            self._h_rig_edges.observe(m.rig_edges)
            self._h_sim_passes.observe(m.sim_passes)
            self._h_results.observe(m.count)
            obs = dict(cardinality=float(m.count),
                       rig_nodes=float(m.rig_nodes),
                       rig_edges=float(m.rig_edges))
            if rb:
                obs["resident_bytes"] = float(rb)
            self._account_estimates(entry, **obs)
        self.counters["host_exec"] += 1

    def _arm_transfer_attribution(self, res: _Resident, entry: _PlanEntry,
                                  opts) -> None:
        """Pre-dispatch ledger/residency wiring for one host execution:
        hand the entry's cached device executor to ``prepare_rig`` (warm
        repeats skip the re-upload) and stamp the shared slab intersector
        with this graph's ledger key so its h2d/d2h charges attribute to
        the right graph."""
        opts.resident_executor = entry.resident
        if entry.plan.enum_method == "frontier-device":
            device_intersector().ledger_key = getattr(res.ctx.graph,
                                                      "graph_key", "-")

    def _run_host(self, res: _Resident, qr: PatternQuery, entry: _PlanEntry,
                  stats: EngineStats, materialize: bool,
                  trace=NULL_TRACER, budget=None) -> MatchResult:
        """One governed host attempt; transient failures (injected faults,
        device losses surfacing as :class:`TransientError`) are retried
        here up to ``budget.max_attempts`` — recompute is the only recovery
        the RIG needs."""
        opts = entry.plan.gm_options(limit=self.options.limit,
                                     materialize=materialize,
                                     budget=budget, breaker=self.breaker)
        self._arm_transfer_attribution(res, entry, opts)
        attempts = 1 if budget is None else max(1, budget.max_attempts)
        for attempt in range(1, attempts + 1):
            stats.attempts = max(stats.attempts, attempt)
            try:
                m = res.gm().match(qr, options=opts, trace=trace)
                break
            except TransientError:
                if attempt >= attempts:
                    raise
                self.counters["transient_retries"] += 1
        self._observe_host(entry, stats, m)
        return m

    def _post_device(self, res: _Resident, qr: PatternQuery,
                     entry: _PlanEntry, stats: EngineStats, dev,
                     materialize: bool, trace=NULL_TRACER,
                     dispatch_s: float = 0.0, budget=None):
        """Common handling of one device result: stats, RIG-stats
        observation, and exact host fallback on capacity overflow.
        Returns ``(count, tuples)``.  ``dispatch_s`` is this query's share
        of the device dispatch, used only to synthesize trace spans."""
        stats.backend = DEVICE
        stats.enum_method = "torchgm-frontier"  # device matcher's enumerator
        # exact_sim runs the device fixpoint loop, whose pass count is not
        # surfaced; 0 = "not tracked" (the truncated mode reports its budget)
        jgm = res.jgm()
        stats.sim_passes = 0 if jgm.exact_sim else jgm.n_passes
        stats.rig_nodes = int(np.sum(dev.fb_sizes))
        self.counters["device_exec"] += 1
        if dev.overflowed:
            if trace.enabled:
                trace.add("device_attempt", duration_s=dispatch_s,
                          overflowed=True, rig_nodes=stats.rig_nodes)
            # the host re-run records the real rig/enumerate/materialize
            # spans for this query
            m = self._run_host(res, qr, entry, stats, materialize,
                               trace=trace, budget=budget)
            stats.backend = DEVICE          # device ran; host completed
            stats.overflow_fallback = True
            self.counters["overflow_fallbacks"] += 1
            return m.count, m.tuples
        if trace.enabled:
            # the device matcher runs selection and enumeration in one
            # call: the rig/materialize spans are structural markers, the
            # measured share lands on enumerate
            trace.add("rig", device=True, rig_nodes=stats.rig_nodes,
                      fb_sizes=[int(x) for x in dev.fb_sizes])
            trace.add("enumerate", duration_s=dispatch_s,
                      method="torchgm-frontier", results=int(dev.count))
            trace.add("materialize",
                      materialized=dev.tuples is not None)
        entry.rig.observe(rig_nodes=stats.rig_nodes, rig_edges=0,
                          sim_passes=stats.sim_passes,
                          matching_s=0.0, enumerate_s=0.0, count=dev.count)
        self._h_rig_nodes.observe(stats.rig_nodes)
        self._h_results.observe(dev.count)
        # the device matcher reports no RIG edge count — only reconcile
        # the quantities the device path actually observes
        self._account_estimates(entry, cardinality=float(dev.count),
                                rig_nodes=float(stats.rig_nodes))
        return dev.count, dev.tuples

    def _finish(self, stats: EngineStats, count: int,
                t_start: Optional[float] = None) -> None:
        """``t_start=None`` (batch members): per-query total is the sum of
        this query's own phases, not wall time since the batch began."""
        stats.count = count
        stats.total_s = (time.perf_counter() - t_start if t_start is not None
                         else stats.parse_s + stats.plan_s + stats.exec_s)
        self._h_parse.observe(stats.parse_s)
        self._h_plan.observe(stats.plan_s)
        self._h_exec.observe(stats.exec_s)
        self._h_total.observe(stats.total_s)
        self.counters["queries"] += 1

    @staticmethod
    def _exemplar_trace(stats: EngineStats, root: Optional[Span]):
        """Span tree for a tail-sampled exemplar: the real lifecycle tree
        when the query was profiled, otherwise one synthesized from the
        phase timings every query measures anyway — so slow/failed
        requests always carry *some* tree without ``profile=True``
        overhead on the rest of the traffic."""
        if root is not None:
            return root.to_dict()
        attrs = {"status": stats.status, "backend": stats.backend,
                 "synthesized": True}
        if stats.error_type:
            attrs["error"] = stats.error_type
        return {
            "name": "query", "duration_s": stats.total_s, "attrs": attrs,
            "children": [
                {"name": "parse", "duration_s": stats.parse_s},
                {"name": "plan", "duration_s": stats.plan_s},
                {"name": "exec", "duration_s": stats.exec_s,
                 "attrs": {"enum_method": stats.enum_method,
                           "degradations": list(stats.degradations)}},
            ],
        }

    def _record_event(self, stats: EngineStats, key: str, count: int,
                      trace_root: Optional[Span] = None) -> None:
        """Serving telemetry for one finished request (every execution
        mode funnels through here): one structured event in the flight
        recorder — with tail-based exemplar consideration — plus the
        phase observations for the windowed QPS/error-rate/quantile
        series.  A no-op when ``self.telemetry`` is off."""
        if not self.telemetry:
            return
        ev = QueryEvent.from_stats(stats, key=key, count=count)
        self.flight.record_query(
            ev, trace_provider=lambda: self._exemplar_trace(stats,
                                                            trace_root))
        self.windows.observe(
            {"parse": stats.parse_s, "plan": stats.plan_s,
             "exec": stats.exec_s, "total": stats.total_s},
            error=stats.status != "ok")

    def _ensure_labels(self, res: _Resident, stats: EngineStats,
                       trace=NULL_TRACER, budget=None) -> None:
        """Label-cache access with its lifecycle span (per-phase children
        on a cold build, ``cached=True`` on a hit).  A transient failure
        mid-build leaves the context cleanly cold (the build is
        transactional), so the retry here simply rebuilds."""
        attempts = 1 if budget is None else max(1, budget.max_attempts)
        with trace.span("labels") as lsp:
            for attempt in range(1, attempts + 1):
                stats.attempts = max(stats.attempts, attempt)
                try:
                    stats.label_cache_hit = res.ctx.ensure_labels()
                    break
                except TransientError:
                    if attempt >= attempts:
                        raise
                    self.counters["transient_retries"] += 1
            if trace.enabled:
                lsp.set(cached=stats.label_cache_hit)
                if not stats.label_cache_hit:
                    for name, dur in res.ctx.label_phases:
                        trace.add(name, duration_s=dur)
        if not stats.label_cache_hit:
            self.counters["label_builds"] += 1

    def execute(self, query: QueryLike, *,
                graph: Optional[DataGraph] = None,
                materialize: Optional[bool] = None,
                profile: bool = False, budget=_UNSET) -> EngineResult:
        """Plan and run one query; returns count/tuples + plan + stats.
        ``profile=True`` additionally records the full lifecycle span tree
        (parse → canonicalize → plan → labels → rig → enumerate →
        materialize) on ``result.trace``.

        ``budget`` (a :class:`repro_torch.robust.Budget` template; defaults to
        ``options.budget``, ``None`` = ungoverned) bounds this execution:
        a deadline blown during enumeration returns the correctly-truncated
        prefix with ``stats.status == "deadline_exceeded"``; one blown in a
        non-enumerable phase (labels, RIG build) or a resource cap returns
        an empty result carrying the typed status — unless
        ``budget.raise_on_error``, in which case the typed
        :class:`~repro_torch.robust.QueryError` propagates instead.
        """
        t_start = time.perf_counter()
        res = self._resident(graph)
        stats = EngineStats()
        trace = Tracer("query") if profile else NULL_TRACER
        b = self._arm_budget(budget)
        # parse/plan first: malformed text must not pay a cold label build
        qr, key, entry = self._prepare(query, res, stats, trace=trace)
        mat = self.options.materialize if materialize is None else materialize

        t0 = time.perf_counter()
        count, tuples = 0, None
        try:
            self._ensure_labels(res, stats, trace=trace, budget=b)
            t0 = time.perf_counter()
            if entry.plan.backend == DEVICE:
                try:
                    dev = self.breaker.call(
                        lambda: res.jgm().match(qr, materialize=mat),
                        budget=b)
                    count, tuples = self._post_device(
                        res, qr, entry, stats, dev, mat, trace=trace,
                        dispatch_s=time.perf_counter() - t0, budget=b)
                except (DeviceFailure, BreakerOpen):
                    # bottom of the ladder: recompute the query on the host
                    if "host" not in stats.degradations:
                        stats.degradations.append("host")
                        self.counters["budget_degradations"] += 1
                    m = self._run_host(res, qr, entry, stats, mat,
                                       trace=trace, budget=b)
                    count, tuples = m.count, m.tuples
            else:
                m = self._run_host(res, qr, entry, stats, mat, trace=trace,
                                   budget=b)
                count, tuples = m.count, m.tuples
            if (b is not None and b.raise_on_error
                    and stats.deadline_exceeded):
                raise DeadlineExceeded(
                    f"deadline exceeded after {count} result(s)")
        except QueryError as e:
            if b is not None and b.raise_on_error:
                raise
            stats.status = e.status
            stats.error_type = type(e).__name__
            stats.partial = True
            if isinstance(e, DeadlineExceeded):
                stats.deadline_exceeded = True
                self.counters["deadline_exceeded"] += 1
            tuples = (np.empty((0, qr.n), dtype=np.int64) if mat else None)
        stats.exec_s = time.perf_counter() - t0
        self._finish(stats, count, t_start)
        root = trace.finish()
        if root is not None:
            root.set(key=key, backend=stats.backend, count=count,
                     status=stats.status)
            if stats.error_type:
                root.set(error=stats.error_type)
        self._record_event(stats, key, count, trace_root=root)
        return EngineResult(count=count, tuples=tuples, query=qr,
                            plan=entry.plan, stats=stats, key=key,
                            trace=root)

    def execute_stream(self, query: QueryLike, *,
                       graph: Optional[DataGraph] = None,
                       chunk_size: Optional[int] = None,
                       limit=_UNSET, profile: bool = False,
                       budget=_UNSET) -> EngineStream:
        """Plan one query and enumerate its results *lazily*, in fixed-size
        chunks — the facade over :meth:`GM.match_stream` /
        :func:`repro_torch.core.mjoin.iter_tuples`.

        Planning, label-cache handling and RIG construction run eagerly
        (node selection is existence checking, not enumeration); the MJoin
        enumeration itself advances only as the returned
        :class:`EngineStream` is consumed, so an early-stopping consumer
        never pays for the tail.  ``chunk_size=None`` uses the planner's
        choice (estimated — and, on repeat queries, observed — result
        cardinality); ``limit`` defaults to ``options.limit``.  Streaming
        honours the plan's enum_method, including the device-capable paths:
        ``frontier-device`` ships per-level slabs to the ``intersect``
        kernel, and ``frontier-device-resident`` enumerates against the
        device-resident RIG with lazily-consumed fixed-size result pages —
        chunks stay byte-identical to host order either way.  Only the
        whole-graph device matcher has no incremental mode.
        """
        res = self._resident(graph)
        stats = EngineStats(streamed=True)
        trace = Tracer("query") if profile else NULL_TRACER
        b = self._arm_budget(budget)
        # parse/plan first: malformed text must not pay a cold label build
        qr, key, entry = self._prepare(query, res, stats, trace=trace)
        self._ensure_labels(res, stats, trace=trace, budget=b)
        lim = self.options.limit if limit is _UNSET else limit
        chunk = chunk_size if chunk_size is not None else \
            entry.plan.chunk_size
        stats.chunk_size = chunk
        opts = entry.plan.gm_options(limit=lim, materialize=True,
                                     budget=b, breaker=self.breaker)
        self._arm_transfer_attribution(res, entry, opts)
        # setup (RIG build) is eager: a transient fault here is retried,
        # a typed QueryError propagates to the caller — there is no stream
        # to hand back yet.  Once iteration starts, a blown deadline ends
        # the stream after its partial prefix instead.
        attempts = 1 if b is None else max(1, b.max_attempts)
        for attempt in range(1, attempts + 1):
            stats.attempts = max(stats.attempts, attempt)
            try:
                m = res.gm().match_stream(qr, options=opts, chunk_size=chunk,
                                          trace=trace)
                break
            except TransientError:
                if attempt >= attempts:
                    raise
                self.counters["transient_retries"] += 1
        return EngineStream(self, entry, m, stats, qr, key,
                            tracer=trace if profile else None)

    def execute_many(self, queries: Sequence[RequestLike], *,
                     graph: Optional[DataGraph] = None,
                     profile: bool = False,
                     budget=_UNSET) -> List[EngineResult]:
        """Batched execution with cross-request sharing.

        Each item is query text, a :class:`PatternQuery`, or a
        ``(query, graph)`` pair (mixing resident graphs in one batch).
        Requests are grouped per resident graph; within a group the engine

        1. parses and plans *everything* first (a malformed query raises
           before any cold label build is paid),
        2. builds the graph's label structures once,
        3. answers requests with the same canonical key from one execution
           (``stats.shared_exec`` on the copies),
        4. runs device-planned queries through one batched dispatch, and
           host ``frontier-device`` queries through one fused scheduler
           that micro-batches their per-level ``(F, K, W)`` constraint
           gathers into a single ``(ΣF, K, W)`` slab per round; remaining
           host queries run sequentially.
        """
        items: List[Tuple[QueryLike, Optional[DataGraph]]] = []
        for item in queries:
            if isinstance(item, tuple):
                q, g = item
                items.append((q, g))
            else:
                items.append((item, graph))
        # group indices per resident graph (registration happens here, so
        # group order follows first appearance in the batch)
        groups: "OrderedDict[int, Tuple[_Resident, List[int]]]" = \
            OrderedDict()
        residents: List[_Resident] = []
        for i, (_, g) in enumerate(items):
            res = self._resident(g)
            groups.setdefault(id(res), (res, []))[1].append(i)
            residents.append(res)
        # parse/plan the whole batch first (admission control); each
        # request gets its own armed copy of the budget template — one slow
        # request blowing its deadline must not cancel its batch-mates
        prepared = []
        for i, (q, _) in enumerate(items):
            stats = EngineStats()
            trace = Tracer("query") if profile else NULL_TRACER
            qr, key, entry = self._prepare(q, residents[i], stats,
                                           trace=trace)
            prepared.append((qr, key, entry, stats, trace,
                             self._arm_budget(budget)))
        results: List[Optional[EngineResult]] = [None] * len(items)
        for res, idxs in groups.values():
            self._execute_group(res, idxs, prepared, results)
        return results    # type: ignore[return-value]

    def _finish_trace(self, tr, key: str, stats: EngineStats,
                      count: int) -> Optional[Span]:
        root = tr.finish()
        if root is not None:
            root.set(key=key, backend=stats.backend, count=count)
        return root

    def _execute_group(self, res: _Resident, idxs: List[int],
                       prepared, results) -> None:
        """Run one resident graph's share of an ``execute_many`` batch."""
        t0 = time.perf_counter()
        label_hit = res.ctx.ensure_labels()
        build_s = time.perf_counter() - t0
        if not label_hit:
            self.counters["label_builds"] += 1
        for j, i in enumerate(idxs):
            # resident for every query after the first in this group
            hit = label_hit or j > 0
            prepared[i][3].label_cache_hit = hit
            tr = prepared[i][4]
            if tr.enabled:
                sp = tr.add("labels", duration_s=0.0 if hit else build_s,
                            cached=hit)
                if not hit:
                    for name, dur in res.ctx.label_phases:
                        sp.children.append(Span(name, duration_s=dur))

        # dedup by canonical key: the first occurrence executes, the rest
        # are answered from its result (all batch members share the same
        # counting-mode options, so the result is identical by definition)
        rep_of: Dict[str, int] = {}
        dups: Dict[int, List[int]] = {}
        reps: List[int] = []
        for i in idxs:
            key = prepared[i][1]
            if key in rep_of:
                dups.setdefault(rep_of[key], []).append(i)
            else:
                rep_of[key] = i
                reps.append(i)

        lane = {i: prepared[i][2].plan.batch_group() for i in reps}
        device_idx = [i for i in reps if lane[i] == "device"]
        fd_idx = [i for i in reps if lane[i] == "frontier-device"]

        jgm = res.jgm() if device_idx else None
        if len(device_idx) >= 2:
            t0 = time.perf_counter()
            try:
                batch = self.breaker.call(
                    lambda: jgm.match_batch(
                        [prepared[i][0] for i in device_idx]))
            except (DeviceFailure, BreakerOpen):
                # whole-batch device loss: every member degrades to the
                # host singles lane below (recompute, not repair)
                for i in device_idx:
                    stats = prepared[i][3]
                    if "host" not in stats.degradations:
                        stats.degradations.append("host")
                        self.counters["budget_degradations"] += 1
                batch = None
                device_idx = []
            if batch is not None:
                dt = time.perf_counter() - t0
                for i, dev in zip(device_idx, batch):
                    qr, key, entry, stats, tr, b = prepared[i]
                    t1 = time.perf_counter()
                    count, _ = self._post_device(
                        res, qr, entry, stats, dev,
                        materialize=False, trace=tr,
                        dispatch_s=dt / len(device_idx), budget=b)
                    # this query's share of the batched dispatch, plus any
                    # host overflow-fallback time it caused individually
                    stats.exec_s = (dt / len(device_idx)
                                    + time.perf_counter() - t1)
                    self._finish(stats, count)
                    results[i] = EngineResult(
                        count=count, tuples=None, query=qr, plan=entry.plan,
                        stats=stats, key=key,
                        trace=self._finish_trace(tr, key, stats, count))
                device_idx = []

        if len(fd_idx) >= 2:
            # micro-batched frontier lane: one fused (ΣF, K, W) slab per
            # scheduler round across all queries in the lane (the intersect
            # kernel's wrapper: CUDA on the card, its plain version on the
            # CPU pin)
            t0 = time.perf_counter()
            gm_opts = [prepared[i][2].plan.gm_options(
                limit=self.options.limit, materialize=False,
                budget=prepared[i][5], breaker=self.breaker)
                for i in fd_idx]
            for o, i in zip(gm_opts, fd_idx):
                self._arm_transfer_attribution(res, prepared[i][2], o)
            ms, dispatches = res.gm().match_batch_frontier(
                [prepared[i][0] for i in fd_idx], gm_opts,
                intersector=device_intersector(),
                traces=[prepared[i][4] for i in fd_idx])
            dt = time.perf_counter() - t0
            self.counters["frontier_batches"] += 1
            self.counters["frontier_batch_dispatches"] += dispatches
            for i, m in zip(fd_idx, ms):
                qr, key, entry, stats, tr, b = prepared[i]
                self._observe_host(entry, stats, m)
                stats.exec_s = dt / len(fd_idx)   # share of the fused run
                self._finish(stats, m.count)
                if tr.enabled:
                    # the rig span was recorded live by prepare_rig; the
                    # enumeration ran inside the fused scheduler, so its
                    # span is this query's accounted share
                    tr.add("enumerate", duration_s=m.enumerate_s,
                           method=m.enum_method, results=m.count,
                           fused_batch=True, dispatches=dispatches)
                    tr.add("materialize", materialized=False)
                results[i] = EngineResult(
                    count=m.count, tuples=None, query=qr, plan=entry.plan,
                    stats=stats, key=key,
                    trace=self._finish_trace(tr, key, stats, m.count))
            fd_idx = []

        for i in reps:
            if results[i] is not None:
                continue
            qr, key, entry, stats, tr, b = prepared[i]
            t0 = time.perf_counter()
            try:
                if i in device_idx:
                    # singleton device query: non-batched dispatch
                    try:
                        dev = self.breaker.call(
                            lambda: jgm.match(qr, materialize=False),
                            budget=b)
                        count, _ = self._post_device(
                            res, qr, entry, stats, dev, materialize=False,
                            trace=tr, dispatch_s=time.perf_counter() - t0,
                            budget=b)
                    except (DeviceFailure, BreakerOpen):
                        if "host" not in stats.degradations:
                            stats.degradations.append("host")
                            self.counters["budget_degradations"] += 1
                        m = self._run_host(res, qr, entry, stats,
                                           materialize=False, trace=tr,
                                           budget=b)
                        count = m.count
                else:
                    m = self._run_host(res, qr, entry, stats,
                                       materialize=False, trace=tr,
                                       budget=b)
                    count = m.count
            except QueryError as e:
                if b is not None and b.raise_on_error:
                    raise
                stats.status = e.status
                stats.error_type = type(e).__name__
                stats.partial = True
                if isinstance(e, DeadlineExceeded):
                    stats.deadline_exceeded = True
                    self.counters["deadline_exceeded"] += 1
                count = 0
            stats.exec_s = time.perf_counter() - t0
            self._finish(stats, count)
            results[i] = EngineResult(
                count=count, tuples=None, query=qr, plan=entry.plan,
                stats=stats, key=key,
                trace=self._finish_trace(tr, key, stats, count))

        # fan the representatives' answers out to their duplicates
        for rep, dlist in dups.items():
            src = results[rep]
            for i in dlist:
                qr, key, entry, stats, tr, b = prepared[i]
                stats.shared_exec = True
                stats.backend = src.stats.backend
                stats.sim_passes = src.stats.sim_passes
                stats.rig_nodes = src.stats.rig_nodes
                stats.rig_edges = src.stats.rig_edges
                stats.truncated = src.stats.truncated
                stats.enum_method = src.stats.enum_method
                # shared answers share the representative's outcome too
                stats.status = src.stats.status
                stats.error_type = src.stats.error_type
                stats.partial = src.stats.partial
                stats.deadline_exceeded = src.stats.deadline_exceeded
                stats.degradations = list(src.stats.degradations)
                stats.exec_s = 0.0
                self.counters["shared_exec"] += 1
                self._finish(stats, src.count)
                if tr.enabled:
                    # answered from the representative's execution — the
                    # lifecycle phases are structural markers on this copy
                    # (the labels span was already recorded with the group)
                    tr.add("rig", shared=True,
                           rig_nodes=src.stats.rig_nodes)
                    tr.add("enumerate", shared=True, results=src.count,
                           method=src.stats.enum_method)
                    tr.add("materialize", shared=True)
                results[i] = EngineResult(
                    count=src.count, tuples=None, query=qr, plan=entry.plan,
                    stats=stats, key=key,
                    trace=self._finish_trace(tr, key, stats, src.count))

        # serving telemetry: one event per batch member (duplicates too —
        # a served request is a served request), emitted after the whole
        # group resolved so shared answers carry their final stats
        for i in idxs:
            r = results[i]
            self._record_event(r.stats, r.key, r.count, trace_root=r.trace)

    # ------------------------------------------------------------- insight
    def metrics_snapshot(self, prefix: Optional[str] = None
                         ) -> Dict[str, object]:
        """Atomic point-in-time copy of every engine metric (counters,
        cache series, phase/size histograms) — see
        :meth:`repro_torch.obs.metrics.MetricsRegistry.snapshot`.  The transfer
        ledger is published into the registry first, so ``ledger_*`` series
        reflect this instant."""
        self.ledger.publish(self.metrics)
        return self.metrics.snapshot(prefix)

    def metrics_text(self) -> str:
        """Prometheus-style text exposition of the engine registry."""
        self.ledger.publish(self.metrics)
        return prometheus_text(self.metrics)

    @staticmethod
    def render_trace(span: Span, **kw) -> str:
        """Render a ``result.trace`` span tree for the terminal."""
        return render_trace(span, **kw)

    def cache_info(self) -> Dict[str, int]:
        info = {
            "plan_entries": len(self._plan_cache),
            "plan_hits": self._plan_cache.hits,
            "plan_misses": self._plan_cache.misses,
            "plan_evictions": self._plan_cache.evictions,
            "resident_graphs": len(self._residents),
            "label_builds": self.counters["label_builds"],
        }
        return info
