"""GM — the paper's end-to-end graph-pattern matcher (§5 + §6).

Pipeline: transitive reduction → double simulation (node selection) →
RIG expansion → JO search ordering → MJoin enumeration.  Options expose the
paper's ablation variants:

* ``GM``     — everything on (dagmap simulation, transitive reduction, JO);
* ``GM-S``   — no node pre-filtering (that is the default: the paper only
  adds pre-filtering for C-queries where noted);
* ``GM-F``   — pre-filtering *instead of* double simulation (Fig. 9);
* ``GM-NR``  — no transitive reduction (Fig. 11).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .graph import DataGraph
from .mjoin import (DEFAULT_LIMIT, MJoinResult, MJoinStream, iter_tuples,
                    mjoin, mjoin_batched)
from .ordering import get_order
from .query import PatternQuery
from .rig import RIG, SimAlgo, build_rig
from .simulation import EdgeOracle
from ..obs.trace import NULL_TRACER


@dataclass
class GMOptions:
    use_transitive_reduction: bool = True
    sim_algo: SimAlgo = "dagmap"         # bas | dag | dagmap | none
    sim_passes: Optional[int] = 4        # paper's N=4 truncation; None = exact
    use_prefilter: bool = False
    check_method: str = "bitbat"         # binsearch | bititer | bitbat
    ordering: str = "jo"                 # jo | ri | bj
    enum_method: str = "backtrack"       # see repro_torch.core.mjoin.ENUM_METHODS
    expand_method: str = "bitset"        # bitset | interval (§5.5 early term.)
    limit: Optional[int] = DEFAULT_LIMIT
    materialize: bool = True
    max_tuples: int = 1_000_000
    # device slabs below this many rows are routed through the host
    # intersect (padded-dispatch floor makes them device-unprofitable);
    # 0 = off.  The planner sets this for engine-planned device queries.
    small_frontier_rows: int = 0
    # resource governance (PR 7): an *armed* repro_torch.robust.Budget governing
    # this match (deadline / RIG memory / frontier caps) and the engine's
    # shared device CircuitBreaker; None = ungoverned (zero overhead)
    budget: Optional[object] = field(default=None, repr=False, compare=False)
    breaker: Optional[object] = field(default=None, repr=False, compare=False)
    # warm-path reuse (PR 10): a cached device-resident executor
    # (torchgm.frontier.ResidentIntersector) from a previous enumeration of
    # the same (graph, canonical query).  Attached to the freshly built RIG
    # when its shape fingerprint matches, skipping the re-upload; a
    # mismatch is ignored (a fresh upload happens as usual).
    resident_executor: Optional[object] = field(default=None, repr=False,
                                                compare=False)


@dataclass
class MatchResult:
    count: int
    tuples: Optional[np.ndarray]
    order: List[int]
    rig_nodes: int
    rig_edges: int
    matching_s: float          # TR + simulation + RIG + ordering
    enumerate_s: float
    total_s: float
    sim_passes: int
    truncated: bool
    enum_method: str = "backtrack"       # strategy that actually ran
    deadline_exceeded: bool = False      # budget deadline cut enumeration
    degradations: List[str] = field(default_factory=list)
    # resident-path observability (frontier-device-resident only; zero else)
    resident_uploads: int = 0            # RIG matrices uploaded (0 = cached)
    resident_bytes: int = 0              # resident matrix footprint
    resident_dispatches: int = 0         # fused gather+AND device dispatches
    small_frontier_host_routed: int = 0  # slabs host-routed below threshold
    # transfer ledger (PR 10): host<->device bytes this match moved
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    rig: Optional[RIG] = field(default=None, repr=False)


@dataclass
class MatchStream:
    """Streaming counterpart of :class:`MatchResult`.

    Iterate for ``(chunk, q.n)`` int64 tuple chunks (global ids, query-node
    order) in one-shot lexicographic order; the RIG front half has already
    run (``matching_s``), enumeration advances lazily as chunks are
    consumed.  ``count`` / ``truncated`` / ``enum_method`` are live views
    of the underlying :class:`~repro_torch.core.mjoin.MJoinStream` and are final
    once iteration ends."""

    query: PatternQuery
    stream: MJoinStream
    order: List[int]
    rig_nodes: int
    rig_edges: int
    matching_s: float
    sim_passes: int
    rig: Optional[RIG] = field(default=None, repr=False)

    def __iter__(self):
        return iter(self.stream)

    def close(self) -> None:
        self.stream.close()

    @property
    def count(self) -> int:
        return self.stream.count

    @property
    def truncated(self) -> bool:
        return self.stream.stats.truncated

    @property
    def enum_method(self) -> str:
        return self.stream.stats.method

    @property
    def enumerate_s(self) -> float:
        return self.stream.stats.enumerate_s

    @property
    def deadline_exceeded(self) -> bool:
        return self.stream.stats.deadline_exceeded

    @property
    def degradations(self) -> List[str]:
        return self.stream.stats.degradations

    @property
    def resident_uploads(self) -> int:
        return self.stream.stats.resident_uploads

    @property
    def resident_bytes(self) -> int:
        return self.stream.stats.resident_bytes

    @property
    def resident_dispatches(self) -> int:
        st = self.stream.stats
        return st.device_calls if st.method == "frontier-device-resident" \
            else 0

    @property
    def small_frontier_host_routed(self) -> int:
        return self.stream.stats.small_frontier_host_routed

    @property
    def h2d_bytes(self) -> int:
        return self.stream.stats.h2d_bytes

    @property
    def d2h_bytes(self) -> int:
        return self.stream.stats.d2h_bytes


class GM:
    """Reusable matcher bound to one data graph (shares the reachability
    index and packed adjacency across queries — those are *data* indexes;
    the RIG itself is rebuilt per query, as in the paper)."""

    def __init__(self, graph: DataGraph, options: Optional[GMOptions] = None,
                 intervals=None):
        self.graph = graph
        self.options = options or GMOptions()
        self.oracle = EdgeOracle(graph)
        # DFS interval labels for the §5.5 early-expansion-termination path
        # (expand_method="interval"); the engine shares its per-graph labels
        self.intervals = intervals

    def prepare_rig(self, q: PatternQuery,
                    options: Optional[GMOptions] = None,
                    trace=NULL_TRACER):
        """The matching front half shared by every consumption mode:
        TR + double simulation + RIG expansion + search ordering.

        Returns ``(q, rig, order, matching_s)`` — ``q`` already reduced and
        ``order`` the enumeration order (identity for an empty RIG)."""
        opt = options or self.options
        if opt.expand_method == "interval" and self.intervals is None:
            from .reachability import IntervalLabels
            self.intervals = IntervalLabels.build(self.graph)
        t0 = time.perf_counter()
        with trace.span("rig") as sp:
            if opt.use_transitive_reduction:
                q = q.transitive_reduction()
            rig = build_rig(self.graph, q, self.oracle,
                            sim_algo=opt.sim_algo, sim_passes=opt.sim_passes,
                            use_prefilter=opt.use_prefilter,
                            check_method=opt.check_method,
                            expand_method=opt.expand_method,
                            intervals=self.intervals, trace=trace,
                            budget=opt.budget)
            ex = opt.resident_executor
            if (ex is not None and rig.resident is None
                    and not getattr(ex, "closed", False)):
                from ..torchgm.frontier import resident_fingerprint
                if getattr(ex, "fingerprint",
                           None) == resident_fingerprint(rig):
                    rig.resident = ex     # warm reuse: skip the re-upload
            with trace.span("order") as osp:
                order = (list(range(q.n)) if rig.is_empty()
                         else get_order(rig, opt.ordering))
                osp.set(ordering=opt.ordering, order=list(order))
            if trace.enabled:
                sp.set(rig_nodes=rig.n_nodes(),
                       rig_edges=0 if rig.is_empty() else rig.n_edges(),
                       empty=rig.is_empty())
        return q, rig, order, time.perf_counter() - t0

    def match(self, q: PatternQuery,
              options: Optional[GMOptions] = None,
              trace=NULL_TRACER) -> MatchResult:
        opt = options or self.options
        q, rig, order, matching_s = self.prepare_rig(q, opt, trace=trace)
        t1 = time.perf_counter()
        res: MJoinResult = mjoin(rig, order, limit=opt.limit,
                                 materialize=opt.materialize,
                                 max_tuples=opt.max_tuples,
                                 method=opt.enum_method, trace=trace,
                                 budget=opt.budget, breaker=opt.breaker,
                                 small_frontier_rows=opt.small_frontier_rows)
        t2 = time.perf_counter()
        st = res.stats
        return MatchResult(
            count=res.count, tuples=res.tuples, order=order,
            rig_nodes=rig.n_nodes(),
            rig_edges=0 if rig.is_empty() else rig.n_edges(),
            matching_s=matching_s, enumerate_s=t2 - t1,
            total_s=matching_s + (t2 - t1),
            sim_passes=rig.sim.passes if rig.sim else 0,
            truncated=st.truncated,
            enum_method=(opt.enum_method if rig.is_empty() else st.method),
            deadline_exceeded=st.deadline_exceeded,
            degradations=st.degradations,
            resident_uploads=st.resident_uploads,
            resident_bytes=st.resident_bytes,
            resident_dispatches=(st.device_calls
                                 if st.method == "frontier-device-resident"
                                 else 0),
            small_frontier_host_routed=st.small_frontier_host_routed,
            h2d_bytes=st.h2d_bytes, d2h_bytes=st.d2h_bytes,
            rig=rig)

    def match_stream(self, q: PatternQuery,
                     options: Optional[GMOptions] = None,
                     chunk_size: int = 1024,
                     trace=NULL_TRACER) -> "MatchStream":
        """Streaming counterpart of :meth:`match`: the RIG is built eagerly
        (node selection is existence-checking, not enumeration) but the
        MJoin enumeration is lazy — iterate the returned
        :class:`MatchStream` for ``(chunk_size, q.n)`` tuple chunks in the
        same lexicographic order as one-shot matching."""
        opt = options or self.options
        q, rig, order, matching_s = self.prepare_rig(q, opt, trace=trace)
        stream = iter_tuples(rig, order, chunk_size=chunk_size,
                             limit=opt.limit, method=opt.enum_method,
                             budget=opt.budget, breaker=opt.breaker,
                             small_frontier_rows=opt.small_frontier_rows)
        return MatchStream(query=q, stream=stream, order=order,
                           rig_nodes=rig.n_nodes(),
                           rig_edges=0 if rig.is_empty() else rig.n_edges(),
                           matching_s=matching_s,
                           sim_passes=rig.sim.passes if rig.sim else 0,
                           rig=rig)

    def match_batch_frontier(self, queries: List[PatternQuery],
                             options: Optional[List[GMOptions]] = None,
                             *, intersector=None, traces=None):
        """Counting-mode batch with cross-query micro-batched frontier
        dispatches: every query's RIG is built on the host, then all
        enumerations run under one scheduler that fuses their per-level
        ``(F, K, W)`` constraint gathers into a single ``(ΣF, K, W)`` slab
        per round (one ``intersect`` dispatch shared by the whole batch —
        see :func:`repro_torch.core.mjoin.mjoin_batched`).

        Returns ``(results, dispatches)``; per-query counts equal
        ``match(q, materialize=False)``."""
        opts = options or [self.options] * len(queries)
        trs = traces or [NULL_TRACER] * len(queries)
        jobs, metas, budgets = [], [], []
        breaker = None
        for q, opt, tr in zip(queries, opts, trs):
            q, rig, order, matching_s = self.prepare_rig(q, opt, trace=tr)
            jobs.append((rig, order, opt.limit))
            metas.append((q, rig, order, matching_s))
            budgets.append(opt.budget)
            breaker = breaker or opt.breaker
        mj, dispatches = mjoin_batched(
            jobs, intersector=intersector,
            budgets=budgets if any(b is not None for b in budgets) else None,
            breaker=breaker)
        out = []
        for (q, rig, order, matching_s), res in zip(metas, mj):
            out.append(MatchResult(
                count=res.count, tuples=None, order=order,
                rig_nodes=rig.n_nodes(),
                rig_edges=0 if rig.is_empty() else rig.n_edges(),
                matching_s=matching_s, enumerate_s=res.stats.enumerate_s,
                total_s=matching_s + res.stats.enumerate_s,
                sim_passes=rig.sim.passes if rig.sim else 0,
                truncated=res.stats.truncated,
                enum_method=res.stats.method,
                deadline_exceeded=res.stats.deadline_exceeded,
                degradations=res.stats.degradations,
                resident_uploads=res.stats.resident_uploads,
                resident_bytes=res.stats.resident_bytes,
                small_frontier_host_routed=(
                    res.stats.small_frontier_host_routed),
                h2d_bytes=res.stats.h2d_bytes,
                d2h_bytes=res.stats.d2h_bytes, rig=rig))
        return out, dispatches


def match(graph: DataGraph, q: PatternQuery, **kwargs) -> MatchResult:
    """One-shot convenience wrapper."""
    return GM(graph, GMOptions(**kwargs)).match(q)
