"""Runtime Index Graph (Def. 5.1) and BuildRIG (Alg. 4, §5.5).

A RIG of query Q over graph G is a k-partite graph: one independent node set
``cos(q)`` per query node with ``os(q) ⊆ cos(q) ⊆ ms(q)``, and, per query
edge (p, q), exactly the query-edge occurrences between surviving candidates.
It losslessly encodes all homomorphisms from Q to G (Prop. 5.1) and is built
on-the-fly per query — never persisted.

BuildRIG = *node selection* (double simulation — existence semantics)
followed by *node expansion* (materialize adjacency — all-matches semantics).

Layout: the RIG is stored *candidate-locally*.  Per query node q, ``cos(q)``
is remapped onto the compact id space ``0..|cos(q)|-1`` (``cand[q][i]`` is
the data-graph node of local id ``i``, sorted ascending), and every query
edge's adjacency is one contiguous packed bit **matrix**
``uint64[|cos(src)|, n_words(|cos(dst)|)]`` — row i = the dst-local
successor set of src-local candidate i.  Compared to a dict of
full-universe bitsets this shrinks every row universe from |V_G| to
|cos(q)|, removes all dict lookups from the MJoin hot loop, and makes the
per-level constraint rows a single ``matrix[frontier]`` gather.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Literal, Optional

import numpy as np

from . import bitset
from .graph import DataGraph
from .query import CHILD, DESC, PatternQuery
from .reachability import IntervalLabels
from .simulation import (EdgeOracle, SimResult, fb_sim, fb_sim_bas,
                         match_sets)
from ..obs.trace import NULL_TRACER
from ..robust import faults

SimAlgo = Literal["bas", "dag", "dagmap", "none"]


@dataclass
class RIG:
    """Materialized runtime index graph (compact candidate-local layout).

    ``fwd[e]`` is a packed bit matrix ``(|cos(src)|, n_words(|cos(dst)|))``:
    row i = RIG successors of src candidate ``cand[src][i]`` w.r.t. query
    edge ``e``, expressed as *dst-local* ids.  ``bwd[e]`` is its packed
    transpose.  Rows are already restricted to both endpoints' candidate
    sets, so MJoin candidate generation is a pure multiway AND of gathered
    rows — ``cos`` itself is the all-ones set in local space.
    """

    query: PatternQuery
    n_graph: int
    cand: List[np.ndarray]         # cos(q) as sorted data-node ids:
                                   #   local id -> global node
    fwd: List[np.ndarray]          # per edge: uint64 (|cos(src)|, W_dst)
    bwd: List[np.ndarray]          # per edge: uint64 (|cos(dst)|, W_src)
    sim: Optional[SimResult] = None
    build_select_s: float = 0.0
    build_expand_s: float = 0.0
    # device-resident executor handle (torchgm.frontier.ResidentIntersector),
    # built lazily on first frontier-device-resident enumeration and cached
    # here so repeated enumerations over one RIG upload the index only once
    resident: Optional[object] = field(default=None, repr=False)
    # ledger attribution key for device transfers / resident footprint
    # (the owning graph's identity; "-" = anonymous)
    graph_key: str = "-"

    def cos_indices(self, q: int) -> np.ndarray:
        return self.cand[q]

    def cos_size(self, q: int) -> int:
        return len(self.cand[q])

    def n_nodes(self) -> int:
        return sum(len(c) for c in self.cand)

    def edge_count(self, e: int) -> int:
        """Number of RIG edges materialized for query edge ``e``."""
        return bitset.count(self.fwd[e])

    def n_edges(self) -> int:
        return sum(self.edge_count(e) for e in range(len(self.fwd)))

    def size(self) -> int:
        """Paper's graph-size metric: |nodes| + |edges|."""
        return self.n_nodes() + self.n_edges()

    def is_empty(self) -> bool:
        return any(len(c) == 0 for c in self.cand)

    def release_resident(self) -> int:
        """Deterministically tear down the cached device-resident executor
        (if any), crediting the transfer ledger; returns bytes freed."""
        res, self.resident = self.resident, None
        if res is not None and hasattr(res, "close"):
            return res.close()
        return 0


# ----------------------------------------------------------- node prefilter
def prefilter(graph: DataGraph, q: PatternQuery) -> List[np.ndarray]:
    """Structural node pre-filtering [10, 49] applied by the paper to JM/TM
    (and to GM variants in Fig. 9): prune v from ms(q) unless its local
    degrees can satisfy q's child-edge fan-in/out, and for descendant edges
    unless v has any successor/predecessor at all when q does.
    """
    # Homomorphisms are not injective, so the sound degree bound is the
    # number of *distinct labels* among child-edge neighbours (targets with
    # different labels must map to different data nodes), not the edge count.
    out_child_labels = [set() for _ in range(q.n)]
    in_child_labels = [set() for _ in range(q.n)]
    out_any = np.zeros(q.n, dtype=np.int64)
    in_any = np.zeros(q.n, dtype=np.int64)
    for e in q.edges:
        out_any[e.src] += 1
        in_any[e.dst] += 1
        if e.kind == CHILD:
            out_child_labels[e.src].add(q.labels[e.dst])
            in_child_labels[e.dst].add(q.labels[e.src])
    odeg = graph.out_degree()
    ideg = graph.in_degree()
    fb = []
    for qi in range(q.n):
        mask = graph.label_mask(q.labels[qi])
        mask &= odeg >= len(out_child_labels[qi])
        mask &= ideg >= len(in_child_labels[qi])
        if out_any[qi] > 0:
            mask &= odeg >= 1
        if in_any[qi] > 0:
            mask &= ideg >= 1
        fb.append(bitset.pack(mask))
    return fb


# ------------------------------------------------------------------ BuildRIG
def build_rig(graph: DataGraph, q: PatternQuery,
              oracle: Optional[EdgeOracle] = None,
              sim_algo: SimAlgo = "dagmap",
              sim_passes: Optional[int] = 4,
              use_prefilter: bool = False,
              check_method: str = "bitbat",
              expand_method: Literal["bitset", "interval"] = "bitset",
              intervals: Optional[IntervalLabels] = None,
              trace=NULL_TRACER, budget=None) -> RIG:
    """Algorithm 4.

    sim_algo:
      * ``bas``    — FBSimBas (arbitrary edge order)
      * ``dag``    — FBSim (Dag+Δ) without change-flag skipping
      * ``dagmap`` — FBSim (Dag+Δ) + §5.5 convergence optimizations (default)
      * ``none``   — skip double simulation (GM-F variant: prefilter only)
    sim_passes: pass budget (paper fixes N=4); None = exact fixpoint.

    ``budget`` (an armed :class:`repro_torch.robust.Budget`) makes the build a
    governed phase: the deadline is checked and the materialized adjacency
    bytes charged against ``max_rig_bytes`` per query edge, raising
    :class:`DeadlineExceeded` / :class:`ResourceExhausted` *before* the
    next edge is gathered.  The RIG is never persisted, so an abandoned
    build costs nothing to recover from — the caller simply recomputes.
    """
    oracle = oracle or EdgeOracle(graph)

    # ---- phase (a): node selection
    t0 = time.perf_counter()
    sim: Optional[SimResult] = None
    with trace.span("select") as sp:
        if use_prefilter:
            fb0 = prefilter(graph, q)
        else:
            fb0 = match_sets(graph, q)
        if sim_algo == "none":
            cos = fb0
        else:
            if sim_algo == "bas":
                sim = fb_sim_bas(graph, q, oracle, max_passes=sim_passes,
                                 method=check_method, fb0=fb0)
            elif sim_algo == "dag":
                sim = fb_sim(graph, q, oracle, max_passes=sim_passes,
                             method=check_method, use_change_flags=False)
            else:
                sim = fb_sim(graph, q, oracle, max_passes=sim_passes,
                             method=check_method, use_change_flags=True)
            cos = sim.fb
            if use_prefilter:
                cos = [a & b for a, b in zip(cos, fb0)]
        n = graph.n
        cand = [bitset.to_indices(c, n) for c in cos]
        if trace.enabled:
            sp.set(sim_algo=sim_algo,
                   sim_passes=sim.passes if sim else 0,
                   converged=sim.converged if sim else True,
                   pruned=sim.pruned if sim else 0,
                   cand_sizes=[len(c) for c in cand])
    t1 = time.perf_counter()

    # ---- phase (b): node expansion — one batched gather + column-compact
    # per query edge: rows = oracle matrix gathered at all src candidates,
    # restricted to dst candidates by the column gather itself (selecting
    # exactly the dst-candidate columns IS the AND against cos(dst)).
    fwd: List[np.ndarray] = []
    bwd: List[np.ndarray] = []
    expand_sp = trace.span("expand").__enter__()
    for ei, e in enumerate(q.edges):
        faults.maybe_fail("rig_expand")
        if budget is not None:
            budget.check_deadline(f"rig_expand[{ei}]")
        src_idx, dst_idx = cand[e.src], cand[e.dst]
        s_n, d_n = len(src_idx), len(dst_idx)
        if s_n == 0 or d_n == 0:
            fwd.append(np.zeros((s_n, bitset.n_words(d_n)), dtype=np.uint64))
            bwd.append(np.zeros((d_n, bitset.n_words(s_n)), dtype=np.uint64))
            continue
        mat = oracle.fwd_matrix(e.kind)
        if (expand_method == "interval" and intervals is not None
                and e.kind == DESC):
            # §5.5 early expansion termination on compact ids: a src
            # candidate v can only reach dst candidates with
            # begin <= end[v], so rows whose plausible prefix is empty are
            # skipped outright — never gathered or unpacked.  The oracle
            # rows are exact, so no further interval masking is needed
            # (and the surviving rows stay packed and chunk-bounded).
            begins = np.sort(intervals.begin[dst_idx])
            hi = np.searchsorted(begins, intervals.end[src_idx],
                                 side="right")
            f = np.zeros((s_n, bitset.n_words(d_n)), dtype=np.uint64)
            live = np.nonzero(hi > 0)[0]
            if len(live):
                f[live] = bitset.gather_columns(mat, src_idx[live],
                                                dst_idx, n)
        else:
            f = bitset.gather_columns(mat, src_idx, dst_idx, n)
        b = bitset.transpose(f, d_n)
        if budget is not None:
            budget.charge_rig(f.nbytes + b.nbytes, f"rig_expand[{ei}]")
        fwd.append(f)
        bwd.append(b)
    rig = RIG(query=q, n_graph=n, cand=cand, fwd=fwd, bwd=bwd, sim=sim,
              graph_key=getattr(graph, "graph_key", "-"))
    if trace.enabled:      # per-edge RIG edge counts cost a popcount each
        expand_sp.set(expand_method=expand_method,
                      edge_counts=[rig.edge_count(e)
                                   for e in range(len(fwd))],
                      rig_nodes=rig.n_nodes())
    expand_sp.__exit__(None, None, None)
    t2 = time.perf_counter()

    rig.build_select_s = t1 - t0
    rig.build_expand_s = t2 - t1
    return rig
