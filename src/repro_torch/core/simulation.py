"""Double simulation (§5.2-§5.4): FBSimBas, FBSimDag and FBSim (Dag+Δ).

The double simulation ``FB`` of query Q by graph G is the largest relation
S ⊆ V_Q × V_G preserving labels plus, for every query edge, the *forward*
(outgoing) and *backward* (incoming) child/descendant constraints.  We
compute it by pruning from the match sets ``ms(q)`` (label inverted lists)
until fixpoint — or until a pass budget is exhausted (§5.5 recommends N=4;
truncation keeps ``FB`` a sound over-approximation, which is all BuildRIG
needs).

Three candidate-check implementations are provided, mirroring Fig. 8(a):

* ``binsearch`` — per-node binary search on sorted CSR adjacency rows,
* ``bititer``   — per-node packed-word AND against the candidate bitset,
* ``bitbat``    — whole-list batched bitset op (the paper's §5.5 batch
  checking; a boolean matrix-vector product over packed rows).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Literal, Optional

import numpy as np

from . import bitset
from .graph import DataGraph
from .query import CHILD, DESC, PatternQuery, QueryEdge

CheckMethod = Literal["binsearch", "bititer", "bitbat"]


# ------------------------------------------------------------------- oracle
@dataclass
class EdgeOracle:
    """Match-set oracle for query edges (child -> adjacency, desc -> ≺).

    Packed row accessors return the set of forward/backward *matches* of a
    node w.r.t. an edge kind; these are exactly the adjacency lists of the
    (maximal) RIG and the operands of every bitset op in §5.5.
    """

    graph: DataGraph
    _reach: object = field(default=None, repr=False)

    def __post_init__(self):
        if self._reach is None:
            self._reach = self.graph.reachability()

    # --- packed rows -------------------------------------------------------
    def fwd_row(self, v: int, kind: int) -> np.ndarray:
        """Packed successors of v under the edge kind (children or ≺-set)."""
        if kind == CHILD:
            return self.graph.adj_bits()[v]
        return self._reach.reach_bits[v]

    def bwd_row(self, v: int, kind: int) -> np.ndarray:
        """Packed predecessors of v under the edge kind."""
        if kind == CHILD:
            return self.graph.adj_bits_t()[v]
        return self._reach.bits_t()[v]

    def fwd_matrix(self, kind: int) -> np.ndarray:
        return self.graph.adj_bits() if kind == CHILD else self._reach.reach_bits

    def bwd_matrix(self, kind: int) -> np.ndarray:
        return self.graph.adj_bits_t() if kind == CHILD else self._reach.bits_t()

    # --- scalar checks -----------------------------------------------------
    def is_match(self, u: int, v: int, kind: int) -> bool:
        if kind == CHILD:
            return self.graph.has_edge(u, v)
        return self._reach.reaches(u, v)


def match_sets(graph: DataGraph, q: PatternQuery) -> List[np.ndarray]:
    """ms(q) for every query node, as packed bitsets over V_G."""
    return [graph.label_bits(l) for l in q.labels]


# ------------------------------------------------- single-constraint pruning
def _prune_once(fb_keep: np.ndarray, other: np.ndarray, matrix: np.ndarray,
                rows_of, method: CheckMethod, graph: DataGraph,
                kind: int, forward: bool, oracle: EdgeOracle) -> np.ndarray:
    """Keep v ∈ fb_keep iff row(v) ∩ other ≠ ∅.  Returns new packed fb_keep.

    ``matrix`` is the packed fwd/bwd row matrix matching direction+kind.
    """
    n = graph.n
    if method == "bitbat":
        # whole-pass batched op: survivors = { v : matrix[v] ∩ other ≠ ∅ }
        alive = bitset.matvec_any(matrix, other)           # bool (n,)
        return fb_keep & bitset.pack(alive)
    cand = bitset.to_indices(fb_keep, n)
    if method == "bititer":
        keep = fb_keep.copy()
        for v in cand:
            if not bitset.intersect_any(matrix[v], other):
                bitset.clear_bit(keep, int(v))
        return keep
    # binsearch: sorted-list membership per neighbour (CSR for child edges;
    # for descendant edges fall back to packed check — the paper's setting
    # uses the reachability index there, not binary search).
    keep = fb_keep.copy()
    other_idx = bitset.to_indices(other, n)
    for v in cand:
        ok = False
        if kind == CHILD:
            row = (graph.children(int(v)) if forward else graph.parents(int(v)))
            if len(row) and len(other_idx):
                pos = np.searchsorted(row, other_idx)
                pos = np.clip(pos, 0, len(row) - 1)
                ok = bool((row[pos] == other_idx).any())
        else:
            ok = bitset.intersect_any(matrix[v], other)
        if not ok:
            bitset.clear_bit(keep, int(v))
    return keep


# ----------------------------------------------------------------- FBSimBas
@dataclass
class SimResult:
    fb: List[np.ndarray]          # packed FB(q) per query node
    passes: int
    converged: bool
    pruned: int                   # total nodes pruned from the match sets
    checks: int = 0               # constraint evaluations (for benchmarks)


def fb_sim_bas(graph: DataGraph, q: PatternQuery, oracle: Optional[EdgeOracle] = None,
               max_passes: Optional[int] = None,
               method: CheckMethod = "bitbat",
               fb0: Optional[List[np.ndarray]] = None) -> SimResult:
    """Algorithm 1 — baseline double-simulation fixpoint.

    Visits query edges in arbitrary (given) order; each pass runs
    forwardPrune then backwardPrune over *all* edges.
    """
    oracle = oracle or EdgeOracle(graph)
    fb = [b.copy() for b in (fb0 or match_sets(graph, q))]
    initial = sum(bitset.count(b) for b in fb)
    passes = 0
    checks = 0
    converged = False
    limit = max_passes if max_passes is not None else 10 * (q.n + 1) * graph.n
    while passes < limit:
        passes += 1
        changed = False
        # forwardPrune: for each edge (qi, qj), prune v from FB(qi) lacking a
        # qualifying successor in FB(qj).
        for e in q.edges:
            new = _prune_once(fb[e.src], fb[e.dst], oracle.fwd_matrix(e.kind),
                              None, method, graph, e.kind, True, oracle)
            checks += 1
            if not np.array_equal(new, fb[e.src]):
                fb[e.src] = new
                changed = True
        # backwardPrune
        for e in q.edges:
            new = _prune_once(fb[e.dst], fb[e.src], oracle.bwd_matrix(e.kind),
                              None, method, graph, e.kind, False, oracle)
            checks += 1
            if not np.array_equal(new, fb[e.dst]):
                fb[e.dst] = new
                changed = True
        if not changed:
            converged = True
            break
    final = sum(bitset.count(b) for b in fb)
    return SimResult(fb=fb, passes=passes, converged=converged,
                     pruned=initial - final, checks=checks)


# ----------------------------------------------------------------- FBSimDag
def fb_sim_dag(graph: DataGraph, q: PatternQuery, oracle: Optional[EdgeOracle] = None,
               max_passes: Optional[int] = None,
               method: CheckMethod = "bitbat",
               fb0: Optional[List[np.ndarray]] = None,
               use_change_flags: bool = True) -> SimResult:
    """Algorithm 2 — exploit DAG structure: each pass is one bottom-up
    (reverse topological) forward sweep + one top-down backward sweep.

    ``use_change_flags`` enables the §5.5 convergence speedup: an edge
    constraint is re-checked only if the other endpoint's candidate set
    changed in the previous sweep ("DagMap" in Fig. 8(b)).
    """
    oracle = oracle or EdgeOracle(graph)
    topo = q.topological_order()
    assert topo is not None, "fb_sim_dag requires a DAG pattern"
    fb = [b.copy() for b in (fb0 or match_sets(graph, q))]
    initial = sum(bitset.count(b) for b in fb)
    dirty = [True] * q.n         # change flags per query node
    passes = 0
    checks = 0
    converged = False
    limit = max_passes if max_passes is not None else 10 * (q.n + 1) * graph.n
    while passes < limit:
        passes += 1
        changed = False
        next_dirty = [False] * q.n
        # forwardSim: reverse topological order, outgoing edges
        for qi in reversed(topo):
            for e in q.out_edges(qi):
                if use_change_flags and not (dirty[e.dst] or dirty[e.src]):
                    continue
                new = _prune_once(fb[qi], fb[e.dst], oracle.fwd_matrix(e.kind),
                                  None, method, graph, e.kind, True, oracle)
                checks += 1
                if not np.array_equal(new, fb[qi]):
                    fb[qi] = new
                    changed = True
                    next_dirty[qi] = True
        # backwardSim: topological order, incoming edges
        for qi in topo:
            for e in q.in_edges(qi):
                if use_change_flags and not (dirty[e.src] or next_dirty[e.src]
                                             or dirty[qi] or next_dirty[qi]):
                    continue
                new = _prune_once(fb[qi], fb[e.src], oracle.bwd_matrix(e.kind),
                                  None, method, graph, e.kind, False, oracle)
                checks += 1
                if not np.array_equal(new, fb[qi]):
                    fb[qi] = new
                    changed = True
                    next_dirty[qi] = True
        dirty = next_dirty
        if not changed:
            converged = True
            break
    final = sum(bitset.count(b) for b in fb)
    return SimResult(fb=fb, passes=passes, converged=converged,
                     pruned=initial - final, checks=checks)


# -------------------------------------------------------------------- FBSim
def fb_sim(graph: DataGraph, q: PatternQuery, oracle: Optional[EdgeOracle] = None,
           max_passes: Optional[int] = None,
           method: CheckMethod = "bitbat",
           use_change_flags: bool = True) -> SimResult:
    """Algorithm 3 — Dag+Δ: decompose Q into a DAG plus back edges, iterate
    (FBSimDag on the DAG part; FBSimBas sweeps on Δ) until stable."""
    oracle = oracle or EdgeOracle(graph)
    if q.is_dag():
        return fb_sim_dag(graph, q, oracle, max_passes=max_passes, method=method,
                          use_change_flags=use_change_flags)
    q_dag, back = q.dag_decomposition()
    delta = PatternQuery(labels=list(q.labels), edges=back) if back else None
    fb = match_sets(graph, q)
    initial = sum(bitset.count(b) for b in fb)
    passes = 0
    checks = 0
    converged = False
    outer_limit = max_passes if max_passes is not None else 10 * (q.n + 1) * graph.n
    while passes < outer_limit:
        passes += 1
        before = [b.copy() for b in fb]
        r1 = fb_sim_dag(graph, q_dag, oracle, max_passes=max_passes, method=method,
                        fb0=fb, use_change_flags=use_change_flags)
        fb = r1.fb
        checks += r1.checks
        if delta is not None:
            r2 = fb_sim_bas(graph, delta, oracle, max_passes=max_passes,
                            method=method, fb0=fb)
            fb = r2.fb
            checks += r2.checks
        if all(np.array_equal(a, b) for a, b in zip(before, fb)):
            converged = True
            break
    final = sum(bitset.count(b) for b in fb)
    return SimResult(fb=fb, passes=passes, converged=converged,
                     pruned=initial - final, checks=checks)
