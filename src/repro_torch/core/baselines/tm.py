"""TM — the tree-based baseline (§7.1; DagStackD/[46]-style).

Pick a spanning tree Q_T of Q; evaluate Q_T level by level (each tree edge
is a parent→child extension join over its occurrence list); then filter the
tree solutions against the reachability constraints of the non-tree edges.

Faithful to the described weakness: the set of *tree* solutions is fully
materialized before non-tree filtering, so queries whose spanning tree is
unselective blow up — a row budget emulates the paper's TM timeouts
(``TMTimeout``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .. import bitset
from ..graph import DataGraph
from ..query import PatternQuery, QueryEdge
from ..rig import prefilter
from ..simulation import EdgeOracle


class TMTimeout(RuntimeError):
    """Tree-solution budget blown (the paper's TM timeout failure mode)."""


@dataclass
class TMResult:
    count: int
    tuples: np.ndarray
    tree_edges: List[QueryEdge]
    nontree_edges: List[QueryEdge]
    tree_solutions: int
    total_s: float


def spanning_tree(q: PatternQuery) -> Tuple[List[QueryEdge], List[QueryEdge]]:
    """BFS spanning tree over the undirected view, preferring child edges
    (cheaper to evaluate) as tree edges."""
    seen = {0}
    tree: List[QueryEdge] = []
    frontier = [0]
    edges = sorted(q.edges, key=lambda e: e.kind)   # child edges first
    while frontier:
        nxt = []
        for v in frontier:
            for e in edges:
                if e in tree:
                    continue
                other = None
                if e.src == v and e.dst not in seen:
                    other = e.dst
                elif e.dst == v and e.src not in seen:
                    other = e.src
                if other is not None:
                    tree.append(e)
                    seen.add(other)
                    nxt.append(other)
        frontier = nxt
    nontree = [e for e in q.edges if e not in tree]
    return tree, nontree


def tm_match(graph: DataGraph, q: PatternQuery,
             budget_rows: int = 5_000_000,
             use_prefilter: bool = True) -> TMResult:
    t0 = time.perf_counter()
    oracle = EdgeOracle(graph)
    fb = prefilter(graph, q) if use_prefilter else \
        [graph.label_bits(l) for l in q.labels]
    tree, nontree = spanning_tree(q)
    n = graph.n

    # --- evaluate the tree pattern: extension joins along tree edges -------
    tuples = bitset.to_indices(fb[0], n).reshape(-1, 1)
    cols = [0]
    for e in tree:
        anchored_src = e.src in cols
        key = e.src if anchored_src else e.dst
        new = e.dst if anchored_src else e.src
        ki = cols.index(key)
        other_bits = fb[new]
        out = []
        total = 0
        row_cache: Dict[int, np.ndarray] = {}
        for r in tuples:
            v = int(r[ki])
            if v not in row_cache:
                packed = (oracle.fwd_row(v, e.kind) if anchored_src
                          else oracle.bwd_row(v, e.kind)) & other_bits
                row_cache[v] = bitset.to_indices(packed, n)
            ext = row_cache[v]
            total += len(ext)
            if total > budget_rows:
                raise TMTimeout(f"tree solutions > {budget_rows} rows")
            for w in ext:
                out.append(np.concatenate([r, [w]]))
        tuples = (np.stack(out).astype(np.int64) if out
                  else np.empty((0, len(cols) + 1), dtype=np.int64))
        cols = cols + [new]
        if len(tuples) == 0:
            break
    tree_solutions = len(tuples)

    # --- filter non-tree edges ---------------------------------------------
    if len(tuples) and nontree:
        keep = np.ones(len(tuples), dtype=bool)
        for e in nontree:
            si, di = cols.index(e.src), cols.index(e.dst)
            for i in range(len(tuples)):
                if keep[i] and not oracle.is_match(int(tuples[i, si]),
                                                   int(tuples[i, di]), e.kind):
                    keep[i] = False
        tuples = tuples[keep]

    if len(tuples):
        perm = [cols.index(i) for i in range(q.n)]
        tuples = np.unique(tuples[:, perm], axis=0)
    else:
        tuples = np.empty((0, q.n), dtype=np.int64)
    return TMResult(count=len(tuples), tuples=tuples, tree_edges=tree,
                    nontree_edges=nontree, tree_solutions=tree_solutions,
                    total_s=time.perf_counter() - t0)
