"""JM — the join-based baseline (§7.1; R-Join-style [11]).

Decompose Q into binary relationships (its edges); materialize the
occurrence relation of every edge on G; pick an optimized left-deep plan by
exhaustive dynamic programming over estimated join costs; evaluate as a
sequence of binary hash joins.

Deliberately faithful to the described weaknesses: the per-edge relations
and every intermediate result are fully materialized, so dense/descendant
queries explode — a configurable row budget emulates the paper's
out-of-memory failures deterministically (reported as ``JMBudgetExceeded``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .. import bitset
from ..graph import DataGraph
from ..query import PatternQuery
from ..rig import prefilter
from ..simulation import EdgeOracle


class JMBudgetExceeded(RuntimeError):
    """Intermediate-result budget blown (the paper's JM OOM failure mode)."""


@dataclass
class JMResult:
    count: int
    tuples: np.ndarray
    plan: List[int]                 # edge order
    plans_enumerated: int
    max_intermediate: int
    total_s: float


def _edge_relation(graph: DataGraph, oracle: EdgeOracle, e, fb) -> np.ndarray:
    """Materialize ms(e) restricted to prefiltered candidate sets: (k, 2)."""
    n = graph.n
    src_idx = bitset.to_indices(fb[e.src], n)
    dst_bits = fb[e.dst]
    rows = []
    for v in src_idx:
        row = oracle.fwd_row(int(v), e.kind) & dst_bits
        idx = bitset.to_indices(row, n)
        if len(idx):
            rows.append(np.stack([np.full(len(idx), v, dtype=np.int64), idx], 1))
    if not rows:
        return np.empty((0, 2), dtype=np.int64)
    return np.concatenate(rows, axis=0)


def _hash_join(left: np.ndarray, left_cols: List[int],
               rel: np.ndarray, e_src: int, e_dst: int,
               budget: int) -> Tuple[np.ndarray, List[int]]:
    """Join a tuple relation with a binary edge relation."""
    have_src = e_src in left_cols
    have_dst = e_dst in left_cols
    if have_src and have_dst:
        i, j = left_cols.index(e_src), left_cols.index(e_dst)
        pairs = set(map(tuple, rel))
        keep = np.fromiter(((int(r[i]), int(r[j])) in pairs for r in left),
                           dtype=bool, count=len(left))
        return left[keep], left_cols
    if have_src or have_dst:
        key_col = e_src if have_src else e_dst
        new_col = e_dst if have_src else e_src
        ki = left_cols.index(key_col)
        rel_key = rel[:, 0] if have_src else rel[:, 1]
        rel_val = rel[:, 1] if have_src else rel[:, 0]
        buckets: Dict[int, List[int]] = {}
        for k, v in zip(rel_key, rel_val):
            buckets.setdefault(int(k), []).append(int(v))
        out = []
        total = 0
        for r in left:
            vs = buckets.get(int(r[ki]))
            if not vs:
                continue
            total += len(vs)
            if total > budget:
                raise JMBudgetExceeded(f"intermediate > {budget} rows")
            for v in vs:
                out.append(np.concatenate([r, [v]]))
        new = (np.stack(out) if out
               else np.empty((left.shape[1] + 1, 0)).T.astype(np.int64))
        return new.astype(np.int64), left_cols + [new_col]
    # cartesian (disconnected plan step)
    total = len(left) * len(rel)
    if total > budget:
        raise JMBudgetExceeded(f"cartesian {total} rows > {budget}")
    li = np.repeat(np.arange(len(left)), len(rel))
    ri = np.tile(np.arange(len(rel)), len(left))
    new = np.concatenate([left[li], rel[ri]], axis=1)
    return new.astype(np.int64), left_cols + [e_src, e_dst]


def jm_match(graph: DataGraph, q: PatternQuery,
             budget_rows: int = 5_000_000,
             use_prefilter: bool = True,
             max_plans: int = 5_000_000) -> JMResult:
    t0 = time.perf_counter()
    oracle = EdgeOracle(graph)
    fb = prefilter(graph, q) if use_prefilter else \
        [graph.label_bits(l) for l in q.labels]

    rels = [_edge_relation(graph, oracle, e, fb) for e in q.edges]
    sizes = np.array([max(len(r), 1) for r in rels], dtype=np.float64)
    m = len(q.edges)
    cos_size = np.array([max(bitset.count(b), 1) for b in fb], dtype=np.float64)
    sel = [len(rels[i]) / (cos_size[q.edges[i].src] * cos_size[q.edges[i].dst])
           for i in range(m)]

    # --- exhaustive DP over left-deep edge orders (R-Join style) -----------
    plans_enumerated = 0
    best: Dict[frozenset, Tuple[float, float, frozenset, List[int]]] = {}
    for i in range(m):
        nodes = frozenset({q.edges[i].src, q.edges[i].dst})
        best[frozenset([i])] = (sizes[i], sizes[i], nodes, [i])
    for k in range(1, m):
        for subset in [s for s in list(best) if len(s) == k]:
            cost, card, nodes, order = best[subset]
            for nxt in range(m):
                if nxt in subset:
                    continue
                e = q.edges[nxt]
                overlap = len(nodes & {e.src, e.dst})
                if overlap == 0 and k < m - 1:
                    continue
                if overlap == 2:
                    ncard = card * sel[nxt]
                elif overlap == 1:
                    newn = e.dst if e.src in nodes else e.src
                    ncard = card * cos_size[newn] * sel[nxt]
                else:
                    ncard = card * sizes[nxt]
                plans_enumerated += 1
                if plans_enumerated > max_plans:
                    raise JMBudgetExceeded("plan enumeration exceeded budget")
                key = subset | {nxt}
                ncost = cost + ncard
                if key not in best or ncost < best[key][0]:
                    best[key] = (ncost, ncard,
                                 nodes | {e.src, e.dst}, order + [nxt])
    plan = best[frozenset(range(m))][3]

    # --- execute ------------------------------------------------------------
    e0 = q.edges[plan[0]]
    tuples, cols = rels[plan[0]].copy(), [e0.src, e0.dst]
    max_inter = len(tuples)
    for ei in plan[1:]:
        e = q.edges[ei]
        tuples, cols = _hash_join(tuples, cols, rels[ei], e.src, e.dst,
                                  budget_rows)
        max_inter = max(max_inter, len(tuples))
    # project to query-node order (isolated query nodes cannot occur: Q is
    # connected and every node touches an edge)
    perm = [cols.index(i) for i in range(q.n)]
    tuples = tuples[:, perm] if len(tuples) else np.empty((0, q.n), np.int64)
    tuples = np.unique(tuples, axis=0) if len(tuples) else tuples
    return JMResult(count=len(tuples), tuples=tuples, plan=plan,
                    plans_enumerated=plans_enumerated,
                    max_intermediate=max_inter,
                    total_s=time.perf_counter() - t0)
