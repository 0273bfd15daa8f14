"""Query canonicalization for cross-query caching (planner / RIG stats).

Two isomorphic hybrid patterns (same labels and edge kinds under a node
renaming) have identical optimal plans, so plan-cache keys are computed on a
*canonical form*: the transitive reduction (§4) with nodes renumbered into a
deterministic order.

For small queries (n <= 6, i.e. <= 720 permutations) the canonical order is
exact — minimum over all node permutations of the (labels, edges) encoding.
Larger patterns fall back to iterated color refinement (1-WL) with lexicographic
tie-breaking; that is deterministic (same query text -> same key, so the
cache stays correct) but may assign two isomorphic queries different keys,
costing only a duplicate cache entry.

The same caveat applies to *cyclic* patterns under ``reduce=True``: the
transitive reduction of a cyclic graph is not unique, so two isomorphic
cyclic queries may reduce to non-isomorphic forms and get different keys.
For acyclic patterns (the common case) the reduction is unique and the
key is a true isomorphism invariant — asserted property-based in
``tests/engine/test_planner.py``.
"""

from __future__ import annotations

from itertools import permutations
from typing import List, Tuple

from ..core.query import PatternQuery, QueryEdge

__all__ = ["canonical_form", "canonical_key", "EXACT_MAX_NODES"]

EXACT_MAX_NODES = 6


def _encode(labels: List[int],
            edges: List[Tuple[int, int, int]]) -> Tuple:
    return (tuple(labels), tuple(sorted(edges)))


def _apply(q: PatternQuery, perm: Tuple[int, ...]) -> Tuple:
    """perm[old_index] = new_index."""
    labels = [0] * q.n
    for old, new in enumerate(perm):
        labels[new] = q.labels[old]
    edges = [(perm[e.src], perm[e.dst], e.kind) for e in q.edges]
    return _encode(labels, edges)


def _refined_order(q: PatternQuery) -> Tuple[int, ...]:
    """Deterministic node order from 1-WL color refinement; ties broken by
    original index (stable, text-deterministic)."""
    colors: List[Tuple] = [
        (q.labels[v],
         tuple(sorted((e.kind, q.labels[e.dst]) for e in q.out_edges(v))),
         tuple(sorted((e.kind, q.labels[e.src]) for e in q.in_edges(v))))
        for v in range(q.n)
    ]
    for _ in range(q.n):
        nxt = [
            (colors[v],
             tuple(sorted((e.kind, colors[e.dst]) for e in q.out_edges(v))),
             tuple(sorted((e.kind, colors[e.src]) for e in q.in_edges(v))))
            for v in range(q.n)
        ]
        if len(set(nxt)) == len(set(colors)):
            break
        colors = nxt
    order = sorted(range(q.n), key=lambda v: (colors[v], v))
    perm = [0] * q.n
    for new, old in enumerate(order):
        perm[old] = new
    return tuple(perm)


def canonical_form(q: PatternQuery,
                   reduce: bool = True) -> Tuple[PatternQuery, Tuple[int, ...]]:
    """Return ``(canonical_query, perm)`` with ``perm[old] = new``.

    ``reduce=True`` first applies the transitive reduction, so queries that
    differ only by redundant descendant edges share a canonical form.
    """
    if reduce:
        q = q.transitive_reduction()
    if q.n <= EXACT_MAX_NODES:
        best = None
        best_perm: Tuple[int, ...] = tuple(range(q.n))
        for perm in permutations(range(q.n)):
            enc = _apply(q, perm)
            if best is None or enc < best:
                best, best_perm = enc, perm
        perm = best_perm
    else:
        perm = _refined_order(q)
    labels_enc, edges_enc = _apply(q, perm)
    cq = PatternQuery(labels=list(labels_enc),
                      edges=[QueryEdge(*e) for e in edges_enc])
    return cq, perm


def canonical_key(q: PatternQuery, reduce: bool = True) -> str:
    """Stable string key for plan / RIG-stats caches."""
    cq, _ = canonical_form(q, reduce=reduce)
    labels = ",".join(map(str, cq.labels))
    edges = " ".join(f"{e.src}{'/' if e.kind == 0 else '//'}{e.dst}"
                     for e in cq.edges)
    return f"n{cq.n}|l[{labels}]|e[{edges}]"
