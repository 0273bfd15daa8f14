"""Search-order strategies for MJoin (§6.1, Table 3).

* ``JO``  — greedy join-based ordering [21] driven by *RIG statistics*:
  start at the query node with the smallest candidate set; repeatedly append
  the unselected node adjacent to the prefix with the smallest |cos|.
* ``RI``  — structure-only ordering [8]: maximize edge constraints to the
  prefix, as early as possible; ties broken by connectivity to unvisited
  neighbourhood, then by degree.
* ``BJ``  — dynamic-programming optimal left-deep plan over estimated join
  costs (exponential in |V_Q|; the paper shows it does not scale past ~10
  nodes — we guard with a node cap).
"""

from __future__ import annotations

from itertools import combinations
from typing import List, Optional

import numpy as np

from .query import PatternQuery
from .rig import RIG


def _adjacent(q: PatternQuery, a: int, b: int) -> bool:
    return any((e.src == a and e.dst == b) or (e.src == b and e.dst == a)
               for e in q.edges)


def order_jo(rig: RIG) -> List[int]:
    q = rig.query
    sizes = [rig.cos_size(i) for i in range(q.n)]
    order = [int(np.argmin(sizes))]
    remaining = set(range(q.n)) - set(order)
    while remaining:
        frontier = [r for r in remaining if any(_adjacent(q, r, s) for s in order)]
        if not frontier:                     # disconnected pattern guard
            frontier = list(remaining)
        nxt = min(frontier, key=lambda r: (sizes[r], r))
        order.append(nxt)
        remaining.discard(nxt)
    return order


def order_ri(q: PatternQuery) -> List[int]:
    """RI [8]: data-independent; prefers nodes maximally constrained by the
    already-ordered prefix (then by future connectivity, then degree)."""
    deg = [len(q.neighbors(i)) for i in range(q.n)]
    order = [int(np.argmax(deg))]
    remaining = set(range(q.n)) - set(order)
    while remaining:
        def key(r: int):
            to_prefix = sum(1 for s in order if _adjacent(q, r, s))
            to_future = sum(1 for s in remaining if s != r and _adjacent(q, r, s))
            return (-to_prefix, -to_future, -deg[r], r)
        nxt = min(remaining, key=key)
        order.append(nxt)
        remaining.discard(nxt)
    return order


def order_bj(rig: RIG, max_nodes: int = 14) -> Optional[List[int]]:
    """DP over subsets for an optimal left-deep plan; cost model = sum of
    estimated intermediate cardinalities with independence-style selectivity
    per connecting edge.  Returns None beyond ``max_nodes`` (the paper's
    scalability point about BJ)."""
    q = rig.query
    n = q.n
    if n > max_nodes:
        return None
    sizes = np.array([max(rig.cos_size(i), 1) for i in range(n)], dtype=np.float64)
    # per-edge selectivity estimate: |occ(e)| / (|cos(src)| * |cos(dst)|)
    sel = {}
    for ei, e in enumerate(q.edges):
        occ = rig.edge_count(ei)
        denom = sizes[e.src] * sizes[e.dst]
        sel[(e.src, e.dst)] = float(occ) / denom if denom else 0.0

    def extend_card(card: float, subset: frozenset, nxt: int) -> float:
        c = card * sizes[nxt]
        for (a, b), s in sel.items():
            if (a in subset and b == nxt) or (b in subset and a == nxt):
                c *= s
        return c

    # DP: best (cost, card, order) per subset
    best = {}
    for v in range(n):
        best[frozenset([v])] = (sizes[v], sizes[v], [v])
    for size in range(1, n):
        layer = [s for s in best if len(s) == size]
        for subset in layer:
            cost, card, order = best[subset]
            for nxt in range(n):
                if nxt in subset:
                    continue
                if size and not any(_adjacent(q, nxt, s) for s in subset):
                    if size < n - 1:   # delay cartesian products
                        continue
                ncard = extend_card(card, subset, nxt)
                ncost = cost + ncard
                key = subset | {nxt}
                if key not in best or ncost < best[key][0]:
                    best[key] = (ncost, ncard, order + [nxt])
    full = frozenset(range(n))
    return best[full][2] if full in best else order_jo(rig)


def get_order(rig: RIG, strategy: str = "jo") -> List[int]:
    if strategy == "jo":
        return order_jo(rig)
    if strategy == "ri":
        return order_ri(rig.query)
    if strategy == "bj":
        o = order_bj(rig)
        return o if o is not None else order_jo(rig)
    raise ValueError(f"unknown ordering strategy: {strategy}")
