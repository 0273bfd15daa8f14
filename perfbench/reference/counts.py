"""Plain count of a hybrid pattern's homomorphic matches: the reference of
the served path (``QueryServer`` over the engine's device lane).

A match of a query (labels, edges (s, d, kind)) maps every query node to
a data node of the same label, so that a child edge (kind 0) lands on an
edge of the data graph and a descendant edge (kind 1) on a path of length
>= 1; two query nodes may map to the same data node.  The query is the
one sent, not transitively reduced.  Reachability is worked out again from
the edge list (:class:`perfbench.reference.graph.Reach`), with nothing
from the program.

The count is a join, level by level, over the query's nodes: a table of
partial matches, each extended by every data node that fits the next
query node's label and its edges to the nodes already bound.  Departures
from a textbook join, each for time or memory only:

* each node's candidates are first cut to arc consistency: a node stays
  a candidate of a query node while, for every edge at that query node,
  some candidate of the edge's other end fits it; repeated until nothing
  changes (no match is lost: a match's nodes fit each other);
* the order: the node with the fewest candidates first, then the
  connected node with the fewest, lowest id on ties (any order gives the
  same count);
* the table is worked in blocks of ``block`` rows, and each block's
  extensions in parts of at most ``max(block * 64, n)`` rows, depth
  first, so that memory stays at one part a level;
* the last levels are summed, not expanded: from the first level on
  which every later node's edges end at nodes bound before it, a partial
  match's extensions are the product of its numbers of fitting nodes at
  each of those levels (the last level alone, where no such run is
  longer);
* it stops once the sum reaches ``limit`` and returns ``min(count,
  limit)``; a product is cut at ``limit`` on the way, which changes no
  sum below it.

Arithmetic is bool and int64 only, so the comparison is exact.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .graph import Reach


class _Stop(Exception):
    pass


def _order(labels: Sequence[int], edges, sizes: Sequence[int]) -> List[int]:
    n = len(labels)
    nbrs = [set() for _ in range(n)]
    for s, d, _ in edges:
        nbrs[s].add(d)
        nbrs[d].add(s)
    out = [min(range(n), key=lambda v: (sizes[v], v))]
    while len(out) < n:
        bound = set(out)
        near = [v for v in range(n) if v not in bound and nbrs[v] & bound]
        pick = near or [v for v in range(n) if v not in bound]
        out.append(min(pick, key=lambda v: (sizes[v], v)))
    return out


class Counter:
    """Counts queries on one data graph: ``reach`` its reachability,
    ``labels`` its (n,) node labels on the same device."""

    def __init__(self, reach: Reach, labels: torch.Tensor, *,
                 block: int = 8192):
        self.reach = reach
        self.labels = labels
        self.block = block
        self.part = max(block * 64, reach.n)
        dev = reach.device
        self.is_target = torch.zeros(reach.n, dtype=torch.bool, device=dev)
        self.is_target[reach.targets] = True

    def count(self, labels: Sequence[int], edges: Sequence[Tuple[int, int,
                                                                 int]],
              limit: Optional[int] = None) -> int:
        r = self.reach
        dev = r.device
        cand = self._consistent(labels, edges)
        order = _order(labels, edges, [int(c.sum()) for c in cand])
        pos = {v: i for i, v in enumerate(order)}
        levels = []
        for i, v in enumerate(order):
            into = [(pos[s], k) for s, d, k in edges
                    if d == v and pos[s] < i]        # bound -> v
            out_of = [(pos[d], k) for s, d, k in edges
                      if s == v and pos[d] < i]      # v -> bound
            levels.append((torch.nonzero(cand[v]).flatten(), into, out_of))
        self._tail = len(levels) - 1
        while self._tail > 0 and all(
                j < self._tail - 1 for _, into, out_of in
                levels[self._tail - 1:] for j, _ in into + out_of):
            self._tail -= 1
        self._total = 0
        self._limit = limit
        rows = torch.zeros((1, 0), dtype=torch.int64, device=dev)
        try:
            self._level(levels, 0, rows)
        except _Stop:
            pass
        return self._total if limit is None else min(self._total, limit)

    def _consistent(self, labels, edges) -> List[torch.Tensor]:
        """(n,) bool candidates of each query node at arc consistency."""
        r = self.reach
        cand = [self.labels == int(l) for l in labels]
        for _, d, _ in edges:                 # an edge ends at a target
            cand[d] = cand[d] & self.is_target
        changed = True
        while changed:
            changed = False
            for s, d, k in edges:
                rows = r.rows(k)                      # (n, |T|)
                cols = r.pos[torch.nonzero(cand[d]).flatten()]
                src = cand[s] & rows[:, cols].any(dim=1)
                dst = torch.zeros_like(cand[d])
                dst[r.targets] = rows[cand[s]].any(dim=0)
                dst &= cand[d]
                if not (torch.equal(src, cand[s])
                        and torch.equal(dst, cand[d])):
                    cand[s], cand[d] = src, dst
                    changed = True
        return cand

    def _fits(self, level, rows: torch.Tensor) -> torch.Tensor:
        """(len(rows), len(space)) bool: the space's nodes that extend each
        partial match."""
        space, into, out_of = level
        r = self.reach
        ok = torch.ones((len(rows), len(space)), dtype=torch.bool,
                        device=r.device)
        if into:                                 # space lies in the targets
            cols = r.pos[space]
            for j, k in into:
                ok &= r.rows(k)[rows[:, j]][:, cols]
        for j, k in out_of:
            p = r.pos[rows[:, j]]                # the bound end's column
            hit = r.rows(k)[space][:, p.clamp(min=0)].t()
            ok &= hit & (p >= 0)[:, None]
        return ok

    def _product(self, levels, part: torch.Tensor) -> int:
        """Sum over the block's rows of the product of their numbers of
        fitting nodes at each level of the tail."""
        lim = self._limit
        prod = None
        for level in levels[self._tail:]:
            per = self._fits(level, part).sum(dim=1, dtype=torch.int64)
            if prod is None:
                prod = per
            elif lim is not None:
                prod = torch.clamp(prod * per, max=lim)
            else:
                if bool((prod.double() * per.double() >= 2.0 ** 63).any()):
                    raise OverflowError("a count past int64 needs a limit")
                prod = prod * per
        return int(prod.sum())

    def _level(self, levels, i: int, rows: torch.Tensor) -> None:
        for a in range(0, len(rows), self.block):
            part = rows[a:a + self.block]
            if i == self._tail:
                self._total += self._product(levels, part)
                if self._limit is not None and self._total >= self._limit:
                    raise _Stop
                continue
            ok = self._fits(levels[i], part)
            per = ok.sum(dim=1, dtype=torch.int64).cpu().numpy()
            ends = np.cumsum(per)
            lo, base = 0, 0
            while lo < len(part):
                hi = max(lo + 1, int(np.searchsorted(ends, base + self.part,
                                                      side="right")))
                r_id, c_id = torch.nonzero(ok[lo:hi], as_tuple=True)
                if len(r_id):
                    nxt = torch.cat([part[lo:hi][r_id],
                                     levels[i][0][c_id][:, None]], dim=1)
                    self._level(levels, i + 1, nxt)
                base = int(ends[hi - 1])
                lo = hi
