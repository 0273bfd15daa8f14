"""Plain reachability of the data graph, for the references.

Worked out again from the edge list that the harness made, with nothing
from the program.  A path of length >= 1 ends at a node that has an
incoming edge, so every reachability row lives on the *targets* ``T`` (the
nodes with in-degree > 0).  The closure ``C`` of the adjacency among the
targets is squared to its fixed point in float64 (exact 0/1 sums), and a
node's row is its own edges into ``T`` joined with their rows of ``C``:

    A_T[u, t] = edge u -> t          R[u, t] = A_T[u, t] or (A_T @ C)[u, t] > 0

``max_hops`` bounds the paths (the controls' broken guarantee: a closure
cut short); ``None`` is the full closure.  Rows are dense over ``T``, so
the memory is ``n * |T|``: on the Table 1 epinions profile 75,879 x 655
(the power-law generator sends every edge to 655 hubs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _bool_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b > 0 for 0/1 bool operands, in float64 (exact: every sum is
    an integer below 2^53)."""
    return (a.double() @ b.double()) > 0


class Reach:
    """The data graph's adjacency and reachability rows on ``device``."""

    def __init__(self, n: int, edges: np.ndarray, device,
                 max_hops: Optional[int] = None):
        dev = self.device = torch.device(device)
        self.n = n
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        edges = np.unique(edges, axis=0) if edges.size else edges
        self.edges = edges
        targets = np.unique(edges[:, 1])
        self.targets = torch.from_numpy(targets).to(dev)
        pos = np.full(n, -1, dtype=np.int64)
        pos[targets] = np.arange(len(targets))
        self.pos = torch.from_numpy(pos).to(dev)
        src = torch.from_numpy(edges[:, 0]).to(dev)
        col = self.pos[torch.from_numpy(edges[:, 1]).to(dev)]
        self.adj = torch.zeros((n, len(targets)), dtype=torch.bool,
                               device=dev)
        self.adj[src, col] = True
        self.reach = self._reach(max_hops)

    def _reach(self, max_hops: Optional[int]) -> torch.Tensor:
        a_tt = self.adj[self.targets]                  # (|T|, |T|)
        if max_hops is not None:
            paths = a_tt.clone()                       # paths of 1 edge
            for _ in range(max(0, max_hops - 2)):      # rows of <= hops-1
                paths = paths | _bool_mm(paths, a_tt)
            if max_hops <= 1:
                return self.adj.clone()
            return self.adj | _bool_mm(self.adj, paths)
        c = a_tt.clone()
        while True:
            nxt = c | _bool_mm(c, c)
            if torch.equal(nxt, c):
                break
            c = nxt
        return self.adj | _bool_mm(self.adj, c)

    def rows(self, kind: int) -> torch.Tensor:
        """(n, |T|) bool: child rows (kind 0) or descendant rows (1)."""
        return self.reach if kind else self.adj

    def block(self, kind: int, rows: torch.Tensor,
              cols: torch.Tensor) -> torch.Tensor:
        """(len(rows), len(cols)) bool: an edge (kind 0) or a path of
        length >= 1 (kind 1) from node rows[i] to node cols[j]."""
        p = self.pos[cols]
        out = torch.zeros((len(rows), len(cols)), dtype=torch.bool,
                          device=self.device)
        hit = p >= 0
        out[:, hit] = self.rows(kind)[rows][:, p[hit]]
        return out
