"""Hybrid graph pattern queries (Def. 3.3) and transitive reduction (§4).

A query is a small directed graph; every node carries a label; every edge is
either a *child* edge ``p/q`` (edge-to-edge mapping) or a *descendant* edge
``p//q`` (edge-to-path mapping).  §4 of the paper minimizes the number of
expensive descendant edges via transitive reduction under the inference
rules::

    (IR1)  x/y            ⊢  x//y
    (IR2)  x//y, y//z     ⊢  x//z
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from ..obs.trace import profiled

CHILD = 0
DESC = 1

_KIND_STR = {CHILD: "/", DESC: "//"}


@dataclass(frozen=True)
class QueryEdge:
    src: int
    dst: int
    kind: int  # CHILD or DESC

    def __repr__(self) -> str:
        return f"{self.src}{_KIND_STR[self.kind]}{self.dst}"


@dataclass
class PatternQuery:
    """A connected, directed, node-labeled hybrid pattern."""

    labels: List[int]
    edges: List[QueryEdge]
    name: str = ""

    def __post_init__(self) -> None:
        es = []
        for e in self.edges:
            if not isinstance(e, QueryEdge):
                e = QueryEdge(int(e[0]), int(e[1]), int(e[2]))
            assert 0 <= e.src < self.n and 0 <= e.dst < self.n
            assert e.src != e.dst, "self-loop pattern edges are not supported"
            es.append(e)
        # dedup: a child edge subsumes a descendant edge on the same pair
        seen: dict[Tuple[int, int], int] = {}
        for e in es:
            key = (e.src, e.dst)
            seen[key] = min(seen.get(key, DESC + 1), e.kind)
        self.edges = [QueryEdge(s, d, k) for (s, d), k in sorted(seen.items())]

    # ------------------------------------------------------------------ views
    @property
    def n(self) -> int:
        return len(self.labels)

    @property
    def m(self) -> int:
        return len(self.edges)

    def out_edges(self, q: int) -> List[QueryEdge]:
        return [e for e in self.edges if e.src == q]

    def in_edges(self, q: int) -> List[QueryEdge]:
        return [e for e in self.edges if e.dst == q]

    def neighbors(self, q: int) -> List[int]:
        out = set()
        for e in self.edges:
            if e.src == q:
                out.add(e.dst)
            if e.dst == q:
                out.add(e.src)
        return sorted(out)

    def adjacency(self) -> np.ndarray:
        a = np.zeros((self.n, self.n), dtype=bool)
        for e in self.edges:
            a[e.src, e.dst] = True
        return a

    def is_connected(self) -> bool:
        if self.n == 0:
            return True
        a = self.adjacency()
        und = a | a.T
        seen = np.zeros(self.n, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            v = stack.pop()
            for w in np.nonzero(und[v])[0]:
                if not seen[w]:
                    seen[w] = True
                    stack.append(int(w))
        return bool(seen.all())

    def is_dag(self) -> bool:
        return self.topological_order() is not None

    def topological_order(self):
        """Kahn.  None if cyclic."""
        indeg = np.zeros(self.n, dtype=np.int64)
        for e in self.edges:
            indeg[e.dst] += 1
        order = [q for q in range(self.n) if indeg[q] == 0]
        head = 0
        while head < len(order):
            v = order[head]
            head += 1
            for e in self.out_edges(v):
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    order.append(e.dst)
        return order if len(order) == self.n else None

    # --------------------------------------------------- closure / reduction
    def reachable_matrix(self, skip: QueryEdge | None = None) -> np.ndarray:
        """Boolean (n, n): r[x, y] = a (simple) directed path x -> y exists,
        optionally ignoring one edge.  Path length >= 1."""
        a = np.zeros((self.n, self.n), dtype=bool)
        for e in self.edges:
            if skip is not None and e == skip:
                continue
            a[e.src, e.dst] = True
        r = a.copy()
        for _ in range(self.n):
            nxt = r | (r @ a)
            if (nxt == r).all():
                break
            r = nxt
        return r

    def full_form(self) -> "PatternQuery":
        """The closure of the query under IR1/IR2 (§4, Fig. 2(b)): add a
        descendant edge for every inferable reachability relationship."""
        r = self.reachable_matrix()
        edges = list(self.edges)
        existing = {(e.src, e.dst) for e in self.edges}
        for x in range(self.n):
            for y in range(self.n):
                if x != y and r[x, y] and (x, y) not in existing:
                    edges.append(QueryEdge(x, y, DESC))
        return PatternQuery(labels=list(self.labels), edges=edges,
                            name=self.name + "+full")

    def transitive_reduction(self) -> "PatternQuery":
        """Remove redundant *descendant* edges (Def. 4.1): a descendant edge
        (x, y) is transitive if a directed path x -> y exists that does not
        use it.  Child edges are never removed (they constrain more).

        Edges are examined in a canonical ``(src, dst)`` order and each test
        runs against the edges left by the removals before it, so that two
        edges cannot "justify" each other's removal (matters only for cyclic
        patterns, where the reduction is not unique — we return one valid
        reduction).

        One ordered pass suffices: a removal only shrinks reachability, so an
        edge found not removable stays not removable for the rest of the
        run, and rescanning from the first edge after each removal would
        re-test those edges and drop none of them.  The pass works on one
        out-neighbour bitmask per node (Python ints, any width) and builds
        a single query at the end.
        """
        with profiled("query.reduce"):
            out = [0] * self.n
            for e in self.edges:
                out[e.src] |= 1 << e.dst
            dropped = set()
            for e in self.edges:   # in (src, dst) order (__post_init__)
                if e.kind != DESC:
                    continue
                bit = 1 << e.dst
                out[e.src] &= ~bit
                if _reaches(out, e.src, bit):
                    dropped.add(e)
                else:
                    out[e.src] |= bit
            name = (self.name + "+tr") if self.name else "tr"
            return PatternQuery(labels=list(self.labels),
                                edges=[e for e in self.edges
                                       if e not in dropped],
                                name=name)

    # ----------------------------------------------------- dag decomposition
    def dag_decomposition(self):
        """Split edges into a spanning DAG + back-edge set Δ (Alg. 3 line 4).

        DFS-based: an edge closing a cycle w.r.t. the DFS (i.e. pointing into
        the current stack) goes to Δ; everything else to the DAG part.
        """
        color = [0] * self.n   # 0 white, 1 gray, 2 black
        dag_edges: List[QueryEdge] = []
        back_edges: List[QueryEdge] = []
        out = {q: self.out_edges(q) for q in range(self.n)}

        def dfs(root: int):
            stack = [(root, 0)]
            color[root] = 1
            while stack:
                v, i = stack[-1]
                if i < len(out[v]):
                    stack[-1] = (v, i + 1)
                    e = out[v][i]
                    if color[e.dst] == 1:
                        back_edges.append(e)
                    else:
                        dag_edges.append(e)
                        if color[e.dst] == 0:
                            color[e.dst] = 1
                            stack.append((e.dst, 0))
                else:
                    color[v] = 2
                    stack.pop()

        for q in range(self.n):
            if color[q] == 0:
                dfs(q)
        # The DAG part might still be cyclic through cross edges in rare
        # multi-root cases; verify and demote offenders.
        dag = PatternQuery(labels=list(self.labels), edges=dag_edges)
        while not dag.is_dag():
            # demote one edge on a cycle
            for e in list(dag.edges):
                test = PatternQuery(labels=list(self.labels),
                                    edges=[x for x in dag.edges if x != e])
                rm = test.reachable_matrix()
                if rm[e.dst, e.src]:   # e closes a cycle
                    back_edges.append(e)
                    dag = test
                    break
            else:
                break
        return dag, back_edges

    # --------------------------------------------------------------- pretty
    def __repr__(self) -> str:
        lab = ",".join(map(str, self.labels))
        ed = " ".join(map(repr, self.edges))
        return f"PatternQuery<{self.name}|labels=[{lab}]|{ed}>"


def _reaches(out: List[int], src: int, target: int) -> bool:
    """Whether a path of one or more edges leads from ``src`` into the
    node bitmask ``target``, over the out-neighbour bitmasks ``out``."""
    seen = 0
    frontier = out[src]
    while frontier:
        if frontier & target:
            return True
        seen |= frontier
        nxt = 0
        while frontier:
            low = frontier & -frontier
            nxt |= out[low.bit_length() - 1]
            frontier ^= low
        frontier = nxt & ~seen
    return False


def query(labels: Sequence[int], edges: Sequence[Tuple[int, int, int]],
          name: str = "") -> PatternQuery:
    return PatternQuery(labels=list(labels),
                        edges=[QueryEdge(*e) for e in edges], name=name)


def paper_example_query() -> PatternQuery:
    """Query Q of Fig. 1(b): A -> B (child), C -> B (child), A // C, B // D,
    D // E, C // E  (labels a=0, b=1, c=2, d=3, e=4)."""
    return query(
        labels=[0, 1, 2, 3, 4],
        edges=[(0, 1, CHILD), (2, 1, CHILD), (0, 2, DESC),
               (1, 3, DESC), (3, 4, DESC), (2, 4, DESC)],
        name="fig1b",
    )
