"""Frozen copy of the port's query sampler, the query normal form, and the
one general traffic generator that every traffic file drives.

``random_query_from_graph`` and ``_assign_kinds`` are the port's
(``repro_torch.data.queries``) line for line, over the frozen
:class:`~perfbench.gen.graphs.Csr` instead of a ``DataGraph``; they return
the raw ``(labels, edges)`` that ``PatternQuery`` takes.  ``normalize`` and
``transitive_reduction`` restate the pattern rules of the paper (Def. 4.1)
for the harness and the reference, so that neither reads them from the
program.

A traffic file (``perfbench/traffic/<mix>.json``) names a ``mix``: entries
of ``n_nodes``, ``qtype`` and ``count``.  :class:`QueryStream` cycles
through blocks holding ``count`` queries of each entry, each block in an
order drawn from the seed, so that every seed sends the same shapes in the
same proportions and only labels, edges and order change.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from .graphs import Csr

CHILD, DESC = 0, 1
Edge = Tuple[int, int, int]


class Query(NamedTuple):
    labels: Tuple[int, ...]
    edges: Tuple[Edge, ...]      # normal form: one edge a pair, sorted

    @property
    def n(self) -> int:
        return len(self.labels)

    @property
    def m(self) -> int:
        return len(self.edges)


def _assign_kinds(edges: Sequence[tuple], qtype: str,
                  rng: np.random.Generator) -> List[Edge]:
    out = []
    for (s, d) in edges:
        if qtype == "C":
            k = CHILD
        elif qtype == "D":
            k = DESC
        elif qtype == "H":
            k = DESC if rng.random() < 0.5 else CHILD
        else:
            raise ValueError(f"unknown query type {qtype}")
        out.append((s, d, k))
    return out


def random_query_from_graph(graph: Csr, n_nodes: int, qtype: str = "H",
                            extra_edge_prob: float = 0.3,
                            seed: int = 0) -> Tuple[List[int], List[Edge]]:
    """A connected subgraph of the data graph with edge kinds drawn by
    ``qtype``: ``(labels, edges)`` as the port's sampler builds them."""
    rng = np.random.default_rng(seed)
    for _attempt in range(64):
        start = int(rng.integers(0, graph.n))
        nodes = [start]
        seen = {start}
        frontier = [start]
        while len(nodes) < n_nodes and frontier:
            v = frontier.pop(int(rng.integers(0, len(frontier))))
            nbrs = np.concatenate([graph.children(v), graph.parents(v)])
            rng.shuffle(nbrs)
            for w in nbrs:
                w = int(w)
                if w not in seen:
                    seen.add(w)
                    nodes.append(w)
                    frontier.append(w)
                    if len(nodes) >= n_nodes:
                        break
        if len(nodes) >= n_nodes:
            break
    nodes = nodes[:n_nodes]
    pos = {v: i for i, v in enumerate(nodes)}
    node_set = set(nodes)
    edges = []
    for v in nodes:
        for w in graph.children(v):
            if int(w) in node_set:
                edges.append((pos[v], pos[int(w)]))
    edges = sorted(set(edges))
    if not edges:
        return random_query_from_graph(graph, n_nodes, qtype,
                                       extra_edge_prob, seed + 1)
    keep = []
    connected = {edges[0][0]}
    pool = list(edges)
    progress = True
    while progress:
        progress = False
        for e in pool:
            if e in keep:
                continue
            if e[0] in connected or e[1] in connected:
                keep.append(e)
                connected |= {e[0], e[1]}
                progress = True
    for e in pool:
        if e not in keep and rng.random() < extra_edge_prob:
            keep.append(e)
    used = sorted({x for e in keep for x in e})
    remap = {v: i for i, v in enumerate(used)}
    keep = [(remap[a], remap[b]) for a, b in keep]
    labels = [int(graph.labels[nodes[v]]) for v in used]
    return labels, _assign_kinds(keep, qtype, rng)


def normalize(labels: Sequence[int], edges: Sequence[Edge]) -> Query:
    """One edge a directed pair, a child edge subsuming a descendant edge
    on the same pair, sorted by (src, dst)."""
    seen = {}
    for s, d, k in edges:
        if s == d or not (0 <= s < len(labels) and 0 <= d < len(labels)):
            raise ValueError(f"bad pattern edge {(s, d, k)}")
        seen[(s, d)] = min(seen.get((s, d), DESC + 1), k)
    return Query(tuple(int(x) for x in labels),
                 tuple((s, d, k) for (s, d), k in sorted(seen.items())))


def _reaches(n: int, edges: Sequence[Edge]) -> np.ndarray:
    a = np.zeros((n, n), dtype=bool)
    for s, d, _ in edges:
        a[s, d] = True
    r = a.copy()
    for _ in range(n):
        nxt = r | (r @ a)
        if (nxt == r).all():
            break
        r = nxt
    return r


def transitive_reduction(q: Query) -> Query:
    """Def. 4.1: drop a descendant edge (x, y) while a path x -> y of
    length >= 1 exists without it; edges in (src, dst) order, the test
    redone after each removal.  Child edges always stay."""
    edges = list(q.edges)
    changed = True
    while changed:
        changed = False
        for e in sorted((e for e in edges if e[2] == DESC),
                        key=lambda e: (e[0], e[1])):
            rest = [x for x in edges if x != e]
            if _reaches(q.n, rest)[e[0], e[1]]:
                edges = rest
                changed = True
                break
    return Query(q.labels, tuple(edges))


def seed_stream(seed: int, stream: int) -> np.random.Generator:
    """The generator of one of a run's streams (graph, traffic, warm-up,
    check sample), from the run's seed."""
    return np.random.default_rng(np.random.SeedSequence(
        [seed % (1 << 63), stream]))


class QueryStream:
    """The traffic of one cell: an endless, seeded sequence of queries
    sampled from the data graph as the traffic file's ``mix`` says.  A
    query whose transitive reduction exceeds ``max_q`` nodes or ``max_e``
    edges is drawn again from the next sampler seed."""

    def __init__(self, graph: Csr, traffic: dict, rng: np.random.Generator,
                 max_q: int, max_e: int):
        self.graph = graph
        self.mix = traffic["mix"]
        self.extra = float(traffic.get("extra_edge_prob", 0.3))
        self.rng = rng
        self.max_q, self.max_e = max_q, max_e
        self._block: List[int] = []

    def _entry(self) -> dict:
        if not self._block:
            block = [i for i, e in enumerate(self.mix)
                     for _ in range(int(e.get("count", 1)))]
            self._block = [block[j] for j in self.rng.permutation(len(block))]
        return self.mix[self._block.pop()]

    def next(self) -> Query:
        e = self._entry()
        sub = int(self.rng.integers(0, 1 << 62))
        while True:
            labels, edges = random_query_from_graph(
                self.graph, int(e["n_nodes"]), e["qtype"], self.extra,
                seed=sub)
            q = normalize(labels, edges)
            tr = transitive_reduction(q)
            if tr.n <= self.max_q and tr.m <= self.max_e:
                return q
            sub += 1

    def take(self, k: int) -> List[Query]:
        return [self.next() for _ in range(k)]
