"""Pattern-query workload generators (paper §7.1 "Queries", Fig. 3).

Query sets come in three flavours by edge type — C (child-only), H (hybrid:
each edge descendant with probability 0.5), D (descendant-only) — and four
structural classes: *acyclic*, *cyclic*, *clique* and *combo* (undirected
view has >2 cycles).  We provide the Fig.-3-style templates plus random
queries sampled from connected subgraphs of a target data graph (guarantees
a non-trivial answer, as the paper's biology query sets do).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.graph import DataGraph
from ..core.query import CHILD, DESC, PatternQuery, QueryEdge


# ------------------------------------------------------------ Fig.3 templates
# Each template: (name, class, n_nodes, directed edge list).
TEMPLATES: List[tuple] = [
    # acyclic: paths / trees / dags without undirected cycles
    ("T0_path3",   "acyclic", 3, [(0, 1), (1, 2)]),
    ("T1_path4",   "acyclic", 4, [(0, 1), (1, 2), (2, 3)]),
    ("T2_star4",   "acyclic", 4, [(0, 1), (0, 2), (0, 3)]),
    ("T3_tree5",   "acyclic", 5, [(0, 1), (0, 2), (1, 3), (1, 4)]),
    ("T4_tree6",   "acyclic", 6, [(0, 1), (0, 2), (1, 3), (2, 4), (2, 5)]),
    # cyclic: exactly one/two undirected cycles
    ("T5_tri",     "cyclic", 3, [(0, 1), (1, 2), (0, 2)]),
    ("T6_diamond", "cyclic", 4, [(0, 1), (0, 2), (1, 3), (2, 3)]),
    ("T7_square",  "cyclic", 4, [(0, 1), (1, 2), (2, 3), (0, 3)]),
    ("T8_house",   "cyclic", 5, [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4)]),
    ("T9_cyc5",    "cyclic", 5, [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4)]),
    # cliques (directed acyclically: i -> j for i < j)
    ("T10_cl4",    "clique", 4, [(i, j) for i in range(4) for j in range(i + 1, 4)]),
    ("T11_cl5",    "clique", 5, [(i, j) for i in range(5) for j in range(i + 1, 5)]),
    # combo: > 2 undirected cycles, mixed
    ("T12_combo6", "combo", 6, [(0, 1), (0, 2), (1, 2), (1, 3), (2, 4),
                                (3, 4), (3, 5), (4, 5)]),
    ("T13_combo7", "combo", 7, [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4),
                                (4, 5), (4, 6), (5, 6), (1, 4)]),
    ("T14_combo8", "combo", 8, [(0, 1), (1, 2), (2, 3), (0, 3), (2, 4),
                                (4, 5), (5, 6), (4, 6), (6, 7), (3, 6)]),
]


def _assign_kinds(edges: Sequence[tuple], qtype: str,
                  rng: np.random.Generator) -> List[QueryEdge]:
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
        out.append(QueryEdge(s, d, k))
    return out


def query_from_template(template_idx: int, graph: DataGraph, qtype: str = "H",
                        seed: int = 0) -> PatternQuery:
    """Instantiate a Fig.-3 template: pick node labels from frequent labels
    of the target graph (so match sets are non-trivial)."""
    name, cls, n, edges = TEMPLATES[template_idx % len(TEMPLATES)]
    rng = np.random.default_rng(seed + 1000 * template_idx)
    label_ids = np.array(sorted(graph.inverted.keys()))
    freqs = np.array([len(graph.inverted[int(l)]) for l in label_ids],
                     dtype=np.float64)
    p = freqs / freqs.sum()
    labels = rng.choice(label_ids, size=n, p=p)
    return PatternQuery(labels=[int(l) for l in labels],
                        edges=_assign_kinds(edges, qtype, rng),
                        name=f"{name}_{qtype}")


def template_queries(graph: DataGraph, qtype: str = "H", seed: int = 0,
                     classes: Optional[Sequence[str]] = None) -> List[PatternQuery]:
    out = []
    for i, (name, cls, n, edges) in enumerate(TEMPLATES):
        if classes and cls not in classes:
            continue
        out.append(query_from_template(i, graph, qtype=qtype, seed=seed))
    return out


def random_query_from_graph(graph: DataGraph, n_nodes: int, qtype: str = "H",
                            extra_edge_prob: float = 0.3,
                            seed: int = 0) -> PatternQuery:
    """Random query sampled as a connected subgraph of the data graph (the
    paper's biology query sets [42] are built this way) — guarantees at
    least one occurrence *before* edge-kind assignment; descendant edges can
    only widen the answer, so the query stays satisfiable."""
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
    # keep it connected but not complete: sample a spanning set + extras
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
    return PatternQuery(labels=labels,
                        edges=_assign_kinds(keep, qtype, rng),
                        name=f"rand{n_nodes}_{qtype}_s{seed}")
