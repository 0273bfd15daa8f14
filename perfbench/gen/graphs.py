"""Frozen copy of the port's synthetic labelled-graph generator.

The benchmark makes its data graph here, from the run's seed, so that a
later change to ``repro_torch.data.graphs`` cannot move the yardstick.
The arithmetic is the port's ``random_labeled_graph`` /
``paper_profile_graph`` line for line; ``perfbench/tests`` holds it to the
port's output byte for byte.  The result is the raw edge list (duplicates
included, self loops dropped) and the labels; the harness hands them to
the port through ``graph_from_edge_list`` and to the reference as they are.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np


class RawGraph(NamedTuple):
    edges: np.ndarray      # int64 (E, 2), as generated (duplicates kept)
    labels: np.ndarray     # int64 (n,)
    num_labels: int

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])


def random_labeled_graph(n: int, avg_degree: float = 4.0, n_labels: int = 8,
                         kind: str = "powerlaw", label_skew: float = 1.2,
                         seed: int = 0) -> RawGraph:
    rng = np.random.default_rng(seed)
    n_edges = int(n * avg_degree)

    if kind == "uniform":
        src = rng.integers(0, n, size=n_edges)
        dst = rng.integers(0, n, size=n_edges)
    elif kind == "dag":
        a = rng.integers(0, n, size=n_edges)
        b = rng.integers(0, n, size=n_edges)
        src, dst = np.minimum(a, b), np.maximum(a, b)
    elif kind == "powerlaw":
        src = rng.integers(0, n, size=n_edges)
        ranks = (rng.pareto(1.5, size=n_edges) * 3).astype(np.int64) % n
        perm = rng.permutation(n)
        dst = perm[ranks]
    else:
        raise ValueError(f"unknown graph kind: {kind}")

    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], axis=1)

    w = 1.0 / np.arange(1, n_labels + 1) ** label_skew
    w /= w.sum()
    labels = rng.choice(n_labels, size=n, p=w)
    return RawGraph(edges=edges.astype(np.int64), labels=labels,
                    num_labels=n_labels)


# the paper's Table 1 datasets: (|V|, |E|, |L|, topology family)
PAPER_PROFILES: Dict[str, tuple] = {
    "yeast":    (3_112, 12_519, 71, "uniform"),
    "human":    (4_674, 86_282, 44, "uniform"),
    "hprd":     (9_460, 34_998, 307, "uniform"),
    "epinions": (75_879, 508_837, 20, "powerlaw"),
    "dblp":     (317_080, 1_049_866, 20, "uniform"),
    "email":    (265_214, 420_045, 20, "powerlaw"),
    "amazon":   (403_394, 3_387_388, 3, "uniform"),
    "berkstan": (685_230, 7_600_595, 5, "powerlaw"),
    "google":   (875_713, 5_105_039, 5, "powerlaw"),
}


def paper_profile_graph(name: str, scale: float = 1.0,
                        seed: int = 0) -> RawGraph:
    v, e, l, kind = PAPER_PROFILES[name]
    n = max(int(v * scale), 64)
    return random_labeled_graph(n=n, avg_degree=e / v, n_labels=l,
                                kind=kind, seed=seed)


class Csr:
    """Deduplicated edges and both adjacency directions, sorted as the
    port's ``DataGraph`` sorts them (children and parents ascending), so
    that the frozen query sampler walks the same neighbour lists."""

    def __init__(self, g: RawGraph):
        self.n = g.n
        self.labels = np.asarray(g.labels)
        edges = np.asarray(g.edges, dtype=np.int64).reshape(-1, 2)
        if edges.size:
            edges = np.unique(edges, axis=0)
        self.edges = edges
        self.fwd_indptr, self.fwd_indices = _csr(edges[:, 0], edges[:, 1],
                                                 self.n)
        self.bwd_indptr, self.bwd_indices = _csr(edges[:, 1], edges[:, 0],
                                                 self.n)

    def children(self, v: int) -> np.ndarray:
        return self.fwd_indices[self.fwd_indptr[v]:self.fwd_indptr[v + 1]]

    def parents(self, v: int) -> np.ndarray:
        return self.bwd_indices[self.bwd_indptr[v]:self.bwd_indptr[v + 1]]


def _csr(src: np.ndarray, dst: np.ndarray, n: int):
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int64)
