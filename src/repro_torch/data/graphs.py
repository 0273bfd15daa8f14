"""Synthetic labeled data-graph generators.

The paper evaluates on nine SNAP graphs (Table 1) spanning |V| 3.1K..876K,
average degree 2.6..36.9, and 3..307 labels.  Those datasets are not
available offline, so the benchmark harness regenerates graphs matching the
*structural profile* of each (size, average degree, label count, label skew)
with three topology families:

* ``uniform``   — Erdős–Rényi-style random edges,
* ``powerlaw``  — preferential-attachment out-edges (heavy-tail in-degree,
  like the social/web graphs),
* ``dag``       — edges oriented low→high id (enables the interval-label
  early-termination path).

Labels are Zipf-distributed (the SNAP label sets are highly skewed).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.graph import DataGraph, graph_from_edge_list


def random_labeled_graph(n: int, avg_degree: float = 4.0, n_labels: int = 8,
                         kind: str = "powerlaw", label_skew: float = 1.2,
                         seed: int = 0) -> DataGraph:
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
        # preferential attachment on destinations: sample from a Zipf-ish
        # rank distribution over a random permutation of nodes
        ranks = (rng.pareto(1.5, size=n_edges) * 3).astype(np.int64) % n
        perm = rng.permutation(n)
        dst = perm[ranks]
    else:
        raise ValueError(f"unknown graph kind: {kind}")

    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], axis=1)

    # Zipf labels
    w = 1.0 / np.arange(1, n_labels + 1) ** label_skew
    w /= w.sum()
    labels = rng.choice(n_labels, size=n, p=w)
    return graph_from_edge_list(edges, labels, num_labels=n_labels)


# structural profiles of the paper's Table 1 datasets (|V|, |E|, |L|),
# scaled down by `scale` for laptop-class reproduction runs.
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


def paper_profile_graph(name: str, scale: float = 1.0, seed: int = 0) -> DataGraph:
    v, e, l, kind = PAPER_PROFILES[name]
    n = max(int(v * scale), 64)
    return random_labeled_graph(n=n, avg_degree=e / v, n_labels=l,
                                kind=kind, seed=seed)
