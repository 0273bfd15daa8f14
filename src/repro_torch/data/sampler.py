"""GraphSAGE neighbour sampler (the real sampler minibatch_lg requires).

Uniform fan-out sampling over CSR adjacency, layered (e.g. 15-10): seeds →
up to f1 neighbours each → up to f2 neighbours of those.  Produces a
self-contained padded ``GraphBatch`` (static shapes) whose first
``len(seeds)`` nodes are the seeds; padding edges point at a masked sink.
Deterministic per (seed, step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray
    indices: np.ndarray
    feats: np.ndarray          # (N, F)
    labels: np.ndarray         # (N,)

    @property
    def n(self) -> int:
        return len(self.indptr) - 1


def random_csr_graph(n: int, avg_deg: float, d_feat: int, n_classes: int,
                     seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    feats = rng.standard_normal((n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int64),
                    feats=feats, labels=labels)


def sample_blocks(g: CSRGraph, seeds: np.ndarray, fanouts: Sequence[int],
                  rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (nodes, edge_src_local, edge_dst_local): a node-induced
    sampled subgraph whose first len(seeds) entries are the seeds."""
    nodes: List[int] = list(map(int, seeds))
    local = {v: i for i, v in enumerate(nodes)}
    esrc: List[int] = []
    edst: List[int] = []
    frontier = list(map(int, seeds))
    for f in fanouts:
        nxt: List[int] = []
        for v in frontier:
            nbrs = g.indices[g.indptr[v]:g.indptr[v + 1]]
            if len(nbrs) == 0:
                continue
            take = nbrs if len(nbrs) <= f else rng.choice(nbrs, size=f,
                                                          replace=False)
            for w in map(int, take):
                if w not in local:
                    local[w] = len(nodes)
                    nodes.append(w)
                    nxt.append(w)
                # message flows neighbour -> node being refined
                esrc.append(local[w])
                edst.append(local[v])
        frontier = nxt
    return (np.asarray(nodes, np.int64), np.asarray(esrc, np.int64),
            np.asarray(edst, np.int64))


def sampled_batch(g: CSRGraph, batch_nodes: int, fanouts: Sequence[int],
                  step: int, seed: int = 0, pad_nodes: int | None = None,
                  pad_edges: int | None = None) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((seed, step))
    seeds = rng.choice(g.n, size=batch_nodes, replace=False)
    nodes, esrc, edst = sample_blocks(g, seeds, fanouts, rng)

    # worst-case static shapes
    if pad_nodes is None:
        pad_nodes = batch_nodes
        for f in fanouts:
            pad_nodes += pad_nodes * f
        pad_nodes = min(pad_nodes, batch_nodes * int(np.prod(fanouts)) * 2)
    if pad_edges is None:
        pad_edges = pad_nodes
    pad_nodes = max(pad_nodes, len(nodes) + 1)
    pad_edges = max(pad_edges, len(esrc))

    sink = pad_nodes - 1
    node_feat = np.zeros((pad_nodes, g.feats.shape[1]), np.float32)
    node_feat[:len(nodes)] = g.feats[nodes]
    labels = np.zeros(pad_nodes, np.int32)
    labels[:len(nodes)] = g.labels[nodes]
    node_mask = np.zeros(pad_nodes, bool)
    node_mask[:len(nodes)] = True
    train_mask = np.zeros(pad_nodes, bool)
    train_mask[:batch_nodes] = True                 # loss on seeds only
    src = np.full(pad_edges, sink, np.int32)
    dst = np.full(pad_edges, sink, np.int32)
    src[:len(esrc)] = esrc
    dst[:len(edst)] = edst
    return {"node_feat": node_feat, "edge_src": src, "edge_dst": dst,
            "labels": labels, "node_mask": node_mask, "train_mask": train_mask}
