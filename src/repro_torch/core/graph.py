"""Data graph representation (Definition 3.1).

A directed, node-labeled graph ``G = (V, E)`` with a finite label alphabet.
The structure keeps:

* CSR adjacency in both directions (children / parents — Def. 3.2),
* per-label inverted lists ``I_a`` (the match sets ``ms(q)`` of query nodes),
* optional packed-bit adjacency and reachability matrices for the bitset
  batch operations of §5.5, built lazily and cached.

The host-faithful algorithms (``repro_torch.core``) operate on this structure; the
device path (``repro_torch.torchgm``) consumes its packed exports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from . import bitset


@dataclass
class DataGraph:
    n: int
    labels: np.ndarray                 # int32 (n,)
    num_labels: int
    edges: np.ndarray                  # int64 (E, 2), deduplicated, no self loops req.

    # --- derived (filled in __post_init__) ---
    fwd_indptr: np.ndarray = field(init=False)
    fwd_indices: np.ndarray = field(init=False)
    bwd_indptr: np.ndarray = field(init=False)
    bwd_indices: np.ndarray = field(init=False)
    inverted: Dict[int, np.ndarray] = field(init=False)

    _adj_bits: Optional[np.ndarray] = field(default=None, init=False, repr=False)
    _adj_bits_t: Optional[np.ndarray] = field(default=None, init=False, repr=False)
    _reach: Optional["object"] = field(default=None, init=False, repr=False)

    def __post_init__(self) -> None:
        self.labels = np.asarray(self.labels, dtype=np.int32)
        assert self.labels.shape == (self.n,)
        edges = np.asarray(self.edges, dtype=np.int64).reshape(-1, 2)
        if edges.size:
            edges = np.unique(edges, axis=0)
        self.edges = edges
        self.fwd_indptr, self.fwd_indices = _csr(edges[:, 0], edges[:, 1], self.n)
        self.bwd_indptr, self.bwd_indices = _csr(edges[:, 1], edges[:, 0], self.n)
        self.inverted = {
            int(l): np.nonzero(self.labels == l)[0]
            for l in np.unique(self.labels)
        }

    # ------------------------------------------------------------------ basics
    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def avg_degree(self) -> float:
        return self.n_edges / max(self.n, 1)

    def children(self, v: int) -> np.ndarray:
        return self.fwd_indices[self.fwd_indptr[v]:self.fwd_indptr[v + 1]]

    def parents(self, v: int) -> np.ndarray:
        return self.bwd_indices[self.bwd_indptr[v]:self.bwd_indptr[v + 1]]

    def out_degree(self) -> np.ndarray:
        return np.diff(self.fwd_indptr)

    def in_degree(self) -> np.ndarray:
        return np.diff(self.bwd_indptr)

    def inverted_list(self, label: int) -> np.ndarray:
        """``I_a``: nodes whose label is ``label`` (sorted)."""
        return self.inverted.get(int(label), np.empty(0, dtype=np.int64))

    def has_edge(self, u: int, v: int) -> bool:
        row = self.children(u)
        i = np.searchsorted(row, v)
        return bool(i < len(row) and row[i] == v)

    # ------------------------------------------------------- packed bit views
    def adj_bits(self) -> np.ndarray:
        """Packed forward adjacency rows: uint64 (n, W); row v = children(v)."""
        if self._adj_bits is None:
            self._adj_bits = _pack_csr(self.fwd_indptr, self.fwd_indices, self.n)
        return self._adj_bits

    def adj_bits_t(self) -> np.ndarray:
        """Packed backward adjacency rows: row v = parents(v)."""
        if self._adj_bits_t is None:
            self._adj_bits_t = _pack_csr(self.bwd_indptr, self.bwd_indices, self.n)
        return self._adj_bits_t

    def reachability(self):
        """Lazily-built reachability oracle (see ``repro_torch.core.reachability``)."""
        if self._reach is None:
            from .reachability import ReachabilityIndex
            self._reach = ReachabilityIndex.build(self)
        return self._reach

    def label_mask(self, label: int) -> np.ndarray:
        mask = np.zeros(self.n, dtype=bool)
        lst = self.inverted_list(label)
        mask[lst] = True
        return mask

    def label_bits(self, label: int) -> np.ndarray:
        return bitset.from_indices(self.inverted_list(label), self.n)

    # ---------------------------------------------------------------- exports
    def adjacency_matrix(self) -> np.ndarray:
        """Dense boolean adjacency (n, n) — small-graph oracles only."""
        a = np.zeros((self.n, self.n), dtype=bool)
        if self.n_edges:
            a[self.edges[:, 0], self.edges[:, 1]] = True
        return a


def _csr(src: np.ndarray, dst: np.ndarray, n: int):
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int64)


def _pack_csr(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n, bitset.n_words(n)), dtype=np.uint64)
    # vectorized scatter of bits
    rows = np.repeat(np.arange(n), np.diff(indptr))
    cols = indices
    if len(cols):
        words = cols >> 6
        shifts = (cols & 63).astype(np.uint64)
        np.bitwise_or.at(out, (rows, words), np.uint64(1) << shifts)
    return out


def graph_from_edge_list(edges, labels, num_labels: Optional[int] = None) -> DataGraph:
    labels = np.asarray(labels, dtype=np.int32)
    n = len(labels)
    if num_labels is None:
        num_labels = int(labels.max()) + 1 if n else 0
    return DataGraph(n=n, labels=labels, num_labels=num_labels,
                     edges=np.asarray(edges, dtype=np.int64).reshape(-1, 2))


def paper_example_graph() -> DataGraph:
    """The data graph of Fig. 1(a).

    Labels a,b,c,d,e -> 0..4.  Node ids: a1..a5 = 0..4, b1..b4 = 5..8,
    c1..c3 = 9..11, d1 = 12, e1 = 13.  The edge set reproduces the figure's
    topology closely enough to exercise every code path (child edges,
    multi-hop descendant paths, shared children); exact-figure fidelity is
    not required by any test that uses it as an oracle input.
    """
    labels = [0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 3, 4]
    a1, a2, a3, a4, a5, b1, b2, b3, b4, c1, c2, c3, d1, e1 = range(14)
    edges = [
        (a1, b1), (a1, b2), (c1, b2), (a2, b2), (a2, c1), (c1, a3),
        (a3, b3), (b2, d1), (b1, c2), (d1, c2), (c2, e1), (b3, c3),
        (c3, e1), (a4, b4), (b4, c3), (a5, b4), (d1, a4),
    ]
    return graph_from_edge_list(edges, labels, num_labels=5)
