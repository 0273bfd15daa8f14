"""Node-reachability substrate (Def. 3.2 and §5.5).

The paper plugs in *any* reachability labeling scheme; its experiments use
BFL (Bloom Filter Labeling [39]) plus plain adjacency for child edges.  We
provide three interchangeable components:

``ReachabilityIndex``
    SCC condensation + packed-bit transitive closure over the condensation
    DAG.  Exact, O(n·E/64) time, n²/64 bytes.  This powers the *bitset batch*
    operations (matvec-style existence checks and adjacency-row intersection)
    that the device path accelerates with the ``bitmm`` kernel.

``IntervalLabels``
    DFS (begin, end) intervals on a DAG — used for the paper's *early
    expansion termination* (§5.5): within a DAG, ``u`` cannot reach ``v``
    whenever ``u.end < v.begin``.

``BFL``
    A faithful-in-spirit Bloom Filter Labeling: per-node k-bit bloom
    summaries of the reachable set, computed bottom-up over the condensation
    DAG, used as a *negative* filter in front of a guided DFS.  Probe-style
    API (``reaches(u, v)``) like the original; no false negatives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import bitset
from .graph import DataGraph


# --------------------------------------------------------------------------- SCC
def strongly_connected_components(graph: DataGraph):
    """Iterative Tarjan.  Returns (comp_id per node, n_comps).

    Component ids are numbered in *reverse topological order of the
    condensation* (i.e. comp(u) >= comp(v) whenever u can reach v in distinct
    components gets comp(u) > comp(v) after the flip below we instead
    guarantee topological order: comp(u) < comp(v) => u cannot be reached
    from v).  We post-process to a forward topological numbering.
    """
    n = graph.n
    index = np.full(n, -1, dtype=np.int64)
    low = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    comp = np.full(n, -1, dtype=np.int64)
    stack: list[int] = []
    next_index = 0
    n_comps = 0

    indptr, indices = graph.fwd_indptr, graph.fwd_indices

    for root in range(n):
        if index[root] != -1:
            continue
        # each frame: (node, next child pointer)
        work = [(root, indptr[root])]
        index[root] = low[root] = next_index
        next_index += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, ptr = work[-1]
            if ptr < indptr[v + 1]:
                work[-1] = (v, ptr + 1)
                w = indices[ptr]
                if index[w] == -1:
                    index[w] = low[w] = next_index
                    next_index += 1
                    stack.append(int(w))
                    on_stack[w] = True
                    work.append((int(w), indptr[w]))
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            else:
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        comp[w] = n_comps
                        if w == v:
                            break
                    n_comps += 1
    # Tarjan emits components in reverse topological order -> flip.
    comp = (n_comps - 1) - comp
    return comp, n_comps


# ------------------------------------------------------- condensation utils
def _condensation_csr(comp: np.ndarray, n_comps: int, edges: np.ndarray,
                      reverse: bool = False):
    """Deduplicated condensation-DAG adjacency as CSR ``(indptr, succs)``.

    Vectorized: maps every data edge to its component pair, drops
    intra-component pairs, and dedupes with one ``np.unique`` over the
    pair array (no per-edge Python loop).
    """
    if len(edges) == 0:
        return np.zeros(n_comps + 1, dtype=np.int64), \
            np.empty(0, dtype=np.int64)
    cs = comp[edges[:, 0]]
    cd = comp[edges[:, 1]]
    if reverse:
        cs, cd = cd, cs
    keep = cs != cd
    pairs = np.unique(np.stack([cs[keep], cd[keep]], axis=1), axis=0)
    indptr = np.searchsorted(pairs[:, 0], np.arange(n_comps + 1))
    return indptr, pairs[:, 1]


def _self_loop_mask(graph: DataGraph) -> np.ndarray:
    mask = np.zeros(graph.n, dtype=bool)
    if graph.n_edges:
        sl = graph.edges[:, 0] == graph.edges[:, 1]
        mask[graph.edges[sl, 0]] = True
    return mask


# ------------------------------------------------------------------- closure
@dataclass
class ReachabilityIndex:
    """Exact reachability via condensation + packed closure.

    ``reach_bits`` is a packed bit matrix (n, W): row u = set of nodes v with
    u ≺ v (strict per Def. 3.2 — v reachable by a path of length >= 1; a node
    reaches itself only if it lies on a cycle).
    """

    n: int
    comp: np.ndarray              # (n,) component id, topologically numbered
    reach_bits: np.ndarray        # (n, W) packed, node-level closure
    comp_sizes: np.ndarray = None  # (n_comps,) members per component
    reach_bits_t: Optional[np.ndarray] = None   # transpose, built lazily

    @staticmethod
    def build(graph: DataGraph) -> "ReachabilityIndex":
        n = graph.n
        comp, n_comps = strongly_connected_components(graph)
        comp_sizes = np.bincount(comp, minlength=n_comps)

        W = bitset.n_words(n)
        # members packed per component — one vectorized bit scatter
        cmembers = np.zeros((n_comps, W), dtype=np.uint64)
        if n:
            v = np.arange(n)
            np.bitwise_or.at(cmembers, (comp, v >> 6),
                             np.uint64(1) << (v & 63).astype(np.uint64))

        indptr, succs = _condensation_csr(comp, n_comps, graph.edges)
        # components whose members are self-reachable: non-trivial SCCs and
        # singleton components carrying a self loop
        has_loop = np.zeros(n_comps, dtype=bool)
        has_loop[comp[_self_loop_mask(graph)]] = True
        own = (comp_sizes > 1) | has_loop

        # creach[c] = packed set of *data nodes* reachable from component c,
        # including c's own members iff it is cyclic — strictness handled
        # at node level below.  Reverse topological order = descending id.
        creach = np.zeros((n_comps, W), dtype=np.uint64)
        for c in range(n_comps - 1, -1, -1):
            row = succs[indptr[c]:indptr[c + 1]]
            if len(row):
                acc = np.bitwise_or.reduce(creach[row] | cmembers[row],
                                           axis=0)
            else:
                acc = np.zeros(W, dtype=np.uint64)
            if own[c]:
                acc |= cmembers[c]
            creach[c] = acc

        reach = creach[comp]  # (n, W): every node inherits its component row
        return ReachabilityIndex(n=n, comp=comp, reach_bits=reach,
                                 comp_sizes=comp_sizes)

    # ------------------------------------------------------------- interface
    def reaches(self, u: int, v: int) -> bool:
        """u ≺ v (Def. 3.2)."""
        return bitset.get(self.reach_bits[u], v)

    def reach_row(self, u: int) -> np.ndarray:
        """Packed descendant set of u."""
        return self.reach_bits[u]

    def bits_t(self) -> np.ndarray:
        """Packed *ancestor* rows (transpose), built lazily and cached."""
        if self.reach_bits_t is None:
            dense = bitset.unpack(self.reach_bits, self.n)
            self.reach_bits_t = bitset.pack(dense.T)
        return self.reach_bits_t

    def dense(self) -> np.ndarray:
        return bitset.unpack(self.reach_bits, self.n)


# ------------------------------------------------------------ interval labels
@dataclass
class IntervalLabels:
    """DFS (begin, end) intervals (paper §5.5, early expansion termination).

    Guarantee used: if ``end[u] < begin[v]`` then u does not reach v.
    (The converse does not hold — it is a pruning filter only.)

    Built on the SCC *condensation* DAG, with every node inheriting its
    component's interval — this keeps the guarantee sound on arbitrary
    digraphs (within one SCC ``begin <= end`` always holds, so the filter
    never prunes a cyclic pair), which BuildRIG's interval expansion path
    relies on.
    """

    begin: np.ndarray
    end: np.ndarray

    @staticmethod
    def build(graph: DataGraph) -> "IntervalLabels":
        comp, n_comps = strongly_connected_components(graph)
        indptr, succs = _condensation_csr(comp, n_comps, graph.edges)

        begin = np.full(n_comps, -1, dtype=np.int64)
        end = np.full(n_comps, -1, dtype=np.int64)
        clock = 0
        indeg = np.zeros(n_comps, dtype=np.int64)
        if len(succs):
            indeg += np.bincount(succs, minlength=n_comps)
        roots = np.nonzero(indeg == 0)[0]
        visited = np.zeros(n_comps, dtype=bool)
        for root in (*roots, *range(n_comps)):
            if visited[root]:
                continue
            stack = [(int(root), int(indptr[root]))]
            visited[root] = True
            begin[root] = clock
            clock += 1
            while stack:
                v, ptr = stack[-1]
                if ptr < indptr[v + 1]:
                    stack[-1] = (v, ptr + 1)
                    w = int(succs[ptr])
                    if not visited[w]:
                        visited[w] = True
                        begin[w] = clock
                        clock += 1
                        stack.append((w, int(indptr[w])))
                else:
                    stack.pop()
                    end[v] = clock
                    clock += 1
        # propagate: end must cover all descendants even via cross edges.
        # Component ids are topologically numbered, so one descending-id
        # max-fold makes the filter exact on the condensation.
        for c in range(n_comps - 1, -1, -1):
            row = succs[indptr[c]:indptr[c + 1]]
            if len(row):
                end[c] = max(int(end[c]), int(end[row].max()))
        return IntervalLabels(begin=begin[comp], end=end[comp])

    def cannot_reach(self, u: int, v: int) -> bool:
        return bool(self.end[u] < self.begin[v])


# ----------------------------------------------------------------------- BFL
@dataclass
class BFL:
    """Bloom Filter Labeling (Su et al. [39]) — probe-style reachability.

    Each node gets a k-bit bloom summary ``Lout`` of its reachable set (and
    ``Lin`` of its ancestor set), computed bottom-up (top-down) over the
    condensation.  ``reaches`` first applies the two bloom *negative* filters
    and a topological-order filter, then falls back to a bloom-guided DFS.
    Exact (no false negatives by construction; DFS resolves false positives).
    """

    n: int
    bits: int
    comp: np.ndarray
    hash_: np.ndarray          # (n,) node hash in [0, bits)
    lout: np.ndarray           # (n, bits/64) packed bloom of descendants
    lin: np.ndarray            # (n, bits/64) packed bloom of ancestors
    topo: np.ndarray           # (n,) topological rank of the node's component
    graph: DataGraph
    comp_sizes: np.ndarray = None   # (n_comps,) members per component
    self_loop: np.ndarray = None    # (n,) node has a self loop

    stats_probes: int = 0
    stats_dfs: int = 0

    @staticmethod
    def build(graph: DataGraph, bits: int = 256, seed: int = 0) -> "BFL":
        n = graph.n
        comp, n_comps = strongly_connected_components(graph)
        comp_sizes = np.bincount(comp, minlength=n_comps)
        rng = np.random.default_rng(seed)
        hash_ = rng.integers(0, bits, size=n, dtype=np.int64)
        W = bits // 64
        assert bits % 64 == 0

        # component-level bloom of member hashes — one vectorized scatter
        cbloom_out = np.zeros((n_comps, W), dtype=np.uint64)
        if n:
            np.bitwise_or.at(
                cbloom_out, (comp, hash_ >> 6),
                np.uint64(1) << (hash_ & 63).astype(np.uint64))
        cbloom_in = cbloom_out.copy()

        indptr, succs = _condensation_csr(comp, n_comps, graph.edges)
        rptr, preds = _condensation_csr(comp, n_comps, graph.edges,
                                        reverse=True)
        for c in range(n_comps - 1, -1, -1):
            row = succs[indptr[c]:indptr[c + 1]]
            if len(row):
                cbloom_out[c] |= np.bitwise_or.reduce(cbloom_out[row],
                                                      axis=0)
        for c in range(n_comps):
            row = preds[rptr[c]:rptr[c + 1]]
            if len(row):
                cbloom_in[c] |= np.bitwise_or.reduce(cbloom_in[row], axis=0)

        return BFL(n=n, bits=bits, comp=comp, hash_=hash_,
                   lout=cbloom_out[comp], lin=cbloom_in[comp],
                   topo=comp.astype(np.int64), graph=graph,
                   comp_sizes=comp_sizes, self_loop=_self_loop_mask(graph))

    def _bloom_neg(self, u: int, v: int) -> bool:
        """True => definitely NOT reachable."""
        hv = self.hash_[v]
        if not (self.lout[u, hv >> 6] >> np.uint64(hv & 63)) & np.uint64(1):
            return True
        hu = self.hash_[u]
        if not (self.lin[v, hu >> 6] >> np.uint64(hu & 63)) & np.uint64(1):
            return True
        return False

    def reaches(self, u: int, v: int) -> bool:
        self.stats_probes += 1
        cu, cv = self.comp[u], self.comp[v]
        if cu == cv:
            # same SCC: reachable iff the SCC is non-trivial or self-loop.
            # Component sizes are precomputed in build — this probe used to
            # rescan the whole comp array (O(n) per reaches call).
            if u == v:
                return bool(self.self_loop[u]) or self.comp_sizes[cu] >= 2
            return bool(self.comp_sizes[cu] >= 2)
        if self.topo[u] > self.topo[v]:   # topological filter
            return False
        if self._bloom_neg(u, v):
            return False
        # bloom-guided DFS over the data graph
        self.stats_dfs += 1
        seen = set([u])
        stack = [u]
        while stack:
            x = stack.pop()
            for w in self.graph.children(int(x)):
                w = int(w)
                if w == v:
                    return True
                if w in seen:
                    continue
                if self.topo[w] > self.topo[v]:
                    continue
                if self._bloom_neg(w, v):
                    continue
                seen.add(w)
                stack.append(w)
        return False
