"""Tensor encoding of pattern queries (fixed max_q / max_e padding).

Encoding queries as flat int tensors makes the whole-graph matcher a
function of tensors only, so a batch of queries is the same tensors with
a leading batch dimension (the server's batching axis).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Sequence

import numpy as np
import torch

from ..core.query import PatternQuery

PAD = -1
INF = int(np.iinfo(np.int32).max)


@dataclass
class QueryTensor:
    labels: torch.Tensor      # int32 (..., max_q), PAD on padding
    edge_src: torch.Tensor    # int32 (..., max_e)
    edge_dst: torch.Tensor    # int32 (..., max_e)
    edge_kind: torch.Tensor   # int32 (..., max_e): 0 child, 1 desc, PAD
    n_nodes: torch.Tensor     # int32 (...)
    n_edges: torch.Tensor     # int32 (...)

    @property
    def max_q(self) -> int:
        return self.labels.shape[-1]

    @property
    def max_e(self) -> int:
        return self.edge_src.shape[-1]


def encode_query(q: PatternQuery, max_q: int, max_e: int) -> QueryTensor:
    if q.n > max_q or q.m > max_e:
        raise ValueError(f"query has {q.n} nodes / {q.m} edges, more than "
                         f"max_q={max_q} / max_e={max_e}")
    labels = np.full(max_q, PAD, dtype=np.int32)
    labels[:q.n] = q.labels
    src = np.full(max_e, 0, dtype=np.int32)
    dst = np.full(max_e, 0, dtype=np.int32)
    kind = np.full(max_e, PAD, dtype=np.int32)
    for i, e in enumerate(q.edges):
        src[i], dst[i], kind[i] = e.src, e.dst, e.kind
    return QueryTensor(labels=torch.from_numpy(labels),
                       edge_src=torch.from_numpy(src),
                       edge_dst=torch.from_numpy(dst),
                       edge_kind=torch.from_numpy(kind),
                       n_nodes=torch.tensor(q.n, dtype=torch.int32),
                       n_edges=torch.tensor(q.m, dtype=torch.int32))


def encode_batch(queries: Sequence[PatternQuery], max_q: int,
                 max_e: int) -> QueryTensor:
    qts = [encode_query(q, max_q, max_e) for q in queries]
    return QueryTensor(*(torch.stack([getattr(qt, f.name) for qt in qts])
                         for f in fields(QueryTensor)))


def query_adjacency(qt: QueryTensor) -> torch.Tensor:
    """Undirected (..., max_q, max_q) bool adjacency of the pattern."""
    max_q = qt.max_q
    valid = qt.edge_kind >= 0
    batch = qt.labels.shape[:-1]
    flat = torch.zeros(batch + (max_q * max_q,), dtype=torch.int32,
                       device=qt.labels.device)
    src, dst = qt.edge_src.long(), qt.edge_dst.long()
    # scatter into the flattened (max_q * max_q) pairs: padding edges point
    # at (0, 0) and are masked by ``valid``, so a max-scatter (OR) suffices
    for pairs in (src * max_q + dst, dst * max_q + src):
        flat.scatter_reduce_(-1, pairs, valid.to(torch.int32), reduce="amax")
    return flat.reshape(batch + (max_q, max_q)) > 0


def jo_order(qt: QueryTensor, fb_sizes: torch.Tensor) -> torch.Tensor:
    """JO ordering (§6.1): greedy smallest-candidate-set-first with
    connectivity to the prefix.  ``fb_sizes``: (..., max_q) candidate-set
    cardinalities from the double simulation.  Returns (..., max_q) int32
    (positions >= n_nodes hold PAD).  Ties break to the lowest node id, as
    ``jnp.argmin`` does: ``torch.argmin`` also returns the first minimum."""
    max_q = qt.max_q
    dev = qt.labels.device
    adj = query_adjacency(qt)
    n_nodes = qt.n_nodes.long()[..., None]
    real = torch.arange(max_q, device=dev) < n_nodes           # (..., max_q)
    sizes = torch.where(real, torch.clamp(fb_sizes.long(), max=INF - 1),
                        INF)
    selected = torch.zeros_like(real)
    order = torch.full(real.shape, PAD, dtype=torch.int32, device=dev)
    for i in range(max_q):
        touching = (adj & selected[..., None, :]).any(dim=-1)
        eligible = ~selected & real & (touching if i else True)
        # fall back to any unselected real node (disconnected guard)
        fallback = ~selected & real
        elig = torch.where(eligible.any(dim=-1, keepdim=True), eligible,
                           fallback)
        cost = torch.where(elig, sizes, INF)
        nxt = torch.argmin(cost, dim=-1, keepdim=True)          # (..., 1)
        selected = selected.scatter(-1, nxt, real.gather(-1, nxt))
        order[..., i] = torch.where(i < n_nodes[..., 0],
                                    nxt[..., 0].to(torch.int32), PAD)
    return order
