"""Plain truncated double simulation: the reference of the sharded filter
step (``gm_serve_step``).

For a batch of queries (transitively reduced, in normal form) on the data
graph: FB⁰(q) = the nodes of q's label; then ``n_passes`` Jacobi passes,
each computed from the FB before it, where every edge (s, d, kind) keeps

    in FB(s) the nodes with a kind-successor in FB(d)
    in FB(d) the nodes with a kind-predecessor in FB(s).

Then, per query edge, the number of RIG edges Σ_{u ∈ FB(s)} |row_kind(u) ∩
FB(d)|, and per query node the first ``top_k`` node ids of FB in ascending
order, padded with -1.  Products are float64 0/1 sums (exact).  Outputs
are laid out as the program's (``max_q`` nodes, ``max_e`` edges a query,
zero / -1 on padding).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..gen.queries import Query
from .graph import Reach


class FilterOut(NamedTuple):
    fb_sizes: np.ndarray      # (B, max_q) int64
    edge_counts: np.ndarray   # (B, max_e) float32
    candidates: np.ndarray    # (B, max_q, top_k) int64


def simulate(reach: Reach, labels: torch.Tensor, queries: List[Query], *,
             max_q: int, max_e: int, n_passes: int,
             top_k: int) -> FilterOut:
    dev = reach.device
    n = reach.n
    tgt = reach.targets
    b = len(queries)
    fb = torch.zeros((b, max_q, n), dtype=torch.bool, device=dev)
    for i, q in enumerate(queries):
        for j, l in enumerate(q.labels):
            fb[i, j] = labels == l
    rows = [reach.rows(k).double() for k in (0, 1)]           # (n, |T|)
    for _ in range(n_passes):
        cols = fb.reshape(b * max_q, n).t().double()          # (n, B*max_q)
        fwd = [(rows[k] @ cols[tgt]) > 0 for k in (0, 1)]
        bwd = [(rows[k].t() @ cols) > 0 for k in (0, 1)]
        keep = torch.ones_like(fb)
        for i, q in enumerate(queries):
            for s, d, k in q.edges:
                keep[i, s] &= fwd[k][:, i * max_q + d]
                back = torch.zeros(n, dtype=torch.bool, device=dev)
                back[tgt] = bwd[k][:, i * max_q + s]
                keep[i, d] &= back
        fb = fb & keep

    sizes = fb.sum(dim=2).cpu().numpy()
    counts = np.zeros((b, max_e), dtype=np.float32)
    cols = fb.reshape(b * max_q, n).t().double()
    succ = [rows[k] @ cols[tgt] for k in (0, 1)]              # (n, BQ)
    for i, q in enumerate(queries):
        for e, (s, d, k) in enumerate(q.edges):
            per_node = succ[k][:, i * max_q + d]
            total = int(round(float((per_node * fb[i, s]).sum().item())))
            counts[i, e] = np.float32(total)
    cand = np.full((b, max_q, top_k), -1, dtype=np.int64)
    for i in range(b):
        for j in range(max_q):
            ids = torch.nonzero(fb[i, j]).flatten()[:top_k].cpu().numpy()
            cand[i, j, :len(ids)] = ids
    return FilterOut(fb_sizes=sizes, edge_counts=counts, candidates=cand)
