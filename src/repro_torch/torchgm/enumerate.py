"""Frontier-vectorized MJoin on the whole data graph (Alg. 5, level form).

The backtracking enumeration becomes a *level-synchronous frontier
expansion*: a fixed-capacity table of partial assignments is extended one
query node at a time (following the search order), where each extension is
the paper's multiway packed-bitset intersection — ``cos(q_i)`` AND one
data-graph row per bound neighbour — realized as gathers of rows of the
stacked packed matrices plus lane-wise ANDs.  Intermediate results remain
intersections (never joins); a capacity overflow is *detected and
reported*, never silently truncated: the engine turns it into an exact
host re-run.

The search order is known on the host, so the Python loop over levels
applies to each level only the edges that constrain it and stops after
the query's last node (the JAX package masks the remaining levels out).
Frontier expansion — the first ``capacity`` set bits of the candidate
rows in row-major order — runs on the card through the ``expand_pairs``
kernel, which neither syncs with the host nor materialises the unpacked
``(capacity, n_pad)`` bits.  Rows of the frontier that are not alive are
unspecified.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import packed
from ..kernels.gather_intersect import expand_pairs
from .device_graph import DeviceGraph, stacked_matrices
from .encoding import PAD, QueryTensor


class MJoinCount(NamedTuple):
    count: torch.Tensor       # int64 scalar — exact iff not overflowed
    overflowed: torch.Tensor  # bool scalar
    frontier: torch.Tensor    # (capacity, max_q) int32 — last-level partials
    alive: torch.Tensor       # (capacity,) bool


def _host(order) -> np.ndarray:
    """A search order (tensor on any device, or array) as int64 numpy."""
    if isinstance(order, torch.Tensor):
        order = order.cpu().numpy()
    return np.asarray(order, dtype=np.int64)


def _inverse_order(order: np.ndarray, max_q: int) -> np.ndarray:
    # PAD entries clip onto index 0 — a min-scatter, so duplicate writes
    # from padding cannot clobber a real node's position
    inv = np.full(max_q, max_q + 1, dtype=np.int64)   # unreachable position
    safe = np.clip(order, 0, max_q - 1)
    updates = np.where(order >= 0, np.arange(max_q), max_q + 1)
    np.minimum.at(inv, safe, updates)
    return inv


def mjoin_count(dg: DeviceGraph, qt: QueryTensor, fb: torch.Tensor,
                order, *, capacity: int = 4096,
                materialize: bool = False) -> MJoinCount:
    """Count (and optionally materialize up to ``capacity``) occurrences
    of one query.

    fb: (max_q, n_pad) bool — the double-simulation candidate sets;
    order: (max_q,) search order (PAD beyond n_nodes), any device.
    """
    dev = dg.device
    np_, max_q, w = dg.n_pad, qt.max_q, dg.n_words
    mats_flat = stacked_matrices(dg).reshape(4 * np_, w)
    fb_words = packed.pack(fb)                          # (max_q, W)
    order = _host(order)
    inv = _inverse_order(order, max_q)
    n_nodes = int(qt.n_nodes)
    src, dst, kind = (np.asarray(t.cpu(), dtype=np.int64)
                      for t in (qt.edge_src, qt.edge_dst, qt.edge_kind))

    assign = torch.full((capacity, max_q), PAD, dtype=torch.int32,
                        device=dev)
    alive = torch.zeros(capacity, dtype=torch.bool, device=dev)
    alive[0] = True
    total = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    slots = torch.arange(capacity, device=dev)

    for i in range(n_nodes):
        qi = int(np.clip(order[i], 0, max_q - 1))
        is_last = i == n_nodes - 1
        cand = fb_words[qi].expand(capacity, w).clone()
        for e in range(qt.max_e):
            if kind[e] < 0:
                continue
            psrc = inv[np.clip(src[e], 0, max_q - 1)]
            pdst = inv[np.clip(dst[e], 0, max_q - 1)]
            f_app = pdst == i and psrc < i      # src bound -> forward row
            b_app = psrc == i and pdst < i      # dst bound -> backward row
            if not (f_app or b_app):
                continue
            jpos = psrc if f_app else pdst
            mat_id = (0 if f_app else 2) + int(np.clip(kind[e], 0, 1))
            t_col = assign[:, int(np.clip(jpos, 0, max_q - 1))].long()
            rows = mats_flat[mat_id * np_ + t_col.clamp(0, np_ - 1)]
            cand &= rows
        cand = torch.where(alive[:, None], cand, 0)
        level_total = packed.popcount(cand).sum(dtype=torch.int64)
        if is_last:
            total = total + level_total
        else:
            overflow = overflow | (level_total > capacity)
        if is_last and not materialize:
            break
        # expand: the first `capacity` set bits in row-major order
        parent, node = expand_pairs(cand, n_i=np_, size=capacity)
        valid_new = slots < level_total
        assign = assign[parent.long()]
        assign[:, i] = torch.where(valid_new, node, PAD)
        alive = valid_new

    return MJoinCount(count=total, overflowed=overflow, frontier=assign,
                      alive=alive)


def decode_tuples(res: MJoinCount, order, n_nodes: int) -> np.ndarray:
    """Host-side: frontier rows -> occurrence tuples in query-node order."""
    assign = res.frontier.cpu().numpy()[res.alive.cpu().numpy()]
    order = _host(order)[:n_nodes]
    out = np.full((assign.shape[0], n_nodes), -1, dtype=np.int64)
    for pos, qnode in enumerate(order):
        out[:, int(qnode)] = assign[:, pos]
    return out
