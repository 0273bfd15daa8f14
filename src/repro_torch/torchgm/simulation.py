"""Batched double simulation on the card (§5.2–§5.5, whole-graph form).

One pass evaluates *all* query edges with four packed boolean products
(child/descendant × forward/backward) instead of per-edge bitmap sweeps —

    Y_f^child = (A · FBᵀ)  > 0        Y_f^desc = (R · FBᵀ)  > 0
    Y_b^child = (Aᵀ · FBᵀ) > 0        Y_b^desc = (Rᵀ · FBᵀ) > 0

then every edge (p, q, kind) contributes two elementwise masks

    FB'(p) &= Y_f^kind[:, q]          FB'(q) &= Y_b^kind[:, p]

applied jointly (Jacobi style).  The largest double simulation is unique
(§5.2), and Jacobi iteration converges to the same fixpoint as the paper's
Gauss-Seidel sweeps; a truncated pass budget (paper: N=4) keeps FB a sound
over-approximation either way.

Every function takes one query (``QueryTensor`` fields of shape
``(max_q,)``) or a batch (a leading batch dimension).  A batch puts all of
its members' FB rows into the same four ``bitmm`` calls per pass
(``B = batch × max_q`` columns), so each matrix is read once per pass for
the whole batch.  The exact mode iterates until no member changes; passes
past a member's own fixpoint leave it as it is, so each member's FB equals
its single-query result.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..dist.meta import host_int
from ..kernels import ops
from .device_graph import DeviceGraph
from .encoding import QueryTensor


def initial_fb(dg: DeviceGraph, qt: QueryTensor) -> torch.Tensor:
    """FB⁰ = match sets: label agreement (padding never matches)."""
    ql = qt.labels.to(dg.device)[..., :, None]
    return (ql == dg.labels) & (ql >= 0)


def _columns(fb: torch.Tensor) -> torch.Tensor:
    """(Bq, max_q, n_pad) FB -> the (n_pad, Bq * max_q) right operand of
    bitmm, as a transposed view (the kernel packs it along K itself)."""
    return fb.reshape(-1, fb.shape[-1]).t()


def _edges(qt: QueryTensor, device) -> Tuple[int, tuple]:
    """Number of edge slots any batch member uses, and the (Bq, max_e)
    edge tensors on ``device``.  Slots past every member's edge count hold
    padding (kind PAD), which the passes would skip anyway."""
    # traced on meta tensors: every slot, as the reference's static loop
    n_e = host_int(qt.n_edges.max(), qt.max_e) if qt.n_edges.numel() else 0
    cols = tuple(t.reshape(-1, qt.max_e).to(device).long()
                 for t in (qt.edge_src, qt.edge_dst, qt.edge_kind))
    return n_e, cols


def _edge_pass(dg: DeviceGraph, fb: torch.Tensor, n_e: int,
               edges: tuple) -> torch.Tensor:
    """One Jacobi double-simulation pass over a (Bq, max_q, n_pad) FB."""
    bq, max_q, n_pad = fb.shape
    x = _columns(fb)
    y = torch.stack([ops.bitmm(dg.stack[i], x) for i in range(4)])
    # y[mat, b, q] -> (n_pad,): mat 0/1 forward child/desc, 2/3 backward
    y = y.reshape(4, n_pad, bq, max_q).permute(0, 2, 3, 1)
    return apply_edge_masks(fb, y, n_e, edges)


def apply_edge_masks(fb: torch.Tensor, y: torch.Tensor, n_e: int,
                     edges: tuple) -> torch.Tensor:
    """FB (Bq, max_q, n) pruned by one pass's products ``y`` (4, Bq,
    max_q, n) bool: forward child / desc, backward child / desc, each
    column a query node's existence test over the same n nodes."""
    bq = fb.shape[0]
    src, dst, kind = edges
    bidx = torch.arange(bq, device=fb.device)
    keep = torch.ones_like(fb)
    for e in range(n_e):
        s, d, k = src[:, e], dst[:, e], kind[:, e]
        off = ~(k >= 0)[:, None]                  # padding: no constraint
        kk = k.clamp(0, 1)
        # forward: nodes in FB(src) need a kind-successor inside FB(dst)
        keep[bidx, s] &= y[kk, bidx, d] | off
        # backward: nodes in FB(dst) need a kind-predecessor inside FB(src)
        keep[bidx, d] &= y[2 + kk, bidx, s] | off
    return fb & keep


def simulate(dg: DeviceGraph, qt: QueryTensor, *, n_passes: int = 4,
             exact: bool = False) -> Tuple[torch.Tensor, int]:
    """:func:`double_simulation` plus the number of passes it ran."""
    fb = initial_fb(dg, qt)
    single = fb.dim() == 2
    fb = fb.reshape(-1, *fb.shape[-2:])
    n_e, edges = _edges(qt, dg.device)
    passes = 0
    if exact:
        count = fb.sum(dim=(1, 2))
        while True:
            fb = _edge_pass(dg, fb, n_e, edges)
            passes += 1
            new = fb.sum(dim=(1, 2))
            if torch.equal(new, count):
                break
            count = new
    else:
        for _ in range(n_passes):
            fb = _edge_pass(dg, fb, n_e, edges)
        passes = n_passes
    return (fb[0] if single else fb), passes


def double_simulation(dg: DeviceGraph, qt: QueryTensor, *,
                      n_passes: int = 4, exact: bool = False) -> torch.Tensor:
    """FB (..., max_q, n_pad) bool.  ``exact=True`` iterates to the
    fixpoint; otherwise runs the ``n_passes`` budget (the paper's N=4
    truncation)."""
    return simulate(dg, qt, n_passes=n_passes, exact=exact)[0]


def fb_sizes(fb: torch.Tensor) -> torch.Tensor:
    """|cos(q)| per query node: (..., max_q) int32."""
    return fb.sum(dim=-1, dtype=torch.int32)


def rig_edge_counts(dg: DeviceGraph, qt: QueryTensor,
                    fb: torch.Tensor) -> torch.Tensor:
    """Per query edge: number of RIG edges (occurrences within cos sets) —
    the paper's RIG size statistic, computed with sum-semantics bitmm:
    |E_e| = Σ_{v∈cos(src)} |row_kind(v) ∩ cos(dst)|.  (..., max_e)
    float32, as the JAX package returns it; the sums are taken in float64,
    so each count below 2^24 is exact."""
    single = fb.dim() == 2
    fb = fb.reshape(-1, *fb.shape[-2:])
    bq, max_q, n_pad = fb.shape
    x = _columns(fb)
    counts = torch.stack([ops.bitmm(m, x, threshold=False)
                          for m in (dg.adj, dg.reach)])
    counts = counts.reshape(2, n_pad, bq, max_q).permute(0, 2, 3, 1)
    out = edge_sums(fb, counts, qt).to(torch.float32)
    return out[0] if single else out


def edge_sums(fb: torch.Tensor, counts: torch.Tensor,
              qt: QueryTensor) -> torch.Tensor:
    """(Bq, max_e) float64: per query edge, the sum over the nodes v of
    FB(src) (Bq, max_q, n) of ``counts`` (2, Bq, max_q, n) — child / desc
    successors of v inside FB(dst), float32 — taken in float64 (exact);
    0 on padding edges."""
    bq = fb.shape[0]
    _, (src, dst, kind) = _edges(qt, fb.device)
    bidx = torch.arange(bq, device=fb.device)
    out = torch.zeros((bq, qt.max_e), dtype=torch.float64, device=fb.device)
    for e in range(qt.max_e):
        s, d, k = src[:, e], dst[:, e], kind[:, e]
        per_node = torch.where((k == 1)[:, None], counts[1][bidx, d],
                               counts[0][bidx, d])   # (Bq, n)
        masked = torch.where(fb[bidx, s], per_node.double(), 0.0).sum(-1)
        out[:, e] = torch.where(k >= 0, masked, 0.0)
    return out
