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
A level — each live row's candidate row ANDed with one gathered row per
constraining edge, its count, and the expansion into the first
``capacity`` set bits in row-major order — is one ``gather_expand``
call: on the card a fused kernel that reads only the live rows' gathered
rows, never writes the AND rows, and never syncs with the host.  The
live rows are always a prefix of the frontier (``alive = slots <
level_total``), so a level passes their number, ``n_alive``, as a device
scalar.  Rows of the frontier that are not alive are unspecified.

With ``page_on_device`` a level wider than ``capacity`` is not reported
but paged: the level's rows are cut, by the inclusive scan of their
counts that ``gather_expand`` returns, into ranges whose expansion fits
in ``capacity``, and each range's page is carried down to the last level
before the next range is expanded (depth first), so a level holds one
page at a time.  The last level is counted, never expanded, and the
enumeration stops once the count reaches ``limit``: the result is then
exactly ``limit``, reported as truncated.  Each page waits for its count
on the host, which the cut needs.  Where every level from some level
on has edges only to nodes bound before that level (a star's leaves once
its centre is bound), those levels constrain each other in nothing: a
row's extensions through all of them are the product of its counts at
each, and the page is counted so, without expanding them.

Each page is the ``torch.profiler`` range ``repro_torch.enumerate.page``
(one check without a profiler), and the process-wide registry counts
``enum_queries``, ``enum_pages`` (the levels' ``gather_expand`` calls)
and ``enum_limit_hits``, on the host, from numbers the loop has already
read; nothing is counted on ``meta`` tensors.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import packed
from ..kernels.gather_intersect import gather_expand
from ..obs.metrics import get_registry
from ..obs.trace import profiled
from .device_graph import DeviceGraph, stacked_matrices
from .encoding import PAD, QueryTensor


class MJoinCount(NamedTuple):
    count: torch.Tensor       # int64 scalar — exact iff not overflowed
    overflowed: torch.Tensor  # bool scalar
    frontier: torch.Tensor    # (capacity, max_q) int32 — last-level partials
    alive: torch.Tensor       # (capacity,) bool
    truncated: bool = False   # paged: the count stopped at ``limit``


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


def _level_plan(qt: QueryTensor, order: np.ndarray, n_pad: int
                ) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Per level i of the search order: (the query node bound there, the
    constraining edges as (frontier column of the bound end, offset of
    its matrix's rows in the stacked matrices' flat view))."""
    max_q = qt.max_q
    inv = _inverse_order(order, max_q)
    src, dst, kind = (np.asarray(t.cpu(), dtype=np.int64)
                      for t in (qt.edge_src, qt.edge_dst, qt.edge_kind))
    plan = []
    for i in range(int(qt.n_nodes)):
        qi = int(np.clip(order[i], 0, max_q - 1))
        cons = []
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
            cons.append((int(np.clip(jpos, 0, max_q - 1)), mat_id * n_pad))
        plan.append((qi, cons))
    return plan


def _level_idx(assign: torch.Tensor, cons, n_pad: int) -> torch.Tensor:
    """(F, Kc) int32 rows of the stacked matrices that each frontier row
    gathers at one level."""
    if not cons:
        return torch.empty((assign.shape[0], 0), dtype=torch.int32,
                           device=assign.device)
    return torch.stack([assign[:, j].clamp(0, n_pad - 1) + off
                        for j, off in cons], dim=1)


def _count(dev, queries: int, pages: int, limit_hits: int) -> None:
    if dev.type == "meta":
        return
    reg = get_registry()
    reg.counter("enum_queries").inc(queries)
    reg.counter("enum_pages").inc(pages)
    if limit_hits:
        reg.counter("enum_limit_hits").inc(limit_hits)


def mjoin_count(dg: DeviceGraph, qt: QueryTensor, fb: torch.Tensor,
                order, *, capacity: int = 4096,
                materialize: bool = False, limit: Optional[int] = None,
                page_on_device: bool = False) -> MJoinCount:
    """Count (and optionally materialize up to ``capacity``) occurrences
    of one query.

    fb: (max_q, n_pad) bool — the double-simulation candidate sets;
    order: (max_q,) search order (PAD beyond n_nodes), any device.

    ``page_on_device`` pages levels wider than ``capacity`` instead of
    reporting ``overflowed`` (never set then), and stops at ``limit``
    (None: count everything); it counts only, and needs ``capacity`` >=
    ``n_pad``, the most one row can expand to.  Without it ``limit`` is
    not used: the count is exact unless ``overflowed``.
    """
    dev = dg.device
    np_, max_q = dg.n_pad, qt.max_q
    mats_flat = stacked_matrices(dg).reshape(4 * np_, dg.n_words)
    fb_words = packed.pack(fb)                          # (max_q, W)
    plan = _level_plan(qt, _host(order), np_)
    if page_on_device:
        return _mjoin_paged(mats_flat, fb_words, plan, n_pad=np_,
                            max_q=max_q, capacity=capacity, limit=limit,
                            materialize=materialize)

    assign = torch.full((capacity, max_q), PAD, dtype=torch.int32,
                        device=dev)
    alive = torch.zeros(capacity, dtype=torch.bool, device=dev)
    alive[0] = True
    # live frontier rows: always the prefix `alive` marks
    n_alive = torch.ones((), dtype=torch.int64, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    slots = torch.arange(capacity, device=dev)

    pages = 0
    for i, (qi, cons) in enumerate(plan):
        is_last = i == len(plan) - 1
        idx = _level_idx(assign, cons, np_)
        expand = not is_last or materialize
        # count, and expand: the first `capacity` set bits in row-major order
        with profiled("enumerate.page"):
            level_total, parent, node = gather_expand(
                mats_flat, fb_words[qi], idx, n_alive, n_i=np_,
                size=capacity, expand=expand)
        pages += 1
        if is_last:
            total = total + level_total
        else:
            overflow = overflow | (level_total > capacity)
        if not expand:
            break
        valid_new = slots < level_total
        assign = assign[parent.long()]
        assign[:, i] = torch.where(valid_new, node, PAD)
        alive = valid_new
        n_alive = level_total.clamp(max=capacity)
    _count(dev, 1, pages, 0)

    return MJoinCount(count=total, overflowed=overflow, frontier=assign,
                      alive=alive)


class _LimitReached(Exception):
    pass


def _cut(incl: np.ndarray, capacity: int) -> List[Tuple[int, int, int]]:
    """Greedy ranges [a, b) of rows whose expansions (``incl``: the rows'
    inclusive scan) sum to at most ``capacity`` each, as (a, b, pairs);
    every row expands to at most ``capacity``."""
    out, a, base = [], 0, 0
    n = len(incl)
    while a < n:
        b = int(np.searchsorted(incl, base + capacity, side="right"))
        end = int(incl[b - 1])
        out.append((a, b, end - base))
        a, base = b, end
    return out


def _tail(plan) -> int:
    """The first level from which on every level's edges end at nodes
    bound before it: those levels constrain each other in nothing, so a
    partial match's extensions through all of them are the product of
    its counts at each."""
    i = len(plan) - 1
    while i > 0 and all(j < i - 1 for _, cons in plan[i - 1:]
                        for j, _ in cons):
        i -= 1
    return i


def _mjoin_paged(mats_flat, fb_words, plan, *, n_pad: int, max_q: int,
                 capacity: int, limit: Optional[int],
                 materialize: bool) -> MJoinCount:
    """Depth-first paged enumeration (see the module's docstring)."""
    dev = mats_flat.device
    if materialize:
        raise ValueError("page_on_device counts only: materialize needs "
                         "page_on_device=False")
    if capacity < n_pad:
        raise ValueError(f"page_on_device needs capacity >= n_pad (one "
                         f"row expands to up to {n_pad} pairs), got "
                         f"capacity={capacity}")
    # every row of a page is live: gather_expand takes min(n_alive, F)
    every = torch.full((), capacity, dtype=torch.int64, device=dev)
    tail = _tail(plan)
    # a row's product saturates here: at the limit, or where int64 ends
    cap = limit if limit is not None else (1 << 63) - 1
    # a product at most the limit times a count (< n_pad) fits in int64
    clamped = limit is not None and limit < (1 << 63) // n_pad
    state = {"count": 0, "pages": 0}

    def count_tail(assign: torch.Tensor) -> None:
        """Sum over the page's rows of the product of their counts at the
        tail's levels, each product cut at ``cap``."""
        many = tail < len(plan) - 1
        prod = None
        for qi, cons in plan[tail:]:
            idx = _level_idx(assign, cons, n_pad)
            with profiled("enumerate.page"):
                out = gather_expand(mats_flat, fb_words[qi], idx, every,
                                    n_i=n_pad, size=0, expand=False,
                                    scan=many)
            state["pages"] += 1
            if not many:
                prod = out[0]
                break
            per = torch.diff(out[3], prepend=out[3].new_zeros(1))
            if prod is None:
                prod = per
            elif clamped:
                prod = torch.clamp(prod * per, max=cap)
            else:
                if bool(((prod.double() * per.double()) >= 2.0 ** 63).any()):
                    raise OverflowError("a count past int64 needs a limit")
                prod = torch.clamp(prod * per, max=cap)
        total = int(prod.sum()) if many else int(prod)
        state["count"] = min(state["count"] + total, cap)
        if limit is not None and state["count"] >= limit:
            raise _LimitReached

    def level(i: int, assign: torch.Tensor) -> None:
        if i == tail:
            count_tail(assign)
            return
        qi, cons = plan[i]
        idx = _level_idx(assign, cons, n_pad)
        with profiled("enumerate.page"):
            t, parent, node, incl = gather_expand(
                mats_flat, fb_words[qi], idx, every, n_i=n_pad,
                size=capacity, expand=True, scan=True)
            total = int(t)
        state["pages"] += 1
        if total == 0:
            return
        ranges = ([(0, idx.shape[0], total)] if total <= capacity else
                  _cut(incl.cpu().numpy(), capacity))
        for j, (a, b, pairs) in enumerate(ranges):
            if j:
                with profiled("enumerate.page"):
                    _, parent, node = gather_expand(
                        mats_flat, fb_words[qi], idx[a:b], every,
                        n_i=n_pad, size=pairs, expand=True)
                state["pages"] += 1
            child = assign[a:b][parent[:pairs].long()]
            child[:, i] = node[:pairs]
            level(i + 1, child)

    root = torch.full((1, max_q), PAD, dtype=torch.int32, device=dev)
    truncated = False
    try:
        if plan:
            level(0, root)
    except _LimitReached:
        truncated = True
    count = state["count"] if limit is None else min(state["count"], limit)
    _count(dev, 1, state["pages"], int(truncated))
    empty = torch.zeros((0,), dtype=torch.bool, device=dev)
    return MJoinCount(count=torch.tensor(count, dtype=torch.int64),
                      overflowed=torch.tensor(False), frontier=root[:0],
                      alive=empty, truncated=truncated)


def decode_tuples(res: MJoinCount, order, n_nodes: int) -> np.ndarray:
    """Host-side: frontier rows -> occurrence tuples in query-node order."""
    assign = res.frontier.cpu().numpy()[res.alive.cpu().numpy()]
    order = _host(order)[:n_nodes]
    out = np.full((assign.shape[0], n_nodes), -1, dtype=np.int64)
    for pos, qnode in enumerate(order):
        out[:, int(qnode)] = assign[:, pos]
    return out
