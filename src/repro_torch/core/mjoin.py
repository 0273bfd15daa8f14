"""MJoin — multiway intersection-based occurrence enumeration (Alg. 5, §6).

At enumeration position *i* the candidate set for query node q_i is the
intersection of ``cos(q_i)`` (the RIG node set) and one RIG adjacency row
per already-bound neighbour of q_i — a true multiway join with no binary
intermediate results.  Worst-case optimal (Thm. 2/3: runtime within the
AGM bound of the RIG edge relations).

Two enumeration strategies over the compact candidate-local RIG layout:

* ``backtrack`` — the paper's one-tuple-at-a-time depth-first search.
  ``cos`` is the all-ones set in local space, so each level is K gathered
  rows AND-reduced (K = bound neighbours of q_i).
* ``frontier`` / ``frontier-device`` — level-synchronous batched
  enumeration: an ``(F, level)`` table of partial assignments is extended
  one position at a time; the K constraint rows of the *whole frontier*
  are gathered into ``(F, K, W)`` and AND-reduced + popcounted in one call
  (numpy host path, or the ``intersect`` CUDA kernel on device).
  Frontier slabs bound the transient gather memory; both strategies
  enumerate in the same lexicographic order, so ``limit`` / ``max_tuples``
  / truncation semantics are preserved exactly.
* ``frontier-device-resident`` — the packed RIG matrices are uploaded to
  the device **once** (:class:`repro_torch.torchgm.frontier.ResidentIntersector`)
  and each level ships only ``(F, K)`` int32 constraint-row indices; the
  fused ``gather_intersect`` kernel does gather + AND + popcount on
  device, and frontier expansion returns compact (row, column) pair pages
  instead of dense boolean slabs.  Enumeration is *paged depth-first over
  level-synchronous pages*: a level wider than ``max_frontier`` is split
  into in-order pages that are recursed one at a time — same lexicographic
  order, bounded memory, and no fallback-to-backtrack (this method never
  raises :class:`FrontierOverflow`).

Both strategies are implemented as *block generators* over the shared
constraint machinery, which gives three consumption modes on one code
path:

* :func:`mjoin` — the classic one-shot API (count + optional tuples);
* :func:`iter_tuples` — a chunked streaming API (:class:`MJoinStream`)
  that yields fixed-size ndarray chunks lazily, in the same lexicographic
  order as one-shot enumeration, with ``limit`` pushdown: a consumer that
  stops early (or hits the limit mid-chunk) never visits the tail — the
  backtrack search simply pauses, and the frontier path reads no further
  last-level slabs (observable via ``MJoinStats.intersections`` /
  ``device_calls``);
* :func:`mjoin_batched` — cross-query counting: several queries'
  frontier enumerations run as coroutines under one scheduler that pads
  and stacks their pending ``(F, K, W)`` constraint gathers into a single
  ``(ΣF, K, W)`` slab per round — one device dispatch shared by the whole
  batch instead of per-query dispatches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import bitset
from .rig import RIG
from .slabgeom import padded_rows_cap
from ..obs.trace import NULL_TRACER
from ..robust.errors import BreakerOpen, DeadlineExceeded, DeviceFailure

DEFAULT_LIMIT = 10_000_000   # paper §7.1: stop after 10^7 matches
ENUM_METHODS = ("backtrack", "frontier", "frontier-device",
                "frontier-device-resident")

_FRONTIER_SLAB = 8192        # frontier rows per gather slab (memory bound)
_INF_CAP = 1 << 62           # "materialize everything" sentinel
_DEADLINE_STEPS = 1024       # backtrack loop iterations between clock reads


@dataclass
class MJoinStats:
    results: int = 0
    expanded: int = 0            # partial assignments explored
    intersections: int = 0       # constraint-row ANDs (per partial, per row)
    truncated: bool = False      # hit the result limit
    enumerate_s: float = 0.0
    method: str = "backtrack"    # strategy that actually ran
    frontier_peak: int = 0       # widest frontier level (frontier methods)
    device_calls: int = 0        # intersect-kernel dispatches (device method)
    # observability (PR 6): per-level frontier widths (frontier methods,
    # level 0 = the root candidate set), wall time inside the device
    # intersector (fenced), and the final local->global materialization.
    frontier_levels: List[int] = field(default_factory=list)
    device_s: float = 0.0
    materialize_s: float = 0.0
    # resource governance (PR 7): a budget deadline noticed at a slab/block
    # boundary stops enumeration cleanly — the counted/yielded prefix is a
    # valid lexicographic truncation; each degradation-ladder step taken
    # (device -> host-intersect, full -> chunked slabs, frontier ->
    # backtrack) is recorded in order.
    deadline_exceeded: bool = False
    degradations: List[str] = field(default_factory=list)
    # resident path (PR 8): one-time RIG upload accounting, device pair
    # pages shipped, and levels routed to the host intersect because the
    # frontier was below the padded-dispatch break-even (F < threshold)
    resident_uploads: int = 0
    resident_bytes: int = 0
    resident_upload_s: float = 0.0
    resident_pages: int = 0
    small_frontier_host_routed: int = 0
    # transfer ledger (PR 10): host<->device bytes moved by THIS
    # enumeration (uploads, slab ships, index vectors, pair/row readback),
    # measured as intersector-counter deltas around each dispatch so
    # breaker retries and degraded attempts are included.  The process-wide
    # per-site breakdown lives in repro_torch.obs.ledger.
    h2d_bytes: int = 0
    d2h_bytes: int = 0


@dataclass
class MJoinResult:
    count: int
    tuples: Optional[np.ndarray]     # (k, n_query) int64, in *query-node* order
    stats: MJoinStats
    order: List[int]


class FrontierOverflow(RuntimeError):
    """Raised when a frontier level exceeds ``max_frontier`` rows; the
    driver falls back to the constant-space backtracking strategy."""


# ------------------------------------------------------------------ helpers
def _constraints(q, order: List[int]) -> List[List[Tuple[int, int, bool]]]:
    """constraints[i]: list of (prefix_position, edge_index, is_forward).

    is_forward=True  => edge (order[j] -> order[i]): row = rig.fwd[e][t_j]
    is_forward=False => edge (order[i] -> order[j]): row = rig.bwd[e][t_j]
    """
    pos = {qi: i for i, qi in enumerate(order)}
    cons: List[List[Tuple[int, int, bool]]] = [[] for _ in range(q.n)]
    for ei, e in enumerate(q.edges):
        ps, pd = pos[e.src], pos[e.dst]
        if ps < pd:
            cons[pd].append((ps, ei, True))
        else:
            cons[ps].append((pd, ei, False))
    return cons


def _to_query_order(assign: np.ndarray, order: List[int],
                    cand: List[np.ndarray]) -> np.ndarray:
    """Local-id rows in order-position layout -> global-id tuples in
    query-node order (vectorized over all rows per position)."""
    k = assign.shape[0]
    out = np.empty((k, len(order)), dtype=np.int64)
    for p, qi in enumerate(order):
        out[:, qi] = cand[qi][assign[:, p]]
    return out


_DEVICE = None


def device_intersector():
    """The process-wide slab executor (CUDA ``intersect`` kernel), built on
    first use.  Raises when no device can be resolved (no CUDA and no
    explicit CPU pin) or the kernels fail to build: there is no silent
    fallback to the host path."""
    global _DEVICE
    if _DEVICE is None:
        from ..torchgm.frontier import DeviceIntersector
        _DEVICE = DeviceIntersector()
    return _DEVICE


def resident_intersector(rig: RIG, stats: Optional[MJoinStats] = None):
    """The RIG's device-resident executor, built (and uploaded) on first
    use and cached on ``rig.resident`` — one upload per RIG, shared by
    every enumeration over it.  Raises when no device can be resolved or
    the kernels fail to build (no silent fallback to the host path).

    With ``stats``, upload accounting is recorded: ``resident_uploads``
    counts only *fresh* uploads (a cache hit contributes bytes but no
    upload), so engine counters reflect real transfers.
    """
    res = getattr(rig, "resident", None)
    if res is not None and getattr(res, "closed", False):
        res = rig.resident = None       # torn down (evicted): rebuild
    if res is None:
        from ..torchgm.frontier import ResidentIntersector
        res = ResidentIntersector.build(rig)
        rig.resident = res
        if stats is not None:
            stats.resident_uploads += 1
            stats.resident_upload_s += res.upload_s
            stats.h2d_bytes += res.nbytes
    if stats is not None:
        stats.resident_bytes = res.nbytes
    return res


class _XferDelta:
    """Record an intersector's cumulative h2d/d2h counter movement into
    ``stats`` around a dispatch (context manager; exception-safe so failed
    attempts still account the bytes they shipped)."""

    __slots__ = ("res", "stats", "_h", "_d")

    def __init__(self, res, stats: Optional[MJoinStats]):
        self.res, self.stats = res, stats

    def __enter__(self):
        self._h = getattr(self.res, "h2d_bytes", 0)
        self._d = getattr(self.res, "d2h_bytes", 0)
        return self

    def __exit__(self, *exc):
        if self.stats is not None and self.res is not None:
            self.stats.h2d_bytes += getattr(self.res, "h2d_bytes", 0) - self._h
            self.stats.d2h_bytes += getattr(self.res, "d2h_bytes", 0) - self._d
        return False


# ---------------------------------------------------------------- backtrack
def _backtrack_blocks(rig: RIG, order: List[int], cons, limit,
                      stats: MJoinStats, mat_cap: int, block: int = 1024,
                      budget=None) -> Iterator[Tuple[Optional[np.ndarray], int]]:
    """Depth-first enumeration as a lazy block generator.

    Yields ``(rows, visited)`` pairs: ``rows`` is an ``(k <= block, n)``
    int64 array of completed assignments (local ids, order-position layout;
    ``None`` once ``mat_cap`` assignments have been materialized) and
    ``visited`` the number of results visited since the previous yield
    (materialization may lag counting when ``mat_cap`` < limit).  The
    search state is suspended between yields, so a consumer that stops
    early never visits the tail.
    """
    n = rig.query.n
    sizes = [rig.cos_size(qi) for qi in order]
    all_ids = [np.arange(s, dtype=np.int64) for s in sizes]
    empty = np.empty(0, dtype=np.int64)

    t = np.full(n, -1, dtype=np.int64)       # local ids, order positions
    cand_lists: List[np.ndarray] = [empty] * n
    cursors = np.zeros(n, dtype=np.int64)
    count = 0

    buf = (np.empty((block, n), dtype=np.int64) if mat_cap > 0 else None)
    k = 0          # rows in buf
    visited = 0    # results since last yield
    n_mat = 0      # total rows materialized

    def candidates(i: int) -> np.ndarray:
        cs = cons[i]
        if not cs:
            return all_ids[i]
        j, ei, isf = cs[0]
        acc = (rig.fwd[ei] if isf else rig.bwd[ei])[t[j]]
        stats.intersections += 1
        if len(cs) > 1:
            acc = acc.copy()
            for (j, ei, isf) in cs[1:]:
                acc &= (rig.fwd[ei] if isf else rig.bwd[ei])[t[j]]
                stats.intersections += 1
                if not acc.any():
                    return empty
        elif not acc.any():
            return empty
        return bitset.to_indices(acc, sizes[i])

    # cooperative deadline: one clock read per _DEADLINE_STEPS loop
    # iterations, so a blown budget is noticed within a bounded slice of
    # work while the un-governed path pays only an int compare
    steps = 0
    i = 0
    cand_lists[0] = candidates(0)
    cursors[0] = 0
    while i >= 0:
        if limit is not None and count >= limit:
            stats.truncated = True
            break
        if budget is not None:
            steps += 1
            if steps >= _DEADLINE_STEPS:
                steps = 0
                if budget.expired():
                    stats.deadline_exceeded = True
                    stats.truncated = True
                    break
        lst = cand_lists[i]
        c = cursors[i]
        if c >= len(lst):
            i -= 1
            if i >= 0:
                cursors[i] += 1
            continue
        t[i] = lst[c]
        stats.expanded += 1
        if i == n - 1:
            count += 1
            visited += 1
            if buf is not None and n_mat < mat_cap:
                buf[k] = t
                k += 1
                n_mat += 1
            if visited >= block:
                yield (buf[:k].copy() if k else None), visited
                k = 0
                visited = 0
            cursors[i] += 1
            continue
        i += 1
        cand_lists[i] = candidates(i)
        cursors[i] = 0
    if visited:
        yield (buf[:k].copy() if k else None), visited


def _mjoin_backtrack(rig: RIG, order: List[int], cons, limit,
                     materialize: bool, max_tuples: int,
                     stats: MJoinStats, budget=None
                     ) -> Tuple[int, Optional[np.ndarray]]:
    """Returns ``(count, assign)`` — assign in *local* order-position
    layout (``None`` when not materializing); the caller converts to
    query-node order under the materialize phase."""
    mat_cap = max_tuples if materialize else 0
    blocks: List[np.ndarray] = []
    count = 0
    for blk, visited in _backtrack_blocks(rig, order, cons, limit, stats,
                                          mat_cap, budget=budget):
        if blk is not None:
            blocks.append(blk)
        count += visited
    assign = None
    if materialize:
        assign = (np.vstack(blocks) if blocks
                  else np.empty((0, rig.query.n), dtype=np.int64))
    return count, assign


# ----------------------------------------------------------------- frontier
def _slab_intersect(rig: RIG, cs, slab: np.ndarray,
                    intersector, stats: MJoinStats, breaker=None,
                    small_rows: int = 0):
    """Gather the K constraint rows for one frontier slab and AND-reduce.

    Returns ``(acc, counts)``: the packed candidate rows (f, W) plus, on
    the device path, the kernel's fused per-row popcounts (None on the
    host path — computed lazily only where needed).  ``cs`` is non-empty
    (K >= 1); each constraint contributes one gathered row per frontier
    entry.

    With a ``breaker``, the device dispatch is governed: transient
    failures retry inside :meth:`CircuitBreaker.call`, and a dispatch that
    still fails (or an open breaker, which refuses before touching the
    device) degrades this slab — and effectively the query — to the fused
    numpy path, recorded once as the ``host-intersect`` ladder step.
    Results are identical either way.

    ``small_rows`` is the sub-threshold host routing bound: a slab with
    fewer rows than it skips the device entirely (the kernel pads every
    dispatch to >= 128 rows, so tiny frontiers pay the full padded
    dispatch for almost no work — BENCH data puts the break-even around
    the padding floor).  Routed slabs are counted in
    ``stats.small_frontier_host_routed``.
    """
    stats.intersections += len(cs) * len(slab)
    if intersector is not None and small_rows and len(slab) < small_rows:
        stats.small_frontier_host_routed += 1
        intersector = None
    if intersector is not None:
        rows = np.stack([(rig.fwd[ei] if isf else rig.bwd[ei])[slab[:, j]]
                         for (j, ei, isf) in cs], axis=1)    # (f, K, W)
        t0 = time.perf_counter()
        try:
            with _XferDelta(intersector, stats):
                if breaker is not None:
                    acc, counts = breaker.call(lambda: intersector(rows))
                else:
                    acc, counts = intersector(rows)
        except (DeviceFailure, BreakerOpen):
            stats.device_s += time.perf_counter() - t0
            if "host-intersect" not in stats.degradations:
                stats.degradations.append("host-intersect")
            acc = np.bitwise_and.reduce(rows, axis=1)
            return acc, bitset.count_rows(acc)
        stats.device_s += time.perf_counter() - t0
        stats.device_calls += 1
        return acc, counts
    j, ei, isf = cs[0]
    acc = (rig.fwd[ei] if isf else rig.bwd[ei])[slab[:, j]]  # gather = copy
    for (j, ei, isf) in cs[1:]:
        acc &= (rig.fwd[ei] if isf else rig.bwd[ei])[slab[:, j]]
    return acc, None


def _frontier_events(rig: RIG, order: List[int], cons, limit,
                     stats: MJoinStats, device: bool, max_frontier: int,
                     mat_cap: int, external: bool = False,
                     slab_rows: Optional[int] = None, budget=None,
                     breaker=None, small_rows: int = 0):
    """Level-synchronous frontier enumeration as an event generator.

    Yields two event kinds:

    * ``("need", rows)`` — only when ``external``: a pending ``(F, K, W)``
      constraint gather; the driver must resume the generator with
      ``send((acc, counts))`` (the AND-reduced rows and their per-row
      popcounts).  This is the hook the cross-query batcher uses to fuse
      several queries' gathers into one device dispatch.
    * ``("out", rows, visited)`` — a block of completed assignments at the
      last level: ``rows`` is ``(k, n)`` int64 in order-position layout
      (``None`` when the materialization budget ``mat_cap`` is exhausted
      or zero), ``visited`` the number of results this slab contributed
      after limit clipping.  Last-level slabs are processed lazily, one
      per event, so a consumer that stops early reads no further slabs.

    Raises :class:`FrontierOverflow` — always before the first ``"out"``
    event, since overflow can only occur while building a non-last level —
    when a level exceeds ``max_frontier`` rows.
    """
    n = rig.query.n
    sizes = [rig.cos_size(qi) for qi in order]
    intersector = None
    if device and not external:
        intersector = device_intersector()

    n_mat = 0
    count = 0
    frontier = np.arange(sizes[0], dtype=np.int64)[:, None]   # (F, 1)
    stats.frontier_peak = len(frontier)
    stats.frontier_levels.append(len(frontier))
    stats.expanded += len(frontier)

    if n == 1:
        total = sizes[0]
        if limit is not None and total >= limit:
            total = limit
            stats.truncated = True
        blk = frontier[:min(total, mat_cap)] if mat_cap > 0 else None
        yield ("out", blk, total)
        return

    for i in range(1, n):
        last = i == n - 1
        n_i = sizes[i]
        cs = cons[i]
        new_parts: List[np.ndarray] = []
        new_rows = 0
        # slab rows bounded by both the row count and the dense unpack
        # width, so the per-slab transient stays ~32 MB even for huge
        # candidate sets
        srows = slab_rows or max(1, min(_FRONTIER_SLAB,
                                        (1 << 25) // max(n_i, 1)))
        if budget is not None:
            # budget-tightened slab height — the "smaller chunks"
            # degradation step.  The device intersector pads every
            # dispatch (F -> pow2 >= 128, K -> pow2, W -> 128-lane
            # multiples), so when a device dispatch is possible the cap
            # must bound the *padded* allocation, not the logical gather
            # transient — on ragged slabs padding can exceed it by >2x.
            if intersector is not None and budget.max_slab_bytes is not None:
                cap = padded_rows_cap(budget.max_slab_bytes,
                                      max(1, len(cs)), bitset.n_words(n_i),
                                      srows)
                if cap == 0:
                    # even the minimal 128-row padded dispatch blows the
                    # cap: this query degrades to the host intersect
                    intersector = None
                    cap = budget.slab_cap_rows(
                        max(1, len(cs)) * bitset.n_words(n_i) * 8)
                    if "host-intersect" not in stats.degradations:
                        stats.degradations.append("host-intersect")
            else:
                cap = budget.slab_cap_rows(
                    max(1, len(cs)) * bitset.n_words(n_i) * 8)
            if cap is not None and cap < srows:
                srows = cap
                if "chunked-slabs" not in stats.degradations:
                    stats.degradations.append("chunked-slabs")
        for lo in range(0, len(frontier), srows):
            if budget is not None and budget.expired():
                stats.deadline_exceeded = True
                stats.truncated = True
                return
            slab = frontier[lo:lo + srows]
            counts = None
            if cs:
                if external:
                    rows = np.stack(
                        [(rig.fwd[ei] if isf else rig.bwd[ei])[slab[:, j]]
                         for (j, ei, isf) in cs], axis=1)     # (f, K, W)
                    stats.intersections += len(cs) * len(slab)
                    acc, counts = yield ("need", rows)
                    stats.device_calls += 1
                else:
                    acc, counts = _slab_intersect(rig, cs, slab,
                                                  intersector, stats,
                                                  breaker=breaker,
                                                  small_rows=small_rows)
                bits = None
            else:                      # disconnected pattern: cartesian
                acc = None
                bits = np.ones((len(slab), n_i), dtype=bool)
            if last:
                if counts is None:
                    counts = (bitset.count_rows(acc) if acc is not None
                              else np.full(len(slab), n_i, dtype=np.int64))
                slab_total = int(counts.sum())
                want = min(mat_cap - n_mat, slab_total) if mat_cap > 0 else 0
                blk = None
                if want > 0:
                    if bits is None:
                        bits = bitset.unpack(acc, n_i)
                    rid, cid = np.nonzero(bits)
                    blk = np.concatenate(
                        [slab[rid[:want]],
                         cid[:want, None].astype(np.int64)], axis=1)
                    n_mat += len(blk)
                count += slab_total
                stats.expanded += slab_total
                visited = slab_total
                hit_limit = False
                if limit is not None and count >= limit:
                    stats.expanded -= count - limit
                    visited = slab_total - (count - limit)
                    count = limit
                    stats.truncated = True
                    hit_limit = True
                yield ("out", blk, visited)
                if hit_limit:
                    return
            else:
                if bits is None:
                    bits = bitset.unpack(acc, n_i)
                rid, cid = np.nonzero(bits)
                if len(rid):
                    new_parts.append(np.concatenate(
                        [slab[rid], cid[:, None].astype(np.int64)],
                        axis=1))
                    new_rows += len(rid)
                    # enforce the bound *while* accumulating — before
                    # the oversized level is ever materialized whole
                    if new_rows > max_frontier:
                        raise FrontierOverflow(
                            f"frontier level {i} exceeds "
                            f"max_frontier={max_frontier} rows")
        if last:
            return
        frontier = (np.vstack(new_parts) if new_parts
                    else np.empty((0, i + 1), dtype=np.int64))
        stats.frontier_peak = max(stats.frontier_peak, len(frontier))
        stats.frontier_levels.append(len(frontier))
        stats.expanded += len(frontier)
        if len(frontier) == 0:
            return


# ------------------------------------------------------ resident frontier
def _resident_frontier_events(rig: RIG, order: List[int], cons, limit,
                              stats: MJoinStats, max_frontier: int,
                              mat_cap: int, slab_rows: Optional[int] = None,
                              budget=None, breaker=None,
                              small_rows: int = 0):
    """Paged device-resident frontier enumeration (event generator).

    Yields the same ``("out", rows, visited)`` events as
    :func:`_frontier_events` but executes each level against the
    device-resident RIG (:func:`resident_intersector`): the host ships
    only ``(F, K)`` int32 constraint-row indices per slab, and both the
    gather + AND + popcount and the set-bit expansion run on device —
    result pages come back as compact (row, column) pairs.

    A level wider than ``max_frontier`` is *paged*, not abandoned: full
    pages of child rows are recursed depth-first in order (page p's
    completions all precede page p+1's by construction), which preserves
    the exact lexicographic order of the level-synchronous path while
    bounding live frontier memory to ~``max_frontier`` rows per level.
    This generator therefore never raises :class:`FrontierOverflow`.

    Degradation ladder: a failed device dispatch (or open breaker) — at
    either the intersect or the expand step — degrades the remaining
    enumeration to the host gather + numpy intersect (``host-intersect``),
    and slabs below ``small_rows`` are host-routed pre-emptively (the
    padded dispatch floor makes them device-unprofitable).  Only injected
    faults and an open breaker take that ladder; a CUDA error raises.
    """
    n = rig.query.n
    sizes = [rig.cos_size(qi) for qi in order]
    res = resident_intersector(rig, stats)

    page_rows = max(1, max_frontier)
    state = {"count": 0, "n_mat": 0, "done": False, "dev_ok": True}
    level_rows = [0] * n

    root = np.arange(sizes[0], dtype=np.int64)[:, None]       # (F, 1)
    if n == 1:
        stats.frontier_peak = len(root)
        stats.frontier_levels.append(len(root))
        stats.expanded += len(root)
        total = sizes[0]
        if limit is not None and total >= limit:
            total = limit
            stats.truncated = True
        blk = root[:min(total, mat_cap)] if mat_cap > 0 else None
        yield ("out", blk, total)
        return

    def _host_acc(cs, slab):
        j, ei, isf = cs[0]
        acc = (rig.fwd[ei] if isf else rig.bwd[ei])[slab[:, j]]
        for (j, ei, isf) in cs[1:]:
            acc &= (rig.fwd[ei] if isf else rig.bwd[ei])[slab[:, j]]
        return acc

    def _degrade():
        state["dev_ok"] = False
        if "host-intersect" not in stats.degradations:
            stats.degradations.append("host-intersect")

    def intersect_slab(cs, slab, w64):
        """Dispatch one slab: ``(handle, acc_host, counts)`` — exactly one
        of handle/acc_host is set; counts only on the device path."""
        stats.intersections += len(cs) * len(slab)
        if state["dev_ok"] and not (small_rows and len(slab) < small_rows):
            t0 = time.perf_counter()
            try:
                with _XferDelta(res, stats):
                    if breaker is not None:
                        handle, counts = breaker.call(
                            lambda: res.intersect(cs, slab, w64))
                    else:
                        handle, counts = res.intersect(cs, slab, w64)
            except (DeviceFailure, BreakerOpen):
                stats.device_s += time.perf_counter() - t0
                _degrade()
            else:
                stats.device_s += time.perf_counter() - t0
                stats.device_calls += 1
                return handle, None, counts
        elif state["dev_ok"]:
            stats.small_frontier_host_routed += 1
        return None, _host_acc(cs, slab), None

    def slab_pairs(cs, slab, handle, acc, n_i, want):
        """First ``want`` set-bit (row, column) pairs of one dispatched
        slab, lexicographic; device pair page when possible."""
        if handle is not None:
            t0 = time.perf_counter()
            try:
                with _XferDelta(res, stats):
                    if breaker is not None:
                        rid, cid = breaker.call(
                            lambda: res.expand(handle, n_i, want))
                    else:
                        rid, cid = res.expand(handle, n_i, want)
            except (DeviceFailure, BreakerOpen):
                stats.device_s += time.perf_counter() - t0
                _degrade()
                acc = _host_acc(cs, slab)
            else:
                stats.device_s += time.perf_counter() - t0
                stats.resident_pages += 1
                return rid, cid
        bits = bitset.unpack(acc, n_i)
        rid, cid = np.nonzero(bits)
        return rid[:want], cid[:want]

    def expand(frontier, i):
        """Extend an ``(F, i)`` prefix page at level ``i`` (recursive)."""
        last = i == n - 1
        n_i = sizes[i]
        cs = cons[i]
        w64 = bitset.n_words(n_i)
        srows = slab_rows or max(1, min(_FRONTIER_SLAB,
                                        (1 << 25) // max(n_i, 1)))
        if budget is not None and cs:
            cap = None
            if state["dev_ok"] and budget.max_slab_bytes is not None:
                # charge the *padded* dispatch transient (index upload +
                # AND output), same geometry the executor allocates
                cap = res.rows_cap(budget.max_slab_bytes, len(cs), srows)
                if cap == 0:
                    _degrade()
            if not state["dev_ok"] or budget.max_slab_bytes is None:
                cap = budget.slab_cap_rows(
                    len(cs) * bitset.n_words(n_i) * 8)
            if cap is not None and cap < srows:
                srows = cap
                if "chunked-slabs" not in stats.degradations:
                    stats.degradations.append("chunked-slabs")
        pend: List[np.ndarray] = []
        pend_rows = 0
        for lo in range(0, len(frontier), srows):
            if budget is not None and budget.expired():
                stats.deadline_exceeded = True
                stats.truncated = True
                state["done"] = True
                return
            slab = frontier[lo:lo + srows]
            if cs:
                handle, acc, counts = intersect_slab(cs, slab, w64)
            else:                          # disconnected pattern: cartesian
                handle = acc = counts = None
            if last:
                if counts is None:
                    counts = (bitset.count_rows(acc) if cs
                              else np.full(len(slab), n_i, dtype=np.int64))
                slab_total = int(counts.sum())
                want = (min(mat_cap - state["n_mat"], slab_total)
                        if mat_cap > 0 else 0)
                blk = None
                if want > 0:
                    if cs:
                        rid, cid = slab_pairs(cs, slab, handle, acc,
                                              n_i, want)
                    else:
                        rid = np.repeat(np.arange(len(slab)), n_i)[:want]
                        cid = np.tile(np.arange(n_i), len(slab))[:want]
                    blk = np.concatenate(
                        [slab[rid], cid[:, None].astype(np.int64)], axis=1)
                    state["n_mat"] += len(blk)
                state["count"] += slab_total
                stats.expanded += slab_total
                visited = slab_total
                if limit is not None and state["count"] >= limit:
                    over = state["count"] - limit
                    stats.expanded -= over
                    visited = slab_total - over
                    state["count"] = limit
                    stats.truncated = True
                    state["done"] = True
                yield ("out", blk, visited)
                if state["done"]:
                    return
                continue
            # intermediate level: child rows, paged
            if cs:
                if handle is not None:
                    total = int(counts.sum())
                    rid, cid = slab_pairs(cs, slab, handle, acc, n_i, total)
                else:
                    bits = bitset.unpack(acc, n_i)
                    rid, cid = np.nonzero(bits)
            else:
                rid = np.repeat(np.arange(len(slab)), n_i)
                cid = np.tile(np.arange(n_i), len(slab))
            if len(rid):
                child = np.concatenate(
                    [slab[rid], cid[:, None].astype(np.int64)], axis=1)
                level_rows[i] += len(child)
                stats.expanded += len(child)
                pend.append(child)
                pend_rows += len(child)
                stats.frontier_peak = max(stats.frontier_peak, pend_rows)
            # flush full pages in order: page p's completions all precede
            # page p+1's, so recursion preserves lexicographic order
            while pend_rows >= page_rows:
                cat = pend[0] if len(pend) == 1 else np.vstack(pend)
                page, rest = cat[:page_rows], cat[page_rows:]
                pend = [rest] if len(rest) else []
                pend_rows = len(rest)
                yield from expand(page, i + 1)
                if state["done"]:
                    return
        if pend_rows:
            cat = pend[0] if len(pend) == 1 else np.vstack(pend)
            yield from expand(cat, i + 1)

    try:
        for lo in range(0, len(root), page_rows):
            page = root[lo:lo + page_rows]
            level_rows[0] += len(page)
            stats.expanded += len(page)
            stats.frontier_peak = max(stats.frontier_peak, len(page))
            yield from expand(page, 1)
            if state["done"]:
                return
    finally:
        lvls = level_rows[:n - 1]
        while len(lvls) > 1 and lvls[-1] == 0:
            lvls.pop()
        stats.frontier_levels = lvls


def _mjoin_frontier(rig: RIG, order: List[int], cons, limit,
                    materialize: bool, max_tuples: int, stats: MJoinStats,
                    device: bool, max_frontier: int, budget=None,
                    breaker=None, small_rows: int = 0
                    ) -> Tuple[int, Optional[np.ndarray]]:
    mat_cap = 0
    if materialize:
        mat_cap = max_tuples if limit is None else min(max_tuples, limit)
    blocks: List[np.ndarray] = []
    count = 0
    for _, blk, visited in _frontier_events(rig, order, cons, limit, stats,
                                            device, max_frontier, mat_cap,
                                            budget=budget, breaker=breaker,
                                            small_rows=small_rows):
        if blk is not None and len(blk):
            blocks.append(blk)
        count += visited
    assign = None
    if materialize:
        assign = (np.vstack(blocks) if blocks
                  else np.empty((0, rig.query.n), dtype=np.int64))
    return count, assign


def _mjoin_resident(rig: RIG, order: List[int], cons, limit,
                    materialize: bool, max_tuples: int, stats: MJoinStats,
                    max_frontier: int, budget=None, breaker=None,
                    small_rows: int = 0) -> Tuple[int, Optional[np.ndarray]]:
    mat_cap = 0
    if materialize:
        mat_cap = max_tuples if limit is None else min(max_tuples, limit)
    blocks: List[np.ndarray] = []
    count = 0
    for _, blk, visited in _resident_frontier_events(
            rig, order, cons, limit, stats, max_frontier, mat_cap,
            budget=budget, breaker=breaker, small_rows=small_rows):
        if blk is not None and len(blk):
            blocks.append(blk)
        count += visited
    assign = None
    if materialize:
        assign = (np.vstack(blocks) if blocks
                  else np.empty((0, rig.query.n), dtype=np.int64))
    return count, assign


# ---------------------------------------------------------------------- API
def mjoin(rig: RIG, order: List[int], limit: Optional[int] = DEFAULT_LIMIT,
          materialize: bool = True, max_tuples: int = 1_000_000,
          method: str = "backtrack",
          max_frontier: int = 1 << 25, trace=NULL_TRACER,
          budget=None, breaker=None,
          small_frontier_rows: int = 0) -> MJoinResult:
    """Enumerate (or count) the occurrences encoded by ``rig``.

    ``limit`` bounds the number of results visited (None = exhaustive);
    ``max_tuples`` bounds materialization only (counting continues);
    ``method`` picks the enumeration strategy (see module docstring) —
    a frontier level wider than ``max_frontier`` rows falls back to
    ``backtrack`` to keep memory bounded, except under
    ``frontier-device-resident`` where such a level is *paged* through
    in ``max_frontier``-row pages instead (no fallback, same order).
    ``small_frontier_rows`` routes device slabs below that many rows
    through the host intersect (the padded dispatch floor makes tiny
    slabs device-unprofitable); 0 disables the routing.  ``trace``
    records the ``enumerate`` / ``materialize`` phases as spans when
    profiling.

    ``budget`` (an armed :class:`repro_torch.robust.Budget`) adds cooperative
    governance: its deadline is checked at slab/block boundaries (a blown
    deadline yields the partial prefix with ``stats.deadline_exceeded``),
    its ``max_frontier_rows``/``max_slab_bytes`` tighten the frontier
    bounds (degrading to smaller slabs or backtracking, recorded in
    ``stats.degradations``).  ``breaker`` governs device dispatches on the
    ``frontier-device`` path (retry, then host fallback).
    """
    if method not in ENUM_METHODS:
        raise ValueError(f"unknown enum method: {method!r} "
                         f"(expected one of {ENUM_METHODS})")
    if budget is not None:
        max_frontier = budget.frontier_cap(max_frontier)
    q = rig.query
    n = q.n
    t0 = time.perf_counter()
    stats = MJoinStats(method=method)

    if rig.is_empty() or (limit is not None and limit <= 0):
        stats.truncated = limit is not None and limit <= 0 \
            and not rig.is_empty()
        stats.enumerate_s = time.perf_counter() - t0
        trace.span("enumerate").__enter__().set(
            method=method, results=0, empty_rig=rig.is_empty(),
            truncated=stats.truncated).__exit__(None, None, None)
        trace.span("materialize").__enter__().set(
            rows=0).__exit__(None, None, None)
        return MJoinResult(0, np.empty((0, n), dtype=np.int64) if materialize
                           else None, stats, order)

    cons = _constraints(q, order)
    with trace.span("enumerate") as esp:
        if method == "backtrack":
            count, assign = _mjoin_backtrack(rig, order, cons, limit,
                                             materialize, max_tuples, stats,
                                             budget=budget)
        else:
            try:
                if method == "frontier-device-resident":
                    # paged: never raises FrontierOverflow
                    count, assign = _mjoin_resident(
                        rig, order, cons, limit, materialize, max_tuples,
                        stats, max_frontier=max_frontier, budget=budget,
                        breaker=breaker, small_rows=small_frontier_rows)
                else:
                    count, assign = _mjoin_frontier(
                        rig, order, cons, limit, materialize, max_tuples,
                        stats, device=(method == "frontier-device"),
                        max_frontier=max_frontier, budget=budget,
                        breaker=breaker, small_rows=small_frontier_rows)
            except FrontierOverflow:
                degr = stats.degradations + ["backtrack"]
                old = stats
                stats = MJoinStats(method="backtrack",   # strategy that ran
                                   degradations=degr,
                                   # bytes already moved before the overflow
                                   # stay on the query's record
                                   h2d_bytes=old.h2d_bytes,
                                   d2h_bytes=old.d2h_bytes,
                                   resident_uploads=old.resident_uploads,
                                   resident_bytes=old.resident_bytes,
                                   resident_upload_s=old.resident_upload_s)
                esp.set(overflow_fallback=True)
                count, assign = _mjoin_backtrack(rig, order, cons, limit,
                                                 materialize, max_tuples,
                                                 stats, budget=budget)
        if trace.enabled:
            esp.set(method=stats.method, results=count,
                    expanded=stats.expanded,
                    intersections=stats.intersections,
                    truncated=stats.truncated,
                    frontier_levels=list(stats.frontier_levels),
                    frontier_peak=stats.frontier_peak,
                    device_calls=stats.device_calls,
                    device_s=stats.device_s)

    tuples = None
    with trace.span("materialize") as msp:
        if materialize:
            t_m = time.perf_counter()
            tuples = _to_query_order(assign, order, rig.cand)
            stats.materialize_s = time.perf_counter() - t_m
        if trace.enabled:
            msp.set(rows=0 if tuples is None else len(tuples),
                    materialized=materialize)

    stats.results = count
    stats.enumerate_s = (time.perf_counter() - t0) - stats.materialize_s
    return MJoinResult(count=count, tuples=tuples, stats=stats, order=order)


# ----------------------------------------------------------------- streaming
class MJoinStream:
    """Chunked lazy enumeration over one RIG (created by :func:`iter_tuples`).

    Iterating yields ``(chunk_size, n_query)`` int64 arrays — global node
    ids in query-node order, byte-identical to the corresponding slice of
    one-shot ``mjoin(...).tuples`` — in the same lexicographic order; every
    chunk except the last has exactly ``chunk_size`` rows.  Enumeration
    state advances only as chunks are consumed (``limit`` pushdown):
    stopping early leaves the tail unvisited, which is observable in the
    live ``stats`` counters.  The stream is single-pass; ``count`` tracks
    tuples yielded so far and ``stats.truncated`` is set the moment the
    limit is hit (the final chunk is cut at exactly ``limit`` rows).
    """

    def __init__(self, rig: RIG, order: List[int], *, chunk_size: int = 1024,
                 limit: Optional[int] = DEFAULT_LIMIT,
                 method: str = "backtrack", max_frontier: int = 1 << 25,
                 slab_rows: Optional[int] = None, budget=None, breaker=None,
                 small_frontier_rows: int = 0):
        if method not in ENUM_METHODS:
            raise ValueError(f"unknown enum method: {method!r} "
                             f"(expected one of {ENUM_METHODS})")
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        self.rig = rig
        self.order = order
        self.chunk_size = chunk_size
        self.limit = limit
        self.method = method
        self.max_frontier = (max_frontier if budget is None
                             else budget.frontier_cap(max_frontier))
        self.slab_rows = slab_rows
        self.budget = budget
        self.breaker = breaker
        self.small_frontier_rows = small_frontier_rows
        self.stats = MJoinStats(method=method)
        self.count = 0               # tuples yielded so far
        self._it = self._chunks()

    # single-pass iterable
    def __iter__(self) -> "MJoinStream":
        return self

    def __next__(self) -> np.ndarray:
        return next(self._it)

    def close(self) -> None:
        """Stop enumeration early (drops any suspended search state)."""
        self._it.close()

    # ------------------------------------------------------------ internals
    def _blocks(self):
        """Local-layout assignment blocks, with the frontier -> backtrack
        overflow fallback (safe: overflow precedes the first output)."""
        stats = self.stats
        cons = _constraints(self.rig.query, self.order)
        if self.method != "backtrack":
            mat_cap = self.limit if self.limit is not None else _INF_CAP
            if self.method == "frontier-device-resident":
                gen = _resident_frontier_events(
                    self.rig, self.order, cons, self.limit, stats,
                    max_frontier=self.max_frontier, mat_cap=mat_cap,
                    slab_rows=self.slab_rows, budget=self.budget,
                    breaker=self.breaker,
                    small_rows=self.small_frontier_rows)
            else:
                gen = _frontier_events(
                    self.rig, self.order, cons, self.limit, stats,
                    device=(self.method == "frontier-device"),
                    max_frontier=self.max_frontier, mat_cap=mat_cap,
                    slab_rows=self.slab_rows, budget=self.budget,
                    breaker=self.breaker,
                    small_rows=self.small_frontier_rows)
            try:
                try:
                    first = next(gen)
                except StopIteration:
                    return
                except FrontierOverflow:
                    stats.method = "backtrack"
                    stats.expanded = 0
                    stats.intersections = 0
                    stats.frontier_peak = 0
                    stats.device_calls = 0
                    stats.frontier_levels = []
                    stats.device_s = 0.0
                    if "backtrack" not in stats.degradations:
                        stats.degradations.append("backtrack")
                else:
                    yield first[1]
                    for ev in gen:
                        yield ev[1]
                    return
            finally:
                gen.close()
        for blk, _ in _backtrack_blocks(self.rig, self.order, cons,
                                        self.limit, stats, mat_cap=_INF_CAP,
                                        block=self.chunk_size,
                                        budget=self.budget):
            yield blk

    def _chunks(self):
        # t0 = start of the currently-unaccounted work interval; None while
        # suspended at a yield (that interval is already accounted), so the
        # finally clause never re-counts it — nor the consumer's own time
        # between receiving a chunk and closing the stream.
        stats = self.stats
        t0: Optional[float] = time.perf_counter()
        try:
            if self.rig.is_empty():
                return
            if self.limit is not None and self.limit <= 0:
                stats.truncated = True
                return
            pend: List[np.ndarray] = []
            pend_rows = 0
            for blk in self._blocks():
                if blk is None or not len(blk):
                    continue
                pend.append(blk)
                pend_rows += len(blk)
                while pend_rows >= self.chunk_size:
                    cat = pend[0] if len(pend) == 1 else np.vstack(pend)
                    out, rest = (cat[:self.chunk_size],
                                 cat[self.chunk_size:])
                    pend = [rest] if len(rest) else []
                    pend_rows = len(rest)
                    self.count += len(out)
                    stats.results = self.count
                    stats.enumerate_s += time.perf_counter() - t0
                    t0 = None
                    yield _to_query_order(out, self.order, self.rig.cand)
                    t0 = time.perf_counter()
            if pend_rows:
                cat = pend[0] if len(pend) == 1 else np.vstack(pend)
                self.count += len(cat)
                stats.results = self.count
                stats.enumerate_s += time.perf_counter() - t0
                t0 = None
                yield _to_query_order(cat, self.order, self.rig.cand)
                t0 = time.perf_counter()
            if (self.budget is not None and stats.deadline_exceeded
                    and self.budget.raise_on_error):
                raise DeadlineExceeded(
                    f"deadline exceeded after {self.count} streamed tuple(s)")
        finally:
            stats.results = self.count
            if t0 is not None:
                stats.enumerate_s += time.perf_counter() - t0


def iter_tuples(rig: RIG, order: List[int], *, chunk_size: int = 1024,
                limit: Optional[int] = DEFAULT_LIMIT,
                method: str = "backtrack", max_frontier: int = 1 << 25,
                slab_rows: Optional[int] = None, budget=None,
                breaker=None, small_frontier_rows: int = 0) -> MJoinStream:
    """Streaming counterpart of :func:`mjoin`: a lazy, chunked enumerator.

    ``np.vstack(list(iter_tuples(rig, order, chunk_size=k)))`` equals
    ``mjoin(rig, order, materialize=True).tuples`` for every ``k`` and
    every ``method``; chunks arrive in lexicographic order and enumeration
    work is done on demand (see :class:`MJoinStream`).  ``slab_rows``
    overrides the frontier gather slab height (testing / tuning hook).
    ``budget`` / ``breaker`` add cooperative governance as in :func:`mjoin`;
    a blown deadline ends the stream after the partial prefix (raising
    :class:`DeadlineExceeded` instead when ``budget.raise_on_error``).
    """
    return MJoinStream(rig, order, chunk_size=chunk_size, limit=limit,
                       method=method, max_frontier=max_frontier,
                       slab_rows=slab_rows, budget=budget, breaker=breaker,
                       small_frontier_rows=small_frontier_rows)


# -------------------------------------------------------- cross-query batch
def stack_slabs(blocks: Sequence[np.ndarray]
                ) -> Tuple[np.ndarray, List[Tuple[int, int, int, int]]]:
    """Pad + stack per-query ``(F_i, K_i, W_i)`` uint64 constraint slabs
    into one ``(ΣF, maxK, maxW)`` block for a single fused dispatch.

    Padding is AND-exact: extra K rows are all-ones (the AND identity) and
    real rows are zero-extended beyond their own W words, so the fused
    AND-reduce + popcount of the big block restricted to each span equals
    the per-query result.  Returns ``(big, spans)`` with spans of
    ``(row_offset, F_i, K_i, W_i)``.
    """
    f_tot = sum(b.shape[0] for b in blocks)
    k_max = max(b.shape[1] for b in blocks)
    w_max = max(b.shape[2] for b in blocks)
    big = np.full((f_tot, k_max, w_max), np.uint64(0xFFFFFFFFFFFFFFFF),
                  dtype=np.uint64)
    spans: List[Tuple[int, int, int, int]] = []
    off = 0
    for b in blocks:
        f, k, w = b.shape
        big[off:off + f, :k, :w] = b
        big[off:off + f, :k, w:] = 0
        spans.append((off, f, k, w))
        off += f
    return big, spans


def _host_intersect_block(big: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy AND-reduce + per-row popcount of a stacked ``(F, K, W)`` slab
    (the host stand-in for the ``intersect`` kernel on the batched path)."""
    acc = np.bitwise_and.reduce(big, axis=1)
    return acc, bitset.count_rows(acc)


class _BatchJob:
    __slots__ = ("gen", "stats", "count", "reply", "active_s")

    def __init__(self, gen, stats):
        self.gen = gen
        self.stats = stats
        self.count = 0
        self.reply = None
        self.active_s = 0.0      # this job's own share of the batch time


def mjoin_batched(jobs: Sequence[Tuple[RIG, List[int], Optional[int]]],
                  *, intersector=None, max_frontier: int = 1 << 25,
                  budgets: Optional[Sequence] = None, breaker=None
                  ) -> Tuple[List[MJoinResult], int]:
    """Count several queries' occurrences with *cross-query micro-batched*
    frontier dispatches.

    ``jobs`` is a sequence of ``(rig, order, limit)``.  Every job runs the
    level-synchronous frontier enumeration as a coroutine; each scheduler
    round collects one pending ``(F, K, W)`` constraint gather per active
    job, pads and stacks them (:func:`stack_slabs`) into a single
    ``(ΣF, K, W)`` slab, resolves it with **one** call to ``intersector``
    (the ``intersect`` CUDA kernel executor; numpy AND+popcount when
    ``None``), and scatters the per-job results back.  Per-job counts,
    truncation, and stats semantics match ``mjoin(..., materialize=False)``
    exactly; a job whose frontier overflows ``max_frontier`` falls back to
    backtracking on its own, without stalling the batch.

    ``budgets`` (parallel to ``jobs``, entries may be None) adds per-job
    governance: each armed budget's deadline/frontier caps apply to that
    job only — a blown deadline completes the job with its partial count
    (``stats.deadline_exceeded``) while the rest of the batch continues.
    ``breaker`` governs the fused dispatch; when a dispatch fails for good
    (or the breaker is open) the whole batch degrades to the numpy
    intersect for the remaining rounds, recorded per job as the
    ``host-intersect`` ladder step.

    Returns ``(results, dispatches)`` — dispatches is the number of fused
    slab calls actually issued (the quantity micro-batching minimizes).
    """
    method = "frontier-device" if intersector is not None else "frontier"
    results: List[Optional[MJoinResult]] = [None] * len(jobs)
    active = {}
    dispatches = 0

    def _budget(idx: int):
        return budgets[idx] if budgets is not None else None

    for idx, (rig, order, limit) in enumerate(jobs):
        stats = MJoinStats(method=method)
        if rig.is_empty() or (limit is not None and limit <= 0):
            stats.truncated = limit is not None and limit <= 0 \
                and not rig.is_empty()
            results[idx] = MJoinResult(0, None, stats, order)
            continue
        b = _budget(idx)
        mf = max_frontier if b is None else b.frontier_cap(max_frontier)
        cons = _constraints(rig.query, order)
        gen = _frontier_events(rig, order, cons, limit, stats, device=False,
                               max_frontier=mf, mat_cap=0,
                               external=True, budget=b)
        active[idx] = _BatchJob(gen, stats)

    while active:
        requests = {}
        for idx, job in list(active.items()):
            rig, order, limit = jobs[idx]
            t0 = time.perf_counter()
            try:
                while True:
                    ev = job.gen.send(job.reply)
                    job.reply = None
                    if ev[0] == "need":
                        requests[idx] = ev[1]
                        break
                    job.count += ev[2]
                job.active_s += time.perf_counter() - t0
            except StopIteration:
                job.stats.results = job.count
                job.stats.enumerate_s = (job.active_s
                                         + time.perf_counter() - t0)
                results[idx] = MJoinResult(job.count, None, job.stats, order)
                del active[idx]
            except FrontierOverflow:
                degr = job.stats.degradations + ["backtrack"]
                stats = MJoinStats(method="backtrack", degradations=degr,
                                   h2d_bytes=job.stats.h2d_bytes,
                                   d2h_bytes=job.stats.d2h_bytes)
                cons = _constraints(rig.query, order)
                count, _ = _mjoin_backtrack(rig, order, cons, limit,
                                            materialize=False, max_tuples=0,
                                            stats=stats, budget=_budget(idx))
                stats.results = count
                stats.enumerate_s = (job.active_s
                                     + time.perf_counter() - t0)
                results[idx] = MJoinResult(count, None, stats, order)
                del active[idx]
        if requests:
            idxs = list(requests)
            big, spans = stack_slabs([requests[i] for i in idxs])
            t0 = time.perf_counter()
            isect0 = intersector            # pre-degrade reference
            h2d0 = getattr(isect0, "h2d_bytes", 0)
            d2h0 = getattr(isect0, "d2h_bytes", 0)
            if intersector is not None:
                try:
                    if breaker is not None:
                        acc, counts = breaker.call(
                            lambda: intersector(big))
                    else:
                        acc, counts = intersector(big)
                except (DeviceFailure, BreakerOpen):
                    # degrade the whole batch for its remaining rounds:
                    # results are identical, just computed on the host
                    intersector = None
                    for i in idxs:
                        d = active[i].stats.degradations
                        if "host-intersect" not in d:
                            d.append("host-intersect")
                    acc, counts = _host_intersect_block(big)
            else:
                acc, counts = _host_intersect_block(big)
            share = (time.perf_counter() - t0) / len(idxs)
            # the ledger holds the exact fused-dispatch bytes; per-job stats
            # get an equal share (the padded fused slab is not separable
            # per job), mirroring the device_s share above
            h2d_share = (getattr(isect0, "h2d_bytes", 0)
                         - h2d0) // len(idxs)
            d2h_share = (getattr(isect0, "d2h_bytes", 0)
                         - d2h0) // len(idxs)
            dispatches += 1
            for i, (off, f, k, w) in zip(idxs, spans):
                active[i].active_s += share
                active[i].stats.device_s += share
                active[i].stats.h2d_bytes += h2d_share
                active[i].stats.d2h_bytes += d2h_share
                active[i].reply = (np.ascontiguousarray(acc[off:off + f, :w]),
                                   counts[off:off + f])
    return results, dispatches  # type: ignore[return-value]
