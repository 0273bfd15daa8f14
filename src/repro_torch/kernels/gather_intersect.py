"""``gather_intersect``, ``expand_pairs`` and ``gather_expand`` — the
resident-RIG kernels and the whole-graph enumerator's level.

The resident enumerator (``repro_torch.core.mjoin``, method
``frontier-device-resident``) keeps every packed RIG adjacency matrix in
one device-resident int32 lane matrix ``(R, W)``.  A level dispatch ships
only the ``(F, K)`` int32 row indices of its constraint rows:

* :func:`gather_intersect` gathers those rows on the device, ANDs them
  over the level's ``w32`` live lanes and popcounts each result row;
* :func:`expand_pairs` turns the AND rows' set bits into compact
  ``(row, column)`` pair pages in row-major (= lexicographic) order;
* :func:`gather_expand` is one level of the whole-graph enumerator
  (``repro_torch.torchgm.enumerate``): each live frontier row's candidate
  row ANDed with its gathered rows, counted and expanded, without the
  AND rows ever being written.

On a CUDA tensor each wrapper launches the hand-written kernels of
``csrc/frontier_kernels.cu`` (which name the TPU kernels they replace and
their bounds); on a CPU tensor it runs the plain version of
:mod:`repro_torch.kernels.ref`.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, _check
from .ref import expand_pairs_ref, gather_expand_ref, gather_intersect_ref

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def gather_intersect(matrix: torch.Tensor, idx: torch.Tensor, *, w32: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """matrix: int32 lanes (R, W); idx: int32 (F, K) row indices in
    ``[0, R)`` (callers check them on the host before upload) ->
    (and_rows int32 (F, w32), counts int32 (F,)), counts over the ``w32``
    lanes (see :func:`repro_torch.kernels.ref.gather_intersect_ref`)."""
    _check.lanes(matrix, "matrix", 2)
    _check.lanes(idx, "idx", 2)
    dev = _check.same_device(matrix, idx)
    _, w = matrix.shape
    f, k = idx.shape
    if not 0 < w32 <= w or w32 % 2:
        raise ValueError(f"w32 must be even and in (0, {w}], got {w32}")
    if k < 1:
        raise ValueError(f"K must be at least 1, got {k}")
    if dev.type == "cpu":
        return gather_intersect_ref(matrix, idx, w32=w32)
    if w % 4:
        raise ValueError(f"matrix rows must hold a multiple of 4 lanes, "
                         f"got W={w}")
    _check.aligned(matrix, "matrix", 16)
    and_rows = torch.empty((f, w32), dtype=torch.int32, device=dev)
    counts = torch.empty((f,), dtype=torch.int32, device=dev)
    if f == 0:
        return and_rows, counts
    fn = _build.function("frontier_kernels", "rt_gather_intersect",
                         [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(matrix.data_ptr(), idx.data_ptr(),
                        and_rows.data_ptr(), counts.data_ptr(), w, f, k, w32,
                        stream), "gather_intersect")
    _build.count_launch("gather_intersect")
    return and_rows, counts


def _segments(live: int) -> int:
    """Segments of a row of ``live`` lanes (the kernels' unit of work)."""
    lanes = _build.function("frontier_kernels", "rt_segment_lanes", [])()
    return -(-live // lanes)


def _expand(rows, fb, idx, n_alive, *, w_all, f, k, n_i, size, expand,
            name, scan=False):
    """Launch the segment kernels: pass 1 counts each (row, segment), the
    int64 scan of the counts gives every segment its first pair slot, and
    pass 2 (when ``expand``) writes the first ``size`` pairs.  Returns
    (total int64 0-d, rid, cid) on the rows' device, and with ``scan`` the
    rows' inclusive scan too (each row's last segment's entry of the
    segments' scan); no host sync."""
    dev = rows.device
    live = min(w_all, (n_i + 31) // 32)
    nseg = _segments(live)
    if f * nseg >= 1 << 31:
        raise ValueError(f"{name}: {f} rows of {nseg} segments are more "
                         f"than the kernels index (2^31)")
    gather = int(idx is not None)
    ptr = (lambda t: None if t is None else t.data_ptr())
    counts = torch.empty((f * nseg,), dtype=torch.int32, device=dev)
    count_fn = _build.function(
        "frontier_kernels", "rt_segment_counts",
        [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _P])
    write_fn = _build.function(
        "frontier_kernels", "rt_segment_write",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
         _I64, _I32, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(count_fn(rows.data_ptr(), ptr(fb), ptr(idx),
                              ptr(n_alive), counts.data_ptr(), w_all, f, k,
                              live, n_i, nseg, gather, stream),
                     f"{name} (segment counts)")
        if not expand and not scan:
            return counts.sum(dtype=torch.int64), None, None
        incl = torch.cumsum(counts, dim=0, dtype=torch.int64)
        rows_incl = (incl.view(f, nseg)[:, -1],) if scan else ()
        if not expand or size == 0:
            pairs = ([torch.zeros((0,), dtype=torch.int32, device=dev)
                      for _ in range(2)] if expand else [None, None])
            return (incl[-1], *pairs, *rows_incl)
        rid = torch.empty((size,), dtype=torch.int32, device=dev)
        cid = torch.empty((size,), dtype=torch.int32, device=dev)
        _build.check(write_fn(rows.data_ptr(), ptr(fb), ptr(idx),
                              ptr(n_alive), counts.data_ptr(),
                              incl.data_ptr(), rid.data_ptr(),
                              cid.data_ptr(), w_all, f, k, live, n_i, nseg,
                              size, gather, stream),
                     f"{name} (segment write)")
    return (incl[-1], rid, cid, *rows_incl)


def expand_pairs(and_rows: torch.Tensor, *, n_i: int, size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Set bits of ``and_rows`` (int32 lanes (F, w32)) at columns below
    ``n_i`` -> the first ``size`` ``(row, column)`` pairs in row-major
    order, as int32 vectors of length ``size`` zero-filled past the last
    pair.  ``size`` is a static page bound: callers bucket it and slice
    the valid prefix themselves."""
    _check.lanes(and_rows, "and_rows", 2)
    dev = _check.same_device(and_rows)
    f, w = and_rows.shape
    if not 0 < n_i <= 32 * w:
        raise ValueError(f"n_i must be in (0, {32 * w}], got {n_i}")
    if size < 0:
        raise ValueError(f"size must be >= 0, got {size}")
    if dev.type == "cpu":
        return expand_pairs_ref(and_rows, n_i=n_i, size=size)
    if f == 0 or size == 0:
        return (torch.zeros((size,), dtype=torch.int32, device=dev),
                torch.zeros((size,), dtype=torch.int32, device=dev))
    _, rid, cid = _expand(and_rows, None, None, None, w_all=w, f=f, k=0,
                          n_i=n_i, size=size, expand=True,
                          name="expand_pairs")
    _build.count_launch("expand_pairs")
    return rid, cid


def gather_expand(mats: torch.Tensor, fb_row: torch.Tensor,
                  idx: torch.Tensor, n_alive: torch.Tensor, *, n_i: int,
                  size: int, expand: bool = True, scan: bool = False
                  ) -> Tuple[Optional[torch.Tensor], ...]:
    """One level of the whole-graph enumerator.

    mats: int32 lanes (R, W), the stacked matrices' flat view; fb_row:
    int32 lanes (W,), the level's candidate row; idx: int32 (F, Kc) row
    ids into ``mats``, one column per constraining edge (``Kc`` may be 0;
    callers keep them in ``[0, R)``); n_alive: int64 0-d tensor on the
    same device, the number of live frontier rows (a prefix: rows at or
    past it count nothing and are not read).  Row f of the level is
    ``fb_row & AND_k mats[idx[f, k]]`` cut below column ``n_i``.

    Returns (total, rid, cid): total, the int64 0-d count of the live
    rows' set bits; with ``expand``, the first ``size`` ``(row, column)``
    pairs in row-major order as :func:`expand_pairs` gives them (without,
    None and None).  With ``scan`` a fourth tensor follows: the int64
    (F,) inclusive scan of the rows' counts, which the paging enumerator
    cuts a level's rows by.  Nothing waits for the device."""
    _check.lanes(mats, "mats", 2)
    _check.lanes(fb_row, "fb_row", 1)
    _check.lanes(idx, "idx", 2)
    if not isinstance(n_alive, torch.Tensor):
        raise TypeError(f"n_alive must be a torch.Tensor, got "
                        f"{type(n_alive)}")
    dev = _check.same_device(mats, fb_row, idx, n_alive)
    _, w = mats.shape
    f, k = idx.shape
    if fb_row.shape != (w,):
        raise ValueError(f"fb_row must have shape ({w},), got "
                         f"{tuple(fb_row.shape)}")
    if n_alive.dtype != torch.int64 or n_alive.dim() != 0:
        raise ValueError(f"n_alive must be an int64 0-d tensor, got "
                         f"{n_alive.dtype} {tuple(n_alive.shape)}")
    if not 0 < n_i <= 32 * w:
        raise ValueError(f"n_i must be in (0, {32 * w}], got {n_i}")
    if size < 0:
        raise ValueError(f"size must be >= 0, got {size}")
    if dev.type == "cpu":
        return gather_expand_ref(mats, fb_row, idx, n_alive, n_i=n_i,
                                 size=size, expand=expand, scan=scan)
    if f == 0:
        pairs = [torch.zeros((size,), dtype=torch.int32, device=dev)
                 if expand else None for _ in range(2)]
        rows_incl = ((torch.zeros((0,), dtype=torch.int64, device=dev),)
                     if scan else ())
        return (torch.zeros((), dtype=torch.int64, device=dev), *pairs,
                *rows_incl)
    out = _expand(mats, fb_row, idx, n_alive, w_all=w, f=f, k=k, n_i=n_i,
                  size=size, expand=expand, name="gather_expand", scan=scan)
    _build.count_launch("gather_expand")
    return out
