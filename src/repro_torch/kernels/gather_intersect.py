"""``gather_intersect`` and ``expand_pairs`` — the resident-RIG kernels.

The resident enumerator (``repro_torch.core.mjoin``, method
``frontier-device-resident``) keeps every packed RIG adjacency matrix in
one device-resident int32 lane matrix ``(R, W)``.  A level dispatch ships
only the ``(F, K)`` int32 row indices of its constraint rows:

* :func:`gather_intersect` gathers those rows on the device, ANDs them
  over the level's ``w32`` live lanes and popcounts each result row;
* :func:`expand_pairs` turns the AND rows' set bits into compact
  ``(row, column)`` pair pages in row-major (= lexicographic) order.

On a CUDA tensor each wrapper launches the hand-written kernels of
``csrc/frontier_kernels.cu`` (which name the TPU kernels they replace and
their bounds); on a CPU tensor it runs the plain version of
:mod:`repro_torch.kernels.ref`.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, _check
from .ref import expand_pairs_ref, gather_intersect_ref

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
    rid = torch.empty((size,), dtype=torch.int32, device=dev)
    cid = torch.empty((size,), dtype=torch.int32, device=dev)
    if f == 0 or size == 0:
        rid.zero_()
        cid.zero_()
        return rid, cid
    counts = torch.empty((f,), dtype=torch.int32, device=dev)
    count_fn = _build.function("frontier_kernels", "rt_row_counts",
                               [_P, _P, _I32, _I32, _I32, _P])
    write_fn = _build.function("frontier_kernels", "rt_expand_write",
                               [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I64,
                                _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(count_fn(and_rows.data_ptr(), counts.data_ptr(), f, w,
                              n_i, stream), "expand_pairs (row counts)")
        # exclusive offsets come from this scan: incl[r] - counts[r]
        incl = torch.cumsum(counts, dim=0, dtype=torch.int64)
        _build.check(write_fn(and_rows.data_ptr(), counts.data_ptr(),
                              incl.data_ptr(), rid.data_ptr(),
                              cid.data_ptr(), f, w, n_i, size, stream),
                     "expand_pairs (write)")
    _build.count_launch("expand_pairs")
    return rid, cid
