"""``intersect`` — K-way AND + popcount of a shipped constraint slab.

The MJoin candidate step (Alg. 5, lines 5-7) of the slab-shipping
executor (``frontier-device`` and the cross-query batched lane): for F
partial matches, each constrained by K packed rows gathered on the host,
the AND of the K rows and its popcount.  On a CUDA tensor the wrapper
launches ``intersect_kernel`` of ``csrc/frontier_kernels.cu``; on a CPU
tensor it runs :func:`repro_torch.kernels.ref.intersect_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, _check
from .ref import intersect_ref

_P, _I32 = ctypes.c_void_p, ctypes.c_int


def intersect(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows: int32 lanes (F, K, W) -> (and_rows int32 (F, W),
    counts int32 (F,)).  On the card W must be a multiple of 4 lanes (the
    executor pads it to 128)."""
    _check.lanes(rows, "rows", 3)
    dev = _check.same_device(rows)
    f, k, w = rows.shape
    if k < 1:
        raise ValueError(f"K must be at least 1, got {k}")
    if dev.type == "cpu":
        return intersect_ref(rows)
    if w % 4:
        raise ValueError(f"rows must hold a multiple of 4 lanes, got W={w}")
    _check.aligned(rows, "rows", 16)
    and_rows = torch.empty((f, w), dtype=torch.int32, device=dev)
    counts = torch.empty((f,), dtype=torch.int32, device=dev)
    if f == 0 or w == 0:
        counts.zero_()
        return and_rows, counts
    fn = _build.function("frontier_kernels", "rt_intersect",
                         [_P, _P, _P, _I32, _I32, _I32, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(rows.data_ptr(), and_rows.data_ptr(),
                        counts.data_ptr(), f, k, w, stream), "intersect")
    _build.count_launch("intersect")
    return and_rows, counts
