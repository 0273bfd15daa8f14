"""Packing of a RIG into the one matrix the resident executor uploads."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def pack_resident_rig(rig) -> Tuple[np.ndarray, List[int], List[int], int]:
    """Concatenate a RIG's per-edge packed adjacency into one uint32
    matrix for the resident gather-intersect path.

    Every ``rig.fwd[e]`` / ``rig.bwd[e]`` uint64 matrix is re-viewed as
    little-endian uint32 lanes (bit-compatible with the host packing) and
    stacked row-wise into ``(R, W)`` with ``W`` = the widest edge's lane
    count rounded to 128; rows are zero-extended beyond their true width,
    so AND/popcount over the common width is exact.  A dedicated all-zero
    row is appended last — index padding targets it so padded dispatch
    rows contribute nothing.

    Returns ``(matrix32, fwd_off, bwd_off, zero_row)``: constraint row
    ``(edge e, forward, local src id i)`` lives at ``fwd_off[e] + i``
    (``bwd_off[e] + i`` for backward rows).  The matrix is byte-equal to
    the JAX package's packing of the same RIG.

    Resident footprint: ``(Σ_e |cos(src_e)| + |cos(dst_e)| + 1) * W * 4``
    bytes — linear in RIG nodes per edge, not in enumerated frontiers.
    """
    mats = list(rig.fwd) + list(rig.bwd)
    w_lanes = 128
    for m in mats:
        w_lanes = max(w_lanes, 2 * m.shape[1])
    w_lanes = -(-w_lanes // 128) * 128
    rows = sum(m.shape[0] for m in mats) + 1          # + the all-zero row
    matrix = np.zeros((rows, w_lanes), dtype=np.uint32)
    fwd_off: List[int] = []
    bwd_off: List[int] = []
    off = 0
    for offs, group in ((fwd_off, rig.fwd), (bwd_off, rig.bwd)):
        for m in group:
            offs.append(off)
            s, w64 = m.shape
            if s:
                matrix[off:off + s, :2 * w64] = np.ascontiguousarray(
                    m).view(np.uint32).reshape(s, 2 * w64)
            off += s
    return matrix, fwd_off, bwd_off, rows - 1
