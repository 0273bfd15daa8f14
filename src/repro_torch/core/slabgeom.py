"""Device slab padding geometry — pure integer math, no torch dependency.

The device intersectors (:mod:`repro_torch.torchgm.frontier`) never dispatch the
logical slab shapes the enumerator produces: ``(F, K, W)`` gather slabs
are padded to kernel block multiples (F to the next power of two >= 128,
K to a power of two with AND-identity rows, W to a multiple of 128 uint32
lanes), and resident-path dispatches pad F the same way.  Budget
enforcement must charge the *padded* allocation — on small or ragged
slabs the padding can exceed the logical size by more than 2x, so a cap
computed from logical bytes would not actually bound device memory.

This module is the single source of truth for that geometry: the
enumerator (``repro_torch.core.mjoin``, torch-free) uses it to tighten slab
heights under ``Budget.max_slab_bytes``, and the torch executors use the
same functions to size and account their real allocations.
"""

from __future__ import annotations

from typing import Tuple

LANE_BYTES = 4          # kernels operate on uint32 lanes
MIN_ROWS = 128          # F padding floor (bounds retraces to O(log F))
MIN_LANES = 128         # W padding unit, in uint32 lanes


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pow2_at_least(x: int, floor: int = MIN_ROWS) -> int:
    p = floor
    while p < x:
        p *= 2
    return p


def padded_slab_shape(f: int, k: int, w64: int) -> Tuple[int, int, int]:
    """Device shape (rows, constraints, uint32 lanes) actually allocated
    for a logical ``(f, k, w64)`` uint64 gather slab."""
    return (pow2_at_least(f), pow2_at_least(k, floor=1),
            round_up(max(2 * w64, MIN_LANES), MIN_LANES))


def padded_slab_bytes(f: int, k: int, w64: int) -> int:
    """Bytes the device intersector allocates for a logical slab."""
    fp, kp, wp = padded_slab_shape(f, k, w64)
    return fp * kp * wp * LANE_BYTES


def padded_rows_cap(max_bytes: int, k: int, w64: int, at_most: int) -> int:
    """Largest slab height whose *padded* allocation fits ``max_bytes``,
    capped at ``at_most``.  Returns 0 when even the minimal (128-row)
    padded dispatch exceeds the cap — the caller must route that level
    through the host intersect instead."""
    if padded_slab_bytes(1, k, w64) > max_bytes:
        return 0
    fp = MIN_ROWS
    while fp < at_most and padded_slab_bytes(fp * 2, k, w64) <= max_bytes:
        fp *= 2
    return min(fp, at_most)


def resident_dispatch_bytes(f: int, k: int, w_lanes: int) -> int:
    """Per-dispatch device transient of the resident gather-intersect
    path: the padded ``(F, K)`` int32 index upload plus the padded
    ``(F, W)`` AND output and ``(F,)`` counts (the resident matrix itself
    is a one-time upload, charged separately)."""
    fp = pow2_at_least(f)
    return fp * (k + w_lanes + 1) * LANE_BYTES


def resident_rows_cap(max_bytes: int, k: int, w_lanes: int,
                      at_most: int) -> int:
    """Resident-path analogue of :func:`padded_rows_cap`."""
    if resident_dispatch_bytes(1, k, w_lanes) > max_bytes:
        return 0
    fp = MIN_ROWS
    while fp < at_most and resident_dispatch_bytes(fp * 2, k,
                                                   w_lanes) <= max_bytes:
        fp *= 2
    return min(fp, at_most)
