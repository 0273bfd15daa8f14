"""Frozen work counts of the port's kernels and the peaks they are held to.

Each function gives ``(bytes, operations)`` that one call must move and do
on its inputs, as ``chip_smoke.py``'s ``bound`` counts them: each input
byte read once and each output byte written once, whatever the kernel
reads again, and the operations that the inputs need (live rows, never the
frontier's capacity).  :func:`least_s` turns a count into the least time
the card could take: the larger of the bytes over the memory rate and the
operations over the rate of the units that do them.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12          # device memory
INT8_TENSOR_OPS_PER_S = 1979e12    # int8 tensor cores: bitmm's product
INT32_OPS_PER_S = 67e12            # 32-bit operations outside the tensor cores

OPS_PER_S = {"bitmm": INT8_TENSOR_OPS_PER_S,
             "gather_expand": INT32_OPS_PER_S}


def bitmm(m: int, w: int, k: int, b: int, *, x_bytes: int = 1,
          threshold: bool = True) -> Tuple[int, int]:
    """A (M, W) int32 lanes by X (K, B): A read once, X and Y once; the
    product as the int8 tensor cores do it, 2 * M * 32 W * B operations (a
    multiply-add is two).  Y is bool under ``threshold``, else float32."""
    out = m * b * (1 if threshold else 4)
    return 4 * m * w + k * b * x_bytes + out, 2 * m * 32 * w * b


def gather_expand(live: int, alive: int, k: int, distinct: int, size: int,
                  expand: bool = True) -> Tuple[int, int]:
    """One level of the whole-graph enumerator: ``alive`` live frontier
    rows, each ANDing its candidate row with ``k`` gathered rows over
    ``live`` lanes; ``distinct`` different rows gathered (each read once),
    the index of the live rows, the candidate row, and ``size`` (row,
    column) pairs written when the level expands.  One AND or popcount a
    gathered lane."""
    pairs = 2 * size if expand else 0
    return (4 * (distinct * live + alive * k + pairs + live),
            alive * live * (k + 1))


def least_s(kernel: str, nbytes: int, ops: int) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations") for one call."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / OPS_PER_S[kernel]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
