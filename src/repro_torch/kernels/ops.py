"""Dispatching entry points of the port's kernels, as the JAX package's
``repro.kernels.ops`` names them.

There is no ``impl`` switch: each wrapper launches its CUDA kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor.
``transitive_closure`` repeats ``closure_step`` and ``transpose`` turns
its result into the transposed matrix (the on-device closure of
``from_host(closure_on_device=True)``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .bitmm import bitmm
from .closure import closure_step, transpose
from .intersect import intersect

__all__ = ["bitmm", "closure_step", "intersect", "transitive_closure",
           "transpose"]


def transitive_closure(adj_words: torch.Tensor, *,
                       n_steps: Optional[int] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The closure of a square packed adjacency (int32 lanes (N, N/32)) by
    repeated squaring: ``n_steps`` calls of :func:`closure_step`, by
    default ``⌈log₂ max(N, 2)⌉``, which reach any path length (as the JAX
    package runs them: no early exit at the fixed point).

    The result lands in ``out`` (allocated when not given; it must not
    overlap ``adj_words``, which is left as it was).  The steps ping-pong
    between ``out`` and one temporary buffer of the same shape.
    """
    n = adj_words.shape[0]
    steps = n_steps if n_steps is not None else max(
        1, math.ceil(math.log2(max(n, 2))))
    if out is None:
        out = torch.empty_like(adj_words)
    if steps == 0:
        return out.copy_(adj_words)
    tmp = torch.empty_like(out) if steps > 1 else None
    bufs = (out, tmp) if steps % 2 else (tmp, out)   # the last step -> out
    r = adj_words
    for s in range(steps):
        r = closure_step(r, out=bufs[s % 2])
    return out
