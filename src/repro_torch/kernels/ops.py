"""Dispatching entry points of the port's kernels, as the JAX package's
``repro.kernels.ops`` names them.

There is no ``impl`` switch: each wrapper launches its CUDA kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor.
``closure_step`` and ``transitive_closure`` (the on-device closure) are
not ported yet.
"""

from __future__ import annotations

from .bitmm import bitmm
from .intersect import intersect

__all__ = ["bitmm", "intersect"]
