"""``closure_step`` — one boolean squaring step of the transitive closure
on packed rows.

``R' = R | (R·R > 0)`` for a square 0/1 matrix ``R`` of ``N`` rows stored
as ``N / 32`` packed int32 lanes per row; ``N`` a multiple of 32.
Repeated ``⌈log₂ N⌉`` times from the adjacency
(:func:`repro_torch.kernels.ops.transitive_closure`) it gives the
reachability matrix of the whole-graph matcher's on-device closure path
(``from_host(closure_on_device=True)``).

On a CUDA tensor the wrapper launches ``closure_step_kernel`` of
``csrc/closure.cu`` (which names the TPU kernel it replaces, its bound and
its design); on a CPU tensor it runs
:func:`repro_torch.kernels.ref.closure_step_ref`.  There is no fallback
between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, _check
from .ref import closure_step_ref

_P, _I32 = ctypes.c_void_p, ctypes.c_int


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def closure_step(r_words: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """r_words: int32 lanes (N, N/32) -> R | (R·R > 0), same shape,
    written into ``out`` when given (a buffer of the same shape and device
    that does not overlap ``r_words``: other rows are still reading R
    while one is written)."""
    _check.lanes(r_words, "r_words", 2)
    n, w = r_words.shape
    if n != 32 * w:
        raise ValueError(f"closure_step needs a square packed matrix "
                         f"(N, N/32), got {tuple(r_words.shape)}")
    if out is None:
        out = torch.empty_like(r_words)
    else:
        _check.lanes(out, "out", 2)
        _check.same_device(r_words, out)
        if out.shape != r_words.shape:
            raise ValueError(f"out has shape {tuple(out.shape)}, r_words "
                             f"{tuple(r_words.shape)}")
        if n and _overlap(out, r_words):
            raise ValueError("out overlaps r_words")
    dev = _check.same_device(r_words)
    if dev.type == "cpu":
        out.copy_(closure_step_ref(r_words))
        return out
    if n == 0:
        return out
    fn = _build.function("closure", "rt_closure_step", [_P, _P, _I32, _I32,
                                                        _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(r_words.data_ptr(), out.data_ptr(), n, w, stream),
                     "closure_step")
    _build.count_launch("closure_step")
    return out
