"""``closure_step`` — one boolean squaring step of the transitive closure
on packed rows — and ``transpose``, the packed bit transpose that turns the
closure into its transposed matrix.

``R' = R | (R·R > 0)`` for a square 0/1 matrix ``R`` of ``N`` rows stored
as ``N / 32`` packed int32 lanes per row; ``N`` a multiple of 32.
Repeated ``⌈log₂ N⌉`` times from the adjacency
(:func:`repro_torch.kernels.ops.transitive_closure`) it gives the
reachability matrix of the whole-graph matcher's on-device closure path
(``from_host(closure_on_device=True)``), which then transposes it.

On a CUDA tensor each wrapper launches its kernel of ``csrc/closure.cu``
(which names what it replaces, its bound and its design): ``closure_step``
a pass that lists each row's set columns (:func:`row_lists`) and a pass
that builds each output row from those lists, counted as one
``closure_step`` launch; ``transpose`` a bit-block transpose.  On a CPU
tensor they run :func:`repro_torch.kernels.ref.closure_step_ref`,
:func:`repro_torch.kernels.ref.closure_row_lists_ref` and
:func:`repro_torch.kernels.packed.transpose`.  There is no fallback
between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build, _check, packed
from .ref import closure_row_lists_ref, closure_step_ref

_P, _I32 = ctypes.c_void_p, ctypes.c_int

#: entries of a row's column list; a row with more set bits is dense (the
#: kernel's ``kCap``)
LIST_CAP = 32


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def _square(words: torch.Tensor, name: str, fn: str) -> Tuple[int, int]:
    _check.lanes(words, name, 2)
    n, w = words.shape
    if n != 32 * w:
        raise ValueError(f"{fn} needs a square packed matrix (N, N/32), got "
                         f"{tuple(words.shape)}")
    return n, w


def _output(words: torch.Tensor, out: Optional[torch.Tensor],
            name: str) -> torch.Tensor:
    """``out``, checked to be a buffer of ``words``' shape and device that
    does not overlap it (other rows are still read while one is written),
    or a new one."""
    if out is None:
        return torch.empty_like(words)
    _check.lanes(out, "out", 2)
    _check.same_device(words, out)
    if out.shape != words.shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, {name} "
                         f"{tuple(words.shape)}")
    if words.numel() and _overlap(out, words):
        raise ValueError(f"out overlaps {name}")
    return out


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def closure_step(r_words: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """r_words: int32 lanes (N, N/32) -> R | (R·R > 0), same shape,
    written into ``out`` when given (a buffer of the same shape and device
    that does not overlap ``r_words``).

    The step is the operator ``repro_torch::closure_step`` (it writes
    ``out``), so that fake and ``meta`` tensors trace it (counting no
    launch) and ``FlopCounterMode`` counts the kernel's own operations
    (:func:`closure_step_flops`)."""
    _square(r_words, "r_words", "closure_step")
    out = _output(r_words, out, "r_words")
    _check.same_device(r_words)
    _closure_step_op(r_words, out)
    return out


@torch.library.custom_op("repro_torch::closure_step", mutates_args=("out",))
def _closure_step_op(r_words: torch.Tensor, out: torch.Tensor) -> None:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if r_words.device.type == "cpu":
        out.copy_(closure_step_ref(r_words))
        return
    n, w = r_words.shape
    if n == 0:
        return
    dev = r_words.device
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    lists = torch.empty((n, LIST_CAP), dtype=torch.int32, device=dev)
    fn = _build.function("closure", "rt_closure_step",
                         [_P, _P, _P, _P, _I32, _I32, _I32, _P])
    with torch.cuda.device(dev):
        _build.check(fn(r_words.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                        lists.data_ptr(), n, w, LIST_CAP, _stream(dev)),
                     "closure_step")
    _build.count_launch("closure_step")


@_closure_step_op.register_fake
def _closure_step_fake(r_words, out):
    return None


@register_flop_formula(torch.ops.repro_torch.closure_step)
def closure_step_flops(r_shape, out_shape_arg=None, *_, out_shape=None,
                       **__) -> int:
    """The kernel's word operations on an R whose every row is dense (more
    than ``LIST_CAP`` set bits) and every bit set, the most it does:
    each lane popcounted, copied and written (3 N W), and one OR per lane
    of row k for each set bit (i, k) (N N W).  PERF.md's count for a
    given R (``chip_smoke.closure_step_ops``) reads R's bits, which a
    formula of shapes cannot."""
    n, w = r_shape
    return 3 * n * w + n * n * w


def row_lists(r_words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first pass of :func:`closure_step` alone: int32 lanes (N, N/32)
    -> (cnt (N,) int32, the set bits of each row; lists (N, LIST_CAP)
    int32, the set columns of each row with ``cnt <= LIST_CAP`` in
    ascending order).  Entries past a row's count, and every entry of a
    dense row, are -1 on the CPU and undefined on the card."""
    n, w = _square(r_words, "r_words", "row_lists")
    dev = _check.same_device(r_words)
    if dev.type == "cpu":
        return closure_row_lists_ref(r_words, LIST_CAP)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    lists = torch.empty((n, LIST_CAP), dtype=torch.int32, device=dev)
    if n == 0:
        return cnt, lists
    fn = _build.function("closure", "rt_closure_row_lists",
                         [_P, _P, _P, _I32, _I32, _I32, _P])
    with torch.cuda.device(dev):
        _build.check(fn(r_words.data_ptr(), cnt.data_ptr(), lists.data_ptr(),
                        n, w, LIST_CAP, _stream(dev)), "closure_row_lists")
    _build.count_launch("closure_row_lists")
    return cnt, lists


def transpose(words: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transpose of a square packed bit matrix: int32 lanes (N, N/32) ->
    the same shape, into ``out`` when given (a buffer of the same shape
    and device that does not overlap ``words``)."""
    n, w = _square(words, "words", "transpose")
    out = _output(words, out, "words")
    dev = _check.same_device(words)
    if dev.type == "cpu":
        return packed.transpose(words, out=out)
    if n == 0:
        return out
    fn = _build.function("closure", "rt_transpose", [_P, _P, _I32, _P])
    with torch.cuda.device(dev):
        _build.check(fn(words.data_ptr(), out.data_ptr(), w, _stream(dev)),
                     "transpose")
    _build.count_launch("transpose")
    return out
