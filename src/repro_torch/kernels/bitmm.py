"""``bitmm`` — boolean matrix product with a bit-packed left operand.

The workhorse of the whole-graph double simulation
(:mod:`repro_torch.torchgm.simulation`): ``Y = f(unpack(A) @ X)`` where
``A`` is a 0/1 matrix stored as packed int32 lanes (the data graph's
adjacency or reachability rows) and ``X`` a dense 0/1 matrix (the
candidate sets of the query nodes, transposed).  ``f`` is ``> 0``
(threshold: existence of a successor in the set) or the plain sum
(count semantics: RIG edge counts).

On a CUDA tensor the wrapper launches ``bitmm_kernel`` of
``csrc/bitmm.cu`` (which names the TPU kernel it replaces, its bound and
its design); on a CPU tensor it runs
:func:`repro_torch.kernels.ref.bitmm_ref`.  There is no fallback between
the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _check
from .ref import bitmm_ref, check_binary

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def bitmm(a_words: torch.Tensor, x: torch.Tensor, *,
          threshold: bool = True) -> torch.Tensor:
    """a_words: int32 lanes (M, W); x: 0/1 (K, B) of any dtype and any
    strides, with ``32 (W - 1) < K <= 32 W`` (bits of A at column K and
    above do not count) -> (M, B) bool under ``threshold``, else float32
    counts.  Raises ``ValueError`` on an X that is not 0/1."""
    _check.lanes(a_words, "a_words", 2)
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("x must be a 2-D tensor (K, B)")
    dev = _check.same_device(a_words, x)
    m, w = a_words.shape
    k, b = x.shape
    if not 32 * (w - 1) < k <= 32 * w:
        raise ValueError(f"x has K={k} rows, a_words {w} lanes: need "
                         f"32*(W-1) < K <= 32*W")
    check_binary(x)
    if dev.type == "cpu":
        return bitmm_ref(a_words, x, threshold=threshold)
    bits = x if x.dtype == torch.bool else x != 0
    bits = bits.view(torch.uint8)             # same strides, 0/1 bytes
    out_dtype = torch.bool if threshold else torch.float32
    y = torch.empty((m, b), dtype=out_dtype, device=dev)
    if m == 0 or b == 0:
        return y
    xt = torch.empty((b, w), dtype=torch.int32, device=dev)
    pack_fn = _build.function("bitmm", "rt_bitmm_pack",
                              [_P, _P, _I64, _I32, _I32, _I64, _I64, _P])
    mm_fn = _build.function("bitmm", "rt_bitmm",
                            [_P, _P, _P, _I32, _I32, _I32, _I32, _P])
    sk, sb = bits.stride()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(pack_fn(bits.data_ptr(), xt.data_ptr(), k, b, w, sk, sb,
                             stream), "bitmm (pack X^T)")
        _build.check(mm_fn(a_words.data_ptr(), xt.data_ptr(), y.data_ptr(),
                           m, w, b, int(not threshold), stream), "bitmm")
    _build.count_launch("bitmm")
    return y
