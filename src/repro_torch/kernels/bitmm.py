"""``bitmm`` — boolean matrix product with a bit-packed left operand.

The workhorse of the whole-graph double simulation
(:mod:`repro_torch.torchgm.simulation`): ``Y = f(unpack(A) @ X)`` where
``A`` is a 0/1 matrix stored as packed int32 lanes (the data graph's
adjacency or reachability rows) and ``X`` a dense 0/1 matrix (the
candidate sets of the query nodes, transposed).  ``f`` is ``> 0``
(threshold: existence of a successor in the set) or the plain sum
(count semantics: RIG edge counts).

On a CUDA tensor the wrapper launches ``bitmm_kernel`` of
``csrc/bitmm.cu`` (which names the TPU kernel it replaces, its bounds and
its design: one pass over A for up to 256 columns, the product on the int8
tensor cores) with the right operand that :func:`b_operand` prepares; on a
CPU tensor it runs
:func:`repro_torch.kernels.ref.bitmm_ref`.  There is no fallback between
the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _check
from .ref import bitmm_ref, check_binary

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the kernel's int32 sums of up to 128 per column stay exact below this K
_MAX_K = 1 << 24


def b_operand(x: torch.Tensor, w: int) -> torch.Tensor:
    """The kernel's right operand for a 0/1 ``x`` (K, B) and ``w`` lanes of
    A: X^T as K-major 0/1 bytes, a (B, 32 W) uint8 tensor whose first
    element lies on a 16-byte boundary and whose rows are a multiple of 16
    bytes apart (and no closer than 32 W), zero at columns K and above (so
    A's bits there multiply zeros).

    The simulation's operand is already that layout: the transpose of a
    contiguous (B, 32 W) bool with K = 32 W.  Then this returns a view of
    ``x``'s own storage (no copy); any other ``x`` is copied into a new
    zero-padded tensor.  ``x`` must already be 0/1."""
    k, b = x.shape
    xt = x.t()
    if (x.dtype in (torch.bool, torch.uint8) and k == 32 * w
            and xt.stride(1) == 1 and x.data_ptr() % 16 == 0
            and (b == 1 or (xt.stride(0) % 16 == 0
                            and xt.stride(0) >= 32 * w))):
        return xt.view(torch.uint8)
    out = torch.zeros((b, 32 * w), dtype=torch.uint8, device=x.device)
    out[:, :k] = xt != 0
    return out


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
    if k >= _MAX_K:
        raise ValueError(f"bitmm on the card takes K < 2^24, got {k}")
    out_dtype = torch.bool if threshold else torch.float32
    y = torch.empty((m, b), dtype=out_dtype, device=dev)
    if m == 0 or b == 0:
        return y
    xt = b_operand(x, w)
    fn = _build.function("bitmm", "rt_bitmm",
                         [_P, _P, _P, _I32, _I32, _I32, _I64, _I32, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(a_words.data_ptr(), xt.data_ptr(), y.data_ptr(), m,
                        w, b, xt.stride(0) if b > 1 else 32 * w,
                        int(not threshold), stream),
                     "bitmm")
    _build.count_launch("bitmm")
    return y
