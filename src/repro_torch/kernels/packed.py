"""Packed-bitset utilities on torch tensors (32-bit lanes).

Device-side mirror of :mod:`repro_torch.core.bitset`, which packs into
uint64 words with numpy.  The kernels work on 32-bit lanes: bit ``i`` of a
universe lives in lane ``i >> 5`` at position ``i & 31`` (little-endian),
so the host's uint64 words, viewed as uint32 pairs on a little-endian
machine, are already in lane order.

torch's CPU build has no right shift for ``uint32`` and no popcount op,
so every lane here is an ``int32`` holding the same 32 bits: an int32
view of uint32 words is bit-identical, while a cast would change values.
Popcount uses the SWAR bit trick on int64 copies of the lanes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

WORD = 32


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """Values in [0, 2^32) held in int64 -> int32 lanes with the same bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def pack(mask: torch.Tensor) -> torch.Tensor:
    """bool (..., n) -> int32 lanes (..., ceil(n/32)), little-endian bits."""
    n = mask.shape[-1]
    pad = (-n) % WORD
    if pad:
        mask = torch.cat([mask, mask.new_zeros(mask.shape[:-1] + (pad,))],
                         dim=-1)
    m = mask.reshape(mask.shape[:-1] + (-1, WORD)).to(torch.int64)
    weights = torch.ones(WORD, dtype=torch.int64,
                         device=mask.device) << torch.arange(
                             WORD, dtype=torch.int64, device=mask.device)
    return _as_int32((m * weights).sum(dim=-1))


def unpack(words: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """int32 lanes (..., W) -> bool (..., W*32), cut to ``n`` bits."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    # arithmetic shift sign-extends, but bit 0 of the result is bit `s`
    bits = ((words[..., None] >> shifts) & 1).to(torch.bool)
    out = bits.reshape(words.shape[:-1] + (-1,))
    return out if n is None else out[..., :n]


# rows of a packed matrix unpacked per chunk of transpose: 2,048 rows of the
# epinions graph's 76,288 columns are 156 MB as bool
_TRANSPOSE_CHUNK_ROWS = 2048


def transpose(words: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transpose of a square packed bit matrix: int32 lanes (N, N/32) ->
    the same shape, into ``out`` when given.  Rows are unpacked a chunk of
    ``32 c`` at a time, transposed and packed into lanes ``r0/32 ..
    r0/32 + c`` of every output row, so no N x N matrix is unpacked."""
    n, w = words.shape
    if n != WORD * w:
        raise ValueError(f"transpose needs a square packed matrix (N, N/32),"
                         f" got {tuple(words.shape)}")
    if out is None:
        out = torch.empty_like(words)
    for r0 in range(0, n, _TRANSPOSE_CHUNK_ROWS):
        r1 = min(n, r0 + _TRANSPOSE_CHUNK_ROWS)
        out[:, r0 // WORD:r1 // WORD] = pack(unpack(words[r0:r1]).t())
    return out


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-lane popcount of int32 lanes -> int32; reduce with .sum()."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def pack_numpy_u64_to_u32(words64: np.ndarray) -> torch.Tensor:
    """The host path's packed uint64 words as int32 lanes (little-endian
    layouts are bit-compatible: one uint64 word is two lanes)."""
    return torch.from_numpy(np.ascontiguousarray(words64).view(np.int32))
