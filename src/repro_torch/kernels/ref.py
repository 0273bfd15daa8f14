"""Plain PyTorch versions of the port's CUDA kernels.

They are the semantic ground truth: the CPU tests hold them to the JAX
package's oracles, the kernel wrappers take them for tensors on the CPU,
and ``chip_smoke.py`` holds each CUDA kernel to its plain version on the
card.  All lanes are int32 tensors holding the packed uint32 bits (see
:mod:`repro_torch.kernels.packed`); every result is an exact integer.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import packed

# elements of unpacked A per K-chunk of bitmm_ref (a 2^27-element float32
# chunk is 512 MB): the whole unpacked adjacency of the epinions graph
# would be 5.8 GB as bool and 23 GB as float32
_BITMM_CHUNK_ELEMENTS = 1 << 27
# unpacked bits per row chunk of expand_pairs_ref: a frontier page of the
# whole-graph matcher (65,536 rows of 76,288 bits at epinions) would be
# 5 GB as bool
_EXPAND_CHUNK_BITS = 1 << 27


def check_binary(x: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every element of ``x`` is 0 or 1 (a
    bool tensor always is; any other dtype is checked, which on the card
    waits for the device)."""
    if x.dtype != torch.bool and bool(((x != 0) & (x != 1)).any()):
        raise ValueError("bitmm takes a 0/1 right operand")


def bitmm_ref(a_words: torch.Tensor, x: torch.Tensor, *,
              threshold: bool = True) -> torch.Tensor:
    """Boolean matrix product with a bit-packed left operand.

    a_words: int32 lanes (M, W) — packed 0/1 rows; x: 0/1 (K, B) with
    ``32 (W - 1) < K <= 32 W`` (bits of A at column K and above do not
    count) -> (M, B): bool ``(A @ x) > 0`` under ``threshold``, else the
    float32 counts ``A @ x`` (exact: every count is below 2^24).  A is
    unpacked one K-chunk at a time, never whole.
    """
    check_binary(x)
    m, w = a_words.shape
    k, b = x.shape
    xf = x.to(torch.float32)
    y = torch.zeros((m, b), dtype=torch.float32, device=a_words.device)
    step = max(1, min(w, _BITMM_CHUNK_ELEMENTS // max(1, 32 * m)))
    for j0 in range(0, w, step):
        j1 = min(w, j0 + step)
        k0, k1 = 32 * j0, min(k, 32 * j1)
        dense = packed.unpack(a_words[:, j0:j1], k1 - k0).to(torch.float32)
        y += dense @ xf[k0:k1]
    return y > 0 if threshold else y


def intersect_ref(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-way AND + popcount.

    rows: int32 lanes (F, K, W) -> (and_rows int32 (F, W), counts int32 (F,)).
    """
    acc = rows[:, 0]
    for i in range(1, rows.shape[1]):
        acc = acc & rows[:, i]
    acc = acc.contiguous()
    return acc, packed.popcount(acc).sum(dim=-1, dtype=torch.int32)


def gather_intersect_ref(matrix: torch.Tensor, idx: torch.Tensor, *,
                         w32: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather + K-way AND + popcount over a resident matrix.

    matrix: int32 lanes (R, W); idx: int32 (F, K) row indices ->
    (and_rows int32 (F, w32), counts int32 (F,)).  Row f is the AND of
    ``matrix[idx[f, k], :w32]`` over k; counts are taken over those
    ``w32`` lanes.  For resident matrices, whose rows are zero past their
    width, that equals the count over all ``W`` lanes.
    """
    rows = matrix[:, :w32][idx.long()]                 # (F, K, w32)
    return intersect_ref(rows)


def expand_pairs_ref(and_rows: torch.Tensor, *, n_i: int, size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Set bits of ``and_rows`` (int32 lanes (F, w32)) at columns below
    ``n_i`` -> the first ``size`` ``(row, column)`` pairs in row-major
    (= lexicographic) order, as int32 vectors of length ``size``,
    zero-filled past the last pair.  The rows are unpacked one chunk at a
    time, and no chunk is unpacked once ``size`` pairs are found."""
    rid = torch.zeros(size, dtype=torch.int32, device=and_rows.device)
    cid = torch.zeros(size, dtype=torch.int32, device=and_rows.device)
    step = max(1, _EXPAND_CHUNK_BITS // max(1, n_i))
    got = 0
    for r0 in range(0, and_rows.shape[0], step):
        if got >= size:
            break
        bits = packed.unpack(and_rows[r0:r0 + step], n_i)   # (chunk, n_i)
        flat = torch.nonzero(bits.reshape(-1)).reshape(-1)[:size - got]
        k = len(flat)
        rid[got:got + k] = (flat // n_i + r0).to(torch.int32)
        cid[got:got + k] = (flat % n_i).to(torch.int32)
        got += k
    return rid, cid
