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
    zero-filled past the last pair."""
    bits = packed.unpack(and_rows, n_i)                  # (F, n_i)
    flat = torch.nonzero(bits.reshape(-1)).reshape(-1)[:size]
    rid = torch.zeros(size, dtype=torch.int32, device=and_rows.device)
    cid = torch.zeros(size, dtype=torch.int32, device=and_rows.device)
    rid[:len(flat)] = (flat // n_i).to(torch.int32)
    cid[:len(flat)] = (flat % n_i).to(torch.int32)
    return rid, cid
