"""Plain PyTorch versions of the port's CUDA kernels.

They are the semantic ground truth: the CPU tests hold them to the JAX
package's oracles, the kernel wrappers take them for tensors on the CPU,
and ``chip_smoke.py`` holds each CUDA kernel to its plain version on the
card.  All lanes are int32 tensors holding the packed uint32 bits (see
:mod:`repro_torch.kernels.packed`); every result is an exact integer.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
# rows per block of closure_step_ref: a block's bf16 product at the
# epinions graph (2,048 x 76,288) is 312 MB, its packing 1.25 GB
_CLOSURE_ROW_BLOCK = 2048


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


def closure_step_ref(r_words: torch.Tensor) -> torch.Tensor:
    """One squaring step of the transitive closure on packed rows:
    ``R' = R | (R·R > 0)``, int32 lanes (N, N/32) -> the same shape.

    R is unpacked once as the right operand (N x N, bfloat16 on the card,
    where the epinions graph's is 11.6 GB, float32 on the CPU at test
    sizes); the left operand is that matrix a block of rows at a time, so
    the card never holds a float32 N x N matrix or an N x N product.
    Each block's product is thresholded, ORed with its own rows and
    packed.  ``> 0`` is exact whatever the precision of the accumulation:
    every term is 0 or 1 and non-negative, so a sum is 0 only when every
    term is, and a positive sum cannot round to 0.
    """
    n = r_words.shape[0]
    dtype = torch.bfloat16 if r_words.is_cuda else torch.float32
    dense = torch.empty((n, n), dtype=dtype, device=r_words.device)
    out = torch.empty_like(r_words)
    blocks = [(r0, min(n, r0 + _CLOSURE_ROW_BLOCK))
              for r0 in range(0, n, _CLOSURE_ROW_BLOCK)]
    for r0, r1 in blocks:
        dense[r0:r1] = packed.unpack(r_words[r0:r1], n)
    for r0, r1 in blocks:
        rows = dense[r0:r1]
        out[r0:r1] = packed.pack(((rows @ dense) > 0) | (rows > 0))
    return out


def closure_row_lists_ref(r_words: torch.Tensor,
                          cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row lists of ``closure_step``'s first pass: int32 lanes
    (N, N/32) -> (cnt (N,) int32, each row's set bits; lists (N, cap)
    int32, the set columns of each row with ``cnt <= cap`` in ascending
    order, -1 past its count and in every row with more)."""
    n = r_words.shape[0]
    cnt = torch.empty(n, dtype=torch.int32, device=r_words.device)
    lists = torch.full((n, cap), -1, dtype=torch.int32,
                       device=r_words.device)
    cols = torch.arange(n, dtype=torch.int32, device=r_words.device)
    for r0 in range(0, n, _CLOSURE_ROW_BLOCK):
        rows = packed.unpack(r_words[r0:r0 + _CLOSURE_ROW_BLOCK], n)
        c = rows.sum(dim=1)
        cnt[r0:r0 + rows.shape[0]] = c.to(torch.int32)
        key = torch.where(rows, cols, n)          # n sorts past every column
        first = key.topk(min(cap, n), dim=1, largest=False).values
        first = torch.where((first < n) & (c <= cap)[:, None], first, -1)
        lists[r0:r0 + rows.shape[0], :first.shape[1]] = first
    return cnt, lists


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


def gather_level_ref(mats: torch.Tensor, fb_row: torch.Tensor,
                     idx: torch.Tensor, n_alive: torch.Tensor, *,
                     n_i: int) -> torch.Tensor:
    """The whole-graph enumerator's level rows: int32 lanes (F, W), row f
    ``fb_row & AND_k mats[idx[f, k]]`` for ``f < n_alive``, zero past it
    and at columns ``>= n_i`` (see :func:`gather_expand_ref`)."""
    f, k = idx.shape
    w = mats.shape[1]
    cand = fb_row.expand(f, w).clone()
    for j in range(k):
        cand &= mats[idx[:, j].long()]
    alive = torch.arange(f, device=mats.device) < n_alive
    cand = torch.where(alive[:, None], cand, 0)
    live = min(w, (n_i + 31) // 32)
    cand[:, live:] = 0
    if n_i < 32 * live:                 # bits at n_i and above never count
        cand[:, live - 1] &= (1 << (n_i - 32 * (live - 1))) - 1
    return cand


def gather_expand_ref(mats: torch.Tensor, fb_row: torch.Tensor,
                      idx: torch.Tensor, n_alive: torch.Tensor, *, n_i: int,
                      size: int, expand: bool = True, scan: bool = False
                      ) -> Tuple[Optional[torch.Tensor], ...]:
    """One level of the whole-graph enumerator: the candidate row
    ``fb_row`` (int32 lanes (W,)) ANDed, for each frontier row f below
    ``n_alive`` (an int64 0-d tensor), with the rows ``mats[idx[f, k]]``
    (mats int32 lanes (R, W), idx int32 (F, Kc), Kc >= 0) -> (total: the
    int64 0-d count of those rows' set bits below column ``n_i``; with
    ``expand``, their first ``size`` ``(row, column)`` pairs as
    :func:`expand_pairs_ref` gives them, else None and None; with
    ``scan``, fourth, the int64 (F,) inclusive scan of the rows'
    counts)."""
    cand = gather_level_ref(mats, fb_row, idx, n_alive, n_i=n_i)
    per_row = packed.popcount(cand).sum(dim=1, dtype=torch.int64)
    total = per_row.sum()
    rows_incl = (torch.cumsum(per_row, dim=0),) if scan else ()
    if not expand:
        return (total, None, None, *rows_incl)
    rid, cid = expand_pairs_ref(cand, n_i=n_i, size=size)
    return (total, rid, cid, *rows_incl)
