"""Packed-bitset algebra used by the host-faithful path.

The paper implements its candidate sets and adjacency lists as roaring
bitmaps (§5.5 "Implementation").  Roaring's value proposition is CPU-cache
friendly *compressed* set algebra; for the host-faithful reproduction we use
flat packed ``uint64`` words (numpy), which provide the same AND/OR/ANDNOT
semantics with vectorized word-wise ops.  The device path (``repro_torch.kernels``)
re-implements the same algebra on uint32 lanes in CUDA kernels.

Conventions
-----------
* A *bitset over a universe of size n* is a ``uint64[ceil(n/64)]`` array,
  little-endian bit order (bit ``i`` lives in word ``i >> 6`` at position
  ``i & 63``).
* A *bit matrix* is ``uint64[n, W]`` — one packed row per universe element
  (e.g. packed adjacency rows, packed reachability rows).
"""

from __future__ import annotations

import numpy as np

WORD = 64


def n_words(n: int) -> int:
    """Number of 64-bit words needed for a universe of size ``n``."""
    return (n + WORD - 1) // WORD


def pack(mask: np.ndarray) -> np.ndarray:
    """Pack a boolean array (..., n) into uint64 words (..., ceil(n/64)).

    Little-endian within each byte and across bytes, so that
    ``bit i -> word[i // 64] >> (i % 64) & 1``.
    """
    mask = np.asarray(mask, dtype=bool)
    n = mask.shape[-1]
    pad_bits = (-n) % (8 * 8)  # pad to whole uint64 words
    if pad_bits:
        pad_shape = mask.shape[:-1] + (pad_bits,)
        mask = np.concatenate([mask, np.zeros(pad_shape, dtype=bool)], axis=-1)
    bytes_ = np.ascontiguousarray(np.packbits(mask, axis=-1,
                                              bitorder="little"))
    return bytes_.view(np.uint64)


def unpack(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack`: uint64 words (..., W) -> bool (..., n)."""
    bytes_ = np.ascontiguousarray(words).view(np.uint8)
    bits = np.unpackbits(bytes_, axis=-1, bitorder="little")
    return bits[..., :n].astype(bool)


def empty(n: int) -> np.ndarray:
    return np.zeros(n_words(n), dtype=np.uint64)


def full(n: int) -> np.ndarray:
    out = np.full(n_words(n), np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    tail = n % WORD
    if tail:
        out[-1] = np.uint64((1 << tail) - 1)
    return out


def from_indices(idx: np.ndarray, n: int) -> np.ndarray:
    """Bitset with exactly the bits in ``idx`` set."""
    mask = np.zeros(n, dtype=bool)
    mask[np.asarray(idx, dtype=np.int64)] = True
    return pack(mask)


def to_indices(words: np.ndarray, n: int) -> np.ndarray:
    """Sorted array of set-bit positions."""
    return np.nonzero(unpack(words, n))[0]


def count(words: np.ndarray) -> int:
    """Popcount over all words (supports matrices; sums everything)."""
    return int(np.bitwise_count(words).sum())


def count_rows(words: np.ndarray) -> np.ndarray:
    """Per-row popcount for a bit matrix (n, W) -> int64 (n,)."""
    return np.bitwise_count(words).sum(axis=-1).astype(np.int64)


def any_set(words: np.ndarray) -> bool:
    return bool(words.any())


def get(words: np.ndarray, i: int) -> bool:
    return bool((words[i >> 6] >> np.uint64(i & 63)) & np.uint64(1))


def set_bit(words: np.ndarray, i: int) -> None:
    words[i >> 6] |= np.uint64(1) << np.uint64(i & 63)


def clear_bit(words: np.ndarray, i: int) -> None:
    words[i >> 6] &= ~(np.uint64(1) << np.uint64(i & 63))


def intersect_any(a: np.ndarray, b: np.ndarray) -> bool:
    """True iff a ∩ b ≠ ∅  (no materialization)."""
    return bool(np.bitwise_and(a, b).any())


def intersect_many(rows: np.ndarray) -> np.ndarray:
    """AND-reduce k packed rows (k, W) -> (W,).

    This is the host analogue of the ``intersect`` CUDA kernel: the
    multiway-join candidate computation of MJoin (Alg. 5 lines 5-7).
    """
    if rows.shape[0] == 0:
        raise ValueError("intersect_many needs at least one row")
    return np.bitwise_and.reduce(rows, axis=0)


def union_rows(matrix: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """OR-reduce selected rows of a bit matrix: ∪_{v in idx} matrix[v].

    The paper's ``bitBat`` batch operation (§5.5) unions the adjacency
    bitmaps of all surviving candidates in one pass.
    """
    if len(idx) == 0:
        return np.zeros(matrix.shape[1], dtype=np.uint64)
    return np.bitwise_or.reduce(matrix[np.asarray(idx, dtype=np.int64)], axis=0)


def gather_columns(matrix: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                   n: int, chunk_bytes: int = 1 << 25) -> np.ndarray:
    """Gather + column-compact a packed bit matrix in one chunked pass:
    ``(n, n_words(n))[rows] -> (len(rows), n_words(len(cols)))``.

    Output row r has bit j set iff ``matrix[rows[r]]`` has bit ``cols[j]``
    set — i.e. the selected rows re-expressed over the compact universe
    ``cols`` (the candidate-local id spaces of the RIG).  Both the row
    gather and the dense unpack happen per chunk so the transient slab
    stays bounded (~``chunk_bytes``).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    r = len(rows)
    if len(cols) == 0 or r == 0:
        return np.zeros((r, n_words(len(cols))), dtype=np.uint64)
    out = np.empty((r, n_words(len(cols))), dtype=np.uint64)
    step = max(1, chunk_bytes // max(n, 1))
    for lo in range(0, r, step):
        hi = min(lo + step, r)
        out[lo:hi] = pack(unpack(matrix[rows[lo:hi]], n)[:, cols])
    return out


def transpose(matrix: np.ndarray, n_cols: int,
              chunk_bytes: int = 1 << 25) -> np.ndarray:
    """Packed transpose: (R, n_words(n_cols)) -> (n_cols, n_words(R)).

    Bit (i, j) of the result equals bit (j, i) of the input.  Processed in
    64-bit-aligned column blocks so the dense transient stays bounded.
    """
    r = matrix.shape[0]
    out = np.empty((n_cols, n_words(r)), dtype=np.uint64)
    if n_cols == 0:
        return out
    if r == 0:
        out[:] = 0
        return out
    step_w = max(1, chunk_bytes // max(r * WORD, 1))       # words per block
    for lo_w in range(0, matrix.shape[1], step_w):
        hi_w = min(lo_w + step_w, matrix.shape[1])
        dense = unpack(matrix[:, lo_w:hi_w], (hi_w - lo_w) * WORD)
        lo, hi = lo_w * WORD, min(hi_w * WORD, n_cols)
        out[lo:hi] = pack(np.ascontiguousarray(dense.T[: hi - lo]))
    return out


def matvec_any(matrix: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """Boolean mat-vec: out[i] = (matrix[i] ∩ vec) ≠ ∅, for all rows at once.

    out is a *bool* array (n,).  This is the whole-pass batched form of the
    paper's existence check: for every node v, "does v have a neighbour
    inside ``vec``?".
    """
    return np.bitwise_and(matrix, vec[None, :]).any(axis=1)
