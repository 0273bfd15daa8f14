"""The port's kernels (``repro_torch.kernels``) against the JAX package's.

Every input is made from a seed with numpy and handed to both packages.
On the CPU the port's wrappers run their plain PyTorch versions, which
must equal the JAX oracles and the Pallas kernels (in interpret mode)
exactly: every quantity is a packed bit or an integer count.  The CUDA
kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bitset as host_bits  # noqa: E402
from repro.kernels import packed as jpacked  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gather_intersect import (expand_pairs as j_expand,  # noqa: E402
                                            gather_intersect_pallas,
                                            gather_intersect_xla)
from repro.kernels.intersect import intersect_pallas  # noqa: E402
from repro_torch.kernels import packed  # noqa: E402
from repro_torch.kernels.gather_intersect import (expand_pairs,  # noqa: E402
                                                  gather_intersect)
from repro_torch.kernels.intersect import intersect  # noqa: E402


def lanes(a: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 lanes (a view, never a cast)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def words(t) -> np.ndarray:
    """Port lanes or a JAX uint32 array -> uint32 numpy words."""
    if isinstance(t, torch.Tensor):
        return np.ascontiguousarray(t.cpu().numpy()).view(np.uint32)
    return np.asarray(t).astype(np.uint32)


def rand_words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


# ------------------------------------------------------------------ packed
@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 1024])
def test_pack_unpack_match_jax(n):
    mask = np.random.default_rng(n).random((3, n)) < 0.3
    got = packed.pack(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    assert np.array_equal(words(got), words(jpacked.pack(jnp.asarray(mask))))
    assert np.array_equal(packed.unpack(got, n).numpy(), mask)


def test_popcount_matches_jax():
    w = rand_words(np.random.default_rng(1), 4, 37)
    w[0, :4] = [0, 1, 3, 0xFFFFFFFF]
    got = packed.popcount(lanes(w))
    assert np.array_equal(got.numpy(),
                          np.asarray(jpacked.popcount(jnp.asarray(w))))


def test_u64_u32_bridge_matches_jax():
    mask = np.random.default_rng(0).random(300) < 0.4
    w64 = host_bits.pack(mask)
    got = packed.pack_numpy_u64_to_u32(w64)
    assert np.array_equal(words(got), jpacked.pack_numpy_u64_to_u32(w64))
    assert np.array_equal(packed.unpack(got, 300).numpy(), mask)


# --------------------------------------------------------------- intersect
@pytest.mark.parametrize("f,k,w", [(128, 2, 16), (256, 4, 64), (128, 1, 128),
                                   (128, 64, 16)])
def test_intersect_matches_jax(f, k, w):
    rows = rand_words(np.random.default_rng(f + k + w), f, k, w)
    want_rows, want_counts = jref.intersect_ref(jnp.asarray(rows))
    pal_rows, pal_counts = intersect_pallas(jnp.asarray(rows), bf=128, bw=16,
                                            interpret=True)
    got_rows, got_counts = intersect(lanes(rows))
    for r, c in ((want_rows, want_counts), (pal_rows, pal_counts)):
        assert np.array_equal(words(got_rows), words(r))
        assert np.array_equal(got_counts.numpy(), np.asarray(c))


def test_intersect_disjoint_rows_count_zero():
    a = np.zeros((128, 2, 16), dtype=np.uint32)
    a[:, 0] = 0xAAAAAAAA
    a[:, 1] = 0x55555555
    got_rows, got_counts = intersect(lanes(a))
    assert not got_rows.any() and not got_counts.any()


# -------------------------------------------------------- gather_intersect
@pytest.mark.parametrize("f,k,w", [(1, 1, 128), (5, 2, 128), (16, 3, 256),
                                   (33, 4, 128), (3, 40, 128)])
def test_gather_intersect_matches_jax(f, k, w):
    rng = np.random.default_rng(f * 100 + k)
    matrix = rand_words(rng, 40, w)
    matrix[-1] = 0                                     # the zero row
    idx = rng.integers(0, 40, size=(f, k)).astype(np.int32)
    got_rows, got_counts = gather_intersect(lanes(matrix),
                                            torch.from_numpy(idx), w32=w)
    for fn in (gather_intersect_xla,
               lambda m, i, w32: gather_intersect_pallas(m, i, w32=w32,
                                                         interpret=True)):
        rows, counts = fn(jnp.asarray(matrix), jnp.asarray(idx), w32=w)
        assert np.array_equal(words(got_rows), words(rows)[:f])
        assert np.array_equal(got_counts.numpy(), np.asarray(counts)[:f])


def test_gather_intersect_zero_row_padding_is_inert():
    matrix = np.full((8, 128), 0xFFFFFFFF, dtype=np.uint32)
    matrix[-1] = 0
    idx = torch.full((3, 2), 7, dtype=torch.int32)     # all -> zero row
    rows, counts = gather_intersect(lanes(matrix), idx, w32=128)
    assert not rows.any() and not counts.any()


def test_gather_intersect_counts_live_lanes_of_resident_rows():
    """Resident rows are zero past their width: counting the ``w32``
    live lanes equals the JAX kernel's count over all ``W`` lanes."""
    rng = np.random.default_rng(5)
    matrix = np.zeros((20, 128), dtype=np.uint32)
    matrix[:19, :6] = rand_words(rng, 19, 6)
    idx = rng.integers(0, 20, size=(9, 3)).astype(np.int32)
    got_rows, got_counts = gather_intersect(lanes(matrix),
                                            torch.from_numpy(idx), w32=6)
    rows, counts = gather_intersect_xla(jnp.asarray(matrix),
                                        jnp.asarray(idx), w32=6)
    assert np.array_equal(words(got_rows), words(rows))
    assert np.array_equal(got_counts.numpy(), np.asarray(counts))


# ------------------------------------------------------------ expand_pairs
@pytest.mark.parametrize("n_i", [70, 64, 1])
def test_expand_pairs_matches_jax(n_i):
    """Ragged ``n_i`` with non-zero tail bits: bits at >= n_i never count;
    the page is cut at ``size`` and zero-filled past the last pair."""
    rng = np.random.default_rng(9 + n_i)
    w64 = host_bits.n_words(n_i)
    host_rows = rng.integers(0, 1 << 63, size=(6, w64), dtype=np.uint64)
    rows32 = np.ascontiguousarray(host_rows).view(np.uint32)
    want_r, _ = np.nonzero(host_bits.unpack(host_rows, n_i))
    total = len(want_r)
    for size in (total, total + 5, max(1, total // 2), 1024):
        rid, cid = expand_pairs(lanes(rows32), n_i=n_i, size=size)
        jr, jc = j_expand(jnp.asarray(rows32), n_i=n_i, size=size)
        assert rid.dtype == cid.dtype == torch.int32
        assert np.array_equal(rid.numpy(), np.asarray(jr))
        assert np.array_equal(cid.numpy(), np.asarray(jc))


# ------------------------------------------------------------ wrapper checks
def test_wrappers_reject_bad_arguments():
    m = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_intersect(m.to(torch.int64), torch.zeros((1, 1),
                                                        dtype=torch.int32),
                         w32=2)
    with pytest.raises(ValueError):
        gather_intersect(m, torch.zeros((1, 1), dtype=torch.int32), w32=3)
    with pytest.raises(ValueError):
        gather_intersect(m, torch.zeros((1, 0), dtype=torch.int32), w32=2)
    with pytest.raises(ValueError):
        intersect(torch.zeros((4, 2, 8), dtype=torch.int32)[:, :, ::2])
    with pytest.raises(ValueError):
        expand_pairs(m, n_i=32 * 128 + 1, size=4)
