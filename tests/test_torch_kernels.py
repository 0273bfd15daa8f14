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
from repro.kernels.bitmm import bitmm_pallas  # noqa: E402
from repro.kernels.gather_intersect import (expand_pairs as j_expand,  # noqa: E402
                                            gather_intersect_pallas,
                                            gather_intersect_xla)
from repro.kernels.intersect import intersect_pallas  # noqa: E402
from repro_torch.kernels import ops, packed  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.kernels.bitmm import bitmm  # noqa: E402
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


def test_expand_pairs_chunked_plain_version_matches_jax(monkeypatch):
    """The plain version unpacks a few rows at a time and stops once it
    has ``size`` pairs; any chunking gives the JAX answer."""
    n_i = 70
    host_rows = np.random.default_rng(11).integers(
        0, 1 << 63, size=(9, host_bits.n_words(n_i)), dtype=np.uint64)
    rows32 = np.ascontiguousarray(host_rows).view(np.uint32)
    total = int(host_bits.unpack(host_rows, n_i).sum())
    for chunk_bits in (1, n_i, 3 * n_i + 5):
        monkeypatch.setattr(pref, "_EXPAND_CHUNK_BITS", chunk_bits)
        for size in (total, total + 5, max(1, total // 2), 1):
            rid, cid = pref.expand_pairs_ref(lanes(rows32), n_i=n_i,
                                             size=size)
            jr, jc = j_expand(jnp.asarray(rows32), n_i=n_i, size=size)
            assert np.array_equal(rid.numpy(), np.asarray(jr))
            assert np.array_equal(cid.numpy(), np.asarray(jc))


# ------------------------------------------------------------------- bitmm
def _bitmm_case(seed, m, k, b, density=0.3):
    rng = np.random.default_rng(seed)
    dense = rng.random((m, k)) < density
    return (np.array(jpacked.pack(jnp.asarray(dense))),
            rng.random((k, b)) < 0.3)


@pytest.mark.parametrize("m,k,b", [(128, 256, 8), (256, 1024, 16),
                                   (512, 2048, 4), (128, 128, 128)])
@pytest.mark.parametrize("threshold", [True, False])
def test_bitmm_matches_jax(m, k, b, threshold):
    a, x = _bitmm_case(m + k + b, m, k, b)
    want = np.asarray(jref.bitmm_ref(jnp.asarray(a), jnp.asarray(
        x, jnp.float32), threshold=threshold))
    pal = np.asarray(bitmm_pallas(jnp.asarray(a), jnp.asarray(x, jnp.float32),
                                  threshold=threshold, bm=128, bk=128,
                                  interpret=True))
    got = bitmm(lanes(a), torch.from_numpy(x), threshold=threshold)
    assert got.dtype == (torch.bool if threshold else torch.float32)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), (pal > 0) if threshold else pal)


def test_bitmm_chunked_plain_version_and_operand_forms(monkeypatch):
    """The plain version unpacks A one K-chunk at a time; any chunking,
    a float or transposed 0/1 operand and ``ops.bitmm`` give one answer."""
    a, x = _bitmm_case(3, 200, 2048, 8)
    want = np.asarray(jref.bitmm_ref(jnp.asarray(a), jnp.asarray(
        x, jnp.float32), threshold=False))
    xt = torch.from_numpy(x)
    monkeypatch.setattr(pref, "_BITMM_CHUNK_ELEMENTS", 200 * 32 * 3)
    for operand in (xt, xt.float(), xt.t().contiguous().t()):
        got = ops.bitmm(lanes(a), operand, threshold=False)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [33, 1000, 32 * 37])
def test_bitmm_ragged_k_ignores_bits_past_k(k):
    """K not a multiple of 32: A's bits at column K and above never count,
    which is the JAX product with X zero-padded to 32 W rows."""
    a, x = _bitmm_case(k, 77, 32 * ((k + 31) // 32), 5, density=0.5)
    x[k:] = False
    for threshold in (True, False):
        want = np.asarray(jref.bitmm_ref(jnp.asarray(a), jnp.asarray(
            x, jnp.float32), threshold=threshold))
        got = bitmm(lanes(a), torch.from_numpy(x[:k]), threshold=threshold)
        assert np.array_equal(got.numpy(), want)


def test_bitmm_empty_full_and_rejects_non_binary():
    m, k, b = 128, 256, 8
    zero = torch.zeros((m, k // 32), dtype=torch.int32)
    ones = torch.full((m, k // 32), -1, dtype=torch.int32)
    x = torch.ones((k, b))
    assert not bitmm(zero, x).any()
    assert torch.equal(bitmm(ones, x, threshold=False),
                       torch.full((m, b), float(k)))
    for fn in (bitmm, pref.bitmm_ref):
        with pytest.raises(ValueError, match="0/1"):
            fn(ones, torch.full((k, b), 0.5))
    with pytest.raises(ValueError):
        bitmm(ones, torch.ones((k + 32, b)))


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
