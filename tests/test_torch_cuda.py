"""The port on the card: CUDA kernels and executors against the plain
versions and the host path.

Every test here is marked ``cuda`` and skips without a CUDA device.  On
the card's machine (which has no JAX) run them with

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import GM, GMOptions  # noqa: E402
from repro_torch.data.graphs import random_labeled_graph  # noqa: E402
from repro_torch.data.queries import random_query_from_graph  # noqa: E402
from repro_torch.kernels import launch_counts, ref, reset_launch_counts  # noqa: E402
from repro_torch.kernels.bitmm import bitmm  # noqa: E402
from repro_torch.kernels.gather_intersect import (expand_pairs,  # noqa: E402
                                                  gather_intersect)
from repro_torch.kernels.intersect import intersect  # noqa: E402
from repro_torch.obs.ledger import LEDGER  # noqa: E402
from repro_torch.torchgm import TorchGM, frontier  # noqa: E402

RESIDENT = "frontier-device-resident"


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", None)
    return torch.device("cuda")


def _lanes(rng, *shape):
    return torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, size=shape, dtype=np.int64).astype(np.int32))


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("f,k,w32", [(1, 1, 2), (130, 3, 66),
                                     (1000, 4, 256), (130, 40, 66),
                                     (9, 70, 256)])
def test_gather_intersect_kernel_equals_plain(cuda, f, k, w32):
    rng = np.random.default_rng(f + k)
    m = _lanes(rng, 300, 256).to(cuda)
    m[-1] = 0
    idx = torch.from_numpy(rng.integers(0, 300, size=(f, k)).astype(
        np.int32)).to(cuda)
    assert _equal(gather_intersect(m, idx, w32=w32),
                  ref.gather_intersect_ref(m, idx, w32=w32))


@pytest.mark.cuda
@pytest.mark.parametrize("f,k,w", [(3, 1, 4), (257, 4, 128), (128, 8, 132),
                                   (129, 64, 132)])
def test_intersect_kernel_equals_plain(cuda, f, k, w):
    rows = _lanes(np.random.default_rng(f), f, k, w).to(cuda)
    assert _equal(intersect(rows), ref.intersect_ref(rows))


@pytest.mark.cuda
@pytest.mark.parametrize("f,w,n_i,size", [(6, 4, 70, 37), (6, 4, 70, 1024),
                                          (500, 8, 250, 65536),
                                          (1, 2, 33, 5)])
def test_expand_pairs_kernel_equals_plain(cuda, f, w, n_i, size):
    rows = _lanes(np.random.default_rng(n_i), f, w).to(cuda)
    assert _equal(expand_pairs(rows, n_i=n_i, size=size),
                  ref.expand_pairs_ref(rows, n_i=n_i, size=size))


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", ["C", "H", "D"])
def test_match_on_card_equals_host(cuda, qtype):
    g = random_labeled_graph(300, avg_degree=3.0, n_labels=3, seed=4)
    q = random_query_from_graph(g, n_nodes=4, qtype=qtype, seed=5)
    want = GM(g).match(q, GMOptions(enum_method="frontier", limit=None))
    reset_launch_counts()
    for method in ("frontier-device", RESIDENT):
        got = GM(g).match(q, GMOptions(enum_method=method, limit=None))
        assert got.enum_method == method and got.degradations == []
        assert got.count == want.count
        assert got.tuples.tobytes() == want.tuples.tobytes()
    counts = launch_counts()
    if want.count:
        assert counts.get("gather_intersect", 0) > 0
        assert counts.get("intersect", 0) > 0


@pytest.mark.cuda
def test_resident_executor_charges_full_pair_pages(cuda):
    LEDGER.reset()
    g = random_labeled_graph(200, avg_degree=3.0, n_labels=2, seed=3)
    q = random_query_from_graph(g, n_nodes=3, qtype="D", seed=4)
    got = GM(g).match(q, GMOptions(enum_method=RESIDENT, limit=None))
    res = got.rig.resident
    assert res.device.type == "cuda"
    pages = LEDGER.transfers.d2h_bytes(site="pair_extract_d2h")
    assert pages > 0 and pages % (2 * 4 * res.PAGE_BUCKET) == 0
    assert got.rig.release_resident() == res.nbytes
    assert LEDGER.resident.live_bytes() == 0
    LEDGER.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,b,density", [
    (128, 256, 8, 0.3), (300, 1184, 8, 0.1), (257, 100, 1, 0.5),
    (1000, 2048, 128, 0.05), (77, 4096, 13, 0.01), (2051, 32 * 37, 64, 0.2),
    (64, 33, 3, 0.5), (129, 70000, 9, 0.001)])
@pytest.mark.parametrize("threshold", [True, False])
def test_bitmm_kernel_equals_plain(cuda, m, k, b, density, threshold):
    rng = np.random.default_rng(m + k + b)
    w = (k + 31) // 32
    a = _lanes(rng, m, w).to(cuda)
    keep = torch.from_numpy(rng.random((m, w)) < density * 4).to(cuda)
    a = torch.where(keep, a, 0)
    x = torch.from_numpy(rng.random((k, b)) < 0.3).to(cuda)
    reset_launch_counts()
    got = bitmm(a, x, threshold=threshold)
    assert launch_counts().get("bitmm") == 1
    want = ref.bitmm_ref(a, x, threshold=threshold)
    assert got.dtype == want.dtype and torch.equal(got, want)
    # a float 0/1 operand and a transposed view give the same product
    xt = x.t().contiguous().t()
    assert torch.equal(bitmm(a, xt.float(), threshold=threshold), want)


@pytest.mark.cuda
def test_bitmm_kernel_empty_and_full(cuda):
    m, k, b = 200, 32 * 41, 8
    x = torch.ones((k, b), dtype=torch.bool, device=cuda)
    zero = torch.zeros((m, k // 32), dtype=torch.int32, device=cuda)
    ones = torch.full((m, k // 32), -1, dtype=torch.int32, device=cuda)
    assert not bitmm(zero, x).any()
    assert torch.equal(bitmm(ones, x, threshold=False),
                       torch.full((m, b), float(k), device=cuda))
    with pytest.raises(ValueError):
        bitmm(ones, torch.full((k, b), 2.0, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("qtype,seed", [("C", 1), ("H", 2), ("D", 3)])
def test_torchgm_on_card_equals_host(cuda, qtype, seed):
    g = random_labeled_graph(400, avg_degree=3.0, n_labels=4, seed=seed)
    q = random_query_from_graph(g, 4, qtype=qtype, seed=seed)
    want = GM(g).match(q, GMOptions(enum_method="frontier", limit=None,
                                    materialize=False))
    gm = TorchGM(g, block=128, capacity=1 << 16, exact_sim=True)
    assert gm.device.type == "cuda"
    reset_launch_counts()
    got = gm.match(q)
    assert launch_counts().get("bitmm", 0) >= 4
    assert not got.overflowed and got.count == want.count
    [batched] = gm.match_batch([q])
    assert batched.count == want.count
