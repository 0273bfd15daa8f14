"""The paging enumerator on the card: ``gather_expand``'s row scan against
its plain version, and ``TorchGM(page_on_device=True)`` against the host
``GM``.

Every test here is marked ``cuda`` and skips without a CUDA device.  On
the card's machine (which has no JAX) run them with

    python -m pytest -m cuda tests/test_torch_cuda_paging.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import GM, GMOptions  # noqa: E402
from repro_torch.data.graphs import random_labeled_graph  # noqa: E402
from repro_torch.data.queries import random_query_from_graph  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.gather_intersect import gather_expand  # noqa: E402
from repro_torch.torchgm import TorchGM, frontier  # noqa: E402


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_cuda_paging.py`")
    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", None)
    return torch.device("cuda")


# (F, Kc, lanes, n_alive, expand): rows off a segment's 256 lanes, a level
# without constraints, rows past n_alive, a count-only scan
@pytest.mark.cuda
@pytest.mark.parametrize("f,k,w,n_alive,expand", [
    (1, 0, 8, 1, True), (70, 2, 300, 70, True), (513, 3, 2384, 400, True),
    (64, 1, 1000, 64, False), (5, 4, 36, 0, True)])
def test_gather_expand_scan_equals_plain(cuda, f, k, w, n_alive, expand):
    rng = np.random.default_rng(f * 7 + k + w)
    r = 200
    lanes = lambda *s: torch.from_numpy(rng.integers(   # noqa: E731
        -(1 << 31), 1 << 31, size=s, dtype=np.int64).astype(np.int32))
    mats = (lanes(r, w) | lanes(r, w)).to(cuda)
    fb = (lanes(w) | lanes(w)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, r, size=(f, k)).astype(
        np.int32)).to(cuda)
    alive = torch.tensor(n_alive, dtype=torch.int64, device=cuda)
    n_i, size = 32 * w - 3, 4096
    got = gather_expand(mats, fb, idx, alive, n_i=n_i, size=size,
                        expand=expand, scan=True)
    want = ref.gather_expand_ref(mats, fb, idx, alive, n_i=n_i, size=size,
                                 expand=expand, scan=True)
    assert len(got) == len(want) == 4
    assert int(got[0]) == int(want[0])
    assert torch.equal(got[3].cpu(), want[3].cpu())
    if expand:
        assert all(torch.equal(g, x) for g, x in zip(got[1:3], want[1:3]))


@pytest.mark.cuda
def test_paged_torchgm_equals_host(cuda):
    g = random_labeled_graph(1500, avg_degree=3.0, n_labels=4, seed=3)
    qs = [random_query_from_graph(g, 3 + i % 4, qtype="CHD"[i % 3],
                                  seed=i) for i in range(12)]
    limit = 200_000
    paged = TorchGM(g, capacity=1536, exact_sim=True, page_on_device=True,
                    limit=limit)
    assert paged.dg.n_pad == 1536
    for q in qs:
        want = GM(g, GMOptions(limit=limit)).match(q).count
        got = paged.match(q)
        assert got.count == want
        assert got.truncated == (want == limit) and not got.overflowed
