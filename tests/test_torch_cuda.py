"""The port on the card: CUDA kernels and executors against the plain
versions and the host path.

Every test here is marked ``cuda`` and skips without a CUDA device.  On
the card's machine (which has no JAX) run them with

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import graph_from_arrays, query_from_spec  # noqa: E402
from repro_torch.core import GM, GMOptions  # noqa: E402
from repro_torch.core import bitset  # noqa: E402
from repro_torch.core.reachability import ReachabilityIndex  # noqa: E402
from repro_torch.data.graphs import random_labeled_graph  # noqa: E402
from repro_torch.data.queries import random_query_from_graph  # noqa: E402
from repro_torch.kernels import launch_counts, ref, reset_launch_counts  # noqa: E402
from repro_torch.kernels import ops, packed  # noqa: E402
from repro_torch.kernels.bitmm import bitmm  # noqa: E402
from repro_torch.kernels.closure import (LIST_CAP, closure_step,  # noqa: E402
                                        row_lists, transpose)
from repro_torch.kernels import gather_intersect as gi  # noqa: E402
from repro_torch.kernels.gather_intersect import (expand_pairs,  # noqa: E402
                                                  gather_expand,
                                                  gather_intersect)
from repro_torch.kernels.intersect import intersect  # noqa: E402
from repro_torch.obs.ledger import LEDGER  # noqa: E402
from repro_torch.torchgm import TorchGM, device_graph, frontier  # noqa: E402

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


# (F, K, lanes) of the AND-row kernels: a row takes a group of threads,
# one for each of its 16-byte (8-byte where lanes % 4 == 2) chunks rounded
# up to a power of two, so a 256-thread block holds 256 rows of 2 lanes
# down to one row past 512 lanes, and a row past 1,024 lanes loops; a
# group wider than a warp sums its count in shared memory; K up to 4 is a
# template, past it groups of 4 rows.  Lane counts around 64 and 256 and
# w32 % 4 == 2; F = 1 and off the rows of a warp and of a block; K = 1 to
# 5 and past a warp.
AND_ROW_SHAPES = [(1, 1, 2), (130, 3, 66), (1000, 4, 256), (130, 40, 66),
                  (9, 70, 256)]
AND_ROW_SHAPES += [(130, 3, w) for w in (2, 62, 64, 254, 258, 832)]
AND_ROW_SHAPES += [(1, 1, 832), (1, 2, 62), (7, 1, 2), (33, 2, 64),
                   (257, 1, 130), (1023, 2, 258), (4097, 1, 6),
                   (300, 1, 4100)]
AND_ROW_SHAPES += [(100, k, 258) for k in (1, 2, 3, 4, 5)]
AND_ROW_SHAPES += [(100, k, 832) for k in (4, 5)]
AND_ROW_SHAPES += [(9, 33, 832), (20, 64, 66), (5, 70, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("f,k,w32", AND_ROW_SHAPES)
def test_gather_intersect_kernel_equals_plain(cuda, f, k, w32):
    rng = np.random.default_rng(f + k + w32)
    m = _lanes(rng, 300, 256 if w32 <= 256 else 4104).to(cuda)
    m[-1] = 0
    idx = torch.from_numpy(rng.integers(0, 300, size=(f, k)).astype(
        np.int32)).to(cuda)
    assert _equal(gather_intersect(m, idx, w32=w32),
                  ref.gather_intersect_ref(m, idx, w32=w32))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["repeated", "zero_row", "all_same",
                                     "all_zero"])
def test_gather_intersect_kernel_repeated_and_zero_rows(cuda, pattern):
    """Indices that gather one row several times for a frontier row, the
    all-zero row among live ones, one row for every frontier row, and the
    zero row alone (counts 0)."""
    rng = np.random.default_rng(11)
    m = _lanes(rng, 64, 896).to(cuda)
    m[-1] = 0
    f, k = 777, 3
    idx = rng.integers(0, 64, size=(f, k)).astype(np.int32)
    if pattern == "repeated":
        idx[:, 1:] = idx[:, :1]
    elif pattern == "zero_row":
        idx[::5, 2] = 63
    elif pattern == "all_same":
        idx[:] = 9
    else:
        idx[:] = 63
    idx = torch.from_numpy(idx).to(cuda)
    for w32 in (66, 832):
        got = gather_intersect(m, idx, w32=w32)
        assert _equal(got, ref.gather_intersect_ref(m, idx, w32=w32))
        if pattern == "all_zero":
            assert not got[1].any()


@pytest.mark.cuda
def test_gather_intersect_kernel_largest_gm_shape(cuda):
    """The GM.match path's largest launch: a 53,632 x 896-lane resident
    matrix, 1,024 frontier rows of one constraint gathering 145 distinct
    rows, 832 live lanes."""
    rng = np.random.default_rng(53_632)
    m = _lanes(rng, 53_632, 896).to(cuda)
    m[-1] = 0
    pool = rng.choice(53_632, size=145, replace=False)
    idx = torch.from_numpy(pool[rng.integers(0, 145, size=(1_024, 1))]
                           .astype(np.int32)).to(cuda)
    assert _equal(gather_intersect(m, idx, w32=832),
                  ref.gather_intersect_ref(m, idx, w32=832))


@pytest.mark.cuda
@pytest.mark.parametrize("f,k,w", [(3, 1, 4), (257, 4, 128), (128, 8, 132),
                                   (129, 64, 132), (1, 1, 896), (1, 3, 4),
                                   (7, 2, 64), (33, 1, 256), (257, 2, 260),
                                   (512, 1, 896), (1023, 3, 832),
                                   (2049, 1, 8), (100, 5, 4100),
                                   (9, 33, 256), (5, 70, 132)]
                         + [(100, k, 260) for k in (1, 2, 3, 4, 5)])
def test_intersect_kernel_equals_plain(cuda, f, k, w):
    rows = _lanes(np.random.default_rng(f + k + w), f, k, w).to(cuda)
    assert _equal(intersect(rows), ref.intersect_ref(rows))


@pytest.mark.cuda
@pytest.mark.parametrize("f,w,n_i,size", [(6, 4, 70, 37), (6, 4, 70, 1024),
                                          (500, 8, 250, 65536),
                                          (1, 2, 33, 5), (1024, 832, 26_575,
                                                          1_013_760)])
def test_expand_pairs_kernel_equals_plain(cuda, f, w, n_i, size):
    rows = _lanes(np.random.default_rng(n_i), f, w).to(cuda)
    assert _equal(expand_pairs(rows, n_i=n_i, size=size),
                  ref.expand_pairs_ref(rows, n_i=n_i, size=size))


# (rows, lanes, n_i, size, fill, offset): segments of 256 lanes; W % 4 != 0
# (4-byte loads), n_i off a multiple of 32, `size` cut inside a segment,
# `size` past the total (zero fill), a single wide row, all-ones rows, and
# an input one lane off a 16-byte boundary
EXPAND_SEGMENT_CASES = {
    "w_mod4": (300, 130, 32 * 130, 1 << 16, "random", 0),
    "n_i_ragged": (64, 600, 600 * 32 - 17, 1 << 18, "random", 0),
    "cut_in_segment": (40, 1024, 32 * 1024, 12_345, "random", 0),
    "zero_fill": (7, 520, 16_600, 1 << 17, "sparse", 0),
    "one_wide_row": (1, 2384, 76_288, 65_536, "random", 0),
    "all_ones": (33, 300, 9_580, 200_000, "ones", 0),
    "all_ones_cut": (33, 300, 9_580, 77_777, "ones", 0),
    "misaligned": (50, 260, 8_300, 1 << 16, "random", 1),
}


def _expand_rows(rng, f, w, fill, offset, device):
    if fill == "ones":
        rows = torch.full((f * w + offset,), -1, dtype=torch.int32)
    else:
        rows = _lanes(rng, f * w + offset)
        if fill == "sparse":
            rows = torch.where(torch.from_numpy(rng.random(f * w + offset)
                                                < 0.01), rows, 0)
    return rows.to(device)[offset:].view(f, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXPAND_SEGMENT_CASES))
def test_expand_pairs_kernel_segments(cuda, case):
    f, w, n_i, size, fill, offset = EXPAND_SEGMENT_CASES[case]
    rows = _expand_rows(np.random.default_rng(f + w), f, w, fill, offset,
                        cuda)
    assert _equal(expand_pairs(rows, n_i=n_i, size=size),
                  ref.expand_pairs_ref(rows, n_i=n_i, size=size))


# (rows F, Kc, n_alive, lanes W, n_i, size, expand, fill, offset): Kc 0,
# 1, 3 and past the 32 row pointers a warp resolves at once; n_alive 0,
# 1, partial, all and past F; W % 4 != 0; `size` cut inside a segment and
# past the total; all-ones rows; mats one lane off a 16-byte boundary
GATHER_EXPAND_CASES = {
    "kc0_first_level": (1024, 0, 1, 2384, 76_288, 65_536, True, "random", 0),
    "kc1_partial": (1024, 1, 700, 132, 4_200, 5_000, True, "random", 0),
    "kc3_all_alive": (512, 3, 512, 130, 4_160, 1 << 16, True, "random", 0),
    "kc40_pointer_chunks": (96, 40, 60, 64, 2_048, 4_096, True, "ones", 0),
    "none_alive": (256, 2, 0, 132, 4_224, 1_000, True, "random", 0),
    "alive_past_rows": (256, 2, 900, 132, 4_224, 1 << 15, True, "random", 0),
    "count_only": (2048, 2, 1500, 520, 16_640, 0, False, "random", 0),
    "ones_cut": (300, 2, 250, 36, 1_100, 100_003, True, "ones", 0),
    "ones_zero_fill": (300, 1, 20, 36, 1_100, 1 << 16, True, "ones", 0),
    "misaligned": (400, 2, 333, 260, 8_300, 1 << 14, True, "random", 1),
    "size_zero": (64, 1, 64, 132, 4_224, 0, True, "random", 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GATHER_EXPAND_CASES))
def test_gather_expand_kernel_equals_plain(cuda, case):
    f, k, n_alive, w, n_i, size, expand, fill, offset = \
        GATHER_EXPAND_CASES[case]
    rng = np.random.default_rng(f + k + w)
    r = 300
    if fill == "ones":
        mats = torch.full((r * w + offset,), -1, dtype=torch.int32)
        fb = torch.full((w,), -1, dtype=torch.int32)
    else:
        # rows of density ~ 0.8 per bit keep a few bits after three ANDs
        mats = _lanes(rng, r * w + offset) | _lanes(rng, r * w + offset)
        fb = _lanes(rng, w) | _lanes(rng, w)
    mats = mats.to(cuda)[offset:].view(r, w)
    fb = fb.to(cuda)
    idx = torch.from_numpy(rng.integers(0, r, size=(f, k)).astype(
        np.int32)).to(cuda)
    alive = torch.tensor(n_alive, dtype=torch.int64, device=cuda)
    reset_launch_counts()
    got = gather_expand(mats, fb, idx, alive, n_i=n_i, size=size,
                        expand=expand)
    assert launch_counts() == {"gather_expand": 1}
    want = ref.gather_expand_ref(mats, fb, idx, alive, n_i=n_i, size=size,
                                 expand=expand)
    assert got[0].dtype == torch.int64 and got[0].dim() == 0
    assert int(got[0]) == int(want[0])
    if expand:
        assert _equal(got[1:], want[1:])
    else:
        assert got[1:] == (None, None) == want[1:]


@pytest.mark.cuda
def test_torchgm_on_card_calls_no_plain_version(cuda, monkeypatch):
    """The whole-graph matcher's levels go through the kernels alone."""
    g = random_labeled_graph(400, avg_degree=3.0, n_labels=3, seed=6)
    qs = [random_query_from_graph(g, 4, qtype=t, seed=s)
          for t, s in (("C", 1), ("D", 2))]
    want = [GM(g).match(q, GMOptions(enum_method="frontier", limit=None,
                                     materialize=False)).count for q in qs]
    gm = TorchGM(g, block=128, capacity=1 << 16, exact_sim=True)

    def refuse(*_, **__):
        raise AssertionError("a plain version ran on the card")
    for module, name in ((gi, "gather_expand_ref"), (gi, "expand_pairs_ref"),
                         (gi, "gather_intersect_ref"), (packed, "popcount"),
                         (ref, "gather_expand_ref"),
                         (ref, "expand_pairs_ref")):
        monkeypatch.setattr(module, name, refuse)
    reset_launch_counts()
    got = [gm.match(q) for q in qs] + gm.match_batch(qs)
    assert [r.count for r in got] == want + want
    assert not any(r.overflowed for r in got)
    counts = launch_counts()
    assert counts.get("gather_expand", 0) >= 6
    assert "expand_pairs" not in counts


def _cycle(n):
    nodes = np.arange(n)
    return graph_from_arrays(n, np.zeros(n, dtype=np.int32), 1,
                             np.stack([nodes, (nodes + 1) % n], axis=1))


@pytest.mark.cuda
def test_whole_graph_count_past_int32(cuda):
    """A directed cycle of 46,341 nodes, one label: every node reaches
    every node, so the 2-node `//` query has n^2 = 2,147,488,281 >= 2^31
    occurrences, which the count must hold exactly (in int64) and equal
    the host reachability index's row sizes summed."""
    n = 46_341
    g = _cycle(n)
    want = int(bitset.count_rows(g.reachability().reach_bits).sum())
    assert want == n * n > 2 ** 31
    gm = TorchGM(g, capacity=65_536, exact_sim=True)
    reset_launch_counts()
    got = gm.match(query_from_spec([0, 0], [(0, 1, 1)]))
    assert (got.count, got.overflowed) == (want, False)
    assert launch_counts().get("gather_expand", 0) == 2


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


# B across the MMA widths (32, 64, 128, 256: zero columns of padding) and
# past 256 (a second column tile); M one below and one past the row tiles
# (384 rows for B <= 64, 128 above); W % 4 != 0 (4-byte copies of A); K
# below 32 W with A's tail bits set (random words)
BITMM_SHAPES = [
    (128, 256, 8, 0.3), (300, 1184, 8, 0.1), (257, 100, 1, 0.5),
    (1000, 2048, 128, 0.05), (77, 4096, 13, 0.01), (2051, 32 * 37, 64, 0.2),
    (64, 33, 3, 0.5), (129, 70000, 9, 0.001)]
BITMM_SHAPES += [(300, 2048, b, 0.3) for b in (1, 15, 16, 17, 64, 65, 128,
                                                256, 257)]
BITMM_SHAPES += [(383, 2048, 64, 0.3), (385, 2048, 64, 0.3),
                 (127, 2048, 128, 0.3), (129, 2048, 128, 0.3),
                 (300, 32 * 37, 64, 0.3), (300, 1000, 64, 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,b,density", BITMM_SHAPES)
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
    # the simulation's operand (the transposed view of contiguous bool
    # rows, passed to the kernel as it is), a float copy of it and a
    # strided slice give the same product
    xt = x.t().contiguous().t()
    strided = torch.stack([x, ~x], dim=2).reshape(k, 2 * b)[:, ::2]
    for form in (xt, xt.float(), strided):
        assert torch.equal(bitmm(a, form, threshold=threshold), want)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [True, False])
def test_bitmm_kernel_misaligned_a(cuda, threshold):
    """A off a 16-byte boundary has no tensor map: its stages come from
    4-byte copies."""
    rng = np.random.default_rng(5)
    m, k, b = 300, 2048, 64
    a = _lanes(rng, m * (k // 32) + 1).to(cuda)[1:].view(m, k // 32)
    assert a.data_ptr() % 16
    x = torch.from_numpy(rng.random((k, b)) < 0.3).to(cuda)
    assert torch.equal(bitmm(a, x, threshold=threshold),
                       ref.bitmm_ref(a, x, threshold=threshold))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32 * 41, 1000])
def test_bitmm_kernel_empty_and_full(cuda, k):
    """All-ones A in sum mode counts exactly K (its bits at K and above
    never count)."""
    m, b = 200, 8
    w = (k + 31) // 32
    x = torch.ones((k, b), dtype=torch.bool, device=cuda)
    zero = torch.zeros((m, w), dtype=torch.int32, device=cuda)
    ones = torch.full((m, w), -1, dtype=torch.int32, device=cuda)
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


def _packed(dense, device):
    return packed.pack(torch.from_numpy(dense)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 96, 512, 1024, 1056])
@pytest.mark.parametrize("density", [0.001, 0.03, 0.3])
def test_closure_step_kernel_equals_plain(cuda, n, density):
    """n = 96 and 1,056 have a lane count that is not a multiple of 4
    (the kernel's 4-byte path)."""
    dense = np.random.default_rng(n).random((n, n)) < density
    r = _packed(dense, cuda)
    reset_launch_counts()
    got = closure_step(r)
    assert launch_counts().get("closure_step") == 1
    assert torch.equal(got, ref.closure_step_ref(r))
    out = torch.full_like(r, -1)
    assert closure_step(r, out=out) is out and torch.equal(out, got)


def _structured(kind, n):
    """A 0/1 (n, n) matrix whose rows exercise both paths of the kernel:
    ``mixed``, rows past the list capacity (every third row, and row 1 with
    33 bits) among sparse ones (row 0 with exactly 32 bits); ``hub``, a
    sparse column listed by every row; ``hub_dense``, the same hub with a
    dense row of its own; ``powerlaw``, Zipf row degrees."""
    rng = np.random.default_rng(n + len(kind))
    dense = np.zeros((n, n), dtype=bool)
    if kind == "mixed":
        deg = np.where(np.arange(n) % 3 == 0, rng.integers(33, 200, n),
                       rng.integers(0, 33, n))
        deg[:4] = (32, 33, 0, 1)
    elif kind.startswith("hub"):
        deg = rng.integers(0, 8, n)
    else:
        deg = rng.zipf(1.6, n)
    for i, d in enumerate(np.minimum(deg, n)):
        dense[i, rng.choice(n, size=d, replace=False)] = True
    if kind.startswith("hub"):
        dense[:, 7] = True
        if kind == "hub_dense":
            dense[7, rng.choice(n, size=min(n, 100), replace=False)] = True
    return dense


CLOSURE_KINDS = ["mixed", "hub", "hub_dense", "powerlaw"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [96, 1024, 1056])
@pytest.mark.parametrize("kind", CLOSURE_KINDS)
def test_closure_step_kernel_structured_rows(cuda, kind, n):
    """Two steps, so that the second takes the rows that the first made
    dense; n = 96 and 1,056 take the 4-byte path."""
    r = _packed(_structured(kind, n), cuda)
    for _ in range(2):
        nxt = closure_step(r)
        assert torch.equal(nxt, ref.closure_step_ref(r))
        r = nxt


@pytest.mark.cuda
@pytest.mark.parametrize("n", [96, 1024])
@pytest.mark.parametrize("kind", CLOSURE_KINDS)
def test_closure_row_lists_kernel_equals_plain(cuda, kind, n):
    """The first pass: exact counts of every row, dense ones included, and
    the ascending column list of every sparse row."""
    dense = _structured(kind, n)
    r = _packed(dense, cuda)
    reset_launch_counts()
    cnt, lists = row_lists(r)
    assert launch_counts() == {"closure_row_lists": 1}
    want_cnt, want_lists = ref.closure_row_lists_ref(r, LIST_CAP)
    assert torch.equal(cnt, want_cnt)
    assert np.array_equal(cnt.cpu().numpy(), dense.sum(axis=1))
    sparse = cnt <= LIST_CAP
    listed = torch.arange(LIST_CAP, device=cuda) < cnt[:, None]
    assert torch.equal(torch.where(listed & sparse[:, None], lists, -1),
                       want_lists)
    assert bool((~sparse).any()) == (kind != "hub")


@pytest.mark.cuda
def test_closure_step_kernel_misaligned(cuda):
    """R off a 16-byte boundary with W % 4 == 0 takes the 4-byte path."""
    n = 1024
    words = packed.pack(torch.from_numpy(_structured("mixed", n))).reshape(-1)
    r = torch.cat([words[:1], words]).to(cuda)[1:].view(n, n // 32)
    assert r.data_ptr() % 16
    assert torch.equal(closure_step(r), ref.closure_step_ref(r))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [False, True])
def test_closure_step_kernel_empty_and_full(cuda, fill):
    r = _packed(np.full((1024, 1024), fill), cuda)
    got = closure_step(r)
    assert torch.equal(got, r) and torch.equal(got, ref.closure_step_ref(r))


@pytest.mark.cuda
def test_closure_step_kernel_chain_needs_every_step(cuda):
    """A 1,024-node chain: each of its 10 steps changes R, the kernel
    equals the plain version at every one, and the last gives the strict
    upper triangle."""
    n = 1024
    dense = np.zeros((n, n), dtype=bool)
    dense[np.arange(n - 1), np.arange(1, n)] = True
    r = _packed(dense, cuda)
    for _ in range(10):
        nxt = closure_step(r)
        assert torch.equal(nxt, ref.closure_step_ref(r))
        assert not torch.equal(nxt, r)
        r = nxt
    want = _packed(np.triu(np.ones((n, n), dtype=bool), k=1), cuda)
    assert torch.equal(r, want)
    assert torch.equal(closure_step(r), r)


@pytest.mark.cuda
def test_transitive_closure_on_card_equals_host_index(cuda):
    g = random_labeled_graph(300, avg_degree=3.0, n_labels=3, seed=6)
    n_pad = 320
    dense = np.zeros((n_pad, n_pad), dtype=bool)
    dense[:g.n, :g.n] = g.adjacency_matrix()
    reset_launch_counts()
    got = ops.transitive_closure(_packed(dense, cuda))
    assert launch_counts().get("closure_step") == 9
    host = ReachabilityIndex.build(g).dense()
    assert np.array_equal(packed.unpack(got, n_pad).cpu().numpy()[:g.n, :g.n],
                          host)
    assert torch.equal(packed.transpose(got),
                       _packed(packed.unpack(got, n_pad).cpu().numpy().T,
                               cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n,block", [(300, 128), (700, 512)])
def test_closure_on_device_on_card_equals_host_index_stack(cuda, n, block):
    g = random_labeled_graph(n, avg_degree=3.0, n_labels=4, seed=n)
    reset_launch_counts()
    dg = device_graph.from_host(g, block=block, closure_on_device=True)
    assert dg.device.type == "cuda"
    assert launch_counts().get("closure_step") == int(np.ceil(np.log2(
        dg.n_pad)))
    host = device_graph.from_host(g, block=block)
    assert torch.equal(dg.stack, host.stack)
    assert torch.equal(dg.labels, host.labels)
    q = random_query_from_graph(g, 4, qtype="D", seed=n)
    want = GM(g).match(q, GMOptions(enum_method="frontier", limit=None,
                                    materialize=False))
    got = TorchGM(g, block=block, capacity=1 << 16, exact_sim=True,
                  closure_on_device=True).match(q)
    assert not got.overflowed and got.count == want.count


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 96, 384, 512, 1056, 4128])
def test_transpose_kernel_equals_plain(cuda, n):
    """W = 1, 3, 33 and 129 take the 4-byte path; W = 12 a ragged tile on
    the 16-byte path."""
    dense = np.random.default_rng(n).random((n, n)) < 0.3
    words = _packed(dense, cuda)
    reset_launch_counts()
    got = transpose(words)
    assert launch_counts() == {"transpose": 1}
    assert torch.equal(got, packed.transpose(words))
    assert torch.equal(got, _packed(np.ascontiguousarray(dense.T), cuda))
    out = torch.full_like(words, -1)
    assert transpose(got, out=out) is out and torch.equal(out, words)


@pytest.mark.cuda
def test_transpose_kernel_misaligned_and_rejects_overlap(cuda):
    n, w = 512, 16
    flat = _lanes(np.random.default_rng(3), n * w + 8).to(cuda)
    words = flat[1:n * w + 1].view(n, w)
    assert words.data_ptr() % 16
    assert torch.equal(transpose(words), packed.transpose(words))
    with pytest.raises(ValueError, match="overlaps"):
        transpose(words, out=words)
    with pytest.raises(ValueError, match="overlaps"):
        transpose(flat[:n * w].view(n, w), out=flat[8:].view(n, w))
    with pytest.raises(ValueError, match="square"):
        transpose(words[:64])
