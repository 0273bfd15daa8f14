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
from repro_torch.torchgm import distributed  # noqa: E402

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


class _Rank:
    """What ``shard_graph_arrays`` reads of a rank's (data, model) mesh."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords

    def get_local_rank(self, axis):
        return self.coords[self.mesh_dim_names.index(axis)]


# (row degree, model degree) of the sharded simulation's tiles: n_pad 2,304
# is 72 words, so model degrees 1 and 2 give w_l 72 and 36 (multiples of 4)
# and 4 and 8 give 18 and 9 (not); row degree 18 cuts tiles of one 128-row
# block
MESH_TILES = [(rows, model) for model in (1, 2, 4, 8) for rows in (1, 4, 18)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,model", MESH_TILES)
@pytest.mark.parametrize("threshold", [True, False])
def test_bitmm_kernel_on_mesh_tiles(cuda, rows, model, threshold):
    """``bitmm`` on every (rows_l, w_l) tile that ``shard_graph_arrays``
    cuts from a random packed stack, by the shard's FB columns in the form
    the sharded pass hands them over (K = np_l = 32 w_l)."""
    rng = np.random.default_rng(10 * rows + model)
    n_pad = 2304
    stack = _lanes(rng, 4, n_pad, n_pad // 32)
    keep = torch.from_numpy(rng.random(stack.shape) < 0.2)
    stack = torch.where(keep, stack, 0).to(cuda)
    dg = device_graph.DeviceGraph(
        n=n_pad, n_pad=n_pad, stack=stack,
        labels=torch.zeros(n_pad, dtype=torch.int32, device=cuda))
    fb = torch.from_numpy(rng.random((2, 8, n_pad)) < 0.3).to(cuda)
    np_l = n_pad // model
    for r in range(rows):
        for c in range(model):
            tile, labels = distributed.shard_graph_arrays(
                dg, _Rank((rows, model), (r, c)))
            assert tile.shape == (4, n_pad // rows, n_pad // 32 // model)
            assert tile.is_contiguous() and labels.shape == (np_l,)
            x = fb[..., c * np_l:(c + 1) * np_l].contiguous()
            x = x.reshape(-1, np_l).t()
            for m in range(4):
                reset_launch_counts()
                got = bitmm(tile[m], x, threshold=threshold)
                assert launch_counts().get("bitmm") == 1
                want = ref.bitmm_ref(tile[m], x, threshold=threshold)
                assert got.dtype == want.dtype and torch.equal(got, want)


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


# ------------------------------------------------------------ LM trainer
LM_ARCHS = ("yi-34b", "qwen1.5-4b", "qwen2-7b", "grok-1-314b",
            "deepseek-moe-16b")


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _rel(got, want, rel):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_smoke_step_on_card_equals_cpu(cuda, no_tf32, arch_id):
    """float32 smoke config from the same weights and batch: loss, every
    gradient leaf (1e-5 of the leaf's largest entry), then two
    ``apply_updates`` from the CPU's gradients (parameters, m and v to
    1e-6 of each leaf's largest entry; gradients near eps would make a
    step from each device's own gradients differ by up to lr there)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree as tr

    cfg = get_config(arch_id).smoke_config()
    host = tf.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=0)
    runs = []
    for dev in ("cpu", cuda):
        params = tr.map_tree(lambda p: p.to(dev).requires_grad_(True), host)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss = tf.loss_fn(params, b, cfg)
        grads = torch.autograd.grad(loss, tr.leaves(params))
        runs.append((params, loss.detach(), grads))
    (pc, lc, gc), (pg, lg, gg) = runs
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
    for a, b in zip(gg, gc):
        _rel(a, b, 1e-5)
    host_grads = tr.unflatten_like(pc, gc)
    states = []
    for params in (pc, pg):
        dev = tr.leaves(params)[0].device
        g = tr.map_tree(lambda t: t.to(dev), host_grads)
        st = opt.init_state(params)
        for _ in range(2):
            params, st, _ = opt.apply_updates(params, g, st, ocfg)
        states.append((params, st["m"], st["v"]))
    for a, b in zip(tr.leaves(states[1]), tr.leaves(states[0])):
        _rel(a, b, 1e-6)


@pytest.mark.cuda
def test_lm_bf16_full_depth_forward_backward(cuda):
    """qwen1.5-4b's depth (40 layers) and vocabulary at a narrow width, in
    bf16 at B = 2, T = 1,024: finite loss near ln V + 0.5 and gradients;
    with remat the peak holds one layer's activations, not 40."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import tree as tr

    base = dataclasses.replace(get_config("qwen1.5-4b").cfg, d_model=256,
                               n_heads=2, n_kv=2, d_ff=512)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, base.vocab, (2, 1024))
                                 .astype(np.int32)).to(cuda)
             for k in ("tokens", "labels")}
    peaks = {}
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        params = tf.TransformerLM(cfg, generator=torch.Generator(
            cuda).manual_seed(0)).params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        loss = tf.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, tr.leaves(params))
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() - start
        assert math.log(cfg.vocab) < float(loss.detach()) \
            < math.log(cfg.vocab) + 1
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        assert all(g.dtype == torch.bfloat16 for g in grads)
        del params, grads, loss
    assert peaks[True] < peaks[False], peaks


@pytest.mark.cuda
def test_adamw_in_place_equals_out_of_place_on_card(cuda, monkeypatch):
    """The sliced in-place update against the reference's out-of-place
    formula, on the card: float32 leaves to 1e-6 relative, bfloat16 leaves
    to one bf16 step."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree as tr

    monkeypatch.setattr(opt, "SLICE_ELEMS", 1000)     # several slices a leaf
    gen = torch.Generator(cuda).manual_seed(0)
    shapes = {"embed": (300, 64), "ln": (8, 64), "w": (8, 64, 96),
              "v": (64,)}

    def tree(dtype_w):
        return {k: torch.randn(s, generator=gen, device=cuda).to(
            dtype_w if k == "w" else torch.float32) for k, s in shapes.items()}

    cfg = opt.AdamWConfig(lr=0.05, warmup_steps=1, weight_decay=0.1)
    for dtype_w in (torch.float32, torch.bfloat16):
        params = tree(dtype_w)
        ref_p = tr.map_tree(torch.clone, params)
        m = tr.map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
        v = tr.map_tree(torch.clone, m)
        st = opt.init_state(params)
        for step in range(1, 4):
            grads = tr.map_tree(lambda p: 3 * torch.randn(
                p.shape, generator=gen, device=cuda).to(p.dtype), params)
            params, st, metr = opt.apply_updates(params, grads, st, cfg)
            # the reference's formula, out of place
            gn = opt.global_norm(grads)
            scale = torch.clamp(1.0 / torch.clamp(gn, min=1e-9), max=1.0)
            lr = opt.schedule_lr(cfg, torch.tensor(step, device=cuda))
            bc1, bc2 = 1 - 0.9 ** float(step), 1 - 0.95 ** float(step)
            for k in shapes:
                g = grads[k].float() * scale
                m[k] = 0.9 * m[k] + (1 - 0.9) * g
                v[k] = 0.95 * v[k] + (1 - 0.95) * torch.square(g)
                delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + cfg.eps)
                delta = delta + 0.1 * float(ref_p[k].ndim >= 2) \
                    * ref_p[k].float()
                ref_p[k] = (ref_p[k].float() - lr * delta).to(ref_p[k].dtype)
        for k in shapes:
            rel = 2 ** -7 if params[k].dtype == torch.bfloat16 else 1e-6
            _rel(params[k], ref_p[k], rel)
            _rel(st["m"][k], m[k], 1e-6)
            _rel(st["v"][k], v[k], 1e-6)


# ---------------------------------------------------- GNN and DIN trainer
GNN_DIN_ARCHS = ("gin-tu", "graphsage-reddit", "schnet", "graphcast", "din")


def _smoke_inputs(arch_id):
    """(cfg, model module, host params, numpy batch) of a smoke config."""
    from repro_torch.configs import get_config
    from repro_torch.data import recsys_data
    from repro_torch.models import gnn, recsys

    arch = get_config(arch_id)
    cfg = arch.smoke_config()
    gen = torch.Generator().manual_seed(0)
    if arch.family == "recsys":
        return cfg, recsys, recsys.init_params(cfg, gen), \
            recsys_data.din_batch(8, cfg.seq_len, cfg.n_items, cfg.n_cates,
                                  cfg.n_user_feats, cfg.user_feat_vocab,
                                  step=0, seed=1)
    return cfg, gnn, gnn.init_params(cfg, gen), arch.smoke_batch(seed=1)


def _grads_on(mod, cfg, host, np_batch, dev):
    """(params, loss, gradients in leaf order) of one step on ``dev``."""
    from repro_torch.configs.base import batch_to
    from repro_torch.train import tree as tr

    params = tr.map_tree(lambda p: p.to(dev).requires_grad_(True), host)
    loss = mod.loss_fn(params, batch_to(np_batch, dev), cfg)
    grads = torch.autograd.grad(loss, tr.leaves(params),
                                materialize_grads=True)
    return params, loss.detach(), grads


# DIN's attention MLP: the gradient of its scores sums to zero over each
# history (the softmax is shift-invariant), so its leaves' gradients are
# sums whose terms cancel (attn_b2's exactly: its gradient is zero) and a
# float32 rounding of the scores' gradient shows there at 2e-5 of a leaf's
# largest entry.  Each attn_* leaf is held within 1e-6 (16 float32 ulps)
# of the largest entry of its gradient with the scores' gradient taken in
# absolute value (the cancelling terms' magnitudes:
# ``recsys.attention_grad_scales`` on the CPU), or within 1e-5 of its own,
# whichever is larger.
@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", GNN_DIN_ARCHS)
def test_gnn_din_smoke_step_on_card_equals_cpu(cuda, no_tf32, arch_id):
    """float32 smoke config from the same weights and batch: loss (1e-5
    relative), every gradient leaf (1e-5 of the leaf's largest entry;
    ``index_add`` adds in no fixed order on the card; DIN's attention MLP
    as above), then two ``apply_updates`` from the CPU's gradients
    (1e-6)."""
    from repro_torch.configs.base import batch_to
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree as tr

    cfg, mod, host, np_batch = _smoke_inputs(arch_id)
    (pc, lc, gc), (pg, lg, gg) = [_grads_on(mod, cfg, host, np_batch, dev)
                                  for dev in ("cpu", cuda)]
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
    scales = {}
    if arch_id == "din":
        scales = mod.attention_grad_scales(host, batch_to(np_batch, "cpu"),
                                           cfg)
    for name, a, b in zip(tr.to_dict(pc), gg, gc):
        limit = max(1e-5 * float(b.abs().max()),
                    1e-6 * scales.get(name, 0.0))
        assert float((a.cpu() - b).abs().max()) <= limit, name
    host_grads = tr.unflatten_like(pc, gc)
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=0)
    states = []
    for params in (pc, pg):
        dev = tr.leaves(params)[0].device
        g = tr.map_tree(lambda t: t.to(dev), host_grads)
        st = opt.init_state(params)
        for _ in range(2):
            params, st, _ = opt.apply_updates(params, g, st, ocfg)
        states.append((params, st["m"], st["v"]))
    for a, b in zip(tr.leaves(states[1]), tr.leaves(states[0])):
        _rel(a, b, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_gnn_aggregate_repeated_destination_on_card(cuda, kind):
    """Half of 200,000 messages into one destination (the sampler's sink
    gets every padded edge), the rest spread, a row of 64 floats each:
    the card's atomic adds equal the CPU's within float32 summation
    error; rows no edge reaches stay exactly zero."""
    from repro_torch.models import gnn

    rng = np.random.default_rng(0)
    n, e = 5_000, 200_000
    dst = rng.integers(0, n // 2, e).astype(np.int32)
    dst[: e // 2] = n - 1
    msg = torch.from_numpy(rng.standard_normal((e, 64)).astype(np.float32))
    dst = torch.from_numpy(dst)
    want = gnn.aggregate(msg, dst, n, kind)
    got = gnn.aggregate(msg.to(cuda), dst.to(cuda), n, kind).cpu()
    _rel(got, want, 1e-5)
    assert not got[n // 2:n - 1].any()


@pytest.mark.cuda
def test_din_table_gradient_dense_on_card(cuda, no_tf32):
    """DIN's embedding gradients on the card are dense (strided, the
    table's shape), zero on rows no id touched, and equal to the CPU's;
    one AdamW step moves every row (decay on 2-D leaves)."""
    from repro_torch.configs.base import batch_to
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree as tr

    cfg, mod, host, np_batch = _smoke_inputs("din")
    grads = {}
    for dev in ("cpu", cuda):
        params = {k: v.to(dev).requires_grad_(True) for k, v in host.items()}
        loss = mod.loss_fn(params, batch_to(np_batch, dev), cfg)
        grads[str(dev)] = dict(zip(sorted(params), torch.autograd.grad(
            loss, [params[k] for k in sorted(params)])))
    gc, gg = grads["cpu"], grads[str(cuda)]
    used = np.unique(np.concatenate([np_batch["item_id"].ravel(),
                                     np_batch["hist_items"].ravel()]))
    for k in ("item_table", "cate_table", "user_table"):
        assert gg[k].layout == torch.strided
        assert gg[k].shape == host[k].shape and gg[k].is_cuda
        _rel(gg[k], gc[k], 1e-5)
    rows = torch.ones(cfg.n_items, dtype=torch.bool)
    rows[torch.from_numpy(used).long()] = False
    assert not gg["item_table"].cpu()[rows].any()
    params = {k: v.to(cuda) for k, v in host.items()}
    before = params["item_table"].clone()
    opt.apply_updates(params, gg, opt.init_state(params),
                      opt.AdamWConfig(lr=1e-2, warmup_steps=0))
    assert bool((params["item_table"] != before).all(-1).all())
    assert tr.leaves(params)[0].is_cuda


# ----------------------------------------------- sharded GNN step, rig_gm
def _sharded_run(arch_id, device, host, np_batch):
    """(loss, gradients in leaf order, parameters / m / v after one step)
    of ``models.gnn_dist`` on a 1 x 1 mesh on ``device`` (NCCL on the
    card, gloo on the CPU), the group torn down after."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import batch_to
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import gnn, gnn_dist
    from repro_torch.train import AdamWConfig, init_state
    from repro_torch.train import tree as tr

    cfg = get_config(arch_id).smoke_config()
    pin, frontier.DEFAULT_DEVICE = frontier.DEFAULT_DEVICE, \
        "cpu" if device == "cpu" else None
    try:
        mesh = make_local_mesh(1, 1)
        assert dist.get_backend() == ("gloo" if device == "cpu" else "nccl")
        params = gnn.GNN(cfg, tr.map_tree(
            lambda p: p.to(device, copy=True), host)).params
        batch = batch_to(np_batch, device)
        loss, grads = gnn_dist.sharded_loss_and_grads(cfg, mesh)(params,
                                                                 batch)
        step, _ = gnn_dist.sharded_train_step(
            cfg, mesh, AdamWConfig(lr=1e-2, warmup_steps=0))
        state = init_state(params)
        params, state, step_loss = step(params, state, batch)
        # the step's own forward and backward (atomics: no fixed order)
        torch.testing.assert_close(step_loss, loss, rtol=1e-6, atol=0)
        return (loss.cpu(), [g.cpu() for g in tr.leaves(grads)],
                [t.detach().cpu() for t in
                 tr.leaves((params, state["m"], state["v"]))])
    finally:
        frontier.DEFAULT_DEVICE = pin
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["gin-tu", "graphsage-reddit"])
def test_gnn_dist_smoke_step_on_card_equals_cpu(cuda, no_tf32, arch_id):
    """``sharded_train_step`` on a 1 x 1 NCCL mesh against the same on a
    1 x 1 gloo mesh on the CPU, float32 smoke config, same weights and
    batch: loss (1e-5 relative), every gradient leaf (1e-5 of its largest
    entry), then one step each from its own gradients: parameters (1e-6),
    m (1e-5, linear in the gradients) and v (2e-5, quadratic)."""
    from repro_torch.configs import get_config
    from repro_torch.models import gnn

    arch = get_config(arch_id)
    cfg = arch.smoke_config()
    host = gnn.init_params(cfg, torch.Generator().manual_seed(0))
    np_batch = arch.smoke_batch(seed=1)
    lc, gc, sc = _sharded_run(arch_id, "cpu", host, np_batch)
    reset_launch_counts()
    lg, gg, sg = _sharded_run(arch_id, cuda, host, np_batch)
    assert launch_counts() == {}
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=1e-5)
    for a, b in zip(gg, gc):
        _rel(a, b, 1e-5)
    n = len(sc) // 3
    for i, (a, b) in enumerate(zip(sg, sc)):
        _rel(a, b, (1e-6, 1e-5, 2e-5)[i // n])


@pytest.mark.cuda
def test_pattern_smoke_on_card(cuda):
    """``rig_gm``'s smoke on the card: ``TorchGM`` through ``bitmm`` and
    ``gather_expand``, each count equal to the host ``match``'s."""
    from repro_torch.configs import get_config

    for seed in range(4):
        reset_launch_counts()
        out = get_config("rig_gm").smoke(seed)
        assert out["finite"] and out["count"] == out["host_count"], out
        counts = launch_counts()
        assert counts.get("bitmm") and counts.get("gather_expand"), counts


@pytest.mark.cuda
def test_closure_step_kernel_power_law_32k(cuda):
    """R of 32,768 nodes (1,024 lanes, 128 MiB): the email profile's
    adjacency transposed (each row a node's in-neighbours, so its in-degree
    hubs are rows past the list capacity) ORed with the identity, held to
    the plain version whole (its bf16 unpack is 2 GiB)."""
    from repro_torch.data.graphs import random_labeled_graph

    n = 32_768
    g = random_labeled_graph(n, avg_degree=420_045 / 265_214, n_labels=20,
                             kind="powerlaw", seed=0)
    ids = np.arange(n)
    r = packed.from_pairs(np.concatenate([g.edges[:, 1], ids]),
                          np.concatenate([g.edges[:, 0], ids]), (n, n),
                          device=cuda)
    cnt, _ = row_lists(r)
    assert int((cnt > LIST_CAP).sum()) >= 10 and int(cnt.max()) > 1000
    reset_launch_counts()
    got = closure_step(r)
    assert launch_counts() == {"closure_step": 1}
    assert torch.equal(got, ref.closure_step_ref(r))


# ------------------------------------------------- the kernels as operators
@pytest.mark.cuda
def test_bitmm_operator_fake_meta_and_formula_on_cuda(cuda):
    """``bitmm`` is the operator ``repro_torch::bitmm``: fake ``cuda``
    tensors and ``meta`` tensors get the output's shape and dtype from its
    fake and launch nothing; ``FlopCounterMode`` over a real call counts
    the kernel's ``2 M 32 W B``; the real call launches the kernel once
    and equals the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    rng = np.random.default_rng(0)
    a = _lanes(rng, 300, 5).to(cuda)
    x = torch.from_numpy(rng.random((150, 40)) < 0.3).to(cuda)
    reset_launch_counts()
    with FakeTensorMode() as mode:
        fa, fx = mode.from_tensor(a), mode.from_tensor(x)
        for threshold, dtype in ((True, torch.bool),
                                 (False, torch.float32)):
            y = bitmm(fa, fx, threshold=threshold)
            assert (y.shape, y.dtype, y.device.type) \
                == ((300, 40), dtype, "cuda")
    y = bitmm(a.to("meta"), x.to("meta"), threshold=False)
    assert (y.shape, y.dtype) == ((300, 40), torch.float32)
    assert launch_counts() == {}
    counter = FlopCounterMode(display=False)
    with counter:
        y = bitmm(a, x, threshold=False)
    assert counter.get_total_flops() == 2 * 300 * 32 * 5 * 40
    assert launch_counts() == {"bitmm": 1}
    assert torch.equal(y.cpu(), ref.bitmm_ref(a.cpu(), x.cpu(),
                                              threshold=False))


@pytest.mark.cuda
def test_closure_step_operator_fake_meta_and_formula_on_cuda(cuda):
    """``closure_step`` is the operator ``repro_torch::closure_step``
    (writing ``out``): fake and ``meta`` calls launch nothing;
    ``FlopCounterMode`` counts the dense bound ``3 N W + N N W``; the real
    call launches once and equals the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    rng = np.random.default_rng(1)
    r = _lanes(rng, 256, 8).to(cuda)
    reset_launch_counts()
    with FakeTensorMode() as mode:
        out = closure_step(mode.from_tensor(r))
        assert (out.shape, out.dtype, out.device.type) \
            == ((256, 8), torch.int32, "cuda")
    assert closure_step(r.to("meta")).shape == (256, 8)
    assert launch_counts() == {}
    counter = FlopCounterMode(display=False)
    with counter:
        out = closure_step(r)
    assert counter.get_total_flops() == 3 * 256 * 8 + 256 * 256 * 8
    assert launch_counts() == {"closure_step": 1}
    assert torch.equal(out.cpu(), ref.closure_step_ref(r.cpu()))


@pytest.mark.cuda
def test_dryrun_trace_on_the_cards_machine(cuda):
    """The dry-run on the card's machine: a fake group's mesh is a
    ``cuda`` mesh, the units trace on ``meta`` tensors (the serve unit and
    a small LM train unit on (2, 2)) and no kernel is launched; the card's
    allocator does not move."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import LMArch
    from repro_torch.launch.dryrun import fake_group, trace
    from repro_torch.launch.mesh import make_local_mesh

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    reset_launch_counts()
    with fake_group(4):
        mesh = make_local_mesh(2, 2)
        assert mesh.device_type == "cuda"
        t = trace(get_config("rig_gm").build_dryrun(
            dict(kind="serve", n_pad=8192, batch=2, passes=4), mesh))
        assert t["flops"] == 18 * 2 * 4096 * 32 * 128 * 16
        lm = LMArch(dataclasses.replace(
            get_config("qwen2-7b").smoke_config(), n_layers=2))
        t = trace(lm.build_dryrun(dict(kind="train", seq_len=32,
                                       global_batch=4), mesh))
        assert t["flops"] > 0 and t["collectives"]["all-reduce"]["count"]
    assert launch_counts() == {}
    assert torch.cuda.memory_allocated() == before
