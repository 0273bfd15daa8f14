"""The least times that ``chip_smoke.py`` sets beside each kernel.

``chip_smoke.py`` is loaded by path (its top-level imports are the
standard library only) and its bound functions are called on ``meta``
tensors of the serve path's shapes at the ``epinions`` profile
(n_pad = 76,288 nodes, W = 2,384 lanes, a batch of 8 queries of 8 nodes:
B = 64), so no memory is allocated and no card is needed.
"""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import packed  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_PAD, W, B = 76_288, 2_384, 64


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _serve_operands(b=B, x_dtype=torch.bool):
    a = torch.empty((N_PAD, W), dtype=torch.int32, device="meta")
    x = torch.empty((N_PAD, b), dtype=x_dtype, device="meta")
    return a, x


def test_bitmm_bound_counts_bytes_and_tensor_operations(smoke):
    """A read once (727,482,368 B), bool X and bool Y once; the product as
    the int8 tensor cores do it, a multiply-add counted as two."""
    nbytes, ops = smoke.bound("bitmm", _serve_operands(), {})
    assert nbytes == 737_247_232
    assert nbytes == 4 * N_PAD * W + 2 * N_PAD * B
    assert ops == 2 * N_PAD * 32 * W * B == 744_941_944_832


@pytest.mark.parametrize("threshold,x_dtype,out_bytes,x_bytes", [
    (True, torch.bool, 1, 1), (False, torch.bool, 4, 1),
    (True, torch.float32, 1, 4), (False, torch.float32, 4, 4)])
def test_bitmm_bound_bytes_follow_the_dtypes(smoke, threshold, x_dtype,
                                             out_bytes, x_bytes):
    nbytes, ops = smoke.bound("bitmm", _serve_operands(x_dtype=x_dtype),
                              {"threshold": threshold})
    assert nbytes == 4 * N_PAD * W + N_PAD * B * (x_bytes + out_bytes)
    assert ops == 2 * N_PAD * 32 * W * B


@pytest.mark.parametrize("b,by,least_ms", [(64, "operations", 0.376423),
                                            (32, "bytes", 0.218616)])
def test_bitmm_bound_is_the_larger_time(smoke, b, by, least_ms):
    """At B = 64 (a batch of 8) the int8 tensor cores (1,979 TOP/s) bound
    bitmm, above the 0.220 ms that its bytes take; at B = 32 (a batch of
    4) the bytes do."""
    least, got_by, nbytes, ops = smoke.bound_ms("bitmm", _serve_operands(b),
                                                {})
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops / 1979e12 * 1e3
    assert got_by == by
    assert least == max(t_bytes, t_ops)
    assert least == pytest.approx(least_ms, abs=1e-6)


def test_word_kernel_bounds_keep_their_basis(smoke):
    """The word-operation kernels stay measured against the float32 rate
    outside the tensor cores; bytes bound them."""
    rows = torch.empty((512, 1, 896), dtype=torch.int32, device="meta")
    least, by, nbytes, ops = smoke.bound_ms("intersect", (rows,), {})
    assert (nbytes, ops) == (4 * 512 * (896 + 896 + 1), 512 * 896 * 2)
    assert by == "bytes" and least == pytest.approx(nbytes / 3.35e12 * 1e3)
    page = torch.empty((65_536, W), dtype=torch.int32, device="meta")
    least, by, nbytes, ops = smoke.bound_ms(
        "expand_pairs", (page,), {"n_i": N_PAD, "size": 65_536})
    assert nbytes == 4 * (65_536 * W + 2 * 65_536)
    assert ops == 3 * 65_536 * W
    assert by == "bytes"


@pytest.mark.parametrize("pattern,distinct", [("cycle", 148), ("same", 1),
                                              ("all", 2_048)])
def test_gather_intersect_bound_counts_distinct_rows_once(smoke, pattern,
                                                          distinct):
    """gather_intersect at the GM.match path's largest shape (the resident
    matrix on meta, a small CPU index): each distinct gathered row is read
    once over w32 lanes, however many frontier rows gather it; the index,
    the AND rows and the counts once."""
    matrix = torch.empty((53_632, 896), dtype=torch.int32, device="meta")
    f, k, w32 = 1_024, 2, 832
    rows = torch.arange(f)
    idx = {"cycle": torch.stack([rows % 145, 50_000 + rows % 3], dim=1),
           "same": torch.full((f, k), 7),
           "all": torch.stack([rows, f + rows], dim=1)}[pattern].int()
    least, by, nbytes, ops = smoke.bound_ms("gather_intersect", (matrix, idx),
                                            {"w32": w32})
    assert nbytes == 4 * (distinct * w32 + f * (k + w32 + 1))
    assert ops == f * w32 * (k + 1)
    assert by == "bytes" and least == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_histogram_keeps_launch_shapes_only(smoke):
    """The shape histogram's keys: (R, W, F, K, w32) and (F, K, W); a call
    with no rows launches nothing and is not kept."""
    m = torch.empty((300, 256), dtype=torch.int32, device="meta")
    idx = torch.empty((1_024, 1), dtype=torch.int32, device="meta")
    keys = smoke.HISTOGRAM
    assert keys["gather_intersect"](m, idx, 62) == (300, 256, 1_024, 1, 62)
    assert keys["gather_intersect"](m, idx[:0], 62) is None
    slab = torch.empty((512, 1, 896), dtype=torch.int32, device="meta")
    assert keys["intersect"](slab) == (512, 1, 896)
    assert keys["intersect"](slab[:0]) is None


def test_transpose_bound_is_its_bytes(smoke):
    """The packed transpose reads the closure once and writes it once
    (1,454,964,736 B at epinions, 0.434 ms at 3.35 TB/s); its five swap
    stages are far below the word-operation rate."""
    words = torch.empty((N_PAD, W), dtype=torch.int32, device="meta")
    least, by, nbytes, ops = smoke.bound_ms("transpose", (words,), {})
    assert nbytes == 2 * 4 * N_PAD * W == 1_454_964_736
    assert ops == 5 * N_PAD * W
    assert by == "bytes"
    assert least == pytest.approx(0.434318, abs=1e-6)


def _packed_rows(rows, n):
    dense = torch.zeros((n, n), dtype=torch.bool)
    for i, cols in rows.items():
        dense[i, cols] = True
    return packed.pack(dense)


@pytest.mark.parametrize("case", ["chain", "hub_dense", "empty"])
def test_closure_step_bound_counts_the_list_work(smoke, case):
    """closure_step moves R once and R' once; its operations are the list
    work of its two passes, counted by hand on small inputs (the count
    depends on the data, so these are CPU tensors, not meta)."""
    n, w = 64, 2
    if case == "chain":             # row i lists i + 1 (one entry each)
        r = _packed_rows({i: [i + 1] for i in range(n - 1)}, n)
        # own entries: n - 1; listed rows 1 .. n - 1 hold 1, 1, ..., 0
        want = 2 * n * w + (n - 1) + (n - 2)
    elif case == "hub_dense":       # row 0 all ones, every other row {0}
        r = _packed_rows({0: list(range(n)),
                          **{i: [0] for i in range(1, n)}}, n)
        # row 0 dense: W to copy; rows 1..63 one own entry; column 0 is
        # listed by all 64 rows and is dense (W each); columns 1..63 by
        # row 0 only, one entry each
        want = 2 * n * w + (w + (n - 1)) + (n * w + (n - 1))
    else:
        r = torch.zeros((n, w), dtype=torch.int32)
        want = 2 * n * w
    nbytes, ops = smoke.bound("closure_step", (r,), {})
    assert nbytes == 2 * 4 * n * w
    assert ops == want


@pytest.mark.parametrize("n_alive,expand", [(65_536, True), (100, True),
                                            (65_536, False), (0, True)])
def test_gather_expand_bound_counts_the_live_rows(smoke, n_alive, expand):
    """The enumerator's level at the serve shape (the stack's flat view,
    meta): each distinct row the live rows gather read once over the live
    lanes, their index, the candidate row and, when expanding, the pairs;
    one operation per gathered lane.  Rows past n_alive cost nothing."""
    mats = torch.empty((4 * N_PAD, W), dtype=torch.int32, device="meta")
    fb_row = torch.empty((W,), dtype=torch.int32, device="meta")
    f, k, size = 65_536, 2, 65_536
    # live row f gathers rows f % 50 and 1,000 + f % 7: 57 distinct rows
    rows = torch.arange(f, dtype=torch.int32)
    idx = torch.stack([rows % 50, 1_000 + rows % 7], dim=1)
    alive = torch.tensor(n_alive)
    kw = {"n_i": N_PAD, "size": size, "expand": expand}
    least, by, nbytes, ops = smoke.bound_ms(
        "gather_expand", (mats, fb_row, idx, alive), kw)
    distinct = 57 if n_alive >= 50 else 0
    pairs = 2 * size if expand else 0
    assert nbytes == 4 * (distinct * W + n_alive * k + pairs + W)
    assert ops == n_alive * W * (k + 1)
    assert least == max(nbytes / 3.35e12, ops / 67e12) * 1e3
    assert by == ("bytes" if nbytes / 3.35e12 >= ops / 67e12 else
                  "operations")
