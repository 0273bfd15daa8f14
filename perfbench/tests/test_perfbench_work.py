"""The frozen work counts reproduce the kernel table's bounds."""

import pytest

from perfbench import work


def ms(kernel, counts):
    s, by = work.least_s(kernel, *counts)
    return s * 1e3, by


def test_bitmm_64_columns():
    t, by = ms("bitmm", work.bitmm(76_288, 2_384, 76_288, 64))
    assert t == pytest.approx(0.376423, abs=5e-7) and by == "operations"


def test_bitmm_32_columns():
    t, by = ms("bitmm", work.bitmm(76_288, 2_384, 76_288, 32))
    assert t == pytest.approx(0.218616, abs=5e-7) and by == "bytes"


def test_gather_expand_level():
    # mats 305,152 x 2,384, idx 65,536 x 2, n_alive 45,771: operations bound
    for distinct in (1, 100, 1_000):
        t, by = ms("gather_expand",
                   work.gather_expand(2_384, 45_771, 2, distinct, 65_536))
        assert t == pytest.approx(0.004886, abs=5e-7) and by == "operations"


def test_bytes_count_each_row_once():
    few = work.gather_expand(2_384, 10, 2, 5, 64)[0]
    many = work.gather_expand(2_384, 10, 2, 20, 64)[0]
    assert many - few == 4 * 15 * 2_384
    assert work.bitmm(10, 2, 64, 3, threshold=False)[0] == \
        4 * 10 * 2 + 64 * 3 + 10 * 3 * 4
