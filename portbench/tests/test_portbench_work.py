"""Work counts and rooflines on hand-worked shapes."""

import pytest

from portbench.metrics import work


def test_cm_work_by_hand():
    # two rows of 1,000 and 500 bytes coded into 300 and 200 bytes
    nbytes, ops = work.cm_work([1000, 500], [300, 200])
    assert nbytes == 1500 + 500 + 16
    assert ops == 40 * 8 * 1500


def test_least_time_and_share():
    # 60 rows of 16 MiB: operations bound, 40 * 8 * 60 * 2**24 / 67e12
    rows = [16 << 20] * 60
    nbytes, ops = work.cm_work(rows, [2 << 20] * 60)
    t, by = work.least_seconds(nbytes, ops)
    assert by == "operations" and t == pytest.approx(40 * 8 * 60 * 2**24 / 67e12)
    assert work.roofline_pct(nbytes, ops, 5.0) == pytest.approx(100 * t / 5.0)
    assert work.roofline_pct(nbytes, ops, 0.0) is None


def test_bytes_bound():
    t, by = work.least_seconds(3_350_000_000, 0)
    assert by == "bytes" and t == pytest.approx(1e-3)


def test_crc_and_lzp_work():
    assert work.crc_work([1 << 20, 1 << 20], 16) == (2 * (1 << 20) + 4 * 2 * 16 + 8, 5 * 2 * (1 << 20))
    assert work.lzp_work([100], [60], [100]) == (100 + 60 + 8, 18 * 100)
