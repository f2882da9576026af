"""The yardstick's byte counts against the bounds PERF.md has used."""

import pytest

from blasbench import roofline

GBPS = roofline.peak_gbps("NVIDIA H100 80GB HBM3")


def test_peak_by_name():
    assert GBPS == 3350.0
    assert roofline.peak_gbps("NVIDIA A100-SXM4-80GB") is None


@pytest.mark.parametrize("nbytes, ms", [
    (roofline.dot_bytes(1 << 29, "bf16", "bf16"), 0.6410),
    (roofline.gemv_bytes(16384, 16384, "bf16", "bf16", "bf16"), 0.1603),
    (roofline.gemv_bytes(16384, 16384, "f32", "f32", "f32"), 0.3206),
    (roofline.dot_bytes(1 << 27, "f32", "f32"), 0.3205),
])
def test_bounds_match_the_kernel_table(nbytes, ms):
    assert round(roofline.bound_ms(nbytes, GBPS), 4) == ms


def test_trsv_reads_the_strict_triangle():
    n = 16384
    unit = roofline.trsv_bytes(n, "f32", "f32", "f32", unit=True)
    assert unit == (n * (n - 1) // 2) * 4 + 2 * n * 4
    assert roofline.trsv_bytes(n, "f32", "f32", "f32", unit=False) == unit + 4 * n
    # half of A, not whole 64 x 64 diagonal tiles: under the 0.1609 ms those counted
    assert round(roofline.bound_ms(unit, GBPS), 4) == 0.1603
