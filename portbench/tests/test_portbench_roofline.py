"""The roofline arithmetic against PERF.md's float32 figures (section 6:
kernel #1 6.72 MB and 34.7 MFLOP at K = 10,001; #2 7.93 MB at K = 11,264;
#4 / #5 / #6 75.5 / 37.7 / 29.4 MB at N = 20,000), and its float64 case."""

import pytest
from portbench_testkit import REPO  # noqa: F401  (puts the repo on sys.path)

from portbench import roofline


def test_float32_figures_of_perf_md():
    nbytes, flops = roofline.kkt_work(10_001, 2, width=4)
    assert round(nbytes / 1e6, 2) == 6.72
    assert round(flops / 1e6, 1) == 34.7
    assert round(roofline.chain_work(11_264, 3, width=4)[0] / 1e6, 2) == 7.93
    cr = roofline.cr_work(20_001, 3, width=4)
    assert [round(cr[k][0] / 1e6, 1) for k in
            ("cr_level_factor", "cr_level_apply", "cr_backsub")] == \
        [75.5, 37.7, 29.4]


@pytest.mark.parametrize("work", [
    lambda w: roofline.kkt_work(10_001, 2, width=w),
    lambda w: roofline.chain_work(11, 3, chains=1024, width=w),
    lambda w: roofline.cr_sweeps_work(100_001, 3, width=w),
])
def test_float64_moves_twice_the_bytes_and_the_same_operations(work):
    b4, f4 = work(4)
    b8, f8 = work(8)
    assert b8 == 2 * b4 and f8 == f4


def test_cr_levels_pad_to_a_power_of_two_and_stop_at_the_tail():
    assert roofline.cr_pairs(20_001) == 32_768 - 8
    assert roofline.cr_pairs(100_001) == 131_072 - 8
    assert roofline.cr_pairs(16) == 8


def test_the_cells_are_bound_by_bytes():
    for work in (roofline.kkt_work(10_001, 2),
                 roofline.chain_work(11_264, 3),
                 roofline.chain_work(11, 3, chains=1024),
                 roofline.cr_sweeps_work(100_001, 3)):
        assert roofline.bound(*work)[1] == "bytes"
    # 340 us float64 for the three CR sweeps at N = 100,000.
    assert roofline.bound(*roofline.cr_sweeps_work(100_001, 3))[0] == \
        pytest.approx(340.5e-6, rel=1e-3)


def test_share_is_none_where_nothing_was_measured():
    assert roofline.share(roofline.kkt_work(11, 2), None) is None
    assert roofline.share(roofline.kkt_work(11, 2), 0.0) is None
