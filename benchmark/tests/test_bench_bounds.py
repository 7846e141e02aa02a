"""The frozen roofline arithmetic against shapes worked by hand."""

import pytest

from benchmark.harness import bounds

B16 = "banded_dp16_kernel<16, 2, false, WindowRows>"
CLIP = "banded_dp_kernel<16, true, 2, false, WindowRows>"
PLAIN32 = "banded_dp_kernel<16, false, 4, true, WindowRows>"


def test_per_cell_from_the_body_name():
    assert bounds.banded_dp_per_cell(B16) == 3.0
    assert bounds.banded_dp_per_cell(CLIP) == 7.5
    assert bounds.banded_dp_per_cell(PLAIN32) == 6.0
    with pytest.raises(ValueError):
        bounds.banded_dp_per_cell("vote_kernel")


def test_banded_dp_bound_by_hand():
    # 131,072 candidates of 150-base reads (pad 160), windows of 192,
    # hw 16: 19,660,800 rows x (33 x 3 + 3) = 2,005,401,600 instructions
    # at 16.75e12 a second; bytes 131,072 x (192 + 160 + 4 + 16)
    got = bounds.banded_dp_bound_s(131072, 192, 160, 150, 16, B16)
    assert got == pytest.approx(2_005_401_600 / 16.75e12)
    assert 131072 * 372 / 3.35e12 < got
    clip = bounds.banded_dp_bound_s(32768, 192, 160, 150, 16, CLIP)
    assert clip == pytest.approx(32768 * 150 * (33 * 7.5 + 3) / 16.75e12)


def test_tb_dp_bound_by_hand():
    # 8,192 winners x 150 rows x (33 x 15 + 12)
    got = bounds.tb_dp_bound_s(8192, 192, 160, 150, 16)
    assert got == pytest.approx(8192 * 150 * 507 / 16.75e12)


def test_bytes_bound_where_the_work_is_small():
    # one row of hw 1: the bytes take longer than the instructions
    got = bounds.banded_dp_bound_s(1000, 10_000, 160, 1, 1, B16)
    assert got == pytest.approx(1000 * (10_000 + 160 + 4 + 16) / 3.35e12)
