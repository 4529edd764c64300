"""The work arithmetic against hand counts."""

import pytest

from benchmark import work


def test_dp_and_energy_ops():
    assert work.dp_ops(1, False) == 4            # 3 compares + the add
    assert work.dp_ops(2, True) == 5 + 8 + 1
    assert work.energy_ops(0, False) == 3        # sub, mul, abs
    assert work.energy_ops(0, True) == 4         # + the bias's add
    assert work.energy_ops(1, False) == 8
    assert work.energy_ops(4, True) == 9
    assert work.energy_ops(6, True) == 1         # NULL: the bias alone


def test_carve_work_by_hand():
    # 2 rows, 4 then 3 columns carved: 14 cells of 3 + 4 operations;
    # 8 pixels of 3 u8 read and an i32 map written
    assert work.carve_work(2, 4, 3, 2, nrg=0, delta_x=1, has_bias=False,
                           has_rig=False) == (98, 56)
    # a bias plane: one more op a cell, 4 more bytes a pixel
    assert work.carve_work(2, 4, 3, 2, nrg=0, delta_x=1, has_bias=True,
                           has_rig=False) == (112, 88)


def test_main_path_bound():
    # 2048^2, 100 seams: 2.865 G operations, 0.0428 ms on an H100
    ops, nbytes = work.carve_work(2048, 2048, 3, 100, nrg=0, delta_x=1,
                                  has_bias=False, has_rig=False)
    assert ops == 2048 * (100 * 2048 - 4950) * 7
    t, by = work.least_seconds(ops, nbytes,
                               work.peaks("NVIDIA H100 80GB HBM3"))
    assert by == "operations"
    assert t == pytest.approx(4.2762e-5, rel=1e-3)


def test_unknown_card_has_no_peaks():
    assert work.peaks("NVIDIA A100-SXM4-40GB") is None
