"""Enums and engine constants of the carver (SPEC.md §2, §5, §7).

The subset of ``lqr_tpu.config`` that the PyTorch port's carving path uses;
values are identical (tests/test_torch_convert.py asserts it).
"""

from __future__ import annotations

import enum


class EnergyFunc(enum.IntEnum):
    """The 7 builtin energy functions (SPEC.md §2); default GRAD_XABS."""

    GRAD_XABS = 0
    GRAD_SUMABS = 1
    GRAD_NORM = 2
    LUMA_GRAD_XABS = 3
    LUMA_GRAD_SUMABS = 4
    LUMA_GRAD_NORM = 5
    NULL = 6


class ResizeOrder(enum.IntEnum):
    """Which axis a two-axis resize carves first."""

    HOR = 0   # width first, then height (default)
    VERT = 1  # height first, then width


DEFAULT_SIDE_SWITCH_FREQUENCY = 2
MAX_DELTA_X = 10
MIN_ENL_STEP = 1.001
MAX_ENL_STEP = 2.0
