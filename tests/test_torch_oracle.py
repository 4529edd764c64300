"""The port's NumPy oracle (lqr_tpu_torch.oracle) against lqr_tpu.oracle:
every function, bit for bit (tolerance 0), over each energy function,
delta_x 0-2, rigidity, bias and both side preferences; and its
compute_vs_map against the C++ reference carver (native.carve)."""

import numpy as np
import pytest
import torch

from conftest import random_image
from lqr_tpu import oracle as jor
from lqr_tpu.config import EnergyFunc as JEnergyFunc
from lqr_tpu_torch import native
from lqr_tpu_torch import oracle as tor
from lqr_tpu_torch.config import EnergyFunc

torch.set_num_threads(1)


def _img(seed, h=12, w=20, c=3):
    return (random_image(np.random.default_rng(seed), h, w, c) // 8) * 8


def _fields(seed, h, w):
    rng = np.random.default_rng(seed)
    bias = np.round(rng.standard_normal((h, w)) * 4).astype(np.float32) / 8
    rig = np.round(np.abs(rng.standard_normal((h, w))) * 4).astype(
        np.float32) / 4
    return bias, rig


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_readers_and_gradients_match_jax(c):
    img = _img(c, c=c)
    for name in ("strength", "brightness", "luma"):
        got = getattr(tor, name)(img)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, getattr(jor, name)(img))
    b = tor.luma(img)
    for g, w in zip(tor.gradients(b), jor.gradients(b)):
        np.testing.assert_array_equal(g, w)
    assert tor.LUMA_W == jor.LUMA_W and tor.INF == jor.INF


@pytest.mark.parametrize("nrg", list(EnergyFunc))
def test_energy_matches_jax(nrg):
    for c in (3, 4):
        img = _img(int(nrg) + c, c=c)
        got = tor.energy(img, nrg)
        assert got.dtype == np.float32 and got.shape == img.shape[:2]
        np.testing.assert_array_equal(got, jor.energy(img,
                                                      JEnergyFunc(int(nrg))))


@pytest.mark.parametrize("delta_x", [0, 1, 2])
def test_seam_search_matches_jax(delta_x):
    h, w = 14, 23
    e = tor.energy(_img(delta_x, h, w), EnergyFunc.GRAD_XABS)
    bias, rig = _fields(delta_x, h, w)
    for pref_left in (True, False):
        assert tor.dx_order(delta_x, pref_left) == jor.dx_order(delta_x,
                                                                pref_left)
        for r in (np.zeros_like(rig), rig):
            got = tor.find_seam(e + bias, r, delta_x, pref_left, h)
            np.testing.assert_array_equal(
                got, jor.find_seam(e + bias, r, delta_x, pref_left, h))
            assert np.abs(np.diff(got)).max(initial=0) <= delta_x
    for s in range(1, 12):
        for freq in (0, 1, 2, 5):
            assert tor.pref_is_left(s, freq) == jor.pref_is_left(s, freq)
    assert tor.pref_is_left(3) == jor.pref_is_left(3)


def test_remove_seam_and_materialize_match_jax():
    h, w = 10, 16
    img = _img(3, h, w)
    seam = np.random.default_rng(0).integers(0, w, h)
    np.testing.assert_array_equal(tor.remove_seam(img, seam),
                                  jor.remove_seam(img, seam))
    vs = jor.compute_vs_map(img, 6)
    plane = np.random.default_rng(1).random((h, w)).astype(np.float32)
    for new_w in (w - 6, w - 3, w, w + 2, w + 6):
        np.testing.assert_array_equal(tor.materialize(img, vs, new_w),
                                      jor.materialize(img, vs, new_w))
        np.testing.assert_array_equal(tor.materialize(plane, vs, new_w),
                                      jor.materialize(plane, vs, new_w))


@pytest.mark.parametrize("nrg", list(EnergyFunc))
@pytest.mark.parametrize("delta_x", [0, 1, 2])
def test_compute_vs_map_matches_jax(nrg, delta_x):
    h, w, n = 9, 18, 5
    img = _img(int(nrg) * 3 + delta_x, h, w)
    bias, rig = _fields(delta_x, h, w)
    for kw in ({}, {"bias": bias, "rig": rig, "side_switch_freq": 1}):
        got = tor.compute_vs_map(img, n, nrg=nrg, delta_x=delta_x, **kw)
        want = jor.compute_vs_map(img, n, nrg=JEnergyFunc(int(nrg)),
                                  delta_x=delta_x, **kw)
        np.testing.assert_array_equal(got, want)
        # the map extended from its fully shrunk state
        np.testing.assert_array_equal(
            tor.compute_vs_map(img, 3, nrg=nrg, delta_x=delta_x,
                               start_seam=n + 1, vs=got, **kw),
            jor.compute_vs_map(img, 3, nrg=JEnergyFunc(int(nrg)),
                               delta_x=delta_x, start_seam=n + 1, vs=want,
                               **kw))


def test_carve_width_matches_jax():
    img = _img(11, 10, 24)
    for new_w in (17, 24, 30):
        np.testing.assert_array_equal(tor.carve_width(img, new_w),
                                      jor.carve_width(img, new_w))


@pytest.mark.parametrize("delta_x", [0, 1, 2])
def test_compute_vs_map_matches_native(delta_x):
    """The C++ reference is the oracle's other side: the same seams with
    bias and rigidity, under a non-sqrt and a sqrt energy."""
    h, w, n = 16, 28, 9
    img = _img(20 + delta_x, h, w)
    bias, rig = _fields(30 + delta_x, h, w)
    for nrg in (EnergyFunc.GRAD_XABS, EnergyFunc.LUMA_GRAD_SUMABS):
        np.testing.assert_array_equal(
            tor.compute_vs_map(img, n, nrg=nrg, delta_x=delta_x, bias=bias,
                               rig=rig),
            native.carve(img, n, bias=bias, rig=rig, delta_x=delta_x,
                         nrg=int(nrg)))
