"""The port's Carver (lqr_tpu_torch.Carver, device="cpu") as a whole
against lqr_tpu.Carver(use_pallas=False) and the C++ reference carver:
equal visibility maps and u8-equal images."""

import numpy as np
import pytest
import torch

import lqr_tpu
import lqr_tpu_torch
from conftest import random_image
from lqr_tpu_torch import native
from lqr_tpu_torch.config import EnergyFunc, ResizeOrder

torch.set_num_threads(1)


def _img(seed, h, w, c=3):
    return (random_image(np.random.default_rng(seed), h, w, c) // 8) * 8


def _pair(img, **kw):
    return (lqr_tpu.Carver(img, use_pallas=False, **kw),
            lqr_tpu_torch.Carver(img, device="cpu", **kw))


def _same_vmaps(j, t):
    assert len(j.vmaps) == len(t.vmaps)
    for a, b in zip(j.vmaps, t.vmaps):
        assert (a.depth, a.ref_w, a.ref_h, a.orientation) == (
            b.depth, b.ref_w, b.ref_h, b.orientation)
        np.testing.assert_array_equal(b.data, a.data)


def test_shrink_then_slide_back():
    img = _img(1, 20, 96)
    j, t = _pair(img)
    for c in (j, t):
        c.resize(70, 20)
    np.testing.assert_array_equal(t.get_image(), j.get_image())
    np.testing.assert_array_equal(t.vmap_dump().data, j.vmap_dump().data)
    for c in (j, t):
        c.resize(96, 20)
    np.testing.assert_array_equal(t.get_image(), img)
    np.testing.assert_array_equal(j.get_image(), img)
    assert (t.width, t.height, t.depth, t.orientation) == (96, 20, 26, 0)


def test_two_axis_resize_dumps_same_vmaps():
    img = _img(2, 40, 48)
    j, t = _pair(img)
    for c in (j, t):
        c.set_dump_vmaps(True)
        c.resize(36, 30)
    np.testing.assert_array_equal(t.get_image(), j.get_image())
    assert [v.orientation for v in t.vmaps] == [0, 1]
    _same_vmaps(j, t)
    assert not t.scan_by_row and (t.ref_width, t.ref_height) == (36, 40)


def test_vertical_first_order_and_side_switch():
    img = _img(3, 36, 44)
    j, t = _pair(img)
    for c in (j, t):
        c.set_resize_order(ResizeOrder.VERT)
        c.set_side_switch_frequency(1)
        c.set_dump_vmaps(True)
        c.resize(38, 28)
    np.testing.assert_array_equal(t.get_image(), j.get_image())
    _same_vmaps(j, t)


def test_multipass_enlargement():
    img = _img(4, 16, 40)
    j, t = _pair(img)
    for c in (j, t):
        c.set_enl_step(1.25)
        c.set_dump_vmaps(True)
        c.resize(64, 16)                 # 1.6x width: several passes
    out = t.get_image()
    assert out.shape == (16, 64, 3)
    np.testing.assert_array_equal(out, j.get_image())
    assert len(t.vmaps) >= 3
    _same_vmaps(j, t)


@pytest.mark.parametrize("delta_x", [1, 2])
def test_rigidity(delta_x):
    img = _img(5, 18, 60)
    j, t = _pair(img, delta_x=delta_x, rigidity=40.0)
    for c in (j, t):
        c.resize(45, 18)
    np.testing.assert_array_equal(t.get_image(), j.get_image())
    for c in (j, t):
        c.resize(45, 14)                 # flatten + rig unfold + reorient
        c.resize(70, 14)                 # and enlarge
    np.testing.assert_array_equal(t.get_image(), j.get_image())


@pytest.mark.parametrize("nrg", [EnergyFunc.GRAD_XABS, EnergyFunc.GRAD_NORM,
                                 EnergyFunc.LUMA_GRAD_NORM,
                                 EnergyFunc.LUMA_GRAD_SUMABS])
def test_against_native_reference(nrg):
    """The C++ reference is the other side for the sqrt energies."""
    img = _img(6, 24, 80)
    t = lqr_tpu_torch.Carver(img, delta_x=2, device="cpu")
    t.set_energy_function(nrg)
    t.resize(57, 24)
    vs = native.carve(img, 23, delta_x=2, nrg=int(nrg))
    np.testing.assert_array_equal(t.vmap_dump().data, vs)
    np.testing.assert_array_equal(t.get_image(),
                                  native.materialize(img, vs, 57))
    t.resize(95, 24)
    np.testing.assert_array_equal(t.get_image(),
                                  native.materialize(img, vs, 95))


def test_errors_and_device():
    img = _img(7, 8, 16)
    with pytest.raises(lqr_tpu_torch.LqrConfigError):
        lqr_tpu_torch.Carver(img, delta_x=11, device="cpu")
    with pytest.raises(lqr_tpu_torch.LqrConfigError):
        lqr_tpu_torch.Carver(img, rigidity=-1, device="cpu")
    with pytest.raises(lqr_tpu_torch.LqrImageError):
        lqr_tpu_torch.Carver(np.zeros((8, 16, 5), np.uint8), device="cpu")
    t = lqr_tpu_torch.Carver(img, device="cpu")
    with pytest.raises(lqr_tpu_torch.LqrConfigError):
        t.set_enl_step(2.5)
    with pytest.raises(lqr_tpu_torch.LqrConfigError):
        t.resize(0, 8)
    t.resize(10, 8)
    with pytest.raises(lqr_tpu_torch.LqrStateError):
        t.set_energy_function(EnergyFunc.NULL)   # carved map: flatten first
    if not torch.cuda.is_available():
        with pytest.raises(lqr_tpu_torch.LqrConfigError):
            lqr_tpu_torch.Carver(img)             # the default is "cuda"


def test_progress_chunks():
    events = []

    class Progress:
        def init(self, msg):
            events.append(("init", msg))

        def update(self, frac):
            events.append(("update", frac))

        def end(self):
            events.append(("end",))

    img = _img(8, 12, 50)
    j, t = _pair(img)
    t.set_progress(Progress())
    for c in (j, t):
        c.resize(20, 12)
    np.testing.assert_array_equal(t.get_image(), j.get_image())
    assert events[0] == ("init", "Resizing width...")
    assert events[-1] == ("end",)
    assert [e[1] for e in events if e[0] == "update"][-1] == 1.0
    assert t.depth == 30
