"""Masks and attached aux images on the port's Carver (device="cpu"):
mask strength and placement against lqr_tpu's, and bias_add / rigmask_add /
attach against lqr_tpu.Carver(use_pallas=False) and the C++ reference
carver. Equal visibility maps and u8-equal images and aux images."""

import numpy as np
import pytest
import torch

import lqr_tpu
import lqr_tpu_torch
import mask_cases
from conftest import random_image
from lqr_tpu import oracle as joracle
from lqr_tpu.utils import codec
from lqr_tpu_torch import native
from lqr_tpu_torch import oracle as toracle
from lqr_tpu_torch.carver import place_mask_numpy
from lqr_tpu_torch.config import EnergyFunc, ResizeOrder
from lqr_tpu_torch.ops.place_mask import place_mask

torch.set_num_threads(1)


def _img(seed, h, w, c=3):
    return (random_image(np.random.default_rng(seed), h, w, c) // 8) * 8


def _masks(seed, h, w):
    """A preservation mask, a discard mask, a grey rigidity mask on the
    left third and an RGBA aux image."""
    rng = np.random.default_rng(seed)
    pres = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3)).astype(np.uint8)
    disc = rng.integers(0, 256, (h // 2, w // 2, 4)).astype(np.uint8)
    rigm = rng.integers(0, 256, (h, w // 3)).astype(np.uint8)
    aux = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    return pres, disc, rigm, aux


def _dress(c, h, w, seed):
    pres, disc, rigm, aux = _masks(seed, h, w)
    c.bias_add(pres, 1000.0, w // 4, h // 4)
    c.bias_add(disc, -800.0, w // 2, h // 2)
    c.rigmask_add(rigm)
    c.attach(aux)


def _pair(img, **kw):
    return (lqr_tpu.Carver(img, use_pallas=False, **kw),
            lqr_tpu_torch.Carver(img, device="cpu", **kw))


def _same(j, t, n_aux=1):
    np.testing.assert_array_equal(t.get_image(), j.get_image())
    for i in range(n_aux):
        np.testing.assert_array_equal(t.get_aux(i), j.get_aux(i))
    assert len(j.vmaps) == len(t.vmaps)
    for a, b in zip(j.vmaps, t.vmaps):
        assert (a.depth, a.ref_w, a.ref_h, a.orientation) == (
            b.depth, b.ref_w, b.ref_h, b.orientation)
        np.testing.assert_array_equal(b.data, a.data)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_strength_and_placement_match_jax(C):
    rng = np.random.default_rng(C)
    mask = rng.integers(0, 256, (9, 14, C)).astype(np.uint8)
    want = joracle.strength(mask)
    got = toracle.strength(mask)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    H, W = 20, 30
    # inside, negative, clipped at the far edges, wholly outside
    for x_off, y_off in ((3, 2), (-4, -3), (25, 15), (-20, 0), (0, 40)):
        np.testing.assert_array_equal(
            place_mask_numpy(mask, H, W, x_off, y_off),
            codec.place_mask(mask, H, W, x_off, y_off),
            err_msg=f"{x_off=} {y_off=}")
    if C == 1:       # a 2-D mask is one channel
        np.testing.assert_array_equal(toracle.strength(mask[:, :, 0]), want)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_place_mask_plain_equals_codec(C, n):
    """ops.place_mask on the CPU sums n placements
    into one plane bit for bit as the Carver's planes were built before:
    each field from place_mask_numpy and from lqr_tpu's codec, times
    f32(factor/1000), added in turn; compared as int32, so the signs of
    zero count. Offsets inside, negative, past the far edges, wholly
    outside, a mask larger than the image; factors +-1000 and -800. A CPU
    Carver's bias (bias_add) and rigidity (rigmask_add) planes equal the
    codec-built ones."""
    H, W = mask_cases.MASK_PLANE
    runs = mask_cases.mask_runs(C, n)
    img = _img(10, H, W)
    for run in runs:
        got = None
        want = {"numpy": None, "jax codec": None}
        rig_want = None
        c = lqr_tpu_torch.Carver(img, device="cpu")
        for mask, x_off, y_off, factor in run:
            f = np.float32(factor / 1000.0)
            got = place_mask(torch.from_numpy(mask), H, W, x_off, y_off, f,
                             got)
            fields = {"numpy": place_mask_numpy(mask, H, W, x_off, y_off),
                      "jax codec": codec.place_mask(mask, H, W, x_off,
                                                    y_off)}
            for k, field in fields.items():
                add = field * f
                want[k] = add if want[k] is None else want[k] + add
            field = fields["jax codec"]
            rig_want = field if rig_want is None else rig_want + field
            c.bias_add(mask, factor, x_off, y_off)
            c.rigmask_add(mask, x_off, y_off)
        assert got.dtype == torch.float32 and got.shape == (H, W)
        for k, plane in want.items():
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(plane),
                                          err_msg=k)
        np.testing.assert_array_equal(_bits(c._ref_bias.numpy()),
                                      _bits(want["jax codec"]))
        np.testing.assert_array_equal(_bits(c._ref_rig.numpy()),
                                      _bits(rig_want))


@pytest.mark.parametrize("order", [ResizeOrder.HOR, ResizeOrder.VERT])
def test_masked_carver_matches_jax(order):
    """Both masks, a rigidity mask and an aux image through a two-axis
    resize (orientation 1 transposes bias, rig and aux), then a second
    resize after a mask added to the carved map forces a flatten."""
    h, w = 36, 64
    img = _img(1, h, w)
    j, t = _pair(img, rigidity=30.0)
    for c in (j, t):
        c.set_resize_order(order)
        c.set_dump_vmaps(True)
        _dress(c, h, w, 2)
        c.resize(48, 28)
    _same(j, t)
    assert t.orientation == (1 if order == ResizeOrder.HOR else 0)
    pres = _masks(3, h, w)[0]
    for c in (j, t):
        c.bias_add(pres, 500.0, 2, 3)         # flattens the carved map
        assert (c.ref_width, c.ref_height) == (48, 28)
        c.resize(40, 28)
    _same(j, t)
    assert torch.equal(t.get_image_device(), torch.from_numpy(t.get_image()))


def test_multipass_enlargement_with_bias():
    """As tests/test_multipass_enlarge.py:152: each pass after a flatten
    sees the enlarged bias field."""
    h, w = 16, 20
    img = _img(4, h, w)
    bias = np.zeros((h, w), np.float32)
    bias[:, 5:9] = 0.8
    mask_u8 = (np.stack([bias] * 3, -1) * 255).astype(np.uint8)
    j, t = _pair(img)
    for c in (j, t):
        c.set_enl_step(1.5)
        c.set_dump_vmaps(True)
        c.bias_add(mask_u8, 1000.0)
        c.attach(img[:, :, :2])
        c.resize(int(w * 2.2), h)
    assert t.get_image().shape == (h, 44, 3) and len(t.vmaps) >= 2
    _same(j, t)


def test_attach_errors_match_jax():
    img = _img(5, 12, 20)
    j, t = _pair(img)
    for bad in (np.zeros((12, 21, 3), np.uint8),
                np.zeros((12, 20, 5), np.uint8)):
        with pytest.raises(lqr_tpu.LqrImageError) as want:
            j.attach(bad)
        with pytest.raises(lqr_tpu_torch.LqrImageError) as got:
            t.attach(bad)
        assert str(got.value) == str(want.value)
    t.attach(img[:, :, 0])                    # a 2-D aux image: one channel
    assert t.get_aux(0).shape == (12, 20, 1)


@pytest.mark.parametrize("nrg", [EnergyFunc.GRAD_NORM,
                                 EnergyFunc.LUMA_GRAD_SUMABS])
def test_masks_match_native(nrg):
    """The C++ reference is the other side for the sqrt energies: its bias
    and rig planes are built in numpy in the Carver's rounding order."""
    h, w, n, rigidity = 30, 72, 25, 40.0
    img = _img(6, h, w)
    t = lqr_tpu_torch.Carver(img, rigidity=rigidity, device="cpu")
    t.set_energy_function(nrg)
    _dress(t, h, w, 7)
    t.resize(w - n, h)

    pres, disc, rigm, aux = _masks(7, h, w)
    B = (place_mask_numpy(pres, h, w, w // 4, h // 4) * np.float32(1.0)
         + place_mask_numpy(disc, h, w, w // 2, h // 2) * np.float32(-0.8))
    R = place_mask_numpy(rigm, h, w, 0, 0) * np.float32(rigidity)
    vs = native.carve(img, n, bias=B, rig=R, nrg=int(nrg))
    np.testing.assert_array_equal(t.vmap_dump().data, vs)
    np.testing.assert_array_equal(t.get_image(),
                                  native.materialize(img, vs, w - n))
    np.testing.assert_array_equal(t.get_aux(0),
                                  native.materialize(aux, vs, w - n))


@pytest.mark.parametrize("offsets", [((-5, -4), (-7, 3)),
                                     ((50, 25), (60, -10)),
                                     ((-30, 20), (10, 30))])
def test_clipped_masks_match_jax(offsets):
    """bias_add + rigmask_add at offsets that clip the masks at every edge:
    the port's placement (ops.place_mask) gives lqr_tpu.Carver's
    maps and pixels."""
    h, w = 30, 64
    img = _img(8, h, w)
    pres, disc, rigm, _ = _masks(9, h, w)
    (bx, by), (rx, ry) = offsets
    j, t = _pair(img, rigidity=25.0)
    for c in (j, t):
        c.set_dump_vmaps(True)
        c.bias_add(pres, 1000.0, bx, by)
        c.bias_add(disc, -800.0, rx, by)
        c.rigmask_add(rigm, rx, ry)
        c.resize(w - 20, h - 6)
    _same(j, t, n_aux=0)
