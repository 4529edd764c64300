"""The port's mask authoring and preview compositor (lqr_tpu_torch.masks,
lqr_tpu_torch.preview) against lqr_tpu's on the same seeded images,
tolerance 0: the paint colours, the new-layer law, the edit session's
paint / ok / cancel paths with every layer's pixels and flags equal, a
painted mask that drives both Carvers to the same image, and the preview
pixbuf byte for byte (factor law, 50 % composite, offset overlay)."""

import importlib

import numpy as np
import pytest
import torch

from lqr_tpu import config as jconfig, image_model as jim
from lqr_tpu import masks as jmasks, render as jrender
from lqr_tpu_torch import config as tconfig, image_model as tim
from lqr_tpu_torch import masks as tmasks
from lqr_tpu_torch import render as trender
from test_torch_render import _same_layers

torch.set_num_threads(1)

# both packages export a function ``preview`` that shadows the module
jpreview = importlib.import_module("lqr_tpu.preview")
tpreview = importlib.import_module("lqr_tpu_torch.preview")

SIDES = {
    "jax": (jconfig, jim, jmasks, jpreview, jrender, {"use_pallas": False}),
    "torch": (tconfig, tim, tmasks, tpreview, trender, {"device": "cpu"}),
}


def _both(fn):
    """fn(side modules...) on each side; returns {side: result}."""
    return {side: fn(*mods) for side, mods in SIDES.items()}


def _rgb_image(im, px):
    img = im.Image.from_array(px)
    img.active_layer.translate(3, 5)
    return img


def test_colour_from_type_rgb(make_image):
    px = make_image(h=20, w=30)
    got = _both(lambda cfg, im, m, *_: [
        m.colour_from_type(_rgb_image(im, px), t)
        for t in cfg.AuxLayerType])
    assert got["torch"] == got["jax"] == [
        tmasks.PRES_COLOR, tmasks.DISC_COLOR, tmasks.RIGMASK_COLOR]
    assert (tmasks.PRES_COLOR, tmasks.DISC_COLOR, tmasks.RIGMASK_COLOR,
            tmasks.GRAY_COLOR) == (jmasks.PRES_COLOR, jmasks.DISC_COLOR,
                                   jmasks.RIGMASK_COLOR, jmasks.GRAY_COLOR)


def test_colour_from_type_gray(make_image):
    px = make_image(c=1)
    got = _both(lambda cfg, im, m, *_: [
        m.colour_from_type(im.Image.from_array(px), t)
        for t in cfg.AuxLayerType])
    assert got["torch"] == got["jax"] == [tmasks.GRAY_COLOR] * 3


@pytest.mark.parametrize("c", [3, 1])
def test_new_mask_layer_law(make_image, c):
    """layers_combo.c:186-203: transparent, typed+alpha, active layer's
    geometry, 50% opacity, inserted on top."""
    px = make_image(h=20, w=30, c=c)

    def run(cfg, im, m, *_):
        img = _rgb_image(im, px)
        mask = m.new_mask_layer(img, cfg.AuxLayerType.DISC)
        assert img.layers[0] is mask
        return img

    got = _both(run)
    _same_layers(got["jax"], got["torch"])
    m = got["torch"].layers[0]
    assert m.bpp == (4 if c == 3 else 2)
    assert (m.height, m.width, m.x_off, m.y_off) == (20, 30, 3, 5)
    assert m.opacity == 50.0 and not m.pixels.any()
    assert m.name == "discard mask layer"


@pytest.mark.parametrize("c", [3, 1])
def test_edit_session_paint_and_ok(make_image, c):
    """paint's rounding: each channel u8(round(255 * v)), alpha the max of
    the old one and round(255 * strength * coverage) on covered pixels."""
    px = make_image(h=20, w=30, c=c)
    rng = np.random.default_rng(11)
    cov = rng.random((20, 30))
    cov[cov < 0.3] = 0.0
    region = np.zeros((20, 30), bool)
    region[4:10, 6:12] = True

    def run(cfg, im, m, *_):
        img = _rgb_image(im, px)
        prev = img.active
        with m.edit_mask(img, cfg.AuxLayerType.RIGMASK, name="__r") as s:
            s.paint(region)
            s.paint(cov, strength=0.7)
            s.paint(cov * 1.5 - 0.2, strength=0.4)   # clipped to [0, 1]
        assert img.active == prev
        return img

    got = _both(run)
    _same_layers(got["jax"], got["torch"])
    m = got["torch"].layer_by_name("__r")
    want = [0, 0, 255, 255] if c == 3 else [85, 255]
    assert (m.pixels[5, 7] == want).all()


def test_edit_session_cancel_removes_new_layer(make_image):
    """cancel_work_on_aux_layer (main.c:600-613)."""
    px = make_image(h=20, w=30)

    def run(cfg, im, m, *_):
        img = _rgb_image(im, px)
        s = m.edit_mask(img, cfg.AuxLayerType.PRES, name="__p")
        s.paint(np.ones((20, 30)))
        s.cancel()
        assert img.layer_by_name("__p") is None
        assert img.active == "Background"
        return img

    got = _both(run)
    _same_layers(got["jax"], got["torch"])


def test_edit_session_exception_cancels(make_image):
    px = make_image(h=20, w=30)

    def run(cfg, im, m, *_):
        img = _rgb_image(im, px)
        with pytest.raises(RuntimeError):
            with m.edit_mask(img, cfg.AuxLayerType.PRES, name="__p") as s:
                s.paint(np.ones((20, 30)))
                raise RuntimeError("boom")
        assert img.layer_by_name("__p") is None
        with pytest.raises(Exception, match="already closed"):
            s.paint(np.ones((20, 30)))
        return img

    got = _both(run)
    _same_layers(got["jax"], got["torch"])


def test_edit_existing_layer_kept_on_cancel(make_image):
    px = make_image(h=20, w=30)

    def run(cfg, im, m, *_):
        img = _rgb_image(im, px)
        mask = m.new_mask_layer(img, cfg.AuxLayerType.RIGMASK, name="__r")
        mask.opacity = 80.0
        s = m.edit_mask(img, cfg.AuxLayerType.RIGMASK, layer=mask)
        assert mask.opacity == 50.0 and img.active == "__r"
        s.paint(np.eye(20, 30))
        s.cancel()                          # not new -> kept
        assert img.layer_by_name("__r") is mask
        return img

    got = _both(run)
    _same_layers(got["jax"], got["torch"])
    assert got["torch"].layer_by_name("__r").opacity == 80.0


def test_painted_mask_drives_both_carvers(make_image):
    """An authored discard mask biases seams into its area: the port's
    Carver (CPU) gives JAX's image."""
    px = make_image(h=24, w=32)
    region = np.zeros((24, 32), bool)
    region[:, 10:14] = True

    def run(cfg, im, m, prev, rend, dev):
        img = im.Image.from_array(px)
        with m.edit_mask(img, cfg.AuxLayerType.DISC, name="__d") as s:
            s.paint(region)
        c = cfg.LqrConfig(new_width=28, new_height=24, disc_layer="__d",
                          resize_aux_layers=False)
        cd = rend.init_carver(img, c, **dev)
        assert rend.render_noninteractive(c, cfg.SeamColors(), cd)
        return cd.image

    got = _both(run)
    _same_layers(got["jax"], got["torch"])
    assert got["torch"].layer_by_name("Background").width == 28


def _preview_both(build, **kw):
    got = _both(lambda cfg, im, m, prev, *_: prev.preview(
        *build(cfg, im), **kw))
    assert got["torch"].dtype == got["jax"].dtype == np.uint8
    np.testing.assert_array_equal(got["torch"], got["jax"])
    return got["torch"]


@pytest.mark.parametrize("hw", [(20, 30), (400, 900), (230, 310), (37, 601)])
def test_preview_factor_law(make_image, hw):
    """interface.c:297-310: factor = max(w/300, h/200, 1); the thumbnail
    of an RGBA layer over the checkerboard."""
    h, w = hw
    px = make_image(h=h, w=w, c=4, smooth=False)
    out = _preview_both(lambda cfg, im: (im.Image.from_array(px),
                                         cfg.LqrConfig()))
    f = max(w / tpreview.PREVIEW_MAX_WIDTH, h / tpreview.PREVIEW_MAX_HEIGHT,
            1.0)
    assert out.shape == (int(h / f), int(w / f), 4)
    assert (out[:, :, 3] == 255).all()


@pytest.mark.parametrize("on", [True, False])
def test_preview_composites_masks_at_50pct(make_image, on):
    """preview.c:133-185: every overlay composited at 127/255, or left out
    when its activation flag is off."""
    base = make_image(h=20, w=30)
    rng = np.random.default_rng(3)
    masks = {n: rng.integers(0, 256, (20, 30, 4)).astype(np.uint8)
             for n in ("__pres", "__disc", "__rig")}

    def build(cfg, im):
        img = im.Image.from_array(base)
        for n, mpx in masks.items():
            img.add_layer(im.Layer(n, mpx, visible=False), 0)
        img.active = "Background"
        return img, cfg.LqrConfig(pres_layer="__pres", disc_layer="__disc",
                                  rigmask_layer="__rig")

    out = _preview_both(build, pres_on=on, disc_on=on, rigmask_on=on)
    assert np.array_equal(out[:, :, :3], base) != on


def test_preview_offset_overlay(make_image):
    """Overlays at offsets past the preview's edges are clipped; an
    overlay on a downscaled preview is placed at its truncated offset."""
    base = make_image(h=230, w=610)
    pres = np.zeros((40, 50, 4), np.uint8)
    pres[:, :] = [0, 255, 0, 255]
    gray = make_image(h=30, w=90, c=2)

    def build(cfg, im):
        img = im.Image.from_array(base)
        img.add_layer(im.Layer("__pres", pres, x_off=590, y_off=215,
                               visible=False), 0)
        img.add_layer(im.Layer("__rig", gray, x_off=-41, y_off=17,
                               visible=False), 0)
        img.active = "Background"
        return img, cfg.LqrConfig(pres_layer="__pres", rigmask_layer="__rig")

    out = _preview_both(build)
    assert out.shape == (113, 300, 4)
    assert out[-1, -1, 1] > out[-1, -1, 0]      # green tint in the corner
