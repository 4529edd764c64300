"""The port's render layer (lqr_tpu_torch.render, device="cpu") against
lqr_tpu.render (use_pallas=False) on the same layered images: every layer's
pixels, offsets and flags equal (tolerance 0) over output target x scaleback
with preservation, discard and rigidity masks, aux layers and seam maps;
an ID-based discard mask; multipass enlargement; a two-axis resize in VERT
order; the interactive cycle."""

import numpy as np
import pytest
import torch

from lqr_tpu import config as jconfig, image_model as jim, render as jrender
from lqr_tpu_torch import config as tconfig, image_model as tim
from lqr_tpu_torch import render as trender
from conftest import random_image

torch.set_num_threads(1)

H, W = 24, 40

SIDES = {
    "jax": (jconfig, jim, jrender, {"use_pallas": False}),
    "torch": (tconfig, tim, trender, {"device": "cpu"}),
}


def _base(seed=5):
    return random_image(np.random.default_rng(seed), H, W, 3)


def _masks():
    pres = np.zeros((10, 14, 4), np.uint8)
    pres[2:8, 3:11] = [0, 255, 0, 255]
    disc = np.zeros((H, W, 3), np.uint8)
    disc[6:18, 22:30] = 255
    rig = np.random.default_rng(7).integers(0, 256, (H, 16, 1)).astype(
        np.uint8)
    return pres, disc, rig


def _image(side, with_masks=True):
    _, im, _, _ = SIDES[side]
    img = im.Image.from_array(_base(), "Background")
    if with_masks:
        pres, disc, rig = _masks()
        img.add_layer(im.Layer("pres", pres, x_off=4, y_off=3,
                               visible=False))
        img.add_layer(im.Layer("disc", disc, visible=False))
        img.add_layer(im.Layer("rig", rig, x_off=2, visible=False,
                               alpha_lock=True))
    return img


def _render(side, cfg_kw, img=None, colors=None):
    cfgm, _, rend, dev = SIDES[side]
    img = _image(side) if img is None else img
    kw = dict(cfg_kw)
    for k, enum_name in (("output_target", "OutputTarget"),
                         ("scaleback_mode", "ScalebackMode"),
                         ("res_order", "ResizeOrder")):
        if k in kw:
            kw[k] = getattr(cfgm, enum_name)(int(kw[k]))
    cfg = cfgm.LqrConfig(**kw)
    cd = rend.init_carver(img, cfg, **dev)
    colors = cfgm.SeamColors() if colors is None else cfgm.SeamColors(
        *colors)
    assert rend.render_noninteractive(cfg, colors, cd)
    return img, cd


def _same_layers(a, b):
    assert (a.width, a.height, a.active) == (b.width, b.height, b.active)
    assert [l.name for l in a.layers] == [l.name for l in b.layers]
    for la, lb in zip(a.layers, b.layers):
        assert (la.x_off, la.y_off, la.visible, la.alpha_lock, la.opacity) \
            == (lb.x_off, lb.y_off, lb.visible, lb.alpha_lock, lb.opacity), \
            la.name
        assert la.pixels.dtype == lb.pixels.dtype == np.uint8
        np.testing.assert_array_equal(lb.pixels, la.pixels, err_msg=la.name)
        assert (la.mask is None) == (lb.mask is None)
    np.testing.assert_array_equal(b.flatten_visible(), a.flatten_visible())


def _same_render(cfg_kw, **kw):
    j_in, jcd = _render("jax", cfg_kw, **kw)
    t_in, tcd = _render("torch", cfg_kw, **kw)
    _same_layers(jcd.image, tcd.image)
    _same_layers(j_in, t_in)          # the caller's image, NEW_IMAGE too
    assert jcd.layer_name == tcd.layer_name
    return tcd


@pytest.mark.parametrize("scaleback", [None, 0, 1, 2, 3],
                         ids=["none", "lqrback", "std", "stdw", "stdh"])
@pytest.mark.parametrize("target", [0, 1, 2],
                         ids=["same", "new-layer", "new-image"])
def test_render_matrix_matches_jax(target, scaleback):
    cfg = dict(new_width=31, new_height=H, pres_layer="pres",
               disc_layer="disc", rigmask_layer="rig", rigidity=20.0,
               output_target=target, output_seams=True)
    if scaleback is not None:
        cfg.update(scaleback=True, scaleback_mode=scaleback)
    _same_render(cfg, colors=(0.9, 0.1, 0.0, 0.1, 0.0, 0.6))


def test_render_id_based_disc_mask_matches_jax_and_name():
    """An int layer ID resolves like the layer's name, in both packages and
    through NEW_IMAGE (the copied aux layer keeps its ID)."""
    out = {}
    for side in SIDES:
        for by in ("name", "id"):
            img = _image(side)
            disc = img.layer_by_name("disc")
            ref = disc.layer_id if by == "id" else "disc"
            _, cd = _render(side, dict(new_width=30, new_height=H,
                                       disc_layer=ref, output_target=2),
                            img=img)
            out[side, by] = cd.image.layer_by_name(cd.layer_name).pixels
    for key, px in out.items():
        np.testing.assert_array_equal(px, out["jax", "name"], err_msg=key)


def test_render_multipass_enlarge_one_seam_layer_per_pass():
    tcd = _same_render(dict(new_width=int(W * 2.4), new_height=H,
                            pres_layer="pres", output_seams=True))
    n = sum(l.name == "Background seam map" for l in tcd.image.layers)
    assert n == 3          # 40 -> 60 -> 90 -> 96 at enl_step 1.5


def test_render_two_axis_vert_order_and_canvas_kept():
    _same_render(dict(new_width=33, new_height=19, res_order=1,
                      resize_canvas=False, resize_aux_layers=False,
                      output_seams=True))


def test_render_interactive_cycle_matches_jax():
    state = {}
    for side, (cfgm, im, rend, dev) in SIDES.items():
        img = im.Image.from_array(_base(), "Background")
        cfg = cfgm.LqrConfig(new_width=W, new_height=H)
        cd = rend.init_carver(img, cfg, interactive=True, **dev)
        assert rend.render_interactive(cfg, cd, 30, H)
        assert rend.render_interactive(cfg, cd, 35, H)
        assert rend.render_dump_vmap(cd, cfgm.SeamColors())
        info = (cd.ref_w, cd.ref_h, cd.orientation, cd.depth)
        assert rend.render_flatten(cd)
        assert rend.render_interactive(cfg, cd, 33, 20)
        state[side] = (cd.image, info, (cd.ref_w, cd.depth))
        img.remove_layer(cd.layer_name)
        assert not rend.revalidate_interactive(cd)
    _same_layers(state["jax"][0], state["torch"][0])
    assert state["jax"][1:] == state["torch"][1:]
    assert state["torch"][1] == (W, H, 0, 10)


def test_render_progress_events_match_jax():
    """A progress object handed to init_carver sees the same events."""
    from lqr_tpu import progress as jprog
    from lqr_tpu_torch import progress as tprog
    events = {}
    for side, prog in (("jax", jprog), ("torch", tprog)):
        cfgm, im, rend, dev = SIDES[side]
        p = prog.CollectingProgress()
        img = im.Image.from_array(_base(), "Background")
        cfg = cfgm.LqrConfig(new_width=30, new_height=20)
        cd = rend.init_carver(img, cfg, progress=p, **dev)
        assert rend.render_noninteractive(cfg, cfgm.SeamColors(), cd)
        events[side] = p.events
    assert events["torch"] == events["jax"]
    assert events["torch"][0] == ("init", "Resizing width...")
    assert events["torch"][-1] == ("end",)
