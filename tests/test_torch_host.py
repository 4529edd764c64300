"""The port's host modules against their lqr_tpu originals on the same
seeded inputs (tolerance 0): config enums and defaults, the image model,
the seam-map colouring, size parsing and linked coordinates, the GAP
schedule, the auto-size guess, i18n and the settings store (in both
directions)."""

import dataclasses

import numpy as np
import pytest
import torch

from lqr_tpu import (config as jconfig, gap as jgap, guess as jguess,
                     i18n as ji18n, image_model as jim,
                     settings as jsettings, sizeentry as jsize,
                     vmap_render as jvr)
from lqr_tpu_torch import (config as tconfig, gap as tgap, guess as tguess,
                           i18n as ti18n, image_model as tim,
                           settings as tsettings, sizeentry as tsize,
                           vmap_render as tvr)
from lqr_tpu_torch.errors import LqrConfigError

torch.set_num_threads(1)

ENUMS = ["EnergyFunc", "ResizeOrder", "OutputTarget", "ScalebackMode",
         "MaskBehavior", "AuxLayerType"]


@pytest.mark.parametrize("name", ENUMS)
def test_enum_members_and_values(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert [(m.name, int(m)) for m in t] == [(m.name, int(m)) for m in j]


def test_config_records_and_constants():
    for rec in ("LqrConfig", "SeamColors"):
        j, t = getattr(jconfig, rec)(), getattr(tconfig, rec)()
        jf = [(f.name, getattr(j, f.name)) for f in dataclasses.fields(j)]
        tf = [(f.name, getattr(t, f.name)) for f in dataclasses.fields(t)]
        assert tf == jf
    t = tconfig.LqrConfig()
    assert t.replace(new_width=7).new_width == 7 and t.new_width == 100
    for k in ("DEFAULT_SIDE_SWITCH_FREQUENCY", "MAX_DELTA_X", "MAX_RIGIDITY",
              "MAX_COEFF", "MIN_ENL_STEP", "MAX_ENL_STEP"):
        assert getattr(tconfig, k) == getattr(jconfig, k), k
    for ref in ("mask", 0, 3, "", -1, None, True):
        assert tconfig.layer_ref_set(ref) == jconfig.layer_ref_set(ref)


def _layers(im, rng):
    img = im.Image(width=40, height=30)
    img.add_layer(im.Layer("bg", rng.integers(0, 256, (30, 40, 3))))
    img.add_layer(im.Layer("ga", rng.integers(0, 256, (20, 25, 2)),
                           x_off=-5, y_off=12, opacity=60.0))
    img.add_layer(im.Layer("rgba", rng.integers(0, 256, (16, 18, 4)),
                           x_off=30, y_off=-3))
    img.add_layer(im.Layer("hidden", np.full((30, 40, 1), 9), visible=False))
    m = rng.integers(0, 256, (30, 40)).astype(np.uint8)
    img.add_layer(im.Layer("masked", rng.integers(0, 256, (30, 40, 3)),
                           mask=m, opacity=50.0))
    return img


def _same_image(a, b):
    assert (a.width, a.height) == (b.width, b.height)
    for la, lb in zip(a.layers, b.layers, strict=True):
        assert (la.name, la.x_off, la.y_off) == (lb.name, lb.x_off, lb.y_off)
        np.testing.assert_array_equal(lb.pixels, la.pixels)
    np.testing.assert_array_equal(b.flatten_visible(), a.flatten_visible())


@pytest.mark.parametrize("op", ["flatten", "resize_canvas", "layer_ops"])
def test_image_model(op):
    j, t = (_layers(im, np.random.default_rng(3)) for im in (jim, tim))
    for img in (j, t):
        if op == "resize_canvas":
            img.resize_canvas(52, 26, 7, -4)
            img.resize_layer_to_image_size(img.layer_by_name("rgba"))
        elif op == "layer_ops":
            m = img.layer_by_name("masked")
            m.apply_mask()
            img.layer_by_name("bg").resize(44, 28, -3, 5, fill=17)
            img.layer_by_name("ga").scale(31, 17)
            img.layer_by_name("hidden").add_alpha()
            img.remove_layer("rgba")
    _same_image(j, t)
    ids = [l.layer_id for l in t.layers]
    assert len(set(ids)) == len(ids)
    assert t.layer_ref(ids[1]) is t.layers[1]
    assert t.layer_ref(t.layers[0].name) is t.layers[0]


@pytest.mark.parametrize("hw", [(17, 23), (64, 96), (30, 40), (5, 1)])
def test_bilinear_scale(hw):
    src = np.random.default_rng(4).integers(0, 256, (30, 40, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(tim.bilinear_scale(src, hw[1], hw[0]),
                                  jim.bilinear_scale(src, hw[1], hw[0]))


def test_render_vmap():
    rng = np.random.default_rng(5)
    vs = rng.integers(0, 13, (20, 31)).astype(np.int32)
    for colors in (None, (0.3, 0.7, 0.1, 0.9, 0.2, 0.5)):
        jc = colors and jconfig.SeamColors(*colors)
        tc = colors and tconfig.SeamColors(*colors)
        np.testing.assert_array_equal(tvr.render_vmap(vs, 12, tc),
                                      jvr.render_vmap(vs, 12, jc))


@pytest.mark.parametrize("spec", ["40", " 75% ", "150%", "12.5%", "0%",
                                  "33.3%"])
def test_parse_size(spec):
    assert tsize.parse_size(spec, 97) == jsize.parse_size(spec, 97)


def test_parse_size_refuses_like_jax():
    for spec in ("abc", "12x", "%"):
        with pytest.raises(LqrConfigError):
            tsize.parse_size(spec, 50)


def test_coordinates_chain():
    def run(m):
        c = m.Coordinates(640, 480, chain_active=True)
        out = []
        c.set_width(50, m.Unit.PERCENT)
        out.append((c.width, c.height, c.x.value))
        c.set_height(2.5, m.Unit.INCH)
        out.append((c.width, c.height, c.y.value))
        c.chain_constrains_ratio = False
        c.set_width(300, m.Unit.PIXEL)
        out.append((c.width, c.height))
        c.reset()
        out.append((c.width, c.height))
        return out
    assert run(tsize) == run(jsize)


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_gap_schedule(n):
    a = dict(new_width=100, new_height=200, rigidity=0.0, delta_x=1,
             enl_step=1.2, pres_coeff=3)
    b = dict(new_width=113, new_height=100, rigidity=10.0, delta_x=3,
             enl_step=1.9, pres_coeff=1000, nrg_func=5, output_seams=True)
    j = list(jgap.schedule(jconfig.LqrConfig(**a), jconfig.LqrConfig(**b), n))
    t = list(tgap.schedule(tconfig.LqrConfig(**a), tconfig.LqrConfig(**b), n))
    assert [dataclasses.astuple(x) for x in t] == [
        dataclasses.astuple(x) for x in j]


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_guess_new_size(c):
    rng = np.random.default_rng(6 + c)
    mask = rng.integers(0, 256, (14, 19, c)).astype(np.uint8)
    for d in (tguess.HOR, tguess.VERT):
        for off in ((0, 0), (5, -3), (-7, 9), (40, 0)):
            assert (tguess.guess_new_size(mask, 30, 22, d, *off)
                    == jguess.guess_new_size(mask, 30, 22, d, *off))


def test_i18n():
    assert ti18n.available_languages() == ji18n.available_languages()
    assert ti18n.N_("Resizing width...") == "Resizing width..."


def test_settings_round_trip_both_ways(tmp_path):
    cfg = dict(new_width=77, new_height=55, pres_layer="p", disc_layer="d",
               rigmask_layer="", rigidity=12.5, nrg_func=4, res_order=1,
               output_target=2, scaleback=True, scaleback_mode=3,
               mask_behavior=1, enl_step=1.7)
    colors = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)
    got = []
    for writer, reader in ((jsettings, tsettings), (tsettings, jsettings),
                           (tsettings, tsettings)):
        wc = writer.__name__.split(".")[0] == "lqr_tpu"
        cm = jconfig if wc else tconfig
        path = tmp_path / f"{len(got)}.json"
        stored = writer.save_vals(writer.SettingsStore(path),
                                  cm.LqrConfig(**cfg), cm.SeamColors(*colors),
                                  disc_status=False)
        back, col = reader.retrieve_vals(reader.SettingsStore(path))
        assert dataclasses.astuple(back) == dataclasses.astuple(stored)
        assert dataclasses.astuple(col) == colors
        got.append(path.read_text())
        ui = writer.UIVals(chain_active=True, last_used_width=9,
                           last_layer_name="x")
        writer.save_ui_vals(writer.SettingsStore(path), ui)
        assert dataclasses.astuple(reader.retrieve_ui_vals(
            reader.SettingsStore(path))) == dataclasses.astuple(ui)
    assert got[0] == got[1] == got[2]
    img = tim.Image.from_array(np.zeros((4, 4, 3), np.uint8))
    img.add_layer(tim.Layer("p", np.zeros((4, 4, 1), np.uint8)))
    c, _ = tsettings.retrieve_vals_use_aux_layers_names(
        tsettings.SettingsStore(tmp_path / "0.json"), img)
    assert (c.pres_layer, c.disc_layer) == ("p", "")
