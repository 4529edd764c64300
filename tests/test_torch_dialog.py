"""The port's headless main dialog and run-mode dispatch
(lqr_tpu_torch.dialog, device="cpu") against lqr_tpu.dialog
(use_pallas=False) on the same seeded images, tolerance 0: the dialog's
size, mask and refresh laws give equal configs; run_plugin in its three
modes gives equal layer stacks and equal settings records; a store written
by either package replays in the other to the same pixels."""

import json

import numpy as np
import pytest
import torch

from lqr_tpu import config as jconfig, dialog as jdialog
from lqr_tpu import errors as jerrors, image_model as jim
from lqr_tpu import settings as jsettings, sizeentry as jsize
from lqr_tpu_torch import config as tconfig, dialog as tdialog
from lqr_tpu_torch import errors as terrors, image_model as tim
from lqr_tpu_torch import settings as tsettings, sizeentry as tsize
from test_torch_render import _same_layers

torch.set_num_threads(1)

SIDES = {
    "jax": (jconfig, jim, jdialog, jsettings, jsize, jerrors,
            {"use_pallas": False}),
    "torch": (tconfig, tim, tdialog, tsettings, tsize, terrors,
              {"device": "cpu"}),
}


class Side:
    def __init__(self, name):
        (self.cfg, self.im, self.dlg, self.st, self.size, self.err,
         self.dev) = SIDES[name]
        self.name = name

    def image(self, px, *masks):
        img = self.im.Image.from_array(px)
        for name, mpx, kw in masks:
            img.add_layer(self.im.Layer(name, mpx, **kw), 0)
        img.active = "Background"
        return img

    def store(self, tmp_path):
        return self.st.SettingsStore(tmp_path / f"{self.name}.json")

    def run(self, img, mode, **kw):
        return self.dlg.run_plugin(img, self.dlg.RunMode(mode), **kw,
                                   **self.dev)


def _both(fn):
    return {name: fn(Side(name)) for name in SIDES}


def _stored(store):
    return json.loads(store.path.read_text()) if store.path.exists() else {}


def _cfg_dict(cfg):
    return None if cfg is None else {
        k: (int(v) if isinstance(v, int) else v)
        for k, v in vars(cfg).items()}


def test_size_section_chain(make_image):
    px = make_image(h=20, w=32)

    def run(s):
        d = s.dlg.MainDialog(s.image(px))
        d.size.chain_active = True
        seen = []
        d.set_new_size(width=16)
        seen.append((d.cfg.new_width, d.cfg.new_height))
        d.reset_size_to_image()
        seen.append((d.cfg.new_width, d.cfg.new_height))
        d.set_new_size(width=50, unit=s.size.Unit.PERCENT)
        seen.append((d.cfg.new_width, d.cfg.new_height))
        d.size.chain_active = False
        d.set_new_size(width=27, height=13)
        seen.append(_cfg_dict(d.cfg))
        return seen

    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == [(16, 10), (32, 20), (16, 10)]


def test_disc_warning_tracks_size(make_image):
    """interface.c:857-902: warn iff the first scaling direction
    enlarges while a discard mask is selected."""
    px = make_image(h=20, w=32)

    def run(s):
        img = s.image(px, ("d", np.zeros((20, 32, 4), np.uint8), {}))
        d = s.dlg.MainDialog(img, s.cfg.LqrConfig(
            selected_layer_name="Background"))
        d.select_mask(s.cfg.AuxLayerType.DISC, "d")
        seen = []
        for w, h in ((40, 20), (20, 20), (32, 30)):
            d.set_new_size(width=w, height=h)
            seen.append(d.disc_warning())
        d.cfg = d.cfg.replace(res_order=s.cfg.ResizeOrder.VERT,
                              new_width=40, new_height=10)
        seen.append(d.disc_warning())
        return seen

    got = _both(run)
    assert got["torch"] == got["jax"] == [True, False, True, False]


def test_mask_eligibility_and_refresh(make_image):
    px = make_image(h=20, w=32)

    def run(s):
        img = s.image(px, ("m1", np.zeros((20, 32, 4), np.uint8), {}))
        d = s.dlg.MainDialog(img)
        seen = [d.feature_masks_available(), d.eligible_mask_layers()]
        d.select_mask(s.cfg.AuxLayerType.PRES, "m1")
        with pytest.raises(s.err.LqrError, match="not selectable"):
            d.select_mask(s.cfg.AuxLayerType.DISC, "Background")
        img.remove_layer("m1")
        d.refresh()
        seen += [d.cfg.pres_layer, d.feature_masks_available()]
        return seen

    got = _both(run)
    assert got["torch"] == got["jax"] == [True, ["m1"], "", False]


def test_new_mask_round_trip_and_reset(make_image):
    px = make_image(h=20, w=32)

    def run(s):
        img = s.image(px)
        d = s.dlg.MainDialog(img)
        with d.new_mask(s.cfg.AuxLayerType.DISC, name="dm") as m:
            m.paint(np.tri(20, 32))
        with d.edit_mask(s.cfg.AuxLayerType.DISC) as m:
            m.paint(np.ones((20, 32)), strength=0.5)
        picked = d.cfg.disc_layer
        d.set_new_size(width=10)
        d.reset()                                 # RESPONSE_RESET
        assert d.cfg == s.cfg.LqrConfig(selected_layer_name="Background",
                                        new_width=32, new_height=20)
        assert d.colors == s.cfg.SeamColors()
        return img, picked

    got = _both(run)
    _same_layers(got["jax"][0], got["torch"][0])
    assert got["jax"][1] == got["torch"][1] == "dm"


def _render_both(tmp_path, make_stack, mode, cfg=None, dialog=None):
    """run_plugin on each side on its own store; make_stack(s, store),
    cfg(s) and dialog(s) build that side's image, config and dialog
    callback. Returns the port's (image, cfg, stored json)."""
    def run(s):
        store = s.store(tmp_path)
        img = make_stack(s, store)
        out, got = s.run(img, mode, store=store,
                         cfg=None if cfg is None else cfg(s),
                         dialog_driver=None if dialog is None else dialog(s))
        return out, got, _stored(store)

    got = _both(run)
    if got["jax"][1] is not None:
        _same_layers(got["jax"][0], got["torch"][0])
    assert _cfg_dict(got["torch"][1]) == _cfg_dict(got["jax"][1])
    assert got["torch"][2] == got["jax"][2]
    return got["torch"]


def test_run_plugin_noninteractive(tmp_path, make_image):
    px = make_image(h=20, w=32)
    out, cfg, _ = _render_both(
        tmp_path, lambda s, st: s.image(px), 1,
        cfg=lambda s: s.cfg.LqrConfig(new_width=28, new_height=20))
    assert out.layer_by_name("Background").width == 28
    for name in SIDES:
        s = Side(name)
        with pytest.raises(s.err.LqrError, match="full config"):
            s.run(s.image(px), 1)


def test_run_plugin_with_last_vals(tmp_path, make_image):
    px = make_image(h=20, w=32)

    def stack(s, store):
        s.st.save_vals(store, s.cfg.LqrConfig(new_width=30, new_height=20,
                                              pres_layer="pm", rigidity=5.0))
        return s.image(px, ("pm", np.full((20, 32, 4), 255, np.uint8),
                            {"visible": False}))

    out, cfg, _ = _render_both(tmp_path, stack, 2)
    assert cfg.pres_layer == "pm"                 # resolved by name
    assert out.layer_by_name("Background").width == 30


def test_run_plugin_interactive_state_machine(tmp_path, make_image):
    """RESET loops back with defaults; WORK_ON_AUX_LAYER paints masks and
    loops; OK renders and persists (main.c:327-385, 438-441)."""
    px = make_image(h=20, w=32)
    region = np.zeros((20, 32))
    region[5:15, 8:20] = 1.0

    def dialog(s):
        calls = []

        def respond(dialog):
            calls.append(1)
            if len(calls) == 1:
                dialog.set_new_size(width=5, height=5)
                return s.dlg.Response.RESET
            if len(calls) == 2:
                with dialog.new_mask(s.cfg.AuxLayerType.PRES, name="pm") as m:
                    m.paint(region)
                with dialog.new_mask(s.cfg.AuxLayerType.RIGMASK,
                                     name="rm") as m:
                    m.paint(np.tri(20, 32))
                return s.dlg.Response.WORK_ON_AUX_LAYER
            dialog.set_new_size(width=24, height=20)
            return s.dlg.Response.OK
        return respond

    out, cfg, stored = _render_both(tmp_path, lambda s, st: s.image(px), 0,
                                    dialog=dialog)
    assert cfg.new_width == 24                    # RESET dropped the 5x5
    assert (cfg.pres_layer, cfg.rigmask_layer) == ("pm", "rm")
    assert out.layer_by_name("Background").width == 24
    assert stored["plug_in_lqr"]["new_width"] == 24
    assert stored["plug_in_lqr"]["pres_layer_name"] == "pm"


def test_run_plugin_interactive_cancel(tmp_path, make_image):
    px = make_image(h=20, w=32)
    out, cfg, stored = _render_both(tmp_path, lambda s, st: s.image(px), 0,
                                    dialog=lambda s: lambda d: 1)
    assert cfg is None and stored == {}           # nothing persisted
    for name in SIDES:
        s = Side(name)
        with pytest.raises(s.err.LqrError, match="requires a dialog"):
            s.run(s.image(px), 0, store=s.store(tmp_path))
        with pytest.raises(s.err.LqrError, match="fatal"):
            s.run(s.image(px), 0, store=s.store(tmp_path),
                  dialog_driver=lambda d: 5)


def test_ui_vals_roundtrip(tmp_path, make_image):
    """PlugInUIVals persistence (main.h:54-71; save main.c:495, restore
    main.c:504): chain state, mask statuses, last-used size and expander
    flags are stored alike, and a fresh dialog restores them."""
    px = make_image(h=20, w=32)

    def respond(dialog):
        assert not dialog.last_values_available()
        dialog.size.chain_active = True
        dialog.seams_control_expanded = True
        dialog.set_new_size(width=24)             # chain: height follows
        return 0

    _, _, stored = _render_both(tmp_path, lambda s, st: s.image(px), 0,
                                dialog=lambda s: respond)
    ui = stored["plug_in_lqr_ui"]
    assert ui["chain_active"] and ui["seams_control_expanded"]
    assert (ui["last_used_width"], ui["last_used_height"]) == (24, 15)

    def restore(s):
        d = s.dlg.MainDialog(s.image(px),
                             ui=s.st.retrieve_ui_vals(s.store(tmp_path)))
        seen = [d.size.chain_active, d.seams_control_expanded,
                d.last_values_available()]
        d.size.chain_active = False
        d.set_new_size(width=30, height=18)
        d.use_last_values()                       # interface.c:963-975
        return seen + [(d.cfg.new_width, d.cfg.new_height)]

    got = _both(restore)
    assert got["torch"] == got["jax"] == [True, True, True, (24, 15)]


def test_ui_vals_statuses_follow_masks(tmp_path, make_image):
    """AUX_LAYER_STATUS bookkeeping (main.c:406-409)."""
    px = make_image(h=20, w=32)
    m = np.zeros((20, 32, 3), np.uint8)
    m[:, 8:12] = 255

    def dialog(s):
        def respond(dialog):
            dialog.select_mask(s.cfg.AuxLayerType.DISC, "disc mask")
            dialog.set_new_size(width=26, height=20)
            return s.dlg.Response.OK
        return respond

    _, _, stored = _render_both(
        tmp_path, lambda s, st: s.image(px, ("disc mask", m, {})), 0,
        dialog=dialog)
    ui = stored["plug_in_lqr_ui"]
    assert ui["disc_status"] and not ui["pres_status"]
    assert not ui["rigmask_status"]


def test_use_last_values_unavailable_raises(make_image):
    px = make_image(h=20, w=32)
    for name in SIDES:
        s = Side(name)
        with pytest.raises(s.err.LqrError, match="no last-used size"):
            s.dlg.MainDialog(s.image(px)).use_last_values()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_store_replays_across_packages(tmp_path, make_image, writer,
                                       reader):
    """A store written by one package's interactive run replays in the
    other's WITH_LAST_VALS to the writer's pixels."""
    px = make_image(h=24, w=36)
    pm = np.zeros((24, 36, 4), np.uint8)
    pm[4:16, 10:22] = [0, 255, 0, 255]
    stack = (("pm", pm, {"visible": False}),)
    w = Side(writer)
    store = w.st.SettingsStore(tmp_path / "shared.json")

    def respond(dialog):
        dialog.select_mask(w.cfg.AuxLayerType.PRES, "pm")
        dialog.set_new_size(width=29, height=21)
        dialog.cfg = dialog.cfg.replace(rigidity=7.0, delta_x=2,
                                        nrg_func=w.cfg.EnergyFunc(3))
        return 0

    written, _ = w.run(w.image(px, *stack), 0, store=store,
                       dialog_driver=respond)
    r = Side(reader)
    replayed, cfg = r.run(r.image(px, *stack), 2,
                          store=r.st.SettingsStore(store.path))
    assert (cfg.pres_layer, cfg.new_width, cfg.new_height) == ("pm", 29, 21)
    assert int(cfg.nrg_func) == 3 and cfg.delta_x == 2
    _same_layers(written, replayed)
