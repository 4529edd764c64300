"""The port's interactive session (lqr_tpu_torch.interactive,
device="cpu") against lqr_tpu.interactive (use_pallas=False) on the same
seeded images, tolerance 0: after every step the layer stack's pixels and
flags, and map_info(), are equal. The session's flow, the seam-map dump,
the debounce, the progress protocol, the FATAL revalidation (a removed
layer, a changed bpp), and one seeded sequence with masks over shrink,
lookup, map growth, enlargement, reset, flatten, a vertical map, two dumps
and back. Both entry points default to the card and raise without one."""

import dataclasses

import numpy as np
import pytest
import torch

import lqr_tpu
import lqr_tpu_torch
from lqr_tpu import config as jconfig, errors as jerrors, image_model as jim
from lqr_tpu import interactive as jinter, progress as jprog
from lqr_tpu_torch import config as tconfig, errors as terrors
from lqr_tpu_torch import image_model as tim, interactive as tinter
from lqr_tpu_torch import progress as tprog
from test_torch_render import _same_layers

torch.set_num_threads(1)

SIDES = {
    "jax": (jconfig, jim, jinter, jerrors, {"use_pallas": False}),
    "torch": (tconfig, tim, tinter, terrors, {"device": "cpu"}),
}


def _session(side, px, cfg_kw=None, masks=(), **kw):
    cfgm, im, inter, _, dev = SIDES[side]
    img = im.Image.from_array(px)
    for name, mpx, lkw in masks:
        img.add_layer(im.Layer(name, mpx, **lkw))
    cfg = cfgm.LqrConfig(**(cfg_kw or {}))
    return inter.InteractiveSession(img, cfg, **kw, **dev)


def _sessions(px, **kw):
    return {side: _session(side, px, **kw) for side in SIDES}


def _same(sessions):
    j, t = sessions["jax"], sessions["torch"]
    _same_layers(j.image, t.image)
    assert dataclasses.asdict(j.map_info()) == dataclasses.asdict(
        t.map_info())
    assert j.map_info().describe() == t.map_info().describe()


def test_interactive_session_flow(make_image):
    base = make_image(h=20, w=30)
    ss = _sessions(base)
    for s in ss.values():
        s.set_size(24, 20)
    _same(ss)
    info = ss["torch"].map_info()
    assert info.orientation == 0 and info.depth == 6
    assert (info.range_min, info.range_max) == (24, 36)
    assert "reference 30" in info.describe()
    for s in ss.values():
        s.reset_size()      # the map was never reset: the original image
    _same(ss)
    np.testing.assert_array_equal(
        ss["torch"].image.layer_by_name("Background").pixels, base)
    for s in ss.values():
        s.set_size(24, 20)
        s.reset_map()
    _same(ss)
    assert ss["torch"].map_info().depth == 0
    for s in ss.values():
        s.reset_size()      # the flattened map no longer reproduces it
    _same(ss)
    assert not np.array_equal(
        ss["torch"].image.layer_by_name("Background").pixels, base)


def test_interactive_dump_and_back(make_image):
    ss = _sessions(make_image(h=16, w=24))
    for s in ss.values():
        s.set_size(20, 16)
        assert s.dump_seam_map()
    _same(ss)
    n_layers = len(ss["torch"].image.layers)
    for s in ss.values():
        s.set_size(18, 16)
        assert s.dump_seam_map()        # reuses the layer
    _same(ss)
    assert len(ss["torch"].image.layers) == n_layers
    backs = {side: s.back() for side, s in ss.items()}
    _same_layers(backs["jax"][0], backs["torch"][0])
    assert int(backs["torch"][1].output_target) == 0
    assert vars(backs["torch"][1]).keys() == vars(backs["jax"][1]).keys()


def test_interactive_debounce(make_image):
    ss = _sessions(make_image(h=12, w=20), debounce_s=10.0)
    for s in ss.values():
        s.set_size(16, 12)
        assert s.tick() is None          # not settled yet
        assert s.image.layer_by_name("Background").pixels.shape == \
            (12, 20, 3)
    _same(ss)
    for s in ss.values():
        s.flush()                        # force apply
        assert s.image.layer_by_name("Background").pixels.shape == \
            (12, 16, 3)
        assert s.flush() is None         # nothing pending
    _same(ss)
    zero = _sessions(make_image(h=12, w=20), debounce_s=1e-9)
    for s in zero.values():
        s.set_size(15, 12)
        while s.tick() is None:
            pass
    _same(zero)


def test_progress_callbacks(make_image):
    img = make_image(h=16, w=40)
    events = {}
    for side, (prog, carver, dev) in {
            "jax": (jprog, lqr_tpu.Carver, {"use_pallas": False}),
            "torch": (tprog, lqr_tpu_torch.Carver, {"device": "cpu"})}.items():
        p = prog.CollectingProgress()
        c = carver(img, **dev)
        c.set_progress(p)
        c.resize(20, 16)
        events[side] = p.events
    assert events["torch"] == events["jax"]
    kinds = [e[0] for e in events["torch"]]
    assert kinds[0] == "init" and kinds[-1] == "end"
    assert events["torch"][0][1] == "Resizing width..."
    fracs = [e[1] for e in events["torch"] if e[0] == "update"]
    assert fracs == sorted(fracs) and abs(fracs[-1] - 1.0) < 1e-9


def test_interactive_detects_removed_layer(make_image):
    ss = _sessions(make_image(h=16, w=24))
    for side, s in ss.items():
        s.set_size(20, 16)                          # works
        s.image.remove_layer(s.cd.layer_name)       # external mutation
        with pytest.raises(SIDES[side][3].LqrImageError):
            s.set_size(18, 16)


def test_interactive_detects_bpp_change(make_image):
    ss = _sessions(make_image(h=16, w=24))
    for side, s in ss.items():
        s.image.layer_by_name(s.cd.layer_name).add_alpha()   # bpp 3 -> 4
        with pytest.raises(SIDES[side][3].LqrImageError):
            s.set_size(20, 16)


def test_interactive_sequence_matches_jax():
    """Masks attached and resized with the image; after every step the
    two sessions hold equal layers and map info."""
    rng = np.random.default_rng(21)
    H, W = 24, 40
    base = ((rng.integers(0, 256, (H, W, 3)) // 32) * 32).astype(np.uint8)
    pres = np.zeros((H, W, 4), np.uint8)
    pres[6:18, 12:22] = [0, 255, 0, 255]
    rig = rng.integers(0, 256, (H, 14, 2)).astype(np.uint8)
    masks = (("pres", pres, {"visible": False}),
             ("rig", rig, {"x_off": 3, "visible": False}))
    ss = _sessions(base, cfg_kw=dict(pres_layer="pres", rigmask_layer="rig",
                                     rigidity=10.0), masks=masks)
    steps = [
        ("shrink", lambda s: s.set_size(30, H)),
        ("lookup up", lambda s: s.set_size(36, H)),
        ("grow the map", lambda s: s.set_size(26, H)),
        ("enlarge within", lambda s: s.set_size(W + 12, H)),
        ("reset_size", lambda s: s.reset_size()),
        ("reset_map", lambda s: s.reset_map()),
        ("vertical", lambda s: s.set_size(W, 19)),
        ("dump", lambda s: s.dump_seam_map()),
        ("dump again", lambda s: s.dump_seam_map()),
    ]
    for label, step in steps:
        out = {side: step(s) for side, s in ss.items()}
        assert (out["jax"] is None) == (out["torch"] is None), label
        _same(ss)
    info = ss["torch"].map_info()
    assert (info.orientation, info.depth) == (1, 5)
    np.testing.assert_array_equal(
        ss["torch"].image.layer_by_name("Background").pixels.shape,
        (19, W, 3))
    assert sum(l.name == "Background seam map"
               for l in ss["torch"].image.layers) == 1
    backs = {side: s.back() for side, s in ss.items()}
    _same_layers(backs["jax"][0], backs["torch"][0])
    assert int(backs["torch"][1].output_target) == 0


@pytest.mark.parametrize("entry", ["session", "run_plugin"])
def test_entry_points_default_to_the_card(monkeypatch, make_image, entry):
    """Without a device argument the carver goes to CUDA; where CUDA is
    absent that raises instead of falling back to the CPU."""
    from lqr_tpu_torch import dialog
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = tim.Image.from_array(make_image(h=12, w=20))
    with pytest.raises(terrors.LqrConfigError, match="CUDA"):
        if entry == "session":
            tinter.InteractiveSession(img)
        else:
            dialog.run_plugin(img, dialog.RunMode.NONINTERACTIVE,
                              cfg=tconfig.LqrConfig(new_width=16,
                                                    new_height=12))
