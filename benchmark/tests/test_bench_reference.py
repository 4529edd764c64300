"""The plain reference against the port's plain CPU path at tiny sizes:
Carver and BatchCarver, with and without the two bias masks and
rigidity masks; answers of several seam counts in one check; the inputs of
the traffic files that existed before rigidity masks, unchanged."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import carve as ref
from benchmark.reference import compare


def _images(n, h, w, seed):
    return inputs.image_pool(n, h, w, seed, "cpu")


def _config(**kw):
    cfg = {"energy": 0, "delta_x": 1, "rigidity": 0.0,
           "side_switch_frequency": 2}
    cfg.update(kw)
    return cfg


def _carved(cfg, img, pairs, rigmasks, seams):
    """The port's answer for img carved by `seams` seams on the CPU."""
    import lqr_tpu_torch
    h, w = img.shape[:2]
    c = lqr_tpu_torch.Carver(img, delta_x=cfg["delta_x"],
                             rigidity=cfg["rigidity"], device="cpu")
    c.set_energy_function(cfg["energy"])
    c.set_side_switch_frequency(cfg["side_switch_frequency"])
    for m, f in pairs:
        c.bias_add(m, f)
    for m in rigmasks:
        c.rigmask_add(m)
    c.resize(w - seams, h)
    return compare.Answer(img, pairs, seams, c.vmap_dump().data,
                          c.get_image(), list(rigmasks))


# "rig": the two bias masks and two rigidity masks, placed in turn
@pytest.mark.parametrize("masked", [False, True, "rig"])
@pytest.mark.parametrize("cfg", [
    _config(), _config(delta_x=2), _config(energy=1),
    _config(energy=3, side_switch_frequency=0), _config(rigidity=40.0)])
def test_reference_equals_carver(cfg, masked):
    h, w, seams = 20, 36, 9
    imgs = _images(2, h, w, 5)
    spec = [{"shape": "ellipse", "area": [0.1, 0.25]},
            {"shape": "rect", "area": [0.02, 0.06]}] if masked else []
    masks = inputs.masks(spec, 2, h, w, 5)
    rigspec = [{"shape": "rect", "area": [0.2, 0.4]},
               {"shape": "ellipse", "area": [0.1, 0.2]}]
    rigmasks = (inputs.masks(rigspec, 2, h, w, 5, stream=5)
                if masked == "rig" else [[], []])
    answers = [_carved(cfg, img, list(zip(ms, (1000.0, -1000.0))), rms,
                       seams)
               for img, ms, rms in zip(imgs, masks, rigmasks)]
    vs, out = compare.expected(cfg, answers, "cpu")
    for a, v, o in zip(answers, vs, out):
        np.testing.assert_array_equal(v, a.vs)
        np.testing.assert_array_equal(o, a.out)
    assert compare.passes(compare.check(cfg, answers, "cpu"))


@pytest.mark.parametrize("cfg", [_config(), _config(delta_x=2)])
def test_reference_equals_batch_carver(cfg):
    from lqr_tpu_torch.parallel import BatchCarver
    size, seams = 32, 10
    wave = inputs.waves(1, 5, size, 9, "cpu")[0]
    bc = BatchCarver(wave, delta_x=cfg["delta_x"], nrg=cfg["energy"],
                     device="cpu")
    bc.carve(seams)
    outs = bc.images_at(size - seams)
    vs_ref = ref.carve(torch.from_numpy(wave), seams,
                       delta_x=cfg["delta_x"])
    np.testing.assert_array_equal(bc.state.vs[:, :, :size].numpy(),
                                  vs_ref.numpy())
    out_ref = ref.materialize(torch.from_numpy(wave), vs_ref, size - seams)
    np.testing.assert_array_equal(np.stack(outs), out_ref.numpy())


def test_bias_masks_hold_their_area_shares():
    h, w = 200, 300
    ell, rect = inputs.masks([{"shape": "ellipse", "area": [0.10, 0.25]},
                              {"shape": "rect", "area": [0.02, 0.06]}],
                             1, h, w, 3)[0]
    assert 0.09 <= (ell > 0).mean() <= 0.26
    assert 0.018 <= (rect > 0).mean() <= 0.062
    assert set(np.unique(ell)) == {0, 255}


def test_inputs_follow_the_seed():
    a = inputs.image_pool(2, 16, 24, 2**31 + 3, "cpu")
    b = inputs.image_pool(2, 16, 24, 2**31 + 3, "cpu")
    c = inputs.image_pool(2, 16, 24, 2**31 + 4, "cpu")
    assert a.dtype == np.uint8 and a.shape == (2, 16, 24, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])
    w = inputs.waves(2, 3, 16, -7, "cpu")
    assert w.shape == (2, 3, 16, 16, 3)
    np.testing.assert_array_equal(w, inputs.waves(2, 3, 16, -7, "cpu"))


def test_lower_precision_differs():
    """The control's arithmetic: the reference in bfloat16 carves other
    seams than in float32."""
    imgs = torch.from_numpy(_images(2, 24, 40, 1))
    assert (ref.carve(imgs, 8) != ref.carve(imgs, 8,
                                            dtype=torch.bfloat16)).any()


def test_answers_of_several_seam_counts():
    """Each answer is held to its own seam count, in one check; an answer
    carved by another count than it asked for is a mismatch."""
    cfg = _config()
    imgs = _images(3, 20, 36, 6)
    answers = [_carved(cfg, img, [], [], s)
               for img, s in zip(imgs, (5, 9, 5))]
    vs, out = compare.expected(cfg, answers, "cpu")
    for a, v, o in zip(answers, vs, out):
        np.testing.assert_array_equal(v, a.vs)
        np.testing.assert_array_equal(o, a.out)
        assert o.shape == (20, 36 - a.seams, 3)
    numbers = compare.check(cfg, answers, "cpu")
    assert compare.passes(numbers) and numbers["checked_images"] == 3
    wrong = dataclasses.replace(answers[1], seams=6)
    numbers = compare.check(cfg, answers[:1] + [wrong] + answers[2:], "cpu")
    assert numbers["vs_mismatch"] > 0 and numbers["pixel_mismatch"] > 0
    assert not compare.passes(numbers)


# sha256 (first 16 hex digits) of each cell's inputs as its driver makes
# them from the seed 2**31 + 11 under its tiny traffic, and of the masked
# traffic file's masks at its own size, as they were before the traffic
# took rigidity masks (drawn on a stream of their own)
BEFORE = {"plugin-2048-remove100": "910c30ad28fed8f5",
          "batch-1mp-wave256": "3b41ca9bba77f339",
          "plugin-2048-bias-remove100": "8d0ba3452a801000",
          "batch-1mp-wave16": "70306d6adcf47e08"}
MASKS_BEFORE = "56ad225b3371f1e0"


def test_existing_cells_keep_their_inputs():
    from benchmark import harness

    from .conftest import TINY
    bench = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    for name, digest in BEFORE.items():
        cell = harness.find_cell(bench, name)
        traffic = harness.find_traffic(cell["traffic"])
        assert "rigmasks" not in traffic
        tiny = TINY[cell["traffic"]]
        assert set(tiny) == set(traffic)
        cfg = harness.find_config(bench, cell["config"], harness.HERE.parent)
        c = harness.find_driver(tiny["driver"]).Client(cfg, tiny,
                                                       2**31 + 11, "cpu")
        h = hashlib.sha256()
        if tiny["driver"] == "carver":
            h.update(np.ascontiguousarray(c.images).tobytes())
            for ms in c.masks:
                for m, f in ms:
                    h.update(np.ascontiguousarray(m).tobytes())
                    h.update(repr(f).encode())
            assert c.rigmasks == [[]] * tiny["pool"]
        else:
            h.update(np.ascontiguousarray(c.waves).tobytes())
        assert h.hexdigest()[:16] == digest, name
    traffic = harness.find_traffic("plugin-2048-bias-remove100")
    h = hashlib.sha256()
    for ms in inputs.masks(traffic["masks"], traffic["pool"],
                           traffic["height"], traffic["width"], 2**31 + 11):
        for m in ms:
            h.update(m.tobytes())
    assert h.hexdigest()[:16] == MASKS_BEFORE


def test_rigidity_masks_hold_their_area_shares():
    """The new cell's rigidity rectangles, at its own size, cover their
    share of the area, drawn apart from its bias masks."""
    from benchmark import harness
    t = harness.find_traffic("plugin-1024x768-masks-rig-remove100")
    h, w, n = t["height"], t["width"], t["pool"]
    rig = inputs.masks(t["rigmasks"], n, h, w, 2**31 + 5, stream=5)
    bias = inputs.masks(t["rigmasks"], n, h, w, 2**31 + 5)
    for (r,), (b,) in zip(rig, bias):
        assert 0.19 <= (r > 0).mean() <= 0.41
        assert set(np.unique(r)) == {0, 255}
        assert not np.array_equal(r, b)
