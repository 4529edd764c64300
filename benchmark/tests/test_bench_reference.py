"""The plain reference against the port's plain CPU path at tiny sizes:
Carver and BatchCarver, with and without the two bias masks."""

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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cfg", [
    _config(), _config(delta_x=2), _config(energy=1),
    _config(energy=3, side_switch_frequency=0), _config(rigidity=40.0)])
def test_reference_equals_carver(cfg, masked):
    import lqr_tpu_torch
    h, w, seams = 20, 36, 9
    imgs = _images(2, h, w, 5)
    spec = [{"shape": "ellipse", "area": [0.1, 0.25]},
            {"shape": "rect", "area": [0.02, 0.06]}] if masked else []
    masks = inputs.masks(spec, 2, h, w, 5)
    answers = []
    for img, ms in zip(imgs, masks):
        pairs = list(zip(ms, (1000.0, -1000.0)))
        c = lqr_tpu_torch.Carver(img, delta_x=cfg["delta_x"],
                                 rigidity=cfg["rigidity"], device="cpu")
        c.set_energy_function(cfg["energy"])
        c.set_side_switch_frequency(cfg["side_switch_frequency"])
        for m, f in pairs:
            c.bias_add(m, f)
        c.resize(w - seams, h)
        answers.append(compare.Answer(img, pairs, seams, c.vmap_dump().data,
                                      c.get_image()))
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
