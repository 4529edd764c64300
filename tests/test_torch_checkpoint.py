"""Checkpoint/resume of the port (lqr_tpu_torch.checkpoint, device="cpu"):
a resumed map continues the exact seam sequence of an uninterrupted run,
and checkpoints cross-load both ways with lqr_tpu.checkpoint (the same
.npz format): equal maps, images and vmaps after the same continuation
(tolerance 0). Mirrors tests/test_checkpoint.py."""

import io
import json

import numpy as np
import pytest
import torch

import lqr_tpu
import lqr_tpu_torch
from lqr_tpu import checkpoint as jck
from lqr_tpu_torch import checkpoint as tck
from conftest import random_image

torch.set_num_threads(1)


def _img(seed, h, w, c=3):
    return random_image(np.random.default_rng(seed), h, w, c)


def _vs(c):
    st = c._state
    return np.asarray(st.vs.cpu() if hasattr(st.vs, "cpu") else st.vs)


def test_resume_continues_exact_seam_sequence(tmp_path):
    img = _img(1, 24, 40)
    p = str(tmp_path / "ck.npz")
    full = lqr_tpu_torch.Carver(img, device="cpu")
    full.resize(28, 24)
    c1 = lqr_tpu_torch.Carver(img, device="cpu")
    c1.resize(35, 24)
    tck.save_carver(p, c1)
    c2 = tck.load_carver(p, device="cpu")
    assert (c2.width, c2.height, c2.depth) == (35, 24, 5)
    c2.resize(28, 24)
    np.testing.assert_array_equal(c2.get_image(), full.get_image())
    np.testing.assert_array_equal(_vs(c2), _vs(full))
    j = lqr_tpu.Carver(img, use_pallas=False)
    j.resize(28, 24)
    np.testing.assert_array_equal(_vs(c2), _vs(j))


def test_resume_within_map_range_no_recompute(tmp_path):
    img = _img(2, 20, 36)
    p = str(tmp_path / "ck.npz")
    c1 = lqr_tpu_torch.Carver(img, device="cpu")
    c1.resize(26, 20)
    ref = {}
    for w in (30, 27, 36):
        c1.resize(w, 20)
        ref[w] = c1.get_image()
    c1.resize(26, 20)
    tck.save_carver(p, c1)
    c2 = tck.load_carver(p, device="cpu")
    for w in (30, 27, 36):
        c2.resize(w, 20)
        np.testing.assert_array_equal(c2.get_image(), ref[w])
    assert c2.depth == 10


def test_checkpoint_fresh_carver_roundtrip(tmp_path):
    img = _img(3, 12, 16)
    p = str(tmp_path / "ck.npz")
    c1 = lqr_tpu_torch.Carver(img, device="cpu")
    tck.save_carver(p, c1)
    c2 = tck.load_carver(p, device="cpu")
    for c in (c1, c2):
        c.resize(12, 12)
    np.testing.assert_array_equal(c2.get_image(), c1.get_image())


def _configure(c):
    """A carver with every saved field away from its default: energy,
    bias, rigidity mask, an aux image, recorded vmaps."""
    h, w = c.height, c.width
    mask = np.zeros((h, w, 3), np.uint8)
    mask[4:10, 6:14] = 200
    c.set_energy_function(1)
    c.set_enl_step(1.3)
    c.bias_add(mask, 800.0)
    c.rigmask_add(mask[:, :, :1], 2, 1)
    c.attach(_img(9, h, w, 2))
    c.set_dump_vmaps(True)


CASES = {
    # name: (carver kwargs, configure?, resize before the save, after)
    "plain": ({}, False, (24, 18), (20, 18)),
    "masks": ({"delta_x": 2, "rigidity": 10.0}, True, (24, 18), (20, 18)),
    "vert": ({}, False, (30, 13), (30, 11)),
    "two_axis": ({}, True, (25, 15), (22, 14)),
    "fresh": ({}, False, None, (26, 16)),
}


def _make(side, name):
    kw, conf, before, _ = CASES[name]
    img = _img(4, 18, 30)
    c = (lqr_tpu.Carver(img, use_pallas=False, **kw) if side == "jax"
         else lqr_tpu_torch.Carver(img, device="cpu", **kw))
    if conf:
        _configure(c)
    if name == "vert":
        c.set_resize_order(1)
    if before:
        c.resize(*before)
    return c


def _same(j, t):
    assert (j.width, j.height, j.depth, j.orientation) == (
        t.width, t.height, t.depth, t.orientation)
    np.testing.assert_array_equal(t.get_image(), j.get_image())
    if j._state is not None:
        np.testing.assert_array_equal(_vs(t), _vs(j))
    assert len(j.vmaps) == len(t.vmaps)
    for a, b in zip(j.vmaps, t.vmaps):
        assert (a.depth, a.ref_w, a.ref_h, a.orientation) == (
            b.depth, b.ref_w, b.ref_h, b.orientation)
        np.testing.assert_array_equal(b.data, a.data)
    for i in range(len(j._aux)):
        np.testing.assert_array_equal(t.get_aux(i), j.get_aux(i))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("name", list(CASES))
def test_cross_load_continues_identically(tmp_path, name, direction):
    """Save in one package, load in the other, continue both: the loaded
    carver equals the saved one, before and after the same resize."""
    p = str(tmp_path / "ck.npz")
    src, dst = direction.split("_to_")
    saved = _make(src, name)
    (jck if src == "jax" else tck).save_carver(p, saved)
    loaded = (jck.load_carver(p) if dst == "jax"
              else tck.load_carver(p, device="cpu"))
    j, t = (saved, loaded) if src == "jax" else (loaded, saved)
    _same(j, t)
    after = CASES[name][3]
    for c in (j, t):
        c.resize(*after)
    _same(j, t)


def _rewrite_use_pallas(path, value):
    """The same archive with params["use_pallas"] set to value."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    params = json.loads(bytes(arrays["params"]).decode())
    params["use_pallas"] = value
    arrays["params"] = np.frombuffer(json.dumps(params).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


@pytest.mark.parametrize("use_pallas", [True, False, None])
def test_port_ignores_saved_use_pallas(tmp_path, use_pallas):
    p = str(tmp_path / "ck.npz")
    j = _make("jax", "masks")
    jck.save_carver(p, j)
    _rewrite_use_pallas(p, use_pallas)
    t = tck.load_carver(p, device="cpu")
    assert t.device == torch.device("cpu")
    _same(j, t)


def test_port_saves_null_use_pallas(tmp_path):
    p = str(tmp_path / "ck.npz")
    tck.save_carver(p, _make("torch", "plain"))
    with np.load(p) as z:
        params = json.loads(bytes(z["params"]).decode())
    assert params["use_pallas"] is None and params["format"] == 1
    assert jck.load_carver(p).use_pallas is False     # JAX's CPU default


def test_load_carver_defaults_to_the_card(tmp_path):
    p = str(tmp_path / "ck.npz")
    tck.save_carver(p, _make("torch", "plain"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(lqr_tpu_torch.LqrConfigError, match="CUDA"):
        tck.load_carver(p)
