"""The port's batch path (lqr_tpu_torch.parallel.batch, plain versions on
the CPU) against the JAX package's ``lqr_tpu.parallel.BatchCarver``.

Tolerance 0 everywhere: the visibility maps over the whole padded buffer
(padded rows and lanes included), the compacted planes, every image and aux
image. The cases mirror tests/test_parallel.py: ragged heights with ties,
the SUMABS bottom edge, masks with rigidity, global rigidity without a
mask, aux images, per-image seam counts and the pre-stacked ndarray. The
equal-height case runs JAX's Pallas tier in interpreter mode
(LQR_PALLAS_INTERPRET=1, as tests/test_parallel.py runs it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import random_image
from lqr_tpu.core import engine as jeng
from lqr_tpu.parallel import batch as jbatch
from lqr_tpu_torch import Carver, LqrImageError
from lqr_tpu_torch.carver import place_mask_numpy
from lqr_tpu_torch.core import engine as teng
from lqr_tpu_torch.core.state import per_map
from lqr_tpu_torch.ops import carve_resident as tcr
from lqr_tpu_torch.ops import dp_cuda
from lqr_tpu_torch.parallel import batch as tbatch

torch.set_num_threads(1)

_STATE = ("vs", "cur_b", "cur_bias", "cur_rig")


def _tied(rng, h, w, c=3):
    """Few grey levels: energy ties everywhere, as in test_parallel.py."""
    return (rng.integers(0, 8, (h, w, c)) * 32).astype(np.uint8)


def _assert_state_equal(t_state, j_state):
    for name in _STATE:
        g, e = getattr(t_state, name), getattr(j_state, name)
        assert (g is None) == (e is None), name
        if g is not None:
            np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(e),
                                          err_msg=name)
    np.testing.assert_array_equal(t_state.depth, np.asarray(j_state.depth))


def _pair(imgs, carve, **kw):
    """The same batch through both packages' BatchCarver."""
    j = jbatch.BatchCarver(imgs, use_pallas=False, **kw)
    t = tbatch.BatchCarver(imgs, device="cpu", **kw)
    assert t.ragged == j.ragged
    for n in carve:
        j.carve(n)
        t.carve(n)
    _assert_state_equal(t.state, j.state)
    return t, j


def _assert_images_equal(t, j, widths, aux=False):
    for g, e in zip(t.images_at(widths), j.images_at(widths)):
        np.testing.assert_array_equal(g, e)
    if aux:
        for gi, ei in zip(t.aux_at(widths), j.aux_at(widths)):
            for g, e in zip(gi, ei):
                np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("nrg", [0, 1])
def test_ragged_ties_match_jax(nrg):
    """Ragged heights and widths with ties; nrg 1 (GRAD_SUMABS) replicates
    the bottom edge at each image's true height."""
    rng = np.random.default_rng(7 + nrg)
    imgs = [_tied(rng, 12, 24), _tied(rng, 16, 24), _tied(rng, 9, 20),
            _tied(rng, 16, 16)]
    t, j = _pair(imgs, [5], nrg=nrg)
    assert t.ragged
    _assert_images_equal(t, j, np.array([im.shape[1] - 5 for im in imgs]))
    # a second call goes on from depth 5, and the map slides back
    t.carve(2)
    j.carve(2)
    _assert_state_equal(t.state, j.state)
    _assert_images_equal(t, j, np.array([im.shape[1] - 3 for im in imgs]))


def test_masks_and_rigidity_match_jax():
    """Benchmark config #2 batched: bias (preservation + discard) and a
    rigidity mask under a global rigidity, ragged heights, delta_x 2."""
    rng = np.random.default_rng(13)
    imgs = [random_image(rng, 16, 28, 3), random_image(rng, 12, 24, 3),
            random_image(rng, 14, 30, 3)]
    biases, rigmasks = [], []
    for im in imgs:
        h, w = im.shape[:2]
        b = np.zeros((h, w), np.float32)
        b[h // 4: h // 2, w // 4: w // 2] += 1.0
        b[h // 2:, w // 2:] -= 0.8
        biases.append(b)
        rigmasks.append(rng.random((h, w)).astype(np.float32))
    biases[2] = None                    # an image without a bias field
    t, j = _pair(imgs, [5], rigidity=40.0, biases=biases,
                 rigmasks=rigmasks, delta_x=2)
    _assert_images_equal(t, j, np.array([im.shape[1] - 5 for im in imgs]))


def test_global_rigidity_without_mask_matches_jax():
    """rigidity > 0 and no rigmask: the global value everywhere, each
    image's coefficients f32(m^1.5 / h_i) (rigc_table) across heights."""
    rng = np.random.default_rng(3)
    imgs = [random_image(rng, 12, 24, 3), random_image(rng, 16, 24, 3)]
    _pair(imgs, [3], rigidity=25.0, delta_x=2)
    for dx in (1, 2, 3):
        np.testing.assert_array_equal(tbatch.rigc_table([7, 12, 300], dx),
                                      jbatch.rigc_table([7, 12, 300], dx))


def test_aux_match_jax():
    rng = np.random.default_rng(17)
    imgs = [random_image(rng, 12, 24, 3), random_image(rng, 16, 20, 3)]
    aux = [[rng.integers(0, 256, im.shape[:2] + (1,)).astype(np.uint8),
            rng.integers(0, 256, im.shape[:2] + (4,)).astype(np.uint8)]
           for im in imgs]
    t, j = _pair(imgs, [4], aux=aux)
    widths = np.array([im.shape[1] - 4 for im in imgs])
    _assert_images_equal(t, j, widths, aux=True)
    # enlarge through the same seams
    _assert_images_equal(t, j, widths + 7, aux=True)


def test_per_image_seam_counts_match_jax():
    rng = np.random.default_rng(19)
    imgs = [random_image(rng, 14, 30, 3), random_image(rng, 14, 30, 3),
            random_image(rng, 10, 26, 3)]
    t, j = _pair(imgs, [np.array([3, 7, 0]), np.array([2, 0, 4])])
    _assert_images_equal(t, j, np.array([25, 23, 22]))


@pytest.mark.parametrize("W", [128, 100])
def test_prestacked_ndarray_matches_list_and_jax(W):
    """The pre-stacked [B, H, W, C] batch: used as it is when W is already
    the lane bucket (W = 128), padded otherwise; and its dtype checked."""
    rng = np.random.default_rng(11)
    arr = np.stack([random_image(rng, 16, W, 3) for _ in range(4)])
    t, j = _pair(arr, [5])
    listed = tbatch.BatchCarver([arr[i] for i in range(4)], device="cpu")
    listed.carve(5)
    assert torch.equal(listed.state.vs, t.state.vs)
    with pytest.raises(LqrImageError, match="dtype"):
        tbatch.BatchCarver(arr.astype(np.float32), device="cpu")


def test_equal_heights_match_jax_pallas_tier(monkeypatch):
    """Equal heights take JAX's Pallas tier (lax.scan through the solo
    engine, resident kernel in interpreter mode) and the port's batched
    resident kernel (its plain version here): the same maps."""
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(29)
    imgs = [random_image(rng, 24, 40, 3), random_image(rng, 24, 36, 3),
            random_image(rng, 24, 40, 3)]
    counts = np.array([6, 4, 5])
    j = jbatch.BatchCarver([im.copy() for im in imgs], use_pallas=True)
    assert j.scan_pallas
    j.carve(counts)
    t = tbatch.BatchCarver(imgs, device="cpu")
    assert not t.ragged
    t.carve(counts)
    _assert_state_equal(t.state, j.state)
    _assert_images_equal(t, j, np.array([34, 32, 35]))


def _ragged_batch(seed, sizes, dx=2):
    """Tied images with u8 bias and rigidity masks, and the fields a solo
    Carver builds from them (bias_add at factor 1000, rigmask_add)."""
    rng = np.random.default_rng(seed)
    imgs = [_tied(rng, h, w) for h, w in sizes]
    bmasks = [rng.integers(0, 256, (h, w)).astype(np.uint8)
              for h, w in sizes]
    rmasks = [rng.integers(0, 256, (h, w)).astype(np.uint8)
              for h, w in sizes]
    biases = [place_mask_numpy(m, *m.shape, 0, 0) * np.float32(1.0)
              for m in bmasks]
    rigm = [place_mask_numpy(m, *m.shape, 0, 0) for m in rmasks]
    return imgs, (bmasks, rmasks), dict(biases=biases, rigmasks=rigm,
                                        rigidity=5.0, delta_x=dx)


def test_batched_resident_plain_matches_per_map():
    """The batched resident entry (its plain version on CPU tensors) is
    the per-map loop of carve_chunk_resident_plain, each map with its own
    w0, d0, kc (one of them 0), true height and rigc row; the batch's
    posmap is lqr_tpu's map by map, and one map's alone."""
    sizes = [(12, 60), (16, 50), (7, 64), (16, 40)]
    imgs, _, kw = _ragged_batch(5, sizes)
    bc = tbatch.BatchCarver(imgs, device="cpu", **kw)
    bc.carve([3, 0, 5, 1])          # hidden columns inside the rows
    st = bc.state
    B, H, Wb = st.vs.shape
    pm = teng._posmap(st.vs, per_map(st.ref_w, "cpu"))
    for i in range(B):
        want = np.asarray(jeng._posmap_from_vs(jnp.asarray(st.vs[i].numpy()),
                                               jnp.int32(st.ref_w[i])))
        np.testing.assert_array_equal(pm[i].numpy(), want)
        assert torch.equal(teng._posmap(st.vs[i], int(st.ref_w[i])), pm[i])
    rigc = torch.from_numpy(tbatch.rigc_table(bc.heights, 2))
    kc = [5, 0, 9, 3]
    d0 = [3, 0, 5, 1]
    w0 = list(bc.widths - np.array(d0))
    before = dict(dp_cuda.LAUNCHES)
    got = tcr.carve_chunk_resident_batched(
        st.cur_b, st.cur_bias, st.cur_rig, pm, w0, d0, kc, bc.heights, rigc,
        2, True, True, 0, 2, teng.KC)
    assert dp_cuda.LAUNCHES == before     # CPU tensors run the plain path
    for i in range(B):
        h = int(bc.heights[i])
        want = tcr.carve_chunk_resident_plain(
            st.cur_b[i], st.cur_bias[i], st.cur_rig[i], pm[i], w0[i], d0[i],
            kc[i], 2, True, True, 0, 2, teng.KC,
            h=None if h == H else h, rigc_vec=rigc[i])
        for g, e in zip(got, want):
            assert torch.equal(g[i], e), i
    assert (got[0][1] == -1).all()       # kc = 0: no seam recorded
    with pytest.raises(ValueError, match="kc"):
        tcr.carve_chunk_resident_batched(
            st.cur_b, st.cur_bias, st.cur_rig, pm, w0, d0, [5, 0, 9, 200],
            bc.heights, rigc, 2, True, True, 0, 2, teng.KC)


def test_routes_match_reference_loop_and_solo_carvers():
    """Both of extend_batched's routes (the batched resident kernel and
    the per-seam kernels map by map) equal the flat reference loop
    extend_map_batched; every image equals its solo port Carver with the
    same masks."""
    sizes = [(10, 40), (14, 36), (6, 44)]
    imgs, (bmasks, rmasks), kw = _ragged_batch(23, sizes)
    n = np.array([9, 5, 0])
    bc = tbatch.BatchCarver(imgs, device="cpu", **kw)
    cfg, st0 = bc.cfg, bc.state
    rigc = tbatch.rigc_table(bc.heights, 2)
    ref = tbatch.extend_map_batched(cfg, st0, n, bc.heights, rigc)
    rigc = torch.from_numpy(rigc)
    for route in (teng.extend_resident, tbatch._extend_per_seam):
        got = route(cfg, st0, n, bc.heights, rigc)
        for name in _STATE:
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        np.testing.assert_array_equal(got.depth, n)
    bc.carve(n)
    assert torch.equal(bc.state.vs, ref.vs)
    for i, (h, w) in enumerate(sizes):
        solo = Carver(imgs[i], delta_x=2, rigidity=5.0, device="cpu")
        solo.bias_add(bmasks[i], 1000.0)
        solo.rigmask_add(rmasks[i])
        solo.resize(w - int(n[i]), h)
        vm = solo.vmap_dump()            # None: no seam carved
        np.testing.assert_array_equal(
            ref.vs[i, :h, :w].numpy(),
            np.zeros((h, w), np.int32) if vm is None else vm.data)
        np.testing.assert_array_equal(bc.images_at(bc.widths - n)[i],
                                      solo.get_image())


def test_chunk_boundary(monkeypatch):
    """KC shrunk to 4: the resident route's chunks and the reference
    loop's commits cross several boundaries with per-image counts."""
    monkeypatch.setattr(teng, "KC", 4)
    sizes = [(9, 30), (12, 26)]
    imgs, _, kw = _ragged_batch(31, sizes, dx=1)
    bc = tbatch.BatchCarver(imgs, device="cpu", **kw)
    n = np.array([11, 6])
    rigc = tbatch.rigc_table(bc.heights, 1)
    ref = tbatch.extend_map_batched(bc.cfg, bc.state, n, bc.heights, rigc)
    got = teng.extend_resident(bc.cfg, bc.state, n, bc.heights,
                               torch.from_numpy(rigc))
    for name in _STATE:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_materialize_batched_mixes_shrink_and_enlarge():
    """materialize_batched and materialize_all_batched on a ragged batch
    with a bias and an aux image, at widths that shrink some maps, enlarge
    others (up to the map's depth) and keep one, equal lqr_tpu's
    materialize_array map by map, the image, the aux and the f32 bias."""
    sizes = [(10, 40), (14, 36), (6, 44), (12, 30)]
    imgs, _, kw = _ragged_batch(41, sizes)
    rng = np.random.default_rng(42)
    aux = [[_tied(rng, h, w, 1)] for h, w in sizes]
    bc = tbatch.BatchCarver(imgs, aux=aux, device="cpu", **kw)
    bc.carve(np.array([9, 5, 0, 7]))
    st, out_Wb = bc.state, bc.cfg.Wb
    w = bc.widths + np.array([-4, 5, 0, 7])
    img = tbatch.materialize_batched(bc.cfg, st, w, out_Wb)
    img_all, (aux_t,) = tbatch.materialize_all_batched(bc.cfg, st, w, out_Wb)
    bias = teng.materialize_array(st.bias, st.vs, st.ref_w, w, out_Wb)
    assert torch.equal(img_all, img)
    for i in range(len(sizes)):
        args = (jnp.asarray(st.vs[i].numpy()), jnp.int32(st.ref_w[i]),
                jnp.int32(w[i]), out_Wb)
        for got, plane in ((img, st.ref), (aux_t, st.aux[0]),
                           (bias, st.bias)):
            want = jeng.materialize_array(jnp.asarray(plane[i].numpy()),
                                          *args)
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_errors():
    rng = np.random.default_rng(2)
    with pytest.raises(LqrImageError, match="at least one image"):
        tbatch.BatchCarver([], device="cpu")
    with pytest.raises(LqrImageError, match="channels"):
        tbatch.BatchCarver([random_image(rng, 8, 8, 3),
                            random_image(rng, 8, 8, 4)], device="cpu")
    with pytest.raises(LqrImageError, match="same number of aux"):
        tbatch.BatchCarver([random_image(rng, 8, 8, 3)] * 2,
                           aux=[[random_image(rng, 8, 8, 1)], []],
                           device="cpu")
    with pytest.raises(LqrImageError, match="aux 0 of image 0"):
        tbatch.BatchCarver([random_image(rng, 8, 8, 3)],
                           aux=[[random_image(rng, 8, 9, 1)]], device="cpu")


def test_init_state_batched_runs_on_the_card_unless_asked(monkeypatch):
    """init_state_batched puts the state on CUDA by default: without CUDA it
    raises and names device="cpu"; asked for the CPU, it builds there."""
    from lqr_tpu_torch import LqrConfigError
    from lqr_tpu_torch.core.state import EngineConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(H=4, Wb=128, C=3)
    px = np.zeros((2, 4, 128, 3), np.uint8)
    with pytest.raises(LqrConfigError, match='device="cpu"'):
        tbatch.init_state_batched(cfg, px, [8, 5])
    st = tbatch.init_state_batched(cfg, px, [8, 5], device="cpu")
    assert st.vs.device.type == "cpu" and st.vs.shape == (2, 4, 128)
    assert st.ref_w.tolist() == [8, 5]
