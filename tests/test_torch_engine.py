"""The port's engine (lqr_tpu_torch.core) against lqr_tpu.core on the CPU:
bit-exact energies, visibility maps, compacted planes and materialized
images (u8-equal), shrink and enlarge, delta_x 1 and 2, with and without
rigidity. The JAX engine runs with use_pallas=False."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import random_image
from lqr_tpu.config import EnergyFunc
from lqr_tpu.core import energy as jen
from lqr_tpu.core import engine as jeng
from lqr_tpu.core import state as jst
from lqr_tpu_torch.core import energy as ten
from lqr_tpu_torch.core import engine as teng
from lqr_tpu_torch.core import state as tst

torch.set_num_threads(1)


def _quantized(rng, h, w, c):
    return (random_image(rng, h, w, c) // 8) * 8      # ties on purpose


@pytest.mark.parametrize("nrg", list(EnergyFunc))
@pytest.mark.parametrize("C", [3, 4])
def test_energy_matches_jax(nrg, C):
    rng = np.random.default_rng(int(nrg) * 10 + C)
    H, w, Wb = 12, 50, 128
    img = np.zeros((H, Wb, C), np.uint8)
    img[:, :w] = random_image(rng, H, w, C)
    b_want = jen.reader_plane(jnp.asarray(img), int(nrg))
    b_got = ten.reader_plane(torch.from_numpy(img), int(nrg))
    np.testing.assert_array_equal(b_got.numpy(), np.asarray(b_want))
    for ww in (w, 1, 2):
        e_want = jen.energy_from_plane(b_want, jnp.int32(ww), int(nrg))
        e_got = ten.energy_from_plane(b_got, ww, int(nrg))
        assert e_got.dtype == torch.float32
        np.testing.assert_array_equal(e_got.numpy(), np.asarray(e_want),
                                      err_msg=f"w={ww}")


def _states(img, Wb, delta_x, rigidity, bias=None):
    H, w, C = img.shape
    kw = dict(H=H, Wb=Wb, C=C, delta_x=delta_x, has_rig=rigidity > 0,
              has_bias=bias is not None)
    jcfg = jst.EngineConfig(use_pallas=False, **kw)
    tcfg = tst.EngineConfig(**kw)
    rig = (np.full((H, w), np.float32(rigidity), np.float32)
           if rigidity > 0 else None)
    return (jcfg, jst.init_state(jcfg, img, bias=bias, rig=rig),
            tcfg, tst.init_state(tcfg, img, bias=bias, rig=rig,
                                 device="cpu"))


@pytest.mark.parametrize("has_bias", [False, True])
@pytest.mark.parametrize("delta_x", [1, 2])
@pytest.mark.parametrize("rigidity", [0.0, 3.0])
def test_extend_and_materialize_match_jax(delta_x, rigidity, has_bias):
    rng = np.random.default_rng(delta_x * 7 + int(rigidity))
    H, w, Wb, k = 24, 200, 256, 40
    img = _quantized(rng, H, w, 3)
    # a random f32 bias quantized to eighths: ties on purpose
    bias = (np.round(rng.standard_normal((H, w)) * 4).astype(np.float32)
            * np.float32(0.125) if has_bias else None)
    jcfg, jst0, tcfg, tst0 = _states(img, Wb, delta_x, rigidity, bias)

    jst1 = jeng.extend_map(jcfg, jst0, jnp.int32(k))
    tst1 = teng.extend_map(tcfg, tst0, k)
    assert tst1.depth == k and tst0.depth == 0
    assert not tst0.vs.any()                  # the input state is untouched
    np.testing.assert_array_equal(tst1.vs.numpy(), np.asarray(jst1.vs))
    np.testing.assert_array_equal(tst1.cur_b.numpy(), np.asarray(jst1.cur_b))
    if rigidity:
        np.testing.assert_array_equal(tst1.cur_rig.numpy(),
                                      np.asarray(jst1.cur_rig))
    if has_bias:
        np.testing.assert_array_equal(tst1.cur_bias.numpy(),
                                      np.asarray(jst1.cur_bias))

    out_Wb = 256
    for target in (w - k, w - 13, w, w + 9, w + k):
        j_img, j_bias, j_rig, _ = jeng.materialize_all(
            jcfg, jst1, jnp.int32(target), out_Wb)
        t_img, t_bias, t_rig, t_aux = teng.materialize_all(tcfg, tst1,
                                                           target, out_Wb)
        assert t_img.dtype == torch.uint8 and t_aux == ()
        np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img),
                                      err_msg=f"w={target}")
        if rigidity:
            np.testing.assert_array_equal(t_rig.numpy(), np.asarray(j_rig))
        if has_bias:
            np.testing.assert_array_equal(t_bias.numpy(), np.asarray(j_bias))
        else:
            assert t_bias is None


def test_materialize_out_width_and_channels():
    """Output buffers narrower and wider than Wb, 1 and 2 channels, and
    a map extended in two calls."""
    rng = np.random.default_rng(5)
    H, w, Wb = 16, 120, 128
    for C in (1, 2):
        img = _quantized(rng, H, w, C)
        jcfg, j0, tcfg, t0 = _states(img, Wb, 1, 0.0)
        j1 = jeng.extend_map(jcfg, jeng.extend_map(jcfg, j0, jnp.int32(10)),
                             jnp.int32(15))
        t1 = teng.extend_map(tcfg, teng.extend_map(tcfg, t0, 10), 15)
        np.testing.assert_array_equal(t1.vs.numpy(), np.asarray(j1.vs))
        for target, out_Wb in ((w - 25, 128), (w + 20, 256), (w + 25, 384)):
            want = jeng.materialize(jcfg, j1, jnp.int32(target), out_Wb)
            got = teng.materialize(tcfg, t1, target, out_Wb)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seam_step_matches_jax():
    rng = np.random.default_rng(9)
    img = _quantized(rng, 12, 60, 3)
    jcfg, j, tcfg, t = _states(img, 128, 1, 0.0)
    for _ in range(3):
        j = jeng.seam_step(jcfg, j)
        t = teng.seam_step(tcfg, t)
    assert t.depth == int(j.depth) == 3
    np.testing.assert_array_equal(t.vs.numpy(), np.asarray(j.vs))


def test_pref_is_left_matches_jax():
    for freq in (0, 1, 2, 5):
        for s in range(1, 30):
            assert teng.pref_is_left(s, freq) == bool(
                jeng.pref_is_left(jnp.int32(s), freq))


@pytest.mark.parametrize("nrg", list(EnergyFunc))
def test_ragged_energy_matches_jax(nrg):
    """energy_from_plane(h=...): the bottom edge replicates at the true
    height h - 1 of a plane padded to more rows."""
    rng = np.random.default_rng(int(nrg) + 40)
    H, w, Wb = 12, 50, 128
    img = np.zeros((H, Wb, 3), np.uint8)
    img[:, :w] = _quantized(rng, H, w, 3)
    b = ten.reader_plane(torch.from_numpy(img), int(nrg))
    for h in (1, 2, 7, H):
        want = jen.energy_from_plane(jnp.asarray(b.numpy()), jnp.int32(w),
                                     int(nrg), h=jnp.int32(h))
        got = ten.energy_from_plane(b, w, int(nrg), h=h)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"h={h}")


@pytest.mark.parametrize("h", [1, 6, 13, 16])
def test_ragged_carve_once_matches_jax(h):
    """_carve_once with the true height h and per-image rigc_vec of a map
    padded to 16 rows: the seam over the whole buffer (rows >= h carry
    seam[h - 1]) and every compacted plane, as lqr_tpu.core.engine's."""
    from lqr_tpu_torch.parallel.batch import rigc_table
    rng = np.random.default_rng(h)
    H, w, Wb = 16, 90, 128
    img = np.zeros((H, w, 3), np.uint8)
    img[:h] = _quantized(rng, h, w, 3)
    bias = np.round(rng.standard_normal((H, w)) * 4).astype(np.float32) / 8
    rig = np.abs(np.round(rng.standard_normal((H, w)) * 4)).astype(
        np.float32)
    jcfg, j, tcfg, t = _states(img, Wb, 2, 1.0, bias)
    j = j._replace(cur_rig=jnp.asarray(np.pad(rig, ((0, 0), (0, Wb - w)))))
    t = t._replace(cur_rig=torch.from_numpy(np.pad(rig,
                                                   ((0, 0), (0, Wb - w)))))
    for nrg in (0, 1):
        jc = dataclasses.replace(jcfg, nrg=nrg)
        tc = dataclasses.replace(tcfg, nrg=nrg)
        rv = rigc_table([h], 2)[0]
        for s in (1, 11):
            want = jeng._carve_once(jc, j.cur_b, j.cur_bias, j.cur_rig,
                                    jnp.int32(w), jnp.int32(s),
                                    h=jnp.int32(h), rigc_vec=jnp.asarray(rv))
            got = teng._carve_once(tc, t.cur_b, t.cur_bias, t.cur_rig, None,
                                   w, s, h=h, rigc_vec=torch.from_numpy(rv))
            for g, e in zip(got[:4], want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                              err_msg=f"{nrg=} {s=}")
            assert (got[0][h:] == got[0][h - 1]).all()


def test_init_state_runs_on_the_card_unless_asked(monkeypatch):
    """init_state puts the state on CUDA by default: without CUDA it raises
    and names device="cpu"; asked for the CPU, it builds there."""
    from lqr_tpu_torch import LqrConfigError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((4, 8, 3), np.uint8)
    cfg = tst.EngineConfig(H=4, Wb=128, C=3)
    with pytest.raises(LqrConfigError, match='device="cpu"'):
        tst.init_state(cfg, img)
    with pytest.raises(LqrConfigError, match="CUDA is not available"):
        tst.init_state(cfg, img, device="cuda:0")
    st = tst.init_state(cfg, img, device="cpu")
    assert st.vs.device.type == "cpu" and st.cur_b.shape == (4, 128)


@pytest.mark.parametrize("nrg", list(EnergyFunc))
def test_energy_of_the_image_matches_jax(nrg):
    """core.energy.energy: the energy of the interleaved image, equal to
    JAX's and to reader_plane then energy_from_plane."""
    rng = np.random.default_rng(40 + int(nrg))
    H, Wb = 10, 128
    for C, w in ((3, 77), (4, 128), (1, 2)):
        img = np.zeros((H, Wb, C), np.uint8)
        img[:, :w] = random_image(rng, H, w, C)
        got = ten.energy(torch.from_numpy(img), w, int(nrg))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jen.energy(jnp.asarray(img),
                                               jnp.int32(w), int(nrg))))
        np.testing.assert_array_equal(
            got.numpy(), ten.energy_from_plane(
                ten.reader_plane(torch.from_numpy(img), int(nrg)), w,
                int(nrg)).numpy())


def test_lane_index_and_shift_frontier_match_jax():
    from lqr_tpu.core import dp as jdp
    from lqr_tpu_torch.core import dp as tdp
    for H, Wb in ((1, 128), (7, 256)):
        got = tst.lane_index(H, Wb, "cpu")
        assert got.dtype == torch.int32 and got.shape == (H, Wb)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jst.lane_index(H, Wb)))
    M = np.random.default_rng(3).random((4, 9)).astype(np.float32)
    M[1, 2] = np.inf
    for m in (M, M[0]):
        for dx in range(-4, 5):
            got = tdp.shift_frontier(torch.from_numpy(m), dx)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jdp.shift_frontier(jnp.asarray(m),
                                                           dx)))
