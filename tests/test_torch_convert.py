"""State carried across from the JAX package to the port (and back), and
the port's constants, errors and messages against lqr_tpu's."""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lqr_tpu.config as jconfig
import lqr_tpu.errors as jerrors
from conftest import random_image
from lqr_tpu.core import engine as jeng
from lqr_tpu.core import state as jst
from lqr_tpu_torch import config as tconfig
from lqr_tpu_torch import errors as terrors
from lqr_tpu_torch import i18n as ti18n
from lqr_tpu_torch.convert import (config_from_jax_fields, state_from_numpy,
                                   state_to_numpy)
from lqr_tpu_torch.core import engine as teng

torch.set_num_threads(1)

_FIELDS = ("ref", "bias", "rig", "vs", "aux", "cur_b", "cur_bias",
           "cur_rig", "ref_w", "depth")


def _to_numpy(jstate) -> dict:
    out = {}
    for name in _FIELDS:
        v = getattr(jstate, name)
        if name == "aux":
            out[name] = tuple(np.asarray(a) for a in v)
        else:
            out[name] = None if v is None else np.asarray(v)
    return out


@pytest.mark.parametrize("delta_x,rigidity", [(1, 0.0), (2, 5.0)])
def test_carry_jax_state_into_port(delta_x, rigidity):
    rng = np.random.default_rng(delta_x)
    H, w, Wb, k, m = 20, 110, 128, 12, 17
    img = (random_image(rng, H, w, 3) // 8) * 8
    jcfg = jst.EngineConfig(H=H, Wb=Wb, C=3, delta_x=delta_x,
                            has_rig=rigidity > 0, use_pallas=False)
    rig = (np.full((H, w), np.float32(rigidity), np.float32)
           if rigidity else None)
    j0 = jst.init_state(jcfg, img, rig=rig)
    jk = jeng.extend_map(jcfg, j0, jnp.int32(k))
    jkm = jeng.extend_map(jcfg, j0, jnp.int32(k + m))

    fields = dataclasses.asdict(jcfg)
    tcfg, device = config_from_jax_fields(fields)
    assert device == "cpu" and tcfg.delta_x == delta_x
    t = state_from_numpy(fields, _to_numpy(jk), device)
    assert (t.ref_w, t.depth) == (w, k)
    t = teng.extend_map(tcfg, t, m)
    np.testing.assert_array_equal(t.vs.numpy(), np.asarray(jkm.vs))
    np.testing.assert_array_equal(t.cur_b.numpy(), np.asarray(jkm.cur_b))
    img_t = teng.materialize(tcfg, t, w - k - m, 128)
    img_j = jeng.materialize(jcfg, jkm, jnp.int32(w - k - m), 128)
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))

    back = state_to_numpy(t)
    want = _to_numpy(jkm)
    for name in _FIELDS:
        if name == "aux":
            assert back[name] == want[name] == ()
        elif want[name] is None:
            assert back[name] is None
        else:
            assert back[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(back[name], want[name])


def test_carry_jax_state_with_bias_and_aux_into_port():
    """A JAX map carved part-way with a bias plane and an aux image goes
    on in the port, bit-equal to JAX's continuation."""
    rng = np.random.default_rng(9)
    H, w, Wb, k, m = 18, 100, 128, 10, 21
    img = (random_image(rng, H, w, 3) // 8) * 8
    bias = (np.round(rng.standard_normal((H, w)) * 4).astype(np.float32)
            * np.float32(0.125))
    aux = random_image(rng, H, w, 4)
    jcfg = jst.EngineConfig(H=H, Wb=Wb, C=3, has_bias=True,
                            aux_channels=(4,), use_pallas=False)
    j0 = jst.init_state(jcfg, img, bias=bias, aux=(aux,))
    jk = jeng.extend_map(jcfg, j0, jnp.int32(k))
    jkm = jeng.extend_map(jcfg, jk, jnp.int32(m))

    fields = dataclasses.asdict(jcfg)
    tcfg, device = config_from_jax_fields(fields)
    t = teng.extend_map(tcfg, state_from_numpy(fields, _to_numpy(jk),
                                               device), m)
    for name in ("vs", "cur_b", "cur_bias"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(jkm, name)))
    for target in (w - k - m, w - 3, w + 17):
        want = jeng.materialize_all(jcfg, jkm, jnp.int32(target), 128)
        got = teng.materialize_all(tcfg, t, target, 128)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[3][0].numpy(),
                                      np.asarray(want[3][0]))


def test_round_trip_and_presence_checks():
    rng = np.random.default_rng(4)
    H, w, Wb = 8, 30, 128
    jcfg = jst.EngineConfig(H=H, Wb=Wb, C=1, has_bias=True,
                            aux_channels=(3,), use_pallas=True)
    bias = rng.standard_normal((H, w)).astype(np.float32)
    aux = random_image(rng, H, w, 3)
    j0 = jst.init_state(jcfg, random_image(rng, H, w, 1), bias=bias,
                        aux=(aux,))
    fields = dataclasses.asdict(jcfg)
    tcfg, device = config_from_jax_fields(fields)
    assert device == "cuda" and tcfg.aux_channels == (3,)
    arrays = _to_numpy(j0)
    back = state_to_numpy(state_from_numpy(fields, arrays, "cpu"))
    for name in _FIELDS:
        if name == "aux":
            assert len(back[name]) == 1
            np.testing.assert_array_equal(back[name][0], arrays[name][0])
        elif arrays[name] is None:
            assert back[name] is None
        else:
            np.testing.assert_array_equal(back[name], arrays[name])
    with pytest.raises(ValueError):
        state_from_numpy(fields, dict(arrays, bias=None), "cpu")
    with pytest.raises(ValueError):
        state_from_numpy(fields, dict(arrays, vs=arrays["vs"][:, :64]),
                         "cpu")


def test_config_values_match_jax():
    for enum_name in ("EnergyFunc", "ResizeOrder"):
        got = {e.name: int(e) for e in getattr(tconfig, enum_name)}
        want = {e.name: int(e) for e in getattr(jconfig, enum_name)}
        assert got == want
    for name in ("DEFAULT_SIDE_SWITCH_FREQUENCY", "MAX_DELTA_X",
                 "MIN_ENL_STEP", "MAX_ENL_STEP"):
        assert getattr(tconfig, name) == getattr(jconfig, name)


def test_errors_and_messages_match_jax(monkeypatch):
    for cls in ("LqrError", "LqrConfigError", "LqrImageError",
                "LqrStateError"):
        assert issubclass(getattr(terrors, cls), terrors.LqrError)
    import lqr_tpu.i18n as ji18n
    for lang in ("", "it"):
        monkeypatch.setenv("LANGUAGE", lang)
        for mod in (ti18n, ji18n):
            mod.reset()
        try:
            for check, args in ((jerrors.check_channels, (5,)),
                                (jerrors.check_target_size, (0, 3))):
                with pytest.raises(jerrors.LqrError) as want:
                    check(*args)
                with pytest.raises(terrors.LqrError) as got:
                    getattr(terrors, check.__name__)(*args)
                assert str(got.value) == str(want.value)
                assert type(got.value).__name__ == type(want.value).__name__
        finally:
            for mod in (ti18n, ji18n):
                mod.reset()
    # the port reads its own copies of the catalogs (test_torch_i18n.py
    # holds them equal to the JAX package's)
    assert (os.path.dirname(ti18n.BUNDLED_DIR)
            == os.path.dirname(os.path.abspath(ti18n.__file__)))


def test_batch_state_round_trip_and_continuation():
    """A ragged JAX batch carved part-way (masks, an aux image) goes on in
    the port, bit-equal to JAX's continuation, and comes back."""
    from lqr_tpu.parallel import batch as jbatch
    from lqr_tpu_torch.convert import (batch_state_from_numpy,
                                       batch_state_to_numpy)
    from lqr_tpu_torch.parallel import batch as tbatch
    rng = np.random.default_rng(21)
    sizes = [(14, 60), (10, 50), (14, 40)]
    imgs = [(random_image(rng, h, w, 3) // 8) * 8 for h, w in sizes]
    biases = [rng.standard_normal((h, w)).astype(np.float32)
              for h, w in sizes]
    aux = [[random_image(rng, h, w, 1)] for h, w in sizes]
    j = jbatch.BatchCarver(imgs, biases=biases, rigidity=3.0, delta_x=2,
                           aux=aux, use_pallas=False)
    j.carve(np.array([4, 6, 2]))
    fields = dataclasses.asdict(j.cfg)
    tcfg, device = config_from_jax_fields(fields)
    arrays = dict(_to_numpy(j.state), heights=j.heights)
    t, heights = batch_state_from_numpy(fields, arrays, device)
    np.testing.assert_array_equal(heights, j.heights)
    np.testing.assert_array_equal(t.ref_w, [60, 50, 40])
    np.testing.assert_array_equal(t.depth, [4, 6, 2])
    back = batch_state_to_numpy(t, heights)
    for name in _FIELDS + ("heights",):
        if name == "aux":
            np.testing.assert_array_equal(back[name][0], arrays[name][0])
        elif arrays[name] is None:
            assert back[name] is None
        else:
            assert back[name].dtype == np.asarray(arrays[name]).dtype, name
            np.testing.assert_array_equal(back[name], arrays[name])

    n = np.array([3, 0, 5])
    j.carve(n)
    t = tbatch.extend_batched(tcfg, t, n, heights,
                              tbatch.rigc_table(heights, 2))
    for name in ("vs", "cur_b", "cur_bias", "cur_rig"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j.state, name)))
    w = np.array([53, 44, 33])
    img, aux_t = tbatch.materialize_all_batched(tcfg, t, w, tcfg.Wb)
    img_j, aux_j = jbatch.materialize_all_batched(j.cfg, j.state,
                                                  jnp.asarray(w), j.cfg.Wb)
    np.testing.assert_array_equal(img.numpy(), np.asarray(img_j))
    np.testing.assert_array_equal(aux_t[0].numpy(), np.asarray(aux_j[0]))
    with pytest.raises(ValueError, match="heights"):
        batch_state_from_numpy(fields, dict(arrays, heights=[14, 10]),
                               device)
    with pytest.raises(ValueError, match="ref_w"):
        batch_state_from_numpy(fields, dict(arrays, ref_w=[60, 50]), device)
