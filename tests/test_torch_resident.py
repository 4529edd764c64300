"""The port's resident chunk carve (lqr_tpu_torch.ops.carve_resident, plain
version on the CPU) against the JAX package's carve_chunk_resident, whose
Pallas kernel runs in interpreter mode (LQR_PALLAS_INTERPRET=1) as
tests/test_carve_resident.py runs it; the resident route's commits against
lqr_tpu's _commit_ref_hist; the port's two extend_map routes against each
other and against lqr_tpu's extend_map(use_pallas=False); and the port's
resident gate.

Tolerance 0 everywhere: the committed visibility maps, the compacted
planes at every column, posmap below the new width."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lqr_tpu.core import engine as jeng
from lqr_tpu.core import state as jst
from lqr_tpu_torch.core import engine as teng
from lqr_tpu_torch.core import state as tst
from lqr_tpu_torch.ops import carve_resident as tcr
from lqr_tpu_torch.ops import dp_cuda

torch.set_num_threads(1)


def _planes(seed, H, Wb, has_bias, has_rig, w=None):
    """Quantized image (ties on purpose), normal bias, |normal| rigidity,
    as tests/test_carve_resident.py makes them."""
    rng = np.random.default_rng(seed)
    w = Wb if w is None else w
    img = (rng.integers(0, 8, (H, w, 3)) * 32).astype(np.uint8)
    bias = (rng.standard_normal((H, w)).astype(np.float32)
            if has_bias else None)
    rig = (np.abs(rng.standard_normal((H, w))).astype(np.float32)
           if has_rig else None)
    return img, bias, rig


def _pair(img, bias, rig, Wb, **kw):
    H = img.shape[0]
    kw = dict(H=H, Wb=Wb, C=3, has_bias=bias is not None,
              has_rig=rig is not None, **kw)
    jcfg = jst.EngineConfig(use_pallas=False, **kw)
    tcfg = tst.EngineConfig(**kw)
    return (jcfg, jst.init_state(jcfg, img, bias=bias, rig=rig),
            tcfg, tst.init_state(tcfg, img, bias=bias, rig=rig,
                                 device="cpu"))


def _port_chunk(t, w0, d0, kc, dx, has_bias, has_rig, nrg):
    pm = teng._posmap(t.vs, t.ref_w)
    return tcr.carve_chunk_resident(t.cur_b, t.cur_bias, t.cur_rig, pm, w0,
                                    d0, kc, dx, has_bias, has_rig, nrg, 2,
                                    teng.KC)


@pytest.mark.parametrize("has_bias,has_rig,nrg,dx", [
    (False, False, 0, 1),
    (True, True, 0, 1),
    (True, True, 1, 2),
    (False, True, 2, 3),
    (True, False, 5, 1),
    (False, False, 6, 1),
])
def test_plain_matches_jax_resident(monkeypatch, has_bias, has_rig, nrg,
                                    dx):
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    from lqr_tpu.ops.carve_resident import carve_chunk_resident
    H, Wb, kc = 16, 256, 6
    img, bias, rig = _planes(1234 + nrg, H, Wb, has_bias, has_rig)
    jcfg, j, tcfg, t = _pair(img, bias, rig, Wb, delta_x=dx, nrg=nrg)
    b_before = t.cur_b.clone()
    jh, jb, jbias, jrig, jpm = carve_chunk_resident(
        j.cur_b, j.cur_bias, j.cur_rig, jeng._posmap_from_vs(j.vs, j.ref_w),
        j.ref_w, jnp.int32(0), jnp.int32(kc), dx, has_bias, has_rig, nrg,
        jcfg.side_switch_freq, jeng.KC)
    th, tb, tbias, trig, tpm = _port_chunk(t, Wb, 0, kc, dx, has_bias,
                                           has_rig, nrg)
    np.testing.assert_array_equal(th[:kc].numpy(), np.asarray(jh)[:kc])
    assert (th[kc:] == -1).all()
    vs_j = jeng._commit_ref_hist(j.vs, jnp.int32(0), jnp.int32(kc), jh)
    assert teng.route(tcfg) == "resident"      # one chunk, one commit
    t1 = teng.extend_map(tcfg, t, kc)
    np.testing.assert_array_equal(t1.vs.numpy(), np.asarray(vs_j))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    if has_bias:
        np.testing.assert_array_equal(tbias.numpy(), np.asarray(jbias))
    if has_rig:
        np.testing.assert_array_equal(trig.numpy(), np.asarray(jrig))
    np.testing.assert_array_equal(tpm[:, :Wb - kc].numpy(),
                                  np.asarray(jpm)[:, :Wb - kc])
    assert torch.equal(t.cur_b, b_before)     # the input is left as it is


def test_chunks_at_depth_compose_like_jax(monkeypatch):
    """Two chunks of the port's resident route (KC = 4: d0 = 0, then
    d0 = 4) commit the map of one JAX chunk of 8 seams."""
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    from lqr_tpu.ops.carve_resident import carve_chunk_resident
    H, Wb = 16, 256
    img, _, _ = _planes(7, H, Wb, False, False)
    jcfg, j, tcfg, t = _pair(img, None, None, Wb)
    jh, *_ = carve_chunk_resident(
        j.cur_b, None, None, jeng._posmap_from_vs(j.vs, j.ref_w), j.ref_w,
        jnp.int32(0), jnp.int32(8), 1, False, False, 0, 2, jeng.KC)
    vs_j = jeng._commit_ref_hist(j.vs, jnp.int32(0), jnp.int32(8), jh)

    monkeypatch.setattr(teng, "KC", 4)
    assert teng.route(tcfg) == "resident"
    t1 = teng.extend_map(tcfg, t, 8)
    assert t1.depth == 8
    np.testing.assert_array_equal(t1.vs.numpy(), np.asarray(vs_j))


@pytest.mark.parametrize("has_bias,has_rig,dx", [(False, False, 1),
                                                 (True, True, 2)])
def test_routes_match_jax_across_a_chunk(monkeypatch, has_bias, has_rig,
                                        dx):
    """k = 140 crosses the 128-seam chunk; extend_map on each of the port's
    routes gives lqr_tpu's state, then a second call extends from depth
    140."""
    H, w, Wb, k = 6, 300, 384, 140
    img, bias, rig = _planes(11 + dx, H, Wb, has_bias, has_rig, w=w)
    jcfg, j, tcfg, t = _pair(img, bias, rig, Wb, delta_x=dx)
    assert tcr.resident_ok(1, H, Wb, has_bias, has_rig)
    j1 = jeng.extend_map(jcfg, j, jnp.int32(k))
    j2 = jeng.extend_map(jcfg, j1, jnp.int32(9))
    for route in ("resident", "per_seam"):
        monkeypatch.setattr(teng, "route", lambda cfg, r=route: r)
        t1 = teng.extend_map(tcfg, t, k)
        t2 = teng.extend_map(tcfg, t1, 9)
        for got, want in ((t1, j1), (t2, j2)):
            assert got.depth == int(want.depth)
            for name in ("vs", "cur_b", "cur_bias", "cur_rig"):
                g, e = getattr(got, name), getattr(want, name)
                assert (g is None) == (e is None), name
                if g is not None:
                    np.testing.assert_array_equal(
                        g.numpy(), np.asarray(e), err_msg=route)
    assert not t.vs.any()


def test_gate():
    # the configurations of scripts/bench_all.py that it must admit
    assert tcr.resident_bytes(384, 512, False, False) == 1769472
    assert tcr.resident_ok(1, 384, 512, False, False)
    assert tcr.resident_bytes(768, 1024, True, True) == 13369344
    assert tcr.resident_ok(1, 768, 1024, True, True)
    # the 2048^2 main path, the largest map measured, takes the resident
    # route; one column more, with bias and rigidity (71 MB of planes), or
    # larger, the per-seam route
    assert tcr.resident_bytes(2048, 2048, False, False) == 37748736
    assert tcr.resident_bytes(2048, 2048, False, False) == tcr.RESIDENT_BUDGET
    assert tcr.resident_ok(1, 2048, 2048, False, False)
    assert not tcr.resident_ok(1, 2048, 2049, False, False)
    assert tcr.resident_bytes(2048, 2048, True, True) == 71303168
    assert not tcr.resident_ok(1, 2048, 2048, True, True)
    assert not tcr.resident_ok(1, 2048, 2560, False, False)
    assert not tcr.resident_ok(1, 16, tcr.MAX_WB + 128, False, False)
    assert tcr.resident_ok(1, 16, 384, False, False)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    before = dict(dp_cuda.LAUNCHES)
    b = torch.zeros((8, 128))
    pm = torch.zeros((8, 128), dtype=torch.int32)
    args = (b, None, None, pm, 128, 0, 4, 1, False, False, 0, 2, 128)

    def call(**over):
        names = ("cur_b", "cur_bias", "cur_rig", "posmap", "w0", "d0", "kc",
                 "delta_x", "has_bias", "has_rig", "nrg", "ssf", "KC")
        kw = dict(zip(names, args), **over)
        return tcr.carve_chunk_resident(**kw)

    with pytest.raises(TypeError):
        call(cur_b=b.double())
    with pytest.raises(TypeError):
        call(posmap=pm.long())
    with pytest.raises(ValueError):
        call(has_bias=True)                      # bias missing
    with pytest.raises(ValueError):
        call(kc=129)
    with pytest.raises(ValueError):
        call(w0=3)                               # fewer columns than seams
    with pytest.raises(ValueError):
        call(nrg=7)
    hist, b2, _, _, pm2 = call()
    assert hist.shape == (128, 8) and (hist[4:] == -1).all()
    assert (b2[:, 124:] == 0).all() and (pm2[:, 124:] == 0).all()
    assert dp_cuda.LAUNCHES == before     # CPU tensors run the plain path
