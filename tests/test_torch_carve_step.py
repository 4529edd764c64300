"""The port's fused seam step (lqr_tpu_torch.ops.carve_step, plain versions
on the CPU) against the JAX package's carve_step_pallas, whose Pallas
kernels run in interpreter mode (LQR_PALLAS_INTERPRET=1) as
tests/test_pallas_dp.py runs them; against JAX's unfused step (energy, scan
DP, roll/select compaction) on a shape JAX's fused_ok refuses; and the
seam loop of chip_smoke.py (carve_step per seam, _commit_hist per chunk)
against lqr_tpu's extend_map(use_pallas=False) and native.carve.

Tolerance 0 on the seam and on every compacted plane at every column."""

import importlib.util
import itertools
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lqr_tpu.core import dp as jdp
from lqr_tpu.core import engine as jeng
from lqr_tpu.core import state as jst
from lqr_tpu.core.energy import energy_from_plane
from lqr_tpu_torch import native
from lqr_tpu_torch.core import state as tst
from lqr_tpu_torch.ops import carve_step as tcs
from lqr_tpu_torch.ops import dp_cuda

torch.set_num_threads(1)

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    """chip_smoke.py as a module (it imports nothing of the package at its
    top level), for its carve_step loop."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _planes(seed, H, W, Wb, has_bias, has_rig, levels=16):
    """Reader plane of few levels (ties on purpose), a bias of integers and
    an |normal| rigidity, zero past W, as tests/test_pallas_dp.py makes
    them."""
    rng = np.random.default_rng(seed)
    b = np.zeros((H, Wb), np.float32)
    b[:, :W] = np.round(rng.random((H, W), dtype=np.float32) * levels) / levels
    bias = np.zeros((H, Wb), np.float32)
    rig = np.zeros((H, Wb), np.float32)
    if has_bias:
        bias[:, :W] = np.round(rng.standard_normal((H, W)) * 4)
    if has_rig:
        rig[:, :W] = np.abs(rng.standard_normal((H, W)))
    return b, bias, rig


def _ref_carve_once(b, bias, rig, w, pref, delta_x, has_bias, has_rig, nrg):
    """JAX's unfused step: energy_from_plane + scan DP + roll/select
    compaction (tests/test_pallas_dp.py:_ref_carve_once)."""
    H, Wb = b.shape
    lane = jnp.broadcast_to(jnp.arange(Wb, dtype=jnp.int32), (H, Wb))
    e = energy_from_plane(b, w, nrg)
    if has_bias:
        e = jnp.where(lane < w, e + bias, jnp.inf)
    seam = jdp.find_seam(e, rig, pref, delta_x, has_rig)
    ge = lane >= seam[:, None]
    keep = lane < (w - 1)

    def compact(a):
        return jnp.where(keep, jnp.where(ge, jnp.roll(a, -1, axis=1), a),
                         jnp.float32(0))

    return (seam, compact(b), compact(bias) if has_bias else bias,
            compact(rig) if has_rig else rig)


def _port_step(b, bias, rig, w, pref, dx, has_bias, has_rig, nrg, fuse):
    """carve_step on CPU tensors; absent planes are None and come back so,
    and no kernel launch is counted."""
    before = dict(dp_cuda.LAUNCHES)
    got = tcs.carve_step(torch.from_numpy(np.asarray(b)),
                         torch.from_numpy(bias) if has_bias else None,
                         torch.from_numpy(rig) if has_rig else None,
                         w, pref, dx, has_bias, has_rig, nrg,
                         fuse_energy=fuse)
    assert dp_cuda.LAUNCHES == before
    assert (got[2] is None) == (not has_bias)
    assert (got[3] is None) == (not has_rig)
    return got


def _assert_step_equal(got, want, has_bias, has_rig, msg):
    names = ("seam", "b", "bias", "rig")
    present = (True, True, has_bias, has_rig)
    for g, e, name, on in zip(got, want, names, present):
        if on:
            np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                          err_msg=f"{name} {msg}")


# Each energy with each mask set. carve_step_pallas compiles once per
# (energy, masks, delta_x, mode), so each case runs it at one delta_x in one
# mode, and the four (mode, delta_x) pairs alternate over the cases (each
# is met three times); the other delta_x is held against JAX's unfused
# step. The port runs both modes and both side preferences every time.
_CASES = [(nrg, masks, 1 + i % 2, (i // 2) % 2 == 1)
          for i, (nrg, masks) in enumerate(itertools.product(
              (0, 1, 2, 6), ((False, False), (True, False), (True, True))))]


@pytest.mark.parametrize("nrg,masks,dx,jax_fuse", _CASES)
def test_carve_step_matches_pallas(monkeypatch, nrg, masks, dx, jax_fuse):
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    from lqr_tpu.ops import dp_pallas
    has_bias, has_rig = masks
    H, W, Wb = 32, 1000, 1024
    assert dp_pallas.fused_ok(H, Wb) and tcs.fused_ok(H, Wb, dx)
    b, bias, rig = _planes(5 + nrg, H, W, Wb, has_bias, has_rig)
    for pref in (True, False):
        jargs = (jnp.asarray(b), jnp.asarray(bias), jnp.asarray(rig),
                 jnp.int32(W), jnp.bool_(pref))
        flags = (has_bias, has_rig, nrg)
        want = {dx: dp_pallas.carve_step_pallas(*jargs, dx, *flags,
                                                fuse_energy=jax_fuse),
                3 - dx: _ref_carve_once(*jargs, 3 - dx, *flags)}
        for d, fuse in itertools.product((1, 2), (False, True)):
            got = _port_step(b, bias, rig, W, pref, d, *flags, fuse)
            _assert_step_equal(got, want[d], has_bias, has_rig,
                               f"{pref=} delta_x={d} {fuse=}")


def test_carve_step_nonpow2_matches_pallas(monkeypatch):
    """24 x 768 at W = 760: a lane count the TPU kernels fold into a
    non-power-of-two L (fused_ok admits it at delta_x = 1). Runs with the
    persistent compile cache off, as tests/test_pallas_dp.py runs it."""
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    from lqr_tpu.ops import dp_pallas
    H, W, Wb = 24, 760, 768
    assert dp_pallas.fused_ok(H, Wb, 1)
    b, bias, rig = _planes(11, H, W, Wb, False, False, levels=8)
    z = jnp.zeros((H, Wb), jnp.float32)
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        for pref in (True, False):
            want = dp_pallas.carve_step_pallas(
                jnp.asarray(b), z, z, jnp.int32(W), jnp.bool_(pref), 1,
                False, False, 0, fuse_energy=True)
            for fuse in (False, True):
                got = _port_step(b, bias, rig, W, pref, 1, False, False, 0,
                                 fuse)
                _assert_step_equal(got, want, False, False, f"{pref=}")
    finally:
        jax.config.update("jax_enable_compilation_cache", True)


def test_carve_step_sqrt_energy_shrinking_width(monkeypatch):
    """GRAD_NORM over four successive widths, each step on the previous
    step's compacted plane (the in-loop situation), the port alternating
    its two modes."""
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    from lqr_tpu.ops import dp_pallas
    rng = np.random.default_rng(9)
    H, W, Wb = 16, 512, 512
    b = rng.random((H, Wb), dtype=np.float32)
    z = jnp.zeros((H, Wb), jnp.float32)
    bj, bt = jnp.asarray(b), torch.from_numpy(b)
    for k in range(4):
        w, pref = W - k, k % 2 == 0
        want = dp_pallas.carve_step_pallas(bj, z, z, jnp.int32(w),
                                           jnp.bool_(pref), 1, False, False,
                                           2)
        got = tcs.carve_step(bt, None, None, w, pref, 1, False, False, 2,
                             fuse_energy=k % 2 == 1)
        _assert_step_equal(got, want, False, False, f"{k=}")
        bj, bt = want[1], got[1]


@pytest.mark.parametrize("dx", [1, 2])
def test_carve_step_where_jax_fused_ok_refuses(dx):
    """H = 300 leaves H % BR rows that the TPU grid would drop, so JAX's
    fused_ok refuses the shape; the port's limits are its own, and it
    carves it equal to JAX's unfused step."""
    from lqr_tpu.ops import dp_pallas
    H, W, Wb = 300, 1000, 1024
    assert not dp_pallas.fused_ok(H, Wb, dx)
    assert tcs.fused_ok(H, Wb, dx)
    b, bias, rig = _planes(44 + dx, H, W, Wb, True, True)
    for pref in (True, False):
        want = _ref_carve_once(jnp.asarray(b), jnp.asarray(bias),
                               jnp.asarray(rig), jnp.int32(W),
                               jnp.bool_(pref), dx, True, True, 1)
        for fuse in (False, True):
            got = _port_step(b, bias, rig, W, pref, dx, True, True, 1, fuse)
            _assert_step_equal(got, want, True, True, f"{pref=} {fuse=}")


# Widths past one block's shared-memory frontier (two rows of Wb f32) that
# JAX's fused_ok takes (a fold factor > 1): (Wb, delta_x, masks,
# carve_step_pallas's mode, its side preference); the other preference is
# held against JAX's unfused step, which is faster in interpret mode. At
# 8 x 32768 and delta_x = 2 carve_step_pallas raises in interpret mode
# (a 16-row slice of an 8-row block) although fused_ok takes the shape, so
# both preferences are held against the unfused step there (None).
_WIDE = [(29696, 1, False, True, True),
         (32768, 1, False, False, False),
         (32768, 2, True, True, None)]


@pytest.mark.parametrize("Wb,dx,masks,jax_fuse,jax_pref", _WIDE)
def test_carve_step_takes_every_width_jax_fused_ok_takes(
        monkeypatch, Wb, dx, masks, jax_fuse, jax_pref):
    """H = 8 at widths past the old 29 024-column cap: the port's fused_ok
    takes each, and both modes of carve_step equal JAX's step bit for
    bit."""
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    from lqr_tpu.ops import dp_pallas
    H, W = 8, Wb - 70
    assert dp_pallas.fused_ok(H, Wb, dx) and tcs.fused_ok(H, Wb, dx)
    b, bias, rig = _planes(Wb + dx, H, W, Wb, masks, masks)
    flags = (masks, masks, 1 if masks else 0)
    for pref in (True, False):
        jargs = (jnp.asarray(b), jnp.asarray(bias), jnp.asarray(rig),
                 jnp.int32(W), jnp.bool_(pref))
        want = (dp_pallas.carve_step_pallas(*jargs, dx, *flags,
                                            fuse_energy=jax_fuse)
                if pref == jax_pref else _ref_carve_once(*jargs, dx, *flags))
        for fuse in (False, True):
            got = _port_step(b, bias, rig, W, pref, dx, *flags, fuse)
            _assert_step_equal(got, want, masks, masks, f"{pref=} {fuse=}")


def test_carve_step_parts_equal_their_plain_versions():
    """dp_energy_forward and backtrack_compact on CPU tensors are their
    plain versions; a width below the buffer, rigidity at delta_x = 2."""
    H, W, Wb, w = 40, 250, 256, 231
    b, bias, rig = (torch.from_numpy(p)
                    for p in _planes(3, H, W, Wb, True, True))
    args = (b, bias, rig, w, False, 2, True, True, 1)
    M, bp = tcs.dp_energy_forward(*args)
    M_p, bp_p = tcs.dp_energy_forward_plain(*args)
    assert torch.equal(M, M_p) and torch.equal(bp, bp_p)
    assert bp.dtype == torch.int8 and (M[w:] == torch.inf).all()
    got = tcs.backtrack_compact(M, bp, b, bias, rig, w, False, True, True)
    want = tcs.backtrack_compact_plain(M, bp, b, bias, rig, w, False, True,
                                       True)
    step = tcs.carve_step_plain(*args)
    for g, e, s in zip(got, want, step):
        assert torch.equal(g, e) and torch.equal(g, s)
    assert (got[1][:, w - 1:] == 0).all()


def test_carve_step_checks_arguments():
    H, Wb = 8, 128
    b = torch.zeros((H, Wb))
    ok = (b, None, None, 100, True, 1, False, False, 0)
    tcs.carve_step(*ok)
    bad = [
        ((b, None, None, 0, True, 1, False, False, 0), "w=0"),
        ((b, None, None, Wb + 1, True, 1, False, False, 0), "w=129"),
        ((b, None, None, 100, True, 11, False, False, 0), "delta_x=11"),
        ((b, None, None, 100, True, 1, False, False, 7), "nrg=7"),
        ((b, None, None, 100, True, 1, True, False, 0), "cur_bias is None"),
        ((b, None, b[:4], 100, True, 1, False, True, 0), "cur_rig: shape"),
        ((b.t(), None, None, 100, True, 1, False, False, 0),
         "not contiguous"),
        ((b[0], None, None, 100, True, 1, False, False, 0), r"\[H, Wb\]"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            tcs.carve_step(*args)
    with pytest.raises(TypeError, match="dtype"):
        tcs.carve_step(b.double(), *ok[1:])
    assert tcs.fused_ok(H, 65536, 10) and tcs.fused_ok(1, 1, 0)
    assert not tcs.fused_ok(0, Wb) and not tcs.fused_ok(H, 0)
    assert not tcs.fused_ok(H, Wb, 11) and not tcs.fused_ok(H, Wb, -1)


def _loop_states(img, bias, rig, Wb, **kw):
    H = img.shape[0]
    kw = dict(H=H, Wb=Wb, C=3, has_bias=bias is not None,
              has_rig=rig is not None, **kw)
    jcfg = jst.EngineConfig(use_pallas=False, **kw)
    tcfg = tst.EngineConfig(**kw)
    return (jcfg, jst.init_state(jcfg, img, bias=bias, rig=rig),
            tcfg, tst.init_state(tcfg, img, bias=bias, rig=rig,
                                 device="cpu"))


@pytest.mark.parametrize("nrg,dx,masks,fuse", [
    (0, 1, False, False),
    (0, 1, False, True),
    (1, 2, True, True),
])
def test_carve_step_loop_matches_extend_map(nrg, dx, masks, fuse):
    """20 seams at 32 x 1024 through chip_smoke.py's carve_step loop give
    the visibility map and planes of lqr_tpu's extend_map."""
    rng = np.random.default_rng(20 + nrg)
    H, W, k = 32, 1024, 20
    img = (rng.integers(0, 8, (H, W, 3)) * 32).astype(np.uint8)
    bias = (np.round(rng.standard_normal((H, W)) * 4).astype(np.float32)
            / 8 if masks else None)
    rig = np.abs(rng.standard_normal((H, W))).astype(np.float32) \
        if masks else None
    jcfg, j, tcfg, t = _loop_states(img, bias, rig, W, delta_x=dx, nrg=nrg)
    want = jeng.extend_map(jcfg, j, jnp.int32(k))
    got = _chip_smoke().carve_step_loop(tcfg, t, k, fuse)
    assert got.depth == k and not t.vs.any()
    for name in ("vs", "cur_b", "cur_bias", "cur_rig"):
        g, e = getattr(got, name), getattr(want, name)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                          err_msg=name)


def test_carve_step_loop_sqrt_energy_matches_native():
    """GRAD_NORM with bias and rigidity over 140 seams (a 128-seam commit
    and a partial one), both modes, against the C++ reference: the sqrt
    energies are held against native.carve (tests/test_fuzz_triangle.py)."""
    rng = np.random.default_rng(31)
    H, W, k = 16, 256, 140
    img = (rng.integers(0, 8, (H, W, 3)) * 32).astype(np.uint8)
    bias = np.round(rng.standard_normal((H, W)) * 4).astype(np.float32) / 8
    rig = np.abs(np.round(rng.standard_normal((H, W)) * 4)).astype(
        np.float32)
    want = native.carve(img, k, bias=bias, rig=rig, nrg=2)
    cfg = tst.EngineConfig(H=H, Wb=W, C=3, nrg=2, has_bias=True,
                           has_rig=True)
    st = tst.init_state(cfg, img, bias=bias, rig=rig, device="cpu")
    loop = _chip_smoke().carve_step_loop
    for fuse in (False, True):
        got = loop(cfg, st, k, fuse)
        np.testing.assert_array_equal(got.vs.numpy(), want,
                                      err_msg=f"{fuse=}")
