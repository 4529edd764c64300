"""The port's sharded paths (lqr_tpu_torch.parallel.sharding on CPU shards,
plain versions of the kernels) against the JAX package's
``lqr_tpu.parallel.sharding`` on the virtual 8-device CPU mesh.

The port's mesh is one process with each shard a tensor of its own; here
every shard lies on the CPU. Tolerance 0 everywhere. The DP block's plain
version is held against JAX's ``dp_block_pallas`` in interpreter mode
(LQR_PALLAS_INTERPRET=1) over the cases of
tests/test_parallel.py::test_sharded_dp_pallas_block_bit_exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_image
from lqr_tpu.core import dp as jdp
from lqr_tpu.parallel import batch as jbatch
from lqr_tpu.parallel import sharding as jshard
from lqr_tpu_torch import LqrConfigError, LqrImageError
from lqr_tpu_torch.core import dp as tdp
from lqr_tpu_torch.ops import dp_block as tdpb
from lqr_tpu_torch.ops import dp_cuda
from lqr_tpu_torch.parallel import batch as tbatch
from lqr_tpu_torch.parallel import sharding as tshard

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("the JAX side needs the 8-device CPU mesh")


def _cpu_mesh(n, data=None):
    """A mesh of n CPU shards (make_mesh takes the CUDA devices unless
    given others)."""
    return tshard.make_mesh(devices=["cpu"] * n, data=data)


def _energy(seed, H, Wb, ties=True):
    rng = np.random.default_rng(seed)
    e = rng.random((H, Wb), dtype=np.float32)
    if ties:
        e = np.round(e * 8) / 8
    rig = np.abs(rng.standard_normal((H, Wb))).astype(np.float32)
    return e, rig


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("pref,dx,has_rig", [(True, 1, False),
                                             (False, 1, True),
                                             (True, 2, True)])
def test_dp_block_plain_matches_pallas(monkeypatch, pref, dx, has_rig,
                                       first):
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    from lqr_tpu.ops.dp_block import dp_block_pallas
    R, We, H = 8, 256, 32
    e, rig = _energy(17 + dx, R, We)
    e[:, :3] = np.inf                    # a mesh edge's +inf halo
    m0 = np.round(np.random.default_rng(dx).random(We, np.float32) * 8) / 8
    m0[-2:] = np.inf
    want = dp_block_pallas(jnp.asarray(m0), jnp.asarray(e),
                           jnp.asarray(rig) if has_rig else None,
                           jnp.bool_(pref), jnp.bool_(first), dx, has_rig, R,
                           H)
    before = dict(dp_cuda.LAUNCHES)
    got = tdpb.dp_block(torch.from_numpy(m0), torch.from_numpy(e),
                        torch.from_numpy(rig) if has_rig else None, pref,
                        first, dx, has_rig, H)
    assert dp_cuda.LAUNCHES == before     # CPU tensors run the plain path
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int8
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_dp_block_checks_inputs():
    e = torch.zeros((4, 100))
    with pytest.raises(ValueError):
        tdpb.dp_block(torch.zeros(99), e, None, True, False, 1, False, 16)
    with pytest.raises(ValueError):
        tdpb.dp_block(torch.zeros(100), e, None, True, False, 1, True, 16)
    with pytest.raises(TypeError):
        tdpb.dp_block(torch.zeros(100), e.double(), None, True, False, 1,
                      False, 16)
    # any width: no multiple of 128 needed, unlike the Pallas kernel
    m, bp = tdpb.dp_block(torch.zeros(100), e, None, True, True, 1, False,
                          16)
    assert m.shape == (100,) and bp.shape == (4, 100)


@functools.lru_cache(maxsize=None)
def _jax_seams(dx, has_rig, pref):
    """(JAX sharded seam on make_mesh(8, data=1), core.dp seam)."""
    e, rig = _energy(5, 16, 1024)
    args = (jnp.asarray(e), jnp.asarray(rig), jnp.bool_(pref), dx, has_rig)
    sharded = jshard.find_seam_sharded(jshard.make_mesh(8, data=1), *args)
    return np.asarray(sharded), np.asarray(jdp.find_seam(*args))


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("dx,has_rig,pref", [(1, False, True),
                                             (2, True, False)])
def test_find_seam_sharded_matches_jax(n_shards, dx, has_rig, pref):
    e, rig = _energy(5, 16, 1024)
    want_sharded, want = _jax_seams(dx, has_rig, pref)
    np.testing.assert_array_equal(want_sharded, want)
    mesh = _cpu_mesh(n_shards, data=1)
    assert mesh.shape == {"data": 1, "cols": n_shards}
    got = tshard.find_seam_sharded(mesh, torch.from_numpy(e),
                                   torch.from_numpy(rig) if has_rig else None,
                                   pref, dx, has_rig)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tdp.find_seam(torch.from_numpy(e), torch.from_numpy(rig), pref,
                          dx, has_rig)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def _masked_batch(seed, B, H, W):
    rng = np.random.default_rng(seed)
    imgs = [random_image(rng, H, W, 3) for _ in range(B)]
    biases = [rng.standard_normal((H, W)).astype(np.float32) for _ in imgs]
    rigmasks = [np.abs(rng.standard_normal((H, W))).astype(np.float32)
                for _ in imgs]
    return imgs, dict(biases=biases, rigmasks=rigmasks, rigidity=10.0)


@pytest.mark.parametrize("n_data", [2, 8])
def test_data_parallel_matches_jax(n_data):
    """The batch split over 'data' (no exchange): the same maps and images
    as JAX's data-parallel BatchCarver and as the port unsharded."""
    rng = np.random.default_rng(23)
    imgs = [random_image(rng, 16, 24 + 4 * (i % 3), 3) for i in range(8)]
    biases = [rng.standard_normal(im.shape[:2]).astype(np.float32)
              for im in imgs]
    kw = dict(biases=biases, rigidity=10.0)
    j = jbatch.BatchCarver(imgs, mesh=jshard.make_mesh(8, data=8), **kw)
    j.carve(5)
    t = tbatch.BatchCarver(imgs, mesh=_cpu_mesh(n_data, data=n_data),
                           device="cpu", **kw)
    assert not t.col_sharded and len(t._state.shards) == n_data
    t.carve(5)
    solo = tbatch.BatchCarver(imgs, device="cpu", **kw)
    solo.carve(5)
    np.testing.assert_array_equal(t.state.vs.numpy(), np.asarray(j.state.vs))
    assert torch.equal(t.state.vs, solo.state.vs)
    for a, b in zip(t.images_at(20), j.images_at(20)):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_col_sharded():
    imgs, kw = _masked_batch(31, 2, 16, 256)
    mesh = jshard.make_mesh(8, data=2)            # 2 x 4: data AND cols
    j = jbatch.BatchCarver(imgs, mesh=mesh, **kw)
    assert j.col_sharded
    j.carve(12)
    return (np.asarray(j.state.vs), np.asarray(j.state.cur_b),
            [np.asarray(a) for a in j.images_at(244)])


@pytest.mark.parametrize("n_data,n_cols", [(2, 4), (1, 2), (1, 8), (2, 1)])
def test_column_sharded_resize_matches_jax(n_data, n_cols):
    """BatchCarver on a (data, cols) mesh of CPU shards: the column-sharded
    resize (every seam step on the image's column shards) gives JAX's
    column-sharded maps on its 2 x 4 mesh, for 1, 2, 4 and 8 shards."""
    imgs, kw = _masked_batch(31, 2, 16, 256)
    want_vs, want_b, want_imgs = _jax_col_sharded()
    mesh = _cpu_mesh(n_data * n_cols, data=n_data)
    t = tbatch.BatchCarver(imgs, mesh=mesh, device="cpu", **kw)
    assert t.col_sharded == (n_cols > 1)
    t.carve(12)
    st = t.state
    np.testing.assert_array_equal(st.vs.numpy(), want_vs)
    np.testing.assert_array_equal(st.cur_b.numpy(), want_b)
    np.testing.assert_array_equal(st.depth, [12, 12])
    for a, b in zip(t.images_at(244), want_imgs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nrg", [1, 2])
def test_column_sharded_per_image_counts_and_nrg(nrg):
    """Per-image seam counts and the SUMABS and NORM energies (the y
    gradient inside each shard) on 4 column shards equal the unsharded
    port."""
    imgs, kw = _masked_batch(41, 2, 8, 256)
    n = np.array([7, 3])
    shd = tbatch.BatchCarver(imgs, mesh=_cpu_mesh(4, data=1),
                             device="cpu", nrg=nrg, delta_x=2, **kw)
    shd.carve(n)
    solo = tbatch.BatchCarver(imgs, device="cpu", nrg=nrg, delta_x=2, **kw)
    solo.carve(n)
    for name in ("vs", "cur_b", "cur_bias", "cur_rig"):
        assert torch.equal(getattr(shd.state, name),
                           getattr(solo.state, name)), name


def test_sharded_seam_step_bias_rig():
    rng = np.random.default_rng(31)
    B, H, Wb = 2, 16, 256
    imgs = np.stack([random_image(rng, H, Wb, 3) for _ in range(B)])
    bias = rng.standard_normal((B, H, Wb)).astype(np.float32)
    rig = np.abs(rng.standard_normal((B, H, Wb))).astype(np.float32)
    widths = np.array([Wb, Wb - 9], np.int32)
    want = jshard.sharded_seam_step(
        jshard.make_mesh(8, data=2), jnp.asarray(imgs), jnp.asarray(widths),
        jnp.bool_(True), delta_x=2, bias=jnp.asarray(bias),
        rig=jnp.asarray(rig), has_bias=True, has_rig=True)
    got = tshard.sharded_seam_step(
        _cpu_mesh(4, data=1), torch.from_numpy(imgs), widths, True,
        delta_x=2, bias=torch.from_numpy(bias), rig=torch.from_numpy(rig),
        has_bias=True, has_rig=True)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_ragged_with_cols_and_uneven_batch_raise():
    rng = np.random.default_rng(3)
    mesh = _cpu_mesh(8, data=2)
    with pytest.raises(LqrImageError, match="equal image heights"):
        tbatch.BatchCarver([random_image(rng, 16, 256, 3),
                            random_image(rng, 12, 256, 3)], mesh=mesh,
                           device="cpu")
    with pytest.raises(LqrImageError, match="shard evenly"):
        tbatch.BatchCarver([random_image(rng, 24, 32, 3)] * 3,
                           mesh=_cpu_mesh(8, data=8), device="cpu")
    with pytest.raises(LqrImageError, match="shard evenly"):
        tshard.find_seam_sharded(_cpu_mesh(3, data=1),
                                 torch.zeros((4, 128)), None, True, 1, False)


def test_mesh():
    mesh = _cpu_mesh(8)
    assert mesh.shape == {"data": 2, "cols": 4}
    assert _cpu_mesh(4).shape == {"data": 1, "cols": 4}
    cpu = torch.device("cpu")
    mesh = tshard.make_mesh(devices=[cpu] * 4, data=2)
    assert mesh.devices == ((cpu, cpu), (cpu, cpu))
    from lqr_tpu_torch import LqrConfigError
    with pytest.raises(LqrConfigError):
        _cpu_mesh(6, data=4)
    with pytest.raises(LqrConfigError):
        tshard.make_mesh(5, devices=[cpu] * 4)
    # the exact-cone rule picks the same rows per block as JAX's
    for H, dx, Wl in ((16, 1, 64), (2048, 1, 512), (30, 2, 64), (7, 3, 8)):
        assert tshard._block_rows(H, dx, Wl) == jshard._block_rows(H, dx, Wl)


def test_make_mesh_needs_cuda_or_devices(monkeypatch):
    """Without devices, make_mesh takes every CUDA device; with none it
    raises instead of building CPU shards, which come only when asked."""
    from lqr_tpu_torch import LqrConfigError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(LqrConfigError, match=r'devices=\["cpu"\]'):
        tshard.make_mesh()
    with pytest.raises(LqrConfigError, match="no CUDA device"):
        tshard.make_mesh(4, data=1)
    mesh = tshard.make_mesh(devices=["cpu"] * 2)
    assert mesh.shape == {"data": 1, "cols": 2}


CUDA0 = torch.device("cuda", 0)


def test_dp_route_by_placement():
    """The sharded DP's placement rule: up to a cluster's MAX_SHARDS shards
    on one CUDA device take the one-launch kernel; CPU shards, shards on
    distinct devices and more shards on one device than a cluster holds
    take the per-block loop. The one-launch entry itself refuses a mesh
    wider than the cluster limit."""
    assert tshard.dp_route([CUDA0] * 4) == "cluster"
    assert tshard.dp_route([CUDA0] * tdpb.MAX_SHARDS) == "cluster"
    assert tshard.dp_route(["cuda:0"]) == "cluster"
    assert tshard.dp_route([torch.device("cpu")] * 4) == "blocks"
    assert tshard.dp_route([CUDA0, torch.device("cuda", 1)]) == "blocks"
    assert tshard.dp_route([CUDA0, torch.device("cpu")]) == "blocks"
    assert tshard.dp_route([CUDA0] * (tdpb.MAX_SHARDS + 1)) == "blocks"
    with pytest.raises(LqrConfigError, match="1 to 8 blocks"):
        tdpb.dp_sharded([torch.zeros((4, 16))] * 9, None, True, 1, False, 4,
                        4)


def _blocked_inputs(n=4, H=16, Wl=64):
    e, rig = _energy(9, H, n * Wl)
    return ([torch.from_numpy(e[:, c * Wl:(c + 1) * Wl].copy())
             for c in range(n)],
            [torch.from_numpy(rig[:, c * Wl:(c + 1) * Wl].copy())
             for c in range(n)])


def test_one_device_mesh_takes_the_cluster_entry(monkeypatch):
    """A mesh row whose shards share one CUDA device runs dp_sharded once a
    seam (stood in for here by its plain version on CPU tensors), never the
    per-block loop; its result is the per-block loop's. Twelve shards on
    the device, more than a cluster holds, take the per-block loop."""
    calls, loops = [], []

    def sharded(*args):
        calls.append(args)
        return tdpb.dp_sharded_plain(*args)

    def blocked(*args):
        loops.append(args)
        return tdpb.dp_sharded_plain(*args[:-1])

    e_loc, rig_loc = _blocked_inputs()
    want = tdpb.dp_sharded_plain(e_loc, rig_loc, True, 2, True, 16, 8)
    monkeypatch.setattr(tshard, "dp_sharded", sharded)
    monkeypatch.setattr(tshard, "dp_blocked", blocked)
    got = tshard._dp_local_blocked(e_loc, rig_loc, True, 2, True, 16, 8,
                                   [CUDA0] * 4)
    assert len(calls) == 1 and not loops
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    e12, rig12 = _blocked_inputs(n=12, Wl=32)
    got = tshard._dp_local_blocked(e12, rig12, True, 2, True, 16, 8,
                                   [CUDA0] * 12)
    assert len(calls) == 1 and len(loops) == 1
    want = tdpb.dp_sharded_plain(e12, rig12, True, 2, True, 16, 8)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)


def test_cpu_mesh_takes_the_plain_loop(monkeypatch):
    """CPU shards run the per-block loop on dp_block's plain version, with
    no kernel launched and the one-launch entry never called."""
    def sharded(*args):
        raise AssertionError("dp_sharded ran on a CPU mesh")

    monkeypatch.setattr(tshard, "dp_sharded", sharded)
    before = dict(dp_cuda.LAUNCHES)
    e_loc, rig_loc = _blocked_inputs()
    got = tshard._dp_local_blocked(e_loc, rig_loc, False, 1, True, 16, 8,
                                   [torch.device("cpu")] * 4)
    want = tdpb.dp_sharded_plain(e_loc, rig_loc, False, 1, True, 16, 8)
    assert dp_cuda.LAUNCHES == before
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    # and dp_sharded itself takes CPU tensors to its plain version
    got = tdpb.dp_sharded(e_loc, rig_loc, False, 1, True, 16, 8)
    assert dp_cuda.LAUNCHES == before
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
