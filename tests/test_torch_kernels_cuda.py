"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA inputs, bit-exact (tolerance 0), a refused launch
that must raise, and the Carver's CUDA path against the C++ reference.

Marked ``cuda``; every test skips where CUDA is unavailable. On a machine
with an NVIDIA GPU (no jax needed, so skip tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

import lqr_tpu_torch
from lqr_tpu_torch import native
from lqr_tpu_torch.core import engine
from lqr_tpu_torch.core.state import EngineConfig, init_state
from lqr_tpu_torch.ops import carve_resident, dp_cuda

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; CUDA is not available")
    return torch.device("cuda", 0)


def _case(seed, H, W, Wb, has_rig, device):
    rng = np.random.default_rng(seed)
    e = np.full((H, Wb), np.inf, np.float32)
    e[:, :W] = np.round(rng.random((H, W), dtype=np.float32) * 8) / 8
    rig = None
    if has_rig:
        rig = np.zeros((H, Wb), np.float32)
        rig[:, :W] = np.round(np.abs(rng.standard_normal((H, W))) * 4) / 4
        rig = torch.from_numpy(rig).to(device)
    return torch.from_numpy(e).to(device), rig


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 256, (h, w, 3)) // 64) * 64).astype(np.uint8)


@pytest.mark.parametrize("H,W,Wb,dx,has_rig", [
    (2048, 2048, 2048, 1, False),      # the main path's shape
    (256, 1000, 1024, 2, True),
    (300, 380, 384, 1, False),
    (40, 100, 128, 3, True),
    (16, 1, 128, 0, False),
])
def test_kernels_match_plain(cuda, H, W, Wb, dx, has_rig):
    e, rig = _case(H + dx, H, W, Wb, has_rig, cuda)
    for pref in (True, False):
        M_k, bp_k = dp_cuda.dp_forward(e, rig, pref, dx, has_rig)
        M_p, bp_p = dp_cuda.dp_forward_plain(e, rig, pref, dx, has_rig)
        seam_k = dp_cuda.backtrack(M_p, bp_p, pref)
        seam_p = dp_cuda.backtrack_plain(M_p, bp_p, pref)
        torch.cuda.synchronize()
        assert torch.equal(M_k, M_p) and torch.equal(bp_k, bp_p), pref
        assert torch.equal(seam_k, seam_p), pref


def test_refused_launch_raises(cuda):
    before = dict(dp_cuda.LAUNCHES)
    big = torch.zeros((2, 32768), dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="lqr_dp_forward launch failed"):
        dp_cuda.dp_forward(big, None, True, 1, False)
    assert dp_cuda.LAUNCHES == before
    # the refused launch leaves no pending error behind
    torch.cuda.synchronize()
    assert torch.equal(torch.ones(3, device=cuda) * 2,
                       torch.full((3,), 2.0, device=cuda))


def test_carver_cuda_matches_native(cuda):
    img = _image(1, 192, 256)
    before = dict(dp_cuda.LAUNCHES)
    c = lqr_tpu_torch.Carver(img, device="cuda")
    c.resize(230, 192)
    vs = native.carve(img, 26)
    np.testing.assert_array_equal(c.vmap_dump().data, vs)
    np.testing.assert_array_equal(c.get_image(),
                                  native.materialize(img, vs, 230))
    # 192 x 256 takes the resident route: one launch for the 26 seams
    launched = {k: dp_cuda.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"dp_forward": 0, "backtrack": 0, "carve_resident": 1}
    c.resize(270, 192)
    np.testing.assert_array_equal(c.get_image(),
                                  native.materialize(img, vs, 270))


def _resident_planes(seed, H, W, Wb, device):
    """A reader plane of few levels (ties on purpose), a bias of eighths,
    a rigidity field and the identity posmap, zero past W."""
    rng = np.random.default_rng(seed)
    planes = np.zeros((3, H, Wb), np.float32)
    planes[0, :, :W] = rng.integers(0, 6, (H, W)) / np.float32(5)
    planes[1, :, :W] = np.round(rng.standard_normal((H, W)) * 4) / 8
    planes[2, :, :W] = np.abs(np.round(rng.standard_normal((H, W)) * 8))
    pm = np.zeros((H, Wb), np.int32)
    pm[:, :W] = np.arange(W)
    b, bias, rig = torch.from_numpy(planes).to(device)
    return b, bias, rig, torch.from_numpy(pm).to(device)


@pytest.mark.parametrize("dx", [1, 2])
@pytest.mark.parametrize("nrg", range(7))
def test_resident_kernel_matches_plain(cuda, nrg, dx):
    """A partial chunk (kc < KC) at depth d0 > 0, bias and rig on and off;
    tolerance 0 on hist rows < kc and on every plane at every column."""
    H, W, Wb, w0, d0, kc = 40, 250, 256, 241, 9, 23
    b, bias, rig, pm = _resident_planes(nrg * 10 + dx, H, W, Wb, cuda)
    for has_bias in (False, True):
        for has_rig in (False, True):
            args = (b, bias if has_bias else None, rig if has_rig else None,
                    pm, w0, d0, kc, dx, has_bias, has_rig, nrg, 2,
                    engine.KC)
            before = dp_cuda.LAUNCHES["carve_resident"]
            got = carve_resident.carve_chunk_resident(*args)
            want = carve_resident.carve_chunk_resident_plain(*args)
            torch.cuda.synchronize()
            assert dp_cuda.LAUNCHES["carve_resident"] == before + 1
            assert torch.equal(got[0], want[0]), (has_bias, has_rig)
            assert (got[0][kc:] == -1).all()
            for g, e in zip(got[1:], want[1:]):
                assert (g is None) == (e is None)
                if g is not None:
                    assert torch.equal(g, e), (has_bias, has_rig)


def test_masked_carver_cuda_matches_native(cuda):
    """bias_add (preservation and discard), rigmask_add and attach through
    the resident kernel, against the C++ reference."""
    from lqr_tpu_torch.carver import place_mask_numpy
    h, w, n, rigidity = 96, 160, 40, 50.0
    img = _image(3, h, w)
    rng = np.random.default_rng(4)
    pres = rng.integers(0, 256, (h // 4, w // 4, 3)).astype(np.uint8)
    disc = rng.integers(0, 256, (h // 2, w // 2, 1)).astype(np.uint8)
    rigm = rng.integers(0, 256, (h, w // 3)).astype(np.uint8)
    aux = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    before = dict(dp_cuda.LAUNCHES)
    c = lqr_tpu_torch.Carver(img, rigidity=rigidity, device="cuda")
    c.bias_add(pres, 1000.0, w // 4, h // 4)
    c.bias_add(disc, -800.0, w // 2, h // 2)
    c.rigmask_add(rigm)
    c.attach(aux)
    c.resize(w - n, h)
    B = (place_mask_numpy(pres, h, w, w // 4, h // 4) * np.float32(1.0)
         + place_mask_numpy(disc, h, w, w // 2, h // 2) * np.float32(-0.8))
    R = place_mask_numpy(rigm, h, w, 0, 0) * np.float32(rigidity)
    vs = native.carve(img, n, bias=B, rig=R)
    np.testing.assert_array_equal(c.vmap_dump().data, vs)
    np.testing.assert_array_equal(c.get_image(),
                                  native.materialize(img, vs, w - n))
    np.testing.assert_array_equal(c.get_aux(0),
                                  native.materialize(aux, vs, w - n))
    assert dp_cuda.LAUNCHES["carve_resident"] == before["carve_resident"] + 1
    assert dp_cuda.LAUNCHES["dp_forward"] == before["dp_forward"]


@pytest.mark.parametrize("nrg,dx,rig", [(2, 2, 0.0), (4, 1, 25.0)])
def test_extend_map_cuda_matches_cpu(cuda, nrg, dx, rig):
    img = _image(2, 64, 200)
    cfg = EngineConfig(H=64, Wb=256, C=3, delta_x=dx, nrg=nrg,
                       has_rig=rig > 0)
    field = np.full((64, 200), np.float32(rig)) if rig else None
    cpu = engine.extend_map(cfg, init_state(cfg, img, rig=field), 30)
    # both routes on the card: the per-seam kernels and the resident one
    for route in (engine._extend_per_seam, engine._extend_resident):
        got = route(cfg, init_state(cfg, img, rig=field, device=cuda), 30)
        for name in ("vs", "cur_b"):
            np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                          getattr(cpu, name).numpy())
        for w in (170, 230):
            np.testing.assert_array_equal(
                engine.materialize(cfg, got, w, 256).cpu().numpy(),
                engine.materialize(cfg, cpu, w, 256).numpy())
