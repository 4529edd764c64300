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
from lqr_tpu_torch.ops import dp_cuda

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
    assert all(dp_cuda.LAUNCHES[k] - before[k] == 26 for k in before)
    c.resize(270, 192)
    np.testing.assert_array_equal(c.get_image(),
                                  native.materialize(img, vs, 270))


@pytest.mark.parametrize("nrg,dx,rig", [(2, 2, 0.0), (4, 1, 25.0)])
def test_extend_map_cuda_matches_cpu(cuda, nrg, dx, rig):
    img = _image(2, 64, 200)
    cfg = EngineConfig(H=64, Wb=256, C=3, delta_x=dx, nrg=nrg,
                       has_rig=rig > 0)
    field = np.full((64, 200), np.float32(rig)) if rig else None
    st = {d: engine.extend_map(cfg, init_state(cfg, img, rig=field,
                                               device=d), 30)
          for d in ("cpu", cuda)}
    for name in ("vs", "cur_b"):
        np.testing.assert_array_equal(getattr(st[cuda], name).cpu().numpy(),
                                      getattr(st["cpu"], name).numpy())
    for w in (170, 230):
        np.testing.assert_array_equal(
            engine.materialize(cfg, st[cuda], w, 256).cpu().numpy(),
            engine.materialize(cfg, st["cpu"], w, 256).numpy())
