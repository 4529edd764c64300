"""The port's seam DP (lqr_tpu_torch.ops.dp_cuda, plain versions on the CPU)
against the JAX package: bit-exact M_last, bp and seams.

The Pallas kernels run in interpreter mode (LQR_PALLAS_INTERPRET=1), as
tests/test_pallas_dp.py runs them. The shapes reach each kernel that
find_seam_pallas can launch:

- Wb=1024, H=32, delta_x=1: _dpf_kernel (wedge form) + _btw_kernel;
- Wb=1024, H=16, delta_x=2: _dpf_kernel (rank form) + _btf_kernel;
- Wb=128,  H=16: _dp_kernel + _bt_kernel (no fold applies).

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lqr_tpu.core import dp as jdp
from lqr_tpu_torch.core import dp as tdp
from lqr_tpu_torch.ops import dp_cuda

torch.set_num_threads(1)


def _case(seed, H, W, Wb, has_rig):
    """Quantized energy (ties on purpose), +inf past W; optional rigidity."""
    rng = np.random.default_rng(seed)
    e = np.full((H, Wb), np.inf, np.float32)
    e[:, :W] = np.round(rng.random((H, W), dtype=np.float32) * 8) / 8
    rig = np.zeros((H, Wb), np.float32)
    if has_rig:
        rig[:, :W] = np.round(np.abs(rng.standard_normal((H, W))) * 4) / 4
    return e, rig


# (H, W, Wb, delta_x, has_rig)
_PALLAS_SHAPES = {
    "dpf_wedge_btw": (32, 1000, 1024, 1, (False, True)),
    "dpf_rank_btf": (16, 1000, 1024, 2, (False,)),
    "dp_bt_unfolded": (16, 100, 128, 1, (False,)),
}


@pytest.mark.parametrize("shape", sorted(_PALLAS_SHAPES))
def test_find_seam_matches_pallas_interpret(shape, monkeypatch):
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    from lqr_tpu.ops.dp_pallas import find_seam_pallas
    H, W, Wb, dx, rigs = _PALLAS_SHAPES[shape]
    for has_rig in rigs:
        e, rig = _case(3, H, W, Wb, has_rig)
        for pref in (True, False):
            want = np.asarray(find_seam_pallas(
                jnp.asarray(e), jnp.asarray(rig), jnp.bool_(pref), dx,
                has_rig))
            got = dp_cuda.find_seam(torch.from_numpy(e),
                                    torch.from_numpy(rig) if has_rig
                                    else None, pref, dx, has_rig)
            assert got.dtype == torch.int32 and got.shape == (H,)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{has_rig=} {pref=}")


@pytest.mark.parametrize("H,W,Wb,dx,has_rig", [
    (32, 1000, 1024, 1, False),
    (32, 1000, 1024, 1, True),
    (16, 1000, 1024, 2, False),
    (16, 100, 128, 1, False),
    (12, 40, 128, 3, True),
    (12, 40, 128, 0, False),
])
def test_dp_forward_matches_jax_core(H, W, Wb, dx, has_rig):
    e, rig = _case(11, H, W, Wb, has_rig)
    for pref in (True, False):
        M_want, bp_want = jdp.dp_forward(jnp.asarray(e), jnp.asarray(rig),
                                         jnp.bool_(pref), dx, has_rig)
        M_got, bp_got = dp_cuda.dp_forward(
            torch.from_numpy(e), torch.from_numpy(rig) if has_rig else None,
            pref, dx, has_rig)
        assert M_got.dtype == torch.float32 and bp_got.dtype == torch.int8
        np.testing.assert_array_equal(M_got.numpy(), np.asarray(M_want))
        np.testing.assert_array_equal(bp_got.numpy(), np.asarray(bp_want))
        seam_want = jdp.backtrack(M_want, bp_want, jnp.bool_(pref))
        seam_got = dp_cuda.backtrack(M_got, bp_got, pref)
        np.testing.assert_array_equal(seam_got.numpy(),
                                      np.asarray(seam_want))


def test_backtrack_tie_break_both_sides():
    """A flat last row: LEFT starts at the leftmost, RIGHT at the rightmost
    minimum (torch.argmin's first-index rule would be wrong for RIGHT)."""
    H, Wb = 4, 128
    M = torch.full((Wb,), torch.inf)
    M[:7] = 1.0
    bp = torch.zeros((H, Wb), dtype=torch.int8)
    assert dp_cuda.backtrack(M, bp, True).tolist() == [0] * H
    assert dp_cuda.backtrack(M, bp, False).tolist() == [6] * H


def test_rank_tables_and_rigidity_coefficients():
    from lqr_tpu.ops.dp_pallas import _rank_consts
    for dx in range(0, 11):
        assert tdp.rank_tables(dx) == jdp.rank_tables(dx)
        for H in (7, 300, 2048):
            want = {abs(d): c for d, _, _, c in _rank_consts(dx, H)}
            got = tdp.rigc_table(dx, H)
            assert got.dtype == np.float32
            assert [got[m] for m in range(dx + 1)] == [want[m]
                                                       for m in range(dx + 1)]


def test_wrappers_check_inputs_and_count_no_cpu_launches():
    before = dict(dp_cuda.LAUNCHES)
    e = torch.zeros((8, 128))
    with pytest.raises(TypeError):
        dp_cuda.dp_forward(e.double(), None, True, 1, False)
    with pytest.raises(ValueError):
        dp_cuda.dp_forward(e, None, True, 11, False)
    with pytest.raises(ValueError):
        dp_cuda.dp_forward(e, None, True, 1, True)          # rig missing
    with pytest.raises(ValueError):
        dp_cuda.dp_forward(e, torch.zeros((8, 64)), True, 1, True)
    with pytest.raises(ValueError):
        dp_cuda.dp_forward(e.t(), None, True, 1, False)     # wrong shape
    with pytest.raises(ValueError):
        dp_cuda.dp_forward(torch.zeros((128, 8)).t(), None, True, 1, False)
    with pytest.raises(TypeError):
        dp_cuda.backtrack(e[0], torch.zeros((8, 128), dtype=torch.int32),
                          True)
    with pytest.raises(ValueError):
        dp_cuda.backtrack(e[0, :64], torch.zeros((8, 128),
                                                 dtype=torch.int8), True)
    seam = dp_cuda.find_seam(e, None, True, 1, False)
    assert seam.tolist() == [0] * 8
    assert dp_cuda.LAUNCHES == before     # CPU tensors run the plain path


@pytest.mark.parametrize("h", [1, 2, 9, 16])
@pytest.mark.parametrize("dx,has_rig", [(1, False), (2, True)])
def test_ragged_dp_matches_jax_core(h, dx, has_rig):
    """dp_forward(h=, rigc_vec=): rows >= h pass the frontier through with
    bp = 0, and the image's own rigidity coefficients replace the table of
    the padded height."""
    from lqr_tpu_torch.parallel.batch import rigc_table
    H, W, Wb = 16, 100, 128
    e, rig = _case(h + dx, H, W, Wb, has_rig)
    rv = rigc_table([h], dx)[0]
    for pref in (True, False):
        M_want, bp_want = jdp.dp_forward(
            jnp.asarray(e), jnp.asarray(rig), jnp.bool_(pref), dx, has_rig,
            h=jnp.int32(h), rigc_vec=jnp.asarray(rv))
        M_got, bp_got = dp_cuda.dp_forward(
            torch.from_numpy(e), torch.from_numpy(rig) if has_rig else None,
            pref, dx, has_rig, h=h, rigc_vec=torch.from_numpy(rv))
        np.testing.assert_array_equal(M_got.numpy(), np.asarray(M_want))
        np.testing.assert_array_equal(bp_got.numpy(), np.asarray(bp_want))
        got = dp_cuda.find_seam(torch.from_numpy(e),
                                torch.from_numpy(rig) if has_rig else None,
                                pref, dx, has_rig, h=h,
                                rigc_vec=torch.from_numpy(rv))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jdp.backtrack(M_want, bp_want,
                                                  jnp.bool_(pref))))
    with pytest.raises(ValueError):
        dp_cuda.dp_forward(torch.from_numpy(e), None, True, dx, False,
                           h=H + 1)
    with pytest.raises(ValueError):
        dp_cuda.dp_forward(torch.from_numpy(e), None, True, dx, False,
                           rigc_vec=torch.zeros(dx + 2))
