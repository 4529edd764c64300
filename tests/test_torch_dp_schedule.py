"""A pure-torch model of the CUDA DP and backtrack schedules, held bit-equal
to the plain versions (lqr_tpu_torch.core.dp) and to the JAX package's
lqr_tpu.core.dp on small shapes.

The model follows csrc/dp_forward.cu: strips of S kept columns, each
computed in a window with G halo columns on each side, K rows between
frontier exchanges, the cell rule as the kernel runs it (a strict-less
scan in rank order). Columns beyond a window hold -inf, a poison that wins
every minimum it reaches, so a halo too narrow for K rows shows up in the
kept columns. The chase follows csrc/backtrack.cu: windows of rows x
columns around the seam, reloaded when the rows end or the seam leaves the
columns, the next window loaded ahead around the column where the last
began. Shapes cover ties, rigidity, delta_x 0..3, ragged h with a
per-image rigc and strips that do not divide the width.
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
    e[:, :W] = np.round(rng.random((H, W), dtype=np.float32) * 4) / 4
    rig = np.zeros((H, Wb), np.float32)
    if has_rig:
        rig[:, :W] = np.round(np.abs(rng.standard_normal((H, W))) * 4) / 4
    return e, rig


def _window_row(m, e, r, order, rigc, has_rig):
    """One row of a window: the kernel's cell rule, -inf beyond the window
    (the poison)."""
    d = max(abs(dx) for dx in order)
    pad = torch.full((d,), -torch.inf)
    mp = torch.cat([pad, m, pad])
    W = m.shape[0]
    best = mp[d:d + W].clone()
    bd = torch.zeros(W, dtype=torch.int8)
    for dx in order[1:]:
        c = mp[d + dx:d + dx + W]
        if has_rig:
            c = c + r * rigc[abs(dx)]
        take = c < best
        best = torch.where(take, c, best)
        bd = torch.where(take, torch.tensor(dx, dtype=torch.int8), bd)
    return e + best, bd


def strip_dp(e, rig, pref_left, dx, has_rig, S, G, K, h=None,
             rigc_vec=None):
    """The strip schedule of csrc/dp_forward.cu -> (M_last, bp)."""
    H, Wb = e.shape
    rows = H if h is None else h
    order = tdp.rank_order(dx, pref_left)
    rigc = (torch.from_numpy(tdp.rigc_table(dx, H)) if rigc_vec is None
            else rigc_vec)
    bp = torch.zeros((H, Wb), dtype=torch.int8)
    front = e[0].clone()
    W = S + 2 * G
    for y0 in range(1, rows, K):
        y1 = min(y0 + K, rows)
        nxt = torch.full((Wb,), torch.nan)
        for t in range(-(-Wb // S)):
            cols = torch.arange(t * S - G, t * S - G + W)
            inr = (cols >= 0) & (cols < Wb)
            cc = cols.clamp(0, Wb - 1)
            kept = torch.zeros(W, dtype=torch.bool)
            kept[G:G + S] = True
            kept &= cols < Wb
            m = torch.where(inr, front[cc], torch.inf)
            for y in range(y0, y1):
                ey = torch.where(inr, e[y, cc], torch.inf)
                ry = torch.where(inr, rig[y, cc], 0.0) if has_rig else None
                m, b = _window_row(m, ey, ry, order, rigc, has_rig)
                bp[y, cols[kept]] = b[kept]
            nxt[cols[kept]] = m[kept]
        front = nxt
    return front, bp


def window_chase(M_last, bp, pref_left, rows=32, reach=64, span=144,
                 align=16):
    """The windowed chase of csrc/backtrack.cu -> (seam [H] int32, the
    windows it loaded)."""
    H, Wb = bp.shape
    eq = M_last == M_last.min()
    lanes = torch.arange(Wb)
    x = int(torch.where(eq, lanes, Wb).min() if pref_left
            else torch.where(eq, lanes, -1).max())
    vec = Wb % align == 0 and Wb >= span
    sp = min(span, Wb)

    def window_at(top, x):
        lo = min(max(x - reach, 0), Wb - sp)
        return top, min(rows, top + 1), (lo & -align) if vec else lo

    seam = torch.full((H,), -1, dtype=torch.int32)
    y = H - 1
    top, n, lo = window_at(y, x)
    windows = 1
    while y >= 0:
        # the next window, loaded while this one is chased: the rows below,
        # around the column this window began at (the vector path only)
        nxt = window_at(y - n, x)
        ahead = vec and nxt[0] >= 0
        win = bp[top - n + 1:top + 1, lo:lo + sp].flip(0)  # win[r] = row top - r
        r = 0
        while r < n and 0 <= x - lo < sp:
            seam[y - r] = x
            x += int(win[r, x - lo])
            r += 1
        assert r > 0
        y -= r
        if y < 0:
            break
        if ahead and r == n and 0 <= x - nxt[2] < sp:
            top, n, lo = nxt
        else:                    # the seam left its columns
            top, n, lo = window_at(y, x)
        windows += 1
    return seam, windows


def _check(e, rig, dx, has_rig, geo, h=None, rigc=None, chase=None):
    """The model against core.dp and lqr_tpu.core.dp, both preferences."""
    et, rt = torch.from_numpy(e), torch.from_numpy(rig)
    S, G, K = geo
    assert G >= dx * K
    for pref in (True, False):
        M_m, bp_m = strip_dp(et, rt, pref, dx, has_rig, S, G, K, h=h,
                             rigc_vec=rigc)
        M_p, bp_p = tdp.dp_forward(et, rt if has_rig else None, pref, dx,
                                   has_rig, h=h, rigc_vec=rigc)
        assert torch.equal(M_m, M_p) and torch.equal(bp_m, bp_p), pref
        M_j, bp_j = jdp.dp_forward(
            jnp.asarray(e), jnp.asarray(rig), jnp.bool_(pref), dx, has_rig,
            h=None if h is None else jnp.int32(h),
            rigc_vec=None if rigc is None else jnp.asarray(rigc.numpy()))
        np.testing.assert_array_equal(M_m.numpy(), np.asarray(M_j))
        np.testing.assert_array_equal(bp_m.numpy(), np.asarray(bp_j))
        seam, _ = window_chase(M_m, bp_m, pref, **(chase or {}))
        np.testing.assert_array_equal(
            seam.numpy(), tdp.backtrack(M_p, bp_p, pref).numpy())
        np.testing.assert_array_equal(
            seam.numpy(), np.asarray(jdp.find_seam(
                jnp.asarray(e), jnp.asarray(rig), jnp.bool_(pref), dx,
                has_rig, h=None if h is None else jnp.int32(h),
                rigc_vec=None if rigc is None else jnp.asarray(
                    rigc.numpy()))))


# (H, W, Wb, delta_x, has_rig, (S, G, K)): small windows, so that a map of
# tens of columns spans several strips and K rows several exchanges
_SMALL = [
    (20, 50, 50, 1, False, (16, 8, 8)),      # strips that do not divide Wb
    (20, 37, 40, 1, True, (16, 8, 5)),
    (17, 45, 48, 2, False, (16, 8, 4)),      # H - 1 not a multiple of K
    (17, 45, 48, 2, True, (8, 4, 2)),
    (13, 30, 30, 3, True, (16, 9, 3)),
    (13, 33, 35, 3, False, (8, 6, 2)),
    (12, 40, 40, 0, False, (16, 0, 64)),     # delta_x = 0: no halo
    (12, 40, 40, 0, True, (8, 4, 3)),
    (1, 30, 32, 1, False, (16, 8, 8)),       # H = 1: no rows to run
    (9, 1, 1, 1, False, (16, 8, 8)),         # Wb = 1
    (9, 5, 7, 2, True, (16, 8, 4)),          # Wb < one strip
    (24, 64, 64, 1, False, (16, 16, 16)),
]


@pytest.mark.parametrize("H,W,Wb,dx,has_rig,geo", _SMALL)
def test_strip_schedule_matches_plain_and_jax(H, W, Wb, dx, has_rig, geo):
    e, rig = _case(H * 7 + Wb + dx, H, W, Wb, has_rig)
    _check(e, rig, dx, has_rig, geo)


@pytest.mark.parametrize("H,W,Wb,dx,has_rig", [
    (40, 600, 600, 1, False),      # three strips of the kernel's geometry
    (30, 500, 512, 2, True),
    (12, 1000, 1021, 3, True),     # Wb % 4 != 0
])
def test_kernel_geometry_matches_plain_and_jax(H, W, Wb, dx, has_rig):
    """The geometry the wrapper launches (strip_geometry), with the
    kernel's 256-column window."""
    ctas, warps, S, G, K = dp_cuda.strip_geometry(Wb, dx)
    assert S + 2 * G == dp_cuda.WINDOW and ctas * warps <= -(-Wb // S)
    e, rig = _case(H + Wb + dx, H, W, Wb, has_rig)
    _check(e, rig, dx, has_rig, (S, G, K))


@pytest.mark.parametrize("h", [1, 6, 11, 16])
@pytest.mark.parametrize("dx,has_rig", [(1, False), (2, True)])
def test_ragged_strip_schedule(h, dx, has_rig):
    """Rows >= h pass through (bp = 0, the frontier unchanged) with the
    image's own rigidity coefficients."""
    from lqr_tpu_torch.parallel.batch import rigc_table
    H, W, Wb = 16, 45, 48
    e, rig = _case(h * 3 + dx, H, W, Wb, has_rig)
    rigc = torch.from_numpy(rigc_table([h], dx)[0])
    _check(e, rig, dx, has_rig, (16, 8, 8 // dx), h=h, rigc=rigc)


@pytest.mark.parametrize("dx", [1, 2, 3])
def test_chase_restarts_where_the_seam_leaves_its_window(dx):
    """Narrow chase windows (4 rows, 12 columns) make the seam leave its
    columns before the rows end at delta_x > 1; every restart gives the
    plain seam."""
    H, W, Wb = 40, 60, 64
    e, rig = _case(50 + dx, H, W, Wb, True)
    _check(e, rig, dx, True, (16, 8, 8 // dx),
           chase={"rows": 4, "reach": 2, "span": 12, "align": 4})


def test_chase_window_count():
    """At the kernel's window (32 rows, 144 columns around the column where
    the previous window began) a delta_x = 1 seam never leaves the
    columns: one window per 32 rows."""
    H, W = 200, 400
    e, _ = _case(9, H, W, W, False)
    M, bp = tdp.dp_forward(torch.from_numpy(e), None, True, 1, False)
    seam, windows = window_chase(M, bp, True)
    assert torch.equal(seam, tdp.backtrack(M, bp, True))
    assert windows == -(-H // 32)


@pytest.mark.parametrize("dx", range(11))
def test_strip_geometry_invariants(dx):
    """Every geometry the wrapper can pick is one the kernel's launcher
    takes: S a multiple of 16, S + 2G = 256, G >= delta_x * K, K >= 1, a
    cluster of at most 8 blocks, no more blocks or warps than strips, no
    more warps than fit; every block has strips."""
    for cap in (1, 3, 4, 9, 12, 13, 14, 16):
        for Wb in (1, 7, 16, 100, 255, 256, 257, 1000, 1201, 2048, 4097,
                   8192, 32768):
            ctas, warps, S, G, K = dp_cuda.strip_geometry(Wb, dx, cap)
            strips = -(-Wb // S)
            assert S > 0 and S % 16 == 0 and S + 2 * G == 256
            assert K >= 1 and G >= dx * K and G >= 8 * dx
            assert 1 <= ctas <= min(8, strips)
            assert 1 <= warps <= min(cap, strips)
            assert all((r + 1) * strips // ctas - r * strips // ctas >= 1
                       for r in range(ctas))
    # the main path, 2048 columns at delta_x = 1: four blocks of four warps
    assert dp_cuda.strip_geometry(2048, 1) == (4, 4, 128, 64, 64)
