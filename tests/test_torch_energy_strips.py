"""A pure-torch model of csrc/dp_energy_forward.cu's warp-specialised
schedule, held bit-equal to the plain versions and to the JAX package on
small shapes.

The model follows the kernel: a cluster of `ctas` blocks of `nwarps`
consumer warps, each with a producer warp. A producer walks its
consumer's (strip, row) tasks and streams, for each run of K rows of a
strip, the b rows y0 - 1 .. y1 (clamped to H - 1) as items of its ring: a
slot holds the window's columns x0 - 4 .. x0 + W + 3 of one b row, and
the bias and rig rows of a task row. For task (strip, y) it reads items
base + y - y0 .. + 2 (rows y - 1, y, y + 1) and writes the window's
energies (+inf at x >= w and outside [0, Wb); the edges replicated at
lane 0, lane w - 1, row 0 and row H - 1) and rig (0 outside [0, Wb)).
Slot columns outside [0, Wb) hold NaN, which no kept energy may read. The
consumer runs the strip sweep of tests/test_torch_dp_schedule.py on those
windows: columns beyond a window hold -inf, a poison that wins every
minimum it reaches, so a halo too narrow for K rows shows up in the kept
columns.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lqr_tpu.core import dp as jdp
from lqr_tpu.core.energy import energy_from_plane as jenergy
from lqr_tpu_torch.core import dp as tdp
from lqr_tpu_torch.core.energy import sqrt_f32
from lqr_tpu_torch.core.engine import total_energy
from lqr_tpu_torch.ops import carve_step as tcs
from lqr_tpu_torch.ops import dp_cuda

torch.set_num_threads(1)

_HALF = torch.tensor(np.float32(0.5))


def _fam(nrg: int) -> int:
    """csrc/energy.cuh's family: 0 XABS, 1 SUMABS, 2 NORM, 3 NULL."""
    return 3 if nrg == 6 else nrg % 3


def _tasks(rows, K, first, hi, nwarps):
    """A warp's (y0, y1, strip) runs in the order advance() walks them."""
    runs = []
    for y0 in range(1, rows, K):
        for t in range(first, hi, nwarps):
            runs.append((y0, min(y0 + K, rows), t))
    return runs


def _slot(b, j, x0, win):
    """One ring slot's b row: columns x0 - 4 .. x0 + win + 3 of row j (H - 1
    at most), NaN outside [0, Wb)."""
    H, Wb = b.shape
    cols = torch.arange(x0 - 4, x0 + win + 4)
    inr = (cols >= 0) & (cols < Wb)
    row = b[min(j, H - 1), cols.clamp(0, Wb - 1)]
    return torch.where(inr, row, torch.nan)


def producer_window(items, k, x0, win, b, bias, rig, y, w, nrg):
    """The energies and rig a producer writes for the task whose centre row
    y is item k of its ring (items[k - 1], items[k + 1]: the rows above and
    below): [win] each."""
    H, Wb = b.shape
    cols = torch.arange(x0, x0 + win)
    inr = (cols >= 0) & (cols < Wb)
    cc = cols.clamp(0, Wb - 1)
    c = items[k]
    mid = c[4:4 + win]
    left = torch.where(cols > 0, c[3:3 + win], mid)
    right = torch.where(cols < w - 1, c[5:5 + win], mid)
    fam = _fam(nrg)
    gx = (right - left) * _HALF
    if fam == 0:
        e = torch.abs(gx)
    elif fam == 3:
        e = torch.zeros(win)
    else:
        gy = (items[k + 1][4:4 + win] - items[k - 1][4:4 + win]) * _HALF
        e = ((torch.abs(gx) + torch.abs(gy)) * _HALF if fam == 1
             else sqrt_f32(gx * gx + gy * gy))
    if bias is not None:
        e = e + torch.where(inr, bias[y, cc], torch.nan)
    e = torch.where((cols >= 0) & (cols < w), e, torch.inf)
    r = (torch.where(inr, rig[y, cc], 0.0) if rig is not None
         else torch.zeros(win))
    return e, r


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
        cand = mp[d + dx:d + dx + W]
        if has_rig:
            cand = cand + r * rigc[abs(dx)]
        take = cand < best
        best = torch.where(take, cand, best)
        bd = torch.where(take, torch.tensor(dx, dtype=torch.int8), bd)
    return e + best, bd


def energy_strips(b, bias, rig, w, pref_left, dx, nrg, geo):
    """The schedule of csrc/dp_energy_forward.cu -> (M_last, bp, the
    windows' energies by (strip, y)). geo: (ctas, nwarps, S, G, K)."""
    ctas, nwarps, S, G, K = geo
    H, Wb = b.shape
    win = S + 2 * G
    nstrips = -(-Wb // S)
    has_rig = rig is not None
    order = tdp.rank_order(dx, pref_left)
    rigc = torch.from_numpy(tdp.rigc_table(dx, H))
    # the producers: each warp's task stream, its energies ahead of the
    # consumer's row
    windows = {}
    for rank in range(ctas):
        lo, hi = rank * nstrips // ctas, (rank + 1) * nstrips // ctas
        for first in range(lo, lo + nwarps):
            items = []                       # the warp's item stream
            for y0, y1, t in _tasks(H, K, first, hi, nwarps):
                base = len(items)
                items += [_slot(b, j, t * S - G, win)
                          for j in range(y0 - 1, y1 + 1)]
                for y in range(y0, y1):
                    windows[(t, y)] = producer_window(
                        items, base + (y - y0) + 1, t * S - G, win, b, bias,
                        rig, y, w, nrg)
    # row 0: the producers' energies of the whole row in every frontier
    front = total_energy(b, bias, w, nrg, bias is not None)[0]
    bp = torch.zeros((H, Wb), dtype=torch.int8)
    for y0 in range(1, H, K):
        y1 = min(y0 + K, H)
        nxt = torch.full((Wb,), torch.nan)
        for t in range(nstrips):
            cols = torch.arange(t * S - G, t * S - G + win)
            inr = (cols >= 0) & (cols < Wb)
            cc = cols.clamp(0, Wb - 1)
            kept = torch.zeros(win, dtype=torch.bool)
            kept[G:G + S] = True
            kept &= cols < Wb
            m = torch.where(inr, front[cc], torch.inf)
            for y in range(y0, y1):
                e, r = windows[(t, y)]
                m, bd = _window_row(m, e, r, order, rigc, has_rig)
                bp[y, cols[kept]] = bd[kept]
            nxt[cols[kept]] = m[kept]
        front = nxt
    return front, bp, windows


def _planes(seed, H, W, Wb, masks, levels=6):
    """Reader plane of few levels (ties on purpose), a bias of eighths and a
    rigidity field nonzero past W, zero b and bias past W."""
    rng = np.random.default_rng(seed)
    b = np.zeros((H, Wb), np.float32)
    b[:, :W] = rng.integers(0, levels, (H, W)) / np.float32(levels - 1)
    bias = np.zeros((H, Wb), np.float32)
    bias[:, :W] = np.round(rng.standard_normal((H, W)) * 4) / 8
    rig = np.abs(np.round(rng.standard_normal((H, Wb)) * 8)).astype(
        np.float32)
    t = torch.from_numpy
    return t(b), t(bias) if masks else None, t(rig) if masks else None


def _jax_dp(b, bias, rig, w, pref, dx, nrg):
    """JAX's energy map (+ bias below w) and forward DP."""
    H, Wb = b.shape
    e = jenergy(jnp.asarray(b.numpy()), w, nrg)
    if bias is not None:
        lane = jnp.arange(Wb)[None, :]
        e = jnp.where(lane < w, e + jnp.asarray(bias.numpy()), jnp.inf)
    r = jnp.asarray(rig.numpy()) if rig is not None else jnp.zeros((H, Wb))
    return jdp.dp_forward(e, r, jnp.bool_(pref), dx, rig is not None)


def _check(b, bias, rig, w, dx, nrg, geo):
    """The model's windows against lqr_tpu.core.energy's map, and its sweep
    against the plain version and JAX, both side preferences."""
    H, Wb = b.shape
    _, _, S, G, K = geo
    assert G >= dx * K and S + 2 * G <= dp_cuda.WINDOW
    jm = jenergy(jnp.asarray(b.numpy()), w, nrg)
    if bias is not None:
        jm = jnp.where(jnp.arange(Wb)[None, :] < w,
                       jm + jnp.asarray(bias.numpy()), jnp.inf)
    emap = torch.from_numpy(np.array(jm))
    for pref in (True, False):
        M, bp, windows = energy_strips(b, bias, rig, w, pref, dx, nrg, geo)
        want = tcs.dp_energy_forward_plain(b, bias, rig, w, pref, dx,
                                           bias is not None, rig is not None,
                                           nrg)
        assert torch.equal(M, want[0]) and torch.equal(bp, want[1]), pref
        M_j, bp_j = _jax_dp(b, bias, rig, w, pref, dx, nrg)
        np.testing.assert_array_equal(M.numpy(), np.asarray(M_j))
        np.testing.assert_array_equal(bp.numpy(), np.asarray(bp_j))
    # every energy a producer writes: the map's value, +inf outside [0, Wb)
    assert len(windows) == (H - 1) * -(-Wb // S)
    for (t, y), (e, _) in windows.items():
        cols = torch.arange(t * S - G, t * S - G + S + 2 * G)
        inr = (cols >= 0) & (cols < Wb)
        assert torch.equal(e[inr], emap[y, cols[inr]]), (t, y)
        assert (e[~inr] == torch.inf).all()


# (H, W, Wb, w, delta_x, nrg, masks, (ctas, nwarps, S, G, K)): small
# windows (S + 2G < 256), so that tens of columns span several strips
_SMALL = [
    (20, 50, 50, 50, 1, 0, False, (2, 2, 16, 8, 8)),      # Wb % 4 != 0
    (20, 37, 40, 33, 1, 1, True, (1, 2, 16, 8, 5)),       # w < Wb
    (17, 45, 48, 45, 2, 2, True, (2, 1, 16, 8, 4)),       # several a warp
    (17, 45, 48, 40, 2, 6, True, (1, 1, 8, 4, 2)),        # NULL + bias
    (13, 30, 30, 30, 3, 2, True, (1, 2, 16, 9, 3)),
    (13, 33, 35, 33, 3, 0, False, (2, 2, 8, 6, 2)),
    (12, 40, 40, 38, 0, 1, False, (1, 3, 16, 0, 64)),     # delta_x = 0
    (12, 40, 40, 40, 0, 4, True, (2, 2, 8, 4, 3)),
    (14, 60, 64, 61, 10, 5, True, (1, 2, 16, 20, 2)),     # delta_x = 10
    (1, 30, 32, 30, 1, 0, False, (1, 1, 16, 8, 8)),       # H = 1
    (9, 1, 1, 1, 1, 2, True, (1, 1, 16, 8, 8)),           # Wb = 1
    (9, 5, 7, 5, 2, 1, True, (1, 1, 16, 8, 4)),           # Wb < one strip
    (24, 20, 20, 20, 1, 2, False, (1, 1, 16, 16, 16)),    # Wb < 32
]


@pytest.mark.parametrize("H,W,Wb,w,dx,nrg,masks,geo", _SMALL)
def test_energy_strip_model_matches_plain_and_jax(H, W, Wb, w, dx, nrg,
                                                  masks, geo):
    b, bias, rig = _planes(H * 7 + Wb + dx + nrg, H, W, Wb, masks)
    _check(b, bias, rig, w, dx, nrg, geo)


@pytest.mark.parametrize("H,W,Wb,w,dx,nrg,masks", [
    (40, 600, 600, 600, 1, 0, False),     # three strips of the kernel
    (30, 500, 512, 470, 2, 2, True),
    (12, 1000, 1021, 1000, 3, 1, True),   # Wb % 4 != 0
])
def test_energy_strip_model_at_kernel_geometry(H, W, Wb, w, dx, nrg, masks):
    """The geometry the wrapper launches (energy_geometry on an H100's
    opt-in shared memory), with the kernel's 256-column window."""
    _, geo = tcs.energy_geometry(Wb, dx, masks, masks, 232448)
    assert geo[2] + 2 * geo[3] == dp_cuda.WINDOW
    b, bias, rig = _planes(H + Wb + dx, H, W, Wb, masks)
    _check(b, bias, rig, w, dx, nrg, geo)


@pytest.mark.parametrize("dx", [1, 2])
def test_energy_strip_model_halo_one_row_too_narrow_fails(dx):
    """K one row beyond what the halo holds lets the poison into the kept
    columns."""
    H, W, Wb = 20, 48, 48
    b, bias, rig = _planes(3 + dx, H, W, Wb, False)
    want = tcs.dp_energy_forward_plain(b, None, None, W, True, dx, False,
                                       False, 0)
    S, G = 16, 8
    got = energy_strips(b, None, None, W, True, dx, 0,
                        (1, 2, S, G, G // dx + 1))
    assert not torch.equal(got[1], want[1])


@pytest.mark.parametrize("dx", [0, 1, 2, 10])
def test_energy_geometry_rule(dx):
    """energy_geometry's rule: the frontier stays in shared memory where it
    fits beside four warp pairs, the warp pairs fit what is left, at most
    MAX_PAIRS, and strip_geometry's invariants hold."""
    optin = 232448
    for masks in ((False, False), (True, False), (False, True),
                  (True, True)):
        pair = tcs.pair_bytes(*masks)
        for Wb in (1, 20, 256, 1021, 2048, 20000, 29000, 32768, 65536):
            scratch, (ctas, warps, S, G, K) = tcs.energy_geometry(
                Wb, dx, *masks, optin)
            front = 0 if scratch else dp_cuda._front_bytes(Wb)
            assert scratch == (dp_cuda._front_bytes(Wb) + 4 * pair > optin)
            assert 1 <= warps <= tcs.MAX_PAIRS
            assert warps * pair + front <= optin
            assert S % 16 == 0 and S + 2 * G == 256 and G >= dx * K >= 0
            strips = -(-Wb // S)
            assert 1 <= ctas <= min(8, strips) and warps <= strips
    # the main path, 2048 columns at delta_x = 1: four blocks of four pairs
    assert tcs.energy_geometry(2048, 1, False, False, optin) == (
        False, (4, 4, 128, 64, 64))
