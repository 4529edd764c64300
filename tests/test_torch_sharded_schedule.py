"""A pure-torch model of the schedule of csrc/dp_sharded.cu (the column-
sharded DP of one seam in one cluster launch), held bit-equal to the plain
per-block loop (lqr_tpu_torch.ops.dp_block.dp_sharded_plain), to the JAX
package's lqr_tpu.parallel.sharding._dp_local_blocked under shard_map on
the virtual 8-device CPU mesh, and in the own columns to the unsharded
lqr_tpu_torch.core.dp.dp_forward.

The model follows the kernel's strip schedule: each shard's extended slab
of Wl + 2G columns is cut into strips of S kept columns, each computed in
a 256-column window with Gi halo columns on each side, K rows between
reloads of the window from the shard's frontier (which warp runs a strip,
and in which turn, changes no value); every R rows the halo
columns of each frontier are replaced by the neighbours' G edge values
(+inf at the mesh's edges and for delta_x = 0), and each row's energy and
rigidity come from the shard's own plane and the neighbours' G edge
columns. Columns beyond a window hold -inf, a poison that wins every
minimum it reaches, so a window halo too narrow for K rows shows up in the
own columns. Tolerance 0 everywhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from lqr_tpu.parallel import sharding as jshard
from lqr_tpu_torch.core import dp as tdp
from lqr_tpu_torch.ops import dp_block as tdpb
from lqr_tpu_torch.ops import dp_cuda
from lqr_tpu_torch.parallel import sharding as tshard

torch.set_num_threads(1)

SMEM = 227 * 1024          # the H100's opt-in shared memory per block
WINDOW = dp_cuda.WINDOW


def _planes(seed, H, W):
    """Quantized energy (ties on purpose) and rigidity [H, W]."""
    rng = np.random.default_rng(seed)
    e = (np.round(rng.random((H, W), dtype=np.float32) * 4) / 4)
    rig = (np.round(np.abs(rng.standard_normal((H, W))) * 4) / 4)
    return e.astype(np.float32), rig.astype(np.float32)


def _window_row(m, e, r, order, rigc, has_rig):
    """One row of a window by the kernel's cell rule (a strict-less scan in
    rank order), -inf beyond the window."""
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


def sharded_strips(e_loc, rig_loc, pref_left, dx, has_rig, H, R, K, Gi, S):
    """The strip schedule of csrc/dp_sharded.cu -> (per-shard M_last [Wl],
    per-shard bp [H, Wl] int8)."""
    n, Wl = len(e_loc), e_loc[0].shape[1]
    G = max(R * dx, 1)
    We = Wl + 2 * G
    exchange = n > 1 and dx > 0
    order = tdp.rank_order(dx, pref_left)
    rigc = torch.from_numpy(tdp.rigc_table(dx, H))
    rig_loc = rig_loc if has_rig else [torch.zeros_like(e) for e in e_loc]

    def slab(planes, c, y, fill):
        """Row y of shard c's extended slab of one plane."""
        left = (planes[c - 1][y, Wl - G:] if exchange and c > 0
                else torch.full((G,), fill))
        right = (planes[c + 1][y, :G] if exchange and c < n - 1
                 else torch.full((G,), fill))
        return torch.cat([left, planes[c][y], right])

    strips = -(-We // S)
    cols = [torch.arange(t * S - Gi, t * S - Gi + WINDOW)
            for t in range(strips)]
    inr = [(x >= 0) & (x < We) for x in cols]
    kept = []
    for x in cols:
        k = torch.zeros(WINDOW, dtype=torch.bool)
        k[Gi:Gi + S] = True
        kept.append(k & (x < We))

    def window(vec, t, fill):
        return torch.where(inr[t], vec[cols[t].clamp(0, We - 1)], fill)

    bp = [torch.zeros((H, Wl), dtype=torch.int8) for _ in range(n)]
    m = [[window(slab(e_loc, c, 0, torch.inf), t, torch.inf)
          for t in range(strips)] for c in range(n)]
    yr = yk = 1
    for y in range(1, H):
        if yr == R or yk == K:
            fronts = []
            for c in range(n):
                f = torch.full((We,), torch.nan)
                for t in range(strips):
                    f[cols[t][kept[t]]] = m[c][t][kept[t]]
                fronts.append(f)
            if yr == R:          # the halo exchange between the frontiers
                ext = []
                for c in range(n):
                    f = fronts[c].clone()
                    f[:G] = (fronts[c - 1][Wl:Wl + G] if exchange and c > 0
                             else torch.inf)
                    f[G + Wl:] = (fronts[c + 1][G:2 * G]
                                  if exchange and c < n - 1 else torch.inf)
                    ext.append(f)
                fronts = ext
                yr = 0
            m = [[window(fronts[c], t, torch.inf) for t in range(strips)]
                 for c in range(n)]
            yk = 0
        for c in range(n):
            ey = slab(e_loc, c, y, torch.inf)
            ry = slab(rig_loc, c, y, 0.0)
            for t in range(strips):
                m[c][t], b = _window_row(m[c][t], window(ey, t, torch.inf),
                                         window(ry, t, 0.0), order, rigc,
                                         has_rig)
                own = kept[t] & (cols[t] >= G) & (cols[t] < G + Wl)
                bp[c][y, cols[t][own] - G] = b[own]
        yr += 1
        yk += 1
    M = []
    for c in range(n):
        out = torch.full((Wl,), torch.nan)
        for t in range(strips):
            own = kept[t] & (cols[t] >= G) & (cols[t] < G + Wl)
            out[cols[t][own] - G] = m[c][t][own]
        M.append(out)
    return M, bp


@functools.lru_cache(maxsize=None)
def _jax_blocked(n, H, W, dx, has_rig, pref, seed):
    """JAX's _dp_local_blocked under shard_map over n 'cols' devices."""
    e, rig = _planes(seed, H, W)
    Wl = W // n
    R = jshard._block_rows(H, dx, Wl)

    @functools.partial(shard_map, mesh=jshard.make_mesh(n, data=1),
                       in_specs=(P(None, "cols"), P(None, "cols"), P()),
                       out_specs=(P("cols"), P(None, "cols")),
                       check_vma=False)
    def run(e, r, pl):
        return jshard._dp_local_blocked(e, r, pl, dx, has_rig, H, n, R)

    M, bp = run(jnp.asarray(e), jnp.asarray(rig), jnp.bool_(pref))
    return np.asarray(M), np.asarray(bp)


def _check(n, H, W, dx, has_rig, pref, seed):
    e, rig = _planes(seed, H, W)
    Wl = W // n
    R = tshard._block_rows(H, dx, Wl)
    split = [torch.from_numpy(a[:, c * Wl:(c + 1) * Wl].copy())
             for a in (e, rig) for c in range(n)]
    e_loc, rig_loc = split[:n], split[n:] if has_rig else None
    geo = tdpb.sharded_geometry(Wl, dx, R, has_rig, SMEM)
    K, Gi, S, warps, _ = geo
    assert Gi % 8 == 0 and dx * K <= Gi and S + 2 * Gi == WINDOW
    assert 1 <= warps <= tdpb.STRIP_WARPS
    M_m, bp_m = sharded_strips(e_loc, rig_loc, pref, dx, has_rig, H, R, K,
                               Gi, S)
    M_p, bp_p = tdpb.dp_sharded_plain(e_loc, rig_loc, pref, dx, has_rig, H,
                                      R)
    for c in range(n):
        np.testing.assert_array_equal(M_m[c].numpy(), M_p[c].numpy())
        np.testing.assert_array_equal(bp_m[c].numpy(), bp_p[c].numpy())
    M_all = torch.cat(M_m).numpy()
    bp_all = torch.cat(bp_m, dim=1).numpy()
    # the own columns are the unsharded DP's
    M_u, bp_u = tdp.dp_forward(torch.from_numpy(e), torch.from_numpy(rig),
                               pref, dx, has_rig)
    np.testing.assert_array_equal(M_all, M_u.numpy())
    np.testing.assert_array_equal(bp_all, bp_u.numpy())
    M_j, bp_j = _jax_blocked(n, H, W, dx, has_rig, pref, seed)
    np.testing.assert_array_equal(M_all, M_j)
    np.testing.assert_array_equal(bp_all, bp_j)
    return R, geo


@pytest.fixture
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("the JAX side needs the 8-device CPU mesh")


@pytest.mark.usefixtures("_eight_devices")
@pytest.mark.parametrize("pref", [True, False])
@pytest.mark.parametrize("has_rig", [False, True])
@pytest.mark.parametrize("dx", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_strip_schedule_matches_plain_and_jax(n, dx, has_rig, pref):
    """H = 48 (R = 16, or 8 where 16 rows' halo passes half a shard) over
    400 columns: 2 shards of 200 (two strips each), 4 of 100, 8 of 50
    (own columns that straddle a lane's 8)."""
    R, _ = _check(n, 48, 400, dx, has_rig, pref, seed=n * 10 + dx)
    assert R in (16, 8)


@pytest.mark.usefixtures("_eight_devices")
@pytest.mark.parametrize("pref", [True, False])
def test_nested_row_halos(pref):
    """delta_x = 3 at R = 32: the window's halo holds K = 21 < R rows, so
    the windows reload twice between two exchanges; four strips a shard."""
    R, geo = _check(2, 64, 400, 3, True, pref, seed=7)
    assert R == 32 and geo == (21, 64, 128, 4, False)


def test_poison_shows_a_narrow_halo():
    """The model is strict: K rows through a window halo narrower than
    delta_x * K let the -inf beyond the window into the own columns."""
    H, W, n, dx = 64, 400, 2, 3
    e, rig = _planes(7, H, W)
    Wl = W // n
    e_loc = [torch.from_numpy(e[:, c * Wl:(c + 1) * Wl].copy())
             for c in range(n)]
    R = tshard._block_rows(H, dx, Wl)
    M_p, _ = tdpb.dp_sharded_plain(e_loc, None, True, dx, False, H, R)
    M_m, _ = sharded_strips(e_loc, None, True, dx, False, H, R, 32, 64, 128)
    assert not all(torch.equal(a, b) for a, b in zip(M_m, M_p))


def test_geometry():
    """The 2048^2 path on 4 shards takes three strips (delta_x 1) or five
    (delta_x 2), one a warp, with no reload between exchanges; a slab of
    more strips than a block's warps gives each warp several (the fewest
    warps for as many turns), and a slab whose frontier rows do not fit
    the shared memory beside the rings keeps them in device scratch."""
    assert tdpb.sharded_geometry(512, 1, 32, False, SMEM) == (
        32, 32, 192, 3, False)
    assert tdpb.sharded_geometry(512, 2, 32, True, SMEM) == (
        32, 64, 128, 5, False)
    # 22 strips: 16 warps would take two turns, as 11 do
    assert tdpb.sharded_geometry(4096, 1, 32, False, SMEM) == (
        32, 32, 192, 11, False)
    assert tdpb.sharded_geometry(4096, 1, 32, True, SMEM) == (
        32, 32, 192, 11, False)
    # half the shared memory: 7 rings fit, 22 strips in 4 turns of 6
    # warps, the frontier rows in device scratch
    assert tdpb.sharded_geometry(4096, 1, 32, True, SMEM // 2)[3:] == (
        6, True)
    assert tdpb.sharded_geometry(40000, 1, 32, False, SMEM) == (
        32, 32, 192, 15, True)
    assert tdpb.sharded_geometry(30000, 2, 32, True, SMEM) == (
        32, 64, 128, 14, True)
