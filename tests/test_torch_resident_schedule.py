"""A pure-torch model of the resident kernel's schedule
(lqr_tpu_torch/csrc/carve_resident.cu), held bit-equal to the plain version
(ops.carve_resident.carve_chunk_resident_plain) and to the JAX package's
carve_chunk_resident (its Pallas kernel in interpreter mode) on small
shapes.

Per seam the model follows the kernel: the side preference of the seam;
the energy pass into an E plane of the map's true height; each strip
window's energy read from it with the window's halo (+inf outside the
map); the DP in strips of S kept columns with G halo columns,
-inf beyond each window, K rows between frontier exchanges; the start
column by (value, column) pairs reduced per warp of 32 threads and then
over the warps; the chase through windows of rows x columns from that
column, reloaded when the rows end or the seam leaves the columns; the
record and the compaction by row slices, each warp two rows at a time in
ascending groups of 256 columns (every load of a group before its stores);
the zeros at x >= w0 - kc. A halo too narrow for K rows lets the poison
into the kept columns and fails the comparison.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lqr_tpu.core import engine as jeng
from lqr_tpu.core import state as jst
from lqr_tpu_torch.core import dp as tdp
from lqr_tpu_torch.core import engine as teng
from lqr_tpu_torch.core.energy import sqrt_f32
from lqr_tpu_torch.ops import carve_resident as tcr

torch.set_num_threads(1)

HALF = torch.tensor(np.float32(0.5))


def _energy(fam, gx, gy, bias):
    """core/energy.py's families on gradients (f32 ops in its order)."""
    if fam == 3:
        e = torch.zeros_like(gx)
    elif fam == 0:
        e = torch.abs(gx)
    elif fam == 1:
        e = (torch.abs(gx) + torch.abs(gy)) * HALF
    else:
        e = sqrt_f32(gx * gx + gy * gy)
    return e if bias is None else e + bias


def _family(nrg):
    return 3 if nrg == 6 else nrg % 3


def energy_plane(b, bias, w, h, nrg):
    """The energy pass: E [h, Wb] of the map, +inf at x >= w."""
    Wb = b.shape[1]
    x = torch.arange(Wb)
    bl = b[:h, (x - 1).clamp(min=0)]
    br = torch.where(x[None] < w - 1, b[:h, (x + 1).clamp(max=Wb - 1)],
                     b[:h])
    y = torch.arange(h)
    bu = b[(y - 1).clamp(min=0)]
    bd = b[torch.where(y < h - 1, y + 1, y)]
    gx = (br - bl) * HALF
    gy = (bd - bu) * HALF
    e = _energy(_family(nrg), gx, gy, None if bias is None else bias[:h])
    return torch.where(x[None] < w, e, torch.inf)


def _window_row(m, e, r, order, rigc, has_rig):
    """One DP row of a window: the kernel's strict-less scan in rank order,
    -inf beyond the window."""
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


def strip_dp(E, rig, h, pref_left, dx, rigc, geo):
    """The DP of rows 0 .. h - 1 of E in strips -> (M_last [Wb], bp [h,
    Wb])."""
    S, G, K = geo
    Wb = E.shape[1]
    order = tdp.rank_order(dx, pref_left)
    bp = torch.zeros((h, Wb), dtype=torch.int8)
    front = E[0].clone()
    W = S + 2 * G
    for y0 in range(1, h, K):
        y1 = min(y0 + K, h)
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
                ey = torch.where(inr, E[y, cc], torch.inf)
                ry = torch.where(inr, rig[y, cc], 0.0) if rig is not None \
                    else None
                m, bw = _window_row(m, ey, ry, order, rigc, rig is not None)
                bp[y, cols[kept]] = bw[kept]
            nxt[cols[kept]] = m[kept]
        front = nxt
    return front, bp


def start_column(M, w, pref_left, threads=64):
    """(value, column) pairs: each thread scans columns t, t + threads, ...
    below w; a butterfly over each warp of 32; then over the warps."""
    def better(v, x, bv, bx):
        return v < bv or (v == bv and (x < bx if pref_left else x > bx))
    init = (float("inf"), M.shape[0] if pref_left else -1)
    pairs = []
    for t in range(threads):
        bv, bx = init
        for x in range(t, w, threads):
            if better(float(M[x]), x, bv, bx):
                bv, bx = float(M[x]), x
        pairs.append((bv, bx))
    warps = []
    for w0 in range(0, threads, 32):
        lane = pairs[w0:w0 + 32]
        o = 16
        while o:
            lane = [lane[i ^ o] if better(*lane[i ^ o], *lane[i]) else lane[i]
                    for i in range(32)]
            o //= 2
        warps.append(lane[0])
    best = init
    for v, x in warps:
        if better(v, x, *best):
            best = (v, x)
    return best[1]


def chase(bp, x, rows=32, reach=64, span=144, align=16):
    """The windowed chase of chase.cuh from column x of the last row of bp
    ([h, Wb]) -> seam [h] int32."""
    h, Wb = bp.shape
    vec = Wb % align == 0 and Wb >= span
    sp = min(span, Wb)

    def window_at(top, x):
        lo = min(max(x - reach, 0), Wb - sp)
        return top, min(rows, top + 1), (lo & -align) if vec else lo

    seam = torch.full((h,), -1, dtype=torch.int32)
    y = h - 1
    top, n, lo = window_at(y, x)
    while y >= 0:
        nxt = window_at(y - n, x)
        ahead = vec and nxt[0] >= 0
        win = bp[top - n + 1:top + 1, lo:lo + sp].flip(0)
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
        else:
            top, n, lo = window_at(y, x)
    return seam


def compact(planes, seam, w, warps=16, rows_at_once=2, group=256):
    """The record's companion: each warp takes rows_at_once rows at a time,
    rows (g * rows_at_once + r) + k * warps * rows_at_once, in ascending
    groups of `group` columns, every load of a group before its stores."""
    H = seam.shape[0]
    for gw in range(warps):
        for y0 in range(gw * rows_at_once, H, warps * rows_at_once):
            ys = [y for y in range(y0, y0 + rows_at_once) if y < H]
            ngroups = max(-(-(w - 1 - int(seam[y])) // group) for y in ys)
            for g in range(ngroups):
                loads = []
                for y in ys:
                    x = int(seam[y]) + g * group + torch.arange(group)
                    x = x[x < w - 1]
                    loads.append((y, x, [p[y, x + 1].clone() for p in planes]))
                for y, x, vals in loads:
                    for p, v in zip(planes, vals):
                        p[y, x] = v


def chunk_model(b, bias, rig, pm, w0, d0, kc, dx, nrg, ssf, KC, geo,
                h=None, rigc=None, threads=64, warps=16):
    """The kernel's chunk -> (hist [KC, H], b', bias', rig', pm'): the DP's
    window geo = (S, G, K), the start column over block 0's threads, the
    compaction over the cluster's warps."""
    H, Wb = b.shape
    h = H if h is None else h
    rigc = (torch.from_numpy(tdp.rigc_table(dx, H)) if rigc is None
            else rigc)
    b, pm = b.clone(), pm.clone()
    bias = None if bias is None else bias.clone()
    rig = None if rig is None else rig.clone()
    hist = torch.full((KC, H), -1, dtype=torch.int32)
    for j in range(kc):
        w, s = w0 - j, d0 + j + 1
        left = ssf <= 0 or ((s - 1) // ssf) % 2 == 0
        E = energy_plane(b, bias, w, h, nrg)
        M, bp = strip_dp(E, rig, h, left, dx, rigc, geo)
        x = start_column(M, w, left, threads)
        seam = torch.empty(H, dtype=torch.int32)
        seam[:h] = chase(bp, x)
        seam[h:] = x
        hist[j] = pm.gather(1, seam[:, None].long())[:, 0]
        compact([p for p in (b, pm, bias, rig) if p is not None], seam, w,
                warps)
    keep = torch.arange(Wb)[None] < w0 - kc
    out = [torch.where(keep, p, 0) if p is not None else None
           for p in (b, bias, rig, pm)]
    return (hist, *out)


def _planes(seed, H, W, Wb, masks, flat=False):
    """A reader plane of few levels (ties on purpose), a bias of eighths, a
    rigidity of integers, the identity posmap; zero past W."""
    rng = np.random.default_rng(seed)
    p = np.zeros((3, H, Wb), np.float32)
    p[0, :, :W] = 0.5 if flat else rng.integers(0, 6, (H, W)) / np.float32(5)
    p[1, :, :W] = np.round(rng.standard_normal((H, W)) * 4) / 8
    p[2, :, :W] = np.abs(np.round(rng.standard_normal((H, W)) * 8))
    pm = np.zeros((H, Wb), np.int32)
    pm[:, :W] = np.arange(W)
    b, bias, rig = (torch.from_numpy(x) for x in p)
    return (b, bias if masks else None, rig if masks else None,
            torch.from_numpy(pm))


def _geo(dx, S=16):
    """A small window: S kept columns, G = 8 * max(dx, 1) halo columns, K
    rows, the most the halo holds."""
    G = 8 * max(dx, 1)
    return S, G, G // dx if dx else 8


def _kernel_geo(Wp, dx, cluster):
    """chunk_model's geo, threads and warps at the kernel's geometry on
    `cluster` (blocks, warps a block)."""
    csize, nwarps, _, _, S, G, K = tcr.resident_geometry(Wp, dx, cluster)
    return dict(geo=(S, G, K), threads=32 * nwarps, warps=csize * nwarps)


def _assert_chunk(got, want, kc):
    assert torch.equal(got[0][:kc], want[0][:kc])
    assert (got[0][kc:] == -1).all()
    for g, e in zip(got[1:], want[1:]):
        assert (g is None) == (e is None)
        if g is not None:
            assert torch.equal(g, e)


# (delta_x, nrg, masks, ssf, d0): delta_x 0..3 and 10; GRAD_XABS,
# GRAD_SUMABS, GRAD_NORM and NULL; masks on and off; ssf = 1 switches the
# side every seam inside the chunk, ssf = 0 keeps LEFT, and ssf = 4 at
# d0 = 4 starts on RIGHT
_CASES = [
    (0, 0, True, 1, 0),
    (1, 0, False, 1, 3),
    (1, 2, True, 1, 3),
    (2, 6, True, 4, 4),
    (2, 2, False, 0, 0),
    (3, 2, True, 1, 7),
    (3, 0, True, 4, 4),
    (10, 0, True, 1, 2),
    (10, 6, False, 1, 2),
    (0, 1, False, 4, 4),
]


@pytest.mark.parametrize("dx,nrg,masks,ssf,d0", _CASES)
def test_model_matches_plain(dx, nrg, masks, ssf, d0):
    H, W, Wb, kc = 11, 45, 48, 5
    b, bias, rig, pm = _planes(dx * 10 + nrg, H, W, Wb, masks)
    args = (b, bias, rig, pm, W, d0, kc, dx)
    want = tcr.carve_chunk_resident_plain(*args, masks, masks, nrg, ssf, 8)
    got = chunk_model(*args, nrg, ssf, 8, _geo(dx))
    _assert_chunk(got, want, kc)


@pytest.mark.parametrize("w0,d0,kc", [(40, 0, 6), (37, 0, 0), (38, 128, 4)])
def test_model_flat_map_and_kc_zero(w0, d0, kc):
    """Every candidate ties on a flat map; kc = 0 carves nothing and only
    zeroes past w0; a partial chunk at depth 128."""
    H, W, Wb = 9, 40, 40
    b, bias, rig, pm = _planes(5, H, W, Wb, True, flat=True)
    args = (b, bias, rig, pm, w0, d0, kc, 1)
    want = tcr.carve_chunk_resident_plain(*args, True, True, 0, 2, 8)
    got = chunk_model(*args, 0, 2, 8, _geo(1))
    _assert_chunk(got, want, kc)


@pytest.mark.parametrize("nrg,cluster", [
    pytest.param(0, None, id="0"), pytest.param(2, None, id="2"),
    pytest.param(0, (1, 4), id="0-1x4"), pytest.param(2, (2, 4), id="2-2x4"),
    pytest.param(0, (2, 8), id="0-2x8"), pytest.param(2, (4, 8), id="2-4x8"),
    pytest.param(0, (8, 8), id="0-8x8")])
def test_model_ragged_batch_matches_plain(nrg, cluster):
    """Three maps padded to H rows (true heights H, H // 2 + 1 and 1), each
    with its own rigidity coefficients, width, depth and seam count (one of
    them 0); rows >= h carry the seam of row h - 1. cluster None: a small
    window on 40 columns; else the batched entry's geometry on `cluster`
    (blocks, warps a block) for 256 columns."""
    from lqr_tpu_torch.parallel.batch import rigc_table
    H, dx = 12, 2
    if cluster is None:
        W, Wb, w0s = 37, 40, [37, 35, 30]
        kw = dict(geo=_geo(dx))
    else:
        W, Wb, w0s = 250, 256, [250, 241, 200]
        kw = _kernel_geo(Wb, dx, cluster)
    heights, kcs, d0s = [12, 7, 1], [5, 0, 4], [0, 3, 9]
    maps = [_planes(40 + i, H, W, Wb, True) for i in range(3)]
    for (b, bias, rig, _), h in zip(maps, heights):
        for p in (b, bias, rig):
            p[h:] = 0
    rigc = torch.from_numpy(rigc_table(heights, dx))
    stacked = [torch.stack(p) for p in zip(*maps)]
    params = tcr._batched_params(3, H, Wb, w0s, d0s, kcs, heights, 8)
    want = tcr.carve_chunk_resident_batched_plain(
        *stacked, params, rigc, dx, True, True, nrg, 2, 8)
    for i, (b, bias, rig, pm) in enumerate(maps):
        got = chunk_model(b, bias, rig, pm, w0s[i], d0s[i], kcs[i], dx, nrg,
                          2, 8, h=heights[i], rigc=rigc[i], **kw)
        _assert_chunk(got, [x[i] if x is not None else None for x in want],
                      kcs[i])


@pytest.mark.parametrize("cluster", [
    pytest.param(tcr.ONE_BLOCK, id="True"),
    *[pytest.param(c, id=f"True-{c[0]}x{c[1]}") for c in tcr.BATCH_CLUSTERS]])
def test_model_at_kernel_geometry(cluster):
    """The geometry the wrapper launches (resident_geometry) on each
    cluster (one block a map, "True", and each wider cluster; one map gets
    8 x 8), with the kernel's 256-column window over several strips, its
    block's threads and its cluster's warps."""
    H, W, Wb, dx = 10, 590, 600, 1
    Wp = tcr.padded_width(Wb)
    kw = _kernel_geo(Wp, dx, cluster)
    S, G, _ = kw["geo"]
    assert S + 2 * G == 256 and -(-Wp // S) > 1
    b, bias, rig, pm = _planes(9, H, W, Wb, True)
    args = (b, bias, rig, pm, W, 0, 3, dx)
    want = tcr.carve_chunk_resident_plain(*args, True, True, 2, 1, 8)
    got = chunk_model(*args, 2, 1, 8, **kw)
    _assert_chunk(got, want, 3)


@pytest.mark.parametrize("dx", [1, 2])
def test_model_halo_one_row_too_narrow_fails(dx):
    """K one row beyond what the halo holds lets the poison into the kept
    columns."""
    H, W, Wb = 12, 48, 48
    b, bias, rig, pm = _planes(3, H, W, Wb, False)
    args = (b, bias, rig, pm, W, 0, 3, dx)
    want = tcr.carve_chunk_resident_plain(*args, False, False, 0, 1, 8)
    S, G, K = _geo(dx)
    got = chunk_model(*args, 0, 1, 8, (S, G, K + 1))
    assert not torch.equal(got[1], want[1])


# a stubbed card: the clusters of each (blocks, warps a block) it holds at
# once for 1024 columns at delta_x 1 (an H100's answer)
_HELD = {(8, 8): 15, (8, 4): 30, (4, 8): 30, (4, 4): 62, (2, 8): 66,
         (2, 4): 132}


@pytest.mark.parametrize("B,cluster", [
    (1, (8, 8)), (2, (8, 8)), (15, (8, 8)), (16, (4, 8)), (17, (4, 8)),
    (31, (2, 8)), (64, (2, 8)), (100, (2, 4)), (256, (1, 4))])
def test_batch_cluster_rule(B, cluster):
    """The cluster with the most warps a map that the card holds B of at
    once, else one block of 4 warps a map; B = 1 runs under the budget of
    planes, a batch whenever its columns fit the kernel."""
    assert tcr.batch_cluster(B, _HELD.get) == cluster
    geo = tcr.resident_geometry(1024, 1, cluster)
    if cluster == tcr.ONE_BLOCK:
        assert geo == (1, 4, 1, 4, 128, 64, 64)
    else:
        assert geo == (*cluster, 2, 4, 128, 64, 64)
    if B == 1:
        for H in (1024, 4096):
            assert tcr.resident_ok(1, H, 1024, True, True) == (
                tcr.resident_bytes(H, 1024, True, True)
                <= tcr.RESIDENT_BUDGET)
        assert not tcr.resident_ok(1, 4096, 1024, True, True)
    else:
        assert tcr.resident_ok(B, 4096, 1024, True, True)
    assert not tcr.resident_ok(B, 16, tcr.MAX_WB + 128, False, False)


@pytest.mark.parametrize("H,W,masks,solo", [
    (2048, 2048, False, (8, 8, 4, 4, 128, 64, 64)),
    (768, 1024, True, (8, 8, 2, 4, 128, 64, 64)),
    (384, 512, False, (8, 8, 1, 3, 176, 40, 40))])
def test_one_map_keeps_the_solo_geometry(monkeypatch, H, W, masks, solo):
    """A batch of one, at the shapes Carver launches (2048^2; 1024x768
    with bias and rigidity; test_gate's 512x384), takes the resident route
    on 8 blocks of 8 warps with the geometry the solo launch had (`solo`,
    recorded from it on an H100's opt-in shared memory): the first
    cluster whenever the card holds one."""
    monkeypatch.setattr(tcr.dp_cuda, "smem_optin", lambda d: 232448)
    assert tcr.resident_ok(1, H, W, masks, masks)
    cluster = tcr.batch_cluster(1, lambda c: 1)
    assert cluster == (8, 8)
    Wp = tcr.padded_width(W)
    assert tcr._geometry(Wp, 1, cluster, torch.device("cuda", 0)) == solo


def test_batch_cluster_skips_a_cluster_too_narrow_for_the_strips():
    """8192 columns need the DP on 8 blocks: no cluster of 4 or 2."""
    assert tcr.resident_geometry(8192, 1, (8, 8))[:3] == (8, 8, 8)
    for cluster in ((4, 8), (2, 8), (2, 4)):
        assert tcr.resident_geometry(8192, 1, cluster) is None


def test_resident_clusters_asks_the_card_once(monkeypatch):
    """The occupancy query runs once per (device, Wp, delta_x, rigidity
    flag, cluster), with the launch's geometry; a cluster too narrow for
    the strips is never asked and holds none."""
    import contextlib
    asked = []

    class Lib:
        @staticmethod
        def lqr_resident_clusters(*args):
            asked.append(args)
            return {8: 15, 4: 30, 2: 66}[args[3]]

    dev = torch.device("cuda", 0)
    monkeypatch.setattr(tcr._build, "load", lambda: Lib)
    monkeypatch.setattr(tcr.dp_cuda, "smem_optin", lambda d: 232448)
    monkeypatch.setattr(tcr.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    tcr.resident_clusters.cache_clear()
    try:
        for _ in range(3):
            assert tcr.resident_clusters(dev, 1024, 1, True, (4, 8)) == 30
        assert tcr.resident_clusters(dev, 8192, 1, False, (2, 8)) == 0
        assert tcr.batch_cluster(31, functools.partial(
            tcr.resident_clusters, dev, 1024, 1, False)) == (2, 8)
    finally:
        tcr.resident_clusters.cache_clear()
    assert asked[0] == (1024, 1, 1, 4, 8, 2, 4, 128, 64, 64)
    assert [a[2:5] for a in asked] == [(1, 4, 8), (0, 8, 8), (0, 4, 8),
                                       (0, 2, 8)]


def test_start_column_and_chase_match_plain_backtrack():
    """The pair reduction gives the plain start column on ties, both sides;
    the chase from it gives the plain seam."""
    rng = np.random.default_rng(2)
    e = torch.from_numpy(np.round(rng.random((30, 200), dtype=np.float32)
                                  * 2) / 2)
    for pref in (True, False):
        M, bp = tdp.dp_forward(e, None, pref, 1, False)
        seam = chase(bp, start_column(M, 200, pref))
        assert torch.equal(seam, tdp.backtrack(M, bp, pref))


def _jax_pair(img, bias, rig, Wb, dx, nrg):
    H = img.shape[0]
    kw = dict(H=H, Wb=Wb, C=3, has_bias=bias is not None,
              has_rig=rig is not None, delta_x=dx, nrg=nrg)
    jcfg = jst.EngineConfig(use_pallas=False, **kw)
    from lqr_tpu_torch.core import state as tst
    t = tst.init_state(tst.EngineConfig(**kw), img, bias=bias, rig=rig,
                       device="cpu")
    return jcfg, jst.init_state(jcfg, img, bias=bias, rig=rig), t


@pytest.mark.parametrize("dx,nrg,batched", [(1, 0, False), (2, 2, True)])
def test_model_matches_jax_resident(monkeypatch, dx, nrg, batched):
    """The model against lqr_tpu's carve_chunk_resident (Pallas, interpreter
    mode) at the JAX tests' shape, bias and rigidity on, with one map's
    cluster (8 x 8) and with one block a map."""
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    from lqr_tpu.ops.carve_resident import carve_chunk_resident
    H, Wb, kc = 16, 256, 4
    rng = np.random.default_rng(77 + dx)
    img = (rng.integers(0, 8, (H, Wb, 3)) * 32).astype(np.uint8)
    bias = rng.standard_normal((H, Wb)).astype(np.float32)
    rig = np.abs(rng.standard_normal((H, Wb))).astype(np.float32)
    jcfg, j, t = _jax_pair(img, bias, rig, Wb, dx, nrg)
    jh, jb, jbias, jrig, jpm = carve_chunk_resident(
        j.cur_b, j.cur_bias, j.cur_rig, jeng._posmap_from_vs(j.vs, j.ref_w),
        j.ref_w, jnp.int32(0), jnp.int32(kc), dx, True, True, nrg,
        jcfg.side_switch_freq, jeng.KC)
    pm = teng._posmap(t.vs, t.ref_w)
    got = chunk_model(t.cur_b, t.cur_bias, t.cur_rig, pm, Wb, 0, kc, dx,
                      nrg, jcfg.side_switch_freq, jeng.KC,
                      **_kernel_geo(Wb, dx,
                                    tcr.ONE_BLOCK if batched
                                    else tcr.BATCH_CLUSTERS[0]))
    np.testing.assert_array_equal(got[0][:kc].numpy(), np.asarray(jh)[:kc])
    for g, e in ((got[1], jb), (got[2], jbias), (got[3], jrig)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    np.testing.assert_array_equal(got[4][:, :Wb - kc].numpy(),
                                  np.asarray(jpm)[:, :Wb - kc])
