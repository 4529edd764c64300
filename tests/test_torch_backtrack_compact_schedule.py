"""A pure-torch model of backtrack_compact's schedule
(lqr_tpu_torch/csrc/carve_step.cu), held bit-equal to the plain version
(ops.carve_step.backtrack_compact_plain) and to the JAX package's
carve_step_pallas (its Pallas kernels in interpreter mode) on small shapes.

The model follows the kernel's order of work: the start column by (value,
column) pairs, each of 256 threads over its strided columns, reduced per
warp of 32 by a butterfly and then over the warps; the windowed chase of
chase.cuh (windows of 32 rows by 144 columns, reloaded where the seam
leaves the columns), which publishes after each window that every row >= y
is in seam[]; tickets of bands of 8 rows by 2048-column segments from row
H - 1 upward, each compacted only once its rows are published, reading
seam[] as it then stands; the compaction a warp a row, in groups of
4-column vectors with the next column taken from the neighbour lane (the
edge lane loads it), or a column a lane where Wb % 4 != 0 or a plane is
not 16-byte aligned. seam[] holds an earlier launch's values until the
chase writes it, so a band read before its rows are published fails the
comparison.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lqr_tpu_torch.ops import carve_step as tcs

torch.set_num_threads(1)

THREADS = 256       # csrc/carve_step.cu: kThreads
BAND = 8            # kBand: rows of a band, a warp a row
SEG = 512           # kSeg: columns of a band's segment
GROUP = 4           # kGroup: 16-byte vectors in flight a lane
STALE = -1          # seam[] before the chase writes it


def _better(v, x, bv, bx, left):
    return v < bv or (v == bv and (x < bx if left else x > bx))


def _butterfly(pairs, left):
    o = 16
    while o:
        pairs = [pairs[i ^ o] if _better(*pairs[i ^ o], *pairs[i], left)
                 else pairs[i] for i in range(32)]
        o //= 2
    return pairs[0]


def start_column(M, left):
    """The chaser block's start column: (value, column) pairs."""
    Wb = M.shape[0]
    init = (float("inf"), Wb if left else -1)
    pairs = []
    for t in range(THREADS):
        bv, bx = init
        for x in range(t, Wb, THREADS):
            if _better(float(M[x]), x, bv, bx, left):
                bv, bx = float(M[x]), x
        pairs.append((bv, bx))
    warps = [_butterfly(pairs[k:k + 32], left)
             for k in range(0, THREADS, 32)]
    return _butterfly(warps + [init] * (32 - len(warps)), left)[1]


def chase(bp, x, seam, rows=32, reach=64, span=144, align=16):
    """The windowed chase from column x of row H - 1, writing seam[] ([H]
    int32) and yielding y after each window: every row >= y is in seam[];
    last, 0 (the kernel's final publication)."""
    H, Wb = bp.shape
    vec = Wb % align == 0 and Wb >= span
    sp = min(span, Wb)

    def window_at(top, x):
        lo = min(max(x - reach, 0), Wb - sp)
        return top, min(rows, top + 1), (lo & -align) if vec else lo

    y = H - 1
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
        yield y + 1
        if y < 0:
            break
        if ahead and r == n and 0 <= x - nxt[2] < sp:
            top, n, lo = nxt
        else:
            top, n, lo = window_at(y, x)
    yield 0


def compact_vec(a, out, y, s, w, c0, c1):
    """Columns [c0, c1) of row y, 4-column vectors a lane."""
    Wb = a.shape[1]
    lane = torch.arange(32)
    keep = w - 1
    for base in range(c0, c1, 128 * GROUP):
        for g in range(GROUP):
            if base + 128 * g >= c1:
                break                           # no lane stores
            x = base + 128 * g + 4 * lane
            inside = x < c1
            cols = (x[:, None] + torch.arange(4)).clamp(max=Wb - 1)
            v = torch.where((inside & (x < w))[:, None], a[y, cols], 0.0)
            last = (lane == 31) | (x + 4 >= c1)
            edge = torch.where(inside & last & (x + 4 < w),
                               a[y, (x + 4).clamp(max=Wb - 1)], 0.0)
            down = torch.roll(v[:, 0], -1)      # lane + 1's first column
            nx = torch.where(last, edge, down)
            nxt = torch.cat([v[:, 1:], nx[:, None]], 1)
            xs = x[:, None] + torch.arange(4)
            o = torch.where(xs < keep, torch.where(xs >= s, nxt, v), 0.0)
            for i in torch.nonzero(inside)[:, 0].tolist():
                out[y, x[i]:x[i] + 4] = o[i]


def compact_scalar(a, out, y, s, w, c0, c1):
    """Columns [c0, c1) of row y, a column a lane."""
    Wb = a.shape[1]
    x = torch.arange(c0, c1)
    src = torch.where(x >= s, x + 1, x).clamp(max=Wb - 1)
    out[y, c0:c1] = torch.where(x < w - 1, a[y, src], 0.0)


def schedule(M, bp, planes, w, left, aligned=True, seg=SEG, band=BAND,
             early=0):
    """The kernel's launch -> (seam, compacted planes). planes: the planes
    present; aligned: every plane 16-byte aligned; early: rows a band is
    read before it is published (0 in the kernel)."""
    H, Wb = bp.shape
    seam = torch.full((H,), STALE, dtype=torch.int32)
    outs = [torch.full_like(p, torch.nan) for p in planes]
    compact = compact_vec if Wb % 4 == 0 and aligned else compact_scalar
    nseg = -(-Wb // seg)
    tickets = [(max(0, H - (k + 1) * band), H - k * band, c * seg,
                min(Wb, (c + 1) * seg))
               for k in range(-(-H // band)) for c in range(nseg)]
    pubs = []
    for pub in chase(bp, start_column(M, left), seam):
        pubs.append(pub)
        while tickets and tickets[0][0] + early >= pub:
            y0, y1, c0, c1 = tickets.pop(0)
            for y in range(y0, y1):
                s = int(seam[y])          # read past the L1: as it stands
                for p, o in zip(planes, outs):
                    compact(p, o, y, s, w, c0, c1)
    assert not tickets and pubs[-1] == 0
    assert pubs == sorted(pubs, reverse=True)
    return seam, outs, pubs


def _planes(seed, H, W, Wb, flat=False):
    """A reader plane of six levels (ties on purpose; one level if flat),
    a bias of eighths, a rigidity of integers; zero past W."""
    rng = np.random.default_rng(seed)
    p = np.zeros((3, H, Wb), np.float32)
    p[0, :, :W] = 0.4 if flat else rng.integers(0, 6, (H, W)) / np.float32(5)
    p[1, :, :W] = np.round(rng.standard_normal((H, W)) * 4) / 8
    p[2, :, :W] = np.abs(np.round(rng.standard_normal((H, W)) * 8))
    return tuple(torch.from_numpy(a) for a in p)


def _run(case, left, **kw):
    """The model and the plain version on one case, both sides."""
    H, W, Wb, w, dx, masks, kind = case
    b, bias, rig = _planes(H + Wb + dx, H, W, Wb, flat=kind == "flat")
    planes = (b, bias if masks else None, rig if masks else None)
    M, bp = tcs.dp_energy_forward_plain(*planes, w, left, dx, masks, masks,
                                        0)
    want = tcs.backtrack_compact_plain(M, bp, *planes, w, left, masks,
                                       masks)
    seam, outs, pubs = schedule(M, bp, [p for p in planes if p is not None],
                                w, left, aligned=kind != "offset", **kw)
    return (seam, *outs), [want[0]] + [e for e, p in zip(want[1:], planes)
                                       if p is not None], pubs


# (H, W, Wb, w, delta_x, masks, planes): the kernel's edges (planes
# "ties", "flat" for one level, "offset" for planes off a 16-byte boundary)
_CASES = [
    (40, 250, 256, 231, 1, True, "ties"),     # vector chase and compaction
    (37, 101, 101, 90, 2, True, "ties"),      # Wb % 4 != 0, Wb < 144
    (45, 120, 120, 120, 3, False, "ties"),    # Wb < 144, vectors, w = Wb
    (20, 300, 304, 290, 2, True, "ties"),     # H < 32: one partial window
    (1, 50, 64, 50, 1, True, "ties"),         # H = 1
    (30, 100, 128, 1, 1, True, "ties"),       # w = 1: every output 0
    (30, 1, 1, 1, 0, True, "ties"),           # Wb = 1
    (70, 300, 320, 300, 7, False, "ties"),    # seams leave their windows
    (61, 160, 160, 160, 10, True, "ties"),
    (50, 64, 64, 64, 2, False, "flat"),       # ties everywhere
    (90, 200, 208, 200, 1, True, "flat"),
    (33, 200, 200, 200, 1, True, "offset"),   # the scalar compaction
]


@pytest.mark.parametrize("case", _CASES)
def test_model_matches_plain(case):
    for left in (True, False):
        got, want, pubs = _run(case, left)
        for g, e in zip(got, want):
            assert torch.equal(g, e), left
        # a window at a time: at least one publication each 32 rows
        assert len(pubs) >= -(-case[0] // 32) + 1


@pytest.mark.parametrize("seg,band", [(128, 8), (256, 3), (12, 5)])
def test_model_segments_and_bands(seg, band):
    """Bands that do not divide H and several column segments (smaller than
    the kernel's, so a small map has many): the same result."""
    case = (43, 500, 512, 480, 2, True, "ties")
    for left in (True, False):
        got, want, _ = _run(case, left, seg=seg, band=band)
        for g, e in zip(got, want):
            assert torch.equal(g, e), left


def test_start_column_pairs_on_ties():
    """The pair reduction takes the leftmost minimum for LEFT and the
    rightmost for RIGHT, over ties, +inf lanes and a -inf, as the plain
    backtrack does."""
    from lqr_tpu_torch.core import dp as tdp
    rng = np.random.default_rng(4)
    for Wb, w in ((1000, 900), (256, 256), (7, 3)):
        M = np.full(Wb, np.inf, np.float32)
        M[:w] = rng.integers(0, 3, w)
        for m in (M, np.where(np.arange(Wb) == w // 2, -np.inf, M)):
            m = torch.from_numpy(m.astype(np.float32))
            bp = torch.zeros((1, Wb), dtype=torch.int8)
            for left in (True, False):
                assert start_column(m, left) == int(tdp.backtrack(m, bp,
                                                                  left)[0])


@pytest.mark.parametrize("early", [BAND, 32])
def test_model_reading_before_publication_fails(early):
    """A band read `early` rows before its rows are all published compacts
    along seam[]'s stale values and differs from the plain version."""
    got, want, _ = _run((100, 250, 256, 240, 1, True, "ties"), True,
                        early=early)
    assert not all(torch.equal(g, e) for g, e in zip(got[1:], want[1:]))


@pytest.mark.parametrize("dx,masks", [(1, True), (2, False)])
def test_model_matches_jax_carve_step(monkeypatch, dx, masks):
    """The model on the port's plain DP against lqr_tpu's carve_step_pallas
    (Pallas, interpreter mode) at the JAX tests' shape, both sides."""
    monkeypatch.setenv("LQR_PALLAS_INTERPRET", "1")
    from lqr_tpu.ops import dp_pallas
    H, W, Wb = 32, 1000, 1024
    b, bias, rig = _planes(3 + dx, H, W, Wb)
    for left in (True, False):
        want = dp_pallas.carve_step_pallas(
            jnp.asarray(b.numpy()), jnp.asarray(bias.numpy()),
            jnp.asarray(rig.numpy()), jnp.int32(W), jnp.bool_(left), dx,
            masks, masks, 0, fuse_energy=dx == 1)
        planes = (b, bias if masks else None, rig if masks else None)
        M, bp = tcs.dp_energy_forward_plain(*planes, W, left, dx, masks,
                                            masks, 0)
        seam, outs, _ = schedule(M, bp, [p for p in planes if p is not None],
                                 W, left)
        np.testing.assert_array_equal(seam.numpy(), np.asarray(want[0]))
        for o, e in zip(outs, want[1:]):
            np.testing.assert_array_equal(o.numpy(), np.asarray(e))


def test_sync_words_epochs(monkeypatch):
    """Each launch on a stream takes the next epoch on that stream's words;
    streams keep words of their own; past the last epoch a stream gets
    fresh zero words and starts again at 1."""
    monkeypatch.setattr(tcs, "_SYNC", {})
    monkeypatch.setattr(tcs, "_EPOCHS", 3)
    dev = torch.device("cpu")
    a = [tcs._sync_words(dev, 11) for _ in range(3)]
    b = tcs._sync_words(dev, 22)
    assert [e for _, e in a] == [1, 2, 3] and b[1] == 1
    assert all(w is a[0][0] for w, _ in a) and b[0] is not a[0][0]
    a[0][0].fill_(7)
    words, epoch = tcs._sync_words(dev, 11)
    assert epoch == 1 and words is not a[0][0] and not words.any()
