"""NumPy reference implementation of SPEC.md — the correctness oracle.

The port's own copy of ``lqr_tpu.oracle`` (importing that module would
import jax), function for function and bit for bit; only its config comes
from the port's ``config``. It is deliberately simple (loops where clarity
wins): the ground truth that the C++ single-core reference
(``native/lqr_ref.cpp``), the JAX engine and the port are held against.
``strength`` is also the mask reader of the port's host API.

It implements the capability surface of liblqr as used by the reference
plugin (SURVEY.md §2.3): energy functions, bias/rigidity fields, the
cumulative-cost DP with delta_x and side-switch tie-breaking, successive seam
computation with a visibility map, shrink/enlarge materialization, flatten,
and attached aux carvers.
"""

from __future__ import annotations

import numpy as np

from .config import EnergyFunc, DEFAULT_SIDE_SWITCH_FREQUENCY

INF = np.float32(np.inf)

LUMA_W = (0.2126, 0.7152, 0.0722)  # SPEC.md §1 [CHOICE: Rec.709]


# ---------------------------------------------------------------------------
# §1 pixel readers
# ---------------------------------------------------------------------------

def strength(img: np.ndarray) -> np.ndarray:
    """Mask strength: mean(color)/255 * alpha (SPEC.md §1; wiki:48).

    Op order is pinned for bit-exact cross-implementation matching:
    sum(color channels, f32) / f32(255*nc), then * (alpha / 255).
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    has_alpha = c in (2, 4)
    nc = c - (1 if has_alpha else 0)
    s = img[:, :, :nc].astype(np.float32).sum(axis=2, dtype=np.float32)
    s = s * np.float32(1.0 / (255 * nc))
    if has_alpha:
        s = s * (img[:, :, -1].astype(np.float32) * np.float32(1.0 / 255))
    return s.astype(np.float32)


def brightness(img: np.ndarray) -> np.ndarray:
    """Image brightness reader == mask strength rule (SPEC.md §1)."""
    return strength(img)


def luma(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    has_alpha = c in (2, 4)
    nc = c - (1 if has_alpha else 0)
    if nc >= 3:
        f = img[:, :, :3].astype(np.float32)
        # pinned op order: ((w0*R + w1*G) + w2*B) / 255
        s = np.float32(LUMA_W[0]) * f[:, :, 0]
        s = s + np.float32(LUMA_W[1]) * f[:, :, 1]
        s = s + np.float32(LUMA_W[2]) * f[:, :, 2]
        s = s * np.float32(1.0 / 255)
    else:
        s = img[:, :, 0].astype(np.float32) * np.float32(1.0 / 255)
    if has_alpha:
        s = s * (img[:, :, -1].astype(np.float32) * np.float32(1.0 / 255))
    return s.astype(np.float32)


# ---------------------------------------------------------------------------
# §2 energy functions
# ---------------------------------------------------------------------------

def gradients(b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Central differences with edge replication, /2 (SPEC.md §2)."""
    h, w = b.shape
    xm = np.maximum(np.arange(w) - 1, 0)
    xp = np.minimum(np.arange(w) + 1, w - 1)
    ym = np.maximum(np.arange(h) - 1, 0)
    yp = np.minimum(np.arange(h) + 1, h - 1)
    gx = (b[:, xp] - b[:, xm]) * np.float32(0.5)
    gy = (b[yp, :] - b[ym, :]) * np.float32(0.5)
    return gx.astype(np.float32), gy.astype(np.float32)


def energy(img: np.ndarray, nrg: EnergyFunc) -> np.ndarray:
    """Energy map of a (current, compacted) image. img: [h, w, c] uint8."""
    h, w = img.shape[:2]
    if nrg == EnergyFunc.NULL:
        return np.zeros((h, w), np.float32)
    if nrg in (EnergyFunc.GRAD_XABS, EnergyFunc.GRAD_SUMABS,
               EnergyFunc.GRAD_NORM):
        b = brightness(img)
    else:
        b = luma(img)
    gx, gy = gradients(b)
    if nrg in (EnergyFunc.GRAD_XABS, EnergyFunc.LUMA_GRAD_XABS):
        e = np.abs(gx)
    elif nrg in (EnergyFunc.GRAD_SUMABS, EnergyFunc.LUMA_GRAD_SUMABS):
        e = (np.abs(gx) + np.abs(gy)) * np.float32(0.5)
    else:
        e = np.sqrt(gx * gx + gy * gy)
    return e.astype(np.float32)


# ---------------------------------------------------------------------------
# §5 DP + backtrack
# ---------------------------------------------------------------------------

def dx_order(delta_x: int, pref_left: bool) -> list[int]:
    """Candidate scan order (SPEC.md §5)."""
    order = [0]
    for m in range(1, delta_x + 1):
        pair = [-m, m] if pref_left else [m, -m]
        order.extend(pair)
    return order


def find_seam(e_tot: np.ndarray, rig: np.ndarray, delta_x: int,
              pref_left: bool, full_h: int) -> np.ndarray:
    """One minimal seam on an [h, w] energy(+bias) map.

    rig: per-pixel rigidity [h, w] (may be all zeros). full_h is the H used
    for the /H rigidity normalization (SPEC.md §4).
    Returns seam[y] = column index per row.
    """
    h, w = e_tot.shape
    M_prev = e_tot[0].astype(np.float32)
    bp = np.zeros((h, w), np.int8)
    order = dx_order(delta_x, pref_left)
    for y in range(1, h):
        best = np.full(w, np.inf, np.float32)
        bbp = np.zeros(w, np.int8)
        for dx in order:
            # cost of arriving at x from x+dx in the previous row; the
            # rigidity step constant is rounded to f32 once (SPEC.md §4)
            rigc = np.float32((abs(dx) ** 1.5) / float(full_h))
            src = np.arange(w) + dx
            valid = (src >= 0) & (src < w)
            c = np.full(w, np.inf, np.float32)
            c[valid] = M_prev[src[valid]] + rig[y][valid] * rigc
            take = c < best
            best[take] = c[take]
            bbp[take] = dx
        M_prev = (e_tot[y] + best).astype(np.float32)
        bp[y] = bbp
    # start point
    if pref_left:
        x = int(np.argmin(M_prev))
    else:
        x = int(w - 1 - np.argmin(M_prev[::-1]))
    seam = np.zeros(h, np.int64)
    seam[h - 1] = x
    for y in range(h - 1, 0, -1):
        x = x + int(bp[y, x])
        seam[y - 1] = x
    return seam


def pref_is_left(s: int, freq: int = DEFAULT_SIDE_SWITCH_FREQUENCY) -> bool:
    """Side preference of seam s (1-based). SPEC.md §5."""
    if freq <= 0:
        return True
    return ((s - 1) // freq) % 2 == 0


# ---------------------------------------------------------------------------
# §6 carving / visibility map / materialization
# ---------------------------------------------------------------------------

def remove_seam(arr: np.ndarray, seam: np.ndarray) -> np.ndarray:
    """Remove one pixel per row at seam[y]. arr: [h, w, ...]."""
    h, w = arr.shape[:2]
    out = np.empty((h, w - 1) + arr.shape[2:], arr.dtype)
    for y in range(h):
        out[y] = np.concatenate([arr[y, :seam[y]], arr[y, seam[y] + 1:]],
                                axis=0)
    return out


def compute_vs_map(img: np.ndarray, n_seams: int, *,
                   nrg: EnergyFunc = EnergyFunc.GRAD_XABS,
                   bias: np.ndarray | None = None,
                   rig: np.ndarray | None = None,
                   delta_x: int = 1,
                   side_switch_freq: int = DEFAULT_SIDE_SWITCH_FREQUENCY,
                   start_seam: int = 1,
                   vs: np.ndarray | None = None) -> np.ndarray:
    """Compute/extend a visibility map by carving n_seams successively.

    img is the *reference* image [H, W, C] u8; bias/rig live on reference
    coords. Seams start_seam .. start_seam+n_seams-1 are recorded into vs
    (allocated zero if not given). Extension carves from the fully-shrunk
    state of the existing map (SPEC.md §7).
    """
    H, W = img.shape[:2]
    if vs is None:
        vs = np.zeros((H, W), np.int32)
    else:
        vs = vs.copy()
    if bias is None:
        bias = np.zeros((H, W), np.float32)
    if rig is None:
        rig = np.zeros((H, W), np.float32)

    # compact existing map away
    colmap = np.tile(np.arange(W, dtype=np.int64), (H, 1))
    keep = vs == 0
    cur_w = int(keep[0].sum())
    assert np.all(keep.sum(axis=1) == cur_w), "corrupt vs map"
    cur_img = np.empty((H, cur_w) + img.shape[2:], img.dtype)
    cur_bias = np.empty((H, cur_w), np.float32)
    cur_rig = np.empty((H, cur_w), np.float32)
    cur_colmap = np.empty((H, cur_w), np.int64)
    for y in range(H):
        idx = np.nonzero(keep[y])[0]
        cur_img[y] = img[y, idx]
        cur_bias[y] = bias[y, idx]
        cur_rig[y] = rig[y, idx]
        cur_colmap[y] = colmap[y, idx]

    for i in range(n_seams):
        s = start_seam + i
        pl = pref_is_left(s, side_switch_freq)
        e = energy(cur_img, nrg) + cur_bias
        seam = find_seam(e, cur_rig, delta_x, pl, H)
        for y in range(H):
            vs[y, cur_colmap[y, seam[y]]] = s
        cur_img = remove_seam(cur_img, seam)
        cur_bias = remove_seam(cur_bias, seam)
        cur_rig = remove_seam(cur_rig, seam)
        cur_colmap = remove_seam(cur_colmap, seam)
    return vs


def materialize(ref: np.ndarray, vs: np.ndarray, w: int) -> np.ndarray:
    """Materialize width w from (reference image, vs map). SPEC.md §6."""
    H, W = ref.shape[:2]
    if w <= W:
        k = W - w
        out = np.empty((H, w) + ref.shape[2:], ref.dtype)
        for y in range(H):
            keep = (vs[y] == 0) | (vs[y] > k)
            out[y] = ref[y, np.nonzero(keep)[0]]
        return out
    k = w - W
    out = np.empty((H, w) + ref.shape[2:], ref.dtype)
    for y in range(H):
        j = 0
        for x in range(W):
            p = ref[y, x]
            out[y, j] = p
            j += 1
            if 1 <= vs[y, x] <= k:
                nxt = ref[y, min(x + 1, W - 1)]
                if np.issubdtype(ref.dtype, np.integer):
                    # floor average in integer arithmetic (SPEC.md §6
                    # [CHOICE])
                    out[y, j] = ((p.astype(np.uint16)
                                  + nxt.astype(np.uint16))
                                 // 2).astype(ref.dtype)
                else:
                    # float planes (bias/rig) average exactly like the
                    # engine's _avg_insert: (a + b) * 0.5 in the plane
                    # dtype (engine.py _avg_insert float branch)
                    out[y, j] = (p + nxt) * ref.dtype.type(0.5)
                j += 1
        assert j == w
    return out


# ---------------------------------------------------------------------------
# convenience: full shrink-by-n pipeline (benchmark config #1 semantics)
# ---------------------------------------------------------------------------

def carve_width(img: np.ndarray, new_w: int, **kw) -> np.ndarray:
    """Shrink or enlarge width of img to new_w (single pass; new_w within
    enl_step of W for enlargement). Returns the materialized image."""
    W = img.shape[1]
    n = abs(W - new_w)
    vs = compute_vs_map(img, n, **kw)
    return materialize(img, vs, new_w)
