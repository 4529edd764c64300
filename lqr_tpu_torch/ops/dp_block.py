"""The column-sharded DP: one block of rows, and one seam over every shard.

``dp_block`` is the counterpart of ``lqr_tpu.ops.dp_block.dp_block_pallas``,
with its contract: ``m0 [We]`` is the shard's frontier after the halo
exchange (+inf where nothing is known), ``e_ext [R, We]`` the energy slab and
``rig_ext [R, We]`` (or None) the rigidity slab, both halo-extended;
``first`` says that the block holds the image's row 0 (M = E, bp = 0
there). Returns ``(m_out [We] f32, bp [R, We] int8)``; the shard's own
columns are exact, the halo lanes upper bounds (``parallel/sharding.py``).
The rigidity coefficients are f32(m^1.5 / H) of the image's height H.
Unlike the Pallas kernel, ``We`` need not be a multiple of 128, and any
width is taken: the kernel (``csrc/dp_block.cu``) holds its two frontier
rows in shared memory, or in a ``[2, We]`` f32 scratch in device memory when
they do not fit it. ``dp_blocked`` is the loop of JAX's ``block_step`` over
every block of rows and every shard, one ``dp_block`` call each, with the
halo exchange between blocks as explicit copies to each shard's device:
the form that crosses devices.

``dp_sharded`` runs the same forward DP of one seam for up to MAX_SHARDS
shards that all lie on one CUDA device as one launch of
``csrc/dp_sharded.cu``: a thread-block cluster of one block per shard,
each reading its shard's planes in place, the halos exchanged through
distributed shared memory (a device scratch for slabs too wide for it).
Any slab width is taken. Its plain version ``dp_sharded_plain`` is the
per-block loop with ``dp_block_plain``; the outputs are bit-equal.
``sharded_geometry`` picks the kernel's warps and strips.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel on the current stream without synchronizing, or raises.
There is no fallback from a failed launch to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.dp import dp_row, rank_setup, rigc_table
from ..errors import LqrConfigError
from ..i18n import _
from . import _build, dp_cuda

__all__ = ["dp_block", "dp_block_plain", "dp_blocked", "dp_sharded",
           "dp_sharded_plain", "sharded_geometry", "MAX_SHARDS"]

INF = float("inf")
# csrc/dp_sharded.cu: the most shards (blocks of the cluster), the most
# warps a block and the rows of each warp's ring
MAX_SHARDS = 8
STRIP_WARPS = 16
RING_ROWS = 8


def _check_args(m0, e_ext, rig_ext, delta_x, has_rig) -> None:
    if e_ext.ndim != 2:
        raise ValueError(f"e_ext: expected [R, We], got {tuple(e_ext.shape)}")
    R, We = e_ext.shape
    dev = e_ext.device
    dp_cuda._check(e_ext, "e_ext", torch.float32, (R, We), dev)
    dp_cuda._check(m0, "m0", torch.float32, (We,), dev)
    if has_rig:
        if rig_ext is None:
            raise ValueError("has_rig set but rig_ext is None")
        dp_cuda._check(rig_ext, "rig_ext", torch.float32, (R, We), dev)
    if not 0 <= delta_x <= 10:
        raise ValueError(f"delta_x={delta_x} out of range 0..10")


def dp_block(m0: torch.Tensor, e_ext: torch.Tensor, rig_ext, pref_left: bool,
             first: bool, delta_x: int, has_rig: bool, H: int):
    """R DP rows of a halo-extended slab (see the module doc)."""
    _check_args(m0, e_ext, rig_ext, delta_x, has_rig)
    if e_ext.device.type == "cpu":
        return dp_block_plain(m0, e_ext, rig_ext, pref_left, first, delta_x,
                              has_rig, H)
    if e_ext.device.type != "cuda":
        raise ValueError(f"e_ext: unsupported device {e_ext.device}")

    R, We = e_ext.shape
    dev = e_ext.device
    lib = _build.load()
    m_out = torch.empty(We, dtype=torch.float32, device=dev)
    bp = torch.empty((R, We), dtype=torch.int8, device=dev)
    rigc = dp_cuda._rigc_device(delta_x, H, dev)
    scratch = (torch.empty(2 * We, dtype=torch.float32, device=dev)
               if 2 * We * 4 > dp_cuda.smem_optin(dev) else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_dp_block(m0.data_ptr(), e_ext.data_ptr(),
                              rig_ext.data_ptr() if has_rig else None,
                              rigc.data_ptr(), int(bool(pref_left)),
                              int(bool(first)), delta_x, R, We,
                              m_out.data_ptr(), bp.data_ptr(),
                              None if scratch is None else scratch.data_ptr(),
                              stream)
    _build.check(lib, rc, "lqr_dp_block")
    dp_cuda.LAUNCHES["dp_block"] += 1
    return m_out, bp


def dp_block_plain(m0, e_ext, rig_ext, pref_left: bool, first: bool,
                   delta_x: int, has_rig: bool, H: int):
    """The plain version, on any device: R rows of core.dp's ``dp_row``."""
    R, We = e_ext.shape
    order, dxs = rank_setup(delta_x, pref_left, e_ext.device)
    rigc = torch.from_numpy(rigc_table(delta_x, H))
    bp = torch.zeros((R, We), dtype=torch.int8, device=e_ext.device)
    M = m0
    for y in range(R):
        if first and y == 0:
            M = e_ext[0].clone()         # row 0 has no predecessor
            continue
        M, bp[y] = dp_row(M, e_ext[y], rig_ext[y] if has_rig else None,
                          order, dxs, rigc, has_rig)
    return M, bp


def dp_blocked(e_loc, rig_loc, pref_left: bool, delta_x: int, has_rig: bool,
               H: int, R: int, devices, block=dp_block):
    """The column-sharded forward DP as one ``block`` call per block of R
    rows and shard. e_loc / rig_loc: per-shard [H, Wl] tensors (rig_loc
    None without rigidity), shard c on devices[c]. Each block, every shard
    sends each neighbour its G = max(R * delta_x, 1) edge frontier values
    and [R, G] energy (and rigidity) slab as one packed copy; at the mesh's
    edges, and for delta_x = 0, the halo is +inf frontier and energy with
    zero rigidity. Returns (per-shard M_last [Wl], per-shard bp [H, Wl]
    int8)."""
    n = len(e_loc)
    Wl = e_loc[0].shape[-1]
    G = max(R * delta_x, 1)      # halo width (>= 1 keeps shapes non-empty)
    exchange = n > 1 and delta_x > 0
    inf_f = [torch.full((G,), INF, device=dv) for dv in devices]
    inf_e = [torch.full((R, G), INF, device=dv) for dv in devices]
    zero_r = [torch.zeros((R, G), device=dv) for dv in devices]
    M = [torch.full((Wl,), INF, device=dv) for dv in devices]
    bps = [[] for _ in range(n)]

    for blk in range(H // R):
        rows = slice(blk * R, (blk + 1) * R)
        e_blk = [e[rows] for e in e_loc]
        r_blk = [r[rows] for r in rig_loc] if has_rig else None

        def pack(c, sl):
            """The [1 + R (+ R), G] plane one shard sends one neighbour:
            frontier, energy slab and rigidity slab in one copy."""
            parts = [M[c][None, sl], e_blk[c][:, sl]]
            if has_rig:
                parts.append(r_blk[c][:, sl])
            return torch.cat(parts, dim=0)

        if exchange:   # every shard sends before any frontier moves on
            to_right = [pack(c, slice(Wl - G, Wl)) for c in range(n - 1)]
            to_left = [None] + [pack(c, slice(0, G)) for c in range(1, n)]

        def unpack(halo, c):
            if halo is None:
                return inf_f[c], inf_e[c], zero_r[c]
            halo = halo.to(devices[c])
            return (halo[0], halo[1:1 + R],
                    halo[1 + R:] if has_rig else zero_r[c])

        for c in range(n):
            fl, el, rl = unpack(to_right[c - 1] if exchange and c > 0
                                else None, c)
            fr, er, rr = unpack(to_left[c + 1] if exchange and c < n - 1
                                else None, c)
            m_ext = torch.cat([fl, M[c], fr])
            e_ext = torch.cat([el, e_blk[c], er], dim=1)
            r_ext = (torch.cat([rl, r_blk[c], rr], dim=1) if has_rig
                     else None)
            m_new, bp_ext = block(m_ext, e_ext, r_ext, pref_left, blk == 0,
                                  delta_x, has_rig, H)
            M[c] = m_new[G:G + Wl]
            bps[c].append(bp_ext[:, G:G + Wl])
    return M, [torch.cat(b, dim=0) for b in bps]


def dp_sharded_plain(e_loc, rig_loc, pref_left: bool, delta_x: int,
                     has_rig: bool, H: int, R: int):
    """The plain version of dp_sharded, on any device: the per-block loop
    with dp_block_plain."""
    return dp_blocked(e_loc, rig_loc, pref_left, delta_x, has_rig, H, R,
                      [e.device for e in e_loc], block=dp_block_plain)


def sharded_geometry(Wl: int, delta_x: int, R: int, has_rig: bool,
                     smem: int):
    """The geometry of csrc/dp_sharded.cu for shards of Wl columns:
    (K, Gi, S, warps, global_front). Strips of S kept columns of a 256-column
    window with Gi = round_up(delta_x * K, 8) halo columns on each side, K
    = R rows between reloads (fewer where delta_x * R > 64); one warp a
    strip up to STRIP_WARPS warps or as many rings as `smem` bytes hold,
    past that each warp running several strips in turn (the fewest warps
    that need no more turns). global_front: the two frontier rows do not
    fit `smem` beside the rings, and lie in a device scratch."""
    G = max(R * delta_x, 1)
    We = Wl + 2 * G
    K = R if delta_x * R <= 64 else max(1, 64 // delta_x)
    Gi = dp_cuda._cdiv(delta_x * K, 8) * 8
    S = dp_cuda.WINDOW - 2 * Gi
    ring = RING_ROWS * dp_cuda.WINDOW * 4 * (2 if has_rig else 1)
    strips = dp_cuda._cdiv(We, S)
    turns = dp_cuda._cdiv(strips, min(strips, STRIP_WARPS, smem // ring))
    warps = dp_cuda._cdiv(strips, turns)
    front = 2 * dp_cuda._cdiv(We, 4) * 4 * 4
    return K, Gi, S, warps, warps * ring + front > smem


def dp_sharded(e_loc, rig_loc, pref_left: bool, delta_x: int, has_rig: bool,
               H: int, R: int):
    """The column-sharded forward DP of one seam in one launch, for shards
    that all lie on one CUDA device (see the module doc); on CPU tensors the
    plain version. e_loc / rig_loc: per-shard [H, Wl] f32 (rig_loc None
    without rigidity), read in place; R: rows per halo exchange. Returns
    (per-shard M_last [Wl], per-shard bp [H, Wl] int8). More than
    MAX_SHARDS shards raise LqrConfigError: one cluster holds no more."""
    n = len(e_loc)
    if not 1 <= n <= MAX_SHARDS:
        raise LqrConfigError(
            _("{n} column shards: the one-launch sharded DP runs one "
              "thread-block cluster of 1 to {m} blocks")
            .format(n=n, m=MAX_SHARDS))
    Wl = e_loc[0].shape[-1]
    dev = e_loc[0].device
    for c in range(n):
        dp_cuda._check(e_loc[c], f"e_loc[{c}]", torch.float32, (H, Wl), dev)
        if has_rig:
            dp_cuda._check(rig_loc[c], f"rig_loc[{c}]", torch.float32,
                           (H, Wl), dev)
    if not 0 <= delta_x <= 10:
        raise ValueError(f"delta_x={delta_x} out of range 0..10")
    if R < 1 or H % R != 0 or max(R * delta_x, 1) > Wl:
        raise ValueError(f"dp_sharded: R={R} rows per exchange do not fit "
                         f"H={H}, Wl={Wl}, delta_x={delta_x}")
    if dev.type == "cpu":
        return dp_sharded_plain(e_loc, rig_loc, pref_left, delta_x, has_rig,
                                H, R)
    if dev.type != "cuda":
        raise ValueError(f"e_loc: unsupported device {dev}")

    K, Gi, S, warps, gfront = sharded_geometry(
        Wl, delta_x, R, has_rig, dp_cuda.smem_optin(dev))
    lib = _build.load()
    ptrs = ctypes.c_void_p * n
    e = ptrs(*[t.data_ptr() for t in e_loc])
    rig = ptrs(*[t.data_ptr() for t in rig_loc]) if has_rig else None
    m_last = torch.empty((n, Wl), dtype=torch.float32, device=dev)
    bp = torch.empty((n, H, Wl), dtype=torch.int8, device=dev)
    We = Wl + 2 * max(R * delta_x, 1)
    scratch = (torch.empty(n * 2 * dp_cuda._cdiv(We, 4) * 4,
                           dtype=torch.float32, device=dev)
               if gfront else None)
    rigc = dp_cuda._rigc_device(delta_x, H, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_dp_sharded(e, rig, rigc.data_ptr(), int(bool(pref_left)),
                                delta_x, n, H, Wl, R, warps, K, Gi, S,
                                m_last.data_ptr(), bp.data_ptr(),
                                None if scratch is None else scratch.data_ptr(),
                                stream)
    _build.check(lib, rc, "lqr_dp_sharded")
    dp_cuda.LAUNCHES["dp_sharded"] += 1
    return list(m_last.unbind(0)), list(bp.unbind(0))
