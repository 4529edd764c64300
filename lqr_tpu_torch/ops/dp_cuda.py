"""Seam DP and backtrack: the CUDA kernels and their plain versions.

Counterpart of ``lqr_tpu.ops.dp_pallas.find_seam_pallas``. Each wrapper
takes the same arguments as its plain version in ``core/dp.py`` (re-exported
here as ``*_plain``). On a CPU tensor it runs the plain version; on a CUDA
tensor it launches its kernel (``csrc/dp_forward.cu``, ``csrc/backtrack.cu``)
on the current stream without synchronizing, or raises. There is no
fallback from a failed launch to the plain version.

``LAUNCHES`` counts successful kernel launches per kernel, so a run can show
that its main path went through the kernels; it also counts the kernels of
``ops/carve_resident.py``, ``ops/dp_block.py`` (``dp_block`` and
``dp_sharded``) and ``ops/carve_step.py``. It is ``profiling.COUNTERS``'s
group ``LAUNCHES``.

The DP kernel runs warp strips with K-row halos over a thread-block cluster
(``csrc/dp_forward.cu``); ``strip_geometry`` picks its blocks, warps, strip
width, halo and K. A map whose frontier pair and row rings do not fit the
card's shared memory together keeps the frontier in a global scratch
(``frontier_scratch``).
"""

from __future__ import annotations

import functools

import torch

from ..core.dp import (dp_forward as dp_forward_plain,
                       backtrack as backtrack_plain,
                       find_seam as find_seam_plain, rigc_table)
from .. import profiling
from . import _build

LAUNCHES = profiling.group("LAUNCHES", {
    "dp_forward": 0, "backtrack": 0, "carve_resident": 0, "dp_block": 0,
    "dp_sharded": 0, "dp_energy_forward": 0, "backtrack_compact": 0})

__all__ = ["LAUNCHES", "dp_forward", "backtrack", "find_seam",
           "dp_forward_plain", "backtrack_plain", "find_seam_plain"]


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


@functools.lru_cache(maxsize=16)
def _rigc_device(delta_x: int, H: int, device: torch.device) -> torch.Tensor:
    # cached: a fresh host->device copy per seam would synchronize the stream
    return torch.from_numpy(rigc_table(delta_x, H)).to(device)


@functools.lru_cache(maxsize=16)
def smem_optin(device: torch.device) -> int:
    """The opt-in shared memory per block of a CUDA device, in bytes."""
    lib = _build.load()
    with torch.cuda.device(device):
        n = lib.lqr_smem_optin()
    if n < 0:
        _build.check(lib, -n, "lqr_smem_optin")
    return n


# csrc/dp_forward.cu: a warp's window of columns, its row ring, the most
# warps a block runs, the most blocks in its cluster, and the fewest warps
# whose rings must fit beside a shared-memory frontier
WINDOW = 256
WARP_RING = 16 * 1024
MAX_WARPS = 16
MAX_CTAS = 8
MIN_WARPS_SMEM_FRONTIER = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _front_bytes(W: int) -> int:
    return 2 * _cdiv(W, 4) * 4 * 4


def frontier_scratch(W: int, device: torch.device):
    """None when the DP kernel's frontier pair fits the device's shared
    memory beside the row rings of MIN_WARPS_SMEM_FRONTIER warps; else a
    [2 * round_up(W, 4)] f32 scratch for the kernel to hold it in."""
    if (_front_bytes(W) + MIN_WARPS_SMEM_FRONTIER * WARP_RING
            <= smem_optin(device)):
        return None
    return torch.empty(_front_bytes(W) // 4, dtype=torch.float32,
                       device=device)


def warp_cap(W: int, device: torch.device, scratch) -> int:
    """The most warps a block of the DP kernel runs: their row rings and a
    shared-memory frontier (scratch None) fit the device's shared memory."""
    room = smem_optin(device) - (_front_bytes(W) if scratch is None else 0)
    return min(MAX_WARPS, room // WARP_RING)


def strip_geometry(Wb: int, delta_x: int, max_warps: int = MAX_WARPS):
    """(ctas, warps, S, G, K) of the DP kernel for a map of Wb columns:
    strips of S kept columns (a multiple of 16) with G = (WINDOW - S) / 2
    halo columns on each side, G >= 8 * delta_x, exchanged every K = G //
    delta_x rows (64 at delta_x = 0), over a thread-block cluster of ctas
    blocks of warps warps each. A map of up to four strips runs in one
    block; a wider one in strips of at most 128 columns (K = 64 at
    delta_x = 1: the exchanges, not the halos, cost the most), four warps
    a block (one on each of the SM's schedulers) on up to 8 blocks; wider
    still, 8 blocks of up to max_warps warps (a multiple of 4), each warp
    running several strips."""
    smax = WINDOW - 16 * delta_x
    need = _cdiv(Wb, smax)
    if need <= 4:
        ctas, warps = 1, min(need, max_warps)
    elif _cdiv(Wb, min(128, smax)) <= 4 * MAX_CTAS:
        ctas, warps = _cdiv(_cdiv(Wb, min(128, smax)), 4), min(4, max_warps)
    else:
        ctas = MAX_CTAS
        warps = min(_cdiv(_cdiv(need, MAX_CTAS), 4) * 4,
                    max_warps - max_warps % 4 or max_warps)
    total = ctas * warps
    S = _cdiv(_cdiv(Wb, total), 16) * 16 if need <= total else smax
    G = (WINDOW - S) // 2
    strips = _cdiv(Wb, S)
    return (min(ctas, strips), min(warps, strips), S, G,
            G // delta_x if delta_x else 64)


def dp_forward(e_tot: torch.Tensor, rig: torch.Tensor | None,
               pref_left: bool, delta_x: int, has_rig: bool, h=None,
               rigc_vec=None):
    """Forward DP -> (M_last [Wb] f32, bp [H, Wb] int8); see core.dp. h:
    the true height (rows >= h pass through); rigc_vec: [delta_x + 1] f32
    on e_tot's device, the image's rigidity coefficients."""
    if e_tot.ndim != 2:
        raise ValueError(f"e_tot: expected [H, Wb], got {tuple(e_tot.shape)}")
    H, Wb = e_tot.shape
    _check(e_tot, "e_tot", torch.float32, (H, Wb), e_tot.device)
    if has_rig:
        if rig is None:
            raise ValueError("has_rig set but rig is None")
        _check(rig, "rig", torch.float32, (H, Wb), e_tot.device)
    if not 0 <= delta_x <= 10:
        raise ValueError(f"delta_x={delta_x} out of range 0..10")
    if h is not None and not 1 <= h <= H:
        raise ValueError(f"h={h} out of range 1..{H}")
    if rigc_vec is not None:
        _check(rigc_vec, "rigc_vec", torch.float32, (delta_x + 1,),
               e_tot.device)
    if e_tot.device.type == "cpu":
        return dp_forward_plain(e_tot, rig, pref_left, delta_x, has_rig,
                                h=h, rigc_vec=rigc_vec)
    if e_tot.device.type != "cuda":
        raise ValueError(f"e_tot: unsupported device {e_tot.device}")

    lib = _build.load()
    dev = e_tot.device
    M_last = torch.empty(Wb, dtype=torch.float32, device=dev)
    bp = torch.empty((H, Wb), dtype=torch.int8, device=dev)
    rigc = (_rigc_device(delta_x, H, dev) if rigc_vec is None
            else rigc_vec)
    scratch = frontier_scratch(Wb, dev)
    geo = strip_geometry(Wb, delta_x, warp_cap(Wb, dev, scratch))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_dp_forward(e_tot.data_ptr(),
                                rig.data_ptr() if has_rig else None,
                                rigc.data_ptr(), int(bool(pref_left)),
                                delta_x, H, Wb, H if h is None else int(h),
                                *geo, M_last.data_ptr(), bp.data_ptr(),
                                None if scratch is None
                                else scratch.data_ptr(), stream)
    _build.check(lib, rc, "lqr_dp_forward")
    LAUNCHES["dp_forward"] += 1
    return M_last, bp


def backtrack(M_last: torch.Tensor, bp: torch.Tensor,
              pref_left: bool) -> torch.Tensor:
    """Seam [H] int32 from (M_last, bp); see core.dp."""
    if bp.ndim != 2:
        raise ValueError(f"bp: expected [H, Wb], got {tuple(bp.shape)}")
    H, Wb = bp.shape
    _check(bp, "bp", torch.int8, (H, Wb), bp.device)
    _check(M_last, "M_last", torch.float32, (Wb,), bp.device)
    if bp.device.type == "cpu":
        return backtrack_plain(M_last, bp, pref_left)
    if bp.device.type != "cuda":
        raise ValueError(f"bp: unsupported device {bp.device}")

    lib = _build.load()
    seam = torch.empty(H, dtype=torch.int32, device=bp.device)
    with torch.cuda.device(bp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_backtrack(M_last.data_ptr(), bp.data_ptr(),
                               int(bool(pref_left)), Wb, H, seam.data_ptr(),
                               stream)
    _build.check(lib, rc, "lqr_backtrack")
    LAUNCHES["backtrack"] += 1
    return seam


def find_seam(e_tot, rig, pref_left: bool, delta_x: int, has_rig: bool,
              h=None, rigc_vec=None):
    """Seam [H] int32 of the energy map: dp_forward then backtrack."""
    M_last, bp = dp_forward(e_tot, rig, pref_left, delta_x, has_rig, h=h,
                            rigc_vec=rigc_vec)
    return backtrack(M_last, bp, pref_left)
