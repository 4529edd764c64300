"""Seam DP and backtrack: the CUDA kernels and their plain versions.

Counterpart of ``lqr_tpu.ops.dp_pallas.find_seam_pallas``. Each wrapper
takes the same arguments as its plain version in ``core/dp.py`` (re-exported
here as ``*_plain``). On a CPU tensor it runs the plain version; on a CUDA
tensor it launches its kernel (``csrc/dp_forward.cu``, ``csrc/backtrack.cu``)
on the current stream without synchronizing, or raises. There is no
fallback from a failed launch to the plain version.

``LAUNCHES`` counts successful kernel launches per kernel, so a run can show
that its main path went through the kernels; it also counts the kernels of
``ops/carve_resident.py``, ``ops/dp_block.py`` and ``ops/carve_step.py``.

A map too wide for two frontier rows in the card's shared memory runs the
same DP kernel with its frontier in a global scratch (``frontier_scratch``).
"""

from __future__ import annotations

import functools

import torch

from ..core.dp import (dp_forward as dp_forward_plain,
                       backtrack as backtrack_plain,
                       find_seam as find_seam_plain, rigc_table)
from . import _build

LAUNCHES = {"dp_forward": 0, "backtrack": 0, "carve_resident": 0,
            "carve_resident_batched": 0, "dp_block": 0,
            "dp_energy_forward": 0, "backtrack_compact": 0}

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


def frontier_scratch(W: int, device: torch.device):
    """None when two frontier rows of W f32 fit the device's shared memory;
    else a [2 * W] f32 scratch for the kernel to hold them in."""
    if 2 * W * 4 <= smem_optin(device):
        return None
    return torch.empty(2 * W, dtype=torch.float32, device=device)


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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_dp_forward(e_tot.data_ptr(),
                                rig.data_ptr() if has_rig else None,
                                rigc.data_ptr(), int(bool(pref_left)),
                                delta_x, H, Wb, H if h is None else int(h),
                                M_last.data_ptr(), bp.data_ptr(),
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
