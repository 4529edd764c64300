"""One halo-extended block of DP rows for the column-sharded resize.

Counterpart of ``lqr_tpu.ops.dp_block.dp_block_pallas``, with its
contract: ``m0 [We]`` is the shard's frontier after the halo exchange
(+inf where nothing is known), ``e_ext [R, We]`` the energy slab and
``rig_ext [R, We]`` (or None) the rigidity slab, both halo-extended;
``first`` says that the block holds the image's row 0 (M = E, bp = 0
there). Returns ``(m_out [We] f32, bp [R, We] int8)``; the shard's own
columns are exact, the halo lanes upper bounds (``parallel/sharding.py``).
The rigidity coefficients are f32(m^1.5 / H) of the image's height H.

On a CPU tensor ``dp_block`` runs ``dp_block_plain``; on a CUDA tensor it
launches ``csrc/dp_block.cu`` on the current stream without synchronizing,
or raises. There is no fallback from a failed launch to the plain version.
Unlike the Pallas kernel, ``We`` need not be a multiple of 128, and any
width is taken: the kernel holds its two frontier rows in shared memory,
or in a ``[2, We]`` f32 scratch in device memory when they do not fit it.
"""

from __future__ import annotations

import torch

from ..core.dp import dp_row, rank_setup, rigc_table
from . import _build, dp_cuda

__all__ = ["dp_block", "dp_block_plain"]


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
