"""One seam step on the compacted planes in two kernel launches.

Counterpart of ``lqr_tpu.ops.dp_pallas.carve_step_pallas`` and
``fused_ok``. ``carve_step`` takes the reader plane ``cur_b`` (and the bias
and rigidity planes where present) at width ``w``, finds one seam and
returns ``(seam [H] i32, cur_b', cur_bias', cur_rig')``: the planes with
the seam removed, zero at x >= w - 1, each a fresh tensor; an absent plane
comes back as it was given. It equals the per-seam step of
``core.engine._carve_once`` (energy, DP, backtrack, roll/select
compaction) bit for bit. ``w`` and ``pref_left`` are host values, so the
step never waits for the device.

- ``fuse_energy=True``: ``dp_energy_forward`` (the forward DP with the
  energy computed inline from the reader plane), then
  ``backtrack_compact`` (the start column, the chase and the compaction of
  every plane);
- ``fuse_energy=False``, the default, as in ``carve_step_pallas``: the
  energy map in torch ops (``engine.total_energy``), the DP kernel of
  ``ops.dp_cuda``, then ``backtrack_compact``.

Each wrapper runs its plain version on a CPU tensor and launches its kernel
(``csrc/carve_step.cu``) on a CUDA tensor, on the current stream without
synchronizing, or raises; there is no fallback from a failed launch to the
plain version. ``carve_step_plain`` composes the plain versions.

``fused_ok`` states this card's limits, which both modes share: the
forward kernel holds two frontier rows of Wb f32 in one block's shared
memory (at most 232 448 bytes on an H100, less its few static bytes: Wb
<= 29 024). The TPU's rules (a fold factor > 1, a power-of-two lane count,
H % BR == 0) do not apply.
No seam route of the package calls ``carve_step``; ``chip_smoke.py`` drives
it in a loop over seams, as ``scripts/attr2048.py`` drives the JAX op.
"""

from __future__ import annotations

import torch

from ..core import dp
from ..core.engine import compactor, total_energy
from . import _build, dp_cuda

__all__ = ["MAX_WB", "fused_ok", "carve_step", "carve_step_plain",
           "dp_energy_forward", "dp_energy_forward_plain",
           "backtrack_compact", "backtrack_compact_plain"]

# two f32 frontier rows in an H100 block's opt-in shared memory, 256
# bytes left for the kernel's static shared memory
MAX_WB = (232448 - 256) // 8


def fused_ok(H: int, Wb: int, delta_x: int = 1) -> bool:
    """Whether carve_step takes an [H, Wb] map at this delta_x."""
    return H >= 1 and 1 <= Wb <= MAX_WB and 0 <= delta_x <= 10


def _check_planes(cur_b, cur_bias, cur_rig, has_bias, has_rig) -> None:
    if cur_b.ndim != 2:
        raise ValueError(f"cur_b: expected [H, Wb], got {tuple(cur_b.shape)}")
    shape, dev = tuple(cur_b.shape), cur_b.device
    dp_cuda._check(cur_b, "cur_b", torch.float32, shape, dev)
    for name, plane, flag in (("cur_bias", cur_bias, has_bias),
                              ("cur_rig", cur_rig, has_rig)):
        if flag:
            if plane is None:
                raise ValueError(f"{name} is None but its flag is set")
            dp_cuda._check(plane, name, torch.float32, shape, dev)


def _check_step(cur_b, w: int, delta_x: int, nrg: int) -> None:
    H, Wb = cur_b.shape
    if not fused_ok(H, Wb, delta_x):
        raise ValueError(f"carve_step does not take H={H} Wb={Wb} "
                         f"delta_x={delta_x} (fused_ok: Wb <= {MAX_WB}, "
                         f"delta_x 0..10)")
    if not 1 <= w <= Wb:
        raise ValueError(f"w={w} out of range 1..{Wb}")
    if not 0 <= nrg <= 6:
        raise ValueError(f"nrg={nrg} out of range 0..6")
    if cur_b.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cur_b: unsupported device {cur_b.device}")


def dp_energy_forward_plain(cur_b, cur_bias, cur_rig, w: int,
                            pref_left: bool, delta_x: int, has_bias: bool,
                            has_rig: bool, nrg: int):
    """The plain version, on any device: the energy map, then core.dp's
    forward DP. Returns (M_last [Wb] f32, bp [H, Wb] int8)."""
    e = total_energy(cur_b, cur_bias, w, nrg, has_bias)
    return dp.dp_forward(e, cur_rig, pref_left, delta_x, has_rig)


def dp_energy_forward(cur_b, cur_bias, cur_rig, w: int, pref_left: bool,
                      delta_x: int, has_bias: bool, has_rig: bool, nrg: int):
    """The forward DP of the reader plane at width w with the energy
    computed inline -> (M_last [Wb] f32, bp [H, Wb] int8)."""
    _check_planes(cur_b, cur_bias, cur_rig, has_bias, has_rig)
    _check_step(cur_b, w, delta_x, nrg)
    if cur_b.device.type == "cpu":
        return dp_energy_forward_plain(cur_b, cur_bias, cur_rig, w,
                                       pref_left, delta_x, has_bias, has_rig,
                                       nrg)
    H, Wb = cur_b.shape
    dev = cur_b.device
    lib = _build.load()
    M_last = torch.empty(Wb, dtype=torch.float32, device=dev)
    bp = torch.empty((H, Wb), dtype=torch.int8, device=dev)
    rigc = dp_cuda._rigc_device(delta_x, H, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_dp_energy_forward(
            cur_b.data_ptr(), cur_bias.data_ptr() if has_bias else None,
            cur_rig.data_ptr() if has_rig else None, rigc.data_ptr(),
            int(bool(pref_left)), delta_x, nrg, H, Wb, int(w),
            M_last.data_ptr(), bp.data_ptr(), stream)
    _build.check(lib, rc, "lqr_dp_energy_forward")
    dp_cuda.LAUNCHES["dp_energy_forward"] += 1
    return M_last, bp


def backtrack_compact_plain(M_last, bp, cur_b, cur_bias, cur_rig, w: int,
                            pref_left: bool, has_bias: bool, has_rig: bool):
    """The plain version, on any device: core.dp's backtrack, then the
    engine's roll/select compaction of each plane present."""
    seam = dp.backtrack(M_last, bp, pref_left)
    compact = compactor(seam, w, cur_b.shape[1])
    return (seam, compact(cur_b),
            compact(cur_bias) if has_bias else cur_bias,
            compact(cur_rig) if has_rig else cur_rig)


def backtrack_compact(M_last, bp, cur_b, cur_bias, cur_rig, w: int,
                      pref_left: bool, has_bias: bool, has_rig: bool):
    """The seam of (M_last, bp) and the planes compacted along it ->
    (seam [H] i32, cur_b', cur_bias', cur_rig')."""
    _check_planes(cur_b, cur_bias, cur_rig, has_bias, has_rig)
    H, Wb = cur_b.shape
    dev = cur_b.device
    dp_cuda._check(bp, "bp", torch.int8, (H, Wb), dev)
    dp_cuda._check(M_last, "M_last", torch.float32, (Wb,), dev)
    if not 1 <= w <= Wb:
        raise ValueError(f"w={w} out of range 1..{Wb}")
    if dev.type == "cpu":
        return backtrack_compact_plain(M_last, bp, cur_b, cur_bias, cur_rig,
                                       w, pref_left, has_bias, has_rig)
    if dev.type != "cuda":
        raise ValueError(f"cur_b: unsupported device {dev}")
    lib = _build.load()
    seam = torch.empty(H, dtype=torch.int32, device=dev)
    b_out = torch.empty_like(cur_b)
    bias_out = torch.empty_like(cur_bias) if has_bias else None
    rig_out = torch.empty_like(cur_rig) if has_rig else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_backtrack_compact(
            M_last.data_ptr(), bp.data_ptr(), cur_b.data_ptr(),
            cur_bias.data_ptr() if has_bias else None,
            cur_rig.data_ptr() if has_rig else None, int(bool(pref_left)),
            H, Wb, int(w), seam.data_ptr(), b_out.data_ptr(),
            bias_out.data_ptr() if has_bias else None,
            rig_out.data_ptr() if has_rig else None, stream)
    _build.check(lib, rc, "lqr_backtrack_compact")
    dp_cuda.LAUNCHES["backtrack_compact"] += 1
    return (seam, b_out, bias_out if has_bias else cur_bias,
            rig_out if has_rig else cur_rig)


def carve_step(cur_b, cur_bias, cur_rig, w: int, pref_left: bool,
               delta_x: int, has_bias: bool, has_rig: bool, nrg: int,
               fuse_energy: bool = False):
    """One seam step (see the module doc) -> (seam, cur_b', cur_bias',
    cur_rig')."""
    _check_planes(cur_b, cur_bias, cur_rig, has_bias, has_rig)
    _check_step(cur_b, w, delta_x, nrg)
    if fuse_energy:
        M_last, bp = dp_energy_forward(cur_b, cur_bias, cur_rig, w,
                                       pref_left, delta_x, has_bias, has_rig,
                                       nrg)
    else:
        e = total_energy(cur_b, cur_bias, w, nrg, has_bias)
        M_last, bp = dp_cuda.dp_forward(e, cur_rig, pref_left, delta_x,
                                        has_rig)
    return backtrack_compact(M_last, bp, cur_b, cur_bias, cur_rig, w,
                             pref_left, has_bias, has_rig)


def carve_step_plain(cur_b, cur_bias, cur_rig, w: int, pref_left: bool,
                     delta_x: int, has_bias: bool, has_rig: bool, nrg: int):
    """The plain version of carve_step, on any device (both modes compute
    the same step)."""
    M_last, bp = dp_energy_forward_plain(cur_b, cur_bias, cur_rig, w,
                                         pref_left, delta_x, has_bias,
                                         has_rig, nrg)
    return backtrack_compact_plain(M_last, bp, cur_b, cur_bias, cur_rig, w,
                                   pref_left, has_bias, has_rig)
