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
(``csrc/dp_energy_forward.cu``, ``csrc/carve_step.cu``) on a CUDA tensor,
on the current stream without synchronizing, or raises; there is no
fallback from a failed launch to the plain version. ``carve_step_plain``
composes the plain versions.

``dp_energy_forward``'s kernel pairs each warp of the strip sweep
(``csrc/strip_dp.cuh``) with a producer warp that computes the energies
into its row ring; ``energy_geometry`` picks its cluster and where its
frontier lies. ``backtrack_compact``'s kernel runs one windowed chase a
launch (``csrc/chase.cuh``) that publishes its rows as it goes, and the
other blocks compact bands of rows behind it; the wrapper keeps two words
of device scratch and an epoch per stream for it (``_sync_words``).

``fused_ok`` states the card's own limits, which both modes share: any
H >= 1 and Wb >= 1 (the forward kernels keep their frontier rows in a
device scratch past the shared memory), delta_x 0..10. The TPU's rules (a
fold factor > 1, a power-of-two lane count, H % BR == 0) do not apply, so
the port takes every shape JAX's ``fused_ok`` takes, and more.
No seam route of the package calls ``carve_step``; ``chip_smoke.py`` drives
it in a loop over seams, as ``scripts/attr2048.py`` drives the JAX op.
"""

from __future__ import annotations

import threading

import torch

from ..core import dp
from ..core.engine import compactor, total_energy
from . import _build, dp_cuda

__all__ = ["fused_ok", "energy_geometry", "sqrt_rn_mismatches",
           "carve_step", "carve_step_plain",
           "dp_energy_forward", "dp_energy_forward_plain",
           "backtrack_compact", "backtrack_compact_plain"]

# csrc/dp_energy_forward.cu: a consumer warp's ring stages, a producer
# warp's ring of copy groups, the floats of a group's b slot (two boxes of
# 4 rows: the 256-column window and 4 columns each side, the first box
# padded to 128 bytes) and of its bias or rig slot, and the most consumer
# warps a block runs
STAGES = 8
GROUPS = 4
SLOT_B = 1088
SLOT_M = 4 * dp_cuda.WINDOW
MAX_PAIRS = 8


def pair_bytes(has_bias: bool, has_rig: bool) -> int:
    """Shared memory of one consumer/producer warp pair: a full and an
    empty mbarrier per stage and a fill mbarrier per group slot, the
    consumer's E (and rig) ring, the producer's ring of b (and bias and
    rig) groups."""
    slot = SLOT_B + SLOT_M * (int(has_bias) + int(has_rig))
    return ((2 * STAGES + GROUPS) * 8
            + STAGES * dp_cuda.WINDOW * 4 * (1 + has_rig) + GROUPS * slot * 4)


def energy_geometry(Wb: int, delta_x: int, has_bias: bool, has_rig: bool,
                    optin: int):
    """(frontier in scratch, (ctas, warps, S, G, K)) of dp_energy_forward
    for a map of Wb columns on a card with `optin` bytes of shared memory a
    block. The frontier pair (2 * round_up(Wb, 4) f32) stays in shared
    memory when it fits beside the pairs of
    dp_cuda.MIN_WARPS_SMEM_FRONTIER warps, else it goes to a device
    scratch; the consumer warps a block are then as many pairs as fit the
    rest (pair_bytes), at most MAX_PAIRS (so at most 16 warps, each with
    128 registers), and dp_cuda.strip_geometry picks the strips under that
    cap."""
    pair = pair_bytes(has_bias, has_rig)
    front = dp_cuda._front_bytes(Wb)
    scratch = front + dp_cuda.MIN_WARPS_SMEM_FRONTIER * pair > optin
    cap = min(MAX_PAIRS, (optin - (0 if scratch else front)) // pair)
    return scratch, dp_cuda.strip_geometry(Wb, delta_x, cap)


def sqrt_rn_mismatches(device: torch.device) -> int:
    """The number of f32 values >= +0 (NaNs included) at which
    dp_energy_forward's square root (csrc/dp_energy_forward.cu: sqrt_rn)
    differs from CUDA's __fsqrt_rn in any bit, counted on the card over
    all 2^31 of them; 0 is the kernel's claim."""
    lib = _build.load()
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        rc = lib.lqr_sqrt_rn_check(bad.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "lqr_sqrt_rn_check")
    return int(bad.item())


def fused_ok(H: int, Wb: int, delta_x: int = 1) -> bool:
    """Whether carve_step takes an [H, Wb] map at this delta_x."""
    return H >= 1 and Wb >= 1 and 0 <= delta_x <= 10


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
                         f"delta_x={delta_x} (fused_ok: H >= 1, Wb >= 1, "
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
    in_scratch, geo = energy_geometry(Wb, delta_x, has_bias, has_rig,
                                      dp_cuda.smem_optin(dev))
    scratch = (torch.empty(dp_cuda._front_bytes(Wb) // 4,
                           dtype=torch.float32, device=dev)
               if in_scratch else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_dp_energy_forward(
            cur_b.data_ptr(), cur_bias.data_ptr() if has_bias else None,
            cur_rig.data_ptr() if has_rig else None, rigc.data_ptr(),
            int(bool(pref_left)), delta_x, nrg, H, Wb, int(w), *geo,
            M_last.data_ptr(), bp.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
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


# backtrack_compact's device scratch, per (device index, stream): the
# ticket and progress words (int64, zero when made) and the epoch of the
# last launch on them (csrc/carve_step.cu: each launch takes the next;
# two launches on one stream must never share one, hence the lock)
_SYNC: dict = {}
_SYNC_LOCK = threading.Lock()
_EPOCHS = 2 ** 32 - 1


def _sync_words(dev: torch.device, stream: int):
    """(scratch, epoch) for the next backtrack_compact launch on `stream`:
    the stream's two words and an epoch larger than any earlier launch's on
    them; past 2^32 - 1 epochs the stream gets fresh words (zero, made on
    the same stream, so ordered behind its earlier launches)."""
    with _SYNC_LOCK:
        entry = _SYNC.get((dev.index, stream))
        if entry is None or entry[1] == _EPOCHS:
            entry = [torch.zeros(2, dtype=torch.int64, device=dev), 0]
            _SYNC[(dev.index, stream)] = entry
        entry[1] += 1
        return entry[0], entry[1]


def backtrack_compact(M_last, bp, cur_b, cur_bias, cur_rig, w: int,
                      pref_left: bool, has_bias: bool, has_rig: bool):
    """The seam of (M_last, bp) and the planes compacted along it ->
    (seam [H] i32, cur_b', cur_bias', cur_rig'). On the card: one launch
    of csrc/carve_step.cu on the current stream, which must not be
    capturing a CUDA graph (each launch takes a fresh epoch)."""
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
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("backtrack_compact cannot be captured in a "
                               "CUDA graph: each launch takes a fresh epoch")
        stream = torch.cuda.current_stream().cuda_stream
        sync, epoch = _sync_words(dev, stream)
        rc = lib.lqr_backtrack_compact(
            M_last.data_ptr(), bp.data_ptr(), cur_b.data_ptr(),
            cur_bias.data_ptr() if has_bias else None,
            cur_rig.data_ptr() if has_rig else None, int(bool(pref_left)),
            H, Wb, int(w), seam.data_ptr(), b_out.data_ptr(),
            bias_out.data_ptr() if has_bias else None,
            rig_out.data_ptr() if has_rig else None, sync.data_ptr(), epoch,
            stream)
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
