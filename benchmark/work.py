"""The least work of a carve and the card's peaks: what a roofline share
is measured against.

The operation counts are those of the repository's chip check (one
pixel's energy, one DP cell), applied to a request's own shapes: the
energy and the DP cells are counted over the width each seam carves, so
the work is the same whichever route or kernel carves it. Bytes: each
input byte read once and each output byte written once.
"""

from __future__ import annotations

# Published peaks by card name (torch.cuda.get_device_name, lower case):
# float32 operations outside the tensor cores and device-memory bytes a
# second. NVIDIA H100 SXM data sheet, dense, at the full 700 W limit.
PEAKS = {
    "nvidia h100 80gb hbm3": {"f32_ops_s": 67e12, "bytes_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    """The card's peaks, or None for a card not in the table."""
    return PEAKS.get(device_name.strip().lower())


def dp_ops(delta_x: int, has_rig: bool) -> int:
    """Operations of one DP cell: a compare per candidate, the rigidity
    term's multiply and add a side candidate, the energy's add."""
    return (2 * delta_x + 1) + (4 * delta_x if has_rig else 0) + 1


def energy_ops(nrg: int, has_bias: bool) -> int:
    """Operations of one pixel's energy: the x-gradient families a sub, a
    mul and an abs; the sum-of-abs and norm families both gradients (a sub
    and a mul each) and three more; the null energy none; the bias's add."""
    fam = 3 if nrg == 6 else nrg % 3
    return (3, 8, 8, 0)[fam] + (1 if has_bias else 0)


def carve_work(h: int, w: int, c: int, seams: int, *, nrg: int,
               delta_x: int, has_bias: bool, has_rig: bool) -> tuple[int, int]:
    """(operations, bytes) of carving `seams` seams off an h x w image of c
    u8 channels: every seam's energy and DP over the width it carves; the
    image (and the bias and rigidity planes, f32) read once and the
    visibility map (i32) written once."""
    cells = h * sum(w - j for j in range(seams))
    ops = cells * (energy_ops(nrg, has_bias) + dp_ops(delta_x, has_rig))
    nbytes = h * w * (c + 4 * has_bias + 4 * has_rig + 4)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float, peak: dict) -> tuple[float, str]:
    """(the least time the card could take, what bounds it): the larger of
    the operations over the f32 rate and the bytes over the memory rate."""
    t_ops = ops / peak["f32_ops_s"]
    t_bytes = nbytes / peak["bytes_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
