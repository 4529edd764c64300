"""Profiling / tracing / roofline accounting on PyTorch.

The reference's only instrumentation is a compiled-out wall-clock macro
(``__CLOCK_IT__``, gimp-lqr-plugin src/render.c:36-38). This module gives
the port

- ``trace(logdir)``: ``torch.profiler`` around the enclosed block (CUDA
  activity when a card is in use), written as a Chrome trace into
  ``logdir`` (chrome://tracing or Perfetto);
- ``annotate(name)``: a named span inside ``trace``
  (``torch.profiler.record_function``);
- ``seam_roofline(...)``: the bytes one seam step of the per-seam route
  (``core.engine._carve_once``) reads and writes at a given size, and the
  card's speed-of-light bound from them;
- ``Stopwatch``: phase timing that synchronizes the device a tensor lives
  on before it reads the clock.

The counterpart of ``lqr_tpu.profiling`` without its TPU chain-latency
calibration: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import time

import torch

from .errors import LqrConfigError
from .i18n import _

# Device-memory rates by card name (torch.cuda.get_device_name, lower
# case), GB/s: the H100 SXM's 3.35 TB/s (NVIDIA's data sheet, 700 W).
HBM_GBPS = {"h100 80gb hbm3": 3350.0}


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block and write it as a Chrome trace into
    ``logdir`` (created if missing). Yields the trace file's path, which
    exists once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{time.time_ns()}.json"
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(str(path))


def annotate(name: str):
    """Named span inside a trace (host-side phase annotation)."""
    return torch.profiler.record_function(name)


def hbm_gbps_of(device_name: str) -> float:
    """The device-memory rate (GB/s) of a card by its name; an unknown card
    raises LqrConfigError (pass the rate to seam_roofline instead)."""
    key = next((k for k in HBM_GBPS if k in device_name.lower()), None)
    if key is None:
        raise LqrConfigError(
            _("no memory rate known for device {d!r}; pass hbm_gbps")
            .format(d=device_name))
    return HBM_GBPS[key]


@dataclasses.dataclass
class Roofline:
    hbm_bytes: int          # device-memory traffic of one seam step
    seq_rows: int           # rows on the sequential DP critical path
    sol_seams_per_s: float  # speed-of-light bound from memory traffic alone
    breakdown: dict

    def efficiency(self, measured_seams_per_s: float) -> float:
        return measured_seams_per_s / self.sol_seams_per_s


def seam_roofline(H: int, W: int, has_bias: bool = False,
                  has_rig: bool = False, hbm_gbps: float | None = None
                  ) -> Roofline:
    """Device-memory cost of one seam step on the per-seam route
    (core.engine._carve_once and its commit in _extend_per_seam), each
    byte read once and each byte written once.

    Traffic per seam:
      energy:    read cur_b (f32) + write e (f32)
      DP fwd:    read e (+ the rig plane) + write bp (i8)
      backtrack: read M_last (f32 [W]), one bp byte a row (the chase),
                 write the seam (i32 [H])
      compact:   read + write cur_b (and the bias/rig planes when present)
      commit:    read + write posmap (i32, compacted with the planes),
                 gather the seam's reference columns and scatter them into
                 vs (i32 [H] each); the per-call posmap build is left out

    ``hbm_gbps``: the memory rate; None takes the card's
    (``hbm_gbps_of(torch.cuda.get_device_name())``), which needs CUDA.
    """
    if hbm_gbps is None:
        if not torch.cuda.is_available():
            raise LqrConfigError(
                _("no CUDA device to take a memory rate from; pass "
                  "hbm_gbps"))
        hbm_gbps = hbm_gbps_of(torch.cuda.get_device_name())
    plane = H * W * 4
    n_extra = int(has_bias) + int(has_rig)
    b = {
        "energy": 2 * plane,
        "dp_forward": plane + H * W * 1 + (plane if has_rig else 0),
        "backtrack": 4 * W + H + 4 * H,
        "compact": 2 * plane * (1 + n_extra),
        "commit_amortized": 2 * plane + 2 * 4 * H,
    }
    total = sum(b.values())
    return Roofline(hbm_bytes=total, seq_rows=H,
                    sol_seams_per_s=hbm_gbps * 1e9 / total, breakdown=b)


class Stopwatch:
    """Phase timer that synchronizes before it reads the clock. Use:
    sw = Stopwatch(); ...; sw.lap('carve', state.vs)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.laps: list[tuple[str, float]] = []

    def lap(self, name: str, sync_on: torch.Tensor | None = None) -> float:
        """Close the phase ``name``; a CUDA tensor ``sync_on`` first waits
        for its device (a CPU tensor is ready when its op returns)."""
        if sync_on is not None and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        now = time.perf_counter()
        dt = now - self.t0
        self.laps.append((name, dt))
        self.t0 = now
        return dt

    def report(self) -> str:
        return " | ".join(f"{n}: {dt * 1e3:.1f}ms" for n, dt in self.laps)
