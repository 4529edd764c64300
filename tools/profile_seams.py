#!/usr/bin/env python3
"""Where the device time of one map's seam loop goes, by kernel.

    python3 tools/profile_seams.py [N] [SEAMS]

Runs the N x N seam loops that chip_smoke.py phase 5 times (default
2048^2, 20 seams): extend_map's per-seam and resident routes, the fused
step with the energy in torch ops and the DP kernel, and the fused step
with the energy inline; each once to warm up and once under
torch.profiler. Prints per loop
its wall time, the device's busy share (the kernels' summed device time
over the wall time: one stream, so they do not overlap) and the device time
of its largest kernels. Needs a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv: list[str]) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as smoke
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.core.state import EngineConfig, init_state

    if not torch.cuda.is_available():
        print("profile_seams: needs a CUDA device", file=sys.stderr)
        return 1
    n = int(argv[0]) if argv else 2048
    seams = int(argv[1]) if len(argv) > 1 else 20
    dev = torch.device("cuda", 0)
    cfg = EngineConfig(H=n, Wb=n, C=3)
    img = smoke.make_test_image(n)
    print(torch.cuda.get_device_name(0), flush=True)
    for route in (engine._extend_per_seam, engine._extend_resident,
                  smoke.fused_split, smoke.fused_inline):
        route(cfg, init_state(cfg, img, device=dev), seams)        # warm-up
        st = init_state(cfg, img, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            route(cfg, st, seams)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:     # kernels, copies
                continue
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            rows.append((us, ev.count, ev.key))
        rows.sort(reverse=True)
        if not rows:
            print(f"{route.__name__}: the trace shows no device time")
            continue
        busy = sum(r[0] for r in rows) / 1e6
        print(f"{route.__name__}, {seams} seams at {n}x{n}: wall "
              f"{wall * 1e3:.3f} ms = {wall / seams * 1e6:.1f} us/seam; "
              f"device busy {busy * 1e3:.3f} ms ({busy / wall * 100:.1f} %), "
              f"{sum(r[1] for r in rows)} device ops")
        for us, count, key in rows[:6]:
            print(f"  {us / 1e3:10.3f} ms {us / 1e6 / busy * 100:5.1f} % "
                  f"x{count:<5d} {key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
