#!/usr/bin/env python3
"""Where the device time of one map's seam loop goes, by kernel.

    python3 tools/profile_seams.py [N] [SEAMS]

Runs the N x N seam loops that chip_smoke.py phase 5 times (default
2048^2, 20 seams): extend_map's per-seam and resident routes, the fused
step with the energy in torch ops and the DP kernel, and the fused step
with the energy inline, and the column-sharded resize on 4 shards of the
card (BatchCarver); each once to warm up and once under torch.profiler.
Prints per loop
its wall time, the device's busy share (the kernels' summed device time
over the wall time: one stream, so they do not overlap) and the device time
of its largest kernels; for the column-sharded loop also the host
operators with the most self CPU time. Needs a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv: list[str]) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as smoke
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.core.state import EngineConfig, init_state
    from lqr_tpu_torch.parallel import BatchCarver, make_mesh

    if not torch.cuda.is_available():
        print("profile_seams: needs a CUDA device", file=sys.stderr)
        return 1
    n = int(argv[0]) if argv else 2048
    seams = int(argv[1]) if len(argv) > 1 else 20
    dev = torch.device("cuda", 0)
    cfg = EngineConfig(H=n, Wb=n, C=3)
    img = smoke.make_test_image(n)
    print(torch.cuda.get_device_name(0), flush=True)

    def profiled(label, make, run, host_ops=0):
        run(make())                                              # warm-up
        obj = make()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(obj)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report(label, prof.key_averages(), wall, seams, n, host_ops)

    for route in (engine._extend_per_seam, smoke.resident_route,
                  smoke.fused_split, smoke.fused_inline):
        profiled(route.__name__, lambda: init_state(cfg, img, device=dev),
                 lambda st, route=route: route(cfg, st, seams))
    mesh = make_mesh(devices=[dev] * smoke.SHARDS, data=1)
    profiled(f"column-sharded on {smoke.SHARDS} shards",
             lambda: BatchCarver([img], mesh=mesh),
             lambda bc: bc.carve(seams), host_ops=8)
    return 0


def _report(label, events, wall, seams, n, host_ops):
    """Print the device busy share and the largest kernels of one profiled
    loop; with host_ops, also its host operators with the most self CPU
    time (a loop the host holds back)."""
    from torch.autograd import DeviceType
    rows = []
    for ev in events:
        if ev.device_type != DeviceType.CUDA:     # kernels, copies
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        rows.append((us, ev.count, ev.key))
    rows.sort(reverse=True)
    if not rows:
        print(f"{label}: the trace shows no device time")
        return
    busy = sum(r[0] for r in rows) / 1e6
    print(f"{label}, {seams} seams at {n}x{n}: wall "
          f"{wall * 1e3:.3f} ms = {wall / seams * 1e6:.1f} us/seam; "
          f"device busy {busy * 1e3:.3f} ms ({busy / wall * 100:.1f} %), "
          f"{sum(r[1] for r in rows)} device ops")
    for us, count, key in rows[:6]:
        print(f"  {us / 1e3:10.3f} ms {us / 1e6 / busy * 100:5.1f} % "
              f"x{count:<5d} {key[:80]}")
    if host_ops:
        host = sorted(((ev.self_cpu_time_total, ev.count, ev.key)
                       for ev in events
                       if ev.device_type == DeviceType.CPU),
                      reverse=True)
        calls = sum(ev.count for ev in events
                    if ev.device_type == DeviceType.CPU
                    and ev.key.startswith("aten::"))
        print(f"  host: {calls / seams:.1f} aten ops a seam; the most self "
              f"CPU time:")
        for us, count, key in host[:host_ops]:
            print(f"  {us / 1e3:10.3f} ms host x{count:<6d} {key[:70]}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
