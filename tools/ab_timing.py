#!/usr/bin/env python3
"""The end-to-end timings of chip_smoke.py phase 5 for the checkout at ROOT.

    python3 tools/ab_timing.py ROOT LABEL [--kernels | --batch | --sharded |
                                           --masks]

Imports ROOT's chip_smoke.py and ROOT's lqr_tpu_torch, builds its kernels,
and times what phase 5 times: 100 seams at 2048x2048 through both
extend_map routes and through both modes of the fused step, both routes
at 1024x768 with masks and at 512x384, BatchCarver.carve on cfg5 and one
cfg4 wave, and the column-sharded 2048x2048; first the fused step's
kernels (dp_energy_forward, backtrack_compact) at 2048x2048. With
--kernels it times instead the DP and backtrack kernels alone (CUDA events,
the mean of 50 launches) at the shapes their routes give them: 2048x2048,
1024x768 with rigidity, 512x384; with --batch only BatchCarver.carve on
cfg5 and the cfg4 wave, first in a fresh process; with --sharded only
the column-sharded 2048x2048; with --masks only a masked Carver request
at the two masked cells' shapes (2048x2048 with a preservation and a
discard mask; 1024x768 with both and a rigidity mask, rigidity 300): the
mask placements (the bias_add / rigmask_add calls, synchronized) and the
whole request, Carver(...) to get_image() after 100 seams, the median of 7
runs. Each line is prefixed with LABEL. To compare two
commits on one card, unpack the other with ``git archive`` and run both in
turns in one call, one process each: parent, change, change, parent.
"""

from __future__ import annotations

import pathlib
import sys


def time_kernels(smoke, dev, label: str) -> None:
    """The DP and backtrack kernels of ROOT, each shape in turn."""
    import torch
    from lqr_tpu_torch.core.energy import energy_from_plane, reader_plane
    from lqr_tpu_torch.ops import dp_cuda

    for (h, w), has_rig in (((smoke.N, smoke.N), False), (smoke.CFG2, True),
                            (smoke.CFG1, False)):
        img = torch.from_numpy(smoke.crop_image((h, w))).to(dev)
        e = energy_from_plane(reader_plane(img, 0), w, 0)
        rig = (torch.from_numpy(smoke.cfg2_inputs()["rig"]).to(dev)
               if has_rig else None)
        M, bp = dp_cuda.dp_forward(e, rig, True, 1, has_rig)
        fwd = smoke._cuda_ms(
            lambda: dp_cuda.dp_forward(e, rig, True, 1, has_rig), 50)
        bt = smoke._cuda_ms(lambda: dp_cuda.backtrack(M, bp, True), 50)
        print(f"[{label}] {w}x{h} rig={has_rig}: dp_forward {fwd:.4f} ms, "
              f"backtrack {bt:.4f} ms on {torch.cuda.get_device_name(0)}",
              flush=True)


def time_fused_kernel(smoke, dev, label: str) -> None:
    """The fused step's kernels of ROOT at the fused loop's first step,
    2048x2048 at delta_x 1: dp_energy_forward without masks, and
    backtrack_compact on its M_last and bp without and with a bias and a
    rigidity plane (the mean of 100 launches)."""
    import numpy as np
    import torch
    from lqr_tpu_torch.core.energy import reader_plane
    from lqr_tpu_torch.ops import carve_step as cs

    n = smoke.N
    b = reader_plane(torch.from_numpy(smoke.make_test_image(n)).to(dev), 0)
    fwd = (b, None, None, n, True, 1, False, False, 0)
    ms = smoke._cuda_ms(lambda: cs.dp_energy_forward(*fwd), 20)
    M, bp = cs.dp_energy_forward(*fwd)
    rng = np.random.default_rng(8)
    bias, rig = (torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in rng.integers(0, 8, (2, n, n)) / 8)
    bt = [smoke._cuda_ms(lambda: cs.backtrack_compact(M, bp, b, *masks, n,
                                                      True, *flags), 100)
          for masks, flags in (((None, None), (False, False)),
                               ((bias, rig), (True, True)))]
    print(f"[{label}] {n}x{n}: dp_energy_forward {ms:.4f} ms, "
          f"backtrack_compact {bt[0]:.4f} ms, with bias and rig "
          f"{bt[1]:.4f} ms on {torch.cuda.get_device_name(0)}", flush=True)


def time_masked_requests(smoke, dev, label: str) -> None:
    """A masked Carver request of ROOT at the masked cells' shapes: each a
    block of 255 in a [h, w] u8 mask, 0 elsewhere, placed at (0, 0)."""
    import statistics
    import time

    import numpy as np
    import torch
    from lqr_tpu_torch import Carver

    def block(h, w, y0, y1, x0, x1):
        m = np.zeros((h, w), np.uint8)
        m[y0:y1, x0:x1] = 255
        return m

    for (h, w), rigidity, rig in (((smoke.N, smoke.N), 0.0, False),
                                  (smoke.CFG2, 300.0, True)):
        img = smoke.crop_image((h, w))
        bias = [(block(h, w, h // 4, 3 * h // 4, w // 3, 2 * w // 3), 1000.0),
                (block(h, w, 0, h // 5, 0, w // 5), -1000.0)]
        rigm = [block(h, w, h // 3, 2 * h // 3, 0, w // 2)] if rig else []
        place, whole = [], []
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = Carver(img, rigidity=rigidity, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for mask, factor in bias:
                c.bias_add(mask, factor)
            for mask in rigm:
                c.rigmask_add(mask)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            c.resize(w - smoke.SEAMS, h)
            c.get_image()
            t3 = time.perf_counter()
            if i:
                place.append((t2 - t1) * 1e3)
                whole.append((t3 - t0) * 1e3)
            del c
        print(f"[{label}] masked request {w}x{h}, {len(bias) + len(rigm)} "
              f"masks: placements {statistics.median(place):.3f} ms "
              f"(runs {[round(x, 3) for x in place]}), whole request "
              f"{statistics.median(whole):.3f} ms (runs "
              f"{[round(x, 3) for x in whole]}) on "
              f"{torch.cuda.get_device_name(0)}", flush=True)


def main(argv: list[str]) -> int:
    root, label = pathlib.Path(argv[0]).resolve(), argv[1]
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as smoke
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.ops import _build
    from lqr_tpu_torch.parallel import BatchCarver, make_mesh

    if not torch.cuda.is_available():
        print("ab_timing: needs a CUDA device", file=sys.stderr)
        return 1
    _build.build()
    _build.load()
    smoke.say = lambda phase, msg: print(f"[{label}] {msg}", flush=True)
    dev = torch.device("cuda", 0)
    gpu = torch.cuda.get_device_name(0)
    if argv[2:] == ["--masks"]:
        time_masked_requests(smoke, dev, label)
        return 0
    batch_only = argv[2:] == ["--batch"]
    sharded_only = argv[2:] == ["--sharded"]
    if not (batch_only or sharded_only):
        time_fused_kernel(smoke, dev, label)
    if argv[2:] == ["--kernels"]:
        time_kernels(smoke, dev, label)
        return 0
    N, seams = smoke.N, smoke.SEAMS
    if not (batch_only or sharded_only):
        smoke.time_routes(dev, f"{N}x{N}", (N, N),
                          [engine._extend_per_seam, smoke.resident_route,
                           smoke.fused_split, smoke.fused_inline], seams, gpu)
        routes = [smoke.resident_route, engine._extend_per_seam]
        c2 = smoke.cfg2_inputs()
        smoke.time_routes(dev, "1024x768 with bias and rig", smoke.CFG2,
                          routes, seams, gpu, c2["bias"], c2["rig"])
        smoke.time_routes(dev, "512x384", smoke.CFG1, routes, seams, gpu)
    if not sharded_only:
        frames, counts = smoke.cfg5_inputs()
        smoke._median_runs("cfg5 BatchCarver.carve",
                           lambda: BatchCarver(frames, device=dev),
                           lambda bc: bc.carve(counts), int(counts.sum()),
                           "img_seams", gpu)
        del frames
        wave = smoke.cfg4_inputs()
        smoke._median_runs("cfg4 wave BatchCarver.carve",
                           lambda: BatchCarver(wave, device=dev),
                           lambda bc: bc.carve(smoke.CFG4[3]),
                           len(wave) * smoke.CFG4[3], "img_seams", gpu)
        del wave
    if batch_only:
        return 0
    img = smoke.make_test_image(N)
    mesh = make_mesh(devices=[dev] * smoke.SHARDS, data=1)
    smoke._median_runs(f"column-sharded {N}x{N}",
                       lambda: BatchCarver([img], mesh=mesh),
                       lambda bc: bc.carve(seams), seams, "seam", gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
