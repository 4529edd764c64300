#!/usr/bin/env python3
"""Time the strip DP kernel (csrc/dp_forward.cu) at several geometries.

    python3 tools/dp_geometry.py [N]

Builds the kernels, then launches lqr_dp_forward on the N x N main-path
energy (default 2048, delta_x = 1, LEFT, no rigidity) at the geometry
ops/dp_cuda.strip_geometry picks and at others: (blocks in the cluster,
warps a block, kept columns S, halo G, rows between exchanges K). Prints
per geometry the mean of 20 launches (CUDA events) and whether M_last and
bp equal the plain version's. Needs a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GEOMETRIES = [
    (1, 12, 176, 40, 40),     # one block, three warps a scheduler
    (2, 6, 176, 40, 40),
    (3, 4, 176, 40, 40),      # one warp a scheduler
    (2, 8, 128, 64, 64),
    (8, 2, 128, 64, 64),
    (8, 4, 64, 96, 96),
    (4, 4, 128, 64, 32),      # the picked strips, more exchanges
    (4, 4, 128, 64, 16),
    (3, 3, 240, 8, 8),        # the narrowest halo
]


def main(argv: list[str]) -> int:
    import torch

    import chip_smoke as smoke
    from lqr_tpu_torch.core.energy import energy_from_plane, reader_plane
    from lqr_tpu_torch.ops import _build, dp_cuda

    if not torch.cuda.is_available():
        print("dp_geometry: needs a CUDA device", file=sys.stderr)
        return 1
    n = int(argv[0]) if argv else 2048
    lib = _build.load()
    dev = torch.device("cuda", 0)
    img = torch.from_numpy(smoke.make_test_image(n)).to(dev)
    e = energy_from_plane(reader_plane(img, 0), n, 0)
    M_p, bp_p = dp_cuda.dp_forward_plain(e, None, True, 1, False)
    rigc = dp_cuda._rigc_device(1, n, dev)
    m = torch.empty(n, device=dev)
    bp = torch.empty((n, n), dtype=torch.int8, device=dev)
    scratch = dp_cuda.frontier_scratch(n, dev)
    picked = dp_cuda.strip_geometry(n, 1, dp_cuda.warp_cap(n, dev, scratch))
    print(torch.cuda.get_device_name(0), flush=True)
    for geo in [picked] + [g for g in GEOMETRIES if g != picked]:
        def run():
            rc = lib.lqr_dp_forward(
                e.data_ptr(), None, rigc.data_ptr(), 1, 1, n, n, n, *geo,
                m.data_ptr(), bp.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            _build.check(lib, rc, "lqr_dp_forward")
        ms = smoke._cuda_ms(run, 20)
        exact = torch.equal(m, M_p) and torch.equal(bp, bp_p)
        print(f"geometry {geo}{' (picked)' if geo == picked else ''}: "
              f"{ms:.4f} ms, {ms * 1e3 / n:.4f} us/row, bit-exact {exact}",
              flush=True)
        if not exact:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
