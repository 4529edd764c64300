#!/usr/bin/env python3
"""The resident kernel's batched entry on each cluster, on the card.

    python3 tools/batch_clusters.py [--quick]

For each shape of a batched user (cfg4's 1024x1024 map and cfg5's 640x360
GAP frame, delta_x 1, no masks, one chunk of engine.KC seams) prints how
many clusters of each (blocks, warps a block) in CLUSTERS the card holds
at once (``ops.carve_resident.resident_clusters``), then for each B in
BATCHES the ms of one chunk's launch on every cluster the card holds all B
of and on one block a map (CUDA events, the mean of 3 launches after one),
the fastest, and the cluster ``batch_cluster`` picks. Every cluster's
planes and seams are checked equal to one block a map's. CLUSTERS holds
the batched entry's clusters and the ones its rule leaves out (8 x 4,
4 x 4), to show why. With --quick: B up to 16 and one launch.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from lqr_tpu_torch.core import engine  # noqa: E402
from lqr_tpu_torch.core.energy import reader_plane  # noqa: E402
from lqr_tpu_torch.ops import carve_resident as cr  # noqa: E402

SHAPES = (("cfg4 1024x1024", 1024, 1024), ("cfg5 640x360", 360, 640))
BATCHES = (2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 256)
CLUSTERS = ((8, 8), (8, 4), (4, 8), (4, 4), (2, 8), (2, 4))


def batch_inputs(B: int, h: int, w: int, dev):
    """B distinct maps (one test image rolled by 7 columns a map) and the
    batched entry's other arguments for one chunk of engine.KC seams."""
    base = reader_plane(torch.from_numpy(smoke.crop_image((h, w))).to(dev), 0)
    b = torch.stack([torch.roll(base, 7 * i, 1) for i in range(B)])
    pm = torch.arange(w, dtype=torch.int32, device=dev).expand(
        B, h, w).contiguous()
    rigc = torch.zeros((B, 2), device=dev)
    return (b, None, None, pm, w, 0, engine.KC, h, rigc, 1, False, False, 0,
            2, engine.KC)


def on_cluster(cluster, args):
    """One launch of the batched entry with each map on `cluster`."""
    pick = cr.batch_cluster
    cr.batch_cluster = lambda B, clusters: cluster
    try:
        return cr.carve_chunk_resident_batched(*args)
    finally:
        cr.batch_cluster = pick


def _name(cluster) -> str:
    return "x".join(map(str, cluster))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("batch_clusters: needs a CUDA device", file=sys.stderr)
        return 1
    quick = argv == ["--quick"]
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    for label, h, w in SHAPES:
        Wp = cr.padded_width(w)
        held = {c: cr.resident_clusters(dev, Wp, 1, False, c)
                for c in CLUSTERS}
        print(json.dumps({"shape": label,
                          "clusters_held": {_name(c): n
                                            for c, n in held.items()},
                          "device": name}), flush=True)
        for B in BATCHES:
            if quick and B > 16:
                break
            args = batch_inputs(B, h, w, dev)
            ms, same, want = {}, {}, None
            for c in (cr.ONE_BLOCK, *CLUSTERS):
                if c != cr.ONE_BLOCK and held[c] < B:
                    continue
                out = on_cluster(c, args)
                if want is None:
                    want = out
                else:
                    same[_name(c)] = all(torch.equal(g, e) for g, e in
                                         zip(out, want) if g is not None)
                ms[_name(c)] = round(smoke._cuda_ms(
                    lambda: on_cluster(c, args), 1 if quick else 3), 3)
            print(json.dumps({
                "shape": label, "B": B, "ms_a_chunk": ms,
                "equal_to_one_block": same, "fastest": min(ms, key=ms.get),
                "picked": _name(cr.batch_cluster(B, held.get)),
                "device": name}), flush=True)
            del args, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
