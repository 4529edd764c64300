#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lqr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

1. device  — the card's name and power limit; no CUDA means exit 1.
2. build   — nvcc builds the kernels from lqr_tpu_torch/csrc/, one process
             per source, all started together.
3. kernels — each kernel against its plain PyTorch version on the same
             CUDA inputs, bit-exact (tolerance 0). DP and backtrack:
             2048x2048 at delta_x=1 with both side preferences, delta_x=2
             with rigidity, a Wb=384 shape, the strip kernel's edges
             (EDGE_CASES: Wb % 4 != 0, Wb < 32, Wb = 1, H = 1, H - 1 not a
             multiple of K, delta_x 0, 3, 7 and 10, energies full of ties,
             rigidity, unaligned planes), a ragged h with a per-image
             rigc, and Wb=32768 (the DP's frontier in global scratch); a
             bad argument (delta_x=64, a halo narrower than delta_x * K)
             must raise. The resident kernel: the main path's launch
             (2048x2048, 100 seams, timed there and at cfg2's chunk),
             1024x768 with bias and rigidity
             under GRAD_XABS and GRAD_NORM (128 seams), delta_x=2 with
             rigidity, 512x384 without masks, a partial chunk (72 seams
             at depth 128), and its edges for both entries
             (RESIDENT_EDGES: Wb % 4 != 0, Wb < 32, H = 1, H - 1 not a
             multiple of K, delta_x 0, 3 and 10, ties, unaligned planes;
             the batched entry with ragged heights). Its batched entry,
             with bias and rigidity, at
             the padded shapes of the batch paths below: four maps at
             360x640 (per-map width, seam count, one of them 0, and true
             height), three at 480x640 and two at 1024x1024; without
             masks at the wave16 cell's shape (16 maps of 1024x1024, a
             128-seam chunk, on clusters of 4 blocks a map, timed there);
             and timed at the cfg4 wave's shape (256 maps of 1024x1024, 8
             seams).
             dp_block: R=32 rows over a shard of 512 columns extended by
             32*delta_x lanes each side (the card's shard of the
             distinct-device mesh below, timed there), delta_x 1 and 2,
             rigidity on and off, `first` on and off, and a slab of 30001
             lanes (its frontier in global scratch); and R=32 over phase
             10's shard of 1024 columns (timed there). dp_sharded (the
             column-sharded DP of one seam, one cluster launch for all
             shards) against the per-block loop with dp_block's plain
             version (SHARDED_CASES): 2048x2048 on 4 shards (the sharded
             path's own shape, timed there), delta_x 1 and 2, rigidity on
             and off, both sides; 2 and 8 shards; 2 shards of 30016
             columns (frontiers in device scratch, several strips a warp);
             its own columns against dp_forward; and the bytes that cross
             shards per seam. The fused
             seam step's two kernels: dp_energy_forward at 2048x2048
             (delta_x=1, both side preferences; delta_x=2 with rigidity), at
             cfg2 with bias and rigidity under GRAD_XABS, GRAD_NORM and
             NULL, at a width below the buffer, and past one block's
             shared-memory frontier: 256x32768 with rigidity and 8x65536
             (timed at 2048x2048 and 256x32768); its square root against
             __fsqrt_rn at every f32 >= +0; backtrack_compact at
             2048x2048, delta_x 1 and 2, with and without bias and
             rigidity, at full width and below it, and at its edges
             (STEP_EDGES: Wb % 4 != 0, Wb < 144, Wb = 1, H < 32, H = 1,
             w = 1, w = Wb, bands that do not divide H, delta_x 3 and 7,
             three column segments, ties everywhere, unaligned planes),
             timed at 2048x2048 without and with bias and rigidity beside
             its two-launch yardstick (the backtrack kernel, then the
             engine's torch compaction). Kernel and plain times at the
             shapes of the paths below.
4. slice   — the paths through the public surfaces, each with the launch
             counts set to 0 just before it and read just after: Carver at
             2048x2048, 100 seams (the resident kernel), and the same
             image on the per-seam route, driven explicitly (the DP and
             backtrack kernels); cfg2, 1024x768
             with preservation, discard and rigidity masks and an RGBA aux
             image, 100 then 300 seams (the resident kernel); cfg1,
             512x384, 100 seams; BatchCarver on cfg5 (300 frames of
             640x360, GAP's keyframed 0..160 seams) and one cfg4 wave (256
             images of 1024x1024, 256 seams each) on the batched resident
             kernel; a ragged BatchCarver of 8 images with masks and an
             RGBA aux image; the column-sharded BatchCarver, 2048x2048
             on 4 column shards of the one card, 100 seams (dp_sharded and
             the backtrack kernel); and the column-sharded BatchCarver on a
             mesh of distinct devices (the card and the CPU), 1024x384 on 2
             shards, 20 seams (dp_block on the card's shard, its plain
             version on the CPU's). Each visibility map must equal the C++
             reference carver's bit for bit, each image (and aux image) its
             materialization u8 for u8. Then the fused seam step
             (ops.carve_step, one step per seam on the compacted planes,
             the seams committed every 128 as the JAX engine commits
             them): 100 seams at 2048x2048 with the energy in torch ops and
             the DP kernel, and with the energy inline; cfg2's image with
             its bias and rigidity planes, energy inline.
5. timing  — synchronized, median of 3 fresh runs: 100 seams at 2048x2048
             through both extend_map routes (the resident one is
             extend_map's there) and through both modes of the fused step,
             both extend_map routes at 1024x768 with masks and at 512x384;
             img_seams/s of BatchCarver.carve on cfg5 and on the cfg4
             wave; us/seam of the column-sharded 2048x2048.
6. cli     — the batch path above the Carver, file to file through the
             command line (lqr_tpu_torch.cli), PNGs through the port's
             codec, the launch counts set to 0 before each call: 2048x2048
             -> 1948 (the resident kernel) equal to native's
             materialization u8 for u8; the same with a preservation mask
             and a rigidity mask (the DP and backtrack kernels, past the
             gate) equal to native.carve with the same bias and rig fields;
             cfg1 with --output-target new-layer --seams and with
             --scaleback --scaleback-mode stdw, the card's file equal to
             --cpu's byte for byte; 2048 -> 2248 columns (one enlargement
             pass) equal to native's; checkpoints saved on the card (50
             seams) and on the CPU (4 seams), loaded on the card and resized
             to 1948, equal to native.carve's map; then the plain shrink's
             time to image (median of 3, fresh files: the whole call and
             its parts) and materialize's time alone.
7. interactive — the interactive session and the plugin's run modes on the
             main path's 2048x2048, the launch counts set to 0 before each
             step: InteractiveSession + set_size(1948) (the resident
             kernel), lookups at 2000 and 2100 (no launch), growth to 1900
             (the resident kernel), reset_size (the image itself), two
             seam-map dumps into one layer, reset_map and a vertical map
             (the resident kernel), each map and layer equal to native's;
             run_plugin INTERACTIVE with a painted preservation mask and
             rigidity mask (past the gate: the per-seam kernels) equal to
             native.carve with the Carver's fields, replayed by
             WITH_LAST_VALS on a fresh copy, and the preview with the
             masks on. Then the times: the first map, retarget_ms of a
             lookup and of an extension, a lookup and an extension under
             profiling.trace (its span and the resident kernel in the
             trace), the masked run_plugin in both modes, and its
             write-back by part.
8. entry points — the port's measuring programs, called in-process, the
             launch counts set to 0 before each, each JSON line printed
             after "[entry]": lqr_tpu_torch.bench (the 2048x2048, 100-seam
             metric: one resident launch a timed run) and each config of
             lqr_tpu_torch.bench_all: cfg1 and cfg2 (one resident launch),
             cfg3 (2048x2048 to 3072 x 1948: the resident kernel 8 times
             for the 1024-seam width map, then the DP and backtrack
             kernels 100 times each for the height map on the 3072-row
             transposed image; held against the C++ reference in full at
             768x768, and at 2048x2048 the whole width map, the height map
             and the image), cfg4 (all 4096 images, 16 waves of 256: two
             batched resident launches a wave) and cfg5 (two batched
             launches). A line with an "error", a bit_exact* that is not
             true, a value <= 0 or other launches than these fails.
9. scaling — python -m lqr_tpu_torch.scaling on the card, in a process of
             its own, each JSON line printed after "[scaling]": a cfg4
             wave (256 images of 1024x1024, 256 seams) through
             BatchCarver on a one-process mesh of two 'data' rows of the
             card against no mesh (no exchange in the carve, two batched
             resident launches a row); the same wave over two processes
             that share the card (make_process_mesh in a gloo group, its
             carrier the mailbox of one host, 128 images each, the vs maps
             gathered device to device and held against one process); and
             2048x2048, 100 seams on 4 column shards of the card (one
             dp_sharded and one backtrack launch a seam, the halo
             exchanges the design predicts). A non-zero exit, a line that
             is not bit-exact or other launches fail. Then the two-process
             wave again under gloo (called here): its map equal to the
             mailbox's, and the 'data' gather's time under both carriers.
10. cols   — the 'cols' axis across processes that share the card
             (lqr_tpu_torch.scaling's multiprocess_gloo_resize, called here,
             its workers on a make_process_mesh in a gloo group), each mesh
             under both carriers, gloo (host copies over the group) and the
             mailbox (CUDA IPC rings ordered by stream memory operations):
             2048x2048, 100 seams on one row of 2 column shards in 2
             processes, then a 2 x 2 mesh on 4 processes carving 4 images
             of 512x384 (cfg1's size) with bias and rigidity, 100 seams.
             Each worker's gathered map must equal the others', rank 0's
             one-process BatchCarver's and the other carrier's; each
             worker launches dp_block H / R times and the backtrack once a
             seam step (its own launch counts, set to 0 around its carve);
             the halo messages a row sends a seam must be the design's
             (n_cols - 1)(2H/R + 3); the mailbox must make no host copy and
             send no message of data over the group in the carve, gloo
             some. The ms a seam, each worker's ms in its messages (under
             the mailbox the time to enqueue them), its host copies and
             its launches are printed with the card's name and power limit.

The card's name and power limit (nvidia-smi) stand on a line of their own;
the line before the last is a JSON object with one entry per kernel: its
launches on its path, its largest error against its plain version, its time
and the plain version's, and its bound (the larger of its bytes over the
H100's memory rate and its operations over its f32 rate); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N = 2048          # the main path: 100 seams off a 2048x2048 RGB image
SEAMS = 100
CFG1 = (384, 512)     # (h, w) of scripts/bench_all.py's cfg1, no masks
CFG2 = (768, 1024)    # cfg2: preservation, discard and rigidity masks
RIGIDITY = 100.0      # cfg2's global rigidity
CFG5 = (360, 640, 300, 160)   # (h, w) of a GAP frame, frames, last seams
CFG4 = (1024, 1024, 256, 256)  # (h, w), images in one wave, seams each
CFG4_KC = 8           # seams of phase 3's batched launch at the cfg4 shape
WAVE16 = (1024, 1024, 16, 4)  # (h, w), maps, blocks a map on an H100
SHARDS = 4            # column shards of the one card
DISTINCT = (384, 1024)  # (h, w) on the card and the CPU, 2 column shards
COLS_W = N // 2       # phase 10's shard width: N columns on 2 processes
# the ragged batch: (h, w, seams) of each image
RAGGED = ((360, 640, 60), (300, 512, 40), (480, 600, 100), (200, 384, 30),
          (360, 560, 90), (240, 320, 50), (480, 640, 80), (128, 256, 20))


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def make_test_image(n: int, seed: int = 0) -> np.ndarray:
    """Smooth structured test image; the same generator as bench.py's."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, n, 3)).astype(np.float32)
    for _ in range(3):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
               + np.roll(img, -1, 0) + np.roll(img, -1, 1)) / 5.0
    yy, xx = np.mgrid[0:n, 0:n]
    img[:, :, 0] += 60 * np.sin(xx / 37.0) + 40 * np.cos(yy / 53.0)
    img[:, :, 1] += 50 * np.cos((xx + yy) / 41.0)
    return np.clip(img, 0, 255).astype(np.uint8)


def crop_image(hw, seed: int = 0) -> np.ndarray:
    """An h x w test image, cropped as scripts/bench_all.py crops it."""
    h, w = hw
    return make_test_image(max(h, w), seed)[:h, :w]


def cfg2_inputs(seed: int = 3) -> dict:
    """cfg2's image, its masks (a preservation mask on rows h/4..h/2,
    columns w/4..w/2; a discard mask on rows h/2..h, columns w/2..w; a
    random grey rigidity mask on the left third), an RGBA aux image, and
    the bias and rig planes the Carver builds from them, in numpy in the
    same rounding order."""
    from lqr_tpu_torch.carver import place_mask_numpy
    h, w = CFG2
    rng = np.random.default_rng(seed)
    d = {"img": crop_image(CFG2),
         "pres": rng.integers(160, 256, (h // 4, w // 4, 3)).astype(np.uint8),
         "disc": np.full((h - h // 2, w - w // 2, 3), 255, np.uint8),
         "rigm": rng.integers(0, 256, (h, w // 3)).astype(np.uint8),
         "aux": rng.integers(0, 256, (h, w, 4)).astype(np.uint8)}
    d["bias"] = (
        place_mask_numpy(d["pres"], h, w, w // 4, h // 4) * np.float32(1.0)
        + place_mask_numpy(d["disc"], h, w, w // 2, h // 2)
        * np.float32(-0.8))
    d["rig"] = (place_mask_numpy(d["rigm"], h, w, 0, 0)
                * np.float32(RIGIDITY))
    return d


def reset_launches() -> None:
    from lqr_tpu_torch.ops import dp_cuda
    for k in dp_cuda.LAUNCHES:
        dp_cuda.LAUNCHES[k] = 0


def _max_err(a, b) -> float:
    """Largest |a - b| over elements that differ (0.0 when equal, inf == inf
    counting as equal)."""
    diff = a.ne(b)
    if not bool(diff.any()):
        return 0.0
    return float((a.double() - b.double()).abs()[diff].max())


def _random_case(H, W, Wb, delta_x, has_rig, seed, device):
    """Quantized random energy (ties on purpose) and rigidity planes."""
    import torch
    rng = np.random.default_rng(seed)
    e = np.full((H, Wb), np.inf, np.float32)
    e[:, :W] = np.round(rng.random((H, W), dtype=np.float32) * 8) / 8
    rig = None
    if has_rig:
        rig = np.zeros((H, Wb), np.float32)
        rig[:, :W] = np.round(np.abs(rng.standard_normal((H, W))) * 4) / 4
        rig = torch.from_numpy(rig).to(device)
    return torch.from_numpy(e).to(device), rig


def _cuda_ms(fn, reps: int, warm: bool = True) -> float:
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# The strip DP kernel's and the windowed chase's edges: (H, W, Wb,
# delta_x, has_rig, energy) with energy "ties" (eighths), "flat" (every
# cell equal) or "offset" (the planes 4 bytes past a 16-byte boundary);
# rig is nonzero past W, where E is +inf and the rig term picks bp
EDGE_CASES = [
    (64, 1021, 1021, 1, False, "ties"),     # Wb % 4 != 0, strips uneven
    (50, 999, 1003, 2, True, "ties"),
    (40, 20, 20, 1, False, "ties"),         # Wb < 32
    (30, 1, 1, 1, False, "ties"),           # Wb = 1
    (30, 1, 1, 0, True, "ties"),
    (1, 500, 512, 1, False, "ties"),        # H = 1
    (333, 700, 700, 1, False, "ties"),      # H - 1 not a multiple of K
    (100, 300, 300, 0, True, "ties"),       # delta_x = 0
    (100, 640, 640, 3, True, "ties"),       # delta_x = 3
    (60, 500, 512, 7, True, "ties"),        # run-time delta_x
    (40, 300, 300, 10, False, "ties"),
    (80, 256, 256, 2, False, "flat"),       # every candidate ties
    (90, 2000, 2048, 1, True, "flat"),
    (70, 600, 640, 1, True, "offset"),      # unaligned planes
]


def _edge_case(H, W, Wb, dx, has_rig, energy, device):
    """One of EDGE_CASES' inputs on the device."""
    import torch
    rng = np.random.default_rng(H * 31 + Wb + dx)
    e = np.full((H, Wb), np.inf, np.float32)
    e[:, :W] = (0.5 if energy == "flat" else
                np.round(rng.random((H, W), dtype=np.float32) * 8) / 8)
    rig = (np.round(np.abs(rng.standard_normal((H, Wb))) * 4) / 4
           ).astype(np.float32) if has_rig else None
    if energy != "offset":
        return (torch.from_numpy(e).to(device),
                None if rig is None else torch.from_numpy(rig).to(device))

    def offset(a):
        buf = torch.empty(a.size + 1, dtype=torch.float32, device=device)
        buf[1:] = torch.from_numpy(a.ravel()).to(device)
        return buf[1:].view(a.shape)
    return offset(e), None if rig is None else offset(rig)


# The resident kernel's edges, for both entries: (H, Wb, w0, kc, delta_x,
# nrg, masks, planes) with planes "ties" (a reader plane of six levels, a
# bias of eighths, a rigidity of integers), "flat" (one level: every
# candidate ties) or "offset" (the planes 4 bytes past a 16-byte boundary)
RESIDENT_EDGES = [
    (40, 1021, 1000, 30, 1, 0, True, "ties"),     # Wb % 4 != 0
    (30, 20, 20, 10, 1, 2, False, "ties"),        # Wb < 32
    (1, 300, 290, 20, 2, 1, True, "ties"),        # H = 1
    (70, 640, 640, 12, 1, 0, True, "ties"),       # H - 1 not a multiple of K
    (50, 256, 250, 16, 0, 0, True, "ties"),       # delta_x = 0
    (50, 700, 690, 16, 3, 2, True, "ties"),       # delta_x = 3
    (40, 512, 500, 12, 10, 6, True, "ties"),      # run-time delta_x
    (60, 384, 384, 20, 1, 0, False, "flat"),      # every candidate ties
    (48, 500, 480, 14, 2, 1, True, "offset"),     # unaligned planes
]


def resident_edge(case, device, maps: int = 0):
    """One of RESIDENT_EDGES' inputs on the device: (b, bias, rig, posmap)
    of one map, or of a batch of `maps` maps (then [maps, H, Wb] and the
    rows at y >= h[i] of map i zero, h = H, H // 2 + 1, 1, ...)."""
    import torch
    H, Wb, w0, kc, dx, nrg, masks, kind = case
    n = max(maps, 1)
    rng = np.random.default_rng(H * 7 + Wb + dx)
    planes = np.zeros((3, n, H, Wb), np.float32)
    planes[0, :, :, :w0] = (rng.integers(0, 6, (n, H, w0)) / np.float32(5)
                            if kind != "flat" else 0.5)
    planes[1, :, :, :w0] = np.round(rng.standard_normal((n, H, w0)) * 4) / 8
    planes[2, :, :, :w0] = np.abs(np.round(rng.standard_normal((n, H, w0))
                                           * 8))
    for i, h in enumerate(resident_edge_heights(H, maps)):
        planes[:, i, h:] = 0
    pm = np.zeros((n, H, Wb), np.int32)
    pm[:, :, :w0] = np.arange(w0)

    def put(a):
        if kind != "offset":
            return torch.from_numpy(a).to(device)
        buf = torch.empty(a.size + 1, dtype=torch.from_numpy(a).dtype,
                          device=device)
        buf[1:] = torch.from_numpy(a.ravel()).to(device)
        return buf[1:].view(a.shape)
    out = [put(x if maps else x[0]) for x in (*planes, pm)]
    b, bias, rig, pm_t = out
    return b, bias if masks else None, rig if masks else None, pm_t


def resident_edge_heights(H: int, maps: int) -> list:
    """The true heights of a batch of RESIDENT_EDGES maps."""
    return [(H, H // 2 + 1, 1)[i % 3] for i in range(maps)]


def check_resident_edges(device, cases=RESIDENT_EDGES) -> float:
    """Phase 3: the resident kernel's solo and batched entries against their
    plain versions at RESIDENT_EDGES (tolerance 0 on hist rows < kc and on
    every plane at every column): the solo entry with the side switching
    every seam (ssf = 1) at depth 5; the batched entry on three maps of
    ragged heights and seam counts (one of them 0). Returns the largest
    error."""
    import torch
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.ops import carve_resident as cr
    from lqr_tpu_torch.parallel.batch import rigc_table

    err = 0.0
    for case in cases:
        H, Wb, w0, kc, dx, nrg, masks, kind = case
        b, bias, rig, pm = resident_edge(case, device)
        args = (b, bias, rig, pm, w0, 5, kc, dx, masks, masks, nrg, 1,
                engine.KC)
        got = cr.carve_chunk_resident(*args)
        want = cr.carve_chunk_resident_plain(*args)
        torch.cuda.synchronize()
        e = max([_max_err(got[0][:kc], want[0][:kc])]
                + [_max_err(g, w) for g, w in zip(got[1:], want[1:])
                   if g is not None])
        if e != 0.0 or not bool((got[0][kc:] == -1).all()):
            raise AssertionError(f"carve_resident differs from plain at the "
                                 f"edge {case}")
        err = max(err, e)
        maps = 3
        b, bias, rig, pm = resident_edge(case, device, maps)
        heights = resident_edge_heights(H, maps)
        rigc = torch.from_numpy(rigc_table(heights, dx)).to(device)
        kcs, d0 = [kc, 0, max(kc // 2, 1)], [0, 3, 9]
        args = (b, bias, rig, pm, w0, d0, kcs, heights, rigc, dx, masks,
                masks, nrg, 2, engine.KC)
        params = cr._batched_params(maps, H, Wb, w0, d0, kcs, heights,
                                    engine.KC)
        want = cr.carve_chunk_resident_batched_plain(
            b, bias, rig, pm, params, rigc, dx, masks, masks, nrg, 2,
            engine.KC)
        got = cr.carve_chunk_resident_batched(*args)
        torch.cuda.synchronize()
        e = max(_max_err(g, w) for g, w in zip(got, want) if g is not None)
        if e != 0.0:
            raise AssertionError(f"carve_resident_batched differs from plain "
                                 f"at the edge {case}")
        err = max(err, e)
        say("kernels", f"carve_resident edge H={H} Wb={Wb} w0={w0} kc={kc} "
            f"delta_x={dx} nrg={nrg} masks={masks} {kind}: solo, and batched "
            f"(heights {heights}, kc {kcs}): max_abs_err=0.0 (tolerance 0)")
    return err


def check_kernels(device, n: int) -> dict:
    """Phase 3: kernels vs plain versions; returns per-kernel errors and
    times."""
    import torch
    from lqr_tpu_torch.core.energy import energy_from_plane, reader_plane
    from lqr_tpu_torch.ops import _build, dp_cuda
    from lqr_tpu_torch.parallel.batch import rigc_table

    img = torch.from_numpy(make_test_image(n)).to(device)
    e_main = energy_from_plane(reader_plane(img, 0), n, 0)
    cases = [("main", e_main, None, 1, pref, None) for pref in (True, False)]
    e, rig = _random_case(256, 1000, 1024, 2, True, 5, device)
    cases += [("delta2_rig", e, rig, 2, pref, None) for pref in (True, False)]
    e, rig = _random_case(300, 380, 384, 1, False, 6, device)
    cases += [("wb384", e, None, 1, True, None)]
    for H, W, Wb, dx, has_rig, energy in EDGE_CASES:
        e, rig = _edge_case(H, W, Wb, dx, has_rig, energy, device)
        cases += [(f"edge {energy}", e, rig, dx, pref, None)
                  for pref in (True, False)]
    e, rig = _random_case(40, 200, 256, 2, True, 17, device)
    rigc = torch.from_numpy(rigc_table([17], 2)[0]).to(device)
    cases += [("ragged h=17", e, rig, 2, pref, (17, rigc))
              for pref in (True, False)]

    err = {"dp_forward": 0.0, "backtrack": 0.0}
    for name, e, rig, dx, pref, ragged in cases:
        has_rig = rig is not None
        h, rv = ragged or (None, None)
        M_k, bp_k = dp_cuda.dp_forward(e, rig, pref, dx, has_rig, h=h,
                                       rigc_vec=rv)
        M_p, bp_p = dp_cuda.dp_forward_plain(e, rig, pref, dx, has_rig, h=h,
                                             rigc_vec=rv)
        seam_k = dp_cuda.backtrack(M_p, bp_p, pref)
        seam_p = dp_cuda.backtrack_plain(M_p, bp_p, pref)
        torch.cuda.synchronize()
        e_dp = max(_max_err(M_k, M_p), _max_err(bp_k, bp_p))
        e_bt = _max_err(seam_k, seam_p)
        say("kernels", f"{name} H={e.shape[0]} Wb={e.shape[1]} delta_x={dx} "
            f"rig={has_rig} pref_left={pref} geometry "
            f"{dp_cuda.strip_geometry(e.shape[1], dx)}: dp_forward "
            f"max_abs_err={e_dp} backtrack max_abs_err={e_bt} (tolerance 0)")
        if e_dp != 0.0 or e_bt != 0.0:
            raise AssertionError(f"kernel differs from plain on {name}")
        err["dp_forward"] = max(err["dp_forward"], e_dp)
        err["backtrack"] = max(err["backtrack"], e_bt)

    # a map wider than two frontier rows of shared memory: the same
    # kernel with its frontier in a global scratch
    e_w, _ = _random_case(256, 32760, 32768, 1, False, 7, device)
    if dp_cuda.frontier_scratch(32768, device) is None:
        raise AssertionError("Wb=32768 should not fit shared memory")
    for pref in (True, False):
        M_k, bp_k = dp_cuda.dp_forward(e_w, None, pref, 1, False)
        M_p, bp_p = dp_cuda.dp_forward_plain(e_w, None, pref, 1, False)
        torch.cuda.synchronize()
        e_dp = max(_max_err(M_k, M_p), _max_err(bp_k, bp_p))
        say("kernels", f"wide H=256 Wb=32768 delta_x=1 pref_left={pref} "
            f"(frontier in global scratch): dp_forward max_abs_err={e_dp} "
            f"(tolerance 0)")
        if e_dp != 0.0:
            raise AssertionError("wide dp_forward differs from plain")

    # a bad argument never launches: the launcher refuses delta_x = 64 and
    # a halo narrower than delta_x * K
    lib = _build.load()
    before = dict(dp_cuda.LAUNCHES)
    m = torch.empty(256, device=device)
    bp = torch.empty((2, 256), dtype=torch.int8, device=device)
    rigc = torch.zeros(65, device=device)
    for label, dx, geo in (("delta_x=64", 64, dp_cuda.strip_geometry(256, 1)),
                           ("G < delta_x * K", 2, (1, 1, 160, 48, 25))):
        rc = lib.lqr_dp_forward(e_main.data_ptr(), None, rigc.data_ptr(), 1,
                                dx, 2, 256, 2, *geo, m.data_ptr(),
                                bp.data_ptr(), None,
                                torch.cuda.current_stream().cuda_stream)
        try:
            _build.check(lib, rc, "lqr_dp_forward")
        except RuntimeError as exc:
            say("kernels", f"{label} refused as it must: {exc}")
        else:
            raise AssertionError(f"a {label} launch did not raise")
    torch.cuda.synchronize()
    if dp_cuda.LAUNCHES != before:
        raise AssertionError("a refused launch was counted")

    M_p, bp_p = dp_cuda.dp_forward_plain(e_main, None, True, 1, False)
    ms = {
        "dp_forward": _cuda_ms(
            lambda: dp_cuda.dp_forward(e_main, None, True, 1, False), 20),
        "backtrack": _cuda_ms(
            lambda: dp_cuda.backtrack(M_p, bp_p, True), 20),
        "dp_forward wide": _cuda_ms(
            lambda: dp_cuda.dp_forward(e_w, None, True, 1, False), 20),
    }
    plain_ms = {
        "dp_forward": _cuda_ms(
            lambda: dp_cuda.dp_forward_plain(e_main, None, True, 1, False),
            2),
        "backtrack": _cuda_ms(
            lambda: dp_cuda.backtrack_plain(M_p, bp_p, True), 2),
        "dp_forward wide": _cuda_ms(
            lambda: dp_cuda.dp_forward_plain(e_w, None, True, 1, False), 2),
    }
    for k in ms:
        rows, shape = (256, "256x32768") if k.endswith("wide") else (
            n, f"{n}x{n}")
        say("kernels", f"{k} at {shape}: kernel {ms[k]:.4f} ms "
            f"({ms[k] * 1e3 / rows:.4f} us/row), plain {plain_ms[k]:.4f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


# the fused step's wide shape: past one block's shared-memory frontier
WIDE_STEP = (256, 32768)

# backtrack_compact's edges: (H, W, Wb, w, delta_x, nrg, has_bias, has_rig,
# planes), the planes zero past W, with planes "ties" (a reader plane of
# six levels), "flat" (one level: M_last and every DP candidate tie) or
# "offset" (the planes 4 bytes past a 16-byte boundary)
STEP_EDGES = [
    (64, 1021, 1021, 1000, 1, 0, True, True, "ties"),   # Wb % 4 != 0
    (40, 100, 100, 100, 1, 0, False, False, "ties"),    # Wb < 144, w = Wb
    (50, 37, 37, 30, 2, 0, True, False, "ties"),        # both, scalar path
    (30, 1, 1, 1, 0, 0, False, True, "ties"),           # Wb = 1
    (20, 300, 304, 290, 2, 0, True, False, "ties"),     # H < 32
    (1, 500, 512, 500, 1, 0, False, True, "ties"),      # H = 1
    (30, 200, 256, 1, 1, 0, True, True, "ties"),        # w = 1: all zero
    (333, 700, 704, 700, 3, 0, True, True, "ties"),     # bands ragged
    (100, 640, 640, 640, 7, 0, False, True, "ties"),    # seams leave windows
    (8, 5000, 5000, 4990, 2, 0, True, True, "ties"),    # 3 column segments
    (80, 256, 256, 256, 2, 0, False, False, "flat"),    # ties everywhere
    (90, 2000, 2048, 2000, 1, 0, True, True, "flat"),
    (70, 600, 640, 600, 1, 0, True, True, "offset"),    # unaligned planes
    (2048, 2048, 2048, 1990, 2, 0, True, True, "offset"),
]


def step_planes(case, device):
    """The (b, bias, rig) planes of one of STEP_EDGES (or of a step shape
    with its planes kind), zero past W, on the device; bias and rig even
    where the case has none."""
    import torch
    H, W, Wb, _, dx, nrg, _, _, kind = case
    rng = np.random.default_rng(H * 7 + Wb + dx + nrg)
    planes = np.zeros((3, H, Wb), np.float32)
    planes[0, :, :W] = (np.float32(0.4) if kind == "flat" else
                        rng.integers(0, 6, (H, W)) / np.float32(5))
    planes[1, :, :W] = np.round(rng.standard_normal((H, W)) * 4) / 8
    planes[2, :, :W] = np.abs(np.round(rng.standard_normal((H, W)) * 8))
    if kind != "offset":
        return tuple(torch.from_numpy(a).to(device) for a in planes)

    def offset(a):
        buf = torch.empty(a.size + 1, dtype=torch.float32, device=device)
        buf[1:] = torch.from_numpy(a.ravel()).to(device)
        return buf[1:].view(a.shape)
    return tuple(offset(a) for a in planes)


def _step_planes(hw, seed, device):
    """A reader plane of six levels (ties on purpose), a bias of eighths
    and a rigidity of integers, on the device."""
    import torch
    rng = np.random.default_rng(seed)
    planes = np.zeros((3,) + tuple(hw), np.float32)
    planes[0] = rng.integers(0, 6, hw) / np.float32(5)
    planes[1] = np.round(rng.standard_normal(hw) * 4) / 8
    planes[2] = np.abs(np.round(rng.standard_normal(hw) * 4))
    return tuple(torch.from_numpy(a).to(device) for a in planes)


def check_carve_step(device, n: int) -> dict:
    """Phase 3: the fused seam step's two kernels against their plain
    versions on the same CUDA inputs (tolerance 0 on M_last, bp, the seam
    and every compacted plane at every column); returns their largest
    errors and their times at n x n."""
    import torch
    from lqr_tpu_torch.core.energy import reader_plane
    from lqr_tpu_torch.core.state import EngineConfig, init_state
    from lqr_tpu_torch.ops import carve_step as cs

    b = reader_plane(torch.from_numpy(make_test_image(n)).to(device), 0)
    rng = np.random.default_rng(8)
    bias = torch.from_numpy(np.round(rng.standard_normal((n, n)) * 4)
                            .astype(np.float32) / 8).to(device)
    rig = torch.from_numpy(np.round(np.abs(rng.standard_normal((n, n))) * 4)
                           .astype(np.float32) / 4).to(device)
    h, w = CFG2
    c2 = cfg2_inputs()
    st2 = init_state(EngineConfig(H=h, Wb=w, C=3, has_bias=True,
                                  has_rig=True), c2["img"], bias=c2["bias"],
                     rig=c2["rig"], device=device)
    p2 = (st2.cur_b, st2.cur_bias, st2.cur_rig)
    # (label, (b, bias, rig), w, delta_x, nrg, side preferences)
    fwd = [(f"{n}x{n}", (b, None, None), n, 1, 0, (True, False)),
           (f"{n}x{n} rig", (b, None, rig), n, 2, 0, (True, False)),
           (f"{n}x{n} w={n - 37} bias+rig", (b, bias, rig), n - 37, 1, 1,
            (False,))]
    fwd += [(f"cfg2 {w}x{h} bias+rig nrg={nrg}", p2, w, 1, nrg,
             (True, False)) for nrg in (0, 2, 6)]
    # widths past one block's shared-memory frontier (device scratch)
    wide = _step_planes(WIDE_STEP, 9, device)
    fwd += [(f"{WIDE_STEP[0]}x{WIDE_STEP[1]} rig", (wide[0], None, wide[2]),
             WIDE_STEP[1] - 8, 1, 0, (True, False))]
    huge = _step_planes((8, 65536), 10, device)
    fwd += [("8x65536 bias+rig nrg=2", huge, 65536 - 100, 2, 2,
             (True, False)),
            ("8x65536", (huge[0], None, None), 65536, 1, 0, (True,))]
    bt = [(f"{n}x{n}", (b, None, None), n, 1),
          (f"{n}x{n} bias+rig", (b, bias, rig), n, 2),
          (f"{n}x{n} bias+rig delta_x=1", (b, bias, rig), n, 1),
          (f"{n}x{n} w={n - 37}", (b, None, None), n - 37, 2),
          (f"{n}x{n} w={n - 37} bias+rig", (b, bias, rig), n - 37, 1)]
    for case in STEP_EDGES:
        H, W, Wb, ww, dx, _, has_bias, has_rig, kind = case
        pb, pbias, prig = step_planes(case, device)
        bt.append((f"{H}x{Wb} W={W} {kind}",
                   (pb, pbias if has_bias else None,
                    prig if has_rig else None), ww, dx))
    err = {"dp_energy_forward": 0.0, "backtrack_compact": 0.0}
    for label, planes, ww, dx, nrg, prefs in fwd:
        flags = (planes[1] is not None, planes[2] is not None)
        for pref in prefs:
            args = planes + (ww, pref, dx) + flags + (nrg,)
            got = cs.dp_energy_forward(*args)
            want = cs.dp_energy_forward_plain(*args)
            torch.cuda.synchronize()
            e = max(_max_err(got[0], want[0]), _max_err(got[1], want[1]))
            say("kernels", f"dp_energy_forward {label} delta_x={dx} "
                f"pref_left={pref}: max_abs_err={e} (tolerance 0)")
            if e != 0.0:
                raise AssertionError(f"dp_energy_forward differs from plain "
                                     f"on {label}")
            err["dp_energy_forward"] = max(err["dp_energy_forward"], e)
    for label, planes, ww, dx in bt:
        flags = (planes[1] is not None, planes[2] is not None)
        for pref in (True, False):
            M, bp = cs.dp_energy_forward_plain(*planes, ww, pref, dx, *flags,
                                               0)
            got = cs.backtrack_compact(M, bp, *planes, ww, pref, *flags)
            want = cs.backtrack_compact_plain(M, bp, *planes, ww, pref,
                                              *flags)
            torch.cuda.synchronize()
            e = max(_max_err(g, p) for g, p in zip(got, want)
                    if g is not None)
            say("kernels", f"backtrack_compact {label} delta_x={dx} "
                f"pref_left={pref}: max_abs_err={e} (tolerance 0)")
            if e != 0.0:
                raise AssertionError(f"backtrack_compact differs from plain "
                                     f"on {label}")
            err["backtrack_compact"] = max(err["backtrack_compact"], e)

    bad = cs.sqrt_rn_mismatches(device)
    say("kernels", f"dp_energy_forward's sqrt_rn against __fsqrt_rn at all "
        f"2^31 f32 values >= +0: {bad} differ (tolerance 0)")
    if bad:
        raise AssertionError("sqrt_rn differs from __fsqrt_rn")

    main = ((b, None, None), n, True, 1, False, False, 0)
    wmain = ((wide[0], None, None), WIDE_STEP[1], True, 1, False, False, 0)
    M, bp = cs.dp_energy_forward_plain(*main[0], *main[1:])
    bt_args = (M, bp, b, None, None, n, True, False, False)
    bt_masks = (M, bp, b, bias, rig, n, True, True, True)
    ms = {"dp_energy_forward": _cuda_ms(
              lambda: cs.dp_energy_forward(*main[0], *main[1:]), 20),
          "dp_energy_forward wide": _cuda_ms(
              lambda: cs.dp_energy_forward(*wmain[0], *wmain[1:]), 20),
          "backtrack_compact": _cuda_ms(
              lambda: cs.backtrack_compact(*bt_args), 20),
          "backtrack_compact masks": _cuda_ms(
              lambda: cs.backtrack_compact(*bt_masks), 20)}
    # the two-launch yardstick: what the per-seam route pays for the same
    # function, #2's backtrack kernel and the engine's torch compaction
    yard = {label: _cuda_ms(lambda: two_launch_step(*args), 20)
            for label, args in (("no masks", bt_args),
                                ("bias+rig", bt_masks))}
    plain_ms = {"dp_energy_forward": _cuda_ms(
                    lambda: cs.dp_energy_forward_plain(*main[0], *main[1:]),
                    2),
                "dp_energy_forward wide": _cuda_ms(
                    lambda: cs.dp_energy_forward_plain(*wmain[0],
                                                       *wmain[1:]), 2),
                "backtrack_compact": _cuda_ms(
                    lambda: cs.backtrack_compact_plain(*bt_args), 2)}
    for k in ms:
        rows, shape = ((WIDE_STEP[0], "x".join(map(str, WIDE_STEP)))
                       if k.endswith("wide") else (n, f"{n}x{n}"))
        say("kernels", f"{k} at {shape} delta_x=1: kernel {ms[k]:.4f} ms "
            f"({ms[k] * 1e3 / rows:.4f} us/row)"
            + (f", plain {plain_ms[k]:.4f} ms" if k in plain_ms else ""))
    for label, t in yard.items():
        mine = ms["backtrack_compact" + (" masks" if "rig" in label else "")]
        say("kernels", f"backtrack_compact's yardstick at {n}x{n} {label} "
            f"(backtrack kernel + torch compaction): {t:.4f} ms; the fused "
            f"kernel {mine:.4f} ms ({t / mine:.2f}x)")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


def two_launch_step(M, bp, b, bias, rig, w, pref_left, has_bias, has_rig):
    """backtrack_compact's function as the per-seam route computes it:
    the backtrack kernel (dp_cuda.backtrack), then engine.compactor's torch
    ops on each plane present."""
    from lqr_tpu_torch.core.engine import compactor
    from lqr_tpu_torch.ops import dp_cuda
    seam = dp_cuda.backtrack(M, bp, pref_left)
    compact = compactor(seam, w, b.shape[1])
    return (seam, compact(b), compact(bias) if has_bias else bias,
            compact(rig) if has_rig else rig)


def check_resident(device) -> dict:
    """Phase 3, the resident kernel against its plain version on the same
    CUDA inputs (tolerance 0 on hist rows < kc and on every plane at every
    column), the main path's own launch (2048x2048, 100 seams) first;
    returns its largest error, its times at the main path's launch and at
    cfg2's 128-seam chunk."""
    import torch
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.core.state import EngineConfig, init_state, round_up
    from lqr_tpu_torch.ops import carve_resident as cr

    def chunk(hw, kc, nrg=0, dx=1, bias=None, rig=None):
        h, w = hw
        cfg = EngineConfig(H=h, Wb=round_up(w, 128), C=3, delta_x=dx,
                           nrg=nrg, has_bias=bias is not None,
                           has_rig=rig is not None)
        st = init_state(cfg, crop_image(hw), bias=bias, rig=rig,
                        device=device)
        pm = engine._posmap(st.vs, st.ref_w)
        return (st.cur_b, st.cur_bias, st.cur_rig, pm, w, 0, kc, dx,
                cfg.has_bias, cfg.has_rig, nrg, cfg.side_switch_freq,
                engine.KC)

    c2 = cfg2_inputs()
    cases = [
        # the main path's launch: Carver.resize's one chunk of SEAMS seams
        (f"main path {N}x{N} no masks", chunk((N, N), SEAMS)),
        ("cfg2 GRAD_XABS bias+rig", chunk(CFG2, 128, 0, 1, c2["bias"],
                                          c2["rig"])),
        ("cfg2 GRAD_NORM bias+rig", chunk(CFG2, 128, 2, 1, c2["bias"],
                                          c2["rig"])),
        ("1024x768 delta_x=2 rig", chunk(CFG2, 48, 0, 2, None, c2["rig"])),
        ("cfg1 512x384 no masks", chunk(CFG1, 128)),
    ]
    def compare(name, args):
        """(kernel's outputs, largest error, the plain version's ms); one
        map launches on 8 blocks of 8 warps."""
        before = dict(cr.BATCH_BLOCKS)
        got = cr.carve_chunk_resident(*args)
        blocks = [n for n, c in cr.BATCH_BLOCKS.items() if c != before[n]]
        if blocks != ["8"]:
            raise AssertionError(f"carve_resident {name}: a launch of "
                                 f"{blocks} blocks a map, expected 8")
        out = []
        plain_ms = _cuda_ms(
            lambda: out.append(cr.carve_chunk_resident_plain(*args)), 1,
            warm=False)
        want = out[0]
        kc = args[6]
        e = max([_max_err(got[0][:kc], want[0][:kc])]
                + [_max_err(g, p) for g, p in zip(got[1:], want[1:])
                   if g is not None])
        H, Wb = args[0].shape
        say("kernels", f"carve_resident {name} H={H} Wb={Wb} w0={args[4]} "
            f"d0={args[5]} kc={kc}: 8 blocks a map, max_abs_err={e} "
            f"(tolerance 0)")
        if e != 0.0 or not bool((got[0][kc:] == -1).all()):
            raise AssertionError(f"carve_resident differs from plain: {name}")
        return got, e, plain_ms

    _, err, plain_ms = compare(*cases[0])
    c2_first, e, c2_plain_ms = compare(*cases[1])
    err = max(err, e)
    for case in cases[2:]:
        err = max(err, compare(*case)[1])
    # the partial chunk goes on from cfg2's first chunk's planes
    _, b, bias, rig, pm = c2_first
    args = cases[1][1]
    err = max(err, compare("cfg2 partial chunk at depth 128",
                           (b, bias, rig, pm, args[4] - 128, 128, 72)
                           + args[7:])[1])

    err = max(err, check_resident_edges(device))
    ms = _cuda_ms(lambda: cr.carve_chunk_resident(*cases[0][1]), 5)
    c2_ms = _cuda_ms(lambda: cr.carve_chunk_resident(*args), 5)
    say("kernels", f"carve_resident, the main path's launch ({SEAMS} seams "
        f"at {N}x{N}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; 128 "
        f"seams at 1024x768 with bias and rig: kernel {c2_ms:.4f} ms, plain "
        f"{c2_plain_ms:.4f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "cfg2": c2_ms,
            "cfg2_plain": c2_plain_ms}


def _check_carve(label, img, vs, out, vs_ref, w, aux=None, aux_out=None):
    from lqr_tpu_torch import native
    if out.shape != (img.shape[0], w, img.shape[2]) or out.dtype != np.uint8:
        raise AssertionError(f"{label}: image shape {out.shape} {out.dtype}")
    if not np.array_equal(vs, vs_ref):
        raise AssertionError(f"{label}: vs differs from native.carve on "
                             f"{(vs != vs_ref).sum()} pixels")
    if not np.array_equal(out, native.materialize(img, vs_ref, w)):
        raise AssertionError(f"{label}: image differs from native")
    if aux is not None and not np.array_equal(
            aux_out, native.materialize(aux, vs_ref, w)):
        raise AssertionError(f"{label}: aux image differs from native")


def _expect_launches(label, launches, want):
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")


def run_main_slice(device, n: int, seams: int):
    """Phase 4: the 2048x2048 main path through the public Carver (the
    resident route: one launch for the 100 seams). Returns its launch
    counts and the visibility map (equal to native.carve's)."""
    import lqr_tpu_torch
    from lqr_tpu_torch import native
    from lqr_tpu_torch.ops import dp_cuda

    img = make_test_image(n)
    carver = lqr_tpu_torch.Carver(img, device=device)
    reset_launches()
    t0 = time.perf_counter()
    carver.resize(n - seams, n)
    out = carver.get_image()
    secs = time.perf_counter() - t0
    launches = dict(dp_cuda.LAUNCHES)
    t1 = time.perf_counter()
    vs_ref = native.carve(img, seams)
    ref_secs = time.perf_counter() - t1
    _check_carve("main", img, carver.vmap_dump().data, out, vs_ref,
                 n - seams)
    _expect_launches("main", launches, _only(carve_resident=1))
    say("slice", f"Carver.resize({n - seams}, {n}) + get_image on {n}x{n}: "
        f"{secs:.3f} s incl. first calls; vs == native.carve, image == "
        f"native.materialize (C++ reference took {ref_secs:.1f} s); "
        f"launches {launches}")
    return launches, vs_ref


def run_main_per_seam(device, n: int, seams: int, vs_ref) -> dict:
    """Phase 4: the 2048x2048 main path's image on the per-seam route,
    driven explicitly (engine._extend_per_seam; the gate takes 2048^2 to
    the resident route): the DP and backtrack kernels once a seam, vs equal
    to native.carve's and the image to native.materialize. Returns the
    launch counts."""
    import torch
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.core.state import EngineConfig, init_state

    img = make_test_image(n)
    cfg = EngineConfig(H=n, Wb=n, C=3)
    st = init_state(cfg, img, device=device)
    torch.cuda.synchronize()
    reset_launches()
    out = engine._extend_per_seam(cfg, st, seams)
    torch.cuda.synchronize()
    launches = _launches()
    _expect_launches("main, per-seam route", launches,
                     _only(dp_forward=seams, backtrack=seams))
    image = engine.materialize(cfg, out, n - seams, n - seams)
    _check_carve("main, per-seam route", img, out.vs.cpu().numpy(),
                 image.cpu().numpy(), vs_ref, n - seams)
    say("slice", f"{n}x{n}, {seams} seams on the per-seam route: vs == "
        f"native.carve, image == native.materialize; launches {launches}")
    return launches


def carve_step_loop(cfg, st, k: int, fuse_energy: bool):
    """k seams off a MapState through ops.carve_step, one step per seam on
    the compacted planes; hist[j] = seam, committed into a fresh vs every
    KC seams by engine._commit_hist (the JAX engine's commit). Returns the
    state after the k seams."""
    import torch
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.ops.carve_step import carve_step

    vs = st.vs.clone()
    b, bias, rig = st.cur_b, st.cur_bias, st.cur_rig
    hist = torch.empty((engine.KC, cfg.H), dtype=torch.int32,
                       device=b.device)
    depth, d0, j = st.depth, st.depth, 0
    for _ in range(k):
        s = depth + 1
        hist[j], b, bias, rig = carve_step(
            b, bias, rig, st.ref_w - depth,
            engine.pref_is_left(s, cfg.side_switch_freq), cfg.delta_x,
            cfg.has_bias, cfg.has_rig, cfg.nrg, fuse_energy=fuse_energy)
        depth, j = s, j + 1
        if j == engine.KC:
            engine._commit_hist(vs, st.ref_w, d0, j, hist)
            d0, j = depth, 0
    engine._commit_hist(vs, st.ref_w, d0, j, hist)
    return st._replace(vs=vs, cur_b=b, cur_bias=bias, cur_rig=rig,
                       depth=depth)


def resident_route(cfg, st, k: int):
    """extend_map on its resident route, whatever its gate says (the
    engine's one resident route, on the map as a batch of one)."""
    from lqr_tpu_torch.core import engine
    gate = engine.route
    engine.route = lambda cfg: "resident"
    try:
        return engine.extend_map(cfg, st, k)
    finally:
        engine.route = gate


def fused_split(cfg, st, k: int):
    """carve_step_loop with the energy in torch ops and the DP kernel."""
    return carve_step_loop(cfg, st, k, False)


def fused_inline(cfg, st, k: int):
    """carve_step_loop with the energy inside the forward kernel."""
    return carve_step_loop(cfg, st, k, True)


def run_fused(device, vs_main, vs_cfg2) -> dict:
    """Phase 4: the fused seam step through carve_step_loop, 100 seams at
    N x N in both modes and on cfg2's image with its bias and rigidity
    planes (energy inline); each visibility map equal to native.carve's
    (vs_main, and vs_cfg2's first 100 seams), each image to
    native.materialize, two launches per seam. Returns the launch counts
    of the 2048^2 run with the energy inline."""
    import torch
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.core.state import EngineConfig, init_state

    h, w = CFG2
    d = cfg2_inputs()
    runs = [(f"fused {N}x{N} split", make_test_image(N), None, None, False,
             vs_main),
            (f"fused {N}x{N} energy inline", make_test_image(N), None, None,
             True, vs_main),
            (f"fused cfg2 {w}x{h} bias+rig energy inline", d["img"],
             d["bias"], d["rig"], True,
             np.where(vs_cfg2 <= SEAMS, vs_cfg2, 0))]
    for label, img, bias, rig, fuse, vs_ref in runs:
        H, W = img.shape[:2]
        cfg = EngineConfig(H=H, Wb=W, C=3, has_bias=bias is not None,
                           has_rig=rig is not None)
        st = init_state(cfg, img, bias=bias, rig=rig, device=device)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = carve_step_loop(cfg, st, SEAMS, fuse)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _launches()
        fwd = "dp_energy_forward" if fuse else "dp_forward"
        _expect_launches(label, launches,
                         _only(**{fwd: SEAMS, "backtrack_compact": SEAMS}))
        image = engine.materialize(cfg, out, W - SEAMS, W - SEAMS)
        _check_carve(label, img, out.vs.cpu().numpy(), image.cpu().numpy(),
                     vs_ref, W - SEAMS)
        say("slice", f"{label}: {SEAMS} seams in {secs:.3f} s incl. first "
            f"calls; vs == native.carve, image == native.materialize; "
            f"launches {launches}")
        if fuse and bias is None:
            main = launches
    return main


def run_cfg2(device) -> dict:
    """Phase 4: cfg2 through the public Carver — masks, rigidity and an
    RGBA aux image; 100 seams, then 300 (200 more on the live map: a
    128-seam chunk and a 72-seam chunk). Returns the launch counts and
    native.carve's 300-seam map."""
    import lqr_tpu_torch
    from lqr_tpu_torch import native
    from lqr_tpu_torch.ops import dp_cuda

    h, w = CFG2
    d = cfg2_inputs()
    carver = lqr_tpu_torch.Carver(d["img"], rigidity=RIGIDITY,
                                  device=device)
    carver.bias_add(d["pres"], 1000.0, w // 4, h // 4)
    carver.bias_add(d["disc"], -800.0, w // 2, h // 2)
    carver.rigmask_add(d["rigm"])
    carver.attach(d["aux"])
    reset_launches()
    t0 = time.perf_counter()
    got = {}
    for n in (100, 300):
        carver.resize(w - n, h)
        got[n] = (carver.vmap_dump().data, carver.get_image(),
                  carver.get_aux(0))
    secs = time.perf_counter() - t0
    launches = dict(dp_cuda.LAUNCHES)
    t1 = time.perf_counter()
    vs_ref = native.carve(d["img"], 300, bias=d["bias"], rig=d["rig"])
    ref_secs = time.perf_counter() - t1
    for n, (vs, out, aux_out) in got.items():
        # the first n seams of the 300-seam map are the n-seam map
        want = np.where(vs_ref <= n, vs_ref, 0)
        _check_carve(f"cfg2 {n} seams", d["img"], vs, out, want, w - n,
                     d["aux"], aux_out)
    _expect_launches("cfg2", launches, _only(carve_resident=3))
    say("slice", f"cfg2 {w}x{h} bias(+1000, -800) + rigmask + RGBA aux, "
        f"rigidity {RIGIDITY}: resize to {w - 100} then {w - 300} + "
        f"get_image + get_aux: {secs:.3f} s incl. first calls; vs == "
        f"native.carve, image and aux == native.materialize at both widths "
        f"(C++ reference took {ref_secs:.1f} s); launches {launches}")
    return launches, vs_ref


def run_cfg1(device, seams: int) -> dict:
    """Phase 4: cfg1, 512x384 without masks, through the public Carver."""
    import lqr_tpu_torch
    from lqr_tpu_torch import native
    from lqr_tpu_torch.ops import dp_cuda

    h, w = CFG1
    img = crop_image(CFG1)
    carver = lqr_tpu_torch.Carver(img, device=device)
    reset_launches()
    carver.resize(w - seams, h)
    out = carver.get_image()
    launches = dict(dp_cuda.LAUNCHES)
    _check_carve("cfg1", img, carver.vmap_dump().data, out,
                 native.carve(img, seams), w - seams)
    _expect_launches("cfg1", launches, _only(carve_resident=1))
    say("slice", f"cfg1 {w}x{h}: resize to {w - seams}: vs == native.carve,"
        f" image == native.materialize; launches {launches}")
    return launches


def time_routes(device, label, hw, routes, seams, gpu, bias=None,
                rig=None) -> dict:
    """Phase 5: seconds per seam of each extend_map route, synchronized,
    fresh images, the routes in turns; the median of three runs each after
    a warm-up."""
    import torch
    from lqr_tpu_torch.core.state import EngineConfig, init_state, round_up

    h, w = hw
    cfg = EngineConfig(H=h, Wb=round_up(w, 128), C=3,
                       has_bias=bias is not None, has_rig=rig is not None)

    def one(route, seed):
        st = init_state(cfg, crop_image(hw, seed), bias=bias, rig=rig,
                        device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = route(cfg, st, seams)
        torch.cuda.synchronize()
        if out.depth != seams:
            raise AssertionError(f"depth {out.depth} after {seams} seams")
        return time.perf_counter() - t0

    for route in routes:
        one(route, 1)                                    # warm-up
    runs = {route.__name__: [] for route in routes}
    for seed in (2, 3, 4):
        for route in routes:
            runs[route.__name__].append(one(route, seed))
    per_seam = {}
    for name, r in runs.items():
        per_seam[name] = statistics.median(r) / seams
        say("timing", f"{name} {seams} seams at {label}: runs "
            f"{[round(x, 5) for x in r]} s; median "
            f"{per_seam[name] * 1e6:.1f} us/seam = "
            f"{1 / per_seam[name]:.1f} seams/s on {gpu}")
    return per_seam


def check_dp_block(device) -> dict:
    """Phase 3: dp_block against its plain version at the shape of the
    card's shard of run_sharded_distinct's mesh (DISTINCT): R = 32 rows
    over a shard of 512 columns extended by G = 32 * delta_x lanes each
    side, +inf at one mesh edge, timed there at delta_x 1; and at phase
    10's shard of 1024 columns, timed there too."""
    import torch
    from lqr_tpu_torch.ops import dp_block as db

    R, Wl = 32, DISTINCT[1] // 2
    err, seed = 0.0, 40
    for dx in (1, 2):
        G = R * dx
        We = Wl + 2 * G
        for has_rig in (False, True):
            seed += 1
            e, rig = _random_case(R, We - G, We, dx, has_rig, seed, device)
            m0 = torch.from_numpy(np.round(np.random.default_rng(seed).random(
                We, np.float32) * 8) / 8).to(device)
            m0[We - G:] = torch.inf
            for first in (False, True):
                for pref in (True, False):
                    got = db.dp_block(m0, e, rig, pref, first, dx, has_rig, N)
                    want = db.dp_block_plain(m0, e, rig, pref, first, dx,
                                             has_rig, N)
                    torch.cuda.synchronize()
                    e_b = max(_max_err(got[0], want[0]),
                              _max_err(got[1], want[1]))
                    err = max(err, e_b)
                    if e_b != 0.0:
                        raise AssertionError(
                            f"dp_block differs from plain: {dx=} {has_rig=} "
                            f"{first=} {pref=}")
            say("kernels", f"dp_block R={R} We={We} delta_x={dx} "
                f"rig={has_rig}, first on/off, both sides: max_abs_err="
                f"{err} (tolerance 0)")
    # a slab wider than two frontier rows of shared memory: the frontier
    # pair in a global scratch
    We = 30001
    for first, dx, has_rig in ((False, 1, False), (True, 2, True)):
        e, rig = _random_case(12, We - 7, We, dx, has_rig, 60 + dx, device)
        m0 = e[-1].flip(0).contiguous()
        for pref in (True, False):
            got = db.dp_block(m0, e, rig, pref, first, dx, has_rig, N)
            want = db.dp_block_plain(m0, e, rig, pref, first, dx, has_rig, N)
            torch.cuda.synchronize()
            e_b = max(_max_err(got[0], want[0]), _max_err(got[1], want[1]))
            if e_b != 0.0:
                raise AssertionError(f"wide dp_block differs from plain: "
                                     f"{dx=} {first=} {pref=}")
        say("kernels", f"dp_block R=12 We={We} delta_x={dx} rig={has_rig} "
            f"first={first} (frontier in global scratch), both sides: "
            f"max_abs_err=0.0 (tolerance 0)")
    G = R
    e, _ = _random_case(R, Wl + G, Wl + 2 * G, 1, False, 50, device)
    m0 = e[0].flip(0).contiguous()
    ms = _cuda_ms(lambda: db.dp_block(m0, e, None, True, False, 1, False, N),
                  50)
    plain_ms = _cuda_ms(lambda: db.dp_block_plain(m0, e, None, True, False,
                                                  1, False, N), 3)
    say("kernels", f"dp_block R={R} We={Wl + 2 * G} delta_x=1 (the card's "
        f"shard of the {DISTINCT[1]}x{DISTINCT[0]} distinct-device mesh): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    # phase 10's shape: a 2048^2 image's shard of 1024 columns on one row of
    # 2 column shards, extended by G = 32 lanes each side
    We = COLS_W + 2 * G
    e, _ = _random_case(R, We - G, We, 1, False, 51, device)
    m0 = e[0].flip(0).contiguous()
    m0[We - G:] = torch.inf
    for first in (False, True):
        got = db.dp_block(m0, e, None, True, first, 1, False, N)
        want = db.dp_block_plain(m0, e, None, True, first, 1, False, N)
        torch.cuda.synchronize()
        if max(_max_err(got[0], want[0]), _max_err(got[1], want[1])) != 0.0:
            raise AssertionError(f"dp_block differs from plain at We={We}")
    cols_ms = _cuda_ms(lambda: db.dp_block(m0, e, None, True, False, 1,
                                           False, N), 50)
    cols_plain = _cuda_ms(lambda: db.dp_block_plain(m0, e, None, True,
                                                    False, 1, False, N), 3)
    say("kernels", f"dp_block R={R} We={We} delta_x=1 (phase 10's shard of "
        f"{N}x{N} on 2 column shards), first on/off: max_abs_err=0.0 "
        f"(tolerance 0); kernel {cols_ms:.4f} ms, plain {cols_plain:.4f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "cols": cols_ms,
            "cols_plain": cols_plain}


# The one-launch column-sharded DP's cases: (shards, H, W, delta_x,
# has_rig); the first is the 2048^2 path's own shape; the last two shards
# of 30016 columns, whose frontier rows do not fit the shared memory
SHARDED_CASES = [(SHARDS, N, N, 1, False), (SHARDS, N, N, 1, True),
                 (SHARDS, N, N, 2, False), (SHARDS, N, N, 2, True),
                 (2, N, N, 1, True), (8, N, N, 2, False),
                 (2, 256, 60032, 1, True)]
# small shapes for the CUDA tests: delta_x 0 and 3 (windows reloaded
# between exchanges), an odd shard width (own columns that straddle a
# lane's 8), one shard, H not a multiple of 32, more strips than warps
# (several a warp), and frontier rows in device scratch (16-byte copies,
# and an odd width with 4-byte ones)
SHARDED_EDGES = [(2, 48, 400, 0, False), (8, 48, 400, 2, True),
                 (2, 64, 400, 3, True), (3, 40, 303, 1, True),
                 (1, 32, 100, 1, False), (4, 24, 1000, 1, False),
                 (2, 16, 8192, 1, False), (2, 32, 60000, 2, True),
                 (2, 16, 59998, 1, False)]


def _sharded_inputs(case, device, seed):
    """(e_loc, rig_loc, R, e, rig) of a SHARDED_CASES case: random quantized
    planes (ties on purpose) split over its shards."""
    from lqr_tpu_torch.parallel.sharding import _block_rows
    n, H, W, dx, has_rig = case
    e, rig = _random_case(H, W, W, dx, has_rig, seed, device)
    Wl = W // n
    e_loc = [e[:, c * Wl:(c + 1) * Wl].contiguous() for c in range(n)]
    rig_loc = ([rig[:, c * Wl:(c + 1) * Wl].contiguous() for c in range(n)]
               if has_rig else None)
    return e_loc, rig_loc, _block_rows(H, dx, Wl), e, rig


def check_sharded_case(device, case, seed: int = 0,
                       own_vs_forward: bool = False) -> float:
    """dp_sharded against its plain version, both side preferences,
    tolerance 0 on every shard's M_last and bp; with own_vs_forward, the
    own columns against the unsharded dp_forward kernel too. Returns the
    largest error (0.0) or raises."""
    import torch
    from lqr_tpu_torch.ops import dp_block as db
    from lqr_tpu_torch.ops import dp_cuda

    n, H, W, dx, has_rig = case
    e_loc, rig_loc, R, e, rig = _sharded_inputs(case, device, seed)
    geo = db.sharded_geometry(W // n, dx, R, has_rig,
                              dp_cuda.smem_optin(device))
    err = 0.0
    for pref in (True, False):
        want = db.dp_sharded_plain(e_loc, rig_loc, pref, dx, has_rig, H, R)
        before = dp_cuda.LAUNCHES["dp_sharded"]
        got = db.dp_sharded(e_loc, rig_loc, pref, dx, has_rig, H, R)
        torch.cuda.synchronize()
        if dp_cuda.LAUNCHES["dp_sharded"] != before + 1:
            raise AssertionError("dp_sharded did not count one launch")
        e_s = max(_max_err(g, w) for g, w in zip(got[0] + got[1],
                                                 want[0] + want[1]))
        err = max(err, e_s)
        if e_s != 0.0:
            raise AssertionError(f"dp_sharded differs from plain: {case} "
                                 f"pref_left={pref}")
        if own_vs_forward:
            M_f, bp_f = dp_cuda.dp_forward(e, rig, pref, dx, has_rig)
            torch.cuda.synchronize()
            e_f = max(_max_err(torch.cat(got[0]), M_f),
                      _max_err(torch.cat(got[1], dim=1), bp_f))
            if e_f != 0.0:
                raise AssertionError(f"dp_sharded's own columns differ from "
                                     f"dp_forward: {case} pref_left={pref}")
    say("kernels", f"dp_sharded {n} shards H={H} W={W} delta_x={dx} "
        f"rig={has_rig} R={R} geometry (K, Gi, S, warps, global "
        f"frontier) {geo}, both sides: max_abs_err={err} (tolerance 0)"
        + (", own columns == dp_forward's" if own_vs_forward else ""))
    return err


def sharded_exchange_bytes(n: int, H: int, W: int, delta_x: int,
                           has_rig: bool) -> int:
    """Bytes that cross shards in one seam's DP: every R rows each of the
    n - 1 boundaries carries, both ways, G frontier values and an [R, G]
    energy (and rigidity) slab, f32."""
    from lqr_tpu_torch.parallel.sharding import _block_rows
    if n < 2 or delta_x == 0:
        return 0
    R = _block_rows(H, delta_x, W // n)
    G = R * delta_x
    per = 4 * (G + R * G * (2 if has_rig else 1))
    return (H // R) * (n - 1) * 2 * per


def check_dp_sharded(device) -> dict:
    """Phase 3: dp_sharded against its plain version at SHARDED_CASES (the
    own columns against dp_forward at the path's shape), then timed at
    the 2048^2 path's shape beside the per-block loop on the dp_block
    kernel (the route it replaces) and the plain loop, and at the wide
    case."""
    from lqr_tpu_torch.ops import dp_block as db
    from lqr_tpu_torch.ops import dp_cuda

    err = 0.0
    for i, case in enumerate(SHARDED_CASES):
        err = max(err, check_sharded_case(device, case, seed=70 + i,
                                          own_vs_forward=i < 4))
    case = SHARDED_CASES[0]
    n, H, W, dx, has_rig = case
    e_loc, _, R, _, _ = _sharded_inputs(case, device, 90)
    ms = _cuda_ms(lambda: db.dp_sharded(e_loc, None, True, dx, False, H, R),
                  20)
    devs = [device] * n
    blocks_ms = _cuda_ms(lambda: db.dp_blocked(e_loc, None, True, dx, False,
                                               H, R, devs), 2)
    plain_ms = _cuda_ms(lambda: db.dp_sharded_plain(e_loc, None, True, dx,
                                                    False, H, R), 1)
    geo = db.sharded_geometry(W // n, dx, R, False,
                              dp_cuda.smem_optin(device))
    say("kernels", f"dp_sharded at {W}x{H} on {n} shards (delta_x={dx}, "
        f"R={R}, geometry {geo}): {ms:.4f} ms ({ms * 1e3 / H:.4f} us/row); "
        f"the per-block loop on the dp_block kernel ({H // R * n} launches) "
        f"{blocks_ms:.4f} ms, the plain loop {plain_ms:.4f} ms")
    wide = SHARDED_CASES[-1]
    e_w, rig_w, R_w, _, _ = _sharded_inputs(wide, device, 91)
    ms_w = _cuda_ms(lambda: db.dp_sharded(e_w, rig_w, True, wide[3], True,
                                          wide[1], R_w), 20)
    geo_w = db.sharded_geometry(wide[2] // wide[0], wide[3], R_w, True,
                                dp_cuda.smem_optin(device))
    say("kernels", f"dp_sharded at {wide[2]}x{wide[1]} on {wide[0]} shards "
        f"(delta_x={wide[3]}, rig, R={R_w}, geometry {geo_w}): {ms_w:.4f} "
        f"ms ({ms_w * 1e3 / wide[1]:.4f} us/row)")
    for c in SHARDED_CASES:
        say("kernels", f"bytes crossing shards per seam's DP, {c[0]} shards "
            f"{c[2]}x{c[1]} delta_x={c[3]} rig={c[4]}: "
            f"{sharded_exchange_bytes(c[0], c[1], c[2], c[3], c[4])}")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


def _batched_case(device, sizes, kc, delta_x, rigidity, seed, masks=True):
    """The batched resident entry and its plain version (the per-map loop of
    the resident kernel's plain version) on one batch of the given (h, w)
    sizes, with bias and rigidity masks (masks) or none, padded as
    BatchCarver pads it. Returns (max_abs_err over hist and every plane,
    plain ms, the kernel's call, the blocks a map it launched)."""
    import torch
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.core.state import per_map
    from lqr_tpu_torch.ops import carve_resident as cr
    from lqr_tpu_torch.parallel import batch

    rng = np.random.default_rng(seed)
    imgs = [crop_image(hw, seed=seed + i) for i, hw in enumerate(sizes)]
    kw = dict(
        biases=[np.round(rng.standard_normal(hw) * 4).astype(np.float32) / 8
                for hw in sizes],
        rigmasks=[rng.random(hw).astype(np.float32) for hw in sizes]
    ) if masks else {}
    bc = batch.BatchCarver(imgs, delta_x=delta_x, rigidity=rigidity,
                           device=device, **kw)
    st = bc.state
    B, H, Wb = st.vs.shape
    pm = engine._posmap(st.vs, per_map(st.ref_w, device))
    rigc = torch.from_numpy(batch.rigc_table(bc.heights, delta_x)).to(device)
    d0 = [0] * B
    args = (st.cur_b, st.cur_bias, st.cur_rig, pm, bc.widths, d0, kc,
            bc.heights, rigc, delta_x, masks, masks, 0, 2, engine.KC)
    before = dict(cr.BATCH_BLOCKS)
    got = cr.carve_chunk_resident_batched(*args)
    blocks = [int(n) for n, c in cr.BATCH_BLOCKS.items() if c != before[n]]
    params = cr._batched_params(B, H, Wb, bc.widths, d0, kc, bc.heights,
                                engine.KC)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = cr.carve_chunk_resident_batched_plain(
        st.cur_b, st.cur_bias, st.cur_rig, pm, params, rigc, delta_x, masks,
        masks, 0, 2, engine.KC)
    t1.record()
    torch.cuda.synchronize()
    err = max(_max_err(g, w) for g, w in zip(got, want)
              if g is not None)
    say("kernels", f"carve_resident_batched B={B} H={H} Wb={Wb} heights="
        f"{bc.heights.tolist()} widths={bc.widths.tolist()} kc={kc} "
        f"delta_x={delta_x} {'bias+rig' if masks else 'no masks'}, blocks "
        f"a map {blocks}: max_abs_err={err} (tolerance 0)")
    if err != 0.0:
        raise AssertionError(f"carve_resident_batched differs from plain at "
                             f"B={B} H={H} Wb={Wb}")
    return err, t0.elapsed_time(t1), (
        lambda: cr.carve_chunk_resident_batched(*args)), blocks


def check_resident_batched(device) -> dict:
    """Phase 3: the batched resident entry against its plain version, one
    launch per batch, at the shapes its three paths give it: a ragged batch
    of four maps padded to cfg5's 360x640 (per-map width, seam count, one
    of them 0, and true height; delta_x=2); three maps padded to the ragged
    phase's 480x640; two maps at the cfg4 wave's 1024x1024 (1024 threads a
    block); and, without masks, the wave16 cell's 16 maps of 1024x1024 and
    128-seam chunk, which must launch WAVE16's clusters of 4 blocks a map
    (the card holds 15 clusters of 8, 30 of 4; timed there)."""
    from lqr_tpu_torch.core import engine
    kc = [32, 0, 20, 25]
    err, plain_ms, launch, _ = _batched_case(
        device, [(360, 640), (300, 600), (200, 500), (360, 620)], kc, 2,
        20.0, 0)
    ms = _cuda_ms(launch, 3)
    say("kernels", f"carve_resident_batched, that batch ({sum(kc)} seams): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    for sizes, kcs, seed in (([(480, 600), (128, 640), (300, 256)],
                              [24, 12, 16], 10),
                             ([(1024, 1024)] * 2, [8, 6], 20)):
        e, _, _, _ = _batched_case(device, sizes, kcs, 1, RIGIDITY, seed)
        err = max(err, e)
    h, w, B, blocks = WAVE16
    e, wave_plain_ms, wave, got = _batched_case(
        device, [(h, w)] * B, [engine.KC] * B, 1, 0.0, 30, masks=False)
    if got != [blocks]:
        raise AssertionError(f"carve_resident_batched at the wave16 shape "
                             f"launched {got} blocks a map, not {blocks}")
    wave_ms = _cuda_ms(wave, 3)
    say("kernels", f"carve_resident_batched at the wave16 shape ({B} maps "
        f"of {w}x{h}, kc={engine.KC}, {blocks} blocks a map): kernel "
        f"{wave_ms:.4f} ms, plain {wave_plain_ms:.4f} ms")
    return {"err": max(err, e), "ms": ms, "plain_ms": plain_ms,
            "cfg4": time_batched_cfg4(device), "wave16": wave_ms}


def time_batched_cfg4(device) -> float:
    """Phase 3: the batched entry at the cfg4 wave's shape, 256 maps of
    1024x1024 (a smooth test image's reader plane, no masks), kc = CFG4_KC
    seams; ms a launch, the mean of 3 after a warm-up."""
    import torch
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.core.energy import reader_plane
    from lqr_tpu_torch.ops import carve_resident as cr

    h, w, B, _ = CFG4
    b = reader_plane(torch.from_numpy(make_test_image(w, seed=10)[:h])
                     .to(device), 0).expand(B, h, w).contiguous()
    pm = torch.arange(w, dtype=torch.int32, device=device).expand(
        B, h, w).contiguous()
    rigc = torch.zeros((B, 2), device=device)
    args = (b, None, None, pm, w, 0, CFG4_KC, h, rigc, 1, False, False, 0,
            2, engine.KC)
    ms = _cuda_ms(lambda: cr.carve_chunk_resident_batched(*args), 3)
    say("kernels", f"carve_resident_batched at the cfg4 shape ({B} maps of "
        f"{w}x{h}, kc={CFG4_KC}): {ms:.4f} ms")
    return ms


# The H100 SXM's published float32 rate outside the tensor cores
# (NVIDIA's data sheet, 700 W); its memory rate is profiling.HBM_GBPS's.
F32_OPS_S = 67e12


def _bound(nbytes: float, ops: float):
    """(least ms, what bounds it): the larger of the bytes over the H100's
    memory rate and the operations over its f32 rate."""
    from lqr_tpu_torch.profiling import HBM_GBPS
    t_bytes = nbytes / (HBM_GBPS["h100 80gb hbm3"] * 1e9) * 1e3
    t_ops = ops / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dp_ops(delta_x: int, has_rig: bool) -> int:
    """Operations of one DP cell: a compare per candidate, the rig term's
    multiply and add per off-centre candidate, the energy's add."""
    return (2 * delta_x + 1) + (4 * delta_x if has_rig else 0) + 1


def _energy_ops(nrg: int, has_bias: bool) -> int:
    """Operations of one pixel's energy (core/energy.py): XABS sub, mul,
    abs; SUMABS and NORM both gradients (sub, mul each), then abs, abs,
    add, mul or mul, mul, add, sqrt; NULL none; the bias's add."""
    fam = 3 if nrg == 6 else nrg % 3
    return (3, 8, 8, 0)[fam] + (1 if has_bias else 0)


def kernel_bounds(n: int) -> dict:
    """Each kernel's bound at the shape phase 3 times it: each input byte
    read once, each output byte written once, the bytes the chase reads
    (one per row) rather than all of bp, and the operations its cells
    need over the widths this run carves."""
    H = W = n
    res_h, res_w = CFG2
    res_kc = 128
    # the batched entry's timed batch: (h, w, seams) per map, delta_x 2,
    # bias and rig, padded to 360 x 640 (check_resident_batched)
    batch = ((360, 640, 32), (300, 600, 0), (200, 500, 20), (360, 620, 25))
    R, We, We_c = 32, DISTINCT[1] // 2 + 2 * 32, COLS_W + 2 * 32
    c4_h, c4_w, c4_B, _ = CFG4
    w16_h, w16_w, w16_B, _ = WAVE16
    wh, ww = WIDE_STEP
    per_res = _energy_ops(0, True) + _dp_ops(1, True)
    per_bat = _energy_ops(0, True) + _dp_ops(2, True)
    return {
        "dp_forward": _bound(4 * H * W + 4 * W + H * W,
                             H * W * _dp_ops(1, False)),
        "dp_forward wide": _bound(4 * 256 * 32768 + 4 * 32768 + 256 * 32768,
                                  256 * 32768 * _dp_ops(1, False)),
        "backtrack": _bound(4 * W + H + 4 * H, 2 * W),
        # the main path's launch: SEAMS seams at n x n, no masks, delta_x 1
        "carve_resident": _bound(
            2 * 2 * 4 * H * W + 4 * SEAMS * H,
            H * (_energy_ops(0, False) + _dp_ops(1, False))
            * sum(W - j for j in range(SEAMS))),
        "carve_resident cfg2": _bound(
            2 * 4 * 4 * res_h * res_w + 4 * res_kc * res_h,
            per_res * res_h * sum(res_w - j for j in range(res_kc))),
        "carve_resident_batched": _bound(
            sum(2 * 4 * 4 * 360 * 640 + 4 * k * h for h, _, k in batch if k),
            per_bat * sum(h * sum(w - j for j in range(k))
                          for h, w, k in batch)),
        "carve_resident_batched cfg4": _bound(
            c4_B * (2 * 2 * 4 * c4_h * c4_w + 4 * CFG4_KC * c4_h),
            c4_B * c4_h * (_energy_ops(0, False) + _dp_ops(1, False))
            * sum(c4_w - j for j in range(CFG4_KC))),
        "carve_resident_batched wave16": _bound(
            w16_B * (2 * 2 * 4 * w16_h * w16_w + 4 * 128 * w16_h),
            w16_B * w16_h * (_energy_ops(0, False) + _dp_ops(1, False))
            * sum(w16_w - j for j in range(128))),
        # the card's shard of the distinct-device mesh, one block of rows
        "dp_block": _bound(4 * R * We + 2 * 4 * We + R * We,
                           R * We * _dp_ops(1, False)),
        # phase 10's shard of 1024 columns and its halos, one block of rows
        "dp_block cols": _bound(4 * R * We_c + 2 * 4 * We_c + R * We_c,
                                R * We_c * _dp_ops(1, False)),
        # the 2048^2 path's seam on SHARDS shards: E read once, bp and
        # M_last written once, the operations of the own cells (the halo
        # slabs are columns of the same E; the frontiers cross in shared
        # memory)
        "dp_sharded": _bound(4 * H * W + H * W + 4 * W,
                             H * W * _dp_ops(1, False)),
        "dp_energy_forward": _bound(
            4 * H * W + 4 * W + H * W,
            H * W * (_energy_ops(0, False) + _dp_ops(1, False))),
        "dp_energy_forward wide": _bound(
            4 * wh * ww + 4 * ww + wh * ww,
            wh * ww * (_energy_ops(0, False) + _dp_ops(1, False))),
        "backtrack_compact": _bound(4 * W + H + 2 * 4 * H * W + 4 * H,
                                    2 * W),
        "backtrack_compact masks": _bound(
            4 * W + H + 3 * 2 * 4 * H * W + 4 * H, 2 * W),
    }


def _launches() -> dict:
    from lqr_tpu_torch.ops import dp_cuda
    return dict(dp_cuda.LAUNCHES)


def _only(**counts) -> dict:
    """Every kernel's expected launch count: the given ones, else 0."""
    return {k: counts.get(k, 0) for k in _launches()}


def _round_half_away(x: float) -> int:
    """GIMP's ROUND() of a non-negative value (GAP's keyframe law)."""
    return int(np.floor(x + 0.5))


def cfg5_inputs():
    """cfg5 of scripts/bench_all.py: 300 rolled copies of one 640x360 test
    image (frame i rolled by (i, 2i)), and GAP's keyframed seam counts from
    0 (frame 0) to 160 (the last frame): round(160 * f / 299)."""
    h, w, n, top = CFG5
    base = crop_image((h, w))
    frames = np.stack([np.roll(base, (i, 2 * i), axis=(0, 1))
                       for i in range(n)])
    counts = np.array([_round_half_away(top * f / (n - 1))
                       for f in range(n)], np.int64)
    return frames, counts


def cfg4_inputs(seed: int = 0) -> np.ndarray:
    """One cfg4 wave: 256 copies of a 1024x1024 test image, each rolled by
    random (dy, dx) in [0, 64), pre-stacked [256, 1024, 1024, 3] u8."""
    h, w, B, _ = CFG4
    base = make_test_image(w, seed=10)[:h]
    r = np.random.default_rng(seed)
    return np.stack([np.roll(base, (int(dy), int(dx)), axis=(0, 1))
                     for dy, dx in zip(r.integers(0, 64, B),
                                       r.integers(0, 64, B))])


def run_cfg5(device, frames, counts) -> dict:
    """Phase 4: BatchCarver on cfg5's 300 frames; images_at against the C++
    reference on the deepest frame and two others."""
    import torch
    from lqr_tpu_torch import native
    from lqr_tpu_torch.parallel import BatchCarver

    h, w = frames.shape[1:3]
    bc = BatchCarver(frames, device=device)
    reset_launches()
    bc.carve(counts)
    torch.cuda.synchronize()
    launches = _launches()
    _expect_launches("cfg5", launches, _only(carve_resident=2))
    outs = bc.images_at(w - counts)
    checked = (len(frames) - 1, len(frames) // 2, len(frames) // 8)
    for f in checked:
        n = int(counts[f])
        vs = bc.state.vs[f, :, :w].cpu().numpy()
        _check_carve(f"cfg5 frame {f}", frames[f], vs, outs[f],
                     native.carve(frames[f], n), w - n)
    say("slice", f"cfg5 BatchCarver on {len(frames)} frames of {w}x{h}, "
        f"keyframed 0..{int(counts.max())} seams ({int(counts.sum())} in "
        f"all): vs == native.carve and images_at == native.materialize on "
        f"frames {checked}; launches {launches}")
    return launches


def run_cfg4(device, arr) -> dict:
    """Phase 4: one cfg4 wave through BatchCarver (the pre-stacked ndarray,
    used as it is); vs against the C++ reference on two images."""
    import torch
    from lqr_tpu_torch import native
    from lqr_tpu_torch.parallel import BatchCarver

    B, h, w = arr.shape[:3]
    seams = CFG4[3]
    bc = BatchCarver(arr, device=device)
    reset_launches()
    bc.carve(seams)
    torch.cuda.synchronize()
    launches = _launches()
    _expect_launches("cfg4", launches, _only(carve_resident=2))
    for i in (0, B - 1):
        vs = bc.state.vs[i, :, :w].cpu().numpy()
        if not np.array_equal(vs, native.carve(arr[i], seams)):
            raise AssertionError(f"cfg4 image {i}: vs differs from native")
    say("slice", f"cfg4 wave: BatchCarver on {B} images of {w}x{h}, {seams} "
        f"seams each: vs == native.carve on images 0 and {B - 1}; launches "
        f"{launches}")
    return launches


def ragged_inputs() -> dict:
    """Eight images of mixed sizes, each with cfg2's masks (preservation
    +1000 on its second quarter, discard -800 on its bottom-right quarter,
    a random grey rigidity mask on its left third) and an RGBA aux image;
    the bias and rig planes a Carver builds from them."""
    from lqr_tpu_torch.carver import place_mask_numpy
    sizes = [(h, w) for h, w, _ in RAGGED]
    rng = np.random.default_rng(12)
    d = {"sizes": sizes, "seams": np.array([n for _, _, n in RAGGED]),
         "img": [], "pres": [],
         "disc": [], "rigm": [], "aux": [], "bias": [], "rig": []}
    for i, (h, w) in enumerate(sizes):
        d["img"].append(crop_image((h, w), seed=20 + i))
        pres = rng.integers(160, 256, (h // 4, w // 4, 3)).astype(np.uint8)
        disc = np.full((h - h // 2, w - w // 2, 3), 255, np.uint8)
        rigm = rng.integers(0, 256, (h, w // 3)).astype(np.uint8)
        d["pres"].append(pres)
        d["disc"].append(disc)
        d["rigm"].append(rigm)
        d["aux"].append(rng.integers(0, 256, (h, w, 4)).astype(np.uint8))
        d["bias"].append(
            place_mask_numpy(pres, h, w, w // 4, h // 4) * np.float32(1.0)
            + place_mask_numpy(disc, h, w, w // 2, h // 2)
            * np.float32(-0.8))
        d["rig"].append(place_mask_numpy(rigm, h, w, 0, 0))
    return d


def run_ragged(device) -> dict:
    """Phase 4: a ragged BatchCarver with masks and aux images; each image
    equal to its solo Carver and to the C++ reference."""
    import torch
    import lqr_tpu_torch
    from lqr_tpu_torch import native
    from lqr_tpu_torch.parallel import BatchCarver

    d = ragged_inputs()
    bc = BatchCarver(d["img"], rigidity=RIGIDITY, biases=d["bias"],
                     rigmasks=d["rig"], aux=[[a] for a in d["aux"]],
                     device=device)
    n = d["seams"]
    reset_launches()
    bc.carve(n)
    torch.cuda.synchronize()
    launches = _launches()
    _expect_launches("ragged", launches, _only(carve_resident=1))
    vs_all = bc.state.vs.cpu().numpy()
    outs, auxs = bc.images_at(bc.widths - n), bc.aux_at(bc.widths - n)
    for i, (h, w) in enumerate(d["sizes"]):
        img, k = d["img"][i], int(n[i])
        solo = lqr_tpu_torch.Carver(img, rigidity=RIGIDITY, device=device)
        solo.bias_add(d["pres"][i], 1000.0, w // 4, h // 4)
        solo.bias_add(d["disc"][i], -800.0, w // 2, h // 2)
        solo.rigmask_add(d["rigm"][i])
        solo.attach(d["aux"][i])
        solo.resize(w - k, h)
        if not np.array_equal(vs_all[i, :h, :w], solo.vmap_dump().data):
            raise AssertionError(f"ragged image {i}: vs differs from its "
                                 f"solo Carver")
        vs_ref = native.carve(img, k, bias=d["bias"][i],
                              rig=d["rig"][i] * np.float32(RIGIDITY))
        _check_carve(f"ragged image {i}", img, vs_all[i, :h, :w], outs[i],
                     vs_ref, w - k, d["aux"][i], auxs[i][0])
    say("slice", f"ragged BatchCarver on {len(d['sizes'])} images "
        f"{d['sizes']} with masks, rigidity {RIGIDITY} and RGBA aux, seams "
        f"{n.tolist()}: vs == each solo Carver == native.carve, images and "
        f"aux == native.materialize; launches {launches}")
    return launches


def run_sharded(device, vs_main) -> dict:
    """Phase 4: the column-sharded resize, 2048x2048 on four column shards
    of the one card, 100 seams; vs equal to the unsharded Carver's (which
    equals native.carve) and the image to native.materialize."""
    import torch
    from lqr_tpu_torch import native
    from lqr_tpu_torch.parallel import BatchCarver, make_mesh
    from lqr_tpu_torch.parallel.sharding import _block_rows

    img = make_test_image(N)
    mesh = make_mesh(devices=[device] * SHARDS, data=1)
    bc = BatchCarver([img], mesh=mesh)
    if not bc.col_sharded:
        raise AssertionError("the mesh did not shard columns")
    reset_launches()
    bc.carve(SEAMS)
    torch.cuda.synchronize()
    launches = _launches()
    R = _block_rows(N, 1, N // SHARDS)
    _expect_launches("sharded", launches,
                     _only(dp_sharded=SEAMS, backtrack=SEAMS))
    _check_carve("sharded", img, bc.state.vs[0, :, :N].cpu().numpy(),
                 bc.images_at(N - SEAMS)[0], vs_main, N - SEAMS)
    say("slice", f"column-sharded BatchCarver, {N}x{N} on {SHARDS} column "
        f"shards of {device}, {SEAMS} seams ({R} rows per halo exchange): "
        f"vs == the unsharded Carver's == native.carve, image == "
        f"native.materialize; launches {launches}")
    return launches


def run_sharded_distinct(device) -> dict:
    """Phase 4: the column-sharded resize on a mesh of distinct devices,
    the card and the CPU: 1024x384 on 2 column shards (the card's slab
    check_dp_block's shape), 20 seams. The DP
    takes the per-block loop (dp_block on the card's shard, its plain
    version on the CPU's) with the halos copied between the two; vs equal
    to native.carve and the image to native.materialize."""
    import torch
    from lqr_tpu_torch import native
    from lqr_tpu_torch.parallel import BatchCarver, make_mesh
    from lqr_tpu_torch.parallel.sharding import _block_rows, dp_route

    h, w = DISTINCT
    seams = 20
    img = crop_image(DISTINCT)
    mesh = make_mesh(devices=[device, "cpu"], data=1)
    if dp_route(mesh.devices[0]) != "blocks":
        raise AssertionError("a mesh of distinct devices took the cluster")
    bc = BatchCarver([img], mesh=mesh)
    reset_launches()
    bc.carve(seams)
    torch.cuda.synchronize()
    launches = _launches()
    R = _block_rows(h, 1, w // 2)
    _expect_launches("sharded distinct", launches,
                     _only(dp_block=seams * (h // R), backtrack=seams))
    _check_carve("sharded distinct", img,
                 bc.state.vs[0, :, :w].cpu().numpy(),
                 bc.images_at(w - seams)[0], native.carve(img, seams),
                 w - seams)
    say("slice", f"column-sharded BatchCarver, {w}x{h} on 2 column shards "
        f"({device} and cpu), {seams} seams ({R} rows per halo exchange): "
        f"vs == native.carve, image == native.materialize; launches "
        f"{launches}")
    return launches


# Phase 6: the batch path above the Carver, file to file through the
# command line (lqr_tpu_torch.cli) at the main path's 2048x2048
CLI_ENLARGE = 200     # columns the enlargement inserts (one pass at 150 %)
CK_SEAMS = 50         # seams carved on the card before a checkpoint
CK_CPU_SEAMS = 4      # seams carved on the CPU before a checkpoint
RIG_MASK_RIGIDITY = 100.0   # --rigidity; render triples it with a rig mask


def route_launches(H: int, W: int, has_bias: bool, has_rig: bool,
                   seams: int) -> dict:
    """The launches the gate implies for seams seams off an H x W map
    without a live map: the resident kernel once per chunk of engine.KC,
    or the DP and backtrack kernels once a seam."""
    from lqr_tpu_torch.carver import _bucket
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.ops.carve_resident import resident_ok
    if resident_ok(1, H, _bucket(W), has_bias, has_rig):
        return _only(carve_resident=-(-seams // engine.KC))
    return _only(dp_forward=seams, backtrack=seams)


def cli_masks(n: int, seed: int = 6) -> dict:
    """The masked run's files and fields: a preservation mask over rows and
    columns n/4..n/2 (--pres, --pres-offset), a grey rigidity mask on the
    left third (--rigmask), and the bias and rig planes the Carver builds
    from them (rigidity tripled, as render's rigidity_init does)."""
    from lqr_tpu_torch.carver import place_mask_numpy
    rng = np.random.default_rng(seed)
    d = {"pres": rng.integers(160, 256, (n // 4, n // 4, 3)).astype(np.uint8),
         "rigm": rng.integers(0, 256, (n, n // 3, 1)).astype(np.uint8)}
    d["bias"] = (place_mask_numpy(d["pres"], n, n, n // 4, n // 4)
                 * np.float32(1.0))
    d["rig"] = (place_mask_numpy(d["rigm"], n, n, 0, 0)
                * np.float32(3 * RIG_MASK_RIGIDITY))
    return d


def _cli(argv) -> dict:
    """cli.main(argv) with the launch counts set to 0 just before it;
    returns the counts read just after. A non-zero exit raises."""
    import torch
    from lqr_tpu_torch import cli
    torch.cuda.synchronize()
    reset_launches()
    rc = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit code {rc}")
    return _launches()


def _same_file_image(label, path, ref):
    from lqr_tpu_torch.utils.image_io import load_image
    got = load_image(str(path))
    if got.shape != ref.shape or not np.array_equal(got, ref):
        raise AssertionError(f"{label}: {path.name} {got.shape} differs from "
                             f"the reference {ref.shape}")


def run_cli(device, tmp, vs_main) -> None:
    """Phase 6: the command line file to file on the card, each output held
    against the C++ reference (or against --cpu), each run's launches the
    ones its route's gate implies."""
    import torch
    from lqr_tpu_torch import Carver, load_carver, native, save_carver
    from lqr_tpu_torch.utils.image_io import save_image

    img = make_test_image(N)
    src = tmp / "in.png"
    save_image(str(src), img)
    ref = native.materialize(img, vs_main, N - SEAMS)

    # 1. plain shrink: the resident route
    launches = _cli([src, N - SEAMS, N, "-o", tmp / "out.png"])
    _expect_launches("cli shrink", launches,
                     route_launches(N, N, False, False, SEAMS))
    _same_file_image("cli shrink", tmp / "out.png", ref)
    say("cli", f"{N}x{N} -> {N - SEAMS}x{N} file to file: output == "
        f"native.materialize(img, native.carve(img, {SEAMS})); launches "
        f"{launches}")

    # 2. masked shrink: preservation and rigidity masks, past the gate
    m = cli_masks(N)
    save_image(str(tmp / "pres.png"), m["pres"])
    save_image(str(tmp / "rig.png"), m["rigm"])
    masked = _cli([src, N - SEAMS, N, "--pres", tmp / "pres.png",
                   "--pres-offset", f"{N // 4},{N // 4}", "--pres-coeff",
                   "1000", "--rigmask", tmp / "rig.png", "--rigidity",
                   f"{RIG_MASK_RIGIDITY:g}", "-o", tmp / "masked.png"])
    _expect_launches("cli masked", masked,
                     route_launches(N, N, True, True, SEAMS))
    t0 = time.perf_counter()
    vs_m = native.carve(img, SEAMS, bias=m["bias"], rig=m["rig"])
    ref_secs = time.perf_counter() - t0
    _same_file_image("cli masked", tmp / "masked.png",
                     native.materialize(img, vs_m, N - SEAMS))
    say("cli", f"{N}x{N} -> {N - SEAMS}x{N} with --pres and --rigmask: "
        f"output == native (carve with the same bias and rig fields, "
        f"{ref_secs:.1f} s on one core); launches {masked}")

    # 3. cfg1's image through two output options: the card == --cpu
    h1, w1 = CFG1
    save_image(str(tmp / "cfg1.png"), crop_image(CFG1))
    for j, opts in enumerate((["--output-target", "new-layer", "--seams"],
                              ["--scaleback", "--scaleback-mode", "stdw"])):
        outs = []
        for extra in ([], ["--cpu"]):
            tag = "cpu" if extra else "gpu"
            out = tmp / f"cfg1_{j}_{tag}.png"
            got = _cli([tmp / "cfg1.png", w1 - SEAMS, h1, *opts, *extra,
                        "-o", out])
            if not extra:
                _expect_launches(f"cli cfg1 {opts}", got,
                                 route_launches(h1, w1, False, False, SEAMS))
            outs.append(out.read_bytes())
        if outs[0] != outs[1]:
            raise AssertionError(f"cli cfg1 {opts}: the card's file differs "
                                 f"from --cpu's")
        say("cli", f"cfg1 {w1}x{h1} -> {w1 - SEAMS}x{h1} {' '.join(opts)}: "
            f"the card's file == --cpu's, byte for byte")

    # 4. enlargement, one pass at the default --enl-step 150
    grown = _cli([src, N + CLI_ENLARGE, N, "-o", tmp / "grown.png"])
    _expect_launches("cli enlarge", grown,
                     route_launches(N, N, False, False, CLI_ENLARGE))
    vs_g = native.carve(img, CLI_ENLARGE)
    if not np.array_equal(np.where(vs_g <= SEAMS, vs_g, 0), vs_main):
        raise AssertionError("native.carve's first seams changed")
    _same_file_image("cli enlarge", tmp / "grown.png",
                     native.materialize(img, vs_g, N + CLI_ENLARGE))
    say("cli", f"{N}x{N} -> {N + CLI_ENLARGE}x{N}: output == "
        f"native.materialize at the enlarged width; launches {grown}")

    # 5. checkpoints: saved on the card and on the CPU, resumed on the card
    for dev, k in ((device, CK_SEAMS), ("cpu", CK_CPU_SEAMS)):
        c = Carver(img, device=dev)
        c.resize(N - k, N)
        save_carver(str(tmp / "ck.npz"), c)
        r = load_carver(str(tmp / "ck.npz"), device="cuda")
        if (r.depth, r.width, r.device.type) != (k, N - k, device.type):
            raise AssertionError(f"checkpoint: loaded depth {r.depth} "
                                 f"width {r.width} on {r.device}")
        torch.cuda.synchronize()
        reset_launches()
        r.resize(N - SEAMS, N)
        got = r.get_image()
        resumed = _launches()
        _expect_launches(f"checkpoint from {dev}", resumed,
                         _only(carve_resident=1))
        if not np.array_equal(r.vmap_dump().data, vs_main):
            raise AssertionError(f"checkpoint from {dev}: the resumed map "
                                 f"differs from native.carve's")
        if not np.array_equal(got, ref):
            raise AssertionError(f"checkpoint from {dev}: the resumed image "
                                 f"differs from native.materialize")
        say("cli", f"checkpoint of a carver on {dev} at depth {k}, loaded "
            f"on the card, resized to {N - SEAMS}: map == native.carve's, "
            f"image == the shrink's; launches {resumed}")


def time_cli(device, tmp, vs_main, gpu) -> dict:
    """Phase 6: time to image of the plain shrink, synchronized, the median
    of 3 runs after a warm-up, fresh files each run: the whole cli.main
    call, then its parts done one by one as cli.run_one does them (decode,
    init_carver, resize, the write-back's materialize and copy to the host,
    encode); and materialize alone (CUDA events, mean of 20)."""
    import torch
    from lqr_tpu_torch import native
    from lqr_tpu_torch.config import LqrConfig
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.image_model import Image
    from lqr_tpu_torch.render import _write_back, init_carver
    from lqr_tpu_torch.utils.image_io import load_image, save_image

    img = make_test_image(N)
    ref = native.materialize(img, vs_main, N - SEAMS)
    cfg = LqrConfig(new_width=N - SEAMS, new_height=N)
    names = ("cli", "decode", "init_carver", "resize", "write_back",
             "encode")
    runs = {k: [] for k in names}
    for i in range(4):
        src, out = tmp / f"t{i}.png", tmp / f"t{i}_out.png"
        save_image(str(src), img)
        t = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _cli([src, N - SEAMS, N, "-o", out])
        t["cli"] = time.perf_counter() - t0
        _same_file_image("cli timing", out, ref)
        out.unlink()
        t0 = time.perf_counter()
        arr = load_image(str(src))
        t1 = time.perf_counter()
        cd = init_carver(Image.from_array(arr), cfg, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cd.carver.resize(N - SEAMS, N)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        _write_back(cd, cfg, N - SEAMS, N)
        t4 = time.perf_counter()
        save_image(str(out), cd.image.layer_by_name(cd.layer_name).pixels)
        t5 = time.perf_counter()
        t.update(decode=t1 - t0, init_carver=t2 - t1, resize=t3 - t2,
                 write_back=t4 - t3, encode=t5 - t4)
        _same_file_image("cli timing, by part", out, ref)
        if i:
            for k in names:
                runs[k].append(t[k])
    med = {k: statistics.median(v) * 1e3 for k, v in runs.items()}
    st = cd.carver._state
    mat_ms = _cuda_ms(lambda: engine.materialize_array(
        st.ref, st.vs, st.ref_w, N - SEAMS, N), 20)
    say("cli", f"time to image, {N}x{N} PNG -> {N - SEAMS}x{N} PNG, median "
        f"of 3: cli.main {med['cli']:.3f} ms; by part: decode "
        f"{med['decode']:.3f}, init_carver {med['init_carver']:.3f}, resize "
        f"{med['resize']:.3f}, write-back {med['write_back']:.3f}, encode "
        f"{med['encode']:.3f} ms; runs (ms) "
        f"{ {k: [round(x * 1e3, 3) for x in v] for k, v in runs.items()} }; "
        f"materialize alone {mat_ms:.4f} ms; on {gpu}")
    return {**med, "materialize": mat_ms}


# Phase 7: the interactive session and the masked run_plugin at the main
# path's 2048x2048
GROW = 48             # seams the map grows past its depth (1948 -> 1900)
LOOKUP_AT = (2000, 2100)  # widths inside the map's range [1948, 2148]
LOOKUPS = 20          # timed set_size calls inside the map
EXTEND_BY = 10        # seams past the depth a timed extension carves
EXTENSIONS = 5        # timed extensions in a row
PLUGIN_RIGIDITY = 100.0   # the dialog's rigidity; render triples it


def plugin_regions(n: int) -> dict:
    """The regions the dialog callback paints: the preservation mask over
    the centred quarter (rows and columns n/4..3n/4), the rigidity mask
    over the left third."""
    pres = np.zeros((n, n), bool)
    pres[n // 4:3 * n // 4, n // 4:3 * n // 4] = True
    rig = np.zeros((n, n), bool)
    rig[:, :n // 3] = True
    return {"pres": pres, "rig": rig}


def paint_masks(open_session, regions) -> None:
    """Paint the preservation and the rigidity mask, each in the mask-edit
    session that open_session(kind) opens on a new layer, and keep both."""
    from lqr_tpu_torch.config import AuxLayerType
    for kind, key in ((AuxLayerType.PRES, "pres"),
                      (AuxLayerType.RIGMASK, "rig")):
        with open_session(kind) as m:
            m.paint(regions[key])


def plugin_image(img, regions):
    """A fresh Image of img with both masks painted in their own layers,
    named as the dialog's New button names them."""
    from lqr_tpu_torch.image_model import Image
    from lqr_tpu_torch.masks import edit_mask
    image = Image.from_array(img)
    paint_masks(lambda kind: edit_mask(image, kind), regions)
    return image


def plugin_fields(image, n: int) -> dict:
    """The bias and rig fields the Carver builds from plugin_image's
    layers (pres_coeff 1000, the rigidity tripled by rigidity_init)."""
    from lqr_tpu_torch.carver import place_mask_numpy
    pres = image.layer_by_name("preservation mask layer").pixels
    rig = image.layer_by_name("rigidity mask layer").pixels
    return {"bias": place_mask_numpy(pres, n, n, 0, 0) * np.float32(1.0),
            "rig": place_mask_numpy(rig, n, n, 0, 0)
            * np.float32(3 * PLUGIN_RIGIDITY)}


def plugin_dialog(regions, width: int):
    """The dialog callback of phase 7's INTERACTIVE run: first a New
    preservation mask and a New rigidity mask, each painted and kept
    (WORK_ON_AUX_LAYER); then the size (the stored 100x100 reset to the
    image, the width set) and the rigidity, and OK."""
    from lqr_tpu_torch.dialog import Response
    calls = []

    def respond(dialog):
        calls.append(1)
        if len(calls) == 1:
            paint_masks(dialog.new_mask, regions)
            return Response.WORK_ON_AUX_LAYER
        dialog.reset_size_to_image()
        dialog.set_new_size(width=width)
        dialog.cfg = dialog.cfg.replace(rigidity=PLUGIN_RIGIDITY)
        return Response.OK
    return respond


def _counted(label, fn, want):
    """fn() with the launch counts set to 0 just before it; the counts
    read just after must be want. Returns fn's result and the counts."""
    import torch
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = _launches()
    _expect_launches(label, launches, want)
    return out, launches


def _same_pixels(label, got, want):
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{label}: pixels {got.shape} differ from the "
                             f"reference {want.shape}")


def _live_map(sess) -> np.ndarray:
    """The session's visibility map in its own orientation, without
    recording it (vmap_dump would hand it to the next seam-map dump)."""
    st = sess.cd.carver._state
    return st.vs[:, :st.ref_w].cpu().numpy()


def run_interactive(device, vs_main, tmp) -> None:
    """Phase 7, steps 1-7: an InteractiveSession at 2048x2048 on the card
    (map build, lookups, growth, reset, dumps, a vertical map) and
    run_plugin INTERACTIVE with two painted masks, then WITH_LAST_VALS,
    each step's launches the ones its route implies, each image equal to
    the C++ reference's (native.carve's on worker threads meanwhile)."""
    from concurrent.futures import ThreadPoolExecutor
    from lqr_tpu_torch import native, preview
    from lqr_tpu_torch.config import SeamColors
    from lqr_tpu_torch.dialog import RunMode, run_plugin
    from lqr_tpu_torch.image_model import Image
    from lqr_tpu_torch.settings import SettingsStore
    from lqr_tpu_torch.vmap_render import render_vmap

    img = make_test_image(N)
    img_t = np.ascontiguousarray(img.transpose(1, 0, 2))
    regions = plugin_regions(N)
    fields = plugin_fields(plugin_image(img, regions), N)
    w1, deep = N - SEAMS, SEAMS + GROW
    none = _only()
    with ThreadPoolExecutor(3) as pool:
        f_deep = pool.submit(native.carve, img, deep)
        f_vert = pool.submit(native.carve, img_t, SEAMS)
        f_mask = pool.submit(native.carve, img, SEAMS, **fields)

        def bg(sess):
            return sess.image.layer_by_name("Background").pixels

        # 1. the first map: the resident kernel
        sess, launches = _counted("interactive map", lambda: _new_session(
            img, device, w1), route_launches(N, N, False, False, SEAMS))
        if not np.array_equal(_live_map(sess), vs_main):
            raise AssertionError("interactive map differs from native.carve")
        _same_pixels("interactive map", bg(sess),
                     native.materialize(img, vs_main, w1))
        say("interactive", f"InteractiveSession + set_size({w1}, {N}): map "
            f"== native.carve, layer == native.materialize; launches "
            f"{launches}")

        # 2. lookups inside the map: no kernel
        for w in LOOKUP_AT:
            _counted(f"lookup {w}", lambda: sess.set_size(w, N), none)
            _same_pixels(f"lookup {w}", bg(sess),
                         native.materialize(img, vs_main, w))
        say("interactive", f"set_size at widths {LOOKUP_AT}: no launch; "
            f"layers == native.materialize of the same map")

        # 3. the map grows by GROW seams
        _counted("grow", lambda: sess.set_size(N - deep, N),
                 route_launches(N, N, False, False, GROW))
        vs_deep = f_deep.result()
        if not np.array_equal(np.where(vs_deep <= SEAMS, vs_deep, 0),
                              vs_main):
            raise AssertionError("native.carve's first seams changed")
        if not np.array_equal(_live_map(sess), vs_deep):
            raise AssertionError(f"grown map differs from native.carve("
                                 f"img, {deep})")
        _same_pixels("grow", bg(sess), native.materialize(img, vs_deep,
                                                          N - deep))
        say("interactive", f"set_size({N - deep}, {N}): depth {SEAMS} -> "
            f"{deep} on carve_resident (1 launch); map == native.carve("
            f"img, {deep}), layer == its materialization")

        # 4. back to the reference size: the image itself
        _counted("reset_size", sess.reset_size, none)
        _same_pixels("reset_size", bg(sess), img)

        # 5. the seam map, dumped twice into one layer
        for _ in range(2):
            if not _counted("dump", sess.dump_seam_map, none)[0]:
                raise AssertionError("dump_seam_map returned False")
        dumps = [l for l in sess.image.layers
                 if l.name == "Background seam map"]
        if len(dumps) != 1:
            raise AssertionError(f"{len(dumps)} seam-map layers, expected 1")
        _same_pixels("dump", dumps[0].pixels,
                     render_vmap(vs_deep, deep, SeamColors()))
        say("interactive", "reset_size: layer == img; dump_seam_map twice: "
            "one 'Background seam map' layer == render_vmap(native's map); "
            "no launch")

        # 6. flatten, then a vertical map
        _counted("reset_map", sess.reset_map, none)
        _counted("vertical", lambda: sess.set_size(N, w1),
                 route_launches(N, N, False, False, SEAMS))
        vs_vert = f_vert.result()
        if sess.map_info().orientation != 1 or not np.array_equal(
                _live_map(sess), vs_vert):
            raise AssertionError("vertical map differs from native.carve "
                                 "of the transposed image")
        _same_pixels("vertical", bg(sess), native.materialize(
            img_t, vs_vert, w1).transpose(1, 0, 2))
        say("interactive", f"reset_map, set_size({N}, {w1}): a vertical map "
            f"on carve_resident (1 launch) == native.carve of the "
            f"transposed image, layer == its materialization")
        del sess

        # 7. run_plugin, INTERACTIVE with two painted masks, then replayed
        store = SettingsStore(tmp / "plugin.json")
        image = Image.from_array(img)
        masked = route_launches(N, N, True, True, SEAMS)
        (out, cfg), _ = _counted(
            "run_plugin INTERACTIVE", lambda: run_plugin(
                image, RunMode.INTERACTIVE, store=store,
                dialog_driver=plugin_dialog(regions, w1), device=device),
            masked)
        vs_mask = f_mask.result()
    if (cfg.pres_layer, cfg.rigmask_layer) != ("preservation mask layer",
                                               "rigidity mask layer"):
        raise AssertionError(f"run_plugin masks {cfg.pres_layer!r}, "
                             f"{cfg.rigmask_layer!r}")
    ref = plugin_image(img, regions)
    for layer in ref.layers:
        _same_pixels(f"run_plugin {layer.name}",
                     out.layer_by_name(layer.name).pixels,
                     native.materialize(layer.pixels, vs_mask, w1))
    say("interactive", f"run_plugin INTERACTIVE ({N}x{N} -> {w1}, a painted "
        f"preservation mask and rigidity mask, rigidity "
        f"{PLUGIN_RIGIDITY:g}): the image and both masks == native "
        f"(carve with the Carver's bias and rig fields); launches {masked}")
    (again, _), _ = _counted("run_plugin WITH_LAST_VALS", lambda: run_plugin(
        ref, RunMode.WITH_LAST_VALS, store=store, device=device), masked)
    for layer in out.layers:
        _same_pixels(f"replay {layer.name}",
                     again.layer_by_name(layer.name).pixels, layer.pixels)
    fresh = plugin_image(img, regions)
    on = preview(fresh, cfg)
    off = preview(fresh, cfg, pres_on=False, rigmask_on=False)
    side = int(N / max(N / 200, 1.0))         # 200 at 2048: the 300x200 law
    if on.shape != (side, side, 4):
        raise AssertionError(f"preview shape {on.shape}")
    a, b = side // 2, side // 20              # centre; near the top left
    for key, (y, x, ch) in {"pres": (a, a, 1), "rig": (b, b, 2)}.items():
        if on[y, x, ch] <= off[y, x, ch]:
            raise AssertionError(f"preview: no {key} tint at ({y}, {x})")
    if not np.array_equal(on[b, side - 1 - b], off[b, side - 1 - b]):
        raise AssertionError("preview: an uncovered pixel changed")
    say("interactive", f"run_plugin WITH_LAST_VALS on a fresh copy == the "
        f"interactive run, every layer; launches {masked}; preview "
        f"{on.shape}, the masks tint their pixels")


def _ms(fn) -> float:
    """Milliseconds of fn(), synchronized before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _med(label, runs, gpu) -> float:
    med = statistics.median(runs)
    say("interactive", f"{label}: median {med:.3f} ms of "
        f"{[round(x, 3) for x in runs]} on {gpu}")
    return med


def time_interactive(device, tmp, gpu) -> None:
    """Phase 7, step 8, on the card, synchronized around each call: the
    first map (InteractiveSession + set_size, fresh sessions, median of 3
    after a warm-up); retarget_ms of a lookup (LOOKUPS set_size calls
    inside the map: the resize and the write-back to the host) and of an
    extension (EXTEND_BY seams past the depth, EXTENSIONS in a row); a
    lookup and an extension under profiling.trace, each in an
    annotate("retarget") span, the trace holding the span and the resident
    kernel; run_plugin with both masks, INTERACTIVE and WITH_LAST_VALS
    (median of 3 after a warm-up, fresh images); and the replay by part
    (init_carver, resize, the write-back: one materialization for the
    image, one per aux layer)."""
    import torch
    from lqr_tpu_torch import profiling
    from lqr_tpu_torch.dialog import RunMode, run_plugin
    from lqr_tpu_torch.image_model import Image
    from lqr_tpu_torch.render import _write_back, init_carver
    from lqr_tpu_torch.settings import (
        SettingsStore, retrieve_vals_use_aux_layers_names)

    img = make_test_image(N)
    w1 = N - SEAMS
    first = []
    for i in range(4):
        box = []
        ms = _ms(lambda: box.append(_new_session(img, device, w1)))
        if i:
            first.append(ms)
    sess = box[0]
    _med(f"first map, InteractiveSession + set_size({w1}, {N}) at {N}x{N}",
         first, gpu)

    widths = [w1 + 10 * (j + 1) for j in range(LOOKUPS)]
    _ms(lambda: sess.set_size(w1 + 5, N))               # warm-up
    reset_launches()
    looks = [_ms(lambda: sess.set_size(w, N)) for w in widths]
    _expect_launches("timed lookups", _launches(), _only())
    _med(f"retarget_ms of a lookup, {LOOKUPS} set_size calls at widths "
         f"{widths[0]}..{widths[-1]} (map depth {SEAMS})", looks, gpu)
    _med("of it get_image alone (materialize + copy to the host)",
         [_ms(sess.cd.carver.get_image) for _ in range(5)], gpu)
    layer = sess.image.layer_by_name("Background")
    _med(
        "of it the layer's canvas resize alone (Layer.resize, before "
        "get_image replaces its pixels)",
        [_ms(lambda: layer.resize(layer.width, N, 0, 0)) for _ in range(5)],
        gpu)

    targets = [w1 - EXTEND_BY * (j + 1) for j in range(EXTENSIONS)]
    reset_launches()
    exts = [_ms(lambda: sess.set_size(w, N)) for w in targets]
    _expect_launches("timed extensions", _launches(),
                     _only(carve_resident=EXTENSIONS))
    _med(f"retarget_ms of an extension by {EXTEND_BY} seams past the "
         f"depth, {EXTENSIONS} in a row (to {targets[-1]})", exts, gpu)

    with profiling.trace(tmp / "trace") as path:
        for w in (N, targets[-1] - EXTEND_BY):
            with profiling.annotate("retarget"):
                sess.set_size(w, N)
        torch.cuda.synchronize()
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events
             if e.get("name") == profiling.PREFIX + "retarget"]
    kernels = [e for e in events if "carve_resident" in e.get("name", "")
               and str(e.get("cat", "")).lower() == "kernel"]
    if not spans or not kernels:
        raise AssertionError(f"trace {path.name}: {len(spans)} 'retarget' "
                             f"spans, {len(kernels)} carve_resident kernels")
    say("interactive", f"profiling.trace of a lookup and an extension: "
        f"{len(spans)} 'retarget' spans ({[e.get('dur') for e in spans]} "
        f"us), {len(kernels)} carve_resident kernel "
        f"({[e.get('dur') for e in kernels]} us) in {path.name} "
        f"({path.stat().st_size} bytes) on {gpu}")
    del sess

    regions = plugin_regions(N)
    interactive, replay = [], []
    reset_launches()
    for i in range(4):
        image = Image.from_array(img)
        store = SettingsStore(tmp / f"timed{i}.json")
        t = _ms(lambda: run_plugin(
            image, RunMode.INTERACTIVE, store=store,
            dialog_driver=plugin_dialog(regions, w1), device=device))
        image = plugin_image(img, regions)
        r = _ms(lambda: run_plugin(image, RunMode.WITH_LAST_VALS,
                                   store=store, device=device))
        if i:
            interactive.append(t)
            replay.append(r)
    _expect_launches("timed run_plugin", _launches(),
                     _only(dp_forward=8 * SEAMS, backtrack=8 * SEAMS))
    _med(
        f"masked run_plugin INTERACTIVE end to end ({N}x{N} -> {w1}, the "
        f"dialog painting both masks, per-seam kernels)", interactive, gpu)
    _med(
        "masked run_plugin WITH_LAST_VALS end to end (the masks already in "
        "the image)", replay, gpu)

    parts = {"init_carver": [], "resize": [], "write_back": []}
    for i in range(4):
        image = plugin_image(img, regions)
        cfg, _ = retrieve_vals_use_aux_layers_names(store, image)
        box = []
        t = {"init_carver": _ms(lambda: box.append(
            init_carver(image, cfg, device=device)))}
        cd = box[0]
        t["resize"] = _ms(lambda: cd.carver.resize(w1, N))
        t["write_back"] = _ms(lambda: _write_back(cd, cfg, w1, N))
        if i:
            for k, v in t.items():
                parts[k].append(v)
    n_aux = len(cd.aux_names)
    _med(
        "of the replay init_carver (both masks placed on the host, the "
        "planes to the card)", parts["init_carver"], gpu)
    _med(f"of the replay resize ({SEAMS} seams on the per-seam kernels)",
         parts["resize"], gpu)
    _med(
        f"of the replay the write-back with {n_aux} aux layers (1 + "
        f"{n_aux} materializations)", parts["write_back"], gpu)
    _med("  get_image alone", [_ms(cd.carver.get_image)
                               for _ in range(4)][1:], gpu)
    _med("  get_aux(0) alone", [_ms(lambda: cd.carver.get_aux(0))
                                for _ in range(4)][1:], gpu)


def _new_session(img, device, width):
    from lqr_tpu_torch.image_model import Image
    from lqr_tpu_torch.interactive import InteractiveSession
    sess = InteractiveSession(Image.from_array(img), device=device)
    sess.set_size(width, N)
    return sess


def _median_runs(label, make, run, unit_count, unit, gpu) -> float:
    """Median seconds of three synchronized runs, each on fresh state from
    make() (outside the timed window), after a warm-up."""
    import torch
    secs = []
    for i in range(4):
        obj = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(obj)
        torch.cuda.synchronize()
        if i:
            secs.append(time.perf_counter() - t0)
        del obj
    med = statistics.median(secs)
    rate = (f"{unit_count / med:.1f} img_seams/s" if unit == "img_seams"
            else f"{med / unit_count * 1e6:.1f} us/seam")
    say("timing", f"{label}: runs {[round(x, 5) for x in secs]} s; median "
        f"{med:.5f} s = {rate} on {gpu}")
    return med


CFG4_IMAGES = 4096    # cfg4's images in phase 8: all 16 waves


def check_entry_line(label, line, want) -> None:
    """Phase 8: an entry point's JSON line passes: no error, every
    bit_exact* true, a value > 0, the launches of its timed run."""
    if "error" in line:
        raise AssertionError(f"{label}: error {line['error']}")
    bad = [k for k, v in line.items() if k.startswith("bit_exact")
           and v is not True]
    if bad or not any(k.startswith("bit_exact") for k in line):
        raise AssertionError(f"{label}: not bit-exact ({bad})")
    if not line["value"] > 0:
        raise AssertionError(f"{label}: value {line['value']}")
    _expect_launches(label, {k: line["launches"].get(k, 0)
                             for k in _launches()}, want)


def run_entry_points(device) -> None:
    """Phase 8: lqr_tpu_torch.bench and each lqr_tpu_torch.bench_all
    config on the card, in-process, each line checked."""
    from lqr_tpu_torch import bench, bench_all
    from lqr_tpu_torch.core.engine import KC

    # the launches of one timed run of each: cfg3's width map in chunks of
    # KC seams, its height map past the resident gate; two chunks a wave
    want = {"bench": _only(carve_resident=1),
            1: _only(carve_resident=1),
            2: _only(carve_resident=1),
            3: _only(carve_resident=N // 2 // KC, dp_forward=SEAMS,
                     backtrack=SEAMS),
            4: _only(carve_resident=2 * CFG4_IMAGES // CFG4[2]),
            5: _only(carve_resident=2)}
    reset_launches()
    t0 = time.perf_counter()
    line = bench.measure(device=device)
    say("entry", json.dumps(line))
    check_entry_line("bench", line, want["bench"])
    say("entry", f"bench: {time.perf_counter() - t0:.1f} s, launches in "
        f"all {_launches()}")
    report = bench_all.Reporter(
        out=lambda payload: say("entry", json.dumps(payload)))
    kw = {3: {"spot_seams": N // 2}, 4: {"n_images": CFG4_IMAGES}}
    for i in sorted(bench_all.CONFIGS):
        reset_launches()
        t0 = time.perf_counter()
        bench_all.run_config(i, report, device=device, **kw.get(i, {}))
        check_entry_line(bench_all.NAMES[i], report.lines[-1], want[i])
        say("entry", f"{bench_all.NAMES[i]}: {time.perf_counter() - t0:.1f}"
            f" s, launches in all {_launches()}")


def check_scaling_line(line) -> None:
    """Phase 9: one line of lqr_tpu_torch.scaling: no error, bit-exact, its
    counters as the design says, the launches of its route."""
    from lqr_tpu_torch.core.engine import KC
    label = line["metric"]
    if "error" in line or line["ok"] is not True \
            or line["bit_exact"] is not True:
        raise AssertionError(f"{label}: {line.get('error', 'not ok')}")
    per_row = _only(carve_resident=CFG4[3] // KC)
    if label == "data_parallel_scaling":
        _expect_launches(label, {k: line["launches_unsharded"].get(k, 0)
                                 for k in _launches()}, per_row)
        (dev,) = line["per_device"].values()
        _expect_launches(label, {k: dev["launches"].get(k, 0)
                                 for k in _launches()},
                         _only(carve_resident=line["rows"]
                               * CFG4[3] // KC))
    elif label == "multiprocess_gloo_resize":
        for w in line["workers"]:
            if w["device"] != "cuda:0":
                raise AssertionError(f"{label}: rank {w['rank']} on "
                                     f"{w['device']}")
            _expect_launches(f"{label} rank {w['rank']}",
                             {k: w["launches"].get(k, 0)
                              for k in _launches()}, per_row)
    else:
        _expect_launches(label, {k: line["launches_per_seam"].get(k, 0)
                                 for k in _launches()},
                         _only(dp_sharded=1, backtrack=1))


def run_scaling(gpu) -> None:
    """Phase 9: python -m lqr_tpu_torch.scaling on the card, in a process
    of its own (its workers share the card, their mesh's own carrier: the
    mailbox); every line checked. Then the same 'data' mesh under gloo,
    called here: the wave's gather timed under both carriers."""
    import torch
    from lqr_tpu_torch import scaling
    torch.cuda.empty_cache()        # the card's memory for its processes
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lqr_tpu_torch.scaling"],
        cwd=pathlib.Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=600)
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    for line in lines:
        say("scaling", json.dumps(line))
    if proc.returncode != 0 or len(lines) != 3:
        raise AssertionError(f"lqr_tpu_torch.scaling exited "
                             f"{proc.returncode} with {len(lines)} lines: "
                             f"{proc.stderr[-3000:]}")
    for line in lines:
        check_scaling_line(line)
    if lines[1]["transport"] != "mailbox":
        raise AssertionError(f"the workers on one host took "
                             f"{lines[1]['transport']}, not the mailbox")
    say("scaling", f"three lines bit-exact, their counters and launches as "
        f"expected: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gloo = scaling.multiprocess_gloo_resize("cuda", False, 2, 1, "gloo")
    say("scaling", json.dumps(gloo))
    if gloo["transport"] != "gloo":
        raise AssertionError(f"the gloo line ran {gloo['transport']}")
    check_scaling_line(gloo)
    if gloo["workers"][0]["vs_sha256"] != lines[1]["workers"][0]["vs_sha256"]:
        raise AssertionError("the wave's map differs between the carriers")
    say("scaling", f"the cfg4 wave's 'data' gather on 2 processes: mailbox "
        f"{lines[1]['gather_s']:.4f} s (again {lines[1]['gather_again_s']:.4f}"
        f" s), gloo {gloo['gather_s']:.4f} s (again "
        f"{gloo['gather_again_s']:.4f} s); the maps equal; "
        f"{time.perf_counter() - t0:.1f} s for the gloo line; {gpu}")


# Phase 10: (processes, column shards a row) of each process mesh
PROCESS_COLS = ((2, 2), (4, 2))


def run_process_cols(gpu) -> dict:
    """Phase 10: the 'cols' axis across processes that share the card, each
    mesh carved by lqr_tpu_torch.scaling's workers under each carrier;
    every line checked, each carrier's map held against the other's.
    Returns the workers' launches of dp_block and the backtrack, summed."""
    import torch
    from lqr_tpu_torch import scaling
    from lqr_tpu_torch.parallel.sharding import TRANSPORTS
    torch.cuda.empty_cache()        # the card's memory for its processes
    total = {"dp_block": 0, "backtrack": 0}
    maps = {}                       # each mesh's map under the first carrier
    for (procs, cols), transport in ((m, t) for m in PROCESS_COLS
                                     for t in TRANSPORTS):
        label = f"{procs} processes as {procs // cols} x {cols}, {transport}"
        t0 = time.perf_counter()
        line = scaling.multiprocess_gloo_resize("cuda", False, procs, cols,
                                                transport)
        say("cols", json.dumps(line))
        if line["ok"] is not True or line["bit_exact"] is not True \
                or line["transport"] != transport:
            raise AssertionError(f"{label}: not ok: halo "
                                 f"{line['halo_messages_per_seam']} against "
                                 f"{line['halo_messages_predicted']}, "
                                 f"bit_exact {line['bit_exact']}, carrier "
                                 f"{line['transport']}")
        copies = line["host_copies_per_seam"]
        sent = line["gloo_messages_per_seam"]
        if (transport == "mailbox") != (copies == sent == 0):
            raise AssertionError(f"{label}: {copies} host copies and {sent} "
                                 f"gloo messages a seam step")
        sha = {w["vs_sha256"] for w in line["workers"]}
        if maps.setdefault((procs, cols), sha) != sha:
            raise AssertionError(f"{label}: the map differs from the other "
                                 f"carrier's")
        for w in line["workers"]:
            steps = w["images"] * w["seams"]
            if w["device"] != "cuda:0" or w["img_seams"] != steps:
                raise AssertionError(f"{label}: rank {w['rank']} on "
                                     f"{w['device']}, {w['img_seams']} "
                                     f"img_seams")
            _expect_launches(f"{label} rank {w['rank']}",
                             {k: w["launches"].get(k, 0)
                              for k in _launches()},
                             _only(dp_block=steps * (w["H"]
                                                     // w["block_rows"]),
                                   backtrack=steps))
            for kname in total:
                total[kname] += w["launches"][kname]
        w0 = line["workers"][0]
        say("cols", f"{label}, {w0['images']} image(s) of {w0['H']} rows a "
            f"row, {w0['seams']} seams, R={line['block_rows']}: "
            f"{line['ms_per_seam']:.3f} ms a seam step; in messages "
            f"{[round(x, 3) for x in line['exchange_ms_per_seam']]} ms a "
            f"step by rank; launches a step "
            f"{line['launches_per_seam'][0]} in every worker; halo messages "
            f"a step {line['halo_messages_per_seam']} (predicted "
            f"{line['halo_messages_predicted']}); host copies "
            f"{copies} and gloo messages {sent} a step; every worker's map "
            f"bit-equal to one process's and to the other carrier's; "
            f"{time.perf_counter() - t0:.1f} s with the workers' start; "
            f"{gpu}")
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from lqr_tpu_torch.ops import _build, dp_cuda    # needs the checkout
    from lqr_tpu_torch.core import engine

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    gpu = smi.stdout.strip().splitlines()[0]
    say("device", f"{name}; nvidia-smi: {gpu}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    print(gpu, flush=True)

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    say("build", f"nvcc {' '.join(_build.NVCC_FLAGS)}, "
        f"{len(_build.SOURCES)} sources in parallel: "
        f"{time.perf_counter() - t0:.2f} s -> {_build.SO.name}")

    k = check_kernels(device, N)
    for kname, check in (("carve_resident", check_resident),
                         ("carve_resident_batched", check_resident_batched),
                         ("dp_block", check_dp_block),
                         ("dp_sharded", check_dp_sharded)):
        r = check(device)
        for key in ("err", "ms", "plain_ms"):
            k[key][kname] = r[key]
        for cell in ("cfg2", "cfg4", "wave16", "cols"):
            if cell in r:
                k["ms"][f"{kname} {cell}"] = r[cell]
    r = check_carve_step(device, N)
    for key in ("err", "ms", "plain_ms"):
        k[key].update(r[key])

    launches, vs_main = run_main_slice(device, N, SEAMS)
    per_seam = run_main_per_seam(device, N, SEAMS, vs_main)
    for kname in ("dp_forward", "backtrack"):
        launches[kname] = per_seam[kname]
    _, vs_cfg2 = run_cfg2(device)
    run_cfg1(device, SEAMS)
    frames, counts = cfg5_inputs()
    run_cfg5(device, frames, counts)
    wave = cfg4_inputs()
    run_cfg4(device, wave)
    run_ragged(device)
    launches["dp_sharded"] = run_sharded(device, vs_main)["dp_sharded"]
    launches["dp_block"] = run_sharded_distinct(device)["dp_block"]
    fl = run_fused(device, vs_main, vs_cfg2)
    for kname in ("dp_energy_forward", "backtrack_compact"):
        launches[kname] = fl[kname]

    time_routes(device, f"{N}x{N}", (N, N),
                [engine._extend_per_seam, resident_route, fused_split,
                 fused_inline], SEAMS, gpu)
    routes = [resident_route, engine._extend_per_seam]
    c2 = cfg2_inputs()
    time_routes(device, "1024x768 with bias and rig", CFG2, routes, SEAMS,
                gpu, c2["bias"], c2["rig"])
    time_routes(device, "512x384", CFG1, routes, SEAMS, gpu)
    from lqr_tpu_torch.parallel import BatchCarver, make_mesh
    _median_runs(f"cfg5 BatchCarver.carve, {len(frames)} frames of 640x360, "
                 f"{int(counts.sum())} img_seams",
                 lambda: BatchCarver(frames, device=device),
                 lambda bc: bc.carve(counts), int(counts.sum()), "img_seams",
                 gpu)
    _median_runs(f"cfg4 wave BatchCarver.carve, {len(wave)} images of "
                 f"1024x1024, {CFG4[3]} seams each",
                 lambda: BatchCarver(wave, device=device),
                 lambda bc: bc.carve(CFG4[3]), len(wave) * CFG4[3],
                 "img_seams", gpu)
    del wave
    img = make_test_image(N)
    mesh = make_mesh(devices=[device] * SHARDS, data=1)
    _median_runs(f"column-sharded {N}x{N} on {SHARDS} shards of one card, "
                 f"{SEAMS} seams", lambda: BatchCarver([img], mesh=mesh),
                 lambda bc: bc.carve(SEAMS), SEAMS, "seam", gpu)

    with tempfile.TemporaryDirectory() as tmp:
        run_cli(device, pathlib.Path(tmp), vs_main)
        time_cli(device, pathlib.Path(tmp), vs_main, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        run_interactive(device, vs_main, pathlib.Path(tmp))
        time_interactive(device, pathlib.Path(tmp), gpu)
    run_entry_points(device)
    run_scaling(gpu)
    for kname, count in run_process_cols(gpu).items():
        launches[kname] += count

    replaces = {"dp_forward": "lqr_tpu/ops/dp_pallas.py:351",
                "backtrack": "lqr_tpu/ops/dp_pallas.py:547",
                "carve_resident": "lqr_tpu/ops/carve_resident.py:178",
                "dp_block": "lqr_tpu/ops/dp_block.py:44",
                "dp_sharded": "lqr_tpu/ops/dp_block.py:44",
                "dp_energy_forward": "lqr_tpu/ops/dp_pallas.py:761",
                "backtrack_compact": "lqr_tpu/ops/dp_pallas.py:925 and "
                                     "lqr_tpu/ops/dp_pallas.py:1002"}
    sources = {"backtrack_compact": "carve_step"}
    bounds = kernel_bounds(N)
    for kname, (ms_b, by) in bounds.items():
        say("bounds", f"{kname}: {ms_b * 1e3:.4f} us, bound by {by}")
    for kname, shape in (("carve_resident", f"the main path's launch "
                                            f"({N}x{N}, {SEAMS} seams)"),
                         ("carve_resident cfg2", "cfg2's 128-seam chunk"),
                         ("carve_resident_batched", "cfg5's batch of 4 maps"),
                         ("carve_resident_batched cfg4", "the cfg4 shape"),
                         ("carve_resident_batched wave16",
                          "the wave16 shape"),
                         ("dp_energy_forward wide",
                          "x".join(map(str, WIDE_STEP))),
                         ("backtrack_compact masks",
                          f"{N}x{N} with bias and rig"),
                         ("dp_block cols",
                          f"R=32, We={COLS_W + 64} (phase 10's shard)")):
        say("bounds", f"{kname.split()[0]} at {shape}: "
            f"{k['ms'][kname]:.4f} ms, bound {bounds[kname][0]:.4f} ms "
            f"({bounds[kname][1]})")
    # no single PyTorch call computes a DP scan, a chase or a resident
    # chunk, so no kernel has a library time
    kernels = [{
        "name": kname, "route": "cuda",
        "source": f"lqr_tpu_torch/csrc/{sources.get(kname, kname)}.cu",
        "replaces": replaces[kname],
        "launches": launches[kname],
        "max_abs_err": k["err"][kname],
        "ms": k["ms"][kname], "plain_ms": k["plain_ms"][kname],
        "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
        "library_ms": None,
    } for kname in dp_cuda.LAUNCHES]
    for kern in kernels:
        if kern["launches"] <= 0:
            raise AssertionError(f"{kern['name']} was not launched on its "
                                 f"path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
