#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lqr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

1. device  — the card's name and power limit; no CUDA means exit 1.
2. build   — nvcc builds the kernels from lqr_tpu_torch/csrc/.
3. kernels — each kernel against its plain PyTorch version on the same
             CUDA inputs, bit-exact (tolerance 0): 2048x2048 at delta_x=1
             with both side preferences, delta_x=2 with rigidity, and a
             Wb=384 shape; a launch the card refuses (oversize Wb) must
             raise. Kernel and plain times at 2048x2048.
4. slice   — Carver(img, device="cuda").resize(2048-100, 2048) on the
             2048x2048 test image: the visibility map must equal the C++
             reference carver's bit for bit, the image its materialization
             u8 for u8, and both kernels must have been launched for every
             seam.
5. timing  — 100 seams through extend_map on fresh images, synchronized.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N = 2048          # the main path: 100 seams off a 2048x2048 RGB image
SEAMS = 100


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


def _cuda_ms(fn, reps: int) -> float:
    import torch
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


def check_kernels(device, n: int) -> dict:
    """Phase 3: kernels vs plain versions; returns per-kernel errors and
    times."""
    import torch
    from lqr_tpu_torch.core.energy import energy_from_plane, reader_plane
    from lqr_tpu_torch.ops import dp_cuda

    img = torch.from_numpy(make_test_image(n)).to(device)
    e_main = energy_from_plane(reader_plane(img, 0), n, 0)
    cases = [("main", e_main, None, 1, pref) for pref in (True, False)]
    e, rig = _random_case(256, 1000, 1024, 2, True, 5, device)
    cases += [("delta2_rig", e, rig, 2, pref) for pref in (True, False)]
    e, rig = _random_case(300, 380, 384, 1, False, 6, device)
    cases += [("wb384", e, None, 1, True)]

    err = {"dp_forward": 0.0, "backtrack": 0.0}
    for name, e, rig, dx, pref in cases:
        has_rig = rig is not None
        M_k, bp_k = dp_cuda.dp_forward(e, rig, pref, dx, has_rig)
        M_p, bp_p = dp_cuda.dp_forward_plain(e, rig, pref, dx, has_rig)
        seam_k = dp_cuda.backtrack(M_p, bp_p, pref)
        seam_p = dp_cuda.backtrack_plain(M_p, bp_p, pref)
        torch.cuda.synchronize()
        e_dp = max(_max_err(M_k, M_p), _max_err(bp_k, bp_p))
        e_bt = _max_err(seam_k, seam_p)
        say("kernels", f"{name} H={e.shape[0]} Wb={e.shape[1]} delta_x={dx} "
            f"rig={has_rig} pref_left={pref}: dp_forward max_abs_err={e_dp} "
            f"backtrack max_abs_err={e_bt} (tolerance 0)")
        if e_dp != 0.0 or e_bt != 0.0:
            raise AssertionError(f"kernel differs from plain on {name}")
        err["dp_forward"] = max(err["dp_forward"], e_dp)
        err["backtrack"] = max(err["backtrack"], e_bt)

    # a launch the card refuses must raise, never fall back
    big = torch.zeros((2, 32768), dtype=torch.float32, device=device)
    try:
        dp_cuda.dp_forward(big, None, True, 1, False)
    except RuntimeError as exc:
        say("kernels", f"oversize Wb=32768 refused as it must: {exc}")
    else:
        raise AssertionError("oversize Wb launch did not raise")

    M_p, bp_p = dp_cuda.dp_forward_plain(e_main, None, True, 1, False)
    ms = {
        "dp_forward": _cuda_ms(
            lambda: dp_cuda.dp_forward(e_main, None, True, 1, False), 20),
        "backtrack": _cuda_ms(
            lambda: dp_cuda.backtrack(M_p, bp_p, True), 20),
    }
    plain_ms = {
        "dp_forward": _cuda_ms(
            lambda: dp_cuda.dp_forward_plain(e_main, None, True, 1, False),
            2),
        "backtrack": _cuda_ms(
            lambda: dp_cuda.backtrack_plain(M_p, bp_p, True), 2),
    }
    for k in ms:
        say("kernels", f"{k} at {n}x{n}: kernel {ms[k]:.4f} ms, plain "
            f"{plain_ms[k]:.4f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


def run_slice(device, n: int, seams: int) -> dict:
    """Phase 4: the main path through the public Carver surface."""
    import lqr_tpu_torch
    from lqr_tpu_torch import native
    from lqr_tpu_torch.ops import dp_cuda

    img = make_test_image(n)
    carver = lqr_tpu_torch.Carver(img, device=device)
    for k in dp_cuda.LAUNCHES:
        dp_cuda.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    carver.resize(n - seams, n)
    out = carver.get_image()
    secs = time.perf_counter() - t0
    launches = dict(dp_cuda.LAUNCHES)
    vs = carver.vmap_dump().data

    t1 = time.perf_counter()
    vs_ref = native.carve(img, seams)
    out_ref = native.materialize(img, vs_ref, n - seams)
    ref_secs = time.perf_counter() - t1
    if out.shape != (n, n - seams, 3) or out.dtype != np.uint8:
        raise AssertionError(f"image shape {out.shape} {out.dtype}")
    if not np.array_equal(vs, vs_ref):
        raise AssertionError(
            f"vs differs from native.carve on {(vs != vs_ref).sum()} pixels")
    if not np.array_equal(out, out_ref):
        raise AssertionError("image differs from native.materialize")
    for k, v in launches.items():
        if v < seams:
            raise AssertionError(f"{k} launched {v} times for {seams} seams")
    say("slice", f"Carver.resize({n - seams}, {n}) + get_image on {n}x{n}: "
        f"{secs:.3f} s incl. first calls; vs == native.carve, image == "
        f"native.materialize (C++ reference took {ref_secs:.1f} s); "
        f"launches {launches}")
    return launches


def time_extend(device, n: int, seams: int, gpu: str) -> float:
    """Phase 5: seconds per seam of extend_map, synchronized, fresh
    images; returns the median of three runs."""
    import torch
    from lqr_tpu_torch.core.state import EngineConfig, init_state
    from lqr_tpu_torch.core.engine import extend_map

    cfg = EngineConfig(H=n, Wb=n, C=3)

    def one(seed):
        st = init_state(cfg, make_test_image(n, seed), device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = extend_map(cfg, st, seams)
        torch.cuda.synchronize()
        if out.depth != seams:
            raise AssertionError(f"depth {out.depth} after {seams} seams")
        return time.perf_counter() - t0

    one(1)                                   # warm-up
    runs = [one(seed) for seed in (2, 3, 4)]
    per_seam = statistics.median(runs) / seams
    say("timing", f"extend_map {seams} seams at {n}x{n}: runs "
        f"{[round(r, 4) for r in runs]} s; median {per_seam * 1e6:.1f} "
        f"us/seam = {1 / per_seam:.1f} seams/s on {gpu}")
    return per_seam


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from lqr_tpu_torch.ops import _build, dp_cuda    # needs the checkout

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    gpu = smi.stdout.strip().splitlines()[0]
    say("device", f"{name}; nvidia-smi: {gpu}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    say("build", f"nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.2f} s -> {_build.SO.name}")

    k = check_kernels(device, N)
    launches = run_slice(device, N, SEAMS)
    time_extend(device, N, SEAMS, gpu)

    replaces = {"dp_forward": "lqr_tpu/ops/dp_pallas.py:351",
                "backtrack": "lqr_tpu/ops/dp_pallas.py:547"}
    kernels = [{
        "name": kname, "route": "cuda",
        "source": f"lqr_tpu_torch/csrc/{kname}.cu",
        "replaces": replaces[kname],
        "launches": launches[kname],
        "max_abs_err": k["err"][kname],
        "ms": k["ms"][kname], "plain_ms": k["plain_ms"][kname],
    } for kname in dp_cuda.LAUNCHES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
