"""Benchmark of the port: seams/s at 2048x2048, 100-seam removal on the card
(BASELINE.md's primary metric), the counterpart of the JAX package's
``bench.py``.

    python -m lqr_tpu_torch.bench [--size 2048] [--seams 100]
        [--ref-seams 12] [--check-seams 6] [--device cuda]

Prints ONE JSON line and exits 0, whatever fails (a failed phase is named
in an "error" field, beside what did succeed):

  {"metric": "seams_per_sec_2048x2048_remove100", "value": N,
   "unit": "seams/s", "vs_baseline": N, ...}

- value: seams/s of ``core.engine.extend_map`` on the card: 100 seams off a
  fresh 2048x2048 test image, synchronized around the call, the median of
  3 runs after a warm-up; the copy to the card is outside the timed window.
- vs_baseline: the ratio to the single-core C++ reference carver
  (native/lqr_ref.cpp, ``native.bench``), best of 2 runs of --ref-seams
  seams on the same image.
- bit_exact_vs_ref / mismatch_frac: the first --check-seams seams of the
  card's visibility map against ``native.carve``'s.
- device: the card's name and power limit (nvidia-smi); route: the route
  extend_map took; launches: the kernels one timed run launched.

The device is the card unless ``--device cpu`` is given, which only the
tests use (the plain PyTorch versions of the kernels). Without CUDA the
line has value 0 and an error: the CPU is never timed in the card's place.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np


def make_test_image(n: int, seed: int = 0) -> np.ndarray:
    """Smooth structured test image (pure noise has degenerate seams)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, n, 3)).astype(np.float32)
    for _ in range(3):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
               + np.roll(img, -1, 0) + np.roll(img, -1, 1)) / 5.0
    yy, xx = np.mgrid[0:n, 0:n]
    img[:, :, 0] += 60 * np.sin(xx / 37.0) + 40 * np.cos(yy / 53.0)
    img[:, :, 1] += 50 * np.cos((xx + yy) / 41.0)
    return np.clip(img, 0, 255).astype(np.uint8)


def device_info(device) -> dict:
    """The device's name and power limit: nvidia-smi's
    ``name,power.limit`` for a card, {"name": "cpu", "power_limit": None}
    for the CPU."""
    import torch
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    info = {"name": torch.cuda.get_device_name(index), "power_limit": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return info
    name, _, limit = smi.stdout.strip().partition(", ")
    return {"name": name or info["name"], "power_limit": limit or None}


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches_of(fn):
    """(fn(), the kernel launches fn made: {name: count} of the nonzero
    counts; empty on the CPU, where the plain versions launch nothing)."""
    from .ops import dp_cuda
    before = dict(dp_cuda.LAUNCHES)
    out = fn()
    return out, {k: v - before[k] for k, v in dp_cuda.LAUNCHES.items()
                 if v != before[k]}


def median_runs(make, run, device, runs: int = 3):
    """Seconds of ``runs`` synchronized calls of run(make()) after one
    warm-up, each on fresh input from make(seed) built outside the timed
    window; returns (the median, every run, the launches of the last)."""
    secs, launches = [], {}
    for i in range(runs + 1):
        obj = make(i + 1)
        sync(device)
        t0 = time.perf_counter()
        _, launches = launches_of(lambda: run(obj))
        sync(device)
        if i:
            secs.append(time.perf_counter() - t0)
        del obj
    return statistics.median(secs), secs, launches


def measure(size: int = 2048, seams: int = 100, ref_seams: int = 12,
            check_seams: int = 6, device: str = "cuda") -> dict:
    """The benchmark's one result, as the JSON line prints it; never
    raises: a failed phase is named in result["error"]."""
    result = {"metric": f"seams_per_sec_{size}x{size}_remove{seams}",
              "value": 0.0, "unit": "seams/s", "vs_baseline": 0.0}
    errors = []
    try:
        _run(size, seams, ref_seams, check_seams, device, result, errors)
    except Exception as e:  # noqa: BLE001 — the JSON line must still go out
        errors.append(f"fatal:{type(e).__name__}:{str(e)[:300]}")
    if errors:
        result["error"] = "; ".join(errors)
    return result


def _run(n, seams, ref_seams, check_seams, device, result, errors):
    from .core.engine import extend_map, route
    from .core.state import EngineConfig, init_state, resolve_device, \
        round_up
    from . import native

    dev = resolve_device(device)        # no CUDA: raises before any timing
    result["device"] = device_info(dev)
    img = make_test_image(n)
    cfg = EngineConfig(H=n, Wb=round_up(n, 128), C=3)
    result["route"] = route(cfg)

    cpu_sps = max(ref_seams / native.bench(img, ref_seams)
                  for _ in range(2))
    result["cpu_singlecore_seams_per_sec"] = cpu_sps

    try:
        st = extend_map(cfg, init_state(cfg, img, device=dev), check_seams)
        vs_dev = st.vs[:, :n].cpu().numpy()
        vs_ref = native.carve(img, check_seams)
        result["bit_exact_vs_ref"] = bool(np.array_equal(vs_dev, vs_ref))
        result["mismatch_frac"] = float((vs_dev != vs_ref).mean())
    except Exception as e:  # noqa: BLE001 — time the carve all the same
        errors.append(f"check:{type(e).__name__}:{str(e)[:200]}")

    med, secs, launches = median_runs(
        lambda seed: init_state(cfg, make_test_image(n, seed=seed),
                                device=dev),
        lambda st: extend_map(cfg, st, seams), dev)
    sps = seams / med
    result.update({"value": sps, "vs_baseline": sps / cpu_sps,
                   "per_seam_us": med / seams * 1e6, "runs_s": secs,
                   "launches": launches})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lqr_tpu_torch.bench",
        description="seams/s of the port on the card, one JSON line")
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--seams", type=int, default=100)
    ap.add_argument("--ref-seams", type=int, default=12,
                    help="seams timed on the single-core C++ baseline "
                         "(scaled; the full count would take minutes)")
    ap.add_argument("--check-seams", type=int, default=6,
                    help="seams cross-checked bit-exact against the C++ "
                         "reference")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the kernels' plain versions (tests)")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.size, args.seams, args.ref_seams,
                             args.check_seams, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
