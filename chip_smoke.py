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
             with rigidity, and a Wb=384 shape; a launch the card refuses
             (oversize Wb) must raise. The resident kernel: 1024x768 with
             bias and rigidity under GRAD_XABS and GRAD_NORM (128 seams),
             delta_x=2 with rigidity, 512x384 without masks, and a partial
             chunk (72 seams at depth 128). Kernel and plain times at
             2048x2048 (DP, backtrack) and 1024x768 with masks (resident).
4. slice   — the paths through the public Carver surface, each with the
             launch counts set to 0 just before it and read just after:
             2048x2048, 100 seams (the per-seam kernels, no resident
             launch); cfg2, 1024x768 with preservation, discard and
             rigidity masks and an RGBA aux image, 100 seams and then 300
             (the resident kernel only); cfg1, 512x384, 100 seams. Each
             visibility map must equal the C++ reference carver's bit for
             bit, each image (and aux image) its materialization u8 for u8.
5. timing  — 100 seams through extend_map on fresh images, synchronized:
             the per-seam route at 2048x2048, both routes at 1024x768 with
             masks and at 512x384.

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
CFG1 = (384, 512)     # (h, w) of scripts/bench_all.py's cfg1, no masks
CFG2 = (768, 1024)    # cfg2: preservation, discard and rigidity masks
RIGIDITY = 100.0      # cfg2's global rigidity


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


def check_resident(device) -> dict:
    """Phase 3, the resident kernel against its plain version on the same
    CUDA inputs (tolerance 0 on hist rows < kc and on every plane at every
    column); returns its largest error and its times."""
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
        pm = engine._posmap_from_vs(st.vs, st.ref_w)
        return (st.cur_b, st.cur_bias, st.cur_rig, pm, w, 0, kc, dx,
                cfg.has_bias, cfg.has_rig, nrg, cfg.side_switch_freq,
                engine.KC)

    c2 = cfg2_inputs()
    cases = [
        ("cfg2 GRAD_XABS bias+rig", chunk(CFG2, 128, 0, 1, c2["bias"],
                                          c2["rig"])),
        ("cfg2 GRAD_NORM bias+rig", chunk(CFG2, 128, 2, 1, c2["bias"],
                                          c2["rig"])),
        ("1024x768 delta_x=2 rig", chunk(CFG2, 48, 0, 2, None, c2["rig"])),
        ("cfg1 512x384 no masks", chunk(CFG1, 128)),
    ]
    def compare(name, args):
        got = cr.carve_chunk_resident(*args)
        want = cr.carve_chunk_resident_plain(*args)
        torch.cuda.synchronize()
        kc = args[6]
        e = max([_max_err(got[0][:kc], want[0][:kc])]
                + [_max_err(g, p) for g, p in zip(got[1:], want[1:])
                   if g is not None])
        H, Wb = args[0].shape
        say("kernels", f"carve_resident {name} H={H} Wb={Wb} w0={args[4]} "
            f"d0={args[5]} kc={kc}: max_abs_err={e} (tolerance 0)")
        if e != 0.0 or not bool((got[0][kc:] == -1).all()):
            raise AssertionError(f"carve_resident differs from plain: {name}")
        return got, e

    first, err = compare(*cases[0])
    for case in cases[1:]:
        err = max(err, compare(*case)[1])
    # the partial chunk goes on from the first case's planes
    _, b, bias, rig, pm = first
    args = cases[0][1]
    err = max(err, compare("cfg2 partial chunk at depth 128",
                           (b, bias, rig, pm, args[4] - 128, 128, 72)
                           + args[7:])[1])

    args = cases[0][1]
    ms = _cuda_ms(lambda: cr.carve_chunk_resident(*args), 5)
    plain_ms = _cuda_ms(lambda: cr.carve_chunk_resident_plain(*args), 1,
                        warm=False)
    say("kernels", f"carve_resident, 128 seams at 1024x768 with bias and "
        f"rig: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


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


def run_main_slice(device, n: int, seams: int) -> dict:
    """Phase 4: the 2048x2048 main path through the public Carver."""
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
    _expect_launches("main", launches, {"dp_forward": seams,
                                        "backtrack": seams,
                                        "carve_resident": 0})
    say("slice", f"Carver.resize({n - seams}, {n}) + get_image on {n}x{n}: "
        f"{secs:.3f} s incl. first calls; vs == native.carve, image == "
        f"native.materialize (C++ reference took {ref_secs:.1f} s); "
        f"launches {launches}")
    return launches


def run_cfg2(device) -> dict:
    """Phase 4: cfg2 through the public Carver — masks, rigidity and an
    RGBA aux image; 100 seams, then 300 (200 more on the live map: a
    128-seam chunk and a 72-seam chunk)."""
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
    _expect_launches("cfg2", launches, {"dp_forward": 0, "backtrack": 0,
                                        "carve_resident": 3})
    say("slice", f"cfg2 {w}x{h} bias(+1000, -800) + rigmask + RGBA aux, "
        f"rigidity {RIGIDITY}: resize to {w - 100} then {w - 300} + "
        f"get_image + get_aux: {secs:.3f} s incl. first calls; vs == "
        f"native.carve, image and aux == native.materialize at both widths "
        f"(C++ reference took {ref_secs:.1f} s); launches {launches}")
    return launches


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
    _expect_launches("cfg1", launches, {"dp_forward": 0, "backtrack": 0,
                                        "carve_resident": 1})
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

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    say("build", f"nvcc {' '.join(_build.NVCC_FLAGS)}, "
        f"{len(_build.SOURCES)} sources in parallel: "
        f"{time.perf_counter() - t0:.2f} s -> {_build.SO.name}")

    k = check_kernels(device, N)
    r = check_resident(device)
    launches = run_main_slice(device, N, SEAMS)
    launches["carve_resident"] = run_cfg2(device)["carve_resident"]
    run_cfg1(device, SEAMS)

    time_routes(device, f"{N}x{N}", (N, N), [engine.extend_map], SEAMS, gpu)
    routes = [engine._extend_resident, engine._extend_per_seam]
    c2 = cfg2_inputs()
    time_routes(device, "1024x768 with bias and rig", CFG2, routes, SEAMS,
                gpu, c2["bias"], c2["rig"])
    time_routes(device, "512x384", CFG1, routes, SEAMS, gpu)

    k["err"]["carve_resident"] = r["err"]
    k["ms"]["carve_resident"] = r["ms"]
    k["plain_ms"]["carve_resident"] = r["plain_ms"]
    replaces = {"dp_forward": "lqr_tpu/ops/dp_pallas.py:351",
                "backtrack": "lqr_tpu/ops/dp_pallas.py:547",
                "carve_resident": "lqr_tpu/ops/carve_resident.py:178"}
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
