"""All five BASELINE.json benchmark configs on the card, one JSON line each:
the port's counterpart of the JAX package's ``scripts/bench_all.py``.

Configs (BASELINE.json "configs"):
  1. 512x384 RGB, default params, remove 100 vertical seams
  2. 1024x768 with preservation + discard bias masks and rigidity
  3. 2048x2048 two-axis rescale with seam insertion to 150% width
  4. Batched throughput: 4096x 1MP images, 25% width reduction
  5. GAP animation: 300-frame keyframed sequence with per-frame seam maps

Each line keeps the JAX script's metric name, unit, vs_baseline (the rate
against the single-core C++ reference, ``native.bench``, scaled where the
JAX script scales it) and bit-exact check against the C++ reference, and
adds the card's name and power limit ("device") and the kernels one timed
run launched ("launches"). Timing is bench.py's: synchronized around the
timed call, fresh input each run, the median of 3 after a warm-up, the
copy to the card outside the timed window. A config that fails prints an
error line and the rest go on; the exit code is 0.

Usage: python -m lqr_tpu_torch.bench_all [--config N] [--quick]
  --quick samples config #4 (256 images instead of 4096; rate-identical)

Each config function takes its sizes and device as parameters, so that the
tests run it small on the CPU; the command line runs them on the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .bench import (device_info, launches_of, make_test_image, median_runs,
                    sync)

NAMES = {1: "cfg1_512x384_default_100seams",
         2: "cfg2_1024x768_masks_rigidity_100seams",
         3: "cfg3_2048sq_two_axis_enlarge150",
         4: "cfg4_batched_1MP_25pct_reduction",
         5: "cfg5_gap_300frames_keyframed"}


def _crop(h: int, w: int, seed: int = 0) -> np.ndarray:
    return make_test_image(max(h, w), seed=seed)[:h, :w]


def _extend_rate(report, name, h, w, seams, cpu_seams, dev, bias=None,
                 rig=None):
    """cfg1/cfg2: seams/s of extend_map on an h x w crop (bias/rig f32
    fields or None), its map against native.carve, the CPU rate from
    native.bench over cpu_seams seams (best of 2)."""
    from . import native
    from .core.engine import extend_map, route
    from .core.state import EngineConfig, init_state, round_up

    img = _crop(h, w)
    cfg = EngineConfig(H=h, Wb=round_up(w, 128), C=3,
                       has_bias=bias is not None, has_rig=rig is not None)
    st = extend_map(cfg, init_state(cfg, img, bias=bias, rig=rig,
                                    device=dev), seams)
    vs_ref = native.carve(img, seams, bias=bias, rig=rig)
    exact = bool(np.array_equal(st.vs[:, :w].cpu().numpy(), vs_ref))
    med, secs, launches = median_runs(
        lambda seed: init_state(cfg, _crop(h, w, seed), bias=bias, rig=rig,
                                device=dev),
        lambda s: extend_map(cfg, s, seams), dev)
    sps = seams / med
    cpu = max(cpu_seams / native.bench(img, cpu_seams) for _ in range(2))
    report(name, sps, "seams/s", sps / cpu, dev, bit_exact=exact,
           meets_50x_target=bool(sps / cpu >= 50), route=route(cfg),
           per_seam_us=med / seams * 1e6, runs_s=secs,
           cpu_singlecore_seams_per_sec=cpu, launches=launches)


def config1(report, device="cuda", h=384, w=512, seams=100):
    """512x384 defaults, 100 vertical seams (liblqr defaults, CPU ref)."""
    from .core.state import resolve_device
    dev = resolve_device(device)
    _extend_rate(report, NAMES[1], h, w, seams, seams, dev)


def config2(report, device="cuda", h=768, w=1024, seams=100, cpu_seams=12):
    """1024x768 with pres+disc masks and rigidity (feature-mask path); the
    CPU rate is the reference's without masks over cpu_seams seams, as the
    JAX script measures it."""
    from .core.state import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    bias = np.zeros((h, w), np.float32)
    bias[h // 4:h // 2, w // 4:w // 2] += 1.0    # preservation area
    bias[h // 2:, w // 2:] -= 0.8                # discard area
    rig = np.zeros((h, w), np.float32)
    rig[:, :w // 3] = 100.0 * rng.random((h, w // 3)).astype(np.float32)
    _extend_rate(report, NAMES[2], h, w, seams, cpu_seams, dev, bias, rig)


def _two_axis_reference(img, new_w: int, new_h: int):
    """The two-axis protocol on the C++ reference: the width map to new_w
    (one enlargement pass), materialized, transposed, the height map to
    new_h, materialized, transposed back. Returns (width map, height map
    in the transposed image's coordinates, the image)."""
    from . import native
    H, W = img.shape[:2]
    vs_w = native.carve(img, abs(new_w - W))
    tw = np.ascontiguousarray(np.swapaxes(native.materialize(img, vs_w,
                                                             new_w), 0, 1))
    vs_h = native.carve(tw, H - new_h)
    out = np.swapaxes(native.materialize(tw, vs_h, new_h), 0, 1)
    return vs_w, vs_h, out


def config3(report, device="cuda", n=2048, cut=100, m=768, m_cut=48,
            spot_seams=6, ref_seams=8):
    """n^2 two-axis rescale: Carver.resize(1.5 n, n - cut), one enlargement
    pass of n/2 width seams (the resident route at 2048^2), then cut
    height seams on the transposed 1.5n-column image (the per-seam route
    at 2048^2: its planes are past the resident gate).

    The time is split as the JAX script splits it: the input staged on the
    card, the compute (resize + the output on the card), the output's copy
    to the host; one more flow times the width and the height pass apart.
    The CPU baseline is the reference's seconds per seam
    measured on ref_seams seams at each of the two geometries the flow
    visits, scaled by the config's seam counts. Bit-exactness: (a) the
    full two-axis protocol at m^2 (m_cut height seams), u8 for u8 against
    the C++ reference; (b) the n^2 flow's width map, its first spot_seams
    seams against native.carve; when spot_seams is the whole map (n/2),
    also the height map and the output image against the reference."""
    from . import native
    from .carver import Carver
    from .core.state import resolve_device

    dev = resolve_device(device)
    new_w, new_h = int(n * 1.5), n - cut

    def flow(seed):
        """(input stage s, compute s, output transfer s, launches of the
        resize) of one two-axis resize."""
        im = make_test_image(n, seed=seed)
        t0 = time.perf_counter()
        cc = Carver(im, device=dev)
        sync(dev)
        t1 = time.perf_counter()
        out_dev, launches = launches_of(
            lambda: (cc.resize(new_w, new_h), cc.get_image_device())[1])
        sync(dev)
        t2 = time.perf_counter()
        out_dev.cpu()
        t3 = time.perf_counter()
        return t1 - t0, t2 - t1, t3 - t2, launches

    flow(1)                                        # warm-up
    runs = [flow(seed) for seed in (2, 3, 4)]
    stage_s, wall_s, d2h_s = ([r[k] for r in runs] for k in range(3))
    launches = runs[-1][3]
    dt = statistics.median(wall_s)
    seam_ops = n // 2 + cut          # inserted width seams + removed rows

    # where the compute goes: one more flow, its two axes timed apart (the
    # same work: resize keeps an axis already at its target)
    cc = Carver(make_test_image(n, seed=5), device=dev)
    sync(dev)
    t0 = time.perf_counter()
    cc.resize(new_w, n)
    sync(dev)
    t1 = time.perf_counter()
    cc.resize(new_w, new_h)
    cc.get_image_device()
    sync(dev)
    axes_s = {"width_pass_s": t1 - t0,
              "height_pass_s": time.perf_counter() - t1}
    del cc

    # the CPU baseline, scaled from ref_seams seams per geometry; the
    # height carve runs on the transposed 1.5n-column materialization, and
    # any image of those dimensions prices its per-seam cost
    img = make_test_image(n)
    t_w = min(native.bench(img, ref_seams) for _ in range(2))
    tall = np.ascontiguousarray(
        np.swapaxes(np.concatenate([img, img[:, :n // 2]], axis=1), 0, 1))
    t_h = min(native.bench(tall, ref_seams) for _ in range(2))
    cpu_dt = t_w / ref_seams * (n // 2) + t_h / ref_seams * cut

    # (a) the full two-axis protocol at m^2
    small = make_test_image(m)
    cs = Carver(small, device=dev)
    cs.resize(int(m * 1.5), m - m_cut)
    exact_small = bool(np.array_equal(
        cs.get_image(), _two_axis_reference(small, int(m * 1.5),
                                           m - m_cut)[2]))
    del cs

    # (b) the n^2 flow's maps against the reference
    cb = Carver(img, device=dev)
    cb.set_dump_vmaps(True)
    cb.resize(new_w, new_h)
    out_big = cb.get_image()
    vmap_w, vmap_h = (v.data for v in cb.vmaps)
    del cb
    extra = {}
    if spot_seams >= n // 2:
        vs_w, vs_h, out_ref = _two_axis_reference(img, new_w, new_h)
        exact_big = bool(np.array_equal(vmap_w, vs_w)
                         and np.array_equal(vmap_h.T, vs_h)
                         and np.array_equal(out_big, out_ref))
        extra["bit_exact_full_protocol_2048"] = exact_big
    else:
        vs_spot = native.carve(img, spot_seams)
        exact_big = bool(np.array_equal(
            np.where(vmap_w <= spot_seams, vmap_w, 0), vs_spot))

    report(NAMES[3], seam_ops / dt, "seam_ops/s", cpu_dt / dt, dev,
           bit_exact=bool(exact_small and exact_big),
           meets_50x_target=bool(cpu_dt / dt >= 50), wall_s=dt,
           wall_runs_s=wall_s, input_stage_s=statistics.median(stage_s),
           output_transfer_s=statistics.median(d2h_s), **axes_s,
           cpu_single_core_wall_s=cpu_dt,
           cpu_baseline_scaled_from_seams=ref_seams,
           bit_exact_full_protocol_768=exact_small,
           bit_exact_2048_spot=exact_big, spot_seams=min(spot_seams, n // 2),
           launches=launches, **extra)


def make_wave(seed: int, B: int, size: int) -> np.ndarray:
    """One cfg4 wave on the host: B copies of a size^2 test image, each
    rolled by a random (dy, dx) in [0, 64), written by the native codec
    straight into the [B, size, size, 3] batch buffer."""
    from .utils import codec
    r = np.random.default_rng(seed)
    base = make_test_image(size, seed=seed)
    dys = r.integers(0, 64, B).astype(np.int32)
    dxs = r.integers(0, 64, B).astype(np.int32)
    return codec.stage_wave(base, dys, dxs, size, size)


def config4(report, device="cuda", n_images=4096, wave=256, seams=256,
            size=1024):
    """Batched throughput: size^2 images (1 MP), 25% width reduction
    (1024 -> 768), n_images in waves of `wave` through BatchCarver.

    The device carve rate (the BASELINE metric) against the single-core
    CPU reference's rate on the same per-image work, bit-exactness checked
    on one image of a 4-image wave. The host synthesis of each wave
    (codec.stage_wave) runs on one worker thread, two waves ahead of the
    carve; the copy of a wave to the card (BatchCarver's state) runs on
    the main thread, synchronized, outside every carve's timer."""
    from . import native
    from .core.state import resolve_device
    from .parallel import BatchCarver
    from .utils import codec

    dev = resolve_device(device)

    bc = BatchCarver(make_wave(10_000, wave, size), device=dev)   # warm-up
    bc.carve(seams)
    sync(dev)
    del bc

    frs0 = make_wave(0, 4, size)
    bc0 = BatchCarver(frs0, device=dev)
    bc0.carve(seams)
    vs_ref = native.carve(frs0[1], seams)
    exact = bool(np.array_equal(bc0.state.vs[1, :, :size].cpu().numpy(),
                                vs_ref))
    del bc0

    waves = max(1, n_images // wave)
    done, carve_s, stage_s, launches = 0, 0.0, [], {}
    ex = ThreadPoolExecutor(1)
    try:
        t_all = time.perf_counter()
        futs = deque(ex.submit(make_wave, wv, wave, size)
                     for wv in range(min(2, waves)))
        next_wv = len(futs)
        for _ in range(waves):
            arr = futs.popleft().result()
            if next_wv < waves:
                futs.append(ex.submit(make_wave, next_wv, wave, size))
                next_wv += 1
            t0 = time.perf_counter()
            bc = BatchCarver(arr, device=dev)    # the copy to the card
            sync(dev)
            t1 = time.perf_counter()
            _, lc = launches_of(lambda: bc.carve(seams))
            sync(dev)
            carve_s += time.perf_counter() - t1
            stage_s.append(t1 - t0)
            for k, v in lc.items():
                launches[k] = launches.get(k, 0) + v
            done += len(arr)
            del bc, arr
        wall = time.perf_counter() - t_all
    finally:
        ex.shutdown(cancel_futures=True)

    t_cpu = min(native.bench(frs0[1], seams) for _ in range(2))
    cpu_rate = seams / t_cpu

    # the non-carve wall, priced directly: one wave's host synthesis and
    # one plain copy of the built buffer to the card
    r = np.random.default_rng(99)
    base = make_test_image(size, seed=99)
    t0 = time.perf_counter()
    arr = codec.stage_wave(base, r.integers(0, 64, wave).astype(np.int32),
                           r.integers(0, 64, wave).astype(np.int32),
                           size, size)
    t_synth = time.perf_counter() - t0
    import torch
    host = torch.from_numpy(arr)
    sync(dev)
    t0 = time.perf_counter()
    on_dev = host.to(dev)
    sync(dev)
    t_h2d = time.perf_counter() - t0
    del on_dev

    rate = done * seams / carve_s
    report(NAMES[4], rate, "img_seams/s", rate / cpu_rate, dev,
           bit_exact=exact, meets_50x_target=bool(rate / cpu_rate >= 50),
           images=done, waves=waves,
           images_per_s_device=done / carve_s, carve_s=carve_s,
           end_to_end_wall_s=wall,
           cpu_single_core_img_seams_per_s=cpu_rate,
           host_synth_s_per_wave=t_synth, h2d_s_per_wave=t_h2d,
           stage_s_per_wave=statistics.median(stage_s),
           wave_mb=arr.nbytes / 1e6, launches=launches)


def config5(report, device="cuda", n_frames=300, h=360, w=640, top=160):
    """GAP animation: an n_frames keyframed schedule from w to w - top
    columns (GAP's per-frame counts), per-frame seam maps through one
    BatchCarver; the device carve rate against the CPU reference's carve
    rate, bit-exactness on the deepest frame."""
    from . import native
    from .config import LqrConfig
    from .core.state import resolve_device
    from .gap import schedule
    from .parallel import BatchCarver
    from .parallel.batch import materialize_batched
    from .utils import codec

    dev = resolve_device(device)
    base = _crop(h, w)
    ii = np.arange(n_frames, dtype=np.int32)
    frames = codec.stage_wave(base, ii, 2 * ii, h, w)    # [N, h, w, 3]
    cfg_from = LqrConfig(new_width=w, new_height=h)       # identity
    cfg_to = LqrConfig(new_width=w - top, new_height=h)
    widths = np.asarray([c.new_width for c in
                         schedule(cfg_from, cfg_to, n_frames)], np.int64)
    counts = w - widths

    def run(frs):
        """(stage s, carve s, materialize s, launches of the carve)."""
        t0 = time.perf_counter()
        bc = BatchCarver(frs, device=dev)
        sync(dev)
        t1 = time.perf_counter()
        _, launches = launches_of(lambda: bc.carve(counts))
        sync(dev)
        t2 = time.perf_counter()
        materialize_batched(bc.cfg, bc.state, widths, bc.cfg.Wb)
        sync(dev)
        t3 = time.perf_counter()
        return t1 - t0, t2 - t1, t3 - t2, launches

    run(codec.stage_wave(base, 7 * ii + 3, 3 * ii + 1, h, w))   # warm-up
    runs = [run(codec.stage_wave(base, ii + 5 * s, 2 * ii + 3 * s, h, w))
            for s in (1, 2, 3)]
    stage_s, carve_s, mat_s = (statistics.median(r[k] for r in runs)
                               for k in range(3))
    dt = stage_s + carve_s + mat_s

    probe = int(counts[-1])                     # the deepest frame
    t_cpu = min(native.bench(frames[-1], probe) for _ in range(2))
    cpu_total = t_cpu / probe * float(counts.sum())
    bc = BatchCarver([frames[-1]], device=dev)
    bc.carve(np.asarray([probe]))
    exact = bool(np.array_equal(bc.state.vs[0, :, :w].cpu().numpy(),
                                native.carve(frames[-1], probe)))

    # the device CARVE rate against the CPU reference's carve rate (the CPU
    # baseline neither stages frames nor materializes); the end-to-end
    # wall and its parts are reported beside it
    carve_rate = float(counts.sum()) / carve_s
    cpu_rate = float(counts.sum()) / cpu_total
    report(NAMES[5], carve_rate, "img_seams/s", carve_rate / cpu_rate, dev,
           bit_exact=exact, meets_50x_target=bool(carve_rate / cpu_rate
                                                  >= 50),
           total_seams=int(counts.sum()),
           frames_per_s_end_to_end=n_frames / dt, end_to_end_wall_s=dt,
           stage_s=stage_s, carve_s=carve_s, materialize_s=mat_s,
           carve_runs_s=[r[1] for r in runs],
           frames_mb=frames.nbytes / 1e6,
           staging_mb_per_s=frames.nbytes / 1e6 / stage_s,
           cpu_single_core_wall_s=cpu_total, launches=runs[-1][3])


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}


def emit(payload: dict) -> None:
    print(json.dumps(payload), flush=True)


def run_config(i: int, report, **kw) -> None:
    """Config i, reporting through report(metric, value, unit,
    vs_baseline, dev, **extra); a failure reports an error line instead
    (value 0, unit "error") and does not raise."""
    t0 = time.perf_counter()
    try:
        CONFIGS[i](report, **kw)
    except Exception as e:  # noqa: BLE001 — record and go on
        report.error(NAMES[i], f"{type(e).__name__}: {str(e)[:300]}")
    sys.stderr.write(f"[bench_all] config{i}: "
                     f"{time.perf_counter() - t0:.1f}s\n")


class Reporter:
    """Prints each config's line as it comes and keeps it."""

    def __init__(self, out=emit):
        self.lines = []
        self._out = out

    def __call__(self, metric, value, unit, vs_baseline, dev, **extra):
        self._add({"metric": metric, "value": float(value), "unit": unit,
                   "vs_baseline": float(vs_baseline),
                   "device": device_info(dev), **extra})

    def error(self, metric, message):
        self._add({"metric": metric, "value": 0.0, "unit": "error",
                   "vs_baseline": 0.0, "error": message})

    def _add(self, payload):
        self.lines.append(payload)
        self._out(payload)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lqr_tpu_torch.bench_all",
        description="the five BASELINE configs on the card, a JSON line "
                    "each")
    ap.add_argument("--config", type=int, default=0, choices=range(6),
                    help="run only config N (1-5); 0 = all")
    ap.add_argument("--quick", action="store_true",
                    help="sample config #4 at 256 images")
    args = ap.parse_args(argv)
    report = Reporter()
    for i in [args.config] if args.config else sorted(CONFIGS):
        kw = {"n_images": 256} if i == 4 and args.quick else {}
        run_config(i, report, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
