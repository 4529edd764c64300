#!/usr/bin/env python3
"""Where the resident kernel's time goes, phase by phase, on the card.

    python3 tools/resident_phases.py

Builds the kernels once more with -DLQR_RESIDENT_PHASES into
lqr_tpu_torch/build/phases/, where block 0 of the resident kernel sums the
nanoseconds of each phase of each seam on the device's global timer: the
energy pass, the DP, the start column and the chase, the record and the
compaction (each up to the cluster barrier that ends it). Prints the
microseconds per seam of each phase for the solo entry (cfg2's 128-seam
chunk, cfg1's, a 2048x2048 chunk) and for the batched entry at the cfg4
wave's shape (256 maps of 1024x1024, chip_smoke.CFG4_KC seams) and at a
wave of 16 such maps (a 128-seam chunk) at the cluster the entry picks and
at one block a map (map 0's first block), with the launch's time beside
them.
"""

from __future__ import annotations

import ctypes
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from lqr_tpu_torch.core import engine  # noqa: E402
from lqr_tpu_torch.core.energy import reader_plane  # noqa: E402
from lqr_tpu_torch.core.state import EngineConfig, init_state  # noqa: E402
from lqr_tpu_torch.ops import _build  # noqa: E402
from lqr_tpu_torch.ops import carve_resident as cr  # noqa: E402

PHASES = ("energy", "DP", "start+chase", "compaction")


def load_phases() -> ctypes.CDLL:
    """The kernels built with -DLQR_RESIDENT_PHASES (once, into
    lqr_tpu_torch/build/phases/), bound like the default library and with
    the phase counters' reader."""
    so = _build.build(_build.BUILD / "phases" / "liblqr_phases.so",
                      ("-DLQR_RESIDENT_PHASES",))
    lib = _build.bind(ctypes.CDLL(str(so)))
    lib.lqr_resident_phases.restype = ctypes.c_int
    lib.lqr_resident_phases.argtypes = [ctypes.c_void_p]
    return lib


def measure(lib: ctypes.CDLL, fn, seams: int):
    """(ms of one launch of fn, us per seam of each of PHASES in it): fn
    launches the resident kernel from lib (inside _build.using(lib))."""
    out = (ctypes.c_ulonglong * len(PHASES))()
    fn()                                        # warm-up
    torch.cuda.synchronize()
    _build.check(lib, lib.lqr_resident_phases(out), "phases")   # zeroes
    ms = smoke._cuda_ms(fn, 1, warm=False)
    _build.check(lib, lib.lqr_resident_phases(out), "phases")
    return ms, [v / 1e3 / seams for v in out]


def main() -> int:
    if not torch.cuda.is_available():
        print("resident_phases: needs a CUDA device", file=sys.stderr)
        return 1
    lib = load_phases()
    dev = torch.device("cuda", 0)

    def report(label, fn, seams):
        with _build.using(lib):
            ms, per = measure(lib, fn, seams)
        print(f"{label}: {ms:.3f} ms a launch; us/seam "
              + ", ".join(f"{n} {v:.2f}" for n, v in zip(PHASES, per))
              + f" (sum {sum(per):.2f}) on {torch.cuda.get_device_name(0)}",
              flush=True)

    c2 = smoke.cfg2_inputs()
    for label, hw, bias, rig in (("cfg2 1024x768 bias+rig", smoke.CFG2,
                                  c2["bias"], c2["rig"]),
                                 ("cfg1 512x384", smoke.CFG1, None, None),
                                 ("2048x2048", (2048, 2048), None, None)):
        h, w = hw
        cfg = EngineConfig(H=h, Wb=w, C=3, has_bias=bias is not None,
                           has_rig=rig is not None)
        st = init_state(cfg, smoke.crop_image(hw), bias=bias, rig=rig,
                        device=dev)
        pm = engine._posmap(st.vs, st.ref_w)
        args = (st.cur_b, st.cur_bias, st.cur_rig, pm, w, 0, engine.KC, 1,
                cfg.has_bias, cfg.has_rig, 0, cfg.side_switch_freq,
                engine.KC)
        report(f"solo {label}, {engine.KC} seams",
               lambda: cr.carve_chunk_resident(*args), engine.KC)

    h, w, _, _ = smoke.CFG4
    for B, kc, clusters in ((smoke.CFG4[2], smoke.CFG4_KC, (None,)),
                            (16, engine.KC, (None, cr.ONE_BLOCK))):
        b = reader_plane(torch.from_numpy(smoke.make_test_image(
            w, seed=10)[:h]).to(dev), 0).expand(B, h, w).contiguous()
        pm = torch.arange(w, dtype=torch.int32, device=dev).expand(
            B, h, w).contiguous()
        rigc = torch.zeros((B, 2), device=dev)
        args = (b, None, None, pm, w, 0, kc, h, rigc, 1, False, False, 0, 2,
                engine.KC)
        for cluster in clusters:
            pick = cr.batch_cluster
            if cluster is not None:
                cr.batch_cluster = lambda n, held: cluster
            before = dict(cr.BATCH_BLOCKS)
            try:
                report(f"batched {B} x {w}x{h}, {kc} seams",
                       lambda: cr.carve_chunk_resident_batched(*args), kc)
            finally:
                cr.batch_cluster = pick
            print("  blocks a map: " + ", ".join(
                k for k, v in cr.BATCH_BLOCKS.items() if v > before[k]),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
