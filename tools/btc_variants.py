#!/usr/bin/env python3
"""Time source variants of backtrack_compact (csrc/carve_step.cu) at 2048^2.

    python3 tools/btc_variants.py [ROUNDS]

Each variant is a text substitution of this checkout's carve_step.cu,
compiled with the package's nvcc flags beside the other sources' objects
(built once) into a library of its own, loaded with ``_build.using``. Each
is timed on the fused loop's first step (2048x2048, delta_x 1: M_last and
bp from dp_energy_forward) without and with a bias and a rigidity plane
(CUDA events, the mean of 200 launches), ROUNDS rounds in turns (default
3); before that, each variant that is a correct kernel is held against the
plain version (tolerance 0). Needs the CUDA toolkit and a card.

  shipped         the source as it is: the chasing warp hands each window
                  to a publisher warp, which fences and stores the progress
  chaser_fence    the chasing warp fences (__threadfence) and stores the
                  progress word itself after each window, no publisher
  chaser_fence_4  the same, after every 4th window (128 rows) and the last
  no_fence        chaser_fence with a relaxed store and no fence: not a
                  correct kernel; what the fence costs
  after_chase     the chase hands off only its last row: every band is
                  compacted after the chase
  no_compaction   the bands wait and compact nothing: not a correct
                  kernel; the chase alone inside this kernel
  seg2048, seg256, seg128   kSeg, the columns of a band's segment
"""

from __future__ import annotations

import ctypes
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from lqr_tpu_torch.ops import _build  # noqa: E402

ROWS_FROM = "  __device__ __forceinline__ void rows_from(int y, int lane)"
HANDOFF = ROWS_FROM + """ const {
    __syncwarp();
    __threadfence_block();
    if (lane == 0) *rows = max(y, 0);
  }"""
SETUP = """      Handoff pub;
      pub.rows = &s_rows;
"""
PUBLISHER = "      publish(&s_rows, progress, tag, H, lane);"
SEG = "constexpr int kSeg = 512;"
COMPACT = """    compact_row<kVec>(b, b_out, y, s, Wb, w, c0, c1, lane);
    if (bias) compact_row<kVec>(bias, bias_out, y, s, Wb, w, c0, c1, lane);
    if (rig) compact_row<kVec>(rig, rig_out, y, s, Wb, w, c0, c1, lane);
"""


def chaser_fence(src: str, every: int = 0, fence: bool = True) -> str:
    """The chasing warp publishes itself (every `every` rows, 0: each
    window); without `fence`, a relaxed store."""
    store = ("st_release(progress, tag | (unsigned)(H - max(y, 0)))"
             if fence else
             'asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: '
             '"l"(progress), "l"(tag | (unsigned)(H - max(y, 0))) : '
             '"memory")')
    body = (f"  unsigned long long* progress;\n  unsigned long long tag;\n"
            f"  int H;\n  int last = 1 << 30;\n"
            + ROWS_FROM + " {\n"
            + (f"    if (y > 0 && last - y < {every}) return;\n"
               f"    last = y;\n" if every else "")
            + "    __syncwarp();\n"
            + ("    __threadfence();\n" if fence else "")
            + f"    if (lane == 0) {store};\n  }}")
    return (src.replace(HANDOFF, body)
            .replace(SETUP, SETUP + "      pub.progress = progress;\n"
                     "      pub.tag = tag;\n      pub.H = H;\n")
            .replace(PUBLISHER, "      ;"))


def variants(src: str) -> dict:
    for part in (HANDOFF, SETUP, PUBLISHER, SEG, COMPACT):
        assert part in src, part
    return {
        "shipped": src,
        "chaser_fence": chaser_fence(src),
        "chaser_fence_4": chaser_fence(src, every=128),
        "no_fence": chaser_fence(src, fence=False),
        "after_chase": src.replace(
            HANDOFF, HANDOFF.replace("    __syncwarp();",
                                     "    if (y > 0) return;\n"
                                     "    __syncwarp();")),
        "no_compaction": src.replace(COMPACT, "    if (s == -12345) {\n"
                                     + COMPACT + "    }\n"),
        "seg2048": src.replace(SEG, "constexpr int kSeg = 2048;"),
        "seg256": src.replace(SEG, "constexpr int kSeg = 256;"),
        "seg128": src.replace(SEG, "constexpr int kSeg = 128;"),
    }


def build(tmp: pathlib.Path) -> dict:
    """{variant: bound library}."""
    nvcc = _build._nvcc()
    others = [s for s in _build.SOURCES if s.name != "carve_step.cu"]
    cmds = [[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(tmp / f"{s.stem}.o"),
             str(s)] for s in others]
    srcs = variants((_build.CSRC / "carve_step.cu").read_text())
    made = []
    try:
        for name, text in srcs.items():
            # beside chase.cuh, which it includes
            path = _build.CSRC / f"_variant_{name}.cu"
            path.write_text(text)
            made.append(path)
            cmds.append([nvcc, *_build.NVCC_FLAGS, "-c", "-o",
                         str(tmp / f"v_{name}.o"), str(path)])
        _build._run(cmds)
    finally:
        for path in made:
            path.unlink()
    _build._run([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                  str(tmp / f"lib_{name}.so"),
                  *[str(tmp / f"{s.stem}.o") for s in others],
                  str(tmp / f"v_{name}.o")] for name in srcs])
    return {name: _build.bind(ctypes.CDLL(str(tmp / f"lib_{name}.so")))
            for name in srcs}


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    import chip_smoke as smoke
    from lqr_tpu_torch.core.energy import reader_plane
    from lqr_tpu_torch.ops import carve_step as cs

    if not torch.cuda.is_available():
        print("btc_variants: needs a CUDA device", file=sys.stderr)
        return 1
    rounds = int(argv[0]) if argv else 3
    dev = torch.device("cuda", 0)
    n = smoke.N
    b = reader_plane(torch.from_numpy(smoke.make_test_image(n)).to(dev), 0)
    rng = np.random.default_rng(8)
    bias, rig = (torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in rng.integers(0, 8, (2, n, n)) / 8)
    _build.load()
    M, bp = cs.dp_energy_forward(b, None, None, n, True, 1, False, False, 0)
    cases = {"no masks": (M, bp, b, None, None, n, True, False, False),
             "bias+rig": (M, bp, b, bias, rig, n, True, True, True)}
    gpu = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for name, lib in libs.items():
            if name in ("no_fence", "no_compaction"):
                continue
            with _build.using(lib):
                for args in cases.values():
                    got = cs.backtrack_compact(*args)
                    want = cs.backtrack_compact_plain(*args)
                    if not all(torch.equal(g, e) for g, e in zip(got, want)
                               if g is not None):
                        print(f"{name}: differs from the plain version")
                        return 1
        for r in range(rounds):
            for name, lib in libs.items():
                with _build.using(lib):
                    ms = [smoke._cuda_ms(
                        lambda: cs.backtrack_compact(*args), 200)
                        for args in cases.values()]
                print(f"round {r} {name}: {ms[0]:.4f} ms, with bias and rig "
                      f"{ms[1]:.4f} ms on {gpu}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
