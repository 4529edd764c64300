"""Run one cell of the benchmark of lqr_tpu_torch on an NVIDIA GPU.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints the result as one JSON line (the last
line of standard output) and the numbers compared beside their limits (the
last lines of standard error). Exits 2, printing no result, without CUDA
or with fewer cards than the cell asks for, and 3 if JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time


def _process_start() -> float:
    """The wall-clock time at which this process started: its start in
    clock ticks after boot (/proc/self/stat) against the boot clock; the
    time now where that cannot be read."""
    now = time.time()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return now
    return now - age if 0 <= age < 600 else now


T_START = _process_start()
ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # the benchmark's package and the program import from the checkout's
    # root, not from this script's folder
    sys.path[0] = str(ROOT)
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    from benchmark import harness
    chips = harness.find_cell(bench, args.workload)["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    result = harness.run_cell(
        bench=bench, workload=args.workload, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), t_start=T_START, root=ROOT)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
