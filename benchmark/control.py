"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload NAME --seeds N [N ...]
        [--seconds S]

For each seed, one short run of the cell at its own size whose checked
answers come from the plain reference computed in bfloat16, the precision
below the float32 the configurations state, in the program's place: the
control, whose numbers are the upper readings of the limits (the lower
ones are the benchmark's own runs'). One JSON line a run. The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        t = time.time()
        out = harness.run_cell(
            bench=bench, workload=args.workload, seed=seed,
            seconds=args.seconds, trace=False,
            device=torch.device("cuda", 0), t_start=t, root=ROOT,
            control=torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"],
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
