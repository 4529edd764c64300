"""One run of one cell: set-up, the measured window, the metrics, the check.

Everything cell-specific is found by name under the benchmark's folder:
``configs/<config>.json``, ``traffic/<traffic>.json``, the module of
the program entry the traffic names (``drivers/<name>.py``, its
``Client``), and one reader a metric
(``end_to_end/<name>.py``, ``layer_metrics/<name>.py``), each a module with
``read(run) -> float | None``. A reader that finds nothing returns None and
the metric is left out of the line.

The window is a closed loop with one client: a request starts when the
previous one's result is in host memory. Requests start while the window
is open; it closes when the last of them has finished, so a rate covers
all the work and all the time of the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
import time
import traceback

import numpy as np

from . import device_trace
from .reference import compare

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lqr_tpu")


# -- discovery by name ------------------------------------------------------

def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def find_config(bench: dict, name: str, root: pathlib.Path) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return load_json(root / cfg["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def find_traffic(name: str, folder: pathlib.Path = HERE) -> dict:
    return load_json(folder / "traffic" / f"{name}.json")


def find_driver(name: str, folder: pathlib.Path = HERE):
    return _module(folder / "drivers" / f"{name}.py", f"driver_{name}")


def find_reader(name: str, kind: str, folder: pathlib.Path = HERE):
    """The reader of metric `name`; kind is "end_to_end" or
    "layer_metrics"."""
    return _module(folder / kind / f"{name}.py", f"{kind}_{name}")


def _module(path: pathlib.Path, name: str):
    key = "benchmark._found." + name.replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, workload: str, kind: str) -> list[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that the cell
    reports: those without a workloads list, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# -- the run record ----------------------------------------------------------

@dataclasses.dataclass
class Request:
    index: int
    seams: int        # seams removed: images x seams for a wave
    ops: int          # the carve's least work (work.carve_work)
    nbytes: int
    start: float      # host clock, s
    end: float


@dataclasses.dataclass
class Run:
    """What the readers read."""
    setup_s: float
    window_s: float
    requests: list[Request]
    spans: list[device_trace.Span]      # host clock, ns; traced runs
    trace: device_trace.Trace | None    # traced runs
    device_name: str


class Spans:
    """The benchmark's host spans around its calls into the program. Off
    (no cost) in an untraced run; in a traced one each span synchronizes
    the device at both ends and is marked for the profiler."""

    def __init__(self, sync=None):
        self.sync = sync
        self.records: list[device_trace.Span] = []

    @contextlib.contextmanager
    def __call__(self, name: str, index: int):
        if self.sync is None:
            yield
            return
        import torch
        self.sync()
        with torch.profiler.record_function(
                device_trace.span_name(name, index)):
            t0 = time.perf_counter_ns()
            yield
            self.sync()
            t1 = time.perf_counter_ns()
        self.records.append(device_trace.Span(name, index, t0, t1))


def _reservoir(kept: list, item, seen: int, k: int,
               rng: np.random.Generator) -> None:
    """Keep a uniform sample of k of the items seen so far (Algorithm R)."""
    if len(kept) < k:
        kept.append(item)
        return
    j = int(rng.integers(0, seen))
    if j < k:
        kept[j] = item


def run_cell(*, bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, root: pathlib.Path,
             folder: pathlib.Path = HERE, patch=None,
             control=None, requests: int | None = None) -> dict:
    """One run of the cell; returns the result line's object.

    patch: a callable run after set-up and before the window (the tests'
    faults in the timed path); control: a dtype in which the plain
    reference stands in for the program's answers (the control);
    requests: the least number of requests the window starts before it
    closes (the tests' fixed amount of work; the benchmark's runs close
    the window by time alone)."""
    import torch
    cell = find_cell(bench, workload)
    config = find_config(bench, cell["config"], root)
    traffic = find_traffic(cell["traffic"], folder)
    driver = find_driver(traffic["driver"], folder)
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError("the harness drives one client, closed loop")
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)

    client = driver.Client(config, traffic, seed, device)
    client.request(-1, Spans())            # warm every shape the cell uses
    sync()
    if patch is not None:
        patch()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    # the set-up's objects leave the collector's scans, so its passes in
    # the window cost what the window's own objects cost
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start

    spans = Spans(sync if trace else None)
    rng = np.random.default_rng([seed % (1 << 63), 7])
    n_check = int(traffic["check_requests"])
    n_trace = int(traffic.get("trace_requests", 0))
    kept, done_requests, failed = [], [], 0
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    i = 0
    least = 0 if requests is None else int(requests)
    while time.perf_counter() - t0 < seconds or i < least:
        start = time.perf_counter()
        try:
            done = client.request(i, spans)
        except Exception:     # a request that never comes: counted, shown
            traceback.print_exc()
            failed += 1
            done = None
        end = time.perf_counter()
        if done is not None:
            seams, ops, nbytes, keep = done
            done_requests.append(Request(i, seams, ops, nbytes, start,
                                         end))
            _reservoir(kept, (i, keep), len(done_requests), n_check, rng)
        i += 1
        if prof is not None and i == n_trace:
            prof.stop()
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    if prof is not None and i < n_trace:
        prof.stop()
    sync()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # the readers take the traced requests' spans on the profiler's clock
    # from tr, and every request's host spans (the medians) from spans
    tr = None if prof is None else device_trace.from_profiler(prof)
    del prof
    if tr is not None:
        print(f"benchmark: trace: {len(tr.events)} device events, "
              f"{sum(e.launch_ns is not None for e in tr.events)} tied to "
              f"their launch; {len(tr.spans)} spans", file=sys.stderr)

    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = Run(setup_s, window_s, done_requests, spans.records, tr, name)

    # the check: the program's state is freed, then the reference runs
    frozen = [a for i, keep in kept for a in client.freeze(i, keep)]
    del kept, client
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = compare.check(config, frozen, device, control)
    print(f"benchmark: {workload}: set-up {setup_s:.3f} s, window "
          f"{window_s:.3f} s, {len(done_requests)} requests ({failed} "
          f"failed), check of {len(frozen)} images "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = (failed == 0 and len(done_requests) > 0
               and compare.passes(numbers))

    kind = "per_layer" if trace else "end_to_end"
    folder_kind = "layer_metrics" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, workload, kind):
        value = find_reader(m["name"], folder_kind, folder).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct),
           "attempted": len(done_requests) + failed,
           "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None and tr.spans:
        dev["busy_s"] = device_trace.busy_s(tr)
        dev["window_s"] = tr.window_s
        out["breakdown"] = device_trace.breakdown(tr)
    out["checks"] = compare.as_line(numbers)
    return out

