"""Tiny cells for the CPU tests: the benchmark's drivers and readers under
traffic files of the same names at toy sizes."""

from __future__ import annotations

import json
import pathlib
import time

import pytest

from benchmark import harness

ROOT = harness.HERE.parent
TINY = {
    "plugin-2048-remove100": {
        "driver": "carver", "clients": 1, "height": 24, "width": 40,
        "seams": 7, "pool": 3, "masks": [], "check_requests": 2,
        "trace_requests": 3},
    "plugin-2048-bias-remove100": {
        "driver": "carver", "clients": 1, "height": 24, "width": 40,
        "seams": 7, "pool": 3,
        "masks": [{"shape": "ellipse", "area": [0.10, 0.25],
                   "coefficient": "pres_coefficient"},
                  {"shape": "rect", "area": [0.02, 0.06],
                   "coefficient": "disc_coefficient"}],
        "check_requests": 2, "trace_requests": 3},
    "batch-1mp-wave256": {
        "driver": "batch", "clients": 1, "size": 32, "batch": 6,
        "seams": 8, "pool": 2, "check_requests": 1, "check_images": 3,
        "trace_requests": 2},
    "batch-1mp-wave16": {
        "driver": "batch", "clients": 1, "size": 32, "batch": 4,
        "seams": 8, "pool": 3, "check_requests": 2, "check_images": 2,
        "trace_requests": 2},
    "plugin-1024x768-masks-rig-remove100": {
        "driver": "carver", "clients": 1, "height": 24, "width": 40,
        "seams": 7, "pool": 3,
        "masks": [{"shape": "ellipse", "area": [0.10, 0.25],
                   "coefficient": "pres_coefficient"},
                  {"shape": "rect", "area": [0.02, 0.06],
                   "coefficient": "disc_coefficient"}],
        "rigmasks": [{"shape": "rect", "area": [0.20, 0.40]}],
        "check_requests": 2, "trace_requests": 3},
}


@pytest.fixture
def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def tiny_folder(path: pathlib.Path) -> pathlib.Path:
    """A benchmark folder whose traffic files are TINY's and whose drivers
    and readers are the benchmark's own."""
    path.mkdir(parents=True, exist_ok=True)
    for sub in ("drivers", "end_to_end", "layer_metrics"):
        (path / sub).symlink_to(harness.HERE / sub)
    (path / "traffic").mkdir()
    for name, t in TINY.items():
        (path / "traffic" / f"{name}.json").write_text(json.dumps(t))
    return path


@pytest.fixture
def run_tiny(bench, tmp_path):
    folder = tiny_folder(tmp_path / "bench")

    def run(workload: str, seed: int = 2**31 + 11, trace: bool = False,
            device="cpu", seconds: float = 0.3, **kw) -> dict:
        return harness.run_cell(bench=bench, workload=workload, seed=seed,
                                seconds=seconds, trace=trace, device=device,
                                t_start=time.time(), root=ROOT,
                                folder=folder, **kw)
    return run
