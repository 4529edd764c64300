"""The measuring command: it loads nothing of JAX or the JAX package
(top-level names compared whole), and it fails, printing no result and
falling back to nothing, where there is no card."""

import os
import pathlib
import shutil
import subprocess
import sys

from benchmark import harness

from .conftest import ROOT

CHECK = """
import json, sys, time, pathlib
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.tests.conftest import tiny_folder
bench = harness.load_json(pathlib.Path({root!r}) / "BENCHMARK.json")
folder = tiny_folder(pathlib.Path({tmp!r}))
for wl in [c["name"] for c in bench["workloads"]]:
    out = harness.run_cell(bench=bench, workload=wl, seed=3, seconds=0.2,
                           trace=True, device="cpu", t_start=time.time(),
                           root=pathlib.Path({root!r}), folder=folder)
    assert out["correct"], out
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_runs_load_no_jax(tmp_path):
    """Every cell, run end to end at a toy size in a fresh interpreter,
    loads no module whose top-level name is jax, jaxlib, flax or lqr_tpu
    (lqr_tpu_torch, which begins with it, is the program)."""
    code = CHECK.format(root=str(ROOT), tmp=str(tmp_path / "b"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(__import__("json").loads(res.stdout.strip().splitlines()[-1]))
    assert "lqr_tpu_torch" in top and "torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    fake = type(sys)("fake")
    for name in ("lqr_tpu_torch.fake", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lqr_tpu.carver", fake)
    monkeypatch.setitem(sys.modules, "jax", fake)
    assert harness.forbidden_modules() == ["jax", "lqr_tpu.carver"]


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "plugin-2048-remove100", "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _command(ROOT, env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_benchmark_alone_no_result(tmp_path):
    """In a folder holding only BENCHMARK.json and the benchmark's files
    (no program), the command exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _command(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert not (tmp_path / "lqr_tpu_torch").exists()
    assert pathlib.Path(tmp_path / "benchmark" / "run.py").is_file()
