"""The port's measuring entry points on the CPU: native.bench,
lqr_tpu_torch.bench (one JSON line, the JAX bench.py's metric and keys, an
error line and exit 0 without CUDA) and each lqr_tpu_torch.bench_all config
at a tiny size (bit-exact against the C++ reference, named as
scripts/bench_all.py names them). The numbers a CPU run prints are no
device metric; the tests read only the keys, the checks and the names."""

import ast
import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from lqr_tpu_torch import bench, bench_all, native

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

# each config at a tiny size; cfg3's spot check covers its whole width map
TINY = {1: {"h": 40, "w": 64, "seams": 8},
        2: {"h": 48, "w": 64, "seams": 8, "cpu_seams": 2},
        3: {"n": 48, "cut": 6, "m": 40, "m_cut": 4, "spot_seams": 24,
            "ref_seams": 2},
        4: {"n_images": 12, "wave": 4, "seams": 8, "size": 48},
        5: {"n_frames": 10, "h": 24, "w": 40, "top": 8}}


def _jax_bench_module():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(out: str) -> list:
    return [json.loads(x) for x in out.strip().splitlines()]


def test_native_bench_times_the_reference():
    img = bench.make_test_image(48)
    secs = native.bench(img, 5)
    assert math.isfinite(secs) and secs > 0
    assert native.bench(img[:, :, 0], 5, delta_x=2, nrg=3) > 0
    with pytest.raises(ValueError):
        native.bench(img, 48)


@pytest.mark.parametrize("n,seed", [(33, 0), (64, 5), (96, 1)])
def test_make_test_image_byte_equal_to_bench_py(n, seed):
    got = bench.make_test_image(n, seed)
    want = _jax_bench_module().make_test_image(n, seed)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_bench_cpu_prints_one_exact_line(capsys):
    assert bench.main(["--device", "cpu", "--size", "96", "--seams", "8",
                       "--ref-seams", "2", "--check-seams", "2"]) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert line["metric"] == "seams_per_sec_96x96_remove8"
    assert line["unit"] == "seams/s"
    assert "error" not in line, line.get("error")
    assert line["bit_exact_vs_ref"] is True and line["mismatch_frac"] == 0
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["cpu_singlecore_seams_per_sec"] > 0
    assert line["per_seam_us"] > 0 and len(line["runs_s"]) == 3
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert line["route"] == "resident" and line["launches"] == {}


def test_bench_without_cuda_prints_an_error_line(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert line["metric"] == "seams_per_sec_2048x2048_remove100"
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "CUDA" in line["error"]
    assert "cpu_singlecore_seams_per_sec" not in line


def test_bench_all_names_match_scripts_bench_all():
    tree = ast.parse((REPO / "scripts" / "bench_all.py").read_text())
    names = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "names"):
            names = ast.literal_eval(node.value)
    assert names == bench_all.NAMES
    assert sorted(bench_all.CONFIGS) == sorted(names)


@pytest.mark.parametrize("i", sorted(TINY))
def test_bench_all_config_tiny_on_cpu(i):
    report = bench_all.Reporter(out=lambda payload: None)
    bench_all.run_config(i, report, device="cpu", **TINY[i])
    (line,) = report.lines
    assert line["metric"] == bench_all.NAMES[i]
    assert "error" not in line, line.get("error")
    assert line["bit_exact"] is True
    for key, v in line.items():
        if key.startswith("bit_exact"):
            assert v is True, key
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["device"]["name"] == "cpu" and line["launches"] == {}
    if i == 3:
        assert line["bit_exact_full_protocol_2048"] is True
        assert line["spot_seams"] == 24
    if i == 4:
        assert line["images"] == 12 and line["waves"] == 3


def test_bench_all_without_cuda_prints_error_lines(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_all.main(["--config", "3"]) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert line["metric"] == bench_all.NAMES[3]
    assert line["value"] == 0.0 and line["unit"] == "error"
    assert "CUDA" in line["error"]


def test_cfg4_stages_waves_with_the_native_codec():
    """A cfg4 wave: rolled copies of one image, the shifts in [0, 64)."""
    arr = bench_all.make_wave(3, 5, 40)
    base = bench.make_test_image(40, seed=3)
    r = np.random.default_rng(3)
    dys, dxs = r.integers(0, 64, 5), r.integers(0, 64, 5)
    for k in range(5):
        np.testing.assert_array_equal(
            arr[k], np.roll(base, (int(dys[k]), int(dxs[k])), axis=(0, 1)))
