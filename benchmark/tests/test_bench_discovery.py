"""A configuration, a traffic mix and a metric reader placed in a folder
are found by name, and a cell built of new files alone runs: nothing that
exists has to be edited to add one."""

import json
import time

from benchmark import harness

from .conftest import ROOT, TINY, tiny_folder


def test_found_by_name(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "layer_metrics").mkdir()
    (tmp_path / "configs" / "new-config.json").write_text('{"x": 1}')
    (tmp_path / "traffic" / "new-mix.json").write_text('{"y": 2}')
    (tmp_path / "layer_metrics" / "new_metric.sub.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = {"configs": [{"name": "new-config",
                          "file": "configs/new-config.json"}]}
    assert harness.find_config(bench, "new-config", tmp_path) == {"x": 1}
    assert harness.find_traffic("new-mix", tmp_path) == {"y": 2}
    reader = harness.find_reader("new_metric.sub", "layer_metrics", tmp_path)
    assert reader.read(None) == 42.0


def test_new_cell_from_new_files(tmp_path, bench):
    folder = tiny_folder(tmp_path / "bench")
    # a new traffic mix and a new per-layer metric, as new files beside
    # the benchmark's own (the reader folder is a copy here, so the
    # benchmark's folder is not written)
    mix = dict(TINY["plugin-2048-remove100"], seams=5, pool=2)
    (folder / "traffic" / "plugin-tiny-remove5.json").write_text(
        json.dumps(mix))
    (folder / "layer_metrics").unlink()
    (folder / "layer_metrics").mkdir()
    for p in harness.HERE.joinpath("layer_metrics").glob("*.py"):
        (folder / "layer_metrics" / p.name).write_text(p.read_text())
    (folder / "layer_metrics" / "requests_traced.py").write_text(
        "def read(run):\n"
        "    return None if run.trace is None else "
        "float(len({s.index for s in run.trace.spans}))\n")
    extended = json.loads(json.dumps(bench))
    extended["workloads"].append(
        {"name": "plugin-tiny-remove5", "config": "plugin-defaults",
         "traffic": "plugin-tiny-remove5", "chips": 1, "why": "a test"})
    extended["per_layer"].append(
        {"name": "requests_traced", "unit": "requests", "better": "higher",
         "source": "device_trace", "layer": "carver",
         "moves": "image_ms_p95", "workloads": ["plugin-tiny-remove5"]})
    extended["end_to_end"][2]["workloads"].append("plugin-tiny-remove5")
    extended["per_layer"][0]["workloads"].append("plugin-tiny-remove5")
    # four requests, whatever the window's time holds: the three traced
    # ones and one after them
    out = harness.run_cell(bench=extended, workload="plugin-tiny-remove5",
                           seed=5, seconds=0, trace=True, device="cpu",
                           t_start=time.time(), root=ROOT, folder=folder,
                           requests=4)
    assert out["correct"]
    assert out["metrics"]["requests_traced"]["value"] == 3.0
    assert "carver_host_ms" in out["metrics"]
    out = harness.run_cell(bench=extended, workload="plugin-tiny-remove5",
                           seed=5, seconds=0, trace=False, device="cpu",
                           t_start=time.time(), root=ROOT, folder=folder,
                           requests=4)
    assert set(out["metrics"]) == {"setup_s", "seams_per_s", "image_ms_p95"}


def test_benchmark_json_names_files_that_exist(bench):
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).is_file()
        assert harness.load_json(ROOT / cfg["file"])["name"] == cfg["name"]
    for cell in bench["workloads"]:
        t = harness.find_traffic(cell["traffic"])
        assert (harness.HERE / "drivers" / f"{t['driver']}.py").is_file()
    for m in bench["end_to_end"]:
        assert (harness.HERE / "end_to_end" / f"{m['name']}.py").is_file()
    for m in bench["per_layer"]:
        assert (harness.HERE / "layer_metrics" / f"{m['name']}.py").is_file()
