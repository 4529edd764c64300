"""The port stands alone: importing lqr_tpu_torch, carving on the CPU,
running its command line (--cpu) file to file, saving and loading a
checkpoint, an interactive session's step, a preview, the mask, dialog
and profiling modules, the oracle, the codec's staging and a tiny CPU run
of the bench and bench_all entry points never import jax or lqr_tpu; the
port exports every name lqr_tpu does; and every public function, class and
method of lqr_tpu has a counterpart in the port or a stated reason (an ast
comparison, so that a new gap shows)."""

import ast
import json
import pathlib
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import json
import sys
import numpy as np
import lqr_tpu_torch
img = (np.arange(12 * 40 * 3) % 251).astype(np.uint8).reshape(12, 40, 3)
c = lqr_tpu_torch.Carver(img, device="cpu")
c.resize(33, 12)
assert c.get_image().shape == (12, 33, 3)
from lqr_tpu_torch.parallel import make_mesh
b = lqr_tpu_torch.BatchCarver([img, img[:9]], device="cpu")
b.carve([2, 3])
s = lqr_tpu_torch.BatchCarver([img], mesh=make_mesh(devices=["cpu"] * 2, data=1))
s.carve(2)
assert (s.state.vs == b.state.vs[:1]).all()
from lqr_tpu_torch import cli, load_carver, save_carver
from lqr_tpu_torch.utils.image_io import load_image, save_image
save_image("in.png", img)
assert cli.main(["in.png", "30", "10", "-o", "out.png", "--cpu"]) == 0
assert load_image("out.png").shape == (10, 30, 3)
save_carver("ck.npz", c)
k = load_carver("ck.npz", device="cpu")
k.resize(30, 12)
c.resize(30, 12)
assert (k.get_image() == c.get_image()).all()
from lqr_tpu_torch import dialog, interactive, masks, profiling
from lqr_tpu_torch.image_model import Image
s = interactive.InteractiveSession(Image.from_array(img), device="cpu")
assert s.set_size(30, 12).layer_by_name("Background").width == 30
assert lqr_tpu_torch.preview(s.image, s.cfg).shape == (12, 30, 4)
from lqr_tpu_torch import bench, bench_all, oracle
from lqr_tpu_torch.utils import codec
rep = bench_all.Reporter(out=lambda payload: None)
bench_all.run_config(1, rep, device="cpu", h=12, w=40, seams=3)
assert rep.lines[0]["bit_exact"] is True, rep.lines
r = bench.measure(size=40, seams=3, ref_seams=2, check_seams=2,
                  device="cpu")
assert r["bit_exact_vs_ref"] is True, r
assert codec.stage_wave(img, [1], [2], 12, 40).shape == (1, 12, 40, 3)
assert oracle.carve_width(img[:, :12], 9).shape == (12, 9, 3)
from lqr_tpu_torch import scaling
from lqr_tpu_torch.parallel import make_process_mesh
print(json.dumps(lqr_tpu_torch.__all__))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "lqr_tpu"))
assert not leaked, leaked
print("ok")
"""


def test_import_and_carve_without_jax(tmp_path):
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    import lqr_tpu
    missing = set(lqr_tpu.__all__) - set(json.loads(lines[-2]))
    assert not missing, missing


def test_no_source_imports_jax_or_lqr_tpu():
    pkg = REPO / "lqr_tpu_torch"
    files = sorted(p for p in pkg.rglob("*.py")
                   if "build" not in p.relative_to(pkg).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "lqr_tpu"), (path, name)


# Public names of lqr_tpu without a namesake in the same module of the
# port: where the counterpart lives ...
COUNTERPARTS = {
    "ops/dp_pallas.py:dp_forward_pallas": "ops/dp_cuda.py:dp_forward",
    "ops/dp_pallas.py:backtrack_pallas": "ops/dp_cuda.py:backtrack",
    "ops/dp_pallas.py:find_seam_pallas": "ops/dp_cuda.py:find_seam",
    "ops/dp_pallas.py:carve_step_pallas": "ops/carve_step.py:carve_step",
    "ops/dp_pallas.py:fused_ok": "ops/carve_step.py:fused_ok",
    "ops/dp_block.py:dp_block_pallas": "ops/dp_block.py:dp_blocked",
    "utils/codec.py:place_mask": "ops/place_mask.py:place_mask",
}
# ... or why none is ported: each stands in ROADMAP.md with its reason
BY_DESIGN = {
    "ops/tune.py:Tune": "ops/tune.py",
    "parallel/batch.py:extend_map_scan_pallas": "extend_map_scan_pallas",
    "profiling.py:Roofline.bound": "Roofline.bound",
    "profiling.py:Stopwatch": "profiling.Stopwatch",
    "profiling.py:Stopwatch.lap": "profiling.Stopwatch",
    "profiling.py:Stopwatch.report": "profiling.Stopwatch",
}


def _public_names(path: pathlib.Path) -> set:
    """Top-level public functions and classes, and the public methods and
    properties of public classes, as "Class.method"."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if (not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
                or node.name.startswith("_")):
            continue
        names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names.update(f"{node.name}.{m.name}" for m in node.body
                         if isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                         and not m.name.startswith("_"))
    return names


def _port_names(rel: str) -> set:
    path = REPO / "lqr_tpu_torch" / rel
    return _public_names(path) if path.exists() else set()


def test_every_public_name_of_lqr_tpu_has_a_counterpart():
    jax_pkg = REPO / "lqr_tpu"
    gaps = set()
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = path.relative_to(jax_pkg).as_posix()
        gaps.update(f"{rel}:{name}" for name in
                    _public_names(path) - _port_names(rel))
    assert gaps == set(COUNTERPARTS) | set(BY_DESIGN), (
        "public names of lqr_tpu without a counterpart in lqr_tpu_torch: "
        f"{sorted(gaps - set(COUNTERPARTS) - set(BY_DESIGN))}; exemptions "
        f"that no longer apply: "
        f"{sorted(set(COUNTERPARTS) | set(BY_DESIGN) - gaps)}")
    for target in COUNTERPARTS.values():
        rel, name = target.split(":")
        assert name in _port_names(rel), target
    roadmap = (REPO / "ROADMAP.md").read_text()
    for word in BY_DESIGN.values():
        assert word in roadmap, word
