"""The port stands alone: importing lqr_tpu_torch, carving on the CPU,
running its command line (--cpu) file to file, saving and loading a
checkpoint, an interactive session's step, a preview and the mask, dialog
and profiling modules never import jax or lqr_tpu; and the port exports
every name lqr_tpu does."""

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
