"""The port's 'data' mesh over processes (make_process_mesh, a gloo group of
CPU processes) and its measuring program ``python -m lqr_tpu_torch.scaling``.

Two gloo processes share one BatchCarver: their gathered vs maps, depths,
images_at and aux_at are held against a one-process BatchCarver of the
port and the JAX package's BatchCarver on the same ragged, masked batch
(tolerance 0). The exchange counter (sharding.EXCHANGES) reads 0 over a
'data' carve, and on the 'cols' axis the halo exchanges of each seam that
_block_rows predicts. Every subprocess runs under a timeout of its own, in
a session of its own that is killed whole when the timeout passes.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import random_image
from lqr_tpu.parallel import batch as jbatch
from lqr_tpu_torch import LqrConfigError
from lqr_tpu_torch.config import EnergyFunc
from lqr_tpu_torch.parallel import batch as tbatch
from lqr_tpu_torch.parallel import sharding as tshard

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
SIZES = ((30, 50), (24, 60), (30, 40), (20, 64))     # ragged heights
SEAMS = [5, 3, 7, 2]
WIDTHS = [47, 57, 33, 63]             # inside each map's range of widths

_WORKER = """
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from lqr_tpu_torch import LqrConfigError, LqrImageError
from lqr_tpu_torch.parallel import BatchCarver, make_mesh, make_process_mesh
from lqr_tpu_torch.parallel import sharding

rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
inp = np.load(f"{tmp}/inputs.npz")
n = len([k for k in inp.files if k.startswith("img")])
imgs = [inp[f"img{i}"] for i in range(n)]
biases = [inp[f"bias{i}"] if f"bias{i}" in inp.files else None
          for i in range(n)]
aux = [[inp[f"aux{i}"]] for i in range(n)]
widths = list(inp["widths"])
out = {}
try:
    make_process_mesh(data=1, device="cpu")
except LqrConfigError as e:
    out["cols_refused"] = str(e)
mesh = make_process_mesh(device="cpu")
out["local_rows"] = list(mesh.local_rows)
try:
    BatchCarver(imgs[:3], mesh=mesh)
except LqrImageError as e:
    out["indivisible"] = str(e)
try:
    BatchCarver(imgs[:3], mesh=make_mesh(devices=["cpu"] * 2, data=2))
except LqrImageError as e:
    out["indivisible_one_process"] = str(e)
bc = BatchCarver(imgs, biases=biases, rigidity=30.0, aux=aux, mesh=mesh)
before = dict(sharding.EXCHANGES)
bc.carve(list(inp["seams"]))
out["exchanges"] = {k: v - before[k] for k, v in sharding.EXCHANGES.items()}
st = bc.state
got = {"vs": st.vs.numpy(), "cur_b": st.cur_b.numpy(), "depth": st.depth}
for i, im in enumerate(bc.images_at(widths)):
    got[f"out{i}"] = im
for i, (a,) in enumerate(bc.aux_at(widths)):
    got[f"auxout{i}"] = a
np.savez(f"{tmp}/rank{rank}.npz", **got)
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def _run(cmd, **kw):
    """cmd in a session of its own, under TIMEOUT_S: the whole session is
    killed when it is not done by then (a worker that hangs is no
    orphan)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True, **kw)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{cmd} was not done within {TIMEOUT_S} s")
    return proc.returncode, out, err


def _inputs():
    rng = np.random.default_rng(7)
    imgs = [(rng.integers(0, 8, (h, w, 3)) * 32).astype(np.uint8)
            for h, w in SIZES]                        # ties everywhere
    imgs[1] = random_image(rng, *SIZES[1], 3)
    biases = [None, rng.normal(0, 50, SIZES[1]).astype(np.float32), None,
              np.where(rng.random(SIZES[3]) < 0.2, 1000.0, 0.0)
              .astype(np.float32)]
    aux = [[rng.integers(0, 256, (h, w, 2), dtype=np.uint8)]
           for h, w in SIZES]
    return imgs, biases, aux


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Two gloo CPU processes carving one BatchCarver: each rank's gathered
    arrays and its checks."""
    tmp = tmp_path_factory.mktemp("gloo")
    imgs, biases, aux = _inputs()
    arrays = {f"img{i}": im for i, im in enumerate(imgs)}
    arrays.update({f"bias{i}": b for i, b in enumerate(biases)
                   if b is not None})
    arrays.update({f"aux{i}": a[0] for i, a in enumerate(aux)})
    np.savez(tmp / "inputs.npz", seams=np.array(SEAMS),
             widths=np.array(WIDTHS), **arrays)
    init = (tmp / "rendezvous").as_uri()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "2",
                               init, str(tmp)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              start_new_session=True) for r in range(2)]
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=TIMEOUT_S)[1])
        except subprocess.TimeoutExpired:
            for q in procs:
                os.killpg(q.pid, signal.SIGKILL)
                q.communicate()
            pytest.fail(f"a gloo worker was not done within {TIMEOUT_S} s")
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return [(dict(np.load(tmp / f"rank{r}.npz")),
             json.loads((tmp / f"rank{r}.json").read_text()))
            for r in range(2)]


def _carve(carver):
    imgs, biases, aux = _inputs()
    bc = carver(imgs, biases=biases, rigidity=30.0, aux=aux)
    bc.carve(SEAMS)
    return bc


def test_two_processes_equal_one_process_and_jax(two_processes):
    one = _carve(lambda *a, **k: tbatch.BatchCarver(*a, device="cpu", **k))
    jax = _carve(lambda *a, **k: jbatch.BatchCarver(*a, use_pallas=False,
                                                    **k))
    for got, _checks in two_processes:      # every rank holds the whole map
        for ref in (one.state, jax.state):
            np.testing.assert_array_equal(got["vs"], np.asarray(ref.vs))
            np.testing.assert_array_equal(got["cur_b"],
                                          np.asarray(ref.cur_b))
            np.testing.assert_array_equal(got["depth"],
                                          np.asarray(ref.depth))
        for ref in (one, jax):
            for i, (im, (a,)) in enumerate(zip(ref.images_at(WIDTHS),
                                               ref.aux_at(WIDTHS))):
                np.testing.assert_array_equal(got[f"out{i}"], im)
                np.testing.assert_array_equal(got[f"auxout{i}"], a)


def test_process_mesh_rows_and_refusals(two_processes):
    for rank, (_got, checks) in enumerate(two_processes):
        assert checks["local_rows"] == [rank]
        assert "'cols' axis across processes" in checks["cols_refused"]
        assert "two or more" in checks["cols_refused"]
        assert checks["indivisible"] == checks["indivisible_one_process"]
        assert "cannot shard evenly over 2 'data'" in checks["indivisible"]


def test_data_axis_exchanges_nothing(two_processes):
    for _got, checks in two_processes:
        assert checks["exchanges"] == {"halo": 0, "gather": 0, "process": 0}
    imgs, biases, aux = _inputs()
    mesh = tshard.make_mesh(devices=["cpu"] * 2, data=2)
    bc = tbatch.BatchCarver(imgs, biases=biases, aux=aux, mesh=mesh)
    before = dict(tshard.EXCHANGES)
    bc.carve(SEAMS)
    assert tshard.EXCHANGES == before


@pytest.mark.parametrize("n,delta_x,nrg", [(2, 1, 0), (4, 1, 0), (4, 2, 0),
                                           (4, 1, int(EnergyFunc.NULL))])
def test_cols_axis_halo_exchanges_match_block_rows(n, delta_x, nrg):
    rng = np.random.default_rng(n + delta_x)
    h, w, seams = 40, 120, 3
    img = random_image(rng, h, w, 3)
    bc = tbatch.BatchCarver([img], delta_x=delta_x, nrg=nrg,
                            mesh=tshard.make_mesh(devices=["cpu"] * n,
                                                  data=1))
    solo = tbatch.BatchCarver([img], delta_x=delta_x, nrg=nrg, device="cpu")
    R = tshard._block_rows(h, delta_x, bc.cfg.Wb // n)
    before = dict(tshard.EXCHANGES)
    bc.carve(seams)
    got = {k: v - before[k] for k, v in tshard.EXCHANGES.items()}
    energy = 0 if nrg == int(EnergyFunc.NULL) else 2
    # per seam and inner edge: a DP halo each way a block of R rows, the
    # energy's column each way, the compaction's carry
    assert got["halo"] == seams * (n - 1) * (2 * (h // R) + energy + 1)
    # the backtrack's frontier and backpointers, the seam, the commit's
    # counts and prefix
    assert got["gather"] == seams * 5 * (n - 1)
    assert got["process"] == 0
    solo.carve(seams)
    np.testing.assert_array_equal(bc.state.vs.numpy(),
                                  solo.state.vs.numpy())


def test_make_process_mesh_needs_a_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(LqrConfigError, match="init_process_group"):
        tshard.make_process_mesh(device="cpu")


def _lines(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_scaling_program_quick():
    rc, out, err = _run([sys.executable, "-m", "lqr_tpu_torch.scaling",
                         "--devices", "cpu", "--quick"])
    lines = _lines(out)
    assert rc == 0, err[-3000:]
    assert [x["metric"] for x in lines] == [
        "data_parallel_scaling", "multiprocess_gloo_resize",
        "column_sharded_multiseam_resize"]
    for line in lines:
        assert line["bit_exact"] is True and line["ok"] is True, line
    data, multi, cols = lines
    assert data["exchanges_in_carve_loop"] == 0
    assert data["per_device"]["cpu"]["img_seams"] == 4 * 8
    assert [w["rank"] for w in multi["workers"]] == [0, 1]
    assert all(w["device"] == "cpu" and w["exchanges_in_carve_loop"] == 0
               and w["img_seams"] == 2 * 8 for w in multi["workers"])
    assert cols["halo_exchanges_per_seam"] == cols["halo_exchanges_predicted"]
    assert cols["dp_route"] == "blocks"


def test_scaling_program_fails_with_a_worker():
    """Three workers cannot split the quick batch of 4: they fail, and so
    does the program, though its other lines pass."""
    rc, out, _err = _run([sys.executable, "-m", "lqr_tpu_torch.scaling",
                          "--devices", "cpu", "--quick", "--procs", "3"])
    assert rc != 0
    lines = {x["metric"]: x for x in _lines(out)}
    multi = lines["multiprocess_gloo_resize"]
    assert multi["ok"] is False and "worker" in multi["error"]
    assert "cannot shard evenly over 3" in multi["error"]
    assert lines["data_parallel_scaling"]["ok"] is True


def test_scaling_program_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("the card is here: the default run is the full one")
    rc, out, err = _run([sys.executable, "-m", "lqr_tpu_torch.scaling",
                         "--quick"])
    assert rc == 1 and out == "" and "CUDA" in err
