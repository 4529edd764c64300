"""Scaling checks of the port's meshes, the counterpart of the JAX package's
``scripts/scaling.py``.

    python -m lqr_tpu_torch.scaling [--devices cuda|cpu] [--quick]
        [--procs 2]

Prints one JSON line per measurement and exits 1 when a line is not
bit-exact, a counter reads other than the design says, or a worker fails:
unlike ``bench``, this program is a check.

- ``data_parallel_scaling``: ``BatchCarver`` on a one-process mesh of ROWS
  'data' rows of the device (on one card, the card repeated) against no
  mesh: both walls (the median of 3 synchronized carves, each of a fresh
  carver, after a warm-up), bit-exact vs maps, ``exchanges_in_carve_loop``
  (``sharding.EXCHANGES`` over the mesh's carve, which must be 0: the
  'data' axis exchanges nothing) and the device's kernel launches and
  image-seams.
- ``multiprocess_gloo_resize``: --procs worker processes (``python -m
  lqr_tpu_torch.scaling --worker RANK WORLD INIT``) in one gloo group,
  initialized through a file in a fresh temporary directory. Each carves
  its 'data' row of the same batch on its device (on a one-card machine
  every worker on cuda:0), after a barrier; the rows are all-gathered and
  rank 0 holds the vs maps against a one-process ``BatchCarver``. A worker
  that fails, or is not done within WORKER_TIMEOUT_S, fails the line.
- ``column_sharded_multiseam_resize``: ``BatchCarver`` on SHARDS column
  shards of the device (``extend_map_sharded``): ms/seam, the launches a
  seam, the DP's block rows R and the halo exchanges a seam against the
  design's (SHARDS - 1) * (2 * H / R + 3) (each block of R rows a halo each
  way at each inner edge, the energy's column each way, the compaction's
  carry), bit-exact against the unsharded resize.

Sizes: the data lines carve one cfg4 wave (256 images of 1024x1024, 256
seams; 128 images a row or a process), the column line 2048x2048, 100
seams; --quick takes small ones for the CPU. Parts 1 and 2 of
scripts/scaling.py (the collectives of the compiled HLO, XLA's cost model)
have no PyTorch counterpart; the exchange counter stands for the audit.
Rows or processes that share one card timeshare it: their walls are no
scaling efficiency. The device is the card unless ``--devices cpu`` is
given; without CUDA the program exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .bench import device_info, launches_of, make_test_image, sync
from .bench_all import make_wave
from .core.state import resolve_device
from .errors import LqrConfigError
from .parallel import sharding
from .parallel.batch import BatchCarver
from .parallel.sharding import make_mesh, make_process_mesh

ROWS = 2          # 'data' rows of the one-process mesh
SHARDS = 4        # column shards of the column line
WORKER_TIMEOUT_S = 300
FULL = {"images": 256, "size": 1024, "seams": 256, "col_hw": (2048, 2048),
        "col_seams": 100}
QUICK = {"images": 4, "size": 64, "seams": 8, "col_hw": (40, 128),
         "col_seams": 6}
WALL_NOTE = ("the rows (or processes) share one device and timeshare it: "
             "these walls are not a scaling efficiency")


def _exchanges_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in sharding.EXCHANGES.items()}


def timed_carves(make, seams, device, runs: int = 3):
    """``runs`` synchronized carves of ``seams``, each of a fresh carver from
    make() built outside the timed window, after one warm-up. Returns (the
    median s, every run, the launches and exchanges of the last, the last
    carver)."""
    secs = []
    for i in range(runs + 1):
        bc = make()
        sync(device)
        before = dict(sharding.EXCHANGES)
        t0 = time.perf_counter()
        _, launches = launches_of(lambda: bc.carve(seams))
        sync(device)
        if i:
            secs.append(time.perf_counter() - t0)
        exchanges = _exchanges_since(before)
    return statistics.median(secs), secs, launches, exchanges, bc


def _same_map(a, b) -> bool:
    return (torch.equal(a.vs.cpu(), b.vs.cpu())
            and np.array_equal(a.depth, b.depth))


def data_parallel_scaling(device, sz: dict) -> dict:
    """The 'data' axis in one process: ROWS rows of ``device``."""
    B, seams = sz["images"], sz["seams"]
    wave = make_wave(0, B, sz["size"])
    t_solo, runs_solo, l_solo, _, solo = timed_carves(
        lambda: BatchCarver(wave, device=device), seams, device)
    mesh = make_mesh(devices=[device] * ROWS, data=ROWS)
    t_mesh, runs_mesh, l_mesh, ex, bc = timed_carves(
        lambda: BatchCarver(wave, mesh=mesh), seams, device)
    st = bc.state
    exact = _same_map(st, solo.state)
    moved = sum(ex.values())
    img_seams = int(st.depth.sum())
    return {
        "metric": "data_parallel_scaling", "value": img_seams / t_mesh,
        "unit": f"img_seams_per_sec_mesh_of_{ROWS}_data_rows",
        "vs_baseline": None, "device": device_info(device),
        "images": B, "size": f"{sz['size']}x{sz['size']}", "seams": seams,
        "rows": ROWS, "wall_unsharded_s": t_solo, "wall_sharded_s": t_mesh,
        "runs_unsharded_s": runs_solo, "runs_sharded_s": runs_mesh,
        "launches_unsharded": l_solo,
        "per_device": {str(device): {
            "rows": ROWS, "launches": l_mesh, "img_seams": img_seams,
            "img_seams_per_row": [
                int(st.depth[d * B // ROWS:(d + 1) * B // ROWS].sum())
                for d in range(ROWS)]}},
        "exchanges_in_carve_loop": moved,
        "bit_exact": exact,
        "ok": exact and moved == 0, "wall_note": WALL_NOTE}


def run_worker(rank: int, world: int, init: str, kind: str,
               quick: bool) -> int:
    """One process of multiprocess_gloo_resize: its row of the batch on its
    device; prints one JSON line."""
    sz = QUICK if quick else FULL
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=WORKER_TIMEOUT_S))
    try:
        mesh = make_process_mesh(device="cpu" if kind == "cpu" else None)
        dev = mesh.devices[mesh.local_rows[0]][0]
        wave = make_wave(0, sz["images"], sz["size"])
        BatchCarver(wave, mesh=mesh).carve(sz["seams"])      # warm-up
        bc = BatchCarver(wave, mesh=mesh)
        sync(dev)
        dist.barrier()
        before = dict(sharding.EXCHANGES)
        t0 = time.perf_counter()
        _, launches = launches_of(lambda: bc.carve(sz["seams"]))
        sync(dev)
        wall = time.perf_counter() - t0
        moved = sum(_exchanges_since(before).values())
        t0 = time.perf_counter()
        st = bc.state
        sync(dev)
        Bd = len(wave) // world
        d = mesh.local_rows[0]
        out = {"rank": rank, "device": str(dev), "images": Bd,
               "img_seams": int(st.depth[d * Bd:(d + 1) * Bd].sum()),
               "wall_s": wall, "launches": launches,
               "exchanges_in_carve_loop": moved,
               "gather_s": time.perf_counter() - t0}
        if rank == 0:
            solo = BatchCarver(wave, device=dev)
            solo.carve(sz["seams"])
            out["bit_exact"] = _same_map(st, solo.state)
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _wait(procs, timeout: float) -> None:
    """Wait for every worker; on the first failure, or at the timeout, kill
    the rest and raise RuntimeError."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
        late = time.monotonic() > deadline
        if failed or late or all(c == 0 for c in codes):
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed:
        raise RuntimeError(f"worker {failed[0]} exited "
                           f"{procs[failed[0]].returncode}")
    if late:
        raise RuntimeError(f"a worker was not done within {timeout} s")


def multiprocess_gloo_resize(kind: str, quick: bool, procs: int) -> dict:
    """The 'data' axis across ``procs`` processes (make_process_mesh)."""
    pkg_root = str(pathlib.Path(__file__).resolve().parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    # the workers share this host: their gloo pairs go over loopback
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(prefix="lqr-scaling-") as tmp, \
            contextlib.ExitStack() as files:
        tmp = pathlib.Path(tmp)
        init = (tmp / "rendezvous").as_uri()
        logs = [(files.enter_context(open(tmp / f"out{i}", "w+")),
                 files.enter_context(open(tmp / f"err{i}", "w+")))
                for i in range(procs)]
        t0 = time.perf_counter()
        workers = [subprocess.Popen(
            [sys.executable, "-m", "lqr_tpu_torch.scaling", "--worker",
             str(i), str(procs), init, "--devices", kind]
            + (["--quick"] if quick else []),
            stdout=out, stderr=err, env=env) for i, (out, err) in
            enumerate(logs)]
        try:
            _wait(workers, WORKER_TIMEOUT_S)
        except RuntimeError as e:
            tails = []
            for i, (_out, err) in enumerate(logs):
                err.seek(0)
                tails.append(f"[worker {i}] {err.read()[-1500:]}")
            raise RuntimeError(f"{e}\n" + "\n".join(tails)) from None
        wall = time.perf_counter() - t0
        lines = []
        for out, _err in logs:
            out.seek(0)
            lines.append(json.loads(out.read().strip().splitlines()[-1]))
    exact = lines[0].get("bit_exact") is True
    return {
        "metric": "multiprocess_gloo_resize", "value": exact,
        "unit": f"vs_map_bit_equal_across_{procs}_processes",
        "vs_baseline": None, "processes": procs, "backend": "gloo",
        "init_method": "file", "workers": lines, "wall_s": wall,
        "bit_exact": exact,
        "ok": exact and all(w["exchanges_in_carve_loop"] == 0
                            for w in lines),
        "wall_note": WALL_NOTE}


def column_sharded_multiseam_resize(device, sz: dict) -> dict:
    """The 'cols' axis: one image on SHARDS column shards of ``device``."""
    h, w = sz["col_hw"]
    seams = sz["col_seams"]
    img = make_test_image(max(h, w))[:h, :w]
    solo = BatchCarver([img], device=device)
    solo.carve(seams)
    mesh = make_mesh(devices=[device] * SHARDS, data=1)
    t, runs, launches, ex, bc = timed_carves(
        lambda: BatchCarver([img], mesh=mesh), seams, device)
    R = sharding._block_rows(h, bc.cfg.delta_x, bc.cfg.Wb // SHARDS)
    predicted = (SHARDS - 1) * (2 * (h // R) + 3)
    exact = _same_map(bc.state, solo.state)
    return {
        "metric": "column_sharded_multiseam_resize",
        "value": t / seams * 1e3,
        "unit": f"ms_per_seam_{SHARDS}_column_shards", "vs_baseline": None,
        "device": device_info(device), "size": f"{w}x{h}", "images": 1,
        "seams": seams, "n_cols": SHARDS, "block_rows": R,
        "dp_route": sharding.dp_route(mesh.devices[0]),
        "launches_per_seam": {k: v / seams for k, v in launches.items()},
        "halo_exchanges_per_seam": ex["halo"] / seams,
        "halo_exchanges_predicted": predicted,
        "gathers_per_seam": ex["gather"] / seams,
        "wall_s": t, "runs_s": runs, "bit_exact": exact,
        "ok": (exact and ex["halo"] == predicted * seams
               and ex["process"] == 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lqr_tpu_torch.scaling",
        description="scaling checks of the port's meshes, JSON lines")
    ap.add_argument("--devices", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the kernels' plain versions (tests)")
    ap.add_argument("--quick", action="store_true",
                    help="small sizes, for the CPU")
    ap.add_argument("--procs", type=int, default=2,
                    help="processes of multiprocess_gloo_resize")
    ap.add_argument("--worker", nargs=3, metavar=("RANK", "WORLD", "INIT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, world, init = args.worker
        return run_worker(int(rank), int(world), init, args.devices,
                          args.quick)
    try:
        device = resolve_device(args.devices)
    except LqrConfigError as e:
        print(f"lqr_tpu_torch.scaling: {e}", file=sys.stderr)
        return 1
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        from .ops import _build
        _build.load()       # built once here, before the workers load it
    sz = QUICK if args.quick else FULL
    ok = True
    for name, run in (
            ("data_parallel_scaling",
             lambda: data_parallel_scaling(device, sz)),
            ("multiprocess_gloo_resize",
             lambda: multiprocess_gloo_resize(args.devices, args.quick,
                                              args.procs)),
            ("column_sharded_multiseam_resize",
             lambda: column_sharded_multiseam_resize(device, sz))):
        try:
            line = run()
        except Exception as e:  # noqa: BLE001 — report it, then go on
            line = {"metric": name, "error": f"{type(e).__name__}: {e}",
                    "bit_exact": False, "ok": False}
        ok = ok and line["ok"]
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
