"""Scaling checks of the port's meshes, the counterpart of the JAX package's
``scripts/scaling.py``.

    python -m lqr_tpu_torch.scaling [--devices cuda|cpu] [--quick]
        [--procs 2] [--cols 1] [--transport gloo|mailbox]

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
  initialized through a file in a fresh temporary directory, on a process
  mesh of --procs / --cols 'data' rows of --cols column shards, a shard a
  process, its messages carried by --transport (default: the mesh's
  choice, the mailbox for workers on one host; the line's ``transport``
  says which ran). Each carves its shard of the same batch on its device
  (on a one-card machine every worker on cuda:0), after a barrier; the
  shards are all-gathered (``gather_s``; ``gather_again_s`` a second
  time, with the carrier's room already made) and rank 0 holds the vs
  maps against a one-process ``BatchCarver``, every worker's gathered map
  the same. The batch: with
  one column a 'data' row, the cfg4 wave; with a 'cols' axis of one row,
  the column line's image; of several rows, a row of COL_BATCH cfg1-size
  images each, with bias and rigidity. With a 'cols' axis the line holds
  the halo messages the workers of a row send a seam against the column
  line's prediction, gives the time each spent in its messages (under the
  mailbox the time to enqueue them), and the host copies and the messages
  of data over the group of a row's seam step, which under the mailbox
  must be 0. A worker that fails, or is not done within WORKER_TIMEOUT_S,
  fails the line.
- ``column_sharded_multiseam_resize``: ``BatchCarver`` on SHARDS column
  shards of the device (``extend_map_sharded``): ms/seam, the launches a
  seam, the DP's block rows R and the halo exchanges a seam against the
  design's (SHARDS - 1) * (2 * H / R + 3) (each block of R rows a halo each
  way at each inner edge, the energy's column each way, the compaction's
  carry), bit-exact against the unsharded resize.

Sizes: the data lines carve one cfg4 wave (256 images of 1024x1024, 256
seams; 128 images a row or a process), the column line 2048x2048, 100
seams, and so does a process mesh of one row; one of several rows carves
512x384 images (cfg1's), 100 seams; --quick takes small ones for the
CPU. Parts 1 and 2 of scripts/scaling.py (the collectives of the compiled
HLO, XLA's cost model) have no PyTorch counterpart; the exchange counter
stands for the audit. Rows or processes that share one card timeshare it:
their walls are no scaling efficiency. The device is the card unless
``--devices cpu`` is given; without CUDA the program exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import hashlib
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
COL_BATCH = 2     # images a row of a process mesh of several column rows
COL_RIGIDITY = 100.0
FULL = {"images": 256, "size": 1024, "seams": 256, "col_hw": (2048, 2048),
        "col_seams": 100, "cfg1_hw": (384, 512), "cfg1_seams": 100}
QUICK = {"images": 4, "size": 64, "seams": 8, "col_hw": (40, 128),
         "col_seams": 6, "cfg1_hw": (24, 128), "cfg1_seams": 4}
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


def worker_batch(sz: dict, data: int, cols: int):
    """The batch of a process mesh of ``data`` rows of ``cols`` column
    shards: (images, BatchCarver keywords, seams)."""
    if cols == 1:
        return make_wave(0, sz["images"], sz["size"]), {}, sz["seams"]
    if data == 1:
        h, w = sz["col_hw"]
        return [make_test_image(max(h, w))[:h, :w]], {}, sz["col_seams"]
    h, w = sz["cfg1_hw"]
    rng = np.random.default_rng(1)
    base = make_test_image(max(h, w))[:h, :w]
    n = COL_BATCH * data
    images = [np.roll(base, 9 * i, axis=1) for i in range(n)]
    biases = [rng.normal(0.0, 40.0, (h, w)).astype(np.float32)
              for _ in range(n)]
    return images, {"biases": biases, "rigidity": COL_RIGIDITY}, \
        sz["cfg1_seams"]


_COUNTERS = ("EXCHANGES", "EXCHANGE_SECONDS", "HOST_COPIES", "GLOO_MESSAGES")


def run_worker(rank: int, world: int, init: str, kind: str,
               quick: bool, cols: int = 1,
               transport: str | None = None) -> int:
    """One process of multiprocess_gloo_resize: its shard of the batch on
    its device; prints one JSON line."""
    sz = QUICK if quick else FULL
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=WORKER_TIMEOUT_S))
    try:
        mesh = make_process_mesh(data=world // cols,
                                 device="cpu" if kind == "cpu" else None,
                                 transport=transport)
        d, c = mesh.local_shards[0]
        dev = mesh.devices[d][c]
        images, kw, seams = worker_batch(sz, mesh.shape["data"], cols)
        BatchCarver(images, mesh=mesh, **kw).carve(seams)    # warm-up
        bc = BatchCarver(images, mesh=mesh, **kw)
        sync(dev)
        dist.barrier()
        before = {name: dict(getattr(sharding, name)) for name in _COUNTERS}
        t0 = time.perf_counter()
        _, launches = launches_of(lambda: bc.carve(seams))
        sync(dev)
        wall = time.perf_counter() - t0
        moved = {name.lower(): {k: v - before[name][k] for k, v in
                                getattr(sharding, name).items()}
                 for name in _COUNTERS}
        gather_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            st = bc.state
            sync(dev)
            gather_s.append(time.perf_counter() - t0)
        Bd = len(images) // mesh.shape["data"]
        cfg = bc.cfg
        out = {"rank": rank, "device": str(dev), "shard": [d, c],
               "transport": mesh.transport,
               "images": Bd, "seams": seams, "H": cfg.H,
               "block_rows": sharding._block_rows(cfg.H, cfg.delta_x,
                                                  cfg.Wb // cols),
               "img_seams": int(st.depth[d * Bd:(d + 1) * Bd].sum()),
               "wall_s": wall, "launches": launches,
               "exchanges_in_carve_loop": sum(moved["exchanges"].values()),
               "exchanges": moved["exchanges"],
               "exchange_s": moved["exchange_seconds"],
               "host_copies": moved["host_copies"],
               "gloo_messages": moved["gloo_messages"],
               "gather_s": gather_s[0], "gather_again_s": gather_s[1],
               "vs_sha256": hashlib.sha256(
                   st.vs.cpu().numpy().tobytes()).hexdigest()}
        if rank == 0:
            solo = BatchCarver(images, device=dev, **kw)
            solo.carve(seams)
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


def multiprocess_gloo_resize(kind: str, quick: bool, procs: int,
                             cols: int = 1,
                             transport: str | None = None) -> dict:
    """A process mesh of ``procs`` processes (make_process_mesh) in one gloo
    group: procs / cols 'data' rows of ``cols`` column shards, its messages
    carried by ``transport`` (None: the mesh's choice)."""
    if cols < 1 or procs % cols != 0:
        raise LqrConfigError(f"{procs} processes cannot form rows of {cols} "
                             f"column shards")
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
             str(i), str(procs), init, "--devices", kind, "--cols",
             str(cols)] + (["--quick"] if quick else [])
            + (["--transport", transport] if transport else []),
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
    exact = (lines[0].get("bit_exact") is True
             and len({w["vs_sha256"] for w in lines}) == 1)
    carriers = {w["transport"] for w in lines}
    line = {
        "metric": "multiprocess_gloo_resize", "value": exact,
        "unit": f"vs_map_bit_equal_across_{procs}_processes",
        "vs_baseline": None, "processes": procs,
        "mesh": {"data": procs // cols, "cols": cols}, "backend": "gloo",
        "transport": lines[0]["transport"], "init_method": "file",
        "workers": lines, "wall_s": wall,
        "gather_s": max(w["gather_s"] for w in lines),
        "gather_again_s": max(w["gather_again_s"] for w in lines),
        "bit_exact": exact, "wall_note": WALL_NOTE}
    agreed = len(carriers) == 1 and transport in (None, *carriers)
    if cols == 1:
        line["ok"] = exact and agreed and all(
            w["exchanges_in_carve_loop"] == 0 for w in lines)
        return line
    # a seam step is one seam of one image; a row's workers each take
    # every step of the row's images
    w0 = lines[0]
    steps = w0["images"] * w0["seams"]
    rows = steps * (procs // cols)
    halo = sum(w["exchanges"]["halo"] for w in lines) / rows
    copies = sum(sum(w["host_copies"].values()) for w in lines) / rows
    gloo = sum(sum(w["gloo_messages"].values()) for w in lines) / rows
    predicted = (cols - 1) * (2 * (w0["H"] // w0["block_rows"]) + 3)
    line.update({
        "block_rows": w0["block_rows"],
        "ms_per_seam": max(w["wall_s"] for w in lines) / steps * 1e3,
        "exchange_ms_per_seam": [
            sum(w["exchange_s"].values()) / steps * 1e3 for w in lines],
        "launches_per_seam": [{k: v / steps for k, v in w["launches"].items()}
                              for w in lines],
        "halo_messages_per_seam": halo,
        "halo_messages_predicted": predicted,
        "host_copies_per_seam": copies,
        "gloo_messages_per_seam": gloo,
        "ok": (exact and agreed and halo == predicted
               and (line["transport"] == "gloo" or copies == gloo == 0))})
    return line


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
    ap.add_argument("--cols", type=int, default=1,
                    help="column shards of each row of its process mesh")
    ap.add_argument("--transport", choices=sharding.TRANSPORTS,
                    help="carrier of the process mesh's messages (default: "
                         "the mesh's choice)")
    ap.add_argument("--worker", nargs=3, metavar=("RANK", "WORLD", "INIT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, world, init = args.worker
        return run_worker(int(rank), int(world), init, args.devices,
                          args.quick, args.cols, args.transport)
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
                                              args.procs, args.cols,
                                              args.transport)),
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
