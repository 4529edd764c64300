#!/usr/bin/env python3
"""Where the time of the 'cols' axis across processes goes, on one card.

    python3 tools/profile_process_cols.py [SEAMS]

Starts 2 processes that share cuda:0 in one gloo group (a file rendezvous
in a fresh temporary directory) and builds make_process_mesh(data=1): one
row of 2 column shards of chip_smoke.py's 2048x2048 test image, a shard a
process, as chip_smoke.py phase 10 carves it. Each process

1. sends the DP's halo plane of one block (33 x 32 f32, a host tensor) to
   the other and takes it back, 1000 times over gloo: the loopback's round
   trip, with no device work;
2. carves SEAMS seams (default 10) after a warm-up of as many, under
   torch.profiler: the wall a seam; sharding.EXCHANGE_SECONDS a seam (the
   time in its messages, host copies included); its device busy share (the
   summed device time of its kernels and copies over the wall: one stream,
   so they do not overlap; the other process's work is not in it); its
   device ops and host operators with the most time.

Prints one JSON line a process. Needs a CUDA device; a worker that fails or
is not done within scaling.WORKER_TIMEOUT_S fails the run.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N = 2048
PING_PONGS = 1000


def worker(rank: int, init: str, seams: int) -> None:
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as smoke
    from lqr_tpu_torch.parallel import BatchCarver, make_process_mesh
    from lqr_tpu_torch.parallel import sharding
    from lqr_tpu_torch.scaling import WORKER_TIMEOUT_S

    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=WORKER_TIMEOUT_S))
    try:
        mesh = make_process_mesh(data=1)
        plane = torch.zeros((33, 32))
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(PING_PONGS):
            if rank == 0:
                dist.send(plane, 1)
                dist.recv(plane, 1)
            else:
                dist.recv(plane, 0)
                dist.send(plane, 0)
        round_trip = (time.perf_counter() - t0) / PING_PONGS

        img = smoke.make_test_image(N)
        BatchCarver([img], mesh=mesh).carve(seams)               # warm-up
        bc = BatchCarver([img], mesh=mesh)
        torch.cuda.synchronize()
        dist.barrier()
        secs = dict(sharding.EXCHANGE_SECONDS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bc.carve(seams)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        device = sorted(((getattr(ev, "device_time_total", None)
                          or ev.cuda_time_total, ev.count, ev.key)
                         for ev in events
                         if ev.device_type == DeviceType.CUDA),
                        reverse=True)
        host = sorted(((ev.self_cpu_time_total, ev.count, ev.key)
                       for ev in events
                       if ev.device_type == DeviceType.CPU), reverse=True)
        busy = sum(r[0] for r in device) / 1e6
        print(json.dumps({
            "rank": rank, "device": torch.cuda.get_device_name(0),
            "seams": seams, "gloo_round_trip_ms": round_trip * 1e3,
            "ms_per_seam": wall / seams * 1e3,
            "exchange_ms_per_seam": {
                k: (v - secs[k]) / seams * 1e3
                for k, v in sharding.EXCHANGE_SECONDS.items()},
            "device_busy_share": busy / wall,
            "device_ms_per_seam": busy / seams * 1e3,
            "device_ops": [[round(us / seams / 1e3, 4), n // seams, key[:60]]
                           for us, n, key in device[:6]],
            "host_ms_per_seam": [[round(us / seams / 1e3, 4), n // seams,
                                  key[:60]] for us, n, key in host[:10]]}),
            flush=True)
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> int:
    import torch
    from lqr_tpu_torch.ops import _build
    from lqr_tpu_torch.scaling import WORKER_TIMEOUT_S, _wait

    if argv and argv[0] == "--worker":
        worker(int(argv[1]), argv[2], int(argv[3]))
        return 0
    if not torch.cuda.is_available():
        print("profile_process_cols: needs a CUDA device", file=sys.stderr)
        return 1
    seams = int(argv[0]) if argv else 10
    _build.load()           # built once here, before the workers load it
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo"}
    with tempfile.TemporaryDirectory(prefix="lqr-cols-") as tmp, \
            contextlib.ExitStack() as files:
        tmp = pathlib.Path(tmp)
        init = (tmp / "rendezvous").as_uri()
        logs = [(files.enter_context(open(tmp / f"out{i}", "w+")),
                 files.enter_context(open(tmp / f"err{i}", "w+")))
                for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--worker", str(i), init,
             str(seams)], stdout=out, stderr=err, env=env)
            for i, (out, err) in enumerate(logs)]
        try:
            _wait(procs, WORKER_TIMEOUT_S)
        finally:
            for i, (out, err) in enumerate(logs):
                out.seek(0)
                err.seek(0)
                print(out.read().strip(), flush=True)
                if procs[i].returncode:
                    print(f"[worker {i}] {err.read()[-3000:]}",
                          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
