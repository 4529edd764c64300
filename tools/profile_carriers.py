#!/usr/bin/env python3
"""The carriers of a process mesh on one card: what the mailbox's primitives
do, and where a process mesh's time goes under each carrier.

    python3 tools/profile_carriers.py probe [MESSAGES]
    python3 tools/profile_carriers.py mesh [SEAMS] [--procs 2] [--cols 2]
        [--transport gloo|mailbox]

Each starts its processes on cuda:0 in one gloo group (a file rendezvous in
a fresh temporary directory) and prints one JSON line a process. Processes
that share one card time-slice it: every time here includes the switches
between their contexts. Needs a CUDA device; a worker that fails or is not
done within scaling.WORKER_TIMEOUT_S fails the run.

``probe``: whether two processes can trade device buffers through CUDA
IPC, ordered by CUDA's stream memory operations, and how long a
message and a round trip take. Each process allocates a region with
``lqr_mb_alloc`` (csrc/mailbox.cu): two 4 KiB slots, their two flags and
one credit word; the IPC handles go over gloo once. Then, with nothing on
the host between messages:

1. one way: rank 1 sends MESSAGES (default 1000) [32, 32] f32 payloads to
   rank 0, message q holding q + arange, each a wait on rank 1's credit
   word (the slot is free), a copy into rank 0's slot and a write of q + 1
   to rank 0's flag; rank 0 waits on the flag, copies the slot out with a
   torch op (a kernel reading it) and writes q + 1 to rank 1's credit word.
   Rank 0 checks every payload after one synchronize;
2. ping-pong: MESSAGES round trips, rank 0 sending to rank 1 and rank 1
   sending each message back (the one-way ring's sequence going on, the
   other ring's starting at 0), every payload checked at the end.

Its lines give ms a message one way and ms a round trip (host clock over
the whole run, ended by a synchronize); the run fails on a bad payload.

``mesh``: --procs processes on make_process_mesh(data=procs // cols,
transport=...): rows of --cols column shards, a shard a process, carving
lqr_tpu_torch.scaling's batch for that mesh as chip_smoke.py phase 10 does
(one row: its 2048x2048 image; several: COL_BATCH cfg1-size images a row
with bias and rigidity). Each process

1. sends the DP's halo plane of one block (33 x 32 f32, a host tensor) to
   the other and takes it back, 1000 times over gloo: the loopback's round
   trip, with no device work (a mesh of one row of 2 only);
2. carves SEAMS seams (default 10) a row image after a warm-up of as many,
   under torch.profiler: the wall a seam step; sharding.EXCHANGE_SECONDS a
   seam step (the time in its messages, host copies included; under the
   mailbox the time to enqueue them); its host copies and gloo messages a
   step; its device busy share (the summed device time of its kernels and
   copies over the wall: one stream, so they do not overlap; the other
   processes' work is not in it, and the stream's waits on a flag are no
   device time); its device ops and host operators with the most time.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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

SLOT = 4096              # bytes of a slot: a [32, 32] f32 payload
SLOTS = 2
FLAGS = SLOTS * SLOT     # offset of the flags; the credit word follows them
CREDIT = FLAGS + 8 * SLOTS
REGION = CREDIT + 8


def probe_worker(rank: int, init: str, n: int) -> None:
    import torch
    import torch.distributed as dist
    from lqr_tpu_torch.ops import _build

    lib = _build.load()
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)

        def ok(rc, what):
            _build.check(lib, rc, what)

        mine = ctypes.c_void_p()
        ok(lib.lqr_mb_alloc(REGION, ctypes.byref(mine)), "lqr_mb_alloc")
        handle = ctypes.create_string_buffer(64)
        ok(lib.lqr_mb_handle(mine, handle), "lqr_mb_handle")
        handles = [None, None]
        dist.all_gather_object(handles, handle.raw)
        peer = ctypes.c_void_p()
        ok(lib.lqr_mb_open(handles[1 - rank], ctypes.byref(peer)),
           "lqr_mb_open")
        me, other = mine.value, peer.value
        stream = torch.cuda.current_stream().cuda_stream

        class Slot:
            __slots__ = ("__cuda_array_interface__",)

        def view(base):
            """A [32, 32] f32 tensor over a slot of this process's
            region."""
            s = Slot()
            s.__cuda_array_interface__ = {
                "shape": (32, 32), "typestr": "<f4", "data": (base, False),
                "version": 3, "strides": None}
            return torch.as_tensor(s, device=dev)

        slots = [view(me + k * SLOT) for k in range(SLOTS)]
        base = torch.arange(32 * 32, dtype=torch.float32,
                            device=dev).view(32, 32)
        sent = [base + q for q in range(n)]

        def send(q, payload):
            credit = q - SLOTS + 1
            ok(lib.lqr_mb_put(me + CREDIT if credit > 0 else None, credit,
                              other + (q % SLOTS) * SLOT, payload.data_ptr(),
                              SLOT, other + FLAGS + 8 * (q % SLOTS), q + 1,
                              stream), "lqr_mb_put")

        def receive(q):
            ok(lib.lqr_mb_wait(me + FLAGS + 8 * (q % SLOTS), q + 1, stream),
               "lqr_mb_wait")
            got = slots[q % SLOTS].clone()
            ok(lib.lqr_mb_write(other + CREDIT, q + 1, stream),
               "lqr_mb_write")
            return got

        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        got = [receive(q) if rank == 0 else send(q, sent[q])
               for q in range(n)]
        torch.cuda.synchronize()
        one_way = (time.perf_counter() - t0) / n
        bad = (sum(not torch.equal(g, s) for g, s in zip(got, sent))
               if rank == 0 else 0)

        dist.barrier()
        t0 = time.perf_counter()
        back = []
        for q in range(n):
            # ring 0 -> 1 starts at 0, ring 1 -> 0 goes on from phase 1
            if rank == 0:
                send(q, sent[q])
                back.append(receive(n + q))
            else:
                send(n + q, receive(q))
        torch.cuda.synchronize()
        round_trip = (time.perf_counter() - t0) / n
        if rank == 0:
            bad += sum(not torch.equal(g, s) for g, s in zip(back, sent))
        dist.barrier()
        ok(lib.lqr_mb_close(peer), "lqr_mb_close")
        dist.barrier()
        ok(lib.lqr_mb_free(mine), "lqr_mb_free")
        print(json.dumps({
            "rank": rank, "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "messages": n, "bad_payloads": bad,
            "one_way_ms": one_way * 1e3, "round_trip_ms": round_trip * 1e3}),
            flush=True)
    finally:
        dist.destroy_process_group()



PING_PONGS = 1000


def mesh_worker(rank: int, init: str, seams: int, procs: int, cols: int,
                transport: str | None) -> None:
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lqr_tpu_torch.parallel import BatchCarver, make_process_mesh
    from lqr_tpu_torch.parallel import sharding
    from lqr_tpu_torch.scaling import FULL, WORKER_TIMEOUT_S, worker_batch

    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=procs,
        timeout=datetime.timedelta(seconds=WORKER_TIMEOUT_S))
    try:
        mesh = make_process_mesh(data=procs // cols, transport=transport)
        round_trip = None
        if procs == cols == 2:
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

        images, kw, _ = worker_batch(FULL, procs // cols, cols)
        steps = seams * len(images) // (procs // cols)
        BatchCarver(images, mesh=mesh, **kw).carve(seams)        # warm-up
        bc = BatchCarver(images, mesh=mesh, **kw)
        torch.cuda.synchronize()
        dist.barrier()
        names = ("EXCHANGE_SECONDS", "HOST_COPIES", "GLOO_MESSAGES")
        before = {n: dict(getattr(sharding, n)) for n in names}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bc.carve(seams)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        moved = {n: {k: (v - before[n][k]) / steps for k, v in
                     getattr(sharding, n).items()} for n in names}
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
            "mesh": mesh.shape, "transport": mesh.transport,
            "seams": seams, "seam_steps": steps,
            "gloo_round_trip_ms": (None if round_trip is None
                                   else round_trip * 1e3),
            "ms_per_seam_step": wall / steps * 1e3,
            "exchange_ms_per_seam_step": {
                k: v * 1e3 for k, v in moved["EXCHANGE_SECONDS"].items()},
            "host_copies_per_seam_step": moved["HOST_COPIES"],
            "gloo_messages_per_seam_step": moved["GLOO_MESSAGES"],
            "device_busy_share": busy / wall,
            "device_ms_per_seam_step": busy / steps * 1e3,
            "device_ops": [[round(us / steps / 1e3, 4), n // steps, key[:60]]
                           for us, n, key in device[:6]],
            "host_ms_per_seam_step": [[round(us / steps / 1e3, 4),
                                       n // steps, key[:60]]
                                      for us, n, key in host[:10]]}),
            flush=True)
    finally:
        dist.destroy_process_group()



def _run(flags: list[str], procs: int) -> list[dict]:
    """``procs`` workers of this script with ``flags``; each one's JSON
    lines."""
    from lqr_tpu_torch.scaling import WORKER_TIMEOUT_S, _wait
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo"}
    lines = []
    with tempfile.TemporaryDirectory(prefix="lqr-carriers-") as tmp, \
            contextlib.ExitStack() as files:
        tmp = pathlib.Path(tmp)
        init = (tmp / "rendezvous").as_uri()
        logs = [(files.enter_context(open(tmp / f"out{i}", "w+")),
                 files.enter_context(open(tmp / f"err{i}", "w+")))
                for i in range(procs)]
        workers = [subprocess.Popen(
            [sys.executable, __file__, *flags, "--worker", str(i), init],
            stdout=out, stderr=err, env=env)
            for i, (out, err) in enumerate(logs)]
        try:
            _wait(workers, WORKER_TIMEOUT_S)
        finally:
            for i, (out, err) in enumerate(logs):
                out.seek(0)
                err.seek(0)
                text = out.read().strip()
                print(text, flush=True)
                lines += [json.loads(x) for x in text.splitlines()
                          if x.startswith("{")]
                if workers[i].returncode:
                    print(f"[worker {i}] {err.read()[-3000:]}",
                          file=sys.stderr)
    return lines


def main(argv: list[str]) -> int:
    import torch
    from lqr_tpu_torch.ops import _build
    from lqr_tpu_torch.parallel.sharding import TRANSPORTS

    ap = argparse.ArgumentParser(prog="tools/profile_carriers.py")
    ap.add_argument("what", choices=("probe", "mesh"))
    ap.add_argument("count", nargs="?", type=int,
                    help="probe: messages (1000); mesh: seams (10)")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--cols", type=int, default=2)
    ap.add_argument("--transport", choices=TRANSPORTS)
    ap.add_argument("--worker", nargs=2, metavar=("RANK", "INIT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    probe = args.what == "probe"
    count = args.count or (1000 if probe else 10)
    if args.worker:
        rank, init = int(args.worker[0]), args.worker[1]
        if probe:
            probe_worker(rank, init, count)
        else:
            mesh_worker(rank, init, count, args.procs, args.cols,
                        args.transport)
        return 0
    if not torch.cuda.is_available():
        print("profile_carriers: needs a CUDA device", file=sys.stderr)
        return 1
    _build.load()           # built once here, before the workers load it
    if probe:
        lines = _run(["probe", str(count)], 2)
        return 0 if len(lines) == 2 and not any(x["bad_payloads"]
                                                for x in lines) else 1
    flags = ["mesh", str(count), "--procs", str(args.procs), "--cols",
             str(args.cols)]
    if args.transport:
        flags += ["--transport", args.transport]
    return 0 if len(_run(flags, args.procs)) == args.procs else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
