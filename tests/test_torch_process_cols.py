"""The port's 'cols' axis across processes: make_process_mesh's (data, cols)
meshes over a gloo group of CPU processes, each column shard in a process of
its own, its halos, gathers and row counts carried over torch.distributed
(transport "gloo") or through the mailbox's rings in shared memory
(transport "mailbox", the host model of the card's CUDA IPC carrier).

Every process's gathered vs, cur_b, depth, images_at and aux_at (an RGBA
aux image) are held against the JAX package's column-sharded BatchCarver
on its 8-device CPU mesh and against the port's column-sharded BatchCarver
in one process, on 2 processes x 2 columns, 4 x 4 and 4 as 2 x 2, at
delta_x 1 and 2, with bias, rigidity masks and per-image seam counts
(tolerance 0). The processes of a row compute the same seams as one
process; the halo messages the processes of a row send a seam sum to
(n_cols - 1)(2H/R + 3) under both carriers; the mailbox makes no host copy
and sends no message of data over the group. A ring of 2 slots carries
16 row blocks a seam step. Every subprocess runs under a timeout of its
own, in a session of its own that is killed whole when it passes.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import random_image
from lqr_tpu.parallel import batch as jbatch
from lqr_tpu.parallel import sharding as jshard
from lqr_tpu_torch.ops import dp_cuda
from lqr_tpu_torch.parallel import batch as tbatch
from lqr_tpu_torch.parallel import sharding as tshard

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
H = 24                                  # 3 blocks of R rows at 2 and 4 columns
WIDTHS_IN = [250, 240, 256, 231]        # Wb 256: 128 or 64 columns a shard
SEAMS = [5, 0, 4, 2]
WIDTHS_OUT = [247, 240, 253, 230]
RIGIDITY = 20.0
DELTAS = (1, 2)
MESHES = [(2, 1), (4, 1), (4, 2)]       # (processes, 'data' rows)
TRANSPORTS = ("gloo", "mailbox")
RING = dict(h=64, w=120, dx=5, seams=6)  # 2 shards of 64: R = 4, 16 blocks

_WORKER = """
import datetime, json, os, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from lqr_tpu_torch import LqrConfigError
from lqr_tpu_torch.ops import dp_cuda
from lqr_tpu_torch.parallel import BatchCarver, make_process_mesh, sharding

rank, world, init, tmp, data, mode, transport = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    int(sys.argv[5]), sys.argv[6], sys.argv[7])
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=10 if mode == "die" else 30))
inp = np.load(f"{tmp}/inputs.npz")
n = len(inp["seams"])
kw = dict(biases=[inp[f"bias{i}"] for i in range(n)],
          rigmasks=[inp[f"rig{i}"] for i in range(n)],
          rigidity=float(inp["rigidity"]),
          aux=[[inp[f"aux{i}"]] for i in range(n)])
imgs = [inp[f"img{i}"] for i in range(n)]
checks = {}
try:
    make_process_mesh(data=3, device="cpu")
except LqrConfigError as e:
    checks["indivisible"] = str(e)
get_backend = dist.get_backend
dist.get_backend = lambda group=None: "nccl"
try:
    make_process_mesh(data=data, device="cpu")
except LqrConfigError as e:
    checks["nccl"] = str(e)
dist.get_backend = get_backend
if mode == "carve":
    try:
        make_process_mesh(data=data, device="cpu", transport="nccl")
    except LqrConfigError as e:
        checks["unknown"] = str(e)
    import socket
    from lqr_tpu_torch.parallel import mailbox
    hostname = socket.gethostname
    if rank == 1:          # a process that says it is on another host
        socket.gethostname = lambda: "elsewhere"
    try:
        make_process_mesh(data=data, device="cpu", transport="mailbox")
    except LqrConfigError as e:
        checks["other_host"] = str(e)
    checks["other_host_auto"] = make_process_mesh(data=data,
                                                  device="cpu").transport
    socket.gethostname = hostname
    open_peer = mailbox.Mailbox._open
    def refused(self, handle, nbytes):
        raise OSError(f"cannot map {handle}")
    if rank == 1:          # a peer's memory that will not map
        mailbox.Mailbox._open = refused
    try:
        make_process_mesh(data=data, device="cpu", transport="mailbox")
    except LqrConfigError as e:
        checks["no_map"] = str(e)
    mailbox.Mailbox._open = open_peer
mesh = make_process_mesh(data=data, device="cpu", transport=transport)
checks["shape"] = mesh.shape
checks["transport"] = mesh.transport
checks["local_shards"] = [list(x) for x in mesh.local_shards]
if mode == "ring":
    h, w, dx, k = (int(x) for x in sys.argv[8:12])
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    kw = dict(biases=[rng.normal(0, 40, (h, w)).astype(np.float32)],
              rigmasks=[np.abs(rng.standard_normal((h, w)))
                        .astype(np.float32)], rigidity=20.0, delta_x=dx)
    bc = BatchCarver([img], mesh=mesh, **kw)
    before = dict(sharding.EXCHANGES)
    bc.carve(k)
    checks["exchanges"] = {k2: v - before[k2]
                           for k2, v in sharding.EXCHANGES.items()}
    checks["block_rows"] = sharding._block_rows(h, dx, bc.cfg.Wb // 2)
    checks["slots"] = mesh.mailboxes[0].slots
    one = BatchCarver([img], device="cpu", **kw)
    one.carve(k)
    st = bc.state
    checks["equal"] = (torch.equal(st.vs, one.state.vs)
                       and torch.equal(st.cur_b, one.state.cur_b)
                       and torch.equal(st.cur_bias, one.state.cur_bias)
                       and torch.equal(st.cur_rig, one.state.cur_rig))
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(checks, f)
    dist.destroy_process_group()
    sys.exit(0)
if mode == "die":
    calls = []
    row_class = (sharding._MailboxRow if transport == "mailbox"
                 else sharding._ProcessRow)
    shift = row_class.shift
    def dying(self, *args):
        calls.append(1)
        if rank == 1 and len(calls) == 3:
            os._exit(7)
        return shift(self, *args)
    row_class.shift = dying
seams = []
backtrack = dp_cuda.backtrack
def recorded(*args):
    out = backtrack(*args)
    seams.append(out.numpy().copy())
    return out
dp_cuda.backtrack = recorded
for dx in (1, 2):
    bc = BatchCarver(imgs, delta_x=dx, mesh=mesh, **kw)
    checks[f"col_sharded{dx}"] = bc.col_sharded
    seams.clear()
    before = {name: dict(getattr(sharding, name))
              for name in ("EXCHANGES", "HOST_COPIES", "GLOO_MESSAGES")}
    bc.carve(list(inp["seams"]))
    for name, was in before.items():
        key = "exchanges" if name == "EXCHANGES" else name.lower()
        checks[f"{key}{dx}"] = {k: v - was[k]
                                for k, v in getattr(sharding, name).items()}
    got = {"seams": np.array(seams)}
    st = bc.state
    got.update(vs=st.vs.numpy(), cur_b=st.cur_b.numpy(),
               cur_bias=st.cur_bias.numpy(), cur_rig=st.cur_rig.numpy(),
               depth=st.depth)
    widths = list(inp["widths"])
    for i, (im, (a,)) in enumerate(zip(bc.images_at(widths),
                                       bc.aux_at(widths))):
        got[f"out{i}"] = im
        got[f"auxout{i}"] = a
    np.savez(f"{tmp}/rank{rank}_dx{dx}.npz", **got)
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(checks, f)
dist.destroy_process_group()
"""


def _inputs():
    rng = np.random.default_rng(11)
    imgs = [random_image(rng, H, w, 3) for w in WIDTHS_IN]
    imgs[1] = (rng.integers(0, 8, (H, WIDTHS_IN[1], 3)) * 32).astype(
        np.uint8)                                       # ties everywhere
    kw = dict(
        biases=[rng.normal(0, 40, (H, w)).astype(np.float32)
                for w in WIDTHS_IN],
        rigmasks=[np.abs(rng.standard_normal((H, w))).astype(np.float32)
                  for w in WIDTHS_IN],
        rigidity=RIGIDITY,
        aux=[[rng.integers(0, 256, (H, w, 4), dtype=np.uint8)]
             for w in WIDTHS_IN])
    return imgs, kw


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo",
            "PYTHONPATH": os.pathsep.join(
                p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)}


def _start(tmp, procs: int, data: int, mode: str = "carve",
           transport: str = "gloo", extra=()):
    """The gloo workers on a (data, procs / data) mesh under ``transport``,
    the inputs written to tmp first."""
    imgs, kw = _inputs()
    arrays = {f"img{i}": im for i, im in enumerate(imgs)}
    for i in range(len(imgs)):
        arrays[f"bias{i}"] = kw["biases"][i]
        arrays[f"rig{i}"] = kw["rigmasks"][i]
        arrays[f"aux{i}"] = kw["aux"][i][0]
    np.savez(tmp / "inputs.npz", seams=np.array(SEAMS),
             widths=np.array(WIDTHS_OUT), rigidity=np.float32(RIGIDITY),
             **arrays)
    init = (tmp / "rendezvous").as_uri()
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(procs), init, str(tmp),
         str(data), mode, transport, *map(str, extra)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), start_new_session=True)
        for r in range(procs)]


def _finish(procs):
    """Every worker's (return code, stderr), all killed at TIMEOUT_S."""
    deadline = time.monotonic() + TIMEOUT_S
    out = []
    for p in procs:
        try:
            err = p.communicate(
                timeout=max(deadline - time.monotonic(), 0))[1]
            out.append((p.returncode, err))
        except subprocess.TimeoutExpired:
            for q in procs:
                os.killpg(q.pid, signal.SIGKILL)
                q.communicate()
            pytest.fail(f"a gloo worker was not done within {TIMEOUT_S} s")
    return out


_CASES = [(p, d, t) for t in TRANSPORTS for p, d in MESHES]


@pytest.fixture(scope="module", params=_CASES,
                ids=[f"{p}procs-data{d}" + ("" if t == "gloo" else f"-{t}")
                     for p, d, t in _CASES])
def process_mesh(request, tmp_path_factory):
    """One run of the workers on a mesh under a carrier: (procs, data, each
    rank's checks, each rank's arrays by delta_x)."""
    procs, data, transport = request.param
    tmp = tmp_path_factory.mktemp(f"cols{procs}x{data}{transport}")
    for p, (rc, err) in zip(range(procs), _finish(
            _start(tmp, procs, data, transport=transport))):
        assert rc == 0, f"rank {p}: {err[-3000:]}"
    ranks = [(json.loads((tmp / f"rank{r}.json").read_text()),
              {dx: dict(np.load(tmp / f"rank{r}_dx{dx}.npz"))
               for dx in DELTAS}) for r in range(procs)]
    for checks, _ in ranks:
        assert checks["transport"] == transport
    return procs, data, ranks


_JAX = {}


def _jax(dx):
    """JAX's column-sharded BatchCarver on its 2 x 4 CPU mesh: (vs, cur_b,
    depth, images_at, aux_at, cur_bias, cur_rig)."""
    if dx not in _JAX:
        imgs, kw = _inputs()
        j = jbatch.BatchCarver(imgs, delta_x=dx,
                               mesh=jshard.make_mesh(8, data=2), **kw)
        assert j.col_sharded
        j.carve(SEAMS)
        _JAX[dx] = (np.asarray(j.state.vs), np.asarray(j.state.cur_b),
                    np.asarray(j.state.depth), j.images_at(WIDTHS_OUT),
                    [a for (a,) in j.aux_at(WIDTHS_OUT)],
                    np.asarray(j.state.cur_bias), np.asarray(j.state.cur_rig))
    return _JAX[dx]


def _one_process(dx, data, cols, monkeypatch):
    """The port's column-sharded BatchCarver on a (data, cols) mesh of CPU
    shards in this process, with the seams its backtracks compute."""
    seams = []
    backtrack = dp_cuda.backtrack

    def recorded(*args):
        out = backtrack(*args)
        seams.append(out.numpy().copy())
        return out

    monkeypatch.setattr(dp_cuda, "backtrack", recorded)
    imgs, kw = _inputs()
    bc = tbatch.BatchCarver(
        imgs, delta_x=dx, device="cpu",
        mesh=tshard.make_mesh(devices=["cpu"] * (data * cols), data=data),
        **kw)
    bc.carve(SEAMS)
    return bc, np.array(seams)


@pytest.mark.parametrize("dx", DELTAS)
def test_process_cols_equal_jax_and_one_process(process_mesh, dx,
                                                monkeypatch):
    procs, data, ranks = process_mesh
    (want_vs, want_b, want_depth, want_imgs, want_aux, want_bias,
     want_rig) = _jax(dx)
    one, _ = _one_process(dx, data, procs // data, monkeypatch)
    st = one.state
    np.testing.assert_array_equal(st.vs.numpy(), want_vs)
    for checks, arrays in ranks:         # every rank holds the whole state
        assert checks[f"col_sharded{dx}"] is True
        got = arrays[dx]
        np.testing.assert_array_equal(got["vs"], want_vs)
        np.testing.assert_array_equal(got["cur_b"], want_b)
        np.testing.assert_array_equal(got["cur_b"], st.cur_b.numpy())
        for name, want in (("cur_bias", want_bias), ("cur_rig", want_rig)):
            np.testing.assert_array_equal(got[name], want)
            np.testing.assert_array_equal(got[name],
                                          getattr(st, name).numpy())
        np.testing.assert_array_equal(got["depth"], want_depth)
        np.testing.assert_array_equal(got["depth"], SEAMS)
        for i in range(len(SEAMS)):
            np.testing.assert_array_equal(got[f"out{i}"], want_imgs[i])
            np.testing.assert_array_equal(got[f"auxout{i}"], want_aux[i])
            assert got[f"auxout{i}"].shape == (H, WIDTHS_OUT[i], 4)


@pytest.mark.parametrize("dx", DELTAS)
def test_process_cols_rows_hold_the_same_seams(process_mesh, dx,
                                               monkeypatch):
    """Each process of a row computes the row's seams itself, from the
    gathered frontier and backpointers: the same seams, in the same order,
    as one process computes for that row's images."""
    procs, data, ranks = process_mesh
    cols = procs // data
    _, want = _one_process(dx, data, cols, monkeypatch)
    Bd = len(SEAMS) // data
    # one process carves row after row, each in the order a process of the
    # row carves it
    per_row = np.split(want, np.cumsum([sum(SEAMS[d * Bd:(d + 1) * Bd])
                                        for d in range(data)])[:-1])
    for rank, (checks, arrays) in enumerate(ranks):
        d, c = checks["local_shards"][0]
        assert checks["local_shards"] == [[rank // cols, rank % cols]]
        np.testing.assert_array_equal(arrays[dx]["seams"], per_row[d])


@pytest.mark.parametrize("dx", DELTAS)
def test_process_cols_halo_messages(process_mesh, dx):
    """The halo messages a row's processes send sum, per seam step, to the
    count one process predicts: (n_cols - 1)(2H/R + 3) (a DP halo each way
    each block of R rows at each inner edge, the energy's column each way,
    the compaction's carry), under either carrier. Gloo carries every
    message over the group; the mailbox none. CPU shards make no host copy
    under either."""
    procs, data, ranks = process_mesh
    cols = procs // data
    R = tshard._block_rows(H, dx, 256 // cols)
    assert H // R == 3
    Bd = len(SEAMS) // data
    for d in range(data):
        row = [checks for checks, _ in ranks
               if checks["local_shards"][0][0] == d]
        assert len(row) == cols
        steps = sum(SEAMS[d * Bd:(d + 1) * Bd])
        halo = sum(ch[f"exchanges{dx}"]["halo"] for ch in row)
        assert halo == steps * (cols - 1) * (2 * (H // R) + 3)
        # the backtrack's frontier and backpointers and the commit's
        # counts, one all-gather each a step, and one check of the steps
        for ch in row:
            assert ch[f"exchanges{dx}"]["gather"] == 3 * steps + 1
            assert ch[f"exchanges{dx}"]["process"] == 0
            assert ch[f"host_copies{dx}"] == {"halo": 0, "gather": 0,
                                              "process": 0}
            gloo = ch["transport"] == "gloo"
            assert ch[f"gloo_messages{dx}"] == {
                "halo": ch[f"exchanges{dx}"]["halo"] if gloo else 0,
                "gather": 3 * steps if gloo else 0, "process": 0}


def test_process_mesh_shape_and_refusals(process_mesh):
    """A data count that does not divide the group and a backend that
    carries no CPU tensors raise LqrConfigError in every process."""
    procs, data, ranks = process_mesh
    for checks, _ in ranks:
        assert checks["shape"] == {"data": data, "cols": procs // data}
        assert f"{procs} devices cannot form 3 'data' rows" \
            in checks["indivisible"]
        assert "CPU tensors (gloo); nccl does not" in checks["nccl"]


def test_mailbox_refusals(process_mesh):
    """An unknown transport, an explicit mailbox with a process on another
    host, and one whose peer's memory will not map raise LqrConfigError in
    every process; without a transport the process on another host gets
    gloo."""
    procs, data, ranks = process_mesh
    for checks, _ in ranks:
        assert "unknown transport 'nccl'" in checks["unknown"]
        assert "cpu on elsewhere" in checks["other_host"]
        assert "needs every process of the group on this host" \
            in checks["other_host"]
        assert checks["other_host_auto"] == "gloo"
        assert "cannot map a peer's memory: OSError: cannot map" \
            in checks["no_map"]


def test_dead_worker_fails_the_row(tmp_path):
    """A worker that dies in the middle of a carve fails its neighbour, which
    waits on its messages, within the group's timeout: no process hangs."""
    t0 = time.monotonic()
    (rc0, err0), (rc1, _err1) = _finish(_start(tmp_path, 2, 1, mode="die"))
    assert rc1 == 7
    assert rc0 != 0 and "Error" in err0, err0[-3000:]
    assert time.monotonic() - t0 < TIMEOUT_S


def test_dead_worker_fails_the_row_mailbox(tmp_path):
    """Under the mailbox carrier the neighbour of a worker that dies in the
    middle of a carve polls its ring until the group's timeout (10 s here)
    and raises TimeoutError: no process hangs."""
    t0 = time.monotonic()
    (rc0, err0), (rc1, _err1) = _finish(_start(tmp_path, 2, 1, mode="die",
                                               transport="mailbox"))
    assert rc1 == 7
    assert rc0 != 0 and "TimeoutError" in err0, err0[-3000:]
    assert "sent nothing for 10.0 s" in err0
    assert time.monotonic() - t0 < TIMEOUT_S


def test_mailbox_ring_of_two_slots(tmp_path):
    """A 2-slot ring carries the DP's halo planes of 16 row blocks a seam
    step (64 rows at delta_x 5 on 2 shards of 64 columns: R = 4), with bias
    and rigidity: the slots are reused 8 times a step, each only after its
    receiver released it, and the row's state equals one process's."""
    procs = _finish(_start(tmp_path, 2, 1, mode="ring", transport="mailbox",
                           extra=[RING[k] for k in ("h", "w", "dx",
                                                    "seams")]))
    for r, (rc, err) in enumerate(procs):
        assert rc == 0, f"rank {r}: {err[-3000:]}"
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    R = ranks[0]["block_rows"]
    assert R == 4 and RING["h"] // R == 16
    for checks in ranks:
        assert checks["transport"] == "mailbox" and checks["slots"] == 2
        assert checks["equal"] is True
    halo = sum(ch["exchanges"]["halo"] for ch in ranks)
    assert halo == RING["seams"] * (2 * RING["h"] // R + 3)
