"""Sharded carving: batch data-parallelism and column sharding of the DP.

Counterpart of ``lqr_tpu.parallel.sharding``:

- ``Mesh`` is a (data, cols) grid of ``torch.device`` s. A device may
  appear more than once: four column shards on one GPU run the column-
  sharded path on a one-GPU machine, eight CPU shards run it in the tests.
  ``make_mesh`` builds a mesh in one process, the way ``shard_map`` runs
  one controller. ``make_process_mesh`` builds one whose shards lie in the
  processes of a ``torch.distributed`` group, a shard a process in rank
  order, as a JAX mesh spans the devices of several processes: with one
  'data' row a process the rows exchange nothing; a row of several column
  shards exchanges its halos and gathers between its processes. A mesh over
  processes has a carrier (``Mesh.transport``): "gloo", the group's
  messages as host copies, or "mailbox" (``parallel/mailbox.py``), rings in
  memory that the processes of one host map: CUDA IPC regions written and
  waited on by the streams (no host copy, no host wait, no message over the
  group), or shared host memory for CPU shards.
- A sharded state (``ShardedState``) keeps each shard as its own tensors on
  its device; on a mesh over processes each process holds its own shard
  only. The exchanges of a mesh row's column shards go through one
  interface (``_LocalRow``, ``_ProcessRow``, ``_MailboxRow``): a shift of
  each shard's halo to its left and right neighbours, a gather of the
  row's parts (the frontier and backpointers for the backtrack, the row
  counts for the commit) and the spread of what was computed from them
  back to the shards. In one process it is copies to the neighbour's
  device and a ``torch.cat`` onto the row's first device (but the DP's
  halos on one CUDA device, below); across processes, point-to-point
  messages and all-gathers over the row's gloo subgroup as host copies,
  or the same messages through the row's mailbox, every process then
  computing the seam itself. ``gather_state`` of a mesh over processes all-gathers the
  shards over the group (the group's backend must take CPU tensors: gloo),
  or their planes through the group's mailbox.
- ``EXCHANGES`` counts the messages between shards that this process
  sends, by kind: each is a copy where the two shards lie on distinct
  devices or processes, and a read in place where they share a device.
  ``EXCHANGE_SECONDS`` holds the wall time of the messages between
  processes, host copies included (under the mailbox carrier the time to
  enqueue them). ``HOST_COPIES`` counts the copies between a CUDA device
  and the host that carry them, ``GLOO_MESSAGES`` the messages of the
  shards' data that went over the process group.

Axis ``data`` splits the batch: each shard carves its images with the
batched routes of ``parallel.batch``, with no exchange at all.

Axis ``cols`` splits image columns. The DP's rows are sequential and its
columns parallel, so shards exchange halos once per block of R rows: to
compute R rows exactly in its own Wl columns a shard needs G = R·delta_x
frontier values and an [R, G] energy (and rigidity) slab of each neighbour,
and recomputes the shrinking cone of the halo itself. Values outside the
exact cone are upper bounds that never reach the shard's own columns, so
the seams equal the unsharded DP's bit for bit. At the mesh's edges the
halo is +inf frontier and energy with zero rigidity (a +inf rigidity would
poison e + rig·rigc in the cone).

Which kernel runs the DP is a rule of placement (``dp_route``), the same
for every seam:

- every shard of the mesh row on one CUDA device in one process, at most
  8 of them: one launch of ``dp_sharded`` (``csrc/dp_sharded.cu``) a
  seam, a thread-block cluster of one block per shard with the halos read
  from the neighbours' shared memory and planes, at any shard width;
- shards on distinct devices or in distinct processes, or more than 8 on
  one device (more blocks than a cluster holds): ``dp_blocked``, one
  ``dp_block`` launch (``csrc/dp_block.cu``) per block of rows and shard,
  the halos sent as one packed message per neighbour per block, the only
  form that crosses devices and processes;
- CPU shards: ``dp_blocked`` with the plain version of ``dp_block``.

The backtrack of the gathered map runs on the backtrack kernel on CUDA
tensors and on its plain version on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import socket
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import profiling
from ..config import EnergyFunc
from ..core import engine as eng
from ..core.energy import (_f32, energy_from_gx, energy_from_plane,
                           reader_plane)
from ..core.state import EngineConfig, MapState, resolve_device
from ..errors import LqrConfigError, LqrImageError
from ..i18n import _
from ..ops import dp_cuda
from ..ops.dp_block import MAX_SHARDS, copy_halos, dp_blocked, dp_sharded
from .mailbox import Mailbox

__all__ = ["Mesh", "ShardedState", "make_mesh", "make_process_mesh",
           "shard_batch_state", "gather_state", "map_data_shards",
           "find_seam_sharded", "extend_map_sharded", "sharded_seam_step",
           "dp_route", "EXCHANGES", "EXCHANGE_SECONDS", "HOST_COPIES",
           "GLOO_MESSAGES", "TRANSPORTS"]

INF = float("inf")

# Messages between shards, by kind: "halo" (a column shard's neighbour
# values: the energy's one column, the DP's halo of each block of rows,
# the compaction's carry column), "gather" (within a mesh row: the
# backtrack's inputs, the seam, the commit's row counts; across processes
# an all-gather over the row, one message of each process) and "process"
# (an all-gather over a mesh's process group).
# Each of these four is a group of profiling.COUNTERS under its own name.
EXCHANGES = profiling.group("EXCHANGES", {"halo": 0, "gather": 0,
                                          "process": 0})
# Seconds in the messages between the processes of a mesh row, by kind
EXCHANGE_SECONDS = profiling.group("EXCHANGE_SECONDS", {
    "halo": 0.0, "gather": 0.0, "process": 0.0})
# Copies between a CUDA device and the host that carry the messages, by kind
HOST_COPIES = profiling.group("HOST_COPIES", {"halo": 0, "gather": 0,
                                              "process": 0})
# Messages of the shards' data over a mesh's process group, by kind (not
# the row's check of its steps, nor a mailbox's handles)
GLOO_MESSAGES = profiling.group("GLOO_MESSAGES", {"halo": 0, "gather": 0,
                                                  "process": 0})
# The carriers of a mesh over processes
TRANSPORTS = ("gloo", "mailbox")
# A row's mailbox channels: the halo tags, then the row's gathers
_CHANNELS = ("energy", "dp", "carry", "gather")
# gloo tags of the halos between a row's processes: no message of one
# kind can meet the receive of another
_TAGS = {"energy": 1, "dp": 2, "carry": 3}


def _to_host(kind: str, t: torch.Tensor) -> torch.Tensor:
    """t on the host for a gloo message, a counted copy if it is not."""
    if t.device.type != "cpu":
        HOST_COPIES[kind] += 1
    return t.contiguous().cpu()


def _from_host(kind: str, t: torch.Tensor, device) -> torch.Tensor:
    """A received host tensor on ``device``, a counted copy if that is not
    the host."""
    if torch.device(device).type != "cpu":
        HOST_COPIES[kind] += 1
    return t.to(device)


def _send(kind: str, t: torch.Tensor, device) -> torch.Tensor:
    """t, a shard's tensor, handed to another shard on ``device``."""
    EXCHANGES[kind] += 1
    return t.to(device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, cols) grid of devices: ``devices[d][c]``. A mesh over
    processes (``make_process_mesh``) also has the ``torch.distributed``
    group, ``ranks``, the group rank of the process that holds each shard
    (row-major: shard (d, c) at d * cols + c), and with a 'cols' axis
    ``row_groups``, a gloo subgroup of each row's processes; a device of
    another process's shard is that process's device. ``transport``: its
    carrier, "gloo" or "mailbox"; under "mailbox", ``mailboxes[d]`` is row
    d's (None for a row this process holds no shard of, and without a
    'cols' axis) and ``mailbox`` the group's, for gather_state."""

    devices: tuple
    group: object = None
    ranks: tuple | None = None
    row_groups: tuple | None = None
    transport: str | None = None
    mailboxes: tuple | None = None
    mailbox: object = None

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "cols": len(self.devices[0])}

    def rank_of(self, d: int, c: int):
        """The group rank of the process that holds shard (d, c); None on a
        mesh in one process."""
        if self.ranks is None:
            return None
        return self.ranks[d * len(self.devices[0]) + c]

    @property
    def local_shards(self) -> tuple:
        """The (row, column) shards this process holds: every shard of a
        mesh in one process."""
        cells = [(d, c) for d in range(len(self.devices))
                 for c in range(len(self.devices[0]))]
        if self.ranks is None:
            return tuple(cells)
        me = dist.get_rank(self.group)
        return tuple(dc for dc in cells if self.rank_of(*dc) == me)

    @property
    def local_rows(self) -> tuple:
        """The 'data' rows this process holds a shard of: every row of a
        mesh in one process."""
        return tuple(sorted({d for d, _c in self.local_shards}))


def make_mesh(n_devices: int | None = None, data: int | None = None,
              devices=None) -> Mesh:
    """A (data, cols) mesh of n_devices devices: ``devices`` (a list that
    may repeat a device, e.g. ``["cpu"] * 4`` for CPU shards), else every
    CUDA device; without CUDA and without ``devices`` it raises
    LqrConfigError. data: the size of the 'data' axis (default: 1 for up
    to four devices, else 2)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise LqrConfigError(
                _("make_mesh found no CUDA device; pass devices=[\"cpu\"] * "
                  "n for CPU shards"))
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs):
        raise LqrConfigError(
            _("a mesh of {n} devices needs that many; {m} given")
            .format(n=n, m=len(devs)))
    if data is None:
        data = 1 if n <= 4 else 2
    if n % data != 0:
        raise LqrConfigError(
            _("{n} devices cannot form {d} 'data' rows").format(n=n, d=data))
    cols = n // data
    return Mesh(tuple(tuple(devs[r * cols:(r + 1) * cols])
                      for r in range(data)))


def _takes_cpu(group) -> bool:
    """Whether the group's backend carries CPU tensors ("gloo", "mpi", or a
    device map such as "cpu:gloo,cuda:nccl" with a CPU entry; "nccl" alone
    carries CUDA tensors only)."""
    backend = str(dist.get_backend(group)).lower()
    if ":" in backend:
        return any(part.split(":")[0] == "cpu"
                   for part in backend.split(","))
    return backend != "nccl"


def _timeout_s(group) -> float:
    """The seconds a collective of the group may take: its gloo backend's
    timeout (torch's default where the backend does not say)."""
    try:
        t = group._get_backend(torch.device("cpu")).options._timeout
    except (AttributeError, RuntimeError):
        t = dist.default_pg_timeout
    return t.total_seconds()


def make_process_mesh(data: int | None = None, device=None,
                      group=None, transport: str | None = None) -> Mesh:
    """A mesh whose shards lie in the processes of an initialized
    ``torch.distributed`` group (``group``, else the default group), a
    shard a process: ``data`` rows (the group's size n by default, one row a
    process) of n / data column shards, in rank order (group rank r holds
    shard (r // cols, r % cols)), each on its process's ``device``, by
    default ``cuda:(LOCAL_RANK % device_count)`` (the group rank where
    LOCAL_RANK is unset); pass ``device="cpu"`` for CPU shards. The caller
    initializes the group; building the mesh is collective (every process
    calls it), and with a 'cols' axis it makes a gloo subgroup of each
    row's processes (``dist.new_group``, which every process of the default
    group enters, for every row in the same order).

    transport: the carrier of the shards' messages (``gather_state``, the
    column path). "gloo": host copies over the group, so the group's
    backend must carry CPU tensors (gloo), as it must for the carrier's
    handles and checks either way; "mailbox": the rings of
    ``parallel/mailbox.py`` (a region of each process's device that the
    others map: CUDA IPC on the card, shared memory for CPU shards), which
    needs every process of the group on this host and shards of one device
    type, and its peers' memory mapped (building it maps them); None (the
    default): "mailbox" where every process of the group is on one host
    and its shards are of one device type, else "gloo". An NCCL-only group,
    a ``data`` that does not divide n, an unknown transport and a
    "mailbox" that cannot be had raise LqrConfigError (in every process):
    nothing falls back to another carrier."""
    if transport not in (None,) + TRANSPORTS:
        raise LqrConfigError(
            _("unknown transport {t!r}; use one of {ok}")
            .format(t=transport, ok=", ".join(TRANSPORTS)))
    if not (dist.is_available() and dist.is_initialized()):
        raise LqrConfigError(
            _("make_process_mesh needs an initialized torch.distributed "
              "process group; call torch.distributed.init_process_group "
              "first"))
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    data = n if data is None else data
    if not 1 <= data <= n or n % data != 0:
        raise LqrConfigError(
            _("{n} devices cannot form {d} 'data' rows").format(n=n, d=data))
    if not _takes_cpu(group):
        raise LqrConfigError(
            _("make_process_mesh needs a process group whose backend "
              "carries CPU tensors (gloo); {b} does not")
            .format(b=dist.get_backend(group)))
    if device is None:
        if not torch.cuda.is_available():
            raise LqrConfigError(
                _("make_process_mesh found no CUDA device; pass "
                  "device=\"cpu\" for CPU rows"))
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = resolve_device(device)
    places = [None] * n
    dist.all_gather_object(places, (str(device), socket.gethostname()),
                           group=group)
    names = [x for x, _host in places]
    local = (len({h for _x, h in places}) == 1
             and len({torch.device(x).type for x in names}) == 1)
    if transport is None:
        transport = "mailbox" if local else "gloo"
    elif transport == "mailbox" and not local:
        raise LqrConfigError(
            _("the mailbox transport needs every process of the group on "
              "this host and shards of one device type; the group has "
              "{p}").format(p=", ".join(f"{x} on {h}" for x, h in places)))
    timeout = _timeout_s(group)
    cols = n // data
    me = dist.get_rank(group)
    row_groups = mailboxes = mailbox = None
    if cols > 1:
        row_groups = tuple(
            dist.new_group([dist.get_global_rank(group, r)
                            for r in range(d * cols, (d + 1) * cols)],
                           backend="gloo",
                           timeout=datetime.timedelta(seconds=timeout))
            for d in range(data))
    if transport == "mailbox":
        error = ""
        if cols > 1:
            try:     # a row's processes agree; the rows may not
                mailboxes = tuple(
                    Mailbox(row_groups[d], device, timeout, _CHANNELS)
                    if d == me // cols else None for d in range(data))
            except LqrConfigError as e:
                error = str(e)
        errors = [None] * n
        dist.all_gather_object(errors, error, group=group)
        if any(errors):
            raise LqrConfigError(next(e for e in errors if e))
        # the gather of whole planes: one slot a ring (gather releases its
        # parts at once)
        mailbox = Mailbox(group, device, timeout, ("gather",), slots=1)
    return Mesh(tuple(tuple(torch.device(x)
                            for x in names[d * cols:(d + 1) * cols])
                      for d in range(data)),
                group=group, ranks=tuple(range(n)), row_groups=row_groups,
                transport=transport, mailboxes=mailboxes, mailbox=mailbox)


class ShardedState(NamedTuple):
    """A batched MapState split over a mesh: ``shards[d][c]`` is the MapState
    of data row d's images and (with ``cols``) column shard c's columns, on
    ``mesh.devices[d][c]``; without ``cols`` each row has one shard, on
    ``mesh.devices[d][0]``. On a mesh over processes the shards of other
    processes are None (a row none of whose shards this process holds is
    None). ref_w and depth are the row's, in every shard."""

    mesh: Mesh
    cols: bool
    shards: tuple


_STATE_PLANES = ("ref", "bias", "rig", "vs", "cur_b", "cur_bias", "cur_rig")


def shard_batch_state(st: MapState, mesh: Mesh,
                      cols: bool = False) -> ShardedState:
    """Split a batched MapState over the mesh: the batch over 'data', and
    with cols=True the image columns over 'cols'. On a mesh over processes
    every process passes the whole batch and keeps a copy of its own shard
    (the others are None), so the whole batch can be freed."""
    B, _H, Wb = st.vs.shape
    n_data = mesh.shape["data"]
    if B % n_data != 0:
        raise LqrImageError(
            _("batch of {B} images cannot shard evenly over {n} 'data' "
              "devices; pad the batch to a multiple of {n}")
            .format(B=B, n=n_data))
    n_cols = mesh.shape["cols"] if cols else 1
    if Wb % n_cols != 0:
        raise LqrImageError(
            _("width {w} cannot shard evenly over {n} 'cols' devices")
            .format(w=Wb, n=n_cols))
    Bd, Wl = B // n_data, Wb // n_cols
    local = set(mesh.local_shards)
    copy = mesh.ranks is not None     # no view may keep the whole batch

    def put(a, d, c):
        if a is None:
            return None
        a = a[d * Bd:(d + 1) * Bd]
        if cols:
            a = a[:, :, c * Wl:(c + 1) * Wl]
        a = a.to(mesh.devices[d][c]).contiguous()
        return a.clone() if copy else a

    def shard(d, c):
        sl = slice(d * Bd, (d + 1) * Bd)
        return MapState(**{name: put(getattr(st, name), d, c)
                           for name in _STATE_PLANES},
                        aux=tuple(put(a, d, c) for a in st.aux),
                        ref_w=st.ref_w[sl].copy(), depth=st.depth[sl].copy())

    rows = [None] * n_data
    for d in mesh.local_rows:
        rows[d] = tuple(shard(d, c) if (d, c) in local else None
                        for c in range(n_cols))
    return ShardedState(mesh, cols, tuple(rows))


def _gather_processes(sst: ShardedState) -> MapState:
    """gather_state of a mesh over processes: every shard all-gathered, the
    columns of each row joined, then the rows, onto this process's device.
    The planes go through the group's mailbox under the mailbox carrier,
    else over the group as host copies; the images' widths and depths
    (host arrays) over the group."""
    mesh = sst.mesh
    d0, c0 = mesh.local_shards[0]
    st = sst.shards[d0][c0]
    dev = st.vs.device
    n_data, n_cols = mesh.shape["data"], len(sst.shards[d0])
    box = mesh.mailbox
    planes = [getattr(st, name) for name in _STATE_PLANES] + list(st.aux)
    if box is not None:
        box.reserve({"gather": max(t.numel() * t.element_size()
                                   for t in planes if t is not None)})

    def join(parts, join_cols: bool):
        """The rows in order, each the join of its columns (join_cols) or
        its first column's part; parts in group rank order."""
        rows = [[parts[mesh.rank_of(d, c)] for c in range(n_cols)]
                for d in range(n_data)]
        return torch.cat([torch.cat(r, dim=2) if join_cols else r[0]
                          for r in rows])

    def over_group(t, join_cols: bool):
        host = _to_host("process", t)
        parts = [torch.empty_like(host) for _ in mesh.ranks]
        dist.all_gather(parts, host, group=mesh.group)
        GLOO_MESSAGES["process"] += 1
        return join(parts, join_cols)

    def plane(t):
        if t is None:
            return None
        t0 = time.perf_counter()
        if box is not None:
            out = box.gather("gather", t, lambda p: join(p, sst.cols))
        else:
            out = _from_host("process", over_group(t, sst.cols), dev)
        EXCHANGE_SECONDS["process"] += time.perf_counter() - t0
        EXCHANGES["process"] += 1
        return out

    def host_array(a):
        t0 = time.perf_counter()
        out = over_group(torch.from_numpy(a), False).numpy()
        EXCHANGE_SECONDS["process"] += time.perf_counter() - t0
        EXCHANGES["process"] += 1
        return out

    out = MapState(
        **{name: plane(getattr(st, name)) for name in _STATE_PLANES},
        aux=tuple(plane(a) for a in st.aux),
        ref_w=host_array(st.ref_w), depth=host_array(st.depth))
    if box is not None:
        box.settle()
    return out


def gather_state(sst: ShardedState) -> MapState:
    """The whole batched MapState on the mesh's first device; on a mesh over
    processes, on this process's device in every process (a collective:
    every process of the group calls it)."""
    if sst.mesh.ranks is not None:
        return _gather_processes(sst)
    dev = sst.mesh.devices[0][0]

    def cat(parts):
        if parts[0][0] is None:
            return None
        rows = [torch.cat([p.to(dev) for p in row], dim=2) for row in parts]
        return torch.cat(rows, dim=0)

    def field(name):
        return cat([[getattr(s, name) for s in row] for row in sst.shards])

    n_aux = len(sst.shards[0][0].aux)
    return MapState(
        **{name: field(name) for name in _STATE_PLANES},
        aux=tuple(cat([[s.aux[j] for s in row] for row in sst.shards])
                  for j in range(n_aux)),
        ref_w=np.concatenate([row[0].ref_w for row in sst.shards]),
        depth=np.concatenate([row[0].depth for row in sst.shards]))


def map_data_shards(sst: ShardedState, fn) -> ShardedState:
    """Apply fn(state, batch_slice) -> state to the (unsplit) shard of each
    data row this process holds: the data-parallel resize, with no
    exchange."""
    assert not sst.cols
    out = list(sst.shards)
    for d in sst.mesh.local_rows:
        (st,) = sst.shards[d]
        n = st.vs.shape[0]
        out[d] = (fn(st, slice(d * n, (d + 1) * n)),)
    return sst._replace(shards=tuple(out))


# ---------------------------------------------------------------------------
# column-sharded DP with one halo exchange per block of rows
# ---------------------------------------------------------------------------

def _block_rows(H: int, delta_x: int, Wl: int) -> int:
    """Rows per halo exchange: the largest R dividing H whose halo
    G = R·delta_x is at most half the local width (the exact-cone bound)."""
    for r in (32, 16, 8, 4, 2, 1):
        if H % r == 0 and r * max(delta_x, 1) * 2 <= Wl:
            return r
    return 1


def dp_route(devices, processes: int = 1) -> str:
    """Where a mesh row's column-sharded DP runs, by the placement of its
    shards: "cluster" when every shard lies on one CUDA device in one
    process and they number at most MAX_SHARDS (one dp_sharded launch a
    seam, a cluster block a shard, the halos through distributed shared
    memory), else "blocks" (the per-block loop dp_blocked: one dp_block
    call per block of rows and shard, the halos as messages between the
    shards' devices or processes; CPU shards run its plain version).
    processes: how many processes hold the row's shards."""
    devs = {torch.device(d) for d in devices}
    if (processes == 1 and len(devs) == 1
            and next(iter(devs)).type == "cuda"
            and len(devices) <= MAX_SHARDS):
        return "cluster"
    return "blocks"


class _LocalRow:
    """The exchanges of a mesh row whose column shards all lie in this
    process, shard c on devices[c]: copies to the neighbour's device, the
    gathers a ``torch.cat`` onto the row's first device, and what was
    computed there copied back to each shard."""

    processes = 1

    def __init__(self, devices):
        self.devices = tuple(devices)
        self.n = len(self.devices)
        self.cols = tuple(range(self.n))     # the shards this process holds

    def shift(self, tag: str, to_left, to_right, shape, dtype):
        """to_left(i) / to_right(i): local shard i's message to its left /
        right neighbour (None: nothing goes that way); returns (from_left,
        from_right), each local shard's received message on its device,
        None at the row's edges. tag: the message's kind (a key of _TAGS);
        shape, dtype: a received message's."""
        fl, fr = copy_halos(self.devices, to_left, to_right)
        EXCHANGES["halo"] += sum(m is not None for m in fl + fr)
        return fl, fr

    def gather(self, parts, dim: int = 0) -> torch.Tensor:
        """The row's parts (one a local shard) joined along dim on the
        device where the row's gathered work runs."""
        dev = self.devices[0]
        return torch.cat([parts[0].to(dev)]
                         + [_send("gather", p, dev) for p in parts[1:]],
                         dim=dim)

    def spread(self, parts) -> list:
        """parts[c] (one a column, computed from gathered values) on each
        local shard's device."""
        return [parts[0]] + [_send("gather", p, dv)
                             for p, dv in zip(parts[1:], self.devices[1:])]

    def check_steps(self, steps) -> None:
        """Nothing to check: one process takes every shard's steps."""

    def reserve(self, sizes: dict) -> None:
        """Room for messages of sizes[channel] bytes: nothing to make."""

    def settle(self) -> None:
        """The end of a seam step: nothing to wait for."""


class _ProcessRow:
    """The exchanges of this process's column shard (d, c) with the other
    shards of its mesh row, each in a process of its own: point-to-point
    messages to the neighbours and all-gathers over the row's gloo subgroup,
    as host copies (a device tensor's copy waits for the work that writes
    it). A shift posts all of its sends and receives before it waits on
    any, so neighbours cannot deadlock. Every process of the row computes
    what depends on gathered values itself, so nothing is spread."""

    def __init__(self, mesh: Mesh, d: int, c: int):
        self.n = self.processes = mesh.shape["cols"]
        self.cols = (c,)
        self.devices = (mesh.devices[d][c],)
        self.group = mesh.row_groups[d]
        peer = [dist.get_global_rank(mesh.group, mesh.rank_of(d, j))
                for j in range(self.n)]
        self.left = peer[c - 1] if c > 0 else None
        self.right = peer[c + 1] if c < self.n - 1 else None
        # all_gather's parts come in the subgroup's rank order
        self.slot = [dist.get_group_rank(self.group, g) for g in peer]

    def shift(self, tag: str, to_left, to_right, shape, dtype):
        """As _LocalRow.shift, over gloo."""
        t0 = time.perf_counter()
        ops, bufs = [], {}
        for make, peer in ((to_left, self.left), (to_right, self.right)):
            if make is not None and peer is not None:
                msg = _to_host("halo", make(0))
                ops.append(dist.isend(msg, peer, self.group, _TAGS[tag]))
                EXCHANGES["halo"] += 1
                GLOO_MESSAGES["halo"] += 1
        # the left neighbour sends right, the right neighbour left
        for side, make, peer in (("left", to_right, self.left),
                                 ("right", to_left, self.right)):
            if make is not None and peer is not None:
                bufs[side] = torch.empty(shape, dtype=dtype)
                ops.append(dist.irecv(bufs[side], peer, self.group,
                                      _TAGS[tag]))
        for op in ops:
            op.wait()
        dev = self.devices[0]
        got = [[_from_host("halo", bufs[side], dev)] if side in bufs
               else [None] for side in ("left", "right")]
        EXCHANGE_SECONDS["halo"] += time.perf_counter() - t0
        return got[0], got[1]

    def _all_gather(self, t: torch.Tensor) -> list:
        host = _to_host("gather", t)
        parts = [torch.empty_like(host) for _ in range(self.n)]
        dist.all_gather(parts, host, group=self.group)
        EXCHANGES["gather"] += 1
        return [parts[s] for s in self.slot]

    def gather(self, parts, dim: int = 0) -> torch.Tensor:
        """The row's parts joined along dim on this process's device: an
        all-gather over the row (this process's part is its shard's)."""
        t0 = time.perf_counter()
        (t,) = parts
        GLOO_MESSAGES["gather"] += 1
        out = _from_host("gather", torch.cat(self._all_gather(t), dim=dim),
                         self.devices[0])
        EXCHANGE_SECONDS["gather"] += time.perf_counter() - t0
        return out

    def spread(self, parts) -> list:
        """This shard's part, already on its device: no message."""
        return [parts[self.cols[0]]]

    def check_steps(self, steps) -> None:
        """Raise LqrConfigError unless every process of the row takes the
        same seam steps (steps: this process's counts, depths and widths);
        a row that disagrees would hang in its exchanges."""
        mine = torch.as_tensor(np.asarray(steps, np.int64))
        if any(not torch.equal(p, mine) for p in self._all_gather(mine)):
            raise LqrConfigError(
                _("the processes of a mesh row disagree on the seams to "
                  "carve: every process must pass the same images and "
                  "counts"))

    def reserve(self, sizes: dict) -> None:
        """Room for messages of sizes[channel] bytes: gloo needs none."""

    def settle(self) -> None:
        """The end of a seam step: gloo's messages were waited on."""


class _MailboxRow(_ProcessRow):
    """The exchanges of this process's column shard (d, c) through its
    row's mailbox (``Mesh.mailboxes[d]``): the same messages as
    _ProcessRow's, each put into the receiver's ring on this process's
    stream and read in place there, with no host copy and no message over
    the group (but check_steps'). A shift posts both of its sends before
    either wait, so no stream waits on a flag whose writer waits on it. A
    seam step ends in ``settle``, the host's one wait, with the group's
    timeout."""

    def __init__(self, mesh: Mesh, d: int, c: int):
        super().__init__(mesh, d, c)
        self.box = mesh.mailboxes[d]

    def shift(self, tag: str, to_left, to_right, shape, dtype):
        """As _LocalRow.shift, through the mailbox."""
        t0 = time.perf_counter()
        c = self.cols[0]
        for make, j in ((to_left, c - 1), (to_right, c + 1)):
            if make is not None and 0 <= j < self.n:
                self.box.send(tag, self.slot[j], make(0).contiguous())
                EXCHANGES["halo"] += 1
        # the left neighbour sends right, the right neighbour left
        got = [[self.box.recv(tag, self.slot[j], shape, dtype)]
               if make is not None and 0 <= j < self.n else [None]
               for make, j in ((to_right, c - 1), (to_left, c + 1))]
        EXCHANGE_SECONDS["halo"] += time.perf_counter() - t0
        return got[0], got[1]

    def gather(self, parts, dim: int = 0) -> torch.Tensor:
        """As _ProcessRow.gather, through the mailbox."""
        t0 = time.perf_counter()
        (t,) = parts
        out = self.box.gather(
            "gather", t, lambda p: torch.cat([p[s] for s in self.slot],
                                             dim=dim))
        EXCHANGES["gather"] += 1
        EXCHANGE_SECONDS["gather"] += time.perf_counter() - t0
        return out

    def reserve(self, sizes: dict) -> None:
        """Slots of sizes[channel] bytes in the row's rings (a collective of
        the row; a larger region only where the present one is short)."""
        self.box.reserve(sizes)

    def settle(self) -> None:
        """The end of a seam step: wait until this process's stream has
        run it (TimeoutError past the group's timeout)."""
        self.box.settle()


def _row(mesh: Mesh, d: int):
    """The exchanges of mesh row d's column shards that this process
    holds."""
    if mesh.ranks is None:
        return _LocalRow(mesh.devices[d])
    (c,) = [c for dd, c in mesh.local_shards if dd == d]
    if mesh.transport == "mailbox":
        return _MailboxRow(mesh, d, c)
    return _ProcessRow(mesh, d, c)


def _dp_local_blocked(e_loc, rig_loc, pref_left: bool, delta_x: int,
                      has_rig: bool, H: int, R: int, devices, row=None):
    """The column-sharded forward DP, placed by dp_route. e_loc / rig_loc:
    the [H, Wl] tensors of the row's shards this process holds (rig_loc
    None without rigidity), on devices[i]; row: the row's exchanges
    (_LocalRow(devices) by default). Returns (per-shard M_last [Wl],
    per-shard bp [H, Wl] int8).

    Each block of R rows, every shard takes a halo from each neighbour. In
    one process dp_blocked copies them and dp_sharded's blocks read them
    from each other's shared memory, both counted here; across processes
    the row's shift sends and counts them."""
    processes = 1 if row is None else row.processes
    n = len(e_loc)
    if processes == 1 and n > 1 and delta_x > 0:
        EXCHANGES["halo"] += 2 * (n - 1) * (H // R)
    if dp_route(devices, processes) == "cluster":
        return dp_sharded(e_loc, rig_loc, pref_left, delta_x, has_rig, H, R)
    if processes > 1:
        return dp_blocked(e_loc, rig_loc, pref_left, delta_x, has_rig, H, R,
                          devices, shift=functools.partial(row.shift, "dp"))
    return dp_blocked(e_loc, rig_loc, pref_left, delta_x, has_rig, H, R,
                      devices)


def find_seam_sharded(mesh: Mesh, e_tot, rig, pref_left: bool,
                      delta_x: int, has_rig: bool) -> torch.Tensor:
    """Column-sharded seam search over the first row of a mesh in one
    process. e_tot: [H, Wb] (+inf at invalid lanes, bias folded in). The
    forward DP runs sharded, the backtrack on the gathered map; the seam
    [H] i32 (on the first device) equals core.dp.find_seam's."""
    H, Wb = e_tot.shape
    devs = mesh.devices[0]
    n = len(devs)
    if Wb % n != 0:
        raise LqrImageError(
            _("width {w} cannot shard evenly over {n} 'cols' devices")
            .format(w=Wb, n=n))
    Wl = Wb // n
    R = _block_rows(H, delta_x, Wl)
    row = _LocalRow(devs)

    def split(a):
        return [a[:, c * Wl:(c + 1) * Wl].to(devs[c]).contiguous()
                for c in range(n)]

    M, bp = _dp_local_blocked(split(e_tot), split(rig) if has_rig else None,
                              pref_left, delta_x, has_rig, H, R, devs)
    return dp_cuda.backtrack(row.gather(M), row.gather(bp, dim=1), pref_left)


def _local_energy(cb, w: int, nrg: int, glane, row):
    """Per-shard energy [H, Wl] of the compacted reader planes at width w:
    the x gradient with a one-column halo from each neighbour (the image's
    edges replicated), the rest as core/energy.py computes it."""
    if EnergyFunc(nrg) == EnergyFunc.NULL:
        return [torch.where(g < w, torch.zeros_like(b), INF)
                for b, g in zip(cb, glane)]
    H = cb[0].shape[0]
    fl, fr = row.shift("energy", lambda i: cb[i][:, :1],
                       lambda i: cb[i][:, -1:], (H, 1), cb[0].dtype)
    out = []
    for b, g, bl_col, br_col in zip(cb, glane, fl, fr):
        if bl_col is None:
            bl_col = torch.zeros_like(b[:, :1])
        if br_col is None:
            br_col = torch.zeros_like(b[:, :1])
        br = torch.cat([b[:, 1:], br_col], dim=1)
        br = torch.where(g >= w - 1, b, br)      # replicate right
        bl = torch.cat([bl_col, b[:, :-1]], dim=1)
        bl = torch.where(g == 0, b, bl)          # replicate left
        e = energy_from_gx((br - bl) * _f32(0.5), b, nrg)
        out.append(torch.where(g < w, e, INF))
    return out


def _carve_seam_local(cb, cbs, crg, vs, w: int, s: int, pref_left: bool,
                      ref_w: int, *, row, H: int, delta_x: int, nrg: int,
                      R: int):
    """One carve step of one image on the column shards of its mesh row
    that this process holds (lists of [H, Wl] tensors, a local shard each;
    cbs / crg None when absent), row: the row's exchanges. Energy with a
    one-column halo, the blocked DP, the backtrack of the gathered map, the
    compaction with one carry column from the right neighbour, and the
    commit of seam s to vs. Returns (cb', cbs', crg', vs').

    The commit: a visible column's global rank among its row's visible
    columns is its rank within its shard plus the exclusive prefix of the
    shards' counts, so seam s lands where that rank equals seam[y]."""
    Wl = cb[0].shape[-1]
    glane = [c * Wl + torch.arange(Wl, dtype=torch.int32, device=dv)[None, :]
             for c, dv in zip(row.cols, row.devices)]
    local = range(len(cb))

    e = _local_energy(cb, w, nrg, glane, row)
    if cbs is not None:
        e = [torch.where(glane[i] < w, e[i] + cbs[i], INF) for i in local]
    M, bp = _dp_local_blocked(e, crg, pref_left, delta_x, crg is not None,
                              H, R, row.devices, row)
    seam = dp_cuda.backtrack(row.gather(M), row.gather(bp, dim=1), pref_left)
    seams = row.spread([seam] * row.n)

    # compaction: a left shift of columns >= seam, the right neighbour's
    # first column (one packed message of every plane's) moving in at the
    # end
    planes = [cb] + [p for p in (cbs, crg) if p is not None]
    _fl, carry = row.shift(
        "carry", lambda i: torch.stack([p[i][:, 0] for p in planes]), None,
        (len(planes), H), cb[0].dtype)
    out = [[None] * len(cb) for _ in planes]
    counts = []
    for i in local:
        recv = (carry[i] if carry[i] is not None
                else torch.zeros((len(planes), H), dtype=cb[i].dtype,
                                 device=cb[i].device))
        ge = glane[i] >= seams[i][:, None]
        keep = glane[i] < w - 1
        for j, p in enumerate(planes):
            shifted = torch.cat([p[i][:, 1:], recv[j][:, None]], dim=1)
            out[j][i] = torch.where(keep, torch.where(ge, shifted, p[i]), 0)
        visible = (vs[i] == 0) & (glane[i] < ref_w)
        counts.append(visible.to(torch.int32).sum(dim=1))

    # commit: the exclusive prefix of the shards' visible counts per row
    allc = row.gather([k[None] for k in counts])              # [n, H]
    prefix = row.spread(list((torch.cumsum(allc, dim=0) - allc).unbind(0)))
    vs_out = []
    for i in local:
        visible = (vs[i] == 0) & (glane[i] < ref_w)
        vis = visible.to(torch.int32)
        rank = torch.cumsum(vis, dim=1) - vis + prefix[i][:, None]
        hit = visible & (rank == seams[i][:, None])
        vs_out.append(torch.where(hit, s, vs[i]))
    it = iter(out[1:])
    cbs2 = next(it) if cbs is not None else None
    crg2 = next(it) if crg is not None else None
    return out[0], cbs2, crg2, vs_out


def _message_bytes(H: int, Wl: int, R: int, delta_x: int, planes: int,
                   has_rig: bool) -> list:
    """The largest message of each of _CHANNELS in a column-sharded carve
    of [H, Wl] shards, in bytes: the energy's column, the DP's halo plane
    of R rows, the compaction's carry of ``planes`` columns, and the
    largest of the backtrack's frontier and backpointers and the commit's
    counts."""
    G = max(R * delta_x, 1)
    return [4 * H, 4 * (1 + R * (2 if has_rig else 1)) * G, 4 * planes * H,
            max(4 * Wl, H * Wl, 4 * H)]


def extend_map_sharded(mesh: Mesh, cfg: EngineConfig, sst: ShardedState,
                       k) -> ShardedState:
    """The column-sharded resize: k[b] further seams (scalar or [B]) into
    every image of a state placed by shard_batch_state(mesh, cols=True).
    Each seam step runs on the image's column shards (_carve_seam_local),
    on a mesh over processes each process running its own shard's part
    (the row's processes first compare their steps and reserve their
    messages' room; each step then ends in the row's settle); the
    visibility map equals the unsharded resize's bit for bit."""
    H, Wb = cfg.H, cfg.Wb
    n_cols = mesh.shape["cols"]
    R = _block_rows(H, cfg.delta_x, Wb // n_cols)
    d0 = mesh.local_rows[0]
    Bd = next(s for s in sst.shards[d0] if s is not None).vs.shape[0]
    k = np.broadcast_to(np.asarray(k, np.int64), (Bd * mesh.shape["data"],))
    rows = list(sst.shards)
    for d in mesh.local_rows:
        row = _row(mesh, d)
        held = [sst.shards[d][c] for c in row.cols]
        kd = k[d * Bd:(d + 1) * Bd]
        ref_w, depth = held[0].ref_w, held[0].depth.copy()
        sizes = _message_bytes(
            H, Wb // n_cols, R, cfg.delta_x,
            sum(getattr(held[0], f) is not None
                for f in ("cur_b", "cur_bias", "cur_rig")),
            held[0].cur_rig is not None)
        row.check_steps(np.concatenate([kd, depth, ref_w, sizes]))
        row.reserve(dict(zip(_CHANNELS, sizes)))

        def split(name):
            if getattr(held[0], name) is None:
                return [None] * Bd
            return [[getattr(s, name)[i] for s in held] for i in range(Bd)]

        cb, cbs, crg, vs = (split(f) for f in ("cur_b", "cur_bias",
                                               "cur_rig", "vs"))
        for j in range(int(kd.max()) if Bd else 0):
            for i in range(Bd):
                if j >= kd[i]:
                    continue
                s = int(depth[i] + 1)
                cb[i], cbs[i], crg[i], vs[i] = _carve_seam_local(
                    cb[i], cbs[i], crg[i], vs[i], int(ref_w[i] - depth[i]),
                    s, eng.pref_is_left(s, cfg.side_switch_freq),
                    int(ref_w[i]), row=row, H=H, delta_x=cfg.delta_x,
                    nrg=cfg.nrg, R=R)
                depth[i] += 1
                row.settle()

        def join(parts, i, old):
            if old is None:
                return None
            return torch.stack([parts[b][i] for b in range(Bd)])

        new = list(sst.shards[d])
        for i, (c, st) in enumerate(zip(row.cols, held)):
            new[c] = st._replace(cur_b=join(cb, i, st.cur_b),
                                 cur_bias=join(cbs, i, st.cur_bias),
                                 cur_rig=join(crg, i, st.cur_rig),
                                 vs=join(vs, i, st.vs), depth=depth.copy())
        rows[d] = tuple(new)
    return sst._replace(shards=tuple(rows))


def sharded_seam_step(mesh: Mesh, images, widths, pref_left: bool,
                      delta_x: int = 1, nrg: int = 0, bias=None, rig=None,
                      has_bias: bool = False, has_rig: bool = False):
    """One carve step over a batch with the column-sharded seam search.

    images: [B, H, Wb, C] u8; widths: [B]; bias / rig: [B, H, Wb] f32 (or
    None). Computes each image's energy, folds in the bias, finds the seam
    with find_seam_sharded and compacts every plane. Returns (images',
    bias', rig', seams [B, H] i32)."""
    B, H, Wb, C = images.shape
    dev = images.device
    lane = torch.arange(Wb, device=dev)[None, :]
    outs = []
    for b in range(B):
        w = int(widths[b])
        e = energy_from_plane(reader_plane(images[b], nrg), w, nrg)
        if has_bias:
            e = torch.where(lane < w, e + bias[b], INF)
        seam = find_seam_sharded(mesh, e, rig[b] if has_rig else None,
                                 pref_left, delta_x, has_rig).to(dev)
        ge = lane >= seam[:, None]
        keep = lane < w - 1

        def compact(a):
            g, k = (ge[..., None], keep[..., None]) if a.ndim == 3 else (ge,
                                                                          keep)
            return torch.where(k, torch.where(g, torch.roll(a, -1, dims=1),
                                              a), 0)

        outs.append((compact(images[b]),
                     compact(bias[b]) if has_bias else None,
                     compact(rig[b]) if has_rig else None, seam))
    img2, bias2, rig2, seams = zip(*outs)
    return (torch.stack(img2),
            torch.stack(bias2) if has_bias else bias,
            torch.stack(rig2) if has_rig else rig, torch.stack(seams))
