"""Sharded carving: batch data-parallelism and column sharding of the DP.

Counterpart of ``lqr_tpu.parallel.sharding``:

- ``Mesh`` is a (data, cols) grid of ``torch.device`` s. A device may
  appear more than once: four column shards on one GPU run the column-
  sharded path on a one-GPU machine, eight CPU shards run it in the tests.
  ``make_mesh`` builds a mesh in one process, the way ``shard_map`` runs
  one controller. ``make_process_mesh`` builds one whose 'data' rows lie
  in the processes of a ``torch.distributed`` group, one row a process, as
  a JAX mesh spans the devices of several processes.
- A sharded state (``ShardedState``) keeps each shard as its own tensors on
  its device; on a mesh over processes each process holds its own row
  only. Every exchange between column shards is an explicit copy to the
  neighbour's device (but the DP's halos on one CUDA device, below);
  the gathers (the frontier and backpointers for the backtrack, the row
  counts for the commit) are a ``torch.cat`` onto one device. ``gather_state``
  of a mesh over processes all-gathers the rows over the group, as host
  copies (the group's backend must take CPU tensors: gloo).
- ``EXCHANGES`` counts the messages between shards, by kind: each is a
  copy where the two shards lie on distinct devices or processes, and a
  read in place where they share a device.

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

- every shard of the mesh row on one CUDA device, at most 8 of them: one
  launch of ``dp_sharded`` (``csrc/dp_sharded.cu``) a seam, a thread-block
  cluster of one block per shard with the halos read from the neighbours'
  shared memory and planes, at any shard width;
- shards on distinct devices, or more than 8 on one device (more blocks
  than a cluster holds): ``dp_blocked``, one ``dp_block`` launch
  (``csrc/dp_block.cu``) per block of rows and shard, the halos sent as one
  packed copy per neighbour per block, the only form that crosses devices;
- CPU shards: ``dp_blocked`` with the plain version of ``dp_block``.

The backtrack of the gathered map runs on the backtrack kernel on CUDA
tensors and on its plain version on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import EnergyFunc
from ..core import engine as eng
from ..core.energy import (_f32, energy_from_gx, energy_from_plane,
                           reader_plane)
from ..core.state import EngineConfig, MapState, resolve_device
from ..errors import LqrConfigError, LqrImageError
from ..i18n import _
from ..ops import dp_cuda
from ..ops.dp_block import MAX_SHARDS, dp_blocked, dp_sharded

__all__ = ["Mesh", "ShardedState", "make_mesh", "make_process_mesh",
           "shard_batch_state", "gather_state", "map_data_shards",
           "find_seam_sharded", "extend_map_sharded", "sharded_seam_step",
           "dp_route", "EXCHANGES"]

INF = float("inf")

# Messages between shards, by kind: "halo" (a column shard's neighbour
# values: the energy's one column, the DP's halo of each block of rows,
# the compaction's carry column), "gather" (to and from a mesh row's first
# shard: the backtrack's inputs, the seam, the commit's row counts) and
# "process" (an all-gather over a mesh's process group).
EXCHANGES = {"halo": 0, "gather": 0, "process": 0}


def _send(kind: str, t: torch.Tensor, device) -> torch.Tensor:
    """t, a shard's tensor, handed to another shard on ``device``."""
    EXCHANGES[kind] += 1
    return t.to(device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, cols) grid of devices: ``devices[d][c]``. A mesh over
    processes (``make_process_mesh``) also has the ``torch.distributed``
    group and ``ranks[d]``, the group rank of the process that holds row d;
    a device of another process's row is that process's device."""

    devices: tuple
    group: object = None
    ranks: tuple | None = None

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "cols": len(self.devices[0])}

    @property
    def local_rows(self) -> tuple:
        """The 'data' rows this process holds: every row of a mesh in one
        process."""
        if self.ranks is None:
            return tuple(range(len(self.devices)))
        me = dist.get_rank(self.group)
        return tuple(d for d, r in enumerate(self.ranks) if r == me)


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


def make_process_mesh(data: int | None = None, device=None,
                      group=None) -> Mesh:
    """A mesh whose 'data' rows lie in the processes of an initialized
    ``torch.distributed`` group (``group``, else the default group): one
    row a process, in rank order, on the process's ``device``, by default
    ``cuda:(LOCAL_RANK % device_count)`` (the group rank where LOCAL_RANK is
    unset); pass ``device="cpu"`` for CPU rows. The caller initializes the
    group; building the mesh is collective (every process calls it).

    data: the 'data' rows, the group's size by default. Fewer rows would
    put a 'cols' axis across processes, which raises LqrConfigError: its
    halo exchange between GPUs needs a machine with two or more."""
    if not (dist.is_available() and dist.is_initialized()):
        raise LqrConfigError(
            _("make_process_mesh needs an initialized torch.distributed "
              "process group; call torch.distributed.init_process_group "
              "first"))
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    if data is not None and data != n:
        if not 1 <= data <= n or n % data != 0:
            raise LqrConfigError(
                _("{n} devices cannot form {d} 'data' rows")
                .format(n=n, d=data))
        raise LqrConfigError(
            _("{n} processes as {d} 'data' rows would put a 'cols' axis "
              "across processes: its halo exchange between GPUs needs a "
              "machine with two or more; make_process_mesh puts one 'data' "
              "row in each process").format(n=n, d=data))
    if device is None:
        if not torch.cuda.is_available():
            raise LqrConfigError(
                _("make_process_mesh found no CUDA device; pass "
                  "device=\"cpu\" for CPU rows"))
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    names = [None] * n
    dist.all_gather_object(names, str(resolve_device(device)), group=group)
    return Mesh(tuple((torch.device(d),) for d in names), group=group,
                ranks=tuple(range(n)))


class ShardedState(NamedTuple):
    """A batched MapState split over a mesh: ``shards[d][c]`` is the MapState
    of data row d's images and (with ``cols``) column shard c's columns, on
    ``mesh.devices[d][c]``; without ``cols`` each row has one shard, on
    ``mesh.devices[d][0]``. ref_w and depth are the row's, in every shard."""

    mesh: Mesh
    cols: bool
    shards: tuple


_STATE_PLANES = ("ref", "bias", "rig", "vs", "cur_b", "cur_bias", "cur_rig")


def shard_batch_state(st: MapState, mesh: Mesh,
                      cols: bool = False) -> ShardedState:
    """Split a batched MapState over the mesh: the batch over 'data', and
    with cols=True the image columns over 'cols'. On a mesh over processes
    every process passes the whole batch and keeps a copy of its own rows
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

    copy = mesh.ranks is not None     # no view may keep the whole batch

    def put(a, d, c):
        if a is None:
            return None
        a = a[d * Bd:(d + 1) * Bd]
        if cols:
            a = a[:, :, c * Wl:(c + 1) * Wl]
        a = a.to(mesh.devices[d][c]).contiguous()
        return a.clone() if copy else a

    rows = [None] * n_data
    for d in mesh.local_rows:
        sl = slice(d * Bd, (d + 1) * Bd)
        rows[d] = tuple(
            MapState(**{name: put(getattr(st, name), d, c)
                        for name in _STATE_PLANES},
                     aux=tuple(put(a, d, c) for a in st.aux),
                     ref_w=st.ref_w[sl].copy(), depth=st.depth[sl].copy())
            for c in range(n_cols))
    return ShardedState(mesh, cols, tuple(rows))


def _gather_processes(sst: ShardedState) -> MapState:
    """gather_state of a mesh over processes: every row's shard all-gathered
    over the group as host copies, onto this process's device."""
    mesh = sst.mesh
    (st,) = sst.shards[mesh.local_rows[0]]
    dev = st.vs.device

    def gather(t):
        """t of every row, in row order, on the host."""
        host = t.cpu().contiguous()
        parts = [torch.empty_like(host) for _ in mesh.ranks]
        dist.all_gather(parts, host, group=mesh.group)
        EXCHANGES["process"] += 1
        return torch.cat([parts[r] for r in mesh.ranks])

    def plane(t):
        return None if t is None else gather(t).to(dev)

    return MapState(
        **{name: plane(getattr(st, name)) for name in _STATE_PLANES},
        aux=tuple(plane(a) for a in st.aux),
        ref_w=gather(torch.from_numpy(st.ref_w)).numpy(),
        depth=gather(torch.from_numpy(st.depth)).numpy())


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


def dp_route(devices) -> str:
    """Where a mesh row's column-sharded DP runs, by the placement of its
    shards: "cluster" when every shard lies on one CUDA device and they
    number at most MAX_SHARDS (one dp_sharded launch a seam, a cluster
    block a shard, the halos through distributed shared memory), else
    "blocks" (the per-block loop dp_blocked: one dp_block call per block of
    rows and shard, the halos as copies between the shards' devices; CPU
    shards run its plain version)."""
    devs = {torch.device(d) for d in devices}
    if (len(devs) == 1 and next(iter(devs)).type == "cuda"
            and len(devices) <= MAX_SHARDS):
        return "cluster"
    return "blocks"


def _dp_local_blocked(e_loc, rig_loc, pref_left: bool, delta_x: int,
                      has_rig: bool, H: int, R: int, devices):
    """The column-sharded forward DP, placed by dp_route. e_loc / rig_loc:
    per-shard [H, Wl] tensors (rig_loc None without rigidity), shard c on
    devices[c]. Returns (per-shard M_last [Wl], per-shard bp [H, Wl]
    int8).

    Each block of R rows, every shard takes a halo from each neighbour:
    dp_blocked sends them as packed copies, dp_sharded's blocks read them
    from each other's shared memory; both count here."""
    n = len(e_loc)
    if n > 1 and delta_x > 0:
        EXCHANGES["halo"] += 2 * (n - 1) * (H // R)
    if dp_route(devices) == "cluster":
        return dp_sharded(e_loc, rig_loc, pref_left, delta_x, has_rig, H, R)
    return dp_blocked(e_loc, rig_loc, pref_left, delta_x, has_rig, H, R,
                      devices)


def _backtrack_gathered(M_loc, bp_loc, pref_left: bool, dev):
    """The seam [H] on dev, from the shards' frontiers and backpointers
    gathered there."""
    M_all = torch.cat([M_loc[0].to(dev)]
                      + [_send("gather", m, dev) for m in M_loc[1:]])
    bp_all = torch.cat([bp_loc[0].to(dev)]
                       + [_send("gather", b, dev) for b in bp_loc[1:]], dim=1)
    return dp_cuda.backtrack(M_all, bp_all, pref_left)


def find_seam_sharded(mesh: Mesh, e_tot, rig, pref_left: bool,
                      delta_x: int, has_rig: bool) -> torch.Tensor:
    """Column-sharded seam search over the mesh's first row. e_tot:
    [H, Wb] (+inf at invalid lanes, bias folded in). The forward DP runs
    sharded, the backtrack on the gathered map; the seam [H] i32 (on the
    first device) equals core.dp.find_seam's."""
    H, Wb = e_tot.shape
    devs = mesh.devices[0]
    n = len(devs)
    if Wb % n != 0:
        raise LqrImageError(
            _("width {w} cannot shard evenly over {n} 'cols' devices")
            .format(w=Wb, n=n))
    Wl = Wb // n
    R = _block_rows(H, delta_x, Wl)

    def split(a):
        return [a[:, c * Wl:(c + 1) * Wl].to(devs[c]).contiguous()
                for c in range(n)]

    M, bp = _dp_local_blocked(split(e_tot), split(rig) if has_rig else None,
                              pref_left, delta_x, has_rig, H, R, devs)
    return _backtrack_gathered(M, bp, pref_left, devs[0])


def _local_energy(cb, w: int, nrg: int, glane, devices):
    """Per-shard energy [H, Wl] of the compacted reader planes at width w:
    the x gradient with a one-column halo from each neighbour (the image's
    edges replicated), the rest as core/energy.py computes it."""
    n = len(cb)
    out = []
    for c, b in enumerate(cb):
        if EnergyFunc(nrg) == EnergyFunc.NULL:
            e = torch.zeros_like(b)
        else:
            bl_col = (_send("halo", cb[c - 1][:, -1:], devices[c]) if c > 0
                      else torch.zeros_like(b[:, :1]))
            br_col = (_send("halo", cb[c + 1][:, :1], devices[c])
                      if c < n - 1 else torch.zeros_like(b[:, :1]))
            br = torch.cat([b[:, 1:], br_col], dim=1)
            br = torch.where(glane[c] >= w - 1, b, br)   # replicate right
            bl = torch.cat([bl_col, b[:, :-1]], dim=1)
            bl = torch.where(glane[c] == 0, b, bl)       # replicate left
            e = energy_from_gx((br - bl) * _f32(0.5), b, nrg)
        out.append(torch.where(glane[c] < w, e, INF))
    return out


def _carve_seam_local(cb, cbs, crg, vs, w: int, s: int, pref_left: bool,
                      ref_w: int, *, devices, H: int, delta_x: int, nrg: int,
                      R: int):
    """One carve step of one image on its column shards (lists of [H, Wl]
    tensors; cbs / crg None when absent): energy with a one-column halo,
    the blocked DP, the backtrack of the gathered map, the compaction with
    one carry column from the right neighbour, and the commit of seam s to
    vs. Returns (cb', cbs', crg', vs').

    The commit: a visible column's global rank among its row's visible
    columns is its rank within its shard plus the exclusive prefix of the
    shards' counts, so seam s lands where that rank equals seam[y]."""
    n = len(cb)
    Wl = cb[0].shape[-1]
    glane = [c * Wl + torch.arange(Wl, dtype=torch.int32, device=dv)[None, :]
             for c, dv in enumerate(devices)]

    e = _local_energy(cb, w, nrg, glane, devices)
    if cbs is not None:
        e = [torch.where(glane[c] < w, e[c] + cbs[c], INF) for c in range(n)]
    M, bp = _dp_local_blocked(e, crg, pref_left, delta_x, crg is not None,
                              H, R, devices)
    seam = _backtrack_gathered(M, bp, pref_left, devices[0])

    # compaction: a left shift of columns >= seam, the right neighbour's
    # first column (one packed copy of every plane's) moving in at the end
    planes = [cb] + [p for p in (cbs, crg) if p is not None]
    packed = [torch.stack([p[c][:, 0] for p in planes]) for c in range(n)]
    out = [[None] * n for _ in planes]
    counts, seams = [], []
    for c in range(n):
        seam_c = seam if c == 0 else _send("gather", seam, devices[c])
        seams.append(seam_c)
        recv = (_send("halo", packed[c + 1], devices[c]) if c < n - 1
                else torch.zeros_like(packed[c]))
        ge = glane[c] >= seam_c[:, None]
        keep = glane[c] < w - 1
        for i, p in enumerate(planes):
            shifted = torch.cat([p[c][:, 1:], recv[i][:, None]], dim=1)
            out[i][c] = torch.where(keep, torch.where(ge, shifted, p[c]), 0)
        visible = (vs[c] == 0) & (glane[c] < ref_w)
        counts.append(visible.to(torch.int32).sum(dim=1))

    # commit: the exclusive prefix of the shards' visible counts per row
    allc = torch.stack([counts[0]] + [_send("gather", k, devices[0])
                                      for k in counts[1:]])     # [n, H]
    prefix = torch.cumsum(allc, dim=0) - allc
    vs_out = []
    for c in range(n):
        visible = (vs[c] == 0) & (glane[c] < ref_w)
        vis = visible.to(torch.int32)
        pre = prefix[c] if c == 0 else _send("gather", prefix[c], devices[c])
        rank = torch.cumsum(vis, dim=1) - vis + pre[:, None]
        hit = visible & (rank == seams[c][:, None])
        vs_out.append(torch.where(hit, s, vs[c]))
    it = iter(out[1:])
    cbs2 = next(it) if cbs is not None else None
    crg2 = next(it) if crg is not None else None
    return out[0], cbs2, crg2, vs_out


def extend_map_sharded(mesh: Mesh, cfg: EngineConfig, sst: ShardedState,
                       k) -> ShardedState:
    """The column-sharded resize: k[b] further seams (scalar or [B]) into
    every image of a state placed by shard_batch_state(mesh, cols=True).
    Each seam step runs on the image's column shards (_carve_seam_local);
    the visibility map equals the unsharded resize's bit for bit."""
    H, Wb = cfg.H, cfg.Wb
    n_cols = mesh.shape["cols"]
    R = _block_rows(H, cfg.delta_x, Wb // n_cols)
    B = sum(row[0].vs.shape[0] for row in sst.shards)
    k = np.broadcast_to(np.asarray(k, np.int64), (B,))
    rows, start = [], 0
    for d, row in enumerate(sst.shards):
        devs = mesh.devices[d]
        Bd = row[0].vs.shape[0]
        kd = k[start:start + Bd]
        start += Bd
        ref_w, depth = row[0].ref_w, row[0].depth.copy()

        def split(name):
            if getattr(row[0], name) is None:
                return [None] * Bd
            return [[getattr(s, name)[i] for s in row] for i in range(Bd)]

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
                    int(ref_w[i]), devices=devs, H=H, delta_x=cfg.delta_x,
                    nrg=cfg.nrg, R=R)
                depth[i] += 1

        def join(parts, c, old):
            if old is None:
                return None
            return torch.stack([parts[i][c] for i in range(Bd)])

        rows.append(tuple(
            s._replace(cur_b=join(cb, c, s.cur_b),
                       cur_bias=join(cbs, c, s.cur_bias),
                       cur_rig=join(crg, c, s.cur_rig),
                       vs=join(vs, c, s.vs), depth=depth.copy())
            for c, s in enumerate(row)))
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
