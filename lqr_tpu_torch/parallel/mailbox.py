"""The mailbox carrier: messages between the processes of a mesh, moved from
one process's buffer into another's with no host copy and no message over
the process group.

The counterpart of the collectives ``lqr_tpu.parallel.sharding`` compiles
into its program (``ppermute`` of the halos and the carry column,
``all_gather`` of the backtrack's inputs and the row counts): there the
compiler moves device buffers between the shards' devices; here each
process of a ``torch.distributed`` group owns a region of memory that every
other process of the group maps, and the messages go through rings in it.

- A ring runs from one sender to one receiver on one channel (the tags of
  ``sharding._TAGS`` and "gather"). It has ``slots`` slots, each as large
  as the channel's largest message, and a 64-bit flag a slot, all in the
  receiver's region; and one credit word in the sender's region.
- Message q of a ring (sequence numbers count from 0 for each region and
  never wrap) goes to slot q mod S. The sender waits until the credit is
  at least q - S + 1 (the slot's last message was released), copies the
  message into the slot, and writes q + 1 into the slot's flag. The
  receiver waits until the flag is at least q + 1, reads the slot in place,
  and releases it by writing q + 1 into the sender's credit word.
- A message received by ``recv`` is read in place and stays valid until
  the next ``recv`` on its ring, which releases it first (the column path
  consumes each halo before it asks for the next: the ``torch.cat`` of its
  unpack is its copy); so a ring that ``recv`` reads needs S >= 2.
  ``gather`` releases its parts as soon as it has joined them.

Each process's device decides the memory. On CUDA a region is one
``cudaMalloc`` allocation (``csrc/mailbox.cu``) that the others open through
CUDA IPC; the copies, the flag and credit writes and the waits are enqueued
on the current stream (``cuStreamWriteValue64``, ``cuStreamWaitValue64``),
so the host neither copies nor waits: ``settle`` is the host's one wait, by
polling an event against a deadline. On the CPU (the host model, which the
tests run) a region is a ``multiprocessing.shared_memory`` segment that
every process maps; the waits are host polls against the same deadline.
Either way a peer that stops sending fails the wait within the timeout
(TimeoutError) instead of hanging.

Regions are sized by ``reserve``, a collective of the group: it allocates a
larger region and trades the handles over the group (gloo) only when a
channel needs larger slots than the region has; that is the only traffic
over the group.
"""

from __future__ import annotations

import ctypes
import math
import time
from multiprocessing import shared_memory

import torch
import torch.distributed as dist

from ..errors import LqrConfigError
from ..i18n import _
from ..ops import _build

__all__ = ["Mailbox", "SLOTS"]

SLOTS = 2          # slots a ring whose messages recv reads in place
_ALIGN = 256       # bytes: every slot, flag block and credit block


def _round_up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class _CudaRegion:
    """A region of this process's CUDA device, and the handle another
    process opens it with."""

    def __init__(self, nbytes: int, device: torch.device):
        self.lib = _build.load()
        ptr = ctypes.c_void_p()
        with torch.cuda.device(device):
            self._check(self.lib.lqr_mb_alloc(nbytes, ctypes.byref(ptr)),
                        "lqr_mb_alloc")
            handle = ctypes.create_string_buffer(64)
            self._check(self.lib.lqr_mb_handle(ptr, handle), "lqr_mb_handle")
        self.base, self.handle, self.device = ptr.value, handle.raw, device
        self.bytes = torch.as_tensor(_CudaArray(self.base, nbytes),
                                     device=device)

    def _check(self, rc: int, what: str) -> None:
        _build.check(self.lib, rc, what)

    def free(self) -> None:
        with torch.cuda.device(self.device):
            self._check(self.lib.lqr_mb_free(self.base), "lqr_mb_free")


class _CudaArray:
    """A zero-copy view of [ptr, ptr + n) of a CUDA device for
    ``torch.as_tensor``, by ``__cuda_array_interface__``."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {
            "shape": (n,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None}


class _HostRegion:
    """A shared-memory segment, mapped by torch as a uint8 tensor; its name
    is the handle another process maps it with."""

    def __init__(self, nbytes: int):
        shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self._shm = shm
        self.handle = shm.name
        self.bytes = _map_host(shm.name, nbytes)
        shm.close()               # torch holds its own mapping

    def unlink(self) -> None:
        """Remove the name once every process has mapped the segment; the
        mappings live on."""
        if self._shm is not None:
            self._shm.unlink()
            self._shm = None


def _map_host(name: str, nbytes: int) -> torch.Tensor:
    return torch.from_file(f"/dev/shm/{name}", shared=True, size=nbytes,
                           dtype=torch.uint8)


class Mailbox:
    """Rings between every pair of the processes of a gloo ``group`` on
    ``channels``, in this process's ``device`` memory (CUDA IPC, or shared
    host memory for a CPU device), ``slots`` slots a ring; ``timeout``: the
    seconds a wait may take. Building it is a collective of the group: it
    maps every process's first region, and raises LqrConfigError in every
    process if any cannot map a peer's (a peer on another host, a handle
    that will not open, a device that cannot reach the peer's)."""

    def __init__(self, group, device, timeout: float, channels,
                 slots: int = SLOTS):
        self.group = group
        self.n = dist.get_world_size(group)
        self.me = dist.get_rank(group)
        self.device = torch.device(device)
        self.host = self.device.type == "cpu"
        self.timeout = timeout
        self.channels = tuple(channels)
        self.slots = slots
        self.sizes = dict.fromkeys(self.channels, 0)
        self._region = None
        self._peers = [None] * self.n
        self._retired = []
        self.reserve(dict.fromkeys(self.channels, 1))

    # --- layout: the same offsets in every process's region ---------------

    def _others(self, owner: int):
        return [j for j in range(self.n) if j != owner]

    @staticmethod
    def _ring(owner: int, peer: int) -> int:
        """The index of peer's ring among owner's n - 1."""
        return peer - (peer > owner)

    def _layout(self, sizes: dict) -> dict:
        """Offsets in every process's region: ("slot", c, k) -> the first
        slot of the ring from the owner's k-th peer on channel c (_ring);
        ("flag", c, k) -> that ring's flags; ("credit", c) -> the credit
        words of the rings from the owner on c, one a destination rank;
        "bytes" -> the region's size."""
        off, at = 0, {}
        for c in self.channels:
            for k in range(self.n - 1):
                at[("slot", c, k)] = off
                off += self.slots * _round_up(sizes[c])
        for c in self.channels:
            for k in range(self.n - 1):
                at[("flag", c, k)] = off
                off += _round_up(8 * self.slots)
            at[("credit", c)] = off
            off += _round_up(8 * self.n)
        at["bytes"] = off
        return at

    def _slot(self, c: str, owner: int, src: int, q: int) -> int:
        return (self._at[("slot", c, self._ring(owner, src))]
                + (q % self.slots) * _round_up(self.sizes[c]))

    def _flag(self, c: str, owner: int, src: int, q: int) -> int:
        return (self._at[("flag", c, self._ring(owner, src))]
                + 8 * (q % self.slots))

    def _credit(self, c: str, dst: int) -> int:
        return self._at[("credit", c)] + 8 * dst

    # --- regions -----------------------------------------------------------

    def reserve(self, sizes: dict) -> None:
        """Make every channel's slots at least sizes[channel] bytes (a
        collective of the group, with the same sizes in every process). With
        room enough it does nothing; else every process settles its stream,
        allocates a larger region, trades handles over the group and maps
        every peer's, and the sequences start again from 0."""
        want = {c: max(self.sizes[c], int(sizes.get(c, 0)))
                for c in self.channels}
        if self._region is not None and want == self.sizes:
            return
        if self._region is not None:
            self.settle()
        at = self._layout(want)
        region = (_HostRegion(at["bytes"]) if self.host
                  else _CudaRegion(at["bytes"], self.device))
        handles = [None] * self.n
        dist.all_gather_object(handles, region.handle, group=self.group)
        # every process has settled: nothing more lands in an old region
        peers, error = [None] * self.n, ""
        for j in self._others(self.me):
            try:
                peers[j] = self._open(handles[j], at["bytes"])
            except (OSError, RuntimeError) as e:
                error = f"{type(e).__name__}: {e}"
        errors = [None] * self.n
        dist.all_gather_object(errors, error, group=self.group)
        if self.host:           # every process has mapped it, or failed
            region.unlink()
        if any(errors):
            if not self.host:
                self._unmap(peers)
                region.free()
            raise LqrConfigError(
                _("the mailbox carrier cannot map a peer's memory: {e}")
                .format(e="; ".join(e for e in errors if e)))
        self._close_old()
        self._region, self._peers = region, peers
        self._at, self.sizes = at, want
        self._sent, self._got, self._held = {}, {}, {}
        self._mine = region.bytes
        if self.host:
            self._words = [None if p is None else p.view(torch.int64)
                           for p in peers]
            self._words[self.me] = region.bytes.view(torch.int64)

    def _open(self, handle, nbytes: int):
        """A peer's region: its uint8 tensor on the CPU, its base address
        on CUDA."""
        if self.host:
            return _map_host(handle, nbytes)
        lib = _build.load()
        ptr = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            rc = lib.lqr_mb_open(handle, ctypes.byref(ptr))
        if rc != 0:
            msg = lib.lqr_cuda_error_string(rc).decode(errors="replace")
            raise RuntimeError(f"lqr_mb_open: CUDA error {rc} ({msg})")
        return ptr.value

    def _unmap(self, peers) -> None:
        """Close the peers' CUDA regions that this process opened."""
        lib = _build.load()
        with torch.cuda.device(self.device):
            for p in peers:
                if p is not None:
                    lib.lqr_mb_close(p)

    def _close_old(self) -> None:
        """Unmap the peers' old regions and free this process's (CUDA); a
        host region's mapping is kept, since tensors given out may view
        it."""
        if self._region is None:
            return
        if self.host:
            self._retired.append(self._region)
            return
        self._unmap(self._peers)
        self._region.free()

    # --- the protocol --------------------------------------------------------

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def _wait(self, owner: int, off: int, value: int) -> None:
        """Until the word at off of owner's region (this process's) is >=
        value: a wait on the stream, or a host poll with a deadline."""
        if not self.host:
            rc = self._region.lib.lqr_mb_wait(self._region.base + off, value,
                                              self._stream())
            self._region._check(rc, "lqr_mb_wait")
            return
        words, i = self._words[owner], off // 8
        deadline = time.monotonic() + self.timeout
        polls = 0
        while int(words[i]) < value:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    _("a process of the mesh sent nothing for {s} s; it "
                      "has failed or left").format(s=self.timeout))
            polls += 1
            time.sleep(0 if polls < 64 else 1e-4)

    def _write(self, owner: int, off: int, value: int) -> None:
        """The word at off of owner's region = value (after every write
        before it)."""
        if self.host:
            self._words[owner][off // 8] = value
            return
        rc = self._region.lib.lqr_mb_write(self._peers[owner] + off, value,
                                           self._stream())
        self._region._check(rc, "lqr_mb_write")

    def send(self, channel: str, dst: int, t: torch.Tensor) -> None:
        """Message t (contiguous, on this process's device) to process dst
        of the group on channel."""
        nbytes = t.numel() * t.element_size()
        if nbytes > self.sizes[channel]:
            raise ValueError(f"a {nbytes}-byte message on {channel!r}: the "
                             f"slots hold {self.sizes[channel]}")
        key = (channel, dst)
        q = self._sent.get(key, 0)
        self._sent[key] = q + 1
        credit = q - self.slots + 1
        slot = self._slot(channel, dst, self.me, q)
        flag = self._flag(channel, dst, self.me, q)
        if self.host:
            if credit > 0:
                self._wait(self.me, self._credit(channel, dst), credit)
            self._peers[dst][slot:slot + nbytes].copy_(
                t.reshape(-1).view(torch.uint8))
            self._write(dst, flag, q + 1)
            return
        base, peer = self._region.base, self._peers[dst]
        rc = self._region.lib.lqr_mb_put(
            base + self._credit(channel, dst) if credit > 0 else None,
            max(credit, 0), peer + slot, t.data_ptr(), nbytes, peer + flag,
            q + 1, self._stream())
        self._region._check(rc, "lqr_mb_put")

    def recv(self, channel: str, src: int, shape, dtype) -> torch.Tensor:
        """The next message from process src on channel, a [shape] dtype
        view of its slot, valid until the next recv from src on channel
        (which releases it)."""
        self.release(channel, src)
        key = (channel, src)
        q = self._got.get(key, 0)
        self._got[key] = q + 1
        self._wait(self.me, self._flag(channel, self.me, src, q), q + 1)
        self._held[key] = q
        slot = self._slot(channel, self.me, src, q)
        nbytes = math.prod(shape) * dtype.itemsize
        return self._mine[slot:slot + nbytes].view(dtype).view(shape)

    def release(self, channel: str, src: int) -> None:
        """Give back the slot of the last message recv took from src on
        channel, after every read of it enqueued so far."""
        q = self._held.pop((channel, src), None)
        if q is not None:
            self._write(src, self._credit(channel, self.me), q + 1)

    def gather(self, channel: str, t: torch.Tensor, join) -> torch.Tensor:
        """Every process's t (the same shape and dtype in each) joined by
        join(parts), parts in group rank order (join must copy, as
        ``torch.cat`` does): t goes to every other process first, then the
        n - 1 parts are taken, joined and released."""
        t = t.contiguous()
        for j in self._others(self.me):
            self.send(channel, j, t)
        out = join([t if j == self.me else self.recv(channel, j, t.shape,
                                                     t.dtype)
                    for j in range(self.n)])
        for j in self._others(self.me):
            self.release(channel, j)
        return out

    def settle(self) -> None:
        """Wait, on the host, until this process's stream has run every
        message and read enqueued so far; past the timeout raise
        TimeoutError (a peer that stops leaves the stream waiting). Nothing
        to wait for on the CPU, whose waits are the host's."""
        if self.host:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        deadline = time.monotonic() + self.timeout
        while not ev.query():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    _("a process of the mesh sent nothing for {s} s; it "
                      "has failed or left").format(s=self.timeout))
            time.sleep(2e-5)
