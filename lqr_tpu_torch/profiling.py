"""Profiling / tracing / roofline accounting on PyTorch.

The reference's only instrumentation is a compiled-out wall-clock macro
(``__CLOCK_IT__``, gimp-lqr-plugin src/render.c:36-38). This module is
the port's one tracing system:

- ``trace(logdir)``: ``torch.profiler`` around the enclosed block (CUDA
  activity when a card is in use), written as a Chrome trace into
  ``logdir`` (chrome://tracing or Perfetto);
- ``annotate(name)``: a named span. While a ``torch.profiler`` session
  runs (``trace``, or any other) it is a host range labelled
  ``lqr.<name>`` in the profiler's trace, beside the kernels it launched,
  and a record in ``SPANS``; otherwise it is one flag test and a shared
  no-op context. No span synchronizes the device: its time is the host's
  time to issue its work, plus any wait its code already has;
- ``count(name, n)`` and ``COUNTERS``: counters by group, always on (one
  dict update a call, never one a seam); while a profiler runs each
  update is also a timestamped record in ``SPANS``, so a traced window
  can be cut by request. ``counters()`` reads every group at once,
  the kernels' launches and the meshes' exchanges included;
- ``seam_roofline(...)``: the bytes one seam step of the per-seam route
  (``core.engine._carve_once``) reads and writes at a given size, and the
  card's speed-of-light bound from them.

Spans in the port (innermost last): ``carver.init`` > ``carver.upload``,
``carver.bias_add`` > ``carver.place_mask`` > ``mask.copy`` |
``mask.place`` (``rigmask_add``'s ``carver.place_mask`` stands alone);
``carver.resize`` > ``carver.build_map``,
``engine.resident`` > ``resident.chunk`` | ``resident.commit``, or
``engine.per_seam`` > ``engine.seam`` > ``seam.energy`` | ``seam.find``
| ``seam.compact`` | ``seam.commit``; ``carver.get_image`` >
``carver.materialize``, ``carver.copy_out``, ``carver.host_copy``;
``batch.stage``, ``batch.upload``, ``engine.resident_batched`` (over
``resident.chunk`` | ``resident.commit``) or ``engine.per_seam_batched``
(over ``engine.seam``),
``engine.sharded``, ``batch.images_at`` > ``batch.materialize``,
``batch.copy_out``. Counters: ``seams.<route>`` and ``route_ns.<route>``
(the seams ``core.engine.extend_map`` carved by each of its routes, and
the host's ns inside them, traced or not), ``bytes.h2d`` and
``bytes.d2h`` (bytes handed between host arrays and the carvers'
tensors), ``bytes.d2h_pinned`` (those of ``bytes.d2h`` that
``BatchCarver`` read back into page-locked memory), ``setup.kernels_s``
(``ops._build.load``'s seconds, a build included) and
``setup.native_s`` (the g++ libraries of ``utils.codec`` and
``native``), and the groups ``LAUNCHES`` (``ops.dp_cuda``),
``EXCHANGES``, ``EXCHANGE_SECONDS``, ``HOST_COPIES`` and
``GLOO_MESSAGES`` (``parallel.sharding``).

The counterpart of ``lqr_tpu.profiling`` without its TPU chain-latency
calibration: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import pathlib
import threading
import time

import torch

from .errors import LqrConfigError
from .i18n import _

# Device-memory rates by card name (torch.cuda.get_device_name, lower
# case), GB/s: the H100 SXM's 3.35 TB/s (NVIDIA's data sheet, 700 W).
HBM_GBPS = {"h100 80gb hbm3": 3350.0}


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block and write it as a Chrome trace into
    ``logdir`` (created if missing). Yields the trace file's path, which
    exists once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{time.time_ns()}.json"
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(str(path))


# -- spans and counters ------------------------------------------------------

PREFIX = "lqr."          # the profiler label of a span: PREFIX + name
RING_SIZE = 1 << 16      # records SPANS keeps, the newest


class Span(collections.namedtuple("Span",
                                  "id parent name start_ns end_ns")):
    """A closed span: its id, the id of the span open when it began (0:
    none), its name, and its start and end on ``time.perf_counter_ns``."""


class Count(collections.namedtuple("Count", "name t_ns value total")):
    """A counter update made while a profiler ran: the counter's name,
    when (``time.perf_counter_ns``), by how much, and its value after
    the update (what ``counters()`` read then), so the updates made
    after a traced window are the value now less the last record's
    total."""


# Span and Count records of the traced windows, oldest first; a record
# enters when its span closes
SPANS: collections.deque = collections.deque(maxlen=RING_SIZE)
# The counters by group: group name -> {key: value}; count("g.k", n)
# adds n to COUNTERS["g"]["k"]
COUNTERS: dict[str, dict] = {"seams": {}, "route_ns": {},
                             "bytes": {}, "setup": {}}

_tracing = torch.autograd._profiler_enabled
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
NO_SPAN = contextlib.nullcontext()


def _open() -> list:
    """This thread's stack of open span ids."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


# A span's range in the profiler's trace: a cpu_op range. Not
# record_function's user annotation, which costs about four times as much
# and which the profiler mirrors on the device's timeline as a
# gpu_user_annotation event over the kernels the span launched, where a
# reader of the trace would count it as device work.
_range = torch._C._profiler._RecordFunctionFast


class _Span:
    __slots__ = ("name", "id", "parent", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.rf = _range(PREFIX + self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _open().pop()
        SPANS.append(Span(self.id, self.parent, self.name, self.start, end))
        return False


def annotate(name: str):
    """A span named ``name`` around the ``with`` block: recorded while a
    torch.profiler session runs (as the range ``PREFIX + name`` in its
    trace and as a ``Span`` in ``SPANS``), else the shared no-op
    ``NO_SPAN``."""
    if not _tracing():
        return NO_SPAN
    return _Span(name)


def group(name: str, counts: dict) -> dict:
    """Register the dict ``counts`` (kept as it is, the same object) as
    the counter group ``name``; returns it."""
    COUNTERS[name] = counts
    return counts


def count(name: str, n=1) -> None:
    """Add n to the counter ``name`` ("group.key"; the group must
    exist). While a profiler runs the update is also a ``Count`` in
    ``SPANS``."""
    grp, key = name.split(".", 1)
    counts = COUNTERS[grp]
    with _lock:
        total = counts[key] = counts.get(key, 0) + n
    if _tracing():
        SPANS.append(Count(name, time.perf_counter_ns(), n, total))


def counters() -> dict:
    """A snapshot of every counter, flat: {"group.key": value}."""
    with _lock:
        return {f"{g}.{k}": v for g, counts in COUNTERS.items()
                for k, v in list(counts.items())}


def hbm_gbps_of(device_name: str) -> float:
    """The device-memory rate (GB/s) of a card by its name; an unknown card
    raises LqrConfigError (pass the rate to seam_roofline instead)."""
    key = next((k for k in HBM_GBPS if k in device_name.lower()), None)
    if key is None:
        raise LqrConfigError(
            _("no memory rate known for device {d!r}; pass hbm_gbps")
            .format(d=device_name))
    return HBM_GBPS[key]


@dataclasses.dataclass
class Roofline:
    hbm_bytes: int          # device-memory traffic of one seam step
    seq_rows: int           # rows on the sequential DP critical path
    sol_seams_per_s: float  # speed-of-light bound from memory traffic alone
    breakdown: dict

    def efficiency(self, measured_seams_per_s: float) -> float:
        return measured_seams_per_s / self.sol_seams_per_s


def seam_roofline(H: int, W: int, has_bias: bool = False,
                  has_rig: bool = False, hbm_gbps: float | None = None
                  ) -> Roofline:
    """Device-memory cost of one seam step on the per-seam route
    (core.engine._carve_once and its commit in _extend_per_seam), each
    byte read once and each byte written once.

    Traffic per seam:
      energy:    read cur_b (f32) + write e (f32)
      DP fwd:    read e (+ the rig plane) + write bp (i8)
      backtrack: read M_last (f32 [W]), one bp byte a row (the chase),
                 write the seam (i32 [H])
      compact:   read + write cur_b (and the bias/rig planes when present)
      commit:    read + write posmap (i32, compacted with the planes),
                 gather the seam's reference columns and scatter them into
                 vs (i32 [H] each); the per-call posmap build is left out

    ``hbm_gbps``: the memory rate; None takes the card's
    (``hbm_gbps_of(torch.cuda.get_device_name())``), which needs CUDA.
    """
    if hbm_gbps is None:
        if not torch.cuda.is_available():
            raise LqrConfigError(
                _("no CUDA device to take a memory rate from; pass "
                  "hbm_gbps"))
        hbm_gbps = hbm_gbps_of(torch.cuda.get_device_name())
    plane = H * W * 4
    n_extra = int(has_bias) + int(has_rig)
    b = {
        "energy": 2 * plane,
        "dp_forward": plane + H * W * 1 + (plane if has_rig else 0),
        "backtrack": 4 * W + H + 4 * H,
        "compact": 2 * plane * (1 + n_extra),
        "commit_amortized": 2 * plane + 2 * 4 * H,
    }
    total = sum(b.values())
    return Roofline(hbm_bytes=total, seq_rows=H,
                    sol_seams_per_s=hbm_gbps * 1e9 / total, breakdown=b)
