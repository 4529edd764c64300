"""The reduction of a profiler trace to per-layer numbers.

A trace is a list of device events (kernels and copies, with start and end
in ns) and the benchmark's own host spans (upload, resize, carve,
readback; each synchronized at both ends, so the device work it caused
runs inside it) on the profiler's clock. Readers take their numbers from
here; nothing here knows a cell.
"""

from __future__ import annotations

import dataclasses

SPAN_PREFIX = "bench:"
BETWEEN = "between requests"
NAME_CHARS = 120


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int
    launch_ns: int | None = None   # its launch on the host's clock

    @property
    def caused_ns(self) -> int:
        """When the host asked for it: the launch, else the start."""
        return self.start_ns if self.launch_ns is None else self.launch_ns

    @property
    def is_copy(self) -> bool:
        return self.name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    index: int       # the request's index in the window
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Trace:
    events: list[DeviceEvent]
    spans: list[Span]

    @property
    def window(self) -> tuple[int, int]:
        """The traced window: from the first span's start to the last
        span's end."""
        return (min(s.start_ns for s in self.spans),
                max(s.end_ns for s in self.spans))

    @property
    def window_s(self) -> float:
        t0, t1 = self.window
        return (t1 - t0) / 1e9


def span_name(name: str, index: int) -> str:
    """The profiler label of a host span."""
    return f"{SPAN_PREFIX}{name}:{index}"


def from_profiler(prof) -> Trace:
    """The device events and host spans of a finished torch.profiler run.
    A device event is tied to its span by its launch (the CUDA API call
    of the same correlation id, on the host's clock), not by its start on
    the device's clock, which the profiler maps onto the host's only
    approximately."""
    from torch.autograd import DeviceType
    device, spans, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if name.startswith(SPAN_PREFIX):
            if e.device_type() == DeviceType.CPU:
                label, _, index = name[len(SPAN_PREFIX):].rpartition(":")
                spans.append(Span(label, int(index), start, end))
        elif e.device_type() == DeviceType.CUDA:
            device.append((name, start, end, e.correlation_id()))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = start
    events = [DeviceEvent(n, a, b, launches.get(c)) for n, a, b, c in device]
    return Trace(sorted(events, key=lambda e: e.start_ns),
                 sorted(spans, key=lambda s: s.start_ns))


def _union(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of intervals clipped to [lo, hi], sorted, disjoint."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which the device ran a kernel or a copy."""
    lo, hi = trace.window
    return sum(b - a for a, b in _union(
        ((e.start_ns, e.end_ns) for e in trace.events), lo, hi)) / 1e9


def idle_intervals(trace: Trace) -> list[tuple[int, int]]:
    """The gaps of the window in which the device ran nothing."""
    lo, hi = trace.window
    gaps, t = [], lo
    for a, b in _union(((e.start_ns, e.end_ns) for e in trace.events),
                       lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def idle_by_span(trace: Trace) -> dict[str, float]:
    """Idle seconds of the window by the host span open at the time
    (BETWEEN outside every span)."""
    spans = [(s.start_ns, s.end_ns, s.name) for s in trace.spans]
    out: dict[str, float] = {}
    for a, b in idle_intervals(trace):
        covered = 0
        for s0, s1, name in spans:
            part = min(b, s1) - max(a, s0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part / 1e9
                covered += part
        if b - a > covered:
            out[BETWEEN] = out.get(BETWEEN, 0.0) + (b - a - covered) / 1e9
    return out


def events_in(trace: Trace, names: tuple[str, ...]) -> list[DeviceEvent]:
    """The device events caused inside a span of one of the names."""
    spans = [(s.start_ns, s.end_ns) for s in trace.spans if s.name in names]
    return [e for e in trace.events
            if any(a <= e.caused_ns < b for a, b in spans)]


def span_indices(trace: Trace, names: tuple[str, ...]) -> set[int]:
    """The request indices that have a span of one of the names."""
    return {s.index for s in trace.spans if s.name in names}


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    time by the host span open at the time, each as [name, seconds]."""
    lo, hi = trace.window
    by_name: dict[str, float] = {}
    for e in trace.events:
        dur = min(e.end_ns, hi) - max(e.start_ns, lo)
        if dur > 0:
            by_name[e.name] = by_name.get(e.name, 0.0) + dur / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(idle_by_span(trace).items(), key=lambda kv: -kv[1])[:top]
    # kernel names cut to their first NAME_CHARS characters
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
