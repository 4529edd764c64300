"""The program's own spans and counters set against the benchmark's.

``lqr_tpu_torch.profiling`` keeps, while a profiler runs, a ring of the
program's spans and counter updates (``SPANS``: ``Span`` and ``Count``
records on ``time.perf_counter_ns``, the clock of the benchmark's host
spans, ``Run.spans``). After the window this module

- ties each record to the traced request whose benchmark span holds it
  (both on the host clock);
- maps the records onto the profiler's clock: the offset is the median,
  over the benchmark spans present in both ``Run.spans`` and
  ``Run.trace.spans``, of the difference of their midpoints;
- ties each device event to the program span open at its launch;
- puts each idle interval of the traced window down to the innermost
  program span open then, else to the benchmark span, and prints that
  once a run to stderr (``benchmark: idle by program span: ...``).

Counters are read by request from the ring's records of the traced
requests, and over the untraced rest of the window from their totals
(``after_trace``). A program without the ring (an older commit) gives no
records, and every reader built on this module then returns None.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
import sys
import weakref

from benchmark import device_trace


@dataclasses.dataclass(frozen=True)
class Tied:
    """A program span tied to a request: host clock, ns."""
    id: int
    parent: int
    name: str
    index: int        # the request's index in the window
    bench: str        # the name of the benchmark span that holds it
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Reading:
    spans: list[Tied]                       # by start
    counts: list[tuple[int, str, float]]    # (request index, name, value)
    offset_ns: int | None                   # profiler clock - host clock
    idle: dict[str, float]                  # idle s by innermost span
    idle_in_program_s: float                # idle s inside program spans
    idle_in_bench_s: float                  # idle s inside benchmark spans


def ring() -> list:
    """The program's records (``lqr_tpu_torch.profiling.SPANS``), or none
    where the program keeps no such ring."""
    try:
        from lqr_tpu_torch import profiling
    except ImportError:
        return []
    return list(getattr(profiling, "SPANS", ()))


def counters() -> dict:
    """The program's counters (``profiling.counters()``), or {}."""
    try:
        from lqr_tpu_torch import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "counters", None)
    return {} if read is None else read()


def after_trace(prefix: str) -> dict[str, float]:
    """The updates of the counters named ``prefix``... made after the
    traced requests, in the untraced rest of the window: each counter's
    value now less its total at its last record in the ring. A counter
    the ring never saw, or a program whose records keep no total, gives
    nothing."""
    last = {}
    for r in ring():
        if hasattr(r, "total") and r.name.startswith(prefix):
            last[r.name] = r.total
    now = counters()
    return {k: now[k] - v for k, v in last.items() if k in now}


def _holder(spans: list[device_trace.Span]):
    """A function from a host time to the benchmark span holding it (or
    None); the spans of one run do not overlap."""
    spans = sorted(spans, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in spans]

    def find(t: int):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i].end_ns:
            return spans[i]
        return None
    return find


def offset_ns(run) -> int | None:
    """The profiler's clock less the host clock: the median over the
    benchmark spans in both records of the difference of midpoints."""
    tr = run.trace
    if tr is None or not tr.spans or not run.spans:
        return None
    host = {(s.name, s.index): s for s in run.spans}
    diffs = [(t.start_ns + t.end_ns - h.start_ns - h.end_ns) / 2
             for t in tr.spans
             if (h := host.get((t.name, t.index))) is not None]
    return round(statistics.median(diffs)) if diffs else None


def _tie(run, records) -> tuple[list[Tied], list]:
    find = _holder(run.spans)
    spans, counts = [], []
    for r in records:
        if hasattr(r, "end_ns"):
            b = find(r.start_ns)
            if b is not None and r.end_ns <= b.end_ns:
                spans.append(Tied(r.id, r.parent, r.name, b.index, b.name,
                                  r.start_ns, r.end_ns))
        elif hasattr(r, "t_ns"):
            b = find(r.t_ns)
            if b is not None:
                counts.append((b.index, r.name, r.value))
    spans.sort(key=lambda s: s.start_ns)
    return spans, counts


def _depths(spans: list[Tied]) -> dict[int, int]:
    """Each span's depth below its benchmark span (1: outermost)."""
    by_id = {s.id: s for s in spans}
    depth: dict[int, int] = {}

    def of(s: Tied) -> int:
        if s.id not in depth:
            p = by_id.get(s.parent)
            depth[s.id] = 1 if p is None else of(p) + 1
        return depth[s.id]
    for s in spans:
        of(s)
    return depth


def innermost(intervals) -> list[tuple[int, int, str]]:
    """The timeline of the innermost open interval: intervals are (start,
    end, depth, label), nested or disjoint; returns disjoint (start, end,
    label) segments, sorted, where some interval is open."""
    marks = []
    for k, (a, b, d, label) in enumerate(intervals):
        if b > a:
            marks.append((a, 1, k))
            marks.append((b, 0, k))
    marks.sort()
    out, active, t = [], {}, None
    for time, kind, k in marks:
        if active and t is not None and time > t:
            d, label = max(active.values())
            out.append((t, time, label))
        if kind:
            a, b, d, label = intervals[k]
            active[k] = (d, label)
        else:
            active.pop(k, None)
        t = time
    return out


def idle_split(gaps, segments) -> dict[str, float]:
    """Seconds of the gaps (sorted, disjoint) in each labelled segment
    (sorted, disjoint); what no segment covers goes to BETWEEN."""
    out: dict[str, float] = {}
    j = 0
    for a, b in gaps:
        covered = 0
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s0, s1, label = segments[k]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                out[label] = out.get(label, 0.0) + part / 1e9
                covered += part
            k += 1
        if b - a > covered:
            out[device_trace.BETWEEN] = (out.get(device_trace.BETWEEN, 0.0)
                                         + (b - a - covered) / 1e9)
    return out


def analyse(run, records) -> Reading:
    """The records of ``ring()`` (or a test's) read against the run."""
    spans, counts = _tie(run, records)
    off = offset_ns(run)
    idle, in_prog, in_bench = {}, 0.0, 0.0
    tr = run.trace
    if tr is not None and tr.spans and tr.events and off is not None:
        depth = _depths(spans)
        bench = [(s.start_ns, s.end_ns, 0, s.name) for s in tr.spans]
        prog = [(s.start_ns + off, s.end_ns + off, depth[s.id], s.name)
                for s in spans]
        gaps = device_trace.idle_intervals(tr)
        idle = idle_split(gaps, innermost(bench + prog))
        bench_names = {s.name for s in tr.spans}
        in_bench = sum(v for k, v in idle.items()
                       if k != device_trace.BETWEEN)
        in_prog = sum(v for k, v in idle.items()
                      if k != device_trace.BETWEEN and k not in bench_names)
    return Reading(spans, counts, off, idle, in_prog, in_bench)


_last: list = [None, None]     # (weakref to the run, its Reading)


def of(run) -> Reading:
    """The run's Reading from the program's ring, worked out once a run;
    the first time, the idle breakdown is printed to stderr."""
    if _last[0] is not None and _last[0]() is run:
        return _last[1]
    reading = analyse(run, ring())
    _last[:] = [weakref.ref(run), reading]
    if reading.idle:
        parts = ", ".join(f"{k} {v:.6f}" for k, v in sorted(
            reading.idle.items(), key=lambda kv: -kv[1]))
        share = (100.0 * reading.idle_in_program_s / reading.idle_in_bench_s
                 if reading.idle_in_bench_s else 0.0)
        print(f"benchmark: idle by program span: {parts} (s); program "
              f"spans hold {share:.1f} % of the idle inside benchmark "
              f"spans; clock offset {reading.offset_ns} ns", file=sys.stderr)
    return reading


# -- what the readers share ---------------------------------------------------

def per_request(values: dict[int, float]) -> float | None:
    """The median over requests, None without any."""
    return statistics.median(values.values()) if values else None


def host_ms(run, name: str) -> float | None:
    """The median a request of the host ms in the program spans named
    ``name``."""
    per: dict[int, float] = {}
    for s in of(run).spans:
        if s.name == name:
            per[s.index] = (per.get(s.index, 0.0)
                            + (s.end_ns - s.start_ns) / 1e6)
    return per_request(per)


def span_us(run, name: str) -> float | None:
    """The median over every program span named ``name`` of its host
    µs."""
    d = [(s.end_ns - s.start_ns) / 1e3 for s in of(run).spans
         if s.name == name]
    return statistics.median(d) if d else None


def device_ms(run, name: str) -> float | None:
    """The median a request of the device ms of the events launched inside
    the program spans named ``name`` (their launch mapped to the host
    clock); None without a device trace."""
    reading, tr = of(run), run.trace
    if tr is None or not tr.events or reading.offset_ns is None:
        return None
    events = sorted(((e.caused_ns - reading.offset_ns, e.end_ns - e.start_ns)
                     for e in tr.events))
    at = [t for t, _ in events]
    per: dict[int, float] = {}
    for s in reading.spans:
        if s.name != name:
            continue
        lo = bisect.bisect_left(at, s.start_ns)
        hi = bisect.bisect_left(at, s.end_ns)
        per[s.index] = per.get(s.index, 0.0) + sum(
            d for _, d in events[lo:hi]) / 1e6
    return per_request(per)


def counted(run, name: str, scale: float = 1.0) -> float | None:
    """The median a request of the counter ``name``'s updates, times
    scale."""
    per: dict[int, float] = {}
    for i, n, v in of(run).counts:
        if n == name:
            per[i] = per.get(i, 0.0) + v * scale
    return per_request(per)
