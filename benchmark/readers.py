"""What the per-layer readers share: medians of the host spans, and the
traced window's device numbers. Each returns None where the run has
nothing to read (an untraced run, a cell without such spans)."""

from __future__ import annotations

import statistics

from benchmark import device_trace, work

CARVE_SPANS = ("resize", "carve")


def span_ms(run, names: tuple[str, ...]) -> float | None:
    """The median over requests of the ms a request spent in the spans of
    the names (synchronized host spans of the traced run)."""
    per: dict[int, int] = {}
    for s in run.spans:
        if s.name in names:
            per[s.index] = per.get(s.index, 0) + (s.end_ns - s.start_ns)
    if not per:
        return None
    return statistics.median(per.values()) / 1e6


def _carved(run):
    """The traced carve spans' device events and the requests they carved."""
    tr = run.trace
    if tr is None or not tr.spans or not tr.events:
        return None, []
    idx = device_trace.span_indices(tr, CARVE_SPANS)
    reqs = [r for r in run.requests if r.index in idx]
    if not reqs:
        return None, []
    return device_trace.events_in(tr, CARVE_SPANS), reqs


def kernels_per_seam(run) -> float | None:
    """Device kernels (copies left out) inside the traced carve spans over
    the seams those requests carved."""
    events, reqs = _carved(run)
    if not reqs:
        return None
    return sum(not e.is_copy for e in events) / sum(r.seams for r in reqs)


def carve_roofline_pct(run) -> float | None:
    """The least time the card could take for the traced requests' carve
    work over the device time of everything inside their carve spans, in
    percent; None on a card without published peaks."""
    events, reqs = _carved(run)
    peak = work.peaks(run.device_name)
    if not reqs or peak is None:
        return None
    dev_s = sum(e.end_ns - e.start_ns for e in events) / 1e9
    if dev_s <= 0:
        return None
    least, _ = work.least_seconds(sum(r.ops for r in reqs),
                                  sum(r.nbytes for r in reqs), peak)
    return 100.0 * least / dev_s


def device_idle_pct(run) -> float | None:
    """The share of the traced window in which the device ran no kernel
    and no copy, in percent."""
    tr = run.trace
    if tr is None or not tr.spans or not tr.events:
        return None
    return 100.0 * (1.0 - device_trace.busy_s(tr) / tr.window_s)
