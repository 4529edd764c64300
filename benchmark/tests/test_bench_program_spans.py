"""The program's spans and counters read against the benchmark's, on a
synthetic run: the clock mapping, the records tied to their requests,
device time and idle time by program span, and the new readers (None on
an untraced run and on a program that keeps no ring). On the card, every
program span of a traced request lies inside its benchmark span once
mapped onto the profiler's clock."""

import pytest
import torch

from benchmark import device_trace as dt
from benchmark import harness, program_spans
from lqr_tpu_torch import profiling

MS = 1_000_000          # ns
US = 1_000
OFF = 5_000 * MS        # the profiler's clock less the host clock
NEW = ("mask_place_ms", "seam_issue_us", "materialize_ms.single",
       "materialize_ms.batch", "readback_mb.single", "readback_mb.batch",
       "kernel_load_s", "upload_mb.single", "upload_mb.batch")
# the per-seam route's counters: their totals before the window (the
# warm-up), what each traced request adds, and the untraced rest: 3
# requests of 100 seams at 600 µs a seam
WARM_NS, WARM_SEAMS = 5 * MS, 10
REQ_NS, REQ_SEAMS = 2 * MS, 2
REST_NS, REST_SEAMS = 3 * 100 * 600 * US, 3 * 100
H2D = 46_137_344


def _records(t, base, d2h, n):
    """The n-th (from 0) masked request's program records, t ms after the
    first."""
    def span(i, parent, name, a, b):
        return profiling.Span(base + i, base + parent if parent else 0,
                              name, int((t + a) * MS), int((t + b) * MS))

    def count(name, at, value, total):
        return profiling.Count(name, int((t + at) * MS), value, total)
    return [
        count("bytes.h2d", 0.5, H2D, H2D * (n + 1)),
        span(1, 0, "carver.upload", 0.1, 0.5),
        span(3, 2, "mask.host", 0.6, 1.5),
        span(4, 2, "mask.copy", 1.5, 1.8),
        span(2, 0, "carver.place_mask", 0.6, 1.8),
        span(7, 6, "engine.seam", 2.3, 3.3),
        span(8, 6, "engine.seam", 3.3, 4.3),
        span(6, 5, "engine.per_seam", 2.2, 9.8),
        count("route_ns.per_seam", 9.8, REQ_NS, WARM_NS + REQ_NS * (n + 1)),
        count("seams.per_seam", 9.8, REQ_SEAMS,
              WARM_SEAMS + REQ_SEAMS * (n + 1)),
        span(5, 0, "carver.resize", 2.1, 9.9),
        span(10, 9, "carver.materialize", 10.1, 10.5),
        span(11, 9, "carver.copy_out", 10.5, 11.5),
        count("bytes.d2h", 11.5, d2h, d2h),
        span(9, 0, "carver.get_image", 10.1, 11.9),
    ]


def _synthetic(jitter=0):
    """Two requests 20 ms apart: benchmark spans upload 0-2 ms, resize
    2-10, readback 10-12; device events on the profiler's clock, each
    launched inside a program span. jitter: ns by which the profiler's
    span opens before the host stamp and closes after it."""
    shift = OFF
    host, trace, events, records = [], [], [], []
    for i, t in enumerate((0, 20)):
        for name, a, b in (("upload", 0, 2), ("resize", 2, 10),
                           ("readback", 10, 12)):
            host.append(dt.Span(name, i, (t + a) * MS, (t + b) * MS))
            trace.append(dt.Span(name, i, (t + a) * MS + shift - jitter,
                                 (t + b) * MS + shift + jitter))
        for name, a, b, launch in (
                ("Memcpy HtoD (Pageable -> Device)", 1.5, 1.8, 1.55),
                ("carve_kernel", 3.0, 8.0, 2.35),
                ("materialize_kernel", 10.2, 10.4, 10.15),
                ("Memcpy DtoH (Device -> Pageable)", 10.6, 11.4, 10.55)):
            events.append(dt.DeviceEvent(name, int((t + a) * MS) + shift,
                                         int((t + b) * MS) + shift,
                                         int((t + launch) * MS) + shift))
        records += _records(t, 100 * i, 1000 if i == 0 else 3000, i)
    reqs = [harness.Request(i, 100, 0, 0, 0.0, 0.1) for i in range(2)]
    run = harness.Run(10.0, 1.0, reqs, host, dt.Trace(events, trace),
                      "NVIDIA H100 80GB HBM3")
    return run, records


@pytest.fixture
def ring(monkeypatch):
    """The program's ring and counters as a test sets them."""
    state = {"records": [], "counters": {}}
    monkeypatch.setattr(program_spans, "ring", lambda: state["records"])
    monkeypatch.setattr(program_spans, "counters",
                        lambda: state["counters"])
    return state


def _read(name, run):
    return harness.find_reader(name, "layer_metrics").read(run)


def test_clock_mapping_is_the_median_of_midpoints():
    run, _ = _synthetic(jitter=3 * US)
    assert program_spans.offset_ns(run) == OFF
    # one pair far off moves the median of six by nothing
    run.trace.spans[0] = dt.Span("upload", 0, 7 * MS, 9 * MS)
    assert program_spans.offset_ns(run) == OFF
    run.trace = None
    assert program_spans.offset_ns(run) is None


def test_records_tied_to_their_requests():
    run, records = _synthetic()
    # a record outside every benchmark span (the warm-up) is left out
    stray = profiling.Span(999, 0, "carver.upload", 15 * MS, 16 * MS)
    r = program_spans.analyse(run, records + [stray])
    assert {s.index for s in r.spans} == {0, 1}
    assert len(r.spans) == 2 * 11 and 999 not in {s.id for s in r.spans}
    by = {(s.index, s.name): s.bench for s in r.spans}
    assert by[(1, "mask.host")] == "upload"
    assert by[(0, "engine.seam")] == "resize"
    assert by[(1, "carver.copy_out")] == "readback"
    assert [c for c in r.counts if c[1] == "bytes.d2h"] == [
        (0, "bytes.d2h", 1000), (1, "bytes.d2h", 3000)]
    assert [c[0] for c in r.counts] == [0] * 4 + [1] * 4


def test_device_ms_by_program_span(ring):
    run, ring["records"] = _synthetic()
    assert program_spans.device_ms(run, "carver.materialize") == (
        pytest.approx(0.2))
    assert program_spans.device_ms(run, "mask.copy") == pytest.approx(0.3)
    assert program_spans.device_ms(run, "engine.seam") == pytest.approx(5.0)
    assert program_spans.device_ms(run, "carver.copy_out") == (
        pytest.approx(0.8))
    assert program_spans.device_ms(run, "batch.materialize") is None


def test_idle_by_program_span():
    run, records = _synthetic()
    r = program_spans.analyse(run, records)
    want = {"upload": 0.4, "carver.upload": 0.4, "mask.host": 0.9,
            "resize": 0.2, "carver.resize": 0.2, "engine.per_seam": 1.9,
            "engine.seam": 0.7, "readback": 0.2, "carver.materialize": 0.2,
            "carver.copy_out": 0.2, "carver.get_image": 0.4}
    assert set(r.idle) == set(want) | {dt.BETWEEN}
    for name, ms in want.items():       # the same in both requests
        assert r.idle[name] == pytest.approx(2 * ms / 1e3), name
    assert r.idle[dt.BETWEEN] == pytest.approx(0.008)
    assert r.idle_in_bench_s == pytest.approx(2 * 5.7e-3)
    assert r.idle_in_program_s == pytest.approx(2 * 4.9e-3)
    # the benchmark's own split of the same gaps agrees in its totals
    assert sum(r.idle.values()) == pytest.approx(
        sum(dt.idle_by_span(run.trace).values()))


def test_idle_breakdown_printed_once_a_run(ring, capsys):
    run, ring["records"] = _synthetic()
    for name in ("mask_place_ms", "seam_issue_us", "readback_mb.single"):
        _read(name, run)
    err = capsys.readouterr().err
    assert err.count("benchmark: idle by program span: ") == 1
    assert "mask.host 0.001800" in err


def _counters_now():
    """The program's counters after the window: the kernels' load, and
    the per-seam route's warm-up, two traced and three untraced
    requests."""
    return {"setup.kernels_s": 0.5, "setup.native_s": 0.25,
            "route_ns.per_seam": WARM_NS + 2 * REQ_NS + REST_NS,
            "seams.per_seam": WARM_SEAMS + 2 * REQ_SEAMS + REST_SEAMS,
            "bytes.h2d": 5 * H2D}


def test_counters_after_the_traced_requests(ring):
    """The untraced rest of the window: the value now less the last
    record's total; a counter the ring never saw, or records that keep
    no total, give nothing."""
    _, ring["records"] = _synthetic()
    ring["counters"] = dict(_counters_now(), **{"seams.resident": 7})
    assert program_spans.after_trace("route_ns.") == {
        "route_ns.per_seam": REST_NS}
    assert program_spans.after_trace("seams.") == {
        "seams.per_seam": REST_SEAMS}
    assert program_spans.after_trace("bytes.h2d") == {"bytes.h2d": 3 * H2D}
    assert program_spans.after_trace("setup.") == {}
    # no request after the traced ones: no seam to read a time from
    run, _ = _synthetic()
    ring["counters"]["seams.per_seam"] = WARM_SEAMS + 2 * REQ_SEAMS
    assert _read("seam_issue_us", run) is None
    # an older program's counter records: no total
    ring["records"] = [r._replace() if isinstance(r, profiling.Span)
                       else (r.name, r.t_ns, r.value)
                       for r in ring["records"]]
    assert program_spans.after_trace("seams.") == {}


def test_new_readers_on_a_traced_run(ring):
    run, ring["records"] = _synthetic()
    ring["counters"] = _counters_now()
    assert _read("mask_place_ms", run) == pytest.approx(1.2)
    assert _read("seam_issue_us", run) == pytest.approx(600.0)
    assert _read("upload_mb.single", run) == pytest.approx(46.137344)
    assert _read("upload_mb.batch", run) == pytest.approx(46.137344)
    assert _read("materialize_ms.single", run) == pytest.approx(0.2)
    assert _read("materialize_ms.batch", run) is None
    assert _read("readback_mb.single", run) == pytest.approx(0.002)
    assert _read("readback_mb.batch", run) == pytest.approx(0.002)
    assert _read("kernel_load_s", run) == pytest.approx(0.75)
    ring["counters"] = {}
    assert _read("kernel_load_s", run) is None


def test_new_readers_none_on_an_untraced_run(ring):
    traced, ring["records"] = _synthetic()
    ring["counters"] = {"setup.kernels_s": 0.5}
    run = harness.Run(10.0, 1.0, traced.requests, [], None, "cpu")
    for name in NEW:
        assert _read(name, run) is None, name


def test_new_readers_none_without_the_program_ring(monkeypatch):
    """An older program (no SPANS, no counters()) gives nothing to read,
    and no reader raises."""
    monkeypatch.delattr(profiling, "SPANS")
    monkeypatch.delattr(profiling, "counters")
    assert program_spans.ring() == [] and program_spans.counters() == {}
    run, _ = _synthetic()
    for name in NEW:
        assert _read(name, run) is None, name


@pytest.mark.cuda
def test_program_spans_inside_benchmark_spans_on_the_card(run_tiny,
                                                          monkeypatch):
    """On the card, every program span of a traced request lies inside
    its benchmark span on the profiler's clock, within 50 µs, once
    mapped; the masked cell's new metrics are in its line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = []

    class Kept(harness.Run):
        def __init__(self, *a):
            super().__init__(*a)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    out = run_tiny("plugin-2048-bias-remove100",
                   device=torch.device("cuda", 0), trace=True)
    assert out["correct"], out["checks"]
    for name in ("mask_place_ms", "seam_issue_us", "materialize_ms.single",
                 "readback_mb.single", "upload_mb.single", "kernel_load_s"):
        assert out["metrics"][name]["value"] > 0, name
    run = runs[-1]
    r = program_spans.analyse(run, program_spans.ring())
    traced = {(s.name, s.index): s for s in run.trace.spans}
    held = [s for s in r.spans if (s.bench, s.index) in traced]
    assert held and r.offset_ns is not None
    # spans are recorded while the profiler runs, and only then
    assert {s.index for s in r.spans} == {s.index for s in run.trace.spans}
    for s in held:
        b = traced[(s.bench, s.index)]
        assert b.start_ns - 50 * US <= s.start_ns + r.offset_ns, s
        assert s.end_ns + r.offset_ns <= b.end_ns + 50 * US, s
