"""Each metric reader on a synthetic run: host spans, a profiler record."""

import pytest

from benchmark import device_trace as dt
from benchmark import harness

MS = 1_000_000   # ns


def _run(events, trace_spans, host_spans, device="NVIDIA H100 80GB HBM3"):
    reqs = [harness.Request(i, 100, 67_000_000_000, 1_000, 0.0, 0.1)
            for i in range(2)]
    tr = dt.Trace(events, trace_spans) if trace_spans else None
    return harness.Run(10.0, 1.0, reqs, host_spans, tr, device)


def _synthetic():
    # two requests: upload 0-2 ms, resize 2-10 ms, readback 10-12 ms; the
    # second 20 ms later
    spans = []
    for i, t in enumerate((0, 20)):
        spans += [dt.Span("upload", i, t * MS, (t + 2) * MS),
                  dt.Span("resize", i, (t + 2) * MS, (t + 10) * MS),
                  dt.Span("readback", i, (t + 10) * MS, (t + 12) * MS)]
    events = []
    for t in (0, 20):
        events += [dt.DeviceEvent("Memcpy HtoD (Pageable -> Device)",
                                  t * MS, (t + 1) * MS),
                   dt.DeviceEvent("carve_kernel", (t + 3) * MS,
                                  (t + 8) * MS),
                   dt.DeviceEvent("elementwise", (t + 8) * MS,
                                  (t + 9) * MS),
                   dt.DeviceEvent("Memcpy DtoH (Device -> Pageable)",
                                  (t + 10) * MS, (t + 11) * MS)]
    return events, spans


def _read(name, run):
    kind = "end_to_end" if name in ("setup_s", "seams_per_s",
                                    "image_ms_p95") else "layer_metrics"
    return harness.find_reader(name, kind).read(run)


def test_span_medians():
    events, spans = _synthetic()
    run = _run(events, spans, spans)
    assert _read("carver_host_ms", run) == pytest.approx(4.0)
    assert _read("resize_ms", run) == pytest.approx(8.0)
    assert _read("wave_host_ms", run) == pytest.approx(4.0)
    assert _read("wave_carve_ms", run) is None     # no carve spans


def test_trace_numbers():
    events, spans = _synthetic()
    run = _run(events, spans, spans)
    # 2 kernels a request inside resize, 100 seams each
    assert _read("kernels_per_seam", run) == pytest.approx(0.02)
    # window 32 ms, busy 4 x 2 requests = 16 ms (8 ms per request: copy 1,
    # kernels 5 + 1, copy 1)
    assert dt.busy_s(run.trace) == pytest.approx(0.016)
    assert _read("device_idle_pct.single", run) == pytest.approx(50.0)
    # least time: 2 x 67 G ops at 67 T ops/s = 2 ms over 12 ms of kernels
    assert _read("carve_roofline.single", run) == pytest.approx(100 / 6)
    assert _read("carve_roofline.batch", run) == pytest.approx(100 / 6)
    bd = dt.breakdown(run.trace)
    assert bd["device_ops"][0] == ["carve_kernel", pytest.approx(0.010)]
    idle = dict(bd["idle_gaps"])
    # idle: upload 1, resize 1 + 1, readback 1 a request; 8 between
    assert idle["resize"] == pytest.approx(0.004)
    assert idle["upload"] == pytest.approx(0.002)
    assert idle["readback"] == pytest.approx(0.002)
    assert idle[dt.BETWEEN] == pytest.approx(0.008)


def test_nothing_to_read_gives_none():
    run = _run([], [], [])
    for name in ("carver_host_ms", "resize_ms", "kernels_per_seam",
                 "carve_roofline.single", "device_idle_pct.batch"):
        assert _read(name, run) is None
    events, spans = _synthetic()
    other = _run(events, spans, spans, device="Some Other GPU")
    assert _read("carve_roofline.single", other) is None


def test_end_to_end_readers():
    reqs = [harness.Request(i, 100, 0, 0, 0.0, (i + 1) / 1000)
            for i in range(100)]
    run = harness.Run(12.5, 2.0, reqs, [], None, "cpu")
    assert _read("setup_s", run) == 12.5
    assert _read("seams_per_s", run) == pytest.approx(5000.0)
    assert _read("image_ms_p95", run) == pytest.approx(95.05)


def test_events_go_to_the_span_that_launched_them():
    """A kernel whose start the device clock puts before its span's start
    still belongs to the span that launched it."""
    spans = [dt.Span("upload", 0, 0, 2 * MS), dt.Span("resize", 0, 2 * MS,
                                                      10 * MS)]
    early = dt.DeviceEvent("carve_kernel", 1 * MS, 8 * MS,
                           launch_ns=2 * MS + 10)
    copy = dt.DeviceEvent("Memcpy HtoD (Pageable -> Device)", 0, 1 * MS)
    tr = dt.Trace([copy, early], spans)
    assert dt.events_in(tr, ("resize",)) == [early]
    assert dt.events_in(tr, ("upload",)) == [copy]
