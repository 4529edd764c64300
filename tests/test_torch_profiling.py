"""The port's profiling module (lqr_tpu_torch.profiling) on the CPU: the
per-seam roofline's terms against lqr_tpu.profiling's where both routes
move the same bytes, the port's own backtrack and commit terms, the
memory rate by card name (an unknown card raises), the spans (off: the
shared no-op and an empty ring; on under torch.profiler: names, parents
and the Chrome trace), and the counters (seams and host time by route,
traced or not, bytes each way, the kernels' load, the registered groups,
the totals the ring's records keep)."""

import ctypes
import functools
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lqr_tpu import profiling as jprof
from lqr_tpu_torch import BatchCarver, Carver, LqrConfigError
from lqr_tpu_torch import native
from lqr_tpu_torch import profiling as tprof
from lqr_tpu_torch.core import engine
from lqr_tpu_torch.ops import _build, carve_resident, dp_cuda
from lqr_tpu_torch.parallel import batch, make_mesh, sharding
from lqr_tpu_torch.utils import codec

torch.set_num_threads(1)

SHARED = ("energy", "dp_forward", "compact")


@pytest.mark.parametrize("H,W", [(2048, 2048), (24, 40), (768, 1024)])
@pytest.mark.parametrize("has_bias,has_rig",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_roofline_terms_match_jax(H, W, has_bias, has_rig):
    t = tprof.seam_roofline(H, W, has_bias, has_rig, hbm_gbps=819.0)
    j = jprof.seam_roofline(H, W, has_bias, has_rig, hbm_gbps=819.0)
    assert t.breakdown.keys() == j.breakdown.keys()
    for k in SHARED:
        assert t.breakdown[k] == j.breakdown[k], k
    # the chase reads one bp byte a row (M_last in, the seam out), not
    # JAX's one-hot planes; the commit compacts posmap with the planes and
    # scatters the seam's reference columns into vs
    assert t.breakdown["backtrack"] == 4 * W + H + 4 * H
    assert t.breakdown["commit_amortized"] == 2 * 4 * H * W + 2 * 4 * H
    assert t.hbm_bytes == sum(t.breakdown.values())
    assert t.seq_rows == j.seq_rows == H
    assert t.sol_seams_per_s == 819.0e9 / t.hbm_bytes


def test_roofline_masks_add_compaction_traffic():
    r = tprof.seam_roofline(2048, 2048, hbm_gbps=3350.0)
    r2 = tprof.seam_roofline(2048, 2048, has_bias=True, has_rig=True,
                             hbm_gbps=3350.0)
    assert r2.breakdown["compact"] == 3 * r.breakdown["compact"]
    assert r2.hbm_bytes > r.hbm_bytes
    assert r2.sol_seams_per_s < r.sol_seams_per_s


def test_roofline_efficiency():
    r = tprof.seam_roofline(512, 384, hbm_gbps=3350.0)
    assert r.efficiency(r.sol_seams_per_s) == 1.0
    assert r.efficiency(r.sol_seams_per_s / 4) == 0.25


def test_memory_rate_by_card_name(monkeypatch):
    assert tprof.hbm_gbps_of("NVIDIA H100 80GB HBM3") == 3350.0
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(LqrConfigError, match="hbm_gbps"):
            tprof.hbm_gbps_of(name)
    # no rate given: the card's, and an unknown card or no card raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    r = tprof.seam_roofline(64, 64)
    assert r.sol_seams_per_s == 3350.0e9 / r.hbm_bytes
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "Some Future GPU")
    with pytest.raises(LqrConfigError):
        tprof.seam_roofline(64, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(LqrConfigError):
        tprof.seam_roofline(64, 64)


def test_trace_holds_the_annotated_span(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 40, 3)).astype(np.uint8)
    c = Carver(img, device="cpu")
    with tprof.trace(tmp_path / "tr") as path:
        with tprof.annotate("retarget"):
            c.resize(30, 16)
    assert path.parent == tmp_path / "tr" and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "lqr.retarget"]
    assert spans and all(e.get("dur", 0) > 0 for e in spans)


# -- spans and counters -------------------------------------------------------

H, W, C = 16, 40, 3
MASK = np.full((8, 12, 3), 255, np.uint8)


def _image(seed=0, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (h, w, C)).astype(
        np.uint8)


def _request(route, monkeypatch, seams=7):
    """One masked Carver request (upload, bias_add, resize, get_image) on
    the given extend_map route."""
    monkeypatch.setattr(engine, "route", lambda cfg: route)
    c = Carver(_image(), device="cpu")
    c.bias_add(MASK, 1000.0, 5, 3)
    c.resize(W - seams, H)
    return c.get_image()


def _traced(fn):
    """fn() under torch.profiler; the ring's records it added."""
    tprof.SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return list(tprof.SPANS)


def _delta(fn) -> dict:
    """The counters fn() moved, by name."""
    before = tprof.counters()
    fn()
    after = tprof.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_spans_off_are_the_shared_no_op(monkeypatch):
    tprof.SPANS.clear()
    assert tprof.annotate("carver.resize") is tprof.NO_SPAN
    assert tprof.annotate("engine.seam") is tprof.NO_SPAN
    _request("per_seam", monkeypatch)
    assert len(tprof.SPANS) == 0


@pytest.mark.parametrize("route", ["resident", "per_seam"])
def test_spans_on_names_and_parents(route, monkeypatch):
    seams = 7
    records = _traced(lambda: _request(route, monkeypatch, seams))
    spans = [r for r in records if isinstance(r, tprof.Span)]
    by_id = {s.id: s for s in spans}

    def parent(s):
        return by_id[s.parent].name if s.parent else None

    top = sorted(s.name for s in spans if not s.parent)
    assert top == ["carver.bias_add", "carver.get_image", "carver.init",
                   "carver.resize"]
    expect = {"carver.upload": "carver.init",
              "carver.place_mask": "carver.bias_add",
              "mask.place": "carver.place_mask",
              "mask.copy": "carver.place_mask",
              "carver.build_map": "carver.resize",
              f"engine.{route}": "carver.resize",
              "carver.materialize": "carver.get_image",
              "carver.copy_out": "carver.get_image",
              "carver.host_copy": "carver.get_image"}
    if route == "per_seam":
        expect.update({"engine.seam": "engine.per_seam",
                       "seam.energy": "engine.seam",
                       "seam.find": "engine.seam",
                       "seam.compact": "engine.seam",
                       "seam.commit": "engine.seam"})
    else:
        expect.update({"resident.chunk": "engine.resident",
                       "resident.commit": "engine.resident"})
    for name, want in expect.items():
        found = [s for s in spans if s.name == name]
        assert found, name
        assert all(parent(s) == want for s in found), name
    # a child lies inside its parent, on one clock
    for s in spans:
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    n = {name: sum(s.name == name for s in spans) for name in expect}
    if route == "per_seam":
        assert n["engine.seam"] == n["seam.commit"] == seams
    else:
        assert n["resident.chunk"] == n["resident.commit"] == 1
        assert "engine.seam" not in {s.name for s in spans}
    # the counter updates of the window are records too, stamped inside
    # the span that made them
    counts = {r.name: r for r in records if isinstance(r, tprof.Count)}

    def inside(c, name):
        return any(s.start_ns <= c.t_ns <= s.end_ns for s in spans
                   if s.name == name)
    assert counts[f"seams.{route}"].value == seams
    assert inside(counts[f"seams.{route}"], "carver.resize")
    assert counts[f"route_ns.{route}"].value > 0
    assert inside(counts[f"route_ns.{route}"], "carver.resize")
    assert counts["bytes.d2h"].value == H * (W - seams) * C
    assert inside(counts["bytes.d2h"], "carver.get_image")


def test_chrome_trace_holds_the_carver_spans(tmp_path, monkeypatch):
    with tprof.trace(tmp_path) as path:
        _request("per_seam", monkeypatch, seams=3)
    names = [e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]]
    for name in ("carver.upload", "carver.place_mask", "mask.place",
                 "engine.per_seam", "engine.seam", "seam.find",
                 "carver.materialize", "carver.copy_out"):
        assert tprof.PREFIX + name in names, name
    assert names.count("lqr.engine.seam") == 3


def _solo(route, monkeypatch):
    monkeypatch.setattr(engine, "route", lambda cfg: route)
    Carver(_image(), device="cpu").resize(W - 5, H)


def _batched(resident, monkeypatch):
    monkeypatch.setattr(batch, "resident_ok", lambda *a: resident)
    BatchCarver([_image(1), _image(2)], device="cpu").carve([5, 4])


def _sharded(monkeypatch):
    mesh = make_mesh(devices=["cpu"] * 2, data=1)
    BatchCarver([_image(1), _image(2)], mesh=mesh).carve([5, 4])


@pytest.mark.parametrize("route", ["resident", "per_seam"])
def test_seams_counted_by_route(route, monkeypatch):
    moved = _delta(lambda: _solo(route, monkeypatch))
    assert moved.get(f"seams.{route}") == 5
    assert not [k for k in moved if k.startswith("seams.")
                and k != f"seams.{route}"]


@pytest.mark.parametrize("route", ["resident", "per_seam"])
def test_route_time_counted_untraced(route, monkeypatch):
    """Each extend_map call adds its host ns to route_ns.<route>, one
    update a call, with no profiler running and no record in the ring."""
    tprof.SPANS.clear()
    ns = []
    real = tprof.count

    def spy(name, n=1):
        if name.startswith("route_ns."):
            ns.append((name, n))
        real(name, n)
    monkeypatch.setattr(engine, "count", spy)
    moved = _delta(lambda: _solo(route, monkeypatch))
    assert len(ns) == 1 and ns[0][0] == f"route_ns.{route}" and ns[0][1] > 0
    assert moved[f"route_ns.{route}"] == ns[0][1]
    assert len(tprof.SPANS) == 0


@pytest.mark.parametrize("name,fn", [
    ("batch", lambda mp: _batched(True, mp)),
    ("sharded", _sharded),
])
def test_batched_routes_count_no_solo_seams(name, fn, monkeypatch):
    """The counters by route are extend_map's: a batch, whichever route
    carves it, moves none of them."""
    moved = _delta(lambda: fn(monkeypatch))
    assert not [k for k in moved if k.startswith(("seams.", "route_ns."))]


def test_count_records_keep_the_running_total(monkeypatch):
    """Under a profiler each update is a record holding its counter's
    value after it, so what a window's untraced rest added is the value
    now less the last record's total."""
    records = _traced(lambda: (_solo("per_seam", monkeypatch),
                               _solo("per_seam", monkeypatch)))
    seams = [r for r in records if isinstance(r, tprof.Count)
             and r.name == "seams.per_seam"]
    assert [r.value for r in seams] == [5, 5]
    assert seams[1].total == seams[0].total + 5
    _solo("per_seam", monkeypatch)                # untraced
    assert tprof.counters()["seams.per_seam"] - seams[-1].total == 5


def test_bytes_of_a_carver():
    img = _image()
    aux = img[:, :, :1].copy()
    c = Carver(img, device="cpu")
    moved = _delta(lambda: (c.bias_add(MASK, 500.0), c.attach(aux)))
    # the upload is counted at construction; the mask and the aux image
    # their own u8 bytes (the mask's field is built on the device)
    assert moved["bytes.h2d"] == MASK.nbytes + H * W * 1
    assert _delta(lambda: Carver(img, device="cpu"))["bytes.h2d"] == img.nbytes
    c.resize(W - 6, H)
    assert _delta(c.get_image)["bytes.d2h"] == H * (W - 6) * C
    assert _delta(lambda: c.get_aux(0))["bytes.d2h"] == H * (W - 6)
    assert _delta(c.vmap_dump)["bytes.d2h"] == H * W * 4


def test_bytes_of_a_batch():
    imgs = [_image(1), _image(2, h=12, w=30), _image(3)]
    moved = _delta(lambda: BatchCarver(imgs, device="cpu"))
    B, Hb, Wb = 3, H, 128              # padded to the tallest, 128 lanes
    assert moved["bytes.h2d"] == B * Hb * Wb * C
    bc = BatchCarver(imgs, device="cpu",
                     biases=[np.ones((H, W), np.float32), None,
                             np.ones((H, W), np.float32)])
    bc.carve(4)
    # images_at brings back the kept columns of every padded row, into
    # plain host memory from a CPU state
    out = []
    moved = _delta(lambda: out.extend(bc.images_at(26)))
    assert moved["bytes.d2h"] == B * Hb * 26 * C
    assert moved.get("bytes.d2h_pinned", 0) == 0
    assert [o.shape for o in out] == [(16, 26, 3), (12, 26, 3), (16, 26, 3)]


def test_existing_counters_are_registered_groups():
    assert tprof.COUNTERS["LAUNCHES"] is dp_cuda.LAUNCHES
    assert tprof.COUNTERS["EXCHANGES"] is sharding.EXCHANGES
    assert tprof.COUNTERS["HOST_COPIES"] is sharding.HOST_COPIES
    assert tprof.COUNTERS["EXCHANGE_SECONDS"] is sharding.EXCHANGE_SECONDS
    assert tprof.COUNTERS["GLOO_MESSAGES"] is sharding.GLOO_MESSAGES
    assert tprof.COUNTERS["BATCH_BLOCKS"] is carve_resident.BATCH_BLOCKS
    snap = tprof.counters()
    assert snap["LAUNCHES.dp_forward"] == dp_cuda.LAUNCHES["dp_forward"]
    assert snap["EXCHANGES.halo"] == sharding.EXCHANGES["halo"]


def test_setup_kernels_recorded_by_load(monkeypatch, tmp_path):
    """load() with nvcc and the CUDA library replaced: the first load
    counts its seconds, a build included; a second load counts
    nothing."""
    def fake_run(cmds):
        for cmd in cmds:
            out = cmd[cmd.index("-o") + 1]
            open(out, "wb").close()

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", functools.partial(
        _build.build, tmp_path / "liblqr_kernels.so"))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "bind", lambda lib: lib)
    built = []
    monkeypatch.setattr(_build, "_run", lambda cmds: (built.append(1),
                                                      fake_run(cmds)))
    moved = _delta(_build.load)
    assert built and moved == {"setup.kernels_s": moved["setup.kernels_s"]}
    assert moved["setup.kernels_s"] > 0
    assert _delta(_build.load) == {}
    # a library that is up to date is loaded, not built
    monkeypatch.setattr(_build, "_lib", None)
    built.clear()
    moved = _delta(_build.load)
    assert not built and moved["setup.kernels_s"] > 0


@pytest.mark.parametrize("module", [codec, native])
def test_setup_native_recorded_by_load(module, monkeypatch):
    monkeypatch.setattr(module, "_lib", None)
    moved = _delta(module._load)
    assert moved["setup.native_s"] > 0
    assert module._lib is not None
