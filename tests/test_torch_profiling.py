"""The port's profiling module (lqr_tpu_torch.profiling) on the CPU: the
per-seam roofline's terms against lqr_tpu.profiling's where both routes
move the same bytes, the port's own backtrack and commit terms, the
memory rate by card name (an unknown card raises), the Stopwatch on a CPU
tensor, and a trace of a small CPU carve that holds an annotate span."""

import json

import numpy as np
import pytest
import torch

from lqr_tpu import profiling as jprof
from lqr_tpu_torch import Carver, LqrConfigError
from lqr_tpu_torch import profiling as tprof

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


def test_stopwatch_on_a_cpu_tensor():
    sw = tprof.Stopwatch()
    x = torch.zeros((8, 8)) + 1
    dt = sw.lap("op", x)
    assert dt >= 0 and sw.lap("none") >= 0
    assert [n for n, _ in sw.laps] == ["op", "none"]
    assert "op: " in sw.report() and "none: " in sw.report()


def test_trace_holds_the_annotated_span(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 40, 3)).astype(np.uint8)
    c = Carver(img, device="cpu")
    with tprof.trace(tmp_path / "tr") as path:
        with tprof.annotate("retarget"):
            c.resize(30, 16)
    assert path.parent == tmp_path / "tr" and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "retarget"]
    assert spans and all(e.get("dur", 0) > 0 for e in spans)
