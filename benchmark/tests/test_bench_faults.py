"""The comparison that decides ``correct`` catches what it must: a sound
run of each tiny cell is correct; the control (the plain reference in
bfloat16 in the program's place) is not, nor is a run whose timed path is
broken underneath: a carve that leaves the state unchanged, half of a wave
left out, an answer altered where it is produced, a rigidity mask dropped
or its field made uniform."""

import numpy as np
import pytest
import torch

CELLS = ("plugin-2048-remove100", "plugin-2048-bias-remove100",
         "batch-1mp-wave256", "batch-1mp-wave16",
         "plugin-1024x768-masks-rig-remove100")
BATCH_CELLS = ("batch-1mp-wave256", "batch-1mp-wave16")
RIG_CELLS = ("plugin-1024x768-masks-rig-remove100",)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(run_tiny, workload):
    out = run_tiny(workload)
    assert out["correct"], out["checks"]
    assert out["checks"]["vs_mismatch"]["value"] == 0
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(run_tiny, workload):
    out = run_tiny(workload, control=torch.bfloat16)
    assert not out["correct"]
    assert out["checks"]["vs_mismatch"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_state_left_unchanged(run_tiny, monkeypatch, workload):
    from lqr_tpu_torch.core import engine
    from lqr_tpu_torch.parallel import batch

    def patch():
        monkeypatch.setattr(engine, "extend_map",
                            lambda cfg, st, k, *a, **kw: st)
        monkeypatch.setattr(batch, "extend_batched",
                            lambda cfg, st, k, *a, **kw: st)
    out = run_tiny(workload, patch=patch)
    assert not out["correct"]


@pytest.mark.parametrize("workload", BATCH_CELLS)
def test_half_the_wave_left_out(run_tiny, monkeypatch, workload):
    from lqr_tpu_torch.parallel import BatchCarver
    carve = BatchCarver.carve

    def half(self, n):
        counts = np.full(len(self.widths), n)
        counts[len(counts) // 2:] = 0
        return carve(self, counts)

    # six waves, whatever the window's time holds: a fixed set of kept
    # waves and picked images
    out = run_tiny(workload, seconds=0, requests=6,
                   patch=lambda: monkeypatch.setattr(BatchCarver, "carve",
                                                     half))
    assert not out["correct"]


@pytest.mark.parametrize("workload", RIG_CELLS)
def test_rigidity_mask_dropped(run_tiny, monkeypatch, workload):
    """The carver never given the rigidity mask: a uniform rigidity."""
    from lqr_tpu_torch.carver import Carver
    out = run_tiny(workload, patch=lambda: monkeypatch.setattr(
        Carver, "rigmask_add", lambda self, *a, **kw: None))
    assert not out["correct"]
    assert out["checks"]["vs_mismatch"]["value"] > 0


@pytest.mark.parametrize("workload", RIG_CELLS)
def test_rigidity_made_uniform(run_tiny, monkeypatch, workload):
    """The per-pixel rigidity replaced by a uniform field of its mean."""
    from lqr_tpu_torch import carver
    init_state = carver.init_state

    def uniform(cfg, img, *a, rig=None, **kw):
        if rig is not None:
            rig = torch.full_like(rig, float(rig.mean()))
        return init_state(cfg, img, *a, rig=rig, **kw)

    out = run_tiny(workload, patch=lambda: monkeypatch.setattr(
        carver, "init_state", uniform))
    assert not out["correct"]
    assert out["checks"]["vs_mismatch"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered(run_tiny, monkeypatch, workload):
    from lqr_tpu_torch.core import engine
    materialize = engine.materialize_array

    def altered(*a, **kw):
        out = materialize(*a, **kw).clone()
        if out.dtype == torch.uint8:      # the image, not a bias plane
            out[0, 0, 0] ^= 1
        return out

    out = run_tiny(workload, patch=lambda: monkeypatch.setattr(
        engine, "materialize_array", altered))
    assert not out["correct"]
    assert out["checks"]["pixel_mismatch"]["value"] > 0
    assert out["checks"]["vs_mismatch"]["value"] == 0


def test_traced_run_is_correct_and_reads_spans(run_tiny):
    out = run_tiny("plugin-2048-bias-remove100", trace=True)
    assert out["correct"]
    assert out["metrics"]["resize_ms"]["value"] > 0
    assert "busy_s" in out["device"] and "breakdown" in out


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_on_the_card(run_tiny, workload):
    """On the card (the CUDA kernels), a sound tiny run is correct, traced
    with device time, and the control is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    out = run_tiny(workload, device=dev, trace=True)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert not run_tiny(workload, device=dev,
                        control=torch.bfloat16)["correct"]
