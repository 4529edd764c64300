"""BatchCarver's readback on the card: ``images_at`` and ``aux_at`` copy
only the kept columns into page-locked host memory from PyTorch's host
cache, and hand back exactly the bytes of the same batch carved on the CPU.

Marked ``cuda``; every test skips where CUDA is unavailable. On a machine
with an NVIDIA GPU (no jax needed, so skip tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_batch_readback.py
"""

import numpy as np
import pytest
import torch

from lqr_tpu_torch import profiling
from lqr_tpu_torch.parallel import BatchCarver

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; CUDA is not available")
    return torch.device("cuda", 0)


def _image(seed, h, w, c=3):
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 256, (h, w, c)) // 64) * 64).astype(np.uint8)


def _moved(fn):
    """fn()'s result and the counters it moved, by name."""
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


# (sizes (h, w), seams a map): an equal-size wave, and a ragged one whose
# widths and heights differ, so max(w) is below the padded width Wb
WAVES = {
    "equal": ([(48, 160)] * 4, [24] * 4),
    "ragged": ([(40, 150), (64, 200), (25, 90), (64, 120)], [20, 31, 9, 0]),
}


@pytest.mark.parametrize("wave", sorted(WAVES))
def test_images_at_equals_the_cpu_carve(cuda, wave):
    sizes, seams = WAVES[wave]
    imgs = [_image(10 + i, h, w) for i, (h, w) in enumerate(sizes)]
    aux = [[_image(40 + i, h, w, 1)] for i, (h, w) in enumerate(sizes)]
    n = np.asarray(seams)
    got = BatchCarver(imgs, aux=aux, device=cuda).carve(n)
    want = BatchCarver(imgs, aux=aux, device="cpu").carve(n)
    widths = got.widths - n
    assert widths.max() < got.cfg.Wb
    for g, e in zip(got.images_at(widths), want.images_at(widths)):
        assert g.shape == e.shape and g.dtype == e.dtype
        np.testing.assert_array_equal(g, e)
    for g, e in zip(got.aux_at(widths), want.aux_at(widths)):
        np.testing.assert_array_equal(g[0], e[0])


def test_arrays_are_page_locked_and_counted(cuda):
    sizes, seams = WAVES["ragged"]
    imgs = [_image(20 + i, h, w) for i, (h, w) in enumerate(sizes)]
    aux = [[_image(50 + i, h, w, 1)] for i, (h, w) in enumerate(sizes)]
    bc = BatchCarver(imgs, aux=aux, device=cuda).carve(np.asarray(seams))
    widths = bc.widths - np.asarray(seams)
    for read in (bc.images_at, bc.aux_at):
        outs, moved = _moved(lambda: read(widths))
        arrays = [o if read == bc.images_at else o[0] for o in outs]
        assert all(torch.from_numpy(a).is_pinned() for a in arrays)
        C = arrays[0].shape[2]
        # only the kept columns of every padded row came back
        assert moved["bytes.d2h"] == (len(sizes) * bc.cfg.H * widths.max()
                                      * C)
        assert moved["bytes.d2h_pinned"] == moved["bytes.d2h"]


def test_held_arrays_stay_the_callers_own(cuda):
    """Arrays of a first wave, still held, are unchanged by a second
    BatchCarver's images_at of other images."""
    first = BatchCarver([_image(1, 32, 100), _image(2, 32, 100)],
                        device=cuda).carve(10)
    held = first.images_at(90)
    kept = [a.copy() for a in held]
    del first
    second = BatchCarver([_image(3, 32, 100), _image(4, 32, 100)],
                         device=cuda).carve(10)
    for _ in range(3):
        other = second.images_at(90)
        assert not any(np.shares_memory(a, b) for a in held for b in other)
        assert not all(np.array_equal(a, b) for a, b in zip(kept, other))
        del other
    for a, k in zip(held, kept):
        np.testing.assert_array_equal(a, k)


def test_pinned_allocation_failure_falls_back(cuda, monkeypatch):
    """A failed page-locked allocation gives the same bytes through a
    pageable copy, not counted as pinned."""
    imgs = [_image(5, 40, 130), _image(6, 30, 110)]
    bc = BatchCarver(imgs, device=cuda).carve([12, 7])
    widths = bc.widths - np.asarray([12, 7])
    want = bc.images_at(widths)
    empty = torch.empty

    def refuse(*args, **kw):
        if kw.get("pin_memory"):
            raise RuntimeError("no page-locked memory")
        return empty(*args, **kw)

    monkeypatch.setattr(torch, "empty", refuse)
    got, moved = _moved(lambda: bc.images_at(widths))
    assert moved["bytes.d2h"] == 2 * 40 * widths.max() * 3
    assert "bytes.d2h_pinned" not in moved
    for g, e in zip(got, want):
        assert not torch.from_numpy(g).is_pinned()
        np.testing.assert_array_equal(g, e)
