"""Mask placements shared by the CPU and the CUDA tests of
``ops.place_mask`` (``test_torch_masks.py``, ``test_torch_codec.py``,
``test_torch_kernels_cuda.py``). Imports nothing of the packages."""

import numpy as np

# placements summed in turn into one MASK_PLANE plane: ((x_off, y_off),
# factor, (hm, wm)) inside, negative, past the far edges, wholly outside,
# and a mask larger than the plane
MASK_PLANE = (20, 30)
MASK_PLACEMENTS = [((3, 2), 1000.0, (9, 14)), ((-4, -3), -1000.0, (9, 14)),
                   ((25, 15), -800.0, (9, 14)), ((-20, 0), 1000.0, (9, 14)),
                   ((0, 40), -800.0, (9, 14)), ((-3, -2), -1000.0, (26, 37))]


def mask_runs(channels: int, n: int, seed: int = 0) -> list:
    """Every run of n placements of MASK_PLACEMENTS in turn, wrapping
    around: [[(mask [hm, wm, channels] u8, x_off, y_off, factor), ...],
    ...]. Every third pixel of a mask is 0 in all its channels, so its
    field holds zeros inside the mask too."""
    rng = np.random.default_rng(seed)
    masks = []
    for _, _, (hm, wm) in MASK_PLACEMENTS:
        m = rng.integers(0, 256, (hm, wm, channels)).astype(np.uint8)
        m.reshape(-1, channels)[::3] = 0
        masks.append(m)
    runs = []
    for i in range(len(MASK_PLACEMENTS)):
        run = []
        for j in range(n):
            k = (i + j) % len(MASK_PLACEMENTS)
            (x_off, y_off), factor, _ = MASK_PLACEMENTS[k]
            run.append((masks[k], x_off, y_off, factor))
        runs.append(run)
    return runs


def cell_masks(hw, count: int, seed: int = 0) -> list:
    """count image-sized one-channel masks, each 255 on a random block of
    rows and columns and random grey elsewhere, with the masked cells'
    factors: +1000, -1000, then rigidity masks (factor None)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    out = []
    for j in range(count):
        m = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
        m[h // 4:h // 2, w // (j + 2):w // 2] = 255
        out.append((m, (1000.0, -1000.0, None)[min(j, 2)]))
    return out
