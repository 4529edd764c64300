"""Visibility-map colorization — the seam-map output layer.

Re-implements the color law of ``write_vmap_to_layer``
(gimp-lqr-plugin src/io_functions.c:246-262, SPEC.md §8): seam order index is
mapped to a color interpolated between two gradient endpoints, with alpha
encoding recency; un-carved pixels are fully transparent.

A copy of ``lqr_tpu.vmap_render``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .config import SeamColors


def render_vmap(data: np.ndarray, depth: int,
                colors: SeamColors | None = None) -> np.ndarray:
    """Render a visibility map to an RGBA uint8 image.

    data: [h, w] int (0 = never carved, 1..depth = seam order).
    Returns [h, w, 4] uint8. Matches the reference law exactly:
      value = (depth + 1 - vs) / (depth + 1)
      rgb   = value * col_start + (1 - value) * col_end
      a     = 0.5 * (1 + value);     vs == 0 -> (0, 0, 0, 0)
    with float -> uint8 C-cast truncation (io_functions.c:257-261).
    """
    if colors is None:
        colors = SeamColors()
    data = np.asarray(data)
    vs = data.astype(np.float64)
    value = (depth + 1 - vs) / (depth + 1)
    start = np.array([colors.r1, colors.g1, colors.b1], np.float64)
    end = np.array([colors.r2, colors.g2, colors.b2], np.float64)
    rgb = value[:, :, None] * start + (1.0 - value[:, :, None]) * end
    a = 0.5 * (1.0 + value)
    out = np.empty(data.shape + (4,), np.uint8)
    # C truncation semantics: (guchar)(255 * x)
    out[:, :, :3] = (255.0 * rgb).astype(np.uint8)
    out[:, :, 3] = (255.0 * a).astype(np.uint8)
    out[data == 0] = 0
    return out
