"""Auto-size guess for object removal.

Re-implements ``guess_new_size`` (gimp-lqr-plugin src/layers_combo.c:274-392):
scan the discard mask over its overlap with the layer; per line transverse to
the resize direction, count pixels whose mask value is above threshold; the
new size is the old size minus the maximum count. Threshold law
(gimp-lqr-plugin help/en/index.wiki:60): mean(color)/255 * alpha >= 0.5/c_bpp
where c_bpp is the mask's color channel count.

A copy of ``lqr_tpu.guess``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

HOR = 0
VERT = 1


def guess_new_size(mask: np.ndarray, old_width: int, old_height: int,
                   direction: int, x_off: int = 0, y_off: int = 0) -> int:
    """mask: [hm, wm(,C)] uint8 placed at (x_off, y_off) on the layer.

    direction HOR guesses the new width; VERT the new height.
    """
    mask = np.asarray(mask, np.uint8)
    if mask.ndim == 2:
        mask = mask[:, :, None]
    hm, wm, bpp = mask.shape
    has_alpha = bpp in (2, 4)
    c_bpp = bpp - (1 if has_alpha else 0)

    # overlap window in layer coordinates (layers_combo.c:322-344)
    x0, x1 = max(0, x_off), min(old_width, wm + x_off)
    y0, y1 = max(0, y_off), min(old_height, hm + y_off)
    old_size = old_width if direction == HOR else old_height
    if x1 <= x0 or y1 <= y0:
        return old_size

    sub = mask[y0 - y_off:y1 - y_off, x0 - x_off:x1 - x_off]
    s = sub[:, :, :c_bpp].astype(np.float64).sum(axis=2) / (255.0 * c_bpp)
    if has_alpha:
        s = s * (sub[:, :, -1].astype(np.float64) / 255.0)
    above = s >= (0.5 / c_bpp)
    axis = 1 if direction == HOR else 0   # count along rows for HOR
    max_count = int(above.sum(axis=axis).max(initial=0))
    return old_size - max_count
