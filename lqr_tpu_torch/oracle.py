"""Mask strength (SPEC.md §1), the NumPy reader that masks are placed with.

Counterpart of ``lqr_tpu.oracle.strength``, the one function of the NumPy
oracle that the port's host API needs.
"""

from __future__ import annotations

import numpy as np


def strength(img: np.ndarray) -> np.ndarray:
    """Mask strength: mean(color)/255 * alpha (SPEC.md §1).

    Op order is pinned for bit-exact cross-implementation matching:
    sum(color channels, f32) * f32(1/(255*nc)), then * (alpha * f32(1/255)).
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    has_alpha = c in (2, 4)
    nc = c - (1 if has_alpha else 0)
    s = img[:, :, :nc].astype(np.float32).sum(axis=2, dtype=np.float32)
    s = s * np.float32(1.0 / (255 * nc))
    if has_alpha:
        s = s * (img[:, :, -1].astype(np.float32) * np.float32(1.0 / 255))
    return s.astype(np.float32)
