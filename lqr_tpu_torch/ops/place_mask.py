"""Mask placement: a mask's strength field built into an image plane.

``place_mask(mask, H, W, x_off, y_off, f, prev)`` returns the [H, W] f32
plane ``prev + strength(mask) * f``, the mask placed at (x_off, y_off) and
clipped to the plane (SPEC.md §1, §3), +0 * f outside it; with ``prev``
None, the product alone. ``Carver.bias_add`` gives f = f32(factor / 1000)
and ``rigmask_add`` f = 1. The mask is u8 [hm, wm, mc] (1-4 channels) on
the device of the plane; the Carver checks its shape. The result equals
``place_mask_numpy(...) * f`` (+ ``prev``) bit for bit, the signs of zero
included: each step is one elementwise op, rounded once, in the order of
``oracle.strength``.

Plain PyTorch on the mask's device, so on a CUDA carver only the u8 mask
crosses to the card (lqr_tpu places masks on the host and copies the f32
field, ``lqr_tpu.carver._place_mask``). It writes a fresh plane and only
reads ``prev``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["place_mask"]


def place_mask(mask: torch.Tensor, H: int, W: int, x_off: int, y_off: int,
               f: np.float32,
               prev: torch.Tensor | None = None) -> torch.Tensor:
    """prev + the strength field of mask placed at (x_off, y_off) on an
    [H, W] plane, times f; see the module's docstring."""
    hm, wm, mc = mask.shape
    nc = mc - (1 if mc in (2, 4) else 0)
    m = mask.to(torch.float32)
    s = m[:, :, 0]
    for k in range(1, nc):
        s = s + m[:, :, k]
    # f32(1 / (255 nc)) and f32(1 / 255), rounded once as oracle.strength
    # rounds them: a reciprocal, never a division
    s = s * torch.tensor(np.float32(1.0 / (255 * nc)))
    if nc < mc:
        s = s * (m[:, :, mc - 1] * torch.tensor(np.float32(1.0 / 255)))
    field = torch.zeros((H, W), dtype=torch.float32, device=mask.device)
    y0, y1 = max(0, y_off), min(H, y_off + hm)
    x0, x1 = max(0, x_off), min(W, x_off + wm)
    if y1 > y0 and x1 > x0:
        field[y0:y1, x0:x1] = s[y0 - y_off:y1 - y_off, x0 - x_off:x1 - x_off]
    add = field * torch.tensor(np.float32(f))
    return add if prev is None else prev + add
