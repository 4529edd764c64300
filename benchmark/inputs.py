"""Inputs made from the seed: structured RGB images, waves of crops of a
base image, and feature masks (preservation ellipses, discard rectangles).

Images are made on the device in a few large calls from a
``torch.Generator`` and copied to the host once: a caller hands the
carver host images. The same seed on the same device gives the same
inputs; every seed gives the same sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def seed64(seed: int, stream: int = 0) -> int:
    """A non-negative 63-bit generator seed of a run seed and a stream."""
    return (int(seed) * 1_000_003 + stream) % (1 << 63)


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed64(seed, stream))
    return g


def structured(n: int, h: int, w: int, seed: int, stream: int,
               device) -> torch.Tensor:
    """n smooth structured images [n, h, w, 3] u8 on the device: uniform
    noise blurred three times by a 5-point stencil (pure noise gives
    degenerate seams), plus sinusoidal bands of random phase."""
    g = _generator(seed, stream, device)
    img = torch.randint(0, 256, (n, h, w, 3), generator=g, device=device,
                        dtype=torch.uint8).to(torch.float32)
    for _ in range(3):
        img = (img + img.roll(1, 1) + img.roll(1, 2) + img.roll(-1, 1)
               + img.roll(-1, 2)) / 5.0
    phase = torch.rand((n, 3, 1, 1), generator=g, device=device) * 6.2832
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    img[..., 0] += (60 * torch.sin(xx / 37.0 + phase[:, 0])
                    + 40 * torch.cos(yy / 53.0 + phase[:, 1]))
    img[..., 1] += 50 * torch.cos((xx + yy) / 41.0 + phase[:, 2])
    return img.clamp_(0, 255).to(torch.uint8)


def image_pool(n: int, h: int, w: int, seed: int, device) -> np.ndarray:
    """n distinct structured images, [n, h, w, 3] u8 on the host."""
    return structured(n, h, w, seed, 1, device).cpu().numpy()


def waves(n_waves: int, batch: int, size: int, seed: int, device,
          shift: int = 64) -> np.ndarray:
    """n_waves waves, [n_waves, batch, size, size, 3] u8 on the host: each
    wave's images are crops at seeded offsets in [0, shift) of one
    structured (size + shift)^2 base image of its own."""
    out = torch.empty((n_waves, batch, size, size, 3), dtype=torch.uint8,
                      device=device)
    g = _generator(seed, 2, device)
    for k in range(n_waves):
        base = structured(1, size + shift, size + shift, seed, 10 + k,
                          device)[0]
        offs = torch.randint(0, shift, (batch, 2), generator=g,
                             device=device).tolist()
        for i, (dy, dx) in enumerate(offs):
            out[k, i] = base[dy:dy + size, dx:dx + size]
    return out.cpu().numpy()


def _draw_box(r: np.random.Generator, h: int, w: int, area: float,
              aspect: float) -> tuple[float, float]:
    """(height, width) of a shape of the given area share and aspect
    (width / height), shrunk to fit the image."""
    a = area * h * w
    bh, bw = math.sqrt(a / aspect), math.sqrt(a * aspect)
    scale = min(1.0, (h - 2) / bh, (w - 2) / bw)
    return bh * scale, bw * scale


def ellipse_mask(r: np.random.Generator, h: int, w: int,
                 area: tuple[float, float]) -> np.ndarray:
    """A [h, w] u8 mask, 255 inside an ellipse over a seeded share of the
    area in [area[0], area[1]] (before clipping to the image), 0 outside."""
    share = r.uniform(*area)
    aspect = r.uniform(0.5, 2.0)
    # the ellipse's bounding box has 4 / pi of its area
    bh, bw = _draw_box(r, h, w, share * 4 / math.pi, aspect)
    cy = r.uniform(bh / 2, h - bh / 2)
    cx = r.uniform(bw / 2, w - bw / 2)
    yy = (np.arange(h, dtype=np.float64)[:, None] + 0.5 - cy) / (bh / 2)
    xx = (np.arange(w, dtype=np.float64)[None, :] + 0.5 - cx) / (bw / 2)
    return np.where(yy * yy + xx * xx <= 1.0, 255, 0).astype(np.uint8)


def rect_mask(r: np.random.Generator, h: int, w: int,
              area: tuple[float, float]) -> np.ndarray:
    """A [h, w] u8 mask, 255 inside a rectangle over a seeded share of the
    area in [area[0], area[1]], 0 outside."""
    share = r.uniform(*area)
    aspect = r.uniform(0.5, 2.0)
    bh, bw = _draw_box(r, h, w, share, aspect)
    bh, bw = max(1, round(bh)), max(1, round(bw))
    y0 = int(r.integers(0, h - bh + 1))
    x0 = int(r.integers(0, w - bw + 1))
    m = np.zeros((h, w), np.uint8)
    m[y0:y0 + bh, x0:x0 + bw] = 255
    return m


SHAPES = {"ellipse": ellipse_mask, "rect": rect_mask}


def masks(spec: list[dict], n: int, h: int, w: int, seed: int,
          stream: int = 3) -> list[list[np.ndarray]]:
    """For each of n requests, one [h, w] u8 mask per entry of `spec`
    (each {"shape": "ellipse" | "rect", "area": [lo, hi], ...}), drawn
    from the seed's stream `stream`: 3 for bias masks, 5 for rigidity
    masks (the images take 1, 2 and 10 + k, the check's picks 4 and 7)."""
    r = np.random.default_rng(seed64(seed, stream))
    return [[SHAPES[m["shape"]](r, h, w, tuple(m["area"])) for m in spec]
            for _ in range(n)]
