"""A minimal layered-image model — the GIMP-image/layer stand-in.

The reference plugin manipulates GIMP images: layers with offsets, alpha
locks, layer masks, canvas resizes (SURVEY.md §1 L2/L3). This module gives
the render layer an equivalent host-side model so the orchestration logic
(lqr_tpu_torch.render) can mirror render.c faithfully without GIMP.

Pixels are numpy uint8 [h, w, C]; layer offsets are (x_off, y_off) in canvas
coordinates, canvas is (width, height).

A copy of ``lqr_tpu.image_model``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

_next_layer_id = itertools.count(1)


@dataclasses.dataclass
class Layer:
    name: str
    pixels: np.ndarray                 # [h, w, C] uint8
    x_off: int = 0
    y_off: int = 0
    alpha_lock: bool = False
    visible: bool = True
    mask: np.ndarray | None = None     # [h, w] uint8 layer mask, or None
    opacity: float = 100.0             # gimp_layer_set_opacity (percent)
    layer_id: int = -1                 # GIMP layer-ID analog; auto-assigned

    def __post_init__(self):
        p = np.asarray(self.pixels, np.uint8)
        if p.ndim == 2:
            p = p[:, :, None]
        self.pixels = p
        if self.layer_id < 0:
            self.layer_id = next(_next_layer_id)

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def bpp(self) -> int:
        return self.pixels.shape[2]

    @property
    def has_alpha(self) -> bool:
        return self.bpp in (2, 4)

    def copy(self, name: str | None = None) -> "Layer":
        return Layer(name=name or self.name, pixels=self.pixels.copy(),
                     x_off=self.x_off, y_off=self.y_off,
                     alpha_lock=self.alpha_lock, visible=self.visible,
                     mask=None if self.mask is None else self.mask.copy(),
                     opacity=self.opacity)

    def apply_mask(self):
        """GIMP_MASK_APPLY: multiply alpha by the layer mask, drop it."""
        if self.mask is None:
            return
        if not self.has_alpha:
            self.add_alpha()
        a = self.pixels[:, :, -1].astype(np.uint16)
        m = self.mask.astype(np.uint16)
        self.pixels[:, :, -1] = ((a * m) // 255).astype(np.uint8)
        self.mask = None

    def discard_mask(self):
        """GIMP_MASK_DISCARD: drop the mask unapplied."""
        self.mask = None

    def add_alpha(self):
        if self.has_alpha:
            return
        h, w, c = self.pixels.shape
        self.pixels = np.concatenate(
            [self.pixels, np.full((h, w, 1), 255, np.uint8)], axis=2)

    def resize(self, width: int, height: int, x_shift: int, y_shift: int,
               fill: int = 0):
        """gimp_layer_resize semantics: new canvas for the layer, old
        content placed at (x_shift, y_shift) inside it; offsets adjust so the
        content stays put in image space."""
        c = self.bpp
        out = np.full((height, width, c), fill, np.uint8)
        if self.has_alpha:
            out[:, :, -1] = 0   # exposed area is transparent
        y0, x0 = y_shift, x_shift
        ys0, xs0 = max(0, -y0), max(0, -x0)
        yd0, xd0 = max(0, y0), max(0, x0)
        hh = min(self.height - ys0, height - yd0)
        ww = min(self.width - xs0, width - xd0)
        if hh > 0 and ww > 0:
            out[yd0:yd0 + hh, xd0:xd0 + ww] = \
                self.pixels[ys0:ys0 + hh, xs0:xs0 + ww]
        self.pixels = out
        self.x_off -= x_shift
        self.y_off -= y_shift

    def scale(self, width: int, height: int):
        """gimp_layer_scale: uniform rescale (bilinear, SPEC.md §9)."""
        self.pixels = bilinear_scale(self.pixels, width, height)

    def translate(self, dx: int, dy: int):
        self.x_off += dx
        self.y_off += dy


@dataclasses.dataclass
class Image:
    width: int
    height: int
    layers: list = dataclasses.field(default_factory=list)
    active: str = ""

    @classmethod
    def from_array(cls, pixels: np.ndarray, name: str = "Background"):
        layer = Layer(name=name, pixels=pixels)
        return cls(width=layer.width, height=layer.height, layers=[layer],
                   active=name)

    def layer_by_name(self, name: str) -> Layer | None:
        """Name-based layer lookup (layer_from_name,
        gimp-lqr-plugin src/main.c:452-472)."""
        if not name:
            return None
        for l in self.layers:
            if l.name == name:
                return l
        return None

    def layer_by_id(self, layer_id: int) -> Layer | None:
        if layer_id < 0:
            return None
        for l in self.layers:
            if l.layer_id == layer_id:
                return l
        return None

    def layer_ref(self, ref) -> Layer | None:
        """Resolve a layer reference that is either an int layer ID or a
        name string. The reference plugin accepts both: raw PDB args carry
        IDs, and non-empty name strings override them
        (gimp-lqr-plugin src/main.c:556-576; the batch-gimp-lqr-full-use-id
        variant, gimp-lqr-plugin batch/batch-gimp-lqr.scm:134-197). "" or a
        negative ID means unset."""
        if ref is None:
            return None
        if isinstance(ref, int) and not isinstance(ref, bool):
            return self.layer_by_id(ref)
        return self.layer_by_name(ref)

    @property
    def active_layer(self) -> Layer:
        l = self.layer_by_name(self.active)
        assert l is not None, f"no active layer {self.active!r}"
        return l

    def add_layer(self, layer: Layer, position: int = 0):
        self.layers.insert(position, layer)

    def remove_layer(self, name: str):
        self.layers = [l for l in self.layers if l.name != name]

    def resize_canvas(self, width: int, height: int, dx: int, dy: int):
        """gimp_image_resize: canvas resized; layers keep image-space
        position shifted by (dx, dy)."""
        self.width, self.height = width, height
        for l in self.layers:
            l.translate(dx, dy)

    def resize_layer_to_image_size(self, layer: Layer):
        layer.resize(self.width, self.height, layer.x_off, layer.y_off)

    def flatten_visible(self) -> np.ndarray:
        """Composite visible layers (normal mode) over transparent, for
        preview/testing purposes."""
        out = np.zeros((self.height, self.width, 4), np.float64)
        for l in reversed(self.layers):
            if not l.visible:
                continue
            p = l.pixels.astype(np.float64)
            if l.bpp in (1, 2):
                color = np.repeat(p[:, :, :1], 3, axis=2)
            else:
                color = p[:, :, :3]
            alpha = (p[:, :, -1:] / 255.0 if l.has_alpha
                     else np.ones_like(p[:, :, :1]))
            alpha = alpha * (l.opacity / 100.0)
            x0, y0 = l.x_off, l.y_off
            xs0, ys0 = max(0, -x0), max(0, -y0)
            xd0, yd0 = max(0, x0), max(0, y0)
            ww = min(l.width - xs0, self.width - xd0)
            hh = min(l.height - ys0, self.height - yd0)
            if ww <= 0 or hh <= 0:
                continue
            dst = out[yd0:yd0 + hh, xd0:xd0 + ww]
            sa = alpha[ys0:ys0 + hh, xs0:xs0 + ww]
            sc = color[ys0:ys0 + hh, xs0:xs0 + ww]
            da = dst[:, :, 3:] / 255.0
            na = sa + da * (1 - sa)
            nc = np.where(na > 0,
                          (sc * sa + dst[:, :, :3] * da * (1 - sa))
                          / np.maximum(na, 1e-12), 0)
            dst[:, :, :3] = nc
            dst[:, :, 3:] = na * 255.0
        return np.clip(np.round(out), 0, 255).astype(np.uint8)


def bilinear_scale(pixels: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bilinear resample of a [h, w, C] uint8 image (SPEC.md §9 [CHOICE])."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    if (h, w) == (height, width):
        return pixels.copy()
    # pixel-center alignment
    ys = (np.arange(height) + 0.5) * (h / height) - 0.5
    xs = (np.arange(width) + 0.5) * (w / width) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    p = pixels.astype(np.float64)
    top = p[y0][:, x0] * (1 - fx) + p[y0][:, x1] * fx
    bot = p[y1][:, x0] * (1 - fx) + p[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    return np.clip(np.round(out), 0, 255).astype(pixels.dtype)
