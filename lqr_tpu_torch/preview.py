"""Preview compositor — the thumbnail-with-mask-overlays law.

Replaces gimp-lqr-plugin src/preview.c:94-185: a bounded thumbnail of the
active layer with the in-use pres/disc/rigmask layers alpha-composited
over it at 50%, each placed at its (scaled) offset relative to the layer.

Laws mirrored:
- bound 300x200 (preview.h:26-27); factor = max(w/300, h/200, 1), preview
  dims = layer dims / factor truncated (interface.c:297-310);
- each aux layer's thumbnail is its own dims / factor with alpha kept,
  offsets relative to the active layer then divided by factor truncated
  (combo_get_active + size_info_scale, layers_combo.c:100-122,
  preview.c:123-131);
- composite with overall alpha 127/255 clipped to the preview bounds
  (preview_composite, preview.c:133-143);
- the base thumbnail renders transparency over a light/dark checkerboard
  (GIMP_PIXBUF_SMALL_CHECKS; 8-px checks of 0x99/0x66 [CHOICE] — GIMP's
  small-check rendering constants).

A copy of ``lqr_tpu.preview`` in NumPy (the thumbnails through the port's
``bilinear_scale``): the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .config import LqrConfig
from .image_model import Image, Layer, bilinear_scale

PREVIEW_MAX_WIDTH = 300    # gimp-lqr-plugin src/preview.h:26
PREVIEW_MAX_HEIGHT = 200   # gimp-lqr-plugin src/preview.h:27
_CHECK = 8
_CHECK_LIGHT, _CHECK_DARK = 0x99, 0x66


def _thumbnail(layer: Layer, w: int, h: int, keep_alpha: bool) -> np.ndarray:
    """gimp_drawable_get_thumbnail analog -> [h, w, 4] uint8 RGBA."""
    p = bilinear_scale(layer.pixels, w, h)
    c = p.shape[2]
    if c in (1, 2):
        rgb = np.repeat(p[:, :, :1], 3, axis=2)
    else:
        rgb = p[:, :, :3]
    if c in (2, 4):
        a = p[:, :, -1:]
    else:
        a = np.full((h, w, 1), 255, np.uint8)
    out = np.concatenate([rgb, a], axis=2)
    if not keep_alpha:
        yy, xx = np.mgrid[0:h, 0:w]
        checks = np.where(((yy // _CHECK) + (xx // _CHECK)) % 2 == 0,
                          _CHECK_LIGHT, _CHECK_DARK).astype(np.float64)
        af = out[:, :, 3:].astype(np.float64) / 255.0
        rgbf = out[:, :, :3].astype(np.float64)
        out = np.concatenate(
            [np.clip(np.round(rgbf * af + checks[:, :, None] * (1 - af)),
                     0, 255).astype(np.uint8),
             np.full((h, w, 1), 255, np.uint8)], axis=2)
    return out


def _composite_50(dst: np.ndarray, src: np.ndarray, x_off: int, y_off: int):
    """preview_composite (preview.c:133-143): alpha-over at overall alpha
    127/255, clipped to the destination bounds."""
    ph, pw = dst.shape[:2]
    sh, sw = src.shape[:2]
    dx0, dy0 = max(0, x_off), max(0, y_off)
    dx1 = min(pw, sw + x_off)
    dy1 = min(ph, sh + y_off)
    if dx1 <= dx0 or dy1 <= dy0:
        return
    s = src[dy0 - y_off:dy1 - y_off, dx0 - x_off:dx1 - x_off]
    d = dst[dy0:dy1, dx0:dx1]
    sa = (s[:, :, 3:].astype(np.float64) / 255.0) * (127.0 / 255.0)
    da = d[:, :, 3:].astype(np.float64) / 255.0
    na = sa + da * (1 - sa)
    safe = np.maximum(na, 1e-12)
    rgb = (s[:, :, :3] * sa + d[:, :, :3] * da * (1 - sa)) / safe
    d[:, :, :3] = np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    d[:, :, 3:] = np.clip(np.round(na * 255.0), 0, 255).astype(np.uint8)


def preview(image: Image, cfg: LqrConfig, *,
            pres_on: bool = True, disc_on: bool = True,
            rigmask_on: bool = True) -> np.ndarray:
    """Build the preview pixbuf (preview_build_pixbuf, preview.c:164-185).

    Returns [ph, pw, 4] uint8 RGBA where (pw, ph) follow the 300x200
    factor law. The three ``*_on`` flags mirror the dialog's activation
    checkboxes (ui_vals->pres_status etc.).
    """
    layer = (image.layer_by_name(cfg.selected_layer_name)
             or image.active_layer)
    factor = max(layer.width / PREVIEW_MAX_WIDTH,
                 layer.height / PREVIEW_MAX_HEIGHT, 1.0)
    pw = int(layer.width / factor)
    ph = int(layer.height / factor)
    base = _thumbnail(layer, pw, ph, keep_alpha=False)

    overlays = ((cfg.pres_layer, pres_on), (cfg.disc_layer, disc_on),
                (cfg.rigmask_layer, rigmask_on))
    for name, on in overlays:
        aux = image.layer_by_name(name)
        if aux is None or not on:
            continue
        # combo_get_active: offsets relative to the active layer, then
        # size_info_scale truncates everything by the factor
        x_off = int((aux.x_off - layer.x_off) / factor)
        y_off = int((aux.y_off - layer.y_off) / factor)
        tw = max(1, int(aux.width / factor))
        th = max(1, int(aux.height / factor))
        thumb = _thumbnail(aux, tw, th, keep_alpha=True)
        _composite_50(base, thumb, x_off, y_off)
    return base
