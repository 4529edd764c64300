"""Mask-authoring workflow — the mask-editor round trip, headless.

Replaces the New-mask / Edit-mask workflow of the reference
(gimp-lqr-plugin src/layers_combo.c:174-215 ``callback_new_mask_button``,
gimp-lqr-plugin src/interface_aux.c:59-220 ``dialog_aux`` +
``colour_from_type``, cancel path gimp-lqr-plugin src/main.c:600-613):
batch users author typed mask layers programmatically instead of painting
in GIMP.

The laws mirrored exactly:

- a new mask layer is image-typed WITH alpha (RGBA for RGB images, GRAYA
  for grayscale), sized and positioned like the active layer, filled
  transparent, 50% opacity, normal mode, inserted on top
  (layers_combo.c:186-203);
- the paint color is fixed by mask type: green for preservation, red for
  discard, blue for rigidity masks; mid-gray (1/3, 1/3, 1/3) for
  grayscale images (colour_from_type interface_aux.c:193-220, defaults
  gimp-lqr-plugin src/main.c:130-156);
- the edit session makes the mask the active layer at 50% opacity and
  restores the previous state afterwards; cancelling removes a layer the
  session created (main.c:600-613).

A copy of ``lqr_tpu.masks`` over the port's image model, in NumPy: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .config import AuxLayerType
from .errors import LqrStateError
from .i18n import _, N_
from .image_model import Image, Layer

# default_pres_col / default_disc_col / default_rigmask_col /
# default_gray_col (gimp-lqr-plugin src/main.c:130-156)
PRES_COLOR = (0.0, 1.0, 0.0)
DISC_COLOR = (1.0, 0.0, 0.0)
RIGMASK_COLOR = (0.0, 0.0, 1.0)
GRAY_COLOR = (0.333333, 0.333333, 0.333333)

_TYPE_NAMES = {AuxLayerType.PRES: N_("preservation mask"),
               AuxLayerType.DISC: N_("discard mask"),
               AuxLayerType.RIGMASK: N_("rigidity mask")}


def colour_from_type(image: Image, layer_type: AuxLayerType):
    """Paint color for a mask type (interface_aux.c:193-220): keyed on the
    image's base type (grayscale images always paint mid-gray)."""
    base_c = image.active_layer.bpp
    if base_c <= 2:                     # GIMP_GRAY base type
        return GRAY_COLOR
    return {AuxLayerType.PRES: PRES_COLOR,
            AuxLayerType.DISC: DISC_COLOR,
            AuxLayerType.RIGMASK: RIGMASK_COLOR}[AuxLayerType(layer_type)]


def new_mask_layer(image: Image, layer_type: AuxLayerType,
                   name: str | None = None) -> Layer:
    """Create a fresh typed mask layer (callback_new_mask_button,
    layers_combo.c:186-203): transparent, image-typed + alpha, active
    layer's size and offsets, 50% opacity, inserted on top."""
    layer_type = AuxLayerType(layer_type)
    active = image.active_layer
    c = 4 if active.bpp >= 3 else 2     # RGBA / GRAYA
    pixels = np.zeros((active.height, active.width, c), np.uint8)
    mask = Layer(name=name or f"{_(_TYPE_NAMES[layer_type])} layer",
                 pixels=pixels, x_off=active.x_off, y_off=active.y_off,
                 opacity=50.0)
    image.add_layer(mask, 0)
    return mask


class MaskEditSession:
    """Headless ``dialog_aux``: activate the mask at 50% opacity, expose
    the type's paint color, paint, then OK (keep) or cancel (remove a
    newly created layer and restore everything).

    Usable as a context manager — exiting normally is OK, exiting via an
    exception cancels::

        with edit_mask(img, AuxLayerType.DISC) as s:
            s.paint(region)      # paints the discard color
    """

    def __init__(self, image: Image, layer_type: AuxLayerType,
                 layer: Layer | None = None, name: str | None = None):
        self.image = image
        self.layer_type = AuxLayerType(layer_type)
        self.is_new = layer is None
        self.color = colour_from_type(image, layer_type)
        self._saved_active = image.active
        self._saved_opacity = None
        self._done = False
        if layer is None:
            layer = new_mask_layer(image, layer_type, name=name)
        self.layer = layer
        # dialog_aux entry (interface_aux.c:92-95): activate at 50%
        self._saved_opacity = layer.opacity
        image.active = layer.name
        layer.opacity = 50.0

    def paint(self, region: np.ndarray, strength: float = 1.0):
        """Paint the type's color into the mask with the FG brush analog.

        region: [h, w] bool/float coverage on the layer's own coordinates;
        painted pixels get the type color at alpha = 255 * strength *
        coverage (a full-opacity brush stroke).
        """
        if self._done:
            raise LqrStateError(_("mask edit session already closed"))
        cov = np.clip(np.asarray(region, np.float32), 0.0, 1.0) * strength
        if cov.shape != self.layer.pixels.shape[:2]:
            raise LqrStateError(
                _("paint region {got} does not match mask layer {want}")
                .format(got=cov.shape, want=self.layer.pixels.shape[:2]))
        p = self.layer.pixels
        c = p.shape[2]
        vals = [self.color[0]] if c <= 2 else list(self.color)
        hit = cov > 0
        for k in range(c - 1):
            chan = np.uint8(round(255.0 * vals[k]))
            p[:, :, k] = np.where(hit, chan, p[:, :, k])
        a = np.round(255.0 * cov).astype(np.uint8)
        p[:, :, -1] = np.where(hit, np.maximum(p[:, :, -1], a), p[:, :, -1])

    def ok(self):
        """Keep the mask (the dialog's OK button)."""
        self._restore()

    def cancel(self):
        """Abort: a newly created layer is removed
        (cancel_work_on_aux_layer, main.c:600-613)."""
        if self.is_new:
            self.image.remove_layer(self.layer.name)
        self._restore()

    def _restore(self):
        if self._done:
            return
        self._done = True
        self.image.active = self._saved_active
        if self.image.layer_by_name(self.layer.name) is not None:
            self.layer.opacity = self._saved_opacity

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.ok()
        else:
            self.cancel()
        return False


def edit_mask(image: Image, layer_type: AuxLayerType,
              layer: Layer | None = None,
              name: str | None = None) -> MaskEditSession:
    """Open a mask-editor session (RESPONSE_WORK_ON_AUX_LAYER round trip,
    call stack SURVEY.md §3.3). layer=None creates a new mask layer."""
    return MaskEditSession(image, layer_type, layer=layer, name=name)
