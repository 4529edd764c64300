"""Host-side image file I/O (the GIMP file-plumbing stand-in).

PNG and binary PNM (``.png``, ``.ppm``, ``.pgm``, ``.pnm``) go through the
native C++ codec (``utils.codec``) and nothing else: a file the codec
cannot read or write raises ``LqrImageError``. Other formats (JPEG, TIFF,
...) go through Pillow, imported only for them; without Pillow they raise
``LqrImageError`` too.
"""

from __future__ import annotations

import numpy as np

from ..errors import LqrImageError
from ..i18n import _
from . import codec

_CODEC_EXT = (".png", ".ppm", ".pgm", ".pnm")


def _pil(path: str):
    try:
        from PIL import Image as P
    except ImportError:
        raise LqrImageError(
            _("{path}: only PNG and binary PNM are built in; other formats "
              "need Pillow, which is not installed").format(path=path)) \
            from None
    return P


def load_image(path: str) -> np.ndarray:
    """Load an image file -> uint8 [h, w, c]."""
    if path.lower().endswith(_CODEC_EXT):
        with open(path, "rb") as f:
            data = f.read()
        try:
            return codec.decode(data)
        except LqrImageError as e:
            raise LqrImageError(f"{path}: {e}") from None
    P = _pil(path)
    img = P.open(path)
    if img.mode == "P":
        img = img.convert("RGBA" if "transparency" in img.info else "RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return np.ascontiguousarray(arr, np.uint8)


def save_image(path: str, arr: np.ndarray):
    """Write uint8 [h, w(,c)] to ``path``, the format by its extension."""
    arr = np.asarray(arr, np.uint8)
    low = path.lower()
    if low.endswith(_CODEC_EXT):
        try:
            data = codec.encode(arr, "png" if low.endswith(".png") else "pnm")
        except LqrImageError as e:
            raise LqrImageError(f"{path}: {e}") from None
        with open(path, "wb") as f:
            f.write(data)
        return
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    mode = None
    if arr.ndim == 3:
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[arr.shape[2]]
    _pil(path).fromarray(arr, mode=mode).save(path)
