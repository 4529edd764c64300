"""ctypes bridge to the native C++ image codec (native/imagecodec.cpp):
PNG (8-bit gray, gray+alpha, RGB, RGBA, non-interlaced) and binary PNM
encode and decode.

The codec of ``lqr_tpu.utils.codec``, built at first use with the same
flags into the port's own ``lqr_tpu_torch/build/`` (a per-process
temporary file renamed into place, so that concurrent first uses never
load a half-written library). Every failure, the build's included, raises
``LqrImageError``: nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

from ..errors import LqrImageError
from ..i18n import _

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "native" / "imagecodec.cpp"
_SO = _PKG / "build" / "libimagecodec.so"

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-pthread", "-o", str(tmp),
             str(_SRC), "-lz"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise LqrImageError(
                _("g++ failed building the native image codec ({src}):\n"
                  "{err}").format(src=_SRC.name, err=proc.stderr))
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(str(_SO))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lp = ctypes.POINTER(ctypes.c_long)
    for name in ("lqr_png_info", "lqr_pnm_info"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [u8p, ctypes.c_long, ip, ip, ip]
    for name in ("lqr_png_decode", "lqr_pnm_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [u8p, ctypes.c_long, u8p]
    for name in ("lqr_png_encode", "lqr_pnm_encode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       u8p, ctypes.c_long, lp]
    _lib = lib
    return lib


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode(data: bytes) -> np.ndarray:
    """Decode PNG or binary PNM bytes -> uint8 [h, w, c]."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    for kind, info, dec in (("PNG", lib.lqr_png_info, lib.lqr_png_decode),
                            ("PNM", lib.lqr_pnm_info, lib.lqr_pnm_decode)):
        rc = info(_u8p(buf), len(data), ctypes.byref(h), ctypes.byref(w),
                  ctypes.byref(c))
        if rc == 0:
            out = np.empty((h.value, w.value, c.value), np.uint8)
            rc = dec(_u8p(buf), len(data), _u8p(out))
            if rc != 0:
                raise LqrImageError(
                    _("corrupt {kind} data (decoder code {rc})")
                    .format(kind=kind, rc=rc))
            return out
        if rc == 2:
            raise LqrImageError(
                _("unsupported {kind} variant: the codec reads 8-bit gray, "
                  "gray+alpha, RGB and RGBA, non-interlaced")
                .format(kind=kind))
        if rc != 1:
            raise LqrImageError(
                _("corrupt {kind} header (decoder code {rc})")
                .format(kind=kind, rc=rc))
    raise LqrImageError(_("not a PNG or binary PNM file"))


def encode(img: np.ndarray, fmt: str = "png") -> bytes:
    """Encode uint8 [h, w(,c)] -> PNG ("png") or binary PNM ("pnm", 1 or 3
    channels) bytes."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    cap = h * w * c + (1 << 16) + (h * w * c) // 2
    out = np.empty(cap, np.uint8)
    n = ctypes.c_long()
    fn = lib.lqr_png_encode if fmt == "png" else lib.lqr_pnm_encode
    rc = fn(_u8p(img), h, w, c, _u8p(out), cap, ctypes.byref(n))
    if rc != 0:
        raise LqrImageError(
            _("cannot encode a {h}x{w} image of {c} channels as {fmt} "
              "(encoder code {rc})").format(h=h, w=w, c=c, fmt=fmt.upper(),
                                            rc=rc))
    return out[:n.value].tobytes()
