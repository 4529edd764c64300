"""ctypes bridge to the native C++ image codec (native/imagecodec.cpp):
PNG (8-bit gray, gray+alpha, RGB, RGBA, non-interlaced) and binary PNM
encode and decode, and the host's buffer marshalling: planar
``deinterleave``/``interleave`` and ``stage_wave`` (a batch of rolled
copies of one image written straight into the padded batch buffer, the
staging of bench_all's cfg4 and cfg5). The library's ``lqr_place_mask``
is bound by ``lqr_tpu.utils.codec`` alone: the port places masks on the
device (``ops.place_mask``).

The codec of ``lqr_tpu.utils.codec``, built at first use with the same
flags into the port's own ``lqr_tpu_torch/build/`` (a per-process
temporary file renamed into place, so that concurrent first uses never
load a half-written library). Every failure, the build's included, raises
``NativeCodecError``, an ``LqrImageError``: nothing falls back to another
decoder or to NumPy.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import time

import numpy as np

from .. import profiling
from ..errors import LqrImageError
from ..i18n import _

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "native" / "imagecodec.cpp"
_SO = _PKG / "build" / "libimagecodec.so"

_lib = None


class NativeCodecError(LqrImageError):
    """Unsupported or corrupt input for the native codec, or a failed
    build of it."""


def _load():
    """The codec's library, built by g++ if missing or stale; the
    first call's seconds, a build included, go to ``setup.native_s``."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-pthread", "-o", str(tmp),
             str(_SRC), "-lz"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeCodecError(
                _("g++ failed building the native image codec ({src}):\n"
                  "{err}").format(src=_SRC.name, err=proc.stderr))
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(str(_SO))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lp = ctypes.POINTER(ctypes.c_long)
    i = ctypes.c_int
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
    for name in ("lqr_deinterleave", "lqr_interleave"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [u8p, i, i, i, u8p]
    lib.lqr_stage_wave.restype = None
    lib.lqr_stage_wave.argtypes = [u8p, i, i, i, ip, ip, i, u8p, i, i]
    _lib = lib
    profiling.count("setup.native_s", time.perf_counter() - t0)
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
                raise NativeCodecError(
                    _("corrupt {kind} data (decoder code {rc})")
                    .format(kind=kind, rc=rc))
            return out
        if rc == 2:
            raise NativeCodecError(
                _("unsupported {kind} variant: the codec reads 8-bit gray, "
                  "gray+alpha, RGB and RGBA, non-interlaced")
                .format(kind=kind))
        if rc != 1:
            raise NativeCodecError(
                _("corrupt {kind} header (decoder code {rc})")
                .format(kind=kind, rc=rc))
    raise NativeCodecError(_("not a PNG or binary PNM file"))


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
        raise NativeCodecError(
            _("cannot encode a {h}x{w} image of {c} channels as {fmt} "
              "(encoder code {rc})").format(h=h, w=w, c=c, fmt=fmt.upper(),
                                            rc=rc))
    return out[:n.value].tobytes()


def _image3(img: np.ndarray, what: str) -> np.ndarray:
    """img as a C-contiguous uint8 [h, w, c] array of 1-4 channels."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or not 1 <= img.shape[2] <= 4:
        raise NativeCodecError(
            _("{what} has shape {shape}; expected [h, w] or [h, w, c] with "
              "1-4 channels").format(what=what, shape=img.shape))
    return img


def _check_out(out: np.ndarray, shape: tuple, dtype) -> None:
    if (out.shape != shape or out.dtype != dtype
            or not out.flags.c_contiguous):
        raise NativeCodecError(
            _("output buffer is {shape} {dtype}; expected a C-contiguous "
              "{want} {wdtype}").format(shape=out.shape, dtype=out.dtype,
                                        want=shape,
                                        wdtype=np.dtype(dtype)))


def deinterleave(img: np.ndarray) -> np.ndarray:
    """uint8 [h, w, c] -> [c, h, w] (planar layout)."""
    lib = _load()
    img = _image3(img, "image")
    h, w, c = img.shape
    out = np.empty((c, h, w), np.uint8)
    lib.lqr_deinterleave(_u8p(img), h, w, c, _u8p(out))
    return out


def interleave(planes: np.ndarray) -> np.ndarray:
    """uint8 [c, h, w] -> [h, w, c]."""
    lib = _load()
    planes = np.ascontiguousarray(planes, np.uint8)
    if planes.ndim != 3:
        raise NativeCodecError(
            _("planes have shape {shape}; expected [c, h, w]")
            .format(shape=planes.shape))
    c, h, w = planes.shape
    out = np.empty((h, w, c), np.uint8)
    lib.lqr_interleave(_u8p(planes), h, w, c, _u8p(out))
    return out


def stage_wave(base: np.ndarray, dys, dxs, out_h: int, out_w: int,
               out: np.ndarray | None = None) -> np.ndarray:
    """A wave of cyclically rolled copies of ``base`` ([h, w(, c)] u8),
    written straight into a zero-padded [n, out_h, out_w, c] u8 batch:
    out[i, y, x] = base[(y - dys[i]) % h, (x - dxs[i]) % w] for y < h and
    x < w, zeros elsewhere (one host touch per byte, two C++ threads)."""
    lib = _load()
    base = _image3(base, "base image")
    h, w, c = base.shape
    dys = np.ascontiguousarray(dys, np.int32)
    dxs = np.ascontiguousarray(dxs, np.int32)
    n = dys.size
    if (dys.shape != (n,) or dxs.shape != (n,) or min(h, w) < 1
            or out_h < h or out_w < w):
        raise NativeCodecError(
            _("stage_wave: {n} row shifts and {m} column shifts of a "
              "{h}x{w} image into {oh}x{ow}; expected as many of each, a "
              "non-empty image and a buffer at least its size")
            .format(n=dys.size, m=dxs.size, h=h, w=w, oh=out_h, ow=out_w))
    if out is None:
        out = np.empty((n, out_h, out_w, c), np.uint8)
    else:
        _check_out(out, (n, out_h, out_w, c), np.uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.lqr_stage_wave(_u8p(base), h, w, c, dys.ctypes.data_as(ip),
                       dxs.ctypes.data_as(ip), n, _u8p(out), out_h, out_w)
    return out
