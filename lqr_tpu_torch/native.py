"""ctypes bridge to the single-core C++ reference carver (native/lqr_ref.cpp).

The same library and build flags as ``lqr_tpu.native`` (g++ -O2, no FMA,
no fast-math: the bit-exactness contract of SPEC.md), built at first use
into the port's own ``lqr_tpu_torch/build/`` so that it needs no jax and
never races the JAX package's build. Exposes:

- carve(img, n)           -> visibility map (int32 [H, W])
- materialize(img, vs, w) -> uint8 [H, w, C]
- bench(img, n)           -> seconds for n seams on one core (the CPU
                             baseline of every ``vs_baseline``)
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import time

import numpy as np

from . import profiling

_PKG = pathlib.Path(__file__).resolve().parent
_SRC = _PKG.parent / "native" / "lqr_ref.cpp"
_SO = _PKG / "build" / "liblqr_ref.so"

_lib = None


def _load():
    """The reference carver's library, built by g++ if missing or stale;
    the first call's seconds, a build included, go to
    ``setup.native_s``."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            from .errors import LqrError
            from .i18n import _
            raise LqrError(
                _("g++ failed building the native reference carver "
                  "({src}):\n{err}").format(src=_SRC.name,
                                            err=proc.stderr))
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(str(_SO))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    i = ctypes.c_int
    lib.lqr_ref_carve.restype = i
    lib.lqr_ref_carve.argtypes = [u8p, i, i, i, f32p, f32p, i, i, i, i, i32p]
    lib.lqr_ref_materialize.restype = i
    lib.lqr_ref_materialize.argtypes = [u8p, i32p, i, i, i, i, u8p]
    lib.lqr_ref_bench.restype = ctypes.c_double
    lib.lqr_ref_bench.argtypes = [u8p, i, i, i, i, i, i, i]
    _lib = lib
    profiling.count("setup.native_s", time.perf_counter() - t0)
    return lib


def _img3(img):
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def carve(img, n_seams: int, *, bias=None, rig=None, delta_x: int = 1,
          nrg: int = 0, ssf: int = 2) -> np.ndarray:
    """Visibility map [H, W] int32 of n_seams vertical seams."""
    lib = _load()
    img = _img3(img)
    h, w, c = img.shape
    if not 0 <= n_seams < w:
        raise ValueError(f"n_seams={n_seams} must be in [0, {w})")
    vs = np.zeros((h, w), np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    bp = rp = None
    if bias is not None:
        bias = np.ascontiguousarray(bias, np.float32)
        bp = bias.ctypes.data_as(f32p)
    if rig is not None:
        rig = np.ascontiguousarray(rig, np.float32)
        rp = rig.ctypes.data_as(f32p)
    rc = lib.lqr_ref_carve(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        bp, rp, delta_x, nrg, ssf, n_seams,
        vs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        raise RuntimeError(f"lqr_ref_carve failed ({rc})")
    return vs


def materialize(img, vs, w: int) -> np.ndarray:
    """The image at width w (SPEC.md §6) from (img, vs): uint8 [H, w, C]."""
    lib = _load()
    img = _img3(img)
    h, w0, c = img.shape
    vs = np.ascontiguousarray(vs, np.int32)
    if vs.shape != (h, w0):
        raise ValueError(f"vs shape {vs.shape} != {(h, w0)}")
    out = np.zeros((h, w, c), np.uint8)
    rc = lib.lqr_ref_materialize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        vs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), h, w0, c, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"lqr_ref_materialize failed ({rc})")
    return out


def bench(img, n_seams: int, *, delta_x: int = 1, nrg: int = 0,
          ssf: int = 2) -> float:
    """Seconds that the reference takes for n_seams seams on one core (the
    liblqr-role baseline of bench.py's and bench_all.py's vs_baseline)."""
    lib = _load()
    img = _img3(img)
    h, w, c = img.shape
    if not 0 <= n_seams < w:
        raise ValueError(f"n_seams={n_seams} must be in [0, {w})")
    return float(lib.lqr_ref_bench(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        delta_x, nrg, ssf, n_seams))
