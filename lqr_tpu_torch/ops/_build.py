"""Build and load the port's CUDA kernels (``csrc/*.cu``) with nvcc.

The kernels have a plain ``extern "C"`` interface and are loaded with
ctypes, so the build needs no PyTorch headers (seconds, not minutes). The
library is compiled at first use into ``lqr_tpu_torch/build/`` and rebuilt
when a source or a header is newer than it; each source compiles in its own
nvcc process, all started together, and one more links them. Flags keep the
arithmetic IEEE: no ``--use_fast_math``, no ``-prec-sqrt=false``, and
``--fmad=false`` so no multiply-add is contracted into an FMA.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import pathlib
import shutil
import subprocess
import time

from .. import profiling

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SO = BUILD / "liblqr_kernels.so"
SOURCES = (CSRC / "dp_forward.cu", CSRC / "backtrack.cu",
           CSRC / "carve_resident.cu", CSRC / "dp_block.cu",
           CSRC / "carve_step.cu", CSRC / "dp_sharded.cu",
           CSRC / "dp_energy_forward.cu", CSRC / "mailbox.cu")
HEADERS = (CSRC / "seam_dp.cuh", CSRC / "energy.cuh",
           CSRC / "strip_dp.cuh", CSRC / "strip_sweep.inc",
           CSRC / "chase.cuh")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _stale(so: pathlib.Path) -> bool:
    if not so.exists():
        return True
    built = so.stat().st_mtime
    return any(src.stat().st_mtime > built for src in SOURCES + HEADERS)


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with nvcc's output if any
    fails."""
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmds[0][0]}): {e}") from e
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(so: pathlib.Path = SO, flags: tuple = ()) -> pathlib.Path:
    """Compile the kernels (with extra nvcc flags, e.g. a -D define of a
    tool's instrumented build) into the library `so` if it is missing or
    stale. Raises RuntimeError with nvcc's output when the build fails."""
    if not _stale(so):
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [so.with_name(f"{src.stem}.{tag}.o") for src in SOURCES]
    tmp = so.with_name(f"{so.name}.{tag}.tmp")
    try:
        _run([[_nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(SOURCES, objs)])
        _run([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
        os.replace(tmp, so)  # atomic: a concurrent loader never sees a part
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with argtypes set. The first
    call's seconds, the build's included, go to ``setup.kernels_s``."""
    global _lib
    if _lib is None:
        t0 = time.perf_counter()
        _lib = bind(ctypes.CDLL(str(build())))
        profiling.count("setup.kernels_s", time.perf_counter() - t0)
    return _lib


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """Inside the block every wrapper launches from `lib` (a bound build of
    the same sources, e.g. tools/resident_phases.py's instrumented one);
    the library load() gave before is restored after it."""
    global _lib
    saved, _lib = _lib, lib
    try:
        yield lib
    finally:
        _lib = saved


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argtypes and restypes of the kernels' entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lqr_dp_forward.restype = i
    lib.lqr_dp_forward.argtypes = [p, p, p] + [i] * 10 + [p] * 4
    lib.lqr_smem_optin.restype = i
    lib.lqr_smem_optin.argtypes = []
    lib.lqr_backtrack.restype = i
    lib.lqr_backtrack.argtypes = [p, p, i, i, i, p, p]
    lib.lqr_carve_resident_batched.restype = i
    lib.lqr_carve_resident_batched.argtypes = [p] * 10 + [i] * 14 + [p]
    lib.lqr_resident_clusters.restype = i
    lib.lqr_resident_clusters.argtypes = [i] * 10
    lib.lqr_dp_block.restype = i
    lib.lqr_dp_block.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p]
    lib.lqr_dp_sharded.restype = i
    lib.lqr_dp_sharded.argtypes = [p] * 3 + [i] * 10 + [p] * 4
    lib.lqr_dp_energy_forward.restype = i
    lib.lqr_dp_energy_forward.argtypes = [p] * 4 + [i] * 11 + [p] * 4
    lib.lqr_sqrt_rn_check.restype = i
    lib.lqr_sqrt_rn_check.argtypes = [p, p]
    lib.lqr_backtrack_compact.restype = i
    lib.lqr_backtrack_compact.argtypes = ([p] * 5 + [i] * 4 + [p] * 5
                                          + [ctypes.c_uint, p])
    u64, size = ctypes.c_uint64, ctypes.c_size_t
    for name, args in (("lqr_mb_alloc", [size, ctypes.POINTER(p)]),
                       ("lqr_mb_free", [p]), ("lqr_mb_handle", [p, p]),
                       ("lqr_mb_open", [p, ctypes.POINTER(p)]),
                       ("lqr_mb_close", [p]), ("lqr_mb_write", [p, u64, p]),
                       ("lqr_mb_wait", [p, u64, p]),
                       ("lqr_mb_put", [p, u64, p, p, size, p, u64, p])):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = args
    lib.lqr_cuda_error_string.restype = ctypes.c_char_p
    lib.lqr_cuda_error_string.argtypes = [i]
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib.lqr_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
