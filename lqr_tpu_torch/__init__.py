"""lqr_tpu_torch — the seam carver on PyTorch, with hand-written CUDA
kernels (NVIDIA Hopper, sm_90a).

A port of ``lqr_tpu`` (JAX + Pallas), which stays the reference. Module
names mirror it:

- ``lqr_tpu_torch.core``    — engine state, energy, plain DP, engine.
- ``lqr_tpu_torch.ops``     — the CUDA kernels' wrappers and their build.
- ``lqr_tpu_torch.carver``  — the ``Carver`` host API.
- ``lqr_tpu_torch.parallel`` — ``BatchCarver`` and the sharded resize.
- ``lqr_tpu_torch.native``  — the C++ reference carver (ctypes).
- ``lqr_tpu_torch.convert`` — state exchange with the JAX package.

It imports torch and numpy, never jax or lqr_tpu.
"""

from .config import EnergyFunc, ResizeOrder
from .carver import Carver, VMap
from .parallel import BatchCarver
from .errors import LqrError, LqrConfigError, LqrImageError, LqrStateError

__all__ = ["Carver", "VMap", "BatchCarver", "EnergyFunc", "ResizeOrder",
           "LqrError", "LqrConfigError", "LqrImageError", "LqrStateError"]
