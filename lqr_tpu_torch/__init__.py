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
- ``lqr_tpu_torch.render``  — orchestration: output targets, scaleback,
  aux layers, seam-map output.
- ``lqr_tpu_torch.checkpoint`` — save/resume a carver (the JAX format).
- ``lqr_tpu_torch.gap``     — keyframe interpolation (GAP iterator).
- ``lqr_tpu_torch.cli``     — the batch command line (``lqr-tpu-torch``).
- ``lqr_tpu_torch.masks``, ``preview`` — mask authoring and the preview
  compositor.
- ``lqr_tpu_torch.interactive`` — the live interactive session.
- ``lqr_tpu_torch.dialog``  — the headless main dialog and ``run_plugin``.
- ``lqr_tpu_torch.profiling`` — traces, spans, the per-seam roofline.

It imports torch and numpy, never jax or lqr_tpu.
"""

from .config import (LqrConfig, SeamColors, EnergyFunc, ResizeOrder,
                     OutputTarget, ScalebackMode, MaskBehavior, AuxLayerType)
from .carver import Carver, VMap
from .checkpoint import save_carver, load_carver
from .parallel import BatchCarver
from .errors import LqrError, LqrConfigError, LqrImageError, LqrStateError
from .masks import colour_from_type, new_mask_layer, edit_mask
from .preview import preview

__version__ = "0.3.0"

__all__ = [
    "LqrConfig", "SeamColors", "EnergyFunc", "ResizeOrder", "OutputTarget",
    "ScalebackMode", "MaskBehavior", "AuxLayerType", "Carver", "VMap",
    "BatchCarver", "save_carver", "load_carver", "LqrError",
    "LqrConfigError", "LqrImageError", "LqrStateError", "colour_from_type",
    "new_mask_layer", "edit_mask", "preview", "__version__",
]
