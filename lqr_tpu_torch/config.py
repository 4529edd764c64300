"""Configuration records, enums and engine constants (SPEC.md §2, §5, §7).

A copy of ``lqr_tpu.config`` (importing it would import jax); names,
values and defaults are identical (tests/test_torch_host.py asserts it).

- ``LqrConfig``  <- gimp-lqr-plugin's ``PlugInVals`` (src/main_common.h:34-60,
  defaults src/main.c:62-87)
- ``SeamColors`` <- ``PlugInColVals`` (src/main.c:89-96)
- enums          <- src/main.h:97-115 and the liblqr enums of
  src/interface.c:2137-2147, 2213-2219.

Aux layers are referred to by layer ID *or* by name (src/main.c:556-576):
the ``*_layer`` fields take a name string ("" = unset) or an int layer ID
(< 0 = unset), resolved through ``Image.layer_ref``. The ``*_layer_name``
fields keep the name-based batch/GAP replay semantics.
"""

from __future__ import annotations

import dataclasses
import enum


def layer_ref_set(ref) -> bool:
    """True iff a ``*_layer`` reference is set: a non-empty name string or a
    non-negative int layer ID (GIMP's invalid-layer ID is -1)."""
    if ref is None or ref == "":
        return False
    if isinstance(ref, int) and not isinstance(ref, bool):
        return ref >= 0
    return True


class EnergyFunc(enum.IntEnum):
    """The 7 builtin energy functions (SPEC.md §2); default GRAD_XABS."""

    GRAD_XABS = 0
    GRAD_SUMABS = 1
    GRAD_NORM = 2
    LUMA_GRAD_XABS = 3
    LUMA_GRAD_SUMABS = 4
    LUMA_GRAD_NORM = 5
    NULL = 6


class ResizeOrder(enum.IntEnum):
    """Which axis a two-axis resize carves first."""

    HOR = 0   # width first, then height (default)
    VERT = 1  # height first, then width


class OutputTarget(enum.IntEnum):
    """OutputTarget (src/main.h:97-102)."""

    SAME_LAYER = 0
    NEW_LAYER = 1
    NEW_IMAGE = 2


class ScalebackMode(enum.IntEnum):
    """ScalebackMode (src/main.h:109-115)."""

    LQRBACK = 0  # flatten + liquid-rescale back to original size
    STD = 1      # standard uniform rescale back to original size
    STDW = 2     # uniform rescale reaching original width only
    STDH = 3     # uniform rescale reaching original height only


class MaskBehavior(enum.IntEnum):
    """What to do with a layer's transparency mask (GIMP_MASK_*)."""

    APPLY = 0
    DISCARD = 1


class AuxLayerType(enum.IntEnum):
    """AuxLayerType (src/main.h:35-40)."""

    PRES = 0
    DISC = 1
    RIGMASK = 2


@dataclasses.dataclass
class LqrConfig:
    """The complete 24-field parameter record (``PlugInVals``), field order
    and defaults as in src/main.c:62-87."""

    new_width: int = 100
    new_height: int = 100
    pres_layer: "str | int" = ""  # name or int layer ID; ""/-1 = unset
    pres_coeff: int = 1000
    disc_layer: "str | int" = ""
    disc_coeff: int = 1000
    rigidity: float = 0.0
    rigmask_layer: "str | int" = ""
    delta_x: int = 1
    enl_step: float = 1.5         # stored as percent/100; UI 100.1%-200%
    resize_aux_layers: bool = True
    resize_canvas: bool = True
    output_target: OutputTarget = OutputTarget.SAME_LAYER
    output_seams: bool = False
    nrg_func: EnergyFunc = EnergyFunc.GRAD_XABS
    res_order: ResizeOrder = ResizeOrder.HOR
    mask_behavior: MaskBehavior = MaskBehavior.APPLY
    scaleback: bool = False
    scaleback_mode: ScalebackMode = ScalebackMode.LQRBACK
    no_disc_on_enlarge: bool = True
    # name-based references for batch/GAP replay (src/main.c:508-517)
    pres_layer_name: str = ""
    disc_layer_name: str = ""
    rigmask_layer_name: str = ""
    selected_layer_name: str = ""

    def replace(self, **kw) -> "LqrConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SeamColors:
    """Seam-map gradient endpoints (``PlugInColVals``): start red (1,0,0),
    end dark red (0.2,0,0)."""

    r1: float = 1.0
    g1: float = 0.0
    b1: float = 0.0
    r2: float = 0.2
    g2: float = 0.0
    b2: float = 0.0


DEFAULT_SIDE_SWITCH_FREQUENCY = 2
MAX_DELTA_X = 10
MAX_RIGIDITY = 1000.0
MAX_COEFF = 3000
MIN_ENL_STEP = 1.001
MAX_ENL_STEP = 2.0
