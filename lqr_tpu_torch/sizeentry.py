"""Size-entry / linked-coordinates model — the altsizeentry/altcoordinates
forks, headless.

The reference forks GIMP's size widgets (gimp-lqr-plugin src/
altsizeentry.c, 1299 LoC; gimp-lqr-plugin src/altcoordinates.c, 288 LoC)
to drive the dialog's width/height fields: a value+refval model with a
unit menu (pixels, percent, physical units via a resolution), and a chain
button that constrains either the aspect RATIO of the original size or
EQUALITY of the two fields. This module is the widget pair's data model
without GTK; the CLI and interactive session use it for percent sizes and
aspect-linked resizing.

Laws mirrored:
- unit conversion (altsizeentry.c:655-760): physical value =
  refval / resolution * unit_factor; percent value =
  refval / base * 100; pixel value = refval;
- chain propagation (alt_coordinates_callback,
  altcoordinates.c:44-110): with the chain active and
  chain_constrains_ratio, editing x sets y = x * orig_y / orig_x (and
  symmetrically), change detection by ROUND() against the last values;
  without ratio constraint the fields are kept equal.

A copy of ``lqr_tpu.sizeentry``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
import math

from .errors import LqrConfigError
from .i18n import _


class Unit(enum.Enum):
    """Unit menu entries; factors are per-inch (GIMP unit table)."""

    PIXEL = "px"
    PERCENT = "%"
    INCH = "in"
    MM = "mm"
    POINT = "pt"


_FACTOR = {Unit.INCH: 1.0, Unit.MM: 25.4, Unit.POINT: 72.0}


def _round(x: float) -> int:
    """GIMP's ROUND(): half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


class SizeEntry:
    """One field of the alt_size_entry model: a pixel refval with a
    unit-converted display value and clamped bounds."""

    def __init__(self, refval: float, *, lower: float = 1.0,
                 upper: float = 65536.0, base: float | None = None,
                 resolution: float = 72.0, unit: Unit = Unit.PIXEL):
        self.lower, self.upper = float(lower), float(upper)
        self.base = float(base if base is not None else refval)
        self.resolution = float(resolution)
        self.unit = Unit(unit)
        self._refval = self._clamp(float(refval))

    def _clamp(self, v: float) -> float:
        return min(max(v, self.lower), self.upper)

    @property
    def refval(self) -> float:
        """The pixel-space value (alt_size_entry_get_refval)."""
        return self._refval

    def set_refval(self, v: float):
        self._refval = self._clamp(float(v))

    @property
    def value(self) -> float:
        """The display value in the current unit."""
        if self.unit == Unit.PIXEL:
            return self._refval
        if self.unit == Unit.PERCENT:
            return self._refval / self.base * 100.0
        return self._refval / self.resolution * _FACTOR[self.unit]

    def set_value(self, v: float):
        """Set via the current unit (alt_size_entry_set_value law)."""
        if self.unit == Unit.PIXEL:
            self.set_refval(v)
        elif self.unit == Unit.PERCENT:
            self.set_refval(v * self.base / 100.0)
        else:
            self.set_refval(v * self.resolution / _FACTOR[self.unit])

    def set_unit(self, unit: Unit):
        self.unit = Unit(unit)


class Coordinates:
    """The alt_coordinates pair: two SizeEntry fields + chain button."""

    def __init__(self, width: float, height: float, *,
                 chain_active: bool = False,
                 chain_constrains_ratio: bool = True,
                 resolution: float = 72.0):
        self.x = SizeEntry(width, base=width, resolution=resolution)
        self.y = SizeEntry(height, base=height, resolution=resolution)
        self.chain_active = bool(chain_active)
        self.chain_constrains_ratio = bool(chain_constrains_ratio)
        self._orig_x, self._orig_y = float(width), float(height)
        self._last_x, self._last_y = float(width), float(height)

    @property
    def width(self) -> int:
        return _round(self.x.refval)

    @property
    def height(self) -> int:
        return _round(self.y.refval)

    def _propagate(self):
        """alt_coordinates_callback (altcoordinates.c:44-110)."""
        new_x, new_y = self.x.refval, self.y.refval
        if self.chain_active:
            if self.chain_constrains_ratio:
                if self._orig_x != 0 and self._orig_y != 0:
                    if _round(new_x) != _round(self._last_x):
                        self._last_x = new_x
                        self.y.set_refval(new_x * self._orig_y
                                          / self._orig_x)
                        self._last_y = self.y.refval
                    elif _round(new_y) != _round(self._last_y):
                        self._last_y = new_y
                        self.x.set_refval(new_y * self._orig_x
                                          / self._orig_y)
                        self._last_x = self.x.refval
            else:
                if new_x != self._last_x:
                    self.y.set_refval(new_x)
                    self._last_y = self._last_x = self.y.refval
                elif new_y != self._last_y:
                    self.x.set_refval(new_y)
                    self._last_x = self._last_y = self.x.refval
        else:
            self._last_x, self._last_y = new_x, new_y

    def set_width(self, v: float, unit: Unit | None = None):
        if unit is not None:
            self.x.set_unit(unit)
        self.x.set_value(v)
        self._propagate()

    def set_height(self, v: float, unit: Unit | None = None):
        if unit is not None:
            self.y.set_unit(unit)
        self.y.set_value(v)
        self._propagate()

    def reset(self):
        """The size-section reset button: back to the original size."""
        self.x.set_refval(self._orig_x)
        self.y.set_refval(self._orig_y)
        self._last_x, self._last_y = self.x.refval, self.y.refval


def parse_size(spec: str, base: float) -> int:
    """Parse a CLI size token: plain pixels ('400') or percent ('75%'),
    the percent-unit path of the size entry."""
    spec = spec.strip()
    try:
        if spec.endswith("%"):
            e = SizeEntry(base, base=base, unit=Unit.PERCENT)
            e.set_value(float(spec[:-1]))
            return _round(e.refval)
        return int(spec)
    except ValueError:
        raise LqrConfigError(
            _("size {spec!r} is neither an integer nor a percentage "
              "like '75%'").format(spec=spec)) from None
