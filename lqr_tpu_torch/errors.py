"""Typed user-facing errors; same classes and messages as ``lqr_tpu.errors``."""

from __future__ import annotations

from .i18n import _


class LqrError(Exception):
    """Base class for all user-facing framework errors."""


class LqrConfigError(LqrError):
    """Invalid parameter value."""


class LqrImageError(LqrError):
    """Invalid image data, such as a bad channel count."""


class LqrStateError(LqrError):
    """API misuse or a broken internal invariant."""


def check_channels(c: int, what: str = "image") -> None:
    """1..4 channels (GRAY, GRAYA, RGB, RGBA)."""
    if not 1 <= c <= 4:
        raise LqrImageError(
            _("{what} has {c} channels; only 1-4 (GRAY, GRAYA, RGB, RGBA) "
              "are supported").format(what=what, c=c))


def check_target_size(w: int, h: int) -> None:
    """Resize targets must be positive."""
    if w < 1 or h < 1:
        raise LqrConfigError(
            _("target size {w}x{h} is invalid; both sides must be >= 1")
            .format(w=w, h=h))
