"""GAP animation iterator — keyframe interpolation of LqrConfig.

Re-implements ``plug-in-lqr-Iterator``
(gimp-lqr-plugin gap/plug_in_lqr_iter.c:51-112): for a frame sequence, every
*numeric* field of the config is linearly interpolated between a FROM and TO
keyframe, while every discrete/string field is copied from TO. The blend law
is the reference's ``p_delta_gint``/``p_delta_gfloat``:

    val = from + delta,  delta = ((to - from) / total_steps) * (total_steps - current_step)

(i.e. current_step == total_steps -> FROM; current_step == 0 -> TO), with
ROUND() = round-half-away-from-zero for integer fields.

A copy of ``lqr_tpu.gap``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import Iterator

from .config import LqrConfig

_INT_FIELDS = ("new_width", "new_height", "pres_coeff", "disc_coeff",
               "delta_x")
_FLOAT_FIELDS = ("rigidity", "enl_step")


def _round_half_away(x: float) -> int:
    """GIMP's ROUND(): (int)(x + 0.5) for x >= 0, symmetric for x < 0."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


def interpolate(cfg_from: LqrConfig, cfg_to: LqrConfig,
                total_steps: int, current_step: float) -> LqrConfig:
    """One interpolated config (the p_plug_in_lqr_iter law)."""
    if total_steps < 1:
        return cfg_to.replace()
    out = cfg_to.replace()   # discrete + string fields from TO (iter.c:89-112)
    for f in _INT_FIELDS:
        vf, vt = getattr(cfg_from, f), getattr(cfg_to, f)
        delta = ((vt - vf) / float(total_steps)) * (total_steps - current_step)
        setattr(out, f, _round_half_away(vf + delta))
    for f in _FLOAT_FIELDS:
        vf, vt = getattr(cfg_from, f), getattr(cfg_to, f)
        delta = ((vt - vf) / float(total_steps)) * (total_steps - current_step)
        setattr(out, f, vf + delta)
    return out


def schedule(cfg_from: LqrConfig, cfg_to: LqrConfig,
             n_frames: int) -> Iterator[LqrConfig]:
    """Per-frame configs for an n_frames sequence.

    GAP drives the iterator with total_steps = n_frames - 1 and
    current_step counting down from total_steps (first frame) to 0 (last
    frame), so frame 0 == FROM and frame n-1 == TO.
    """
    total = n_frames - 1
    if total < 1:
        yield cfg_to.replace()
        return
    for frame in range(n_frames):
        yield interpolate(cfg_from, cfg_to, total, float(total - frame))
