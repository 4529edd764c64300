"""Carry carver state between the JAX package and the port.

The JAX package's ``EngineConfig`` and ``MapState``, pulled to plain Python
and numpy (``dataclasses.asdict(cfg)``; each state field through
``np.asarray``), map to the port's and back, so a map carved part-way by
one can be extended and materialized by the other. Nothing here imports
jax: the exchange format is numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.state import EngineConfig, MapState

_PLANES = ("ref", "bias", "rig", "vs", "cur_b", "cur_bias", "cur_rig")
_DTYPES = {"ref": np.uint8, "vs": np.int32}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A tensor that owns a copy of a (arrays pulled from jax are
    read-only views)."""
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


def config_from_jax_fields(fields: dict) -> tuple[EngineConfig, str]:
    """(EngineConfig, device) from the JAX config's fields. ``use_pallas``
    (the JAX package's accelerator-kernel switch) maps to the device:
    True -> "cuda", False -> "cpu"."""
    f = dict(fields)
    device = "cuda" if f.pop("use_pallas", False) else "cpu"
    f["aux_channels"] = tuple(f.get("aux_channels", ()))
    return EngineConfig(**f), device


def state_from_numpy(cfg_fields: dict, arrays: dict, device) -> MapState:
    """The port's MapState from a JAX MapState pulled to numpy.

    arrays: {ref, bias, rig, vs, aux, cur_b, cur_bias, cur_rig, ref_w,
    depth}; bias/rig/cur_bias/cur_rig are None when the config has no
    bias/rigidity."""
    cfg, _ = config_from_jax_fields(cfg_fields)

    def plane(name):
        a = arrays.get(name)
        if a is None:
            return None
        a = np.asarray(a, _DTYPES.get(name, np.float32))
        if a.shape[:2] != (cfg.H, cfg.Wb):
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"({cfg.H}, {cfg.Wb}, ...)")
        return _tensor(a, device)

    st = MapState(
        ref=plane("ref"), bias=plane("bias"), rig=plane("rig"),
        vs=plane("vs"),
        aux=tuple(_tensor(np.asarray(a, np.uint8), device)
                  for a in arrays.get("aux", ())),
        cur_b=plane("cur_b"), cur_bias=plane("cur_bias"),
        cur_rig=plane("cur_rig"),
        ref_w=int(arrays["ref_w"]), depth=int(arrays["depth"]))
    for name, flag in (("bias", cfg.has_bias), ("cur_bias", cfg.has_bias),
                       ("rig", cfg.has_rig), ("cur_rig", cfg.has_rig)):
        if (getattr(st, name) is not None) != flag:
            raise ValueError(f"{name} presence does not match the config")
    return st


def state_to_numpy(st: MapState) -> dict:
    """The port's MapState as numpy arrays, in the JAX MapState's fields
    (ref_w/depth as int32 scalars)."""
    out = {name: (None if getattr(st, name) is None
                  else getattr(st, name).cpu().numpy()) for name in _PLANES}
    out["aux"] = tuple(a.cpu().numpy() for a in st.aux)
    out["ref_w"] = np.int32(st.ref_w)
    out["depth"] = np.int32(st.depth)
    return out
