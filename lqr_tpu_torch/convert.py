"""Carry carver state between the JAX package and the port.

The JAX package's ``EngineConfig`` and ``MapState``, pulled to plain Python
and numpy (``dataclasses.asdict(cfg)``; each state field through
``np.asarray``), map to the port's and back, so a map carved part-way by
one can be extended and materialized by the other; batched states
(``lqr_tpu.parallel.batch``) likewise. Nothing here imports jax: the
exchange format is numpy.
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


def _state_from_numpy(cfg_fields: dict, arrays: dict, device,
                      batched: bool) -> MapState:
    cfg, _ = config_from_jax_fields(cfg_fields)
    lead = 1 if batched else 0

    def plane(name):
        a = arrays.get(name)
        if a is None:
            return None
        a = np.asarray(a, _DTYPES.get(name, np.float32))
        if a.shape[lead:lead + 2] != (cfg.H, cfg.Wb):
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"(H, Wb) = ({cfg.H}, {cfg.Wb}) at axis {lead}")
        return _tensor(a, device)

    if batched:
        ref_w = np.array(arrays["ref_w"], np.int64).reshape(-1)
        depth = np.array(arrays["depth"], np.int64).reshape(-1)
    else:
        ref_w, depth = int(arrays["ref_w"]), int(arrays["depth"])
    st = MapState(
        ref=plane("ref"), bias=plane("bias"), rig=plane("rig"),
        vs=plane("vs"),
        aux=tuple(_tensor(np.asarray(a, np.uint8), device)
                  for a in arrays.get("aux", ())),
        cur_b=plane("cur_b"), cur_bias=plane("cur_bias"),
        cur_rig=plane("cur_rig"), ref_w=ref_w, depth=depth)
    for name, flag in (("bias", cfg.has_bias), ("cur_bias", cfg.has_bias),
                       ("rig", cfg.has_rig), ("cur_rig", cfg.has_rig)):
        if (getattr(st, name) is not None) != flag:
            raise ValueError(f"{name} presence does not match the config")
    if batched:
        B = st.vs.shape[0]
        if ref_w.shape != (B,) or depth.shape != (B,):
            raise ValueError(f"ref_w / depth: expected {B} entries each")
    return st


def state_from_numpy(cfg_fields: dict, arrays: dict, device) -> MapState:
    """The port's MapState from a JAX MapState pulled to numpy.

    arrays: {ref, bias, rig, vs, aux, cur_b, cur_bias, cur_rig, ref_w,
    depth}; bias/rig/cur_bias/cur_rig are None when the config has no
    bias/rigidity."""
    return _state_from_numpy(cfg_fields, arrays, device, batched=False)


def batch_state_from_numpy(cfg_fields: dict, arrays: dict, device):
    """A batched MapState (``lqr_tpu.parallel.batch``: a leading batch axis
    on every array, ref_w and depth [B]) pulled to numpy, as the port's
    batched state (``lqr_tpu_torch.parallel.batch``: ref_w and depth host
    int64 arrays). Returns (state, heights): heights [B] int64 is
    arrays["heights"], the images' true heights, which the JAX state does
    not hold (its BatchCarver does); without it every image has cfg.H
    rows."""
    st = _state_from_numpy(cfg_fields, arrays, device, batched=True)
    B, H = st.vs.shape[:2]
    heights = np.array(arrays.get("heights", np.full(B, H)),
                       np.int64).reshape(-1)
    if heights.shape != (B,) or not ((1 <= heights) & (heights <= H)).all():
        raise ValueError(f"heights: expected {B} entries in 1..{H}")
    return st, heights


def state_to_numpy(st: MapState) -> dict:
    """The port's MapState as numpy arrays, in the JAX MapState's fields
    (ref_w/depth as int32 scalars)."""
    out = {name: (None if getattr(st, name) is None
                  else getattr(st, name).cpu().numpy()) for name in _PLANES}
    out["aux"] = tuple(a.cpu().numpy() for a in st.aux)
    out["ref_w"] = np.int32(st.ref_w)
    out["depth"] = np.int32(st.depth)
    return out


def batch_state_to_numpy(st: MapState, heights=None) -> dict:
    """A batched state of the port as numpy arrays in the JAX MapState's
    fields (ref_w / depth as int32 [B]), with "heights" when given."""
    out = state_to_numpy(st._replace(ref_w=0, depth=0))
    out["ref_w"] = np.asarray(st.ref_w, np.int32)
    out["depth"] = np.asarray(st.depth, np.int32)
    if heights is not None:
        out["heights"] = np.asarray(heights, np.int32)
    return out
