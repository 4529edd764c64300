"""Carver state and static engine configuration (PyTorch port).

Counterpart of ``lqr_tpu.core.state``. The layouts are the JAX package's:
reference pixels u8 [H, Wb, C], planes f32 [H, Wb], visibility map i32
[H, Wb]; width is dynamic inside a fixed buffer ``Wb`` (a multiple of 128),
height ``H`` is fixed for the lifetime of a map.

Unlike the JAX state, ``ref_w`` and ``depth`` are host ints: the host
always knows them, so the seam loop never reads a scalar back from the
device. The device is the device of the tensors; there is no
``use_pallas`` switch: ``init_state`` puts the state on the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import EnergyFunc, DEFAULT_SIDE_SWITCH_FREQUENCY
from ..errors import LqrConfigError
from ..i18n import _


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine parameters of one map."""

    H: int                # image height (rows; seams are vertical)
    Wb: int               # column buffer capacity (>= ref_w, mult of 128)
    C: int                # channels of the main image (1, 2, 3, 4)
    delta_x: int = 1      # max transversal seam step
    nrg: int = int(EnergyFunc.GRAD_XABS)
    side_switch_freq: int = DEFAULT_SIDE_SWITCH_FREQUENCY
    aux_channels: tuple = ()   # channel counts of attached aux images
    has_bias: bool = False     # bias field in use
    has_rig: bool = False      # rigidity in use

    def __post_init__(self):
        assert 1 <= self.C <= 4
        assert 0 <= self.delta_x <= 10


class MapState(NamedTuple):
    """The visibility-map state (SPEC.md §6); field names as in lqr_tpu.

    Reference-coordinate fields (width ref_w inside buffer Wb):
      ref      u8  [H, Wb, C]  reference pixels
      bias     f32 [H, Wb]     additive energy bias, or None
      rig      f32 [H, Wb]     per-pixel rigidity, or None
      vs       i32 [H, Wb]     visibility map (0 = never carved, s = seam #)
      aux      tuple of u8 [H, Wb, C_i]

    Shrunk-most compacted fields (width ref_w - depth):
      cur_b    f32 [H, Wb]     reader plane (brightness or luma, SPEC.md §1)
      cur_bias f32 [H, Wb] or None
      cur_rig  f32 [H, Wb] or None

    Host ints: ref_w, depth. A batch of maps has a leading axis on every
    tensor and [B] int64 host arrays for ref_w and depth
    (``batch_of_one``, ``image_state``).
    """

    ref: torch.Tensor
    bias: torch.Tensor | None
    rig: torch.Tensor | None
    vs: torch.Tensor
    aux: tuple
    cur_b: torch.Tensor
    cur_bias: torch.Tensor | None
    cur_rig: torch.Tensor | None
    ref_w: int
    depth: int


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def lane_index(H: int, Wb: int, device) -> torch.Tensor:
    """[H, Wb] int32 column index grid on ``device`` (a broadcast view)."""
    return torch.arange(Wb, dtype=torch.int32, device=device).expand(H, Wb)


def batch_of_one(st: MapState) -> MapState:
    """A solo state as a batch of one: every tensor a view with a leading
    axis of 1, ref_w and depth [1] host arrays."""
    def one(a):
        return None if a is None else a[None]
    return MapState(ref=st.ref[None], bias=one(st.bias), rig=one(st.rig),
                    vs=st.vs[None], aux=tuple(a[None] for a in st.aux),
                    cur_b=st.cur_b[None], cur_bias=one(st.cur_bias),
                    cur_rig=one(st.cur_rig),
                    ref_w=np.array([st.ref_w], np.int64),
                    depth=np.array([st.depth], np.int64))


def image_state(st: MapState, i: int) -> MapState:
    """Map i of a batched state, as a solo state (views, host ints)."""
    def pick(a):
        return None if a is None else a[i]
    return MapState(ref=st.ref[i], bias=pick(st.bias), rig=pick(st.rig),
                    vs=st.vs[i], aux=tuple(a[i] for a in st.aux),
                    cur_b=st.cur_b[i], cur_bias=pick(st.cur_bias),
                    cur_rig=pick(st.cur_rig), ref_w=int(st.ref_w[i]),
                    depth=int(st.depth[i]))


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A small host array (per-map ints) as a tensor of its own on
    ``device``. To the card it goes from page-locked memory without
    waiting: a copy from pageable memory, the fallback where page-locked
    memory is refused, waits for the stream's queued work, and the carve's
    launches then stall on it."""
    if torch.device(device).type == "cuda":
        try:
            return torch.from_numpy(a).pin_memory().to(device,
                                                       non_blocking=True)
        except RuntimeError:
            pass
    return torch.tensor(a, device=device)


def per_map(x, device):
    """Per-map host ints x ([B]) as an operand that broadcasts against the
    maps' [B, ...] tensors: a [B, 1, 1] int64 tensor on ``device``, or for a
    batch of one the host int itself, which needs no copy."""
    x = np.asarray(x, np.int64).reshape(-1)
    if x.size == 1:
        return int(x[0])
    return to_device(x, device)[:, None, None]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device: "cuda" (raises LqrConfigError when CUDA
    is absent) or "cpu", which the caller must ask for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise LqrConfigError(
            _("device {d} requested but CUDA is not available; pass "
              "device=\"cpu\" for the CPU path").format(d=device))
    if dev.type not in ("cuda", "cpu"):
        raise LqrConfigError(
            _("unsupported device {d}; use \"cuda\" or \"cpu\"")
            .format(d=device))
    return dev


def init_state(cfg: EngineConfig, pixels, bias=None, rig=None, aux=(),
               device="cuda") -> MapState:
    """Build a fresh MapState from an [H, w, C] uint8 image (w <= Wb).

    Inputs are numpy arrays or tensors; bias/rig are f32 [H, w] fields,
    aux a tuple of [H, w, C_i] uint8 images. Everything lands on
    ``device``: the card by default (LqrConfigError without CUDA), the CPU
    when asked with ``device="cpu"``.
    """
    from .energy import reader_plane   # energy imports this module

    device = resolve_device(device)
    H, Wb = cfg.H, cfg.Wb
    pixels = torch.as_tensor(pixels, dtype=torch.uint8, device=device)
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    h, w = pixels.shape[:2]
    assert h == H and w <= Wb and pixels.shape[2] == cfg.C, (
        f"shape {tuple(pixels.shape)} vs cfg {cfg}")

    def pad_w(a):
        out = a.new_zeros((H, Wb) + tuple(a.shape[2:]))
        out[:, :a.shape[1]] = a
        return out

    pixels = pad_w(pixels)
    if cfg.has_bias:
        assert bias is not None, "cfg.has_bias set but no bias given"
        bias = pad_w(torch.as_tensor(bias, dtype=torch.float32,
                                     device=device))
    else:
        bias = None
    if cfg.has_rig:
        assert rig is not None, "cfg.has_rig set but no rig given"
        rig = pad_w(torch.as_tensor(rig, dtype=torch.float32, device=device))
    else:
        rig = None
    aux_p = tuple(pad_w(torch.as_tensor(a, dtype=torch.uint8, device=device)
                        .reshape(H, w, -1)) for a in aux)
    assert tuple(a.shape[2] for a in aux_p) == tuple(cfg.aux_channels)
    vs = torch.zeros((H, Wb), dtype=torch.int32, device=device)
    return MapState(
        ref=pixels, bias=bias, rig=rig, vs=vs, aux=aux_p,
        cur_b=reader_plane(pixels, cfg.nrg), cur_bias=bias, cur_rig=rig,
        ref_w=int(w), depth=0,
    )
