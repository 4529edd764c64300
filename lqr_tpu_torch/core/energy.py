"""Energy functions (SPEC.md §1-§2) as plain PyTorch element-wise ops.

Counterpart of ``lqr_tpu.core.energy``, bit-identical to it: every op is
an f32 op in the JAX package's order, constants are f32 0-d tensors of the
same host-rounded values (``x * f32(1/255)``, never ``x / 255``), and no
fused multiply-add form (``addcmul``, ``alpha=``) is used, so neither the
luma sum nor ``gx*gx + gy*gy`` can be contracted.

The engine precomputes the reader plane once (``reader_plane``) and
carves it along with the image; per seam only ``energy_from_plane`` runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EnergyFunc

LUMA_W = (0.2126, 0.7152, 0.0722)

_LUMA_FAMILY = (EnergyFunc.LUMA_GRAD_XABS, EnergyFunc.LUMA_GRAD_SUMABS,
                EnergyFunc.LUMA_GRAD_NORM)


def _f32(v: float) -> torch.Tensor:
    """v rounded once from f64 to an f32 0-d tensor. It stays on the host:
    a host 0-d operand reaches a CUDA kernel as an argument, with no copy
    and no stream synchronization."""
    return torch.tensor(np.float32(v))


def reader(img: torch.Tensor, use_luma: bool) -> torch.Tensor:
    """Brightness/luma reader: [..., H, Wb, C] u8 -> [..., H, Wb] f32."""
    C = img.shape[-1]
    has_alpha = C in (2, 4)
    nc = C - (1 if has_alpha else 0)
    f = img.to(torch.float32)
    if use_luma and nc >= 3:
        s = _f32(LUMA_W[0]) * f[..., 0]
        s = s + _f32(LUMA_W[1]) * f[..., 1]
        s = s + _f32(LUMA_W[2]) * f[..., 2]
        s = s * _f32(1.0 / 255)
    else:
        s = f[..., 0]
        for k in range(1, nc):
            s = s + f[..., k]
        s = s * _f32(1.0 / (255 * nc))
    if has_alpha:
        s = s * (f[..., -1] * _f32(1.0 / 255))
    return s


def reader_plane(img: torch.Tensor, nrg: int) -> torch.Tensor:
    """The carried reader plane for energy ``nrg`` (zeros for NULL)."""
    nrg = EnergyFunc(nrg)
    if nrg == EnergyFunc.NULL:
        return torch.zeros(img.shape[:-1], dtype=torch.float32,
                           device=img.device)
    return reader(img, nrg in _LUMA_FAMILY)


def _gx(b: torch.Tensor, w: int) -> torch.Tensor:
    lane = torch.arange(b.shape[1], device=b.device)[None, :]
    br = torch.where(lane >= w - 1, b, torch.roll(b, -1, dims=1))
    bl = torch.where(lane == 0, b, torch.roll(b, 1, dims=1))
    return (br - bl) * _f32(0.5)


def _gy(b: torch.Tensor, h=None) -> torch.Tensor:
    bd = torch.cat([b[1:], b[-1:]], dim=0)     # row below (replicated)
    if h is not None:
        # the bottom edge replicates at the true height h - 1 of an image
        # padded to more rows (ragged batches); rows >= h are garbage
        row = torch.arange(b.shape[0], device=b.device)[:, None]
        bd = torch.where(row >= h - 1, b, bd)
    bu = torch.cat([b[:1], b[:-1]], dim=0)     # row above (replicated)
    return (bd - bu) * _f32(0.5)


def gradients(b: torch.Tensor, w: int,
              h=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge-replicated central differences on the first w lanes (SPEC.md
    §2). b: [H, Wb] f32; h: the true height when b is padded to more rows
    (None: all rows are real). Lanes >= w of the result are garbage."""
    return _gx(b, w), _gy(b, h)


def energy_from_plane(b: torch.Tensor, w: int, nrg: int,
                      h=None) -> torch.Tensor:
    """Energy map [H, Wb] f32 from a reader plane; lanes >= w get +inf.
    h: the true height of a padded plane (see ``gradients``)."""
    H, Wb = b.shape
    lane = torch.arange(Wb, device=b.device)[None, :]
    if EnergyFunc(nrg) == EnergyFunc.NULL:
        e = torch.zeros((H, Wb), dtype=torch.float32, device=b.device)
    else:
        e = energy_from_gx(_gx(b, w), b, nrg, h)
    return torch.where(lane < w, e, torch.inf)


def energy_from_gx(gx: torch.Tensor, b: torch.Tensor, nrg: int,
                   h=None) -> torch.Tensor:
    """The energy of a gradient family (not NULL) from the x gradient gx
    and the reader plane b, whose y gradient it takes only where the family
    needs it; a column shard computes gx itself, with its neighbours'
    halo columns (parallel/sharding.py)."""
    nrg = EnergyFunc(nrg)
    if nrg in (EnergyFunc.GRAD_XABS, EnergyFunc.LUMA_GRAD_XABS):
        return torch.abs(gx)            # the default: gy is not needed
    gy = _gy(b, h)
    if nrg in (EnergyFunc.GRAD_SUMABS, EnergyFunc.LUMA_GRAD_SUMABS):
        return (torch.abs(gx) + torch.abs(gy)) * _f32(0.5)
    return sqrt_f32(gx * gx + gy * gy)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt: PyTorch's vectorized CPU sqrt is not (1
    ulp off on AVX-512 hosts); an f64 sqrt rounded to f32 is, on every
    device."""
    return torch.sqrt(x.double()).float()


def energy(img: torch.Tensor, w: int, nrg: int) -> torch.Tensor:
    """Energy map [H, Wb] f32 of the compacted current image ([H, Wb, C]
    u8, lanes >= w zeroed); lanes >= w get +inf. The engine's route,
    ``reader_plane`` then ``energy_from_plane``, bit for bit."""
    return energy_from_plane(reader_plane(img, nrg), w, nrg)
