"""Plain reference of liblqr's carve (SPEC.md), in PyTorch, over a batch of
maps of one size.

Written from the specification, not from the program: the reader plane
(brightness or luma), the gradient energies with edge replication, the
additive bias, the cumulative-cost DP with its candidate order and
side-switch preference, the start column, the backtrack, the visibility
map and the shrinking materialization. Every floating-point operation is
a single IEEE operation in the order the specification pins (no fused
multiply-add), so the float32 result is exact, on the card or the CPU.
``dtype`` runs the same arithmetic in a lower precision (the control).

Each DP row is three tensor operations over the whole batch; the
backtrack walks the rows on the host from the per-row choices.
"""

from __future__ import annotations

import numpy as np
import torch

GRAD_XABS, GRAD_SUMABS, GRAD_NORM = 0, 1, 2
LUMA_GRAD_XABS, LUMA_GRAD_SUMABS, LUMA_GRAD_NORM, NULL = 3, 4, 5, 6
LUMA_W = (0.2126, 0.7152, 0.0722)   # Rec. 709 (SPEC.md §1)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """The f64 value v rounded once to f32, as a scalar on like's device."""
    return torch.tensor(np.float32(v), device=like.device)


def strength(px: torch.Tensor) -> torch.Tensor:
    """Mask strength / brightness of [..., C] u8 pixels, f32: the sum of
    the colour channels over 255 * channels, times alpha / 255 (C 2, 4)."""
    c = px.shape[-1]
    nc = c - (1 if c in (2, 4) else 0)
    s = px[..., :nc].to(torch.float32).sum(dim=-1)
    s = s * _f32(1.0 / (255 * nc), s)
    if c in (2, 4):
        s = s * (px[..., -1].to(torch.float32) * _f32(1.0 / 255, s))
    return s


def luma(px: torch.Tensor) -> torch.Tensor:
    """Rec. 709 luma of [..., C] u8 pixels, f32: ((w0 R + w1 G) + w2 B) /
    255, times alpha / 255 (C 2, 4)."""
    c = px.shape[-1]
    nc = c - (1 if c in (2, 4) else 0)
    f = px.to(torch.float32)
    if nc >= 3:
        s = _f32(LUMA_W[0], f) * f[..., 0]
        s = s + _f32(LUMA_W[1], f) * f[..., 1]
        s = s + _f32(LUMA_W[2], f) * f[..., 2]
        s = s * _f32(1.0 / 255, f)
    else:
        s = f[..., 0] * _f32(1.0 / 255, f)
    if c in (2, 4):
        s = s * (f[..., -1] * _f32(1.0 / 255, f))
    return s


def reader(px: torch.Tensor, nrg: int) -> torch.Tensor:
    """The plane the energy differentiates (SPEC.md §1)."""
    return luma(px) if nrg in (LUMA_GRAD_XABS, LUMA_GRAD_SUMABS) \
        else strength(px)


def energy(b: torch.Tensor, nrg: int) -> torch.Tensor:
    """Energy of [B, H, w] reader planes: central differences with the
    edge replicated, halved; |gx|, or (|gx| + |gy|) / 2 (SPEC.md §2)."""
    if nrg == NULL:
        return torch.zeros_like(b)
    if nrg in (GRAD_NORM, LUMA_GRAD_NORM):
        raise NotImplementedError("the norm energies are not in the "
                                  "reference")
    half = torch.tensor(0.5, dtype=b.dtype, device=b.device)
    bx = torch.cat([b[..., :1], b, b[..., -1:]], dim=-1)
    gx = (bx[..., 2:] - bx[..., :-2]) * half
    if nrg in (GRAD_XABS, LUMA_GRAD_XABS):
        return gx.abs()
    by = torch.cat([b[..., :1, :], b, b[..., -1:, :]], dim=-2)
    gy = (by[..., 2:, :] - by[..., :-2, :]) * half
    return (gx.abs() + gy.abs()) * half


def pref_is_left(s: int, freq: int) -> bool:
    """Side preference of the 1-based seam s (SPEC.md §5)."""
    return freq <= 0 or ((s - 1) // freq) % 2 == 0


def dx_order(delta_x: int, pref_left: bool) -> list[int]:
    """Candidate order: straight down first, then by distance, the
    preferred side first; the first of equal costs wins (SPEC.md §5)."""
    order = [0]
    for m in range(1, delta_x + 1):
        order += [-m, m] if pref_left else [m, -m]
    return order


def find_seams(e: torch.Tensor, rig: torch.Tensor | None, delta_x: int,
               pref_left: bool, full_h: int) -> np.ndarray:
    """One minimal seam of each [H, w] cost map of e [B, H, w]: [B, H]
    columns (host int64). rig: per-pixel rigidity [B, H, w] or None;
    full_h: the H of the rigidity step's 1 / H (SPEC.md §4)."""
    B, H, w = e.shape
    d = delta_x
    order = dx_order(d, pref_left)
    pad = torch.full((B, w + 2 * d), float("inf"), dtype=e.dtype,
                     device=e.device)
    pad[:, d:d + w] = e[:, 0]
    rigc = [_f32(abs(dx) ** 1.5 / float(full_h), e).to(e.dtype)
            for dx in order]
    cand = torch.empty((B, w, len(order)), dtype=e.dtype, device=e.device)
    best = torch.empty((B, w), dtype=e.dtype, device=e.device)
    # rows first, so each row's choices are one contiguous [B, w] block
    choice = torch.zeros((H, B, w), dtype=torch.int64, device=e.device)
    row = pad[:, d:d + w]
    for y in range(1, H):
        views = [pad[:, d + dx:d + dx + w] for dx in order]
        if rig is not None:
            views = [v + rig[:, y] * c for v, c in zip(views, rigc)]
        torch.stack(views, dim=-1, out=cand)
        # the first of equal minima: the candidate order's tie rule
        torch.min(cand, dim=-1, out=(best, choice[y]))
        torch.add(e[:, y], best, out=row)
    dxs = np.asarray(order, np.int64)
    last = row.float().cpu().numpy()   # exact: f32 holds every bf16
    if pref_left:
        x = np.argmin(last, axis=1)
    else:
        x = w - 1 - np.argmin(last[:, ::-1], axis=1)
    ch = choice.to(torch.uint8).cpu().numpy()
    seam = np.empty((B, H), np.int64)
    seam[:, H - 1] = x
    bi = np.arange(B)
    for y in range(H - 1, 0, -1):
        x = x + dxs[ch[y, bi, x]]
        seam[:, y - 1] = x
    return seam


def carve(images: torch.Tensor, seams: int, *, nrg: int = GRAD_XABS,
          delta_x: int = 1, side_switch_freq: int = 2,
          bias: torch.Tensor | None = None, rig: torch.Tensor | None = None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The visibility map [B, H, W] i32 of carving `seams` vertical seams
    off each of images [B, H, W, C] u8 (0: never carved; s: the s-th
    seam), with an additive bias [B, H, W] f32 and per-pixel rigidity
    [B, H, W] f32 (the global rigidity times the mask) where given."""
    B, H, W, _ = images.shape
    dev = images.device
    cur_b = reader(images, nrg).to(dtype)
    cur_bias = None if bias is None else bias.to(dtype)
    cur_rig = None if rig is None else rig.to(dtype)
    col = torch.arange(W, device=dev).expand(B, H, W)
    vs = torch.zeros((B, H, W), dtype=torch.int32, device=dev)
    base = (torch.arange(B, device=dev)[:, None] * H
            + torch.arange(H, device=dev)[None, :]) * W
    for s in range(1, seams + 1):
        w = W - (s - 1)
        e = energy(cur_b, nrg)
        if cur_bias is not None:
            e = e + cur_bias
        seam = torch.from_numpy(find_seams(e, cur_rig, delta_x,
                                           pref_is_left(s, side_switch_freq),
                                           H)).to(dev)
        vs.view(-1)[base + col.gather(2, seam[..., None])[..., 0]] = s
        # drop column seam[b, y] of every row
        lane = torch.arange(w - 1, device=dev)
        keep = (lane + (lane >= seam[..., None])).expand(B, H, w - 1)
        cur_b = cur_b.gather(2, keep)
        col = col.gather(2, keep)
        if cur_bias is not None:
            cur_bias = cur_bias.gather(2, keep)
        if cur_rig is not None:
            cur_rig = cur_rig.gather(2, keep)
    return vs


def materialize(images: torch.Tensor, vs: torch.Tensor,
                w: int) -> torch.Tensor:
    """Each image [B, H, W, C] shrunk to width w <= W by its map: the
    pixels whose seam number is 0 or past W - w (SPEC.md §6)."""
    B, H, W, C = images.shape
    keep = (vs == 0) | (vs > W - w)
    return images[keep].view(B, H, w, C)


def placed_bias(masks: list[tuple[torch.Tensor, float]]
                ) -> torch.Tensor | None:
    """The bias field [h, w] f32 of masks, each a [h, w] or [h, w, C] u8
    plane at the image's origin with its factor: the sum, in the order
    given, of strength * f32(factor / 1000) (SPEC.md §3)."""
    bias = None
    for m, factor in masks:
        px = m if m.dim() == 3 else m[..., None]
        add = strength(px) * _f32(float(factor) / 1000.0, px)
        bias = add if bias is None else bias + add
    return bias


def placed_rigidity(masks: list[torch.Tensor],
                    rigidity: float) -> torch.Tensor:
    """The per-pixel rigidity [h, w] f32 of rigidity masks, each a [h, w]
    or [h, w, C] u8 plane at the image's origin: f32(rigidity) times the
    sum, in the order given, of their strengths; 0 outside them (SPEC.md
    §4, rigidity being R')."""
    total = None
    for m in masks:
        s = strength(m if m.dim() == 3 else m[..., None])
        total = s if total is None else total + s
    return total * _f32(float(rigidity), total)
