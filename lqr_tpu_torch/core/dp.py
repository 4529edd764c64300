"""Cumulative-cost DP and backtrack (SPEC.md §5), plain PyTorch.

Counterpart of ``lqr_tpu.core.dp``:

    M[0, x] = E[0, x]
    M[y, x] = E[y, x] + min_{|dx| <= delta_x} ( M[y-1, x+dx] + rig·f32(|dx|^1.5/H) )

with +inf outside [0, Wb). These are the plain versions of the two CUDA
kernels in ``ops/dp_cuda.py`` (the kernels are held bit-equal to them on
the card) and the CPU path: a Python loop over rows, columns vectorized.
``dp_row`` is one row of the recursion; the column-sharded DP block
(``ops/dp_block.py``) runs it too.

Ragged batches (``lqr_tpu.core.dp.dp_forward``'s hooks): with the true
height ``h`` of an image padded to H rows, rows >= h pass the frontier
through (M = M_prev, bp = 0), so the seam equals the unpadded image's and
its padded rows carry seam[h - 1]; ``rigc_vec`` ([delta_x + 1] f32, the
image's f32(m^1.5 / h)) replaces the table of H.

Tie-breaking (SPEC.md §5): candidates are ranked by side preference
(LEFT: dx = 0, -1, +1, -2, +2, ...; RIGHT: 0, +1, -1, ...) and the
backpointer is the first candidate in rank order that equals the row
minimum — the same choice as a rank-order scan that keeps the first strict
minimum. The seam starts at the leftmost (LEFT) or rightmost (RIGHT)
minimum of the last row.
"""

from __future__ import annotations

import numpy as np
import torch


def rank_tables(delta_x: int) -> tuple[dict, dict]:
    """Static candidate ranks {dx: rank} for LEFT and RIGHT preference."""
    left, right = {0: 0}, {0: 0}
    r = 1
    for m in range(1, delta_x + 1):
        left[-m], left[m] = r, r + 1
        right[m], right[-m] = r, r + 1
        r += 2
    return left, right


def rank_order(delta_x: int, pref_left: bool) -> list[int]:
    """The dx candidates in the scan order of the given preference."""
    ranks = rank_tables(delta_x)[0 if pref_left else 1]
    return sorted(ranks, key=ranks.get)


def rigc_table(delta_x: int, H: int) -> np.ndarray:
    """Rigidity step coefficients f32(m^1.5 / H), m = 0..delta_x, computed
    in f64 on the host and rounded once (SPEC.md §4)."""
    return np.array([np.float32((m ** 1.5) / H)
                     for m in range(delta_x + 1)], np.float32)


def shift_frontier(M: torch.Tensor, dx: int) -> torch.Tensor:
    """shifted[..., x] = M[..., x + dx], +inf where x + dx is out of range.
    M: [..., Wb]."""
    if dx == 0:
        return M
    Wb = M.shape[-1]
    lane = torch.arange(Wb, device=M.device)
    s = torch.roll(M, -dx, dims=-1)
    out = lane >= Wb - dx if dx > 0 else lane < -dx
    return torch.where(out, torch.inf, s)


def dp_row(M: torch.Tensor, e_row: torch.Tensor, rig_row, order: list,
           dxs: torch.Tensor, rigc, has_rig: bool):
    """One DP row: (M_new [W], bp [W] int8) from the previous row M [W].
    order: the dx candidates in rank order, dxs the same as an int8
    tensor; rigc[m] = f32(m^1.5 / H)."""
    W = M.shape[0]
    d = max(abs(dx) for dx in order)
    pad = torch.full((d,), torch.inf, dtype=torch.float32, device=M.device)
    Mp = torch.cat([pad, M, pad])               # Mp[d + x] = M[x]
    cands = []
    for dx in order:
        c = Mp[d + dx:d + dx + W]
        if has_rig and dx != 0:
            c = c + rig_row * rigc[abs(dx)]
        cands.append(c)
    C = torch.stack(cands)                      # [2d+1, W], rank order
    best = C.min(dim=0).values
    first = (C == best).to(torch.uint8).argmax(dim=0)
    return e_row + best, dxs[first]


def rank_setup(delta_x: int, pref_left: bool, device):
    """(order, dxs) for dp_row."""
    order = rank_order(delta_x, bool(pref_left))
    return order, torch.tensor(order, dtype=torch.int8, device=device)


def dp_forward(e_tot: torch.Tensor, rig: torch.Tensor | None,
               pref_left: bool, delta_x: int, has_rig: bool, h=None,
               rigc_vec=None):
    """Run the DP. e_tot: [H, Wb] f32 (+inf at invalid lanes, bias
    included); rig: [H, Wb] f32 or None; h: the true height (rows >= h
    pass through), None for H; rigc_vec: [delta_x + 1] f32 coefficients,
    None for the table of H. Returns (M_last [Wb] f32, bp [H, Wb] int8),
    bp[0] = 0."""
    H, Wb = e_tot.shape
    dev = e_tot.device
    order, dxs = rank_setup(delta_x, pref_left, dev)
    rigc = (torch.from_numpy(rigc_table(delta_x, H)) if rigc_vec is None
            else torch.as_tensor(rigc_vec, dtype=torch.float32).cpu())
    hr = H if h is None else int(h)
    bp = torch.zeros((H, Wb), dtype=torch.int8, device=dev)
    M = e_tot[0]
    for y in range(1, hr):
        M, bp[y] = dp_row(M, e_tot[y], rig[y] if has_rig else None, order,
                          dxs, rigc, has_rig)
    return M, bp


def backtrack(M_last: torch.Tensor, bp: torch.Tensor,
              pref_left: bool) -> torch.Tensor:
    """Extract the seam [H] int32 (compacted coords). Invalid lanes of
    M_last must be +inf."""
    H, Wb = bp.shape
    lane = torch.arange(Wb, device=M_last.device)
    eq = M_last == M_last.min()
    if pref_left:
        x = torch.where(eq, lane, Wb).min()
    else:
        x = torch.where(eq, lane, -1).max()
    # x stays a device tensor of shape [1]: indexing with a 0-d tensor, or
    # .item(), would wait for the device at every row
    x = x.view(1)
    seam = torch.empty(H, dtype=torch.int32, device=M_last.device)
    for y in range(H - 1, -1, -1):
        seam[y:y + 1] = x
        x = x + bp[y].index_select(0, x)
    return seam


def find_seam(e_tot, rig, pref_left: bool, delta_x: int, has_rig: bool,
              h=None, rigc_vec=None):
    M_last, bp = dp_forward(e_tot, rig, pref_left, delta_x, has_rig, h=h,
                            rigc_vec=rigc_vec)
    return backtrack(M_last, bp, pref_left)
