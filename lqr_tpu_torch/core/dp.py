"""Cumulative-cost DP and backtrack (SPEC.md §5), plain PyTorch.

Counterpart of ``lqr_tpu.core.dp``:

    M[0, x] = E[0, x]
    M[y, x] = E[y, x] + min_{|dx| <= delta_x} ( M[y-1, x+dx] + rig·f32(|dx|^1.5/H) )

with +inf outside [0, Wb). These are the plain versions of the two CUDA
kernels in ``ops/dp_cuda.py`` (the kernels are held bit-equal to them on
the card) and the CPU path: a Python loop over rows, columns vectorized.

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


def dp_forward(e_tot: torch.Tensor, rig: torch.Tensor | None,
               pref_left: bool, delta_x: int, has_rig: bool):
    """Run the DP. e_tot: [H, Wb] f32 (+inf at invalid lanes, bias
    included); rig: [H, Wb] f32 or None. Returns (M_last [Wb] f32,
    bp [H, Wb] int8), bp[0] = 0."""
    H, Wb = e_tot.shape
    dev = e_tot.device
    order = rank_order(delta_x, bool(pref_left))
    dxs = torch.tensor(order, dtype=torch.int8, device=dev)
    rigc = torch.from_numpy(rigc_table(delta_x, H))
    d = delta_x
    bp = torch.zeros((H, Wb), dtype=torch.int8, device=dev)
    pad = torch.full((d,), torch.inf, dtype=torch.float32, device=dev)
    M = e_tot[0]
    for y in range(1, H):
        Mp = torch.cat([pad, M, pad])               # Mp[d + x] = M[x]
        cands = []
        for dx in order:
            c = Mp[d + dx:d + dx + Wb]
            if has_rig and dx != 0:
                c = c + rig[y] * rigc[abs(dx)]
            cands.append(c)
        C = torch.stack(cands)                      # [2d+1, Wb], rank order
        best = C.min(dim=0).values
        first = (C == best).to(torch.uint8).argmax(dim=0)
        bp[y] = dxs[first]
        M = e_tot[y] + best
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


def find_seam(e_tot, rig, pref_left: bool, delta_x: int, has_rig: bool):
    M_last, bp = dp_forward(e_tot, rig, pref_left, delta_x, has_rig)
    return backtrack(M_last, bp, pref_left)
