"""The comparison that decides ``correct``: what the window produced
against the plain reference, worked out again from the same inputs.

Each checked answer is an image the program carved in the window: its
visibility map (the seams, in order) and its output pixels. Both are
exact in the specification, so each count of differences has the limit 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import carve as ref

LIMITS = {"vs_mismatch": 0, "pixel_mismatch": 0}


@dataclasses.dataclass
class Answer:
    """One carved image of the window, on the host: its input, the masks
    it was given (each bias mask a [H, W] u8 plane at the origin with its
    factor; each rigidity mask a [H, W] u8 plane at the origin), the seams
    asked for, and what the program gave back."""
    image: np.ndarray                     # [H, W, C] u8
    masks: list[tuple[np.ndarray, float]]
    seams: int
    vs: np.ndarray                        # [H, W] i32, the program's map
    out: np.ndarray                       # [H, W - seams, C] u8
    rigmasks: list[np.ndarray] = dataclasses.field(default_factory=list)


def _rigidity(config: dict, a: Answer, device) -> torch.Tensor | None:
    """The answer's per-pixel rigidity [H, W] f32: f32(R') times its
    rigidity masks' summed strength where it has masks, else R' uniform,
    else (R' = 0) none."""
    if a.rigmasks:
        return ref.placed_rigidity(
            [torch.from_numpy(m).to(device) for m in a.rigmasks],
            config["rigidity"])
    if config["rigidity"] > 0:
        H, W = a.image.shape[:2]
        return torch.full((H, W), np.float32(config["rigidity"]),
                          device=device)
    return None


def _expected_group(config: dict, answers: list[Answer], device,
                    dtype) -> tuple[np.ndarray, np.ndarray]:
    """The reference's maps [n, H, W] and images [n, H, W - seams, C] for
    answers of one size and one seam count."""
    seams = answers[0].seams
    images = torch.from_numpy(np.stack([a.image for a in answers])).to(device)
    _, H, W, _ = images.shape
    bias = None
    if any(a.masks for a in answers):
        bias = torch.stack([
            ref.placed_bias([(torch.from_numpy(m).to(device), f)
                             for m, f in a.masks])
            if a.masks else torch.zeros((H, W), device=device)
            for a in answers])
    rigs = [_rigidity(config, a, device) for a in answers]
    rig = None
    if any(r is not None for r in rigs):
        rig = torch.stack([torch.zeros((H, W), device=device) if r is None
                           else r for r in rigs])
    vs = ref.carve(images, seams, nrg=config["energy"],
                   delta_x=config["delta_x"],
                   side_switch_freq=config["side_switch_frequency"],
                   bias=bias, rig=rig, dtype=dtype)
    out = ref.materialize(images, vs, W - seams)
    return vs.cpu().numpy(), out.cpu().numpy()


def expected(config: dict, answers: list[Answer], device,
             dtype=torch.float32) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """The reference's map [H, W] and image [H, W - seams, C] of each
    answer's input, in the answers' order, computed in dtype: one run of
    the reference for each size and seam count among them."""
    groups: dict[tuple, list[int]] = {}
    for i, a in enumerate(answers):
        groups.setdefault((*a.image.shape, a.seams), []).append(i)
    vs: list = [None] * len(answers)
    out: list = [None] * len(answers)
    for idx in groups.values():
        g_vs, g_out = _expected_group(config, [answers[i] for i in idx],
                                      device, dtype)
        for n, i in enumerate(idx):
            vs[i], out[i] = g_vs[n], g_out[n]
    return vs, out


def _differ(a: np.ndarray, b: np.ndarray) -> int:
    """Elements that differ; every element of the larger when the shapes
    do."""
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.count_nonzero(a != b))


def check(config: dict, answers: list[Answer], device,
          control=None) -> dict:
    """The numbers compared: differing map entries and output bytes over
    the checked answers. control: a dtype in which the reference stands in
    for the program (the control run)."""
    if not answers:
        return {"checked_images": 0, **{k: None for k in LIMITS}}
    want_vs, want_out = expected(config, answers, device)
    if control is None:
        got_vs = [a.vs for a in answers]
        got_out = [a.out for a in answers]
    else:
        got_vs, got_out = expected(config, answers, device, control)
    return {
        "checked_images": len(answers),
        "vs_mismatch": sum(_differ(g, w) for g, w in zip(got_vs, want_vs)),
        "pixel_mismatch": sum(_differ(g, w)
                              for g, w in zip(got_out, want_out)),
    }


def passes(numbers: dict) -> bool:
    return numbers["checked_images"] > 0 and all(
        numbers[k] is not None and numbers[k] <= lim
        for k, lim in LIMITS.items())


def as_line(numbers: dict) -> dict:
    """Each number compared beside its limit, for the result line."""
    out = {"checked_images": {"value": numbers["checked_images"],
                              "limit": "> 0"}}
    for k, lim in LIMITS.items():
        out[k] = {"value": numbers[k], "limit": lim}
    return out
