"""Batch command line — the batch-gimp-lqr script family replacement.

Mirrors the full parameter surface of ``batch-gimp-lqr-full``
(gimp-lqr-plugin batch/batch-gimp-lqr.scm:68-132, registration 199-289):
load file -> configure -> noninteractive liquid rescale -> save, with the
same defaults as the plugin (gimp-lqr-plugin src/main.c:62-87). Masks are
given as separate image files (the GIMP-layer equivalent), optionally with
offsets.

The port's copy of ``lqr_tpu.cli``: it carves on the card (CUDA) unless
``--cpu`` asks for the plain PyTorch versions of the kernels, and without
CUDA and ``--cpu`` it exits 1 before it reads a file.

Examples:

    python -m lqr_tpu_torch.cli in.png 400 300 -o out.png
    python -m lqr_tpu_torch.cli in.png 400 300 --disc dmask.png --seams \
        --output-target new-image -o out.png
    python -m lqr_tpu_torch.cli frames/*.png 400 300 --gap-width 500 \
        --gap-height 300 --outdir out/   # GAP-style animation schedule
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .config import (LqrConfig, SeamColors, EnergyFunc, ResizeOrder,
                     OutputTarget, ScalebackMode, MAX_COEFF, MAX_DELTA_X,
                     MAX_RIGIDITY, MAX_ENL_STEP, MIN_ENL_STEP)
from .errors import LqrError, LqrConfigError, check_target_size
from .i18n import _
from .image_model import Image, Layer
from .sizeentry import parse_size
from .render import init_carver, render_noninteractive
from .core.state import resolve_device
from .gap import schedule
from .utils.image_io import load_image, save_image

_NRG = {"grad_xabs": EnergyFunc.GRAD_XABS,
        "grad_sumabs": EnergyFunc.GRAD_SUMABS,
        "grad_norm": EnergyFunc.GRAD_NORM,
        "luma_grad_xabs": EnergyFunc.LUMA_GRAD_XABS,
        "luma_grad_sumabs": EnergyFunc.LUMA_GRAD_SUMABS,
        "luma_grad_norm": EnergyFunc.LUMA_GRAD_NORM,
        "null": EnergyFunc.NULL}
_TARGET = {"same": OutputTarget.SAME_LAYER,
           "new-layer": OutputTarget.NEW_LAYER,
           "new-image": OutputTarget.NEW_IMAGE}
_SB = {"lqrback": ScalebackMode.LQRBACK, "std": ScalebackMode.STD,
       "stdw": ScalebackMode.STDW, "stdh": ScalebackMode.STDH}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lqr-tpu-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", nargs="+", help=_("input image file(s)"))
    p.add_argument("width", nargs="?", default=None,
                   help=_("final width: pixels or percent like 75%% "
                          "(optional with --last)"))
    p.add_argument("height", nargs="?", default=None,
                   help=_("final height: pixels or percent "
                          "(optional with --last)"))
    p.add_argument("--last", action="store_true",
                   help=_("replay the last saved settings "
                          "(RUN_WITH_LAST_VALS; aux masks matched by name)"))
    p.add_argument("--save-vals", action="store_true",
                   help=_("persist this run's settings for --last replay"))
    p.add_argument("--settings", metavar="PATH",
                   help=_("settings store file (default "
                          "~/.config/lqr_tpu/settings.json)"))
    p.add_argument("-o", "--output", help=_("output file (single input)"))
    p.add_argument("--outdir", help=_("output directory (multiple inputs)"))
    p.add_argument("--pres", help=_("preservation mask image file"))
    p.add_argument("--pres-coeff", type=int, default=1000)
    p.add_argument("--pres-offset", default="0,0", metavar="X,Y")
    p.add_argument("--disc", help=_("discard mask image file"))
    p.add_argument("--disc-coeff", type=int, default=1000)
    p.add_argument("--disc-offset", default="0,0", metavar="X,Y")
    p.add_argument("--rigmask", help=_("rigidity mask image file"))
    p.add_argument("--rigmask-offset", default="0,0", metavar="X,Y")
    p.add_argument("--rigidity", type=float, default=0.0)
    p.add_argument("--delta-x", type=int, default=1)
    p.add_argument("--enl-step", type=float, default=150.0,
                   help=_("max enlargement per step, percent (default 150)"))
    p.add_argument("--no-resize-aux", action="store_true")
    p.add_argument("--no-resize-canvas", action="store_true")
    p.add_argument("--output-target", choices=_TARGET, default="same")
    p.add_argument("--seams", action="store_true",
                   help=_("output the seam map(s)"))
    p.add_argument("--seam-colors", default="1,0,0,0.2,0,0",
                   metavar="R1,G1,B1,R2,G2,B2")
    p.add_argument("--nrg", choices=_NRG, default="grad_xabs")
    p.add_argument("--res-order", choices=["hor", "vert"], default="hor")
    p.add_argument("--scaleback", action="store_true")
    p.add_argument("--scaleback-mode", choices=_SB, default="lqrback")
    p.add_argument("--disc-on-enlarge", action="store_true",
                   help=_("do NOT ignore the discard mask when enlarging"))
    p.add_argument("--gap-width", type=int,
                   help=_("animate: width keyframe for the last frame"))
    p.add_argument("--gap-height", type=int,
                   help=_("animate: height keyframe for the last frame"))
    p.add_argument("--cpu", action="store_true",
                   help=_("run on the CPU (the plain PyTorch versions of the "
                          "kernels)"))
    return p


def _xy(s: str) -> tuple[int, int]:
    try:
        x, y = s.split(",")
        return int(x), int(y)
    except ValueError:
        raise LqrConfigError(
            _("offset {s!r} is not of the form X,Y (integers)")
            .format(s=s)) from None


def _validate(args) -> None:
    """User-facing parameter validation at the CLI boundary (the
    IMAGE_CHECK/LAYER_CHECK analog, gimp-lqr-plugin src/main.h:131-153)."""
    if args.width is None or args.height is None:
        if not args.last:
            raise LqrConfigError(
                _("width and height are required (or use --last to replay "
                  "the saved settings)"))
    else:
        # syntax check; percent sizes resolve per image (size-entry %
        # unit, altsizeentry.c percent law)
        w = parse_size(str(args.width), 100)
        h = parse_size(str(args.height), 100)
        check_target_size(w, h)
        if _is_percent(args) and (args.gap_width or args.gap_height):
            raise LqrConfigError(
                _("percent sizes cannot combine with --gap-* keyframes"))
    if not 0 <= args.delta_x <= MAX_DELTA_X:
        raise LqrConfigError(
            _("--delta-x {v} out of range 0..{hi}")
            .format(v=args.delta_x, hi=MAX_DELTA_X))
    if not 0 <= args.rigidity <= MAX_RIGIDITY:
        raise LqrConfigError(
            _("--rigidity {v} out of range 0..{hi:g}")
            .format(v=args.rigidity, hi=MAX_RIGIDITY))
    for name in ("pres_coeff", "disc_coeff"):
        v = getattr(args, name)
        if not 0 <= v <= MAX_COEFF:
            raise LqrConfigError(
                _("--{name} {v} out of range 0..{hi}")
                .format(name=name.replace("_", "-"), v=v, hi=MAX_COEFF))
    if not MIN_ENL_STEP * 100 <= args.enl_step <= MAX_ENL_STEP * 100:
        raise LqrConfigError(
            _("--enl-step {v} out of range {lo:g}..{hi:g} (percent)")
            .format(v=args.enl_step, lo=MIN_ENL_STEP * 100,
                    hi=MAX_ENL_STEP * 100))
    for path in args.input + [args.pres, args.disc, args.rigmask]:
        if path and not os.path.exists(path):
            raise LqrConfigError(
                _("no such file: {path}").format(path=path))


def _is_percent(args) -> bool:
    return (str(args.width).endswith("%")
            or str(args.height).endswith("%"))


def config_from_args(args) -> LqrConfig:
    # percent sizes stay symbolic until an image's size is known
    w = parse_size(str(args.width), 100) if args.width is not None else 100
    h = parse_size(str(args.height), 100) if args.height is not None else 100
    return LqrConfig(
        new_width=w, new_height=h,
        pres_layer="__pres" if args.pres else "",
        pres_coeff=args.pres_coeff,
        disc_layer="__disc" if args.disc else "",
        disc_coeff=args.disc_coeff,
        rigidity=args.rigidity,
        rigmask_layer="__rigmask" if args.rigmask else "",
        delta_x=args.delta_x,
        enl_step=args.enl_step / 100.0,
        resize_aux_layers=not args.no_resize_aux,
        resize_canvas=not args.no_resize_canvas,
        output_target=_TARGET[args.output_target],
        output_seams=args.seams,
        nrg_func=_NRG[args.nrg],
        res_order=(ResizeOrder.HOR if args.res_order == "hor"
                   else ResizeOrder.VERT),
        scaleback=args.scaleback,
        scaleback_mode=_SB[args.scaleback_mode],
        no_disc_on_enlarge=not args.disc_on_enlarge,
    )


def _build_image(path: str, args) -> Image:
    img = Image.from_array(load_image(path))
    for flag, name, off in (("pres", "__pres", args.pres_offset),
                            ("disc", "__disc", args.disc_offset),
                            ("rigmask", "__rigmask", args.rigmask_offset)):
        f = getattr(args, flag)
        if f:
            x, y = _xy(off)
            img.add_layer(Layer(name, load_image(f), x_off=x, y_off=y,
                                visible=False))
    return img


def _out_path(inp: str, args, i: int, n: int) -> str:
    if args.output and n == 1:
        return args.output
    base = os.path.basename(inp)
    stem, ext = os.path.splitext(base)
    outdir = args.outdir or os.path.dirname(inp) or "."
    os.makedirs(outdir, exist_ok=True)
    return os.path.join(outdir, f"{stem}_lqr{ext or '.png'}")


def _colors(args) -> SeamColors:
    try:
        v = [float(x) for x in args.seam_colors.split(",")]
        if len(v) != 6:
            raise ValueError(len(v))
    except ValueError:
        raise LqrConfigError(
            _("--seam-colors {v!r} is not 6 comma-separated floats "
              "R1,G1,B1,R2,G2,B2")
            .format(v=args.seam_colors)) from None
    return SeamColors(*v)


def run_one(path: str, cfg: LqrConfig, args, out_path: str, device):
    image = _build_image(path, args)
    if _is_percent(args):
        # percent sizes resolve against each image's own dimensions
        layer = image.active_layer
        if args.width is not None:
            cfg = cfg.replace(
                new_width=parse_size(str(args.width), layer.width))
        if args.height is not None:
            cfg = cfg.replace(
                new_height=parse_size(str(args.height), layer.height))
    if args.last:
        # aux masks matched per-image BY NAME (main.c:508-517; the GAP
        # per-frame contract) — unknown names resolve to unset
        def resolve(name):
            return name if image.layer_by_name(name) is not None else ""
        cfg = cfg.replace(pres_layer=resolve(cfg.pres_layer_name),
                          disc_layer=resolve(cfg.disc_layer_name),
                          rigmask_layer=resolve(cfg.rigmask_layer_name))
    cd = init_carver(image, cfg, device=device)
    ok = render_noninteractive(cfg, _colors(args), cd)
    if not ok:
        raise LqrError(_("render failed for {path}").format(path=path))
    if cfg.output_seams or cfg.output_target != OutputTarget.SAME_LAYER:
        out = cd.image.flatten_visible()
    else:
        out = cd.image.layer_by_name(cd.layer_name).pixels
    save_image(out_path, out)
    return cfg


def _split_size_args(args) -> None:
    """argparse's greedy nargs='+' absorbs the trailing WIDTH HEIGHT
    positionals; pull numeric trailers back out of the input list."""
    if args.width is not None or args.height is not None:
        return

    def is_size(tok: str) -> bool:
        return tok.removesuffix("%").lstrip("-").isdigit()

    trail = []
    while (len(args.input) > 1 and len(trail) < 2
           and is_size(args.input[-1])):
        trail.append(args.input.pop())
    trail.reverse()                      # command-line order
    if len(trail) == 2:
        args.width, args.height = trail
    elif len(trail) == 1:
        args.width = trail[0]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _split_size_args(args)
    try:
        return _run(args)
    except LqrError as e:
        # user-facing error channel (the g_message analog,
        # gimp-lqr-plugin src/render.c:42-62)
        print(f"lqr-tpu-torch: {_('error')}: {e}", file=sys.stderr)
        return 1


def _run(args) -> int:
    from .settings import SettingsStore, save_vals, retrieve_vals
    _validate(args)
    # the card unless --cpu; without CUDA this raises before any file is
    # read or written
    device = resolve_device("cpu" if args.cpu else "cuda")
    store = SettingsStore(args.settings)
    if args.last:
        # RUN_WITH_LAST_VALS (main.c:388-390): replay the stored config;
        # aux masks resolve per-image by name inside _run_last below
        cfg, _stored_colors = retrieve_vals(store)
        # explicit size overrides parse like the non---last path (percent
        # stays symbolic here; run_one resolves it against each image)
        if args.width is not None:
            cfg = cfg.replace(new_width=parse_size(str(args.width), 100))
        if args.height is not None:
            cfg = cfg.replace(new_height=parse_size(str(args.height), 100))
    else:
        cfg = config_from_args(args)
    inputs = args.input
    if args.gap_width or args.gap_height:
        # GAP-style animation: interpolate configs across the input frames
        cfg_to = cfg.replace(new_width=args.gap_width or cfg.new_width,
                             new_height=args.gap_height or cfg.new_height)
        cfgs = list(schedule(cfg, cfg_to, len(inputs)))
    else:
        cfgs = [cfg] * len(inputs)
    for i, (path, c) in enumerate(zip(inputs, cfgs)):
        outp = _out_path(path, args, i, len(inputs))
        used = run_one(path, c, args, outp, device)
        print(f"{path} -> {outp} ({used.new_width}x{used.new_height})")
    if args.save_vals:
        save_vals(store, cfg, _colors(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
