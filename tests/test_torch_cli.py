"""The port's command line (lqr_tpu_torch.cli --cpu) against lqr_tpu.cli
--cpu on the same PNG files: byte-equal output files (tolerance 0) for
shrinks and enlargements, the output target x scaleback matrix with masks
and seam maps, --last / --save-vals replay with size overrides, percent
sizes and a GAP schedule; bad sizes exit 1; without CUDA and --cpu the
port exits 1 and writes nothing."""

import numpy as np
import pytest
import torch

from lqr_tpu import cli as jcli
from lqr_tpu_torch import cli as tcli
from lqr_tpu_torch.utils.image_io import load_image, save_image
from conftest import random_image

torch.set_num_threads(1)

H, W = 24, 40


@pytest.fixture
def files(tmp_path):
    rng = np.random.default_rng(11)
    save_image(str(tmp_path / "in.png"), random_image(rng, H, W, 3))
    pres = np.zeros((10, 14, 4), np.uint8)
    pres[2:8, 3:11] = [0, 255, 0, 255]
    save_image(str(tmp_path / "pres.png"), pres)
    disc = np.zeros((H, 12, 3), np.uint8)
    disc[4:20, 2:9] = 255
    save_image(str(tmp_path / "disc.png"), disc)
    save_image(str(tmp_path / "rig.png"),
               rng.integers(0, 256, (H, 16, 1)).astype(np.uint8))
    return tmp_path


def _both(tmp, args, outs=("out.png",), out_flag=True):
    """Run both CLIs with the same arguments (each writing under its own
    directory) and require equal exit codes and byte-equal outputs."""
    got = {}
    for side, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp / side
        d.mkdir(exist_ok=True)
        argv = [a.replace("{out}", str(d)) for a in args]
        if out_flag:
            argv += ["-o", str(d / outs[0])]
        rc = main(argv + ["--cpu"])
        got[side] = (rc, [(d / o).read_bytes() for o in outs] if rc == 0
                     else None)
    assert got["jax"] == got["torch"]
    assert got["torch"][0] == 0
    return [load_image(str(tmp / "torch" / o)) for o in outs]


@pytest.mark.parametrize("size", [("31", "24"), ("52", "24"), ("33", "19"),
                                  ("75%", "100%")])
def test_cli_resize_matches_jax(files, size):
    out, = _both(files, [str(files / "in.png"), *size])
    w = int(W * 0.75) if size[0] == "75%" else int(size[0])
    h = H if size[1] == "100%" else int(size[1])
    assert out.shape == (h, w, 3)


@pytest.mark.parametrize("scaleback", [None, "lqrback", "std", "stdw",
                                       "stdh"])
@pytest.mark.parametrize("target", ["same", "new-layer", "new-image"])
def test_cli_matrix_with_masks_matches_jax(files, target, scaleback):
    args = [str(files / "in.png"), "31", "24",
            "--pres", str(files / "pres.png"), "--pres-offset", "4,3",
            "--disc", str(files / "disc.png"), "--disc-offset", "20,0",
            "--disc-coeff", "800", "--rigmask", str(files / "rig.png"),
            "--rigidity", "20", "--output-target", target, "--seams",
            "--seam-colors", "0.9,0.1,0,0.1,0,0.6"]
    if scaleback:
        args += ["--scaleback", "--scaleback-mode", scaleback]
    _both(files, args)


@pytest.mark.parametrize("override", [(), ("46", "20"), ("50%", "100%")])
def test_cli_last_replay_matches_jax(files, override):
    """--save-vals stores the run's settings (aux masks by name); --last
    replays them with or without a size override."""
    inp = str(files / "in.png")
    _both(files, [inp, "30", "24", "--disc", str(files / "disc.png"),
                  "--nrg", "luma_grad_sumabs", "--delta-x", "2",
                  "--save-vals", "--settings", "{out}/s.json"])
    out, = _both(files, [inp, *override, "--last", "--settings",
                         "{out}/s.json"], outs=("last.png",))
    assert out.shape == {(): (24, 30, 3), ("46", "20"): (20, 46, 3),
                         ("50%", "100%"): (24, 20, 3)}[override]


def test_cli_gap_schedule_matches_jax(files):
    rng = np.random.default_rng(12)
    frames = []
    for i in range(3):
        p = files / f"f{i}.png"
        save_image(str(p), random_image(rng, H, W, 3))
        frames.append(str(p))
    outs = _both(files, [*frames, "36", "24", "--gap-width", "28",
                         "--gap-height", "22", "--outdir", "{out}"],
                 outs=[f"f{i}_lqr.png" for i in range(3)], out_flag=False)
    assert [o.shape[:2] for o in outs] == [(24, 36), (23, 32), (22, 28)]


@pytest.mark.parametrize("size", ["abc", "0", "-3", "12x"])
def test_cli_bad_size_exits_1(files, size, capsys):
    for main in (jcli.main, tcli.main):
        assert main([str(files / "in.png"), size, "24", "-o",
                     str(files / "o.png"), "--cpu"]) == 1
    assert not (files / "o.png").exists()
    assert "lqr-tpu-torch: " in capsys.readouterr().err


def test_cli_without_cuda_exits_1_and_writes_nothing(files, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tcli.main([str(files / "in.png"), "30", "24", "-o",
                      str(files / "o.png")]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (files / "o.png").exists()
