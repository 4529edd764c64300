"""The port's image codec (lqr_tpu_torch.utils.codec / image_io) against
lqr_tpu.utils.codec: byte-equal PNG and PNM encodes, equal decodes
(tolerance 0); no silent fallback: a PNG or PNM the codec cannot read or
write raises LqrImageError without reaching Pillow, and other formats need
Pillow, imported only for them."""

import sys

import numpy as np
import pytest
import torch

from lqr_tpu.utils import codec as jcodec
from lqr_tpu_torch import LqrImageError
from lqr_tpu_torch.utils import codec as tcodec
from lqr_tpu_torch.utils.image_io import load_image, save_image

torch.set_num_threads(1)


def _arr(c, h=29, w=37, seed=0):
    rng = np.random.default_rng(seed + c)
    a = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    return ((a.astype(np.int32) + np.roll(a, 1, 1)) // 2).astype(np.uint8)


@pytest.fixture
def no_pil(monkeypatch):
    """Any import of PIL fails while the test runs."""
    for name in [m for m in sys.modules if m.split(".")[0] == "PIL"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


@pytest.mark.parametrize("fmt,c", [("png", 1), ("png", 2), ("png", 3),
                                   ("png", 4), ("pnm", 1), ("pnm", 3)])
def test_encode_byte_equal_and_decode_equal(fmt, c):
    a = _arr(c)
    data = tcodec.encode(a, fmt)
    assert data == jcodec.encode(a, fmt)
    np.testing.assert_array_equal(tcodec.decode(data), a)
    np.testing.assert_array_equal(tcodec.decode(data), jcodec.decode(data))


def test_encode_2d_is_one_channel():
    a = _arr(1)[:, :, 0]
    assert tcodec.encode(a, "png") == jcodec.encode(a, "png")


@pytest.mark.parametrize("c", [2, 4])
def test_pnm_with_alpha_raises_in_both(c, tmp_path, no_pil):
    with pytest.raises(jcodec.NativeCodecError):
        jcodec.encode(_arr(c), "pnm")
    with pytest.raises(LqrImageError, match="PNM"):
        tcodec.encode(_arr(c), "pnm")
    with pytest.raises(LqrImageError, match="a.ppm"):
        save_image(str(tmp_path / "a.ppm"), _arr(c))
    assert not (tmp_path / "a.ppm").exists()


@pytest.mark.parametrize("cut", ["truncated", "bad_idat", "not_png"])
def test_corrupt_png_raises_without_pillow(cut, tmp_path, no_pil):
    data = bytearray(tcodec.encode(_arr(3), "png"))
    if cut == "truncated":
        data = data[:len(data) // 2]
    elif cut == "bad_idat":
        i = data.index(b"IDAT") + 8
        data[i:i + 16] = b"\xff" * 16
    else:
        data[1:4] = b"JPG"
    p = tmp_path / "bad.png"
    p.write_bytes(bytes(data))
    with pytest.raises(LqrImageError, match="bad.png"):
        load_image(str(p))
    with pytest.raises(jcodec.NativeCodecError):
        jcodec.decode(bytes(data))


def test_palette_png_is_refused_not_converted(tmp_path, no_pil):
    """A palette PNG is a variant the codec does not read: JAX's image_io
    hands it to Pillow, the port raises."""
    data = bytearray(tcodec.encode(_arr(3), "png"))
    data[25] = 3                     # IHDR colour type: palette
    p = tmp_path / "pal.png"
    p.write_bytes(bytes(data))
    with pytest.raises(LqrImageError, match="unsupported PNG"):
        load_image(str(p))


@pytest.mark.parametrize("name", ["a.png", "a.ppm", "a.pgm", "a.pnm"])
def test_file_roundtrip_without_pillow(name, tmp_path, no_pil):
    a = _arr(3 if name in ("a.png", "a.ppm") else 1)
    save_image(str(tmp_path / name), a)
    np.testing.assert_array_equal(load_image(str(tmp_path / name)), a)


def test_other_formats_need_pillow(tmp_path, no_pil):
    with pytest.raises(LqrImageError, match="Pillow"):
        save_image(str(tmp_path / "a.jpg"), _arr(3))
    (tmp_path / "b.tif").write_bytes(b"II*\x00")
    with pytest.raises(LqrImageError, match="Pillow"):
        load_image(str(tmp_path / "b.tif"))
