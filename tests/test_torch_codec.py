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


# -- the host's buffer marshalling: stage_wave, (de)interleave; placement


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("pad", [(0, 0), (5, 0), (0, 7), (3, 9)])
def test_stage_wave_byte_equal_to_jax(c, pad):
    """Shifts of 0, in range, past h and w, and negative; the padding past
    the image zeroed in both."""
    h, w = 13, 21
    base = _arr(c, h, w, seed=7)
    dys = np.array([0, 1, h - 1, h, h + 4, 3 * h + 2, -1, -h - 5], np.int32)
    dxs = np.array([0, w - 1, 2, w + 3, w, -2, 5 * w + 1, 0], np.int32)
    out_h, out_w = h + pad[0], w + pad[1]
    got = tcodec.stage_wave(base, dys, dxs, out_h, out_w)
    want = jcodec.stage_wave(base, dys, dxs, out_h, out_w)
    assert got.shape == (len(dys), out_h, out_w, c) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    for i, (dy, dx) in enumerate(zip(dys, dxs)):
        np.testing.assert_array_equal(
            got[i, :h, :w], np.roll(base, (int(dy), int(dx)), axis=(0, 1)))
    assert not got[:, h:].any() and not got[:, :, w:].any()
    # into a caller's buffer, a 2-D base as one channel
    buf = np.full((len(dys), out_h, out_w, c), 7, np.uint8)
    assert tcodec.stage_wave(base, dys, dxs, out_h, out_w, out=buf) is buf
    np.testing.assert_array_equal(buf, want)
    if c == 1:
        np.testing.assert_array_equal(
            tcodec.stage_wave(base[:, :, 0], dys, dxs, out_h, out_w), want)


def test_stage_wave_refuses_bad_arguments():
    base = _arr(3, 8, 10)
    for args in ((base, [0, 1], [0], 8, 10),       # unequal shift counts
                 (base, [0], [0], 7, 10),          # buffer shorter
                 (base, [0], [0], 8, 9),           # buffer narrower
                 (base[:0], [0], [0], 8, 10)):     # empty image
        with pytest.raises(tcodec.NativeCodecError):
            tcodec.stage_wave(*args)
    for out in (np.zeros((1, 8, 10, 3), np.float32),
                np.zeros((1, 8, 10, 4), np.uint8),
                np.zeros((1, 8, 20, 3), np.uint8)[:, :, ::2]):
        with pytest.raises(tcodec.NativeCodecError, match="buffer"):
            tcodec.stage_wave(base, [0], [0], 8, 10, out=out)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_interleave_round_trip_equal_to_jax(c):
    a = _arr(c, 11, 17)
    planes = tcodec.deinterleave(a)
    np.testing.assert_array_equal(planes, jcodec.deinterleave(a))
    np.testing.assert_array_equal(planes, np.moveaxis(a, 2, 0))
    back = tcodec.interleave(planes)
    np.testing.assert_array_equal(back, jcodec.interleave(planes))
    np.testing.assert_array_equal(back, a)
    with pytest.raises(tcodec.NativeCodecError):
        tcodec.interleave(planes[0])


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_place_mask_equal_to_jax_and_numpy(c):
    """The port's placement (ops.place_mask, on the CPU) against lqr_tpu's
    native codec and place_mask_numpy: inside, negative and clipping
    offsets, wholly outside; factors; a sum into a plane held, which is
    only read."""
    from lqr_tpu_torch.carver import place_mask_numpy
    from lqr_tpu_torch.ops.place_mask import place_mask
    mask = _arr(c, 9, 14, seed=3)
    m, one = torch.from_numpy(mask), np.float32(1.0)
    H, W = 20, 30
    for x_off, y_off in ((3, 2), (-4, -3), (25, 15), (-13, 19), (-20, 0),
                         (0, 40), (17, -8)):
        got = place_mask(m, H, W, x_off, y_off, one).numpy()
        assert got.dtype == np.float32 and got.shape == (H, W)
        np.testing.assert_array_equal(
            got, jcodec.place_mask(mask, H, W, x_off, y_off))
        np.testing.assert_array_equal(
            got, place_mask_numpy(mask, H, W, x_off, y_off))
        for factor in (-0.8, 2.5, 1000.0):
            acc = place_mask(m, H, W, 1, 1, one)
            held = acc.clone()
            want = jcodec.place_mask(mask, H, W, 1, 1)
            jcodec.place_mask(mask, H, W, x_off, y_off, factor, out=want)
            np.testing.assert_array_equal(
                place_mask(m, H, W, x_off, y_off, np.float32(factor),
                           acc).numpy(), want)
            assert torch.equal(acc, held)
    if c == 1:
        np.testing.assert_array_equal(
            place_mask_numpy(mask[:, :, 0], H, W, 2, 3),
            jcodec.place_mask(mask[:, :, 0], H, W, 2, 3))


def test_native_codec_error_is_an_lqr_image_error():
    assert issubclass(tcodec.NativeCodecError, LqrImageError)
    for fn in (lambda: tcodec.decode(b"not an image"),
               lambda: tcodec.interleave(np.zeros((4, 4), np.uint8))):
        try:
            fn()
        except LqrImageError as e:
            assert type(e) is tcodec.NativeCodecError
        else:
            raise AssertionError("no error raised")
