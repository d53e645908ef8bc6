"""The port's PNG codec (diffusionremotesensing_tpu_torch/png.py) against
PIL: images PIL writes in every colour type it writes (grey, RGB, palette
at 1, 2, 4 and 8 bits, grey + alpha, RGBA, 16-bit grey, 1-bit grey) decode
exactly to what PIL reads; 16-bit RGB and RGBA (written by OpenCV) to
what OpenCV reads and, in their high byte, to what PIL reads; grey at 2 and
4 bits and each of the five row filters in files written here, decoded as
PIL decodes them; PIL reads back exactly what the port encodes. Corrupt
CRCs and interlaced images are refused."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from diffusionremotesensing_tpu_torch.png import decode_png, encode_png, is_png, read_png


def _pil_png(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _pil_read(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _image(h, w, c, seed):
    """Noise with smooth and flat regions, so PIL's adaptive row filters
    pick among all five."""
    rng = np.random.default_rng(seed)
    a = (rng.random((h, w, c)) * 255).astype(np.uint8)
    a[: h // 3] = (np.arange(w)[None, :, None] * 3 + np.arange(c)) % 256
    a[h // 3: h // 2] = 77
    a[:, : w // 4] = np.arange(h)[:, None, None] * 5 % 256
    return a


@pytest.mark.parametrize("mode,c", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
@pytest.mark.parametrize("shape", [(37, 53), (1, 5), (64, 64)])
def test_decodes_pil_written_8_bit_exactly(mode, c, shape):
    a = _image(*shape, c, seed=c)
    im = Image.fromarray(a[..., 0] if c == 1 else a, mode)
    data = _pil_png(im)
    np.testing.assert_array_equal(decode_png(data), _pil_read(data))


@pytest.mark.parametrize("colors", [2, 4, 16, 200])
@pytest.mark.parametrize("trns", [False, True])
def test_decodes_pil_written_palette_at_every_depth(colors, trns):
    rng = np.random.default_rng(colors)
    im = Image.fromarray((rng.integers(0, colors, (23, 31))).astype(np.uint8), "P")
    im.putpalette(list(rng.integers(0, 256, 3 * colors)))
    kw = {"transparency": bytes(range(0, 256, 256 // colors))[:colors // 2 + 1]} if trns else {}
    data = _pil_png(im, **kw)
    depth = read_png(data).bit_depth
    assert depth == {2: 1, 4: 2, 16: 4, 200: 8}[colors]
    want = Image.open(io.BytesIO(data)).convert("RGBA" if trns else "RGB")
    np.testing.assert_array_equal(decode_png(data), np.asarray(want))


def test_decodes_pil_written_16_bit_and_1_bit_grey():
    a = (np.random.default_rng(5).random((19, 33)) * 65535).astype(np.uint16)
    data = _pil_png(Image.fromarray(a))
    got = decode_png(data)
    assert got.dtype == np.uint16 and read_png(data).bit_depth == 16
    np.testing.assert_array_equal(got, _pil_read(data))
    b = Image.fromarray(a[:, :30] > 30000)
    data = _pil_png(b)
    assert read_png(data).bit_depth == 1
    np.testing.assert_array_equal(decode_png(data), np.asarray(Image.open(io.BytesIO(data)).convert("L")))


@pytest.mark.parametrize("c", [3, 4])
def test_decodes_16_bit_rgb_and_rgba(c, tmp_path):
    import cv2

    a = (np.random.default_rng(c).random((14, 9, c)) * 65535).astype(np.uint16)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, a)
    data = open(path, "rb").read()
    got = decode_png(data)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., [2, 1, 0, 3][:c]])
    np.testing.assert_array_equal(got >> 8, _pil_read(data))


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(rows, bpp, kinds):
    """PNG-filter uint8 rows (H, stride), row r under kinds[r]."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for r, k in enumerate(kinds):
        x = rows[r].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if k == 0:
            pred = 0
        elif k == 1:
            pred = a
        elif k == 2:
            pred = prev
        elif k == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - ul
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, ul))
        out.append(np.concatenate([[k], (x - pred) % 256]).astype(np.uint8))
        prev = x
    return np.stack(out)


def _write_png(rows, w, h, depth, ctype, kinds, bpp, interlace=0):
    raw = _filter_rows(rows, bpp, kinds)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                                interlace))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [[0] * 12, [1] * 12, [2] * 12, [3] * 12, [4] * 12,
                                   [0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 4, 1]])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_each_row_filter_decodes_as_pil_decodes_it(kinds, c):
    a = _image(12, 17, c, seed=len(set(kinds)) + c)
    data = _write_png(a.reshape(12, -1), 17, 12, 8, {1: 0, 3: 2, 4: 6}[c], kinds, c)
    np.testing.assert_array_equal(decode_png(data), _pil_read(data))


@pytest.mark.parametrize("depth", [2, 4])
def test_grey_below_8_bits_decodes_as_pil_decodes_it(depth):
    w, h = 13, 7
    v = np.random.default_rng(depth).integers(0, 1 << depth, (h, w))
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.int64)
    padded[:, :w] = v
    packed = sum(padded[:, i::per] << (8 - depth * (i + 1)) for i in range(per)).astype(np.uint8)
    data = _write_png(packed, w, h, depth, 0, [1, 4, 3, 0, 2, 4, 3], 1)
    np.testing.assert_array_equal(decode_png(data), _pil_read(data))
    assert read_png(data).samples.max() < (1 << depth)


@pytest.mark.parametrize("shape", [(30, 41), (30, 41, 1), (8, 3, 2), (30, 41, 3), (5, 64, 4)])
def test_pil_reads_back_what_the_port_encodes(shape):
    a = _image(*shape[:2], shape[2] if len(shape) == 3 else 1, seed=7)
    a = a.reshape(shape)
    data = encode_png(a)
    assert is_png(data)
    got = _pil_read(data)
    np.testing.assert_array_equal(got, a[..., 0] if a.ndim == 3 and a.shape[2] == 1 else a)
    np.testing.assert_array_equal(decode_png(data), got)


def test_encode_refuses_other_dtypes_and_shapes():
    with pytest.raises(TypeError):
        encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 5), np.uint8))


def test_a_corrupt_crc_and_an_interlaced_image_are_refused():
    data = bytearray(encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[20] ^= 1  # inside IHDR
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
    a = np.zeros((4, 4), np.uint8)
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(_write_png(a, 4, 4, 8, 0, [0] * 4, 1, interlace=1))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + bytes(20))
