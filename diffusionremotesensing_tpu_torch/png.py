"""PNG decoding and encoding on the standard library's ``zlib`` and
``struct`` and numpy, for machines without PIL.

``decode_png`` reads every colour type (grey, RGB, palette, grey + alpha,
RGBA) at bit depths 8 and 16, and 1, 2 and 4 for grey and palette, through
all five row filters; every chunk's CRC is checked. Interlaced (Adam7)
images are refused. ``encode_png`` writes uint8 grey, grey + alpha, RGB and
RGBA images, each row under the Up filter.

Example:
    arr = decode_png(open("tile.png", "rb").read())   # (H, W) or (H, W, C)
    open("out.png", "wb").write(encode_png(arr))
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

__all__ = ["PngImage", "is_png", "read_png", "decode_png", "encode_png"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # samples a pixel, by colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


class PngImage(NamedTuple):
    """A PNG as stored: ``samples`` is (H, W, channels of the colour type),
    uint8 (uint16 at depth 16) at the file's own scale (palette indices for
    colour type 3, grey values below 2**bit_depth); ``palette`` (N, 3)
    uint8 and ``trns`` (the tRNS chunk's bytes) where the file has them."""

    samples: np.ndarray
    color_type: int
    bit_depth: int
    palette: Optional[np.ndarray]
    trns: Optional[bytes]


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes):
    if not is_png(data):
        raise ValueError("not a PNG: the signature is missing")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of (height, 1 + stride) bytes; bytes (height,
    stride). Rows under None, Sub and Up are undone a row at a time; an
    image with an Average or Paeth row is undone along anti-diagonals of
    pixels, each of which depends only on the two before it."""
    rows = raw.reshape(height, 1 + stride)
    kinds, f = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of 0-4")
    units = stride // bpp
    if not np.isin(kinds, (3, 4)).any():
        out = np.empty_like(f)
        prev = np.zeros(stride, np.uint8)
        for r in range(height):
            k = kinds[r]
            if k == 1:
                out[r] = np.cumsum(f[r].reshape(units, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif k == 2:
                out[r] = f[r] + prev
            else:
                out[r] = f[r]
            prev = out[r]
        return out
    # a padded canvas: row 0 and column 0 are the zeros the filters read
    # beyond the image's top and left edges
    x = np.zeros((height + 1, units + 1, bpp), np.int32)
    fu = f.reshape(height, units, bpp).astype(np.int32)
    kind_of = kinds.astype(np.int32)
    for d in range(height + units - 1):
        r = np.arange(max(0, d - units + 1), min(height, d + 1))
        c = d - r
        a, b, ul = x[r + 1, c], x[r, c + 1], x[r, c]
        k = kind_of[r][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, ul), 0))))
        x[r + 1, c + 1] = (fu[r, c] + pred) & 255
    return x[1:, 1:].astype(np.uint8).reshape(height, stride)


def read_png(data: bytes) -> PngImage:
    """Parse and decompress a PNG into its stored samples (see PngImage)."""
    header, idat, palette, trns = None, [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, ctype, compression, filtering, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} is not valid")
    if compression != 0 or filtering != 0:
        raise ValueError(f"PNG compression {compression} / filter method {filtering} unknown")
    if interlace != 0:
        raise ValueError("interlaced (Adam7) PNG images are not supported")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG has no PLTE chunk")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + stride):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected {height * (1 + stride)}")
    rows = _unfilter(raw, height, stride, max(1, bits // 8))
    if depth == 16:
        samples = rows.reshape(height, -1).view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = rows
    else:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(height, stride * per)
        samples = samples[:, :width * channels]
    return PngImage(np.ascontiguousarray(samples.reshape(height, width, channels)), ctype, depth,
                    palette, trns)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG's pixels as PIL holds them in its ``L``, ``LA``, ``RGB`` and
    ``RGBA`` modes: (H, W) for grey, else (H, W, C). uint8, uint16 at bit
    depth 16. Grey below 8 bits is scaled to 0-255 (2 bits x 85, 4 bits x
    17, 1 bit x 255); a palette image becomes RGB, RGBA where it has a
    tRNS chunk (entries past its end opaque)."""
    png = read_png(data)
    s = png.samples
    if png.color_type == 3:
        idx = s[..., 0]
        if png.trns is not None:
            alpha = np.full(len(png.palette), 255, np.uint8)
            t = np.frombuffer(png.trns, np.uint8)[:len(alpha)]
            alpha[:len(t)] = t
            return np.concatenate([png.palette, alpha[:, None]], axis=1)[idx]
        return png.palette[idx]
    if png.color_type == 0:
        s = s[..., 0]
        if png.bit_depth < 8:
            s = (s * (255 // ((1 << png.bit_depth) - 1))).astype(np.uint8)
    return s


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W) or (H, W, C) with C in 1-4 (grey, grey + alpha, RGB,
    RGBA) -> the bytes of an 8-bit PNG, every row under the Up filter."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8 images, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in (1, 2, 3, 4) or 0 in arr.shape[:2]:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 1-4) images, got {arr.shape}")
    h, w, c = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = arr.reshape(h, w * c)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 arithmetic wraps, as the filter's does
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))
