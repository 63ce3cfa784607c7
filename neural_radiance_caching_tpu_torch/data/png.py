"""PNG decoder in numpy and the standard library's zlib.

The JAX package opens PNGs through PIL (``data/io.load_img``), which the
card's machine does not have. ``read_png`` returns the array that
``np.array(PIL.Image.open(path))`` gives for the files the loaders read:
non-interlaced greyscale, RGB, greyscale + alpha and RGBA images (colour
types 0, 2, 4 and 6) at 8 and 16 bits per sample. At 16 bits it follows
PIL's modes: a greyscale file keeps its full values (mode ``I;16``, uint16);
RGB and RGBA files keep each sample's high byte (uint8); a greyscale +
alpha file becomes RGBA of high bytes, the grey repeated into three
channels. Ancillary chunks are ignored, as PIL ignores them for pixel
values. Palettes, bit depths under 8 and Adam7 interlace raise a ValueError
that names them.

Format reference: the W3C PNG specification (scanline filters, section 9).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples per pixel of each supported colour type.
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def _header(buf, name):
    if buf[:8] != SIGNATURE:
        raise ValueError(f"{name} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(buf):
        length, kind = struct.unpack_from(">I4s", buf, pos)
        data = buf[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name} has no IHDR chunk")
    return header, b"".join(idat)


def decode_png(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """The pixels of a PNG file's bytes, as PIL's array of it."""
    (width, height, depth, color, _, _, interlace), idat = _header(buf, name)
    if color == 3:
        raise ValueError(f"{name}: palette PNGs (colour type 3) are not supported")
    if color not in CHANNELS:
        raise ValueError(f"{name}: unknown PNG colour type {color}")
    if depth not in (8, 16):
        raise ValueError(f"{name}: PNG bit depth {depth} is not supported (8 and 16 only)")
    if interlace:
        raise ValueError(f"{name}: Adam7-interlaced PNGs are not supported")
    bpp = CHANNELS[color] * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    pixels = unfilter(rows[:, 0], rows[:, 1:], bpp).reshape(height, width, -1)
    if depth == 8:
        return pixels[..., 0] if color == 0 else pixels
    if color == 0:
        return (pixels[..., 0].astype(np.uint16) << 8) | pixels[..., 1]
    high = pixels[..., 0::2]
    if color == 4:  # grey + alpha -> RGBA
        return np.concatenate([high[..., :1].repeat(3, -1), high[..., 1:]], -1)
    return np.ascontiguousarray(high)


def unfilter(types, data, bpp):
    """Undo each scanline's filter: `types` [H] (0 None, 1 Sub, 2 Up, 3
    Average, 4 Paeth), `data` [H, stride] filtered bytes, `bpp` bytes per
    pixel; returns the [H, stride] uint8 raw bytes. Without a loop over
    pixels: the Average and Paeth predictors read the pixel to the left,
    the one above and the one above-left, so the pixels of one
    anti-diagonal (row + column constant) depend only on the two diagonals
    before it. The rows are skewed so that each anti-diagonal is a
    contiguous slice, and one step decodes a whole diagonal: height + width
    - 1 steps, each over every row at once."""
    if len(types) and int(types.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(types.max())}")
    height, stride = data.shape
    width = stride // bpp
    # skew[c, r]: pixel c - r - 1 of image row r - 1, so that each
    # anti-diagonal is a contiguous slice; row 0 and the pixels left of each
    # row stay 0 (the filters' neighbours outside the image).
    skew = np.zeros((height + width + 1, height + 1, bpp), np.int16)
    filtered = np.zeros_like(skew)
    _image_view(filtered)[...] = data.reshape(height, width, bpp)
    # Each row's filter as 0/1 weights of the four predictors (Sub, Up,
    # Average, Paeth) over the pixel's bytes: products and sums of
    # same-shape arrays cost the fewest numpy calls (no broadcast, no
    # select, numpy scalars).
    weights = np.zeros((5, height + 1, bpp), np.int16)
    weights[types, np.arange(1, height + 1)] = 1
    sub, up, avg, paeth = weights[1:]
    one, mask = np.int16(1), np.int16(0xFF)
    for d in range(height + width - 1):
        lo, hi = max(0, d - width + 1) + 1, min(height - 1, d) + 2
        a = skew[d + 1, lo:hi]
        b = skew[d + 1, lo - 1:hi - 1]
        c = skew[d, lo - 1:hi - 1]
        da, db = a - c, b - c
        pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
        # Paeth: a where pa is least, else b where pb <= pc, else c.
        nearest = c + (pb <= pc) * db
        nearest += ((pa <= pb) & (pa <= pc)) * (a - nearest)
        pred = (sub[lo:hi] * a + up[lo:hi] * b + avg[lo:hi] * ((a + b) >> one)
                + paeth[lo:hi] * nearest)
        skew[d + 2, lo:hi] = (filtered[d + 2, lo:hi] + pred) & mask
    return _image_view(skew).astype(np.uint8).reshape(height, stride)


def _image_view(skew):
    """The [H, W, bpp] image inside a skewed [H + W + 1, H + 1, bpp] array:
    row y, pixel x at skew[x + y + 2, y + 1]."""
    columns, rows, bpp = skew.shape
    item = skew.itemsize
    return np.lib.stride_tricks.as_strided(
        skew.reshape(-1)[(2 * rows + 1) * bpp:], shape=(rows - 1, columns - rows, bpp),
        strides=((rows + 1) * bpp * item, rows * bpp * item, item))
