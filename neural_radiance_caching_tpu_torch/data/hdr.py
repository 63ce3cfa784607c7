"""Radiance RGBE (``.hdr``) reader: what OpenCV's ``imdecode`` followed by a
BGR-to-RGB conversion gives the JAX package (``data/io.read_hdr``), bit for
bit, without OpenCV (the card's machine has none).

The file is a text header and the pixels (OpenCV's ``rgbe.cpp``, after
Bruce Walter's reader):
- The header's first line begins ``#?RADIANCE`` or ``#?RGBE``. Lines are read
  as C's ``fgets`` reads them into a 128-byte buffer, up to ``FORMAT=32-bit_rle_rgbe``.
  An empty line before it is an error. The line after it must be empty. The
  next one gives the size as ``-Y <height> +X <width>`` (top to bottom, left
  to right; no other orientation is read).
- Each scanline is run-length encoded in the new style (the marker bytes 2,
  2 and the width, then each of the four channels in runs: a count above
  128 repeats the next byte count - 128 times, else the count's bytes
  follow), or flat (4 bytes a pixel). The first scanline whose marker is
  not the new style's, and everything after it, is read flat, as is a file
  whose width is under 8 or above 32767.
- A pixel (r, g, b, e) is (r, g, b) * 2^(e - 136) in float32, and 0 where
  e is 0.
"""

from __future__ import annotations

import re

import numpy as np

SIGNATURES = (b"#?RADIANCE", b"#?RGBE")
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_SIZE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")


def _fgets(data, pos, size=128):
    """(line, next position) as fgets reads at most size - 1 bytes up to
    and including a newline; (b"", pos) at the end of the data."""
    end = data.find(b"\n", pos, pos + size - 1)
    end = min(pos + size - 1, len(data)) if end < 0 else end + 1
    return data[pos:end], end


def _read_header(data, path):
    """(height, width, offset of the pixels)."""
    if not data.startswith(SIGNATURES):
        raise ValueError(f"{path}: not a Radiance HDR file")
    line, pos = _fgets(data, 0)
    while line != _FORMAT:
        if line in (b"", b"\n"):
            raise ValueError(f"{path}: no FORMAT=32-bit_rle_rgbe line in the header")
        line, pos = _fgets(data, pos)
        if not line:
            raise ValueError(f"{path}: the header ends before its FORMAT line")
    line, pos = _fgets(data, pos)
    if line != b"\n":
        raise ValueError(f"{path}: no empty line after the FORMAT line")
    line, pos = _fgets(data, pos)
    size = _SIZE.match(line)
    if size is None:
        raise ValueError(f"{path}: no '-Y <height> +X <width>' size line (another "
                         "orientation is not read)")
    return int(size.group(1)), int(size.group(2)), pos


def _rle_scanline(data, pos, width, path):
    """One new-style run-length encoded scanline after its 4 marker bytes:
    ([4, width] uint8 planes, next position)."""
    planes = np.empty(4 * width, np.uint8)
    view = memoryview(data)
    ptr = 0
    for channel in range(4):
        end = (channel + 1) * width
        while ptr < end:
            if pos + 2 > len(data):
                raise ValueError(f"{path}: the pixels end inside a scanline")
            count, value = data[pos], data[pos + 1]
            pos += 2
            if count > 128:
                count -= 128
                if count > end - ptr:
                    raise ValueError(f"{path}: bad scanline data")
                planes[ptr:ptr + count] = value
                ptr += count
            else:
                if count == 0 or count > end - ptr:
                    raise ValueError(f"{path}: bad scanline data")
                planes[ptr] = value
                rest = count - 1
                if rest:
                    if pos + rest > len(data):
                        raise ValueError(f"{path}: the pixels end inside a scanline")
                    planes[ptr + 1:ptr + count] = np.frombuffer(view[pos:pos + rest], np.uint8)
                    pos += rest
                ptr += count
    return planes.reshape(4, width), pos


def _to_float(rgbe):
    """[..., 4] uint8 RGBE -> [..., 3] float32 (rgbe2float)."""
    e = rgbe[..., 3].astype(np.int64)
    f = np.ldexp(1.0, e - 136).astype(np.float32)
    rgb = rgbe[..., :3].astype(np.float32) * f[..., None]
    return np.where(e[..., None] > 0, rgb, np.float32(0.0))


def decode_hdr(data, path="<bytes>"):
    """The float32 RGB image [height, width, 3] of a Radiance HDR file's
    bytes."""
    data = bytes(data)
    height, width, pos = _read_header(data, path)
    rgbe = np.zeros((height * width, 4), np.uint8)
    done = 0
    if 8 <= width <= 0x7FFF:
        for _ in range(height):
            marker = data[pos:pos + 4]
            if len(marker) < 4:
                raise ValueError(f"{path}: the pixels end early")
            if marker[0] != 2 or marker[1] != 2 or marker[2] & 0x80:
                break  # not run-length encoded: the rest is flat
            if (marker[2] << 8 | marker[3]) != width:
                raise ValueError(f"{path}: wrong scanline width")
            planes, pos = _rle_scanline(data, pos + 4, width, path)
            rgbe[done:done + width] = planes.T
            done += width
    flat = height * width - done
    if flat:
        if pos + 4 * flat > len(data):
            raise ValueError(f"{path}: the pixels end early")
        rgbe[done:] = np.frombuffer(data, np.uint8, 4 * flat, pos).reshape(flat, 4)
    return _to_float(rgbe.reshape(height, width, 4))


def read_hdr(path):
    """The float32 RGB image of the Radiance HDR file at `path`."""
    with open(path, "rb") as f:
        return decode_hdr(f.read(), path)
