"""Minimal OpenEXR scanline codec (read + write), the port's own copy of
the JAX package's ``data/exr.py`` with the same limits: single-part
scanline images, HALF/FLOAT/UINT channels, NO_COMPRESSION / ZIPS / ZIP
compression (zlib), read to [H, W, C] float32 with the channels ordered
RGBA; ``write_exr`` writes uncompressed FLOAT. No EXR library is on the
card's machine.

Format reference: the public OpenEXR file layout specification
(openexr.com/en/latest/OpenEXRFileLayout.html).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}  # UINT/HALF/FLOAT
_COMPRESSION_SCANLINES = {0: 1, 2: 1, 3: 16}  # NONE / ZIPS / ZIP


def _read_null_str(buf, pos):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_channels(data: bytes) -> List[Tuple[str, int]]:
    """chlist attribute -> [(name, pixel_type), ...] in file order."""
    channels = []
    pos = 0
    while data[pos] != 0:
        name, pos = _read_null_str(data, pos)
        pixel_type, = struct.unpack_from("<i", data, pos)
        pos += 16  # pixel type, pLinear+reserved, xSampling, ySampling
        channels.append((name, pixel_type))
    return channels


def _unzip(data: bytes) -> bytes:
    """EXR zip: zlib inflate, then un-delta + de-interleave halves."""
    raw = zlib.decompress(data)
    # Reverse the delta predictor: stored byte ≡ delta + 128 (mod 256).
    arr = np.frombuffer(raw, np.uint8).astype(np.int64)
    arr = np.cumsum(np.concatenate([arr[:1], arr[1:] - 128]))
    arr = (arr % 256).astype(np.uint8)
    # Reverse the two-way interleave.
    half = (len(arr) + 1) // 2
    out = np.zeros_like(arr)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR into [H, W, C] float32 (RGBA channel order)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path} is not an EXR file")
    if version & 0x200:
        raise NotImplementedError("multi-part EXR not supported")
    if version & 0x800:
        raise NotImplementedError("deep EXR not supported")

    pos = 8
    attrs: Dict[str, bytes] = {}
    while buf[pos] != 0:
        name, pos = _read_null_str(buf, pos)
        _type, pos = _read_null_str(buf, pos)
        size, = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = buf[pos : pos + size]
        pos += size
    pos += 1  # header terminator

    channels = _parse_channels(attrs["channels"])
    compression = attrs["compression"][0]
    if compression not in _COMPRESSION_SCANLINES:
        raise NotImplementedError(
            f"EXR compression {compression} not supported (NONE/ZIPS/ZIP only)"
        )
    lines_per_block = _COMPRESSION_SCANLINES[compression]
    x_min, y_min, x_max, y_max = struct.unpack("<4i", attrs["dataWindow"])
    width = x_max - x_min + 1
    height = y_max - y_min + 1

    n_blocks = (height + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, pos)

    bytes_per_px = {0: 4, 1: 2, 2: 4}
    line_bytes = sum(width * bytes_per_px[t] for _, t in channels)

    out = {name: np.zeros((height, width), np.float32) for name, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + size]
        n_lines = min(lines_per_block, y_max - y + 1)
        if compression != 0 and size < n_lines * line_bytes:
            data = _unzip(data)
        p = 0
        for line in range(n_lines):
            yy = y - y_min + line
            for name, ptype in sorted(channels):
                dt = _PIXEL_DTYPES[ptype]
                nbytes = width * np.dtype(dt).itemsize
                row = np.frombuffer(data[p : p + nbytes], dt)
                out[name][yy] = row.astype(np.float32)
                p += nbytes

    order = [c for c in ("R", "G", "B", "A") if c in out]
    order += [name for name, _ in channels if name not in ("R", "G", "B", "A")]
    return np.stack([out[c] for c in order], axis=-1)


def write_exr(path: str, image: np.ndarray):
    """Write [H, W, C<=4] float32 as an uncompressed FLOAT scanline EXR."""
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    names = ["R", "G", "B", "A"][:c] if c <= 4 else [f"c{i}" for i in range(c)]

    def attr(name, type_, payload):
        return (
            name.encode() + b"\x00" + type_.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload
        )

    chlist = b""
    for name in sorted(names):
        chlist += name.encode() + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
    chlist += b"\x00"

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join([
        attr("channels", "chlist", chlist),
        attr("compression", "compression", b"\x00"),
        attr("dataWindow", "box2i", box),
        attr("displayWindow", "box2i", box),
        attr("lineOrder", "lineOrder", b"\x00"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    ]) + b"\x00"

    preamble = struct.pack("<ii", MAGIC, 2) + header
    offset_table_pos = len(preamble)
    first_block = offset_table_pos + 8 * h

    line_bytes = w * 4 * c
    block_size = 8 + line_bytes
    offsets = struct.pack(f"<{h}q", *[first_block + i * block_size for i in range(h)])

    chan_order = np.argsort(np.array(names))
    blocks = []
    for y in range(h):
        row = image[y][:, chan_order].T  # [C, W] in sorted-name order
        blocks.append(struct.pack("<ii", y, line_bytes) + row.tobytes())

    with open(path, "wb") as f:
        f.write(preamble + offsets + b"".join(blocks))
