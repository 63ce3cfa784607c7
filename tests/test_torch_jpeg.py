"""The port's baseline JPEG decoder (`data/jpeg.py`, its entropy decoding in
`csrc/jpeg_entropy.c`) against PIL, which reads every JPEG for the JAX
package, on files PIL and OpenCV write from numpy seeds; and against
`chip_smoke.py`'s own JPEG writer (the card's machine has no PIL).

Tolerances: every decoded array equals PIL's bit for bit (PIL 12.1 decodes
through libjpeg-turbo: ISLOW integer IDCT, fancy upsampling, fixed-point
YCbCr -> RGB, which the port reproduces), on every case here. The C
decoder's coefficient blocks equal the writer's quantised coefficients
exactly. The decoded pixels sit within `chip_smoke.JPEG_FLOAT_TOL` (3
levels) of the writer's float reconstruction, the integer pipeline rounding
once per stage.
"""

import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from neural_radiance_caching_tpu_torch.data import io as io_lib
from neural_radiance_caching_tpu_torch.data import jpeg

SIZES = [(1, 1), (7, 5), (17, 33), (40, 29)]


def _image(h, w, seed, channels=3):
    """Smooth ramps with a fifth of the pixels noise: both the long runs of
    zero AC coefficients and the dense blocks."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    smooth = np.stack([(x * 3 + y * (k + 2)) % 256 for k in range(channels)], -1)
    img = np.where(rng.rand(h, w, 1) < 0.2, rng.randint(0, 256, smooth.shape), smooth)
    img = img.astype(np.uint8)
    return img if channels == 3 else img[..., 0]


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _equal_to_pil(buf):
    want = np.array(Image.open(io.BytesIO(buf)))
    got = jpeg.decode_jpeg(buf)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_decoder_equals_pil(quality, subsampling, h, w):
    """PIL's files at each quality and chroma subsampling, on sizes that are
    not multiples of the MCU, down to 1 x 1."""
    _equal_to_pil(_pil_bytes(_image(h, w, quality + subsampling), quality=quality,
                             subsampling=subsampling))


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_decoder_equals_pil_on_optimized_tables(subsampling):
    """Per-file optimised Huffman tables (`optimize=True`)."""
    _equal_to_pil(_pil_bytes(_image(45, 61, 3), quality=90, subsampling=subsampling,
                             optimize=True))


@pytest.mark.parametrize("h,w", SIZES)
def test_decoder_equals_pil_on_grey(h, w):
    _equal_to_pil(_pil_bytes(_image(h, w, 5, channels=1), quality=85))


@pytest.mark.parametrize("h,w", SIZES)
def test_decoder_equals_pil_on_440(h, w):
    """4:4:0 (vertical chroma halving, libjpeg's h1v2 fancy upsampling), as
    OpenCV writes it."""
    ok, buf = cv2.imencode(".jpg", _image(h, w, 9), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
        cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    _equal_to_pil(buf.tobytes())


@pytest.mark.parametrize("interval", [1, 2, 5])
@pytest.mark.parametrize("factor", ["420", "422"])
def test_decoder_equals_pil_with_restart_markers(interval, factor):
    """Restart intervals (RST0-7, the DC predictors reset at each), as
    OpenCV writes them."""
    ok, buf = cv2.imencode(".jpg", _image(37, 70, interval), [
        cv2.IMWRITE_JPEG_RST_INTERVAL, interval, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}"), cv2.IMWRITE_JPEG_QUALITY, 80])
    assert ok
    buf = buf.tobytes()
    assert b"\xff\xdd" in buf and b"\xff\xd0" in buf
    _equal_to_pil(buf)


def test_decoder_equals_pil_on_16bit_tables():
    """Quantisation tables written with 16-bit entries (Pq = 1)."""
    buf = _pil_bytes(_image(24, 24, 2), quality=60)
    pos = buf.index(b"\xff\xdb")
    length = int.from_bytes(buf[pos + 2:pos + 4], "big")
    seg = buf[pos + 4:pos + 2 + length]
    tables, q = b"", 0
    while q < len(seg):
        tables += bytes([0x10 | seg[q] & 15]) + b"".join(
            int(v).to_bytes(2, "big") for v in seg[q + 1:q + 65])
        q += 65
    patched = (buf[:pos] + b"\xff\xdb" + (len(tables) + 2).to_bytes(2, "big") + tables
               + buf[pos + 2 + length:])
    _equal_to_pil(patched)
    np.testing.assert_array_equal(jpeg.decode_jpeg(patched), jpeg.decode_jpeg(buf))


@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "per_component"])
@pytest.mark.parametrize("restart", [0, 3])
def test_writer_coefficients_and_pil(interleaved, restart):
    """chip_smoke.py's writer (4:2:0, Annex K tables): the C decoder's
    coefficient blocks equal the writer's quantised coefficients (a scan per
    component codes only the blocks inside each component), PIL decodes the
    file to the port's array, and the pixels sit within the float
    reconstruction's tolerance."""
    h, w = 45, 70
    img = _image(h, w, 11)
    buf, coeffs, quant = chip_smoke.jpeg_encode(img, 90, restart, interleaved)
    frame = jpeg.decode_coefficients(buf)
    for comp, want in zip(frame.components, coeffs):
        rows, cols = (-(-n // 8) for n in frame.size(comp))
        if interleaved:
            np.testing.assert_array_equal(comp.blocks, want)
        else:
            np.testing.assert_array_equal(comp.blocks[:rows, :cols], want[:rows, :cols])
            assert not comp.blocks[rows:].any() and not comp.blocks[:, cols:].any()
    for comp, q in zip(frame.components, (quant[0], quant[1], quant[1])):
        np.testing.assert_array_equal(comp.quant, q)
    got = jpeg.pixels(frame)
    np.testing.assert_array_equal(got, np.array(Image.open(io.BytesIO(buf))))
    ref = np.clip(chip_smoke.jpeg_float_reference(coeffs, quant, h, w), 0, 255)
    assert np.abs(got - ref).max() <= chip_smoke.JPEG_FLOAT_TOL


def test_writer_tables_are_annex_k():
    """The writer's Huffman tables are the ones PIL writes without
    optimisation (T.81 Annex K.3), its quantisation tables libjpeg's at
    quality 75."""
    buf = _pil_bytes(_image(16, 16, 0), quality=75)
    frame = jpeg.decode_coefficients(buf)
    np.testing.assert_array_equal(frame.components[0].quant,
                                  chip_smoke.jpeg_qtable(chip_smoke.JPEG_LUMA_Q, 75))
    np.testing.assert_array_equal(frame.components[1].quant,
                                  chip_smoke.jpeg_qtable(chip_smoke.JPEG_CHROMA_Q, 75))
    pos, found = 2, {}
    while buf[pos + 1] != 0xDA:
        length = int.from_bytes(buf[pos + 2:pos + 4], "big")
        seg, q = buf[pos + 4:pos + 2 + length], 0
        while buf[pos + 1] == 0xC4 and q < len(seg):
            counts = tuple(seg[q + 1:q + 17])
            found[(seg[q] >> 4, seg[q] & 15)] = (counts, seg[q + 17:q + 17 + sum(counts)])
            q += 17 + sum(counts)
        pos += 2 + length
    assert found == chip_smoke.JPEG_HUFFMAN


def test_load_img_reads_jpeg_as_pil(tmp_path):
    """`io.load_img` finds a JPEG by its first bytes (any extension) and
    returns PIL's array as float32, as the JAX package's `load_img`."""
    path = tmp_path / "view.JPG"
    path.write_bytes(_pil_bytes(_image(30, 20, 4), quality=95))
    got = io_lib.load_img(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.array(Image.open(path), dtype=np.float32))


def _replace_segment(buf, marker, new_marker, payload):
    """`buf` with its first `marker` segment replaced by a `new_marker`
    segment of `payload`."""
    pos = buf.index(bytes([0xFF, marker]))
    length = int.from_bytes(buf[pos + 2:pos + 4], "big")
    return (buf[:pos] + bytes([0xFF, new_marker]) + (len(payload) + 2).to_bytes(2, "big")
            + payload + buf[pos + 2 + length:])


def _refused(name):
    base = _pil_bytes(_image(24, 32, 1), quality=90)
    sof = base.index(b"\xff\xc0")
    if name == "progressive":
        return _pil_bytes(_image(24, 32, 1), quality=90, progressive=True)
    if name in ("lossless", "arithmetic"):
        return base[:sof + 1] + (b"\xc3" if name == "lossless" else b"\xc9") + base[sof + 2:]
    if name == "12-bit":
        return base[:sof + 4] + b"\x0c" + base[sof + 5:]
    if name == "CMYK":
        buf = io.BytesIO()
        Image.fromarray(_image(24, 32, 1)).convert("CMYK").save(buf, "JPEG")
        return buf.getvalue()
    if name == "RGB":
        # An Adobe marker with transform 0 in place of the JFIF marker.
        return _replace_segment(base, 0xE0, 0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    if name == "sampling factors":
        ok, buf = cv2.imencode(".jpg", _image(24, 32, 1), [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
        return buf.tobytes()
    if name == "Huffman table":
        dht = base.index(b"\xff\xc4") + 5  # the first table's code counts
        return base[:dht] + b"\xff" * 16 + base[dht + 16:]
    if name == "truncated":
        return base[:len(base) // 2]
    if name == "not a JPEG":
        return b"GIF89a" + base[6:]
    raise KeyError(name)


REFUSALS = {"progressive": "progressive JPEG", "lossless": "lossless JPEG",
            "arithmetic": "arithmetic-coded JPEG", "12-bit": "12-bit JPEG",
            "CMYK": "CMYK JPEG", "RGB": "RGB JPEG", "sampling factors": "sampling factors 4x1",
            "Huffman table": "malformed JPEG Huffman table", "truncated": "truncated",
            "not a JPEG": "not a JPEG"}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_raise_by_name(name):
    """Progressive, lossless, arithmetic-coded, 12-bit, CMYK and RGB (Adobe
    transform 0) files, other sampling factors, a malformed Huffman table,
    truncated data and other formats raise a ValueError naming what they
    are."""
    with pytest.raises(ValueError, match=REFUSALS[name]):
        jpeg.decode_jpeg(_refused(name))


def test_truncated_scan_names_the_byte(tmp_path):
    """A scan cut short raises with the file and the byte offset."""
    buf = _pil_bytes(_image(64, 64, 3), quality=95)
    path = tmp_path / "cut.jpg"
    path.write_bytes(buf[:len(buf) - 300] + b"\xff\xd9")
    with pytest.raises(ValueError, match=r"cut\.jpg: JPEG scan data: truncated data .* at byte"):
        jpeg.read_jpeg(path)


def test_missing_or_failing_compiler_raises(monkeypatch, tmp_path):
    """No compiler, or a build that fails, raises with the command; the
    decoder does not fall back to Python."""
    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setenv("CC", "no-such-c-compiler")
    with pytest.raises(RuntimeError, match="no C compiler"):
        jpeg.decode_jpeg(_pil_bytes(_image(8, 8, 0)))
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="building the JPEG entropy decoder failed"):
        jpeg.build_library()
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())


def test_library_is_built_once_per_source(monkeypatch, tmp_path):
    """The library is named by a hash of the source, the compiler and the
    flags, in the build directory, and reused."""
    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path)
    path = jpeg.build_library()
    assert path.parent == tmp_path and path.name.startswith("libjpeg_entropy_")
    mtime = os.path.getmtime(path)
    assert jpeg.build_library() == path and os.path.getmtime(path) == mtime
