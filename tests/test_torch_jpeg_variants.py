"""The port's JPEG decoder (`data/jpeg.py`, `csrc/jpeg_entropy.c`) on the
codings past the baseline YCbCr file, against PIL, which reads every JPEG
for the JAX package: progressive files (spectral selection, successive
approximation, EOB runs, restart intervals), four-component CMYK and YCCK
files, three-component RGB files (an Adobe marker's transform 0, or
component ids R, G, B), and every integer sampling ratio up to 4.

The files come from PIL and OpenCV (`progressive=True`, mode CMYK,
`keep_rgb=True`, `restart_marker_blocks`, OpenCV's 4:1:1 and 4:4:0), from
those files with one marker byte changed (a YCCK transform, the RGB
component ids without their Adobe marker), and, for sampling factors no
writer here offers, from a writer in this file that entropy-codes random
quantised coefficients with `chip_smoke.py`'s baseline Huffman coder.

Tolerance: every decoded array equals PIL's bit for bit. The codings that
stay refused raise a ValueError that names them.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from neural_radiance_caching_tpu_torch.data import jpeg

SIZES = [(1, 1), (9, 4), (30, 3), (17, 33), (40, 29)]


def _image(h, w, seed):
    """Smooth ramps with a fifth of the pixels noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    smooth = np.stack([(x * 3 + y * (k + 2)) % 256 for k in range(3)], -1)
    return np.where(rng.rand(h, w, 1) < 0.2, rng.randint(0, 256, smooth.shape),
                    smooth).astype(np.uint8)


def _pil_bytes(img, mode=None, **kw):
    buf = io.BytesIO()
    image = Image.fromarray(img)
    (image.convert(mode) if mode else image).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _equal_to_pil(buf):
    want = np.array(Image.open(io.BytesIO(buf)))
    got = jpeg.decode_jpeg(buf)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _set_adobe_transform(buf, transform):
    pos = buf.index(b"Adobe") + 11
    return buf[:pos] + bytes([transform]) + buf[pos + 1:]


def _drop_segment(buf, marker):
    pos = buf.index(bytes([0xFF, marker]))
    length = int.from_bytes(buf[pos + 2:pos + 4], "big")
    return buf[:pos] + buf[pos + 2 + length:]


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 95])
def test_progressive_equals_pil(quality, subsampling, h, w):
    """PIL's progressive files (libjpeg's standard script: DC and AC first
    scans with point transforms, then their refinements)."""
    _equal_to_pil(_pil_bytes(_image(h, w, quality + subsampling), quality=quality,
                             subsampling=subsampling, progressive=True))


@pytest.mark.parametrize("kind", ["grey", "restart", "cmyk", "rgb"])
def test_progressive_variants_equal_pil(kind):
    """Progressive grey, CMYK and RGB files, and one with a restart
    interval of 2 MCUs (the EOB run reset at each RSTn)."""
    img = _image(40, 29, 7)
    kw = dict(quality=90, progressive=True)
    buf = {"grey": lambda: _pil_bytes(img[..., 0], **kw),
           "restart": lambda: _pil_bytes(img, restart_marker_blocks=2, **kw),
           "cmyk": lambda: _pil_bytes(img, mode="CMYK", **kw),
           "rgb": lambda: _pil_bytes(img, keep_rgb=True, **kw)}[kind]()
    _equal_to_pil(buf)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("transform", [0, 2], ids=["cmyk", "ycck"])
def test_four_components_equal_pil(transform, h, w):
    """PIL's CMYK files (Adobe transform 0) and the same file read as YCCK
    (transform 2): four planes, inverted as PIL reads them."""
    buf = _pil_bytes(_image(h, w, 3), mode="CMYK", quality=90)
    _equal_to_pil(_set_adobe_transform(buf, transform))


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("marker", ["adobe", "ids"])
def test_rgb_equals_pil(marker, h, w):
    """PIL's RGB files (`keep_rgb`: an Adobe marker with transform 0 and
    component ids R, G, B), and the same file without its Adobe marker,
    which libjpeg reads as RGB by the ids."""
    buf = _pil_bytes(_image(h, w, 4), quality=90, keep_rgb=True)
    if marker == "ids":
        buf = _drop_segment(buf, 0xEE)
    _equal_to_pil(buf)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("factor", ["411", "440"])
def test_opencv_sampling_equals_pil(factor, h, w):
    """OpenCV's 4:1:1 (luma 4x1) and 4:4:0 (luma 1x2) files."""
    value = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}[factor]
    ok, buf = cv2.imencode(".jpg", _image(h, w, 5),
                           [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, value])
    assert ok
    _equal_to_pil(buf.tobytes())


def _segment(marker, payload):
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def _sampled_jpeg(factors, h, w, seed, interleaved=True, markers=b""):
    """A baseline JPEG of random quantised coefficients: component i has
    sampling factors `factors[i]` (h, v), id i + 1, the luma tables for
    component 0 and the chroma tables for the others. Each block's DC is
    drawn in [-40, 40] and its first nine AC coefficients sparsely in
    [-6, 6]. One interleaved scan, or a scan per component."""
    rng = np.random.RandomState(seed)
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    natural = np.asarray(chip_smoke.JPEG_ZIGZAG)
    quant = [chip_smoke.jpeg_qtable(chip_smoke.JPEG_LUMA_Q, 90),
             chip_smoke.jpeg_qtable(chip_smoke.JPEG_CHROMA_Q, 90)]
    tables = {key: chip_smoke._huffman_codes(*spec)
              for key, spec in chip_smoke.JPEG_HUFFMAN.items()}
    coeffs = []
    for fh, fv in factors:
        zz = np.zeros((my * fv, mx * fh, 64), np.int64)
        zz[..., 0] = rng.randint(-40, 41, zz.shape[:2])
        zz[..., 1:10] = rng.randint(-6, 7, zz.shape[:2] + (9,)) * (
            rng.rand(*zz.shape[:2], 9) < 0.4)
        coeffs.append(zz)
    header = (b"\xff\xd8" + markers
              + _segment(0xDB, b"".join(bytes([i]) + bytes(q[natural].astype(np.uint8).tolist())
                                        for i, q in enumerate(quant)))
              + _segment(0xC0, struct.pack(">BHHB", 8, h, w, len(factors)) + b"".join(
                  bytes([i + 1, (fh << 4) | fv, min(i, 1)]) for i, (fh, fv) in enumerate(factors)))
              + _segment(0xC4, b"".join(bytes([(cls << 4) | tid]) + bytes(counts) + symbols
                                        for (cls, tid), (counts, symbols)
                                        in chip_smoke.JPEG_HUFFMAN.items())))

    def sos(ids):
        return _segment(0xDA, bytes([len(ids)]) + b"".join(
            bytes([i + 1, 0x11 if i else 0x00]) for i in ids) + bytes([0, 63, 0]))

    if interleaved:
        units = [c.reshape(my, fv, mx, fh, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, -1, 64)
                 for c, (fh, fv) in zip(coeffs, factors)]
        comp = np.concatenate([np.full(fh * fv, i) for i, (fh, fv) in enumerate(factors)])
        blocks = np.concatenate(units, axis=1).reshape(-1, 64)
        comp = np.tile(comp, my * mx)
        body = sos(range(len(factors))) + chip_smoke._entropy_segment(
            blocks, comp, np.minimum(comp, 1), tables)
    else:
        body = b""
        for i, ((fh, fv), c) in enumerate(zip(factors, coeffs)):
            rows = -(-(-(-h * fv // vmax)) // 8)
            cols = -(-(-(-w * fh // hmax)) // 8)
            blocks = c[:rows, :cols].reshape(-1, 64)
            body += sos([i]) + chip_smoke._entropy_segment(
                blocks, np.full(len(blocks), i), np.full(len(blocks), min(i, 1)), tables)
    return header + body + b"\xff\xd9"


# Every luma factor (h, v) up to 4 x 4 over chroma 1 x 1; an interleaved
# scan holds at most 10 blocks per MCU, so the larger ones are coded in a
# scan per component.
RATIOS = [(hf, vf) for hf in range(1, 5) for vf in range(1, 5)]


@pytest.mark.parametrize("ratio", RATIOS, ids=[f"{h}x{v}" for h, v in RATIOS])
def test_every_integer_ratio_equals_pil(ratio):
    """Luma sampled (h, v) against chroma 1 x 1, YCbCr with a JFIF marker:
    the fancy filters at 2x1, 1x2 and 2x2, replication at the other
    ratios; on a frame whose chroma planes are not a whole number of
    blocks."""
    interleaved = ratio[0] * ratio[1] + 2 <= 10
    jfif = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    _equal_to_pil(_sampled_jpeg([ratio, (1, 1), (1, 1)], 37, 53, sum(ratio),
                                interleaved=interleaved, markers=jfif))


@pytest.mark.parametrize("case", ["chroma-larger", "mixed", "rgb-420", "narrow"])
def test_other_factor_layouts_equal_pil(case):
    """Luma sampled below the chroma (luma upsampled), three different
    factors, an RGB file whose G and B planes are subsampled, and a frame
    whose 2 x 2 chroma plane is 2 samples wide (replicated, not filtered)."""
    factors, h, w, markers = {
        "chroma-larger": ([(1, 1), (2, 2), (2, 2)], 21, 26, b""),
        "mixed": ([(2, 2), (1, 2), (2, 1)], 25, 19, b""),
        "rgb-420": ([(2, 2), (1, 1), (1, 1)], 19, 23,
                    _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")),
        "narrow": ([(2, 2), (1, 1), (1, 1)], 14, 4, b""),
    }[case]
    _equal_to_pil(_sampled_jpeg(factors, h, w, 11, markers=markers))


def _progressive_without_last_scans(keep):
    """PIL's progressive file cut after its first `keep` scans."""
    buf = _pil_bytes(_image(24, 32, 1), quality=90, progressive=True)
    starts, pos = [], 0
    while True:
        pos = buf.find(b"\xff\xda", pos + 1)
        if pos < 0:
            break
        starts.append(pos)
    cut = starts[keep]
    # The Huffman tables of the next scan precede its SOS.
    dht = buf.rfind(b"\xff\xc4", starts[keep - 1], cut)
    return buf[:dht if dht > 0 else cut] + b"\xff\xd9"


REFUSED = {
    "lossless": "lossless JPEG", "arithmetic": "arithmetic-coded JPEG",
    "hierarchical": "hierarchical JPEG", "12-bit": "12-bit JPEG", "DNL": "DNL",
    "fractional ratio": "not an integer", "MCU too large": "more than 10 blocks per MCU",
    "unrefined progressive": "block smoothing", "bad progression": "malformed",
}


def _refused(name):
    base = _pil_bytes(_image(24, 32, 1), quality=90)
    sof = base.index(b"\xff\xc0")
    marker = {"lossless": 0xC3, "arithmetic": 0xC9, "hierarchical": 0xC5}
    if name in marker:
        return base[:sof + 1] + bytes([marker[name]]) + base[sof + 2:]
    if name == "12-bit":
        return base[:sof + 4] + b"\x0c" + base[sof + 5:]
    if name == "DNL":
        return base[:sof + 5] + b"\x00\x00" + base[sof + 7:]
    if name == "fractional ratio":
        return _sampled_jpeg([(3, 1), (2, 1), (1, 1)], 16, 16, 0)
    if name == "MCU too large":
        return _sampled_jpeg([(3, 3), (1, 1), (1, 1)], 16, 16, 0)
    if name == "unrefined progressive":
        return _progressive_without_last_scans(2)
    if name == "bad progression":
        prog = _pil_bytes(_image(24, 32, 1), quality=90, progressive=True)
        sos = prog.index(b"\xff\xda")
        n = prog[sos + 4]
        se = sos + 5 + 2 * n + 1  # the first (DC) scan's Se, which must be 0
        return prog[:se] + b"\x05" + prog[se + 1:]
    raise KeyError(name)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_remaining_refusals_raise_by_name(name):
    """The codings that stay refused raise a ValueError naming them:
    lossless, arithmetic-coded and hierarchical files and a DNL height
    (no writer here makes them), 12-bit files (PIL cannot read them),
    sampling ratios that are not integers and interleaved MCUs of more than
    10 blocks (libjpeg refuses both), a progressive file whose first AC
    coefficients are not fully refined (libjpeg's block smoothing is not
    ported), and a malformed progression."""
    with pytest.raises(ValueError, match=REFUSED[name]):
        jpeg.decode_jpeg(_refused(name))


def test_libjpeg_refuses_what_the_port_refuses_for_libjpeg():
    """PIL fails on the ratios and MCU sizes that the port refuses as
    libjpeg does, and on 12-bit files; it decodes the cut progressive file
    (with block smoothing)."""
    for name in ("fractional ratio", "MCU too large", "12-bit"):
        with pytest.raises((OSError, SyntaxError)):
            Image.open(io.BytesIO(_refused(name))).load()
    assert np.array(Image.open(io.BytesIO(_refused("unrefined progressive")))).shape == (
        24, 32, 3)
