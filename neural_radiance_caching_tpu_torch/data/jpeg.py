"""JPEG decoder: the entropy decoding in C, the rest in numpy.

The JAX package opens JPEGs through PIL (``data/io.load_img``), which the
card's machine does not have. ``read_jpeg`` returns the array that
``np.array(PIL.Image.open(path))`` gives, bit for bit against PIL built on
libjpeg-turbo: uint8 ``[H, W, 3]`` for a YCbCr or RGB file, ``[H, W, 4]``
for a CMYK or YCCK one (inverted, as PIL reads it under Adobe's
convention), ``[H, W]`` for a grey one. It reproduces libjpeg's integer
pipeline at its defaults, which are PIL's:

- the Huffman decoding of 8-bit scans, sequential (SOF0, SOF1) and
  progressive (SOF2: spectral selection, successive approximation, EOB
  runs), with 8- and 16-bit quantisation tables, per-scan Huffman tables,
  restart intervals (the DC predictors and the EOB run reset at each
  RSTn), byte stuffing and fill bytes, interleaved and non-interleaved
  scans: ``csrc/jpeg_entropy.c``, built with the host C compiler at first
  use and called through ctypes (it is sequential bit by bit; a Python
  loop would take seconds per view);
- the dequantisation and ``jidctint.c``'s two-pass integer IDCT (ISLOW),
  its ``DESCALE`` rounding and its range-limit table, which wraps values
  outside [-512, 511] (``& RANGE_MASK``) rather than clipping them;
- ``jdsample.c``'s upsampling of each component to the largest sampling
  factors: the "fancy" triangle filters h2v1 and h2v2 (where the
  component is wider than 2 samples; else replication) and h1v2, with
  their alternating rounding biases, the edge column and the last real row
  repeated as context; every other integer ratio (4:1:1 among them) by
  replication;
- ``jdcolor.c``'s colour spaces as libjpeg guesses them (a JFIF marker,
  an Adobe marker's transform, the component ids): the fixed-point YCbCr
  -> RGB tables (16 fraction bits), RGB as it is, CMYK as it is and YCCK
  -> CMYK through the same tables.

EXIF orientation is not applied (PIL's ``Image.open`` does not apply it
either). Lossless (SOF3), hierarchical and arithmetic-coded files,
precisions other than 8 bits, a height given by a DNL marker, sampling
ratios that are not integers, a progressive file whose first AC
coefficients are not fully refined (libjpeg smooths its blocks), and
truncated or malformed data raise a ValueError that names them. A missing
C compiler or a failed build raises; nothing falls back to a Python
decoder.

Format reference: ITU-T T.81 (markers, Annex B; Huffman decoding, Annex F);
the IJG's libjpeg for the integer IDCT, upsampling and colour conversion.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

SOI = b"\xff\xd8"
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "jpeg_entropy.c"
_CFLAGS = ("-O2", "-std=c99", "-shared", "-fPIC")
BUILD_DIR = _CSRC / "build"

_lib = None
_lib_lock = threading.Lock()

# The C decoder's error codes.
_ERRORS = {1: "truncated data (a marker or the end of the file inside an MCU)",
           2: "a bit pattern that is no Huffman code", 3: "a missing restart marker",
           4: "an AC run past coefficient 63", 5: "a malformed Huffman table",
           6: "an MCU outside the frame", 7: "a refinement coefficient of size other than 1"}
_SOF_REFUSED = {0xC3: "lossless JPEG (SOF3)",
                0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
                0xC7: "hierarchical JPEG (SOF7)", 0xC9: "arithmetic-coded JPEG (SOF9)",
                0xCA: "arithmetic-coded JPEG (SOF10)", 0xCB: "arithmetic-coded JPEG (SOF11)",
                0xCC: "arithmetic-coded JPEG (DAC)", 0xCD: "arithmetic-coded JPEG (SOF13)",
                0xCE: "arithmetic-coded JPEG (SOF14)", 0xCF: "arithmetic-coded JPEG (SOF15)"}

# libjpeg's limit on the blocks of an interleaved scan's MCU.
_MAX_BLOCKS_IN_MCU = 10
# libjpeg-turbo's block smoothing of a progressive file reads the
# refinement state of AC coefficients 1-9.
_SMOOTHED_COEFS = range(1, 10)


# --- the C library -------------------------------------------------------------------------


def _compiler():
    cc = os.environ.get("CC") or "cc"
    argv = shlex.split(cc)
    if shutil.which(argv[0]) is None:
        raise RuntimeError(f"no C compiler ({cc!r} is not on PATH; set CC): the JPEG "
                           "entropy decoder csrc/jpeg_entropy.c cannot be built")
    return argv


def _lib_path(argv):
    digest = hashlib.sha256(_SOURCE.read_bytes())
    digest.update(" ".join(list(argv) + list(_CFLAGS)).encode())
    return BUILD_DIR / f"libjpeg_entropy_{digest.hexdigest()[:16]}.so"


def build_library():
    """Compile csrc/jpeg_entropy.c with the host C compiler (`$CC`, else
    `cc`) into csrc/build/, named by a hash of the source, the compiler and
    the flags; returns the library's path. Raises with the command and its
    output if the build fails."""
    argv = _compiler()
    path = _lib_path(argv)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*argv, *_CFLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the JPEG entropy decoder failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.nrc_jpeg_decode_scan
            p = ctypes.c_void_p
            i32 = ctypes.c_int32
            fn.argtypes = (p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, p, p, p, p, p, p,
                           p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32, i32,
                           ctypes.POINTER(ctypes.c_int64))
            fn.restype = ctypes.c_int
            _lib = fn
        return _lib


# --- markers -------------------------------------------------------------------------------


class _Component:
    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None  # latched at the component's first scan, as libjpeg does
        self.blocks = None
        self.scanned = False
        # Progressive: each coefficient's successive-approximation bit, -1
        # before its first scan (libjpeg's coef_bits).
        self.coef_bits = np.full(64, -1)


class Frame:
    """A decoded file's frame: size, components (id, sampling factors) and
    each component's quantised coefficients [block rows, block cols, 64] in
    natural order, with its quantisation table (natural order); whether it
    is progressive, and its colour space (set at the first scan)."""

    def __init__(self, width, height, components, progressive=False):
        self.width, self.height = width, height
        self.components = components
        self.progressive = progressive
        self.color_space = None
        self.hmax = max(c.h for c in components)
        self.vmax = max(c.v for c in components)
        self.mcus_x = -(-width // (8 * self.hmax))
        self.mcus_y = -(-height // (8 * self.vmax))

    def size(self, comp):
        """The component's own size in samples (libjpeg's downsampled size)."""
        return (-(-self.height * comp.v // self.vmax), -(-self.width * comp.h // self.hmax))


def _u16(buf, pos):
    return struct.unpack_from(">H", buf, pos)[0]


def _color_space(components, jfif, adobe):
    """libjpeg's guess of a file's colour space (jdapimin.c), from the
    markers before its first scan. One component: grey. Three: JFIF means
    YCbCr; an Adobe marker's transform 0 means RGB (any other YCbCr);
    without either, component ids R, G, B mean RGB. Four: an Adobe marker's
    transform 0 means CMYK (any other YCCK); without one, CMYK."""
    if len(components) == 1:
        return "grey"
    if len(components) == 4:
        return "YCCK" if adobe is not None and adobe != 0 else "CMYK"
    if jfif:
        return "YCbCr"
    if adobe is not None:
        return "RGB" if adobe == 0 else "YCbCr"
    if [c.cid for c in components] == [82, 71, 66]:
        return "RGB"
    return "YCbCr"


def _upsampling(frame, comp):
    """The kind of jdsample.c's upsampling of `comp` to the frame's largest
    factors (its method selection, at PIL's fancy upsampling): "full",
    "h2v1", "h1v2", "h2v2" or a (horizontal, vertical) replication."""
    ratio = (frame.hmax // comp.h, frame.vmax // comp.v)
    narrow = frame.size(comp)[1] <= 2
    if ratio == (1, 1):
        return "full"
    if ratio == (2, 1) and not narrow:
        return "h2v1"
    if ratio == (1, 2):
        return "h1v2"
    if ratio == (2, 2) and not narrow:
        return "h2v2"
    return ratio


def decode_coefficients(buf: bytes, name: str = "<bytes>") -> Frame:
    """Parse a baseline JPEG's markers and entropy-decode its scans."""
    if buf[:2] != SOI:
        raise ValueError(f"{name} is not a JPEG file")
    buf = bytes(buf)
    arr = np.frombuffer(buf, np.uint8)
    qtables, dc_tables, ac_tables = {}, {}, {}
    restart, frame, jfif, adobe = 0, None, False, None
    pos, n = 2, len(buf)
    while True:
        # The next marker: libjpeg skips bytes before it and any fill FFs.
        while pos < n and buf[pos] != 0xFF:
            pos += 1
        while pos < n and buf[pos] == 0xFF:
            pos += 1
        if pos >= n:
            if frame is None or not all(c.scanned for c in frame.components):
                raise ValueError(f"{name}: truncated JPEG (the file ends before its scans)")
            break
        marker = buf[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            if frame is None or not all(c.scanned for c in frame.components):
                raise ValueError(f"{name}: truncated JPEG (EOI before every component's scan)")
            break
        if 0xD0 <= marker <= 0xD7 or marker in (0x01, 0xD8):
            continue  # stray RSTn or TEM: no segment
        if pos + 2 > n:
            raise ValueError(f"{name}: truncated JPEG (marker FF{marker:02X} at byte {pos - 2})")
        length = _u16(buf, pos)
        seg = buf[pos + 2: pos + length]
        if len(seg) != length - 2:
            raise ValueError(f"{name}: truncated JPEG (segment FF{marker:02X} at byte "
                             f"{pos - 2})")
        seg_pos = pos + 2
        pos += length
        if marker in _SOF_REFUSED:
            raise ValueError(f"{name}: {_SOF_REFUSED[marker]} is not supported "
                             "(baseline and extended sequential Huffman only)")
        if marker in (0xC0, 0xC1, 0xC2):
            precision, height, width, ncomp = struct.unpack_from(">BHHB", seg, 0)
            if precision != 8:
                raise ValueError(f"{name}: {precision}-bit JPEG is not supported (8-bit only)")
            if height == 0:
                raise ValueError(f"{name}: a JPEG whose height comes in a DNL marker is not "
                                 "supported")
            if ncomp not in (1, 3, 4):
                raise ValueError(f"{name}: JPEG with {ncomp} components is not supported")
            comps = []
            for i in range(ncomp):
                cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * i)
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                    raise ValueError(f"{name}: bad JPEG sampling factors {hv >> 4}x{hv & 15}")
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            frame = Frame(width, height, comps, progressive=marker == 0xC2)
            for c in comps:
                if frame.hmax % c.h or frame.vmax % c.v:
                    factors = ", ".join(f"{d.h}x{d.v}" for d in comps)
                    raise ValueError(f"{name}: JPEG sampling factors {factors} are not "
                                     "supported (a ratio that is not an integer, which "
                                     "libjpeg refuses too)")
                rows = max(frame.mcus_y * c.v, -(-frame.size(c)[0] // 8))
                cols = max(frame.mcus_x * c.h, -(-frame.size(c)[1] // 8))
                c.blocks = np.zeros((rows, cols, 64), np.int16)
        elif marker == 0xDB:  # DQT
            q = 0
            while q < len(seg):
                pq, tq = seg[q] >> 4, seg[q] & 15
                if pq == 0:
                    table = np.frombuffer(seg, np.uint8, 64, q + 1).astype(np.int64)
                    q += 65
                else:
                    table = np.frombuffer(seg, ">u2", 64, q + 1).astype(np.int64)
                    q += 129
                natural = np.zeros(64, np.int64)
                natural[_NATURAL] = table
                qtables[tq] = natural
        elif marker == 0xC4:  # DHT
            q = 0
            while q < len(seg):
                tc, th = seg[q] >> 4, seg[q] & 15
                counts = np.frombuffer(seg, np.uint8, 16, q + 1).copy()
                total = int(counts.sum())
                if total > 256 or q + 17 + total > len(seg):
                    raise ValueError(f"{name}: a malformed JPEG Huffman table (DHT at byte "
                                     f"{seg_pos - 4})")
                symbols = np.zeros(256, np.uint8)
                symbols[:total] = np.frombuffer(seg, np.uint8, total, q + 17)
                (ac_tables if tc else dc_tables)[th] = (counts, symbols)
                q += 17 + total
        elif marker == 0xDD:  # DRI
            restart = _u16(seg, 0)
        elif marker == 0xE0:  # APP0
            jfif = jfif or seg[:5] == b"JFIF\0"
        elif marker == 0xEE:  # APP14
            if seg[:5] == b"Adobe" and len(seg) >= 12:
                adobe = seg[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            if frame.color_space is None:
                frame.color_space = _color_space(frame.components, jfif, adobe)
            pos = _decode_scan(arr, seg, seg_pos + len(seg), frame, qtables, dc_tables,
                               ac_tables, restart, name)
        elif marker == 0xDC:
            raise ValueError(f"{name}: the DNL marker is not supported")
        # APPn, COM and the rest carry nothing the pixels need.
    if frame.progressive and any((c.coef_bits[list(_SMOOTHED_COEFS)] != 0).any()
                                 for c in frame.components):
        raise ValueError(f"{name}: a progressive JPEG whose AC coefficients 1-9 are not fully "
                         "refined is not supported (libjpeg's block smoothing is not ported)")
    return frame


def _decode_scan(arr, seg, start, frame, qtables, dc_tables, ac_tables, restart, name):
    ns = seg[0]
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if not frame.progressive:
        if (ss, se, ahal) != (0, 63, 0):
            raise ValueError(f"{name}: a sequential JPEG scan of spectral selection {ss}-{se} / "
                             f"successive approximation {ahal:#x} is not supported")
        use_dc = use_ac = True
    else:
        # jdphuff.c's checks of the scan's parameters.
        if ((ss == 0 and se != 0) or (ss > 0 and (ss > se or se > 63 or ns != 1))
                or (ah and al != ah - 1) or al > 13):
            raise ValueError(f"{name}: a progressive JPEG scan of spectral selection {ss}-{se} "
                             f"/ successive approximation {ahal:#x} is malformed")
        use_dc, use_ac = ss == 0 and ah == 0, ss > 0
    if ns > 1 and sum(c.h * c.v for c in frame.components
                      if c.cid in seg[1:1 + 2 * ns:2]) > _MAX_BLOCKS_IN_MCU:
        raise ValueError(f"{name}: JPEG sampling factors too large for an interleaved scan "
                         f"(more than {_MAX_BLOCKS_IN_MCU} blocks per MCU)")
    by_id = {c.cid: c for c in frame.components}
    comps, dcs, acs = [], [], []
    for i in range(ns):
        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"{name}: JPEG scan names an unknown component {cid}")
        c = by_id[cid]
        if (use_dc and tables >> 4 not in dc_tables) or (use_ac and tables & 15 not in
                                                         ac_tables):
            raise ValueError(f"{name}: JPEG scan uses an undefined Huffman table")
        if c.quant is None:
            if c.tq not in qtables:
                raise ValueError(f"{name}: JPEG component {cid} uses an undefined "
                                 f"quantisation table {c.tq}")
            c.quant = qtables[c.tq].copy()
        comps.append(c)
        dcs.append(dc_tables[tables >> 4] if use_dc else _NO_TABLE)
        acs.append(ac_tables[tables & 15] if use_ac else _NO_TABLE)

    def ints(values):
        return (ctypes.c_int32 * ns)(*values)

    def ptrs(arrays):
        return (ctypes.c_void_p * ns)(*[a.ctypes.data for a in arrays])

    sizes = [frame.size(c) for c in comps]
    end = ctypes.c_int64(0)
    err = _library()(
        arr.ctypes.data, len(arr), start, ns, ints([c.h for c in comps]),
        ints([c.v for c in comps]), ptrs([c.blocks for c in comps]),
        ints([c.blocks.shape[0] for c in comps]), ints([c.blocks.shape[1] for c in comps]),
        ints([-(-h // 8) for h, _ in sizes]), ints([-(-w // 8) for _, w in sizes]),
        ptrs([d[0] for d in dcs]), ptrs([d[1] for d in dcs]), ptrs([a[0] for a in acs]),
        ptrs([a[1] for a in acs]), frame.mcus_x, frame.mcus_y, restart, int(frame.progressive),
        ss, se, ah, al, ctypes.byref(end))
    if err:
        raise ValueError(f"{name}: JPEG scan data: {_ERRORS.get(err, f'error {err}')} at "
                         f"byte {end.value}")
    for c in comps:
        c.scanned = True
        if frame.progressive:
            c.coef_bits[ss:se + 1] = al
    return end.value


# The tables a scan does not read (a DC refinement's, an AC scan's DC).
_NO_TABLE = (np.zeros(16, np.uint8), np.zeros(256, np.uint8))


# --- the integer pipeline ------------------------------------------------------------------

# Zigzag index -> natural index.
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# jidctint.c: FIX(x) at CONST_BITS = 13.
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_pass(c, shift):
    """One pass of jidctint.c's ISLOW over the last axis of `c` (int64):
    the eight outputs, each DESCALEd by `shift`."""
    z2, z3 = c[..., 2], c[..., 6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (c[..., 0] + c[..., 4]) << CONST_BITS
    tmp1 = (c[..., 0] - c[..., 4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = c[..., 7], c[..., 5], c[..., 3], c[..., 1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    out = (tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
           tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)
    return np.stack([_descale(o, shift) for o in out], axis=-1)


def _range_limit():
    """libjpeg's post-IDCT range-limit table, indexed by the centred value
    & 1023: x + 128 clipped to [0, 255] for x in [-512, 511], wrapping
    outside."""
    x = np.arange(1024)
    x = np.where(x < 512, x, x - 1024)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE = _range_limit()


# No intermediate of a pass exceeds 2**18 x its largest input (the sums of
# the FIX multipliers along each path stay under 170,000): below this input
# magnitude int32 holds every intermediate exactly, as libjpeg's 64-bit
# JLONG does; above it the pass runs in int64.
_INT32_SAFE = 8192


def _exact_dtype(x):
    return np.int32 if int(np.abs(x).max(initial=0)) < _INT32_SAFE else np.int64


def idct_islow(coefficients, quant):
    """Dequantise [..., 64] natural-order coefficients by `quant` and run
    the ISLOW IDCT: uint8 samples [..., 8, 8]."""
    c = coefficients.astype(np.int64) * quant
    c = c.astype(_exact_dtype(c)).reshape(coefficients.shape[:-1] + (8, 8))
    # Pass 1 on the columns (the vertical frequencies), scaled by 2**PASS1_BITS.
    ws = _idct_pass(np.swapaxes(c, -1, -2), CONST_BITS - PASS1_BITS)
    # ws[..., x, y]: pass 2 on the rows.
    ws = ws.astype(_exact_dtype(ws))
    out = _idct_pass(np.swapaxes(ws, -1, -2), CONST_BITS + PASS1_BITS + 3)
    return _RANGE[out & 1023]


def _plane(comp):
    """A component's samples [block rows * 8, block cols * 8] (int32)."""
    blocks = idct_islow(comp.blocks, comp.quant)
    rows, cols = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8).astype(np.int32)


def _edges(x, axis):
    """The neighbours before and after along `axis`, the edges repeated."""
    n = x.shape[axis]
    before = np.take(x, np.r_[0, np.arange(n - 1)], axis=axis)
    after = np.take(x, np.r_[np.arange(1, n), n - 1], axis=axis)
    return before, after


def _interleave(a, b, axis):
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(x, kind):
    """jdsample.c's upsampling of a component's samples `x` [h, w] (int32):
    the fancy filters, their edges repeated (h2v1 and h1v2 round (3 near +
    far) / 4 with biases 1 and 2 at the even and odd outputs, h2v2 the
    column sums (3 near + far) / 16 with 8 and 7), or `kind` an (h, v)
    replication."""
    if kind == "full":
        return x
    if isinstance(kind, tuple):
        return np.repeat(np.repeat(x, kind[1], axis=0), kind[0], axis=1)
    if kind == "h2v1":
        left, right = _edges(x, 1)
        return _interleave((3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2, 1)
    above, below = _edges(x, 0)
    if kind == "h1v2":
        return _interleave((3 * x + above + 1) >> 2, (3 * x + below + 2) >> 2, 0)
    sums = _interleave(3 * x + above, 3 * x + below, 0)
    left, right = _edges(sums, 1)
    return _interleave((3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4, 1)


def _color_tables():
    """jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16, ONE_HALF rounding)."""
    scale = 16
    half = 1 << (scale - 1)
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << scale) + 0.5)

    cr_r = (fix(1.40200) * x + half) >> scale
    cb_b = (fix(1.77200) * x + half) >> scale
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return tuple(t.astype(np.int32) for t in (cr_r, cb_b, cr_g, cb_g))


_CR_R, _CB_B, _CR_G, _CB_G = _color_tables()


# libjpeg's sample range limit: x clipped to [0, 255], for x in [-256, 511].
_CLIP = np.clip(np.arange(-256, 512), 0, 255).astype(np.uint8)


def ycc_to_rgb(y, cb, cr):
    """uint8 RGB [h, w, 3] of int Y, Cb, Cr planes."""
    y = y + 256
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _CLIP[y + _CR_R[cr]]
    out[..., 1] = _CLIP[y + ((_CB_G[cb] + _CR_G[cr]) >> 16)]
    out[..., 2] = _CLIP[y + _CB_B[cb]]
    return out


def ycck_to_cmyk(y, cb, cr, k):
    """jdcolor.c's YCCK -> CMYK: the YCbCr -> RGB tables, each channel
    subtracted from 255 and clipped; K as it is. uint8 [h, w, 4]."""
    out = np.empty(y.shape + (4,), np.uint8)
    out[..., 0] = _CLIP[256 + 255 - (y + _CR_R[cr])]
    out[..., 1] = _CLIP[256 + 255 - (y + ((_CB_G[cb] + _CR_G[cr]) >> 16))]
    out[..., 2] = _CLIP[256 + 255 - (y + _CB_B[cb])]
    out[..., 3] = k
    return out


def pixels(frame: Frame) -> np.ndarray:
    """The decoded samples of a frame: PIL's uint8 array (a four-component
    file's inverted, as PIL reads CMYK under Adobe's convention)."""
    planes = []
    for c in frame.components:
        h, w = frame.size(c)
        planes.append(upsample(_plane(c)[:h, :w], _upsampling(frame, c))[:frame.height,
                                                                          :frame.width])
    if frame.color_space == "grey":
        return planes[0].astype(np.uint8)
    if frame.color_space == "YCbCr":
        return ycc_to_rgb(*planes)
    if frame.color_space == "RGB":
        return np.stack(planes, axis=-1).astype(np.uint8)
    cmyk = ycck_to_cmyk(*planes) if frame.color_space == "YCCK" else np.stack(planes, axis=-1)
    return (255 - cmyk).astype(np.uint8)


def decode_jpeg(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """The pixels of a JPEG file's bytes, as PIL's array of it."""
    return pixels(decode_coefficients(buf, name))


def read_jpeg(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))
