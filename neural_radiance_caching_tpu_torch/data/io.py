"""Image file IO for the dataset loaders (counterpart of ``data/io.py``).

PNGs and JPEGs are read by the port's own decoders (``data/png.py``,
``data/jpeg.py``), which return what PIL gives the JAX package, EXRs by its
own codec (``data/exr.py``), h5 files by its own HDF5 reader
(``data/hdf5.py``, what h5py gives) and Radiance HDR env maps
(``read_hdr``) by its own RGBE reader (``data/hdr.py``, what OpenCV gives).
TIFF images raise (PIL reads them in the JAX package; the card's machine
has no PIL), and so does an HDR file read as an image, which PIL does not
read either.

``resize_lanczos4`` and ``resize_nearest`` are OpenCV's ``cv2.resize`` with
``INTER_LANCZOS4`` and ``INTER_NEAREST``, which the JAX loaders call and
the card's machine does not have.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from neural_radiance_caching_tpu_torch.data import exr, hdf5, hdr, jpeg, png

_TIFF = (b"II*\x00", b"MM\x00*")


def _missing(path, what, reader):
    return NotImplementedError(
        f"{path}: {what} images are not read by the port ({reader} is not on the card's "
        "machine); PNG, JPEG, EXR and h5 are")


def load_img(path):
    """Load an image file into float32 (raw range: callers divide by 255),
    as PIL reads it; the format is told by the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == png.SIGNATURE:
        return png.read_png(path).astype(np.float32)
    if head.startswith(jpeg.SOI):
        return jpeg.read_jpeg(path).astype(np.float32)
    if head[:4] in _TIFF:
        raise _missing(path, "TIFF", "PIL")
    if head.startswith(b"#?"):
        raise ValueError(f"{path}: a Radiance HDR file is read by read_hdr (an env map), "
                         "not as an image (PIL does not read it)")
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def read_hdr(path):
    """A Radiance .hdr file as float32 RGB [H, W, 3] (OpenCV's decode)."""
    return hdr.read_hdr(path)


def load_exr(path):
    return exr.read_exr(path)


def read_h5(path):
    """The `data` dataset of `path` (".h5" added where missing) as float32."""
    if not path.endswith(".h5"):
        path = path + ".h5"
    with hdf5.File(path) as f:
        return np.array(f["data"]).astype(np.float32)


def downsample(img, factor):
    """Area-average downsample by an integer factor."""
    h, w = img.shape[:2]
    h2, w2 = h // factor, w // factor
    img = img[: h2 * factor, : w2 * factor]
    shape = (h2, factor, w2, factor) + img.shape[2:]
    return img.reshape(shape).mean(axis=(1, 3))


# --- OpenCV's resizes ---------------------------------------------------------------------

# interpolateLanczos4's table of sin / cos phases (imgproc/src/resize.cpp).
_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = np.array([[1, 0], [-_S45, -_S45], [0, 1], [_S45, -_S45], [-1, 0], [_S45, _S45],
                        [0, -1], [-_S45, _S45]])
# Lanes of the SIMD vertical pass of the float32 Lanczos resize (OpenCV's
# SSE baseline): it sums the eight rows last to first over each full group
# of lanes, first to last over the rest of the row.
_V_LANES = 4


def _lanczos4_weights(fx):
    """interpolateLanczos4: the 8 float32 tap weights of each float32
    fraction `fx`, sin / cos in float64, the weights normalised by their
    float32 sum (an exact tap takes 1e30 and so all of the weight)."""
    f32 = np.float32
    fx = fx.astype(f32)
    y0 = -(fx + f32(3)).astype(np.float64) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs = np.zeros(fx.shape + (8,), f32)
    total = np.zeros(fx.shape, f32)
    for i in range(8):
        d = fx + f32(3) - f32(i)
        y = -d.astype(np.float64) * np.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            c = ((_LANCZOS_CS[i, 0] * s0 + _LANCZOS_CS[i, 1] * c0) / (y * y)).astype(f32)
        coeffs[..., i] = np.where(np.abs(d) >= f32(1e-6), c, f32(1e30))
        total = total + coeffs[..., i]
    return coeffs * (f32(1) / total)[..., None]


def _lanczos4_taps(src, dst):
    """cv2's taps from `src` samples to `dst`: the 8 source indices of each
    output (clamped: the border repeats) and their weights. The scale is
    1 / (dst / src) in float64 and the position `(d + 0.5) * scale - 0.5`
    is rounded to float32, as cv2 computes it; the kernel is not widened
    when shrinking."""
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    idx = np.clip(sx[:, None] - 3 + np.arange(8), 0, src - 1)
    return idx, _lanczos4_weights(fx)


def resize_lanczos4(img, size):
    """``cv2.resize(img, size, interpolation=cv2.INTER_LANCZOS4)`` of a
    float32 or float64 image [H, W] or [H, W, C]; `size` is (width,
    height). Separable: the rows first, into a buffer of the image's dtype,
    then the columns. Each output sums its 8 products first to last, except
    the float32 vertical pass, which sums as cv2's SIMD loop does
    (``_V_LANES``)."""
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.float64):
        raise TypeError(f"resize_lanczos4 takes float32 or float64 images, not {img.dtype}")
    dt = img.dtype.type
    w, h = size
    height, width = img.shape[:2]
    ix, ax = _lanczos4_taps(width, w)
    iy, ay = _lanczos4_taps(height, h)
    trail = (1,) * (img.ndim - 2)
    ax = ax.astype(dt).reshape((w, 8) + trail)
    rows = np.zeros((height, w) + img.shape[2:], dt)
    for j in range(8):
        tap = np.take(img, ix[:, j], axis=1)
        tap *= ax[:, j]
        rows += tap
    flat = rows.reshape(height, -1)
    ay = ay.astype(dt)[:, :, None]
    out = np.empty((h, flat.shape[1]), dt)
    split = flat.shape[1] // _V_LANES * _V_LANES if dt is np.float32 else 0
    for cols, taps in ((slice(0, split), range(7, -1, -1)),
                       (slice(split, None), range(8))):
        acc = None
        for k in taps:
            term = flat[iy[:, k], cols] * ay[:, k]
            acc = term if acc is None else term + acc
        out[:, cols] = acc
    return out.reshape((h, w) + img.shape[2:])


def resize_nearest(img, size):
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``: output
    pixel d takes source floor(d * (1 / (dst / src))), in float64, capped
    at the last; `size` is (width, height)."""
    img = np.asarray(img)
    w, h = size
    height, width = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(w) * (1.0 / (w / width))).astype(np.int64), width - 1)
    sy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / height))).astype(np.int64),
                    height - 1)
    return img[sy][:, sx]


def get_img(factor, ext, fprefix):
    """Load `fprefix + ext`, dispatching on the extension."""
    path = fprefix + ext
    if path.endswith(".exr"):
        image = load_exr(path)
    elif path.endswith(".h5"):
        image = read_h5(fprefix)
    else:
        image = load_img(path)
    if factor > 1:
        image = downsample(image, factor)
    return image


def get_imgs(data_dir, factor, use_tiffs, use_exrs, load_disps, load_normals,
             load_masks, load_albedos, nameprefix, split="train"):
    """One frame's image and its optional buffers: (image, disparity,
    normals, mask, albedo), each None unless asked for. The TIFF images and
    disparities raise: PIL reads them in the JAX package."""
    fprefix = os.path.join(data_dir, nameprefix)

    if use_tiffs:
        raise _missing(fprefix + "_{R,G,B,A}.tiff", "TIFF", "PIL")
    if use_exrs:
        image = get_img(factor, ".exr", fprefix)
    elif os.path.exists(fprefix + ".h5"):
        image = get_img(factor, ".h5", fprefix) / 255.0
    elif os.path.exists(fprefix + ".png"):
        image = get_img(factor, ".png", fprefix) / 255.0
    elif os.path.exists(fprefix + ".jpg"):
        image = get_img(factor, ".jpg", fprefix) / 255.0
    else:
        image = get_img(factor, "", fprefix) / 255.0

    mask_image = None
    if load_masks:
        maskprefix = os.path.join(
            "/".join(nameprefix.split("/")[:-2]), f"{split}_mask", nameprefix.split("/")[-1])
        mask_image = get_img(factor, ".png", os.path.join(data_dir, maskprefix))
        mask_image = mask_image[..., None] / 255.0

    if load_disps:
        raise _missing(fprefix + "_disp.tiff", "TIFF disparity", "PIL")

    normal_image = None
    if load_normals:
        normal_image = (get_img(factor, ".png", fprefix.replace("rgba", "normal"))[..., :3]
                        * 2.0 / 255.0 - 1.0)

    albedo_image = None
    if load_albedos:
        albedo_image = get_img(factor, ".png", fprefix.replace("rgba", "albedo")) / 255.0

    return image, None, normal_image, mask_image, albedo_image


def find_file(data_dir, frame) -> Optional[str]:
    """The extension of a frame's `file_path` on disk (png, jpg, jpeg, exr,
    h5 or none), or None."""
    base = os.path.join(data_dir, frame["file_path"])
    root, ext = os.path.splitext(base)
    if ext and os.path.exists(base):
        return ext
    for try_ext in (".png", ".jpg", ".jpeg", ".exr", ".h5", ""):
        if os.path.exists(root + try_ext):
            return try_ext
    return None
