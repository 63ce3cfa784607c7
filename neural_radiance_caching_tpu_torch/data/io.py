"""Image file IO for the dataset loaders (counterpart of ``data/io.py``).

PNGs are read by the port's own decoder (``data/png.py``), which returns
what PIL gives the JAX package, EXRs by its own codec (``data/exr.py``) and
h5 files by its own HDF5 reader (``data/hdf5.py``, what h5py gives). The
formats whose readers the card's machine lacks raise naming them: JPEG and
TIFF (PIL), HDR (OpenCV).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from neural_radiance_caching_tpu_torch.data import exr, hdf5, png

_JPEG = b"\xff\xd8\xff"
_TIFF = (b"II*\x00", b"MM\x00*")


def _missing(path, what, reader):
    return NotImplementedError(
        f"{path}: {what} images are not read by the port ({reader} is not on the card's "
        "machine); PNG, EXR and h5 are")


def load_img(path):
    """Load an image file into float32 (raw range: callers divide by 255),
    as PIL reads it; the format is told by the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == png.SIGNATURE:
        return png.read_png(path).astype(np.float32)
    if head.startswith(_JPEG):
        raise _missing(path, "JPEG", "PIL")
    if head[:4] in _TIFF:
        raise _missing(path, "TIFF", "PIL")
    if head.startswith(b"#?"):
        raise _missing(path, "Radiance HDR", "OpenCV")
    raise ValueError(f"{path}: not a PNG file")


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
