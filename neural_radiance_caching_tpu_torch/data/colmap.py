"""COLMAP sparse-reconstruction reader (counterpart of ``data/colmap.py``):
`cameras.bin` and `images.bin` of a reconstruction's folder (the public
COLMAP binary format) into (image names, camera-to-world poses [N, 3, 4]
in OpenGL axes, inverse intrinsics, OpenCV distortion, camera type), as
the `llff` loader reads a capture posed by COLMAP (mip-NeRF 360's
`sparse/0/`). Pure `struct` and numpy."""

from __future__ import annotations

import os
import struct
from typing import Dict

import numpy as np

from neural_radiance_caching_tpu_torch.data import camera_utils

# model_id -> (name, number of parameters)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path) -> Dict[int, dict]:
    """camera id -> {model, width, height, params (float64)}."""
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = _read(f, f"<{n_params}d")
            cameras[cam_id] = {"model": name, "width": int(w), "height": int(h),
                               "params": np.array(params)}
    return cameras


def read_images_bin(path) -> Dict[int, dict]:
    """image id -> {name, qvec (w, x, y, z), tvec, camera_id}; the 2-D
    points are skipped."""
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = _read(f, "<idddddddi")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(24 * n_pts, os.SEEK_CUR)
            images[image_id] = {"name": name.decode("utf-8"), "qvec": np.array([qw, qx, qy, qz]),
                                "tvec": np.array([tx, ty, tz]), "camera_id": cam_id}
    return images


def qvec_to_rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def _camera_tuple(cam):
    """A camera dict -> (pixtocam, distortion dict or None, camtype) for the
    six models the JAX package maps; the others raise by name."""
    model, p = cam["model"], cam["params"]
    if model == "SIMPLE_PINHOLE":
        fx = fy = p[0]
        cx, cy = p[1], p[2]
        dist = None
    elif model == "PINHOLE":
        fx, fy, cx, cy = p[:4]
        dist = None
    elif model in ("SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
        dist = {"k1": p[3], "k2": 0.0, "k3": 0.0, "p1": 0.0, "p2": 0.0}
    elif model in ("RADIAL", "RADIAL_FISHEYE"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
        dist = {"k1": p[3], "k2": p[4], "k3": 0.0, "p1": 0.0, "p2": 0.0}
    elif model == "OPENCV":
        fx, fy, cx, cy = p[:4]
        dist = {"k1": p[4], "k2": p[5], "p1": p[6], "p2": p[7], "k3": 0.0}
    elif model == "OPENCV_FISHEYE":
        fx, fy, cx, cy = p[:4]
        dist = {"k1": p[4], "k2": p[5], "k3": p[6], "k4": p[7]}
    else:
        raise NotImplementedError(f"COLMAP camera model {model}")
    pixtocam = np.linalg.inv(camera_utils.intrinsic_matrix(fx, fy, cx, cy))
    camtype = (camera_utils.ProjectionType.FISHEYE if "FISHEYE" in model
               else camera_utils.ProjectionType.PERSPECTIVE)
    return pixtocam, dist, camtype


def find_colmap_data(data_dir, colmap_subdir=None):
    """The reconstruction's folder: `colmap_subdir`, else the first of
    `sparse/0/`, `sparse/`, `colmap/sparse/0/` holding `images.bin` or
    `images.txt` (a text-only folder is found; its reading then fails on
    the missing `.bin` files, as in the JAX package)."""
    search = [colmap_subdir] if colmap_subdir else ["sparse/0/", "sparse/", "colmap/sparse/0/"]
    for sub in search:
        d = os.path.join(data_dir, sub)
        if os.path.exists(os.path.join(d, "images.bin")) or os.path.exists(
                os.path.join(d, "images.txt")):
            return d
    raise ValueError(f"{data_dir} has no COLMAP data folder.")


def load_colmap_posedata(data_dir, colmap_subdir=None):
    """(image names, camtoworlds [N, 3, 4] float32 in OpenGL axes, pixtocams
    [N, 3, 3] float32, distortion, camtype), sorted by image name. The
    distortion is None where no camera has any, else a dict over the sorted
    union of the cameras' keys of float64 arrays [N] (0 where a camera
    lacks the key); camtype is the last image's camera's."""
    d = find_colmap_data(data_dir, colmap_subdir)
    cameras = read_cameras_bin(os.path.join(d, "cameras.bin"))
    images = read_images_bin(os.path.join(d, "images.bin"))

    names, poses, pixtocams, dists = [], [], [], []
    camtype = camera_utils.ProjectionType.PERSPECTIVE
    for _, im in sorted(images.items(), key=lambda kv: kv[1]["name"]):
        w2c = np.concatenate([qvec_to_rotmat(im["qvec"]), im["tvec"][:, None]], axis=1)
        c2w = np.linalg.inv(camera_utils.pad_poses(w2c[None])[0])[:3, :4]
        c2w = c2w @ np.diag([1.0, -1.0, -1.0, 1.0])  # OpenCV -> OpenGL
        pixtocam, dist, camtype = _camera_tuple(cameras[im["camera_id"]])
        names.append(im["name"])
        poses.append(c2w)
        pixtocams.append(pixtocam)
        dists.append(dist)
    poses = np.stack(poses).astype(np.float32)
    pixtocams = np.stack(pixtocams).astype(np.float32)
    if all(x is None for x in dists):
        dist_out = None
    else:
        dist_out = {k: np.array([0.0 if x is None else x.get(k, 0.0) for x in dists])
                    for k in sorted({k for x in dists if x for k in x})}
    return names, poses, pixtocams, dist_out, camtype
