"""Scenes posed by COLMAP, against the JAX package: the port's COLMAP
reader (`data/colmap.py`) on binaries written here by `struct`, OpenCV's
lens distortion and its Newton inverse, the NDC warp, the render paths,
the `llff` loader on each of its three pose paths (COLMAP's `sparse/0`,
`poses_bounds.npy`, an NGP `transforms.json`) at factor 1 and 4 with its
batches cast on the host and in the train step, the fisheye camtype quirk,
a blender scene whose transforms carry distortion, and one cache step of
the narrow `ngp_yobo.gin` from an LLFF scene through both trainers.

Tolerances: the COLMAP arrays, poses, intrinsics and distortion bit for
bit; distortion and its inverse on the host (numpy, float64 and float32)
bit for bit; rays cast on the host bit for bit (the same numpy operations
on the same cameras); images to 2 float32 ulps of white
(`test_torch_loaders.IMAGE_TOL`); the render paths bit for bit, but for
the arc-length resampling (a float32 inverse CDF: absolute 1e-5); the
in-step cast against jnp's, float32, the undistortion's 10 Newton steps
included: rtol 1e-6 with an absolute 1e-7, the other loader tests' limit,
which holds (at most 1.2e-7 apart on these scenes' unit view directions);
the NDC warp's rays (`pixels_to_rays` with `pixtocam_ndc`) to a relative
2e-5 (`NDC_RTOL`), `convert_to_ndc` alone to 1e-6; the cache step as
`test_torch_loader_steps.py` holds it.
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import test_torch_loaders as loaders
import test_torch_material_slice as material_slice
import test_torch_material_trainer as material_trainer
import test_torch_slf_distance as slf_distance
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.data import camera_utils as jcam
from neural_radiance_caching_tpu.data import colmap as jcolmap
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.engine.configs import Config as JConfig
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu_torch.data import camera_utils as tcam
from neural_radiance_caching_tpu_torch.data import colmap as tcolmap
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights

OPENCV = np.diag([1.0, -1.0, -1.0, 1.0])
# The in-step NDC warp's relative limit: it divides by the rays' depths and
# takes the far point less the near one, which turns the last-ulp
# differences of XLA's fused arithmetic into a measured 1.1e-5 relative.
NDC_RTOL = 2e-5
# mip-NeRF 360's OPENCV camera: the small radial and tangential terms of a
# phone or DSLR lens.
DISTORTION = {"k1": -0.03, "k2": 0.01, "p1": 1e-4, "p2": -1e-4}


# --- COLMAP binaries -----------------------------------------------------------------------

MODEL_IDS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2, "RADIAL": 3, "OPENCV": 4,
             "OPENCV_FISHEYE": 5, "FULL_OPENCV": 6, "FOV": 7, "SIMPLE_RADIAL_FISHEYE": 8,
             "RADIAL_FISHEYE": 9, "THIN_PRISM_FISHEYE": 10}


def model_params(model, w, h, seed=0):
    """A camera of `model` at w x h: focal(s), principal point, and the
    model's distortion terms (mip-NeRF 360's magnitudes)."""
    rng = np.random.RandomState(seed)
    f, fy, cx, cy = 1.1 * w + seed, 1.1 * w + 0.5, w / 2 + 0.3, h / 2 - 0.2
    extra = {"SIMPLE_PINHOLE": [], "PINHOLE": [], "SIMPLE_RADIAL": [-0.03],
             "RADIAL": [-0.03, 0.01], "OPENCV": [-0.03, 0.01, 1e-4, -1e-4],
             "OPENCV_FISHEYE": [0.02, -0.01, 0.003, -0.001], "FULL_OPENCV": [0.0] * 8,
             "FOV": [0.9], "SIMPLE_RADIAL_FISHEYE": [0.02], "RADIAL_FISHEYE": [0.02, -0.01],
             "THIN_PRISM_FISHEYE": [0.0] * 8}[model]
    extra = [e * (1 + 0.1 * rng.rand()) for e in extra]
    if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL", "SIMPLE_RADIAL_FISHEYE",
                 "RADIAL_FISHEYE"):
        return [f, cx, cy] + extra
    return [f, fy, cx, cy] + extra


def rotmat_to_qvec(r):
    """A rotation matrix as COLMAP's (w, x, y, z) quaternion."""
    w = np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    x = np.copysign(np.sqrt(max(0.0, 1 + r[0, 0] - r[1, 1] - r[2, 2])) / 2, r[2, 1] - r[1, 2])
    y = np.copysign(np.sqrt(max(0.0, 1 - r[0, 0] + r[1, 1] - r[2, 2])) / 2, r[0, 2] - r[2, 0])
    z = np.copysign(np.sqrt(max(0.0, 1 - r[0, 0] - r[1, 1] + r[2, 2])) / 2, r[1, 0] - r[0, 1])
    return np.array([w, x, y, z])


def write_colmap(folder, cameras, images):
    """`cameras.bin` from {id: (model, w, h, params)} and `images.bin` from
    [(image id, OpenGL camera-to-world [3, 4], camera id, name)], each
    image with a few 2-D points, in COLMAP's binary layout."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam_id, (model, w, h, params) in cameras.items():
            f.write(struct.pack("<iiQQ", cam_id, MODEL_IDS[model], w, h))
            f.write(struct.pack(f"<{len(params)}d", *params))
    with open(os.path.join(folder, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for image_id, c2w, cam_id, name in images:
            m = np.eye(4)
            m[:3] = c2w
            w2c = np.linalg.inv(m @ OPENCV)
            f.write(struct.pack("<idddddddi", image_id, *rotmat_to_qvec(w2c[:3, :3]),
                                *w2c[:3, 3], cam_id))
            f.write(name.encode() + b"\x00")
            n_pts = image_id % 3
            f.write(struct.pack("<Q", n_pts))
            for k in range(n_pts):
                f.write(struct.pack("<ddq", 1.5 * k, 2.5 * k, k - 1))


def _poses(n, seed, radius=3.0):
    return tcam.generate_spherical_poses(n, radius=radius, seed=seed).astype(np.float64)


COLMAP_MODELS = ["SIMPLE_PINHOLE", "PINHOLE", "SIMPLE_RADIAL", "RADIAL", "OPENCV",
                 "OPENCV_FISHEYE", "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"]


def _assert_posedata_equal(got, want):
    assert got[0] == want[0]
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[3] is None) == (want[3] is None)
    if want[3] is not None:
        assert sorted(got[3]) == sorted(want[3])
        for k in want[3]:
            assert got[3][k].dtype == want[3][k].dtype
            np.testing.assert_array_equal(got[3][k], want[3][k], err_msg=k)
    assert got[4].value == want[4].value


@pytest.mark.parametrize("model", COLMAP_MODELS)
def test_colmap_reader_equals_jax(model, tmp_path):
    """Every camera model the JAX package maps: cameras.bin and images.bin
    as read, and the pose data (names sorted, OpenGL poses, inverse
    intrinsics, distortion over the sorted key union, the camera type)."""
    folder = str(tmp_path / "sparse" / "0")
    cameras = {3: (model, 64, 48, model_params(model, 64, 48))}
    names = ["c.jpg", "a.jpg", "b.jpg", "d.jpg"]
    images = [(7 - i, c2w, 3, names[i]) for i, c2w in enumerate(_poses(4, 1))]
    write_colmap(folder, cameras, images)
    for read in ("read_cameras_bin", "read_images_bin"):
        name = read.split("_")[1] + ".bin"
        want = getattr(jcolmap, read)(os.path.join(folder, name))
        got = getattr(tcolmap, read)(os.path.join(folder, name))
        assert list(got) == list(want)
        for key in want:
            assert sorted(got[key]) == sorted(want[key])
            for field, w in want[key].items():
                np.testing.assert_array_equal(got[key][field], w)
    got, want = tcolmap.load_colmap_posedata(str(tmp_path)), jcolmap.load_colmap_posedata(
        str(tmp_path))
    _assert_posedata_equal(got, want)
    assert got[0] == sorted(names)
    assert got[4].value == ("fisheye" if "FISHEYE" in model else "perspective")
    if model in ("SIMPLE_PINHOLE", "PINHOLE"):
        assert got[3] is None
    # The written poses come back, through a quaternion of their float32
    # rotations.
    order = np.argsort(names)
    np.testing.assert_allclose(got[1], np.stack([c for _, c, _, _ in images])[order], atol=1e-4)


def test_colmap_mixed_cameras_equal_jax(tmp_path):
    """Three cameras, one without distortion: the distortion arrays hold 0
    for its images, the keys are the union's (k4 from the fisheye), and the
    camera type is the last image's (by name)."""
    cameras = {1: ("PINHOLE", 64, 48, model_params("PINHOLE", 64, 48)),
               2: ("OPENCV", 64, 48, model_params("OPENCV", 64, 48, 2)),
               5: ("OPENCV_FISHEYE", 64, 48, model_params("OPENCV_FISHEYE", 64, 48, 3))}
    images = [(i + 1, c2w, (1, 2, 5, 2, 1)[i], f"img_{(3 * i) % 5}.png")
              for i, c2w in enumerate(_poses(5, 2))]
    write_colmap(str(tmp_path / "sparse"), cameras, images)
    got, want = tcolmap.load_colmap_posedata(str(tmp_path)), jcolmap.load_colmap_posedata(
        str(tmp_path))
    _assert_posedata_equal(got, want)
    assert sorted(got[3]) == ["k1", "k2", "k3", "k4", "p1", "p2"]
    assert got[4].value == "perspective"  # img_4.png: the last name, camera 2


@pytest.mark.parametrize("model", ["FULL_OPENCV", "FOV"])
def test_colmap_refused_models_raise_in_both(model, tmp_path):
    cameras = {1: (model, 32, 24, model_params(model, 32, 24))}
    write_colmap(str(tmp_path / "sparse" / "0"), cameras, [(1, _poses(1, 3)[0], 1, "a.png")])
    for pkg in (jcolmap, tcolmap):
        with pytest.raises(NotImplementedError, match=f"COLMAP camera model {model}"):
            pkg.load_colmap_posedata(str(tmp_path))


def test_text_only_folder_fails_in_both(tmp_path):
    """A folder with only `images.txt` is found in both packages, whose
    reading then fails on the missing binaries; no folder at all raises
    the same ValueError."""
    folder = tmp_path / "colmap" / "sparse" / "0"
    os.makedirs(folder)
    (folder / "images.txt").write_text("# Image list\n")
    for pkg in (jcolmap, tcolmap):
        assert pkg.find_colmap_data(str(tmp_path)) == str(folder) + "/"
        with pytest.raises(FileNotFoundError, match="cameras.bin"):
            pkg.load_colmap_posedata(str(tmp_path))
    os.makedirs(tmp_path / "empty")
    for pkg in (jcolmap, tcolmap):
        with pytest.raises(ValueError, match="has no COLMAP data folder"):
            pkg.load_colmap_posedata(str(tmp_path / "empty"))


# --- distortion and NDC --------------------------------------------------------------------

DISTORTION_CASES = {
    "opencv": DISTORTION,
    "fisheye_terms": {"k1": 0.02, "k2": -0.01, "k3": 0.003, "k4": -0.001},
    "strong": {"k1": -0.3, "k2": 0.12, "k3": -0.02, "p1": 0.004, "p2": -0.003},
}


def _coords(dtype, n=4000, seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.9, 0.9, (2, n)).astype(dtype)
    xy[:, :4] = [[0.0, 1e-20, -0.5, 0.9], [0.0, 0.0, 0.4, -0.9]]
    return xy


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(DISTORTION_CASES))
def test_distortion_host_equals_jax_bit_for_bit(case, dtype):
    """distort_coordinates and undistort_coordinates on numpy arrays, with
    shared floats and with per-point arrays of the coefficients; the
    inverse undoes the distortion."""
    params = DISTORTION_CASES[case]
    x, y = _coords(dtype)
    per_point = {k: np.full(x.shape, v) * (1 + 0.05 * np.cos(np.arange(x.size)))
                 for k, v in params.items()}
    for p in (params, per_point):
        for got, want in zip(tcam.distort_coordinates(x, y, p), jcam.distort_coordinates(x, y, p)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        xd, yd = tcam.distort_coordinates(x, y, p)
        got = tcam.undistort_coordinates(xd, yd, p)
        want = jcam.undistort_coordinates(xd, yd, p, xnp=np)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        if case != "strong":
            np.testing.assert_allclose(got[0], x, atol=1e-5)
            np.testing.assert_allclose(got[1], y, atol=1e-5)


@pytest.mark.parametrize("case", sorted(DISTORTION_CASES))
def test_undistort_on_tensors_against_jnp(case):
    """The Newton solve on float32 tensors (the in-step cast's) against
    jnp's under jit, coefficients as float32 arrays per point."""
    x, y = _coords(np.float32, seed=1)
    p = {k: np.full(x.shape, v, np.float32) for k, v in DISTORTION_CASES[case].items()}
    xd, yd = jcam.distort_coordinates(x, y, p)
    want = jax.jit(lambda a, b, q: jcam.undistort_coordinates(a, b, q, xnp=jnp))(xd, yd, p)
    got = tcam.undistort_coordinates(torch.as_tensor(xd), torch.as_tensor(yd),
                                     {k: torch.as_tensor(v) for k, v in p.items()})
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _rays_for_ndc(n=500, seed=2):
    rng = np.random.RandomState(seed)
    origins = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    directions = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)), -rng.uniform(0.5, 1.5, (n, 1))],
                                -1).astype(np.float32)
    pixtocam = np.linalg.inv(tcam.intrinsic_matrix(40.0, 40.0, 32.0, 24.0)).astype(np.float32)
    return origins, directions, pixtocam


def test_convert_to_ndc_host_and_tensors_equal_jax():
    """The NDC warp on numpy arrays (bit for bit) and on float32 tensors
    against jnp's (rtol 1e-6, absolute 1e-7)."""
    origins, directions, pixtocam = _rays_for_ndc()
    for near in (1.0, 0.5):
        want = jcam.convert_to_ndc(origins, directions, pixtocam, near=near, xnp=np)
        got = tcam.convert_to_ndc(origins, directions, pixtocam, near=near)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        want = jax.jit(lambda o, d, p: jcam.convert_to_ndc(o, d, p, near=near, xnp=jnp))(
            origins, directions, pixtocam)
        got = tcam.convert_to_ndc(*map(torch.as_tensor, (origins, directions, pixtocam)),
                                  near=near)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert np.allclose(got[0].numpy()[:, 2], -1.0)


def _cast_inputs(n=300, seed=3):
    rng = np.random.RandomState(seed)
    c2w = _poses(4, seed).astype(np.float32)
    pixtocams = np.stack([np.linalg.inv(tcam.intrinsic_matrix(50.0 + i, 52.0, 32.0, 24.0))
                          for i in range(4)]).astype(np.float32)
    cam = rng.randint(0, 4, n)
    return (rng.randint(0, 64, n), rng.randint(0, 48, n), cam, pixtocams, c2w)


# (distortion, NDC, camtype): the NDC warp with the perspective camera only,
# as PixelRig casts it (a fisheye's rays near its image plane slide to
# the z = -near plane from afar).
RAY_CASES = [(d, n, c) for d in (False, True) for n in (False, True)
             for c in ("perspective", "fisheye", "fisheye_equisolid")
             if not (n and c != "perspective")]


@pytest.mark.parametrize("distortion,ndc,camtype", RAY_CASES)
def test_pixels_to_rays_equals_jax(distortion, ndc, camtype):
    """pixels_to_rays with per-ray distortion (gathered by camera), the NDC
    warp and each camera model reachable by a direct camtype: on the host
    bit for bit, on float32 tensors against jnp's (the NDC warp within
    NDC_RTOL)."""
    pix_x, pix_y, cam, pixtocams, c2w = _cast_inputs()
    kind = jcam.ProjectionType(camtype)
    dist = ({k: np.array([v * (1 + 0.2 * i) for i in range(4)]) for k, v in DISTORTION.items()}
            if distortion else None)
    ndc_mat = pixtocams[0] if ndc else None
    args = (pix_x, pix_y, pixtocams[cam], c2w[cam])
    jdist = None if dist is None else {k: v[cam] for k, v in dist.items()}
    want = jcam.pixels_to_rays(*args, distortion_params=jdist, camtype=kind, xnp=np,
                               pixtocam_ndc=ndc_mat)
    got = tcam.pixels_to_rays(*args, distortion_params=jdist,
                              camtype=tcam.ProjectionType(camtype), pixtocam_ndc=ndc_mat)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, i
        np.testing.assert_array_equal(g, w, err_msg=str(i))

    jargs = [jnp.asarray(a) for a in args]
    fdist = None if dist is None else {k: v.astype(np.float32) for k, v in jdist.items()}
    want = jax.jit(lambda a, b, c, d, e, f: jcam.pixels_to_rays(
        a, b, c, d, distortion_params=e, camtype=kind, xnp=jnp, pixtocam_ndc=f))(
        *jargs, fdist, ndc_mat)
    tdist = None if fdist is None else {k: torch.as_tensor(v) for k, v in fdist.items()}
    got = tcam.pixels_to_rays(*(torch.as_tensor(a) for a in args), distortion_params=tdist,
                              camtype=tcam.ProjectionType(camtype),
                              pixtocam_ndc=None if ndc_mat is None else torch.as_tensor(ndc_mat))
    rtol = NDC_RTOL if ndc else 1e-6
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=1e-7,
                                   err_msg=str(i))


def test_cast_general_and_pinhole_rays_equal_jax():
    """The free cameras' full-image rays, with distortion and a fisheye,
    and the panoramic probe camera, on the host bit for bit."""
    c2w = _poses(1, 4)[0].astype(np.float32)
    pixtocam = np.linalg.inv(tcam.intrinsic_matrix(30.0, 31.0, 12.0, 9.0)).astype(np.float32)
    cases = [
        (tcam.cast_general_rays(c2w, pixtocam, 18, 24, 0.5, 4.0, distortion_params=DISTORTION,
                                camtype=tcam.ProjectionType.FISHEYE, cam_idx=2, light_idx=1),
         jcam.cast_general_rays(c2w, pixtocam, 18, 24, 0.5, 4.0, distortion_params=DISTORTION,
                                camtype=jcam.ProjectionType.FISHEYE, cam_idx=2, light_idx=1)),
        (tcam.cast_pinhole_rays(c2w, 18, 24, 20.0, 0.5, 4.0),
         jcam.cast_pinhole_rays(c2w, 18, 24, 20.0, 0.5, 4.0)),
        (tcam.cast_spherical_rays(c2w, 8, 16, 0.1, 5.0, light_idx=3),
         jcam.cast_spherical_rays(c2w, 8, 16, 0.1, 5.0, light_idx=3)),
    ]
    for got, want in cases:
        for f in dataclasses.fields(want):
            w = getattr(want, f.name)
            assert (getattr(got, f.name) is None) == (w is None), f.name
            if w is not None:
                np.testing.assert_array_equal(getattr(got, f.name), np.asarray(w),
                                              err_msg=f.name)


# --- poses and render paths ----------------------------------------------------------------


def test_focus_and_poses_equal_jax():
    """The focus point, the focus recentring (up turned to +z, and the
    turned-over branch) bit for bit."""
    poses = _poses(7, 5)
    poses[:, :3, 3] += [0.2, -0.1, 0.3]
    for p in (poses, np.diag([1.0, -1.0, -1.0]) @ poses):
        np.testing.assert_array_equal(tcam.focus_point_fn(p), jcam.focus_point_fn(p))
        for g, w in zip(tcam.transform_poses_focus(p.copy()),
                        jcam.transform_poses_focus(p.copy())):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [{}, dict(z_variation=0.3, z_phase=0.5, lock_up=True),
                                dict(relative_to_first_pose=True, flip_y=True),
                                dict(first_pose=np.eye(4))])
def test_ellipse_path_equals_jax(kw):
    poses = _poses(9, 6)
    np.testing.assert_array_equal(tcam.generate_ellipse_path(poses, 17, **kw),
                                  jcam.generate_ellipse_path(poses, 17, **kw))


def test_spiral_path_equals_jax():
    poses = _poses(9, 7)[:, :3, :4]
    bounds = np.random.RandomState(7).uniform(1.0, 6.0, (9, 2))
    for kw in ({}, dict(n_rots=3, zrate=0.25)):
        np.testing.assert_array_equal(tcam.generate_spiral_path(poses, bounds, 13, **kw),
                                      jcam.generate_spiral_path(poses, bounds, 13, **kw))


@pytest.mark.parametrize("kw", [{}, dict(lock_up=True, fixed_up_vector=np.array([0, 0, 1.0])),
                                dict(lookahead_i=2), dict(n_buffer=2), dict(const_speed=True)])
def test_interpolated_path_equals_jax(kw):
    """scipy's spline through the keyframes; the arc-length resampling runs
    the port's float32 inverse CDF against JAX's (absolute 1e-5: its
    parameters an ulp or so apart, through the spline's slope)."""
    poses = _poses(6, 8)[:, :3, :4]
    got = tcam.generate_interpolated_path(poses, 5, **kw)
    want = jcam.generate_interpolated_path(poses, 5, **kw)
    assert got.shape == want.shape
    if kw.get("const_speed"):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_gather_cameras_equals_jax():
    """Per-camera arrays and dicts are gathered, shared ones pass through
    (a [3, 3] pixtocam is gathered by rows when there are 3 poses, as in
    JAX)."""
    for n in (3, 4):
        cams = (np.zeros((n, 3, 4)) + np.arange(n)[:, None, None], np.arange(9.0).reshape(3, 3),
                {"k1": np.arange(n) * 0.1, "p1": 0.5}, None)
        inds = np.arange(n)[::-1]
        got, want = tcam.gather_cameras(cams, inds), jcam.gather_cameras(cams, inds)
        for g, w in zip(got, want):
            if isinstance(w, dict):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
            elif w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)


# --- the llff loader -----------------------------------------------------------------------

LLFF_VIEWS = 10  # llffhold 8 holds out views 0 and 8
LLFF_SIZE = (32, 48)  # full-resolution height and width; images_4 at 8 x 12


def _jpeg(path, rgb):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(path, "JPEG", quality=95)


def _write_images(root, names, size=LLFF_SIZE):
    h, w = size
    for i, name in enumerate(names):
        rgb = np.random.RandomState(200 + i).rand(h, w, 3)
        _jpeg(os.path.join(root, "images", name), rgb)
        small = rgb.reshape(h // 4, 4, w // 4, 4, 3).mean((1, 3))
        _jpeg(os.path.join(root, "images_4", name), small)


def _llff_names(n=LLFF_VIEWS):
    return [f"DSC_{(7 * i) % n:04d}.JPG" for i in range(n)]


def write_llff_colmap(root, camera_models=("OPENCV", "SIMPLE_RADIAL"), fisheye=False):
    """mip-NeRF 360's layout: `sparse/0/{cameras,images}.bin` (OPENCV and
    SIMPLE_RADIAL cameras in turn, image ids not in name order) and the
    JPEGs in `images/` and `images_4/`."""
    h, w = LLFF_SIZE
    names = _llff_names()
    if fisheye:
        camera_models = ("OPENCV_FISHEYE",)
    cameras = {i + 1: (m, w, h, model_params(m, w, h, i)) for i, m in enumerate(camera_models)}
    images = [(100 - i, c2w, 1 + i % len(cameras), names[i])
              for i, c2w in enumerate(_poses(LLFF_VIEWS, 9))]
    write_colmap(os.path.join(root, "sparse", "0"), cameras, images)
    _write_images(root, names)
    return root


def write_llff_poses_bounds(root):
    """LLFF's `poses_bounds.npy` ([down, right, backwards] poses, h, w, focal
    and the near / far bounds per view) and the images."""
    h, w = LLFF_SIZE
    poses = _poses(LLFF_VIEWS, 10)
    nerf_to_llff = np.array([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    llff = np.stack([np.concatenate([p, np.zeros((1, 4))]) for p in poses])
    llff[:, 3, 3] = 1
    llff = (llff @ np.linalg.inv(nerf_to_llff))[:, :3, :4]
    hwf = np.tile(np.array([h, w, 1.2 * w])[None, :, None], (LLFF_VIEWS, 1, 1))
    bounds = np.random.RandomState(10).uniform([1.0, 5.0], [2.0, 8.0], (LLFF_VIEWS, 2))
    arr = np.concatenate([np.concatenate([llff, hwf], -1).reshape(LLFF_VIEWS, 15), bounds], -1)
    np.save(os.path.join(root, "poses_bounds.npy"), arr)
    _write_images(root, sorted(_llff_names()))
    return root


def write_llff_ngp(root):
    """An NGP `transforms.json` in the image folder's layout, the intrinsics
    and OpenCV distortion shared in its header."""
    h, w = LLFF_SIZE
    names = _llff_names()
    frames = []
    for name, c2w in zip(names, _poses(LLFF_VIEWS, 11)):
        m = np.eye(4)
        m[:3] = c2w
        frames.append({"file_path": f"images/{name[:-4]}", "transform_matrix": m.tolist()})
    meta = dict(fl_x=1.1 * w, fl_y=1.1 * w + 1, cx=w / 2, cy=h / 2, w=w, h=h, frames=frames,
                **DISTORTION)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump(meta, f)
    _write_images(root, names)
    return root


LLFF_PATHS = {"colmap": (write_llff_colmap, {}),
              "poses_bounds": (write_llff_poses_bounds, dict(llff_load_from_poses_bounds=True)),
              "ngp": (write_llff_ngp, dict(load_ngp_format_poses=True))}


@pytest.fixture(scope="module")
def llff_scenes(tmp_path_factory):
    out = {}
    for name, (write, _) in LLFF_PATHS.items():
        out[name] = write(str(tmp_path_factory.mktemp(name)))
    out["fisheye"] = write_llff_colmap(str(tmp_path_factory.mktemp("fisheye")), fisheye=True)
    return out


def llff_pair(scenes, path, split="train", factor=0, **extra):
    scene = "colmap" if path == "fisheye" else path
    kw = dict(dataset_loader="llff", batch_size=32, factor=factor, near=0.2, far=6.0,
              **LLFF_PATHS[scene][1], **extra)
    want = jdatasets.load_dataset(split, scenes[path], JConfig(**kw))
    got = tdatasets.load_dataset(split, scenes[path], TConfig(**kw), device="cpu")
    return want, got


def _assert_cameras_equal(got, want):
    for name in ("pixtocams", "camtoworlds", "lights"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for g, w in zip(got.cameras, want.cameras):
        assert (g is None) == (w is None)
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        elif w is not None:
            np.testing.assert_array_equal(g, w)
    assert got.camtype.value == want.camtype.value


LLFF_CASES = [(path, split, factor) for path in sorted(LLFF_PATHS) for split in ("train", "test")
              for factor in (1, 4)]


@pytest.mark.parametrize("path,split,factor", LLFF_CASES)
def test_llff_arrays_equal_jax(llff_scenes, path, split, factor):
    """The images (`images/` at factor 1, `images_4/` at 4), the cameras and
    their distortion, the lights, the split by llffhold."""
    want, got = llff_pair(llff_scenes, path, split, factor)
    loaders._close_images(got.images, want.images, "images")
    _assert_cameras_equal(got, want)
    assert (got.num_images, got.height, got.width) == (want.num_images, want.height, want.width)
    assert got.num_images == (8 if split == "train" else 2)
    assert got.height == LLFF_SIZE[0] // factor
    assert (got.distortion_params is None) == (path == "poses_bounds")


def test_llff_options_equal_jax(llff_scenes):
    """poses_bounds' forward-facing rescale (no PCA), the linear images of
    `linear_to_srgb`, another hold-out, no hold-out, the file-order poses
    without `load_alphabetical`."""
    for path, kw in (("poses_bounds", dict(forward_facing=True)),
                     ("colmap", dict(linear_to_srgb=True, llffhold=3)),
                     ("ngp", dict(llffhold=0)), ("ngp", dict(load_alphabetical=False))):
        for split in ("train", "test"):
            if split == "test" and kw.get("llffhold") == 0:
                continue
            want, got = llff_pair(llff_scenes, path, split, 4, **kw)
            loaders._close_images(got.images, want.images, "images")
            _assert_cameras_equal(got, want)


def _in_step_close(g, w, name):
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=name)


def _jax_in_step(dataset, pixels):
    """jnp's cast of `pixels` against the dataset's cameras, op by op: XLA
    takes minutes on the CPU to compile the unrolled Newton solve for some
    of these scenes' cameras (NGP-posed ones with per-frame distortion)."""
    cams = jax.tree_util.tree_map(jnp.asarray, tuple(dataset.cameras))
    with jax.disable_jit():
        return jcam.cast_ray_batch(cams, jnp.asarray(dataset.lights),
                                   jax.tree_util.tree_map(jnp.asarray, pixels), xnp=jnp)


@pytest.mark.parametrize("path,factor", [(p, f) for p in sorted(LLFF_PATHS) for f in (1, 4)])
def test_llff_batches_equal_jax(llff_scenes, path, factor):
    """The first three train batches, rays cast on the host (distortion
    gathered per ray, bit for bit), then cast by the train step's caster on
    tensors against jnp's; one eval view of each split."""
    want, got = llff_pair(llff_scenes, path, factor=factor)
    for _ in range(3):
        loaders._assert_batch(got.next_train(), want.next_train(), loaders._exact)
    loaders._assert_batch(got.generate_ray_batch(1), want.generate_ray_batch(1), loaders._exact)
    want_test, got_test = llff_pair(llff_scenes, path, "test", factor)
    loaders._assert_batch(got_test.generate_ray_batch(0), want_test.generate_ray_batch(0),
                          loaders._exact)

    want, got = llff_pair(llff_scenes, path, factor=factor, cast_rays_in_train_step=True)
    cast = loaders._in_step(got.config, got)
    for _ in range(3):
        jbatch, tbatch = want.next_train(), got.next_train()
        assert isinstance(tbatch.rays, tpytrees.Pixels)
        jbatch = jbatch.replace(rays=_jax_in_step(want, jbatch.rays))
        tbatch = tbatch.replace(rays=cast(None, tbatch.rays))
        assert tbatch.rays.directions.dtype == torch.float32
        loaders._assert_batch(tbatch, jbatch, _in_step_close)


def test_llff_distortion_reaches_the_rays(llff_scenes):
    """The same scene with its distortion dropped casts other rays: the
    undistortion moves the image plane by about k1 r^2 (the ray through
    the corner pixel most)."""
    _, got = llff_pair(llff_scenes, "colmap", "test", 1)
    batch = got.generate_ray_batch(0)
    got.distortion_params = None
    plain = got.generate_ray_batch(0)
    moved = np.abs(batch.rays.imageplane.numpy() - plain.rays.imageplane.numpy()).max()
    assert 1e-4 < moved < 0.05


def test_fisheye_camtype_quirk_is_kept(llff_scenes):
    """A COLMAP OPENCV_FISHEYE camera loads with camtype FISHEYE in both
    packages, but no cast reads the camtype: its rays are those of a
    perspective camera with the OpenCV radial model (k1..k4), on the host
    and in the step, not those of the fisheye projection."""
    want, got = llff_pair(llff_scenes, "fisheye", "test", 1)
    assert got.camtype == tcam.ProjectionType.FISHEYE and want.camtype.value == "fisheye"
    assert sorted(got.distortion_params) == ["k1", "k2", "k3", "k4"]
    batch = got.generate_ray_batch(0)
    loaders._assert_batch(batch, want.generate_ray_batch(0), loaders._exact)
    pixels = got._make_pixels(*(np.asarray(batch.rays.cam_idx)[:, 0],
                                np.asarray(batch.rays.pix_x_int),
                                np.asarray(batch.rays.pix_y_int)))
    for camtype, same in ((tcam.ProjectionType.PERSPECTIVE, True),
                          (tcam.ProjectionType.FISHEYE, False)):
        rays = tcam.cast_ray_batch(got.cameras, got.lights, pixels, camtype=camtype)
        equal = np.array_equal(np.asarray(rays.directions, np.float32),
                               batch.rays.directions.numpy())
        assert equal == same, camtype
    want, got = llff_pair(llff_scenes, "fisheye", factor=1, cast_rays_in_train_step=True)
    jbatch, tbatch = want.next_train(), got.next_train()
    loaders._assert_batch(tbatch.replace(rays=loaders._in_step(got.config, got)(None, tbatch.rays)),
                          jbatch.replace(rays=_jax_in_step(want, jbatch.rays)), _in_step_close)


def test_blender_with_distortion_loads_as_jax(tmp_path):
    """A blender scene whose transforms carry k1, k2, p1, p2 (shared floats
    in the header) and then per frame: the cameras and the batches, cast on
    the host and in the step, as JAX's."""
    for per_frame in (False, True):
        root = tmp_path / f"per_frame_{per_frame}"
        for s, split in enumerate(("train", "test")):
            frames = []
            for i, pose in enumerate(loaders._c2w(3, 20 + s)):
                m = np.eye(4)
                m[:3] = pose
                frame = dict(file_path=f"{split}/r_{i}", transform_matrix=m.tolist())
                if per_frame:
                    frame.update({k: v * (1 + i) for k, v in DISTORTION.items()})
                frames.append(frame)
                loaders._write_png(str(root / f"{split}/r_{i}.png"),
                                   np.random.RandomState(i).rand(16, 16, 4))
            meta = dict(camera_angle_x=0.69, w=16, h=16, frames=frames)
            if not per_frame:
                meta.update(DISTORTION)
            with open(root / f"transforms_{split}.json", "w") as f:
                json.dump(meta, f)
        for cast in (False, True):
            kw = dict(dataset_loader="blender", batch_size=32, near=2.0, far=6.0,
                      cast_rays_in_train_step=cast)
            want = jdatasets.load_dataset("train", str(root), JConfig(**kw))
            got = tdatasets.load_dataset("train", str(root), TConfig(**kw), device="cpu")
            _assert_cameras_equal(got, want)
            for _ in range(2):
                jbatch, tbatch = want.next_train(), got.next_train()
                if cast:
                    jbatch = jbatch.replace(rays=_jax_in_step(want, jbatch.rays))
                    tbatch = tbatch.replace(rays=loaders._in_step(got.config, got)(
                        None, tbatch.rays))
                loaders._assert_batch(tbatch, jbatch, _in_step_close if cast else loaders._exact)


def test_llff_loader_runs_without_pil_or_jax(llff_scenes):
    """The llff loader reads the COLMAP scene with PIL, OpenCV, imageio,
    h5py and JAX hidden (the card's machine has none of them)."""
    hidden = ("PIL", "cv2", "imageio", "h5py", "jax", "neural_radiance_caching_tpu")
    code = (
        "import sys\n"
        f"for m in {hidden!r}:\n"
        "    sys.modules[m] = None\n"
        "from neural_radiance_caching_tpu_torch.data import datasets\n"
        "from neural_radiance_caching_tpu_torch.engine.configs import Config\n"
        f"d = datasets.load_dataset('train', {llff_scenes['colmap']!r}, Config(\n"
        "    dataset_loader='llff', batch_size=8, factor=4, near=0.2), device='cpu')\n"
        "assert d.next_train().rgb.shape == (8, 3) and d.distortion_params is not None\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


# --- one cache step ------------------------------------------------------------------------

NGP = ["configs/ngp_yobo.gin"]
TRAIN_FRAC = 0.25


@pytest.fixture
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


@pytest.mark.parametrize("in_step", [False, True])
def test_ngp_cache_step_from_llff_through_both_trainers(llff_scenes, in_step, monkeypatch,
                                                        clean_gin):
    """One cache step of the narrow ngp_yobo.gin (the llff loader its
    default) from the COLMAP scene at factor 4, the same weights and draws
    (every leaf from U(-0.5, 0.5), the tables at their init range): every
    loss term, every gradient leaf, the Adam step; the rays cast on the
    host, and in the step (the JAX step's jnp cast of its Pixels, through
    the distortion)."""
    bindings = trainer_test.NGP_TINY + [
        "Config.dataset_loader = 'llff'", f"Config.data_dir = '{llff_scenes['colmap']}'",
        "Config.near = 0.2", f"Config.cast_rays_in_train_step = {in_step}"]
    jt, jmodel, tt = material_trainer._trainers(NGP, bindings, "cache")
    jcfg = jt.config
    jdata = jdatasets.load_dataset("train", jcfg.data_dir, jcfg)
    assert type(tt.dataset).__name__ == type(jdata).__name__ == "LLFF"
    assert tt.dataset.distortion_params is not None
    variables = material_trainer._variables(jmodel, 5)
    jbatch = jdata.next_train()
    if in_step:
        jbatch = jbatch.replace(rays=_jax_in_step(jdata, jbatch.rays))
    with material_slice.injected(7), jhash.xla_encoder_scope():
        (_, jlosses_), jgrad = slf_distance.jax_step_loss(jmodel, jcfg, TRAIN_FRAC)(
            variables, jbatch)
    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    updates, _ = jstate.tx.update(jgrad, jstate.opt_state, variables)
    jnew = material_slice._leaves(optax.apply_updates(variables, updates)["params"])

    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    tbatch = tt.dataset.next_train()
    assert isinstance(tbatch.rays, tpytrees.Pixels) == in_step
    with material_slice.injected(7):
        state, stats = tt.train_step(tt.rng, tt.state, tbatch, TRAIN_FRAC)
    assert calls == []  # the final level's density normals take the plain encoder

    got = {k: float(v) for k, v in stats["losses"].items()}
    assert sorted(got) == sorted(jlosses_) and {"data", "cache_data"} <= set(got)
    for k, v in jlosses_.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **trainer_test.LOSS)
    want = material_slice._leaves(jgrad["params"])
    params = dict(tt.model.named_parameters())
    assert sorted(params) == sorted(want)
    for k, p in params.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, want[k]),
                              *material_trainer.GRAD, k)
    for k, p in params.items():
        lr = max(g["lr"] for g in state.optimizer.param_groups
                 if any(q is p for q in g["params"]))
        np.testing.assert_allclose(p.detach().numpy(), material_slice._tr(k, jnew[k]),
                                   rtol=0, atol=2 * lr + 1e-7, err_msg=k)
