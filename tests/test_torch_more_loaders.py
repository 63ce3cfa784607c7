"""The port's remaining loaders against the JAX package's, on fixture
scenes written here from numpy seeds (PNGs and JPEGs by PIL, EXRs by the
JAX package's writer, h5 files by h5py): `real`, `fipt_real`,
`fipt_synthetic`, `transient_simulation_itof`, `preloaded`, `tat_nerfpp`,
`tat_fvs`, `dtu`, `rtmv`, `pixelrig` and `aerial` (arrays, cameras, lights,
the NDC warp's pixtocam, the first three batches with rays cast on the
host and in the train step, one eval view, both splits, the render-path
branches); the port's projection-matrix decomposition (DTU's cameras)
against `cv2.decomposeProjectionMatrix`; and one open parity check,
nero_bell's material stage from disk through both trainers.

Tolerances: poses, intrinsics, pixel tables and rays cast on the host bit
for bit; images to 2 float32 ulps of white (`test_torch_loaders.IMAGE_TOL`:
the float32 powers of the sRGB transfers run in numpy here and in XLA
there); rays cast in the train step (jnp against torch, float32) to rtol
1e-6 with an absolute 1e-7, PixelRig's NDC rays to a relative 2e-5
(`test_torch_colmap.NDC_RTOL`). The decomposition: K and R to 1e-10 of
their largest entry (both compute in float64; on random matrices cv2 and
the port part at 2.5e-12 at most), the camera centre t[:3] / t[3] to 1e-10
relative, t itself equal up to its sign (the SVD's) to 1e-6 relative; the
DTU loader's poses and intrinsics bit for bit.
"""

import json
import os
import subprocess
import sys

import cv2
import h5py
import numpy as np
import pytest

import test_torch_colmap as colmap_test
import test_torch_loader_steps as loader_steps
import test_torch_loaders as loaders
import test_torch_material_trainer as material_trainer
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.data import exr as jexr
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.engine.configs import Config as JConfig
from neural_radiance_caching_tpu_torch.data import camera_utils as tcam
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees

OPENCV = np.diag([1.0, -1.0, -1.0, 1.0])
H, W = 12, 16


def _rgb(seed, h=H, w=W, c=3):
    return np.random.RandomState(seed).rand(h, w, c)


def _png(path, rgb):
    loaders._write_png(path, rgb)


def _jpeg(path, rgb):
    colmap_test._jpeg(path, rgb)


def _pad(pose):
    m = np.eye(4)
    m[:3] = pose[:3, :4]
    return m


def _frames(poses, prefix, **frame):
    return [dict(frame, file_path=f"{prefix}{i:03d}", transform_matrix=_pad(p).tolist())
            for i, p in enumerate(poses)]


# --- fixture writers -----------------------------------------------------------------------


def write_real(root):
    """NGP JSONs per split, per-frame intrinsics and distortion, PNGs."""
    for s, (split, n) in enumerate((("train", 4), ("test", 2))):
        frames = _frames(colmap_test._poses(n, 30 + s), f"{split}/f_", fl_x=1.1 * W, fl_y=1.2 * W,
                         cx=W / 2, cy=H / 2, k1=-0.02, p2=1e-4)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(w=W, h=H, frames=frames), f)
        for i in range(n):
            _png(os.path.join(root, split, f"f_{i:03d}.png"), _rgb(40 + 10 * s + i))
    return root


def _write_fipt_images(root, n, seed):
    os.makedirs(os.path.join(root, "Image"), exist_ok=True)
    for i in range(n):
        jexr.write_exr(os.path.join(root, "Image", f"{i:03d}_0001.exr"),
                       np.random.RandomState(seed + i).uniform(0, 2, (H, W, 3)).astype(np.float32))


def write_fipt_real(root):
    """`cam.txt` (origin, look-at, up rows), `K_list.txt`, `Image/*.exr`."""
    n = 5
    poses = colmap_test._poses(n, 50)
    with open(os.path.join(root, "cam.txt"), "w") as f:
        f.write(f"{n}\n")
        for p in poses:
            for row in (p[:3, 3], p[:3, 3] - p[:3, 2], p[:3, 1]):
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    with open(os.path.join(root, "K_list.txt"), "w") as f:
        f.write(f"{n}\n")
        for i in range(n):
            k = tcam.intrinsic_matrix(1.1 * W + i, 1.1 * W, W / 2, H / 2)
            for row in k:
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    _write_fipt_images(root, n, 55)
    return root


def write_fipt_synthetic(root):
    """`train/transforms.json` whose frames name `Image/*` EXRs."""
    n = 4
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames = [dict(file_path=f"Image/{i:03d}_0001", transform_matrix=_pad(p).tolist())
              for i, p in enumerate(colmap_test._poses(n, 60))]
    with open(os.path.join(root, "train", "transforms.json"), "w") as f:
        json.dump(dict(camera_angle_x=0.7, w=W, h=H, frames=frames), f)
    _write_fipt_images(root, n, 65)
    return root


def write_itof(root):
    """Transforms JSONs per split and h5 frames [H, W, 4 phases, 3]; a
    quarter of the pixels dark in every phase (masked out)."""
    for s, (split, n) in enumerate((("train", 3), ("test", 2))):
        frames = _frames(colmap_test._poses(n, 70 + s), f"{split}/r_")
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(camera_angle_x=0.7, w=W, h=H, frames=frames), f)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(n):
            data = np.random.RandomState(80 + 10 * s + i).uniform(0, 2, (H, W, 4, 3))
            data[: H // 4] = 0
            with h5py.File(os.path.join(root, split, f"r_{i:03d}.h5"), "w") as f:
                f.create_dataset("data", data=data.astype(np.float32))
    return root


def write_tat_nerfpp(root):
    """NeRF++'s layout: `{train,test,camera_path}/{pose,intrinsics,rgb}`."""
    for s, (split, n) in enumerate((("train", 4), ("test", 2), ("camera_path", 3))):
        for i, pose in enumerate(colmap_test._poses(n, 90 + s)):
            for sub in ("pose", "intrinsics", "rgb"):
                os.makedirs(os.path.join(root, split, sub), exist_ok=True)
            np.savetxt(os.path.join(root, split, "pose", f"{i:05d}.txt"),
                       (_pad(pose) @ OPENCV).reshape(1, 16))
            k = np.eye(4)
            k[:3, :3] = tcam.intrinsic_matrix(1.1 * W + i, 1.1 * W, W / 2, H / 2)
            np.savetxt(os.path.join(root, split, "intrinsics", f"{i:05d}.txt"), k.reshape(1, 16))
            _png(os.path.join(root, split, "rgb", f"{i:05d}.png"), _rgb(95 + 10 * s + i))
    return root


def write_tat_fvs(root):
    """FVS's layout: `dense/ibr3d_pyr_{0,1}` (the finer first by factor),
    `im_*.jpg`, `Ks.npy`, `Rs.npy`, `ts.npy` (OpenCV world-to-camera)."""
    n = 9
    poses = colmap_test._poses(n, 100)
    w2c = np.linalg.inv(np.stack([_pad(p) @ OPENCV for p in poses]))
    for level, (name, scale) in enumerate((("ibr3d_pyr_1", 1), ("ibr3d_pyr_0", 2))):
        d = os.path.join(root, "dense", name)
        os.makedirs(d)
        ks = np.stack([tcam.intrinsic_matrix(1.1 * W / scale + i, 1.1 * W / scale,
                                             W / 2 / scale, H / 2 / scale) for i in range(n)])
        np.save(os.path.join(d, "Ks.npy"), ks.astype(np.float64))
        np.save(os.path.join(d, "Rs.npy"), w2c[:, :3, :3])
        np.save(os.path.join(d, "ts.npy"), w2c[:, :3, 3])
        for i in range(n):
            _jpeg(os.path.join(d, f"im_{i:08d}.jpg"), _rgb(110 + i, H // scale, W // scale))
    return root


DTU_LIGHTS = [f"{c}_r5000" for c in range(7)] + ["max"]


def dtu_projection(pose, i):
    """A DTU-like camera: DTU's 1600 x 1200 focal (~2890 px) and principal
    point scaled to the fixture, [R | t] of the OpenGL pose, times a
    scale as DTU's calibration carries one."""
    k = np.array([[2890.0 / 100 + i, 0.3, 823.0 / 100], [0, 2880.0 / 100, 619.0 / 100],
                  [0, 0, 1]])
    w2c = np.linalg.inv(_pad(pose) @ OPENCV)[:3]
    return 1.7 * k @ w2c


def write_dtu(root):
    """`Rectified/scan1/rect_{i:03d}_{light}.png` for the 8 light conditions
    of 9 views and `Calibration/cal18/pos_{i:03d}.txt` projections."""
    scan = os.path.join(root, "Rectified", "scan1")
    cal = os.path.join(root, "Calibration", "cal18")
    os.makedirs(scan)
    os.makedirs(cal)
    for i, pose in enumerate(colmap_test._poses(9, 120, radius=5.0), start=1):
        np.savetxt(os.path.join(cal, f"pos_{i:03d}.txt"), dtu_projection(pose, i))
        for c, light in enumerate(DTU_LIGHTS):
            _png(os.path.join(scan, f"rect_{i:03d}_{light}.png"), _rgb(1000 * c + i))
    return scan


def write_rtmv(root):
    """RGBA EXRs beside their camera JSONs (`cam2world` transposed, `fx`),
    and the depth and segmentation EXRs the loader skips."""
    for i, pose in enumerate(colmap_test._poses(4, 130)):
        rgba = np.random.RandomState(140 + i).uniform(0, 1.5, (H, W, 4)).astype(np.float32)
        rgba[..., 3] = np.random.RandomState(i).rand(H, W) > 0.3
        jexr.write_exr(os.path.join(root, f"{i:05d}.exr"), rgba)
        jexr.write_exr(os.path.join(root, f"{i:05d}.depth.exr"), rgba[..., :1])
        jexr.write_exr(os.path.join(root, f"{i:05d}.seg.exr"), rgba[..., :1])
        with open(os.path.join(root, f"{i:05d}.json"), "w") as f:
            json.dump({"camera_data": {"cam2world": _pad(pose).T.tolist(),
                                       "intrinsics": {"fx": 1.2 * W}}}, f)
    return root


def _sfm_camera(path, pose, i, fmt):
    cam = dict(focal_length=1.3 * W + i, pixel_aspect_ratio=1.01, principal_point_x=W / 2 + 0.2,
               principal_point_y=H / 2 - 0.1, image_size_x=W, image_size_y=H)
    key = "camera_from_world" if i % 2 else "world_from_camera"
    m = _pad(pose) @ OPENCV
    cam[key] = (np.linalg.inv(m) if key == "camera_from_world" else m).tolist()
    if fmt == "json":
        with open(path + ".json", "w") as f:
            json.dump(cam, f)
    else:
        np.savez(path + ".npz", **{k: np.asarray(v) for k, v in cam.items()})


def write_pixelrig(root):
    """The rig's five cameras: `scaled_images/` and `scaled_camera_pose/`
    (the open SfM-camera encoding, JSON and npz), forward-facing."""
    images = os.path.join(root, "scene", "scaled_images")
    cams = os.path.join(root, "scene", "scaled_camera_pose")
    os.makedirs(images)
    os.makedirs(cams)
    offsets = [(0, 0), (0.1, 0), (-0.1, 0), (0, 0.1), (0, -0.1)]
    for i, (dx, dy) in enumerate(offsets):
        pose = np.eye(4)[:3].copy()
        pose[:3, 3] = [dx, dy, 0.0]
        _jpeg(os.path.join(images, f"cam_{i}.jpg"), _rgb(150 + i))
        _sfm_camera(os.path.join(cams, f"cam_{i}"), pose, i, "json" if i < 3 else "npz")
    return images


def write_aerial(root, orbit=True):
    """`rgb/` and `cameras/` (9 views, llffhold 8), and `orbit_cameras/`."""
    for i, pose in enumerate(colmap_test._poses(9, 160, radius=4.0)):
        _png(os.path.join(root, "rgb", f"{i:04d}.png"), _rgb(170 + i))
        os.makedirs(os.path.join(root, "cameras"), exist_ok=True)
        _sfm_camera(os.path.join(root, "cameras", f"{i:04d}"), pose, i, "json")
    if orbit:
        os.makedirs(os.path.join(root, "orbit_cameras"))
        for i, pose in enumerate(colmap_test._poses(3, 180, radius=4.0)):
            _sfm_camera(os.path.join(root, "orbit_cameras", f"{i:04d}"), pose, i, "npz")
    return root


WRITERS = {"real": write_real, "fipt_real": write_fipt_real,
           "fipt_synthetic": write_fipt_synthetic, "transient_simulation_itof": write_itof,
           "tat_nerfpp": write_tat_nerfpp, "tat_fvs": write_tat_fvs, "dtu": write_dtu,
           "rtmv": write_rtmv, "pixelrig": write_pixelrig, "aerial": write_aerial}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = {name: write(str(tmp_path_factory.mktemp(name))) for name, write in WRITERS.items()}
    out["aerial_ring"] = write_aerial(str(tmp_path_factory.mktemp("aerial_ring")), orbit=False)
    out["preloaded"] = None
    return out


def preloaded_arrays():
    return dict(images=np.random.RandomState(5).rand(3, H, W, 3),
                camtoworlds=colmap_test._poses(3, 190),
                pixtocams=np.linalg.inv(tcam.intrinsic_matrix(20.0, 21.0, W / 2, H / 2))[None])


# Each loader's config and its variants (the factor, the loaders' options,
# the render paths).
LOADER_CONFIG = {
    "real": [dict(), dict(factor=2), dict(use_exrs=False, linear_to_srgb=True)],
    "fipt_real": [dict(use_exrs=True), dict(use_exrs=True, linear_to_srgb=True, factor=2)],
    "fipt_synthetic": [dict(use_exrs=True), dict(use_exrs=True, linear_to_srgb=True)],
    "transient_simulation_itof": [dict(dataset_scale=300.0), dict(dataset_scale=300.0, factor=2)],
    "preloaded": [dict()],
    "tat_nerfpp": [dict(), dict(render_path=True)],
    "tat_fvs": [dict(factor=0), dict(factor=1), dict(factor=0, llffhold=3)],
    "dtu": [dict(), dict(factor=2), dict(dtu_light_cond=7), dict(factor=2, dtu_light_cond=7)],
    "rtmv": [dict(), dict(factor=2)],
    "pixelrig": [dict(near=0.5), dict(near=0.5, render_path=True, render_path_frames=6)],
    "aerial": [dict(world_scale=2.0), dict(world_scale=2.0, render_path=True)],
    "aerial_ring": [dict(world_scale=2.0, render_path=True, render_path_frames=5)],
}
LOADER_NAME = {"aerial_ring": "aerial"}
CASES = [(scene, split, i) for scene in sorted(LOADER_CONFIG) for split in ("train", "test")
         for i in range(len(LOADER_CONFIG[scene]))]
ARRAYS = ("images", "masks", "alphas", "images_flattened", "indices_flattened")


def loader_pair(scenes, scene, split="train", case=0, **extra):
    kw = dict(dataset_loader=LOADER_NAME.get(scene, scene), batch_size=24, near=0.2, far=6.0)
    kw.update(LOADER_CONFIG[scene][case], **extra)
    data = preloaded_arrays() if scene == "preloaded" else {}
    want = jdatasets.load_dataset(split, scenes[scene], JConfig(**kw), **data)
    got = tdatasets.load_dataset(split, scenes[scene], TConfig(**kw), device="cpu", **data)
    return want, got


@pytest.mark.parametrize("scene,split,case", CASES)
def test_loader_arrays_equal_jax(scenes, scene, split, case):
    """The images and every table beside them, the cameras (distortion and
    the NDC pixtocam among them), the lights, the view counts and sizes."""
    want, got = loader_pair(scenes, scene, split, case)
    assert type(got).__name__ == type(want).__name__
    for name in ARRAYS:
        w = getattr(want, name)
        assert (getattr(got, name) is None) == (w is None), name
        if w is not None:
            loaders._close_images(getattr(got, name), w, name)
    colmap_test._assert_cameras_equal(got, want)
    assert (got.num_images, got.height, got.width, got.near, got.far) == (
        want.num_images, want.height, want.width, want.near, want.far)
    if scene == "pixelrig":
        assert got.pixtocam_ndc is not None and (got.near, got.far) == (0.0, 1.0)


def _ndc_close(g, w, name):
    np.testing.assert_allclose(g, w, rtol=colmap_test.NDC_RTOL, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("scene", sorted(set(LOADER_CONFIG) - {"aerial_ring"}))
def test_first_batches_equal_jax(scenes, scene):
    """The first three train batches from the same seed (of the flattened
    table where the loader keeps one), rays cast on the host, then cast by
    the train step's caster against jnp's; one eval view of each split."""
    want, got = loader_pair(scenes, scene)
    for _ in range(3):
        loaders._assert_batch(got.next_train(), want.next_train(), loaders._exact)
    loaders._assert_batch(got.generate_ray_batch(1), want.generate_ray_batch(1), loaders._exact)
    want_test, got_test = loader_pair(scenes, scene, "test")
    loaders._assert_batch(got_test.generate_ray_batch(0), want_test.generate_ray_batch(0),
                          loaders._exact)

    want, got = loader_pair(scenes, scene, cast_rays_in_train_step=True)
    cast = loaders._in_step(got.config, got)
    close = _ndc_close if scene == "pixelrig" else colmap_test._in_step_close
    for _ in range(3):
        jbatch, tbatch = want.next_train(), got.next_train()
        assert isinstance(tbatch.rays, tpytrees.Pixels)
        jbatch = jbatch.replace(rays=colmap_test._jax_in_step(want, jbatch.rays))
        tbatch = tbatch.replace(rays=cast(None, tbatch.rays))
        loaders._assert_batch(tbatch, jbatch, close)


@pytest.mark.parametrize("scene,case", [("tat_nerfpp", 1), ("pixelrig", 1), ("aerial", 1),
                                        ("aerial_ring", 0)])
def test_render_path_views_equal_jax(scenes, scene, case):
    """The render-path cameras' eval views (NeRF++'s camera_path folder,
    PixelRig's ring in NDC, Aerial's orbit cameras and its ring), each
    view's rays bit for bit."""
    want, got = loader_pair(scenes, scene, "test", case)
    for i in range(min(got.num_images, got.camtoworlds.shape[0])):
        loaders._assert_batch(got.generate_ray_batch(i), want.generate_ray_batch(i),
                              loaders._exact)


def test_pixelrig_rays_are_in_ndc(scenes):
    """PixelRig's rays start on the NDC cube's near face (z = -1) and end on
    its far face after their direction (z = +1)."""
    _, got = loader_pair(scenes, "pixelrig")
    rays = got.generate_ray_batch(0).rays
    origins, directions = rays.origins.numpy(), rays.directions.numpy()
    np.testing.assert_allclose(origins[:, 2], -1.0)
    np.testing.assert_allclose(origins[:, 2] + directions[:, 2], 1.0)


def test_itof_masks_and_bins(scenes):
    """The iToF frames' four phases reach the batches as bins, and the dark
    rows are masked out."""
    _, got = loader_pair(scenes, "transient_simulation_itof")
    assert got.images_flattened.shape[1:] == (4, 3)
    assert got.masks[:, : H // 4].sum() == 0 and got.masks[:, H // 4:].all()
    assert got.next_train().rgb.shape == (24, 4, 3)


# --- DTU's projection matrices -------------------------------------------------------------


def _assert_decomposition(projection):
    want = cv2.decomposeProjectionMatrix(projection)[:3]
    got = tcam.decompose_projection_matrix(projection)
    for g, w, name in zip(got[:2], want[:2], ("K", "R")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10 * np.abs(w).max(), err_msg=name)
    assert got[2].dtype == want[2].dtype and got[2].shape == (4, 1)
    sign = np.sign(np.sum(got[2] * want[2]))
    np.testing.assert_allclose(sign * got[2], want[2], rtol=1e-6,
                               atol=1e-6 * np.abs(want[2]).max())
    center = lambda t: t[:3, 0].astype(np.float64) / t[3, 0]
    np.testing.assert_allclose(center(got[2]), center(want[2]),
                               rtol=1e-10 if projection.dtype == np.float64 else 1e-6)
    k = got[0] / got[0][2, 2]
    np.testing.assert_allclose(k @ got[1], projection[:, :3] / got[0][2, 2],
                               atol=1e-5 * np.abs(k).max())
    assert got[0][0, 0] > 0 and got[0][1, 1] > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(6))
def test_decompose_projection_matrix_equals_cv2(seed, dtype):
    """Random full-rank projections (each branch of the RQ sign fix among
    them), then DTU-like ones (a calibrated camera times a scale, either
    sign), against cv2's first three outputs."""
    rng = np.random.RandomState(seed)
    for _ in range(50):
        _assert_decomposition(rng.normal(size=(3, 4)).astype(dtype))
    for i, pose in enumerate(colmap_test._poses(8, seed, radius=5.0)):
        for sign in (1.0, -1.0):
            _assert_decomposition((sign * dtu_projection(pose, i)).astype(dtype))


def test_dtu_cameras_are_the_written_ones(scenes):
    """The DTU loader's intrinsics are the written camera's (its scale
    divided out), before the focus recentring of the poses."""
    _, got = loader_pair(scenes, "dtu", "test")
    k = np.linalg.inv(got.pixtocams[0].astype(np.float64))
    want = np.array([[28.9 + 1, 0.3, 8.23], [0, 28.8, 6.19], [0, 0, 1]])
    np.testing.assert_allclose(k, want, rtol=1e-5, atol=1e-5)


# --- the registry --------------------------------------------------------------------------


def test_every_loader_name_builds(monkeypatch):
    """`load_dataset` builds every name in LOADERS (no loader is refused),
    each the class of JAX's of that name; an unknown name raises."""
    for pkg in (jdatasets, tdatasets):
        monkeypatch.setattr(pkg.Dataset, "__init__", lambda self, *a, **k: None)
    for name in tdatasets.LOADERS:
        want = jdatasets.load_dataset("train", None, JConfig(dataset_loader=name))
        got = tdatasets.load_dataset("train", None, TConfig(dataset_loader=name))
        assert type(got).__name__ == type(want).__name__, name
        assert isinstance(got, tdatasets.Dataset)
    with pytest.raises(KeyError):
        tdatasets.load_dataset("train", None, TConfig(dataset_loader="nerf"))


def test_loaders_run_without_pil_or_jax(scenes):
    """The loaders read their scenes with PIL, OpenCV, imageio, h5py and JAX
    hidden (the card's machine has none of them)."""
    hidden = ("PIL", "cv2", "imageio", "h5py", "jax", "neural_radiance_caching_tpu")
    configs = {scene: dict(LOADER_CONFIG[scene][0], dataset_loader=LOADER_NAME.get(scene, scene))
               for scene in WRITERS}
    code = (
        "import sys\n"
        f"for m in {hidden!r}:\n"
        "    sys.modules[m] = None\n"
        "from neural_radiance_caching_tpu_torch.data import datasets\n"
        "from neural_radiance_caching_tpu_torch.engine.configs import Config\n"
        f"for scene, kw in {configs!r}.items():\n"
        f"    d = datasets.load_dataset('train', {scenes!r}[scene], Config(\n"
        "        batch_size=8, **kw), device='cpu')\n"
        "    assert d.next_train().rgb.shape[0] == 8\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


# --- nero_bell's material stage from disk (an open parity check) ---------------------------
#
# One `material_light_from_scratch` step of nero_ngp_yobo_bell.gin through
# both trainers from the NeRO glossy-synthetic scene of
# `test_torch_loaders.py`, held as `test_torch_material_trainer.py` holds
# its steps (loss terms to 1e-4 relative, the smoothness terms to 1e-3,
# gradient leaves to rtol 2e-3 with an absolute 2e-4 x the leaf's largest
# entry, the Adam step within 2 x the group's learning rate).

@pytest.fixture
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


# The leveled launches of one bell material step: the SLF's reflectance grid
# for the cache's queries along the secondary rays, at the surface points
# and at the primary rays' samples, in the backward's order.
BELL_LAUNCHES = ["leveled"] * 3


@pytest.fixture(scope="module")
def bell_dir(tmp_path_factory):
    return loaders.write_glossy(str(tmp_path_factory.mktemp("bell")))


def test_nero_bell_material_stage_from_disk(bell_dir, monkeypatch, clean_gin):
    """One `material_light_from_scratch` step of nero_ngp_yobo_bell.gin (its
    SLF narrowed) from the glossy-synthetic scene through both trainers,
    each package's batch from its own loader (the flattened pixel stream):
    every loss term, every gradient leaf, the Adam step, the launches."""
    material_trainer.from_disk(monkeypatch)
    bindings = loader_steps.bindings("nero_bell", bell_dir) + material_trainer.OPEN_CHECK_MATERIAL
    jt, jmodel, tt = material_trainer._trainers(loader_steps.BELL, bindings,
                                                 material_trainer.OPEN_CHECK_STAGE)
    assert type(tt.dataset).__name__ == "GlossySynthetic"
    got = material_trainer._step_parity(jt, jmodel, tt, material_trainer._variables(jmodel, 5),
                                        monkeypatch, BELL_LAUNCHES)
    extra = material_trainer.OPEN_CHECK_EXTRA
    assert [k for k in got if k in extra] == extra
    assert got["light_sampling"] != 0
