"""The port's loaders of real captures against the JAX package's, on
fixture scenes written here from numpy seeds (JPEGs by PIL, as cameras
write them): OpenCV's two resizes (`io.resize_lanczos4`,
`io.resize_nearest`) against cv2, `camera_utils.transform_poses_pca`
against JAX's, the PLY reader of NeRO's point clouds, and the `open_illum`,
`neilf` and `glossy_real` loaders (arrays, cameras, lights, the per-pixel
light index, the first three batches with rays cast on the host and in the
train step, one eval view, both splits, the configs' factors); and
open_ngp_yobo_egg.gin's cache and material steps from such an object on
disk through both trainers (their tolerances in their section).

Tolerances: the Lanczos-4 resize equals cv2 bit for bit on float32 and
float64 images, even and odd sizes, shrinking and enlarging (the stated
bound would be 1e-6; none is needed); the nearest resize, poses, point
clouds and intrinsics bit for bit; images, masks and the batches' rgb to 2
float32 ulps of white (`test_torch_loaders.IMAGE_TOL`: `srgb_to_linear`'s
float32 power runs in numpy here and in XLA there); rays cast on the host
bit for bit; rays cast in the train step to rtol 1e-6 with an absolute
1e-7.
"""

import json
import os
import pickle
import struct
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_loaders as loaders
import test_torch_material_trainer as material_trainer
import test_torch_slf_distance as slf_distance
from neural_radiance_caching_tpu.data import camera_utils as jcam
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.data import exr as jexr
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.engine.configs import Config as JConfig
from neural_radiance_caching_tpu_torch.data import camera_utils as tcam
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.data import io as io_lib
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees

OPENCV = np.diag([1.0, -1.0, -1.0, 1.0])


# --- OpenCV's resizes ----------------------------------------------------------------------

RESIZE_SIZES = [(1, 1), (5, 3), (32, 48), (33, 47)]


def _targets(h, w):
    return {"half": (max(w // 2, 1), max(h // 2, 1)), "third": (max(w // 3, 1), max(h // 3, 1)),
            "double": (2 * w, 2 * h)}


@pytest.mark.parametrize("target", ["half", "third", "double"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("h,w", RESIZE_SIZES)
def test_resize_lanczos4_equals_cv2(h, w, dtype, channels, target):
    """cv2.INTER_LANCZOS4 on float32 (the loader's images) and float64
    images, grey and RGB, even and odd sizes: bit for bit."""
    rng = np.random.RandomState(h * 100 + w)
    img = rng.rand(h, w, channels).squeeze(-1) if channels == 1 else rng.rand(h, w, channels)
    img = img.astype(dtype)
    size = _targets(h, w)[target]
    want = cv2.resize(img, size, interpolation=cv2.INTER_LANCZOS4)
    got = io_lib.resize_lanczos4(img, size)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", [(1536, 2048), (1535, 2047)])
def test_resize_lanczos4_equals_cv2_at_capture_size(h, w):
    """The open configs' factor 2 on a camera-sized float32 RGB view, even
    and odd."""
    img = np.random.RandomState(0).rand(h, w, 3).astype(np.float32)
    size = (w // 2, h // 2)
    np.testing.assert_array_equal(io_lib.resize_lanczos4(img, size),
                                  cv2.resize(img, size, interpolation=cv2.INTER_LANCZOS4))


@pytest.mark.parametrize("target", ["half", "third", "double"])
@pytest.mark.parametrize("h,w", RESIZE_SIZES + [(1535, 2047)])
def test_resize_nearest_equals_cv2(h, w, target):
    mask = (np.random.RandomState(w).rand(h, w) * 255).astype(np.uint8).astype(np.float32) / 255
    size = _targets(h, w)[target]
    want = cv2.resize(mask, size, interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(io_lib.resize_nearest(mask, size), want)


# --- poses and point clouds ----------------------------------------------------------------


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_poses_pca_equals_jax(seed, flip):
    """The principal-axis alignment, with the cameras' up along +z and
    turned upside down (the y / z flip branch)."""
    poses = tcam.generate_spherical_poses(7, radius=2.5 + seed, seed=seed).astype(np.float64)
    poses[:, :3, 3] += np.random.RandomState(seed).normal(size=3)
    if flip:
        poses = np.diag([1.0, -1.0, -1.0]) @ poses
    want = jcam.transform_poses_pca(poses.copy())
    got = tcam.transform_poses_pca(poses.copy())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def write_ply(path, points, fmt="binary_little_endian", faces=0):
    """A PLY point cloud: float x, y, z and normals, then `faces` faces
    (uchar count + int indices), as NeRO's `object_point_cloud.ply`."""
    n = len(points)
    normals = np.tile([0.0, 0.0, 1.0], (n, 1))
    header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"] + [
        f"property float {p}" for p in ("x", "y", "z", "nx", "ny", "nz")]
    if faces:
        header += [f"element face {faces}", "property list uchar int vertex_indices"]
    header.append("end_header")
    rows = np.concatenate([points, normals], 1).astype("<f4")
    tri = np.random.RandomState(n).randint(0, n, (faces, 3))
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if fmt == "ascii":
            f.write("".join(" ".join(f"{v:.6f}" for v in r) + "\n" for r in rows).encode())
            f.write("".join(f"3 {a} {b} {c}\n" for a, b, c in tri).encode())
        else:
            f.write(rows.tobytes())
            f.write(b"".join(struct.pack("<Biii", 3, *map(int, t)) for t in tri))


@pytest.mark.parametrize("faces", [0, 40])
@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_point_cloud_reader_equals_jax(fmt, faces, tmp_path):
    """JAX's PLY vertex reader and its quirks: the face element's property
    counts as a vertex property, so a binary file with faces is read with a
    wider record (the points come out shuffled); both packages read the
    same points."""
    points = np.random.RandomState(3).uniform(-0.5, 0.5, (50, 3))
    path = str(tmp_path / "cloud.ply")
    write_ply(path, points, fmt, faces)
    want = jdatasets.GlossyReal._load_point_cloud(None, path)
    got = tdatasets.GlossyReal._load_point_cloud(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if not (faces and fmt != "ascii"):
        np.testing.assert_allclose(got, points, atol=1e-6)


# --- fixture scenes ------------------------------------------------------------------------

OPEN_SIZE = (26, 34)  # the JPEGs' height and width: odd halves at factor 2
OPEN_VIEWS = {"train": 3, "test": 2}
NEILF_VIEWS = 12  # VALIDATION_INDEXES mod 12 hold out 6
NEILF_SIZE = (24, 32)
GLOSSY_VIEWS = 5
GLOSSY_SIZE = (24, 32)


def _jpeg(path, rgb, quality=95):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(path, "JPEG",
                                                                     quality=quality)


def _grey_png(path, values):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(values.astype(np.uint8)).save(path)


def write_open_illum(root, views=None, size=OPEN_SIZE, radius=1.2):
    """An OpenIllumination object: `output/transforms_{split}.json` (the
    OpenCV camera-to-world, per-frame intrinsics), the `.JPG` views of
    illumination 013 in `Lights/013/raw_undistorted/`, the `com_masks` and
    `obj_masks` grey PNGs (values across the 0.5 threshold and at 0).
    Returns the data_dir (`output`)."""
    views = views or OPEN_VIEWS
    h, w = size
    out = os.path.join(root, "obj_02_egg", "output")
    lights = os.path.join(root, "obj_02_egg", "Lights", "013", "raw_undistorted")
    for s, split in enumerate(("train", "test")):
        frames = []
        for i, c2w in enumerate(loaders._c2w(views[split], 60 + s, radius=radius)):
            m = np.eye(4)
            m[:3] = c2w
            name = f"CA{s}{i}"
            frames.append({"file_path": f"./images/{name}", "transform_matrix": (m @ OPENCV).tolist(),
                           "fl_x": 1.2 * w + i, "fl_y": 1.2 * w, "cx": w / 2 - 0.5, "cy": h / 2,
                           "w": w, "h": h})
            rng = np.random.RandomState(70 + 10 * s + i)
            _jpeg(os.path.join(lights, f"{name}.JPG"), rng.rand(h, w, 3))
            mask = rng.randint(0, 256, (h, w))
            mask[: h // 3] = 0
            for sub in ("com_masks", "obj_masks"):
                _grey_png(os.path.join(out, sub, f"{name}.png"), mask)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames}, f)
    return out


def write_neilf(root, views=NEILF_VIEWS, size=NEILF_SIZE, radius=2.0):
    """A NeILF++ scene: `sfm_scene.json` (OpenCV world-to-camera extrinsics,
    focal and principal point, flag 2 on every camera), `images/` with the
    first view a PNG, the second an EXR and the rest JPEGs."""
    h, w = size
    images, cameras = {}, {}
    for i, c2w in enumerate(loaders._c2w(views, 80, radius=radius)):
        m = np.eye(4)
        m[:3] = c2w
        key = str(i * 3 + 1)  # sparse, unsorted as strings
        images[key] = f"/capture/images/img_{i:03d}.JPG"
        cameras[key] = {"flg": 2, "camera": {
            "intrinsic": {"focal": [1.1 * w + i, 1.1 * w], "ppt": [w / 2, h / 2 + 0.5]},
            "extrinsic": np.linalg.inv(m @ OPENCV).reshape(-1).tolist()}}
        rng = np.random.RandomState(90 + i)
        prefix = os.path.join(root, "images", f"img_{i:03d}")
        if i == 0:
            loaders._write_png(prefix + ".png", rng.rand(h, w, 4))
        elif i == 1:
            jexr.write_exr(prefix + ".exr", rng.uniform(0, 2, (h, w, 3)).astype(np.float32))
        else:
            _jpeg(prefix + ".jpg", rng.rand(h, w, 3))
    with open(os.path.join(root, "sfm_scene.json"), "w") as f:
        json.dump({"camera_track_map": {"images": cameras},
                   "image_path": {"file_paths": images}}, f)
    return root


def write_glossy_real(root, views=GLOSSY_VIEWS, size=GLOSSY_SIZE, probe=(48, 64), radius=2.5):
    """A NeRO real capture in `root/bear`: `cache.pkl` (OpenCV
    world-to-camera [3, 4], intrinsics at the probe's size, names by id),
    the probe `images/<name>`, the views in `images_raw_1024/`, and
    `object_point_cloud.ply` (binary, with a face element)."""
    scene = os.path.join(root, "bear")
    h, w = size
    poses, ks, names = {}, {}, {}
    for i, c2w in enumerate(loaders._c2w(views, 95, radius=radius)):
        m = np.eye(4)
        m[:3] = c2w
        m[:3, 3] += [0.3, -0.2, 0.1]
        poses[i] = np.linalg.inv(m @ OPENCV)[:3]
        ks[i] = np.array([[1.2 * probe[1] + i, 0, probe[1] / 2], [0, 1.2 * probe[1], probe[0] / 2],
                          [0, 0, 1]])
        names[i] = f"IMG_{i:04d}.jpg"
        _jpeg(os.path.join(scene, "images_raw_1024", names[i]),
              np.random.RandomState(100 + i).rand(h, w, 3))
    _jpeg(os.path.join(scene, "images", names[1]), np.random.RandomState(99).rand(*probe, 3))
    with open(os.path.join(scene, "cache.pkl"), "wb") as f:
        pickle.dump((poses, ks, names, None), f)
    cloud = np.random.RandomState(98).normal(size=(64, 3)) * 0.2 + [0.3, -0.2, 0.1]
    write_ply(os.path.join(scene, "object_point_cloud.ply"), cloud, faces=40)
    return scene


WRITERS = {"open_illum": write_open_illum, "neilf": write_neilf, "glossy_real": write_glossy_real}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("real_scenes")
    out = {}
    for name, write in WRITERS.items():
        os.makedirs(root / name)
        out[name] = write(str(root / name))
    return out


# Each loader's config fields: open_ngp_yobo.gin, neilf_ngp_yobo.gin,
# glossy_ngp_yobo.gin (their near and far planes and factors).
LOADER_CONFIG = {
    "open_illum": dict(near=0.25, far=2.0, factor=2),
    "neilf": dict(near=0.25, far=2.0, factor=4),
    "glossy_real": dict(near=0.1, far=15.0, factor=0),
}
# Other factors: odd (3), the test split's own (test_factor), none.
FACTOR_CASES = {"open_illum": [{}, dict(factor=3), dict(test_factor=4)],
                "neilf": [{}, dict(factor=0)], "glossy_real": [{}, dict(factor=2)]}
ARRAYS = loaders.ARRAYS + ("light_idx",)


def loader_pair(scenes, loader, split="train", **extra):
    kw = dict(dataset_loader=loader, batch_size=32, **dict(LOADER_CONFIG[loader], **extra))
    want = jdatasets.load_dataset(split, scenes[loader], JConfig(**kw))
    got = tdatasets.load_dataset(split, scenes[loader], TConfig(**kw), device="cpu")
    return want, got


CASES = [(loader, split, i) for loader in sorted(LOADER_CONFIG) for split in ("train", "test")
         for i in range(len(FACTOR_CASES[loader]))]


@pytest.mark.parametrize("loader,split,case", CASES)
def test_loader_arrays_equal_jax(scenes, loader, split, case):
    """The loaded images and masks, the light index, the cameras and the
    lights, at the config's factor and the others of FACTOR_CASES."""
    extra = FACTOR_CASES[loader][case]
    want, got = loader_pair(scenes, loader, split, **extra)
    for name in ARRAYS:
        w = getattr(want, name, None)
        assert (getattr(got, name) is None) == (w is None), name
        if w is None:
            continue
        if name == "light_idx":
            assert got.light_idx.dtype == w.dtype
            np.testing.assert_array_equal(got.light_idx, w)
        else:
            loaders._close_images(getattr(got, name), w, name)
    for name in ("pixtocams", "camtoworlds", "lights"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.num_images, got.height, got.width) == (want.num_images, want.height, want.width)
    if loader == "open_illum":
        factor = (extra.get("test_factor") if split == "test" else None) or extra.get("factor", 2)
        assert (got.height, got.width) == (OPEN_SIZE[0] // factor, OPEN_SIZE[1] // factor)
        assert set(np.unique(got.masks)) == {0.0, 1.0}
    if loader == "neilf":
        assert got.num_images == 6


@pytest.mark.parametrize("loader", sorted(LOADER_CONFIG))
def test_first_batches_equal_jax(scenes, loader):
    """The first three train batches from the same seed, rays cast on the
    host, then again with Config.cast_rays_in_train_step (Pixels, cast by
    the train step's caster against jnp's cast); one eval view of each
    split."""
    want, got = loader_pair(scenes, loader)
    for _ in range(3):
        loaders._assert_batch(got.next_train(), want.next_train(), loaders._exact)
    loaders._assert_batch(got.generate_ray_batch(1), want.generate_ray_batch(1), loaders._exact)
    want_test, got_test = loader_pair(scenes, loader, "test")
    loaders._assert_batch(got_test.generate_ray_batch(0), want_test.generate_ray_batch(0),
                          loaders._exact)

    want, got = loader_pair(scenes, loader, cast_rays_in_train_step=True)
    cast = loaders._in_step(got.config, got)
    cams = tuple(jnp.asarray(c) if c is not None else None for c in want.cameras)
    for _ in range(3):
        jbatch, tbatch = want.next_train(), got.next_train()
        assert isinstance(tbatch.rays, tpytrees.Pixels)
        jbatch = jbatch.replace(rays=jcam.cast_ray_batch(cams, jnp.asarray(want.lights),
                                                         jbatch.rays, xnp=jnp))
        tbatch = tbatch.replace(rays=cast(None, tbatch.rays))
        assert tbatch.rays.directions.dtype == torch.float32

        def close(g, w, name):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=name)

        loaders._assert_batch(tbatch, jbatch, close)


def test_light_index_reaches_the_pixels(scenes):
    """The per-pixel light index a loader keeps is what its batches carry
    (0 for OpenIllumination's one illumination; a planted index shows)."""
    _, got = loader_pair(scenes, "open_illum")
    got.light_idx = got.light_idx + np.arange(got.num_images)[:, None, None, None].astype(np.int32)
    batch = got.next_train()
    np.testing.assert_array_equal(batch.rays.light_idx.numpy()[:, 0],
                                  batch.rays.cam_idx.numpy()[:, 0])


def test_loader_refusals(scenes, tmp_path):
    """A NeILF++ view in TIFF raises by name. OpenIllumination's other
    illuminations (`test_torch_multi_illum.py`) and the relighting env maps
    (`test_torch_relight_inputs.py`) are read: on an object without their
    views both packages fail alike."""
    kw = dict(dataset_loader="open_illum", batch_size=8, multi_illumination=True)
    with pytest.raises(FileNotFoundError, match="Lights/011"):
        jdatasets.load_dataset("train", scenes["open_illum"], JConfig(**kw))
    with pytest.raises(FileNotFoundError, match="Lights/011"):
        tdatasets.load_dataset("train", scenes["open_illum"], TConfig(**kw), device="cpu")
    kw = dict(dataset_loader="open_illum", batch_size=8, compute_relight_metrics=True)
    with pytest.raises(FileNotFoundError, match="Lights/sunset"):
        jdatasets.load_dataset("train", scenes["open_illum"], JConfig(**kw))
    with pytest.raises(FileNotFoundError, match="Lights/sunset"):
        tdatasets.load_dataset("train", scenes["open_illum"], TConfig(**kw), device="cpu")
    root = write_neilf(str(tmp_path))
    os.remove(os.path.join(root, "images", "img_007.jpg"))
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(os.path.join(root, "images",
                                                                     "img_007.tiff"))
    with pytest.raises(NotImplementedError, match="TIFF"):
        tdatasets.load_dataset("train", root, TConfig(dataset_loader="neilf", batch_size=8),
                               device="cpu")


def test_loaders_run_without_pil_or_jax(scenes):
    """The three loaders read their scenes with PIL, OpenCV, imageio, h5py
    and JAX hidden (the card's machine has none of them)."""
    hidden = ("PIL", "cv2", "imageio", "h5py", "jax", "neural_radiance_caching_tpu")
    code = (
        "import sys\n"
        f"for m in {hidden!r}:\n"
        "    sys.modules[m] = None\n"
        "from neural_radiance_caching_tpu_torch.data import datasets\n"
        "from neural_radiance_caching_tpu_torch.engine.configs import Config\n"
        f"for loader, kw in {LOADER_CONFIG!r}.items():\n"
        f"    d = datasets.load_dataset('train', {scenes!r}[loader], Config(\n"
        "        dataset_loader=loader, batch_size=8, **kw), device='cpu')\n"
        "    assert d.next_train().rgb.shape == (8, 3)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


# --- steps from disk ---------------------------------------------------------------------
#
# open_ngp_yobo_egg.gin from an OpenIllumination object on disk (written by
# `write_open_illum`), through both trainers: one cache step, and one step
# of its material stage (`material_light_from_scratch` with resampling),
# each package's batch from its own loader of the same files, at the
# config's own near 0.25 and far 2.0. The models run at test widths
# (`test_torch_trainer.NGP_TINY` with the scene's surface light field
# narrowed as `test_torch_slf_distance.py` narrows it,
# `test_torch_material_trainer.MATERIAL_TINY`), reading the views at
# `Config.factor = 4`. Tolerances as in `test_torch_material_trainer.py`:
# loss terms to 1e-4 relative with an absolute 1e-7 (the smoothness terms to
# 1e-3), every gradient leaf to rtol 2e-3 with an absolute 2e-4 x the
# leaf's largest entry, after the trainer's Adam step a parameter within 2 x
# its group's learning rate of optax's.

OPEN = ["configs/open_ngp_yobo_egg.gin"]
# The fixture's views at 2.5 x the test fixture's size, so that factor 4
# keeps 16 x 21 pixels; the cameras 1.2 from the object, inside far 2.
SIZE = (64, 84)


@pytest.fixture
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


@pytest.fixture(scope="module")
def egg_dir(tmp_path_factory):
    return write_open_illum(str(tmp_path_factory.mktemp("egg")), size=SIZE)


def bindings(data_dir):
    return slf_distance.scene_bindings(OPEN) + [
        "Config.dataset_loader = 'open_illum'", f"Config.data_dir = '{data_dir}'",
        "Config.near = 0.25"]


def test_one_cache_step_from_disk_through_both_trainers(egg_dir, monkeypatch, clean_gin):
    """One cache step from the same weights and draws: every loss term (the
    mask losses of the `com_masks` among them), every gradient leaf, the
    Adam step, and the step's two leveled launches (the SLF's reflectance
    grid and its own grid)."""
    material_trainer.from_disk(monkeypatch)
    jt, jmodel, tt = material_trainer._trainers(OPEN, bindings(egg_dir), "cache")
    assert type(tt.dataset).__name__ == "OpenIllum"
    assert (tt.config.near, tt.config.far) == (0.25, 2.0)
    assert tt.dataset.images.shape[1:3] == (SIZE[0] // 4, SIZE[1] // 4)
    got = material_trainer._step_parity(jt, jmodel, tt, material_trainer._variables(jmodel, 5),
                                        monkeypatch, ["leveled", "leveled"])
    assert {"data", "cache_data", "mask", "cache_mask"} <= set(got)
    assert got["mask"] > 0


# The leveled launches of one material step: the SLF's reflectance grid (at
# 8 points per query) and its own grid, for its queries along the secondary
# rays (batch x num_secondary_samples), at the surface points (one per
# ray) and at the primary rays' final samples, in the backward's order.
MATERIAL_LAUNCHES = ["leveled"] * 6


def test_one_material_step_from_disk_through_both_trainers(egg_dir, monkeypatch, clean_gin):
    """The README's second stage, `material_light_from_scratch` with
    resampling, one step from the same weights and draws: every loss term,
    every gradient leaf, the Adam step, the step's leveled launches."""
    material_trainer.from_disk(monkeypatch)
    jt, jmodel, tt = material_trainer._trainers(
        OPEN, bindings(egg_dir) + material_trainer.MATERIAL_TINY + material_trainer.MATERIAL
        + material_trainer.SMOOTH, "material_light_from_scratch")
    assert type(tt.dataset).__name__ == "OpenIllum"
    got = material_trainer._step_parity(jt, jmodel, tt, material_trainer._variables(jmodel, 5),
                                        monkeypatch, MATERIAL_LAUNCHES)
    extra = ["material_ray_sampler", "material_smoothness", "light_sampling",
             "direct_indirect_consistency"]
    assert [k for k in got if k in extra] == extra
    assert got["light_sampling"] != 0 and got["material_smoothness"] != 0
