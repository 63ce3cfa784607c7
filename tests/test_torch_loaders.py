"""The port's loaders of posed images against the JAX package's, on
fixture scenes written here from numpy seeds: the PNG reader (against PIL,
which reads every PNG for the JAX package), the EXR codec, the pose loader
of transforms JSONs, and the `blender`, `blender_active`, `orb` and
`glossy_synthetic` loaders (arrays, cameras, lights, the first three
batches with rays cast on the host and in the train step, one eval view).

Tolerances: decoded pixels, EXR samples, poses and intrinsics bit for
bit; images, masks and the buffers beside them to 2 float32 ulps of white,
relative and absolute (2.4e-7): `srgb_to_linear`'s float32 power runs in
numpy here and in XLA there, 1 ulp apart at most, and compositing on white
with a fractional alpha that went through it too (NeRO without a depth
image) moves a dark pixel by up to 8 of its own ulps; the batches' rgb
alike; rays cast on the host bit for bit
(the same numpy operations on the same cameras); rays cast in the train
step (jnp against torch, float32) to rtol 1e-6 with an absolute 1e-7.
"""

import dataclasses
import io
import json
import os
import pickle
import struct
import subprocess
import sys
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neural_radiance_caching_tpu.data import camera_utils as jcam
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.data import exr as jexr
from neural_radiance_caching_tpu.engine.configs import Config as JConfig
from neural_radiance_caching_tpu_torch.data import camera_utils as tcam
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.data import exr as texr
from neural_radiance_caching_tpu_torch.data import png
from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees

RES = 16
VIEWS = 3


# --- the test's own PNG encoder ------------------------------------------------------------


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter(raw, bpp, kinds):
    """Each scanline of `raw` [H, stride] uint8 under its filter in `kinds`."""
    r = raw.astype(np.int16)
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :-bpp]
    b = np.zeros_like(r)
    b[1:] = r[:-1]
    c = np.zeros_like(r)
    c[1:, bpp:] = r[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(r), a, b, (a + b) // 2, paeth)
    return np.stack([(r[y] - preds[k][y]) % 256 for y, k in enumerate(kinds)]).astype(np.uint8)


def encode_png(samples, color, depth, filters="cycle", interlace=0):
    """PNG bytes of `samples` [H, W, channels] (ints below 2**depth), each
    scanline under filter `filters` (0-4) or the five in turn ("cycle")."""
    h, w = samples.shape[:2]
    flat = samples.reshape(h, w, -1)
    if depth == 16:
        raw = flat.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        raw = flat.astype(np.uint8).reshape(h, -1)
    bpp = raw.shape[1] // w
    kinds = [y % 5 if filters == "cycle" else filters for y in range(h)]
    rows = _filter(raw, bpp, kinds)
    data = b"".join(bytes([k]) + row.tobytes() for k, row in zip(kinds, rows))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"tEXt", b"Comment\x00fixture")
            + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


def _pil(buf):
    return np.array(Image.open(io.BytesIO(buf)))


CASES = [(color, depth) for color in (0, 2, 4, 6) for depth in (8, 16)]


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "cycle"])
@pytest.mark.parametrize("color,depth", CASES)
def test_png_reader_equals_pil(color, depth, filters):
    """Every colour type at 8 and 16 bits under each filter: PIL's array,
    dtype and all (16-bit RGB and RGBA keep their high bytes, 16-bit grey +
    alpha becomes RGBA, 16-bit grey keeps its values)."""
    rng = np.random.RandomState(color * 100 + depth)
    samples = rng.randint(0, 2**depth, (23, 37, png.CHANNELS[color]))
    # Smooth stretches too, where the predictors are near their inputs.
    samples[::3] = (np.arange(37)[:, None] * 7 + np.arange(png.CHANNELS[color])) % 2**depth
    buf = encode_png(samples, color, depth, filters)
    want = _pil(buf)
    got = png.decode_png(buf)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["L", "RGB", "LA", "RGBA", "I;16"])
def test_png_reader_equals_pil_on_pil_files(mode, tmp_path):
    """Files PIL writes (its own adaptive filters) read as PIL reads them."""
    rng = np.random.RandomState(3)
    y, x = np.mgrid[:41, :29]
    channels = {"L": 1, "RGB": 3, "LA": 2, "RGBA": 4, "I;16": 1}[mode]
    smooth = np.stack([(x * 3 + y * (k + 1)) % 256 for k in range(channels)], -1)
    arr = np.where(rng.rand(41, 29, 1) < 0.2, rng.randint(0, 256, smooth.shape), smooth)
    if mode == "I;16":
        img = Image.fromarray((arr[..., 0] * 251).astype(np.uint16))
    else:
        img = Image.fromarray(arr.astype(np.uint8).squeeze(-1) if channels == 1
                              else arr.astype(np.uint8), mode)
    path = tmp_path / "pil.png"
    img.save(path)
    want = np.array(Image.open(path))
    got = png.read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_png_reader_refusals(tmp_path):
    """Palette files, bit depths under 8 and interlaced files raise, naming
    what they are."""
    path = tmp_path / "p.png"
    Image.fromarray(np.arange(64, dtype=np.uint8).reshape(8, 8)).convert("P").save(path)
    with pytest.raises(ValueError, match="palette"):
        png.read_png(path)
    Image.fromarray(np.eye(8, dtype=bool)).save(path)
    with pytest.raises(ValueError, match="bit depth 1"):
        png.read_png(path)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(encode_png(np.zeros((4, 4, 3), int), 2, 8, interlace=1))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")


# --- EXR -----------------------------------------------------------------------------------

EXR_LINES = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def _exr_zip(raw):
    """The EXR zip predictor: interleave the halves, delta + 128, zlib."""
    t = np.frombuffer(raw, np.uint8)
    t = np.concatenate([t[0::2], t[1::2]]).astype(np.int16)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) % 256
    return zlib.compress(d.astype(np.uint8).tobytes())


def write_exr(path, image, pixel_type, compression):
    """A scanline EXR of `image` [H, W, C] with HALF (1) or FLOAT (2)
    samples, NONE (0), ZIPS (2) or ZIP (3) compression."""
    h, w, c = image.shape
    names = sorted(["R", "G", "B", "A"][:c])
    order = ["R", "G", "B", "A"]
    dtype = {1: np.float16, 2: np.float32}[pixel_type]

    def attr(name, kind, payload):
        return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(payload)) \
            + payload

    chlist = b"".join(n.encode() + b"\0" + struct.pack("<iiii", pixel_type, 0, 1, 1)
                      for n in names) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join([
        attr("channels", "chlist", chlist),
        attr("compression", "compression", bytes([compression])),
        attr("dataWindow", "box2i", box), attr("displayWindow", "box2i", box),
        attr("lineOrder", "lineOrder", b"\0"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0))]) + b"\0"
    lines = EXR_LINES[compression]
    blocks = []
    for y0 in range(0, h, lines):
        data = b"".join(image[y, :, order.index(n)].astype(dtype).tobytes()
                        for y in range(y0, min(y0 + lines, h)) for n in names)
        if compression:
            packed = _exr_zip(data)
            data = packed if len(packed) < len(data) else data
        blocks.append(struct.pack("<ii", y0, len(data)) + data)
    preamble = struct.pack("<ii", jexr.MAGIC, 2) + header
    offset = len(preamble) + 8 * len(blocks)
    offsets = []
    for b in blocks:
        offsets.append(offset)
        offset += len(b)
    with open(path, "wb") as f:
        f.write(preamble + struct.pack(f"<{len(blocks)}q", *offsets) + b"".join(blocks))


@pytest.mark.parametrize("pixel_type,compression", [(1, 0), (2, 0), (1, 2), (2, 2), (1, 3),
                                                    (2, 3), ("jax", 0)])
def test_exr_reader_equals_jax(pixel_type, compression, tmp_path):
    """HALF and FLOAT files, uncompressed (also as JAX's `write_exr` writes
    them), ZIPS and ZIP: the port's reader gives JAX's array and the
    written samples."""
    rng = np.random.RandomState(7)
    image = rng.uniform(-2, 6, (21, 13, 3)).astype(np.float32)
    image[5:9] = 1.5  # runs that the zip predictor compresses
    path = str(tmp_path / "img.exr")
    if pixel_type == "jax":
        jexr.write_exr(path, image)
        written = image
    else:
        write_exr(path, image, pixel_type, compression)
        written = image.astype(np.float16).astype(np.float32) if pixel_type == 1 else image
    got = texr.read_exr(path)
    np.testing.assert_array_equal(got, jexr.read_exr(path))
    np.testing.assert_array_equal(got, written)
    texr.write_exr(path, image[..., :2])
    np.testing.assert_array_equal(texr.read_exr(path), image[..., :2])


# --- the pose loader -----------------------------------------------------------------------


def _c2w(n, seed, radius=4.0):
    return tcam.generate_spherical_poses(n, radius=radius, seed=seed)


def _write_png(path, rgba):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((np.clip(rgba, 0, 1) * 255).astype(np.uint8)).save(path)


POSE_CASES = {
    "camera_angle_x": ({"camera_angle_x": 0.69, "w": RES, "h": RES}, {}),
    "fl_x": ({"fl_x": 20.5, "cx": 7.5, "cy": 8.25, "w": RES, "h": RES}, {}),
    "focal_in_mm": ({"focal_in_mm": 35.0, "sensor_size_horizontal_in_mm": 32.0, "w": RES,
                     "h": RES}, {}),
    "per_frame": ({"w": RES, "h": RES}, {"fl_x": 19.0, "fl_y": 21.0, "cx": 8.0, "cy": 7.0}),
    "probe_png": ({"camera_angle_x": 0.69, "camera_angle_y": 0.6}, {}),
    "probe_exr": ({"camera_angle_x": 0.69}, {}),
    "num_dataset_images": ({"camera_angle_x": 0.69, "w": RES, "h": RES}, {}),
    "distortion": ({"camera_angle_x": 0.69, "w": RES, "h": RES, "k1": 0.1, "p2": 0.01}, {}),
    "camera_type": ({"camera_angle_x": 0.69, "w": RES, "h": RES, "camera_type": "fisheye"},
                    {}),
}


@pytest.mark.parametrize("case", sorted(POSE_CASES))
def test_load_ngp_posedata_equals_jax(case, tmp_path):
    meta, per_frame = POSE_CASES[case]
    poses = _c2w(4, 5)
    frames = []
    for i, pose in enumerate(poses):
        m = np.eye(4)
        m[:3] = pose
        frames.append(dict(per_frame, file_path=f"train/r_{i}", transform_matrix=m.tolist()))
        if per_frame:
            frames[-1]["fl_x"] += i
        rgba = np.random.RandomState(i).rand(RES - 4, RES, 4)
        if case == "probe_exr":
            os.makedirs(tmp_path / "train", exist_ok=True)
            texr.write_exr(str(tmp_path / f"train/r_{i}.exr"), rgba)
        else:
            _write_png(str(tmp_path / f"train/r_{i}.png"), rgba)
    with open(tmp_path / "transforms.json", "w") as f:
        json.dump(dict(meta, frames=frames), f)
    n = 2 if case == "num_dataset_images" else -1
    want = jdatasets.load_ngp_posedata(JConfig(num_dataset_images=n), str(tmp_path))
    got = tdatasets.load_ngp_posedata(TConfig(num_dataset_images=n), str(tmp_path))
    assert got[0] == want[0] and got[5] == want[5]
    assert got[4].value == want[4].value
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[3] is None) == (want[3] is None)
    if want[3] is not None:
        assert got[3] == want[3]
    assert len(got[1]) == (2 if n == 2 else 4)


@pytest.mark.parametrize("case,match", [("distortion", "k1, k2, p1, p2"),
                                        ("camera_type", "'fisheye_equisolid' camera_type")])
def test_blender_refuses_distortion_and_other_cameras(case, match, tmp_path):
    """A blender scene whose transforms carry distortion or a fisheye
    camera_type loads as in JAX: the distortion keys (`match` lists them)
    and the camera type kept, the cameras and the host cast's rays equal to
    JAX's (no cast reads the camera type: `test_torch_colmap.py`)."""
    meta, _ = POSE_CASES[case]
    frames = []
    for split in ("train", "test"):
        for i, pose in enumerate(_c2w(2, 1)):
            m = np.eye(4)
            m[:3] = pose
            frames.append(dict(file_path=f"{split}/r_{i}", transform_matrix=m.tolist()))
            _write_png(str(tmp_path / f"{split}/r_{i}.png"), np.ones((RES, RES, 4)))
        with open(tmp_path / f"transforms_{split}.json", "w") as f:
            json.dump(dict(meta, frames=frames[-2:]), f)
    kw = dict(dataset_loader="blender", batch_size=8, near=2.0, far=6.0)
    want = jdatasets.load_dataset("train", str(tmp_path), JConfig(**kw))
    got = tdatasets.load_dataset("train", str(tmp_path), TConfig(**kw), device="cpu")
    if case == "distortion":
        assert ", ".join(got.distortion_params) == match
        assert got.distortion_params == want.distortion_params
    else:
        assert f"'{got.camtype.value}' camera_type" == match
        assert got.camtype.value == want.camtype.value
    _assert_batch(got.next_train(), want.next_train(), _exact)


# --- fixture scenes ------------------------------------------------------------------------


def _transforms(poses, split, suffix="", **meta):
    frames = []
    for i, pose in enumerate(poses):
        m = np.eye(4, dtype=np.float32)
        m[:3, :4] = pose
        frames.append({"file_path": f"{split}/r_{i}{suffix}", "transform_matrix": m.tolist()})
    return dict(meta, frames=frames)


def write_blender(root, suffix="", aux=False):
    """A TensoIR-style blender scene: `transforms_{split}.json` with
    camera_angle_x, RGBA PNGs (with `aux`, normal and albedo PNGs beside
    them, the image named `..._rgba`)."""
    for s, split in enumerate(("train", "test")):
        meta = _transforms(_c2w(VIEWS, 3 + s), split, suffix,
                           camera_angle_x=float(2 * np.arctan(0.5 / 1.2)), w=RES, h=RES)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
        for i in range(VIEWS):
            rng = np.random.RandomState(10 * s + i)
            _write_png(os.path.join(root, split, f"r_{i}{suffix}.png"), rng.rand(RES, RES, 4))
            if aux:
                for kind in ("normal", "albedo"):
                    _write_png(os.path.join(root, split, f"r_{i}_{kind}.png"),
                               rng.rand(RES, RES, 4))
    return root


def write_orb(root):
    """An ORB scene: per-frame intrinsics, RGB EXR images (values past the
    clip at 4) and `{split}_mask` PNGs."""
    for s, split in enumerate(("train", "test")):
        meta = _transforms(_c2w(VIEWS + 1 - s, 7 + s, radius=3.0), split,
                           fl_x=18.0, fl_y=19.0, cx=8.0, cy=7.5, w=RES, h=RES)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(len(meta["frames"])):
            rng = np.random.RandomState(20 + 10 * s + i)
            jexr.write_exr(os.path.join(root, split, f"r_{i}.exr"),
                           rng.uniform(0, 5, (RES, RES, 3)).astype(np.float32))
            mask = (rng.rand(RES, RES) * 255).astype(np.uint8)
            path = os.path.join(root, f"{split}_mask", f"r_{i}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(mask).save(path)
    return root


def write_glossy(root, n=4):
    """A NeRO glossy-synthetic scene in `root/bell`: `{i}-camera.pkl`
    (OpenCV world-to-camera and intrinsics), RGBA PNGs, 16-bit depth PNGs
    (all but the last image, whose mask comes from its alpha), and the split
    file beside the scene."""
    scene = os.path.join(root, "bell")
    os.makedirs(scene, exist_ok=True)
    with open(os.path.join(root, "synthetic_split_128.pkl"), "wb") as f:
        pickle.dump((["3", "1"], ["0", "2"]), f)
    k = np.array([[20.0, 0, 8.0], [0, 20.0, 8.0], [0, 0, 1]])
    for i, c2w in enumerate(_c2w(n, 11, radius=2.5)):
        c2w_cv = np.eye(4)
        c2w_cv[:3] = c2w
        c2w_cv = c2w_cv @ np.diag([1.0, -1.0, -1.0, 1.0])
        with open(os.path.join(scene, f"{i}-camera.pkl"), "wb") as f:
            pickle.dump((np.linalg.inv(c2w_cv)[:3], k), f)
        rng = np.random.RandomState(40 + i)
        _write_png(os.path.join(scene, f"{i}.png"), rng.rand(RES, RES, 4))
        if i < n - 1:
            depth = rng.uniform(2, 15, (RES, RES))
            Image.fromarray((depth / 15 * 65535).astype(np.uint16)).save(
                os.path.join(scene, f"{i}-depth.png"))
    return scene


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    out = {}
    for name, write in (("blender", write_blender), ("orb", write_orb),
                        ("glossy_synthetic", write_glossy)):
        os.makedirs(root / name)
        out[name] = write(str(root / name))
    os.makedirs(root / "blender_active")
    out["blender_active"] = write_blender(str(root / "blender_active"), "_rgba", aux=True)
    return out


LOADER_CONFIG = {
    "blender": dict(near=2.0, far=6.0),
    "blender_active": dict(near=2.0, far=6.0, compute_normal_metrics=True,
                           compute_albedo_metrics=True),
    "orb": dict(near=0.25, far=2.0, use_exrs=True),
    "glossy_synthetic": dict(near=1.0, far=4.0),
}
ARRAYS = ("images", "masks", "alphas", "normal_images", "albedo_images", "mask_images",
          "depth_images", "images_flattened", "indices_flattened", "light_idx_flattened")


def loader_pair(scenes, loader, split="train", factor=0, **extra):
    kw = dict(dataset_loader=loader, batch_size=32, factor=factor, **LOADER_CONFIG[loader],
              **extra)
    want = jdatasets.load_dataset(split, scenes[loader], JConfig(**kw))
    got = tdatasets.load_dataset(split, scenes[loader], TConfig(**kw), device="cpu")
    return want, got


# 2 float32 ulps of white (1.0).
IMAGE_TOL = 2 * float(np.spacing(np.float32(1)))


def _close_images(got, want, name):
    assert got.dtype == np.asarray(want).dtype, name
    np.testing.assert_allclose(got, np.asarray(want), rtol=IMAGE_TOL, atol=IMAGE_TOL,
                               err_msg=name)


LOADER_CASES = [(loader, split, factor) for loader in sorted(LOADER_CONFIG)
                for split in ("train", "test") for factor in (0, 4)]


@pytest.mark.parametrize("loader,split,factor", LOADER_CASES)
def test_loader_arrays_equal_jax(scenes, loader, split, factor):
    """The loaded images (and every buffer beside them), the cameras and
    the lights, at factor 0 and 4 (blender keeps the JSON's intrinsics at
    factor 4, as JAX does; ORB scales them)."""
    want, got = loader_pair(scenes, loader, split, factor)
    for name in ARRAYS:
        w = getattr(want, name)
        assert (getattr(got, name) is None) == (w is None), name
        if w is not None:
            _close_images(getattr(got, name), w, name)
    for name in ("pixtocams", "camtoworlds", "lights"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.num_images, got.height, got.width) == (want.num_images, want.height, want.width)
    if factor == 4 and loader != "glossy_synthetic":
        assert got.height == RES // 4
    if loader == "orb":
        assert got.images.max() <= 4.0 and set(np.unique(got.masks)) <= {0.0, 1.0}


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_batch(got, want, rays):
    """A port batch (tensors) against JAX's (host arrays): the supervision
    fields, and the rays' fields with `rays(got, want, field)`."""
    for f in dataclasses.fields(want):
        if f.name == "rays":
            continue
        w = getattr(want, f.name)
        assert (getattr(got, f.name) is None) == (w is None), f.name
        if w is not None:
            _close_images(_host(getattr(got, f.name)), np.asarray(w, np.float32), f.name)
    for f in dataclasses.fields(want.rays):
        w = getattr(want.rays, f.name)
        assert (getattr(got.rays, f.name) is None) == (w is None), f.name
        if w is not None:
            rays(_host(getattr(got.rays, f.name)), np.asarray(w), f.name)


def _exact(g, w, name):
    w = w.astype(np.float32) if w.dtype == np.float64 else w
    np.testing.assert_array_equal(g, w, err_msg=name)


def _in_step(config, dataset):
    """The train step's ray caster over `dataset` (the model on the CPU)."""
    model = types.SimpleNamespace(parameters=lambda: iter([torch.zeros(1)]))
    return ttrain._ray_caster(config, dataset, model)


@pytest.mark.parametrize("loader,factor", [(loader, factor) for loader in sorted(LOADER_CONFIG)
                                           for factor in (0, 4)])
def test_first_batches_equal_jax(scenes, loader, factor):
    """The first three train batches from the same seed, rays cast on the
    host, then again with Config.cast_rays_in_train_step (Pixels, cast by
    the train step's caster against jnp's cast); one eval view."""
    want, got = loader_pair(scenes, loader, factor=factor)
    for _ in range(3):
        _assert_batch(got.next_train(), want.next_train(), _exact)
    _assert_batch(got.generate_ray_batch(1), want.generate_ray_batch(1), _exact)

    want, got = loader_pair(scenes, loader, factor=factor, cast_rays_in_train_step=True)
    cast = _in_step(got.config, got)
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

        _assert_batch(tbatch, jbatch, close)


def test_blender_factor_quirk_is_kept(scenes):
    """At factor 4 the blender intrinsics stay the JSON's (16 pixels wide,
    principal point at 8), so the rays of the 4-pixel-wide images stay left
    of the view's centre, in both packages; ORB's are scaled, and its rays
    sit around the centre."""
    for loader, centred in (("blender", False), ("orb", True)):
        want, got = loader_pair(scenes, loader, factor=4)
        x = got.generate_ray_batch(0).rays.imageplane[:, 0].numpy()
        _exact(x, want.generate_ray_batch(0).rays.imageplane[:, 0], loader)
        if centred:
            assert abs(x.mean()) < 1e-6
        else:
            assert x.max() < 0


# The loaders `test_torch_colmap.py` (llff) and `test_torch_more_loaders.py`
# hold against JAX's.
COLMAP_SLICE_LOADERS = ("aerial", "dtu", "fipt_real", "fipt_synthetic", "llff", "pixelrig",
                        "preloaded", "real", "rtmv", "tat_fvs", "tat_nerfpp",
                        "transient_simulation_itof")


@pytest.mark.parametrize("name", COLMAP_SLICE_LOADERS)
def test_other_loaders_raise_by_name(name):
    """Each of these loaders, built by name, fails on a missing scene as
    JAX's does (the same exception), none as a loader not ported."""
    with pytest.raises(Exception) as want:
        jdatasets.load_dataset("train", "/nonexistent", JConfig(dataset_loader=name))
    with pytest.raises(type(want.value)) as got:
        tdatasets.load_dataset("train", "/nonexistent", TConfig(dataset_loader=name),
                               device="cpu")
    assert "not ported" not in str(got.value)


def test_loader_refusals(scenes, tmp_path):
    """The options the port does not read raise by name: ORB's render
    path, TIFF images and disparities; a JPEG is read as PIL reads it
    (`test_torch_jpeg.py`). NeRO's relighting env maps are read
    (`test_torch_relight_inputs.py`): on a scene without its relit views
    both packages fail alike."""
    config = dict(dataset_loader="glossy_synthetic", batch_size=8,
                  compute_relight_metrics=True, **LOADER_CONFIG["glossy_synthetic"])
    with pytest.raises(ValueError) as want:
        jdatasets.load_dataset("test", scenes["glossy_synthetic"], JConfig(**config))
    with pytest.raises(ValueError, match=str(want.value)):
        tdatasets.load_dataset("test", scenes["glossy_synthetic"], TConfig(**config),
                               device="cpu")
    for loader, kw, match in (
            ("orb", dict(vis_render_path=True), "vis_render_path"),
            ("blender", dict(use_tiffs=True), "TIFF"),
            ("blender_active", dict(compute_disp_metrics=True), "TIFF disparity")):
        config = TConfig(dataset_loader=loader, batch_size=8, **LOADER_CONFIG[loader], **kw)
        with pytest.raises(NotImplementedError, match=match):
            tdatasets.load_dataset("test", scenes[loader], config, device="cpu")
    path = tmp_path / "x.jpg"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    np.testing.assert_array_equal(tdatasets.io_lib.load_img(str(path)),
                                  np.array(Image.open(path), dtype=np.float32))


def test_loaders_run_without_pil_or_jax(scenes):
    """Every module of the port and chip_smoke.py import with PIL, OpenCV,
    imageio, h5py and JAX hidden, and each loader reads its scene so."""
    hidden = ("PIL", "cv2", "imageio", "h5py", "jax", "neural_radiance_caching_tpu")
    code = (
        "import importlib, pkgutil, sys\n"
        f"for m in {hidden!r}:\n"
        "    sys.modules[m] = None\n"
        "import neural_radiance_caching_tpu_torch as port\n"
        "for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
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
