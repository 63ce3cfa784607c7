"""Datasets and ray batching (counterpart of ``data/datasets.py``): the
loaders of posed images on disk ``blender``, ``blender_active``, ``orb``
and ``glossy_synthetic``, of transient captures on disk
``transient_simulation`` and ``fwp_transient_captured``, and the
procedural ``SyntheticSpheres`` scene; ``load_dataset`` raises naming any
other loader.

Each loader reads its images on the host (the port's own PNG, EXR and
HDF5 readers, ``data/io.py``, ``data/hdf5.py``) into the same arrays as
the JAX loader, and batches are drawn with the same numpy RandomState
stream as the JAX package, so both packages see identical batches: random
pixels of the stacked images, of the flattened pixel table
(``GlossySynthetic``), or a random window of the transient loaders'
pre-shuffled h5 sample streams.
Rays are cast on the host, or, with ``Config.cast_rays_in_train_step``, a
batch holds its Pixels and the train step casts them; ``next_train`` moves
the batch to the dataset's device, the card unless the caller passes
``device="cpu"``. With ``Config.use_transient`` the procedural images are
time-binned transients [N, H, W, n_bins, 3].
"""

from __future__ import annotations

import glob
import json
import os
import pickle

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.data import camera_utils, hdf5
from neural_radiance_caching_tpu_torch.data import io as io_lib
from neural_radiance_caching_tpu_torch.ops import image as image_ops
from neural_radiance_caching_tpu_torch.utils import pytrees, torchutil


# The JAX package's loaders by Config.dataset_loader name.
LOADERS = ("blender", "blender_active", "transient_simulation", "transient_simulation_itof",
           "fwp_transient_captured", "orb", "open_illum", "neilf", "real", "fipt_real",
           "fipt_synthetic", "glossy_real", "glossy_synthetic", "llff", "tat_nerfpp", "tat_fvs",
           "dtu", "rtmv", "pixelrig", "aerial", "preloaded", "synthetic_spheres")


def load_dataset(split, data_dir, config, device="cuda", **kwargs):
    """Dataset dispatcher on Config.dataset_loader."""
    name = config.dataset_loader
    loaders = {"blender": Blender, "blender_active": BlenderActive, "orb": ORB,
               "glossy_synthetic": GlossySynthetic, "synthetic_spheres": SyntheticSpheres,
               "transient_simulation": TransientSimulation,
               "fwp_transient_captured": FWPTransientCaptured}
    if name in loaders:
        return loaders[name](split, data_dir, config, device=device, **kwargs)
    if name in LOADERS:
        raise NotImplementedError(f"the {name!r} dataset loader is not ported yet")
    raise KeyError(f"unknown dataset loader {name!r}")


# --- pose loaders ------------------------------------------------------------------------


def _extract_ngp_intrinsics(frame, w, h):
    focal_keys = ["fl_x", "fl_y", "camera_angle_x", "camera_angle_y", "focal_in_mm"]
    if not any(k in frame for k in focal_keys):
        return None
    cx = frame.get("cx", w / 2.0)
    cy = frame.get("cy", h / 2.0)
    if "focal_in_mm" in frame:
        fx = w * frame["focal_in_mm"] / frame["sensor_size_horizontal_in_mm"]
    elif "fl_x" in frame:
        fx = frame["fl_x"]
    else:
        fx = 0.5 * w / np.tan(0.5 * float(frame["camera_angle_x"]))
    if "fl_y" in frame:
        fy = frame["fl_y"]
    elif "camera_angle_y" in frame:
        fy = 0.5 * h / np.tan(0.5 * float(frame["camera_angle_y"]))
    else:
        fy = fx
    return np.linalg.inv(camera_utils.intrinsic_matrix(fx, fy, cx, cy))


def _extract_distortion(frame):
    coeffs = ["k1", "k2", "p1", "p2"]
    if not any(c in frame for c in coeffs):
        return None
    return {c: frame.get(c, 0.0) for c in coeffs}


def _meta_camtype(meta):
    if "camera_type" in meta:
        if "fisheye" in meta["camera_type"]:
            return camera_utils.ProjectionType.FISHEYE_EQUISOLID
        return camera_utils.ProjectionType(meta["camera_type"])
    return camera_utils.ProjectionType.PERSPECTIVE


def load_ngp_posedata(config, data_dir, pose_file_name="transforms.json"):
    """Parse an instant-ngp / nerf-synthetic transforms JSON: (names,
    camtoworlds [N, rows, 4] as stored, pixtocams ([N, 3, 3] per frame or
    [3, 3] shared), distortion (None, a dict of floats, or of per-frame
    arrays), camtype, nameprefixes). Without `w` / `h` the first image
    found gives the resolution."""
    with open(os.path.join(data_dir, pose_file_name)) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if not isinstance(frames, list):
        frames = [frames[k] for k in sorted(frames.keys())]
    if config is not None and config.num_dataset_images > 0:
        frames = frames[: config.num_dataset_images]

    w = meta.get("w")
    h = meta.get("h")

    names, nameprefixes, camtoworlds, pixtocams, distortions = [], [], [], [], []
    for frame in frames:
        ext = io_lib.find_file(data_dir, frame)
        filepath = frame["file_path"]
        if w is None or h is None:
            probe = os.path.join(data_dir, filepath + (ext or ""))
            if os.path.exists(probe):
                img = (io_lib.load_exr(probe) if probe.lower().endswith(".exr")
                       else io_lib.load_img(probe))
                h, w = img.shape[:2]
            else:
                w = h = None if config is None else config.width
        names.append(os.path.basename(filepath) + (ext or ""))
        nameprefixes.append(filepath)
        camtoworlds.append(np.array(frame["transform_matrix"], np.float32))
        pixtocams.append(_extract_ngp_intrinsics(frame, w or 1, h or 1))
        distortions.append(_extract_distortion(frame))
    camtoworlds = np.stack(camtoworlds, axis=0).astype(np.float32)

    if pixtocams[0] is None:
        pixtocams = _extract_ngp_intrinsics(meta, w or 1, h or 1)
    else:
        pixtocams = np.stack(pixtocams, axis=0)
    if distortions[0] is None:
        distortions = _extract_distortion(meta)
    else:
        distortions = {k: np.array([d[k] for d in distortions]) for k in distortions[0]}

    return names, camtoworlds, pixtocams, distortions, _meta_camtype(meta), nameprefixes


def load_fwp_posedata(config, data_dir, pose_file_name="transforms.json", frame_step=1):
    """The FWP rig's transforms JSON: as ``load_ngp_posedata``, with each
    frame's `camera` intrinsic matrix (float64) divided by `512 / width`
    (its [2, 2] kept 1) and inverted, every `frame_step`-th frame, and the
    names' extension ".h5"."""
    with open(os.path.join(data_dir, pose_file_name)) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if not isinstance(frames, list):
        frames = [frames[k] for k in sorted(frames.keys())]
    if config.num_dataset_images > 0:
        frames = frames[: config.num_dataset_images]

    def extract_intrinsics(frame):
        if "camera" not in frame:
            return None
        intrinsics = np.array(frame["camera"], np.float64) / int(512 / config.width)
        intrinsics[2, 2] = 1
        return np.linalg.inv(intrinsics)

    names, nameprefixes, camtoworlds, pixtocams, distortions = [], [], [], [], []
    for frame in frames[::frame_step]:
        filepath = frame["file_path"]
        nameprefixes.append(filepath)
        names.append(os.path.splitext(os.path.basename(filepath))[0] + ".h5")
        camtoworlds.append(np.array(frame["transform_matrix"], np.float32))
        pixtocams.append(extract_intrinsics(frame))
        distortions.append(_extract_distortion(frame))
    camtoworlds = np.stack(camtoworlds, axis=0).astype(np.float32)
    if pixtocams[0] is None:
        pixtocams = extract_intrinsics(meta)
    else:
        pixtocams = np.stack(pixtocams, axis=0)
    if distortions[0] is None:
        distortions = _extract_distortion(meta)
    else:
        distortions = {k: np.array([d[k] for d in distortions]) for k in distortions[0]}
    return names, camtoworlds, pixtocams, distortions, _meta_camtype(meta), nameprefixes


def flatten_data(images, dim=3):
    """Image list -> (pixels [P, dim], indices [P, 3] of (image, x, y))."""

    def flatten_and_concat(values, n):
        return np.concatenate([np.array(z).reshape(-1, n) for z in values])

    def index_array(i, w, h):
        x, y = camera_utils.pixel_coordinates(w, h)
        return np.stack([np.full((h, w), i), x, y], axis=-1)

    indices = [index_array(i, z.shape[1], z.shape[0]) for i, z in enumerate(images)]
    return flatten_and_concat(images, dim), flatten_and_concat(indices, 3)


# --- base class --------------------------------------------------------------------------


class Dataset:
    """Base dataset: holds images + cameras, serves ray batches on `device`
    (the card by default; raises without one rather than serving on the
    CPU)."""

    def __init__(self, split, data_dir, config, device="cuda"):
        torchutil.check_device(device, "a dataset", "serve batches on the CPU")
        if config.patch_size > 1:
            raise NotImplementedError("patch batches are not ported yet")
        if config.meshfile:
            raise NotImplementedError(f"Config.meshfile ({config.meshfile!r}) is not ported yet")
        self.split = split
        self.data_dir = data_dir
        self.config = config
        self.device = device
        self._batch_size = config.batch_size
        self.near = config.near
        self.far = config.far
        self._flattened = False
        self._use_tiffs = config.use_tiffs
        self._use_exrs = config.use_exrs
        self._load_disps = config.compute_disp_metrics or config.load_disps
        self._load_normals = config.compute_normal_metrics or config.load_normals
        self._load_albedos = config.compute_albedo_metrics or config.load_albedos
        self._load_env_map = config.compute_relight_metrics
        self.images = None
        self.camtoworlds = None
        # The rays' virtual camera (their vcam_* fields) where it is not
        # their own: the fixed light's frame under ``Config.fixed_light``.
        self.virtual_camtoworlds = None
        self.pixtocams = None
        self.distortion_params = None
        self.camtype = camera_utils.ProjectionType.PERSPECTIVE
        self.lights = None
        self.masks = None
        self.mask_images = None
        self.alphas = None
        self.normal_images = None
        self.albedo_images = None
        self.depth_images = None
        self.impulse_response = None
        self.images_flattened = None
        self.indices_flattened = None
        self.light_idx_flattened = None
        self._np_rng = np.random.RandomState(config.np_rng_seed + (0 if split == "train" else 1))
        self._load_renderings(config)
        if self.distortion_params is not None:
            raise NotImplementedError(
                f"lens distortion ({', '.join(sorted(self.distortion_params))}) is not ported yet")
        if self.camtype != camera_utils.ProjectionType.PERSPECTIVE:
            raise NotImplementedError(f"the {self.camtype.value!r} camera_type is not ported yet")
        self.num_images = self.images.shape[0]
        self.height, self.width = self.images.shape[1:3]
        if self.pixtocams.ndim == 2:
            self.pixtocams = self.pixtocams[None]
        self.pixtocams = self.pixtocams.astype(np.float32)
        if self.lights is None:
            self.lights = self.camtoworlds[:, :3, -1]

    def _load_renderings(self, config):
        raise NotImplementedError

    @property
    def cameras(self):
        return (self.pixtocams, self.camtoworlds)

    def _make_pixels(self, cam_idx, pix_x, pix_y, lossmult=None, light_idx=None):
        n = pix_x.shape[0]
        if light_idx is None:
            light_idx = np.zeros((n, 1), np.int32)
        return pytrees.Pixels(
            pix_x_int=pix_x,
            pix_y_int=pix_y,
            lossmult=(np.ones((n, 1), np.float32) if lossmult is None
                      else lossmult.reshape(n, 1).astype(np.float32)),
            near=np.full((n, 1), self.near, np.float32),
            far=np.full((n, 1), self.far, np.float32),
            cam_idx=cam_idx.reshape(n, 1).astype(np.int32),
            light_idx=np.asarray(light_idx).reshape(n, 1).astype(np.int32),
        )

    def _cast(self, pixels):
        """The batch's rays: its Pixels under ``Config.cast_rays_in_train_step``
        (the train step casts them, `cast_ray_batch` on the card; an eval
        view is cast on the host, ``engine/trainer.render_test_view``), else
        cast here on the host."""
        if self.config.cast_rays_in_train_step:
            return pixels
        return camera_utils.cast_ray_batch(self.cameras, self.lights, pixels,
                                           impulse_response=self.impulse_response,
                                           virtual_camtoworlds=self.virtual_camtoworlds)

    def _gather_batch(self, cam_idx, pix_x, pix_y):
        def gather(x):
            return None if x is None else x[cam_idx, pix_y, pix_x]

        pixels = self._make_pixels(cam_idx, pix_x, pix_y)
        batch = pytrees.Batch(
            rays=self._cast(pixels), rgb=gather(self.images), masks=gather(self.masks),
            normals=gather(self.normal_images), albedos=gather(self.albedo_images),
            alphas=gather(self.alphas))
        return batch.to(self.device)

    def next_train(self):
        """Random pixels across all train images (of the flattened pixel
        table where the loader keeps one)."""
        n = self._batch_size
        if self._flattened:
            inds = self._np_rng.randint(0, self.images_flattened.shape[0], (n,))
            indices = self.indices_flattened[inds]
            cam_idx, pix_x, pix_y = indices[:, 0], indices[:, 1], indices[:, 2]
            pixels = self._make_pixels(cam_idx, pix_x, pix_y,
                                       light_idx=self.light_idx_flattened[inds])
            masks = self.masks[cam_idx, pix_y, pix_x] if self.masks is not None else None
            return pytrees.Batch(rays=self._cast(pixels), rgb=self.images_flattened[inds],
                                 masks=masks).to(self.device)
        cam_idx = self._np_rng.randint(0, self.num_images, (n,))
        pix_x = self._np_rng.randint(0, self.width, (n,))
        pix_y = self._np_rng.randint(0, self.height, (n,))
        return self._gather_batch(cam_idx, pix_x, pix_y)

    def generate_ray_batch(self, cam_idx: int):
        """All pixels of one image, for eval rendering."""
        pix_x, pix_y = camera_utils.pixel_coordinates(self.width, self.height)
        pix_x = pix_x.reshape(-1)
        pix_y = pix_y.reshape(-1)
        return self._gather_batch(np.full_like(pix_x, cam_idx), pix_x, pix_y)


# --- loaders of posed images -------------------------------------------------------------


def _split_name(split):
    return "train" if split == "train" else "test"


class Blender(Dataset):
    """NeRF-synthetic / TensoIR blender scenes: `transforms_{split}.json`,
    RGBA images composited on white, sRGB made linear unless
    `Config.linear_to_srgb` or EXR. As in JAX, the intrinsics are those of
    the JSON's resolution at every `Config.factor`: at a factor above 1
    the rays cover only part of each downsampled image."""

    def _load_renderings(self, config):
        _, camtoworlds, pixtocams, distortions, camtype, nameprefixes = load_ngp_posedata(
            config, self.data_dir, f"transforms_{_split_name(self.split)}.json")
        images = np.stack([
            io_lib.get_imgs(self.data_dir, max(config.factor, 1), self._use_tiffs,
                            self._use_exrs, False, False, False, False, prefix)[0]
            for prefix in nameprefixes])
        if images.shape[-1] == 4:
            self.alphas = images[..., -1]
        else:
            self.alphas = np.ones_like(images[..., 0])
        self.masks = self.alphas[..., None]
        rgb = images[..., :3]
        if not config.linear_to_srgb and not self._use_exrs:
            rgb = np.clip(image_ops.srgb_to_linear(rgb), 0.0, np.inf)
        self.images = (rgb * self.masks + (1.0 - self.masks)).astype(np.float32)
        if pixtocams is None:
            raise ValueError("transforms.json must carry intrinsics")
        self.camtoworlds = camtoworlds[:, :3, :4]
        self.pixtocams = pixtocams
        self.distortion_params = distortions
        self.camtype = camtype


class BlenderActive(Dataset):
    """Blender scenes under active (flash) lighting, with the albedo and
    normal buffers where their metrics ask for them; the disparity TIFFs
    raise (the port reads no TIFF)."""

    def _load_renderings(self, config):
        _, camtoworlds, pixtocams, distortions, camtype, nameprefixes = load_ngp_posedata(
            config, self.data_dir, f"transforms_{_split_name(self.split)}.json")
        frames = [io_lib.get_imgs(self.data_dir, max(config.factor, 1), self._use_tiffs,
                                  self._use_exrs, self._load_disps, self._load_normals, False,
                                  self._load_albedos, p) for p in nameprefixes]
        images, _, normal_images, _, albedo_images = zip(*frames)
        images = np.stack(images, axis=0).astype(np.float32)
        self.alphas = np.copy(images[..., -1])
        if not config.linear_to_srgb and not self._use_exrs:
            images = np.clip(image_ops.srgb_to_linear(images), 0.0, np.inf)
        self.masks = self.alphas[..., None]
        self.images = images[..., :3] * self.masks + (1.0 - self.masks)
        if self._load_albedos:
            albedo = np.stack(albedo_images, axis=0)[..., :3]
            self.albedo_images = albedo * self.masks + (1.0 - self.masks)
        if self._load_normals:
            normals = np.stack(normal_images, axis=0)[..., :3]
            self.normal_images = normals * self.masks + (1.0 - self.masks)
        self.camtoworlds = camtoworlds[:, :3, :4]
        self.pixtocams = pixtocams
        self.distortion_params = distortions
        self.camtype = camtype


class ORB(Dataset):
    """Object Relighting Benchmark captures: the poses recentred on the
    train split's average pose and scaled so that the farthest train camera
    coordinate is 1, the intrinsics scaled by `Config.factor`, images
    clipped to [0, 4] and composited on white by the `{split}_mask` PNGs."""

    def _load_renderings(self, config):
        if config.vis_render_path and self.split != "train":
            raise NotImplementedError("Config.vis_render_path (ORB's ellipse render path) is "
                                      "not ported yet")
        _, camtoworlds_train, _, _, _, _ = load_ngp_posedata(
            config, self.data_dir, "transforms_train.json")
        _, camtoworlds, pixtocams, distortions, camtype, nameprefixes = load_ngp_posedata(
            config, self.data_dir, f"transforms_{_split_name(self.split)}.json")

        factor = max(config.factor, 1)
        pixtocams = pixtocams @ np.diag([factor, factor, 1.0])

        camtoworlds_train, tform = camera_utils.recenter_poses(camtoworlds_train[:, :3, :4])
        camtoworlds = camera_utils.unpad_poses(
            tform @ camera_utils.pad_poses(camtoworlds[:, :3, :4]))
        camtoworlds[:, :3, 3] *= 1.0 / np.max(np.abs(camtoworlds_train[:, :3, 3]))

        images, mask_images, normal_images = [], [], []
        for prefix in nameprefixes:
            image, _, normal_image, mask_image, _ = io_lib.get_imgs(
                self.data_dir, config.factor, self._use_tiffs, self._use_exrs, False,
                self._load_normals, True, False, prefix, _split_name(self.split))
            images.append(np.clip(image, 0.0, 4.0))
            mask_images.append(mask_image > 0.5)
            normal_images.append(normal_image)

        images = np.stack(images, axis=0)
        self.mask_images = np.stack(mask_images, axis=0).astype(np.float32)
        if self._load_normals:
            self.normal_images = np.stack(normal_images, axis=0)
            self.alphas = images[..., -1]
        rgb = images[..., :3]
        alpha = self.mask_images.reshape(rgb.shape[:3] + (-1,))[..., :1]
        self.images = (rgb * alpha + (1.0 - alpha)).astype(np.float32)
        self.masks = alpha
        self.camtoworlds = camtoworlds
        self.pixtocams = pixtocams
        self.distortion_params = distortions
        self.camtype = camtype
        self.lights = self.camtoworlds[..., :3, -1]


class GlossySynthetic(Dataset):
    """NeRO's glossy synthetic scenes: `{i}-camera.pkl` (world-to-camera
    [3, 4] and intrinsics, OpenCV), `{i}.png` RGBA and `{i}-depth.png`
    16-bit depth (the mask is depth < 14.5, else the alpha); the test split
    is `../synthetic_split_128.pkl`'s, the train split every image. Batches
    come from the flattened pixel table. The pickles are the capture's own
    files, unpickled as the JAX loader does."""

    def _load_renderings(self, config):
        if self._load_env_map:
            raise NotImplementedError("Config.compute_relight_metrics (the relighting env "
                                      "maps) is not ported yet")
        with open(os.path.join(self.data_dir, "../synthetic_split_128.pkl"), "rb") as f:
            test_ids, _ = pickle.load(f)
        if self.split == "train":
            im_ids = [str(k) for k in range(len(glob.glob(f"{self.data_dir}/*.pkl")))]
        else:
            im_ids = sorted(test_ids)

        images, mask_images, depth_images, camtoworlds, pixtocams = [], [], [], [], []
        for im_id in im_ids:
            with open(os.path.join(self.data_dir, im_id + "-camera.pkl"), "rb") as f:
                cam_data = pickle.load(f)
            pose = np.eye(4)
            pose[:3, :4] = cam_data[0]
            camtoworlds.append(np.linalg.inv(pose))
            pixtocams.append(cam_data[1])

            image = io_lib.load_img(os.path.join(self.data_dir, im_id + ".png"))
            image = np.clip(image_ops.srgb_to_linear(image.astype(np.float64) / 255.0), 0.0,
                            np.inf)
            images.append(image)

            depth_file = os.path.join(self.data_dir, im_id + "-depth.png")
            if os.path.exists(depth_file):
                depth = io_lib.load_img(depth_file) / 65535 * 15
                if depth.ndim == 3:
                    depth = depth[..., 0]
                mask = (depth < 14.5).astype(np.float32)
            else:
                mask = image[..., 3]
                depth = np.zeros_like(mask)
            depth_images.append(depth[..., None])
            mask_images.append(mask[..., None])

        camtoworlds = np.array(camtoworlds)
        pixtocams = np.linalg.inv(np.array(pixtocams))
        camtoworlds = (camtoworlds @ np.diag([1, -1, -1, 1.0]))[:, :3, :4]

        self.images = np.stack(images, axis=0).astype(np.float32)
        self.mask_images = np.stack(mask_images, axis=0).astype(np.float32)
        self.depth_images = np.stack(depth_images, axis=0)
        self.alphas = np.copy(self.mask_images[..., 0])
        rgb, alpha = self.images[..., :3], self.mask_images
        self.images = (rgb * alpha + (1.0 - alpha)).astype(np.float32)
        self.masks = alpha

        self._flattened = True
        self.images_flattened, self.indices_flattened = flatten_data(list(self.images))
        self.light_idx_flattened = np.zeros((self.images_flattened.shape[0], 1), np.int32)
        self.camtoworlds = camtoworlds
        self.pixtocams = pixtocams.astype(np.float32)
        self.lights = self.camtoworlds[..., :3, -1]


# --- transient captures -----------------------------------------------------------------


class TransientSimulation(Dataset):
    """Simulated time-resolved captures: the train split is a random
    contiguous window of the pre-shuffled sample streams
    `train_efficient/{x,y,samples,file_indices}.h5` (kept open for the
    loader's life, read a window at a time); an eval view is one frame's
    `data` volume [H, W, bins(, C)], its bins from `Config.test_start_bin`,
    decimated by 2 per halving down to the split's height. The test split
    takes `Config.test_height` / `test_width`, or `height` / `width` under
    `Config.vis_only`. `self.images` is a zero view that only carries the
    shapes, as JAX's zero stack does."""

    def _split_size(self, config):
        if self.split == "train" or config.vis_only:
            return config.height, config.width
        return config.test_height, config.test_width

    def _pose_file_name(self, config, all_name):
        if config.eval_path and self.split == "test":
            return "transforms_path2.json"
        if config.eval_train:
            return all_name
        return f"transforms_{self.split}.json"

    def _open_streams(self):
        eff = os.path.join(self.data_dir, "train_efficient")
        self._streams = {name: hdf5.File(os.path.join(eff, f"{name}.h5"))["dataset"]
                         for name in ("x", "y", "samples", "file_indices")}

    def _load_impulse_response(self, config):
        if config.impulse_response:
            ir = np.load(config.impulse_response)
            ir = ir[config.impulse_response_start_bin:
                    config.impulse_response_start_bin + config.n_impulse_response_bins]
            self.impulse_response = ir[::-1].copy()

    def _load_renderings(self, config):
        self.height, self.width = self._split_size(config)
        self._pose_file = self._pose_file_name(config, "transforms_train.json")
        _, camtoworlds, pixtocams, distortions, camtype, _ = load_ngp_posedata(
            config, self.data_dir, self._pose_file)
        if self.split == "train":
            self._open_streams()
        self.camtoworlds = camtoworlds[:, :3, :4]
        self.pixtocams = pixtocams
        self.distortion_params = distortions
        self.camtype = camtype
        self.lights = self.camtoworlds[..., :3, -1]
        if config.fixed_light and config.light_transforms:
            light = np.array(config.light_transforms[config.light_transform_idx], np.float32)
            self.lights = np.tile(light[:3, -1][None], (self.lights.shape[0], 1))
            self.virtual_camtoworlds = np.tile(light[None, :3, :4],
                                               (self.camtoworlds.shape[0], 1, 1))
        if config.fixed_camera:
            self.camtoworlds = np.tile(self.camtoworlds[config.viz_index][None],
                                       (self.camtoworlds.shape[0], 1, 1))[: self.lights.shape[0]]
        self._load_impulse_response(config)
        self.images = np.broadcast_to(np.zeros((), np.float32),
                                      (camtoworlds.shape[0], self.height, self.width, 3))

    def _make_transient_batch(self, pix_x, pix_y, cam_idx, rgb, lossmult=None):
        rgb = np.clip(rgb[..., :3] / self.config.dataset_scale, 0.0, self.config.rgb_max)
        # JAX's mask, the per-bin norms' sum > 0, in one contiguous pass: a
        # sum of the same float32 squares is 0, NaN or > 0 where that is.
        mask = ((rgb * rgb).sum(axis=(-2, -1)) > 0)[:, None].astype(np.float32)
        return self._transient_batch(pix_x, pix_y, cam_idx, rgb, mask, lossmult)

    def _transient_batch(self, pix_x, pix_y, cam_idx, rgb, mask, lossmult):
        pixels = self._make_pixels(cam_idx, pix_x, pix_y, lossmult=lossmult,
                                   light_idx=cam_idx.astype(np.int32))
        return pytrees.Batch(rays=self._cast(pixels), rgb=rgb, masks=mask, alphas=mask,
                             impulse_response=self.impulse_response).to(self.device)

    def _next_window(self):
        """The next batch's window of the streams: (cam_idx, x, y as int32,
        samples [n, bins, C] float32 from `Config.start_bin`)."""
        n, cfg = self._batch_size, self.config
        max_start = self._streams["file_indices"].shape[0] - n
        start = self._np_rng.randint(0, max_start)
        rows = slice(start, start + n)
        cam_idx = self._streams["file_indices"][rows].astype(np.int32)
        pix_x = self._streams["x"][rows].astype(np.int32)
        pix_y = self._streams["y"][rows].astype(np.int32)
        rgb = self._streams["samples"][rows, cfg.start_bin: cfg.start_bin + cfg.n_bins]
        return cam_idx, pix_x, pix_y, rgb.astype(np.float32, copy=False)

    def next_train(self):
        cam_idx, pix_x, pix_y, rgb = self._next_window()
        return self._make_transient_batch(pix_x, pix_y, cam_idx, rgb)

    def generate_ray_batch(self, cam_idx: int):
        """One frame at the split's size: the rows and columns the
        decimation keeps are the only ones read."""
        cfg = self.config
        with open(os.path.join(self.data_dir, self._pose_file)) as f:
            file_path = json.load(f)["frames"][cam_idx]["file_path"]
        if cfg.eval_path:
            rgb = np.zeros((self.height, self.width, cfg.n_bins, 1), np.float32)
        else:
            with hdf5.File(os.path.join(self.data_dir, file_path)) as h5_file:
                data = h5_file["data"]
                step = 2 ** int(np.log2(max(1, data.shape[0] // self.height)))
                rgb = data[::step, ::step, cfg.test_start_bin: cfg.test_start_bin + cfg.n_bins]
                rgb = rgb.astype(np.float32, copy=False)
        if rgb.ndim == 3:
            rgb = rgb[..., None]
        pix_x, pix_y = camera_utils.pixel_coordinates(rgb.shape[1], rgb.shape[0])
        return self._make_transient_batch(
            pix_x.reshape(-1), pix_y.reshape(-1), np.full_like(pix_x.reshape(-1), cam_idx),
            rgb.reshape(-1, rgb.shape[-2], rgb.shape[-1]))

    def close(self):
        """Close the train split's sample streams."""
        for stream in getattr(self, "_streams", {}).values():
            stream.file.close()


class FWPTransientCaptured(TransientSimulation):
    """Captured transients of the FWP rig: per-frame intrinsics
    (``load_fwp_posedata``; every other frame of the eval path), the light
    at `Config.light_source_position` (in each camera's frame under
    `light_static_wrt_camera`), the frames named by
    `Config.train_exclude_prefixes` weighted 0 in the train batches'
    lossmult, and `Config.dark_level` subtracted (the mask is the scaled
    norm summed over the bins against `Config.mask_threshold`)."""

    def _load_renderings(self, config):
        self.height, self.width = self._split_size(config)
        self._pose_file = self._pose_file_name(config, "transforms_all.json")
        frame_step = 2 if (config.eval_path and self.split == "test") else 1
        _, camtoworlds, pixtocams, distortions, camtype, nameprefixes = load_fwp_posedata(
            config, self.data_dir, self._pose_file, frame_step=frame_step)
        if self.split == "train":
            self._open_streams()
        self.camtoworlds = camtoworlds[:, :3, :4]
        self.pixtocams = pixtocams
        self.distortion_params = distortions
        self.camtype = camtype
        lights = np.tile(np.array(config.light_source_position or [0.0, 0.0, 0.0], np.float32),
                         (self.camtoworlds.shape[0], 1))
        if config.light_static_wrt_camera:
            hom = np.concatenate([lights, np.ones_like(lights[:, :1])], axis=1)
            lights = np.einsum("nij,nj->ni", camtoworlds[:, :3, :4], hom)
        self.lights = lights
        self._load_impulse_response(config)
        self.train_exclude_indices = np.array(
            [i for i, name in enumerate(nameprefixes)
             if any(prefix in name for prefix in config.train_exclude_prefixes)], np.int32)
        self.images = np.broadcast_to(np.zeros((), np.float32),
                                      (camtoworlds.shape[0], self.height, self.width, 3))

    def _make_transient_batch(self, pix_x, pix_y, cam_idx, rgb, lossmult=None):
        cfg = self.config
        scaled = rgb[..., :3] / cfg.dataset_scale
        clipped = np.clip(scaled - cfg.dark_level, 0.0, cfg.rgb_max)
        mask = (np.linalg.norm(scaled, axis=-1, keepdims=True).sum(axis=-2)
                >= cfg.mask_threshold).astype(np.float32)
        return self._transient_batch(pix_x, pix_y, cam_idx, clipped, mask, lossmult)

    def next_train(self):
        cam_idx, pix_x, pix_y, rgb = self._next_window()
        lossmult = np.all(cam_idx[..., None] != self.train_exclude_indices[None],
                          axis=-1).astype(np.float32)
        return self._make_transient_batch(pix_x, pix_y, cam_idx, rgb, lossmult=lossmult)


# --- the procedural scene ----------------------------------------------------------------


def _convolve_bins(x, kernel):
    """[N, bins, C] transients correlated with a symmetric 1-D kernel along
    the bins ('same' size)."""
    half = len(kernel) // 2
    pad = np.pad(x, ((0, 0), (half, half), (0, 0)))
    out = np.zeros_like(x)
    for i, w in enumerate(kernel):
        out += w * pad[:, i: i + x.shape[1], :]
    return out


class SyntheticSpheres(Dataset):
    """Procedural analytic scene: lambertian spheres under a point light plus
    ambient ("legacy" shading of the JAX scene), ray-traced in numpy."""

    SPHERES = (
        # (center, radius, albedo)
        ((0.0, 0.0, 0.0), 0.55, (0.9, 0.3, 0.25)),
        ((0.7, 0.4, -0.25), 0.3, (0.25, 0.55, 0.9)),
        ((-0.6, -0.5, -0.15), 0.4, (0.3, 0.85, 0.4)),
    )
    LIGHT = np.array([1.5, -1.5, 2.5], np.float32)
    AMBIENT = 0.25

    def __init__(self, split, data_dir, config, num_images=None, resolution=None,
                 device="cuda"):
        if num_images is None:
            num_images = config.num_dataset_images if config.num_dataset_images > 0 else 16
        if resolution is None:
            resolution = 48 // max(1, config.factor)
        if config.synthetic_spheres_shading != "legacy" or config.synthetic_spheres_multi_illum:
            raise NotImplementedError("only the legacy single-light sphere scene is ported")
        self._num_images = num_images
        self._resolution = resolution
        super().__init__(split, data_dir, config, device=device)

    def _trace(self, origins, dirs, light):
        """Analytic ray tracing of the sphere scene -> (rgb, alpha, t_hit,
        light_dist): the hit distance along the ray and the surface->light
        distance feed the transient renderings."""
        n = origins.shape[0]
        best_t = np.full((n,), np.inf, np.float32)
        rgb = np.ones((n, 3), np.float32)  # white background
        alpha = np.zeros((n,), np.float32)
        light_dist = np.zeros((n,), np.float32)
        for center, radius, albedo in self.SPHERES:
            center = np.array(center, np.float32)
            oc = origins - center
            b = np.sum(oc * dirs, -1)
            c = np.sum(oc * oc, -1) - radius**2
            disc = b * b - c
            hit = disc > 0
            t = -b - np.sqrt(np.maximum(disc, 0))
            hit &= (t > 1e-3) & (t < best_t)
            if not hit.any():
                continue
            p = origins[hit] + t[hit, None] * dirs[hit]
            normal = (p - center) / radius
            to_light = light - p
            dist = np.linalg.norm(to_light, axis=-1, keepdims=True)
            ldir = to_light / dist
            lambert = np.maximum(0.0, np.sum(normal * ldir, -1, keepdims=True))
            rgb[hit] = np.array(albedo, np.float32) * (self.AMBIENT + (1 - self.AMBIENT) * lambert)
            best_t[hit] = t[hit]
            alpha[hit] = 1.0
            light_dist[hit] = dist[..., 0]
        return rgb, alpha, best_t, light_dist

    def _bin_transient(self, rgb, alpha, t_hit, light_dist, config):
        """The direct response in time bins at the path length
        (camera->surface->light) / exposure_time, split linearly between
        the two bins around it; optionally convolved with the impulse."""
        n_bins = config.n_bins
        out = np.zeros((rgb.shape[0], n_bins, 3), np.float32)
        hit = alpha > 0
        bin_f = np.clip((t_hit[hit] + light_dist[hit]) / config.exposure_time, 0,
                        n_bins - 1 - 1e-4)
        b0 = np.floor(bin_f).astype(np.int32)
        frac = (bin_f - b0)[:, None]
        idx = np.nonzero(hit)[0]
        out[idx, b0] += rgb[hit] * (1 - frac)
        out[idx, b0 + 1] += rgb[hit] * frac
        if config.synthetic_spheres_impulse_sigma > 0:
            out = _convolve_bins(out, self._impulse_kernel(config))
        return out

    @staticmethod
    def _impulse_kernel(config):
        """Gaussian sensor impulse response (odd length, unit mass), shared by
        the transients and the rays' impulse_response."""
        sigma = float(config.synthetic_spheres_impulse_sigma)
        half = max(1, int(np.ceil(3.0 * sigma)))
        taps = np.arange(-half, half + 1, dtype=np.float64)
        k = np.exp(-(taps**2) / (2.0 * sigma**2))
        return (k / k.sum()).astype(np.float32)

    def _load_renderings(self, config):
        res = self._resolution
        camtoworlds = camera_utils.generate_spherical_poses(
            self._num_images, radius=4.0, seed=17 if self.split == "train" else 31)
        pixtocam = camera_utils.get_pixtocam(1.2 * res, res, res)
        pix_x, pix_y = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
        pix_x = pix_x.reshape(-1).astype(np.float32)
        pix_y = pix_y.reshape(-1).astype(np.float32)
        if config.use_transient and config.synthetic_spheres_impulse_sigma > 0:
            self.impulse_response = self._impulse_kernel(config)
        lights = np.broadcast_to(self.LIGHT, (self._num_images, 3)).copy()
        images, alphas = [], []
        for c2w, light in zip(camtoworlds, lights):
            out = camera_utils.pixels_to_rays(pix_x, pix_y, pixtocam[None], c2w[None])
            rgb, alpha, t_hit, light_dist = self._trace(
                out[0].reshape(-1, 3), out[2].reshape(-1, 3), light)
            if config.use_transient:
                transient = self._bin_transient(rgb, alpha, t_hit, light_dist, config)
                images.append(transient.reshape(res, res, config.n_bins, 3))
            else:
                images.append(rgb.reshape(res, res, 3))
            alphas.append(alpha.reshape(res, res))
        self.images = np.stack(images).astype(np.float32)
        self.alphas = np.stack(alphas).astype(np.float32)
        self.masks = self.alphas[..., None]
        self.pixtocams = pixtocam[None].astype(np.float32)
        self.camtoworlds = camtoworlds
        self.lights = lights
