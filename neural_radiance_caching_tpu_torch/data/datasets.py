"""Datasets and ray batching (counterpart of ``data/datasets.py``): every
loader of the JAX package by its ``Config.dataset_loader`` name
(``LOADERS``): posed images on disk (``blender``, ``blender_active``,
``orb``, ``glossy_synthetic``, ``rtmv``, ``fipt_synthetic``), real
captures (``llff`` posed by COLMAP, ``poses_bounds.npy`` or an NGP JSON;
``open_illum``, ``neilf``, ``glossy_real``, ``real``, ``fipt_real``,
``tat_nerfpp``, ``tat_fvs``, ``dtu``, ``pixelrig``, ``aerial``), transient
captures (``transient_simulation``, ``transient_simulation_itof``,
``fwp_transient_captured``), arrays in memory (``preloaded``) and the
procedural ``SyntheticSpheres`` scene.

Each loader reads its images on the host (the port's own PNG, JPEG, EXR
and HDF5 readers and OpenCV's resizes, ``data/io.py``, ``data/jpeg.py``,
``data/hdf5.py``; COLMAP's binaries, ``data/colmap.py``) into the same
arrays as the JAX loader, and batches are drawn with the same numpy
RandomState stream as the JAX package, so both packages see identical
batches: random pixels of the stacked images, of the flattened pixel table
(``GlossySynthetic``, the FIPT loaders, ``TransientSimulationIToF``), or a
random window of the transient loaders' pre-shuffled h5 sample streams.
A loader's cameras are ``Dataset.cameras``: (pixtocams, camtoworlds, lens
distortion, the NDC warp's pixtocam), as in JAX; a camera's ``camtype`` is
kept but, as in JAX, no cast reads it.
Rays are cast on the host, or, with ``Config.cast_rays_in_train_step``, a
batch holds its Pixels and the train step casts them; ``next_train`` moves
the batch to the dataset's device, the card unless the caller passes
``device="cpu"``. With ``Config.use_transient`` the procedural images are
time-binned transients [N, H, W, n_bins, 3]. In a data-parallel group
(``parallel/mesh.py``) each rank's train split serves ``batch_size //
world`` rays drawn from numpy seed ``np_rng_seed + rank``.
"""

from __future__ import annotations

import concurrent.futures
import glob
import io
import json
import os
import pickle

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.data import camera_utils, colmap, env_maps, hdf5
from neural_radiance_caching_tpu_torch.data import io as io_lib
from neural_radiance_caching_tpu_torch.ops import image as image_ops
from neural_radiance_caching_tpu_torch.parallel import mesh as mesh_lib
from neural_radiance_caching_tpu_torch.utils import pytrees, torchutil


# The JAX package's loaders by Config.dataset_loader name.
LOADERS = ("blender", "blender_active", "transient_simulation", "transient_simulation_itof",
           "fwp_transient_captured", "orb", "open_illum", "neilf", "real", "fipt_real",
           "fipt_synthetic", "glossy_real", "glossy_synthetic", "llff", "tat_nerfpp", "tat_fvs",
           "dtu", "rtmv", "pixelrig", "aerial", "preloaded", "synthetic_spheres")


def load_dataset(split, data_dir, config, device="cuda", **kwargs):
    """Dataset dispatcher on Config.dataset_loader."""
    loaders = {"blender": Blender, "blender_active": BlenderActive,
               "transient_simulation": TransientSimulation,
               "transient_simulation_itof": TransientSimulationIToF,
               "fwp_transient_captured": FWPTransientCaptured, "orb": ORB,
               "open_illum": OpenIllum, "neilf": Neilf, "real": Real, "fipt_real": FIPTReal,
               "fipt_synthetic": FIPTSynthetic, "glossy_real": GlossyReal,
               "glossy_synthetic": GlossySynthetic, "llff": LLFF,
               "tat_nerfpp": TanksAndTemplesNerfPP, "tat_fvs": TanksAndTemplesFVS, "dtu": DTU,
               "rtmv": RTMV, "pixelrig": PixelRig, "aerial": Aerial, "preloaded": PreloadedData,
               "synthetic_spheres": SyntheticSpheres}
    return loaders[config.dataset_loader](split, data_dir, config, device=device, **kwargs)


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


def load_llff_posedata(data_dir):
    """`poses_bounds.npy` in the LLFF layout: (camtoworlds [N, 3, 4] with
    LLFF's [down, right, backwards] axes turned to [right, up, backwards],
    the shared pixtocam of the first pose's height, width and focal, no
    distortion, PERSPECTIVE, the near / far bounds [N, 2])."""
    posefile = os.path.join(data_dir, "poses_bounds.npy")
    if not os.path.exists(posefile):
        raise ValueError(f"poses_bounds.npy does not exist in {data_dir}.")
    poses_arr = np.load(posefile)
    bounds = poses_arr[:, -2:]
    poses_hwf = poses_arr[:, :-2].reshape([-1, 3, 5])
    nerf_to_llff = np.array([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    poses = poses_hwf[:, :, :4] @ nerf_to_llff
    h, w, f = poses_hwf[0, :, 4]
    pixtocams = camera_utils.get_pixtocam(f, w, h)
    return poses, pixtocams, None, camera_utils.ProjectionType.PERSPECTIVE, bounds


def flatten_data(images, dim=3):
    """Image list -> (pixels [P, dim], indices [P, 3] of (image, x, y))."""

    def flatten_and_concat(values, n):
        return np.concatenate([np.array(z).reshape(-1, n) for z in values])

    def index_array(i, w, h):
        x, y = camera_utils.pixel_coordinates(w, h)
        return np.stack([np.full((h, w), i), x, y], axis=-1)

    indices = [index_array(i, z.shape[1], z.shape[0]) for i, z in enumerate(images)]
    return flatten_and_concat(images, dim), flatten_and_concat(indices, 3)


def flatten_transient_data(images, n_bins, num_rgb_channels=3):
    """Transient image list -> (pixels [P, n_bins, C], indices [P, 3])."""
    pixels, indices = flatten_data([z.reshape(z.shape[0], z.shape[1], -1) for z in images],
                                   dim=n_bins * num_rgb_channels)
    return pixels.reshape(-1, n_bins, num_rgb_channels), indices


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
        # In a data-parallel group each rank serves its block of the global
        # batch, from numpy seed np_rng_seed + rank (its own rows).
        world, rank = mesh_lib.process_count(), mesh_lib.process_index()
        if split == "train" and config.batch_size % world:
            raise ValueError(f"Config.batch_size {config.batch_size} is not divisible by the "
                             f"{world} ranks")
        self._batch_size = config.batch_size // world
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
        # OpenCV coefficients (floats or per-camera arrays) or None; the
        # camera model is kept and, as in JAX, read by no cast.
        self.distortion_params = None
        self.camtype = camera_utils.ProjectionType.PERSPECTIVE
        # The forward-facing NDC warp's shared pixtocam [3, 3] (PixelRig).
        self.pixtocam_ndc = None
        self.lights = None
        # Per-pixel illumination index [N, H, W, 1] where a loader keeps one.
        self.light_idx = None
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
        self._np_rng = np.random.RandomState(
            config.np_rng_seed + (rank if split == "train" else 1))
        self._load_renderings(config)
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
        return (self.pixtocams, self.camtoworlds, self.distortion_params, self.pixtocam_ndc)

    def get_train_cameras(self, config):
        return self.cameras

    def get_train_virtual_cameras(self, config):
        virtual = (self.camtoworlds if self.virtual_camtoworlds is None
                   else self.virtual_camtoworlds)
        return (self.pixtocams, virtual, self.distortion_params, self.pixtocam_ndc)

    def _make_pixels(self, cam_idx, pix_x, pix_y, lossmult=None, light_idx=None):
        n = pix_x.shape[0]
        if light_idx is None:
            light_idx = (self.light_idx[cam_idx, pix_y, pix_x] if self.light_idx is not None
                         else np.zeros((n, 1), np.int32))
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
            pixels = self._make_pixels(
                cam_idx, pix_x, pix_y, light_idx=None if self.light_idx_flattened is None
                else self.light_idx_flattened[inds])
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
    files, unpickled as the JAX loader does. Under
    ``Config.compute_relight_metrics`` every split reads the relit views of
    `../relight_gt/{scene}_{env_map_name}` instead, and the env map
    `../relight_gt/{env_map_name}.exr` (area-downsampled by 4, y up,
    turned 180 degrees) gives the ``env_map*`` tables."""

    def _load_renderings(self, config):
        with open(os.path.join(self.data_dir, "../synthetic_split_128.pkl"), "rb") as f:
            test_ids, _ = pickle.load(f)
        data_dir = self.data_dir
        if self._load_env_map:
            scene = self.data_dir.split("/")[-1]
            data_dir = os.path.join(self.data_dir,
                                    f"../relight_gt/{scene}_{config.env_map_name}")
            im_ids = [str(k) for k in range(len(glob.glob(f"{data_dir}/*.pkl")))]
        elif self.split == "train":
            im_ids = [str(k) for k in range(len(glob.glob(f"{self.data_dir}/*.pkl")))]
        else:
            im_ids = sorted(test_ids)

        images, mask_images, depth_images, camtoworlds, pixtocams = [], [], [], [], []
        for im_id in im_ids:
            with open(os.path.join(data_dir, im_id + "-camera.pkl"), "rb") as f:
                cam_data = pickle.load(f)
            pose = np.eye(4)
            pose[:3, :4] = cam_data[0]
            camtoworlds.append(np.linalg.inv(pose))
            pixtocams.append(cam_data[1])

            image = io_lib.load_img(os.path.join(data_dir, im_id + ".png"))
            image = np.clip(image_ops.srgb_to_linear(image.astype(np.float64) / 255.0), 0.0,
                            np.inf)
            images.append(image)

            depth_file = os.path.join(data_dir, im_id + "-depth.png")
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
        if self._load_env_map:
            tables = env_maps.load_env_map(
                os.path.join(self.data_dir, f"../relight_gt/{config.env_map_name}.exr"),
                downsample=4, y_up=True, flip=True)
            for k, v in tables.items():
                setattr(self, k, v)
        self.camtoworlds = camtoworlds
        self.pixtocams = pixtocams.astype(np.float32)
        self.lights = self.camtoworlds[..., :3, -1]


# --- real captures -----------------------------------------------------------------------


def _map_views(fn, items):
    """`fn` over each view, the results in order, on a pool of host threads
    (the JPEG decodes and the resizes release the GIL)."""
    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


class OpenIllum(Dataset):
    """OpenIllumination light-stage captures (the `output/` directory of an
    object): poses from `transforms_{split}.json`, the intrinsics scaled and
    the images shrunk by `Config.factor` (`test_factor` on the test split),
    the `.JPG` images of each illumination from
    `../Lights/{illumination}/raw_undistorted/` resized by OpenCV's
    Lanczos-4, made linear, and composited on white by the `com_masks`
    (train, > 0.5) or `obj_masks` (test, > 0) PNGs resized by nearest; the
    lights at the cameras. The illuminations: 013 alone; under
    ``Config.multi_illumination`` (not with ``vis_only``) the three of
    ``ILLUM_MAPS_MULTI``, each pixel's light index that of its
    illumination's place, the cameras repeated once per illumination, and
    the three Radiance HDR env maps
    `../../../env_maps/hdrs/{illumination}.hdr` (times 2.5) giving the
    ``env_map*`` tables, concatenated along JAX's axes; under
    ``Config.compute_relight_metrics`` the views of illumination
    `env_map_name` and its env map's tables."""

    ILLUM_MAPS_MULTI = ["013", "011", "009"]

    def _load_renderings(self, config):
        multi = config.multi_illumination
        if self._load_env_map:
            illum_maps = [config.env_map_name]
        elif config.vis_only or not multi:
            illum_maps = ["013"]
        else:
            illum_maps = list(self.ILLUM_MAPS_MULTI)
        split = _split_name(self.split)
        _, camtoworlds, pixtocams, distortions, camtype, nameprefixes = load_ngp_posedata(
            config, self.data_dir, f"transforms_{split}.json")
        factor = max(config.factor if self.split == "train"
                     else (config.test_factor or config.factor), 1)
        pixtocams = pixtocams @ np.diag([factor, factor, 1.0])
        camtoworlds = (camtoworlds @ np.diag([1, -1, -1, 1.0]))[:, :3, :4]
        mask_dir = "./com_masks" if self.split == "train" else "./obj_masks"

        def load_image(item):
            illum_map, prefix = item
            image = io_lib.get_img(1, ".JPG", os.path.join(self.data_dir, prefix.replace(
                "./images", f"../Lights/{illum_map}/raw_undistorted"))) / 255.0
            image = io_lib.resize_lanczos4(
                image, (image.shape[1] // factor, image.shape[0] // factor))
            return np.clip(image_ops.srgb_to_linear(image), 0.0, np.inf)

        def load_mask(prefix):
            mask = io_lib.get_img(1, ".png", os.path.join(
                self.data_dir, prefix.replace("./images", mask_dir))) / 255.0
            mask = io_lib.resize_nearest(mask, (mask.shape[1] // factor, mask.shape[0] // factor))
            return mask[..., None] > (0.5 if self.split == "train" else 0.0)

        images = _map_views(load_image, [(m, p) for m in illum_maps for p in nameprefixes])
        # The PNG decoder's many small steps hold the GIL: threads slow it. Every
        # illumination reads the same masks.
        mask_images = [load_mask(prefix) for prefix in nameprefixes] * len(illum_maps)
        n = len(nameprefixes)
        self.light_idx = np.stack([np.full(image.shape[:2] + (1,), i // n, np.int32)
                                   for i, image in enumerate(images)])
        self.mask_images = np.stack(mask_images, axis=0).astype(np.float32)
        rgb = np.stack(images, axis=0)[..., :3]
        alpha = self.mask_images[..., :1]
        self.images = (rgb * alpha + (1.0 - alpha)).astype(np.float32)
        self.masks = alpha
        if multi:
            camtoworlds = np.concatenate([camtoworlds] * len(illum_maps), axis=0)
            pixtocams = np.concatenate([pixtocams] * len(illum_maps), axis=0)
        if multi or self._load_env_map:
            tables = [env_maps.load_env_map(os.path.join(
                self.data_dir, f"../../../env_maps/hdrs/{name}.hdr"), scale=2.5)
                for name in illum_maps]
            for name, axis in (("env_map", -2), ("env_map_pmf", -1), ("env_map_pdf", -1),
                               ("env_map_dirs", -2)):
                setattr(self, name, np.concatenate([t[name] for t in tables], axis=axis))
            self.env_map_h = tables[0]["env_map_h"]
            self.env_map_w = tables[0]["env_map_w"]
        self.camtoworlds = camtoworlds
        self.pixtocams = pixtocams
        self.distortion_params = distortions
        self.camtype = camtype
        self.lights = self.camtoworlds[..., :3, -1]


class Neilf(Dataset):
    """NeILF++ captures: `sfm_scene.json`'s calibrated cameras (flag 2),
    every image but those of `VALIDATION_INDEXES` (mod the image count) in
    the train split and those in the test split, the first of
    `images/<name>.{png,jpg,tiff,exr}` that exists (TIFF raises: the port
    reads none) area-downsampled by `Config.factor` and scaled by 0.25; the
    inverted extrinsics scaled so that the farthest camera is at 1, y and z
    swapped."""

    VALIDATION_INDEXES = [9, 18, 30, 41, 50, 62, 73, 82, 94]

    def _load_renderings(self, config):
        with open(os.path.join(self.data_dir, "sfm_scene.json")) as f:
            sfm_scene = json.load(f)
        intrinsics, extrinsics = {}, {}
        for index, info in sfm_scene["camera_track_map"]["images"].items():
            if info["flg"] == 2:
                k = np.zeros((4, 4))
                k[0, 0], k[1, 1] = info["camera"]["intrinsic"]["focal"]
                k[0, 2], k[1, 2] = info["camera"]["intrinsic"]["ppt"]
                k[2, 2] = k[3, 3] = 1
                intrinsics[index] = k
                extrinsics[index] = np.array(info["camera"]["extrinsic"]).reshape(4, 4)

        image_list = sfm_scene["image_path"]["file_paths"]
        image_indexes = [str(k) for k in sorted(int(k) for k in image_list)]
        validation = {v % len(image_indexes) for v in self.VALIDATION_INDEXES}
        selected = [idx for i, idx in enumerate(image_indexes)
                    if (i in validation) == (self.split != "train")]

        def load(image_index):
            prefix = os.path.split(os.path.splitext(image_list[image_index])[0])[1]
            fprefix = os.path.join(self.data_dir, "images", prefix)
            for ext in (".png", ".jpg", ".tiff", ".exr"):
                if os.path.exists(fprefix + ext):
                    img = io_lib.get_img(max(config.factor, 1), ext, fprefix)
                    return (img if ext == ".exr" else img / 255.0)[..., :3] * 0.25
            raise FileNotFoundError(fprefix)

        images = _map_views(load, selected)
        camtoworlds = np.stack([np.linalg.inv(extrinsics[i])[:3, :4]
                                @ np.diag([1.0, -1.0, -1.0, 1.0]) for i in selected], axis=0)
        pixtocams = [np.linalg.inv(intrinsics[i][:3, :3]) for i in selected]
        camtoworlds[:, :3, 3] *= 1.0 / np.max(np.abs(camtoworlds[:, :3, 3]))
        camtoworlds = np.array([[1.0, 0, 0], [0, 0, 1], [0, 1, 0]]) @ camtoworlds
        self.images = np.stack(images, axis=0).astype(np.float32)
        self.camtoworlds = camtoworlds.astype(np.float32)
        self.pixtocams = np.stack(pixtocams, axis=0).astype(np.float32)


class GlossyReal(Dataset):
    """NeRO's real captures: `cache.pkl` (world-to-camera poses, OpenCV
    intrinsics and image names by id), the poses normalised by
    `object_point_cloud.ply` (centred on its box, scaled by its farthest
    point, rotated by the object's `META_INFO` up and forward), the
    intrinsics rescaled from the probe image `images/<first name>` to a
    1024-pixel long side, the images from `images_raw_1024/`, the poses
    aligned by ``camera_utils.transform_poses_pca``. The capture's files are
    the object's own, unpickled as the JAX loader does."""

    META_INFO = {
        "bear": {"forward": [0.539944, -0.342791, 0.341446],
                 "up": [0.0512875, -0.645326, -0.762183]},
        "coral": {"forward": [0.004226, -0.235523, 0.267582],
                  "up": [0.0477973, -0.748313, -0.661622]},
        "maneki": {"forward": [-2.336584, -0.406351, 0.482029],
                   "up": [-0.0117387, -0.738751, -0.673876]},
        "bunny": {"forward": [0.437076, -1.672467, 1.436961],
                  "up": [-0.0693234, -0.644819, -0.761185]},
        "vase": {"forward": [-0.911907, -0.132777, 0.180063],
                 "up": [-0.01911, -0.738918, -0.673524]},
    }

    @staticmethod
    def _load_point_cloud(pcl_path):
        """The x, y, z columns of a PLY file's vertices, read as the JAX
        loader reads them: every property line after `element vertex`
        counts as a vertex property (those of later elements too), and a
        binary file's properties are all read as little-endian float32."""
        with open(pcl_path, "rb") as f:
            header = []
            while True:
                line = f.readline().decode("ascii", "ignore").strip()
                header.append(line)
                if line == "end_header":
                    break
            n_verts, props, fmt = 0, [], "ascii"
            for line in header:
                if line.startswith("format"):
                    fmt = line.split()[1]
                if line.startswith("element vertex"):
                    n_verts = int(line.split()[-1])
                if line.startswith("property") and n_verts:
                    props.append(line.split()[-1])
            if fmt == "ascii":
                data = np.loadtxt(f, max_rows=n_verts)
            else:
                dt = np.dtype([(p, "<f4") for p in props])
                data = np.frombuffer(f.read(n_verts * dt.itemsize), dtype=dt)
                data = np.stack([data[p] for p in props], axis=1)
        ix, iy, iz = props.index("x"), props.index("y"), props.index("z")
        return np.stack([data[:, ix], data[:, iy], data[:, iz]], axis=1).astype(float)

    @staticmethod
    def _compute_rotation(vert, forward):
        y = np.cross(vert, forward)
        x = np.cross(y, vert)
        vert = vert / np.linalg.norm(vert)
        x = x / np.linalg.norm(x)
        y = y / np.linalg.norm(y)
        return np.stack([x, y, vert], 0)

    def _normalize(self, poses):
        ref_points = self._load_point_cloud(os.path.join(self.data_dir,
                                                         "object_point_cloud.ply"))
        max_pt, min_pt = np.max(ref_points, 0), np.min(ref_points, 0)
        center = (max_pt + min_pt) * 0.5
        offset = -center
        scale = 1 / np.max(np.linalg.norm(ref_points - center[None], 2, 1))
        meta = self.META_INFO[self.object_name]
        up = np.asarray(meta["up"], np.float32)
        forward = np.asarray(meta["forward"], np.float32)
        up, forward = up / np.linalg.norm(up), forward / np.linalg.norm(forward)
        r_rec = self._compute_rotation(up, forward)
        for img_id, pose in poses.items():
            rot, t = pose[:, :3], pose[:, 3]
            poses[img_id] = np.concatenate([rot @ r_rec.T, ((t - rot @ offset) * scale)[:, None]],
                                           -1)
        return poses

    def _load_renderings(self, config):
        self.object_name = self.data_dir.rstrip("/").split("/")[-1]
        with open(os.path.join(self.data_dir, "cache.pkl"), "rb") as f:
            poses_dict, ks_dict, names_dict, _ = pickle.load(f)
        poses_dict = self._normalize(poses_dict)
        h, w = io_lib.load_img(os.path.join(self.data_dir, "images", names_dict[1])).shape[:2]

        camtoworlds, pixtocams, nameprefixes = [], [], []
        for key in names_dict:
            pose = np.eye(4)
            pose[:3, :4] = np.array(poses_dict[key])
            ratio = 1024.0 / max(h, w)
            th, tw = int(ratio * h), int(ratio * w)
            camtoworlds.append(np.linalg.inv(pose)[:3, :4])
            pixtocams.append(np.diag([tw / w, th / h, 1.0]) @ ks_dict[key])
            nameprefixes.append(os.path.join("images_raw_1024", names_dict[key]))

        pixtocams = np.linalg.inv(np.array(pixtocams))
        camtoworlds = np.array(camtoworlds) @ np.diag([1, -1, -1, 1.0])
        camtoworlds, _ = camera_utils.transform_poses_pca(camtoworlds[:, :3, :4])

        def load(prefix):
            image = io_lib.get_imgs(self.data_dir, config.factor, False, False, False, False,
                                    False, False, prefix)[0]
            if self._use_exrs:
                image = np.clip(image_ops.srgb_to_linear(image), 0.0, np.inf)
            return image

        images = _map_views(load, nameprefixes)
        self.images = np.stack(images, axis=0)[..., :3].astype(np.float32)
        self.camtoworlds = camtoworlds.astype(np.float32)
        self.pixtocams = pixtocams.astype(np.float32)


class Real(Dataset):
    """Real captures posed by NGP JSONs: the poses recentred on the train
    split's average pose and scaled so that the farthest train camera
    coordinate is 1, the intrinsics scaled by `Config.factor`, sRGB made
    linear unless `Config.linear_to_srgb` or EXR."""

    def _load_renderings(self, config):
        _, camtoworlds_train, _, _, _, _ = load_ngp_posedata(
            config, self.data_dir, "transforms_train.json")
        _, camtoworlds, pixtocams, distortions, camtype, nameprefixes = load_ngp_posedata(
            config, self.data_dir, f"transforms_{_split_name(self.split)}.json")
        factor = max(config.factor, 1)
        pixtocams = pixtocams @ np.diag([factor, factor, 1.0])
        camtoworlds_train, tform = camera_utils.recenter_poses(camtoworlds_train[:, :3, :4])
        camtoworlds = camera_utils.unpad_poses(tform @ camera_utils.pad_poses(
            camtoworlds[:, :3, :4]))
        camtoworlds[:, :3, 3] *= 1.0 / np.max(np.abs(camtoworlds_train[:, :3, 3]))
        images = [io_lib.get_imgs(self.data_dir, config.factor, self._use_tiffs, self._use_exrs,
                                  False, False, False, False, prefix)[0]
                  for prefix in nameprefixes]
        self.images = np.stack(images, axis=0).astype(np.float32)
        if not self._use_exrs and not config.linear_to_srgb:
            self.images = np.clip(image_ops.srgb_to_linear(self.images), 0.0, np.inf)
        self.images = self.images[..., :3]
        self.camtoworlds = camtoworlds
        self.pixtocams = pixtocams
        self.distortion_params = distortions
        self.camtype = camtype


class LLFF(Dataset):
    """Real scenes in the LLFF / mip-NeRF 360 layout: the poses from
    COLMAP's `sparse/0/` binaries (``data/colmap.py``; the default), from
    `poses_bounds.npy` (`Config.llff_load_from_poses_bounds`) or from an
    NGP `transforms.json` (`Config.load_ngp_format_poses`), put in the
    images' name order (`Config.load_alphabetical`); the images, sorted by
    file name and paired with the poses in that order, from
    `{image_subdir or images}_{factor}/` (no suffix at factor 0 or 1), the
    intrinsics scaled by the factor, sRGB made linear unless
    `Config.linear_to_srgb`; the poses aligned by
    ``camera_utils.transform_poses_pca``, or, forward-facing from
    `poses_bounds.npy`, scaled so that the near bound is at 4 / 3; every
    `Config.llffhold`-th image (from the first) held out for the test split.
    The cameras' lens distortion comes with them, and their type is kept
    (as in JAX, no cast reads it: a fisheye is cast as a perspective camera
    with the OpenCV radial model)."""

    def _load_renderings(self, config):
        image_subdir = config.image_subdir or "images"
        factor = 1 if config.factor == 0 else config.factor
        image_dir_suffix = "" if factor == 1 else f"_{config.factor}"
        bounds = None
        if config.llff_load_from_poses_bounds:
            image_names = sorted(os.listdir(os.path.join(self.data_dir, image_subdir)))
            poses, pixtocams, distortions, camtype, bounds = load_llff_posedata(self.data_dir)
        elif config.load_ngp_format_poses:
            image_names, poses, pixtocams, distortions, camtype, _ = load_ngp_posedata(
                config, self.data_dir)
            poses = poses[:, :3, :4]
        else:
            image_names, poses, pixtocams, distortions, camtype = colmap.load_colmap_posedata(
                self.data_dir)
        if config.load_alphabetical:
            inds = np.argsort(image_names)
            poses, pixtocams, distortions = camera_utils.gather_cameras(
                (poses, pixtocams, distortions), inds)
        pixtocams = (pixtocams @ np.diag([factor, factor, 1.0])).astype(np.float32)
        self.camtype = camtype

        image_dir = os.path.join(self.data_dir, image_subdir + image_dir_suffix)

        def load(name):
            image = io_lib.load_img(os.path.join(image_dir, name)) / 255.0
            if not config.linear_to_srgb:
                image = np.clip(image_ops.srgb_to_linear(image), 0.0, np.inf)
            return image

        images = np.stack(_map_views(load, sorted(os.listdir(image_dir))))
        if config.forward_facing and bounds is not None:
            scale = 1.0 / (bounds.min() * 0.75)
            poses[:, :3, 3] *= scale
        else:
            poses, _ = camera_utils.transform_poses_pca(poses)
        all_indices = np.arange(images.shape[0])
        test_indices = all_indices[::config.llffhold] if config.llffhold > 0 else all_indices[:0]
        indices = (test_indices if self.split != "train"
                   else np.array([i for i in all_indices if i not in test_indices]))
        self.images = images[indices][..., :3].astype(np.float32)
        self.camtoworlds = poses[indices].astype(np.float32)
        if pixtocams.ndim == 3 and pixtocams.shape[0] > 1:
            self.pixtocams = pixtocams[indices]
        else:
            self.pixtocams = pixtocams
        self.distortion_params = distortions


def read_cam_params_fipt(cam_file):
    """A FIPT camera text file: the count, then 3 rows per camera (origin,
    look-at and up for `cam.txt`, the intrinsic rows for `K_list.txt`)."""
    with open(cam_file) as f:
        cam_data = f.read().splitlines()
    cam_num = int(cam_data[0])
    cam_params = np.array([x.split(" ") for x in cam_data[1:]]).astype(np.float32)
    assert cam_params.shape[0] == cam_num * 3
    return np.split(cam_params, cam_num, axis=0)


class FIPTReal(Dataset):
    """FIPT real captures: `cam.txt` (OpenGL origin, look-at, up) aligned by
    ``camera_utils.transform_poses_pca``, `K_list.txt`, the `Image/*.exr`
    frames (`Config.use_exrs`) sorted by name, area-downsampled by
    `Config.factor`, made sRGB under `Config.linear_to_srgb`; batches from
    the flattened pixel table."""

    def _load_renderings(self, config):
        root = os.path.expanduser(self.data_dir)
        c2ws = []
        for c2w_raw in read_cam_params_fipt(os.path.join(root, "cam.txt")):
            origin, lookat, up = [v.flatten() for v in np.split(c2w_raw.T, 3, axis=1)]
            at = (lookat - origin) / np.linalg.norm(lookat - origin)
            rot = np.stack((np.cross(-up, at), up, -at), -1).astype(np.float32)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :4] = np.hstack((rot, origin.reshape(3, 1).astype(np.float32)))
            c2ws.append(pose)
        c2ws = np.stack(c2ws, 0)[:, :3, :4]
        ks = np.stack(read_cam_params_fipt(os.path.join(root, "K_list.txt")), 0)
        self.camtoworlds, _ = camera_utils.transform_poses_pca(c2ws)
        self.pixtocams = np.linalg.inv(ks).astype(np.float32)
        nameprefixes = sorted(os.path.join("Image", p[: -len(".exr")])
                              for p in os.listdir(os.path.join(root, "Image"))
                              if p.endswith(".exr"))
        self._load_fipt_images(config, nameprefixes)

    def _load_fipt_images(self, config, nameprefixes):
        images = np.stack([
            io_lib.get_imgs(self.data_dir, max(config.factor, 1), False, self._use_exrs, False,
                            False, False, False, prefix)[0] for prefix in nameprefixes], axis=0)
        if self._use_exrs and config.linear_to_srgb:
            images = np.clip(image_ops.linear_to_srgb_host(images / 0.65 * 0.65), 0.0, np.inf)
        self.images = images[..., :3].astype(np.float32)
        self._flattened = True
        self.images_flattened, self.indices_flattened = flatten_data(list(self.images))


class FIPTSynthetic(FIPTReal):
    """FIPT synthetic scenes: poses and intrinsics from the NGP JSON
    `train/transforms.json` (x and z flipped), its frames as FIPTReal's."""

    def _load_renderings(self, config):
        _, camtoworlds, pixtocams, distortions, camtype, nameprefixes = load_ngp_posedata(
            config, self.data_dir, "train/transforms.json")
        camtoworlds = camtoworlds @ np.diag([-1, 1, -1, 1.0])
        self.camtoworlds = camtoworlds[:, :3, :4]
        self.pixtocams = pixtocams
        self.distortion_params = distortions
        self.camtype = camtype
        self._load_fipt_images(config, nameprefixes)


class TanksAndTemplesNerfPP(Dataset):
    """Tanks and Temples in NeRF++'s layout: `{split}/{pose,intrinsics,rgb}/`
    text files and images sorted by name (the `camera_path` folder under
    `Config.render_path`), the poses' y and z flipped."""

    def _load_renderings(self, config):
        split_str = "camera_path" if config.render_path else _split_name(self.split)
        basedir = os.path.join(self.data_dir, split_str)

        def load_files(dirname, load_fn, shape=None):
            d = os.path.join(basedir, dirname)
            mats = np.array([load_fn(os.path.join(d, f)) for f in sorted(os.listdir(d))])
            return mats.reshape(mats.shape[:1] + shape) if shape else mats

        poses = np.matmul(load_files("pose", np.loadtxt, (4, 4)), np.diag([1.0, -1, -1, 1]))
        intrinsics = load_files("intrinsics", np.loadtxt, (4, 4))
        self.images = (load_files("rgb", io_lib.load_img) / 255.0)[..., :3].astype(np.float32)
        self.camtoworlds = poses[:, :3, :4].astype(np.float32)
        self.pixtocams = np.linalg.inv(intrinsics)[..., :3, :3].astype(np.float32)


class TanksAndTemplesFVS(Dataset):
    """Tanks and Temples in Free View Synthesis' layout: the image pyramid
    `dense/ibr3d*` (the `Config.factor`-th from the finest), its `im_*`
    images and `Ks.npy` / `Rs.npy` / `ts.npy` (OpenCV world-to-camera)
    cameras, aligned by ``camera_utils.transform_poses_pca``; every
    `Config.llffhold`-th image held out."""

    def _load_renderings(self, config):
        basedir = os.path.join(self.data_dir, "dense")
        sizes = sorted(f for f in os.listdir(basedir) if f.startswith("ibr3d"))[::-1]
        if config.factor >= len(sizes):
            raise ValueError(f"Factor {config.factor} larger than {len(sizes)}")
        basedir = os.path.join(basedir, sizes[config.factor])
        files = sorted(f for f in os.listdir(basedir) if f.startswith("im_"))
        images = np.array([io_lib.load_img(os.path.join(basedir, f)) for f in files]) / 255.0
        intrinsics = np.load(os.path.join(basedir, "Ks.npy"))
        rot = np.load(os.path.join(basedir, "Rs.npy"))
        trans = np.load(os.path.join(basedir, "ts.npy"))
        w2c = np.concatenate([rot, trans[..., None]], axis=-1)
        c2w = np.linalg.inv(camera_utils.pad_poses(w2c))[:, :3, :4] @ np.diag([1.0, -1, -1, 1])
        poses, _ = camera_utils.transform_poses_pca(c2w)
        all_indices = np.arange(images.shape[0])
        test = all_indices % config.llffhold == 0
        indices = all_indices[~test] if self.split == "train" else all_indices[test]
        self.images = images[indices][..., :3].astype(np.float32)
        self.camtoworlds = poses[indices].astype(np.float32)
        self.pixtocams = np.linalg.inv(intrinsics)[..., :3, :3].astype(np.float32)
        if self.pixtocams.shape[0] == images.shape[0]:
            self.pixtocams = self.pixtocams[indices]


class DTU(Dataset):
    """DTU MVS scans: `rect_{i:03d}_{light}.png` views (the light condition
    `Config.dtu_light_cond`) area-downsampled by `Config.factor`, each
    camera from its projection matrix `../../Calibration/cal18/pos_{i}.txt`
    (``camera_utils.decompose_projection_matrix``, OpenCV's decomposition,
    which the card's machine does not have), the poses recentred on their
    focus point and scaled into [-1, 1]; every `Config.llffhold`-th image
    held out."""

    def _load_renderings(self, config):
        def load_image(i):
            if config.dtu_light_cond < 7:
                light_str = f"{config.dtu_light_cond}_r" + ("5000" if i < 50 else "7000")
            else:
                light_str = "max"
            image = io_lib.load_img(
                os.path.join(self.data_dir, f"rect_{i:03d}_{light_str}.png")) / 255.0
            if config.factor > 1:
                image = io_lib.downsample(image, config.factor)
            projection = np.loadtxt(
                os.path.join(self.data_dir, f"../../Calibration/cal18/pos_{i:03d}.txt"),
                dtype=np.float32)
            camera_mat, rot_mat, t = camera_utils.decompose_projection_matrix(projection)
            camera_mat = camera_mat / camera_mat[2, 2]
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = rot_mat.transpose()
            pose[:3, 3] = (t[:3] / t[3])[:, 0]
            if config.factor > 0:
                camera_mat = np.diag([1.0 / config.factor, 1.0 / config.factor, 1.0]).astype(
                    np.float32) @ camera_mat
            return image, pose[:3], np.linalg.inv(camera_mat)

        n_images = len(os.listdir(self.data_dir)) // 8
        images, camtoworlds, pixtocams = zip(*[load_image(i) for i in range(1, n_images + 1)])
        images = np.stack(images)
        camtoworlds = np.stack(camtoworlds) @ np.diag([1.0, -1, -1, 1]).astype(np.float32)
        camtoworlds, _ = camera_utils.transform_poses_focus(camtoworlds)
        camtoworlds[:, :3, -1] /= np.max(np.abs(camtoworlds[:, :3, -1]))
        all_indices = np.arange(images.shape[0])
        test = all_indices % config.llffhold == 0
        indices = all_indices[~test] if self.split == "train" else all_indices[test]
        self.images = images[indices][..., :3].astype(np.float32)
        self.camtoworlds = camtoworlds[indices].astype(np.float32)
        self.pixtocams = np.stack(pixtocams)[indices].astype(np.float32)


class RTMV(Dataset):
    """RTMV's ray-traced views: every `*.exr` (not `.depth.exr` or
    `.seg.exr`) beside its camera `*.json` (`cam2world`, `fx`), both sorted
    by name, area-downsampled by `Config.factor`, made sRGB and multiplied
    by their alpha (the masks); both splits are every view."""

    def _load_renderings(self, config):
        filenames = sorted(os.listdir(self.data_dir))
        image_filenames = [f for f in filenames if f.endswith(".exr")
                           and not f.endswith(".depth.exr") and not f.endswith(".seg.exr")]
        camera_filenames = [f for f in filenames if f.endswith(".json")]
        assert len(image_filenames) == len(camera_filenames)
        images, poses = [], []
        camera_data = None
        for image_f, camera_f in zip(image_filenames, camera_filenames):
            channels = io_lib.load_exr(os.path.join(self.data_dir, image_f))
            if config.factor > 1:
                channels = io_lib.downsample(channels, config.factor)
            images.append(image_ops.linear_to_srgb_host(channels))
            with open(os.path.join(self.data_dir, camera_f)) as fp:
                camera_data = json.load(fp)["camera_data"]
            poses.append(np.array(camera_data["cam2world"]).T[:3, :4])
        self.images = np.stack(images, axis=0)
        rgb = self.images[..., :3]
        alpha = (self.images[..., -1:] if self.images.shape[-1] == 4
                 else np.ones_like(rgb[..., :1]))
        self.images = (rgb * alpha).astype(np.float32)
        self.masks = alpha.astype(np.float32)
        h, w = self.images.shape[1:3]
        focal = float(camera_data["intrinsics"]["fx"]) / max(config.factor, 1)
        self.pixtocams = camera_utils.get_pixtocam(focal, w, h)[None].astype(np.float32)
        self.camtoworlds = np.stack(poses, axis=0).astype(np.float32)


def _read_sfm_camera(path):
    """One SfM camera in the open JSON or `.npz` encoding that the JAX
    package's PixelRig and Aerial loaders read: `focal_length`,
    `pixel_aspect_ratio` (fy = f * aspect, default 1), `principal_point_x`
    / `_y`, optional `image_size_x` / `_y`, and `camera_from_world` or
    `world_from_camera` [4, 4]. Returns {camera_from_world, calibration,
    focal_length, image_size_x, image_size_y}; any other file raises."""
    with open(path, "rb") as f:
        blob = f.read()
    cam = None
    try:
        cam = {k: np.asarray(v) for k, v in json.loads(blob).items()}
    except (UnicodeDecodeError, json.JSONDecodeError):
        try:
            cam = dict(np.load(io.BytesIO(blob), allow_pickle=False))
        except Exception:
            pass
    if cam is None or "focal_length" not in cam:
        raise NotImplementedError(
            f"camera file {path!r} is not the open JSON/npz SfM-camera format (see "
            "_read_sfm_camera); vision_sfm CameraProto binaries are not read: re-export the "
            "cameras as JSON/npz.")
    if "camera_from_world" in cam:
        cam_from_world = np.asarray(cam["camera_from_world"], np.float64)
    else:
        cam_from_world = np.linalg.inv(np.asarray(cam["world_from_camera"], np.float64))
    f = float(cam["focal_length"])
    aspect = float(cam.get("pixel_aspect_ratio", 1.0))
    calibration = camera_utils.intrinsic_matrix(
        f, f * aspect, float(cam["principal_point_x"]), float(cam["principal_point_y"]))
    return {"camera_from_world": cam_from_world, "calibration": calibration,
            "focal_length": f, "image_size_x": int(cam.get("image_size_x", 0)),
            "image_size_y": int(cam.get("image_size_y", 0))}


def _opencv_pose(cam_from_world, translation_scale):
    """World-from-camera [3, 4] in OpenGL axes, its position scaled."""
    pose = np.linalg.inv(camera_utils.pad_poses(cam_from_world[:3, :4]))[:3, :4]
    pose = pose @ np.diag([1.0, -1.0, -1.0, 1.0])
    pose[:3, -1] *= translation_scale
    return pose


class PixelRig(Dataset):
    """A Pixel phone's five-camera cross rig, forward-facing, rendered in NDC
    space: the images of `data_dir` and the cameras of its
    `scaled_camera_pose` twin (``_read_sfm_camera``), positions scaled by
    1 / `Config.near`, the world's y and z flipped, near 0 and far 1; the
    NDC warp's pixtocam centred, of the first camera's focal. Under
    `Config.render_path` the cameras are a ring of `render_path_frames`
    around the rig's centre through the first camera's intrinsics."""

    def _load_renderings(self, config):
        images_dir = self.data_dir
        cameras_dir = images_dir.replace("scaled_images", "scaled_camera_pose")
        image_files = sorted(os.listdir(images_dir))
        camera_files = sorted(os.listdir(cameras_dir))
        assert len(image_files) == len(camera_files)
        images, poses, pixtocams = [], [], []
        for image_f, camera_f in zip(image_files, camera_files):
            images.append(io_lib.load_img(os.path.join(images_dir, image_f)) / 255.0)
            cam = _read_sfm_camera(os.path.join(cameras_dir, camera_f))
            poses.append(_opencv_pose(cam["camera_from_world"], 1.0 / config.near))
            pixtocams.append(np.linalg.inv(cam["calibration"]))
        self.near, self.far = 0.0, 1.0
        poses = np.diag([1.0, -1.0, -1.0]) @ np.stack(poses, axis=0)
        radius = np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1))
        angles = np.linspace(0, 2 * np.pi, config.render_path_frames, endpoint=False)
        self.render_poses = np.stack([
            np.concatenate([np.eye(3), radius * np.array([[np.cos(a)], [np.sin(a)], [0.0]])],
                           axis=-1) for a in angles], axis=0).astype(np.float32)
        if config.render_path:
            self.camtoworlds = self.render_poses
            self.pixtocams = pixtocams[0].astype(np.float32)
        else:
            self.camtoworlds = poses.astype(np.float32)
            self.pixtocams = np.stack(pixtocams, axis=0).astype(np.float32)
        self.images = np.stack(images, axis=0)[..., :3].astype(np.float32)
        h, w = self.images.shape[1:3]
        focal = 1.0 / self.pixtocams.reshape(-1, 3, 3)[0, 0, 0]
        self.pixtocam_ndc = np.linalg.inv(
            camera_utils.intrinsic_matrix(focal, focal, w / 2.0, h / 2.0)).astype(np.float32)


class Aerial(Dataset):
    """Aerial captures: `rgb/` images and `cameras/` (``_read_sfm_camera``)
    sorted by name, positions divided by `Config.world_scale`; every
    `Config.llffhold`-th image held out. Under `Config.render_path` the
    cameras are those of `orbit_cameras/` where it exists (their
    intrinsics, the last one's), else a ring of `render_path_frames` over
    the scene with a focal of 3 widths."""

    def _load_renderings(self, config):
        images_dir = os.path.join(self.data_dir, "rgb")
        cameras_dir = os.path.join(self.data_dir, "cameras")
        image_files = sorted(os.listdir(images_dir))
        camera_files = sorted(os.listdir(cameras_dir))
        assert len(image_files) == len(camera_files)
        images = np.stack([io_lib.load_img(os.path.join(images_dir, f)) / 255.0
                           for f in image_files], axis=0)

        def load_cam(path):
            cam = _read_sfm_camera(path)
            pose = _opencv_pose(cam["camera_from_world"], 1.0 / config.world_scale)
            return cam, pose, np.linalg.inv(cam["calibration"])

        cams = [load_cam(os.path.join(cameras_dir, f)) for f in camera_files]
        poses = np.stack([c[1] for c in cams], axis=0)
        pixtocams = np.stack([c[2] for c in cams], axis=0)
        all_indices = np.arange(images.shape[0])
        is_test = all_indices % config.llffhold == 0
        indices = all_indices[is_test if self.split != "train" else ~is_test]
        self.images = images[indices][..., :3].astype(np.float32)
        self.camtoworlds = poses[indices].astype(np.float32)
        self.pixtocams = pixtocams[indices].astype(np.float32)
        if not config.render_path:
            return
        orbit_dir = os.path.join(self.data_dir, "orbit_cameras")
        if os.path.isdir(orbit_dir):
            render_poses = []
            for f in sorted(os.listdir(orbit_dir)):
                cam, pose, pixtocam = load_cam(os.path.join(orbit_dir, f))
                render_poses.append(pose)
                self.pixtocams = pixtocam.astype(np.float32)
                if cam["image_size_x"]:
                    self.width = cam["image_size_x"]
                    self.height = cam["image_size_y"]
            self.camtoworlds = np.stack(render_poses, axis=0).astype(np.float32)
        else:
            h, w = images.shape[1:3]
            angles = np.linspace(0, 2 * np.pi, config.render_path_frames, endpoint=False)
            up = np.array([0.0, 0.0, 1.0])
            self.camtoworlds = np.stack([
                camera_utils.viewmatrix(np.array([np.cos(a), np.sin(a), 1.0]), up,
                                        np.array([np.cos(a), np.sin(a), 1.0]))
                for a in angles], axis=0).astype(np.float32)
            focal = 3.0 * w
            self.pixtocams = np.array([[1.0 / focal, 0.0, -0.5 * w / focal],
                                       [0.0, -1.0 / focal, 0.5 * h / focal],
                                       [0.0, 0.0, -1.0]], np.float32)


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


class TransientSimulationIToF(Dataset):
    """iToF frames stored whole: `transforms_{split}.json`, each frame's
    image (an h5 `data` volume [H, W, 4, 3] of its four phases, or a PNG /
    JPEG / EXR) area-downsampled by `Config.factor`; the mask where the last
    channel's sum over the phases is positive, the frames times 255 /
    `Config.dataset_scale` clipped to [0, 1000]; batches from the flattened
    table of 4 bins."""

    def _load_renderings(self, config):
        _, camtoworlds, pixtocams, distortions, camtype, nameprefixes = load_ngp_posedata(
            config, self.data_dir, f"transforms_{_split_name(self.split)}.json")
        images = np.stack([
            io_lib.get_imgs(self.data_dir, max(config.factor, 1), self._use_tiffs,
                            self._use_exrs, False, False, False, False, p)[0]
            for p in nameprefixes], axis=0)
        self.masks = (images[..., -1].sum(-1) > 0).astype(np.float32)[..., None]
        self.alphas = self.masks[..., 0]
        images = np.clip(images[..., :3] * 255 / config.dataset_scale, 0, 1000.0)
        self.images = images.astype(np.float32)
        self._flattened = True
        self.images_flattened, self.indices_flattened = flatten_transient_data(
            list(self.images), n_bins=4)
        self.camtoworlds = camtoworlds[:, :3, :4]
        self.pixtocams = pixtocams
        self.distortion_params = distortions
        self.camtype = camtype
        self.lights = self.camtoworlds[..., :3, -1]


class PreloadedData(Dataset):
    """Arrays already in memory, the constructor's keywords: images [N, H,
    W, 3], camtoworlds [N, 3, 4], pixtocams [N or 1, 3, 3]."""

    def __init__(self, split, data_dir, config, device="cuda", **kwargs):
        self._preloaded = kwargs
        super().__init__(split, data_dir, config, device=device)

    def _load_renderings(self, config):
        self.images = np.asarray(self._preloaded["images"], np.float32)
        self.camtoworlds = np.asarray(self._preloaded["camtoworlds"], np.float32)
        self.pixtocams = np.asarray(self._preloaded["pixtocams"], np.float32)


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
