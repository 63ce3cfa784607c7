"""Datasets and ray batching (counterpart of ``data/datasets.py``; only the
procedural ``SyntheticSpheres`` scene is ported: ``load_dataset`` raises
NotImplementedError naming any other loader).

Images are ray-traced in numpy at construction and batches are drawn with
the same numpy RandomState stream as the JAX package, so both packages see
identical batches. Rays are cast on the host; ``next_train`` moves the batch
to the dataset's device, the card unless the caller passes ``device="cpu"``.
With ``Config.use_transient`` the images are time-binned transients
[N, H, W, n_bins, 3].
"""

from __future__ import annotations

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.data import camera_utils
from neural_radiance_caching_tpu_torch.utils import pytrees, torchutil


# The JAX package's loaders by Config.dataset_loader name.
LOADERS = ("blender", "blender_active", "transient_simulation", "transient_simulation_itof",
           "fwp_transient_captured", "orb", "open_illum", "neilf", "real", "fipt_real",
           "fipt_synthetic", "glossy_real", "glossy_synthetic", "llff", "tat_nerfpp", "tat_fvs",
           "dtu", "rtmv", "pixelrig", "aerial", "preloaded", "synthetic_spheres")


def load_dataset(split, data_dir, config, device="cuda", **kwargs):
    """Dataset dispatcher on Config.dataset_loader."""
    name = config.dataset_loader
    if name == "synthetic_spheres":
        return SyntheticSpheres(split, data_dir, config, device=device, **kwargs)
    if name in LOADERS:
        raise NotImplementedError(f"the {name!r} dataset loader is not ported yet")
    raise KeyError(f"unknown dataset loader {name!r}")


class Dataset:
    """Base dataset: holds images + cameras, serves ray batches on `device`
    (the card by default; raises without one rather than serving on the
    CPU)."""

    def __init__(self, split, data_dir, config, device="cuda"):
        torchutil.check_device(device, "a dataset", "serve batches on the CPU")
        if config.patch_size > 1 or config.cast_rays_in_train_step:
            raise NotImplementedError("patch batches and in-step ray casting are not ported yet")
        self.split = split
        self.data_dir = data_dir
        self.config = config
        self.device = device
        self._batch_size = config.batch_size
        self.near = config.near
        self.far = config.far
        self.images = None
        self.camtoworlds = None
        self.pixtocams = None
        self.lights = None
        self.masks = None
        self.alphas = None
        self.impulse_response = None
        self._np_rng = np.random.RandomState(config.np_rng_seed + (0 if split == "train" else 1))
        self._load_renderings(config)
        self.num_images = self.images.shape[0]
        self.height, self.width = self.images.shape[1:3]
        if self.lights is None:
            self.lights = self.camtoworlds[:, :3, -1]

    def _load_renderings(self, config):
        raise NotImplementedError

    @property
    def cameras(self):
        return (self.pixtocams, self.camtoworlds)

    def _make_pixels(self, cam_idx, pix_x, pix_y):
        n = pix_x.shape[0]
        return pytrees.Pixels(
            pix_x_int=pix_x,
            pix_y_int=pix_y,
            lossmult=np.ones((n, 1), np.float32),
            near=np.full((n, 1), self.near, np.float32),
            far=np.full((n, 1), self.far, np.float32),
            cam_idx=cam_idx.reshape(n, 1).astype(np.int32),
            light_idx=np.zeros((n, 1), np.int32),
        )

    def _gather_batch(self, cam_idx, pix_x, pix_y):
        pixels = self._make_pixels(cam_idx, pix_x, pix_y)
        rays = camera_utils.cast_ray_batch(self.cameras, self.lights, pixels).replace(
            impulse_response=self.impulse_response)
        masks = self.masks[cam_idx, pix_y, pix_x] if self.masks is not None else None
        alphas = self.alphas[cam_idx, pix_y, pix_x] if self.alphas is not None else None
        batch = pytrees.Batch(rays=rays, rgb=self.images[cam_idx, pix_y, pix_x],
                              masks=masks, alphas=alphas)
        return batch.to(self.device)

    def next_train(self):
        """Random pixels across all train images."""
        n = self._batch_size
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
