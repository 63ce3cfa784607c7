"""Datasets and ray batching (counterpart of ``data/datasets.py``; only the
procedural ``SyntheticSpheres`` scene is ported).

Images are ray-traced in numpy at construction and batches are drawn with
the same numpy RandomState stream as the JAX package, so both packages see
identical batches. Rays are cast on the host; ``next_train`` moves the batch
to the dataset's device.
"""

from __future__ import annotations

import numpy as np

from neural_radiance_caching_tpu_torch.data import camera_utils
from neural_radiance_caching_tpu_torch.utils import pytrees


class Dataset:
    """Base dataset: holds images + cameras, serves ray batches on `device`."""

    def __init__(self, split, data_dir, config, device="cpu"):
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
        rays = camera_utils.cast_ray_batch(self.cameras, self.lights, pixels)
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

    def __init__(self, split, data_dir, config, num_images=None, resolution=None, device="cpu"):
        if num_images is None:
            num_images = config.num_dataset_images if config.num_dataset_images > 0 else 16
        if resolution is None:
            resolution = 48 // max(1, config.factor)
        if config.synthetic_spheres_shading != "legacy" or config.synthetic_spheres_multi_illum:
            raise NotImplementedError("only the legacy single-light sphere scene is ported")
        if config.use_transient:
            raise NotImplementedError("transient sphere renderings are not ported yet")
        self._num_images = num_images
        self._resolution = resolution
        super().__init__(split, data_dir, config, device=device)

    def _trace(self, origins, dirs, light):
        """Analytic ray tracing of the sphere scene -> (rgb, alpha)."""
        n = origins.shape[0]
        best_t = np.full((n,), np.inf, np.float32)
        rgb = np.ones((n, 3), np.float32)  # white background
        alpha = np.zeros((n,), np.float32)
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
            ldir = to_light / np.linalg.norm(to_light, axis=-1, keepdims=True)
            lambert = np.maximum(0.0, np.sum(normal * ldir, -1, keepdims=True))
            rgb[hit] = np.array(albedo, np.float32) * (self.AMBIENT + (1 - self.AMBIENT) * lambert)
            best_t[hit] = t[hit]
            alpha[hit] = 1.0
        return rgb, alpha

    def _load_renderings(self, config):
        res = self._resolution
        camtoworlds = camera_utils.generate_spherical_poses(
            self._num_images, radius=4.0, seed=17 if self.split == "train" else 31)
        pixtocam = camera_utils.get_pixtocam(1.2 * res, res, res)
        pix_x, pix_y = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
        pix_x = pix_x.reshape(-1).astype(np.float32)
        pix_y = pix_y.reshape(-1).astype(np.float32)
        lights = np.broadcast_to(self.LIGHT, (self._num_images, 3)).copy()
        images, alphas = [], []
        for c2w, light in zip(camtoworlds, lights):
            out = camera_utils.pixels_to_rays(pix_x, pix_y, pixtocam[None], c2w[None])
            rgb, alpha = self._trace(out[0].reshape(-1, 3), out[2].reshape(-1, 3), light)
            images.append(rgb.reshape(res, res, 3))
            alphas.append(alpha.reshape(res, res))
        self.images = np.stack(images).astype(np.float32)
        self.alphas = np.stack(alphas).astype(np.float32)
        self.masks = self.alphas[..., None]
        self.pixtocams = pixtocam[None].astype(np.float32)
        self.camtoworlds = camtoworlds
        self.lights = lights
