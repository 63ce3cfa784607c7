"""Environment maps and their importance-sampling tables (counterpart of
``data/env_maps.py``).

An equirectangular (latitude-longitude) HDR becomes the tables the
environment samplers read (``ops/render_utils.EnvironmentSampler``,
``QuadratureEnvmapSampler``): the radiance per texel, its direction, the
pmf (the texel's summed radiance times sin(theta), normalised over the
texels) and the solid-angle pdf pmf * H * W / (2 pi^2 sin(theta)), computed
in float64 on the host and stored in float32, as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from neural_radiance_caching_tpu_torch.data import io as io_lib


def build_env_map_tables(env_map_rgb, y_up=False, rotation=0.0):
    """dict(env_map [1, H*W, 1, 3], env_map_pmf [1, H*W, 1], env_map_pdf
    [1, H*W, 1], env_map_dirs [1, H*W, 1, 3], env_map_h, env_map_w) of a
    linear-radiance map [H, W, 3]; `rotation` turns the azimuth, `y_up`
    maps (x, y, z) to (x, z, -y)."""
    light_intensity = env_map_rgb.sum(axis=-1, keepdims=True)
    h, w, _ = light_intensity.shape
    h_interval = 1.0 / h
    sin_theta = np.sin(np.linspace(0 + 0.5 * h_interval, np.pi - 0.5 * h_interval, h))

    pmf = light_intensity * sin_theta.reshape(-1, 1, 1)
    pmf = pmf / pmf.sum()
    pdf = pmf * h * w / (2 * np.pi * np.pi * sin_theta.reshape(-1, 1, 1))

    lat_step = np.pi / h
    lng_step = 2 * np.pi / w
    phi, theta = np.meshgrid(
        np.linspace(np.pi / 2 - 0.5 * lat_step, -np.pi / 2 + 0.5 * lat_step, h),
        np.linspace(np.pi - 0.5 * lng_step, -np.pi + 0.5 * lng_step, w),
        indexing="ij")
    theta = theta + rotation
    x = np.cos(theta) * np.cos(phi)
    y = np.sin(theta) * np.cos(phi)
    z = np.sin(phi)
    if y_up:
        x, y, z = x, z, -y
    dirs = np.stack([x, y, z], axis=-1).reshape(h, w, 3)
    return {
        "env_map": env_map_rgb.reshape(1, h * w, 1, 3).astype(np.float32),
        "env_map_pmf": pmf.reshape(1, h * w, 1).astype(np.float32),
        "env_map_pdf": pdf.reshape(1, h * w, 1).astype(np.float32),
        "env_map_dirs": dirs.reshape(1, h * w, 1, 3).astype(np.float32),
        "env_map_h": h,
        "env_map_w": w,
    }


def load_env_map(path, scale=1.0, downsample=1, y_up=False, flip=False):
    """The tables of the .hdr or .exr env map at `path`: its RGB times
    `scale`, area-downsampled by `downsample`, turned 180 degrees with
    `flip`."""
    if path.endswith(".exr"):
        rgb = io_lib.load_exr(path)[..., :3]
    else:
        rgb = io_lib.read_hdr(path)
    rgb = np.asarray(rgb, np.float32) * scale
    if downsample > 1:
        rgb = io_lib.downsample(rgb, downsample)
    if flip:
        rgb = rgb[::-1, ::-1]
    return build_env_map_tables(rgb, y_up=y_up)
