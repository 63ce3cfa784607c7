"""Camera math for the procedural scene (counterpart of the perspective part
of ``data/camera_utils.py``). Host-side numpy: rays are cast on the host and
moved to the device with the batch."""

from __future__ import annotations

import numpy as np

from neural_radiance_caching_tpu_torch.utils import pytrees


def get_pixtocam(focal, width, height):
    """Inverse intrinsic matrix for a centered pinhole camera."""
    camtopix = np.array(
        [[focal, 0, 0.5 * width], [0, focal, 0.5 * height], [0, 0, 1]], dtype=np.float32)
    return np.linalg.inv(camtopix)


def pixel_coordinates(width, height):
    """Integer (x, y) pixel grids, 'xy' indexing."""
    return np.meshgrid(np.arange(width), np.arange(height), indexing="xy")


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds):
    """Cast perspective rays through pixel centers; returns every per-ray
    camera field (origins, directions, viewdirs, radii, imageplane, look, up,
    cam_origins, vcam_look, vcam_up, vcam_origins).

    Radii follow the mip-NeRF convention: half the distance to the
    neighboring pixels' directions, scaled by 2/sqrt(12).
    """

    def pix_to_dir(x, y):
        return np.stack([x + 0.5, y + 0.5, np.ones_like(x)], axis=-1)

    pixel_dirs_stacked = np.stack(
        [pix_to_dir(pix_x_int + ox, pix_y_int + oy) for ox, oy in ((0, 0), (1, 0), (0, 1))],
        axis=0)
    mat_vec_mul = lambda a, b: np.matmul(a, b[..., None])[..., 0]
    camera_dirs_stacked = mat_vec_mul(pixtocams, pixel_dirs_stacked)
    # OpenCV -> OpenGL.
    camera_dirs_stacked = np.matmul(
        camera_dirs_stacked, np.diag(np.array([1.0, -1.0, -1.0], dtype=np.float32)))
    imageplane = camera_dirs_stacked[0, ..., :2]

    directions, ddx, ddy = mat_vec_mul(camtoworlds[..., :3, :3], camera_dirs_stacked)
    origins = np.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    look = np.broadcast_to(-camtoworlds[..., :3, 2], directions.shape)
    up = np.broadcast_to(camtoworlds[..., :3, 1], directions.shape)
    dx_norm = np.linalg.norm(ddx - directions, axis=-1)
    dy_norm = np.linalg.norm(ddy - directions, axis=-1)
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2 / np.sqrt(12)
    return (origins, directions, viewdirs, radii, imageplane, look, up, origins,
            look, up, origins)


def cast_ray_batch(cameras, lights, pixels: pytrees.Pixels) -> pytrees.Rays:
    """Turn a Pixels batch into a Rays batch by indexing per-ray cameras.

    `cameras` is (pixtocams [N or 1, 3, 3], camtoworlds [N, 3, 4]); `lights`
    is [N_lights or N_cams, 3].
    """
    pixtocams, camtoworlds = cameras[0], cameras[1]
    cam_idx = pixels.cam_idx[..., 0]
    light_idx = pixels.light_idx[..., 0]
    pixtocam = pixtocams[cam_idx if pixtocams.shape[0] > 1 else np.zeros_like(cam_idx)]
    camtoworld = camtoworlds[cam_idx]
    light = lights[light_idx if lights.shape[0] > 1 else np.zeros_like(light_idx)]
    (origins, directions, viewdirs, radii, imageplane, look, up, cam_origins,
     vcam_look, vcam_up, vcam_origins) = pixels_to_rays(
        pixels.pix_x_int, pixels.pix_y_int, pixtocam, camtoworld)
    return pytrees.Rays(
        origins=origins, directions=directions, viewdirs=viewdirs, radii=radii, lights=light,
        imageplane=imageplane, look=look, up=up, cam_origins=cam_origins,
        vcam_look=vcam_look, vcam_up=vcam_up, vcam_origins=vcam_origins,
        lossmult=pixels.lossmult, near=pixels.near, far=pixels.far, cam_idx=pixels.cam_idx,
        light_idx=pixels.light_idx, pix_x_int=pixels.pix_x_int, pix_y_int=pixels.pix_y_int,
        exposure_idx=pixels.exposure_idx, exposure_values=pixels.exposure_values,
    )


def generate_spherical_poses(n, radius, center=np.zeros(3), up_axis=2, min_elevation=0.2,
                             max_elevation=0.9, seed=0):
    """Camera-to-world matrices on a sphere looking at `center` (OpenGL)."""
    rng = np.random.RandomState(seed)
    poses = []
    for i in range(n):
        azim = 2 * np.pi * i / n + rng.uniform(0, 0.1)
        elev = rng.uniform(min_elevation, max_elevation) * np.pi / 2
        pos = center + radius * np.array(
            [np.cos(azim) * np.cos(elev), np.sin(azim) * np.cos(elev), np.sin(elev)])
        forward = center - pos
        forward = forward / np.linalg.norm(forward)
        world_up = np.zeros(3)
        world_up[up_axis] = 1.0
        right = np.cross(forward, world_up)
        right = right / np.linalg.norm(right)
        cam_up = np.cross(right, forward)
        rot = np.stack([right, cam_up, -forward], axis=-1)  # OpenGL: -z is forward.
        poses.append(np.concatenate([rot, pos[:, None]], axis=-1).astype(np.float32))
    return np.stack(poses)
