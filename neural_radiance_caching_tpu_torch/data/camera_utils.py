"""Camera math (counterpart of the perspective part of
``data/camera_utils.py``): rays cast from numpy pixels on the host (the
renderings, the eval views, batches of a config that casts outside the
step) or from tensor pixels on their device (``Config.cast_rays_in_train_step``,
the JAX step's jnp casting); the loaders' intrinsics and pose recentring."""

from __future__ import annotations

import enum

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.utils import pytrees, torchutil


class ProjectionType(enum.Enum):
    """The loaders' camera models; only PERSPECTIVE casts rays in the port."""

    PERSPECTIVE = "perspective"
    FISHEYE = "fisheye"
    FISHEYE_EQUISOLID = "fisheye_equisolid"
    PANORAMIC = "pano"


def get_pixtocam(focal, width, height):
    """Inverse intrinsic matrix for a centered pinhole camera."""
    camtopix = np.array(
        [[focal, 0, 0.5 * width], [0, focal, 0.5 * height], [0, 0, 1]], dtype=np.float32)
    return np.linalg.inv(camtopix)


def intrinsic_matrix(fx, fy, cx, cy):
    """Intrinsic matrix from focal lengths and principal point."""
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)


def pad_poses(p):
    """[..., 3, 4] -> [..., 4, 4] with a bottom (0, 0, 0, 1) row."""
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def viewmatrix(lookdir, up, position):
    """Camera-to-world from a viewing direction, an up vector (made
    orthogonal) and a position."""

    def normalize(x):
        return x / (np.linalg.norm(x) + 1e-12)

    vec1 = normalize(up)
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(vec1, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def average_pose(poses):
    """Mean camera pose (mip-NeRF 360 recentring)."""
    position = poses[:, :3, 3].mean(0)
    z_axis = poses[:, :3, 2].mean(0)
    up = poses[:, :3, 1].mean(0)
    return viewmatrix(z_axis, up, position)


def recenter_poses(poses):
    """Recentre around the average pose; returns (poses, transform [4, 4])."""
    cam2world = average_pose(poses)
    transform = np.linalg.inv(pad_poses(cam2world[None])[0])
    poses = transform @ pad_poses(poses)
    return unpad_poses(poses), transform


def pixel_coordinates(width, height):
    """Integer (x, y) pixel grids, 'xy' indexing."""
    return np.meshgrid(np.arange(width), np.arange(height), indexing="xy")


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds, rng=None, jitter=0):
    """Cast perspective rays through pixel centers; returns every per-ray
    camera field (origins, directions, viewdirs, radii, imageplane, look, up,
    cam_origins, vcam_look, vcam_up, vcam_origins).

    Numpy arrays cast on the host, without jitter (the dataset's renderings,
    eval views); tensors cast on their device in float32 (the train step's
    in-step casting), with the JAX package's jnp op order: the 3x3 products
    and norms as sequential sums of three products. There, with ``jitter``
    and a generator `rng`, each pixel moves by U(-0.5, 0.5) (jitter 1) or
    N(0, 0.25) (otherwise) draws, x then y.

    Radii follow the mip-NeRF convention: half the distance to the
    neighboring pixels' directions, scaled by 2/sqrt(12).
    """
    if isinstance(pix_x_int, torch.Tensor):
        return _pixels_to_rays_torch(pix_x_int, pix_y_int, pixtocams, camtoworlds, rng, jitter)

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


def _mat_vec(a, b):
    """a [..., 3, 3] @ b [..., 3], each row a sequential sum of three products."""
    return torch.stack([(a[..., i, 0] * b[..., 0] + a[..., i, 1] * b[..., 1])
                        + a[..., i, 2] * b[..., 2] for i in range(3)], dim=-1)


def _norm(x):
    return torch.sqrt((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2])


def _pixels_to_rays_torch(pix_x_int, pix_y_int, pixtocams, camtoworlds, rng, jitter):
    if jitter > 0 and rng is not None:
        shape, device = pix_x_int.shape, pix_x_int.device
        if jitter == 1:
            dx = torchutil.uniform(rng, shape, device) - 0.5
            dy = torchutil.uniform(rng, shape, device) - 0.5
        else:
            dx = torchutil.normal(rng, shape, device) * 0.5
            dy = torchutil.normal(rng, shape, device) * 0.5
    else:
        dx = dy = 0.0

    def pix_to_dir(x, y):
        return torch.stack([x + 0.5, y + 0.5, torch.ones_like(x)], dim=-1)

    pixel_dirs = [pix_to_dir(pix_x_int + ox + dx, pix_y_int + oy + dy)
                  for ox, oy in ((0, 0), (1, 0), (0, 1))]
    # OpenCV -> OpenGL.
    flip = torch.tensor([1.0, -1.0, -1.0], device=pix_x_int.device)
    camera_dirs = [_mat_vec(pixtocams, d) * flip for d in pixel_dirs]
    imageplane = camera_dirs[0][..., :2]
    directions, ddx, ddy = (_mat_vec(camtoworlds[..., :3, :3], d) for d in camera_dirs)
    origins = camtoworlds[..., :3, -1].expand(directions.shape)
    viewdirs = directions / _norm(directions)[..., None]
    look = (-camtoworlds[..., :3, 2]).expand(directions.shape)
    up = camtoworlds[..., :3, 1].expand(directions.shape)
    radii = (0.5 * (_norm(ddx - directions) + _norm(ddy - directions)))[..., None] * 2 / \
        torch.sqrt(torch.tensor(12.0, device=directions.device))
    return (origins, directions, viewdirs, radii, imageplane, look, up, origins,
            look, up, origins)


def cast_ray_batch(cameras, lights, pixels: pytrees.Pixels, rng=None, jitter=0,
                   impulse_response=None, virtual_camtoworlds=None) -> pytrees.Rays:
    """Turn a Pixels batch into a Rays batch by indexing per-ray cameras.

    `cameras` is (pixtocams [N or 1, 3, 3], camtoworlds [N, 3, 4]); `lights`
    is [N_lights or N_cams, 3]: numpy arrays with numpy pixels, tensors on
    the pixels' device with tensor pixels. rng / jitter: the pixel jitter
    of ``pixels_to_rays``; impulse_response rides along on the rays.
    virtual_camtoworlds [N, 3, 4], where given, sets the rays' virtual
    camera (vcam_look, vcam_up, vcam_origins) in place of their own.
    """
    pixtocams, camtoworlds = cameras[0], cameras[1]
    cam_idx = pixels.cam_idx[..., 0]
    light_idx = pixels.light_idx[..., 0]
    zeros_like = torch.zeros_like if isinstance(cam_idx, torch.Tensor) else np.zeros_like
    pixtocam = pixtocams[cam_idx if pixtocams.shape[0] > 1 else zeros_like(cam_idx)]
    camtoworld = camtoworlds[cam_idx]
    light = lights[light_idx if lights.shape[0] > 1 else zeros_like(light_idx)]
    (origins, directions, viewdirs, radii, imageplane, look, up, cam_origins,
     vcam_look, vcam_up, vcam_origins) = pixels_to_rays(
        pixels.pix_x_int, pixels.pix_y_int, pixtocam, camtoworld, rng=rng, jitter=jitter)
    if virtual_camtoworlds is not None:
        virtual = virtual_camtoworlds[cam_idx]
        broadcast = (torch.broadcast_to if isinstance(virtual, torch.Tensor)
                     else np.broadcast_to)
        vcam_look, vcam_up, vcam_origins = (
            broadcast(x, directions.shape)
            for x in (-virtual[..., :3, 2], virtual[..., :3, 1], virtual[..., :3, -1]))
    return pytrees.Rays(
        origins=origins, directions=directions, viewdirs=viewdirs, radii=radii, lights=light,
        imageplane=imageplane, look=look, up=up, cam_origins=cam_origins,
        vcam_look=vcam_look, vcam_up=vcam_up, vcam_origins=vcam_origins,
        lossmult=pixels.lossmult, near=pixels.near, far=pixels.far, cam_idx=pixels.cam_idx,
        light_idx=pixels.light_idx, pix_x_int=pixels.pix_x_int, pix_y_int=pixels.pix_y_int,
        exposure_idx=pixels.exposure_idx, exposure_values=pixels.exposure_values,
        impulse_response=impulse_response,
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
