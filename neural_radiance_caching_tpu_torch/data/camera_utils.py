"""Camera math (counterpart of ``data/camera_utils.py``): rays cast from
numpy pixels on the host (the renderings, the eval views, batches of a
config that casts outside the step) or from tensor pixels on their device
(``Config.cast_rays_in_train_step``, the JAX step's jnp casting), through
perspective, fisheye or (on the host) panoramic cameras, with OpenCV's lens
distortion inverted by a fixed 10-step Newton solve and the forward-facing
NDC warp; full-image rays of a free camera (``cast_general_rays``,
``cast_pinhole_rays``, ``cast_spherical_rays``: the trainer's secondary-ray
probe); the loaders' intrinsics, pose recentring and render paths."""

from __future__ import annotations

import enum

import numpy as np
import torch

from neural_radiance_caching_tpu_torch.utils import pytrees, torchutil


class ProjectionType(enum.Enum):
    """The loaders' camera models; PANORAMIC casts on the host only."""

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


def viewmatrix(lookdir, up, position, lock_up=False):
    """Camera-to-world from a viewing direction, an up vector and a
    position: `lookdir` kept and `up` made orthogonal, or with `lock_up`
    the up vector kept and the look direction bent."""

    def normalize(x):
        return x / (np.linalg.norm(x) + 1e-12)

    vec1 = normalize(up)
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(vec1, vec2))
    if lock_up:
        vec2 = normalize(np.cross(vec0, vec1))
    else:
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


def transform_poses_pca(poses):
    """Align the world frame to the principal axes of the camera positions
    (mip-NeRF 360): the right singular vectors of the centred positions as
    the new axes (the last flipped to keep the frame right-handed), y and z
    flipped if the cameras' mean up points down, then scaled so that every
    position lies in [-1, 1]^3. Returns (poses [N, 3, 4], transform [4, 4])."""
    positions = poses[:, :3, 3]
    center = positions.mean(axis=0)
    _, _, axes = np.linalg.svd(positions - center, full_matrices=False)
    if np.linalg.det(axes) < 0:
        axes[-1] *= -1.0
    world_from_old = np.eye(4)
    world_from_old[:3, :3] = axes
    world_from_old[:3, 3] = axes @ -center
    aligned = unpad_poses(world_from_old @ pad_poses(poses))
    if aligned[:, 2, 1].mean() < 0:
        aligned = np.diag(np.array([1.0, -1.0, -1.0])) @ aligned
        world_from_old = np.diag(np.array([1.0, -1.0, -1.0, 1.0])) @ world_from_old
    extent = np.max(np.abs(aligned[:, :3, 3]))
    world_from_old = np.diag(np.array([1 / extent] * 3 + [1.0])) @ world_from_old
    aligned[:, :3, 3] /= extent
    return aligned, world_from_old


def focus_point_fn(poses):
    """The point nearest, in least squares, to every camera's optical axis."""
    directions = poses[:, :3, 2:3]
    origins = poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def transform_poses_focus(poses):
    """Recentre on the cameras' focus point (``focus_point_fn``) with their
    mean up turned to +z; returns (poses [N, 3, 4], transform [4, 4])."""
    focus = focus_point_fn(poses)
    up = poses[:, :3, 1].mean(0)
    up = up / np.linalg.norm(up)
    # The rotation taking `up` to +z (Rodrigues).
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(up, z)
    s = np.linalg.norm(v)
    c = up @ z
    if s < 1e-8:
        rot = np.eye(3) if c > 0 else np.diag(np.array([1.0, -1.0, -1.0]))
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        rot = np.eye(3) + vx + vx @ vx * ((1 - c) / s**2)
    transform = np.concatenate([rot, rot @ -focus[:, None]], -1)
    out = unpad_poses(pad_poses(transform[None])[0] @ pad_poses(poses))
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
    return out, transform


def generate_ellipse_path(poses, n_frames=120, z_variation=0.0, z_phase=0.0, lock_up=False,
                          relative_to_first_pose=False, flip_y=False, first_pose=None):
    """An elliptical render path around the cameras' centre, its axes the
    90th percentiles of their offsets, looking at the centre."""
    if first_pose is not None:
        ref = np.array(first_pose)[:3, :4]
    elif relative_to_first_pose:
        ref = poses[0]
    else:
        ref = average_pose(poses)
    center = poses[:, :3, 3].mean(axis=0)
    offsets = poses[:, :3, 3] - center
    sc = np.percentile(np.abs(offsets), 90, axis=0)
    theta = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    positions = center + np.stack([
        sc[0] * np.cos(theta),
        sc[1] * np.sin(theta) * (-1.0 if flip_y else 1.0),
        sc[2] * z_variation * np.sin(theta + z_phase)], axis=-1)
    positions = positions + ref[:3, 3] * 0.0
    up = ref[:3, 1] if lock_up else poses[:, :3, 1].mean(0)
    return np.stack([viewmatrix(center - p, up, p) for p in positions],
                    axis=0).astype(np.float32)


# Forward-facing spiral heuristics.
NEAR_STRETCH = 0.9
FAR_STRETCH = 5.0
FOCUS_DISTANCE = 0.75


def generate_spiral_path(poses, bounds, n_frames=120, n_rots=2, zrate=0.5):
    """A forward-facing spiral render path (LLFF): around the average pose,
    its radii the 90th percentiles of |camera position|, looking at the
    focus depth blended in disparity between the stretched bounds."""
    near_bound = bounds.min() * NEAR_STRETCH
    far_bound = bounds.max() * FAR_STRETCH
    focal = 1 / ((1 - FOCUS_DISTANCE) / near_bound + FOCUS_DISTANCE / far_bound)
    radii = np.append(np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0), 1.0)
    center_pose = average_pose(poses)
    mean_up = poses[:, :3, 1].mean(0)
    target = center_pose @ np.array([0.0, 0.0, -focal, 1.0])
    angles = np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False)
    offsets = radii * np.stack([np.cos(angles), -np.sin(angles), -np.sin(angles * zrate),
                                np.ones_like(angles)], axis=-1)
    eyes = offsets @ center_pose.T
    return np.stack([viewmatrix(eye - target, mean_up, eye) for eye in eyes], axis=0)


def generate_interpolated_path(poses, n_interp, spline_degree=5, smoothness=0.03,
                               rot_weight=0.1, lock_up=False, fixed_up_vector=None,
                               lookahead_i=None, const_speed=False, n_buffer=None,
                               periodic=False):
    """A smooth B-spline path through keyframe poses: each pose as (position,
    look-at point, up point), the spline over the stacked 9-vectors (scipy's
    splprep / splev), converted back to view matrices; `n_interp` poses per
    keyframe gap, the last dropped. `n_buffer` poses are added before and
    after along the end cameras' axes and cut from the result;
    `const_speed` resamples the spline by arc length (the port's
    ``stepfun.sample`` in float32)."""
    import scipy.interpolate

    def poses_to_points(ps, dist):
        pos = ps[:, :3, -1]
        lookat = pos - dist * ps[:, :3, 2]
        up = pos + dist * ps[:, :3, 1]
        return np.stack([pos, lookat, up], 1)

    def points_to_poses(points):
        out = []
        for i in range(len(points)):
            pos, lookat_point, up_point = points[i]
            if lookahead_i is not None and i + lookahead_i < len(points):
                lookat = pos - points[i + lookahead_i][0]
            else:
                lookat = pos - lookat_point
            up = (up_point - pos) if fixed_up_vector is None else fixed_up_vector
            out.append(viewmatrix(lookat, up, pos, lock_up=lock_up))
        return np.array(out)

    def insert_buffer_poses(ps, nb):
        dz = np.mean(np.linalg.norm(ps[1:, :3, 3] - ps[:-1, :3, 3], axis=-1))

        def shift(pose, d):
            result = np.copy(pose)
            z = result[:3, 2] / np.linalg.norm(result[:3, 2])
            result[:3, 3] += z * d
            return result

        prefix = np.stack([shift(ps[0], (i + 1) * dz) for i in range(nb)])[::-1]
        suffix = np.stack([shift(ps[-1], -(i + 1) * dz) for i in range(nb)])
        return np.concatenate([prefix, ps, suffix])

    def interp(points, u, k, s):
        sh = points.shape
        pts = np.reshape(points, (sh[0], -1))
        k = min(k, sh[0] - 1)
        tck, u_keyframes = scipy.interpolate.splprep(pts.T, k=k, s=s, per=periodic)
        new_points = np.array(scipy.interpolate.splev(u, tck))
        return np.reshape(new_points.T, (len(u), sh[1], sh[2])), u_keyframes

    if n_buffer is not None:
        poses = insert_buffer_poses(poses, n_buffer)
    points = poses_to_points(poses, dist=rot_weight)
    n_frames = n_interp * (points.shape[0] - 1)
    u = np.linspace(0, 1, n_frames, endpoint=True)
    new_points, u_keyframes = interp(points, u=u, k=spline_degree, s=smoothness)
    out_poses = points_to_poses(new_points)
    if n_buffer is not None:
        lo, hi = u_keyframes[n_buffer], u_keyframes[-n_buffer - 1]
        mask = (u >= lo) & (u <= hi)
        out_poses, u = out_poses[mask], u[mask]
    if const_speed:
        from neural_radiance_caching_tpu_torch.ops import stepfun

        positions = out_poses[:, :3, -1]
        lengths = np.linalg.norm(positions[1:] - positions[:-1], axis=-1)
        u = stepfun.sample(None, torch.as_tensor(u, dtype=torch.float32),
                           torch.as_tensor(np.log(lengths), dtype=torch.float32),
                           len(out_poses) + 1).numpy()
        new_points, _ = interp(points, u=u, k=spline_degree, s=smoothness)
        out_poses = points_to_poses(new_points)
    return out_poses[:-1]


def gather_cameras(cameras, inds):
    """Index each camera array (or dict of them) of `cameras` by `inds`:
    only arrays whose leading axis is the poses' count (cameras[0]'s) are
    gathered; shared ones and None pass through."""
    n = np.asarray(cameras[0]).shape[0]

    def gather(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: gather(v) for k, v in x.items()}
        x = np.asarray(x)
        if x.ndim >= 1 and x.shape[0] == n:
            return x[inds]
        return x

    return tuple(gather(c) for c in cameras)


def _rq_decomp3x3(m):
    """OpenCV's ``RQDecomp3x3`` in float64: Givens rotations about x, y
    and z zero M's [2, 1], [2, 0] and [1, 0] in turn, R = M Qx Qy Qz; then
    R turned by 180 degrees about z, y or x so that its first two diagonal
    entries are positive; returns (R upper triangular, Q = Qz^T Qy^T Qx^T)
    with M = R Q."""
    m = np.asarray(m, np.float64)
    eps = np.finfo(np.float64).eps

    def givens(c, s):
        z = 1.0 / np.sqrt(c * c + s * s + eps)
        return c * z, s * z

    c, s = givens(m[2, 2], m[2, 1])
    qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    r = m @ qx
    r[2, 1] = 0
    c, s = givens(r[2, 2], -r[2, 0])
    qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    m2 = r @ qy
    m2[2, 0] = 0
    c, s = givens(m2[1, 1], m2[1, 0])
    qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    r = m2 @ qz
    r[1, 0] = 0
    # A turn by 180 degrees D about z, y or x: R D and Qz D.
    if r[0, 0] < 0:
        flip = np.diag([-1.0, -1.0, 1.0]) if r[1, 1] < 0 else np.diag([-1.0, 1.0, -1.0])
    else:
        flip = np.diag([1.0, -1.0, -1.0]) if r[1, 1] < 0 else None
    if flip is not None:
        r, qz = r @ flip, qz @ flip
    q = (qz.T @ qy.T) @ qx.T
    return r, q


def decompose_projection_matrix(projection):
    """OpenCV's ``decomposeProjectionMatrix`` of a [3, 4] projection P =
    K [R | -R C], its first three outputs: the intrinsics K and rotation R
    of ``_rq_decomp3x3`` on P's left 3x3 in float64 (K's diagonal but its
    last entry positive; K is not normalised: divide by K[2, 2]) and the
    homogeneous camera centre [4, 1] in P's dtype, P's unit null vector (its
    sign is the SVD's: only C = t[:3] / t[3] is defined); computed in
    float64."""
    projection = np.asarray(projection)
    p = np.zeros((4, 4))
    p[:3] = projection
    _, _, vt = np.linalg.svd(p)
    r, q = _rq_decomp3x3(p[:3, :3])
    return r, q, vt[3][:, None].astype(projection.dtype)


def pixel_coordinates(width, height):
    """Integer (x, y) pixel grids, 'xy' indexing."""
    return np.meshgrid(np.arange(width), np.arange(height), indexing="xy")


# --- OpenCV lens distortion and the NDC warp ----------------------------------------------


def _coefficients(params):
    return tuple(params.get(k, 0.0) for k in ("k1", "k2", "k3", "k4", "p1", "p2"))


def distort_coordinates(x, y, params):
    """OpenCV's radial (k1..k4) and tangential (p1, p2) distortion of
    normalised image coordinates; `params` a dict (missing keys 0)."""
    k1, k2, k3, k4, p1, p2 = _coefficients(params)
    r2 = x * x + y * y
    radial = r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = x * (1.0 + radial) + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * (1.0 + radial) + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return xd, yd


def undistort_coordinates(xd, yd, params, max_iterations=10, eps=1e-9):
    """Invert ``distort_coordinates`` by a fixed number of 2-D Newton steps
    from the distorted point, each solving J d = -F in closed form; where
    |det J| <= eps the step is 0. Numpy arrays or tensors, in the JAX
    package's operation order."""
    k1, k2, k3, k4, p1, p2 = _coefficients(params)
    xnp = torch if isinstance(xd, torch.Tensor) else np
    x = xd * xnp.ones_like(xd)
    y = yd * xnp.ones_like(yd)
    for _ in range(max_iterations):
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        # d/d(r^2) of the radial factor.
        d_r = k1 + r2 * (2.0 * k2 + r2 * (3.0 * k3 + r2 * (4.0 * k4)))
        fx = d * x + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xd
        fy = d * y + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y) - yd
        jxx = d + 2.0 * x * x * d_r + 2.0 * p1 * y + 6.0 * p2 * x
        jxy = 2.0 * x * y * d_r + 2.0 * p1 * x + 2.0 * p2 * y
        jyx = 2.0 * x * y * d_r + 2.0 * p2 * y + 2.0 * p1 * x
        jyy = d + 2.0 * y * y * d_r + 2.0 * p2 * x + 6.0 * p1 * y
        det = jxx * jyy - jxy * jyx
        safe = xnp.abs(det) > eps
        inv_det = xnp.where(safe, 1.0 / xnp.where(safe, det, 1.0), 0.0)
        x = x - (fx * jyy - fy * jxy) * inv_det
        y = y - (fy * jxx - fx * jyx) * inv_det
    return x, y


def convert_to_ndc(origins, directions, pixtocam, near=1.0):
    """The forward-facing NDC warp (NeRF, appendix C): each ray slid to
    the z = -near plane, its near point projected to z = -1 and its point at
    infinity to z = +1, with the projective scales 1 / pixtocam[0, 2] and
    1 / pixtocam[1, 2]; returns (origins, directions), the directions not
    unit length. Numpy arrays or tensors."""
    if isinstance(origins, torch.Tensor):
        stack, full_like = torch.stack, torch.full_like
    else:
        stack, full_like = np.stack, np.full_like
    slide = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + slide[..., None] * directions
    scale_x = 1.0 / pixtocam[0, 2]
    scale_y = 1.0 / pixtocam[1, 2]

    def project(p, z_plane):
        return stack([scale_x * p[..., 0] / p[..., 2], scale_y * p[..., 1] / p[..., 2],
                      full_like(p[..., 2], z_plane)], -1)

    near_points = project(origins, -1.0)
    far_points = project(directions, 1.0)
    return near_points, far_points - near_points


# --- rays --------------------------------------------------------------------------------


def _fisheye(x, y, camtype, xnp):
    """Image-plane (x, y) in focal units -> unit directions [..., 3] of an
    equidistant (theta = r) or equisolid (r = 2 sin(theta / 2)) fisheye."""
    r = xnp.sqrt(x * x + y * y)
    if camtype == ProjectionType.FISHEYE:
        theta = xnp.clip(r, None, np.pi)
    else:
        theta = 2.0 * xnp.arcsin(r / 2.0)
    sin_over_r = xnp.sin(theta) / xnp.clip(r, 1e-12, None)
    return xnp.stack([x * sin_over_r, y * sin_over_r, xnp.cos(theta)], -1)


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds, rng=None, jitter=0,
                   camtype=ProjectionType.PERSPECTIVE, distortion_params=None,
                   pixtocam_ndc=None):
    """Cast rays through pixel centers; returns every per-ray camera field
    (origins, directions, viewdirs, radii, imageplane, look, up,
    cam_origins, vcam_look, vcam_up, vcam_origins).

    Numpy arrays cast on the host, without jitter (the dataset's renderings,
    eval views); tensors cast on their device in float32 (the train step's
    in-step casting), with the JAX package's jnp op order: the 3x3 products
    and norms as sequential sums of three products. There, with ``jitter``
    and a generator `rng`, each pixel moves by U(-0.5, 0.5) (jitter 1) or
    N(0, 0.25) (otherwise) draws, x then y.

    distortion_params: a dict of OpenCV coefficients (per-ray arrays or
    shared floats) whose inverse is solved per pixel
    (``undistort_coordinates``). camtype: the image plane bent onto an
    equidistant or equisolid fisheye, or (on the host) an equirectangular
    panorama, where `pixtocams` maps a pixel to (azimuth, polar angle).
    pixtocam_ndc [3, 3]: the rays warped into NDC (``convert_to_ndc``), the
    radii measured between the warped origins of neighbouring pixels.

    Radii follow the mip-NeRF convention: half the distance to the
    neighboring pixels' directions, scaled by 2/sqrt(12).
    """
    if isinstance(pix_x_int, torch.Tensor):
        if camtype == ProjectionType.PANORAMIC:
            raise NotImplementedError("panoramic rays are cast on the host in the port")
        return _pixels_to_rays_torch(pix_x_int, pix_y_int, pixtocams, camtoworlds, rng, jitter,
                                     camtype, distortion_params, pixtocam_ndc)

    def pix_to_dir(x, y):
        return np.stack([x + 0.5, y + 0.5, np.ones_like(x)], axis=-1)

    pixel_dirs_stacked = np.stack(
        [pix_to_dir(pix_x_int + ox, pix_y_int + oy) for ox, oy in ((0, 0), (1, 0), (0, 1))],
        axis=0)
    mat_vec_mul = lambda a, b: np.matmul(a, b[..., None])[..., 0]
    camera_dirs_stacked = mat_vec_mul(pixtocams, pixel_dirs_stacked)
    if distortion_params is not None:
        x, y = undistort_coordinates(camera_dirs_stacked[..., 0], camera_dirs_stacked[..., 1],
                                     distortion_params)
        camera_dirs_stacked = np.stack([x, y, np.ones_like(x)], axis=-1)
    if camtype in (ProjectionType.FISHEYE, ProjectionType.FISHEYE_EQUISOLID):
        camera_dirs_stacked = _fisheye(camera_dirs_stacked[..., 0], camera_dirs_stacked[..., 1],
                                       camtype, np)
    elif camtype == ProjectionType.PANORAMIC:
        theta, phi = camera_dirs_stacked[..., 0], camera_dirs_stacked[..., 1]
        camera_dirs_stacked = np.stack(
            [-np.sin(phi) * np.sin(theta), -np.cos(phi), -np.sin(phi) * np.cos(theta)], axis=-1)
    # OpenCV -> OpenGL.
    camera_dirs_stacked = np.matmul(
        camera_dirs_stacked, np.diag(np.array([1.0, -1.0, -1.0], dtype=np.float32)))
    imageplane = camera_dirs_stacked[0, ..., :2]

    directions, ddx, ddy = mat_vec_mul(camtoworlds[..., :3, :3], camera_dirs_stacked)
    origins = np.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    look = np.broadcast_to(-camtoworlds[..., :3, 2], directions.shape)
    up = np.broadcast_to(camtoworlds[..., :3, 1], directions.shape)
    vcam_origins = origins
    if pixtocam_ndc is None:
        dx_norm = np.linalg.norm(ddx - directions, axis=-1)
        dy_norm = np.linalg.norm(ddy - directions, axis=-1)
    else:
        origins_ndc_dx, _ = convert_to_ndc(origins, ddx, pixtocam_ndc)
        origins_ndc_dy, _ = convert_to_ndc(origins, ddy, pixtocam_ndc)
        origins, directions = convert_to_ndc(origins, directions, pixtocam_ndc)
        dx_norm = np.linalg.norm(origins_ndc_dx - origins, axis=-1)
        dy_norm = np.linalg.norm(origins_ndc_dy - origins, axis=-1)
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2 / np.sqrt(12)
    return (origins, directions, viewdirs, radii, imageplane, look, up, origins,
            look, up, vcam_origins)


def _mat_vec(a, b):
    """a [..., 3, 3] @ b [..., 3], each row a sequential sum of three products."""
    return torch.stack([(a[..., i, 0] * b[..., 0] + a[..., i, 1] * b[..., 1])
                        + a[..., i, 2] * b[..., 2] for i in range(3)], dim=-1)


def _norm(x):
    return torch.sqrt((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2])


def _pixels_to_rays_torch(pix_x_int, pix_y_int, pixtocams, camtoworlds, rng, jitter, camtype,
                          distortion_params, pixtocam_ndc):
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

    # Each pixel and its +x and +y neighbours stacked [3, ..., 3], as in
    # JAX: one pass of the Newton solve for all three.
    camera_dirs = _mat_vec(pixtocams, torch.stack(
        [pix_to_dir(pix_x_int + ox + dx, pix_y_int + oy + dy)
         for ox, oy in ((0, 0), (1, 0), (0, 1))], dim=0))
    if distortion_params is not None:
        x, y = undistort_coordinates(camera_dirs[..., 0], camera_dirs[..., 1], distortion_params)
        camera_dirs = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    if camtype in (ProjectionType.FISHEYE, ProjectionType.FISHEYE_EQUISOLID):
        camera_dirs = _fisheye(camera_dirs[..., 0], camera_dirs[..., 1], camtype, torch)
    # OpenCV -> OpenGL.
    camera_dirs = camera_dirs * torch.tensor([1.0, -1.0, -1.0], device=pix_x_int.device)
    imageplane = camera_dirs[0][..., :2]
    directions, ddx, ddy = _mat_vec(camtoworlds[..., :3, :3], camera_dirs).unbind(0)
    origins = camtoworlds[..., :3, -1].expand(directions.shape)
    viewdirs = directions / _norm(directions)[..., None]
    look = (-camtoworlds[..., :3, 2]).expand(directions.shape)
    up = camtoworlds[..., :3, 1].expand(directions.shape)
    vcam_origins = origins
    if pixtocam_ndc is None:
        dx_norm, dy_norm = _norm(ddx - directions), _norm(ddy - directions)
    else:
        origins_ndc_dx, _ = convert_to_ndc(origins, ddx, pixtocam_ndc)
        origins_ndc_dy, _ = convert_to_ndc(origins, ddy, pixtocam_ndc)
        origins, directions = convert_to_ndc(origins, directions, pixtocam_ndc)
        dx_norm, dy_norm = _norm(origins_ndc_dx - origins), _norm(origins_ndc_dy - origins)
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2 / \
        torch.sqrt(torch.tensor(12.0, device=directions.device))
    return (origins, directions, viewdirs, radii, imageplane, look, up, origins,
            look, up, vcam_origins)


def cameras_to(cameras, device):
    """`cameras` (arrays, dicts of them, floats or None) as tensors on
    `device`, float64 made float32 (as jnp.asarray makes it) and a shared
    float a 0-d float32 tensor."""

    def to(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        t = torch.as_tensor(x)
        return (t.float() if t.dtype == torch.float64 else t).to(device)

    return tuple(to(c) for c in cameras)


def cast_ray_batch(cameras, lights, pixels: pytrees.Pixels, rng=None, jitter=0,
                   impulse_response=None, virtual_camtoworlds=None,
                   camtype=ProjectionType.PERSPECTIVE) -> pytrees.Rays:
    """Turn a Pixels batch into a Rays batch by indexing per-ray cameras.

    `cameras` is (pixtocams [N or 1, 3, 3], camtoworlds [N, 3, 4],
    distortion, pixtocam_ndc), the last two optional: a dict of OpenCV
    coefficients (arrays [N], gathered by the rays' camera, or shared
    floats) or None, and a shared [3, 3] or None (the NDC warp). `lights` is
    [N_lights or N_cams, 3]: numpy arrays with numpy pixels, tensors on the
    pixels' device with tensor pixels. rng / jitter: the pixel jitter of
    ``pixels_to_rays``; impulse_response rides along on the rays.
    virtual_camtoworlds [N, 3, 4], where given, sets the rays' virtual
    camera (vcam_look, vcam_up, vcam_origins) in place of their own.
    """
    pixtocams, camtoworlds = cameras[0], cameras[1]
    distortion_params = cameras[2] if len(cameras) > 2 else None
    pixtocam_ndc = cameras[3] if len(cameras) > 3 else None
    cam_idx = pixels.cam_idx[..., 0]
    light_idx = pixels.light_idx[..., 0]
    if isinstance(distortion_params, dict):
        distortion_params = {k: v[cam_idx] if getattr(v, "ndim", 0) >= 1 else v
                             for k, v in distortion_params.items()}
    zeros_like = torch.zeros_like if isinstance(cam_idx, torch.Tensor) else np.zeros_like
    pixtocam = pixtocams[cam_idx if pixtocams.shape[0] > 1 else zeros_like(cam_idx)]
    camtoworld = camtoworlds[cam_idx]
    light = lights[light_idx if lights.shape[0] > 1 else zeros_like(light_idx)]
    (origins, directions, viewdirs, radii, imageplane, look, up, cam_origins,
     vcam_look, vcam_up, vcam_origins) = pixels_to_rays(
        pixels.pix_x_int, pixels.pix_y_int, pixtocam, camtoworld, rng=rng, jitter=jitter,
        camtype=camtype, distortion_params=distortion_params, pixtocam_ndc=pixtocam_ndc)
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


# --- full-image rays of a free camera ----------------------------------------------------


def cast_general_rays(camtoworld, pixtocam, height, width, near, far, distortion_params=None,
                      camtype=ProjectionType.PERSPECTIVE, cam_idx=0, light_idx=0, lights=None):
    """The [height, width] rays of one camera `camtoworld` [3 or 4, 4]
    through `pixtocam` [3, 3], cast on the host through pixel centres (no
    jitter), with camera index `cam_idx` and light index `light_idx`, the
    light at `lights` or else at the camera's origin."""
    pix_x_int, pix_y_int = pixel_coordinates(width, height)
    camtoworld = np.asarray(camtoworld, np.float32)[..., :3, :4]
    (origins, directions, viewdirs, radii, imageplane, look, up, cam_origins, vcam_look, vcam_up,
     vcam_origins) = pixels_to_rays(pix_x_int, pix_y_int, np.asarray(pixtocam, np.float32),
                                    camtoworld, camtype=camtype,
                                    distortion_params=distortion_params)

    def scalar(v):
        return np.broadcast_to(v, pix_x_int.shape)[..., None]

    if lights is None:
        lights = camtoworld[..., :3, -1]
    return pytrees.Rays(
        origins=origins, directions=directions, viewdirs=viewdirs, radii=radii,
        lights=np.broadcast_to(lights, directions.shape), imageplane=imageplane, look=look,
        up=up, cam_origins=cam_origins, vcam_look=vcam_look, vcam_up=vcam_up,
        vcam_origins=vcam_origins, lossmult=scalar(1.0), near=scalar(np.float32(near)),
        far=scalar(np.float32(far)), cam_idx=scalar(1).astype(np.int32) * cam_idx,
        light_idx=scalar(1).astype(np.int32) * light_idx,
        pix_x_int=pix_x_int, pix_y_int=pix_y_int)


def cast_pinhole_rays(camtoworld, height, width, focal, near, far, **kwargs):
    """``cast_general_rays`` through a centred pinhole of focal `focal`."""
    return cast_general_rays(camtoworld, get_pixtocam(focal, width, height), height, width,
                             near, far, camtype=ProjectionType.PERSPECTIVE, **kwargs)


def cast_spherical_rays(camtoworld, height, width, near, far, light_idx=0):
    """The [height, width] equirectangular rays of one pose `camtoworld`
    [3 or 4, 4], cast on the host through pixel centres (no jitter), the
    light at the pose's origin, camera index 0 and light index
    `light_idx`: the trainer's secondary-ray probe camera."""
    pixtocam = np.diag(np.array([2.0 * np.pi / width, np.pi / height, 1.0], np.float32))
    return cast_general_rays(camtoworld, pixtocam, height, width, near, far,
                             camtype=ProjectionType.PANORAMIC, light_idx=light_idx)


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
